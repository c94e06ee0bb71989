// HEVC motion-compensated prediction on an NVIDIA Hopper card (sm_90a):
// HM's TComInterpolationFilter with the int16 (Short) intermediate, the
// bi-prediction average and explicit weighted prediction.
//
// Replaces the XLA functions thevc_tpu/ops/jx_mc.py:77 mc_batch (with
// _copy_batch :35 and _filter_1d_batch :44) and :107 bi_avg_batch, and the
// weighted paths of the JAX decoder's precompute_device
// (thevc_tpu/decoder/inter.py:121-221).  Per output sample, for a window
// whose (0, 0) is the first tap sample, read at coordinates clamped to the
// plane (what Picture.padded() holds there):
//   copy  first pass of a copy: the sample, or (s << (14 - bd)) - 8192
//   hor   sum_k win[i][j + k] * c[fx][k], rounded and shifted once
//   ver   sum_k win[i + k][j] * c[fy][k], rounded and shifted once
//   2d    tmp = hor pass at 14 bits minus 8192, WRAPPED to int16; then the
//         vertical pass over tmp
// 8 taps at quarter-pel phases for luma, 4 taps at eighth-pel phases for
// chroma, the phase per job.  The last pass clips to [0, 2^bd - 1] unless
// the job keeps 14 bits (bi-prediction and weighted prediction), where the
// value wraps to int16 as the plain version's cast does.  The bi average is
// (p0 + p1 + 2^(shift-1) + 2 * 8192) >> shift with shift = 15 - bd; the
// weighted forms (TComWeightPrediction.cpp addWeightUni / addWeightBi) run
// in int64, as the plain versions do.  Right shifts of negative values are
// arithmetic (as in torch).  Every value matches ops/mc.py bit for bit.
//
// What bounds it on this card: bytes.  Each output sample reads its window
// (the block plus 7 luma or 3 chroma rows and columns, int16) and writes
// one int16; the arithmetic is at most 16 integer multiply-adds a sample
// for luma.  A 1080p picture's prediction moves a few MB: microseconds at
// 3.35 TB/s.  What costs in practice is the number of launches and the
// host work around them, so the design is one launch a picture.
//
// Layout.  thevc_mc_picture takes one int32 device table, uploaded in one
// copy: per reference plane (pointer low, pointer high, rows, columns),
// then per job (one prediction unit and component, both lists where it is
// bi-predicted) the JOB_COLS fields below, then per tile (job, row, column
// of the tile's first output sample).  A block of 256 threads owns one
// 16x16 tile of one job: it loads the tile's window of each list into
// shared memory at clamped coordinates, runs the first pass of a 2-D case
// into shared memory with the int16 wrap, then each thread computes its
// output sample of each list in registers, combines the lists (average or
// weights) and writes the pixel straight into the picture's flat
// prediction buffer (job destination origin and row stride).
// thevc_mc_blocks serves the encoder: N jobs (plane, window x, window y,
// fx, fy) of one size and one case over a stacked int16 plane tensor
// [P, H, W], out [N, h, w] int16; a block owns one tile of at most 16x16 of
// one job, with as many threads (rounded up to a warp) as the tile has
// samples.  Neither entry allocates or synchronises; both launch on the
// stream they are given and return cudaGetLastError().
//
// thevc_mc_qpel serves the P/B pass's quarter-pel refine (the encoder's
// counterpart is thevc_tpu/encoder/fast_inter.py:270-300, which calls
// jx_mc.py:77 mc_batch with case "2d"): for each of nb blocks of size s
// (8, 16, 32 or 64) the 49 candidates at quarter-pel offsets (qdx, qdy)
// in [-3, 3]^2 around the block's integer MV, out [nb, 49, s, s] int16
// pixels, candidate (qdy + 3) * 7 + qdx + 3.  Each is the 2-D case at its
// phases (a zero phase rides the identity tap row through both passes,
// with the first pass's int16 wrap), so it equals thevc_mc_blocks on the
// 49-job table bit for bit.  Per block the input is only (plane, window
// x, window y): the first tap sample of candidate (0, 0).
//
// What bounds it: bytes.  A call writes 49 predictions a block, about
// 205 MB over a 1088x1920 picture (0.061 ms at 3.35 TB/s).  The 49
// candidates need 7 (s + 8) s first-pass and 49 s^2 second-pass outputs a
// block at 45 nonzero taps over the 7 phases of a pass (7 + 8 + 7 + 1 +
// 7 + 8 + 7, the identity row counted as one), 1.5-1.7 G int32
// operations (0.046-0.051 ms at Hopper's int32 rate).
// The generic entry spent 49 times the window gather (a divide, a modulo
// and two clamps a sample), 49 first passes where 7 horizontal positions
// exist, and 1.6 million blocks of 64 threads at s = 8.  The design:
//   - one block of 224 threads owns NB output tiles of T x T (T = s up to
//     32, so a 64 block is 4 tiles; NB = 8, 2, 1, 1 at s = 8, 16, 32, 64)
//     and computes all 49 candidates of them;
//   - the tile's window covers integer offsets -1 and 0 plus the taps,
//     (T + 8) x (T + 8), loaded once into shared memory as int16 from the
//     8-sample-aligned column at or left of it: 16-byte cp.async where a
//     chunk lies inside the plane, clamped per sample where it does not;
//   - the first pass runs once per horizontal position (7, not 49) over
//     the window's T + 8 rows: a thread takes 16 window samples of a row
//     and writes the 8 outputs of each of the 7 positions (int16, with
//     the wrap) as 16-byte stores;
//   - the second pass is register-blocked: a thread reads an 8-column
//     strip of 9 rows of one horizontal position's first pass (9 16-byte
//     loads) and produces output row i of the 7 vertical candidates from
//     it, each as one 16-byte store; neighbouring threads write
//     neighbouring 16 bytes of a candidate.  The taps are compile-time
//     constants per phase (zero taps vanish, the identity row is a shift).
// No allocation, no host synchronisation: a CUDA graph captures it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInternalPrec = 14;      // IF_INTERNAL_PREC
constexpr int kFilterPrec = 6;         // IF_FILTER_PREC
constexpr int kInternalOffs = 8192;    // IF_INTERNAL_OFFS
constexpr int kTile = 16;              // output tile edge
constexpr int kPictureThreads = kTile * kTile;
constexpr int kWinStride = kTile + 8;  // shared window row stride

// job fields (ops/mc_kernel.py names them J_*); list l's six fields at
// kList + 6 * l
enum {
  kH = 0, kW, kLuma, kKind, kDst, kStride, kW0, kW1, kOff, kDen, kList,
  kJobCols = kList + 12
};
enum { kPlane = 0, kWx, kWy, kFx, kFy, kCase };
// job kinds: uni in pixels, bi average, weighted uni, weighted bi
enum { kUni = 0, kBi = 1, kWUni = 2, kWBi = 3 };
// cases: (fx != 0) + 2 * (fy != 0) for the decoder; the encoder asks for
// the 2-D case at every phase (a 0 phase rides the identity tap row)
enum { kCopy = 0, kHor = 1, kVer = 2, k2d = 3 };

// ops/interp.py LUMA_FILTER and CHROMA_FILTER
__constant__ int kLumaTaps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int kChromaTaps[8][4] = {
    {0, 64, 0, 0}, {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

__device__ __forceinline__ int wrap16(int v) {
  return (int)(int16_t)(v & 0xffff);
}

__device__ __forceinline__ int clip_pixel(long long v, int bd) {
  const long long top = (1ll << bd) - 1;
  return (int)(v < 0 ? 0 : (v > top ? top : v));
}

template <int TAPS>
__device__ __forceinline__ int tap(int phase, int k) {
  if constexpr (TAPS == 8) {
    return kLumaTaps[phase][k];
  } else {
    return kChromaTaps[phase][k];
  }
}

struct Shared {
  int win[kTile + 7][kWinStride];      // the window, int16 samples
  int tmp[kTile + 7][kTile];           // the 2-D case's first pass
};

// One list's prediction of output sample (ty, tx) of the tile whose first
// output sample is (ty0, tx0) of the job: th x tw samples, the window's
// (0, 0) at (wy, wx) of a rows x cols plane.  Every thread of the block
// calls it (it synchronises); only threads with `active` use the result.
// `last`: clip to pixels; else keep 14 bits (wrapped to int16).
template <int TAPS>
__device__ int predict(Shared& sm, const int16_t* __restrict__ plane,
                       int rows, int cols, int wx, int wy, int fx, int fy,
                       int cs, int ty0, int tx0, int th, int tw, int ty,
                       int tx, bool active, bool last, int bd) {
  const bool hor = cs == kHor || cs == k2d;
  const bool ver = cs == kVer || cs == k2d;
  const int wr = th + (ver ? TAPS - 1 : 0);
  const int wc = tw + (hor ? TAPS - 1 : 0);
  const int x0 = wx + tx0, y0 = wy + ty0;
  for (int e = threadIdx.x; e < wr * wc; e += blockDim.x) {
    const int r = e / wc, c = e - r * wc;
    const int y = min(max(y0 + r, 0), rows - 1);
    const int x = min(max(x0 + c, 0), cols - 1);
    sm.win[r][c] = plane[(long long)y * cols + x];
  }
  __syncthreads();
  const int head = kInternalPrec - bd;
  if (cs == k2d) {
    // first pass: is_first, not last: shift 6 - head, offset -8192 << it
    const int sh = kFilterPrec - head;
    const int off = -kInternalOffs * (1 << sh);
    for (int e = threadIdx.x; e < wr * tw; e += blockDim.x) {
      const int r = e / tw, c = e - r * tw;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        acc += sm.win[r][c + k] * tap<TAPS>(fx, k);
      }
      sm.tmp[r][c] = wrap16((acc + off) >> sh);
    }
    __syncthreads();
  }
  if (!active) return 0;
  int acc = 0;
  switch (cs) {
    case kCopy: {
      const int s = sm.win[ty][tx];
      return last ? s : wrap16(s * (1 << head) - kInternalOffs);
    }
    case kHor:
    case kVer: {
      const int phase = cs == kHor ? fx : fy;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        acc += (cs == kHor ? sm.win[ty][tx + k] : sm.win[ty + k][tx])
               * tap<TAPS>(phase, k);
      }
      if (last) return clip_pixel((acc + (1 << (kFilterPrec - 1)))
                                  >> kFilterPrec, bd);
      const int sh = kFilterPrec - head;
      return wrap16((acc - kInternalOffs * (1 << sh)) >> sh);
    }
    default: {
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        acc += sm.tmp[ty + k][tx] * tap<TAPS>(fy, k);
      }
      if (last) {
        const int sh = kFilterPrec + head;
        const int off = (1 << (sh - 1)) + (kInternalOffs << kFilterPrec);
        return clip_pixel((acc + off) >> sh, bd);
      }
      return wrap16(acc >> kFilterPrec);
    }
  }
}

__device__ __forceinline__ const int16_t* plane_ptr(const int* desc) {
  const unsigned long long lo = (unsigned)desc[0], hi = (unsigned)desc[1];
  return reinterpret_cast<const int16_t*>((hi << 32) | lo);
}

template <int TAPS>
__device__ int predict_job_list(Shared& sm, const int* planes, const int* lj,
                                int ty0, int tx0, int th, int tw, int ty,
                                int tx, bool active, bool last, int bd) {
  const int* desc = planes + 4 * lj[kPlane];
  return predict<TAPS>(sm, plane_ptr(desc), desc[2], desc[3], lj[kWx],
                       lj[kWy], lj[kFx], lj[kFy], lj[kCase], ty0, tx0, th,
                       tw, ty, tx, active, last, bd);
}

__global__ void __launch_bounds__(kPictureThreads)
mc_picture_kernel(const int* __restrict__ table, int n_planes, int n_jobs,
                  int16_t* __restrict__ pred, int bd) {
  __shared__ Shared sm;
  const int* planes = table;
  const int* jobs = planes + 4 * n_planes;
  const int* tile = jobs + kJobCols * n_jobs + 3 * blockIdx.x;
  const int* job = jobs + kJobCols * tile[0];
  const int ty0 = tile[1], tx0 = tile[2];
  const int th = min(kTile, job[kH] - ty0), tw = min(kTile, job[kW] - tx0);
  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  const bool active = ty < th && tx < tw;
  const int kind = job[kKind];
  const bool last = kind == kUni;
  const int n_lists = (kind == kBi || kind == kWBi) ? 2 : 1;
  int v[2] = {0, 0};
  for (int l = 0; l < n_lists; ++l) {
    const int* lj = job + kList + 6 * l;
    v[l] = job[kLuma]
        ? predict_job_list<8>(sm, planes, lj, ty0, tx0, th, tw, ty, tx,
                              active, last, bd)
        : predict_job_list<4>(sm, planes, lj, ty0, tx0, th, tw, ty, tx,
                              active, last, bd);
    __syncthreads();                   // the next list reuses the window
  }
  if (!active) return;
  int out;
  switch (kind) {
    case kUni:
      out = v[0];
      break;
    case kBi: {
      const int sh = kInternalPrec + 1 - bd;
      const int off = (1 << (sh - 1)) + 2 * kInternalOffs;
      out = clip_pixel((v[0] + v[1] + off) >> sh, bd);
      break;
    }
    case kWUni: {
      const int sh = job[kDen] + kInternalPrec - bd;
      const long long rnd = (1ll << sh) >> 1;
      out = clip_pixel((((long long)job[kW0] * (v[0] + kInternalOffs) + rnd)
                        >> sh) + job[kOff], bd);
      break;
    }
    default: {
      const int sh = job[kDen] + kInternalPrec + 1 - bd;
      const long long half = (1ll << sh) >> 1;
      out = clip_pixel(((long long)job[kW0] * (v[0] + kInternalOffs)
                        + (long long)job[kW1] * (v[1] + kInternalOffs)
                        + half + (long long)job[kOff] * half) >> sh, bd);
    }
  }
  pred[(long long)job[kDst] + (long long)(ty0 + ty) * job[kStride] + tx0
       + tx] = (int16_t)out;
}

template <int TAPS>
__global__ void __launch_bounds__(kPictureThreads)
mc_blocks_kernel(const int16_t* __restrict__ planes, int rows, int cols,
                 const int* __restrict__ jobs, int16_t* __restrict__ out,
                 int h, int w, int tile_h, int tile_w, int tiles_x,
                 int tiles_per_job, int cs, bool last, int bd) {
  __shared__ Shared sm;
  const long long n = blockIdx.x / tiles_per_job;
  const int t = blockIdx.x - n * tiles_per_job;
  const int ty0 = (t / tiles_x) * tile_h, tx0 = (t % tiles_x) * tile_w;
  const int th = min(tile_h, h - ty0), tw = min(tile_w, w - tx0);
  const int ty = threadIdx.x / tile_w, tx = threadIdx.x % tile_w;
  const bool active = ty < th && tx < tw;
  const int* job = jobs + 5 * n;
  const int16_t* plane = planes + (long long)job[0] * rows * cols;
  const int v = predict<TAPS>(sm, plane, rows, cols, job[1], job[2], job[3],
                              job[4], cs, ty0, tx0, th, tw, ty, tx, active,
                              last, bd);
  if (active) out[(n * h + ty0 + ty) * w + tx0 + tx] = (int16_t)v;
}

// ---- the quarter-pel entry -------------------------------------------

constexpr int kQpelThreads = 224;

// quarter-pel position q = 0..6 (offset q - 3): its integer offset plus 1
// (0 for -3..-1, 1 for 0..3) and its phase ((q - 3) & 3)
__host__ __device__ constexpr int qbase(int q) { return q >= 3 ? 1 : 0; }
__host__ __device__ constexpr int qphase(int q) { return (q + 1) & 3; }

// kLumaTaps[p][k] as a constant expression, so that an unrolled loop
// folds it (zero taps vanish, the identity row's 64 is a shift)
__host__ __device__ constexpr int ltap(int p, int k) {
  return p == 0 ? (k == 3 ? 64 : 0)
       : p == 1 ? (k == 0 ? -1 : k == 1 ? 4 : k == 2 ? -10 : k == 3 ? 58
                   : k == 4 ? 17 : k == 5 ? -5 : k == 6 ? 1 : 0)
       : p == 2 ? (k == 0 || k == 7 ? -1 : k == 1 || k == 6 ? 4
                   : k == 2 || k == 5 ? -11 : 40)
       : (k == 0 ? 0 : k == 1 ? 1 : k == 2 ? -5 : k == 3 ? 17 : k == 4 ? 58
          : k == 5 ? -10 : k == 6 ? 4 : -1);
}

template <int T, int NB>
struct QpelShared {
  // the window: row r, column c holds sample (y0 + r, ax + c), ax the
  // 8-aligned column at or left of the window's x0
  alignas(16) int16_t win[NB][T + 8][T + 16];
  // the first pass of horizontal position p over the window's rows
  alignas(16) int16_t tmp[NB][7][T + 8][T];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ unsigned pack2(int lo, int hi) {
  return (unsigned)(lo & 0xffff) | ((unsigned)hi << 16);
}

// tiles: NB consecutive (block, tile) pairs from blockIdx.x * NB, tile t
// of a block at ((t / tiles_x) * T, (t % tiles_x) * T)
template <int T, int NB>
__global__ void __launch_bounds__(kQpelThreads)
mc_qpel_kernel(const int16_t* __restrict__ planes, int rows, int cols,
               const int* __restrict__ origins, long long n_tiles, int s,
               int tiles_x, int16_t* __restrict__ out, bool aligned,
               int bd) {
  __shared__ QpelShared<T, NB> sm;
  constexpr int kRows = T + 8, kChunks = (T + 16) / 8, kGroups = T / 8;
  const int per_block = tiles_x * tiles_x;
  const long long first = (long long)blockIdx.x * NB;

  // 1. the windows, 16 bytes a step
  for (int e = threadIdx.x; e < NB * kRows * kChunks; e += blockDim.x) {
    const int b = e / (kRows * kChunks);
    const int r = (e / kChunks) % kRows, ch = e % kChunks;
    const long long id = first + b;
    if (id >= n_tiles) continue;
    const long long n = id / per_block;
    const int t = (int)(id - n * per_block);
    const int* o = origins + 3 * n;
    const int y = o[2] - 1 + (t / tiles_x) * T + r;
    const int x = ((o[1] - 1) & ~7) + (t % tiles_x) * T + 8 * ch;
    const int16_t* plane = planes + (long long)o[0] * rows * cols;
    int16_t* dst = &sm.win[b][r][8 * ch];
    if (aligned && y >= 0 && y < rows && x >= 0 && x + 8 <= cols) {
      cp_async16(dst, plane + (long long)y * cols + x);
    } else {
      const int16_t* row = plane + (long long)min(max(y, 0), rows - 1)
                           * cols;
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = row[min(max(x + j, 0), cols - 1)];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. the first pass, once per horizontal position: shift 6 - (14 - bd),
  // offset -8192 << it, wrapped to int16
  const int sh1 = kFilterPrec - (kInternalPrec - bd);
  const int off1 = -kInternalOffs * (1 << sh1);
  for (int e = threadIdx.x; e < NB * kRows * kGroups; e += blockDim.x) {
    const int b = e / (kRows * kGroups);
    const int r = (e / kGroups) % kRows, g = e % kGroups;
    if (first + b >= n_tiles) continue;
    const int c0 = ((origins[3 * ((first + b) / per_block) + 1] - 1) & 7)
                   + 8 * g;
    int v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = sm.win[b][r][c0 + j];
#pragma unroll
    for (int p = 0; p < 7; ++p) {
      int res[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (ltap(qphase(p), k) != 0) {
            acc += v[c + qbase(p) + k] * ltap(qphase(p), k);
          }
        }
        res[c] = (acc + off1) >> sh1;
      }
      *reinterpret_cast<uint4*>(&sm.tmp[b][p][r][8 * g]) = make_uint4(
          pack2(res[0], res[1]), pack2(res[2], res[3]),
          pack2(res[4], res[5]), pack2(res[6], res[7]));
    }
  }
  __syncthreads();

  // 3. the second pass: output row i of an 8-column strip of horizontal
  // position p, for the 7 vertical positions; shift 6 + (14 - bd), the
  // offset of the 2-D case's last pass, clipped to pixels
  const int sh2 = kFilterPrec + kInternalPrec - bd;
  const int off2 = (1 << (sh2 - 1)) + (kInternalOffs << kFilterPrec);
  const int top = (1 << bd) - 1;
  for (int e = threadIdx.x; e < NB * 7 * T * kGroups; e += blockDim.x) {
    const int g = e % kGroups, i = (e / kGroups) % T;
    const int p = (e / (kGroups * T)) % 7, b = e / (7 * T * kGroups);
    const long long id = first + b;
    if (id >= n_tiles) continue;
    const long long n = id / per_block;
    const int t = (int)(id - n * per_block);
    int v[9][8];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          &sm.tmp[b][p][i + k][8 * g]);
      const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[k][2 * c] = (int)(int16_t)(u[c] & 0xffff);
        v[k][2 * c + 1] = (int)u[c] >> 16;
      }
    }
    int16_t* dst = out + ((n * 49 + p) * s + (t / tiles_x) * T + i) * s
                   + (t % tiles_x) * T + 8 * g;
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      int res[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (ltap(qphase(q), k) != 0) {
            acc += v[qbase(q) + k][c] * ltap(qphase(q), k);
          }
        }
        res[c] = min(max((acc + off2) >> sh2, 0), top);
      }
      *reinterpret_cast<uint4*>(dst + (long long)q * 7 * s * s) = make_uint4(
          pack2(res[0], res[1]), pack2(res[2], res[3]),
          pack2(res[4], res[5]), pack2(res[6], res[7]));
    }
  }
}

template <int T, int NB>
int launch_qpel(const int16_t* planes, int rows, int cols,
                const int* origins, long long n, int16_t* out, int s, int bd,
                cudaStream_t st) {
  const int tiles_x = s / T;
  const long long n_tiles = n * tiles_x * tiles_x;
  const long long grid = (n_tiles + NB - 1) / NB;
  if (grid > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(planes) & 15) == 0
                       && cols % 8 == 0;
  mc_qpel_kernel<T, NB><<<(unsigned)grid, kQpelThreads, 0, st>>>(
      planes, rows, cols, origins, n_tiles, s, tiles_x, out, aligned, bd);
  return (int)cudaGetLastError();
}

}  // namespace

// table: int32 [4 * n_planes + JOB_COLS * n_jobs + 3 * n_tiles] on the
// device; pred: int16, written at the jobs' samples only.
extern "C" int thevc_mc_picture(const void* table, int n_planes, int n_jobs,
                                int n_tiles, void* pred, int bd,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_planes <= 0 || n_jobs <= 0 || bd < 8 || bd > 12) {
    return (int)cudaErrorInvalidValue;
  }
  mc_picture_kernel<<<n_tiles, kPictureThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), n_planes, n_jobs,
      static_cast<int16_t*>(pred), bd);
  return (int)cudaGetLastError();
}

// planes: int16 [P, rows, cols]; jobs: int32 [n, 5] of (plane, window x,
// window y, fx, fy); out: int16 [n, h, w].
extern "C" int thevc_mc_blocks(const void* planes, int rows, int cols,
                               const void* jobs, long long n, void* out,
                               int h, int w, int cs, int luma, int bi,
                               int bd, void* stream) {
  if (n <= 0) return 0;
  if (h < 1 || h > 64 || w < 1 || w > 64 || cs < 0 || cs > 3 || bd < 8
      || bd > 12 || rows < 1 || cols < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int tile_h = h < kTile ? h : kTile, tile_w = w < kTile ? w : kTile;
  const int tiles_x = (w + tile_w - 1) / tile_w;
  const int tiles_per_job = tiles_x * ((h + tile_h - 1) / tile_h);
  const long long blocks = n * tiles_per_job;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const int threads = (tile_h * tile_w + 31) / 32 * 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int16_t* p = static_cast<const int16_t*>(planes);
  const int* j = static_cast<const int*>(jobs);
  int16_t* o = static_cast<int16_t*>(out);
  if (luma) {
    mc_blocks_kernel<8><<<(unsigned)blocks, threads, 0, st>>>(
        p, rows, cols, j, o, h, w, tile_h, tile_w, tiles_x, tiles_per_job,
        cs, !bi, bd);
  } else {
    mc_blocks_kernel<4><<<(unsigned)blocks, threads, 0, st>>>(
        p, rows, cols, j, o, h, w, tile_h, tile_w, tiles_x, tiles_per_job,
        cs, !bi, bd);
  }
  return (int)cudaGetLastError();
}

// planes: int16 [P, rows, cols]; origins: int32 [n, 3] of (plane, window
// x, window y), the first tap sample of candidate (0, 0) of each block;
// out: int16 [n, 49, s, s], 16-byte aligned; s in {8, 16, 32, 64}.
extern "C" int thevc_mc_qpel(const void* planes, int rows, int cols,
                             const void* origins, long long n, void* out,
                             int s, int bd, void* stream) {
  if (n <= 0) return 0;
  if (bd < 8 || bd > 12 || rows < 1 || cols < 1
      || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int16_t* p = static_cast<const int16_t*>(planes);
  const int* o = static_cast<const int*>(origins);
  int16_t* d = static_cast<int16_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 8: return launch_qpel<8, 8>(p, rows, cols, o, n, d, s, bd, st);
    case 16: return launch_qpel<16, 2>(p, rows, cols, o, n, d, s, bd, st);
    case 32: return launch_qpel<32, 1>(p, rows, cols, o, n, d, s, bd, st);
    case 64: return launch_qpel<32, 1>(p, rows, cols, o, n, d, s, bd, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
