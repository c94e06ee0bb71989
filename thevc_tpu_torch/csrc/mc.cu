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
// host work around them, so each entry is one launch a call.
//
// The machinery both generic entries share.  A unit is a band of output
// rows of one job (one plane, one list); its width w takes G = ceil(w / 8)
// groups of 8 columns.
//   - The window (band + taps - 1 rows; 8 G + 16 columns from the
//     8-aligned column at or left of the first tap sample) is read once
//     into int16 shared memory: 16-byte cp.async where a chunk lies inside
//     a plane whose base is 16-byte aligned and whose width is a multiple
//     of 8, clamped per sample elsewhere.
//   - Register-blocked passes: a thread filters 8 consecutive outputs of a
//     row from taps + 7 window samples, the phase's taps in registers.  The
//     2-D case's first pass goes to shared memory as 16-byte stores; its
//     second pass reads taps 16-byte rows of it.  Columns past w are
//     computed from real (clamped) samples and never stored.
//
// thevc_mc_blocks serves the encoder: N jobs (plane, window x, window y,
// fx, fy) of one size and case over a stacked int16 plane tensor [P, H, W].
// Two planes a job on request (plane p and p + pair_off: Cb and Cr of the
// same jobs, stacked [2P, H, W]), out [2, N, h, w]; and on request a
// second job table over a second plane stack (list 1): both lists at 14
// bits in registers, written once as the bi average in pixels.  A CTA owns
// whole blocks at the encoder's sizes (luma 8/16/32/64, chroma 4/8/16/32,
// square; 16 or 32 blocks a CTA at 4 and 8, 8 at 16, 2 at 32, a 64 block as
// two CTAs of 32-row bands), the sizes template parameters; any other
// shape up to 64x64 takes one block a CTA of 128 threads.
//
// thevc_mc_blocks_fields is the same kernel with the P/B pass's jobs
// derived in the CTA from each block's reference and quarter-pel MV (int32
// fields of the size class's block grid, one list or both lists of a bi
// call) as fast_inter._luma_jobs and _chroma_jobs build them, so that the
// pass builds no job table (about nine elementwise launches a table).
//
// thevc_mc_picture serves the decode, one launch a picture over one int32
// device table: per reference plane (pointer low, pointer high, rows,
// columns); then the jobs (one a (PU, component), both lists where it is
// bi-predicted, the JOB_COLS fields below), ordered on the host by their
// count of row bands, most first, then by component and size; then per
// run of equal band counts (first item, first job, bands).  A warp owns
// one item, a band of one job (at most 32 rows and 64 groups: two a
// lane): it loads both lists' windows before its first wait, filters each
// list into registers, combines them (average or weights) and writes the
// pixels straight into the picture's flat prediction buffer (the job's
// destination origin and row stride).  A CTA of 4 warps reads the plane
// descriptors and the run table into shared memory once.
//
// No entry allocates or synchronises; each launches on the stream it is
// given and returns cudaGetLastError().
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
// x, window y): the first tap sample of candidate (0, 0); thevc_mc_qpel_fields
// derives it in the kernel from the block's reference and integer MV (int64
// fields of the class's grid, the coarse search's and the refinement's
// outputs), as fast_inter._qpel_preds does.
//
// What bounds it: bytes.  A call writes 49 predictions a block, about
// 205 MB over a 1088x1920 picture (0.061 ms at 3.35 TB/s).  The 49
// candidates need 7 (s + 8) s first-pass and 49 s^2 second-pass outputs a
// block at 45 nonzero taps over the 7 phases of a pass (7 + 8 + 7 + 1 +
// 7 + 8 + 7, the identity row counted as one), 1.5-1.7 G int32
// operations (0.046-0.051 ms at Hopper's int32 rate).
// The generic entry would spend 49 window loads and 49 first passes where
// 7 horizontal positions exist.  The design:
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

// The interpolation itself (window chunks, first_pass8, predict8) is in
// mc_common.cuh, which the P/B pass's merge model (inter_me.cu) shares.
#include "mc_common.cuh"

namespace {

// job fields (ops/mc_kernel.py names them J_*); list l's six fields at
// kList + 6 * l
enum {
  kH = 0, kW, kLuma, kKind, kDst, kStride, kW0, kW1, kOff, kDen, kList,
  kJobCols = kList + 12
};
enum { kPlane = 0, kWx, kWy, kFx, kFy, kCase };
// job kinds: uni in pixels, bi average, weighted uni, weighted bi
enum { kUni = 0, kBi = 1, kWUni = 2, kWBi = 3 };
// what the blocks entry writes: pixels, 14 bits, or the bi average of two
// lists in pixels
enum { kPixels = 0, k14 = 1, kAvg = 2 };

// ---- the blocks entry --------------------------------------------------

struct BlocksArgs {
  const int16_t* planes[2];  // per list: int16 [P, rows, cols]
  const int* jobs[2];        // per list: int32 [n, 5], or null: the fields
  // the field entry: per list each block's reference and quarter-pel MV,
  // int32 [n] each, block k at (k / fnbx, k % fnbx) of a grid of h x w
  // blocks; its job's window offset foff (the padding less the taps' half
  // less one), MV shift fshift and phase mask fmask (luma 2 and 3,
  // chroma 3 and 7)
  const int* fref[2];
  const int* fmvx[2];
  const int* fmvy[2];
  int fnbx, foff, fshift, fmask;
  int16_t* out;              // int16 [n_out_planes, n, h, w]
  long long n;
  int rows, cols, h, w, cs, n_out_planes, mode, bd;
  int pair_off[2];           // per list: plane index of a job's 2nd plane
  int aligned[2];            // per list: 16-byte chunks may be copied
  int vec;                   // 16-byte output stores (w % 8 == 0)
};

// a per-list field of the arguments, selected without indexing them at
// run time (which would copy the arguments to local memory)
template <class T>
__device__ __forceinline__ T of_list(const T (&v)[2], int l) {
  return l ? v[1] : v[0];
}

// job n of list l: its row of the job table, or derived from the block's
// MV as the P/B pass's job builders (fast_inter._luma_jobs, _chroma_jobs)
// do: (reference, column + (mv >> shift) + off, row + (mv >> shift) +
// off, mv & mask)
__device__ __forceinline__ void job_of(const BlocksArgs& a, int l,
                                       long long n, int (&j)[5]) {
  const int* t = of_list(a.jobs, l);
  if (t) {
#pragma unroll
    for (int k = 0; k < 5; ++k) j[k] = t[5 * n + k];
    return;
  }
  const int mx = of_list(a.fmvx, l)[n], my = of_list(a.fmvy, l)[n];
  const int bi = (int)(n / a.fnbx), bj = (int)(n - (long long)bi * a.fnbx);
  j[0] = of_list(a.fref, l)[n];
  j[1] = bj * a.w + (mx >> a.fshift) + a.foff;
  j[2] = bi * a.h + (my >> a.fshift) + a.foff;
  j[3] = mx & a.fmask;
  j[4] = my & a.fmask;
}

// one unit's list: its plane, the window's aligned first column and its
// offset to the first tap sample, first row, phases
struct UnitSrc {
  const int16_t* plane;
  int ax, off, y0, fx, fy;
};

// threads of a CTA: one 8-column group of NB units of BAND rows each a
// thread at the encoder's sizes, 128 for the other shapes
template <int S, int BAND, int NB>
__host__ __device__ constexpr int blocks_threads() {
  return S ? NB * BAND * ((S + 7) / 8) : 128;
}

// S: the block size (square), or 0 for any h x w up to 64 x 64 (then one
// unit of all h rows a CTA); BAND output rows a unit; NB units a CTA.
// Dynamic shared memory per unit: the lists' windows [WR][WS], then their
// first passes [WR][W8].
template <int TAPS, int S, int BAND, int NB>
__global__ void __launch_bounds__((blocks_threads<S, BAND, NB>()))
mc_blocks_kernel(BlocksArgs a) {
  constexpr int kThreads = blocks_threads<S, BAND, NB>();
  extern __shared__ __align__(16) int16_t dsm[];
  __shared__ UnitSrc src[NB][2];
  __shared__ long long unit_out[NB];   // the unit's first output; -1: none
  const int h = S ? S : a.h, w = S ? S : a.w;
  const int G = (w + 7) / 8, band = S ? BAND : h;
  const int W8 = 8 * G, WS = W8 + 16, WR = band + TAPS - 1, NCH = G + 2;
  const int nl = a.mode == kAvg ? 2 : 1;
  const int bands = h / band;
  const long long per_job = (long long)a.n_out_planes * bands;
  const int win_sz = WR * WS, tmp_sz = WR * W8;
  const int unit_sz = nl * (win_sz + tmp_sz);
  const int tid = threadIdx.x;

  // 0. the units' sources
  if (tid < NB * nl) {
    const int b = tid / nl, l = tid - b * nl;
    const long long u = (long long)blockIdx.x * NB + b;
    if (u < a.n * per_job) {
      const long long n = u / per_job;
      const int rem = (int)(u - n * per_job);
      const int q = rem / bands, bnd = rem - q * bands;
      int j[5];
      job_of(a, l, n, j);
      const int wx = j[1];
      src[b][l] = UnitSrc{of_list(a.planes, l)
                          + (long long)(j[0] + q * of_list(a.pair_off, l))
                          * a.rows * a.cols, wx & ~7, wx & 7,
                          j[2] + bnd * band, j[3], j[4]};
      if (l == 0) unit_out[b] = ((q * a.n + n) * h + bnd * band) * w;
    } else {
      src[b][l].plane = nullptr;
      if (l == 0) unit_out[b] = -1;
    }
  }
  __syncthreads();

  // 1. the windows, 16 bytes a step
  for (int e = tid; e < NB * nl * WR * NCH; e += kThreads) {
    const int ch = e % NCH, r = (e / NCH) % WR, bl = e / (NCH * WR);
    const int b = bl / nl, l = bl - b * nl;
    const UnitSrc s = src[b][l];
    if (!s.plane) continue;
    load_chunk(dsm + b * unit_sz + l * win_sz + r * WS + 8 * ch, s.plane,
               a.rows, a.cols, s.ax + 8 * ch, s.y0 + r,
               of_list(a.aligned, l));
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. the 2-D case's first pass: shift 6 - (14 - bd), offset -8192 << it
  if (a.cs == k2d) {
    const int sh1 = kFilterPrec - (kInternalPrec - a.bd);
    const int off1 = -kInternalOffs * (1 << sh1);
    for (int e = tid; e < NB * nl * WR * G; e += kThreads) {
      const int g = e % G, r = (e / G) % WR, bl = e / (G * WR);
      const int b = bl / nl, l = bl - b * nl;
      const UnitSrc s = src[b][l];
      if (!s.plane) continue;
      int t[TAPS];
      taps_of<TAPS>(s.fx, t);
      int16_t* unit = dsm + b * unit_sz;
      first_pass8<TAPS>(unit + l * win_sz + r * WS + s.off + 8 * g, t, sh1,
                        off1, unit + nl * win_sz + l * tmp_sz + r * W8
                        + 8 * g);
    }
    __syncthreads();
  }

  // 3. the outputs: each list in registers, combined, written
  for (int e = tid; e < NB * band * G; e += kThreads) {
    const int g = e % G, i = (e / G) % band, b = e / (G * band);
    const long long first = unit_out[b];
    if (first < 0) continue;
    const int16_t* unit = dsm + b * unit_sz;
    int res[2][8];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l < nl) {
        const UnitSrc s = src[b][l];
        int tx[TAPS], ty[TAPS];
        taps_of<TAPS>(s.fx, tx);
        taps_of<TAPS>(s.fy, ty);
        predict8<TAPS>(a.cs, unit + l * win_sz, WS, s.off,
                       unit + nl * win_sz + l * tmp_sz, W8, i, g, tx, ty,
                       a.mode == kPixels, a.bd, res[l]);
      }
    }
    if (a.mode == kAvg) {
      const int sh = kInternalPrec + 1 - a.bd;
      const int off = (1 << (sh - 1)) + 2 * kInternalOffs;
      const int top = (1 << a.bd) - 1;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        res[0][c] = min(max((res[0][c] + res[1][c] + off) >> sh, 0), top);
      }
    }
    int16_t* dst = a.out + first + (long long)i * w + 8 * g;
    if (a.vec) {
      store8(dst, res[0]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (8 * g + c < w) dst[c] = (int16_t)res[0][c];
      }
    }
  }
}

template <int TAPS, int S, int BAND, int NB>
int launch_blocks(const BlocksArgs& a, cudaStream_t st) {
  const int h = S ? S : a.h, w = S ? S : a.w;
  const int G = (w + 7) / 8, band = S ? BAND : h;
  const int nl = a.mode == kAvg ? 2 : 1;
  const size_t smem = sizeof(int16_t) * NB * nl * (band + TAPS - 1)
                      * (8 * G + 16 + 8 * G);
  const long long units = a.n * a.n_out_planes * (h / band);
  const long long grid = (units + NB - 1) / NB;
  if (grid > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  mc_blocks_kernel<TAPS, S, BAND, NB>
      <<<(unsigned)grid, blocks_threads<S, BAND, NB>(), smem, st>>>(a);
  return (int)cudaGetLastError();
}

// ---- the picture entry -------------------------------------------------

constexpr int kPicWarps = 4;
// a warp's shared memory, int16 samples: two windows and one first pass
// of its largest band (8 groups of 8 rows: 2 * 15 * 80 + 15 * 64)
constexpr int kPicWarpSmem = 3360;
constexpr int kMaxPlanes = 96;
constexpr int kMaxRuns = 64;

// the output rows of a band of an h x w job: at most 32, and at most 64
// 8-column groups (ops/mc_kernel.py:picture_table counts the same)
__device__ __forceinline__ int band_rows(int h, int w) {
  return min(min(h, 32), 64 / ((w + 7) >> 3));
}

__device__ __forceinline__ const int16_t* plane_ptr(const int* desc) {
  const unsigned long long lo = (unsigned)desc[0], hi = (unsigned)desc[1];
  return reinterpret_cast<const int16_t*>((hi << 32) | lo);
}

// One warp's item: band `band` of `job` (its fields in shared memory),
// the warp's shared memory `sm`, lane `lane`.
template <int TAPS>
__device__ void picture_item(int16_t* sm, const int* job,
                             const int (*desc)[4], int band, int lane,
                             int16_t* __restrict__ pred, int bd) {
  const int h = job[kH], w = job[kW], kind = job[kKind];
  const int G = (w + 7) >> 3, rows_a_band = band_rows(h, w);
  const int r0 = band * rows_a_band, rb = min(rows_a_band, h - r0);
  const int W8 = 8 * G, WS = W8 + 16, WR = rb + TAPS - 1, NCH = G + 2;
  const int nl = (kind == kBi || kind == kWBi) ? 2 : 1;
  int16_t* tmp = sm + 2 * WR * WS;

  // 1. both lists' windows, then one wait
  for (int l = 0; l < nl; ++l) {
    const int* lj = job + kList + 6 * l;
    const int* d = desc[lj[kPlane]];
    const int16_t* plane = plane_ptr(d);
    const int rows = d[2], cols = d[3];
    const bool aligned = (reinterpret_cast<uintptr_t>(plane) & 15) == 0
                         && (cols & 7) == 0;
    const int ax = lj[kWx] & ~7, y0 = lj[kWy] + r0;
    int16_t* win = sm + l * WR * WS;
    for (int e = lane; e < WR * NCH; e += 32) {
      const int r = e / NCH, ch = e - r * NCH;
      load_chunk(win + r * WS + 8 * ch, plane, rows, cols, ax + 8 * ch,
                 y0 + r, aligned);
    }
  }
  cp_async_wait_all();
  __syncwarp();

  // 2. per list: the 2-D case's first pass, then the lane's groups (two
  // at most) in registers
  const int sh1 = kFilterPrec - (kInternalPrec - bd);
  const int off1 = -kInternalOffs * (1 << sh1);
  const int n_groups = rb * G;
  int v[2][2][8] = {};
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    if (l < nl) {
      const int* lj = job + kList + 6 * l;
      const int cs = lj[kCase], off = lj[kWx] & 7;
      int tx[TAPS], ty[TAPS];
      taps_of<TAPS>(lj[kFx], tx);
      taps_of<TAPS>(lj[kFy], ty);
      const int16_t* win = sm + l * WR * WS;
      if (cs == k2d) {
        for (int e = lane; e < WR * G; e += 32) {
          const int r = e / G, g = e - r * G;
          first_pass8<TAPS>(win + r * WS + off + 8 * g, tx, sh1, off1,
                            tmp + r * W8 + 8 * g);
        }
        __syncwarp();
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int e = lane + 32 * s;
        if (e < n_groups) {
          const int i = e / G, g = e - i * G;
          predict8<TAPS>(cs, win, WS, off, tmp, W8, i, g, tx, ty,
                         kind == kUni, bd, v[l][s]);
        }
      }
      __syncwarp();                    // the next list reuses tmp
    }
  }

  // 3. combine and write
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = lane + 32 * s;
    if (e >= n_groups) continue;
    const int i = e / G, g = e - i * G;
    int out[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int v0 = v[0][s][c], v1 = v[1][s][c];
      switch (kind) {
        case kUni:
          out[c] = v0;
          break;
        case kBi: {
          const int sh = kInternalPrec + 1 - bd;
          const int off = (1 << (sh - 1)) + 2 * kInternalOffs;
          out[c] = clip_pixel((v0 + v1 + off) >> sh, bd);
          break;
        }
        case kWUni: {
          const int sh = job[kDen] + kInternalPrec - bd;
          const long long rnd = (1ll << sh) >> 1;
          out[c] = clip_pixel((((long long)job[kW0] * (v0 + kInternalOffs)
                                + rnd) >> sh) + job[kOff], bd);
          break;
        }
        default: {
          const int sh = job[kDen] + kInternalPrec + 1 - bd;
          const long long half = (1ll << sh) >> 1;
          out[c] = clip_pixel(((long long)job[kW0] * (v0 + kInternalOffs)
                               + (long long)job[kW1] * (v1 + kInternalOffs)
                               + half + (long long)job[kOff] * half) >> sh,
                              bd);
        }
      }
    }
    int16_t* dst = pred + job[kDst] + (long long)(r0 + i) * job[kStride]
                   + 8 * g;
    const int cnt = min(8, w - 8 * g);
    if (cnt == 8 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      store8(dst, out);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (c < cnt) dst[c] = (int16_t)out[c];
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kPicWarps)
mc_picture_kernel(const int* __restrict__ table, int n_planes, int n_jobs,
                  int n_runs, int n_items, int16_t* __restrict__ pred,
                  int bd) {
  __shared__ __align__(16) int16_t sm[kPicWarps][kPicWarpSmem];
  __shared__ int desc[kMaxPlanes][4];
  __shared__ int runs[kMaxRuns][3];
  __shared__ int job[kPicWarps][kJobCols];
  const int* jobs = table + 4 * n_planes;
  const int* run_table = jobs + kJobCols * n_jobs;
  for (int e = threadIdx.x; e < 4 * n_planes; e += blockDim.x) {
    desc[e >> 2][e & 3] = table[e];
  }
  for (int e = threadIdx.x; e < 3 * n_runs; e += blockDim.x) {
    runs[e / 3][e % 3] = run_table[e];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x * kPicWarps + warp;
  if (item >= n_items) return;
  int r = 0;
  while (r + 1 < n_runs && runs[r + 1][0] <= item) ++r;
  const int rel = item - runs[r][0], bands = runs[r][2];
  const int j = runs[r][1] + rel / bands, band = rel % bands;
  if (lane < kJobCols) job[warp][lane] = jobs[(long long)kJobCols * j + lane];
  __syncwarp();
  if (job[warp][kLuma]) {
    picture_item<8>(sm[warp], job[warp], desc, band, lane, pred, bd);
  } else {
    picture_item<4>(sm[warp], job[warp], desc, band, lane, pred, bd);
  }
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

// where each block's window starts: a table of origins, or (the field
// entry) each block's reference and integer MV on a grid of s x s blocks
struct QpelOrigins {
  const int* table;          // int32 [n, 3] (plane, window x, window y),
                             // or null
  const long long* ref;      // int64 [n] each: reference, integer MV
  const long long* mx;
  const long long* my;
  int nbx, off;              // blocks a row; the padding less 3
};

// block n's origin (plane, window x, window y): the table's row, or as
// fast_inter._qpel_preds builds it, (ref, column + mx + off, row + my +
// off)
__device__ __forceinline__ void qpel_origin(const QpelOrigins& o, int s,
                                            long long n, int& p, int& x,
                                            int& y) {
  if (o.table) {
    p = o.table[3 * n];
    x = o.table[3 * n + 1];
    y = o.table[3 * n + 2];
    return;
  }
  const int i = (int)(n / o.nbx), j = (int)(n - (long long)i * o.nbx);
  p = (int)o.ref[n];
  x = j * s + (int)o.mx[n] + o.off;
  y = i * s + (int)o.my[n] + o.off;
}

// tiles: NB consecutive (block, tile) pairs from blockIdx.x * NB, tile t
// of a block at ((t / tiles_x) * T, (t % tiles_x) * T)
template <int T, int NB>
__global__ void __launch_bounds__(kQpelThreads)
mc_qpel_kernel(const int16_t* __restrict__ planes, int rows, int cols,
               const QpelOrigins origins, long long n_tiles, int s,
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
    int op, ox, oy;
    qpel_origin(origins, s, n, op, ox, oy);
    const int y = oy - 1 + (t / tiles_x) * T + r;
    const int x = ((ox - 1) & ~7) + (t % tiles_x) * T + 8 * ch;
    const int16_t* plane = planes + (long long)op * rows * cols;
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
    int op, ox, oy;
    qpel_origin(origins, s, (first + b) / per_block, op, ox, oy);
    const int c0 = ((ox - 1) & 7) + 8 * g;
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
                const QpelOrigins& origins, long long n, int16_t* out, int s,
                int bd, cudaStream_t st) {
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

// the arguments both blocks entries share; no jobs, no fields
BlocksArgs blocks_args(const void* planes0, const void* planes1, int rows,
                       int cols, int pair_off0, int pair_off1, long long n,
                       void* out, int h, int w, int cs, int n_out_planes,
                       int mode, int bd) {
  BlocksArgs a{};
  a.planes[0] = static_cast<const int16_t*>(planes0);
  a.planes[1] = static_cast<const int16_t*>(planes1);
  a.out = static_cast<int16_t*>(out);
  a.n = n;
  a.rows = rows;
  a.cols = cols;
  a.h = h;
  a.w = w;
  a.cs = cs;
  a.n_out_planes = n_out_planes;
  a.mode = mode;
  a.bd = bd;
  a.pair_off[0] = pair_off0;
  a.pair_off[1] = pair_off1;
  for (int l = 0; l < 2; ++l) {
    a.aligned[l] = (reinterpret_cast<uintptr_t>(a.planes[l]) & 15) == 0
                   && cols % 8 == 0;
  }
  a.vec = w % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  return a;
}

// the blocks kernel instance of a call's size and component
int dispatch_blocks(const BlocksArgs& a, int luma, cudaStream_t st) {
  const int s = a.h == a.w ? a.h : 0;
  if (luma) {
    switch (s) {
      case 64: return launch_blocks<8, 64, 32, 1>(a, st);
      case 32: return launch_blocks<8, 32, 32, 2>(a, st);
      case 16: return launch_blocks<8, 16, 16, 8>(a, st);
      case 8: return launch_blocks<8, 8, 8, 16>(a, st);
      default: return launch_blocks<8, 0, 64, 1>(a, st);
    }
  }
  switch (s) {
    case 32: return launch_blocks<4, 32, 32, 2>(a, st);
    case 16: return launch_blocks<4, 16, 16, 8>(a, st);
    case 8: return launch_blocks<4, 8, 8, 16>(a, st);
    case 4: return launch_blocks<4, 4, 4, 32>(a, st);
    default: return launch_blocks<4, 0, 64, 1>(a, st);
  }
}

// the quarter-pel kernel instance of a block size
int dispatch_qpel(const int16_t* p, int rows, int cols,
                  const QpelOrigins& o, long long n, int16_t* d, int s,
                  int bd, cudaStream_t st) {
  switch (s) {
    case 8: return launch_qpel<8, 8>(p, rows, cols, o, n, d, s, bd, st);
    case 16: return launch_qpel<16, 2>(p, rows, cols, o, n, d, s, bd, st);
    case 32: return launch_qpel<32, 1>(p, rows, cols, o, n, d, s, bd, st);
    case 64: return launch_qpel<32, 1>(p, rows, cols, o, n, d, s, bd, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// table: int32 [4 * n_planes + JOB_COLS * n_jobs + 3 * n_runs] on the
// device (ops/mc_kernel.py:picture_table); n_items: the bands of all the
// jobs; pred: int16, written at the jobs' samples only.
extern "C" int thevc_mc_picture(const void* table, int n_planes, int n_jobs,
                                int n_runs, int n_items, void* pred, int bd,
                                void* stream) {
  if (n_items <= 0) return 0;
  if (n_planes <= 0 || n_planes > kMaxPlanes || n_jobs <= 0 || n_runs <= 0
      || n_runs > kMaxRuns || bd < 8 || bd > 12) {
    return (int)cudaErrorInvalidValue;
  }
  mc_picture_kernel<<<(n_items + kPicWarps - 1) / kPicWarps,
                      32 * kPicWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), n_planes, n_jobs, n_runs, n_items,
      static_cast<int16_t*>(pred), bd);
  return (int)cudaGetLastError();
}

// planes0 / planes1: int16 [P0 / P1, rows, cols] of list 0 / list 1;
// jobs0 / jobs1: int32 [n, 5] of (plane, window x, window y, fx, fy); with
// n_out_planes 2 a job also predicts plane + pair_off0 (pair_off1); mode:
// 0 pixels, 1 14 bits (list 0 only), 2 the bi average of both lists in
// pixels; out: int16 [n_out_planes, n, h, w].
extern "C" int thevc_mc_blocks(const void* planes0, const void* planes1,
                               int rows, int cols, int pair_off0,
                               int pair_off1, const void* jobs0,
                               const void* jobs1, long long n, void* out,
                               int h, int w, int cs, int luma,
                               int n_out_planes, int mode, int bd,
                               void* stream) {
  if (n <= 0) return 0;
  if (h < 1 || h > 64 || w < 1 || w > 64 || cs < 0 || cs > 3 || bd < 8
      || bd > 12 || rows < 1 || cols < 1 || n_out_planes < 1
      || n_out_planes > 2 || mode < kPixels || mode > kAvg) {
    return (int)cudaErrorInvalidValue;
  }
  BlocksArgs a = blocks_args(planes0, planes1, rows, cols, pair_off0,
                             pair_off1, n, out, h, w, cs, n_out_planes, mode,
                             bd);
  a.jobs[0] = static_cast<const int*>(jobs0);
  a.jobs[1] = static_cast<const int*>(jobs1);
  return dispatch_blocks(a, luma, static_cast<cudaStream_t>(stream));
}

// jobs derived from MV fields (BlocksArgs fref, fmvx, fmvy): per list the
// references and quarter-pel MVs ref / mvx / mvy, int32 [n] each, of n
// blocks of size x size on a grid nbx blocks wide, planes padded by pad
// (the first tap sample of block (i, j) at MV 0 is (i size + pad - taps /
// 2 + 1, j size + pad - taps / 2 + 1)); the 2-D case at every phase; the
// rest as thevc_mc_blocks.
extern "C" int thevc_mc_blocks_fields(
    const void* planes0, const void* planes1, int rows, int cols,
    int pair_off0, int pair_off1, const void* ref0, const void* mvx0,
    const void* mvy0, const void* ref1, const void* mvx1, const void* mvy1,
    long long n, int nbx, int pad, void* out, int size, int luma,
    int n_out_planes, int mode, int bd, void* stream) {
  if (n <= 0) return 0;
  if (size < 1 || size > 64 || nbx < 1 || n % nbx || bd < 8 || bd > 12
      || rows < 1 || cols < 1 || n_out_planes < 1 || n_out_planes > 2
      || mode < kPixels || mode > kAvg || !ref0 || !mvx0 || !mvy0
      || (mode == kAvg && (!ref1 || !mvx1 || !mvy1))) {
    return (int)cudaErrorInvalidValue;
  }
  BlocksArgs a = blocks_args(planes0, planes1, rows, cols, pair_off0,
                             pair_off1, n, out, size, size, k2d,
                             n_out_planes, mode, bd);
  a.fref[0] = static_cast<const int*>(ref0);
  a.fmvx[0] = static_cast<const int*>(mvx0);
  a.fmvy[0] = static_cast<const int*>(mvy0);
  a.fref[1] = static_cast<const int*>(ref1);
  a.fmvx[1] = static_cast<const int*>(mvx1);
  a.fmvy[1] = static_cast<const int*>(mvy1);
  a.fnbx = nbx;
  a.fshift = luma ? 2 : 3;
  a.fmask = luma ? 3 : 7;
  a.foff = pad - (luma ? 3 : 1);
  return dispatch_blocks(a, luma, static_cast<cudaStream_t>(stream));
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
  QpelOrigins o{static_cast<const int*>(origins), nullptr, nullptr,
                nullptr, 0, 0};
  return dispatch_qpel(static_cast<const int16_t*>(planes), rows, cols, o,
                       n, static_cast<int16_t*>(out), s, bd,
                       static_cast<cudaStream_t>(stream));
}

// ref, mx, my: int64 [n] each, the references and integer MVs (full pel)
// of n blocks of s x s on a grid nbx blocks wide, planes padded by pad:
// block (i, j)'s origin is (ref, j s + mx + pad - 3, i s + my + pad - 3);
// the rest as thevc_mc_qpel.
extern "C" int thevc_mc_qpel_fields(const void* planes, int rows, int cols,
                                    const void* ref, const void* mx,
                                    const void* my, long long n, int nbx,
                                    int pad, void* out, int s, int bd,
                                    void* stream) {
  if (n <= 0) return 0;
  if (bd < 8 || bd > 12 || rows < 1 || cols < 1 || nbx < 1 || n % nbx
      || !ref || !mx || !my
      || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  QpelOrigins o{nullptr, static_cast<const long long*>(ref),
                static_cast<const long long*>(mx),
                static_cast<const long long*>(my), nbx, pad - 3};
  return dispatch_qpel(static_cast<const int16_t*>(planes), rows, cols, o,
                       n, static_cast<int16_t*>(out), s, bd,
                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
