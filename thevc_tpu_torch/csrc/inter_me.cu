// The P/B fast-RD decision pass's own motion search on an NVIDIA Hopper
// card (sm_90a): three kernels, one a stage of
// thevc_tpu_torch/encoder/fast_inter.py, each equal to its plain form bit
// for bit (coarse_fields_plain, int_refine_plain, merge_model_plain).
//
// They replace, in the XLA device program of the JAX package's P/B pass
// (thevc_tpu/encoder/fast_inter.py _frame_body_p, jitted as one):
//   coarse_search  :98 _coarse_fields (the lax.scan over (reference,
//                  row), :116-159): the quarter-resolution full search of
//                  every size class at once;
//   int_refine     :234-262 in _inter_size_pass: the +-3 full-pel SAD
//                  refinement around the coarse winner with the exp-Golomb
//                  MV prior of the neighbourhood-median predictor;
//   merge_model    :367-428: the AMVP-proxy MV bits, the RD sum and the
//                  3-candidate merge/skip model (left, above, zero MV).
// Every float is an eager float32 op of the plain form in its order,
// written as __fmul_rn / __fadd_rn, and the source is built with
// -fmad=false (ops/build.py SOURCE_FLAGS): no multiply-add is contracted.
// Integer MV bits are bit lengths (32 - __clz), as the plain form's
// exact frexp exponents.
//
// coarse_search, one launch a list (every reference, every offset of the
// +-rng quarter-res window, every size class up to the CTU).  Per offset
// (dy, dx) of reference r the cost of a block of class s is
//   float(SAD) * 4 + sqrt_lam * float(2 * bitlen(mvq + 1) + r),
//   mvq = (|dy - rng| + |dx - rng|) * 16,
// the SAD over the block's (s/4)^2 pooled samples; the winner is the least
// (cost, code), code = (r * n_off + dy) * n_off + dx, which is what the
// plain form's first minimum within a chunk and strict < across chunks
// and references pick.  A CTA owns a 16x16 tile of the pooled source (one
// 64x64 luma block) and its (16 + 2 rng)^2 band of each reference in
// shared memory; a warp takes every eighth offset; lane (cy, cx) holds the
// 2x2-sample cells (cy, cx) and (cy + 4, cx) of the tile's 8x8 cells, its
// 8 source samples in registers.  A cell's SAD is the 8x8 class; shuffles
// over the lane bits sum 16/32/64 (xor 1 and 8; 2 and 16; 4 and the two
// cells).  Each lane keeps the running minimum of the 7 blocks it sees
// (offsets come in increasing code, so a strict < keeps the first); the
// warps' minima meet in shared memory.
// What bounds it: operations.  A list at 1080p and rng 16 is 2 references
// x 33^2 offsets x 272 x 480 pooled samples: 2.84e8 absolute differences,
// about 1.3e9 int32 operations with the sums (0.04 ms at 33.5e12 op/s).
//
// int_refine, one launch a size class and list.  Per block its 49 SADs of
// the (s + 6)^2 window around the coarse winner (each sum |org - cand|
// over s^2 samples, >> bit_inc), the MV prior
//   golomb(mvqx - px) + golomb(mvqy - py) + 2,  golomb(v) = 2 bitlen(2|v|+1) - 1,
// with (px, py) the median of the coarse field's left, above and
// above-right MVs (zero outside the grid), and the first minimum of
//   float(sad) + sqrt_lam * float(bits)
// in (dy, dx) raster order.  A team of threads owns a block (8 threads at
// s = 8, a warp at 16, 128 at 32, 256 at 64), its window in shared
// memory; a thread takes runs of 8 samples of a row, their source in
// registers, reads 14 window samples a candidate row and adds into 49
// sums in registers, which the team adds by shuffles (and shared memory
// across its warps).
// What bounds it: operations, 49 s^2 differences a block: 1.0e8 a class
// and list at 1080p, about 3e8 int32 operations (0.01 ms).
//
// merge_model, one launch a size class and list, a warp a block: the RD
// cost of the winner (its transform-RD estimates given), then the left,
// above and zero candidates' luma predictions (the 2-D 8-tap filter of
// mc_common.cuh, a zero phase on the identity tap row, clipped to pixels)
// and their SSE against the source, as the plain form's int64 sum cast to
// int32 (wrapping: a 64x64 block at 10 bits can) and >> 2 bit_inc; the
// first minimum of d_i + lam (2 + i); the winner's Cb and Cr predictions
// (4 taps, eighth-pel) and SSE; skip against the RD cost with a strict <.
// Each prediction's window and first pass stay in the warp's shared
// memory; the second pass goes to registers and into the SSE at once.
// What bounds it: operations, about 3 x 16 multiply-adds a luma sample
// and 16 a chroma one: 1e8 a class and list at 1080p (a few us).
//
// No entry allocates or synchronises; each launches on the stream it is
// given and returns cudaGetLastError().  The scalars (sqrt_lam, lam, cw)
// are read on the device: no host synchronisation, so a CUDA graph can
// capture the pass.

#include "mc_common.cuh"

namespace {

constexpr int kMaxRefs = 16;       // references a list (HEVC: 16)
constexpr int kMaxRng = 16;        // quarter-res search range (64 full pel)
constexpr int kTile = 16;          // coarse: pooled samples a tile side
constexpr int kBand = kTile + 2 * kMaxRng;
constexpr int kCoarseWarps = 8;
constexpr int kClasses = 4;        // 8, 16, 32, 64
// the coarse tile's blocks, class after class: 64 of 8, 16 of 16, 4 of
// 32, 1 of 64
constexpr int kBase16 = 64, kBase32 = 80, kBase64 = 84, kTileBlocks = 85;

__device__ __forceinline__ int bitlen(unsigned v) { return 32 - __clz(v); }

// xGetComponentBits: the exp-Golomb length of an MV difference
__device__ __forceinline__ int golomb(int v) {
  return 2 * bitlen(2u * (unsigned)abs(v) + 1u) - 1;
}

// ---- coarse_search -------------------------------------------------------

struct CoarseArgs {
  const int16_t* org;                // pooled source [hq, wq]
  const int16_t* refs[kMaxRefs];     // pooled bands [hq + 2 rng, wq + 2 rng]
  const float* sqrt_lam;
  long long* out[kClasses];          // per class int64 [3, hq / b, wq / b]
  int n_refs, hq, wq, rng, n_classes;
};

__device__ __forceinline__ void keep_min(float cost, int code, float& best,
                                         int& best_code) {
  if (cost < best) {
    best = cost;
    best_code = code;
  }
}

__global__ void __launch_bounds__(32 * kCoarseWarps)
coarse_kernel(CoarseArgs a) {
  __shared__ int16_t band[kBand * kBand];
  __shared__ float wcost[kCoarseWarps][kTileBlocks];
  __shared__ int wcode[kCoarseWarps][kTileBlocks];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const int n_off = 2 * a.rng + 1, n_off2 = n_off * n_off;
  const int bw = kTile + 2 * a.rng;
  const int brows = a.hq + 2 * a.rng, bcols = a.wq + 2 * a.rng;
  const int cx = lane & 7, cy = lane >> 3;
  const float sqrt_lam = *a.sqrt_lam;

  // the lane's two cells: source samples, and whether the cell is inside
  int org[2][4];
  bool inside[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int y = ty0 + 2 * (cy + 4 * k), x = tx0 + 2 * cx;
    inside[k] = y < a.hq && x < a.wq;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      org[k][q] = inside[k]
          ? a.org[(long long)(y + (q >> 1)) * a.wq + x + (q & 1)] : 0;
    }
  }
  // the running minima: cells (8), 16s, 32s, the 64
  float best[7];
  int best_code[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    best[k] = __int_as_float(0x7f800000);    // inf
    best_code[k] = 0;
  }

  for (int r = 0; r < a.n_refs; ++r) {
    const int16_t* ref = a.refs[r];
    __syncthreads();
    for (int e = threadIdx.x; e < bw * bw; e += 32 * kCoarseWarps) {
      const int y = min(ty0 + e / bw, brows - 1);
      const int x = min(tx0 + e % bw, bcols - 1);
      band[e] = ref[(long long)y * bcols + x];
    }
    __syncthreads();
    for (int o = warp; o < n_off2; o += kCoarseWarps) {
      const int dy = o / n_off, dx = o - dy * n_off;
      const int mvq = (abs(dy - a.rng) + abs(dx - a.rng)) * 16;
      const float lam_bits =
          __fmul_rn(sqrt_lam, (float)(2 * bitlen((unsigned)mvq + 1u) + r));
      const int code = r * n_off2 + o;
      int s8[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int16_t* b = band + (2 * (cy + 4 * k) + dy) * bw + 2 * cx + dx;
        const int v = abs(org[k][0] - b[0]) + abs(org[k][1] - b[1])
                      + abs(org[k][2] - b[bw]) + abs(org[k][3] - b[bw + 1]);
        s8[k] = inside[k] ? v : 0;
      }
      int s16[2], s32[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        s16[k] = s8[k] + __shfl_xor_sync(0xffffffffu, s8[k], 1);
        s16[k] += __shfl_xor_sync(0xffffffffu, s16[k], 8);
        s32[k] = s16[k] + __shfl_xor_sync(0xffffffffu, s16[k], 2);
        s32[k] += __shfl_xor_sync(0xffffffffu, s32[k], 16);
      }
      int s64 = s32[0] + s32[1];
      s64 += __shfl_xor_sync(0xffffffffu, s64, 4);
      const int sums[7] = {s8[0], s8[1], s16[0], s16[1], s32[0], s32[1],
                           s64};
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        keep_min(__fadd_rn(__fmul_rn((float)sums[k], 4.0f), lam_bits), code,
                 best[k], best_code[k]);
      }
    }
  }

  // each warp's minima per block of the tile, then the least of the warps
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ry = cy + 4 * k;                 // cell row
    const int i8 = ry * 8 + cx;
    wcost[warp][i8] = best[k];
    wcode[warp][i8] = best_code[k];
    if (!(cx & 1) && !(ry & 1)) {
      const int i16 = kBase16 + (ry >> 1) * 4 + (cx >> 1);
      wcost[warp][i16] = best[2 + k];
      wcode[warp][i16] = best_code[2 + k];
    }
    if (!(cx & 3) && !(ry & 3)) {
      const int i32 = kBase32 + (ry >> 2) * 2 + (cx >> 2);
      wcost[warp][i32] = best[4 + k];
      wcode[warp][i32] = best_code[4 + k];
    }
  }
  if (lane == 0) {
    wcost[warp][kBase64] = best[6];
    wcode[warp][kBase64] = best_code[6];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= kTileBlocks) return;
  const int c = t < kBase16 ? 0 : t < kBase32 ? 1
              : t < kBase64 ? 2 : 3;
  if (c >= a.n_classes) return;
  float cost = wcost[0][t];
  int code = wcode[0][t];
  for (int w = 1; w < kCoarseWarps; ++w) {
    const float cw = wcost[w][t];
    const int k = wcode[w][t];
    if (cw < cost || (cw == cost && k < code)) {
      cost = cw;
      code = k;
    }
  }
  const int per = 8 >> c;                    // blocks a tile side
  const int i = t - (c == 0 ? 0 : c == 1 ? kBase16 : c == 2 ? kBase32
                                                            : kBase64);
  const int bq = 2 << c;                     // pooled samples a block side
  const int rows = a.hq / bq, cols = a.wq / bq;
  const int by = ty0 / bq + i / per, bx = tx0 / bq + i % per;
  if (by >= rows || bx >= cols) return;
  const long long nb = (long long)rows * cols;
  long long* out = a.out[c] + (long long)by * cols + bx;
  out[0] = (long long)((code / n_off) % n_off - a.rng) * 4;
  out[nb] = (long long)(code % n_off - a.rng) * 4;
  out[2 * nb] = code / n_off2;
}

// ---- int_refine ----------------------------------------------------------

struct RefineArgs {
  const int16_t* org;                // source plane [org_rows, org_cols]
  const int16_t* refs;               // [n_refs, rows, cols]
  const long long* c_dy;             // coarse field, full pel [nby, nbx]
  const long long* c_dx;
  const long long* c_ref;
  const float* sqrt_lam;
  long long* out_mx;                 // [nby * nbx]
  long long* out_my;
  int org_cols, rows, cols, nby, nbx, bit_inc, pad;
};

template <int S>
struct RefineShape {
  static constexpr int kSegs = S * S / 8;           // runs of 8 samples
  static constexpr int kTeam = kSegs < 256 ? kSegs : 256;
  static constexpr int kBlocks = 256 / kTeam;       // blocks a CTA
  static constexpr int kWin = S + 6;
  static constexpr int kTeamWarps = kTeam >= 32 ? kTeam / 32 : 1;
};

// the median of the coarse field's left, above and above-right MVs at
// (i, j) in quarter pel, zero outside the grid
__device__ __forceinline__ int median_pred(const long long* f, int i, int j,
                                           int nby, int nbx) {
  const int l = j > 0 ? (int)f[(long long)i * nbx + j - 1] * 4 : 0;
  const int u = i > 0 ? (int)f[(long long)(i - 1) * nbx + j] * 4 : 0;
  const int ur = (i > 0 && j + 1 < nbx)
      ? (int)f[(long long)(i - 1) * nbx + j + 1] * 4 : 0;
  return max(min(max(l, u), ur), min(l, u));
}

template <int S>
__global__ void __launch_bounds__(256) int_refine_kernel(RefineArgs a) {
  using Sh = RefineShape<S>;
  constexpr int kW = Sh::kWin, kTeam = Sh::kTeam;
  __shared__ int16_t win[Sh::kBlocks][kW * kW];
  __shared__ int part[Sh::kBlocks][Sh::kTeamWarps][49];
  const int b = threadIdx.x / kTeam, t = threadIdx.x % kTeam;
  const int nb = a.nby * a.nbx;
  const int n = blockIdx.x * Sh::kBlocks + b;
  const bool live = n < nb;
  const int bi = live ? n / a.nbx : 0, bj = live ? n % a.nbx : 0;
  const int by = bi * S, bx = bj * S;
  const int dy0 = live ? (int)a.c_dy[n] : 0;
  const int dx0 = live ? (int)a.c_dx[n] : 0;
  const int16_t* plane =
      a.refs + (live ? a.c_ref[n] : 0) * (long long)a.rows * a.cols;

  // the window: candidate (-3, -3)'s first sample at its (0, 0), read at
  // clamped plane coordinates
  const int y0 = by + dy0 + a.pad - 3, x0 = bx + dx0 + a.pad - 3;
  if (live) {
    for (int e = t; e < kW * kW; e += kTeam) {
      const int y = min(max(y0 + e / kW, 0), a.rows - 1);
      const int x = min(max(x0 + e % kW, 0), a.cols - 1);
      win[b][e] = plane[(long long)y * a.cols + x];
    }
  }
  __syncthreads();

  int acc[49];
#pragma unroll
  for (int k = 0; k < 49; ++k) acc[k] = 0;
  if (live) {
    for (int seg = t; seg < Sh::kSegs; seg += kTeam) {
      const int i = seg / (S / 8), j0 = (seg % (S / 8)) * 8;
      int o[8];
      const int16_t* src = a.org + (long long)(by + i) * a.org_cols + bx + j0;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[c] = src[c];
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        const int16_t* row = win[b] + (i + dy) * kW + j0;
        int w[14];
#pragma unroll
        for (int c = 0; c < 14; ++c) w[c] = row[c];
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          int s = acc[dy * 7 + dx];
#pragma unroll
          for (int c = 0; c < 8; ++c) s += abs(o[c] - w[c + dx]);
          acc[dy * 7 + dx] = s;
        }
      }
    }
  }
  // the team's sums: shuffles within a warp, shared memory across warps
  constexpr int kLanes = kTeam < 32 ? kTeam : 32;
#pragma unroll
  for (int k = 0; k < 49; ++k) {
#pragma unroll
    for (int off = kLanes / 2; off >= 1; off >>= 1) {
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
  }
  if constexpr (Sh::kTeamWarps > 1) {
    const int tw = t >> 5;
    if ((t & 31) == 0) {
#pragma unroll
      for (int k = 0; k < 49; ++k) part[b][tw][k] = acc[k];
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < 49; ++k) {
        int s = part[b][0][k];
        for (int w = 1; w < Sh::kTeamWarps; ++w) s += part[b][w][k];
        acc[k] = s;
      }
    }
  }
  if (t != 0 || !live) return;

  const int px = median_pred(a.c_dx, bi, bj, a.nby, a.nbx);
  const int py = median_pred(a.c_dy, bi, bj, a.nby, a.nbx);
  const float sqrt_lam = *a.sqrt_lam;
  float best = 0.0f;
  int best_k = 0;
#pragma unroll
  for (int k = 0; k < 49; ++k) {
    const int dy = k / 7 - 3, dx = k % 7 - 3;
    const int bits = golomb((dx0 + dx) * 4 - px) + golomb((dy0 + dy) * 4 - py)
                     + 2;
    const float cost = __fadd_rn((float)(acc[k] >> a.bit_inc),
                                 __fmul_rn(sqrt_lam, (float)bits));
    if (k == 0 || cost < best) {
      best = cost;
      best_k = k;
    }
  }
  a.out_mx[n] = dx0 + best_k % 7 - 3;
  a.out_my[n] = dy0 + best_k / 7 - 3;
}

// ---- merge_model ---------------------------------------------------------

struct MergeArgs {
  const int16_t* org[3];             // source planes: luma, Cb, Cr
  const int16_t* refs_y;             // [n_refs, rows_y, cols_y]
  const int16_t* refs_c;             // [2 n_refs, rows_c, cols_c]: Cb, Cr
  const int* d[3];                   // transform-RD dist: luma, Cb, Cr
  const float* bits[3];              // transform-RD bits: luma, Cb, Cr
  const int* mvx;                    // the winner: quarter pel, [nb]
  const int* mvy;
  const int* ref;
  const float* lam;
  const float* cw;
  float* out_rd;                     // [nb]
  int* out_mvx;
  int* out_mvy;
  int* out_ref;
  int org_cols, corg_cols, n_refs, rows_y, cols_y, rows_c, cols_c;
  int nby, nbx, bit_inc, pad_y, pad_c;
};

template <int S>
struct MergeShape {
  static constexpr int kWarps = S == 64 ? 2 : 4;    // blocks a CTA
  static constexpr int kG = S / 8;                  // 8-column groups
  // the warp's shared memory, int16: the luma window [S + 7][8 G + 16]
  // and its first pass [S + 7][8 G] (chroma needs less)
  static constexpr int kSmem = (S + 7) * (16 * kG + 16);
};

// The SSE of one prediction of an h x h block (h = S luma, S / 2 chroma)
// against the source, over a warp: the window at plane coordinates (wx,
// wy) (its first tap sample), phases (fx, fy), clipped to pixels; the
// int64 sum cast to int32 and >> 2 bit_inc, as the plain form.
template <int TAPS, int H>
__device__ int block_sse(int16_t* sm, const int16_t* plane, int rows,
                         int cols, int wx, int wy, int fx, int fy,
                         const int16_t* org, int org_cols, int oy, int ox,
                         int bd, int bit_inc, int lane) {
  constexpr int G = (H + 7) / 8, W8 = 8 * G, WS = W8 + 16;
  constexpr int WR = H + TAPS - 1, NCH = G + 2;
  int16_t* win = sm;
  int16_t* tmp = sm + WR * WS;
  const bool aligned = (reinterpret_cast<uintptr_t>(plane) & 15) == 0
                       && (cols & 7) == 0;
  const int ax = wx & ~7, off = wx & 7;
  __syncwarp();                       // the buffer's last reader is done
  for (int e = lane; e < WR * NCH; e += 32) {
    const int r = e / NCH, ch = e - r * NCH;
    load_chunk(win + r * WS + 8 * ch, plane, rows, cols, ax + 8 * ch, wy + r,
               aligned);
  }
  cp_async_wait_all();
  __syncwarp();
  int tx[TAPS], ty[TAPS];
  taps_of<TAPS>(fx, tx);
  taps_of<TAPS>(fy, ty);
  const int sh1 = kFilterPrec - (kInternalPrec - bd);
  const int off1 = -kInternalOffs * (1 << sh1);
  for (int e = lane; e < WR * G; e += 32) {
    const int r = e / G, g = e - r * G;
    first_pass8<TAPS>(win + r * WS + off + 8 * g, tx, sh1, off1,
                      tmp + r * W8 + 8 * g);
  }
  __syncwarp();
  long long acc = 0;
  for (int e = lane; e < H * G; e += 32) {
    const int i = e / G, g = e - i * G;
    int res[8];
    predict8<TAPS>(k2d, win, WS, off, tmp, W8, i, g, tx, ty, true, bd, res);
    const int16_t* src = org + (long long)(oy + i) * org_cols + ox + 8 * g;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (8 * g + c < H) {
        const long long d = src[c] - res[c];
        acc += d * d;
      }
    }
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return (int)(unsigned)(unsigned long long)acc >> (2 * bit_inc);
}

template <int S>
__global__ void __launch_bounds__(32 * MergeShape<S>::kWarps)
merge_model_kernel(MergeArgs a) {
  using Sh = MergeShape<S>;
  constexpr int CS = S / 2;
  __shared__ __align__(16) int16_t smem[Sh::kWarps][Sh::kSmem];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = a.nby * a.nbx;
  const int n = blockIdx.x * Sh::kWarps + warp;
  if (n >= nb) return;
  const int i = n / a.nbx, j = n % a.nbx;
  const int by = i * S, bx = j * S;
  const int bd = 8 + a.bit_inc;
  const float lam = *a.lam, cw = *a.cw;

  // the winner, and the left and above winners (zero outside the grid)
  const int mx = a.mvx[n], my = a.mvy[n], rf = a.ref[n];
  int cx[3] = {0, 0, 0}, cy[3] = {0, 0, 0}, cr[3] = {0, 0, 0};
  if (j > 0) {
    cx[0] = a.mvx[n - 1];
    cy[0] = a.mvy[n - 1];
    cr[0] = a.ref[n - 1];
  }
  if (i > 0) {
    cx[1] = a.mvx[n - a.nbx];
    cy[1] = a.mvy[n - a.nbx];
    cr[1] = a.ref[n - a.nbx];
  }
  // AMVP-proxy MV bits: the cheaper of the two neighbours as predictor
  const int bits_l = golomb(mx - cx[0]) + golomb(my - cy[0]);
  const int bits_a = golomb(mx - cx[1]) + golomb(my - cy[1]);
  const int mvb = min(bits_l, bits_a) + 2 + rf + 4;
  const int d_c = (int)((unsigned)a.d[1][n] + (unsigned)a.d[2][n]);
  float rd = __fadd_rn((float)a.d[0][n], __fmul_rn(cw, (float)d_c));
  const float b = __fadd_rn(__fadd_rn(__fadd_rn(a.bits[0][n], a.bits[1][n]),
                                      a.bits[2][n]),
                            (float)mvb);
  rd = __fadd_rn(rd, __fmul_rn(lam, b));

  // the merge/skip model: left, above, zero on no-residual luma SSE
  int16_t* sm = smem[warp];
  float m_cost = 0.0f;
  int m = 0;
  for (int c = 0; c < 3; ++c) {
    const int16_t* plane = a.refs_y + (long long)cr[c] * a.rows_y * a.cols_y;
    const int sse = block_sse<8, S>(
        sm, plane, a.rows_y, a.cols_y, bx + (cx[c] >> 2) + a.pad_y - 3,
        by + (cy[c] >> 2) + a.pad_y - 3, cx[c] & 3, cy[c] & 3, a.org[0],
        a.org_cols, by, bx, bd, a.bit_inc, lane);
    const float cost = __fadd_rn((float)sse, __fmul_rn(lam, (float)(2 + c)));
    if (c == 0 || cost < m_cost) {
      m_cost = cost;
      m = c;
    }
  }
  const int sx = cx[m], sy = cy[m], sr = cr[m];
  int d_s = 0;
  for (int p = 0; p < 2; ++p) {
    const int16_t* plane = a.refs_c
        + (long long)(sr + p * a.n_refs) * a.rows_c * a.cols_c;
    const int sse = block_sse<4, CS>(
        sm, plane, a.rows_c, a.cols_c, j * CS + (sx >> 3) + a.pad_c - 1,
        i * CS + (sy >> 3) + a.pad_c - 1, sx & 7, sy & 7, a.org[1 + p],
        a.corg_cols, i * CS, j * CS, bd, a.bit_inc, lane);
    d_s = (int)((unsigned)d_s + (unsigned)sse);
  }
  const float skip_rd = __fadd_rn(m_cost, __fmul_rn(cw, (float)d_s));
  if (lane != 0) return;
  const bool use_skip = skip_rd < rd;
  a.out_rd[n] = use_skip ? skip_rd : rd;
  a.out_mvx[n] = use_skip ? sx : mx;
  a.out_mvy[n] = use_skip ? sy : my;
  a.out_ref[n] = use_skip ? sr : rf;
}

template <int S>
int launch_refine(const RefineArgs& a, cudaStream_t st) {
  const long long nb = (long long)a.nby * a.nbx;
  const long long grid = (nb + RefineShape<S>::kBlocks - 1)
                         / RefineShape<S>::kBlocks;
  int_refine_kernel<S><<<(unsigned)grid, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int S>
int launch_merge(const MergeArgs& a, cudaStream_t st) {
  const long long nb = (long long)a.nby * a.nbx;
  const long long grid = (nb + MergeShape<S>::kWarps - 1)
                         / MergeShape<S>::kWarps;
  merge_model_kernel<S><<<(unsigned)grid, 32 * MergeShape<S>::kWarps, 0,
                          st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// refs: a host array of n_refs device pointers; out: per class (8, 16,
// 32, 64; n_classes of them) an int64 [3, hq / b, wq / b] output, b = s / 4
extern "C" int thevc_coarse_search(const int16_t* org, int hq, int wq,
                                   const int16_t* const* refs, int n_refs,
                                   int rng, const float* sqrt_lam,
                                   long long* const* out, int n_classes,
                                   cudaStream_t st) {
  if (n_refs < 1 || n_refs > kMaxRefs || rng < 0 || rng > kMaxRng
      || n_classes < 1 || n_classes > kClasses || hq <= 0 || wq <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  CoarseArgs a{};
  a.org = org;
  for (int r = 0; r < n_refs; ++r) a.refs[r] = refs[r];
  a.sqrt_lam = sqrt_lam;
  for (int c = 0; c < n_classes; ++c) a.out[c] = out[c];
  a.n_refs = n_refs;
  a.hq = hq;
  a.wq = wq;
  a.rng = rng;
  a.n_classes = n_classes;
  const dim3 grid((wq + kTile - 1) / kTile, (hq + kTile - 1) / kTile);
  coarse_kernel<<<grid, 32 * kCoarseWarps, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int thevc_int_refine(const int16_t* org, int org_cols,
                                const int16_t* refs, int rows, int cols,
                                const long long* c_dy, const long long* c_dx,
                                const long long* c_ref, int s, int nby,
                                int nbx, const float* sqrt_lam, int bit_inc,
                                int pad, long long* out_mx,
                                long long* out_my, cudaStream_t st) {
  RefineArgs a{org, refs, c_dy, c_dx, c_ref, sqrt_lam, out_mx, out_my,
               org_cols, rows, cols, nby, nbx, bit_inc, pad};
  if (nby <= 0 || nbx <= 0) return (int)cudaErrorInvalidValue;
  switch (s) {
    case 8: return launch_refine<8>(a, st);
    case 16: return launch_refine<16>(a, st);
    case 32: return launch_refine<32>(a, st);
    case 64: return launch_refine<64>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// org: luma, Cb, Cr source planes (org_cols and corg_cols columns);
// d / bits: the transform-RD estimates of luma, Cb, Cr
extern "C" int thevc_merge_model(
    const int16_t* const* org, int org_cols, int corg_cols,
    const int16_t* refs_y, int n_refs, int rows_y, int cols_y,
    const int16_t* refs_c, int rows_c, int cols_c, const int* const* d,
    const float* const* bits, const int* mvx, const int* mvy, const int* ref,
    const float* lam, const float* cw, int s, int nby, int nbx, int bit_inc,
    int pad_y, int pad_c, float* out_rd, int* out_mvx, int* out_mvy,
    int* out_ref, cudaStream_t st) {
  MergeArgs a{};
  for (int p = 0; p < 3; ++p) {
    a.org[p] = org[p];
    a.d[p] = d[p];
    a.bits[p] = bits[p];
  }
  a.refs_y = refs_y;
  a.refs_c = refs_c;
  a.mvx = mvx;
  a.mvy = mvy;
  a.ref = ref;
  a.lam = lam;
  a.cw = cw;
  a.out_rd = out_rd;
  a.out_mvx = out_mvx;
  a.out_mvy = out_mvy;
  a.out_ref = out_ref;
  a.org_cols = org_cols;
  a.corg_cols = corg_cols;
  a.n_refs = n_refs;
  a.rows_y = rows_y;
  a.cols_y = cols_y;
  a.rows_c = rows_c;
  a.cols_c = cols_c;
  a.nby = nby;
  a.nbx = nbx;
  a.bit_inc = bit_inc;
  a.pad_y = pad_y;
  a.pad_c = pad_c;
  if (nby <= 0 || nbx <= 0 || n_refs < 1) return (int)cudaErrorInvalidValue;
  switch (s) {
    case 8: return launch_merge<8>(a, st);
    case 16: return launch_merge<16>(a, st);
    case 32: return launch_merge<32>(a, st);
    case 64: return launch_merge<64>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
