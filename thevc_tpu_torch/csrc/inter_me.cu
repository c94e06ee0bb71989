// The P/B fast-RD decision pass's own motion search and picks on an
// NVIDIA Hopper card (sm_90a): five kernels of
// thevc_tpu_torch/encoder/fast_inter.py, each equal to its plain form bit
// for bit (coarse_fields_plain, int_refine_plain, merge_model_plain,
// qpel_pick_plain, bi_pick_plain).
//
// They replace, in the XLA device program of the JAX package's P/B pass
// (thevc_tpu/encoder/fast_inter.py _frame_body_p, jitted as one):
//   coarse_search  :98 _coarse_fields (the lax.scan over (reference,
//                  row), :116-159): the quarter-resolution full search of
//                  every size class at once;
//   int_refine     :234-262 in _inter_size_pass: the +-3 full-pel SAD
//                  refinement around the coarse winner with the exp-Golomb
//                  MV prior of the neighbourhood-median predictor;
//   qpel_pick      :280-314: the quarter-pel candidates' MV prior, costs
//                  and first minimum (their SATD is K2's);
//   merge_model    :367-428: the AMVP-proxy MV bits, the RD sum and the
//                  3-candidate merge/skip model (left, above, zero MV);
//   bi_pick        :507-526 and :649-651: the bi stage's MV bits and RD
//                  sum and the L0/L1/BI direction.
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
// and references pick.
// What bounds it on this card: the instruction rate.  A list at 1080p and
// rng 16 is 2 references x 33^2 offsets x 272 x 480 pooled samples,
// 2.84e8 absolute differences, and 9.4e7 block costs (85 blocks a 16x16
// tile and offset), with no reuse of a band sample across offsets unless
// the design keeps it in registers.  So:
// - A CTA owns a 16x16 pooled tile (one 64x64 luma block); its 16
//   half-warps ("slots", 256 threads) each take items (reference, dy, a
//   run of 12 dx offsets) in increasing code, so that a strict < keeps
//   the first of equal costs; the slots' minima meet in shared memory by
//   (cost, code).  No offset is divided: items are counted in a loop.
// - A thread owns a 4x4 region (a 16x16 block: four 8x8 cells), its 16
//   source samples in registers, and slides each band row (16 floats,
//   four 16-byte reads, conflict-free at a 52-float row stride) over its
//   12 offsets: a band sample feeds up to 4 offsets from registers.
// - Differences and sums are float32: every value is an integer below
//   2^24 (a 64x64 block's SAD of int16 samples is at most 256 x 65535),
//   so they are exact and run on the float pipe, two instructions a
//   difference (a subtraction, an add of absolute values); the cost is
//   one exact fma (sad x 4 is exact) of the per-offset sqrt_lam term,
//   which a shared table holds (+inf past the window: those offsets of
//   the last run never win).
// - A thread prices its 4 cells and its 16x16 block once an offset; the
//   32x32 and 64x64 sums come from 2 + 2 shuffles over the half-warp.
// - Two CTAs of 256 threads an SM; the references' bands go to shared
//   memory two at a time.
//
// int_refine, one launch a size class and list.  Per block its 49 SADs of
// the (s + 6)^2 window around the coarse winner (each sum |org - cand|
// over s^2 samples, >> bit_inc), the MV prior
//   golomb(mvqx - px) + golomb(mvqy - py) + 2,  golomb(v) = 2 bitlen(2|v|+1) - 1,
// with (px, py) the median of the coarse field's left, above and
// above-right MVs (zero outside the grid), and the first minimum of
//   float(sad) + sqrt_lam * float(bits)
// in (dy, dx) raster order.
// What bounds it on this card: the instruction issue.  A class and list
// at 1080p is 49 s^2 nb = 1.0e8 differences whatever s (nb = 32640,
// 8160, 2040, 510), 8.2e8 for a B frame's 8 calls.  On the integer pipe
// (64 lanes an SM) a difference is a subtraction, an absolute value and
// an add; on the float pipe (128 lanes) two instructions, which is the
// bound (chip_smoke.py inter_me_bound: 0.0496 ms for the 8 calls).  So:
// - Differences are float32: samples become 2^23 + sample as they land
//   (one byte permute: samples are pixels, below 2^16), the sums start
//   at 2^23, and a lane sums 32 samples, so every value is an integer
//   below 2^24 and exact; a difference is a subtraction and an add of
//   its absolute value (an operand modifier).  The sums' float bits are
//   2^23's plus the integer sum: the team adds them as integers and
//   takes the biases off at the end.
// - A team a block, 32 source samples (four runs of 8 of a row) a lane:
//   2 lanes at s = 8, 8 at 16, a warp at 32, four warps at 64, so that
//   every lane makes the same 3136 differences and each class at 1080p
//   is 2040 warps, 15.5 an SM: every CTA of a call is resident at once
//   (64 threads at s = 8, 128 else, at most 128 registers, 8 or 4 CTAs
//   an SM).  So no team takes a second block, and no window waits for
//   another's sums: a team's window is read once, at its start, while
//   the other CTAs on the SM sum theirs.
// - The windows go to shared memory as floats, rows padded so that a
//   lane reads its 14 samples of a candidate row in 16-byte loads (8-byte
//   at s = 8), the rows a quarter-warp reads on distinct banks; each
//   read feeds the 7 dx offsets from registers.  Where a window lies
//   inside the padded plane (always, for search ranges up to 64 and
//   PAD_FULL's 80) groups of 8 lanes read its rows, a word a lane, so
//   that a load touches the lines of 4 rows and not of 32, and every
//   load of a lane is issued before the first is used; else its team
//   reads at clamped coordinates, as the plain form's gather.
// - The team's 49 sums are reduce-scattered (slot dy * 8 + dx, 64 with
//   the empty dx = 7 and dy = 7): each shuffle round halves the slots a
//   lane holds, 32 + 16 + ... + 64 / lanes shuffles instead of 49 a
//   butterfly round, and lane l ends with the sums of slots l * 64 /
//   lanes on (at s = 64 each warp's, the first warp adding the four
//   warps' columns from shared memory).  Each lane prices its own slots
//   in the plain form's float order and the lanes take the least (cost,
//   slot): the first minimum in raster order, ties included.  The lanes
//   that price read the predictor's neighbours at the start.
// What bounds it now (H100 80GB HBM3, 700.00 W; PERF.md section 6): the
// differences issue at about 0.7 of the float pipe's rate (all but 1 %
// of the summing code is float adds, each with a one-cycle stall), about
// 10 us of a 15-22 us call; the fill adds 1.4 us at s = 64 to 8 us at
// s = 8, where 32640 overlapping windows are about 28 MB of L2 sectors;
// a team's window is needed before its first sum, so only other CTAs'
// sums hide it.
//
// merge_model, one launch a size class and list: the RD cost of the
// winner (its transform-RD estimates given), then the left, above and
// zero candidates' luma predictions (the 2-D 8-tap filter of
// mc_common.cuh, a zero phase on the identity tap row, clipped to pixels)
// and their SSE against the source, as the plain form's int64 sum cast to
// int32 (wrapping: a 64x64 block at 10 bits can) and >> 2 bit_inc; the
// first minimum of d_i + lam (2 + i); the winner's Cb and Cr predictions
// (4 taps, eighth-pel) and SSE; skip against the RD cost with a strict <.
// What bounds it on this card: latency.  Its bytes (the distinct window
// samples, 0.035 ms for a B frame's 8 calls) and its filter taps are
// small, but each block chains waits on global memory, barriers and
// dependent multiply-adds, and a list at s = 64 has only 510 blocks.
// So:
// - A team a block sized to it: 8 lanes at s = 8 (four blocks a warp, a
//   lane a row), a warp at 16, two at 32, eight at 64 (510 CTAs of 256
//   threads, capped at 64 registers so that all fit the card at once); a
//   team waits on its own barrier (a warp's lanes, or a named barrier).
// - Only distinct candidates are predicted: where left, above or zero
//   share MV and reference (static areas, out-of-grid neighbours) the SSE
//   is reused; the same inputs give the same sum, and the order and the
//   strict < of the first minimum stay.
// - The source samples a thread compares go to its registers once a
//   block, requested with the windows, so that no SSE waits on global
//   memory.
// - The first two distinct luma windows are requested at once (one
//   cp.async group each, waited for one by one); the third, where there
//   is one, once the first is priced, so that it arrives while the second
//   is.  Two windows a block in shared memory: at s = 8 eight CTAs of 16
//   blocks an SM (three would allow five).  So a block waits on
//   global memory twice: its luma windows, then the chosen candidate's Cb
//   and Cr windows, both requested together (prefetching every
//   candidate's chroma would read about 2.5x the chroma bytes for one
//   use).
// - A zero phase takes its identity row's one tap (the plain form's sum
//   of 8 with 7 zeros, bit for bit): the first pass of a zero vertical
//   phase covers only the rows the second pass reads, and a full-pel
//   candidate (the zero MV always) needs no first pass at all.
// - Both filter passes take two taps an instruction (__dp2a_lo on int16
//   sample pairs: an aligned word, or one byte permute of two; the second
//   pass pairs two rows column by column), the integer sums of the plain
//   form's tap by tap products.
// - The SSE is an unsigned 32-bit sum that wraps: the int64 sum cast to
//   int32, half the shuffles of a 64-bit one.
//
// qpel_pick (kernel D), one launch a size class and list, after K2's SATD
// of the 49 quarter-pel candidates: per block the exp-Golomb bits of each
// candidate against the median predictor of the coarse field (as
// int_refine's), the cost float(satd) + sqrt_lam * float(bits) and the
// first minimum in candidate order (qdy + 3) * 7 + qdx + 3 -> the winner's
// quarter-pel MV and its reference as int32.  It replaces
// thevc_tpu/encoder/fast_inter.py:280-314 (the predictor :226, _mv_pred_median
// :82).  What bounds it on this card: bytes, 196 of SATD a block (6.4 MB
// at s = 8 at 1080p, about 2 us), and a call's latency.  A thread a block
// (128 a CTA): the CTA's SATD rows, one contiguous run, are staged in
// shared memory with coalesced loads, then each thread walks its 49 costs
// in order with a strict <, its 7 x bits in registers.
//
// bi_pick (kernel E), one launch a B frame over every inter size class
// (the class table in the parameter space, __grid_constant__, as
// intra_select.cu's kernels): per block the two lists' MV bits
// sum (golomb(mvx) + golomb(mvy) + 2 + ref) as an integer, the bi RD sum
// rd_bi = d_y + cw (d_cb + d_cr), then + lam (b_y + b_cb + b_cr + mvbits
// + 5) left to right, rd = min(min(rd0, rd1), rd_bi) and the direction 3
// where rd == rd_bi, else 1 where rd == rd0, else 2, the tests on the
// minimum as computed.  It replaces fast_inter.py:507-526 (the MV bits and
// RD sum of _bi_size_pass) and :649-651 (the direction).  What bounds it:
// bytes (22 words a block in, 2 out; 3.8 MB for a 1080p frame) and one
// launch's latency; a thread a block.  Its outputs are the inter leaves'
// rd and dir that the DP kernel (intra_select.cu) reads.
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

constexpr int kSlots = 16;                       // half-warps a CTA
constexpr int kRun = 12;                         // dx offsets an item
constexpr int kMaxRuns = (2 * kMaxRng + kRun) / kRun;        // 3
constexpr int kLbRow = kMaxRuns * kRun;          // 36 table entries a dy
constexpr int kGroupRefs = 2;                    // bands in shared memory
constexpr int kBandRows = kTile + 2 * kMaxRng;   // 48
// floats a band row: 48 and the reads of the last run's masked offsets
// (4 bx + 24 + 15 <= 51); 52 = 4 mod 8 16-byte units keeps the 16-byte
// reads of a quarter-warp (bx 0..3, two by) on distinct banks
constexpr int kBandStride = 52;

struct CoarseArgs {
  const int16_t* org;                // pooled source [hq, wq]
  const int16_t* refs[kMaxRefs];     // pooled bands [hq + 2 rng, wq + 2 rng]
  const float* sqrt_lam;
  long long* out;                    // per class int64 [3, hq / b, wq / b],
                                     // class after class
  int n_refs, hq, wq, rng, n_classes;
};

__device__ __forceinline__ void keep_min(float cost, int code, float& best,
                                         int& best_code) {
  if (cost < best) {
    best = cost;
    best_code = code;
  }
}

__device__ __forceinline__ void load16(const float* p, float (&w)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
}

__global__ void __launch_bounds__(32 * kSlots / 2, 2)
coarse_kernel(CoarseArgs a) {
  __shared__ __align__(16) float band[kGroupRefs][kBandRows * kBandStride];
  __shared__ __align__(16) float lbt[kGroupRefs][(2 * kMaxRng + 1) * kLbRow];
  __shared__ __align__(16) float lb_idle[kRun];
  __shared__ float wcost[kSlots][kTileBlocks];
  __shared__ int wcode[kSlots][kTileBlocks];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, half = (tid >> 4) & 1, slot = tid >> 4;
  const int l16 = tid & 15, bx = l16 & 3, by = l16 >> 2;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const int rng = a.rng, n_off = 2 * rng + 1, n_off2 = n_off * n_off;
  const int n_runs = (n_off + kRun - 1) / kRun;
  const int bcols = a.wq + 2 * rng, brows = a.hq + 2 * rng;
  const float sqrt_lam = *a.sqrt_lam;
  const float inf = __int_as_float(0x7f800000);
  if (tid < kRun) lb_idle[tid] = inf;

  // the thread's 4x4 source samples (0 outside the picture: those cells'
  // blocks are never written)
  float src[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = ty0 + 4 * by + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = tx0 + 4 * bx + j;
      src[i][j] = (y < a.hq && x < a.wq)
          ? (float)a.org[(long long)y * a.wq + x] : 0.0f;
    }
  }
  // running minima: the 4 cells (8x8 class), the 16, 32 and 64 blocks
  float best[7];
  int best_code[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    best[k] = inf;
    best_code[k] = 0;
  }

  for (int r0 = 0; r0 < a.n_refs; r0 += kGroupRefs) {
    const int ng = min(kGroupRefs, a.n_refs - r0);
    __syncthreads();                  // the last group's readers are done
    for (int e = tid; e < ng * kBandRows * kBandStride; e += 32 * kSlots / 2) {
      const int g = e / (kBandRows * kBandStride);
      const int rest = e - g * (kBandRows * kBandStride);
      const int row = rest / kBandStride, col = rest - row * kBandStride;
      const int y = min(ty0 + row, brows - 1), x = min(tx0 + col, bcols - 1);
      band[g][rest] = (float)a.refs[r0 + g][(long long)y * bcols + x];
    }
    for (int e = tid; e < ng * n_off * kLbRow; e += 32 * kSlots / 2) {
      const int g = e / (n_off * kLbRow);
      const int rest = e - g * (n_off * kLbRow);
      const int dy = rest / kLbRow, dx = rest - dy * kLbRow;
      const int mvq = (abs(dy - rng) + abs(dx - rng)) * 16;
      lbt[g][rest] = dx < n_off
          ? __fmul_rn(sqrt_lam,
                      (float)(2 * bitlen((unsigned)mvq + 1u) + r0 + g))
          : inf;
    }
    __syncthreads();

    // items (reference, dy, run) in increasing code; a warp's two slots
    // take items 2 w + 16 m and 2 w + 1 + 16 m, the warp's trip count
    // the first slot's (an idle slot prices +inf)
    const int per_ref = n_off * n_runs, n_items = ng * per_ref;
    for (int t0 = 2 * warp; t0 < n_items; t0 += kSlots) {
      const int item = min(t0 + half, n_items - 1);
      const int g = item / per_ref;
      const int rest = item - g * per_ref;
      const int dy = rest / n_runs, run = rest - dy * n_runs;
      const float* lbp = t0 + half < n_items
          ? &lbt[g][dy * kLbRow + run * kRun] : lb_idle;
      const int code0 = ((r0 + g) * n_off + dy) * n_off + run * kRun;
      const float* bp = band[g] + (4 * by + dy) * kBandStride + 4 * bx
                        + run * kRun;
      // acc[c][k]: cell c (0 top-left, 1 top-right, 2 bottom-left, 3
      // bottom-right) at offset dx = run * 12 + k
      float acc[4][kRun];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float w[16];
        load16(bp + i * kBandStride, w);
        const int c = (i >> 1) * 2;
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          const float l = fabsf(src[i][0] - w[k]) + fabsf(src[i][1] - w[k + 1]);
          const float r = fabsf(src[i][2] - w[k + 2])
                          + fabsf(src[i][3] - w[k + 3]);
          if (i & 1) {
            acc[c][k] += l;
            acc[c + 1][k] += r;
          } else {
            acc[c][k] = l;
            acc[c + 1][k] = r;
          }
        }
      }
      float lb[kRun];
#pragma unroll
      for (int q = 0; q < kRun / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(lbp)[q];
        lb[4 * q] = v.x;
        lb[4 * q + 1] = v.y;
        lb[4 * q + 2] = v.z;
        lb[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const int code = code0 + k;
        const float s16 = (acc[0][k] + acc[1][k]) + (acc[2][k] + acc[3][k]);
        float s32 = s16 + __shfl_xor_sync(0xffffffffu, s16, 1);
        s32 += __shfl_xor_sync(0xffffffffu, s32, 4);
        float s64 = s32 + __shfl_xor_sync(0xffffffffu, s32, 2);
        s64 += __shfl_xor_sync(0xffffffffu, s64, 8);
        // float(sad) * 4 is exact: one rounding, as the plain form's two
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          keep_min(__fmaf_rn(acc[c][k], 4.0f, lb[k]), code, best[c],
                   best_code[c]);
        }
        keep_min(__fmaf_rn(s16, 4.0f, lb[k]), code, best[4], best_code[4]);
        keep_min(__fmaf_rn(s32, 4.0f, lb[k]), code, best[5], best_code[5]);
        keep_min(__fmaf_rn(s64, 4.0f, lb[k]), code, best[6], best_code[6]);
      }
    }
  }

  // each slot's minima per block of the tile, then the least of the slots
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i8 = (2 * by + (c >> 1)) * 8 + 2 * bx + (c & 1);
    wcost[slot][i8] = best[c];
    wcode[slot][i8] = best_code[c];
  }
  wcost[slot][kBase16 + l16] = best[4];
  wcode[slot][kBase16 + l16] = best_code[4];
  if (!(bx & 1) && !(by & 1)) {
    const int i32 = kBase32 + (by >> 1) * 2 + (bx >> 1);
    wcost[slot][i32] = best[5];
    wcode[slot][i32] = best_code[5];
  }
  if (l16 == 0) {
    wcost[slot][kBase64] = best[6];
    wcode[slot][kBase64] = best_code[6];
  }
  __syncthreads();
  if (tid >= kTileBlocks) return;
  const int c = tid < kBase16 ? 0 : tid < kBase32 ? 1
              : tid < kBase64 ? 2 : 3;
  if (c >= a.n_classes) return;
  float cost = wcost[0][tid];
  int code = wcode[0][tid];
  for (int w = 1; w < kSlots; ++w) {
    const float cw = wcost[w][tid];
    const int k = wcode[w][tid];
    if (cw < cost || (cw == cost && k < code)) {
      cost = cw;
      code = k;
    }
  }
  const int per = 8 >> c;                    // blocks a tile side
  const int i = tid - (c == 0 ? 0 : c == 1 ? kBase16 : c == 2 ? kBase32
                                                              : kBase64);
  const int bq = 2 << c;                     // pooled samples a block side
  const int rows = a.hq / bq, cols = a.wq / bq;
  const int oy = ty0 / bq + i / per, ox = tx0 / bq + i % per;
  if (oy >= rows || ox >= cols) return;
  long long* out = a.out;
  for (int k = 0; k < c; ++k) {
    out += 3ll * (a.hq / (2 << k)) * (a.wq / (2 << k));
  }
  const long long nb = (long long)rows * cols;
  out += (long long)oy * cols + ox;
  out[0] = (long long)((code / n_off) % n_off - rng) * 4;
  out[nb] = (long long)(code % n_off - rng) * 4;
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
  // lanes a block: 32 source samples each, four runs of 8 of a row
  static constexpr int kTeam = S * S / 32;             // 2, 8, 32, 128
  static constexpr int kThreads = S == 8 ? 64 : 128;
  static constexpr int kBlocks = kThreads / kTeam;     // 32, 16, 4, 1
  // s = 8 and 16 are held to 128 registers (8 or 4 CTAs, 16 warps an SM:
  // every CTA of a 1080p call at once); s = 32 and 64 stay below it
  // uncapped, and a cap costs them time
  static constexpr int kMinCtas = S == 8 ? 8 : S == 16 ? 4 : 1;
  static constexpr int kLanes = kTeam < 32 ? kTeam : 32;  // in one warp
  static constexpr int kSlots = 64 / kLanes;           // sums a lane prices
  static constexpr int kWin = S + 6;
  static constexpr int kPairs = kWin / 2;              // sample pairs a row
  // floats a window row: 14 at s = 8 (8-byte reads; a 16-lane phase's
  // 8 blocks x 2 rows fall on distinct banks), else a multiple of 4 with
  // an odd count of 16-byte units (a quarter-warp's 8 rows on distinct
  // banks) and room for the 16-float reads of the last run
  static constexpr int kStride = S == 8 ? 14 : S == 16 ? 28 : S == 32 ? 44
                                                                    : 76;
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

// 2^23 + the low (high) 16-bit sample of a word, as a float: one byte
// permute, exact for samples 0..65535
constexpr float kBias = 8388608.0f;                    // 2^23
constexpr unsigned kBiasBits = 0x4B000000u;
__device__ __forceinline__ float lo_biased(unsigned w) {
  return __int_as_float(__byte_perm(w, kBiasBits, 0x7410));
}
__device__ __forceinline__ float hi_biased(unsigned w) {
  return __int_as_float(__byte_perm(w, kBiasBits, 0x7432));
}

// the k-th run of 8 source samples (row i, column j0) of lane t
template <int S>
__device__ __forceinline__ void refine_run(int t, int k, int& i, int& j0) {
  if constexpr (S == 8) {
    i = t + 2 * k;
    j0 = 0;
  } else if constexpr (S == 16) {
    i = t + 8 * (k >> 1);
    j0 = 8 * (k & 1);
  } else if constexpr (S == 32) {
    i = t;
    j0 = 8 * k;
  } else {
    i = t & 63;
    j0 = 32 * (t >> 6) + 8 * k;
  }
}

// one round of the reduce-scatter: lanes M apart add the C slots of the
// half each keeps (the upper one where the lane has bit M), then the next
// round on those C
template <int C, int M>
__device__ __forceinline__ void scatter_round(unsigned (&v)[64], int lane) {
  const bool upper = lane & M;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const unsigned send = upper ? v[j] : v[j + C];
    const unsigned keep = upper ? v[j + C] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
  if constexpr (M > 1) scatter_round<C / 2, M / 2>(v, lane);
}

// a team's barrier: its warp's lanes, or at s = 64 the CTA
template <int S>
__device__ __forceinline__ void team_sync() {
  if constexpr (S == 64) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

template <int S>
__global__ void __launch_bounds__(RefineShape<S>::kThreads,
                                  RefineShape<S>::kMinCtas)
int_refine_kernel(RefineArgs a) {
  using Sh = RefineShape<S>;
  constexpr int kW = Sh::kWin, kTeam = Sh::kTeam, kStride = Sh::kStride;
  constexpr int kLanes = Sh::kLanes;
  __shared__ __align__(16) float win[Sh::kBlocks][kW * kStride];
  __shared__ __align__(8) unsigned part[S == 64 ? 4 : 1][64];
  __shared__ long long origin[Sh::kBlocks];      // a window's first sample
  const int b = threadIdx.x / kTeam, t = threadIdx.x % kTeam;
  const int lane = threadIdx.x & 31;
  const int nb = a.nby * a.nbx;
  const int n = blockIdx.x * Sh::kBlocks + b;
  // a team past the grid repeats the last block and writes nothing: every
  // lane takes part in the warp's shuffles
  const int nn = min(n, nb - 1);
  const int bi = nn / a.nbx, bj = nn % a.nbx;
  const int by = bi * S, bx = bj * S;
  const int dy0 = (int)a.c_dy[nn], dx0 = (int)a.c_dx[nn];
  const int16_t* plane = a.refs + a.c_ref[nn] * (long long)a.rows * a.cols;
  // the lanes that price candidates (at s = 64 the first warp) read the
  // predictor now, so that its loads land while the sums run
  int px = 0, py = 0;
  if (S < 64 || threadIdx.x < 32) {
    px = median_pred(a.c_dx, bi, bj, a.nby, a.nbx);
    py = median_pred(a.c_dy, bi, bj, a.nby, a.nbx);
  }
  const float sqrt_lam = *a.sqrt_lam;

  // the lane's 4 runs of 8 source samples, 16-byte loads where the plane
  // allows them (the encoder's planes always do; pairs of 2-byte loads
  // serve unaligned planes).  The scalar path alone took a 1080p B
  // frame's 8 calls from 0.1404 to 0.1693 ms as graphs, s = 32 and 64
  // 1.38x and 1.42x, s = 8 unchanged (H100 80GB HBM3, 700.00 W;
  // tools/inter_me_ab.py against a copy with the vector path removed)
  const bool org16 = ((reinterpret_cast<uintptr_t>(a.org) & 15) == 0)
                     && (a.org_cols & 7) == 0;
  uint4 src[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int i, j0;
    refine_run<S>(t, k, i, j0);
    const int16_t* p = a.org + (long long)(by + i) * a.org_cols + bx + j0;
    if (org16) {
      src[k] = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      unsigned w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = (unsigned)(uint16_t)p[2 * q]
               | ((unsigned)(uint16_t)p[2 * q + 1] << 16);
      }
      src[k] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  // the windows, candidate (-3, -3)'s first sample at (0, 0), as 2^23 +
  // sample floats.  Where a window lies inside the padded plane (always,
  // for search ranges up to 64 and PAD_FULL's 80) the warp (at s = 64 the
  // CTA) reads its windows' rows a group of 8 lanes a row, each lane a
  // word and its neighbour's by a shuffle, so that a load touches the
  // lines of 4 rows and not of 32: a group takes whole windows (s = 8,
  // 16) or every 4th (16th) row of its team's; every load of a lane is
  // issued before the first is used, then the sample pairs are stored.
  // A window that does not lie inside, its team reads at clamped
  // coordinates, as the plain form's gather
  const int y0 = by + dy0 + a.pad - 3, x0 = bx + dx0 + a.pad - 3;
  const bool inside = y0 >= 0 && y0 + kW <= a.rows && x0 >= 1
                      && x0 + kW + 2 <= a.cols;
  if (t == 0) {
    origin[b] = inside ? (plane - a.refs) + (long long)y0 * a.cols + x0 : -1;
  }
  team_sync<S>();
  {
    constexpr int kGroups = (S == 64 ? Sh::kThreads : 32) / 8;
    constexpr int kWarpBlocks = S == 64 ? 1 : 32 / kTeam;
    constexpr bool kWhole = kWarpBlocks >= kGroups;  // a group, whole windows
    constexpr int kGroupBlocks = kWhole ? kWarpBlocks / kGroups : 1;
    constexpr int kRowStep = kWhole ? 1 : kGroups;
    constexpr int kGroupRows = (kW + kRowStep - 1) / kRowStep;
    constexpr int kWords = (Sh::kPairs + 8) / 8;     // a row's words / 8
    const int q = lane & 7;
    const int g = (S == 64 ? threadIdx.x : lane) >> 3;
    const int b0 = S == 64 ? 0 : (threadIdx.x >> 5) * kWarpBlocks;
    const int r0 = kWhole ? 0 : g;
    unsigned w[kGroupBlocks][kGroupRows][kWords];
    long long off[kGroupBlocks];
#pragma unroll
    for (int j = 0; j < kGroupBlocks; ++j) {
      off[j] = origin[b0 + (kWhole ? g + kGroups * j : 0)];
      const int16_t* p = a.refs + (off[j] >= 0 ? off[j] : 0)
                         + (long long)r0 * a.cols;
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) {
        const bool live = off[j] >= 0 && r0 + i * kRowStep < kW;
        const unsigned* wp = reinterpret_cast<const unsigned*>(
            reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          w[j][i][k] = (live && q + 8 * k <= Sh::kPairs)
              ? __ldg(wp + q + 8 * k) : 0u;
        }
        p += (long long)kRowStep * a.cols;
      }
    }
#pragma unroll
    for (int j = 0; j < kGroupBlocks; ++j) {
      const int bw = b0 + (kWhole ? g + kGroups * j : 0);
      const int16_t* p = a.refs + (off[j] >= 0 ? off[j] : 0)
                         + (long long)r0 * a.cols;
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) {
        const int r = r0 + i * kRowStep;
        // an odd sample start takes each pair across two words
        const unsigned sel =
            (reinterpret_cast<uintptr_t>(p) & 2) ? 0x5432u : 0x3210u;
        float* dst = win[bw] + r * kStride;
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const unsigned down = __shfl_down_sync(0xffffffffu, w[j][i][k], 1,
                                                 8);
          const unsigned next = k + 1 < kWords
              ? __shfl_sync(0xffffffffu, w[j][i][k + 1 < kWords ? k + 1 : k],
                            0, 8)
              : 0u;
          const int u = q + 8 * k;
          if (off[j] >= 0 && r < kW && u < Sh::kPairs) {
            const unsigned pr = __byte_perm(w[j][i][k], q < 7 ? down : next,
                                            sel);
            *reinterpret_cast<float2*>(dst + 2 * u) =
                make_float2(lo_biased(pr), hi_biased(pr));
          }
        }
        p += (long long)kRowStep * a.cols;
      }
    }
  }
  if (!inside) {
    float* wb = win[b];
    for (int e = t; e < kW * kW; e += kTeam) {
      const int r = e / kW, c = e - r * kW;
      const int y = min(max(y0 + r, 0), a.rows - 1);
      const int x = min(max(x0 + c, 0), a.cols - 1);
      wb[r * kStride + c] = __int_as_float(
          kBiasBits | (uint16_t)plane[(long long)y * a.cols + x]);
    }
  }
  team_sync<S>();

  // the 49 sums of the lane's 32 samples: floats that start at 2^23, so
  // that each stays an exact integer (below 2^24) and its bits are 2^23's
  // plus the sum; two float instructions a difference (a subtraction of
  // two biased samples, an add of its absolute value)
  float acc[49];
#pragma unroll
  for (int k = 0; k < 49; ++k) acc[k] = kBias;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int i, j0;
    refine_run<S>(t, k, i, j0);
    const unsigned sw[4] = {src[k].x, src[k].y, src[k].z, src[k].w};
    float o[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[2 * q] = lo_biased(sw[q]);
      o[2 * q + 1] = hi_biased(sw[q]);
    }
    const float* row = win[b] + i * kStride + j0;
#pragma unroll
    for (int dy = 0; dy < 7; ++dy) {
      float w[16];
      if constexpr (S == 8) {
#pragma unroll
        for (int q = 0; q < 7; ++q) {
          const float2 v = reinterpret_cast<const float2*>(
              row + dy * kStride)[q];
          w[2 * q] = v.x;
          w[2 * q + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(
              row + dy * kStride)[q];
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
      }
      // sample by sample, so that the 7 offsets' sums interleave
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          acc[dy * 7 + dx] += fabsf(o[c] - w[c + dx]);
        }
      }
    }
  }

  // the team's sums, reduce-scattered: slot dy * 8 + dx (a zero where dx
  // or dy is 7); each round halves the slots a lane holds, the lane's bit
  // choosing the half it keeps, so that lane l of kLanes ends with the
  // team-in-the-warp sums of slots l * 64 / kLanes on.  The bits are
  // added as integers: each lane's 2^23 bias comes out at the end
  unsigned v[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    v[k] = ((k & 7) < 7 && (k >> 3) < 7)
        ? __float_as_uint(acc[(k >> 3) * 7 + (k & 7)]) : 0u;
  }
  scatter_round<32, kLanes / 2>(v, lane);
  constexpr int kSlots = Sh::kSlots;
  const int l = lane % kLanes;
  if constexpr (S == 64) {
    // the four warps' sums: lane l of the first warp adds its two slots'
    // columns
    const int warp = threadIdx.x >> 5;
    *reinterpret_cast<uint2*>(&part[warp][kSlots * l]) = make_uint2(v[0],
                                                                    v[1]);
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      v[j] = part[0][kSlots * l + j] + part[1][kSlots * l + j]
             + part[2][kSlots * l + j] + part[3][kSlots * l + j];
    }
  }

  // each lane prices its slots in the plain form's float order, keeping
  // the first least; then the least (cost, slot) across the lanes, which
  // is the first minimum in (dy, dx) raster order
  const unsigned bias = (unsigned)kTeam * kBiasBits;
  float best = 0.0f;
  int best_slot = 64;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int slot = kSlots * l + j;
    const int dy = slot >> 3, dx = slot & 7;
    if (dx < 7 && dy < 7) {
      const int sad = (int)(v[j] - bias) >> a.bit_inc;
      const int bits = golomb((dx0 + dx - 3) * 4 - px)
                       + golomb((dy0 + dy - 3) * 4 - py) + 2;
      const float cost = __fadd_rn((float)sad,
                                   __fmul_rn(sqrt_lam, (float)bits));
      if (best_slot == 64 || cost < best) {
        best = cost;
        best_slot = slot;
      }
    }
  }
#pragma unroll
  for (int m = 1; m < kLanes; m <<= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, best, m);
    const int os = __shfl_xor_sync(0xffffffffu, best_slot, m);
    if (os != 64 && (best_slot == 64 || oc < best
                     || (oc == best && os < best_slot))) {
      best = oc;
      best_slot = os;
    }
  }
  if (l != 0 || n >= nb) return;
  a.out_mx[n] = dx0 + (best_slot & 7) - 3;
  a.out_my[n] = dy0 + (best_slot >> 3) - 3;
}

// ---- merge_model ---------------------------------------------------------

struct MergeArgs {
  const int16_t* org_y;              // source planes
  const int16_t* org_cb;
  const int16_t* org_cr;
  const int16_t* refs_y;             // [n_refs, rows_y, cols_y]
  const int16_t* refs_c;             // [2 n_refs, rows_c, cols_c]: Cb, Cr
  const int* d_y;                    // transform-RD dist, [nb] each
  const int* d_cb;
  const int* d_cr;
  const float* b_y;                  // transform-RD bits, [nb] each
  const float* b_cb;
  const float* b_cr;
  const int* mvx;                    // the winner: quarter pel, [nb]
  const int* mvy;
  const int* ref;
  const float* lam;
  const float* cw;
  int* out;                          // [4, nb]: rd (float bits), mvx, mvy,
                                     // ref
  int org_cols, corg_cols, n_refs, rows_y, cols_y, rows_c, cols_c;
  int nby, nbx, bit_inc, pad_y, pad_c;
};

template <int S>
struct MergeShape {
  // threads a block: 8 at s = 8 (a lane a row), a warp at 16, two at 32,
  // eight at 64
  static constexpr int kTeam = S == 8 ? 8 : S == 16 ? 32 : S == 32 ? 64
                                                                   : 256;
  static constexpr int kThreads = S == 64 ? 256 : 128;
  static constexpr int kBlocks = kThreads / kTeam;      // blocks a CTA
  // CTAs an SM (64 registers a thread at 8, 16 and 64): a 1080p list's
  // 510 CTAs of 64 fit the card at once
  static constexpr int kMinCtas = S == 64 ? 4 : S == 32 ? 1 : 8;
  static constexpr int kG = S / 8;                      // 8-column groups
  // a luma window [S + 7][8 G + 16] (chroma's fit in it), and a first
  // pass [S + 7][8 G]: two windows and one first pass a block, int16
  static constexpr int kWin = (S + 7) * (8 * kG + 16);
  static constexpr int kSmem = 2 * kWin + (S + 7) * 8 * kG;
};

// A team's barrier: its lanes of one warp, or a named barrier (1 + the
// team's index in the CTA) over its warps
template <int T>
struct TeamSync {
  unsigned mask;
  int id;
  __device__ __forceinline__ void operator()() const {
    if constexpr (T <= 32) {
      __syncwarp(mask);
    } else {
      asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(T) : "memory");
    }
  }
};

// The lanes of thread tid's team in its warp
template <int T>
__device__ __forceinline__ unsigned team_mask(int tid) {
  if constexpr (T < 32) {
    return ((1u << T) - 1u) << (tid & 31 & ~(T - 1));
  } else {
    return 0xffffffffu;
  }
}

// A team's sum of one unsigned a thread, in every thread of the team
template <int T>
__device__ __forceinline__ unsigned team_sum(unsigned v, unsigned* part,
                                             int t, const TeamSync<T>& sync) {
  constexpr int kLanes = T < 32 ? T : 32;
#pragma unroll
  for (int o = kLanes / 2; o >= 1; o >>= 1) {
    v += __shfl_xor_sync(sync.mask, v, o);
  }
  if constexpr (T > 32) {
    if ((t & 31) == 0) part[t >> 5] = v;
    sync();
    v = 0;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) v += part[w];
  }
  return v;
}

// Request an h x h block's window (its first tap sample at plane
// coordinates (wx, wy)) into win (row stride 8 G + 16, 16-byte aligned
// chunks from column wx & ~7) as this thread's cp.async group
template <int TAPS, int H, int T>
__device__ __forceinline__ void request_window(int16_t* win,
                                               const int16_t* plane,
                                               int rows, int cols, int wx,
                                               int wy, int t) {
  constexpr int G = (H + 7) / 8, WS = 8 * G + 16;
  constexpr int WR = H + TAPS - 1, NCH = G + 2;
  const bool aligned = (reinterpret_cast<uintptr_t>(plane) & 15) == 0
                       && (cols & 7) == 0;
  const int ax = wx & ~7;
  for (int e = t; e < WR * NCH; e += T) {
    const int r = e / NCH, ch = e - r * NCH;
    load_chunk(win + r * WS + 8 * ch, plane, rows, cols, ax + 8 * ch, wy + r,
               aligned);
  }
  cp_async_commit();
}

// The second pass's items of a thread in a team of T: item e = t + m T
// (m < K) of an h x h block's h x G runs of 8 samples
template <int H, int T>
struct Items {
  static constexpr int kG = (H + 7) / 8, kN = H * kG;
  static constexpr int kK = (kN + T - 1) / T;
};

// A thread's source samples of its items (row i, samples 8 g .. 8 g + 7
// of the block at (oy, ox)), 8 int16 a uint4, read once a block: 16-byte
// loads where the rows are aligned and whole, else samples (0 past h)
template <int H, int T>
__device__ __forceinline__ void load_org(
    const int16_t* org, int org_cols, int oy, int ox, int t,
    uint4 (&o)[Items<H, T>::kK]) {
  using It = Items<H, T>;
  const bool aligned = H % 8 == 0
      && (reinterpret_cast<uintptr_t>(org) & 15) == 0 && (org_cols & 7) == 0
      && (ox & 7) == 0;
#pragma unroll
  for (int m = 0; m < It::kK; ++m) {
    const int e = t + m * T;
    o[m] = make_uint4(0, 0, 0, 0);
    if (e >= It::kN) continue;
    const int i = e / It::kG, g = e % It::kG;
    const int16_t* src = org + (long long)(oy + i) * org_cols + ox + 8 * g;
    if (aligned) {
      o[m] = *reinterpret_cast<const uint4*>(src);
    } else {
      int v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = 8 * g + c < H ? src[c] : 0;
      o[m] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                        pack2(v[4], v[5]), pack2(v[6], v[7]));
    }
  }
}

// This thread's part of the SSE of one prediction of an h x h block (h =
// S luma, S / 2 chroma) against its source samples o (load_org): the
// window win (its first tap sample at column off of row 0), phases (fx,
// fy), clipped to pixels, the first pass in tmp; an unsigned 32-bit sum
// (wrapping).  Begins with the team's barrier (the window is in; tmp's
// last readers are done).
template <int TAPS, int H, int T>
__device__ unsigned team_sse(const int16_t* win, int16_t* tmp, int off,
                             int fx, int fy,
                             const uint4 (&o)[Items<H, T>::kK], int bd,
                             int t, const TeamSync<T>& sync) {
  using It = Items<H, T>;
  constexpr int G = It::kG, W8 = 8 * G, WS = W8 + 16;
  constexpr int WR = H + TAPS - 1, C = TAPS / 2 - 1;
  const int sh1 = kFilterPrec - (kInternalPrec - bd);
  const int off1 = -kInternalOffs * (1 << sh1);
  unsigned tx[TAPS / 2], ty[TAPS / 2];
  tap_pairs<TAPS>(fx, tx);
  tap_pairs<TAPS>(fy, ty);
  sync();
  const bool full = (fx | fy) == 0;
  if (!full) {
    // a zero vertical phase reads only the first pass's rows C .. C + h
    const int r0 = fy == 0 ? C : 0, nr = fy == 0 ? H : WR;
    for (int e = t; e < nr * G; e += T) {
      const int r = r0 + e / G, g = e % G;
      const int16_t* s = win + r * WS + off + 8 * g;
      if (fx == 0) {
        first_pass8_copy<TAPS>(s, sh1, off1, tmp + r * W8 + 8 * g);
      } else {
        first_pass8_pairs<TAPS>(s, off & 1, tx, sh1, off1,
                                tmp + r * W8 + 8 * g);
      }
    }
    sync();
  }
  unsigned acc = 0;
#pragma unroll
  for (int m = 0; m < It::kK; ++m) {
    const int e = t + m * T;
    if (e >= It::kN) continue;
    const int i = e / G, g = e % G;
    int res[8];
    if (full) {
      const int16_t* s = win + (i + C) * WS + off + C + 8 * g;
#pragma unroll
      for (int c = 0; c < 8; ++c) res[c] = copy_pixel(s[c], bd);
    } else if (fy == 0) {
      int v[8];
      load8(tmp + (i + C) * W8 + 8 * g, v);
#pragma unroll
      for (int c = 0; c < 8; ++c) res[c] = last_pass_copy(v[c], bd);
    } else {
      last_pass8_pairs<TAPS>(tmp, W8, i, g, ty, bd, res);
    }
    const unsigned w[4] = {o[m].x, o[m].y, o[m].z, o[m].w};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (8 * g + c < H) {
        const int src = c & 1 ? (int)w[c >> 1] >> 16
                              : (int)(int16_t)(w[c >> 1] & 0xffff);
        const int d = src - res[c];
        acc += (unsigned)(d * d);
      }
    }
  }
  return acc;
}

template <int S>
__global__ void __launch_bounds__(MergeShape<S>::kThreads,
                                  MergeShape<S>::kMinCtas)
merge_model_kernel(MergeArgs a) {
  using Sh = MergeShape<S>;
  constexpr int T = Sh::kTeam, CS = S / 2;
  __shared__ __align__(16) int16_t smem[Sh::kBlocks][Sh::kSmem];
  __shared__ unsigned part[Sh::kBlocks][T > 32 ? T / 32 : 1];
  const int team = threadIdx.x / T, t = threadIdx.x % T;
  const int nb = a.nby * a.nbx;
  const int n = blockIdx.x * Sh::kBlocks + team;
  if (n >= nb) return;                        // the whole team
  const TeamSync<T> sync{team_mask<T>(threadIdx.x), 1 + team};
  int16_t* win = smem[team];
  int16_t* tmp = win + 2 * Sh::kWin;
  const int i = n / a.nbx, j = n % a.nbx;
  const int by = i * S, bx = j * S;
  const int bd = 8 + a.bit_inc;

  // the winner; the candidates left, above (zero outside the grid), zero
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
  // the distinct candidates (uniform in the team): candidate 0; then 1
  // unless it is 0; then 2 unless it is 0 or 1
  const bool same10 = cx[1] == cx[0] && cy[1] == cy[0] && cr[1] == cr[0];
  const bool same20 = cx[2] == cx[0] && cy[2] == cy[0] && cr[2] == cr[0];
  const bool same21 = cx[2] == cx[1] && cy[2] == cy[1] && cr[2] == cr[1];
  const int nd = 1 + !same10 + !(same20 || same21);
  // distinct k's candidate, and candidate c's distinct index
  const int of1 = same10 ? 2 : 1;
  const int at1 = same10 ? 0 : 1;
  const int at2 = same20 ? 0 : same21 ? at1 : nd - 1;
  int ux[3], uy[3], ur[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int c = k == 0 ? 0 : k == 1 ? of1 : 2;
    ux[k] = c == 0 ? cx[0] : c == 1 ? cx[1] : cx[2];
    uy[k] = c == 0 ? cy[0] : c == 1 ? cy[1] : cy[2];
    ur[k] = c == 0 ? cr[0] : c == 1 ? cr[1] : cr[2];
  }
  // this thread's source samples, read once for the block: luma, Cb, Cr
  uint4 o_y[Items<S, T>::kK], o_cb[Items<CS, T>::kK], o_cr[Items<CS, T>::kK];
  load_org<S, T>(a.org_y, a.org_cols, by, bx, t, o_y);
  load_org<CS, T>(a.org_cb, a.corg_cols, i * CS, j * CS, t, o_cb);
  load_org<CS, T>(a.org_cr, a.corg_cols, i * CS, j * CS, t, o_cr);
  // the first two distinct luma windows requested at once, one group
  // each; the third into window 0 once the first is priced, so that it
  // arrives while the second is
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k < nd) {
      request_window<8, S, T>(
          win + k * Sh::kWin,
          a.refs_y + (long long)ur[k] * a.rows_y * a.cols_y, a.rows_y,
          a.cols_y, bx + (ux[k] >> 2) + a.pad_y - 3,
          by + (uy[k] >> 2) + a.pad_y - 3, t);
    }
  }
  unsigned sse[3] = {0, 0, 0};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < nd) {
      // this thread's groups after k's: 1 while a later window is in
      // flight (k = 0 with two or more, k = 1 with three), else 0
      if ((k == 0 && nd > 1) || (k == 1 && nd > 2)) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      const unsigned p = team_sse<8, S, T>(
          win + (k & 1) * Sh::kWin, tmp,
          (bx + (ux[k] >> 2) + a.pad_y - 3) & 7, ux[k] & 3, uy[k] & 3, o_y,
          bd, t, sync);
      sse[k] = team_sum<T>(p, part[team], t, sync);
      if (k == 0 && nd > 2) {
        sync();                       // window 0's readers are done
        request_window<8, S, T>(
            win, a.refs_y + (long long)ur[2] * a.rows_y * a.cols_y,
            a.rows_y, a.cols_y, bx + (ux[2] >> 2) + a.pad_y - 3,
            by + (uy[2] >> 2) + a.pad_y - 3, t);
      }
    }
  }

  // AMVP-proxy MV bits: the cheaper of the two neighbours as predictor
  const int bits_l = golomb(mx - cx[0]) + golomb(my - cy[0]);
  const int bits_a = golomb(mx - cx[1]) + golomb(my - cy[1]);
  const int mvb = min(bits_l, bits_a) + 2 + rf + 4;
  const float lam = *a.lam, cw = *a.cw;
  const int d_c = (int)((unsigned)a.d_cb[n] + (unsigned)a.d_cr[n]);
  float rd = __fadd_rn((float)a.d_y[n], __fmul_rn(cw, (float)d_c));
  const float b = __fadd_rn(__fadd_rn(__fadd_rn(a.b_y[n], a.b_cb[n]),
                                      a.b_cr[n]),
                            (float)mvb);
  rd = __fadd_rn(rd, __fmul_rn(lam, b));

  // the merge/skip model: left, above, zero on no-residual luma SSE, the
  // first minimum
  float m_cost = 0.0f;
  int m = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int at = c == 0 ? 0 : c == 1 ? at1 : at2;
    const unsigned u = at == 0 ? sse[0] : at == 1 ? sse[1] : sse[2];
    const int d = (int)u >> (2 * a.bit_inc);
    const float cost = __fadd_rn((float)d, __fmul_rn(lam, (float)(2 + c)));
    if (c == 0 || cost < m_cost) {
      m_cost = cost;
      m = c;
    }
  }
  const int sx = m == 0 ? cx[0] : m == 1 ? cx[1] : cx[2];
  const int sy = m == 0 ? cy[0] : m == 1 ? cy[1] : cy[2];
  const int sr = m == 0 ? cr[0] : m == 1 ? cr[1] : cr[2];
  // its Cb and Cr windows, requested together into windows 0 and 1
  sync();                             // the luma windows' readers are done
  const int wcx = j * CS + (sx >> 3) + a.pad_c - 1;
  const int wcy = i * CS + (sy >> 3) + a.pad_c - 1;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    request_window<4, CS, T>(
        win + p * Sh::kWin,
        a.refs_c + (long long)(sr + p * a.n_refs) * a.rows_c * a.cols_c,
        a.rows_c, a.cols_c, wcx, wcy, t);
  }
  unsigned d_s = 0;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p == 0) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const unsigned q = team_sse<4, CS, T>(
        win + p * Sh::kWin, tmp, wcx & 7, sx & 7, sy & 7,
        p == 0 ? o_cb : o_cr, bd, t, sync);
    d_s += (unsigned)((int)team_sum<T>(q, part[team], t, sync)
                      >> (2 * a.bit_inc));
  }
  const float skip_rd = __fadd_rn(m_cost, __fmul_rn(cw, (float)(int)d_s));
  if (t != 0) return;
  const bool use_skip = skip_rd < rd;
  a.out[n] = __float_as_int(use_skip ? skip_rd : rd);
  a.out[nb + n] = use_skip ? sx : mx;
  a.out[2 * nb + n] = use_skip ? sy : my;
  a.out[3 * nb + n] = use_skip ? sr : rf;
}

// ---- qpel_pick -----------------------------------------------------------

constexpr int kCands = 49;         // the 7x7 quarter-pel window
constexpr int kPickThreads = 128;  // blocks a CTA, a thread each

struct QpelPickArgs {
  const int* satd;                   // K2's SATD [nb, 49]
  const long long* c_dy;             // coarse field, full pel [nby, nbx]
  const long long* c_dx;
  const long long* c_ref;
  const long long* int_mx;           // the integer winner, full pel [nb]
  const long long* int_my;
  const float* sqrt_lam;
  int* out;                          // [3, nb]: mv_qx, mv_qy (quarter
                                     // pel), ref
  int nby, nbx;
};

__global__ void __launch_bounds__(kPickThreads)
qpel_pick_kernel(QpelPickArgs a) {
  __shared__ int rows[kPickThreads * kCands];
  const long long nb = (long long)a.nby * a.nbx;
  const long long n0 = (long long)blockIdx.x * kPickThreads;
  const int cnt = (int)min((long long)kPickThreads, nb - n0);
  // the CTA's SATD rows are one contiguous run: coalesced words; a
  // thread's row at an odd stride reads on distinct banks
  const int* src = a.satd + n0 * kCands;
  for (int e = threadIdx.x; e < cnt * kCands; e += kPickThreads) {
    rows[e] = src[e];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= cnt) return;
  const long long n = n0 + t;
  const int i = (int)(n / a.nbx), j = (int)(n - (long long)i * a.nbx);
  const int px = median_pred(a.c_dx, i, j, a.nby, a.nbx);
  const int py = median_pred(a.c_dy, i, j, a.nby, a.nbx);
  const int mx = (int)a.int_mx[n] * 4, my = (int)a.int_my[n] * 4;
  const float sl = *a.sqrt_lam;
  int gx[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) gx[q] = golomb(mx + q - 3 - px);
  const int* row = rows + t * kCands;
  float best = 0.0f;
  int code = 0;
#pragma unroll
  for (int qy = 0; qy < 7; ++qy) {
    const int gy = golomb(my + qy - 3 - py) + 2;
#pragma unroll
    for (int qx = 0; qx < 7; ++qx) {
      const int k = qy * 7 + qx;
      const float cost = __fadd_rn((float)row[k],
                                   __fmul_rn(sl, (float)(gy + gx[qx])));
      if (k == 0 || cost < best) {
        best = cost;
        code = k;
      }
    }
  }
  a.out[n] = mx + code % 7 - 3;
  a.out[nb + n] = my + code / 7 - 3;
  a.out[2 * nb + n] = (int)a.c_ref[n];
}

// ---- bi_pick -------------------------------------------------------------

constexpr int kBiThreads = 256;    // blocks a CTA, a thread each

struct BiClass {                   // one inter size class, 8 << k
  const float* rd0;                // list 0's leaf: rd, MV (quarter pel),
  const int* mvx0;                 // reference, [nb] each
  const int* mvy0;
  const int* ref0;
  const float* rd1;                // list 1's
  const int* mvx1;
  const int* mvy1;
  const int* ref1;
  const int* d_y;                  // the bi prediction's transform-RD
  const float* b_y;                // estimates, [nb] each
  const int* d_cb;
  const float* b_cb;
  const int* d_cr;
  const float* b_cr;
  float* rd;                       // out: min of L0, L1, BI [nb]
  int* dir;                        // out: 1 L0, 2 L1, 3 BI [nb]
  int nb, size, first;             // first: the class's first CTA
};

struct BiArgs {
  BiClass cls[kClasses];           // 8 first, then each size up to the CTU
  const float* lam;
  const float* cw;
  int classes;
};

// the arguments stay in the parameter space (__grid_constant__): a class's
// pointers are indexed by a class number known only at run time
__global__ void __launch_bounds__(kBiThreads)
bi_pick_kernel(const __grid_constant__ BiArgs a) {
  int k = 0;
  while (k + 1 < a.classes && (int)blockIdx.x >= a.cls[k + 1].first) ++k;
  const BiClass& c = a.cls[k];
  const int n = ((int)blockIdx.x - c.first) * kBiThreads + threadIdx.x;
  if (n >= c.nb) return;
  const int mvbits = golomb(c.mvx0[n]) + golomb(c.mvy0[n]) + 2 + c.ref0[n]
                     + golomb(c.mvx1[n]) + golomb(c.mvy1[n]) + 2 + c.ref1[n];
  const float lam = *a.lam, cw = *a.cw;
  const int d_c = (int)((unsigned)c.d_cb[n] + (unsigned)c.d_cr[n]);
  float rd_bi = __fadd_rn((float)c.d_y[n], __fmul_rn(cw, (float)d_c));
  const float b = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(c.b_y[n],
                                                          c.b_cb[n]),
                                                c.b_cr[n]),
                                      (float)mvbits),
                            5.0f);
  rd_bi = __fadd_rn(rd_bi, __fmul_rn(lam, b));
  const float rd0 = c.rd0[n], rd1 = c.rd1[n];
  const float rd = fminf(fminf(rd0, rd1), rd_bi);
  c.rd[n] = rd;
  c.dir[n] = rd == rd_bi ? 3 : rd == rd0 ? 1 : 2;
}

template <int S>
int launch_refine(const RefineArgs& a, cudaStream_t st) {
  using Sh = RefineShape<S>;
  // the shared memory of 8 CTAs an SM at s = 8 (8 x 25 KB), 4 else
  static const cudaError_t carve = cudaFuncSetAttribute(
      int_refine_kernel<S>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return (int)carve;
  const long long nb = (long long)a.nby * a.nbx;
  const long long grid = (nb + Sh::kBlocks - 1) / Sh::kBlocks;
  int_refine_kernel<S><<<(unsigned)grid, Sh::kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int S>
int launch_merge(const MergeArgs& a, cudaStream_t st) {
  using Sh = MergeShape<S>;
  const long long nb = (long long)a.nby * a.nbx;
  const long long grid = (nb + Sh::kBlocks - 1) / Sh::kBlocks;
  merge_model_kernel<S><<<(unsigned)grid, Sh::kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// refs: a host array of n_refs device pointers; out: per class (8, 16,
// 32, 64; n_classes of them) an int64 [3, hq / b, wq / b] output, b = s /
// 4, class after class in one buffer
extern "C" int thevc_coarse_search(const int16_t* org, int hq, int wq,
                                   const int16_t* const* refs, int n_refs,
                                   int rng, const float* sqrt_lam,
                                   long long* out, int n_classes,
                                   cudaStream_t st) {
  if (n_refs < 1 || n_refs > kMaxRefs || rng < 0 || rng > kMaxRng
      || n_classes < 1 || n_classes > kClasses || hq <= 0 || wq <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  CoarseArgs a{};
  a.org = org;
  for (int r = 0; r < n_refs; ++r) a.refs[r] = refs[r];
  a.sqrt_lam = sqrt_lam;
  a.out = out;
  a.n_refs = n_refs;
  a.hq = hq;
  a.wq = wq;
  a.rng = rng;
  a.n_classes = n_classes;
  const dim3 grid((wq + kTile - 1) / kTile, (hq + kTile - 1) / kTile);
  coarse_kernel<<<grid, 32 * kSlots / 2, 0, st>>>(a);
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

// org_*: the source planes (org_cols luma, corg_cols chroma columns);
// d_* / b_*: the transform-RD estimates; out: int32 [4, nby * nbx], rd
// (float32 bits), mvx, mvy, ref
extern "C" int thevc_merge_model(
    const int16_t* org_y, const int16_t* org_cb, const int16_t* org_cr,
    int org_cols, int corg_cols, const int16_t* refs_y, int n_refs,
    int rows_y, int cols_y, const int16_t* refs_c, int rows_c, int cols_c,
    const int* d_y, const int* d_cb, const int* d_cr, const float* b_y,
    const float* b_cb, const float* b_cr, const int* mvx, const int* mvy,
    const int* ref, const float* lam, const float* cw, int s, int nby,
    int nbx, int bit_inc, int pad_y, int pad_c, int* out, cudaStream_t st) {
  const MergeArgs a{org_y, org_cb, org_cr, refs_y, refs_c, d_y, d_cb, d_cr,
                    b_y, b_cb, b_cr, mvx, mvy, ref, lam, cw, out,
                    org_cols, corg_cols, n_refs, rows_y, cols_y, rows_c,
                    cols_c, nby, nbx, bit_inc, pad_y, pad_c};
  if (nby <= 0 || nbx <= 0 || n_refs < 1) return (int)cudaErrorInvalidValue;
  switch (s) {
    case 8: return launch_merge<8>(a, st);
    case 16: return launch_merge<16>(a, st);
    case 32: return launch_merge<32>(a, st);
    case 64: return launch_merge<64>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// satd: int32 [nby * nbx, 49]; c_*: the coarse field, int64 [nby, nbx];
// int_m*: the integer winner, int64 [nby * nbx]; out: int32 [3, nby *
// nbx], mv_qx, mv_qy, ref
extern "C" int thevc_qpel_pick(const int* satd, const long long* c_dy,
                               const long long* c_dx, const long long* c_ref,
                               const long long* int_mx,
                               const long long* int_my,
                               const float* sqrt_lam, int nby, int nbx,
                               int* out, cudaStream_t st) {
  if (nby <= 0 || nbx <= 0) return (int)cudaErrorInvalidValue;
  const QpelPickArgs a{satd, c_dy, c_dx, c_ref, int_mx, int_my, sqrt_lam,
                       out, nby, nbx};
  const long long grid = ((long long)nby * nbx + kPickThreads - 1)
                         / kPickThreads;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  qpel_pick_kernel<<<(unsigned)grid, kPickThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// args: a host BiArgs (the class table, 8 first; ``first`` is set here)
extern "C" int thevc_bi_pick(const void* args, cudaStream_t st) {
  BiArgs a = *static_cast<const BiArgs*>(args);
  if (a.classes < 1 || a.classes > kClasses) {
    return (int)cudaErrorInvalidValue;
  }
  long long ctas = 0;
  for (int k = 0; k < a.classes; ++k) {
    BiClass& c = a.cls[k];
    if (c.nb <= 0 || c.size != 8 << k) return (int)cudaErrorInvalidValue;
    c.first = (int)ctas;
    ctas += (c.nb + kBiThreads - 1) / kBiThreads;
  }
  if (ctas >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  bi_pick_kernel<<<(unsigned)ctas, kBiThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
