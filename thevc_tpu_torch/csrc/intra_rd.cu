// The fast-RD intra decision pass's per-block math on an NVIDIA Hopper card
// (sm_90a): two kernels.
//
// Kernel A, thevc_intra_sweep: the 35-mode intra prediction and Hadamard
// SATD of every block of one luma size class.  It replaces the size pass's
// prediction stack and sweep (thevc_tpu/encoder/fast_intra.py:404
// _size_pass_impl, lines 413-449: the reference lines, their [1 2 1]
// smoothing, planar, DC and the 33 angular modes through _unified_plan, the
// SATD; on the TPU the SATD is the Pallas kernel
// thevc_tpu/ops/jx_pallas.py:_satd_kernel), the K7 function _frame_body
// (:793) runs once a class.  Out: int32 SATD [nb, 35] (planar, DC, 2..34)
// and the first-minimum mode of each block.
//
// Kernel B, thevc_tu_rd_given / thevc_tu_rd_intra: the transform-RD
// estimate of a batch of TUs, fast_intra.py:338 _tq_rd with K5's
// forward_transform and quant (thevc_tpu/ops/jx.py:62, :113), the
// coefficient-bit model _coeff_bits_est (:317) and K1's dequant + inverse
// transform (jx_pallas.py:141 _kernel, reached through
// jx.tu_recon_pipeline): per item forward DCT (DST for intra 4x4), quant,
// bit estimate, dequant, inverse, recon and SSE.  The given entry reads an
// item's prediction from a tensor (the P/B pass's winners); the intra
// entry predicts one mode of one block itself from the padded source
// plane (the size pass's top-3 luma candidates, the chroma pass's 5
// candidates, Cb and Cr in one launch).  Size 64 is four 32x32 quadrant
// TUs and size -32 a 32-sized block's four 16x16 quadrants, in raster
// order.  Out: int32 dist [N], float32 bits [N].
//
// Every value equals the port's plain PyTorch form (encoder/fast_intra.py:
// intra_sweep_plain, tu_rd_modes_plain, _tq_rd), which is the semantics
// copied here, not HM's: reference samples come from the source plane at
// every position (open loop, no availability), the smoothed line's corner
// is ([1 2 1] over left[1], corner, above[1]), the last sample of each half
// unfiltered; luma angular modes read the smoothed lines where min(|m - 10|,
// |m - 26|) > INTRA_FILTER_THRESH[log2 s], planar where 10 > it; DC's edge
// filter and the mode 10/26 edge filters (clamped) apply at every luma size;
// chroma reads unfiltered lines and has no DC or edge filter.  The angular
// reference index is HM's refMain (xPredIntraAng): k >= 0 on the main line,
// k < 0 the side line at (128 - k * invAngle) >> 8, which is the gather
// plan of _unified_plan; the tests hold the plain form's per-item
// prediction against the 35-mode stack.  SATD: 8x8 Hadamard blocks when s
// % 8 == 0, else 4x4, normalised ((sad + 2) >> 2, (sad + 1) >> 1), summed,
// >> bit_inc, as csrc/satd.cu.
//
// Exactness.  Integers: the sweep is int32 as satd.cu (a block's sum below
// 64 * 64 * 2^(9 + bit_inc) * 2 for s = 64).  The transforms are int32
// products, exact while no partial sum overflows: residuals are below
// 2^(8 + bit_inc) in magnitude (samples in [0, max_val]), a row's sum of
// |basis| is at most 32 * 90 = 2880, so the forward first pass is below
// 2880 * 2^(8 + bit_inc) < 2^31 for bit_inc <= 11, after its shift of
// log2(s) - 1 + bit_inc the second below 2880^2 * 2^(9 - log2 s) < 2^28;
// the inverse passes read int16 values, below 2880 * 2^15 < 2^27.  The
// wrapper takes bit_inc <= 8.  The quantiser's |c| * scale + add and the
// dequant product are int32 with torch's wrapping (unsigned arithmetic
// here), so they equal the plain form whatever the input.  Floats: the bit
// estimate is the plain form's, operation for operation: the level bits are
// a float32 table whose values are multiples of 2^-23 below 2^5, so their
// float64 sum is exact and equals an int64 count of 2^-23 units rounded to
// float32 once (__ll2float_rn, then an exact scaling); then 1.5f * coded
// groups added above 4x4 (one __fadd_rn), then (bits + 2 log2 s) + 1.0f
// as two __fadd_rn, 0.5f for an all-zero TU; a quadrant block's four
// float32 estimates summed in float64 (exact: four values in [0.5, 2^16))
// and rounded once.  This source is built with -fmad=false too.  So
// dist and bits equal the plain form bit for bit, and the maps on cuda
// those on the CPU.
//
// What bounds them on this card.  Kernel A does about 20 int32 operations a
// predicted sample (the index, the lerp, the difference, the Hadamard's
// butterflies, the absolute sum) over 35 * s^2 samples a block, and reads
// each block and its 4s + 1 reference samples once: at 1080p about 5 G
// operations and 21 MB for the five classes, so it is bound by
// operations (about 0.15 ms at the int32 rate).  Design: one CTA takes 32
// (s <= 32: 32 / blocks-per-tile) whole blocks, or one 64x64 block, keeps
// their reference lines, the smoothed twins, the DC values and the source
// samples in shared memory, and its threads walk (mode, block, Hadamard
// tile) items with the mode the slowest index, so a warp runs one mode and
// takes no divergent branch; each item predicts its 8x8 (4x4) tile in
// registers and transforms it there (satd.cu's fwht), and adds its
// normalised SAD to its (block, mode) sum in shared memory.  No prediction
// reaches device memory (the plain form writes 35 * s^2 int16 a block and
// reads it back).  Kernel B does 4 * s^3 multiply-adds a TU (two passes
// each way) and reads the block and its lines once (intra) or org and pred
// (given): bound by operations.  Design: a TU of s^2 samples runs on
// min(s^2, 256) threads (a 256-thread CTA holds 16 4x4, 4 8x8 or one 16x16
// or 32x32 TU; a quadrant block runs its four TUs in turn on one CTA), a
// thread per coefficient (four at 32x32); the residual, the intermediate
// passes, the dequantised levels and the reconstruction live in two padded
// shared buffers (row stride s + 1: the forward pass's strided reads hit
// no bank twice), the basis beside them, the prediction and source sample
// in registers; the sums (level bits, coded groups, SSE) reduce by
// shuffles within a TU's lanes and one shared atomic a warp.  No
// prediction, coefficient or reconstruction reaches device memory.
//
// The entries do not allocate or synchronise; they launch on the stream
// they are given and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlanar = 0;
constexpr int kDc = 1;
constexpr int kHor = 10;
constexpr int kVer = 26;
constexpr int kModes = 35;
constexpr int kSweepThreads = 224;     // 7 warps: 1120 items = 5 rounds
constexpr int kRdThreads = 256;

__constant__ int kAngTable[9] = {0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ int kInvAngTable[9] = {0, 4096, 1638, 910, 630, 482, 390, 315,
                                    256};
__constant__ int kQuantScales[6] = {26214, 23302, 20560, 18396, 16384, 14564};
__constant__ int kInvQuantScales[6] = {40, 45, 51, 57, 64, 72};

__host__ __device__ constexpr int ilog2(int s) {
  return s == 4 ? 2 : s == 8 ? 3 : s == 16 ? 4 : s == 32 ? 5 : 6;
}

// INTRA_FILTER_THRESH (ops/intra.py) by log2 of the block size
__host__ __device__ constexpr int filter_thresh(int log2s) {
  return log2s == 2 ? 10 : log2s == 3 ? 7 : log2s == 4 ? 1 : log2s == 5 ? 0
                                                                         : 10;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// A mode's prediction parameters.  The reference lines of a block of size S
// sit in shared memory as c[0..4S] = (left[0..2S], above[1..2S]) (left[0]
// = above[0], the corner), then the smoothed line at c[4S + 1 ...] in the
// same layout; `off` picks the line a mode reads.
struct ModeP {
  int kind;   // 0 planar, 1 DC, 2 angular
  int hor;    // angular: main line is the left one
  int angle;
  int inv;
  int off;
};

template <int S, bool LUMA>
__device__ __forceinline__ ModeP mode_params(int mode) {
  constexpr int kLog2 = ilog2(S);
  constexpr int kL = 4 * S + 1;
  ModeP m;
  m.hor = 0;
  m.angle = 0;
  m.inv = 0;
  if (mode == kPlanar) {
    m.kind = 0;
    m.off = (LUMA && 10 > filter_thresh(kLog2)) ? kL : 0;
  } else if (mode == kDc) {
    m.kind = 1;
    m.off = 0;
  } else {
    m.kind = 2;
    m.hor = mode < 18;
    const int ipa = m.hor ? kHor - mode : mode - kVer;
    const int a = ipa < 0 ? -ipa : ipa;
    m.angle = ipa < 0 ? -kAngTable[a] : kAngTable[a];
    m.inv = kInvAngTable[a];
    const int dh = mode > kHor ? mode - kHor : kHor - mode;
    const int dv = mode > kVer ? mode - kVer : kVer - mode;
    m.off = (LUMA && (dh < dv ? dh : dv) > filter_thresh(kLog2)) ? kL : 0;
  }
  return m;
}

// index into a line of HM's refMain[k]: k >= 0 on the main line, k < 0
// projected from the side line at (128 - k * invAngle) >> 8
template <int S>
__device__ __forceinline__ int ref_index(const ModeP& m, int k) {
  const int side = (128 - k * m.inv) >> 8;
  if (m.hor) return k >= 0 ? k : 2 * S + side;
  return k > 0 ? 2 * S + k : (k == 0 ? 0 : side);
}

// sample (y, x) of a block's prediction in mode `mode` (params m); c the
// block's lines (raw, then smoothed), dc its DC value
template <int S, bool LUMA>
__device__ __forceinline__ int predict(const ModeP& m, int mode, const int* c,
                                       int dc, int y, int x, int max_val) {
  constexpr int kLog2 = ilog2(S);
  const int* l = c + m.off;
  if (m.kind == 0) {
    const int top = l[2 * S + 1 + x], left = l[1 + y];
    const int right = l[3 * S + 1] - left, bottom = l[S + 1] - top;
    return ((left << kLog2) + S + (x + 1) * right + (top << kLog2)
            + (y + 1) * bottom) >> (kLog2 + 1);
  }
  if (m.kind == 1) {
    if (!LUMA || (x > 0 && y > 0)) return dc;
    if (x == 0 && y == 0) return (c[2 * S + 1] + c[1] + 2 * dc + 2) >> 2;
    if (y == 0) return (c[2 * S + 1 + x] + 3 * dc + 2) >> 2;
    return (c[1 + y] + 3 * dc + 2) >> 2;
  }
  const int pos = ((m.hor ? x : y) + 1) * m.angle;
  const int f = pos & 31;
  const int k = (m.hor ? y : x) + (pos >> 5) + 1;
  const int a = l[ref_index<S>(m, k)];
  const int b = f ? l[ref_index<S>(m, k + 1)] : 0;
  int p = ((32 - f) * a + f * b + 16) >> 5;
  if (LUMA) {
    if (mode == kVer && x == 0)
      p = clampi(p + ((c[1 + y] - c[0]) >> 1), 0, max_val);
    if (mode == kHor && y == 0)
      p = clampi(p + ((c[2 * S + 1 + x] - c[0]) >> 1), 0, max_val);
  }
  return p;
}

// a block's reference lines from the padded plane (one row and column of
// padding on the top and left: row y0, column x0 hold the corner)
template <int S>
__device__ __forceinline__ int line_sample(const int16_t* plane, int width,
                                           int y0, int x0, int j) {
  return j <= 2 * S ? plane[(size_t)(y0 + j) * width + x0]
                    : plane[(size_t)y0 * width + x0 + (j - 2 * S)];
}

// the [1 2 1]-smoothed twin of line element j (initAdiPattern as the plain
// form's _smooth: the corner over left[1], corner, above[1]; the last
// sample of each half kept)
template <int S>
__device__ __forceinline__ int smooth_at(const int* c, int j) {
  if (j == 0) return (c[2 * S + 1] + 2 * c[0] + c[1] + 2) >> 2;
  if (j == 2 * S || j == 4 * S) return c[j];
  const int prev = j == 2 * S + 1 ? c[0] : c[j - 1];
  return (prev + 2 * c[j] + c[j + 1] + 2) >> 2;
}

template <int S>
__device__ __forceinline__ int dc_of(const int* c) {
  int sum = S;
#pragma unroll 8
  for (int k = 1; k <= S; ++k) sum += c[k] + c[2 * S + k];
  return sum >> (ilog2(S) + 1);
}

// in-place Sylvester Walsh-Hadamard transform of B values (csrc/satd.cu)
template <int B>
__device__ __forceinline__ void fwht(int (&v)[B]) {
#pragma unroll
  for (int h = 1; h < B; h <<= 1) {
#pragma unroll
    for (int i = 0; i < B; i += 2 * h) {
#pragma unroll
      for (int j = i; j < i + h; ++j) {
        const int a = v[j], b = v[j + h];
        v[j] = a + b;
        v[j + h] = a - b;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel A: the 35-mode sweep of one luma size class
// ---------------------------------------------------------------------------

template <int S>
__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(const int16_t* __restrict__ plane, int width, int nby, int nbx,
             int bit_inc, int max_val, int32_t* __restrict__ out,
             int32_t* __restrict__ best) {
  constexpr int B = S % 8 == 0 ? 8 : 4;      // Hadamard tile
  constexpr int TPR = S / B;                 // tiles a block row
  constexpr int NT = TPR * TPR;              // tiles a block
  constexpr int BPC = NT >= 32 ? 1 : 32 / NT;  // blocks a CTA
  constexpr int PER_MODE = BPC * NT;         // items a mode: 32, or 64
  constexpr int ITEMS = kModes * PER_MODE;
  constexpr int L = 4 * S + 1;
  __shared__ int lines[BPC][2 * L];
  __shared__ int16_t org[BPC][S * S];
  __shared__ int dcs[BPC];
  __shared__ int sums[BPC][kModes];

  const int tid = threadIdx.x;
  const int nb = nby * nbx;
  const int b0 = blockIdx.x * BPC;
  const int nblk = min(BPC, nb - b0);

  for (int i = tid; i < nblk * L; i += kSweepThreads) {
    const int bl = i / L, j = i % L, gb = b0 + bl;
    lines[bl][j] = line_sample<S>(plane, width, (gb / nbx) * S,
                                  (gb % nbx) * S, j);
  }
  for (int i = tid; i < nblk * S * S; i += kSweepThreads) {
    const int bl = i / (S * S), e = i % (S * S), gb = b0 + bl;
    org[bl][e] = plane[(size_t)(1 + (gb / nbx) * S + e / S) * width + 1
                       + (gb % nbx) * S + e % S];
  }
  for (int i = tid; i < BPC * kModes; i += kSweepThreads)
    sums[i / kModes][i % kModes] = 0;
  __syncthreads();
  for (int i = tid; i < nblk * L; i += kSweepThreads)
    lines[i / L][L + i % L] = smooth_at<S>(lines[i / L], i % L);
  for (int bl = tid; bl < nblk; bl += kSweepThreads)
    dcs[bl] = dc_of<S>(lines[bl]);
  __syncthreads();

  // items: mode-major, then block, then tile; a warp's 32 items share
  // their mode (32 | PER_MODE and 32 | the thread count)
  for (int it = tid; it < ITEMS; it += kSweepThreads) {
    const int mode = it / PER_MODE;
    const int j = it % PER_MODE;
    const int bl = j / NT, tile = j % NT;
    if (bl >= nblk) continue;
    const ModeP m = mode_params<S, true>(mode);
    const int* c = lines[bl];
    const int dc = dcs[bl];
    const int ty = (tile / TPR) * B, tx = (tile % TPR) * B;
    int d[B][B];
#pragma unroll
    for (int r = 0; r < B; ++r) {
#pragma unroll
      for (int k = 0; k < B; ++k)
        d[r][k] = org[bl][(ty + r) * S + tx + k]
                  - predict<S, true>(m, mode, c, dc, ty + r, tx + k, max_val);
      fwht<B>(d[r]);
    }
    int sad = 0;
#pragma unroll
    for (int k = 0; k < B; ++k) {
      int col[B];
#pragma unroll
      for (int r = 0; r < B; ++r) col[r] = d[r][k];
      fwht<B>(col);
#pragma unroll
      for (int r = 0; r < B; ++r) sad += abs(col[r]);
    }
    atomicAdd(&sums[bl][mode], B == 8 ? (sad + 2) >> 2 : (sad + 1) >> 1);
  }
  __syncthreads();

  for (int i = tid; i < nblk * kModes; i += kSweepThreads)
    out[(size_t)(b0 + i / kModes) * kModes + i % kModes] =
        sums[i / kModes][i % kModes] >> bit_inc;
  for (int bl = tid; bl < nblk; bl += kSweepThreads) {
    int arg = 0, lo = sums[bl][0] >> bit_inc;
    for (int mo = 1; mo < kModes; ++mo) {
      const int v = sums[bl][mo] >> bit_inc;
      if (v < lo) {
        lo = v;
        arg = mo;
      }
    }
    best[b0 + bl] = arg;
  }
}

// ---------------------------------------------------------------------------
// Kernel B: the transform-RD estimate of a batch of TUs
// ---------------------------------------------------------------------------

struct RdArgs {
  const int16_t* plane0;   // intra: the padded source plane(s)
  const int16_t* plane1;
  int width;
  int nbx;
  int per_plane;           // intra: items a plane (nb * k)
  int k;                   // intra: modes a block
  const int32_t* mode;     // intra: [per_plane] mode ids, block-major
  const int16_t* org;      // given: [n, s, s]
  const int16_t* pred;     // given: [n, s, s]
  const int32_t* qp;       // [n] scaled QPs
  const int32_t* basis;    // [t, t] T[k][n], rows basis functions
  const int32_t* level_bits;  // [32769] float32 level bits in 2^-23 units
  long long n;
  int is_intra;
  int bit_inc;
  int max_val;
  int32_t* dist;
  float* bits;
};

// sum over the lanes of one TU (W = min(group, 32) aligned lanes)
template <int W, typename V>
__device__ __forceinline__ V lane_sum(V v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o, W);
  return v;
}

// SRC: 0 the given prediction, 1 a luma mode, 2 a chroma mode
template <int T, int NQ, int SRC>
__global__ void __launch_bounds__(kRdThreads) tu_rd_kernel(RdArgs a) {
  constexpr int S = NQ == 4 ? 2 * T : T;     // the block (prediction) size
  constexpr int TT = T * T;
  constexpr int GROUP = TT < kRdThreads ? TT : kRdThreads;  // lanes a TU
  constexpr int IPC = kRdThreads / GROUP;    // items a CTA
  constexpr int EPT = TT / GROUP;            // coefficients a lane
  constexpr int W = GROUP < 32 ? GROUP : 32;
  constexpr int P = T + 1;                   // padded row stride
  constexpr int L = 4 * S + 1;
  constexpr int LOG2T = ilog2(T);
  constexpr int CGR = T / 4;                 // 4x4 groups a row
  constexpr bool kIntraSrc = SRC != 0;
  constexpr bool kLuma = SRC == 1;
  __shared__ int tm[T * P];
  __shared__ int xb[IPC][T * P];
  __shared__ int yb[IPC][T * P];
  __shared__ int lines[kIntraSrc ? IPC : 1][kIntraSrc ? 2 * L : 1];
  __shared__ int dcs[IPC];
  __shared__ int cgf[IPC][CGR * CGR];
  __shared__ unsigned long long acc_bits[IPC];
  __shared__ unsigned long long acc_sse[IPC];
  __shared__ int acc_nz[IPC];

  const int tid = threadIdx.x;
  const int slot = tid / GROUP, g = tid % GROUP;
  const long long item = (long long)blockIdx.x * IPC + slot;
  const bool live = item < a.n;

  for (int i = tid; i < TT; i += kRdThreads)
    tm[(i / T) * P + i % T] = a.basis[i];

  const int16_t* plane = nullptr;
  int y0 = 0, x0 = 0, mode = 0;
  if (kIntraSrc && live) {
    const int within = (int)(item % a.per_plane);
    plane = item < a.per_plane ? a.plane0 : a.plane1;
    const int blk = within / a.k;
    y0 = (blk / a.nbx) * S;
    x0 = (blk % a.nbx) * S;
    mode = a.mode[within];
    for (int j = g; j < L; j += GROUP)
      lines[slot][j] = line_sample<S>(plane, a.width, y0, x0, j);
  }
  __syncthreads();
  if (kIntraSrc && live) {
    if (kLuma)
      for (int j = g; j < L; j += GROUP)
        lines[slot][L + j] = smooth_at<S>(lines[slot], j);
    if (g == 0) dcs[slot] = dc_of<S>(lines[slot]);
  }
  __syncthreads();

  // quantiser and transform constants of this item
  const int qp = live ? a.qp[item] : 0;
  const int per = qp / 6, rem = qp % 6;
  const int ts = 15 - (8 + a.bit_inc) - LOG2T;
  const int qb = 14 + per + ts;
  const int qadd = (a.is_intra ? 171 : 85) << (qb - 9);
  const int qscale = kQuantScales[rem];
  const int dshift = 20 - 14 - ts;
  const int dscale = kInvQuantScales[rem] << per;
  const int sh1 = LOG2T - 1 + a.bit_inc, sh2 = LOG2T + 6;
  const int ish2 = 12 - a.bit_inc;
  ModeP m{};
  if (kIntraSrc) m = mode_params<S, kLuma>(mode);

  long long dist_acc = 0;
  double bits_acc = 0.0;
  int* x = xb[slot];
  int* yv = yb[slot];
  for (int q = 0; q < NQ; ++q) {
    const int qy = (q >> 1) * T, qx = (q & 1) * T;
    if (g == 0) {
      acc_bits[slot] = 0;
      acc_sse[slot] = 0;
      acc_nz[slot] = 0;
    }
    for (int i = g; i < CGR * CGR; i += GROUP) cgf[slot][i] = 0;
    // the residual, spatial (y, x) = (r, cc)
    int orgv[EPT], predv[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int idx = g + GROUP * e, r = idx / T, cc = idx % T;
      orgv[e] = predv[e] = 0;
      if (live) {
        if (kIntraSrc) {
          orgv[e] = plane[(size_t)(1 + y0 + qy + r) * a.width + 1 + x0 + qx
                          + cc];
          predv[e] = predict<S, kLuma>(m, mode, lines[slot], dcs[slot],
                                       qy + r, qx + cc, a.max_val);
        } else {
          const size_t o = (size_t)item * (S * S) + (qy + r) * S + qx + cc;
          orgv[e] = a.org[o];
          predv[e] = a.pred[o];
        }
      }
      x[r * P + cc] = orgv[e] - predv[e];
    }
    __syncthreads();
    // forward first pass: y[k][j] = (sum_n T[k][n] x[j][n] + add) >> sh1
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int idx = g + GROUP * e, r = idx / T, cc = idx % T;
      int s = 0;
#pragma unroll
      for (int n = 0; n < T; ++n) s += tm[r * P + n] * x[cc * P + n];
      yv[r * P + cc] = (s + (1 << (sh1 - 1))) >> sh1;
    }
    __syncthreads();
    // second pass, quant, bits, dequant (into x)
    long long lbits = 0;
    int nz = 0;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int idx = g + GROUP * e, r = idx / T, cc = idx % T;
      int s = 0;
#pragma unroll
      for (int n = 0; n < T; ++n) s += tm[r * P + n] * yv[cc * P + n];
      const int coef = (s + (1 << (sh2 - 1))) >> sh2;
      const int tmp = (int)((unsigned)abs(coef) * (unsigned)qscale);
      int level = (int)((unsigned)tmp + (unsigned)qadd) >> qb;
      level = coef > 0 ? level : coef < 0 ? -level : 0;
      level = clampi(level, -32768, 32767);
      if (level != 0) {
        lbits += a.level_bits[abs(level)];
        nz += 1;
        cgf[slot][(r >> 2) * CGR + (cc >> 2)] = 1;
      }
      const int prod = (int)((unsigned)level * (unsigned)dscale);
      x[r * P + cc] = clampi(
          (int)((unsigned)prod + (unsigned)(1 << (dshift - 1))) >> dshift,
          -32768, 32767);
    }
    lbits = lane_sum<W>(lbits);
    nz = lane_sum<W>(nz);
    if (g % W == 0) {
      atomicAdd(&acc_bits[slot], (unsigned long long)lbits);
      atomicAdd(&acc_nz[slot], nz);
    }
    __syncthreads();
    // inverse first pass: y[j][k] = clip((sum_n T[n][k] x[n][j] + 64) >> 7)
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int idx = g + GROUP * e, r = idx / T, cc = idx % T;
      int s = 0;
#pragma unroll
      for (int n = 0; n < T; ++n) s += tm[n * P + cc] * x[n * P + r];
      yv[r * P + cc] = clampi((s + 64) >> 7, -32768, 32767);
    }
    __syncthreads();
    // second pass, recon, SSE
    long long sse = 0;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int idx = g + GROUP * e, r = idx / T, cc = idx % T;
      int s = 0;
#pragma unroll
      for (int n = 0; n < T; ++n) s += tm[n * P + cc] * yv[n * P + r];
      const int res = clampi((s + (1 << (ish2 - 1))) >> ish2, -32768, 32767);
      const int d = orgv[e] - clampi(predv[e] + res, 0, a.max_val);
      sse += (long long)d * d;
    }
    sse = lane_sum<W>(sse);
    if (g % W == 0) atomicAdd(&acc_sse[slot], (unsigned long long)sse);
    __syncthreads();
    if (g == 0 && live) {
      int ncg = 0;
      for (int i = 0; i < CGR * CGR; ++i) ncg += cgf[slot][i];
      float b = __fmul_rn(__ll2float_rn((long long)acc_bits[slot]),
                          1.0f / 8388608.0f);
      if (T > 4) b = __fadd_rn(b, __fmul_rn(1.5f, (float)ncg));
      b = acc_nz[slot] ? __fadd_rn(__fadd_rn(b, (float)(2 * LOG2T)), 1.0f)
                       : 0.5f;
      dist_acc += (long long)acc_sse[slot] >> (2 * a.bit_inc);
      bits_acc = __dadd_rn(bits_acc, (double)b);
    }
    __syncthreads();
  }
  if (g == 0 && live) {
    a.dist[item] = (int32_t)dist_acc;
    a.bits[item] = __double2float_rn(bits_acc);
  }
}

template <int T, int NQ, int SRC>
int launch_rd(const RdArgs& a, cudaStream_t stream) {
  constexpr int IPC = kRdThreads / (T * T < kRdThreads ? T * T : kRdThreads);
  const long long blocks = (a.n + IPC - 1) / IPC;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tu_rd_kernel<T, NQ, SRC><<<(unsigned)blocks, kRdThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// size: 4..32 one TU a block, 64 four 32x32 quadrants, -32 four 16x16
template <int SRC>
int dispatch_rd(int size, const RdArgs& a, cudaStream_t st) {
  switch (size) {
    case 4: return launch_rd<4, 1, SRC>(a, st);
    case 8: return launch_rd<8, 1, SRC>(a, st);
    case 16: return launch_rd<16, 1, SRC>(a, st);
    case 32: return launch_rd<32, 1, SRC>(a, st);
    case 64: return launch_rd<32, 4, SRC>(a, st);
    case -32: return launch_rd<16, 4, SRC>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int S>
int launch_sweep(const void* plane, int width, int nby, int nbx, int bit_inc,
                 int max_val, void* out, void* best, cudaStream_t stream) {
  constexpr int NT = (S / (S % 8 == 0 ? 8 : 4)) * (S / (S % 8 == 0 ? 8 : 4));
  constexpr int BPC = NT >= 32 ? 1 : 32 / NT;
  const long long nb = (long long)nby * nbx;
  sweep_kernel<S><<<(unsigned)((nb + BPC - 1) / BPC), kSweepThreads, 0,
                    stream>>>(
      static_cast<const int16_t*>(plane), width, nby, nbx, bit_inc, max_val,
      static_cast<int32_t*>(out), static_cast<int32_t*>(best));
  return (int)cudaGetLastError();
}

bool args_ok(int bit_inc, int max_val) {
  return bit_inc >= 0 && bit_inc <= 8 && max_val > 0 && max_val < 65536;
}

}  // namespace

// plane: int16 [height, width], the padded source plane (one row and
// column of edge padding on the top and left; the wrapper checks that
// every block's 2s + 1 lines lie inside); out: int32 [nby * nbx, 35];
// best: int32 [nby * nbx].  Device pointers, contiguous.
extern "C" int thevc_intra_sweep(const void* plane, int height, int width,
                                 int size, int nby, int nbx, int bit_inc,
                                 int max_val, void* out, void* best,
                                 void* stream) {
  if (nby <= 0 || nbx <= 0) return 0;
  if (!args_ok(bit_inc, max_val) || (long long)nby * size + size + 1 > height
      || (long long)nbx * size + size + 1 > width)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 4: return launch_sweep<4>(plane, width, nby, nbx, bit_inc, max_val,
                                   out, best, st);
    case 8: return launch_sweep<8>(plane, width, nby, nbx, bit_inc, max_val,
                                   out, best, st);
    case 16: return launch_sweep<16>(plane, width, nby, nbx, bit_inc,
                                     max_val, out, best, st);
    case 32: return launch_sweep<32>(plane, width, nby, nbx, bit_inc,
                                     max_val, out, best, st);
    case 64: return launch_sweep<64>(plane, width, nby, nbx, bit_inc,
                                     max_val, out, best, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// org, pred: int16 [n, |size|, |size|]; qp: int32 [n]; basis: int32 [t, t]
// (the DST at t = 4 for intra items, else the DCT); level_bits: int32
// [32769]; dist: int32 [n]; bits: float32 [n].
extern "C" int thevc_tu_rd_given(const void* org, const void* pred,
                                 const void* qp, const void* basis,
                                 const void* level_bits, long long n,
                                 int size, int is_intra, int bit_inc,
                                 int max_val, void* dist, void* bits,
                                 void* stream) {
  if (n <= 0) return 0;
  if (!args_ok(bit_inc, max_val)) return (int)cudaErrorInvalidValue;
  RdArgs a{};
  a.org = static_cast<const int16_t*>(org);
  a.pred = static_cast<const int16_t*>(pred);
  a.qp = static_cast<const int32_t*>(qp);
  a.basis = static_cast<const int32_t*>(basis);
  a.level_bits = static_cast<const int32_t*>(level_bits);
  a.n = n;
  a.is_intra = is_intra != 0;
  a.bit_inc = bit_inc;
  a.max_val = max_val;
  a.dist = static_cast<int32_t*>(dist);
  a.bits = static_cast<float*>(bits);
  return dispatch_rd<0>(size, a, static_cast<cudaStream_t>(stream));
}

// plane0, plane1: int16 [height, width] padded source planes (luma: plane1
// unused; chroma: Cb, Cr); mode: int32 [nby * nbx, k] mode ids of each
// block, the same for every plane; items n = planes * nby * nbx * k in
// (plane, block, mode) order; qp int32 [n].  Intra items: the DST at 4x4,
// offset 171.
extern "C" int thevc_tu_rd_intra(const void* plane0, const void* plane1,
                                 int height, int width, int nby, int nbx,
                                 int k, int planes, const void* mode,
                                 const void* qp, const void* basis,
                                 const void* level_bits, int size, int luma,
                                 int bit_inc, int max_val, void* dist,
                                 void* bits, void* stream) {
  const int s = size < 0 ? -size : size;
  if (nby <= 0 || nbx <= 0 || k <= 0) return 0;
  if (!args_ok(bit_inc, max_val) || planes < 1 || planes > 2
      || (long long)nby * s + s + 1 > height
      || (long long)nbx * s + s + 1 > width)
    return (int)cudaErrorInvalidValue;
  RdArgs a{};
  a.plane0 = static_cast<const int16_t*>(plane0);
  a.plane1 = static_cast<const int16_t*>(planes == 2 ? plane1 : plane0);
  a.width = width;
  a.nbx = nbx;
  a.k = k;
  a.per_plane = nby * nbx * k;
  a.mode = static_cast<const int32_t*>(mode);
  a.qp = static_cast<const int32_t*>(qp);
  a.basis = static_cast<const int32_t*>(basis);
  a.level_bits = static_cast<const int32_t*>(level_bits);
  a.n = (long long)planes * a.per_plane;
  a.is_intra = 1;
  a.bit_inc = bit_inc;
  a.max_val = max_val;
  a.dist = static_cast<int32_t*>(dist);
  a.bits = static_cast<float*>(bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return luma ? dispatch_rd<1>(size, a, st) : dispatch_rd<2>(size, a, st);
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
