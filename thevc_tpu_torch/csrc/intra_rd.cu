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
// chroma reads unfiltered lines and has no DC or edge filter.  Samples lie
// in 0..max_val with max_val < 256 << bit_inc and <= 32767 (the samples of
// the int16 planes at the bit depth; the entries refuse a larger max_val,
// since the operand forms below rest on it).  SATD: 8x8
// Hadamard blocks when s % 8 == 0, else 4x4, normalised ((sad + 2) >> 2,
// (sad + 1) >> 1), summed, >> bit_inc, as csrc/satd.cu.
//
// The reference array.  As HM's xPredIntraAng, a (block, mode) reads its
// refMain: r[k] for k >= 0 the main line (the corner at 0), for k < 0 the
// side line projected at (128 - k * invAngle) >> 8, each from the raw or
// the smoothed lines as the mode's threshold says.  A predicted row y is
// the window r[x + (pos >> 5) + 1], r[x + (pos >> 5) + 2] lerped by one
// weight f = pos & 31, pos = (y + 1) * angle.  Modes 2..17 run as the
// vertical mode 36 - m on the swapped lines (the left line main): that
// prediction is the block's transposed.  The sweep compares it with the
// transposed source: the Hadamard SATD of a transposed 8x8 (4x4) tile is
// the tile's own (H D^T H = (H D H)^T, H symmetric) and a block's tiles map
// one to one, so the SATD is the mode's (tests/test_torch_intra_rd_bounds.
// py proves it on the plain form).  Mode 26's edge filter is then mode 10's
// too: (side[y + 1] - side[0]) >> 1 on column 0.
//
// What bounds them on this card, and the design.
//
// Kernel A does, per predicted sample, the lerp, the residual and its share
// of two Hadamard passes and an absolute sum, over 35 * s^2 samples a block
// (at 1080p 5 classes of 73 M samples), and reads each block and its
// 4s + 1 reference samples once: bound by operations.  The first design (a
// thread a (mode, block, tile) item, the whole tile in registers, the
// reference index computed per sample) ran at 11% of that bound with 97
// registers a thread and 32-way bank conflicts on the source.  Here:
//  - a warp owns a 16x16 region of the frame (16 4x4 blocks, 4 8x8 ones, or
//    a quarter or sixteenth of a larger block) for all 35 modes, two modes
//    a step; lane (g, t) predicts rows g and g + 8, columns 4t..4t+3: two
//    runs of four samples, each from five consecutive reference samples;
//    at most 64 registers (__launch_bounds__), 32 warps an SM;
//  - the CTA keeps each block's main lines (corner and above, corner and
//    left; raw and smoothed) as floats in shared memory, and a run reads
//    its five samples from the main line, or for a negative angle from the
//    side line at the projected index: measured on the card, that beat
//    building each (block, mode)'s refMain in shared memory (a barrier a
//    mode) at every size (PERF.md).  A sample is then two float
//    FMAs and a third for the rounding: x = (32 - f) r[j] + f r[j+1] + 0.5
//    is exact in float32 (below 2^22), and fma(x, 1/32, 1.5 * 2^23) rounds
//    to 1.5 * 2^23 + ((x - 0.5 + 16) >> 5) exactly (the fraction is within
//    0.485 of an integer), whose low 16 bits are the prediction;
//  - the Hadamard runs on the tensor cores (mma.sync, 8-bit operands, s32
//    accumulators).  H D H = H org H - H pred H, and H org H's first pass
//    (org x block-diagonal H) is computed once a region and rides in the
//    accumulator of the prediction's first pass, whose operand is the
//    prediction's bytes (u8 at 8 bits; at bit_inc 1..4 pred = 16 hi + lo,
//    hi < 256 and lo < 16, against [-16 H; -H] in one k32 product); the
//    first pass is below 8 * 2^(8 + bit_inc) <= 2^15 for bit_inc <= 4, so
//    it packs into int16 exactly (cvt.pack.sat), movmatrix transposes each
//    8x8 block, and the second pass takes it split as 256 hi + lo (two k16
//    products, recombined in int32); |.| is summed from the accumulators
//    and the eight tile sums of a step (two modes, four tiles) reduce over
//    the lanes in nine shuffles;
//  - above bit_inc 4 the first pass no longer fits int16: a template
//    instance of the same kernel does the Hadamard by butterflies, a lane's
//    four columns in registers and the rest by shuffles (measured on the
//    card at 8 and 10 bits, that form took 1.1-1.2x the tensor-core form's
//    time over the five classes, PERF.md);
//  - the per-(block, mode) sums stay in shared memory, and the >> bit_inc
//    and the first-minimum argmin run in the kernel.
//
// Kernel B does four transform passes (8t multiply-adds a sample, t the TU
// size), the quantiser, the bit table, dequantiser, recon and SSE: bound by
// operations.  The first design ran the passes as scalar int32 products
// through shared memory (two shared loads an IMAD, eight CTA barriers a
// TU) at 9-17% of the bound.  Here all four passes run on the tensor cores,
// exactly, as K1's inverse (csrc/residual.cu): the basis (|T| <= 90) is the
// s8 operand, its fragments in registers for the CTA's life, and each int16
// operand is split 256 hi + lo (hi s8, lo u8), the two products recombined
// in int32 with the pass's rounding offset:
//  - the residual: |r| <= R = min(2^(8 + bit_inc) - 1, 32767), the entries
//    refusing a max_val above R;
//  - the forward first pass's output: below Sum_n |T[k][n]| * R /
//    2^(log2 t - 1 + bit_inc) + 1/2, whose largest row is the DC row (64 t):
//    at most 32767 for every t and bit_inc (the CPU test
//    tests/test_torch_intra_rd_bounds.py checks every case), so it packs
//    into int16 exactly;
//  - the dequantised levels and the inverse first pass are clipped to
//    int16 by the plain form itself (cvt.pack.sat does that clip);
//  - every sum is below 32 * 90 * 2^15 < 2^27 in int32.
// A pass's output is in the accumulator layout (row g, g + 8; columns 2t,
// 2t + 1), which is an A operand of the next product once its K order is
// permuted (the basis fragments carry the same permutation).  The forward
// second pass and the inverse second pass contract over rows, so movmatrix
// transposes each 8x8 block before them; the forward output is produced
// transposed (coef^T), which is exactly the inverse first pass's operand.
// A warp owns a 16x16 region (16 4x4 TUs, 4 8x8, one 16x16) or one 32x32
// TU, so a TU needs no CTA barrier; the four quadrants of a 64 (-32) block
// run on the four warps of a CTA, which sums their results once.  The
// quantiser (torch's wrapping int32 arithmetic, as unsigned here), the
// level bits (an int64 count of 2^-23), coded-group and nonzero masks
// (redux.sync), dequant, recon and SSE run on the accumulators' elements;
// the sums reduce by shuffles.  The intra entry builds each TU's refMain
// (its mode's range) in shared memory straight from the plane, then
// predicts its samples from it.  No prediction, coefficient or
// reconstruction reaches device memory.
//
// Floats: the bit estimate is the plain form's, operation for operation:
// the level bits are a float32 table whose values are multiples of 2^-23
// below 2^5, so their float64 sum is exact and equals an int64 count of
// 2^-23 units rounded to float32 once (__ll2float_rn, then an exact
// scaling); then 1.5f * coded groups added above 4x4 (one __fadd_rn), then
// (bits + 2 log2 s) + 1.0f as two __fadd_rn, 0.5f for an all-zero TU; a
// quadrant block's four float32 estimates summed in float64 (exact: four
// values in [0.5, 2^16)) and rounded once.  This source is built with
// -fmad=false too (explicit fmaf stays fused, and is exact where used).
//
// The entries do not allocate or synchronise; they launch on the stream
// they are given and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Exact integer products on the tensor cores, the helpers the transforms
// and the Hadamard are built from (csrc/residual.cu holds its own copies of
// the first of them).
//
// An int16 operand is split as v = 256 * hi + lo, hi its high byte (s8) and
// lo its low byte (u8), and the two products are accumulated apart and
// recombined as 256 * acc_hi + acc_lo in int32; a rounding offset rides in
// the lo product's accumulator.  The fragments are those of
// mma.sync.m16n8k16 / m16n8k32 with 8-bit operands (PTX ISA, "Matrix
// Fragments for mma.m16n8k16 / m16n8k32"): for lane l, g = l >> 2 and
// t = l & 3,
//   A (row-major 16 x K): rows g and g + 8, columns 4t..4t+3 (and, at
//     k32, 16 + 4t..16 + 4t+3), the lowest column in the lowest byte;
//   B (column-major K x 8): rows 4t..4t+3 (and 16 + 4t..) of column g;
//   C, D (16 x 8, s32): rows g (c0, c1) and g + 8 (c2, c3), columns 2t and
//     2t + 1.
// movmatrix.trans moves an 8x8 matrix of 16-bit elements held as C is
// (row g, columns 2t and 2t + 1, the lower column in the lower half) into
// its transpose in the same layout.

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// four int16, elements 0 and 1 in x (0 in the low half), 2 and 3 in y ->
// their high bytes as s8 and their low bytes as u8, element 0 in the
// lowest byte: v = 256 * hi + lo
__device__ __forceinline__ void split4(uint32_t x, uint32_t y, uint32_t* hi,
                                       uint32_t* lo) {
  *hi = __byte_perm(x, y, 0x7531);
  *lo = __byte_perm(x, y, 0x6420);
}

// the low bytes of four words, the first in the lowest byte
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// the low halves of two words, a in the low half
__device__ __forceinline__ uint32_t low_halves(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5410);
}

// two int32 -> two int16 saturated, lo in bits 0-15
__device__ __forceinline__ uint32_t pack_sat(int lo, int hi) {
  uint32_t d;
  asm("cvt.pack.sat.s16.s32 %0, %1, %2;" : "=r"(d) : "r"(hi), "r"(lo));
  return d;
}

// the 8x8 16-bit matrix held as C is, transposed
__device__ __forceinline__ uint32_t movt(uint32_t x) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(d) : "r"(x));
  return d;
}

// D = A (16x16, row) * B (16x8, col) + C; the suffix names the A and B
// types (s: s8, u: u8)
#define MMA_S8_K16(NAME, TYPES)                                               \
  __device__ __forceinline__ void NAME(const uint32_t a[2], uint32_t b,       \
                                       const int c[4], int d[4]) {            \
    asm volatile("mma.sync.aligned.m16n8k16.row.col.s32." TYPES ".s32 "       \
                 "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};\n"            \
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])             \
                 : "r"(a[0]), "r"(a[1]), "r"(b), "r"(c[0]), "r"(c[1]),        \
                   "r"(c[2]), "r"(c[3]));                                     \
  }
MMA_S8_K16(mma16_ss, "s8.s8")
MMA_S8_K16(mma16_us, "u8.s8")

// D = A (16x32, row) * B (32x8, col) + C
#define MMA_S8_K32(NAME, TYPES)                                               \
  __device__ __forceinline__ void NAME(const uint32_t a[4],                   \
                                       const uint32_t b[2], const int c[4],   \
                                       int d[4]) {                            \
    asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TYPES ".s32 "       \
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "                    \
                 "{%10,%11,%12,%13};\n"                                       \
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),     \
                   "r"(b[1]), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));    \
  }
MMA_S8_K32(mma32_ss, "s8.s8")
MMA_S8_K32(mma32_us, "u8.s8")

#undef MMA_S8_K16
#undef MMA_S8_K32

constexpr int kPlanar = 0;
constexpr int kDc = 1;
constexpr int kHor = 10;
constexpr int kVer = 26;
constexpr int kModes = 35;
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23: ulp 1 in [2^23, 2^24)

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

// the K index of A-fragment slot s of a 16-wide operand held as C is: slot
// 4t + i is column 2t + i (i < 2), else 8 + 2t + i - 2
__device__ __forceinline__ int perm16(int s) {
  const int t = s >> 2, i = s & 3;
  return i < 2 ? 2 * t + i : 8 + 2 * t + i - 2;
}

// Sylvester Hadamard entry, block-diagonal of blocks of B (4 or 8) over 16
template <int B>
__device__ __forceinline__ int hblk(int k, int n) {
  return (k / B == n / B) ? ((__popc((k % B) & (n % B)) & 1) ? -1 : 1) : 0;
}

// A mode as the vertical form: hor (run on the transposed block), the
// angle, invAngle, the smoothed lines or not, and whether it is mode 26's
// (or 10's) edge-filtered copy
struct Ang {
  int hor;
  int angle;
  int inv;
  int filt;
  int edge;
};

template <int S>
__device__ __forceinline__ Ang angular(int mode, bool luma) {
  Ang m;
  m.hor = mode < 18;
  const int v = m.hor ? 36 - mode : mode;
  const int ipa = v - kVer;
  const int a = ipa < 0 ? -ipa : ipa;
  m.angle = ipa < 0 ? -kAngTable[a] : kAngTable[a];
  m.inv = kInvAngTable[a];
  const int dh = mode > kHor ? mode - kHor : kHor - mode;
  const int dv = mode > kVer ? mode - kVer : kVer - mode;
  m.filt = luma && (dh < dv ? dh : dv) > filter_thresh(ilog2(S));
  m.edge = luma && v == kVer;
  return m;
}

// planar reads the smoothed lines where 10 > the threshold (luma)
template <int S>
__host__ __device__ constexpr bool planar_filtered(bool luma) {
  return luma && 10 > filter_thresh(ilog2(S));
}

// the range [lo, hi] of refMain indices a mode reads (with mode 26's edge
// deltas at -S..-1)
template <int S>
__device__ __forceinline__ void ref_range(const Ang& m, int* lo, int* hi) {
  if (m.angle >= 0) {
    *lo = m.edge ? -S : 1;
    *hi = S + ((S * m.angle) >> 5) + 1;
  } else {
    *lo = ((S * m.angle) >> 5) + 1;
    *hi = S;
  }
}

// refMain[k] of a block from its lines in c layout (c[0..2S] = left[0..2S],
// c[2S + j] = above[j]; the corner at 0): main(k), side(j)
template <int S, typename F>
__device__ __forceinline__ int ref_value(const Ang& m, int k, F&& c) {
  auto main_at = [&](int i) {
    return m.hor ? c(i) : (i ? c(2 * S + i) : c(0));
  };
  auto side_at = [&](int j) {
    return m.hor ? (j ? c(2 * S + j) : c(0)) : c(j);
  };
  if (k > 2 * S) return 0;
  if (k >= 0) return main_at(k);
  if (m.edge) return (side_at(-k) - side_at(0)) >> 1;
  return side_at((128 - k * m.inv) >> 8);
}

// the [1 2 1]-smoothed twin of line element j of a line in c layout
template <int S, typename F>
__device__ __forceinline__ int smooth_at(int j, F&& c) {
  if (j == 0) return (c(2 * S + 1) + 2 * c(0) + c(1) + 2) >> 2;
  if (j == 2 * S || j == 4 * S) return c(j);
  const int prev = j == 2 * S + 1 ? c(0) : c(j - 1);
  return (prev + 2 * c(j) + c(j + 1) + 2) >> 2;
}

// line element j (c layout) of the block whose corner is at (y0, x0) of the
// padded plane
template <int S>
__device__ __forceinline__ int line_sample(const int16_t* plane, int width,
                                           int y0, int x0, int j) {
  return j <= 2 * S ? plane[(size_t)(y0 + j) * width + x0]
                    : plane[(size_t)y0 * width + x0 + (j - 2 * S)];
}

// the float whose value is f (0 <= f < 2^23), without a conversion unit
__device__ __forceinline__ float small_float(int f) {
  return __int_as_float(0x4B000000 | f) - 8388608.0f;
}

// ---------------------------------------------------------------------------
// Kernel A: the 35-mode sweep of one luma size class
// ---------------------------------------------------------------------------

enum SweepForm { kNarrow = 0, kWide = 1, kButterfly = 2 };

template <int S>
struct SweepShape {
  static constexpr int GS = S < 16 ? S : 16;        // block size in a region
  static constexpr int BPR = 16 / GS;               // blocks a region row
  static constexpr int BPG = BPR * BPR;             // blocks a region
  static constexpr int SPB = S > 16 ? S / 16 : 1;   // regions a block row
  static constexpr int GPB = SPB * SPB;             // regions a block
  static constexpr int NW = S == 64 ? 16 : 8;       // warps a CTA
  static constexpr int NBLK = S <= 16 ? NW * BPG : NW / GPB;  // blocks a CTA
  static constexpr int TB = S % 8 == 0 ? 8 : 4;     // Hadamard tile
  static constexpr int L = 4 * S + 1;               // line length
  static constexpr int NF = (S == 8 || S == 16 || S == 32) ? 2 : 1;
  // CTAs an SM must hold: 32 warps, so at most 64 registers a thread
  static constexpr int MINB = 32 / NW;
  static constexpr int LL = 2 * S + 2;              // a main line, padded
};

// The sweep takes two modes a step: planar and DC, then the V modes 18..34
// (the last step 34 twice, its copy not stored), then the H modes 2..17.
constexpr int kSteps = 18;
constexpr int kFirstH = 10;

__device__ __forceinline__ int step_mode(int step, int mm) {
  if (step == 0) return mm;
  if (step < kFirstH) return min(16 + 2 * step + mm, 34);
  return 2 * (step - kFirstH) + 2 + mm;
}

template <int S, int FORM>
__global__ void __launch_bounds__(SweepShape<S>::NW * 32,
                                  SweepShape<S>::MINB)
sweep_kernel(const int16_t* __restrict__ plane, int width, int nby, int nbx,
             int bit_inc, int max_val, int32_t* __restrict__ out,
             int32_t* __restrict__ best) {
  using Sh = SweepShape<S>;
  constexpr int NW = Sh::NW, NTH = NW * 32, GS = Sh::GS, BPR = Sh::BPR;
  constexpr int NBLK = Sh::NBLK, L = Sh::L, NF = Sh::NF;
  constexpr int TB = Sh::TB;
  constexpr int LOG2 = ilog2(S);
  constexpr int LL = Sh::LL;
  __shared__ int lines[NBLK][NF][L];
  // each block's main lines as floats, [V (corner, above), H (corner,
  // left)][raw, smoothed], one zero past the end
  __shared__ float fl[NBLK][2 * NF][LL];
  __shared__ int dcs[NBLK];
  __shared__ int bid[NBLK];
  __shared__ int sums[NBLK][kModes];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nb = nby * nbx;

  // -- this CTA's blocks ---------------------------------------------------
  const int ngx = (nbx + BPR - 1) / BPR, ngy = (nby + BPR - 1) / BPR;
  auto block_of = [&](int lb) -> int {   // global block index, -1 if dead
    if (S <= 16) {
      const int gid = blockIdx.x * NW + lb / Sh::BPG, bi = lb % Sh::BPG;
      if (gid >= ngx * ngy) return -1;
      const int by = (gid / ngx) * BPR + bi / BPR;
      const int bx = (gid % ngx) * BPR + bi % BPR;
      return by < nby && bx < nbx ? by * nbx + bx : -1;
    }
    const int b = blockIdx.x * NBLK + lb;
    return b < nb ? b : -1;
  };
  for (int lb = tid; lb < NBLK; lb += NTH) bid[lb] = block_of(lb);
  for (int i = tid; i < NBLK * kModes; i += NTH) (&sums[0][0])[i] = 0;
  __syncthreads();
  for (int i = tid; i < NBLK * L; i += NTH) {
    const int lb = i / L, j = i % L, b = bid[lb];
    lines[lb][0][j] = b < 0 ? 0 : line_sample<S>(plane, width, (b / nbx) * S,
                                                 (b % nbx) * S, j);
  }
  __syncthreads();
  if (NF == 2)
    for (int i = tid; i < NBLK * L; i += NTH) {
      const int lb = i / L, j = i % L;
      lines[lb][NF - 1][j] =
          smooth_at<S>(j, [&](int x) { return lines[lb][0][x]; });
    }
  for (int lb = tid; lb < NBLK; lb += NTH) {
    int sum = S;
    for (int k = 1; k <= S; ++k)
      sum += lines[lb][0][k] + lines[lb][0][2 * S + k];
    dcs[lb] = sum >> (LOG2 + 1);
  }
  __syncthreads();   // the smoothed lines
  for (int i = tid; i < NBLK * 2 * NF * LL; i += NTH) {
    const int lb = i / (2 * NF * LL), w = (i / LL) % (2 * NF), j = i % LL;
    const int* c = lines[lb][w % NF];
    const int v = j > 2 * S ? 0 : w < NF ? (j ? c[2 * S + j] : c[0]) : c[j];
    fl[lb][w][j] = small_float(v);
  }

  // -- this warp's region: its pixel origin, and its block for S >= 16 -----
  int gy0, gx0, wblk, suby = 0, subx = 0;
  bool wlive;
  if (S <= 16) {
    const int gid = blockIdx.x * NW + warp;
    wlive = gid < ngx * ngy;
    gy0 = wlive ? (gid / ngx) * 16 : 0;
    gx0 = wlive ? (gid % ngx) * 16 : 0;
    wblk = -1;
  } else {
    wblk = warp / Sh::GPB;
    const int sub = warp % Sh::GPB;
    suby = sub / Sh::SPB;
    subx = sub % Sh::SPB;
    const int b = block_of(wblk);
    wlive = b >= 0;
    gy0 = wlive ? (b / nbx) * S + 16 * suby : 0;
    gx0 = wlive ? (b % nbx) * S + 16 * subx : 0;
  }
  // is the pixel (py, px) of the class grid inside a live block?
  auto live_px = [&](int py, int px) {
    return wlive && py < nby * S && px < nbx * S;
  };
  auto org_at = [&](int py, int px) -> int {
    return live_px(py, px) ? plane[(size_t)(1 + py) * width + 1 + px] : 0;
  };
  // the region-local block of oriented region coordinates (ry, rx)
  auto local_block = [&](bool hor, int ry, int rx) -> int {
    if (S > 16) return wblk;
    const int oby = ry / GS, obx = rx / GS;
    return warp * Sh::BPG + (hor ? obx * BPR + oby : oby * BPR + obx);
  };

  // -- constant fragments ----------------------------------------------------
  // pass 1: B[k][n] = sign * Hblk[k][8h + n], k = 4t + i (identity K
  // order), the prediction's copy negated.  Wide (k32): rows 0..15 the hi
  // part, scaled by 16, rows 16..31 the lo part.  Pass 2: K order
  // perm16, the accumulator layout of pass 1.
  auto b1 = [&](int h, int sign, uint32_t (&b)[2]) {
    int v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = sign * hblk<TB>(4 * t + i, 8 * h + g);
    const int m = FORM == kWide ? 16 : 1;
    b[0] = pack_s8(m * v[0], m * v[1], m * v[2], m * v[3]);
    b[1] = pack_s8(v[0], v[1], v[2], v[3]);
  };
  uint32_t b1n[2][2], b2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    b1(h, -1, b1n[h]);
    b2[h] = pack_s8(hblk<TB>(perm16(4 * t), 8 * h + g),
                    hblk<TB>(perm16(4 * t + 1), 8 * h + g),
                    hblk<TB>(perm16(4 * t + 2), 8 * h + g),
                    hblk<TB>(perm16(4 * t + 3), 8 * h + g));
  }
  const int zero4[4] = {0, 0, 0, 0};

  // this thread's source samples in the current orientation (rows g,
  // g + 8, columns 4t..4t+3 of the oriented region): the butterflies keep
  // them; the tensor-core forms keep org x Hblk (C layout, [h][c])
  int orgv[2][4];
  int orgh[2][4];
  auto load_org = [&](bool hor) {
    int v[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[r][j] = hor ? org_at(gy0 + 4 * t + j, gx0 + g + 8 * r)
                      : org_at(gy0 + g + 8 * r, gx0 + 4 * t + j);
    if (FORM == kButterfly) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) orgv[r][j] = v[r][j];
      return;
    }
    uint32_t a[4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (FORM == kNarrow) {
        a[r] = pack_s8(v[r][0], v[r][1], v[r][2], v[r][3]);
      } else {
        a[r] = pack_s8(v[r][0] >> 4, v[r][1] >> 4, v[r][2] >> 4,
                       v[r][3] >> 4);
        a[2 + r] = pack_s8(v[r][0] & 15, v[r][1] & 15, v[r][2] & 15,
                           v[r][3] & 15);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[2];
      b1(h, 1, b);
      if (FORM == kNarrow)
        mma16_us(a, b[1], zero4, orgh[h]);
      else
        mma32_us(a, b, zero4, orgh[h]);
    }
  };
  load_org(false);
  __syncthreads();   // lines, smoothed lines, dcs

  const float maxf = (float)max_val;
  for (int step = 0; step < kSteps; ++step) {
    const bool hor = step >= kFirstH;
    int mode[2];
    Ang m[2];
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
      mode[mm] = step_mode(step, mm);
      m[mm] = step ? angular<S>(mode[mm], true) : Ang{};
    }
    if (step == kFirstH) load_org(true);

    // -- the predictions of the two runs (low 16 bits of q) of both modes,
    // each packed into its operand at once: the prediction's bytes
    // (narrow: pred; wide: pred >> 4 in a[r], pred & 15 in a[2 + r]) or
    // the residual
    uint32_t a[2][4];
    int d[2][2][4];
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ry = g + 8 * r, rx0 = 4 * t;
        const int lb = local_block(hor, ry, rx0);
        // oriented in-block row and first column
        const int oy = S > 16 ? 16 * (hor ? subx : suby) + ry : ry % GS;
        const int ox0 = S > 16 ? 16 * (hor ? suby : subx) + rx0 : rx0 % GS;
        uint32_t q[4];
        if (step) {
          const Ang& ma = m[mm];
          const int pos = (oy + 1) * ma.angle;
          const float w1 = small_float(pos & 31), w0 = 32.0f - w1;
          const int k0 = ox0 + (pos >> 5) + 1;
          // refMain[k]: the main line for k >= 0, the side line
          // projected for k < 0 (negative angles only)
          const float* mainp = fl[lb][(hor ? NF : 0) + ma.filt];
          const float* sidep = fl[lb][(hor ? 0 : NF) + ma.filt];
          float v[5];
          if (ma.angle >= 0) {
#pragma unroll
            for (int j = 0; j < 5; ++j) v[j] = mainp[k0 + j];
          } else {
#pragma unroll
            for (int j = 0; j < 5; ++j) {
              const int k = k0 + j;
              v[j] = *(k >= 0 ? mainp + k : sidep + ((128 - k * ma.inv) >> 8));
            }
          }
          // mode 26's (10's) edge: (side[y + 1] - side[0]) >> 1
          if (ma.edge && ox0 == 0)
            v[0] = fminf(fmaxf(v[0] + floorf((sidep[oy + 1] - sidep[0]) * 0.5f),
                               0.0f),
                         maxf);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            q[j] = __float_as_uint(fmaf(
                fmaf(w1, v[j + 1], fmaf(w0, v[j], 0.5f)), 0.03125f, kMagic));
        } else {
          const int* c = lines[lb][mm == 0 && planar_filtered<S>(true)
                                       ? NF - 1 : 0];
          const int dc = dcs[lb];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int x = ox0 + j, y = oy;
            int p;
            if (mm == 0) {
              p = ((S - 1 - x) * c[y + 1] + (x + 1) * c[3 * S + 1]
                   + (S - 1 - y) * c[2 * S + 1 + x] + (y + 1) * c[S + 1] + S)
                  >> (LOG2 + 1);
            } else if (x > 0 && y > 0) {
              p = dc;
            } else if (x == 0 && y == 0) {
              p = (c[2 * S + 1] + c[1] + 2 * dc + 2) >> 2;
            } else if (y == 0) {
              p = (c[2 * S + 1 + x] + 3 * dc + 2) >> 2;
            } else {
              p = (c[1 + y] + 3 * dc + 2) >> 2;
            }
            q[j] = (uint32_t)p;
          }
        }
        if (FORM == kNarrow) {
          a[mm][r] = low_bytes(q[0], q[1], q[2], q[3]);
        } else if (FORM == kWide) {
          const uint32_t p01 = low_halves(q[0], q[1]);
          const uint32_t p23 = low_halves(q[2], q[3]);
          a[mm][r] = __byte_perm(p01 >> 4, p23 >> 4, 0x6420);
          a[mm][2 + r] =
              __byte_perm(p01 & 0x000F000Fu, p23 & 0x000F000Fu, 0x6420);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            d[mm][r][j] = orgv[r][j] - (int)(q[j] & 0xFFFFu);
        }
      }
    }

    // -- the Hadamard SATD of the region's four 8x8 (sixteen 4x4) tiles ----
    // s[mm][r][h]: this lane's |.| sum of the tile in row half r, column
    // half h, of mode mm
    int s[2][2][2];
    if constexpr (FORM != kButterfly) {
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        int c1[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (FORM == kNarrow)
            mma16_us(a[mm], b1n[h][1], orgh[h], c1[h]);
          else
            mma32_us(a[mm], b1n[h], orgh[h], c1[h]);
        }
        // pack (exact: |first pass| < 2^15), transpose each 8x8 block
        uint32_t mt[2][2];   // [h][r]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mt[h][0] = movt(pack_sat(c1[h][0], c1[h][1]));
          mt[h][1] = movt(pack_sat(c1[h][2], c1[h][3]));
        }
        uint32_t ah[2], al[2];
        split4(mt[0][0], mt[1][0], &ah[0], &al[0]);
        split4(mt[0][1], mt[1][1], &ah[1], &al[1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int yh[4], yl[4];
          mma16_ss(ah, b2[h], zero4, yh);
          mma16_us(al, b2[h], zero4, yl);
          s[mm][0][h] = abs(yh[0] * 256 + yl[0]) + abs(yh[1] * 256 + yl[1]);
          s[mm][1][h] = abs(yh[2] * 256 + yl[2]) + abs(yh[3] * 256 + yl[3]);
        }
      }
    } else {
      // butterflies: a lane's four columns in registers, the rest across
      // lanes (columns 4..7 of a tile on lane ^ 1; rows on lanes ^ 4, 8, 16)
      auto bf = [&](int& v, int other, bool upper) {
        v = upper ? other - v : v + other;
      };
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          int* e = d[mm][r];
          const int a0 = e[0] + e[1], a1 = e[0] - e[1];
          const int a2 = e[2] + e[3], a3 = e[2] - e[3];
          e[0] = a0 + a2;
          e[2] = a0 - a2;
          e[1] = a1 + a3;
          e[3] = a1 - a3;
        }
#pragma unroll
      for (int o = TB == 8 ? 1 : 4; o <= (TB == 8 ? 16 : 8); o <<= 1) {
        if (o == 2) continue;
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bf(d[mm][r][j], __shfl_xor_sync(0xffffffffu, d[mm][r][j], o),
                 lane & o);
      }
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int* e = d[mm][r];
          const int v = abs(e[0]) + abs(e[1]) + abs(e[2]) + abs(e[3]);
          const bool right = TB == 8 ? t >= 2 : false;
          s[mm][r][0] = right ? 0 : v;
          s[mm][r][1] = right ? v : 0;
        }
    }

    // -- each tile's sum onto one lane: eight values (mode, row half,
    // column half) scattered over the lanes that share a tile, one
    // selector bit a step, then the rest summed in full.  Tensor-core
    // forms: an 8x8 tile (r, h) spans all lanes; a 4x4 subtile (g / 4,
    // t / 2) of block (r, h) the lanes sharing bits 1 and 4.
    // Butterflies: 8x8 as above; a 4x4 tile (g / 4 + 2r, t) the lanes
    // sharing bits 0, 1 and 4.
    auto pick = [&](int mask) { return (lane & mask) != 0; };
    int tsum, mm, ty, tx;
    if (FORM == kButterfly && TB == 4) {
      // r by bit 3, the mode by bit 2
      const bool br = pick(8), bm = pick(4);
      int k0 = (br ? s[0][1][0] : s[0][0][0])
               + __shfl_xor_sync(0xffffffffu, br ? s[0][0][0] : s[0][1][0], 8);
      int k1 = (br ? s[1][1][0] : s[1][0][0])
               + __shfl_xor_sync(0xffffffffu, br ? s[1][0][0] : s[1][1][0], 8);
      tsum = (bm ? k1 : k0) + __shfl_xor_sync(0xffffffffu, bm ? k0 : k1, 4);
      mm = bm;
      ty = ((lane >> 4) & 1) + 2 * br;   // tile row g / 4 + 2r
      tx = t;
    } else {
      // r, h, then the mode, each by a selector bit
      const int mr = TB == 8 ? 16 : 8, mh = TB == 8 ? 8 : 4;
      const int mmode = TB == 8 ? 4 : 1;
      const bool br = pick(mr), bh = pick(mh), bm = pick(mmode);
      int k[2][2];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          k[x][h] = (br ? s[x][1][h] : s[x][0][h])
                    + __shfl_xor_sync(0xffffffffu,
                                      br ? s[x][0][h] : s[x][1][h], mr);
      int k2[2];
#pragma unroll
      for (int x = 0; x < 2; ++x)
        k2[x] = (bh ? k[x][1] : k[x][0])
                + __shfl_xor_sync(0xffffffffu, bh ? k[x][0] : k[x][1], mh);
      tsum = (bm ? k2[1] : k2[0])
             + __shfl_xor_sync(0xffffffffu, bm ? k2[0] : k2[1], mmode);
      mm = bm;
      if (TB == 8) {
        tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
        tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
        ty = br;
        tx = bh;
      } else {
        // the subtile at (bit 4, bit 1) of the transposed block is the
        // tile (bit 1, bit 4) of block (r, h)
        ty = 2 * br + ((lane >> 1) & 1);
        tx = 2 * bh + ((lane >> 4) & 1);
      }
    }
    const bool rep = TB == 4 || (lane & 3) == 0;
    const int mo = mm ? mode[1] : mode[0];
    if (rep && !(mm && mode[1] == mode[0])) {
      const int v = TB == 8 ? (tsum + 2) >> 2 : (tsum + 1) >> 1;
      const int lb = local_block(hor, ty * TB, tx * TB);
      if (lb >= 0 && bid[lb] >= 0) atomicAdd(&sums[lb][mo], v);
    }
  }
  __syncthreads();

  for (int i = tid; i < NBLK * kModes; i += NTH) {
    const int lb = i / kModes, mo = i % kModes;
    if (bid[lb] >= 0)
      out[(size_t)bid[lb] * kModes + mo] = sums[lb][mo] >> bit_inc;
  }
  for (int lb = tid; lb < NBLK; lb += NTH) {
    if (bid[lb] < 0) continue;
    int arg = 0, lo = sums[lb][0] >> bit_inc;
    for (int mo = 1; mo < kModes; ++mo) {
      const int v = sums[lb][mo] >> bit_inc;
      if (v < lo) {
        lo = v;
        arg = mo;
      }
    }
    best[bid[lb]] = arg;
  }
}

// ---------------------------------------------------------------------------
// Kernel B: the transform-RD estimate of a batch of TUs
// ---------------------------------------------------------------------------

constexpr int kRdWarps = 4;

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

__device__ __forceinline__ int quant_level(int coef, int4 qc) {
  // qc: qscale, qadd, qb, dscale; torch's wrapping int32 arithmetic
  const int tmp = (int)((unsigned)abs(coef) * (unsigned)qc.x);
  int level = (int)((unsigned)tmp + (unsigned)qc.y) >> qc.z;
  level = coef > 0 ? level : coef < 0 ? -level : 0;
  return clampi(level, -32768, 32767);
}

__device__ __forceinline__ int dequant(int level, int dscale, int dshift) {
  const int prod = (int)((unsigned)level * (unsigned)dscale);
  return clampi(
      (int)((unsigned)prod + (unsigned)(1 << (dshift - 1))) >> dshift,
      -32768, 32767);
}

template <typename V>
__device__ __forceinline__ V shfl64(V v, int o) {
  return (V)__shfl_xor_sync(0xffffffffu, (long long)v, o);
}

// Sum of four per-lane values a[r][h] over the lanes that share a TU, kept
// on one lane each: row half r by lane bit mr, column half h by lane bit
// mh, then the bits in rest (a mask of xor offsets) summed in full.
template <typename V>
__device__ __forceinline__ V scatter_sum(const V (&a)[2][2], int lane, int mr,
                                         int mh, int rest) {
  const bool br = lane & mr, bh = lane & mh;
  V k0 = (br ? a[1][0] : a[0][0]) + shfl64(br ? a[0][0] : a[1][0], mr);
  V k1 = (br ? a[1][1] : a[0][1]) + shfl64(br ? a[0][1] : a[1][1], mr);
  V k = (bh ? k1 : k0) + shfl64(bh ? k0 : k1, mh);
  for (int o = 16; o > 0; o >>= 1)
    if (rest & o) k += shfl64(k, o);
  return k;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += shfl64(v, o);
  return v;
}

// A slot's prediction: the mode as the vertical form (or planar / DC), its
// reference array (angular: refMain[k] at ref[S + k], mode 26's (10's)
// edge deltas below 0; planar, DC: left[1..S+1] at ref[0..S],
// above[1..S+1] at ref[S+1..2S+1]) and DC value
struct SlotPred {
  int kind;    // 0 planar, 1 DC, 2 angular
  Ang m;
  const int* ref;
  int dc;
};

template <int S, bool LUMA>
__device__ __forceinline__ int predict_at(const SlotPred& p, int y, int x,
                                          int max_val) {
  const int* r = p.ref;
  if (p.kind == 2) {
    const int oy = p.m.hor ? x : y, ox = p.m.hor ? y : x;
    const int pos = (oy + 1) * p.m.angle;
    const int f = pos & 31, k = ox + (pos >> 5) + 1;
    int v = ((32 - f) * r[S + k] + f * r[S + k + 1] + 16) >> 5;
    if (p.m.edge && ox == 0) v = clampi(v + r[S - 1 - oy], 0, max_val);
    return v;
  }
  if (p.kind == 0)
    return ((S - 1 - x) * r[y] + (x + 1) * r[2 * S + 1]
            + (S - 1 - y) * r[S + 1 + x] + (y + 1) * r[S] + S)
           >> (ilog2(S) + 1);
  const int dc = p.dc;
  if (!LUMA || (x > 0 && y > 0)) return dc;
  if (x == 0 && y == 0) return (r[S + 1] + r[0] + 2 * dc + 2) >> 2;
  if (y == 0) return (r[S + 1 + x] + 3 * dc + 2) >> 2;
  return (r[y] + 3 * dc + 2) >> 2;
}

// SRC: 0 the given prediction, 1 a luma mode, 2 a chroma mode
template <int T, int NQ, int SRC>
struct RdShape {
  static constexpr int S = NQ == 4 ? 2 * T : T;      // block size
  static constexpr int TPR = T <= 16 ? (16 / T) * (16 / T) : 1;  // TUs a warp
  static constexpr int RM = 3 * S + 2;              // refMain, k = -S..2S+1
  static constexpr bool INTRA = SRC != 0;
  static constexpr int NSLOT = INTRA ? TPR : 1;
};

template <int T, int NQ, int SRC>
__global__ void __launch_bounds__(kRdWarps * 32) tu_rd_kernel(RdArgs a) {
  using Sh = RdShape<T, NQ, SRC>;
  constexpr int S = Sh::S, TPR = Sh::TPR, RM = Sh::RM;
  constexpr int LOG2T = ilog2(T);
  constexpr bool kIntra = Sh::INTRA, kLuma = SRC == 1;
  constexpr int NW = kRdWarps;
  // intra: each slot's reference array
  __shared__ int ref_s[NW][Sh::NSLOT][kIntra ? RM : 1];
  __shared__ int4 qc_s[NW][TPR];
  __shared__ long long item_s[NW][TPR];
  __shared__ int pm_s[NW][TPR][4];          // intra: y0, x0, plane, mode
  __shared__ Ang ang_s[NW][kIntra ? TPR : 1];   // intra: the mode's form
  __shared__ int dc_s[NW][TPR];
  __shared__ unsigned long long units_s[NW][TPR], sse_s[NW][TPR];
  __shared__ int16_t op_s[T == 32 ? NW : 1][T == 32 ? 2 : 1]
                         [T == 32 ? 32 * 32 : 1];
  __shared__ long long qd_s[NW];
  __shared__ float qb_s[NW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long tu0 = ((long long)blockIdx.x * NW + warp) * TPR;
  const long long ntu = a.n * NQ;

  // -- per-TU setup ----------------------------------------------------------
  const int ts = 15 - (8 + a.bit_inc) - LOG2T;
  const int dshift = 20 - 14 - ts;
  if (lane < TPR) {
    const long long u = tu0 + lane;
    const bool live = u < ntu;
    const long long item = live ? u / NQ : -1;
    item_s[warp][lane] = item;
    const int qp = live ? a.qp[item] : 0;
    const int per = qp / 6, rem = qp % 6;
    const int qb = 14 + per + ts;
    const int sh = qb - 9;   // torch: a negative shift gives 0
    const int base = a.is_intra ? 171 : 85;
    qc_s[warp][lane] = make_int4(kQuantScales[rem],
                                 sh < 0 || sh > 31 ? 0 : base << sh, qb,
                                 kInvQuantScales[rem] << per);
    if (kIntra) {
      const int within = live ? (int)(item % a.per_plane) : 0;
      const int blk = within / a.k;
      pm_s[warp][lane][0] = (blk / a.nbx) * S;
      pm_s[warp][lane][1] = (blk % a.nbx) * S;
      pm_s[warp][lane][2] = live && item >= a.per_plane;
      const int mode = live ? a.mode[within] : kDc;
      pm_s[warp][lane][3] = mode;
      ang_s[warp][kIntra ? lane : 0] =
          mode >= 2 ? angular<S>(mode, kLuma) : Ang{};
    }
  }
  __syncwarp();

  // -- intra: each slot's reference array from the plane (smoothed where
  // its mode says) ------------------------------------------------------
  if constexpr (kIntra) {
    for (int i = lane; i < TPR * RM; i += 32) {
      const int sl = i / RM, e = i % RM;
      if (item_s[warp][sl] < 0) continue;
      const int mode = pm_s[warp][sl][3];
      const int16_t* pl = pm_s[warp][sl][2] ? a.plane1 : a.plane0;
      const int y0 = pm_s[warp][sl][0], x0 = pm_s[warp][sl][1];
      auto raw = [&](int j) {
        return (int)line_sample<S>(pl, a.width, y0, x0, j);
      };
      int v;
      if (mode >= 2) {
        const Ang& m = ang_s[warp][sl];
        int lo, hi;
        ref_range<S>(m, &lo, &hi);
        const int k = e - S;
        if (k < lo || k > hi) continue;
        v = m.filt ? ref_value<S>(m, k, [&](int j) {
                       return smooth_at<S>(j, raw);
                     })
                   : ref_value<S>(m, k, raw);
      } else {
        if (e > 2 * S + 1) continue;
        // left[1..S+1], then above[1..S+1]
        const int j = e <= S ? e + 1 : 2 * S + (e - S);
        v = mode == kPlanar && planar_filtered<S>(kLuma) ? smooth_at<S>(j, raw)
                                                          : raw(j);
      }
      ref_s[warp][sl][e] = v;
    }
    __syncwarp();
    if (lane < TPR && item_s[warp][lane] >= 0 && pm_s[warp][lane][3] == kDc) {
      int sum = S;
      for (int k = 0; k < S; ++k)
        sum += ref_s[warp][lane][k] + ref_s[warp][lane][S + 1 + k];
      dc_s[warp][lane] = sum >> (ilog2(S) + 1);
    }
    __syncwarp();
  }
  auto slot_pred = [&](int sl) {
    SlotPred p;
    const int mode = pm_s[warp][sl][3];
    p.kind = mode == kPlanar ? 0 : mode == kDc ? 1 : 2;
    p.m = ang_s[warp][kIntra ? sl : 0];
    p.ref = ref_s[warp][kIntra ? sl : 0];
    p.dc = dc_s[warp][sl];
    return p;
  };
  // org and pred at (ly, lx) of slot sl's TU (lx even: the pair lx, lx + 1)
  auto load_pair = [&](int sl, int ly, int lx, uint32_t* org, uint32_t* pred) {
    const long long item = item_s[warp][sl];
    if (item < 0) {
      *org = *pred = 0;
      return;
    }
    const int q = (int)((tu0 + sl) % NQ);
    const int by = (q >> 1) * T + ly, bx = (q & 1) * T + lx;
    if constexpr (kIntra) {
      const int16_t* pl = pm_s[warp][sl][2] ? a.plane1 : a.plane0;
      const int y0 = pm_s[warp][sl][0], x0 = pm_s[warp][sl][1];
      const int16_t* o = pl + (size_t)(1 + y0 + by) * a.width + 1 + x0 + bx;
      *org = (uint16_t)o[0] | ((uint32_t)(uint16_t)o[1] << 16);
      const SlotPred p = slot_pred(sl);
      const int p0 = predict_at<S, kLuma>(p, by, bx, a.max_val);
      const int p1 = predict_at<S, kLuma>(p, by, bx + 1, a.max_val);
      *pred = (uint16_t)p0 | ((uint32_t)(uint16_t)p1 << 16);
    } else {
      const size_t o = (size_t)item * (S * S) + (size_t)by * S + bx;
      *org = *reinterpret_cast<const uint32_t*>(a.org + o);
      *pred = *reinterpret_cast<const uint32_t*>(a.pred + o);
    }
  };
  auto lo16 = [](uint32_t v) { return (int)(int16_t)(v & 0xFFFFu); };
  auto hi16 = [](uint32_t v) { return (int)(int16_t)(v >> 16); };
  // the residual pair org - pred (|r| <= min(2^(8 + bit_inc) - 1, 32767):
  // samples in 0..max_val)
  auto resid = [&](uint32_t o, uint32_t p) {
    return low_halves((uint32_t)(lo16(o) - lo16(p)),
                      (uint32_t)(hi16(o) - hi16(p)));
  };

  const int sh1 = LOG2T - 1 + a.bit_inc, sh2 = LOG2T + 6;
  const int ish2 = 12 - a.bit_inc;
  // the passes' rounding offsets, added at the recombination
  const int add1 = 1 << (sh1 - 1), add2 = 1 << (sh2 - 1), add3 = 64;
  const int add4 = 1 << (ish2 - 1);
  const int zero4[4] = {0, 0, 0, 0};
  auto tb = [&](int r, int c) { return a.basis[r * T + c]; };
  auto rec = [](const int h[4], const int l[4], int i, int sh, int add) {
    return (h[i] * 256 + l[i] + add) >> sh;
  };

  unsigned long long units = 0, sse = 0;
  uint32_t cgm[2] = {0, 0};   // coded groups (T > 4) or nonzero TUs (T = 4)

  if constexpr (T <= 16) {
    // basis fragments: F = forward (B[K][N] = T[N][K] in a TU's block), I =
    // inverse (T[K][N]); slot 4t + i is K = perm16(4t + i), N = 8h + g
    uint32_t bf[2], bi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int vf[4], vi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = perm16(4 * t + i), nn = 8 * h + g;
        const bool in = kk / T == nn / T;
        vf[i] = in ? tb(nn % T, kk % T) : 0;
        vi[i] = in ? tb(kk % T, nn % T) : 0;
      }
      bf[h] = pack_s8(vf[0], vf[1], vf[2], vf[3]);
      bi[h] = pack_s8(vi[0], vi[1], vi[2], vi[3]);
    }
    // this lane's pairs: row g + 8r, columns 8h + 2t, + 1 of the region
    uint32_t op[2][2], pp[2][2];
    auto slot_of = [&](int y, int x) { return (y / T) * (16 / T) + x / T; };
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = g + 8 * r, x = 8 * h + 2 * t;
        load_pair(slot_of(y, x), y % T, x % T, &op[r][h], &pp[r][h]);
      }
    // one pass: A from 8x8 blocks blk[r][h] (16-bit pairs, C layout), B
    // fragments b -> the hi and lo products, hi[h][4] and lo[h][4]
    auto pass = [&](const uint32_t (&blk)[2][2], const uint32_t (&b)[2],
                    int (&hi)[2][4], int (&lo)[2][4]) {
      uint32_t ah[2], al[2];
      split4(blk[0][0], blk[0][1], &ah[0], &al[0]);
      split4(blk[1][0], blk[1][1], &ah[1], &al[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma16_ss(ah, b[h], zero4, hi[h]);
        mma16_us(al, b[h], zero4, lo[h]);
      }
    };
    // transpose: each 8x8 block, and for one 16x16 TU the blocks too
    auto transpose = [&](uint32_t (&blk)[2][2]) {
      uint32_t m[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) m[r][h] = movt(blk[r][h]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) blk[r][h] = T == 16 ? m[h][r] : m[r][h];
    };
    uint32_t x[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) x[r][h] = resid(op[r][h], pp[r][h]);
    int hi[2][4], lo[2][4];
    // forward first pass: U = R T^T
    pass(x, bf, hi, lo);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x[0][h] = pack_sat(rec(hi[h], lo[h], 0, sh1, add1),
                         rec(hi[h], lo[h], 1, sh1, add1));
      x[1][h] = pack_sat(rec(hi[h], lo[h], 2, sh1, add1),
                         rec(hi[h], lo[h], 3, sh1, add1));
    }
    transpose(x);
    // forward second pass: coef^T = U^T T^T; quant, bits, dequant
    pass(x, bf, hi, lo);
    unsigned long long ub[2][2] = {{0, 0}, {0, 0}};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // region (g + 8r, 8h + 2t + j) of coef^T; its TU slot
        const int sl = T == 16 ? 0 : T == 8 ? 2 * r + h
                                            : (2 * r + (t >> 1)) * 4 + 2 * h
                                                  + (g >> 2);
        const int4 qc = qc_s[warp][sl];
        int dq[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int coef = rec(hi[h], lo[h], 2 * r + j, sh2, add2);
          const int level = quant_level(coef, qc);
          if (level != 0) {
            ub[r][h] += (unsigned)__ldg(a.level_bits + abs(level));
            // coef^T (y, x) is coef[x][y]: group (x / 4, y / 4) of the TU
            const int y = g + 8 * r, xx = 8 * h + 2 * t + j;
            int bit;
            if (T == 4) bit = sl;
            else if (T == 8) bit = 4 * sl + ((xx % 8) / 4) * 2 + (y % 8) / 4;
            else bit = (xx / 4) * 4 + y / 4;
            cgm[0] |= 1u << bit;
          }
          dq[j] = dequant(level, qc.w, dshift);
        }
        x[r][h] = pack_sat(dq[0], dq[1]);
      }
    // inverse first pass: V = clip16(dq^T T)
    pass(x, bi, hi, lo);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x[0][h] = pack_sat(rec(hi[h], lo[h], 0, 7, add3),
                         rec(hi[h], lo[h], 1, 7, add3));
      x[1][h] = pack_sat(rec(hi[h], lo[h], 2, 7, add3),
                         rec(hi[h], lo[h], 3, 7, add3));
    }
    transpose(x);
    // inverse second pass: res = clip16(V^T T); recon, SSE
    pass(x, bi, hi, lo);
    unsigned long long ue[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned long long e = 0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int res =
              clampi(rec(hi[h], lo[h], 2 * r + j, ish2, add4), -32768, 32767);
          const int o = j ? hi16(op[r][h]) : lo16(op[r][h]);
          const int p = j ? hi16(pp[r][h]) : lo16(pp[r][h]);
          const int d = o - clampi(p + res, 0, a.max_val);
          e += (unsigned long long)((long long)d * d);
        }
        ue[r][h] = e;
      }
    // per-TU sums onto one lane each
    cgm[0] = __reduce_or_sync(0xffffffffu, cgm[0]);
    if (T == 16) {
      const unsigned long long bsum =
          warp_sum(ub[0][0] + ub[0][1] + ub[1][0] + ub[1][1]);
      const unsigned long long esum =
          warp_sum(ue[0][0] + ue[0][1] + ue[1][0] + ue[1][1]);
      if (lane == 0) {
        units_s[warp][0] = bsum;
        sse_s[warp][0] = esum;
      }
    } else if (T == 8) {
      // TU (r, h) on lanes by bit 4 (r) and 3 (h)
      const unsigned long long bsum = scatter_sum(ub, lane, 16, 8, 7);
      const unsigned long long esum = scatter_sum(ue, lane, 16, 8, 7);
      if ((lane & 7) == 0) {
        const int sl = 2 * ((lane >> 4) & 1) + ((lane >> 3) & 1);
        units_s[warp][sl] = bsum;
        sse_s[warp][sl] = esum;
      }
    } else {
      // 4x4: lanes sharing a TU differ in bits 0, 2, 3; r by bit 3, h by 2
      const unsigned long long bsum = scatter_sum(ub, lane, 8, 4, 1);
      const unsigned long long esum = scatter_sum(ue, lane, 8, 4, 1);
      if ((lane & 1) == 0) {
        const int r = (lane >> 3) & 1, h = (lane >> 2) & 1;
        const int b1 = (lane >> 1) & 1, b4 = (lane >> 4) & 1;
        // coef^T phase: TU (2r + b1, 2h + b4); spatial phase: (2r + b4,
        // 2h + b1)
        units_s[warp][(2 * r + b1) * 4 + 2 * h + b4] = bsum;
        sse_s[warp][(2 * r + b4) * 4 + 2 * h + b1] = esum;
      }
    }
  } else {
    // ---- one 32x32 TU a warp ---------------------------------------------
    // basis fragments for the four 8-column tiles: k32 slots 4t + i and
    // 16 + 4t + i are K = perm16(4t + i) and 16 + perm16(4t + i)
    uint32_t bf[4][2], bi[4][2];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        int vf[4], vi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = 16 * hf + perm16(4 * t + i), nn = 8 * nj + g;
          vf[i] = tb(nn, kk);
          vi[i] = tb(kk, nn);
        }
        bf[nj][hf] = pack_s8(vf[0], vf[1], vf[2], vf[3]);
        bi[nj][hf] = pack_s8(vi[0], vi[1], vi[2], vi[3]);
      }
    // org and pred in shared memory (this lane's pairs only)
    int16_t* so = op_s[warp][0];
    int16_t* sp = op_s[warp][1];
    uint32_t x[4][4];   // 8x8 blocks [row block][column block], C layout
#pragma unroll
    for (int rb = 0; rb < 4; ++rb)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int y = 8 * rb + g, xx = 8 * nj + 2 * t;
        uint32_t o, p;
        load_pair(0, y, xx, &o, &p);
        *reinterpret_cast<uint32_t*>(so + y * 32 + xx) = o;
        *reinterpret_cast<uint32_t*>(sp + y * 32 + xx) = p;
        x[rb][nj] = resid(o, p);
      }
    // Each pass runs in place: a row tile's A fragments are split off
    // before its outputs overwrite those rows.
    auto frags = [&](int mi, uint32_t (&ah)[4], uint32_t (&al)[4]) {
      split4(x[2 * mi][0], x[2 * mi][1], &ah[0], &al[0]);
      split4(x[2 * mi + 1][0], x[2 * mi + 1][1], &ah[1], &al[1]);
      split4(x[2 * mi][2], x[2 * mi][3], &ah[2], &al[2]);
      split4(x[2 * mi + 1][2], x[2 * mi + 1][3], &ah[3], &al[3]);
    };
    // the whole TU transposed: each 8x8 block, and the blocks
    auto transpose = [&]() {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        x[r][r] = movt(x[r][r]);
#pragma unroll
        for (int c = r + 1; c < 4; ++c) {
          const uint32_t m = movt(x[r][c]);
          x[r][c] = movt(x[c][r]);
          x[c][r] = m;
        }
      }
    };
    int hi[4], lo[4];
    uint32_t ah[4], al[4];
    // forward first pass
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      frags(mi, ah, al);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        mma32_ss(ah, bf[nj], zero4, hi);
        mma32_us(al, bf[nj], zero4, lo);
        x[2 * mi][nj] = pack_sat(rec(hi, lo, 0, sh1, add1),
                                 rec(hi, lo, 1, sh1, add1));
        x[2 * mi + 1][nj] = pack_sat(rec(hi, lo, 2, sh1, add1),
                                     rec(hi, lo, 3, sh1, add1));
      }
    }
    transpose();
    // forward second pass, quant, bits, dequant
    const int4 qc = qc_s[warp][0];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      frags(mi, ah, al);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        mma32_ss(ah, bf[nj], zero4, hi);
        mma32_us(al, bf[nj], zero4, lo);
        int dq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int level = quant_level(rec(hi, lo, i, sh2, add2), qc);
          if (level != 0) {
            units += (unsigned)__ldg(a.level_bits + abs(level));
            const int yy = 16 * mi + g + 8 * (i >> 1);
            const int xx = 8 * nj + 2 * t + (i & 1);
            const int bit = (xx / 4) * 8 + yy / 4;
            cgm[bit >> 5] |= 1u << (bit & 31);
          }
          dq[i] = dequant(level, qc.w, dshift);
        }
        x[2 * mi][nj] = pack_sat(dq[0], dq[1]);
        x[2 * mi + 1][nj] = pack_sat(dq[2], dq[3]);
      }
    }
    // inverse first pass (dq^T is x as it stands)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      frags(mi, ah, al);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        mma32_ss(ah, bi[nj], zero4, hi);
        mma32_us(al, bi[nj], zero4, lo);
        x[2 * mi][nj] = pack_sat(rec(hi, lo, 0, 7, add3),
                                 rec(hi, lo, 1, 7, add3));
        x[2 * mi + 1][nj] = pack_sat(rec(hi, lo, 2, 7, add3),
                                     rec(hi, lo, 3, 7, add3));
      }
    }
    transpose();
    // inverse second pass, recon, SSE
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      frags(mi, ah, al);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        mma32_ss(ah, bi[nj], zero4, hi);
        mma32_us(al, bi[nj], zero4, lo);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int yy = 16 * mi + g + 8 * (i >> 1);
          const int xx = 8 * nj + 2 * t + (i & 1);
          const int res = clampi(rec(hi, lo, i, ish2, add4), -32768, 32767);
          const int d = so[yy * 32 + xx]
                        - clampi(sp[yy * 32 + xx] + res, 0, a.max_val);
          sse += (unsigned long long)((long long)d * d);
        }
      }
    }
    cgm[0] = __reduce_or_sync(0xffffffffu, cgm[0]);
    cgm[1] = __reduce_or_sync(0xffffffffu, cgm[1]);
    units = warp_sum(units);
    sse = warp_sum(sse);
    if (lane == 0) {
      units_s[warp][0] = units;
      sse_s[warp][0] = sse;
    }
  }
  __syncwarp();

  // -- each TU's dist and bits ---------------------------------------------
  if (lane < TPR && item_s[warp][lane] >= 0) {
    const int sl = lane;
    int ncg = 0;
    bool nz;
    if (T == 4) {
      nz = (cgm[0] >> sl) & 1;
    } else if (T == 8) {
      ncg = __popc((cgm[0] >> (4 * sl)) & 15u);
      nz = ncg > 0;
    } else {
      ncg = __popc(cgm[0]) + __popc(cgm[1]);
      nz = ncg > 0;
    }
    float b = __fmul_rn(__ll2float_rn((long long)units_s[warp][sl]),
                        1.0f / 8388608.0f);
    if (T > 4) b = __fadd_rn(b, __fmul_rn(1.5f, (float)ncg));
    b = nz ? __fadd_rn(__fadd_rn(b, (float)(2 * LOG2T)), 1.0f) : 0.5f;
    const long long d = (long long)sse_s[warp][sl] >> (2 * a.bit_inc);
    if (NQ == 1) {
      const long long item = item_s[warp][sl];
      a.dist[item] = (int32_t)d;
      a.bits[item] = b;
    } else {
      qd_s[warp] = d;
      qb_s[warp] = b;
    }
  }
  if constexpr (NQ == 4) {
    // the CTA's four warps are one item's four quadrants
    __syncthreads();
    const long long item = item_s[0][0];
    if (tid == 0 && item >= 0) {
      long long d = 0;
      double b = 0.0;
      for (int w = 0; w < NW; ++w) {
        d += qd_s[w];
        b = __dadd_rn(b, (double)qb_s[w]);
      }
      a.dist[item] = (int32_t)d;
      a.bits[item] = __double2float_rn(b);
    }
  }
}

template <int T, int NQ, int SRC>
int launch_rd(const RdArgs& a, cudaStream_t stream) {
  constexpr int TPR = RdShape<T, NQ, SRC>::TPR;
  const long long per_cta = (long long)kRdWarps * TPR;
  const long long blocks = (a.n * NQ + per_cta - 1) / per_cta;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tu_rd_kernel<T, NQ, SRC><<<(unsigned)blocks, kRdWarps * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// size: 4..32 one TU a block, 64 four 32x32 quadrants, -32 four 16x16;
// chroma (SRC 2) blocks are 4, 8, 16 or 32 (as -32), so no chroma 32x32 TU
template <int SRC>
int dispatch_rd(int size, const RdArgs& a, cudaStream_t st) {
  switch (size) {
    case 4: return launch_rd<4, 1, SRC>(a, st);
    case 8: return launch_rd<8, 1, SRC>(a, st);
    case 16: return launch_rd<16, 1, SRC>(a, st);
    case -32: return launch_rd<16, 4, SRC>(a, st);
    default: break;
  }
  if constexpr (SRC != 2) {
    if (size == 32) return launch_rd<32, 1, SRC>(a, st);
    if (size == 64) return launch_rd<32, 4, SRC>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int S, int FORM>
int launch_sweep_form(const void* plane, int width, int nby, int nbx,
                      int bit_inc, int max_val, void* out, void* best,
                      cudaStream_t stream) {
  using Sh = SweepShape<S>;
  long long ctas;
  if (S <= 16) {
    const long long ng = (long long)((nby + Sh::BPR - 1) / Sh::BPR)
                         * ((nbx + Sh::BPR - 1) / Sh::BPR);
    ctas = (ng + Sh::NW - 1) / Sh::NW;
  } else {
    ctas = ((long long)nby * nbx + Sh::NBLK - 1) / Sh::NBLK;
  }
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sweep_kernel<S, FORM><<<(unsigned)ctas, Sh::NW * 32, 0, stream>>>(
      static_cast<const int16_t*>(plane), width, nby, nbx, bit_inc, max_val,
      static_cast<int32_t*>(out), static_cast<int32_t*>(best));
  return (int)cudaGetLastError();
}

// the tensor-core forms up to bit_inc 4, butterflies above
template <int S>
int launch_sweep(const void* plane, int width, int nby, int nbx, int bit_inc,
                 int max_val, void* out, void* best, cudaStream_t st) {
  if (bit_inc > 4)
    return launch_sweep_form<S, kButterfly>(plane, width, nby, nbx, bit_inc,
                                            max_val, out, best, st);
  if (bit_inc == 0)
    return launch_sweep_form<S, kNarrow>(plane, width, nby, nbx, bit_inc,
                                         max_val, out, best, st);
  return launch_sweep_form<S, kWide>(plane, width, nby, nbx, bit_inc, max_val,
                                     out, best, st);
}

// samples below 256 << bit_inc, and within int16: the sweep's operand
// forms (bytes at bit_inc 0, pred >> 4 below 256 up to bit_inc 4) and the
// forward first pass's int16 bound rest on it
bool args_ok(int bit_inc, int max_val) {
  if (bit_inc < 0 || bit_inc > 8) return false;
  const int top = (256 << bit_inc) - 1;
  return max_val > 0 && max_val <= (top < 32767 ? top : 32767);
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
// offset 171.  Chroma sizes are 4, 8, 16 and -32.
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
      || (long long)nbx * s + s + 1 > width
      || (long long)nby * nbx * k * planes > 0x7fffffffLL)
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
