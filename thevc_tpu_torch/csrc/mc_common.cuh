// The HEVC interpolation both the motion-compensation kernels (mc.cu) and
// the P/B decision pass's merge model (inter_me.cu) run: HM's
// TComInterpolationFilter with the int16 (Short) first-pass intermediate,
// as ops/mc.py computes it.  Per output sample, for a window whose (0, 0)
// is the first tap sample: the 2-D case's first pass at 14 bits less 8192,
// wrapped to int16, then the vertical pass, clipped to pixels or kept at
// 14 bits (mc.cu's header has the whole contract).  Windows go to int16
// shared memory in 8-sample chunks read at clamped plane coordinates.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInternalPrec = 14;      // IF_INTERNAL_PREC
constexpr int kFilterPrec = 6;         // IF_FILTER_PREC
constexpr int kInternalOffs = 8192;    // IF_INTERNAL_OFFS

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// cp.async groups: close the thread's group of copies; wait until at most
// N of its groups are in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ unsigned pack2(int lo, int hi) {
  return (unsigned)(lo & 0xffff) | ((unsigned)hi << 16);
}

// 8 int16 values to and from a 16-byte aligned address
__device__ __forceinline__ void store8(int16_t* dst, const int (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}

__device__ __forceinline__ void load8(const int16_t* src, int (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[2 * c] = (int)(int16_t)(u[c] & 0xffff);
    v[2 * c + 1] = (int)u[c] >> 16;
  }
}

template <int TAPS>
__device__ __forceinline__ void taps_of(int phase, int (&t)[TAPS]) {
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    if constexpr (TAPS == 8) {
      t[k] = kLumaTaps[phase][k];
    } else {
      t[k] = kChromaTaps[phase][k];
    }
  }
}

// One 8-sample chunk of a window: plane samples (y, x .. x + 7) of a rows
// x cols plane (x a multiple of 8) into dst (16-byte aligned), read at
// clamped coordinates
__device__ __forceinline__ void load_chunk(int16_t* dst,
                                           const int16_t* plane, int rows,
                                           int cols, int x, int y,
                                           bool aligned) {
  if (aligned && y >= 0 && y < rows && x >= 0 && x + 8 <= cols) {
    cp_async16(dst, plane + (long long)y * cols + x);
    return;
  }
  const int16_t* row = plane + (long long)min(max(y, 0), rows - 1) * cols;
  int v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = row[min(max(x + j, 0), cols - 1)];
  store8(dst, v);
}

// The 2-D case's first pass over 8 outputs of a row: window samples
// s[0 .. TAPS + 6] -> dst (16-byte aligned), at 14 bits less 8192
// (shift sh, offset off), wrapped to int16
template <int TAPS>
__device__ __forceinline__ void first_pass8(const int16_t* s,
                                            const int (&t)[TAPS], int sh,
                                            int off, int16_t* dst) {
  int v[TAPS + 7];
#pragma unroll
  for (int j = 0; j < TAPS + 7; ++j) v[j] = s[j];
  int res[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) acc += v[c + k] * t[k];
    res[c] = (acc + off) >> sh;
  }
  store8(dst, res);
}

// A phase's taps as int8 pairs for __dp2a_lo: word q holds taps 2 q and
// 2 q + 1 in its low two bytes
template <int TAPS>
__device__ __forceinline__ void tap_pairs(int phase,
                                          unsigned (&w)[TAPS / 2]) {
  int t[TAPS];
  taps_of<TAPS>(phase, t);
#pragma unroll
  for (int q = 0; q < TAPS / 2; ++q) {
    w[q] = (unsigned)(t[2 * q] & 0xff) | ((unsigned)(t[2 * q + 1] & 0xff) << 8);
  }
}

// first_pass8 by two-sample dot products: window samples s[0 .. TAPS + 6]
// read as 32-bit words from s - B (B = the start's parity, a 4-byte
// aligned address); pair j = (s[j], s[j + 1]) is a word or one byte
// permute of two; the same integers as the tap by tap sum
template <int TAPS, int B>
__device__ __forceinline__ void first_pass8_pairs(
    const int16_t* s, const unsigned (&tp)[TAPS / 2], int sh, int off,
    int16_t* dst) {
  constexpr int NW = (TAPS + 8) / 2, NP = TAPS + 6;
  const unsigned* w = reinterpret_cast<const unsigned*>(s - B);
  unsigned word[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) word[k] = w[k];
  unsigned pair[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int at = j + B;             // the pair's first sample in words
    pair[j] = at & 1 ? __byte_perm(word[at >> 1], word[(at >> 1) + 1], 0x5432)
                     : word[at >> 1];
  }
  int res[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int acc = 0;
#pragma unroll
    for (int q = 0; q < TAPS / 2; ++q) {
      acc = __dp2a_lo((int)pair[c + 2 * q], (int)tp[q], acc);
    }
    res[c] = (acc + off) >> sh;
  }
  store8(dst, res);
}

template <int TAPS>
__device__ __forceinline__ void first_pass8_pairs(
    const int16_t* s, int parity, const unsigned (&tp)[TAPS / 2], int sh,
    int off, int16_t* dst) {
  if (parity) {
    first_pass8_pairs<TAPS, 1>(s, tp, sh, off, dst);
  } else {
    first_pass8_pairs<TAPS, 0>(s, tp, sh, off, dst);
  }
}

// The 2-D case's last pass to pixels of outputs (i, 8 g .. 8 g + 7) by
// two-row dot products: rows i + 2 q and i + 2 q + 1 of the first pass
// (row stride tw) paired column by column with one byte permute a pair
template <int TAPS>
__device__ __forceinline__ void last_pass8_pairs(
    const int16_t* tmp, int tw, int i, int g,
    const unsigned (&tp)[TAPS / 2], int bd, int (&res)[8]) {
  int acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0;
#pragma unroll
  for (int q = 0; q < TAPS / 2; ++q) {
    const uint4 a = *reinterpret_cast<const uint4*>(
        tmp + (i + 2 * q) * tw + 8 * g);
    const uint4 b = *reinterpret_cast<const uint4*>(
        tmp + (i + 2 * q + 1) * tw + 8 * g);
    const unsigned wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] = __dp2a_lo((int)__byte_perm(wa[k], wb[k], 0x5410),
                             (int)tp[q], acc[2 * k]);
      acc[2 * k + 1] = __dp2a_lo((int)__byte_perm(wa[k], wb[k], 0x7632),
                                 (int)tp[q], acc[2 * k + 1]);
    }
  }
  const int sh = kFilterPrec + kInternalPrec - bd;
  const int off2 = (1 << (sh - 1)) + (kInternalOffs << kFilterPrec);
  const int top = (1 << bd) - 1;
#pragma unroll
  for (int c = 0; c < 8; ++c) res[c] = min(max((acc[c] + off2) >> sh, 0), top);
}

// A zero phase's pass: the identity tap row's one tap (64, at TAPS / 2 -
// 1), as the TAPS-tap sum computes it.  First pass over 8 outputs of a
// row: window samples s[0 .. TAPS + 6] -> dst (16-byte aligned), at 14
// bits less 8192, wrapped to int16
template <int TAPS>
__device__ __forceinline__ void first_pass8_copy(const int16_t* s, int sh,
                                                 int off, int16_t* dst) {
  int res[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) res[c] = (64 * s[c + TAPS / 2 - 1] + off) >> sh;
  store8(dst, res);
}

// The last pass of the 2-D case to pixels from one first-pass value v
// (a zero vertical phase), or from a window sample x (both phases zero)
__device__ __forceinline__ int last_pass_copy(int v, int bd) {
  const int sh = kFilterPrec + kInternalPrec - bd;
  const int off2 = (1 << (sh - 1)) + (kInternalOffs << kFilterPrec);
  return min(max((64 * v + off2) >> sh, 0), (1 << bd) - 1);
}

__device__ __forceinline__ int copy_pixel(int x, int bd) {
  const int sh1 = kFilterPrec - (kInternalPrec - bd);
  return last_pass_copy(wrap16((64 * x - kInternalOffs * (1 << sh1)) >> sh1),
                        bd);
}

// Outputs (i, 8 g .. 8 g + 7) of one list in case cs: win is the window
// (row stride ws, its first tap sample at column off of row 0), tmp the
// 2-D case's first pass (row stride tw), tx / ty the phases' taps.
// last: clip to pixels; else 14 bits, wrapped to int16.
template <int TAPS>
__device__ __forceinline__ void predict8(int cs, const int16_t* win, int ws,
                                         int off, const int16_t* tmp,
                                         int tw, int i, int g,
                                         const int (&tx)[TAPS],
                                         const int (&ty)[TAPS], bool last,
                                         int bd, int (&res)[8]) {
  const int head = kInternalPrec - bd;
  const int top = (1 << bd) - 1;
  int acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0;
  if (cs == k2d) {
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      int v[8];
      load8(tmp + (i + k) * tw + 8 * g, v);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] += v[c] * ty[k];
    }
    // the last pass of a 2-D case: shift 6 + head, offset of the 8192
    const int sh = kFilterPrec + head;
    const int off2 = (1 << (sh - 1)) + (kInternalOffs << kFilterPrec);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      res[c] = last ? min(max((acc[c] + off2) >> sh, 0), top)
                    : wrap16(acc[c] >> kFilterPrec);
    }
    return;
  }
  const int16_t* s = win + i * ws + off + 8 * g;
  if (cs == kCopy) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      res[c] = last ? s[c] : wrap16(s[c] * (1 << head) - kInternalOffs);
    }
    return;
  }
  if (cs == kHor) {
    int v[TAPS + 7];
#pragma unroll
    for (int j = 0; j < TAPS + 7; ++j) v[j] = s[j];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int k = 0; k < TAPS; ++k) acc[c] += v[c + k] * tx[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] += s[k * ws + c] * ty[k];
    }
  }
  // one pass: rounded to pixels, or to 14 bits less 8192
  const int sh = kFilterPrec - head;
  const int off1 = -kInternalOffs * (1 << sh);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    res[c] = last ? min(max((acc[c] + (1 << (kFilterPrec - 1)))
                            >> kFilterPrec, 0), top)
                  : wrap16((acc[c] + off1) >> sh);
  }
}

}  // namespace
