// Fused dequant + 2-D inverse DCT/DST for a batch of TUs of one size class:
// the decoder's stage-1 residual core on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel thevc_tpu/ops/jx_pallas.py:_kernel
// (:141-187, launched at :228) and, for 8x8 to 32x32 TUs, the coefficient-
// group unpack before it (thevc_tpu/ops/jx.py:_unpack_cgs, :168-181).  Per
// TU, with basis T (DCT, or the 4x4 DST for intra luma) and the scaled QP:
//   scale   = kInvQuant[qp % 6] << (qp / 6)
//   D[n][j] = clip16((X[n][j] * scale + (1 << (dq_shift - 1))) >> dq_shift)
//   U[k][j] = clip16((sum_n T[n][k] * D[n][j] + 64) >> 7)
//   O[r][c] = clip16((sum_n U[r][n] * T[n][c] + (1 << (sh2 - 1))) >> sh2)
// which is HM's xDeQuant followed by xITrMxN (TComTrQuant.cpp), bit for bit:
// X * scale stays below 2^31 for scaled QPs up to 63, and every sum is exact.
//
// What bounds it: each coefficient is 2 bytes written (and at most 2.25
// read, as packed coefficient groups with their indices) against 2 * S
// multiply-adds, so device memory bounds it, not arithmetic; the design
// keeps the dense coefficients out of device memory and the instruction
// count per coefficient low enough for the memory to be the limit:
//  - 8x8 to 32x32 read the CG-packed input (coded 4x4 groups as int16 rows
//    [M, 16] with ascending TU-major indices).  A persistent block walks
//    tiles of consecutive TUs, 16 coefficients a thread, so at most one
//    coded group a thread.  It finds where its first tile's rows start by
//    a block-wide 256-ary search in the indices (a one-thread binary
//    search was 20 dependent loads, most of a block's life); each later
//    tile starts where the last ended.  The next tile's group and QPs are
//    loaded into registers while the current one computes.  Each group is
//    dequantised on the way into an int16 tile in shared memory (zeroed
//    first), so the dense coefficients never reach device memory.  The
//    dense entry (the encoder's RD estimate) fills the same tile from
//    [N, S, S].
//  - Both passes run on the tensor cores, exactly: mma.sync with s8
//    operands and s32 accumulators.  |T| <= 90 fits s8; each int16 operand
//    is split as 256 * hi + lo (hi s8, lo u8), two products are accumulated
//    and recombined as 256 * acc_hi + acc_lo, exact since |sum| <= 32 * 90 *
//    2^15 < 2^27; the rounding offset rides in the lo product's
//    accumulator, and one cvt.pack.sat clips and packs two results.  The
//    basis fragments stay in registers for the block's life.  After the
//    groups are in, each warp runs both passes and the store of its own
//    TUs, with U and then O in shared memory, so a tile costs two block
//    barriers; O leaves as coalesced 16-byte stores.
//  - 4x4 (DCT and the intra-luma DST) ships dense: one thread per TU, both
//    passes in registers, 32 bytes in and 32 out per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads4 = 128;  // 4x4 blocks

// threads of a tensor-core block; its tile is 16 coefficients a thread, one
// 4x4 group (more warps per SM at 8x8 and 16x16, measured on the H100)
constexpr int threads_for(int size) { return size == 32 ? 256 : 128; }

// HM's g_invQuantScales (common/rom.py INV_QUANT_SCALES)
__constant__ int32_t kInvQuant[6] = {40, 45, 51, 57, 64, 72};

// the 16 int16 of a 4x4 group, loaded and stored as two 16-byte vectors
union Group {
  uint4 q[2];
  uint2 h[4];
  int16_t v[16];
};

__device__ __forceinline__ int clip16(int v) {
  return min(32767, max(-32768, v));
}

__device__ __forceinline__ int dq_scale(int qp) {
  return kInvQuant[qp % 6] << (qp / 6);
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// four int16 (x: elements 0, 1; y: 2, 3) -> their high bytes as s8 and
// their low bytes as u8, element 0 in the lowest byte: v = 256 * hi + lo
__device__ __forceinline__ void split4(uint2 v, uint32_t* hi, uint32_t* lo) {
  *hi = __byte_perm(v.x, v.y, 0x7531);
  *lo = __byte_perm(v.x, v.y, 0x6420);
}

// two int32 -> two int16 saturated, lo in bits 0-15: clip16 and pack in one
__device__ __forceinline__ uint32_t pack_sat(int lo, int hi) {
  uint32_t d;
  asm("cvt.pack.sat.s16.s32 %0, %1, %2;" : "=r"(d) : "r"(hi), "r"(lo));
  return d;
}

// D = A (16x32, row) * B (32x8, col) + C, s32; the suffix names the A and B
// types (s: s8, u: u8)
#define MMA_K32(NAME, TYPES)                                                  \
  __device__ __forceinline__ void NAME(const uint32_t a[4],                   \
                                       const uint32_t b[2], int c, int d[4]) {\
    asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TYPES ".s32 "       \
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "                    \
                 "{%10,%10,%10,%10};\n"                                       \
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),     \
                   "r"(b[1]), "r"(c));                                        \
  }
MMA_K32(mma_ss, "s8.s8")
MMA_K32(mma_su, "s8.u8")
MMA_K32(mma_us, "u8.s8")

// D = A (16x16, row) * B (16x8, col) + C, s32
#define MMA_K16(NAME, TYPES)                                                  \
  __device__ __forceinline__ void NAME(const uint32_t a[2], uint32_t b,       \
                                       int c, int d[4]) {                     \
    asm volatile("mma.sync.aligned.m16n8k16.row.col.s32." TYPES ".s32 "       \
                 "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"             \
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])             \
                 : "r"(a[0]), "r"(a[1]), "r"(b), "r"(c));                     \
  }
MMA_K16(mma16_ss, "s8.s8")
MMA_K16(mma16_us, "u8.s8")

// First index i in [0, m) with a[i] >= key (m if none), for ascending a,
// found by the whole block of NTH threads in NTH-ary steps: each thread
// probes one point and __syncthreads_count narrows the range, so 2^21 rows
// take 3 rounds of one load each.  Every thread of the block must call it.
template <int NTH>
__device__ int block_lower_bound(const int32_t* __restrict__ a, int m,
                                 long long key) {
  int lo = 0, hi = m;  // the answer lies in [lo, hi]
  while (hi > lo) {
    const int step = (hi - lo + NTH - 1) / NTH;
    const int p = lo + (int)threadIdx.x * step;
    const int c = __syncthreads_count(p < hi && (long long)a[p] < key);
    if (c == 0) break;
    // a[lo + (c - 1) * step] < key <= a[lo + c * step] (or the end)
    const int top = min(hi, lo + c * step);
    lo += (c - 1) * step + 1;
    hi = top;
  }
  return lo;
}

// the 64 threads of warps 2i and 2i + 1 wait for each other (i < 15)
__device__ __forceinline__ void pair_barrier(int i) {
  asm volatile("bar.sync %0, 64;" ::"r"(i + 1) : "memory");
}

// The tensor-core kernel for S = 8, 16, 32.  A block walks a contiguous run
// of tiles (`tiles` of them, from blockIdx.x * tiles), each 16 coefficients
// a thread of consecutive TUs, so at most one coded group a thread.  The
// loads of the next tile are issued before the current one is computed.
// Shared memory holds D transposed in two buffers that alternate
// by tile (dT[t][j][n], so a B fragment's four consecutive n are one 8-byte
// load; rows padded by 4 int16 so a warp's group writes take the two
// wavefronts an 8-byte store needs), and U row-major (u[t][k][j], so an A
// fragment's four consecutive n of pass 2 are one 8-byte load; rows padded
// by 8 int16, no bank conflicts on the fragment writes), which pass 2
// overwrites with O row by row.  After the groups are in, each warp runs
// both passes and the store of its own TUs (32x32: two warps a TU), so a
// tile takes two block barriers.  8x8 TUs go two to an MMA: the k16 product
// of a block-diagonal [D0^T 0; 0 D1^T] (or [U0 0; 0 U1]) with T stacked
// twice, so no multiply is spent on padding.
template <int S, bool PACKED, int NTH = threads_for(S)>
__global__ void __launch_bounds__(NTH)
residual_tc(const int16_t* __restrict__ src, const int32_t* __restrict__ idx,
            int m, const int32_t* __restrict__ qp,
            const int32_t* __restrict__ basis, int16_t* __restrict__ out,
            int n, int dq_shift, int sh2, int tiles) {
  constexpr int SS = S * S;
  constexpr int NW = NTH / 32;      // warps
  constexpr int TPB = 16 * NTH / SS;  // TUs per tile
  constexpr int LDD = S + 4;        // dT row, int16
  constexpr int LDU = S + 8;        // U and O rows, int16
  constexpr int NCG1 = S / 4;       // CGs per row
  constexpr int NCG = NCG1 * NCG1;  // CGs per TU
  constexpr int MT = (S + 15) / 16; // 16-row tiles
  constexpr int NT = S / 8;         // 8-column tiles
  constexpr int ROWS = TPB * S / NW;  // rows of O a warp stores
  static_assert(TPB * NCG == NTH, "one coefficient group per thread");
  __shared__ __align__(16) int16_t d_s[2][TPB * S * LDD];  // dT
  __shared__ __align__(16) int16_t u_s[TPB * S * LDU];     // U, then O
  __shared__ int qp_s[2][TPB];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const long long n_tiles = ((long long)n + TPB - 1) / TPB;
  const long long first = (long long)blockIdx.x * tiles;
  const long long last = min(n_tiles, first + tiles);
  if (first >= last) return;

  // basis fragments, constant for the block: T(n, k) = basis[n * S + k]
  auto tb = [&](int nn, int k) -> int {
    return (nn < S && k < S) ? basis[nn * S + k] : 0;
  };
  // pass 1, A = T^T (rows k, columns n); 8x8: B = T, rows n mod 8
  uint32_t a1[MT][4];
  // pass 2, B = T (rows n, columns c)
  uint32_t b2[NT][2];
  if constexpr (S == 8) {
    const int nn = (4 * q) & 7;
    b2[0][0] = pack_s8(tb(nn, g), tb(nn + 1, g), tb(nn + 2, g),
                       tb(nn + 3, g));
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int k0 = 16 * mt + g, k1 = k0 + 8;
      a1[mt][0] = pack_s8(tb(4 * q, k0), tb(4 * q + 1, k0), tb(4 * q + 2, k0),
                          tb(4 * q + 3, k0));
      a1[mt][1] = pack_s8(tb(4 * q, k1), tb(4 * q + 1, k1), tb(4 * q + 2, k1),
                          tb(4 * q + 3, k1));
      a1[mt][2] = pack_s8(tb(16 + 4 * q, k0), tb(17 + 4 * q, k0),
                          tb(18 + 4 * q, k0), tb(19 + 4 * q, k0));
      a1[mt][3] = pack_s8(tb(16 + 4 * q, k1), tb(17 + 4 * q, k1),
                          tb(18 + 4 * q, k1), tb(19 + 4 * q, k1));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = 8 * nt + g;
      b2[nt][0] = pack_s8(tb(4 * q, c), tb(4 * q + 1, c), tb(4 * q + 2, c),
                          tb(4 * q + 3, c));
      b2[nt][1] = pack_s8(tb(16 + 4 * q, c), tb(17 + 4 * q, c),
                          tb(18 + 4 * q, c), tb(19 + 4 * q, c));
    }
  }

  // -- the loads of one tile: this thread's coefficient group and, for
  // the first TPB threads, a TU's QP.  Packed: the group is row lo + tid,
  // which may belong to a later tile (then it is dropped and read again).
  const uint4* vals = reinterpret_cast<const uint4*>(src);
  int lo = PACKED ? block_lower_bound<NTH>(idx, m, first * TPB * NCG) : 0;
  Group grp;
  long long key = 0;  // packed: the group's index; dense: its TU's
  int qp_next = 0;
  auto fetch = [&](long long tile) {
    const long long tu0 = tile * TPB;
    if (tid < TPB && tu0 + tid < n) qp_next = qp[tu0 + tid];
    if constexpr (PACKED) {
      const int r = lo + tid;
      key = r < m ? (long long)idx[r] : (long long)n * NCG;
      if (r < m) {
        grp.q[0] = vals[2 * (long long)r];
        grp.q[1] = vals[2 * (long long)r + 1];
      }
    } else {
      const int t = tid / NCG, rem = tid % NCG;
      key = tu0 + t;
      if (key < n) {
        const int16_t* x = src + key * SS + 4 * (rem / NCG1) * S
                           + 4 * (rem % NCG1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          grp.h[i] = *reinterpret_cast<const uint2*>(x + i * S);
      }
    }
  };
  fetch(first);

  const int dq_add = 1 << (dq_shift - 1);
  const int r_add = 1 << (sh2 - 1);
  const uint2 zero2 = make_uint2(0, 0);
  for (long long tile = first; tile < last; ++tile) {
    const long long tu0 = tile * TPB;
    const int count = (int)min((long long)TPB, (long long)n - tu0);
    int16_t* const dt = d_s[tile & 1];
    int* const qps = qp_s[tile & 1];
    // dt and qps were last read before the previous tile's second barrier
    if constexpr (PACKED) {
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int i = tid; i < TPB * S * LDD / 8; i += NTH)
        reinterpret_cast<uint4*>(dt)[i] = zero;
    }
    if (tid < TPB) qps[tid] = qp_next;
    // this tile's group of this thread, then the next tile's loads
    const int cg = PACKED ? (int)min(key - tu0 * NCG, (long long)TPB * NCG)
                          : (key < n ? tid : TPB * NCG);
    const Group mine = grp;
    const int c = __syncthreads_count(cg < count * NCG);
    if (PACKED) lo += c;
    if (tile + 1 < last) fetch(tile + 1);

    // -- dequantised group into dT -----------------------------------------
    if (cg < count * NCG) {
      const int t = cg / NCG, cy = (cg % NCG) / NCG1, cx = cg % NCG1;
      const int scale = dq_scale(qps[t]);
      int d[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        d[i] = ((int)mine.v[i] * scale + dq_add) >> dq_shift;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        *reinterpret_cast<uint2*>(dt + (t * S + 4 * cx + jj) * LDD + 4 * cy) =
            make_uint2(pack_sat(d[jj], d[4 + jj]),
                       pack_sat(d[8 + jj], d[12 + jj]));
    }
    __syncthreads();

    // -- both passes on this warp's TUs; U and O rows stay with the warp --
    if constexpr (S == 8) {
      // two TUs a step: rows g (TU t0) and g + 8 (TU t0 + 1) of the
      // block-diagonal operand; each thread loads from one of the two
      const int side = q >> 1;
      const int t_end = min(count, ROWS / 8 * (warp + 1));
      for (int t0 = ROWS / 8 * warp; t0 < t_end; t0 += 2) {
        const int t = t0 + side;
        uint32_t h, l;
        split4(t < count ? *reinterpret_cast<const uint2*>(
                               dt + (t * 8 + g) * LDD + 4 * (q & 1))
                         : zero2, &h, &l);
        const uint32_t ah[2] = {side ? 0u : h, side ? h : 0u};
        const uint32_t al[2] = {side ? 0u : l, side ? l : 0u};
        int ch[4], cl[4];
        mma16_ss(ah, b2[0][0], 0, ch);
        mma16_us(al, b2[0][0], 64, cl);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // c0, c1: TU t0, k = 2q, 2q + 1; c2, c3: TU t0 + 1; j = g
          const int tt = t0 + (i >> 1), k = 2 * q + (i & 1);
          u_s[(tt * 8 + k) * LDU + g] =
              (int16_t)clip16((ch[i] * 256 + cl[i]) >> 7);
        }
      }
      __syncwarp();
      for (int t0 = ROWS / 8 * warp; t0 < t_end; t0 += 2) {
        const int t = t0 + side;
        uint32_t h, l;
        split4(t < count ? *reinterpret_cast<const uint2*>(
                               u_s + (t * 8 + g) * LDU + 4 * (q & 1))
                         : zero2, &h, &l);
        const uint32_t ah[2] = {side ? 0u : h, side ? h : 0u};
        const uint32_t al[2] = {side ? 0u : l, side ? l : 0u};
        int ch[4], cl[4];
        mma16_ss(ah, b2[0][0], 0, ch);
        mma16_us(al, b2[0][0], r_add, cl);
        // row g of TU t0 (c0, c1) and of TU t0 + 1 (c2, c3), c = 2q, 2q + 1
        *reinterpret_cast<uint32_t*>(u_s + (t0 * 8 + g) * LDU + 2 * q) =
            pack_sat((ch[0] * 256 + cl[0]) >> sh2,
                     (ch[1] * 256 + cl[1]) >> sh2);
        *reinterpret_cast<uint32_t*>(u_s + ((t0 + 1) * 8 + g) * LDU + 2 * q) =
            pack_sat((ch[2] * 256 + cl[2]) >> sh2,
                     (ch[3] * 256 + cl[3]) >> sh2);
      }
    } else {
      // 16x16: TUs 2w and 2w + 1; 32x32: TU w / 2, columns (pass 1) and
      // rows (pass 2) of half w % 2
      static_assert(ROWS == (S == 16 ? 32 : 16), "warp to TU map");
      constexpr int PER = S == 16 ? 2 : 1;        // TUs of the warp
      constexpr int NTW = S == 16 ? NT : NT / 2;  // pass-1 column tiles
      const int t_first = S == 16 ? 2 * warp : warp / 2;
      const int half = S == 16 ? 0 : warp & 1;
#pragma unroll
      for (int tt = 0; tt < PER; ++tt) {
        const int t = t_first + tt;
        if (t >= count) break;
#pragma unroll
        for (int ntw = 0; ntw < NTW; ++ntw) {
          const int nt = half * NTW + ntw;
          const int16_t* col = dt + (t * S + 8 * nt + g) * LDD;
          const uint2 v0 = *reinterpret_cast<const uint2*>(col + 4 * q);
          const uint2 v1 =
              (16 + 4 * q < S)
                  ? *reinterpret_cast<const uint2*>(col + 16 + 4 * q)
                  : zero2;
          uint32_t bh[2], bl[2];
          split4(v0, &bh[0], &bl[0]);
          split4(v1, &bh[1], &bl[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            int ch[4], cl[4];
            mma_ss(a1[mt], bh, 0, ch);
            mma_su(a1[mt], bl, 64, cl);
            const int k0 = 16 * mt + g, j = 8 * nt + 2 * q;
            *reinterpret_cast<uint32_t*>(u_s + (t * S + k0) * LDU + j) =
                pack_sat((ch[0] * 256 + cl[0]) >> 7,
                         (ch[1] * 256 + cl[1]) >> 7);
            *reinterpret_cast<uint32_t*>(u_s + (t * S + k0 + 8) * LDU + j) =
                pack_sat((ch[2] * 256 + cl[2]) >> 7,
                         (ch[3] * 256 + cl[3]) >> 7);
          }
        }
      }
      if constexpr (S == 32) {
        if (t_first < count) pair_barrier(t_first);
      } else {
        __syncwarp();
      }
#pragma unroll
      for (int tt = 0; tt < PER; ++tt) {
        const int t = t_first + tt;
        if (t >= count) break;
        // rows r0..r0+15 are read in full before any of them is written
        const int r0 = 16 * half + g;
        int16_t* u0 = u_s + (t * S + r0) * LDU;
        int16_t* u1 = u0 + 8 * LDU;
        const bool hi4 = 16 + 4 * q < S;
        uint32_t ah[4], al[4];
        split4(*reinterpret_cast<const uint2*>(u0 + 4 * q), &ah[0], &al[0]);
        split4(*reinterpret_cast<const uint2*>(u1 + 4 * q), &ah[1], &al[1]);
        split4(hi4 ? *reinterpret_cast<const uint2*>(u0 + 16 + 4 * q) : zero2,
               &ah[2], &al[2]);
        split4(hi4 ? *reinterpret_cast<const uint2*>(u1 + 16 + 4 * q) : zero2,
               &ah[3], &al[3]);
        __syncwarp();
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          int ch[4], cl[4];
          mma_ss(ah, b2[nt], 0, ch);
          mma_us(al, b2[nt], r_add, cl);
          const int col = 8 * nt + 2 * q;
          *reinterpret_cast<uint32_t*>(u0 + col) =
              pack_sat((ch[0] * 256 + cl[0]) >> sh2,
                       (ch[1] * 256 + cl[1]) >> sh2);
          *reinterpret_cast<uint32_t*>(u1 + col) =
              pack_sat((ch[2] * 256 + cl[2]) >> sh2,
                       (ch[3] * 256 + cl[3]) >> sh2);
        }
      }
    }
    __syncwarp();

    // -- store this warp's rows of O: they are contiguous in out -----------
    const int row0 = ROWS * warp;
    const int rows = max(0, min(ROWS, count * S - row0));
    uint4* dst = reinterpret_cast<uint4*>(out + (tu0 * S + row0) * S);
    for (int i = lane; i < rows * S / 8; i += 32)
      dst[i] = *reinterpret_cast<const uint4*>(
          u_s + (row0 + i / (S / 8)) * LDU + 8 * (i % (S / 8)));
  }
}

// 4x4: one thread per TU, both passes in registers
__global__ void __launch_bounds__(kThreads4)
residual4(const int16_t* __restrict__ x, const int32_t* __restrict__ qp,
          const int32_t* __restrict__ basis, int16_t* __restrict__ out,
          int n, int dq_shift, int sh2) {
  const long long tu = (long long)blockIdx.x * kThreads4 + threadIdx.x;
  if (tu >= n) return;
  int tb[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) tb[i] = __ldg(basis + i);
  Group grp;
  const uint4* src = reinterpret_cast<const uint4*>(x + tu * 16);
  grp.q[0] = src[0];
  grp.q[1] = src[1];
  int16_t* v = grp.v;
  const int scale = dq_scale(qp[tu]);
  const int dq_add = 1 << (dq_shift - 1);
  int d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    d[i] = clip16(((int)v[i] * scale + dq_add) >> dq_shift);
  int u[16];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int acc = 0;
#pragma unroll
      for (int m = 0; m < 4; ++m) acc += tb[m * 4 + k] * d[m * 4 + j];
      u[k * 4 + j] = clip16((acc + 64) >> 7);
    }
  const int r_add = 1 << (sh2 - 1);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int acc = 0;
#pragma unroll
      for (int m = 0; m < 4; ++m) acc += u[r * 4 + m] * tb[m * 4 + c];
      v[r * 4 + c] = (int16_t)clip16((acc + r_add) >> sh2);
    }
  uint4* dst = reinterpret_cast<uint4*>(out + tu * 16);
  dst[0] = grp.q[0];
  dst[1] = grp.q[1];
}

// blocks of `kernel` that fit on the current device at once (every SM full)
template <typename K>
int resident_blocks(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return max(1, sms * per_sm);
}

template <int S, bool PACKED>
void launch_tc(const void* src, const void* idx, int m, const void* qp,
               const void* basis, void* out, int n, int dq_shift, int sh2,
               cudaStream_t stream) {
  constexpr int NTH = threads_for(S);
  constexpr int TPB = 16 * NTH / (S * S);
  static const int resident = resident_blocks(residual_tc<S, PACKED>, NTH);
  const long long n_tiles = ((long long)n + TPB - 1) / TPB;
  const int tiles = (int)((n_tiles + resident - 1) / resident);
  const int blocks = (int)((n_tiles + tiles - 1) / tiles);
  residual_tc<S, PACKED><<<blocks, NTH, 0, stream>>>(
      static_cast<const int16_t*>(src), static_cast<const int32_t*>(idx), m,
      static_cast<const int32_t*>(qp), static_cast<const int32_t*>(basis),
      static_cast<int16_t*>(out), n, dq_shift, sh2, tiles);
}

}  // namespace

// Dense entry.  x: int16 [n, size, size]; qp: int32 [n] scaled QPs in
// 0..63; basis: int32 [size, size]; out: int16 [n, size, size]; all device
// pointers, contiguous, 16-byte aligned.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int thevc_residual(const void* x, const void* qp, const void* basis,
                              void* out, int n, int size, int dq_shift,
                              int sh2, void* stream) {
  if (n <= 0) return 0;
  if (dq_shift < 1 || sh2 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 4:
      residual4<<<(n + kThreads4 - 1) / kThreads4, kThreads4, 0, st>>>(
          static_cast<const int16_t*>(x), static_cast<const int32_t*>(qp),
          static_cast<const int32_t*>(basis), static_cast<int16_t*>(out), n,
          dq_shift, sh2);
      break;
    case 8:
      launch_tc<8, false>(x, nullptr, 0, qp, basis, out, n, dq_shift, sh2, st);
      break;
    case 16:
      launch_tc<16, false>(x, nullptr, 0, qp, basis, out, n, dq_shift, sh2,
                           st);
      break;
    case 32:
      launch_tc<32, false>(x, nullptr, 0, qp, basis, out, n, dq_shift, sh2,
                           st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// CG-packed entry (8x8 to 32x32).  vals: int16 [m, 16], one coded 4x4 group
// per row in raster order; idx: int32 [m], tu * (size/4)^2 + cg_y * size/4 +
// cg_x, ascending, rows at or past n * (size/4)^2 ignored; qp, basis and out
// as for the dense entry.
extern "C" int thevc_residual_packed(const void* vals, const void* idx, int m,
                                     const void* qp, const void* basis,
                                     void* out, int n, int size, int dq_shift,
                                     int sh2, void* stream) {
  if (n <= 0) return 0;
  if (dq_shift < 1 || sh2 < 1 || m < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 8:
      launch_tc<8, true>(vals, idx, m, qp, basis, out, n, dq_shift, sh2, st);
      break;
    case 16:
      launch_tc<16, true>(vals, idx, m, qp, basis, out, n, dq_shift, sh2, st);
      break;
    case 32:
      launch_tc<32, true>(vals, idx, m, qp, basis, out, n, dq_shift, sh2, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
