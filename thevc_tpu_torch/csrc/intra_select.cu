// The fast-RD intra decision pass's selection steps on an NVIDIA Hopper card
// (sm_90a): three kernels around the sweep and TU-RD kernels of intra_rd.cu.
// On the TPU these steps are XLA device code inside one jitted program a
// frame (thevc_tpu/encoder/fast_intra.py:868 _frame_body; P/B slices
// thevc_tpu/encoder/fast_inter.py:792); the Pallas kernel of that path is
// the SATD (jx_pallas.py:63 _satd_kernel), which the sweep holds.
//
// Kernel A, thevc_intra_select: after a luma class's sweep, the open-loop
// MPM and mode-bit cost and the top 3 of each block (fast_intra.py:467-492,
// in _size_pass_impl :404).  Per block the left and above neighbours'
// SATD-best modes (DC outside the frame; above also DC outside the block's
// CTU row below the CTU size, and always at the CTU size), the three MPMs
// (_mpm_vec :303), each mode's bits b0 / b12 / bo and cost = f32(satd) +
// bits * sqrt_lam, rounded after the product and after the sum.  Out: the
// three least costs' modes, ties to the lower mode (a stable ascending sort,
// lax.top_k(-cost)), int32 [nb, 3], and their bits, float32 [nb, 3].  A
// block's bits read its neighbours' SATD-best, which other CTAs of the sweep
// compute: hence a launch of its own after the sweep.
//
// Kernel B, thevc_intra_pick: after the TU-RD of the top 3, the RD pick
// (fast_intra.py:500-516): bits = cbits + mbits, rd = f32(dist) + lam *
// bits; best, dist and bits of the first minimum, then the second and third
// modes, each the first minimum with the earlier winners at +inf.  Out:
// int32 best, dist, mode2, mode3 and float32 bits [nb]; for s >= 8 the
// chroma pass's five candidate ids [nb, 5] (fast_intra.py:580-583: planar,
// 26, 10, DC, each 34 where it is the luma best, then DM = the luma best);
// for s == 4 the NxN 8x8 variant's ids [nb / 4, 5] from the best of each
// even-row, even-column block (fast_intra.py:832-835).
//
// Kernel C, thevc_intra_dp: one launch a frame, a CTA a CTU (the DP never
// crosses a CTU): the chroma pick of every chroma class and of the NxN
// variant (fast_intra.py:588-600: cost = cw * f32(d_cb + d_cr) + lam *
// ((b_cb + b_cr) + mbits), the int32 sum first; the first minimum; the
// stored direction is the id, or 36 for DM), the bottom-up quadtree DP of
// _dp_expand (:613-742: leaves f32(dist) + lam * (bits + 5), + the chroma
// cost, + lam * intra_pen on inter slices; the inter leaf rd + lam * 3 taken
// where strictly cheaper; 1e30 where a block crosses the frame edge, 0
// where it lies outside; quad sums (0,0)+(0,1)+(1,0)+(1,1); a split, or the
// NxN partition at 8, where strictly cheaper and allowed) and the top-down
// expansion (:744-775) into the unit maps: int8 [6, hp/4, wp/4] (depth,
// mode, nxn, chroma, mode2, mode3) for I slices; for P and B slices int16
// [10 | 14, hp/4, wp/4] with pred, ref, mvx, mvy (B: dir, ref1, mvx1,
// mvy1).  Modes, refs and dirs pass through int8, MVs are cut to int16.
//
// Every value equals the port's plain PyTorch forms (encoder/fast_intra.py:
// intra_select_plain, intra_pick_plain, intra_dp_plain), bit for bit: every
// float operation is one IEEE operation in the plain forms' order
// (__fadd_rn / __fmul_rn, int32 -> float32 round-to-nearest; the source is
// also built with -fmad=false), every minimum the first one.
//
// What bounds them.  All three move little: per 1080p frame A reads the
// SATDs (35 int32 a block) and the best modes and writes 24 bytes a block,
// about 29 MB over the five classes; B reads 48 and writes 20 to 40 bytes a
// block, C reads the classes' results once and writes the maps.  By bytes
// they are bound at a few microseconds; their operations are a few hundred a
// block on the CUDA cores.  So the design is the simple one: A a thread a
// block, its CTA's SATD rows staged through shared memory so that the reads
// coalesce; B a thread a block; C a CTA a CTU whose threads walk each class's
// blocks bottom-up (the costs, split flags and chroma directions of the CTU
// in shared memory, a barrier between classes) and then each 4x4 unit's
// path top-down.  Launch latency, not bandwidth, is what they cost.
//
// Every entry checks its geometry, launches on the stream it is given and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kModes = 35;
constexpr int kPlanar = 0;
constexpr int kDc = 1;
constexpr int kHor = 10;
constexpr int kVer = 26;
constexpr int kDmChroma = 36;
constexpr int kSelectThreads = 128;
constexpr int kPickThreads = 256;
constexpr int kDpThreads = 256;

__device__ __forceinline__ float i2f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
// int32 addition that wraps, as a tensor's
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// the chroma candidates' mode ids of a block whose luma best is `best`
// (the DM-reference mode is the same block's)
__device__ __forceinline__ void chroma_ids(int best, int* ids) {
  const int fixed[4] = {kPlanar, kVer, kHor, kDc};
#pragma unroll
  for (int k = 0; k < 4; ++k) ids[k] = best == fixed[k] ? 34 : fixed[k];
  ids[4] = best;
}

// ---------------------------------------------------------------------------
// kernel A: MPM, mode bits, cost and the top 3 of each block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const int* __restrict__ satd, const int* __restrict__ best,
              int nby, int nbx, int size, int ctu,
              const float* __restrict__ b0p, const float* __restrict__ b12p,
              const float* __restrict__ bop, const float* __restrict__ slp,
              int* __restrict__ topk, float* __restrict__ mbits) {
  __shared__ int rows[kSelectThreads * kModes];
  const long long nb = (long long)nby * nbx;
  const long long base = (long long)blockIdx.x * blockDim.x;
  const int n = (int)(nb - base < blockDim.x ? nb - base : blockDim.x);
  // every load in flight before the first store (a loop that stores each
  // value as it arrives waits out one load latency an iteration)
  int v[kModes];
#pragma unroll
  for (int k = 0; k < kModes; ++k) {
    const int j = threadIdx.x + k * kSelectThreads;
    v[k] = j < n * kModes ? satd[base * kModes + j] : 0;
  }
#pragma unroll
  for (int k = 0; k < kModes; ++k) {
    const int j = threadIdx.x + k * kSelectThreads;
    if (j < n * kModes) rows[j] = v[k];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= n) return;
  const long long i = base + t;
  const int by = (int)(i / nbx), bx = (int)(i % nbx);
  const int left = bx > 0 ? best[i - 1] : kDc;
  // an above PU outside the current CTU row reads as DC
  // (TComDataCU.cpp:1931); at the CTU size every block starts a row
  int above = kDc;
  if (size < ctu && by > 0 && (by * size) % ctu != 0) above = best[i - nbx];
  // _mpm_vec
  int m0, m1, m2;
  if (left == above) {
    const bool big = left > 1;
    m0 = big ? left : kPlanar;
    m1 = big ? ((left + 29) % 32) + 2 : kDc;
    m2 = big ? ((left - 1) % 32) + 2 : kVer;
  } else {
    m0 = left;
    m1 = above;
    m2 = (left != 0 && above != 0) ? kPlanar
                                   : (left + above < 2 ? kVer : kDc);
  }
  const float b0 = *b0p, b12 = *b12p, bo = *bop, sl = *slp;
  // the three least costs, ascending; a later equal cost never displaces
  // an earlier one (a stable sort's order)
  float c[3];
  int id[3];
  int have = 0;
  const int* row = rows + t * kModes;
  for (int m = 0; m < kModes; ++m) {
    const float bits = m == m0 ? b0 : ((m == m1 || m == m2) ? b12 : bo);
    const float cost = fadd(i2f(row[m]), fmul(bits, sl));
    if (have == 3 && !(cost < c[2])) continue;
    int p = have < 3 ? have : 2;
    while (p > 0 && cost < c[p - 1]) {
      c[p] = c[p - 1];
      id[p] = id[p - 1];
      --p;
    }
    c[p] = cost;
    id[p] = m;
    if (have < 3) ++have;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int m = id[k];
    topk[i * 3 + k] = m;
    mbits[i * 3 + k] = m == m0 ? b0 : ((m == m1 || m == m2) ? b12 : bo);
  }
}

// ---------------------------------------------------------------------------
// kernel B: the RD pick of the top 3, and the chroma candidates' ids
// ---------------------------------------------------------------------------

// the first minimum of v[0..2]
__device__ __forceinline__ int first_min3(const float* v) {
  int k = 0;
  if (v[1] < v[k]) k = 1;
  if (v[2] < v[k]) k = 2;
  return k;
}

__global__ void __launch_bounds__(kPickThreads)
pick_kernel(const int* __restrict__ topk, const float* __restrict__ mbits,
            const int* __restrict__ dist_k, const float* __restrict__ cbits_k,
            const float* __restrict__ lamp, int nby, int nbx, int size,
            int* __restrict__ best_o, int* __restrict__ dist_o,
            float* __restrict__ bits_o, int* __restrict__ mode2_o,
            int* __restrict__ mode3_o, int* __restrict__ cids) {
  const long long nb = (long long)nby * nbx;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb) return;
  const float lam = *lamp;
  float bits[3], rd[3];
  int mode[3], dist[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mode[k] = topk[i * 3 + k];
    dist[k] = dist_k[i * 3 + k];
    bits[k] = fadd(cbits_k[i * 3 + k], mbits[i * 3 + k]);
    rd[k] = fadd(i2f(dist[k]), fmul(lam, bits[k]));
  }
  const int sel = first_min3(rd);
  rd[sel] = __int_as_float(0x7f800000);
  const int sel2 = first_min3(rd);
  rd[sel2] = __int_as_float(0x7f800000);
  const int sel3 = first_min3(rd);
  const int best = mode[sel];
  best_o[i] = best;
  dist_o[i] = dist[sel];
  bits_o[i] = bits[sel];
  mode2_o[i] = mode[sel2];
  mode3_o[i] = mode[sel3];
  int ids[5];
  chroma_ids(best, ids);
  if (size >= 8) {
#pragma unroll
    for (int k = 0; k < 5; ++k) cids[i * 5 + k] = ids[k];
    return;
  }
  // the NxN 8x8 variant: DM is part 0's (the top-left 4x4's) mode
  const int by = (int)(i / nbx), bx = (int)(i % nbx);
  if ((by | bx) & 1) return;
  const long long j = (long long)(by >> 1) * (nbx >> 1) + (bx >> 1);
#pragma unroll
  for (int k = 0; k < 5; ++k) cids[j * 5 + k] = ids[k];
}

// ---------------------------------------------------------------------------
// kernel C: chroma picks, the quadtree DP and the expansion, a CTA a CTU
// ---------------------------------------------------------------------------

struct DpLuma {            // one luma size class, [nby * nbx] each
  const int* mode;
  const int* dist;
  const float* bits;
  const int* mode2;
  const int* mode3;
};

struct DpChroma {          // one chroma class's candidates
  const int* ids;          // [nb, 5]
  const int* dist;         // [2, nb, 5]: Cb, then Cr
  const float* bits;       // [2, nb, 5]
};

struct DpInter {           // one inter size class's winners, [nby * nbx]
  const float* rd;
  const int* mvx;
  const int* mvy;
  const int* ref;
  const int* dir;          // B slices: then the L1 fields
  const int* mvx1;
  const int* mvy1;
  const int* ref1;
};

struct DpArgs {
  DpLuma luma[5];          // class 4 << k
  DpChroma chroma[5];      // [0]: the NxN variant at 8; [k]: class 4 << k
  DpInter inter[5];        // [k]: class 4 << k where inter_mask bit k
  const float* lam;        // the DP's lambda
  const float* clam;       // the chroma pick's lambda, weight and bits
  const float* cw;
  const float* bits_dm;
  const float* bits_oth;
  float intra_pen;
  int inter_kind;          // 0: I slice, 1: P, 2: B
  int inter_mask;
  int width, height, wp, hp, ctu, max_sig, min_tr_log2;
  void* out;
};

// shared offsets of each class's blocks within a CTU of 64 (4x4 first)
__constant__ int kOff[5] = {0, 256, 320, 336, 340};
constexpr int kCtuBlocks = 341;

// the chroma pick of block g of a class of nb blocks: (stored dir, cost)
__device__ __forceinline__ float chroma_pick(const DpChroma& c, long long nb,
                                             long long g, float clam,
                                             float cw, float bdm, float both,
                                             int* dir) {
  float best = 0.0f;
  int sel = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const long long a = g * 5 + k, b = nb * 5 + g * 5 + k;
    const float dist = i2f(wrap_add(c.dist[a], c.dist[b]));
    const float cbits = fadd(c.bits[a], c.bits[b]);
    const float cost = fadd(fmul(cw, dist),
                            fmul(clam, fadd(cbits, k < 4 ? both : bdm)));
    if (k == 0 || cost < best) {
      best = cost;
      sel = k;
    }
  }
  *dir = sel < 4 ? c.ids[g * 5 + sel] : kDmChroma;
  return best;
}

// the arguments stay in the parameter space (__grid_constant__): the
// classes' pointers are indexed by a class number known only at run time
__global__ void __launch_bounds__(kDpThreads)
dp_kernel(const __grid_constant__ DpArgs a) {
  __shared__ float cost[kCtuBlocks];
  __shared__ unsigned char choice[kCtuBlocks];
  __shared__ unsigned char pred_inter[kCtuBlocks];
  __shared__ signed char cdir[kCtuBlocks];     // at 8: the CU's
  __shared__ signed char ndir[64];             // at 8: the NxN variant's
  const int ctu = a.ctu;
  const int ctx = blockIdx.x, cty = blockIdx.y;
  const float lam = *a.lam;
  const float clam = *a.clam, cw = *a.cw, bdm = *a.bits_dm,
              both = *a.bits_oth;
  const bool inter = a.inter_kind != 0;
  const int min_cu = ctu >> a.max_sig;
  const bool can8 = 8 > (1 << a.min_tr_log2) && 4 >= min_cu;
  const float big = 1e30f;

  // bottom-up, class by class
  for (int k = 0; 4 << k <= ctu; ++k) {
    const int s = 4 << k;
    const int per = ctu / s;                 // blocks a CTU row
    const int nbx = a.wp / s;
    const long long nb = (long long)(a.hp / s) * nbx;
    const DpLuma& L = a.luma[k];
    const bool has_inter = inter && ((a.inter_mask >> k) & 1);
    for (int j = threadIdx.x; j < per * per; j += blockDim.x) {
      const int ly = j / per, lx = j % per;
      const int by = cty * per + ly, bx = ctx * per + lx;
      const long long g = (long long)by * nbx + bx;
      float leaf = fadd(i2f(L.dist[g]), fmul(lam, fadd(L.bits[g], 5.0f)));
      if (s >= 8) {
        int d;
        leaf = fadd(leaf, chroma_pick(a.chroma[k], nb, g, clam, cw, bdm,
                                      both, &d));
        cdir[kOff[k] + j] = (signed char)d;
        if (inter) leaf = fadd(leaf, fmul(lam, a.intra_pen));
      }
      unsigned char pi = 0;
      if (has_inter) {
        const float ileaf = fadd(a.inter[k].rd[g], fmul(lam, 3.0f));
        pi = ileaf < leaf;
        if (ileaf < leaf) leaf = ileaf;
      }
      pred_inter[kOff[k] + j] = pi;
      const int ys = by * s, xs = bx * s;
      const bool crosses = (ys < a.height && ys + s > a.height) ||
                           (xs < a.width && xs + s > a.width);
      const bool outside = ys >= a.height || xs >= a.width;
      if (crosses) leaf = big;
      if (outside) leaf = 0.0f;
      if (s == 4) {
        cost[j] = leaf;
        choice[j] = 0;
        continue;
      }
      const int cp = per * 2, co = kOff[k - 1];
      const int c00 = co + (2 * ly) * cp + 2 * lx;
      const float qs = fadd(fadd(fadd(cost[c00], cost[c00 + 1]),
                                 cost[c00 + cp]), cost[c00 + cp + 1]);
      float split;
      bool can;
      if (s == 8) {
        // the NxN partition (not a CU split) adds its chroma cost
        int d;
        const float nc = chroma_pick(a.chroma[0], nb, g, clam, cw, bdm,
                                     both, &d);
        ndir[j] = (signed char)d;
        split = fadd(fadd(qs, nc), fmul(lam, 3.0f));
        if (inter) split = fadd(split, fmul(lam, a.intra_pen));
        can = can8;
      } else {
        split = fadd(qs, fmul(lam, 1.0f));
        can = s > min_cu;
      }
      const bool take = can && split < leaf;
      cost[kOff[k] + j] = take ? split : leaf;
      choice[kOff[k] + j] = take;
    }
    __syncthreads();
  }

  // top-down: each 4x4 unit's path from the CTU to its leaf
  const int upc = ctu / 4;                   // units a CTU row
  const int uw = a.wp / 4, uh = a.hp / 4;
  const long long plane = (long long)uh * uw;
  int top_k = 0;
  while ((4 << (top_k + 1)) <= ctu && top_k < 4) ++top_k;
  for (int u = threadIdx.x; u < upc * upc; u += blockDim.x) {
    const int uy = u / upc, ux = u % upc;
    const int gy = cty * upc + uy, gx = ctx * upc + ux;
    const long long at = (long long)gy * uw + gx;
    int k = top_k, depth = 0;
    int v[14] = {0, kDc, 0, kDmChroma, kDc, kDc, 0, 0, 0, 0, 1, 0, 0, 0};
    for (;;) {
      const int s = 4 << k, per = ctu / s, nbx = a.wp / s;
      const int ly = uy * 4 / s, lx = ux * 4 / s;
      const int j = ly * per + lx;
      const long long g = (long long)(cty * per + ly) * nbx + ctx * per + lx;
      if (choice[kOff[k] + j] && s > 8) {
        --k;
        ++depth;
        continue;
      }
      v[0] = depth;
      if (choice[kOff[k] + j]) {
        // a split at 8 is an NxN-PU 8x8 CU: the unit's modes are the 4x4
        // pass's
        const long long g4 = (long long)gy * uw + gx;
        v[1] = (signed char)a.luma[0].mode[g4];
        v[2] = 1;
        v[3] = ndir[j];
        v[4] = (signed char)a.luma[0].mode2[g4];
        v[5] = (signed char)a.luma[0].mode3[g4];
        break;
      }
      const DpLuma& L = a.luma[k];
      v[1] = (signed char)L.mode[g];
      v[3] = cdir[kOff[k] + j];
      v[4] = (signed char)L.mode2[g];
      v[5] = (signed char)L.mode3[g];
      if (inter && ((a.inter_mask >> k) & 1) && pred_inter[kOff[k] + j]) {
        const DpInter& I = a.inter[k];
        v[6] = 1;
        v[7] = (signed char)I.ref[g];
        v[8] = (short)I.mvx[g];
        v[9] = (short)I.mvy[g];
        if (a.inter_kind == 2) {
          v[10] = (signed char)I.dir[g];
          v[11] = (signed char)I.ref1[g];
          v[12] = (short)I.mvx1[g];
          v[13] = (short)I.mvy1[g];
        }
      }
      break;
    }
    if (!inter) {
      signed char* o = static_cast<signed char*>(a.out);
      for (int p = 0; p < 6; ++p) o[p * plane + at] = (signed char)v[p];
    } else {
      short* o = static_cast<short*>(a.out);
      const int planes = a.inter_kind == 2 ? 14 : 10;
      for (int p = 0; p < planes; ++p) o[p * plane + at] = (short)v[p];
    }
  }
}

}  // namespace

extern "C" int thevc_intra_select(const void* satd, const void* best,
                                  int nby, int nbx, int size, int ctu,
                                  const void* b0, const void* b12,
                                  const void* bo, const void* sqrt_lam,
                                  void* topk, void* mbits, void* stream) {
  if (nby <= 0 || nbx <= 0 || size < 4 || size > ctu || ctu > 64)
    return (int)cudaErrorInvalidValue;
  const long long nb = (long long)nby * nbx;
  const unsigned grid = (unsigned)((nb + kSelectThreads - 1) /
                                   kSelectThreads);
  select_kernel<<<grid, kSelectThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(satd), static_cast<const int*>(best), nby, nbx,
      size, ctu, static_cast<const float*>(b0),
      static_cast<const float*>(b12), static_cast<const float*>(bo),
      static_cast<const float*>(sqrt_lam), static_cast<int*>(topk),
      static_cast<float*>(mbits));
  return (int)cudaGetLastError();
}

extern "C" int thevc_intra_pick(const void* topk, const void* mbits,
                                const void* dist_k, const void* cbits_k,
                                const void* lam, int nby, int nbx, int size,
                                void* best, void* dist, void* bits,
                                void* mode2, void* mode3, void* cids,
                                void* stream) {
  if (nby <= 0 || nbx <= 0 || size < 4 || size > 64 ||
      (size == 4 && ((nby | nbx) & 1)))
    return (int)cudaErrorInvalidValue;
  const long long nb = (long long)nby * nbx;
  const unsigned grid = (unsigned)((nb + kPickThreads - 1) / kPickThreads);
  pick_kernel<<<grid, kPickThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(topk), static_cast<const float*>(mbits),
      static_cast<const int*>(dist_k), static_cast<const float*>(cbits_k),
      static_cast<const float*>(lam), nby, nbx, size, static_cast<int*>(best),
      static_cast<int*>(dist), static_cast<float*>(bits),
      static_cast<int*>(mode2), static_cast<int*>(mode3),
      static_cast<int*>(cids));
  return (int)cudaGetLastError();
}

extern "C" int thevc_intra_dp(const void* args, void* stream) {
  const DpArgs& a = *static_cast<const DpArgs*>(args);
  if ((a.ctu != 16 && a.ctu != 32 && a.ctu != 64) || a.wp <= 0 ||
      a.hp <= 0 || a.wp % a.ctu || a.hp % a.ctu || a.inter_kind < 0 ||
      a.inter_kind > 2 || a.max_sig < 0 || a.min_tr_log2 < 0 ||
      a.min_tr_log2 > 5)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.wp / a.ctu, a.hp / a.ctu);
  dp_kernel<<<grid, kDpThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
