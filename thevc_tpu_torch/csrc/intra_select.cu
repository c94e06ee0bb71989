// The fast-RD intra decision pass's selection steps on an NVIDIA Hopper card
// (sm_90a): three kernels around the sweep and TU-RD kernels of intra_rd.cu.
// On the TPU these steps are XLA device code inside one jitted program a
// frame (thevc_tpu/encoder/fast_intra.py:868 _frame_body; P/B slices
// thevc_tpu/encoder/fast_inter.py:792); the Pallas kernel of that path is
// the SATD (jx_pallas.py:63 _satd_kernel), which the sweep holds.
//
// Kernel A, thevc_intra_select: one launch a decision pass, after its
// sweeps, over every luma class up to the CTU size: the open-loop MPM and
// mode-bit cost and the top 3 of each block (fast_intra.py:467-492, in
// _size_pass_impl :404).  Per block the left and above neighbours'
// SATD-best modes (DC outside the frame; above also DC outside the block's
// CTU row below the CTU size, and always at the CTU size), the three MPMs
// (_mpm_vec :303), each mode's bits b0 / b12 / bo and cost = f32(satd) +
// bits * sqrt_lam, rounded after the product and after the sum.  Out per
// class: the three least costs' modes, ties to the lower mode (a stable
// ascending sort, lax.top_k(-cost)), int32 [nb, 3], and their bits, float32
// [nb, 3].  A block's bits read its neighbours' SATD-best, which other CTAs
// of the sweep compute: hence a launch after the sweeps.
//
// Kernel B, thevc_intra_pick: one launch a decision pass, after its TU-RDs,
// over every luma class: the RD pick (fast_intra.py:500-516): bits = cbits +
// mbits, rd = f32(dist) + lam * bits; best, dist and bits of the first
// minimum, then the second and third modes, each the first minimum with the
// earlier winners at +inf.  Out per class: int32 best, dist, mode2, mode3
// and float32 bits [nb]; for s >= 8 the chroma pass's five candidate ids
// [nb, 5] (fast_intra.py:580-583: planar, 26, 10, DC, each 34 where it is
// the luma best, then DM = the luma best); for s == 4 the NxN 8x8 variant's
// ids [nb / 4, 5] from the best of each even-row, even-column block
// (fast_intra.py:832-835).
//
// A and B take a class table in the parameter space (__grid_constant__, as
// C's DpArgs): each class's pointers, grid and size, 4x4 first; a CTA finds
// its class from the classes' first CTAs, which the entry sets.
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
// block on the CUDA cores, so they fill the card only together: one launch
// of A (B) over all 173910 blocks of a 1080p pass.  A: a thread a block,
// its CTA's SATD rows staged into shared memory with 16-byte loads; the top
// 3 in registers by compare-selects under the (cost, mode) order, no array
// indexed at run time (no stack frame); the products bits * sqrt_lam once a
// block.  (Teams of lanes on a block's modes, their triples merged by
// shuffles, took the same time in one launch: the 4x4 class fills the
// card.)  B: a
// thread a block, the three candidates ordered by compare-selects.  C: a
// CTA a CTU whose threads walk each class's blocks bottom-up (the costs,
// split flags and chroma directions of the CTU in shared memory, a barrier
// between classes) and then each 4x4 unit's path top-down.
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
constexpr int kClasses = 5;          // luma size classes 4..64
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
// kernel A: MPM, mode bits, cost and the top 3 of each block, every class
// ---------------------------------------------------------------------------

struct SelectClass {       // one luma size class, 4 << k
  const int* satd;         // [nb, 35]: the sweep's SATDs, 16-byte aligned
  const int* best;         // [nb]: the sweep's SATD-best modes
  int* topk;               // [nb, 3]
  float* mbits;            // [nb, 3]
  int nby, nbx, size;
  int first;               // the class's first CTA (the entry sets it)
};

struct SelectArgs {
  SelectClass cls[kClasses];  // 4x4 first, then each size up to the CTU's
  const float* b0;            // the mode-bit classes and sqrt-lambda
  const float* b12;
  const float* bo;
  const float* sqrt_lam;
  int classes, ctu;
};

// the three first entries in the (cost, mode) order, in registers
struct Top3 {
  float c0, c1, c2;
  int m0, m1, m2;
};

// insert (c, m), m above every mode inserted before it: in the (cost,
// mode) order (ascending cost, ties to the lower mode: a stable ascending
// sort's, lax.top_k(-cost)'s) it goes before an entry only where its cost
// is strictly less, so a later equal cost never displaces an earlier one.
// Compare-selects on fixed slots, no array indexed at run time.
__device__ __forceinline__ void insert(Top3& t, float c, int m) {
  const bool l0 = c < t.c0, l1 = c < t.c1, l2 = c < t.c2;
  t.c2 = l1 ? t.c1 : (l2 ? c : t.c2);
  t.m2 = l1 ? t.m1 : (l2 ? m : t.m2);
  t.c1 = l0 ? t.c0 : (l1 ? c : t.c1);
  t.m1 = l0 ? t.m0 : (l1 ? m : t.m1);
  t.c0 = l0 ? c : t.c0;
  t.m0 = l0 ? m : t.m0;
}

// A CTA takes kSelectThreads blocks of one class, a thread a block.  Their
// SATD rows are one contiguous span (128 rows of 140 bytes, 16-byte
// aligned), staged into shared memory with 16-byte loads.
__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const __grid_constant__ SelectArgs a) {
  __shared__ __align__(16) int rows[kSelectThreads * kModes];
  int k = 0;
  while (k + 1 < a.classes && (int)blockIdx.x >= a.cls[k + 1].first) ++k;
  const SelectClass& c = a.cls[k];
  const int base = ((int)blockIdx.x - c.first) * kSelectThreads;
  const int nb = c.nby * c.nbx;
  const int n = nb - base < kSelectThreads ? nb - base : kSelectThreads;
  const int words = n * kModes, quads = words >> 2;
  const int* src = c.satd + (long long)base * kModes;
  const int4* src4 = reinterpret_cast<const int4*>(src);
  int4* rows4 = reinterpret_cast<int4*>(rows);
#pragma unroll 3
  for (int q = threadIdx.x; q < quads; q += kSelectThreads)
    rows4[q] = __ldg(src4 + q);
  for (int w = (quads << 2) + threadIdx.x; w < words; w += kSelectThreads)
    rows[w] = __ldg(src + w);
  __syncthreads();

  if ((int)threadIdx.x >= n) return;
  const int i = base + threadIdx.x;
  const int by = i / c.nbx, bx = i - by * c.nbx;
  const int left = bx > 0 ? __ldg(c.best + i - 1) : kDc;
  // an above PU outside the current CTU row reads as DC
  // (TComDataCU.cpp:1931); at the CTU size every block starts a row
  int above = kDc;
  if (c.size < a.ctu && by > 0 && (by * c.size) % a.ctu != 0)
    above = __ldg(c.best + i - c.nbx);
  // _mpm_vec
  int mpm0, mpm1, mpm2;
  if (left == above) {
    const bool big = left > 1;
    mpm0 = big ? left : kPlanar;
    mpm1 = big ? ((left + 29) % 32) + 2 : kDc;
    mpm2 = big ? ((left - 1) % 32) + 2 : kVer;
  } else {
    mpm0 = left;
    mpm1 = above;
    mpm2 = (left != 0 && above != 0) ? kPlanar
                                     : (left + above < 2 ? kVer : kDc);
  }
  // bits * sqrt_lam takes three values: each one product, as the plain
  // form's
  const float sl = *a.sqrt_lam;
  const float b0 = *a.b0, b12 = *a.b12, bo = *a.bo;
  const float p0 = fmul(b0, sl), p12 = fmul(b12, sl), po = fmul(bo, sl);
  const float inf = __int_as_float(0x7f800000);
  Top3 top = {inf, inf, inf, kModes, kModes, kModes};
  const int* row = rows + threadIdx.x * kModes;
#pragma unroll 5
  for (int m = 0; m < kModes; ++m) {
    const float p = m == mpm0 ? p0 : ((m == mpm1 || m == mpm2) ? p12 : po);
    insert(top, fadd(i2f(row[m]), p), m);
  }
  const int mode[3] = {top.m0, top.m1, top.m2};
  int* to = c.topk + (long long)i * 3;
  float* bits = c.mbits + (long long)i * 3;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int m = mode[j];
    to[j] = m;
    bits[j] = m == mpm0 ? b0 : ((m == mpm1 || m == mpm2) ? b12 : bo);
  }
}

// ---------------------------------------------------------------------------
// kernel B: the RD pick of the top 3, and the chroma candidates' ids
// ---------------------------------------------------------------------------

struct PickClass {         // one luma size class, 4 << k
  const int* topk;         // [nb, 3]: kernel A's modes
  const float* mbits;      // [nb, 3]: their mode bits
  const int* dist_k;       // [nb * 3]: their TU-RD dist and bits
  const float* cbits_k;
  int* best;               // [nb] each
  int* dist;
  float* bits;
  int* mode2;
  int* mode3;
  int* cids;               // [nb, 5]; at 4 the NxN variant's [nb / 4, 5]
  int nby, nbx, size;
  int first;               // the class's first CTA (the entry sets it)
};

struct PickArgs {
  PickClass cls[kClasses];  // 4x4 first
  const float* lam;
  int classes;
};

// the first minimum of (r0, r1, r2)
__device__ __forceinline__ int first_min3(float r0, float r1, float r2) {
  int k = 0;
  float v = r0;
  if (r1 < v) {
    k = 1;
    v = r1;
  }
  if (r2 < v) k = 2;
  return k;
}

template <typename T>
__device__ __forceinline__ T of3(int k, T v0, T v1, T v2) {
  return k == 0 ? v0 : (k == 1 ? v1 : v2);
}

__global__ void __launch_bounds__(kPickThreads)
pick_kernel(const __grid_constant__ PickArgs a) {
  int k = 0;
  while (k + 1 < a.classes && (int)blockIdx.x >= a.cls[k + 1].first) ++k;
  const PickClass& c = a.cls[k];
  const int nbx = c.nbx, nb = c.nby * nbx;
  const int i = ((int)blockIdx.x - c.first) * kPickThreads + threadIdx.x;
  if (i >= nb) return;
  const float lam = *a.lam;
  const long long o = (long long)i * 3;
  const int md0 = c.topk[o], md1 = c.topk[o + 1], md2 = c.topk[o + 2];
  const int d0 = c.dist_k[o], d1 = c.dist_k[o + 1], d2 = c.dist_k[o + 2];
  const float bt0 = fadd(c.cbits_k[o], c.mbits[o]);
  const float bt1 = fadd(c.cbits_k[o + 1], c.mbits[o + 1]);
  const float bt2 = fadd(c.cbits_k[o + 2], c.mbits[o + 2]);
  float r0 = fadd(i2f(d0), fmul(lam, bt0));
  float r1 = fadd(i2f(d1), fmul(lam, bt1));
  float r2 = fadd(i2f(d2), fmul(lam, bt2));
  // each the first minimum with the earlier winners at +inf
  const float inf = __int_as_float(0x7f800000);
  const int s1 = first_min3(r0, r1, r2);
  r0 = s1 == 0 ? inf : r0;
  r1 = s1 == 1 ? inf : r1;
  r2 = s1 == 2 ? inf : r2;
  const int s2 = first_min3(r0, r1, r2);
  r0 = s2 == 0 ? inf : r0;
  r1 = s2 == 1 ? inf : r1;
  r2 = s2 == 2 ? inf : r2;
  const int s3 = first_min3(r0, r1, r2);
  const int best = of3(s1, md0, md1, md2);
  c.best[i] = best;
  c.dist[i] = of3(s1, d0, d1, d2);
  c.bits[i] = of3(s1, bt0, bt1, bt2);
  c.mode2[i] = of3(s2, md0, md1, md2);
  c.mode3[i] = of3(s3, md0, md1, md2);
  int ids[5];
  chroma_ids(best, ids);
  if (c.size >= 8) {
#pragma unroll
    for (int j = 0; j < 5; ++j) c.cids[(long long)i * 5 + j] = ids[j];
    return;
  }
  // the NxN 8x8 variant: DM is part 0's (the top-left 4x4's) mode
  const int by = i / nbx, bx = i - by * nbx;
  if ((by | bx) & 1) return;
  const long long g = (long long)(by >> 1) * (nbx >> 1) + (bx >> 1);
#pragma unroll
  for (int j = 0; j < 5; ++j) c.cids[g * 5 + j] = ids[j];
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

// class k of a class table: of size 4 << k, none above the CTU, a grid
template <typename Class>
bool class_ok(const Class& c, int k, int ctu) {
  return c.nby > 0 && c.nbx > 0 && c.size == 4 << k && c.size <= ctu;
}

extern "C" int thevc_intra_select(const void* args, void* stream) {
  SelectArgs a = *static_cast<const SelectArgs*>(args);
  if ((a.ctu != 16 && a.ctu != 32 && a.ctu != 64) || a.classes < 1 ||
      a.classes > kClasses)
    return (int)cudaErrorInvalidValue;
  long long ctas = 0;
  for (int k = 0; k < a.classes; ++k) {
    SelectClass& c = a.cls[k];
    if (!class_ok(c, k, a.ctu) ||
        (reinterpret_cast<unsigned long long>(c.satd) & 15))
      return (int)cudaErrorInvalidValue;
    c.first = (int)ctas;
    ctas += ((long long)c.nby * c.nbx + kSelectThreads - 1) / kSelectThreads;
  }
  if (ctas >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  select_kernel<<<(unsigned)ctas, kSelectThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int thevc_intra_pick(const void* args, void* stream) {
  PickArgs a = *static_cast<const PickArgs*>(args);
  if (a.classes < 1 || a.classes > kClasses)
    return (int)cudaErrorInvalidValue;
  long long ctas = 0;
  for (int k = 0; k < a.classes; ++k) {
    PickClass& c = a.cls[k];
    // the NxN variant's 8x8 blocks need an even 4x4 grid
    if (!class_ok(c, k, 64) || (k == 0 && ((c.nby | c.nbx) & 1)))
      return (int)cudaErrorInvalidValue;
    c.first = (int)ctas;
    ctas += ((long long)c.nby * c.nbx + kPickThreads - 1) / kPickThreads;
  }
  if (ctas >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  pick_kernel<<<(unsigned)ctas, kPickThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
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
