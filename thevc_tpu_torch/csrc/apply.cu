// The fast-RD device apply of one intra frame on an NVIDIA Hopper card
// (sm_90a), in one launch: for every TU record of the frame's schedule, on
// its plane (luma, Cb or Cr), intra prediction from the evolving recon
// plane, forward transform, quantisation (RDOQ or plain) with sign-bit
// hiding, dequant, inverse transform and reconstruction.
//
// Replaces the XLA function thevc_tpu/encoder/fast_apply.py:729
// _class_step, run per wave by _apply_body :818 (a lax.fori_loop in one
// jitted program a frame on the TPU).  Every value matches the plain
// PyTorch form (encoder/fast_apply.py:_class_step_plain, with
// _predict_batch, ops.tq.forward_transform, _rdoq_batch or ops.tq.quant,
// _sbh_batch and ops.tq.residual_pipeline_plain) bit for bit:
//   line    the reference line read from the recon plane, reads clamped
//           into the plane, HM's substitution over the available range
//           [lo, hi] (samples below lo take line[lo], above hi line[hi]),
//           the DC fill 1 << (7 + bit_inc) when nothing is available;
//   predict planar (the [1 2 1]-filtered line for luma from 8x8 on), DC
//           with the luma edge filter, angular through the per-mode
//           gather plans of encoder/fast_intra.py:_unified_plan (the
//           filter choice baked into them) and the luma mode 10/26 edge
//           filters;
//   tq      the forward DCT (DST for 4x4 luma) in two passes, the plain
//           quantiser or RDOQ with its closed-form context proxies and
//           frozen estBits, SBH, the flat dequant and the inverse
//           transform with the int16 clip between the passes;
//   write   pred + residual clipped to [0, max_val] into the plane, the
//           levels (int16, wrapping as torch's cast does) into the
//           record's level stack row.
// RDOQ ranks float32 costs.  The plain form fixes their order: every sum
// an add tree pairing x[i] with x[i + h] as h halves, every suffix sum
// Hillis-Steele steps, every a + b * c two roundings, the CG zero-out and
// last-position totals left to right.  Here each float operation is one
// __fmul_rn / __fadd_rn / __fsub_rn (this source is also built with
// -fmad=false), the trees pair the same elements (the first levels in a
// thread's registers, the last five across warp 0's lanes with
// shuffles, a CG's 16 positions across 16 lanes), the scans run over
// shared memory with the same pairing, and a minimum is exact in any
// order; so the levels equal the plain form's on the CPU and on the card.
// Ties break as there: strict < in the zero, m, m - 1 order, the largest
// scan position among equal last costs, the largest n among equal SBH
// costs.
// Integer ranges: residuals are below 2^(8 + bit_inc) in magnitude, so
// the forward first pass is below s * 90 * 2^(8 + bit_inc) and, after its
// shift of log2(s) - 1 + bit_inc, the second below (s * 90)^2 * 2^(9 -
// log2(s)) <= 2880^2 * 16 < 2^31 at every bit depth: int32 is exact.  The
// inverse passes read int16 values: below 2880 * 2^15 < 2^27.  The
// quantiser's |c| * scale, RDOQ's |c| * Q and max << qbits, and the
// dequant product at QP <= 63 stay below 2^31, as ops/tq.py notes; SBH's
// keys stay below 2^30 with its 2^26 sentinel.
//
// What bounds it on this card: the chain of TUs, each waiting for its
// neighbours' recon.  The recorded 1080p all-intra frame (QP 32, RDOQ;
// 4716 TUs, 437 waves) moves 20 MB and does 654 M int32 multiply-adds, a
// bound of 0.02 ms; but a wave holds a few dozen TUs against 132 SMs, so
// the card is never full and the time is the latency of the longest
// chain.  The frame's critical path modelled from its schedule at each
// class's measured body latency (32x32 17-21 us, 16x16 8-10 us, 8x8 7-9
// us) is 5.1-5.8 ms, and the kernel takes 5.4-6.1 ms; the class-
// step kernel before it took 23 ms in 1276 launches, paying a frame-wide
// barrier a wave and the classes one after another (PERF.md; an NVIDIA
// H100 80GB HBM3 at 700 W).  So the design cuts what a chain link
// costs: no launch and no wave barrier between TUs, and few barriers in
// the TU itself.
//
// The design: one persistent launch a frame.  The host builds the frame's
// item list (a TU record on one plane; Cb and Cr are items of their own),
// the real records wave by wave, then the padding rows that the plain
// form's windows compute.  The grid is as many CTAs as can be resident;
// each CTA takes a ticket (atomicAdd on the state's counter), runs that
// item to its end, and takes the next, until the tickets pass the list.
// Before it reads its reference line an item waits until every unit
// (4x4 luma, 2x2 chroma) under its available range [lo, hi] is flagged in
// its plane's ready map; a writer flags its own units after its recon
// stores (__syncthreads, __threadfence, then a release store).  So a TU
// reads only samples that hold their final values, and the frame equals
// the wave-by-wave plain form.  The tickets go out in wave order and a
// TU's writers are in earlier waves, so they hold lower tickets: each is
// held by a resident CTA that is running (a CTA takes a ticket only when
// it runs) and that never waits on a higher ticket, so the lowest
// unfinished ticket always progresses.  No cooperative launch and no grid
// barrier are needed, whatever the grid.  The reference line and the
// flags are read through L2 (__ldcg, ld.acquire.gpu): L1 is not coherent
// across SMs and a stale line would break exactness.  A wait is bounded:
// past kMaxPolls polls the CTA writes its ticket + 1 into the state's
// error word and traps, so the launch fails instead of hanging.
// A TU runs on one CTA (kBlock threads); its
// prediction, coefficients, levels and RDOQ costs live in shared memory
// (one dynamic buffer sized for 32x32, about 65 KB), where the class's
// basis, its transpose (the forward transform's reads then hit no bank
// twice) and its scans are staged when a CTA changes class; the other
// tables (plans, CG neighbours, estBits) are read through L1.  The
// substitution is a clamp of the line index, so the reference samples
// are read straight into the two lines.  RDOQ's flags and context counts
// come from warp ballots, a CG's sums and SBH's choice from shuffles in
// its half-warp, the trees as above, the two suffix scans in one loop.
// The source block is read from the original planes; padding rows read
// zeros and write into the guard.
//
// The entry does not allocate or synchronise; it zeroes the state's three
// words and launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3e38f;       // "no candidate" cost (_rdoq_batch big)
constexpr int kSbhInf = 1 << 26;    // SBH's excluded cost (_sbh_batch inf)
constexpr int kClasses = 7;
constexpr int kItemInts = 8;        // x, y, lo, hi, mode, scan, kind, lv_off
constexpr int kMaxPolls = 1 << 24;  // a wait's bound (seconds of sleeps)

// the size classes: (size, luma); 4x4 luma takes the DST basis
__host__ __device__ constexpr int cls_size(int ci) {
  return ci == 0 || ci == 4 ? 4 : ci == 1 || ci == 5 ? 8 : ci == 3 ? 32 : 16;
}

struct ClassTabs {
  const int* basis;     // [s, s] T[k][n]
  const int* plan;      // [3][33][s*s] idx_a, idx_b, frac
  const int* scan;      // [3][s*s] scan position -> raster
  const int* rgt;       // [3][ncg] right CG neighbour, ncg = none
  const int* low;       // [3][ncg] lower CG neighbour
  const float* sig0p;   // [3][4][s*s] (RDOQ only)
  const float* sig1p;   // [3][4][s*s]
  const float* rlv;     // [3][s*s]
  const float* one0;    // [16] each
  const float* one1;
  const float* abs0;
  const float* abs1;
  const float* cbf0;
  const float* cbf1;
  float cgb[2][2];      // sigCG bits [context][bin]
};

struct FrameArgs {
  const int* items;     // [n_items][8]
  int* state;           // [3]: next ticket, error (ticket + 1), items
                        // that waited
  int* ready;           // [3][map_h][map_w] flags of written units
  short* rec[3];        // [rec_h, rec_w] recon planes, one top/left
                        // padding row
  const short* org[3];  // [org_h, org_w] source planes
  short* lv;            // [n_lv] the level stacks
  const int* qscale;    // [6]
  const int* iqscale;   // [6]
  ClassTabs cls[kClasses];
  int rec_h[3], rec_w[3], org_h[3], org_w[3];
  int map_h, map_w, n_lv, n_items;
  int qp[3];
  float lam[3];
  float es[3][4];       // RDOQ's error scale per plane and log2(s) - 2
  int bit_inc, max_val, sign_hide, use_rdoq;
};

template <int S>
struct Smem {
  static constexpr int P = S * S, NCG = P / 16;
  // staged when a CTA changes class
  int basis[S * S];               // T[k][n]
  int basis_t[S * S];             // T[n][k]
  int scan[3 * P];                // scan position -> raster
  int pred[P];
  int co[P];                      // coefficients, raster
  int lev[P];                     // levels, raster
  int du[P];                      // quant remainders, raster
  int w[6][P];                    // per-phase scratch
  int ra[2 * S + 1], rl[2 * S + 1], raf[2 * S + 1], rlf[2 * S + 1];
  // per CG, slot NCG the "none" neighbour
  int cg_has[NCG + 1], cg_ge2[NCG + 1], dec[NCG + 1];
  int nnz[NCG], drop[NCG];
  float sum_sig[NCG], coded[NCG], unc[NCG], sigp0[NCG];
  float ccs[NCG], cga[NCG], cgb[NCG], cgc[NCG];
  float red[2][64];               // the CG trees' levels in shared memory
  float wmin[32];                 // the warps' least totals
  int last, gt1, pick, last_cg, dc;
  float bf, best0;
};

constexpr int kSmemBytes = (int)sizeof(Smem<32>);
// the threads a CTA: of 256, 512 and 1024, 512 gave the recorded 1080p
// frame the least device time (PERF.md)
constexpr int kBlock = 512;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int iclamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ float fmin2(float a, float b) {
  return b < a ? b : a;
}
template <typename T>
__device__ __forceinline__ T sel3(const T (&v)[3], int p) {
  return p == 0 ? v[0] : (p == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __noinline__ void fail(int* state, int ticket) {
  atomicCAS(state + 1, 0, ticket + 1);
  __threadfence_system();
  __trap();
}

// xGetICRate of _rdoq_batch.ic_rate: the rate of level lv, plus the sign
__device__ __forceinline__ float ic_rate(int lv, int base, int rice,
                                         int c1_idx, int c2_idx, float one0,
                                         float one1, float abs0,
                                         float abs1) {
  float rate;
  if (lv >= base) {
    const int sym = lv - base;
    const int three_rice = 3 << rice;
    float r;
    if (sym < three_rice) {
      r = __int2float_rn(((sym >> rice) + 1 + rice) << 15);
    } else {
      const int t = imax(sym - three_rice, 0) + (1 << rice);
      const int ln = (32 - __clz(t)) - 1;
      r = __int2float_rn((3 + ln + 1 - rice + ln) << 15);
    }
    const float extra =
        c1_idx < 8 ? __fadd_rn(one1, c2_idx < 1 ? abs1 : 0.0f) : 0.0f;
    rate = __fadd_rn(r, extra);
  } else if (lv == 1) {
    rate = one0;
  } else if (lv == 2) {
    rate = __fadd_rn(one1, abs0);
  } else {
    rate = 0.0f;
  }
  return __fadd_rn(rate, 32768.0f);
}

// The add trees of two arrays over [0, n) at once (n a power of two),
// pairing x[i] with x[i + h] as h halves: element i lives in thread
// i % NT's slot i / NT (v0, v1).  The levels with h >= NT pair a thread's
// own slots; then the live elements, one a thread, go through shared
// memory (buf0, buf1) down to 32, and warp 0's lanes do the last levels
// by shuffles.  Thread 0 gets the roots (r0, r1).  Every thread calls it.
template <int NT, int PER_T>
__device__ __forceinline__ void tree_sum2(float (&v0)[PER_T],
                                          float (&v1)[PER_T], int n,
                                          float* buf0, float* buf1, int tid,
                                          float& r0, float& r1) {
#pragma unroll
  for (int per = PER_T; per > 1; per >>= 1) {
#pragma unroll
    for (int q = 0; q < per / 2; ++q) {
      v0[q] = __fadd_rn(v0[q], v0[q + per / 2]);
      v1[q] = __fadd_rn(v1[q], v1[q + per / 2]);
    }
  }
  int live = n < NT ? n : NT;
  if (live > 32) {
    if (tid < live) {
      buf0[tid] = v0[0];
      buf1[tid] = v1[0];
    }
    __syncthreads();
    for (int h = live >> 1; h >= 32; h >>= 1) {
      if (tid < h) {
        buf0[tid] = __fadd_rn(buf0[tid], buf0[tid + h]);
        buf1[tid] = __fadd_rn(buf1[tid], buf1[tid + h]);
      }
      __syncthreads();
    }
    live = 32;
    if (tid < 32) {
      v0[0] = buf0[tid];
      v1[0] = buf1[tid];
    }
  }
  if (tid < 32) {
    float x0 = v0[0], x1 = v1[0];
    for (int h = live >> 1; h >= 1; h >>= 1) {
      const float o0 = __shfl_down_sync(0xffffffffu, x0, h);
      const float o1 = __shfl_down_sync(0xffffffffu, x1, h);
      if (tid < h) {
        x0 = __fadd_rn(x0, o0);
        x1 = __fadd_rn(x1, o1);
      }
    }
    r0 = x0;
    r1 = x1;
  }
}

// Hillis-Steele inclusive suffix sums of a[0, n) and of c[0, m) (m <= n)
// in one loop; a (c) ends as the buffer that holds them, b (e) the other
template <int NT>
__device__ __forceinline__ void suffix_sums(float*& a, float*& b, int n,
                                            float*& c, float*& e, int m,
                                            int tid) {
  for (int d = 1; d < n; d <<= 1) {
    for (int i = tid; i < n; i += NT)
      b[i] = i < n - d ? __fadd_rn(a[i], a[i + d]) : a[i];
    if (d < m)
      for (int i = tid; i < m; i += NT)
        e[i] = i < m - d ? __fadd_rn(c[i], c[i + d]) : c[i];
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
    if (d < m) {
      t = c;
      c = e;
      e = t;
    }
  }
}

// One item: the TU of class CI on plane p (0 luma, 1 Cb, 2 Cr).
template <int CI, int NT>
__device__ __forceinline__ void run_item(const FrameArgs& a, const int ticket,
                                         const int (&it)[kItemInts],
                                         unsigned char* raw, int& staged) {
  constexpr int S = cls_size(CI);
  constexpr bool LUMA = CI < 4;
  constexpr int P = S * S, NCG = P / 16;
  constexpr int LOG2 = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
  constexpr int PER_T = (P + NT - 1) / NT;
  constexpr int L1 = 4 * S + 1;            // c = [rl, ra[1:]] per filter
  constexpr int UNIT = LUMA ? 4 : 2;
  constexpr int NU = S / UNIT;             // units a side
  Smem<S>& sm = *reinterpret_cast<Smem<S>*>(raw);
  const ClassTabs& ct = a.cls[CI];

  const int tid = threadIdx.x;
  const int x0 = it[0], y0 = it[1], lo = it[2], hi = it[3];
  const int mode = it[4], sc = it[5], kind = it[6], lv_off = it[7];
  const int p = LUMA ? 0 : ((kind >> 4) & 3);
  const bool real = ((kind >> 6) & 1) != 0;
  const int hgt = sel3(a.rec_h, p), wid = sel3(a.rec_w, p);
  const int bit_inc = a.bit_inc, max_val = a.max_val;
  short* const rec = sel3(a.rec, p);
  if (!ct.basis || (a.use_rdoq && !ct.sig0p) || lv_off < 0
      || lv_off > a.n_lv - P || (!LUMA && p == 0))
    fail(a.state, ticket);
  // lanes of a warp hold consecutive positions of a `for (i = tid; i < P;
  // i += NT)` loop: a CG's 16 positions are a half-warp, and every lane of
  // a warp runs each pass (only the 4x4 classes leave lanes 16-31 out)
  const unsigned wmask = P >= 32 ? 0xffffffffu : 0xffffu;
  const int lane = tid & 31, half16 = lane & 16, n16 = lane & 15;

  // ---- stage the class's bases and scans (the previous item's reads of
  // the buffer passed the item loop's barrier) ----
  if (staged != CI) {
    for (int i = tid; i < S * S; i += NT) {
      const int v = __ldg(ct.basis + i);
      sm.basis[i] = v;
      sm.basis_t[(i & (S - 1)) * S + (i >> LOG2)] = v;
    }
    for (int i = tid; i < 3 * P; i += NT) sm.scan[i] = __ldg(ct.scan + i);
    staged = CI;
  }

  // ---- wait until the units under [lo, hi] are written ----
  {
    bool waited = false;
    if (real && lo <= hi && tid < 4 * NU + 1) {
      const int g = tid;
      if (g >= lo / UNIT && g <= hi / UNIT) {
        const int gx = x0 / UNIT, gy = y0 / UNIT;
        int nx, ny;
        if (g < 2 * NU) {
          nx = gx - 1;
          ny = gy + (2 * NU - 1 - g);
        } else if (g == 2 * NU) {
          nx = gx - 1;
          ny = gy - 1;
        } else {
          nx = gx + (g - 2 * NU - 1);
          ny = gy - 1;
        }
        // a unit outside the map has no writer
        if (nx >= 0 && ny >= 0 && nx < a.map_w && ny < a.map_h) {
          const int* f = a.ready + ((long long)p * a.map_h + ny) * a.map_w
                         + nx;
          int polls = 0, ns = 32;
          while (ld_acquire(f) == 0) {
            waited = true;
            if (++polls > kMaxPolls) fail(a.state, ticket);
            __nanosleep(ns);
            if (ns < 256) ns <<= 1;
          }
        }
      }
    }
    if (__syncthreads_or(waited) && tid == 0) atomicAdd(a.state + 2, 1);
  }

  // ---- the reference line: left column bottom-up, the corner `unit`
  // times, the top row; reads clamped into the plane, through L2.  HM's
  // substitution over [lo, hi] (below lo line[lo], above hi line[hi]) is
  // a clamp of the line index, so ra and rl are read from the plane at
  // once ----
  {
    const bool none = lo > hi;
    const int yc = imin(y0, hgt - 1), xc = imin(x0, wid - 1);
    for (int k = tid; k < 2 * (2 * S + 1); k += NT) {
      const int j = k >> 1;
      // ra[j] = line[2S + unit + j - 1], rl[j] = line[2S - j]; both
      // start at the corner line[2S]
      int i = j == 0 ? 2 * S : ((k & 1) ? 2 * S - j : 2 * S + UNIT + j - 1);
      int v = 1 << (7 + bit_inc);
      if (!none) {
        i = iclamp(i, lo, hi);
        int at;
        if (i < 2 * S)
          at = imin(y0 + 2 * S - i, hgt - 1) * wid + xc;
        else if (i < 2 * S + UNIT)
          at = yc * wid + xc;
        else
          at = yc * wid + imin(x0 + 1 + (i - 2 * S - UNIT), wid - 1);
        v = __ldcg(rec + at);
      }
      if (k & 1)
        sm.rl[j] = v;
      else
        sm.ra[j] = v;
    }
  }
  __syncthreads();
  if (LUMA) {
    // the [1 2 1]-filtered lines (fast_intra._smooth)
    for (int j = tid; j <= 2 * S; j += NT) {
      int fa, fl;
      if (j == 0) {
        fa = (sm.rl[1] + 2 * sm.ra[0] + sm.ra[1] + 2) >> 2;
        fl = (sm.ra[1] + 2 * sm.rl[0] + sm.rl[1] + 2) >> 2;
      } else if (j == 2 * S) {
        fa = sm.ra[j];
        fl = sm.rl[j];
      } else {
        fa = (sm.ra[j - 1] + 2 * sm.ra[j] + sm.ra[j + 1] + 2) >> 2;
        fl = (sm.rl[j - 1] + 2 * sm.rl[j] + sm.rl[j + 1] + 2) >> 2;
      }
      sm.raf[j] = fa;
      sm.rlf[j] = fl;
    }
  }
  if (tid < 32) {
    // the DC sum in warp 0 (integers: exact in any order)
    int sum = 0;
    for (int j = 1 + tid; j <= S; j += 32) sum += sm.ra[j] + sm.rl[j];
    for (int h = 16; h >= 1; h >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, h);
    if (tid == 0) sm.dc = (sum + S) / (2 * S);
  }
  __syncthreads();

  // ---- prediction (_predict_batch) and the residual ----
  int* X = sm.w[0];
  {
    const bool filt_pl = LUMA && S >= 8;      // INTRA_FILTER_THRESH
    const int* pra = filt_pl ? sm.raf : sm.ra;
    const int* prl = filt_pl ? sm.rlf : sm.rl;
    const int m = iclamp(mode - 2, 0, 32);
    const int* ia = ct.plan + (0 * 33 + m) * P;
    const int* ib = ct.plan + (1 * 33 + m) * P;
    const int* fr = ct.plan + (2 * 33 + m) * P;
    const int dc = sm.dc;
    const short* org = sel3(a.org, p);
    const int ow = sel3(a.org_w, p), oh = sel3(a.org_h, p);
    const bool src_in = real && x0 >= 0 && y0 >= 0 && x0 + S <= ow
                        && y0 + S <= oh;
    for (int e = tid; e < P; e += NT) {
      const int y = e >> LOG2, x = e & (S - 1);
      int v;
      if (mode == 0) {
        const int top = pra[1 + x], left = prl[1 + y];
        const int bl = prl[1 + S], tr = pra[1 + S];
        v = ((left << LOG2) + S + (x + 1) * (tr - left) + (top << LOG2)
             + (y + 1) * (bl - top)) >> (LOG2 + 1);
      } else if (mode == 1) {
        v = dc;
        if (LUMA) {
          if (y == 0 && x == 0)
            v = (sm.ra[1] + sm.rl[1] + 2 * dc + 2) >> 2;
          else if (y == 0)
            v = (sm.ra[1 + x] + 3 * dc + 2) >> 2;
          else if (x == 0)
            v = (sm.rl[1 + y] + 3 * dc + 2) >> 2;
        }
      } else {
        // c = [rl, ra[1:]], then for luma [rl_f, ra_f[1:]]
        int c[2];
        const int at[2] = {__ldg(ia + e), __ldg(ib + e)};
        for (int q = 0; q < 2; ++q) {
          int i = at[q];
          const bool f = LUMA && i >= L1;
          if (f) i -= L1;
          c[q] = i <= 2 * S ? (f ? sm.rlf[i] : sm.rl[i])
                            : (f ? sm.raf[i - 2 * S] : sm.ra[i - 2 * S]);
        }
        const int w = __ldg(fr + e);
        v = ((32 - w) * c[0] + w * c[1] + 16) >> 5;
        if (LUMA && mode == 26 && x == 0)
          v = iclamp(v + ((sm.rl[1 + y] - sm.rl[0]) >> 1), 0, max_val);
        if (LUMA && mode == 10 && y == 0)
          v = iclamp(v + ((sm.ra[1 + x] - sm.ra[0]) >> 1), 0, max_val);
      }
      sm.pred[e] = v;
      const int src = src_in ? (int)__ldg(org + (y0 + y) * ow + x0 + x) : 0;
      X[e] = src - v;
    }
  }
  __syncthreads();

  // ---- forward transform (ops.tq.forward_transform): the first pass
  // writes its output transposed (T1T[j][k] = T1[k][j]), so that in both
  // passes a warp's lanes read consecutive words or one broadcast word ----
  {
    int* T1T = sm.w[1];
    const int sh1 = LOG2 - 1 + bit_inc;
    for (int e = tid; e < P; e += NT) {
      const int j = e >> LOG2, k = e & (S - 1);
      int acc = 0;
#pragma unroll 8
      for (int n = 0; n < S; ++n) acc += sm.basis_t[n * S + k] * X[j * S + n];
      T1T[e] = (acc + (1 << (sh1 - 1))) >> sh1;
    }
    __syncthreads();
    const int sh2 = LOG2 + 6;
    for (int e = tid; e < P; e += NT) {
      const int kf = e >> LOG2, j = e & (S - 1);
      int acc = 0;
#pragma unroll 8
      for (int n = 0; n < S; ++n) acc += sm.basis[kf * S + n] * T1T[n * S + j];
      sm.co[e] = (acc + (1 << (sh2 - 1))) >> sh2;
    }
  }
  __syncthreads();

  const int qp = sel3(a.qp, p), per = qp / 6, rem = qp % 6;
  const int ts = 15 - (8 + bit_inc) - LOG2;    // transform shift
  const int ss = iclamp((sc & 3) - 1, 0, 2);   // scan table
  const int* scan = sm.scan + ss * P;

  if (!a.use_rdoq) {
    // ---- plain quantisation (ops.tq.quant, intra rounding) ----
    const int qb = 14 + per + ts;
    const int add = 171 << (qb - 9);
    const int qs = __ldg(a.qscale + rem);
    for (int e = tid; e < P; e += NT) {
      const int c = sm.co[e];
      const int tmp = (c < 0 ? -c : c) * qs;
      const int level = (tmp + add) >> qb;
      sm.du[e] = (tmp - (level << qb)) >> (qb - 8);
      const int sg = c > 0 ? 1 : (c < 0 ? -1 : 0);
      sm.lev[e] = iclamp(sg * level, -32768, 32767);
    }
  } else {
    // ---- RDOQ (_rdoq_batch), in scan order ----
    // LD, LVL, C0, CC, CS live to the end; F1 and F2 are the scans'
    // scratch
    int* LD = sm.w[0];
    int* LVL = sm.w[1];
    float* C0 = reinterpret_cast<float*>(sm.w[2]);
    float* CC = reinterpret_cast<float*>(sm.w[3]);
    float* CS = reinterpret_cast<float*>(sm.w[4]);
    float* F1 = reinterpret_cast<float*>(sm.w[5]);
    float* F2 = reinterpret_cast<float*>(sm.lev);
    const int uiq = __ldg(a.qscale + rem);
    const int qbits = 14 + per + ts;
    const int half = 1 << (qbits - 1);
    const float es = p == 0 ? a.es[0][LOG2 - 2]
                   : (p == 1 ? a.es[1][LOG2 - 2] : a.es[2][LOG2 - 2]);
    const float lam = sel3(a.lam, p);
    const int cbf_ctx = iclamp(LUMA ? ((sc >> 2) == 0 ? 1 : 0) : 5 + (sc >> 2),
                               0, 15);
    for (int g = tid; g <= NCG; g += NT) {
      sm.cg_has[g] = 0;
      sm.cg_ge2[g] = 0;
      sm.dec[g] = 0;
    }
    if (tid == 0) {
      sm.last = -1;
      sm.gt1 = 0;
      sm.pick = -1;
    }
    __syncthreads();
    for (int i = tid; i < P; i += NT) {
      const int c = sm.co[scan[i]];
      const int ld = (c < 0 ? -c : c) * uiq;
      LD[i] = ld;
      const int mab = (ld + half) >> qbits;
      const unsigned b1 = __ballot_sync(wmask, mab >= 1);
      const unsigned b2 = __ballot_sync(wmask, mab >= 2);
      if (n16 == 0) {
        sm.cg_has[i >> 4] = ((b1 >> half16) & 0xffffu) != 0;
        sm.cg_ge2[i >> 4] = ((b2 >> half16) & 0xffffu) != 0;
      }
      // lane 0 holds the warp's first position
      if (lane == 0 && b1) atomicMax(&sm.last, i + 31 - __clz(b1));
    }
    __syncthreads();
    const int last = sm.last;
    const int cg_of_last = imax(last, 0) >> 4;
    // level decision (xGetCodedLevel) with the proxy context chain
    for (int i = tid; i < P; i += NT) {
      const int g = i >> 4;
      // the CG's later positions: lanes n16 + 1 .. 15 of the half-warp
      const int mi = (LD[i] + half) >> qbits;
      const unsigned later = (0xfffeu << n16) & 0xffffu;
      const int n1 = __popc((__ballot_sync(wmask, mi >= 1) >> half16) & later);
      const int n2 = __popc((__ballot_sync(wmask, mi >= 2) >> half16) & later);
      const int n3 = __popc((__ballot_sync(wmask, mi > 3) >> half16) & later);
      const int c1_idx = imin(n1, 8), c2_idx = imin(n2, 1);
      const int c1 = n2 > 0 ? 0 : imin(1 + (n1 - n2), 3);
      const int rice = imin(n3, 4);
      const int prev_ge2 = g + 1 < NCG ? sm.cg_ge2[g + 1] : 0;
      const int prev_valid = g + 1 <= cg_of_last;
      const int ctx_set = (LUMA ? 2 : 0) * (g > 0) + (prev_ge2 & prev_valid);
      const int ctx_one = 4 * ctx_set + c1;
      const int ctx_abs = ctx_set + imin(n2, 2);
      const int patt = sm.cg_has[__ldg(ct.rgt + ss * NCG + g)]
                       + 2 * sm.cg_has[__ldg(ct.low + ss * NCG + g)];
      const float sig0 = __ldg(ct.sig0p + (ss * 4 + patt) * P + i);
      const float sig1 = __ldg(ct.sig1p + (ss * 4 + patt) * P + i);
      const int base = c1_idx < 8 ? 2 + (c2_idx < 1) : 1;
      const float one0 = __ldg(ct.one0 + ctx_one);
      const float one1 = __ldg(ct.one1 + ctx_one);
      const float abs0 = __ldg(ct.abs0 + ctx_abs);
      const float abs1 = __ldg(ct.abs1 + ctx_abs);
      const int ld = LD[i];
      const float ldf = __int2float_rn(ld);
      const float cost0 = __fmul_rn(__fmul_rn(ldf, ldf), es);
      const float lam_sig0 = __fmul_rn(lam, sig0);
      const float lam_sig1 = __fmul_rn(lam, sig1);
      const bool is_last = i == last, in_coded = i <= last;
      const float sig_term = is_last ? 0.0f : lam_sig1;
      const int m = (ld + half) >> qbits;
      float cm = kBig, cm1 = kBig, czero = kBig;
      if (m >= 1) {
        const float err = __int2float_rn(ld - (m << qbits));
        cm = __fadd_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(err, err), es),
                      __fmul_rn(lam, ic_rate(m, base, rice, c1_idx, c2_idx,
                                             one0, one1, abs0, abs1))),
            sig_term);
      }
      if (m >= 2) {
        const int lv = imax(m - 1, 1);
        const float err = __int2float_rn(ld - (lv << qbits));
        cm1 = __fadd_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(err, err), es),
                      __fmul_rn(lam, ic_rate(lv, base, rice, c1_idx, c2_idx,
                                             one0, one1, abs0, abs1))),
            sig_term);
      }
      if (m < 3 && !is_last) czero = __fadd_rn(cost0, lam_sig0);
      // HM order: zero baseline, then m, then m - 1, strict <
      int lvl = 0;
      float best = czero;
      if (cm < best) lvl = m;
      best = fmin2(best, cm);
      if (cm1 < best) lvl = m - 1;
      best = fmin2(best, cm1);
      if (!in_coded) lvl = 0;
      LVL[i] = lvl;
      C0[i] = cost0;
      CC[i] = in_coded ? best : cost0;
      CS[i] = in_coded ? (is_last ? 0.0f : (lvl > 0 ? lam_sig1 : lam_sig0))
                       : 0.0f;
    }
    __syncthreads();
    // CG sums: a CG on a half-warp, the add tree of its 16 positions
    // pairing lane n with lane n + h (h = 8, 4, 2, 1)
    for (int i = tid; i < P; i += NT) {
      const bool nz = LVL[i] > 0;
      float sa = CS[i];
      float sb = nz ? __fsub_rn(CC[i], CS[i]) : 0.0f;
      float sc0 = nz ? C0[i] : 0.0f;
      for (int h = 8; h >= 1; h >>= 1) {
        const float oa = __shfl_down_sync(wmask, sa, h, 16);
        const float ob = __shfl_down_sync(wmask, sb, h, 16);
        const float oc = __shfl_down_sync(wmask, sc0, h, 16);
        if (n16 < h) {
          sa = __fadd_rn(sa, oa);
          sb = __fadd_rn(sb, ob);
          sc0 = __fadd_rn(sc0, oc);
        }
      }
      const unsigned nzm = (__ballot_sync(wmask, nz) >> half16) & 0xffffu;
      if (n16 == 0) {
        const int g = i >> 4;
        sm.dec[g] = nzm != 0;
        sm.nnz[g] = __popc(nzm & 0xfffeu);
        sm.sum_sig[g] = sa;
        sm.coded[g] = sb;
        sm.unc[g] = sc0;
        sm.sigp0[g] = CS[i];
      }
    }
    __syncthreads();
    // CG zero-out (sigCoeffGroupFlag RD)
    for (int g = tid; g < NCG; g += NT) {
      const bool cg_in = g <= cg_of_last, is_lastcg = g == cg_of_last;
      const bool dec = sm.dec[g] != 0;
      const bool eligible = cg_in && !is_lastcg && g != 0 && dec;
      const bool adj = eligible && sm.nnz[g] == 0;
      const float ssa = adj ? __fsub_rn(sm.sum_sig[g], sm.sigp0[g])
                            : sm.sum_sig[g];
      const int ctx = sm.dec[__ldg(ct.rgt + ss * NCG + g)]
                      | sm.dec[__ldg(ct.low + ss * NCG + g)];
      const float lc0 = __fmul_rn(lam, ct.cgb[ctx ? 1 : 0][0]);
      const float lc1 = __fmul_rn(lam, ct.cgb[ctx ? 1 : 0][1]);
      const float zc = __fsub_rn(
          __fsub_rn(__fadd_rn(lc0, sm.unc[g]), sm.coded[g]), ssa);
      const bool zeroed = eligible && zc < lc1;
      const bool empty = cg_in && !is_lastcg && g != 0 && !dec;
      const bool drop = zeroed || empty;
      sm.drop[g] = drop;
      const float ccs =
          cg_in ? (drop ? lc0 : (eligible && !zeroed ? lc1 : 0.0f)) : 0.0f;
      sm.ccs[g] = ccs;
      sm.cga[g] = adj ? sm.sigp0[g] : 0.0f;
      sm.cgb[g] = ccs;
    }
    __syncthreads();
    // base_final and best0 (TComTrQuant.cpp:2096-2177): the add trees over
    // the TU (cost_coeff, cost0) and over its CGs (cga, cgb), each pair in
    // one pass
    {
      float v0[PER_T], v1[PER_T];
#pragma unroll
      for (int q = 0; q < PER_T; ++q) {
        const int i = tid + q * NT;
        v0[q] = 0.0f;
        v1[q] = 0.0f;
        if (i < P) {
          if (sm.drop[i >> 4]) {
            LVL[i] = 0;
            CC[i] = C0[i];
            CS[i] = 0.0f;
          }
          v0[q] = CC[i];
          v1[q] = C0[i];
        }
      }
      float s1 = 0.0f, f2 = 0.0f, ga = 0.0f, gb = 0.0f;
      tree_sum2<NT, PER_T>(v0, v1, P, F1, F2, tid, s1, f2);
      float c0[1] = {tid < NCG ? sm.cga[tid] : 0.0f};
      float c1[1] = {tid < NCG ? sm.cgb[tid] : 0.0f};
      tree_sum2<NT, 1>(c0, c1, NCG, sm.red[0], sm.red[1], tid, ga, gb);
      if (tid == 0) {
        sm.bf = __fadd_rn(__fadd_rn(__fsub_rn(s1, ga), gb),
                          __fmul_rn(lam, __ldg(ct.cbf1 + cbf_ctx)));
        sm.best0 = __fadd_rn(f2, __fmul_rn(lam, __ldg(ct.cbf0 + cbf_ctx)));
      }
    }
    __syncthreads();
    // the suffix sums of d (made exclusive below) and of the CGs' costs
    for (int i = tid; i < P; i += NT) {
      const int lvl = LVL[i];
      F1[i] = i <= last ? (lvl > 0 ? __fsub_rn(CC[i], C0[i]) : CS[i]) : 0.0f;
      const unsigned b = __ballot_sync(wmask, lvl > 1);
      if (lane == 0 && b) atomicMax(&sm.gt1, i + 31 - __clz(b));
    }
    for (int g = tid; g < NCG; g += NT) sm.cga[g] = sm.ccs[g];
    __syncthreads();
    float *suf = F1, *suf_o = F2, *sufcg = sm.cga, *sufcg_o = sm.cgc;
    suffix_sums<NT>(suf, suf_o, P, sufcg, sufcg_o, NCG, tid);
    const float bf = sm.bf, best0 = sm.best0;
    const int gt1 = sm.gt1;
    float tot[PER_T];
    float tmin = kBig;
#pragma unroll
    for (int q = 0; q < PER_T; ++q) {
      const int i = tid + q * NT;
      tot[q] = kBig;
      if (i < P) {
        const int lvl = LVL[i];
        const bool in_coded = i <= last;
        const float d =
            in_coded ? (lvl > 0 ? __fsub_rn(CC[i], C0[i]) : CS[i]) : 0.0f;
        const float sufd = __fsub_rn(suf[i], d);
        const float t = __fsub_rn(
            __fadd_rn(__fsub_rn(__fsub_rn(bf, sufcg[i >> 4]), sufd),
                      __fmul_rn(lam, __ldg(ct.rlv + ss * P + i))),
            CS[i]);
        tot[q] = lvl > 0 && in_coded && i >= gt1 ? t : kBig;
        tmin = fmin2(tmin, tot[q]);
      }
    }
    // the least total (exact in any order: each warp's, then theirs),
    // then the largest position that has it
    for (int h = 16; h >= 1; h >>= 1)
      tmin = fmin2(tmin, __shfl_xor_sync(0xffffffffu, tmin, h));
    if (lane == 0) sm.wmin[tid >> 5] = tmin;
    __syncthreads();
    for (int w = 0; w < NT / 32; ++w) tmin = fmin2(tmin, sm.wmin[w]);
#pragma unroll
    for (int q = 0; q < PER_T; ++q) {
      const int i = tid + q * NT;
      if (i < P && tot[q] == tmin) atomicMax(&sm.pick, i);
    }
    __syncthreads();
    const int last_p1 = tmin < best0 && last >= 0 ? sm.pick + 1 : 0;
    for (int i = tid; i < P; i += NT) {
      const int lvl = i < last_p1 ? LVL[i] : 0;
      const int pos = scan[i];
      sm.du[pos] = i <= last ? (LD[i] - (lvl << qbits)) >> (qbits - 8) : 0;
      sm.lev[pos] = lvl * (sm.co[pos] < 0 ? -1 : 1);
    }
  }
  __syncthreads();

  if (a.sign_hide) {
    // ---- sign-bit hiding (_sbh_batch): a CG on a half-warp ----
    if (tid == 0) sm.last_cg = -1;
    __syncthreads();
    for (int i = tid; i < P; i += NT) {
      const unsigned b =
          (__ballot_sync(wmask, sm.lev[scan[i]] != 0) >> half16) & 0xffffu;
      if (n16 == 0 && b) atomicMax(&sm.last_cg, i >> 4);
    }
    __syncthreads();
    const int last_cg = sm.last_cg;
    for (int i = tid; i < P; i += NT) {
      const int pos = scan[i];
      const int lv = sm.lev[pos], sr = sm.co[pos], dd = sm.du[pos];
      const unsigned nzm =
          (__ballot_sync(wmask, lv != 0) >> half16) & 0xffffu;
      const int first = nzm ? __ffs(nzm) - 1 : 99;
      const int lastn = nzm ? 31 - __clz(nzm) : -1;
      // the sum over [first, lastn] is the sum over the CG: 0 elsewhere
      int csum = lv;
      for (int h = 8; h >= 1; h >>= 1)
        csum += __shfl_xor_sync(wmask, csum, h, 16);
      const int signbit =
          __shfl_sync(wmask, lv, imin(first, 15), 16) > 0 ? 0 : 1;
      const int start_n = (i >> 4) == last_cg ? lastn : 15;
      const bool need = lastn - first >= 4 && signbit != (csum & 1);
      int cost, ch;
      if (lv != 0) {
        const bool pin = n16 == first && (lv == 1 || lv == -1);
        cost = dd > 0 ? -dd : (pin ? kSbhInf : dd);
        ch = dd > 0 ? 1 : (pin ? 0 : -1);
      } else {
        const bool bad = n16 < first && (sr >= 0 ? 0 : 1) != signbit;
        cost = bad ? kSbhInf : -dd;
        ch = bad ? 0 : 1;
      }
      if (n16 > start_n) cost = kSbhInf;
      // distinct keys: the largest n among equal costs
      const int key = cost * 16 + (15 - n16);
      int kmin = key;
      for (int h = 8; h >= 1; h >>= 1)
        kmin = imin(kmin, __shfl_xor_sync(wmask, kmin, h, 16));
      if (need && key == kmin) {
        if (lv == 32767 || lv == -32768) ch = -1;
        sm.lev[pos] = lv + (sr >= 0 ? ch : -ch);
      }
    }
    __syncthreads();
  }

  // ---- the level stack, dequant, inverse transform, recon ----
  {
    short* lvo = a.lv + lv_off;
    int* D = sm.w[0];
    int* T2 = sm.w[1];
    const int dsh = LOG2 + bit_inc - 1;
    const int scale = __ldg(a.iqscale + rem) << per;
    for (int e = tid; e < P; e += NT) {
      const int l = sm.lev[e];
      lvo[e] = (short)l;
      const int q = iclamp(l, -32768, 32767);
      D[e] = iclamp((q * scale + (1 << (dsh - 1))) >> dsh, -32768, 32767);
    }
    __syncthreads();
    for (int e = tid; e < P; e += NT) {
      const int j = e >> LOG2, kx = e & (S - 1);
      int acc = 0;
#pragma unroll 8
      for (int n = 0; n < S; ++n) acc += sm.basis[n * S + kx] * D[n * S + j];
      T2[e] = iclamp((acc + 64) >> 7, -32768, 32767);
    }
    __syncthreads();
    const int sh = 12 - bit_inc;
    const long long plane_n = (long long)hgt * wid;
    for (int e = tid; e < P; e += NT) {
      const int j = e >> LOG2, kx = e & (S - 1);
      int acc = 0;
#pragma unroll 8
      for (int n = 0; n < S; ++n) acc += sm.basis[n * S + kx] * T2[n * S + j];
      const int r = iclamp((acc + (1 << (sh - 1))) >> sh, -32768, 32767);
      const int v = iclamp(sm.pred[e] + r, 0, max_val);
      const long long at = (long long)(y0 + 1 + j) * wid + (x0 + 1 + kx);
      if (at >= 0 && at < plane_n) rec[at] = (short)v;
    }
  }

  // ---- flag the TU's own units, after every recon store ----
  __syncthreads();
  if (real && tid < NU * NU) {
    const int ux = x0 / UNIT + tid % NU, uy = y0 / UNIT + tid / NU;
    if (ux >= 0 && uy >= 0 && ux < a.map_w && uy < a.map_h) {
      __threadfence();
      st_release(a.ready + ((long long)p * a.map_h + uy) * a.map_w + ux, 1);
    }
  }
}

__global__ void __launch_bounds__(kBlock) apply_frame(FrameArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ticket;
  int staged = -1;
  for (;;) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(a.state, 1);
    __syncthreads();
    const int t = s_ticket;
    if (t >= a.n_items) return;
    int it[kItemInts];
#pragma unroll
    for (int k = 0; k < kItemInts; ++k)
      it[k] = __ldg(a.items + (long long)t * kItemInts + k);
    switch (it[6] & 15) {
      case 0: run_item<0, kBlock>(a, t, it, smem, staged); break;
      case 1: run_item<1, kBlock>(a, t, it, smem, staged); break;
      case 2: run_item<2, kBlock>(a, t, it, smem, staged); break;
      case 3: run_item<3, kBlock>(a, t, it, smem, staged); break;
      case 4: run_item<4, kBlock>(a, t, it, smem, staged); break;
      case 5: run_item<5, kBlock>(a, t, it, smem, staged); break;
      case 6: run_item<6, kBlock>(a, t, it, smem, staged); break;
      default: fail(a.state, t);
    }
    // every read of s_ticket and of the shared buffer is done
    __syncthreads();
  }
}

int grid_of(int* grid) {
  // as many CTAs as can be resident, computed once a device
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!cached[dev]) {
    e = cudaFuncSetAttribute(apply_frame,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, apply_frame,
                                                      kBlock, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached[dev] = per_sm * sms;
  }
  *grid = cached[dev];
  return 0;
}

}  // namespace

// The frame kernel's CTAs that can be resident on the current device:
// its grid.
extern "C" int thevc_apply_grid(int* grid) { return grid_of(grid); }

// pointers (device): items, state, ready, rec Y/Cb/Cr, org Y/Cb/Cr, lv,
// qscale, iqscale, then for each of the 7 classes basis, plan, scan, rgt,
// low, sig0p, sig1p, rlv, one0, one1, abs0, abs1, cbf0, cbf1 (a class no
// item takes may be null, and so may the RDOQ tables without RDOQ);
// ints: rec_h[3], rec_w[3], org_h[3], org_w[3], map_h, map_w, n_lv,
// qp[3], bit_inc, max_val, sign_hide, use_rdoq; floats: lam[3],
// es[3][4], then the sigCG bits cgb[7][2][2]
extern "C" int thevc_apply_frame(const void* const* ptrs, const int* ints,
                                 const float* floats, int n_items,
                                 void* stream) {
  if (n_items < 0) return (int)cudaErrorInvalidValue;
  FrameArgs a;
  int i = 0;
  a.items = static_cast<const int*>(ptrs[i++]);
  a.state = static_cast<int*>(const_cast<void*>(ptrs[i++]));
  a.ready = static_cast<int*>(const_cast<void*>(ptrs[i++]));
  for (int p = 0; p < 3; ++p)
    a.rec[p] = static_cast<short*>(const_cast<void*>(ptrs[i++]));
  for (int p = 0; p < 3; ++p)
    a.org[p] = static_cast<const short*>(ptrs[i++]);
  a.lv = static_cast<short*>(const_cast<void*>(ptrs[i++]));
  a.qscale = static_cast<const int*>(ptrs[i++]);
  a.iqscale = static_cast<const int*>(ptrs[i++]);
  for (int c = 0; c < kClasses; ++c) {
    ClassTabs& t = a.cls[c];
    t.basis = static_cast<const int*>(ptrs[i++]);
    t.plan = static_cast<const int*>(ptrs[i++]);
    t.scan = static_cast<const int*>(ptrs[i++]);
    t.rgt = static_cast<const int*>(ptrs[i++]);
    t.low = static_cast<const int*>(ptrs[i++]);
    t.sig0p = static_cast<const float*>(ptrs[i++]);
    t.sig1p = static_cast<const float*>(ptrs[i++]);
    t.rlv = static_cast<const float*>(ptrs[i++]);
    t.one0 = static_cast<const float*>(ptrs[i++]);
    t.one1 = static_cast<const float*>(ptrs[i++]);
    t.abs0 = static_cast<const float*>(ptrs[i++]);
    t.abs1 = static_cast<const float*>(ptrs[i++]);
    t.cbf0 = static_cast<const float*>(ptrs[i++]);
    t.cbf1 = static_cast<const float*>(ptrs[i++]);
    if (t.basis && (!t.plan || !t.scan || !t.rgt || !t.low))
      return (int)cudaErrorInvalidValue;
  }
  if (!a.items && n_items) return (int)cudaErrorInvalidValue;
  if (!a.state || !a.ready || !a.lv || !a.qscale || !a.iqscale)
    return (int)cudaErrorInvalidValue;
  int k = 0;
  for (int p = 0; p < 3; ++p) a.rec_h[p] = ints[k++];
  for (int p = 0; p < 3; ++p) a.rec_w[p] = ints[k++];
  for (int p = 0; p < 3; ++p) a.org_h[p] = ints[k++];
  for (int p = 0; p < 3; ++p) a.org_w[p] = ints[k++];
  a.map_h = ints[k++];
  a.map_w = ints[k++];
  a.n_lv = ints[k++];
  for (int p = 0; p < 3; ++p) a.qp[p] = ints[k++];
  a.bit_inc = ints[k++];
  a.max_val = ints[k++];
  a.sign_hide = ints[k++];
  a.use_rdoq = ints[k++];
  a.n_items = n_items;
  for (int p = 0; p < 3; ++p) {
    if (!a.rec[p] || !a.org[p] || a.rec_h[p] <= 0 || a.rec_w[p] <= 0
        || (long long)a.rec_h[p] * a.rec_w[p] >= (1LL << 31)
        || a.org_h[p] < 0 || a.org_w[p] < 0)
      return (int)cudaErrorInvalidValue;
  }
  int f = 0;
  for (int p = 0; p < 3; ++p) a.lam[p] = floats[f++];
  for (int p = 0; p < 3; ++p)
    for (int s = 0; s < 4; ++s) a.es[p][s] = floats[f++];
  for (int c = 0; c < kClasses; ++c)
    for (int x = 0; x < 2; ++x)
      for (int b = 0; b < 2; ++b) a.cls[c].cgb[x][b] = floats[f++];
  int grid = 0;
  int rc = grid_of(&grid);
  if (rc) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(a.state, 0, 3 * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  apply_frame<<<grid, kBlock, kSmemBytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
