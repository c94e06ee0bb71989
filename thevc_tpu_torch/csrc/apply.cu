// The fast-RD device apply's class step on an NVIDIA Hopper card (sm_90a):
// for every record of one size class's window, and for both chroma planes
// of a chroma class, intra prediction from the evolving recon plane,
// forward transform, quantisation (RDOQ or plain) with sign-bit hiding,
// dequant, inverse transform and reconstruction, in one launch.
//
// Replaces the XLA function thevc_tpu/encoder/fast_apply.py:729
// _class_step (run per wave by _apply_body :818, a lax.fori_loop in one
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
//           record's stack row.
// RDOQ ranks float32 costs.  The plain form fixes their order: every sum
// an add tree pairing x[i] with x[i + h] as h halves, every suffix sum
// Hillis-Steele steps, every a + b * c two roundings, the CG zero-out and
// last-position totals left to right.  Here each float operation is one
// __fmul_rn / __fadd_rn / __fsub_rn (this source is also built with
// -fmad=false), the trees and scans run over shared memory with the same
// pairing, and a minimum is exact in any order; so the levels equal the
// plain form's on the CPU and on the card.  Ties break as there: strict <
// in the zero, m, m - 1 order, the largest scan position among equal last
// costs, the largest n among equal SBH costs.
// Integer ranges: residuals are below 2^(8 + bit_inc) in magnitude, so
// the forward first pass is below s * 90 * 2^(8 + bit_inc) and, after its
// shift of log2(s) - 1 + bit_inc, the second below (s * 90)^2 * 2^(9 -
// log2(s)) <= 2880^2 * 16 < 2^31 at every bit depth: int32 is exact.  The
// inverse passes read int16 values: below 2880 * 2^15 < 2^27.  The
// quantiser's |c| * scale, RDOQ's |c| * Q and max << qbits, and the
// dequant product at QP <= 63 stay below 2^31, as ops/tq.py notes; SBH's
// keys stay below 2^30 with its 2^26 sentinel.
//
// What bounds it on this card: latency.  A class step's bytes are some
// tens of KB (a window of records, their source windows and levels, the
// reference lines), and its operations a few million; a 1080p frame is
// 1276 dependent class steps, each a launch of a few microseconds, and
// inside one a CTA is a chain of about 40 barriers (the transforms, the
// RDOQ trees and scans, SBH).
//
// The design keeps a TU on one SM: grid (window records, planes), one CTA
// a record and plane, 32 threads at 4x4, 64 at 8x8, 256 at 16x16 and
// 32x32; the TU's prediction, coefficients, levels and RDOQ costs live in
// shared memory (under 48 KB at 32x32), the tables (bases, plans, scans,
// CG neighbours, quant scales, estBits) are read from device memory
// through the cache.  The window's start is read on the device
// (starts[*k]); the last CTA to finish advances *k and resets the done
// count, so a wave's step is one kernel node in a CUDA graph.
//
// Window records past the wave (sorted by wave, they follow its records)
// compute as in the plain form: they read no region that a record of the
// wave writes (a TU's wave is one more than the latest it reads), so the
// wave's records are exact; theirs are overwritten at their own wave.
// Padding records take the DC fill and write into the guard.
//
// The entry does not allocate or synchronise; it launches on the stream it
// is given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3e38f;       // "no candidate" cost (_rdoq_batch big)
constexpr int kSbhInf = 1 << 26;    // SBH's excluded cost (_sbh_batch inf)

struct PlaneArgs {
  short* rec;           // [hgt, wid] recon plane, one top/left padding row
  short* lv;            // [n_flat, s, s] level stack
  const short* wins;    // [n_flat, s, s] source windows
  int qp;               // scaled QP
  float lam;            // RDOQ lambda
  float err_scale;      // RDOQ error scale
};

struct StepArgs {
  // the class's records, wave-sorted and padded (int64 [n_flat])
  const long long* xs;
  const long long* ys;
  const long long* lo;
  const long long* hi;
  const long long* mode;
  const long long* scan;
  const long long* starts;   // window start of each active wave
  long long* k;              // [1] the next active wave
  unsigned int* done;        // [1] CTAs finished in this launch
  PlaneArgs plane[2];
  const int* basis;          // [s, s] T[k][n]
  const int* plan;           // [3][33][s*s] idx_a, idx_b, frac
  const int* scan_tab;       // [3][s*s] scan position -> raster
  const int* rgt;            // [3][ncg] right CG neighbour, ncg = none
  const int* low;            // [3][ncg] lower CG neighbour
  const int* qscale;         // [6]
  const int* iqscale;        // [6]
  const float* sig0p;        // [3][4][s*s]
  const float* sig1p;        // [3][4][s*s]
  const float* rlv;          // [3][s*s]
  const float* one0;         // [16] each
  const float* one1;
  const float* abs0;
  const float* abs1;
  const float* cbf0;
  const float* cbf1;
  float cgb[2][2];           // sigCG bits [context][bin]
  int hgt, wid;
  int luma, bit_inc, max_val, sign_hide, use_rdoq;
};

template <int S>
struct Cfg {
  static constexpr int P = S * S;
  static constexpr int NCG = P / 16;
  static constexpr int NT = S >= 16 ? 256 : (S == 8 ? 64 : 32);
  static constexpr int LOG2 = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
  static constexpr int PER_T = (P + NT - 1) / NT;
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int iclamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ float fmin2(float a, float b) {
  return b < a ? b : a;
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

// in place: buf[0] = the add tree over buf[0, n) (n a power of two)
template <int NT>
__device__ __forceinline__ void tree_sum(float* buf, int n, int tid) {
  for (int h = n >> 1; h >= 1; h >>= 1) {
    for (int i = tid; i < h; i += NT) buf[i] = __fadd_rn(buf[i], buf[i + h]);
    __syncthreads();
  }
}

// Hillis-Steele inclusive suffix sums of a[0, n); returns the buffer
// (a or b) that holds them
template <int NT>
__device__ __forceinline__ float* suffix_sum(float* a, float* b, int n,
                                             int tid) {
  for (int d = 1; d < n; d <<= 1) {
    for (int i = tid; i < n; i += NT)
      b[i] = i < n - d ? __fadd_rn(a[i], a[i + d]) : a[i];
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
  return a;
}

template <int S>
__global__ void __launch_bounds__(Cfg<S>::NT) apply_step(StepArgs a) {
  constexpr int P = Cfg<S>::P, NCG = Cfg<S>::NCG, NT = Cfg<S>::NT;
  constexpr int LOG2 = Cfg<S>::LOG2, PER_T = Cfg<S>::PER_T;
  constexpr int L1 = 4 * S + 1;            // c = [rl, ra[1:]] per filter

  __shared__ int s_pred[P];
  __shared__ int s_co[P];                  // coefficients, raster
  __shared__ int s_lev[P];                 // levels, raster
  __shared__ int s_du[P];                  // quant remainders, raster
  __shared__ int s_w[6][P];                // per-phase scratch
  __shared__ int s_line[4 * S + 4];
  __shared__ int s_ra[2 * S + 1], s_rl[2 * S + 1];
  __shared__ int s_raf[2 * S + 1], s_rlf[2 * S + 1];
  // per CG, slot NCG the "none" neighbour
  __shared__ int s_cg_has[NCG + 1], s_cg_ge2[NCG + 1], s_dec[NCG + 1];
  __shared__ int s_nnz[NCG], s_drop[NCG];
  __shared__ float s_sum_sig[NCG], s_coded[NCG], s_unc[NCG], s_sigp0[NCG];
  __shared__ float s_ccs[NCG], s_cga[NCG], s_cgb[NCG], s_cgc[NCG];
  __shared__ long long s_k;
  __shared__ int s_last, s_gt1, s_pick, s_last_p1, s_last_cg, s_dc;
  __shared__ float s_bf, s_best0;

  const int tid = threadIdx.x;
  const PlaneArgs& pa = a.plane[blockIdx.y];
  if (tid == 0) s_k = *a.k;
  __syncthreads();
  const long long kk = s_k;
  const long long idx = a.starts[kk] + blockIdx.x;
  const int x0 = (int)a.xs[idx], y0 = (int)a.ys[idx];
  const int lo = (int)a.lo[idx], hi = (int)a.hi[idx];
  const int mode = (int)a.mode[idx], sc = (int)a.scan[idx];
  const bool luma = a.luma != 0;
  const int unit = luma ? 4 : 2;
  const int len = 4 * S + unit;
  const int hgt = a.hgt, wid = a.wid;
  const int bit_inc = a.bit_inc, max_val = a.max_val;
  const short* rec = pa.rec;

  // ---- the reference line: left column bottom-up, the corner `unit`
  // times, the top row; reads clamped into the plane ----
  {
    const int yc = imin(y0, hgt - 1), xc = imin(x0, wid - 1);
    for (int i = tid; i < len; i += NT) {
      int v;
      if (i < 2 * S)
        v = rec[imin(y0 + 2 * S - i, hgt - 1) * wid + xc];
      else if (i < 2 * S + unit)
        v = rec[yc * wid + xc];
      else
        v = rec[yc * wid + imin(x0 + 1 + (i - 2 * S - unit), wid - 1)];
      s_line[i] = v;
    }
  }
  __syncthreads();
  {
    const bool none = lo > hi;
    const int vlo = none ? 0 : s_line[iclamp(lo, 0, len - 1)];
    const int vhi = none ? 0 : s_line[iclamp(hi, 0, len - 1)];
    __syncthreads();
    for (int i = tid; i < len; i += NT) {
      int v = s_line[i];
      if (none) {
        v = 1 << (7 + bit_inc);
      } else {
        if (i < lo) v = vlo;
        if (i > hi) v = vhi;
      }
      s_line[i] = v;
    }
  }
  __syncthreads();
  for (int j = tid; j <= 2 * S; j += NT) {
    s_ra[j] = j == 0 ? s_line[2 * S] : s_line[2 * S + unit + j - 1];
    s_rl[j] = j == 0 ? s_line[2 * S] : s_line[2 * S - j];
  }
  __syncthreads();
  if (luma) {
    // the [1 2 1]-filtered lines (fast_intra._smooth)
    for (int j = tid; j <= 2 * S; j += NT) {
      int fa, fl;
      if (j == 0) {
        fa = (s_rl[1] + 2 * s_ra[0] + s_ra[1] + 2) >> 2;
        fl = (s_ra[1] + 2 * s_rl[0] + s_rl[1] + 2) >> 2;
      } else if (j == 2 * S) {
        fa = s_ra[j];
        fl = s_rl[j];
      } else {
        fa = (s_ra[j - 1] + 2 * s_ra[j] + s_ra[j + 1] + 2) >> 2;
        fl = (s_rl[j - 1] + 2 * s_rl[j] + s_rl[j + 1] + 2) >> 2;
      }
      s_raf[j] = fa;
      s_rlf[j] = fl;
    }
  }
  if (tid == 0) {
    int sum = 0;
    for (int j = 1; j <= S; ++j) sum += s_ra[j] + s_rl[j];
    s_dc = (sum + S) / (2 * S);
  }
  __syncthreads();

  // ---- prediction (_predict_batch) ----
  {
    const bool filt_pl = luma && S >= 8;      // INTRA_FILTER_THRESH
    const int* pra = filt_pl ? s_raf : s_ra;
    const int* prl = filt_pl ? s_rlf : s_rl;
    const int m = iclamp(mode - 2, 0, 32);
    const int* ia = a.plan + (0 * 33 + m) * P;
    const int* ib = a.plan + (1 * 33 + m) * P;
    const int* fr = a.plan + (2 * 33 + m) * P;
    const int dc = s_dc;
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
        if (luma) {
          if (y == 0 && x == 0)
            v = (s_ra[1] + s_rl[1] + 2 * dc + 2) >> 2;
          else if (y == 0)
            v = (s_ra[1 + x] + 3 * dc + 2) >> 2;
          else if (x == 0)
            v = (s_rl[1 + y] + 3 * dc + 2) >> 2;
        }
      } else {
        // c = [rl, ra[1:]], then for luma [rl_f, ra_f[1:]]
        int c[2];
        const int at[2] = {ia[e], ib[e]};
        for (int q = 0; q < 2; ++q) {
          int i = at[q];
          const bool f = luma && i >= L1;
          if (f) i -= L1;
          c[q] = i <= 2 * S ? (f ? s_rlf[i] : s_rl[i])
                            : (f ? s_raf[i - 2 * S] : s_ra[i - 2 * S]);
        }
        const int w = fr[e];
        v = ((32 - w) * c[0] + w * c[1] + 16) >> 5;
        if (luma && mode == 26 && x == 0)
          v = iclamp(v + ((s_rl[1 + y] - s_rl[0]) >> 1), 0, max_val);
        if (luma && mode == 10 && y == 0)
          v = iclamp(v + ((s_ra[1 + x] - s_ra[0]) >> 1), 0, max_val);
      }
      s_pred[e] = v;
    }
  }
  __syncthreads();

  // ---- forward transform (ops.tq.forward_transform) ----
  const int* basis = a.basis;
  {
    int* X = s_w[0];
    int* T1 = s_w[1];
    const short* win = pa.wins + idx * P;
    for (int e = tid; e < P; e += NT) X[e] = (int)win[e] - s_pred[e];
    __syncthreads();
    const int sh1 = LOG2 - 1 + bit_inc;
    for (int e = tid; e < P; e += NT) {
      const int kf = e >> LOG2, j = e & (S - 1);
      int acc = 0;
      for (int n = 0; n < S; ++n) acc += basis[kf * S + n] * X[j * S + n];
      T1[e] = (acc + (1 << (sh1 - 1))) >> sh1;
    }
    __syncthreads();
    const int sh2 = LOG2 + 6;
    for (int e = tid; e < P; e += NT) {
      const int kf = e >> LOG2, j = e & (S - 1);
      int acc = 0;
      for (int n = 0; n < S; ++n) acc += basis[kf * S + n] * T1[j * S + n];
      s_co[e] = (acc + (1 << (sh2 - 1))) >> sh2;
    }
  }
  __syncthreads();

  const int qp = pa.qp, per = qp / 6, rem = qp % 6;
  const int ts = 15 - (8 + bit_inc) - LOG2;    // transform shift
  const int ss = iclamp((sc & 3) - 1, 0, 2);   // scan table
  const int* scan = a.scan_tab + ss * P;

  if (!a.use_rdoq) {
    // ---- plain quantisation (ops.tq.quant, intra rounding) ----
    const int qb = 14 + per + ts;
    const int add = 171 << (qb - 9);
    const int qs = a.qscale[rem];
    for (int e = tid; e < P; e += NT) {
      const int c = s_co[e];
      const int tmp = (c < 0 ? -c : c) * qs;
      const int level = (tmp + add) >> qb;
      s_du[e] = (tmp - (level << qb)) >> (qb - 8);
      const int sg = c > 0 ? 1 : (c < 0 ? -1 : 0);
      s_lev[e] = iclamp(sg * level, -32768, 32767);
    }
  } else {
    // ---- RDOQ (_rdoq_batch), in scan order ----
    // LD, LVL, C0, CC, CS live to the end; S1 and F2 (s_lev, written
    // only after RDOQ) are the trees' and scans' scratch
    int* LD = s_w[0];
    int* LVL = s_w[1];
    float* C0 = reinterpret_cast<float*>(s_w[2]);
    float* CC = reinterpret_cast<float*>(s_w[3]);
    float* CS = reinterpret_cast<float*>(s_w[4]);
    float* S1 = reinterpret_cast<float*>(s_w[5]);
    float* F2 = reinterpret_cast<float*>(s_lev);
    const int uiq = a.qscale[rem];
    const int qbits = 14 + per + ts;
    const int half = 1 << (qbits - 1);
    const float es = pa.err_scale, lam = pa.lam;
    const int cbf_ctx = iclamp(luma ? ((sc >> 2) == 0 ? 1 : 0) : 5 + (sc >> 2),
                               0, 15);
    for (int g = tid; g <= NCG; g += NT) {
      s_cg_has[g] = 0;
      s_cg_ge2[g] = 0;
      s_dec[g] = 0;
    }
    if (tid == 0) {
      s_last = -1;
      s_gt1 = 0;
      s_pick = -1;
    }
    __syncthreads();
    for (int i = tid; i < P; i += NT) {
      const int c = s_co[scan[i]];
      const int ld = (c < 0 ? -c : c) * uiq;
      LD[i] = ld;
      const int mab = (ld + half) >> qbits;
      if (mab > 0) atomicMax(&s_last, i);
      if (mab >= 1) atomicOr(&s_cg_has[i >> 4], 1);
      if (mab >= 2) atomicOr(&s_cg_ge2[i >> 4], 1);
    }
    __syncthreads();
    const int last = s_last;
    const int cg_of_last = imax(last, 0) >> 4;
    // level decision (xGetCodedLevel) with the proxy context chain
    for (int i = tid; i < P; i += NT) {
      const int g = i >> 4;
      int n1 = 0, n2 = 0, n3 = 0;
      for (int j = i + 1; j < (g + 1) * 16; ++j) {
        const int mj = (LD[j] + half) >> qbits;
        n1 += mj >= 1;
        n2 += mj >= 2;
        n3 += mj > 3;
      }
      const int c1_idx = imin(n1, 8), c2_idx = imin(n2, 1);
      const int c1 = n2 > 0 ? 0 : imin(1 + (n1 - n2), 3);
      const int rice = imin(n3, 4);
      const int prev_ge2 = g + 1 < NCG ? s_cg_ge2[g + 1] : 0;
      const int prev_valid = g + 1 <= cg_of_last;
      const int ctx_set = (luma ? 2 : 0) * (g > 0) + (prev_ge2 & prev_valid);
      const int ctx_one = 4 * ctx_set + c1;
      const int ctx_abs = ctx_set + imin(n2, 2);
      const int patt = s_cg_has[a.rgt[ss * NCG + g]]
                       + 2 * s_cg_has[a.low[ss * NCG + g]];
      const float sig0 = a.sig0p[(ss * 4 + patt) * P + i];
      const float sig1 = a.sig1p[(ss * 4 + patt) * P + i];
      const int base = c1_idx < 8 ? 2 + (c2_idx < 1) : 1;
      const float one0 = a.one0[ctx_one], one1 = a.one1[ctx_one];
      const float abs0 = a.abs0[ctx_abs], abs1 = a.abs1[ctx_abs];
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
    // CG sums (one thread a CG, the add tree of its 16 positions)
    for (int g = tid; g < NCG; g += NT) {
      float sa[16], sb[16], sc0[16];
      int dec = 0, nnz = 0;
      for (int n = 0; n < 16; ++n) {
        const int i = g * 16 + n;
        const bool nz = LVL[i] > 0;
        dec |= nz;
        if (n > 0) nnz += nz;
        sa[n] = CS[i];
        sb[n] = nz ? __fsub_rn(CC[i], CS[i]) : 0.0f;
        sc0[n] = nz ? C0[i] : 0.0f;
      }
      for (int h = 8; h >= 1; h >>= 1)
        for (int n = 0; n < h; ++n) {
          sa[n] = __fadd_rn(sa[n], sa[n + h]);
          sb[n] = __fadd_rn(sb[n], sb[n + h]);
          sc0[n] = __fadd_rn(sc0[n], sc0[n + h]);
        }
      s_dec[g] = dec;
      s_nnz[g] = nnz;
      s_sum_sig[g] = sa[0];
      s_coded[g] = sb[0];
      s_unc[g] = sc0[0];
      s_sigp0[g] = CS[g * 16];
    }
    __syncthreads();
    // CG zero-out (sigCoeffGroupFlag RD)
    for (int g = tid; g < NCG; g += NT) {
      const bool cg_in = g <= cg_of_last, is_lastcg = g == cg_of_last;
      const bool dec = s_dec[g] != 0;
      const bool eligible = cg_in && !is_lastcg && g != 0 && dec;
      const bool adj = eligible && s_nnz[g] == 0;
      const float ssa = adj ? __fsub_rn(s_sum_sig[g], s_sigp0[g])
                            : s_sum_sig[g];
      const int ctx = s_dec[a.rgt[ss * NCG + g]] | s_dec[a.low[ss * NCG + g]];
      const float lc0 = __fmul_rn(lam, a.cgb[ctx ? 1 : 0][0]);
      const float lc1 = __fmul_rn(lam, a.cgb[ctx ? 1 : 0][1]);
      const float zc = __fsub_rn(
          __fsub_rn(__fadd_rn(lc0, s_unc[g]), s_coded[g]), ssa);
      const bool zeroed = eligible && zc < lc1;
      const bool empty = cg_in && !is_lastcg && g != 0 && !dec;
      const bool drop = zeroed || empty;
      s_drop[g] = drop;
      const float ccs =
          cg_in ? (drop ? lc0 : (eligible && !zeroed ? lc1 : 0.0f)) : 0.0f;
      s_ccs[g] = ccs;
      s_cga[g] = adj ? s_sigp0[g] : 0.0f;
      s_cgb[g] = ccs;
    }
    __syncthreads();
    for (int i = tid; i < P; i += NT) {
      if (s_drop[i >> 4]) {
        LVL[i] = 0;
        CC[i] = C0[i];
        CS[i] = 0.0f;
      }
      S1[i] = CC[i];
      F2[i] = C0[i];
    }
    __syncthreads();
    // base_final and best0 (TComTrQuant.cpp:2096-2177): the add trees over
    // the TU and over its CGs
    tree_sum<NT>(S1, P, tid);
    tree_sum<NT>(F2, P, tid);
    tree_sum<NT>(s_cga, NCG, tid);
    tree_sum<NT>(s_cgb, NCG, tid);
    if (tid == 0) {
      s_bf = __fadd_rn(__fadd_rn(__fsub_rn(S1[0], s_cga[0]), s_cgb[0]),
                       __fmul_rn(lam, a.cbf1[cbf_ctx]));
      s_best0 = __fadd_rn(F2[0], __fmul_rn(lam, a.cbf0[cbf_ctx]));
    }
    __syncthreads();
    // the suffix sums of d (made exclusive below) and of the CGs' costs
    for (int i = tid; i < P; i += NT) {
      const int lvl = LVL[i];
      S1[i] = i <= last ? (lvl > 0 ? __fsub_rn(CC[i], C0[i]) : CS[i]) : 0.0f;
      if (lvl > 1) atomicMax(&s_gt1, i);
    }
    for (int g = tid; g < NCG; g += NT) s_cga[g] = s_ccs[g];
    __syncthreads();
    const float* suf = suffix_sum<NT>(S1, F2, P, tid);
    const float* sufcg = suffix_sum<NT>(s_cga, s_cgc, NCG, tid);
    float* other = suf == S1 ? F2 : S1;
    const float bf = s_bf, best0 = s_best0;
    const int gt1 = s_gt1;
    float tot[PER_T];
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
                      __fmul_rn(lam, a.rlv[ss * P + i])),
            CS[i]);
        tot[q] = lvl > 0 && in_coded && i >= gt1 ? t : kBig;
        other[i] = tot[q];
      }
    }
    __syncthreads();
    // the least total (exact in any order), then the largest position
    // that has it
    for (int h = P >> 1; h >= 1; h >>= 1) {
      for (int i = tid; i < h; i += NT)
        other[i] = fmin2(other[i], other[i + h]);
      __syncthreads();
    }
    const float tmin = other[0];
    for (int q = 0; q < PER_T; ++q) {
      const int i = tid + q * NT;
      if (i < P && tot[q] == tmin) atomicMax(&s_pick, i);
    }
    __syncthreads();
    if (tid == 0)
      s_last_p1 = tmin < best0 && last >= 0 ? s_pick + 1 : 0;
    __syncthreads();
    const int last_p1 = s_last_p1;
    for (int i = tid; i < P; i += NT) {
      const int lvl = i < last_p1 ? LVL[i] : 0;
      const int pos = scan[i];
      s_du[pos] = i <= last ? (LD[i] - (lvl << qbits)) >> (qbits - 8) : 0;
      s_lev[pos] = lvl * (s_co[pos] < 0 ? -1 : 1);
    }
  }
  __syncthreads();

  if (a.sign_hide) {
    // ---- sign-bit hiding (_sbh_batch), one thread a CG ----
    if (tid == 0) s_last_cg = -1;
    __syncthreads();
    for (int g = tid; g < NCG; g += NT) {
      bool any = false;
      for (int n = 0; n < 16; ++n) any |= s_lev[scan[g * 16 + n]] != 0;
      if (any) atomicMax(&s_last_cg, g);
    }
    __syncthreads();
    const int last_cg = s_last_cg;
    for (int g = tid; g < NCG; g += NT) {
      int lv[16], sr[16], dd[16];
      int first = 99, lastn = -1;
      for (int n = 0; n < 16; ++n) {
        const int pos = scan[g * 16 + n];
        lv[n] = s_lev[pos];
        sr[n] = s_co[pos];
        dd[n] = s_du[pos];
        if (lv[n] != 0) {
          if (first == 99) first = n;
          lastn = n;
        }
      }
      const int start_n = g == last_cg ? lastn : 15;
      int csum = 0;
      for (int n = first; n <= lastn; ++n) csum += lv[n];
      const int signbit = lv[imin(first, 15)] > 0 ? 0 : 1;
      if (lastn - first >= 4 && signbit != (csum & 1)) {
        int best_key = 0, sel = -1, chg = 0;
        for (int n = 0; n < 16; ++n) {
          int cost, ch;
          if (lv[n] != 0) {
            const bool pin = n == first && (lv[n] == 1 || lv[n] == -1);
            cost = dd[n] > 0 ? -dd[n] : (pin ? kSbhInf : dd[n]);
            ch = dd[n] > 0 ? 1 : (pin ? 0 : -1);
          } else {
            const bool bad = n < first && (sr[n] >= 0 ? 0 : 1) != signbit;
            cost = bad ? kSbhInf : -dd[n];
            ch = bad ? 0 : 1;
          }
          if (n > start_n) cost = kSbhInf;
          // distinct keys: the largest n among equal costs
          const int key = cost * 16 + (15 - n);
          if (sel < 0 || key < best_key) {
            best_key = key;
            sel = n;
            chg = ch;
          }
        }
        if (lv[sel] == 32767 || lv[sel] == -32768) chg = -1;
        const int delta = sr[sel] >= 0 ? chg : -chg;
        s_lev[scan[g * 16 + sel]] = lv[sel] + delta;
      }
    }
    __syncthreads();
  }

  // ---- the level stack, dequant, inverse transform, recon ----
  {
    short* lvo = pa.lv + idx * P;
    int* D = s_w[0];
    int* T2 = s_w[1];
    const int dsh = LOG2 + bit_inc - 1;
    const int scale = a.iqscale[rem] << per;
    for (int e = tid; e < P; e += NT) {
      const int l = s_lev[e];
      lvo[e] = (short)l;
      const int q = iclamp(l, -32768, 32767);
      D[e] = iclamp((q * scale + (1 << (dsh - 1))) >> dsh, -32768, 32767);
    }
    __syncthreads();
    for (int e = tid; e < P; e += NT) {
      const int j = e >> LOG2, kx = e & (S - 1);
      int acc = 0;
      for (int n = 0; n < S; ++n) acc += basis[n * S + kx] * D[n * S + j];
      T2[e] = iclamp((acc + 64) >> 7, -32768, 32767);
    }
    __syncthreads();
    const int sh = 12 - bit_inc;
    short* out = pa.rec;
    const long long plane_n = (long long)hgt * wid;
    for (int e = tid; e < P; e += NT) {
      const int j = e >> LOG2, kx = e & (S - 1);
      int acc = 0;
      for (int n = 0; n < S; ++n) acc += basis[n * S + kx] * T2[n * S + j];
      const int r = iclamp((acc + (1 << (sh - 1))) >> sh, -32768, 32767);
      const int v = iclamp(s_pred[e] + r, 0, max_val);
      const long long at = (long long)(y0 + 1 + j) * wid + (x0 + 1 + kx);
      if (at >= 0 && at < plane_n) out[at] = (short)v;
    }
  }

  // ---- the last CTA to finish advances the wave counter ----
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const unsigned int total = gridDim.x * gridDim.y;
    if (atomicAdd(a.done, 1u) == total - 1) {
      *a.k = kk + 1;
      atomicExch(a.done, 0u);
      __threadfence();
    }
  }
}

template <int S>
int launch(const StepArgs& a, int cap, int n_planes, cudaStream_t st) {
  const dim3 grid((unsigned)cap, (unsigned)n_planes);
  apply_step<S><<<grid, Cfg<S>::NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// pointers (device): the six record fields, starts, k, done, then for
// planes 0 and 1 rec, lv, wins (plane 1's null for luma), basis, plan,
// scan, rgt, low, qscale, iqscale, then the RDOQ tables sig0p, sig1p, rlv,
// one0, one1, abs0, abs1, cbf0, cbf1 (null without RDOQ)
extern "C" int thevc_apply_step(const void* const* ptrs, int size, int luma,
                                int cap, int n_planes, int hgt, int wid,
                                int qp0, int qp1, int bit_inc, int max_val,
                                float lam0, float lam1, float es0, float es1,
                                int sign_hide, int use_rdoq, float cgb00,
                                float cgb01, float cgb10, float cgb11,
                                void* stream) {
  if (cap <= 0 || n_planes < 1 || n_planes > 2 || hgt <= 0 || wid <= 0
      || (long long)hgt * wid >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  StepArgs a;
  int i = 0;
  a.xs = static_cast<const long long*>(ptrs[i++]);
  a.ys = static_cast<const long long*>(ptrs[i++]);
  a.lo = static_cast<const long long*>(ptrs[i++]);
  a.hi = static_cast<const long long*>(ptrs[i++]);
  a.mode = static_cast<const long long*>(ptrs[i++]);
  a.scan = static_cast<const long long*>(ptrs[i++]);
  a.starts = static_cast<const long long*>(ptrs[i++]);
  a.k = static_cast<long long*>(const_cast<void*>(ptrs[i++]));
  a.done = static_cast<unsigned int*>(const_cast<void*>(ptrs[i++]));
  const int qps[2] = {qp0, qp1};
  const float lams[2] = {lam0, lam1}, ess[2] = {es0, es1};
  for (int p = 0; p < 2; ++p) {
    a.plane[p].rec = static_cast<short*>(const_cast<void*>(ptrs[i++]));
    a.plane[p].lv = static_cast<short*>(const_cast<void*>(ptrs[i++]));
    a.plane[p].wins = static_cast<const short*>(ptrs[i++]);
    a.plane[p].qp = qps[p];
    a.plane[p].lam = lams[p];
    a.plane[p].err_scale = ess[p];
  }
  a.basis = static_cast<const int*>(ptrs[i++]);
  a.plan = static_cast<const int*>(ptrs[i++]);
  a.scan_tab = static_cast<const int*>(ptrs[i++]);
  a.rgt = static_cast<const int*>(ptrs[i++]);
  a.low = static_cast<const int*>(ptrs[i++]);
  a.qscale = static_cast<const int*>(ptrs[i++]);
  a.iqscale = static_cast<const int*>(ptrs[i++]);
  a.sig0p = static_cast<const float*>(ptrs[i++]);
  a.sig1p = static_cast<const float*>(ptrs[i++]);
  a.rlv = static_cast<const float*>(ptrs[i++]);
  a.one0 = static_cast<const float*>(ptrs[i++]);
  a.one1 = static_cast<const float*>(ptrs[i++]);
  a.abs0 = static_cast<const float*>(ptrs[i++]);
  a.abs1 = static_cast<const float*>(ptrs[i++]);
  a.cbf0 = static_cast<const float*>(ptrs[i++]);
  a.cbf1 = static_cast<const float*>(ptrs[i++]);
  a.cgb[0][0] = cgb00;
  a.cgb[0][1] = cgb01;
  a.cgb[1][0] = cgb10;
  a.cgb[1][1] = cgb11;
  a.hgt = hgt;
  a.wid = wid;
  a.luma = luma;
  a.bit_inc = bit_inc;
  a.max_val = max_val;
  a.sign_hide = sign_hide;
  a.use_rdoq = use_rdoq;
  if (use_rdoq && (!a.sig0p || !a.sig1p || !a.rlv || !a.one0 || !a.one1
                   || !a.abs0 || !a.abs1 || !a.cbf0 || !a.cbf1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 4: return launch<4>(a, cap, n_planes, st);
    case 8: return launch<8>(a, cap, n_planes, st);
    case 16: return launch<16>(a, cap, n_planes, st);
    case 32: return launch<32>(a, cap, n_planes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
