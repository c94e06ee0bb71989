// HEVC in-loop filters on an NVIDIA Hopper card (sm_90a): deblocking of
// every vertical then every horizontal edge, then SAO, for a batch of
// pictures and all three planes, in one launch.
//
// Replaces the XLA function thevc_tpu/ops/jx_filters.py:273 _filter_core
// (its entries filter_picture :312 and filter_pictures :342, one jitted
// launch on the TPU), with _luma_dir (:47), _chroma_dir (:156) and
// _sao_plane (:205).  Every value matches the plain PyTorch form
// (ops/filters.py:filter_pictures_plain) bit for bit:
//   luma   edges on the 8-sample grid, one 4-line segment a 4x4 unit: the
//          d < beta decision, strong/weak from lines 0 and 3, the side
//          thresholds, the weak filter's 10 tc gate, the no_p / no_q keeps
//          (TComLoopFilter.cpp xPelFilterLuma); none at the picture's
//          left or top boundary, the last at W - 8 (H - 8);
//   chroma edges every 8 chroma samples up to w - 2 (h - 2), bs > 1 only,
//          tc at chroma_scale[clamp(qp_avg, 0, 51)] (xPelFilterChroma);
//   SAO    from the deblocked samples: edge offset classes 0-3 with the
//          picture-boundary exclusions, band offset with a wrapping band
//          position, clipped to [0, 2^bd - 1]
//          (TComSampleAdaptiveOffset.cpp processSaoCuOrg).
// All arithmetic is int32 in registers; right shifts of negative values
// are arithmetic, as in torch.
//
// What bounds it on this card: bytes.  Each plane is read once and written
// once; the decisions and filters are some tens of integer operations a
// 4-sample line, SAO about ten a sample.  A 1080p picture's planes are 3 MB
// (8-bit), and the 12 unit maps and SAO tables add a sixth of that.
//
// The design keeps the whole stage of a tile on one SM: one launch a call,
// no working copy in device memory.
//   - Grid (tiles_x, tiles_y, picture x {luma, chroma}), 256 threads a
//     CTA.  A luma CTA owns one 64x64 output tile; a chroma CTA the 32x32
//     tiles of Cb and Cr at the same place, 128 threads each.  One tile
//     grid serves all three planes (ceil(W / 64) = ceil(W / 2 / 32)); 64
//     keeps a luma thread at 16 output samples (one 16-byte store in
//     8-bit) with the window in 10 KB of shared memory, and a chroma
//     thread at 8.  At most 64 registers a thread, so 4 CTAs share an SM:
//     the CTA's phases are latency-bound (a load, three barriers, the
//     stores), and more CTAs in flight and fewer of them, with both chroma
//     planes in one, hide more of it.  Every coordinate is a 32-bit int
//     from blockIdx / threadIdx with divisions by constants; only the
//     planes' base offsets are 64-bit.
//   - Halo of 4.  The tile's output at [y0, y0+T) x [x0, x0+T) needs the
//     deblocked samples one further out (SAO's neighbours).  The edges at
//     x0 .. x0+T and y0 .. y0+T read 4 samples either side, the luma
//     decisions lines 0 and 3 of a 4-line segment, so the (T+8)^2 window
//     from (y0-4, x0-4) holds everything: every window sample's deblocked
//     value is exact (no edge outside the window writes into it), and
//     tests/test_torch_filters_halo.py checks that the interior depends
//     on nothing outside it, and that 4 is not more than needed.
//   - Loads: the window goes to shared memory as int16, 16 bytes a thread
//     along rows where the plane's rows are 16-byte aligned (a chunk then
//     lies wholly inside or outside the plane), one sample at a time
//     elsewhere (for example an 8-bit width that is not a multiple of 16);
//     samples outside the plane are 0 and never read by a filter that
//     writes the interior.  The six map entries of each thread's vertical
//     and horizontal segment are read into registers meanwhile; the tc,
//     beta and chroma-scale tables and the SAO parameters of the CTUs the
//     tile meets go to shared memory.
//   - Vertical edges in place in shared memory, a thread one (edge, 4-line
//     luma or 2-line chroma segment), one 16-byte row read and written a
//     line: edges are 8 apart and an edge reads x-4 .. x+3, so segments
//     never overlap.  Then horizontal edges the same way (8- or 4-byte
//     column groups of 8 rows).  A barrier after each.
//   - SAO from the deblocked window (never from SAO'd samples, so no second
//     buffer) into the output, or the deblocked interior converted, a thread
//     a run of 16 (luma) or 8 (chroma) samples of a row, stored as one
//     vector where the plane's rows allow it.
// The window's halo is read again by the neighbouring tiles (72^2 / 64^2 =
// 1.27 of the luma bytes, mostly from L2); the rest is read and written
// once, and no intermediate plane goes to device memory.
//
// The entry does not allocate or synchronise; it launches on the stream it
// is given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 4;
constexpr int kLumaTile = 64;
constexpr int kChromaTile = 32;
// CTUs a tile meets along one axis: luma CTUs are at least 16 samples, so
// chroma ones at least 8, and a 64 (32) sample span meets at most 5
constexpr int kMaxCtus = 5;
constexpr int kLumaWin = kLumaTile + 2 * kHalo;

struct Args {
  const void* src[3];        // y, cb, cr: [nb, h, w], [nb, h/2, w/2] each
  void* dst[3];
  const uint8_t* ver[6];     // flags, bs, qp_p (int8), qp_q (int8), no_p,
  const uint8_t* hor[6];     // no_q: [nb, uh, uw] each
  const int8_t* types;       // [nb, 3, nctu]: -1 off, 0-3 EO class, 4 BO
  const int32_t* band_pos;   // [nb, 3, nctu]
  const int32_t* offsets;    // [nb, 3, nctu, 4], pre-shifted
  const int32_t* tc_tab;     // [54]
  const int32_t* beta_tab;   // [52]
  const int32_t* cscale;     // [58]
  int h, w, uh, uw;
  int beta_offset, tc_offset, bd;
  int nctu, ctu_size, ctus_w;
  int deblock, sao_luma, sao_chroma;
};

// A luma CTA uses half 0 of each per-half array; a chroma CTA's Cb half
// uses 0 and its Cr half 1 (the Cb window at 0, the Cr window after it).
struct alignas(16) Smem {
  int16_t win[kLumaWin * kLumaWin];
  int tc[54], beta[52], cscale[58];
  int sao[2][kMaxCtus * kMaxCtus][6];   // type, band position, 4 offsets
  uint8_t ctu_row[2][kLumaTile], ctu_col[2][kLumaTile];  // local CTU of a
                                                         // row, a column
};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(hi, max(lo, v));
}

__device__ __forceinline__ int sign_of(int v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ int lo16(uint32_t v) { return (int16_t)(v & 0xffff); }
__device__ __forceinline__ int hi16(uint32_t v) { return (int16_t)(v >> 16); }
__device__ __forceinline__ uint32_t pack2(int a, int b) {
  return (uint32_t)(uint16_t)a | ((uint32_t)(uint16_t)b << 16);
}

// The six map entries of a unit: flags, bs, qp_p, qp_q, no_p, no_q.
__device__ __forceinline__ void read_unit(const uint8_t* const (&m)[6],
                                          long long i, int (&u)[6]) {
  u[0] = m[0][i];
  u[1] = m[1][i];
  u[2] = (int8_t)m[2][i];
  u[3] = (int8_t)m[3][i];
  u[4] = m[4][i];
  u[5] = m[5][i];
}

__device__ __forceinline__ bool strong_line(const int (&m)[8], int dd,
                                            int beta, int tc) {
  const int ds = abs(m[0] - m[3]) + abs(m[7] - m[4]);
  return ds < (beta >> 3) && 2 * dd < (beta >> 2)
         && abs(m[3] - m[4]) < ((tc * 5 + 1) >> 1);
}

// One luma edge across the 4 lines of a segment, samples 0..7 = x - 4 ..
// x + 3 (_luma_dir).  u: the map entries of the unit on the edge's q side.
// False when it leaves the samples as they were.
__device__ bool luma_edge(const Args& a, const Smem& sm, const int (&u)[6],
                          int (&v)[4][8]) {
  const int bs = u[1];
  if (!(u[0] & (bs > 0 ? 1 : 0))) return false;
  const int qp = (u[2] + u[3] + 1) >> 1;
  const int scale = 1 << (a.bd - 8), maxv = (1 << a.bd) - 1;
  const int tc = sm.tc[clip3(0, 53, qp + 2 * (bs - 1) + 2 * a.tc_offset)]
                 * scale;
  const int beta = sm.beta[clip3(0, 51, qp + 2 * a.beta_offset)] * scale;
  const int dp0 = abs(v[0][1] - 2 * v[0][2] + v[0][3]);
  const int dq0 = abs(v[0][4] - 2 * v[0][5] + v[0][6]);
  const int dp3 = abs(v[3][1] - 2 * v[3][2] + v[3][3]);
  const int dq3 = abs(v[3][4] - 2 * v[3][5] + v[3][6]);
  const int d0 = dp0 + dq0, d3 = dp3 + dq3;
  if (!(d0 + d3 < beta)) return false;
  const int side = (beta + (beta >> 1)) >> 3;
  const bool fp = dp0 + dp3 < side, fq = dq0 + dq3 < side;
  const bool strong = strong_line(v[0], d0, beta, tc)
                      && strong_line(v[3], d3, beta, tc);
  const bool keep_p = u[4] != 0, keep_q = u[5] != 0;
  const int tc2 = tc >> 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m0 = v[i][0], m1 = v[i][1], m2 = v[i][2], m3 = v[i][3];
    const int m4 = v[i][4], m5 = v[i][5], m6 = v[i][6], m7 = v[i][7];
    int o1 = m1, o2 = m2, o3 = m3, o4 = m4, o5 = m5, o6 = m6;
    if (strong) {
      const int t2 = 2 * tc;
      o3 = clip3(m3 - t2, m3 + t2,
                 (m1 + 2 * m2 + 2 * m3 + 2 * m4 + m5 + 4) >> 3);
      o4 = clip3(m4 - t2, m4 + t2,
                 (m2 + 2 * m3 + 2 * m4 + 2 * m5 + m6 + 4) >> 3);
      o2 = clip3(m2 - t2, m2 + t2, (m1 + m2 + m3 + m4 + 2) >> 2);
      o5 = clip3(m5 - t2, m5 + t2, (m3 + m4 + m5 + m6 + 2) >> 2);
      o1 = clip3(m1 - t2, m1 + t2, (2 * m0 + 3 * m1 + m2 + m3 + m4 + 4) >> 3);
      o6 = clip3(m6 - t2, m6 + t2, (m3 + m4 + m5 + 3 * m6 + 2 * m7 + 4) >> 3);
    } else {
      const int delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4;
      if (abs(delta) < tc * 10) {
        const int dc = clip3(-tc, tc, delta);
        o3 = clip3(0, maxv, m3 + dc);
        o4 = clip3(0, maxv, m4 - dc);
        if (fp) {
          const int d1 = (((m1 + m3 + 1) >> 1) - m2 + dc) >> 1;
          o2 = clip3(0, maxv, m2 + clip3(-tc2, tc2, d1));
        }
        if (fq) {
          const int d2 = (((m6 + m4 + 1) >> 1) - m5 - dc) >> 1;
          o5 = clip3(0, maxv, m5 + clip3(-tc2, tc2, d2));
        }
      }
    }
    if (!keep_p) { v[i][1] = o1; v[i][2] = o2; v[i][3] = o3; }
    if (!keep_q) { v[i][4] = o4; v[i][5] = o5; v[i][6] = o6; }
  }
  return true;
}

// One chroma edge across the 2 lines of a segment, samples 2..5 = x - 2 ..
// x + 1 (_chroma_dir).
__device__ bool chroma_edge(const Args& a, const Smem& sm, const int (&u)[6],
                            int (&v)[2][8]) {
  const int bs = u[1];
  if (!(u[0] & (bs > 1 ? 1 : 0))) return false;
  const int qp_avg = (u[2] + u[3] + 1) >> 1;
  const int qp = sm.cscale[clip3(0, 51, qp_avg)];
  const int tc = sm.tc[clip3(0, 53, qp + 2 * (bs - 1) + 2 * a.tc_offset)]
                 * (1 << (a.bd - 8));
  const int maxv = (1 << a.bd) - 1;
  const bool keep_p = u[4] != 0, keep_q = u[5] != 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m2 = v[i][2], m3 = v[i][3], m4 = v[i][4], m5 = v[i][5];
    const int delta = clip3(-tc, tc, ((m4 - m3) * 4 + m2 - m5 + 4) >> 3);
    if (!keep_p) v[i][3] = clip3(0, maxv, m3 + delta);
    if (!keep_q) v[i][4] = clip3(0, maxv, m4 - delta);
  }
  return true;
}

template <typename TS>
__device__ __forceinline__ void chunk_samples(const uint4& c, int (&s)[16]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(TS) == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[4 * k + j] = (w[k] >> (8 * j)) & 0xff;
    } else {
      s[2 * k] = lo16(w[k]);
      s[2 * k + 1] = hi16(w[k]);
    }
  }
}

// The (T+8)^2 window from (y0-4, x0-4) of one plane into shared memory as
// int16, 0 outside the plane.
template <int T, int NT, typename TS>
__device__ void load_window(const TS* src, int hp, int wp, int y0, int x0,
                            bool vec, int tid, int16_t* win) {
  constexpr int kW = T + 2 * kHalo;
  if (vec) {
    // 16-byte chunks from the chunk-aligned column left of the window,
    // each wholly inside or outside the plane
    constexpr int CH = 16 / sizeof(TS);          // samples a chunk
    constexpr int NC = (T + 2 * CH) / CH;        // chunks a row
    constexpr int N = kW * NC;
    constexpr int IT = (N + NT - 1) / NT;
    uint4 c[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = tid + it * NT;
      const int r = i / NC, y = y0 - kHalo + r;
      const int x = x0 - CH + (i % NC) * CH;
      c[it] = make_uint4(0, 0, 0, 0);
      if (i < N && y >= 0 && y < hp && x >= 0 && x < wp) {
        c[it] = *reinterpret_cast<const uint4*>(src + y * wp + x);
      }
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = tid + it * NT;
      if (i >= N) break;
      const int r = i / NC, wc = (i % NC) * CH - CH + kHalo;
      int s[16];
      chunk_samples<TS>(c[it], s);
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        if (wc + k >= 0 && wc + k < kW) win[r * kW + wc + k] = (int16_t)s[k];
      }
    }
  } else {
    for (int i = tid; i < kW * kW; i += NT) {
      const int r = i / kW, q = i % kW;
      const int y = y0 - kHalo + r, x = x0 - kHalo + q;
      win[i] = (y >= 0 && y < hp && x >= 0 && x < wp)
                   ? (int16_t)src[y * wp + x] : (int16_t)0;
    }
  }
}

// One run of R output samples as packed 32-bit words, stored as the widest
// vector its alignment allows.
template <int R, typename TD>
__device__ __forceinline__ void store_run(TD* dst, const int (&o)[R],
                                          bool vec) {
  constexpr int NW = R * (int)sizeof(TD) / 4;
  if (!vec) {
#pragma unroll
    for (int r = 0; r < R; ++r) dst[r] = (TD)o[r];
    return;
  }
  uint32_t wv[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if constexpr (sizeof(TD) == 1) {
      wv[k] = (uint32_t)(uint8_t)o[4 * k] | ((uint32_t)(uint8_t)o[4 * k + 1] << 8)
              | ((uint32_t)(uint8_t)o[4 * k + 2] << 16)
              | ((uint32_t)(uint8_t)o[4 * k + 3] << 24);
    } else {
      wv[k] = pack2(o[2 * k], o[2 * k + 1]);
    }
  }
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int k = 0; k < NW; k += 4) {
      reinterpret_cast<uint4*>(dst)[k / 4] =
          make_uint4(wv[k], wv[k + 1], wv[k + 2], wv[k + 3]);
    }
  } else if constexpr (NW == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(wv[0], wv[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = wv[0];
  }
}

// The whole stage for one T x T tile of plane p (0 luma) of picture b, by
// NT threads (tid 0 .. NT - 1) and the shared memory of its half.
template <int T, int NT, typename TS, typename TD>
__device__ void filter_tile(const Args& a, Smem& sm, int b, int p, int tid,
                            int half) {
  constexpr bool kLuma = T == kLumaTile;
  constexpr int kW = T + 2 * kHalo;
  constexpr int NL = kLuma ? 4 : 2;      // lines a segment
  constexpr int US = kLuma ? 2 : 1;      // sample -> unit shift
  constexpr int LAST = kLuma ? 8 : 2;    // last edge at plane size - LAST
  constexpr int NE = T / 8 + 1;          // edges a direction meets
  constexpr int NS = kW / NL;            // segments along an edge
  constexpr int R = T * T / NT;          // output samples a thread
  constexpr int RUNS = T / R;            // runs a row
  static_assert(NE * NS <= NT, "a thread a segment of each direction");
  const int hp = kLuma ? a.h : a.h >> 1, wp = kLuma ? a.w : a.w >> 1;
  const int y0 = (int)blockIdx.y * T, x0 = (int)blockIdx.x * T;
  const long long base = (long long)b * hp * wp;
  const TS* src = static_cast<const TS*>(
                      p == 0 ? a.src[0] : p == 1 ? a.src[1] : a.src[2])
                  + base;
  TD* dst = static_cast<TD*>(p == 0 ? a.dst[0] : p == 1 ? a.dst[1] : a.dst[2])
            + base;
  const bool sao = kLuma ? a.sao_luma != 0 : a.sao_chroma != 0;
  int16_t* win = sm.win + half * kW * kW;
  int (*const sao_prm)[6] = sm.sao[half];
  uint8_t* const ctu_row = sm.ctu_row[half];
  uint8_t* const ctu_col = sm.ctu_col[half];

  // 1. the window, the SAO parameters, each segment's unit
  load_window<T, NT, TS>(src, hp, wp, y0, x0,
                         (reinterpret_cast<uintptr_t>(src) & 15) == 0
                             && (wp * (int)sizeof(TS)) % 16 == 0,
                         tid, win);
  int vu[6], hu[6];
  bool vj = false, hj = false;
  if (a.deblock) {
    const long long mb = (long long)b * a.uh * a.uw;
    if (tid < NE * NS) {
      // vertical: edge x0 + 8e, segment rows y0 - 4 + NL s ..
      const int e = tid % NE, s = tid / NE;
      const int x = x0 + 8 * e, y = y0 - kHalo + NL * s;
      vj = x >= 8 && x <= wp - LAST && y >= 0 && y < hp;
      if (vj) read_unit(a.ver, mb + (y >> US) * a.uw + (x >> US), vu);
      // horizontal: edge y0 + 8e, segment columns x0 - 4 + NL s ..
      const int s2 = tid % NS, e2 = tid / NS;
      const int yh = y0 + 8 * e2, xh = x0 - kHalo + NL * s2;
      hj = yh >= 8 && yh <= hp - LAST && xh >= 0 && xh < wp;
      if (hj) read_unit(a.hor, mb + (yh >> US) * a.uw + (xh >> US), hu);
    }
  }
  if (sao) {
    const int cs = kLuma ? a.ctu_size : a.ctu_size >> 1;
    const int cr0 = y0 / cs, cc0 = x0 / cs;
    if (tid < T) {
      ctu_row[tid] = (uint8_t)(min(y0 + tid, hp - 1) / cs - cr0);
      ctu_col[tid] = (uint8_t)(min(x0 + tid, wp - 1) / cs - cc0);
    }
    const int nr = (min(y0 + T, hp) - 1) / cs - cr0 + 1;
    const int nc = (min(x0 + T, wp) - 1) / cs - cc0 + 1;
    if (tid < kMaxCtus * kMaxCtus) {
      const int lr = tid / kMaxCtus, lc = tid % kMaxCtus;
      if (lr < nr && lc < nc) {
        const long long c = ((long long)b * 3 + p) * a.nctu
                            + (cr0 + lr) * a.ctus_w + cc0 + lc;
        sao_prm[tid][0] = a.types[c];
        sao_prm[tid][1] = a.band_pos[c];
#pragma unroll
        for (int k = 0; k < 4; ++k) sao_prm[tid][2 + k] = a.offsets[4 * c + k];
      }
    }
  }
  __syncthreads();

  if (a.deblock) {
    // 2. vertical edges: window columns 8e .. 8e + 7, one 16-byte row a line
    if (vj) {
      const int e = tid % NE, s = tid / NE;
      int16_t* at = win + NL * s * kW + 8 * e;
      int v[NL][8];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const uint4 c = *reinterpret_cast<const uint4*>(at + i * kW);
        const uint32_t w4[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[i][2 * k] = lo16(w4[k]);
          v[i][2 * k + 1] = hi16(w4[k]);
        }
      }
      bool changed;
      if constexpr (kLuma) {
        changed = luma_edge(a, sm, vu, v);
      } else {
        changed = chroma_edge(a, sm, vu, v);
      }
      if (changed) {
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          *reinterpret_cast<uint4*>(at + i * kW) = make_uint4(
              pack2(v[i][0], v[i][1]), pack2(v[i][2], v[i][3]),
              pack2(v[i][4], v[i][5]), pack2(v[i][6], v[i][7]));
        }
      }
    }
    __syncthreads();
    // 3. horizontal edges: window rows 8e .. 8e + 7, NL columns a row
    if (hj) {
      const int s = tid % NS, e = tid / NS;
      int16_t* at = win + 8 * e * kW + NL * s;
      int v[NL][8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if constexpr (kLuma) {
          const uint2 c = *reinterpret_cast<const uint2*>(at + k * kW);
          v[0][k] = lo16(c.x);
          v[1][k] = hi16(c.x);
          v[2][k] = lo16(c.y);
          v[3][k] = hi16(c.y);
        } else {
          const uint32_t c = *reinterpret_cast<const uint32_t*>(at + k * kW);
          v[0][k] = lo16(c);
          v[1][k] = hi16(c);
        }
      }
      bool changed;
      if constexpr (kLuma) {
        changed = luma_edge(a, sm, hu, v);
      } else {
        changed = chroma_edge(a, sm, hu, v);
      }
      if (changed) {
#pragma unroll
        for (int k = 1; k < 7; ++k) {
          if constexpr (kLuma) {
            *reinterpret_cast<uint2*>(at + k * kW) = make_uint2(
                pack2(v[0][k], v[1][k]), pack2(v[2][k], v[3][k]));
          } else {
            *reinterpret_cast<uint32_t*>(at + k * kW) = pack2(v[0][k], v[1][k]);
          }
        }
      }
    }
    __syncthreads();
  }

  // 4. SAO (or the deblocked samples) of a run of R interior samples
  const int ly = tid / RUNS, lx = (tid % RUNS) * R;
  const int y = y0 + ly, x = x0 + lx;
  if (y >= hp || x >= wp) return;
  const int16_t* row = win + (ly + kHalo) * kW + lx + kHalo;
  const int maxv = (1 << a.bd) - 1;
  int o[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = row[r];
    int out = s;
    if (sao) {
      const int* prm = sao_prm[ctu_row[ly] * kMaxCtus + ctu_col[lx + r]];
      const int type = prm[0];
      const int xr = x + r;
      if (type >= 0 && type <= 3) {
        // neighbour pairs (dy, dx): horizontal, vertical, 135, 45 degrees
        const int d1y = type == 0 ? 0 : (type == 3 ? 1 : -1);
        const int d1x = type == 1 ? 0 : -1;
        const bool in = (type == 1 || (xr > 0 && xr < wp - 1))
                        && (type == 0 || (y > 0 && y < hp - 1));
        if (in) {
          const int n1 = row[r + d1y * kW + d1x];
          const int n2 = row[r - d1y * kW - d1x];
          const int et = sign_of(s - n1) + sign_of(s - n2) + 2;
          // m_iOffsetEo: edge class 0, 1, 3, 4 takes offset slot 0, 1, 2,
          // 3; class 2 takes none
          const int off = et == 2 ? 0 : prm[2 + et - (et > 2)];
          out = clip3(0, maxv, s + off);
        }
      } else if (type == 4) {
        const int idx = ((s >> (a.bd - 5)) - prm[1]) & 31;
        out = clip3(0, maxv, s + (idx < 4 ? prm[2 + idx] : 0));
      }
    }
    o[r] = out;
  }
  TD* out = dst + y * wp + x;
  if (x + R <= wp) {
    constexpr int VB = R * (int)sizeof(TD) < 16 ? R * (int)sizeof(TD) : 16;
    store_run<R, TD>(out, o, (reinterpret_cast<uintptr_t>(dst) & 15) == 0
                                 && (wp * (int)sizeof(TD)) % VB == 0);
  } else {
    for (int r = 0; r < wp - x; ++r) out[r] = (TD)o[r];
  }
}

// blockIdx.z: picture b, luma (even) or both chroma planes (odd); the
// tables go to shared memory before the tile's first barrier.  At most 64
// registers a thread, so that 4 CTAs share an SM.
template <typename TS, typename TD>
__global__ void __launch_bounds__(kThreads, 4) filter_kernel(Args a) {
  __shared__ Smem sm;
  const int z = (int)blockIdx.z, b = z >> 1, t = (int)threadIdx.x;
  if (a.deblock) {
    if (t < 54) sm.tc[t] = a.tc_tab[t];
    if (t < 52) sm.beta[t] = a.beta_tab[t];
    if (t < 58) sm.cscale[t] = a.cscale[t];
  }
  if (z & 1) {
    const int half = t / (kThreads / 2);
    filter_tile<kChromaTile, kThreads / 2, TS, TD>(
        a, sm, b, 1 + half, t - half * (kThreads / 2), half);
  } else {
    filter_tile<kLumaTile, kThreads, TS, TD>(a, sm, b, 0, t, 0);
  }
}

}  // namespace

// Deblocking (vertical then horizontal edges) and SAO of nb pictures, all
// three planes, in one launch; with both filters off a converting copy.
// ptrs: host array of 24 device pointers: the source planes y [nb, h, w],
// cb and cr [nb, h/2, w/2] (uint8 where src_u8 is set, else int16); the
// output planes alike (uint8 where dst_u8 is set; they must not alias the
// source); the vertical then the horizontal edges' six unit maps
// [nb, uh, uw] each (flags u8, bs u8, qp_p i8, qp_q i8, no_p u8, no_q u8),
// uh >= h/4, uw >= w/4; the SAO types int8 and band positions int32
// [nb, 3, nctu], the offsets int32 [nb, 3, nctu, 4], nctu = ctus_w * ctus_h;
// the tc [54], beta [52] and chroma-scale [58] int32 tables (read only with
// deblock set).  The CTU grid of ctu_size luma samples (16 or more, even)
// covers the picture.
extern "C" int thevc_filter(const void* const* ptrs, int nb, int h, int w,
                            int uh, int uw, int src_u8, int dst_u8,
                            int beta_offset, int tc_offset, int bd,
                            int ctu_size, int ctus_w, int ctus_h, int deblock,
                            int sao_luma, int sao_chroma, void* stream) {
  if (nb <= 0 || 2LL * nb > 65535 || h < 8 || w < 8 || h % 8 || w % 8
      || (long long)h * w >= (1LL << 31) || uh < h / 4 || uw < w / 4
      || (long long)uh * uw >= (1LL << 31) || bd < 8 || bd > 12
      || ctu_size < 16 || ctu_size % 2 || ctus_w < 1 || ctus_h < 1
      || (long long)ctus_w * ctu_size < w || (long long)ctus_h * ctu_size < h) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  for (int p = 0; p < 3; ++p) {
    a.src[p] = ptrs[p];
    a.dst[p] = const_cast<void*>(ptrs[3 + p]);
  }
  for (int k = 0; k < 6; ++k) {
    a.ver[k] = static_cast<const uint8_t*>(ptrs[6 + k]);
    a.hor[k] = static_cast<const uint8_t*>(ptrs[12 + k]);
  }
  a.types = static_cast<const int8_t*>(ptrs[18]);
  a.band_pos = static_cast<const int32_t*>(ptrs[19]);
  a.offsets = static_cast<const int32_t*>(ptrs[20]);
  a.tc_tab = static_cast<const int32_t*>(ptrs[21]);
  a.beta_tab = static_cast<const int32_t*>(ptrs[22]);
  a.cscale = static_cast<const int32_t*>(ptrs[23]);
  a.h = h;
  a.w = w;
  a.uh = uh;
  a.uw = uw;
  a.beta_offset = beta_offset;
  a.tc_offset = tc_offset;
  a.bd = bd;
  a.nctu = ctus_w * ctus_h;
  a.ctu_size = ctu_size;
  a.ctus_w = ctus_w;
  a.deblock = deblock != 0;
  a.sao_luma = sao_luma != 0;
  a.sao_chroma = sao_chroma != 0;
  const dim3 grid((w + kLumaTile - 1) / kLumaTile,
                  (h + kLumaTile - 1) / kLumaTile, 2 * nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (src_u8 && dst_u8) {
    filter_kernel<uint8_t, uint8_t><<<grid, kThreads, 0, st>>>(a);
  } else if (src_u8) {
    filter_kernel<uint8_t, int16_t><<<grid, kThreads, 0, st>>>(a);
  } else if (dst_u8) {
    filter_kernel<int16_t, uint8_t><<<grid, kThreads, 0, st>>>(a);
  } else {
    filter_kernel<int16_t, int16_t><<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
