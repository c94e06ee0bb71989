// HEVC in-loop filters on an NVIDIA Hopper card (sm_90a): deblocking of
// every vertical then every horizontal edge, then SAO, for a batch of
// pictures and all three planes.
//
// Replaces the XLA function thevc_tpu/ops/jx_filters.py:273 _filter_core
// (its entries filter_picture :312 and filter_pictures :342, one jitted
// launch on the TPU), with _luma_dir (:47), _chroma_dir (:156) and
// _sao_plane (:205).  Every value matches the plain PyTorch form
// (ops/filters.py:filter_pictures_plain) bit for bit:
//   luma   edges on the 8-sample grid, one 4-line segment a 4x4 unit: the
//          d < beta decision, strong/weak from lines 0 and 3, the side
//          thresholds, the weak filter's 10 tc gate, the no_p / no_q keeps
//          (TComLoopFilter.cpp xPelFilterLuma);
//   chroma edges every 8 chroma samples, bs > 1 only, tc at
//          chroma_scale[clamp(qp_avg, 0, 51)] (xPelFilterChroma);
//   SAO    from the deblocked samples into a separate output: edge offset
//          classes 0-3 with the picture-boundary exclusions, band offset
//          with a wrapping band position, clipped to [0, 2^bd - 1]
//          (TComSampleAdaptiveOffset.cpp processSaoCuOrg).
// All arithmetic is int32 in registers; right shifts of negative values
// are arithmetic, as in torch.  The tc, beta and chroma-scale tables are
// the port's own (common/tables.py), passed as device pointers.
//
// What bounds it on this card: bytes.  A sample is read and written once
// a pass, and the decisions and filters are some tens of integer
// operations a 4-sample line; a 1080p picture's planes are 3 MB (8-bit).
// The plain form runs about a thousand torch kernels a call over int32
// planes; this is at most three launches on the caller's stream:
//   1. vertical edges: from the input planes into an int16 working copy;
//   2. horizontal edges: in place on the working copy, or straight into
//      the output when SAO is off (a grid-wide dependency on 1, hence a
//      second launch);
//   3. SAO (or, with deblocking on and SAO off, nothing; with both off, a
//      converting copy): from the working copy (or the input) into the
//      output.
// A thread of a deblocking pass owns a tile: 8 samples along the filtering
// direction, centred on one edge position (8g - 4 .. 8g + 3), by the lines
// of one unit (4 luma lines, 2 chroma lines).  An edge reads x - 4 .. x + 3
// and writes x - 3 .. x + 2, so the tiles of one direction are disjoint
// and each thread reads and writes only its own: the passes need no
// synchronisation and may run in place.  Tiles at g = 0 and past the last
// edge copy their samples unchanged.  Threads run along the rows of the
// planes (groups along the row for vertical edges, unit columns for
// horizontal ones), so a warp's loads are contiguous.  SAO is one thread a
// sample, its CTU's parameters read through the cache.  A fused single
// launch over halo'd tiles in shared memory is later work.
//
// No entry allocates or synchronises; each launches on the stream it is
// given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct DeblockArgs {
  const void* src[3];        // y, cb, cr: [nb, h, w], [nb, h/2, w/2] each
  void* dst[3];
  const uint8_t* flags;      // the direction's maps, [nb, uh, uw] each
  const uint8_t* bs;
  const int8_t* qp_p;
  const int8_t* qp_q;
  const uint8_t* no_p;
  const uint8_t* no_q;
  const int32_t* tc_tab;     // [54]
  const int32_t* beta_tab;   // [52]
  const int32_t* cscale;     // [58]
  long long n_luma, n_chroma;  // tiles: luma, one chroma plane
  int nb, h, w, uh, uw;
  int dir;                   // 0: vertical edges, 1: horizontal edges
  int beta_offset, tc_offset, bd;
};

struct SaoArgs {
  const void* src[3];
  void* dst[3];
  const int8_t* types;       // [nb, 3, nctu]: -1 off, 0-3 EO class, 4 BO
  const int32_t* band_pos;   // [nb, 3, nctu]
  const int32_t* offsets;    // [nb, 3, nctu, 4], pre-shifted
  long long n_luma, n_chroma;  // samples: luma, one chroma plane
  int nb, h, w, nctu, ctu_size, ctus_w;
  int sao_luma, sao_chroma, bd;
};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(hi, max(lo, v));
}

__device__ __forceinline__ int sign_of(int v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ bool strong_line(const int (&m)[8], int dd,
                                            int beta, int tc) {
  const int ds = abs(m[0] - m[3]) + abs(m[7] - m[4]);
  return ds < (beta >> 3) && 2 * dd < (beta >> 2)
         && abs(m[3] - m[4]) < ((tc * 5 + 1) >> 1);
}

// One luma edge across the 4 lines of a tile, samples 0..7 = x - 4 .. x + 3
// (_luma_dir).  m: the map entry of the unit on the edge's q side.
__device__ void luma_edge(const DeblockArgs& a, long long m, int (&v)[4][8]) {
  const int bs = a.bs[m];
  if (!(a.flags[m] & (bs > 0 ? 1 : 0))) return;
  const int qp = ((int)a.qp_p[m] + (int)a.qp_q[m] + 1) >> 1;
  const int scale = 1 << (a.bd - 8), maxv = (1 << a.bd) - 1;
  const int tc = a.tc_tab[clip3(0, 53, qp + 2 * (bs - 1) + 2 * a.tc_offset)]
                 * scale;
  const int beta = a.beta_tab[clip3(0, 51, qp + 2 * a.beta_offset)] * scale;
  const int dp0 = abs(v[0][1] - 2 * v[0][2] + v[0][3]);
  const int dq0 = abs(v[0][4] - 2 * v[0][5] + v[0][6]);
  const int dp3 = abs(v[3][1] - 2 * v[3][2] + v[3][3]);
  const int dq3 = abs(v[3][4] - 2 * v[3][5] + v[3][6]);
  const int d0 = dp0 + dq0, d3 = dp3 + dq3;
  if (!(d0 + d3 < beta)) return;
  const int side = (beta + (beta >> 1)) >> 3;
  const bool fp = dp0 + dp3 < side, fq = dq0 + dq3 < side;
  const bool strong = strong_line(v[0], d0, beta, tc)
                      && strong_line(v[3], d3, beta, tc);
  const bool keep_p = a.no_p[m] != 0, keep_q = a.no_q[m] != 0;
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
}

// One chroma edge across the 2 lines of a tile, samples 2..5 = x - 2 ..
// x + 1 (_chroma_dir).
__device__ void chroma_edge(const DeblockArgs& a, long long m,
                            int (&v)[2][8]) {
  const int bs = a.bs[m];
  if (!(a.flags[m] & (bs > 1 ? 1 : 0))) return;
  const int qp_avg = ((int)a.qp_p[m] + (int)a.qp_q[m] + 1) >> 1;
  const int qp = a.cscale[clip3(0, 51, qp_avg)];
  const int tc = a.tc_tab[clip3(0, 53, qp + 2 * (bs - 1) + 2 * a.tc_offset)]
                 * (1 << (a.bd - 8));
  const int maxv = (1 << a.bd) - 1;
  const bool keep_p = a.no_p[m] != 0, keep_q = a.no_q[m] != 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m2 = v[i][2], m3 = v[i][3], m4 = v[i][4], m5 = v[i][5];
    const int delta = clip3(-tc, tc, ((m4 - m3) * 4 + m2 - m5 + 4) >> 3);
    if (!keep_p) v[i][3] = clip3(0, maxv, m3 + delta);
    if (!keep_q) v[i][4] = clip3(0, maxv, m4 - delta);
  }
}

// One tile of NL lines (4 luma, 2 chroma) of plane p: load, filter its
// edge if it has one, store.  STEP: map units between edges (2 luma, 4
// chroma); LAST: how far the last edge may lie from the plane's end
// (8 luma: edges up to W - 8; 2 chroma: up to w - 2).
template <int NL, int STEP, int LAST, typename TS, typename TD>
__device__ void tile(const DeblockArgs& a, int p, long long t) {
  const bool ver = a.dir == 0;
  const int hp = p ? a.h / 2 : a.h, wp = p ? a.w / 2 : a.w;
  const int len = ver ? wp : hp;                // along the filter
  const int segs = (ver ? hp : wp) / NL;        // units across
  const int groups = (len + 11) / 8;            // tiles along
  int b, r, g;
  if (ver) {
    g = (int)(t % groups);
    const long long q = t / groups;
    r = (int)(q % segs);
    b = (int)(q / segs);
  } else {
    r = (int)(t % segs);
    const long long q = t / segs;
    g = (int)(q % groups);
    b = (int)(q / groups);
  }
  const long long base = (long long)b * hp * wp;
  const TS* src = static_cast<const TS*>(a.src[p]) + base;
  TD* dst = static_cast<TD*>(a.dst[p]) + base;
  const long long s_along = ver ? 1 : wp, s_line = ver ? wp : 1;
  const int a0 = 8 * g - 4, l0 = NL * r;
  int v[NL][8];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int x = a0 + k;
      v[i][k] = (x >= 0 && x < len)
                    ? (int)src[(l0 + i) * s_line + x * s_along] : 0;
    }
  }
  if (g >= 1 && 8 * g <= len - LAST) {
    const int row = ver ? r : STEP * g, col = ver ? STEP * g : r;
    const long long m = ((long long)b * a.uh + row) * a.uw + col;
    if constexpr (NL == 4) {
      luma_edge(a, m, v);
    } else {
      chroma_edge(a, m, v);
    }
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int x = a0 + k;
      if (x >= 0 && x < len) dst[(l0 + i) * s_line + x * s_along] = (TD)v[i][k];
    }
  }
}

template <typename TS, typename TD>
__global__ void __launch_bounds__(kThreads) deblock_kernel(DeblockArgs a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < a.n_luma) {
    tile<4, 2, 8, TS, TD>(a, 0, t);
    return;
  }
  const long long u = t - a.n_luma;
  if (u < 2 * a.n_chroma) {
    tile<2, 4, 2, TS, TD>(a, 1 + (int)(u / a.n_chroma), u % a.n_chroma);
  }
}

template <typename TS, typename TD>
__global__ void __launch_bounds__(kThreads) sao_kernel(SaoArgs a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int p;
  long long u;
  if (t < a.n_luma) {
    p = 0;
    u = t;
  } else if (t - a.n_luma < 2 * a.n_chroma) {
    u = t - a.n_luma;
    p = 1 + (int)(u / a.n_chroma);
    u %= a.n_chroma;
  } else {
    return;
  }
  const int hp = p ? a.h / 2 : a.h, wp = p ? a.w / 2 : a.w;
  const int x = (int)(u % wp);
  const long long q = u / wp;
  const int y = (int)(q % hp), b = (int)(q / hp);
  const long long base = (long long)b * hp * wp;
  // the plane's pointers picked without indexing the parameter arrays by
  // a runtime value (which would copy them to the stack)
  const TS* src = static_cast<const TS*>(
                      p == 0 ? a.src[0] : p == 1 ? a.src[1] : a.src[2])
                  + base;
  TD* dst = static_cast<TD*>(p == 0 ? a.dst[0] : p == 1 ? a.dst[1] : a.dst[2])
            + base;
  const int s = src[(long long)y * wp + x];
  int out = s;
  if (p == 0 ? a.sao_luma : a.sao_chroma) {
    const int cs = p ? a.ctu_size / 2 : a.ctu_size;
    const long long c = ((long long)b * 3 + p) * a.nctu
                        + (y / cs) * a.ctus_w + x / cs;
    const int type = a.types[c];
    const int maxv = (1 << a.bd) - 1;
    if (type >= 0 && type <= 3) {
      // neighbour pairs (dy, dx): horizontal, vertical, 135, 45 degrees
      const int d1y = type == 0 ? 0 : (type == 3 ? 1 : -1);
      const int d1x = type == 1 ? 0 : -1;
      const int d2y = -d1y, d2x = -d1x;
      const bool in = (type == 1 || (x > 0 && x < wp - 1))
                      && (type == 0 || (y > 0 && y < hp - 1));
      if (in) {
        const int n1 = src[(long long)(y + d1y) * wp + x + d1x];
        const int n2 = src[(long long)(y + d2y) * wp + x + d2x];
        const int et = sign_of(s - n1) + sign_of(s - n2) + 2;
        // m_iOffsetEo: edge class 0, 1, 3, 4 takes offset slot 0, 1, 2,
        // 3; class 2 takes none
        const int off = et == 2 ? 0 : a.offsets[c * 4 + et - (et > 2)];
        out = clip3(0, maxv, s + off);
      }
    } else if (type == 4) {
      const int idx = ((s >> (a.bd - 5)) - a.band_pos[c]) & 31;
      out = clip3(0, maxv, s + (idx < 4 ? a.offsets[c * 4 + idx] : 0));
    }
  }
  dst[(long long)y * wp + x] = (TD)out;
}

// blocks of kThreads for n threads; false when the grid is too large
bool grid_of(long long n, unsigned* blocks) {
  const long long b = (n + kThreads - 1) / kThreads;
  *blocks = (unsigned)b;
  return b <= 0x7fffffffLL;
}

int deblock_launch(const DeblockArgs& a, int src_u8, int dst_u8,
                   cudaStream_t st) {
  unsigned g;
  const long long n = a.n_luma + 2 * a.n_chroma;
  if (n <= 0) return 0;
  if (!grid_of(n, &g)) return (int)cudaErrorInvalidValue;
  if (src_u8 && dst_u8) {
    deblock_kernel<uint8_t, uint8_t><<<g, kThreads, 0, st>>>(a);
  } else if (src_u8) {
    deblock_kernel<uint8_t, int16_t><<<g, kThreads, 0, st>>>(a);
  } else if (dst_u8) {
    deblock_kernel<int16_t, uint8_t><<<g, kThreads, 0, st>>>(a);
  } else {
    deblock_kernel<int16_t, int16_t><<<g, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

int sao_launch(const SaoArgs& a, int src_u8, int dst_u8, cudaStream_t st) {
  unsigned g;
  const long long n = a.n_luma + 2 * a.n_chroma;
  if (n <= 0) return 0;
  if (!grid_of(n, &g)) return (int)cudaErrorInvalidValue;
  if (src_u8 && dst_u8) {
    sao_kernel<uint8_t, uint8_t><<<g, kThreads, 0, st>>>(a);
  } else if (src_u8) {
    sao_kernel<uint8_t, int16_t><<<g, kThreads, 0, st>>>(a);
  } else if (dst_u8) {
    sao_kernel<int16_t, uint8_t><<<g, kThreads, 0, st>>>(a);
  } else {
    sao_kernel<int16_t, int16_t><<<g, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

bool dims_ok(int nb, int h, int w) {
  return nb > 0 && h >= 8 && w >= 8 && h % 8 == 0 && w % 8 == 0;
}

}  // namespace

// One direction of deblocking over nb pictures.  src / dst: host arrays
// of three device pointers (y [nb, h, w], cb and cr [nb, h/2, w/2]),
// uint8 where *_u8 is set, else int16; dst may equal src.  maps: host
// array of the direction's six device maps [nb, uh, uw] (flags u8, bs u8,
// qp_p i8, qp_q i8, no_p u8, no_q u8), uh >= h/4, uw >= w/4; tables: host
// array of the device tc [54], beta [52] and chroma-scale [58] int32
// tables.  dir 0: vertical edges, 1: horizontal edges.
extern "C" int thevc_deblock(const void* const* src, void* const* dst,
                             int src_u8, int dst_u8, const void* const* maps,
                             const void* const* tables, int nb, int h, int w,
                             int uh, int uw, int dir, int beta_offset,
                             int tc_offset, int bd, void* stream) {
  if (!dims_ok(nb, h, w) || uh < h / 4 || uw < w / 4 || (dir != 0 && dir != 1)
      || bd < 8 || bd > 12) {
    return (int)cudaErrorInvalidValue;
  }
  DeblockArgs a;
  for (int p = 0; p < 3; ++p) {
    a.src[p] = src[p];
    a.dst[p] = dst[p];
  }
  a.flags = static_cast<const uint8_t*>(maps[0]);
  a.bs = static_cast<const uint8_t*>(maps[1]);
  a.qp_p = static_cast<const int8_t*>(maps[2]);
  a.qp_q = static_cast<const int8_t*>(maps[3]);
  a.no_p = static_cast<const uint8_t*>(maps[4]);
  a.no_q = static_cast<const uint8_t*>(maps[5]);
  a.tc_tab = static_cast<const int32_t*>(tables[0]);
  a.beta_tab = static_cast<const int32_t*>(tables[1]);
  a.cscale = static_cast<const int32_t*>(tables[2]);
  a.nb = nb;
  a.h = h;
  a.w = w;
  a.uh = uh;
  a.uw = uw;
  a.dir = dir;
  a.beta_offset = beta_offset;
  a.tc_offset = tc_offset;
  a.bd = bd;
  const bool ver = dir == 0;
  const int hc = h / 2, wc = w / 2;
  a.n_luma = (long long)nb * ((ver ? h : w) / 4) * (((ver ? w : h) + 11) / 8);
  a.n_chroma = (long long)nb * ((ver ? hc : wc) / 2)
               * (((ver ? wc : hc) + 11) / 8);
  return deblock_launch(a, src_u8, dst_u8, static_cast<cudaStream_t>(stream));
}

// SAO over nb pictures (or, with both switches off, a converting copy):
// src / dst as for thevc_deblock (dst must not alias src); types int8,
// band_pos int32 [nb, 3, nctu]; offsets int32 [nb, 3, nctu, 4]; the CTU
// grid ctu_size (luma samples) by ctus_w columns covers the picture.
extern "C" int thevc_sao(const void* const* src, void* const* dst, int src_u8,
                         int dst_u8, const void* types, const void* band_pos,
                         const void* offsets, int nb, int h, int w, int nctu,
                         int ctu_size, int ctus_w, int sao_luma,
                         int sao_chroma, int bd, void* stream) {
  if (!dims_ok(nb, h, w) || nctu <= 0 || ctu_size < 8 || ctus_w <= 0
      || bd < 8 || bd > 12) {
    return (int)cudaErrorInvalidValue;
  }
  SaoArgs a;
  for (int p = 0; p < 3; ++p) {
    a.src[p] = src[p];
    a.dst[p] = dst[p];
  }
  a.types = static_cast<const int8_t*>(types);
  a.band_pos = static_cast<const int32_t*>(band_pos);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.nb = nb;
  a.h = h;
  a.w = w;
  a.nctu = nctu;
  a.ctu_size = ctu_size;
  a.ctus_w = ctus_w;
  a.sao_luma = sao_luma;
  a.sao_chroma = sao_chroma;
  a.bd = bd;
  a.n_luma = (long long)nb * h * w;
  a.n_chroma = (long long)nb * (h / 2) * (w / 2);
  return sao_launch(a, src_u8, dst_u8, static_cast<cudaStream_t>(stream));
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
