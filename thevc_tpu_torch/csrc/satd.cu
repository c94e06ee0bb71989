// Hadamard SATD of one original block against each of its candidate
// predictions: the encoder's intra mode sweep on an NVIDIA Hopper card
// (sm_90a).
//
// Replaces the Pallas TPU kernel thevc_tpu/ops/jx_pallas.py:_satd_kernel
// (:63-89, launched at :115 by satd_sweep_planar).  For each PU n and
// candidate m, with D = org[n] - pred[n][m] cut into 8x8 blocks when the
// PU size is a multiple of 8 and into 4x4 blocks otherwise:
//   sad(block) = sum |H D_block H|,  H the Sylvester Hadamard matrix
//   norm       = (sad + 2) >> 2 for 8x8, (sad + 1) >> 1 for 4x4
//   out[n][m]  = (sum of norm over the PU's blocks) >> bit_inc
// which is HM's xCalcHADs8x8 / xCalcHADs4x4 summed over the PU
// (TComRdCost.cpp; bit-exact with thevc_tpu/encoder/rdcost.py
// calc_had_batched).  All of it is int32 and exact: a 10-bit difference is
// below 2^11, each block sum below 64 * 64 * 2^11, and a 64x64 PU's sum
// below 64 blocks * 2^20.
//
// What bounds it on this card: it reads every candidate sample once (int16)
// and does about 6 integer adds per sample (two 3-stage butterflies, the
// abs and the sum), so it is bound by device-memory bandwidth.  At 1080p
// each size class reads about 146 MB of candidates, about 45 us at
// 3.35 TB/s (an estimate from the published peak).  Design: the layout is
// the natural [N, M, s, s] (the TPU's planar [b*b, N] layout and its
// padding to 512 columns existed for 128-wide lanes); the difference is
// formed in registers, so the int32 difference [N*M, s, s] never reaches
// device memory; one thread owns one Hadamard block, loads its rows with
// 16-byte (8x8) or 8-byte (4x4) vector loads, runs the butterflies in
// registers, and a block of 256 threads owns 256 / blocks-per-PU whole
// (PU, candidate) pairs, summed through shared memory.  The original block
// is shared by the M candidates of a PU and is served from cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// in-place Sylvester Walsh-Hadamard transform of B values
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

// one row of B int16 samples, as a 16-byte (B = 8) or 8-byte (B = 4) load
template <int B>
__device__ __forceinline__ void load_row(const int16_t* p, int (&v)[B]) {
  if constexpr (B == 8) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = (int16_t)(u[i] & 0xffffu);
      v[2 * i + 1] = (int16_t)(u[i] >> 16);
    }
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = (int16_t)(w.x & 0xffffu);
    v[1] = (int16_t)(w.x >> 16);
    v[2] = (int16_t)(w.y & 0xffffu);
    v[3] = (int16_t)(w.y >> 16);
  }
}

template <int S, int B>
__global__ void __launch_bounds__(kThreads)
satd_kernel(const int16_t* __restrict__ org, const int16_t* __restrict__ pred,
            int32_t* __restrict__ out, long long pairs, int m, int bit_inc) {
  constexpr int BPR = S / B;         // blocks per PU row
  constexpr int NB = BPR * BPR;      // blocks per PU
  constexpr int PPB = kThreads / NB; // (PU, candidate) pairs per CUDA block
  __shared__ int32_t sad_s[kThreads];

  const int tid = threadIdx.x;
  const long long p = (long long)blockIdx.x * PPB + tid / NB;
  int norm = 0;
  if (p < pairs) {
    const int blk = tid % NB;
    const int off = (blk / BPR) * B * S + (blk % BPR) * B;
    const int16_t* pp = pred + p * (S * S) + off;
    const int16_t* oo = org + (p / m) * (S * S) + off;
    int d[B][B];
#pragma unroll
    for (int r = 0; r < B; ++r) {
      int o[B], c[B];
      load_row<B>(oo + r * S, o);
      load_row<B>(pp + r * S, c);
#pragma unroll
      for (int k = 0; k < B; ++k) d[r][k] = o[k] - c[k];
      fwht<B>(d[r]);                   // rows
    }
    int sum = 0;
#pragma unroll
    for (int k = 0; k < B; ++k) {      // columns
      int col[B];
#pragma unroll
      for (int r = 0; r < B; ++r) col[r] = d[r][k];
      fwht<B>(col);
#pragma unroll
      for (int r = 0; r < B; ++r) sum += abs(col[r]);
    }
    norm = B == 8 ? (sum + 2) >> 2 : (sum + 1) >> 1;
  }
  sad_s[tid] = norm;
  __syncthreads();

  if (tid < PPB) {
    const long long q = (long long)blockIdx.x * PPB + tid;
    if (q < pairs) {
      int acc = 0;
#pragma unroll
      for (int i = 0; i < NB; ++i) acc += sad_s[tid * NB + i];
      out[q] = acc >> bit_inc;
    }
  }
}

template <int S, int B>
void launch(const void* org, const void* pred, void* out, long long pairs,
            int m, int bit_inc, cudaStream_t stream) {
  constexpr int PPB = kThreads / ((S / B) * (S / B));
  const long long blocks = (pairs + PPB - 1) / PPB;
  satd_kernel<S, B><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int16_t*>(org), static_cast<const int16_t*>(pred),
      static_cast<int32_t*>(out), pairs, m, bit_inc);
}

}  // namespace

// org: int16 [n, size, size]; pred: int16 [n, m, size, size]; out: int32
// [n, m]; all device pointers, contiguous, 16-byte aligned.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int thevc_satd(const void* org, const void* pred, void* out,
                          long long n, int m, int size, int bit_inc,
                          void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (bit_inc < 0 || bit_inc > 30) return (int)cudaErrorInvalidValue;
  const long long pairs = n * m;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 4: launch<4, 4>(org, pred, out, pairs, m, bit_inc, st); break;
    case 8: launch<8, 8>(org, pred, out, pairs, m, bit_inc, st); break;
    case 16: launch<16, 8>(org, pred, out, pairs, m, bit_inc, st); break;
    case 32: launch<32, 8>(org, pred, out, pairs, m, bit_inc, st); break;
    case 64: launch<64, 8>(org, pred, out, pairs, m, bit_inc, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
