// Fused dequant + 2-D inverse DCT/DST for a batch of TUs of one size class:
// the decoder's stage-1 residual core on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel thevc_tpu/ops/jx_pallas.py:_kernel
// (:141-187, launched at :228).  Per TU, with basis T (DCT, or the 4x4 DST
// for intra luma) and per-TU dequant scale:
//   D[n][j] = clip16((X[n][j] * scale + (1 << (dq_shift - 1))) >> dq_shift)
//   U[k][j] = clip16((sum_n T[n][k] * D[n][j] + 64) >> 7)
//   O[r][c] = clip16((sum_n U[r][n] * T[n][c] + (1 << (sh2 - 1))) >> sh2)
// which is HM's xDeQuant followed by xITrMxN (TComTrQuant.cpp).  All sums
// are int32 and exact: |X * scale| < 2^31 for scaled QP <= 63, and each
// pass sums at most 32 products of |T| <= 90 and |D| <= 2^15.
//
// What bounds it on this card: at 32x32 each output sample takes 2 * 32
// int32 multiply-adds against 4 bytes of device-memory traffic (int16 in,
// int16 out), so the kernel is bound by CUDA-core integer MACs and shared-
// memory reads, not by HBM.  Design: the layout is the natural [N, s, s]
// (the TPU's planar [s*s, N] layout and its padding existed for 128-wide
// lanes); each block takes 1024 coefficients (one TU at 32x32, 4 at 16x16,
// 16 at 8x8, 64 at 4x4), dequantises them into shared memory on the load,
// runs both passes out of shared memory with the basis there too, and
// writes int16.  Consecutive threads own consecutive columns, so the
// basis or tile operand of each multiply-add is either a broadcast or a
// conflict-free row of banks.  A partial-butterfly form would cut the MACs
// about fourfold at 32x32 and is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // coefficients per block

__device__ __forceinline__ int clip16(int v) {
  return min(32767, max(-32768, v));
}

template <int S>
__global__ void __launch_bounds__(kThreads)
residual_kernel(const int16_t* __restrict__ x, const int32_t* __restrict__ scale,
                const int32_t* __restrict__ basis, int16_t* __restrict__ out,
                int n, int dq_shift, int sh2) {
  constexpr int SS = S * S;
  constexpr int TPB = kTile / SS;  // TUs per block
  __shared__ int32_t t_s[SS];      // basis, row n = basis function n
  __shared__ int32_t d_s[kTile];   // dequantised coefficients
  __shared__ int32_t u_s[kTile];   // after pass 1

  const int tid = threadIdx.x;
  const long long tu0 = (long long)blockIdx.x * TPB;
  const int count = (int)min((long long)TPB, (long long)n - tu0) * SS;
  const long long base = tu0 * SS;

  for (int i = tid; i < SS; i += kThreads) t_s[i] = basis[i];
  const int dq_add = 1 << (dq_shift - 1);
  for (int e = tid; e < count; e += kThreads) {
    const int v = x[base + e];
    d_s[e] = clip16((v * scale[tu0 + e / SS] + dq_add) >> dq_shift);
  }
  __syncthreads();

  // pass 1 (columns): U[k][j] = sum_n T[n][k] * D[n][j]
  for (int e = tid; e < count; e += kThreads) {
    const int t = e / SS, k = (e / S) % S, j = e % S;
    const int32_t* d = d_s + t * SS + j;
    int acc = 0;
#pragma unroll
    for (int m = 0; m < S; ++m) acc += t_s[m * S + k] * d[m * S];
    u_s[e] = clip16((acc + 64) >> 7);
  }
  __syncthreads();

  // pass 2 (rows): O[r][c] = sum_n U[r][n] * T[n][c]
  const int r2 = 1 << (sh2 - 1);
  for (int e = tid; e < count; e += kThreads) {
    const int t = e / SS, r = (e / S) % S, c = e % S;
    const int32_t* u = u_s + t * SS + r * S;
    int acc = 0;
#pragma unroll
    for (int m = 0; m < S; ++m) acc += u[m] * t_s[m * S + c];
    out[base + e] = (int16_t)clip16((acc + r2) >> sh2);
  }
}

template <int S>
void launch(const void* x, const void* scale, const void* basis, void* out,
            int n, int dq_shift, int sh2, cudaStream_t stream) {
  constexpr int TPB = kTile / (S * S);
  const int blocks = (n + TPB - 1) / TPB;
  residual_kernel<S><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int16_t*>(x), static_cast<const int32_t*>(scale),
      static_cast<const int32_t*>(basis), static_cast<int16_t*>(out), n,
      dq_shift, sh2);
}

}  // namespace

// x: int16 [n, size, size]; scale: int32 [n]; basis: int32 [size, size];
// out: int16 [n, size, size]; all device pointers, contiguous.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int thevc_residual(const void* x, const void* scale,
                              const void* basis, void* out, int n, int size,
                              int dq_shift, int sh2, void* stream) {
  if (n <= 0) return 0;
  if (dq_shift < 1 || sh2 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 4: launch<4>(x, scale, basis, out, n, dq_shift, sh2, st); break;
    case 8: launch<8>(x, scale, basis, out, n, dq_shift, sh2, st); break;
    case 16: launch<16>(x, scale, basis, out, n, dq_shift, sh2, st); break;
    case 32: launch<32>(x, scale, basis, out, n, dq_shift, sh2, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* thevc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
