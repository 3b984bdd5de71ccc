// FedAvg weighted cohort sum for Hopper (sm_90a): out[p] = sum_k w[k] u[k, p].
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_reduce.py
// (_reduce_kernel, launched by fedavg_reduce's pallas_call): a (1, K) x
// (K, P) product with an fp32 accumulator.
//
// What bounds it on this card: bytes.  It reads K*P update values once and
// writes P outputs, two flops per value read: at the main path's K = 10,
// P = 159,010 that is about 7.0 MB, a bound near 2.1 us at 3.35 TB/s.
//
// Design: a GEMV with no reuse to exploit, so the kernel only has to stream
// the update matrix once at full width.  Each thread owns a run of VEC
// adjacent columns, loads them with one VEC*4-byte vector load per row
// (neighbouring threads on neighbouring addresses, so every warp load is
// coalesced), and walks k in ascending order with an fp32 FMA accumulator.
// The order of summation is fixed, so a run repeats itself bitwise.  The
// weights (K floats) are read through the read-only cache.  No shared memory,
// no atomics, no second pass.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

__device__ __forceinline__ void fma_vec(float* acc, float w, float v) {
  acc[0] = fmaf(w, v, acc[0]);
}
__device__ __forceinline__ void fma_vec(float* acc, float w, float2 v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
}
__device__ __forceinline__ void fma_vec(float* acc, float w, float4 v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
  acc[2] = fmaf(w, v.z, acc[2]);
  acc[3] = fmaf(w, v.w, acc[3]);
}

__device__ __forceinline__ void store_vec(float* out, const float* acc, float) {
  *out = acc[0];
}
__device__ __forceinline__ void store_vec(float* out, const float* acc, float2) {
  *reinterpret_cast<float2*>(out) = make_float2(acc[0], acc[1]);
}
__device__ __forceinline__ void store_vec(float* out, const float* acc, float4) {
  *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <int VEC>
__global__ void fedavg_reduce_kernel(const float* __restrict__ updates,
                                     const float* __restrict__ weights, int k_rows,
                                     long long p_cols, float* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  const long long col = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= p_cols) return;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  for (int k = 0; k < k_rows; ++k) {
    const float w = __ldg(weights + k);
    fma_vec(acc, w, __ldg(reinterpret_cast<const T*>(updates + (long long)k * p_cols + col)));
  }
  store_vec(out + col, acc, T{});
}

// Launch on `stream`; `vec` (1, 2 or 4) must divide p_cols and the pointers
// must be aligned to vec * 4 bytes (the wrapper picks it).  Allocates
// nothing; returns cudaGetLastError() (0 = success).
extern "C" int fedavg_reduce_launch(const float* updates, const float* weights,
                                    int k_rows, long long p_cols, int vec, float* out,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long threads_needed = p_cols / vec;
  const unsigned blocks = (unsigned)((threads_needed + THREADS - 1) / THREADS);
  if (blocks == 0) return (int)cudaSuccess;
  switch (vec) {
    case 4:
      fedavg_reduce_kernel<4><<<blocks, THREADS, 0, st>>>(updates, weights, k_rows, p_cols, out);
      break;
    case 2:
      fedavg_reduce_kernel<2><<<blocks, THREADS, 0, st>>>(updates, weights, k_rows, p_cols, out);
      break;
    case 1:
      fedavg_reduce_kernel<1><<<blocks, THREADS, 0, st>>>(updates, weights, k_rows, p_cols, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
