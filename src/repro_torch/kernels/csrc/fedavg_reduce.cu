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
// Design: a GEMV with no reuse to exploit, so the kernel only has to keep
// enough bytes in flight to stream the update matrix once at full rate.
// Each thread owns a run of VEC adjacent columns (VEC by alignment: the
// main path's rows are 8-byte aligned, VEC = 2) and loads them with one
// VEC*4-byte vector load per row, neighbouring threads on neighbouring
// addresses, so every warp load is coalesced.  It issues its rows' loads a
// group of GROUP = 8 ahead of the FMA chain that consumes them: the next
// group's loads go out before the current group's FMAs, so at K = 10 all
// ten rows are in flight at once, where one load at a time was before.
// Blocks of 128 threads give the 132 SMs an even share (4.7 blocks an SM
// at the main path's P).  The chain walks k in ascending order from 0.0
// with fmaf, so a run repeats itself bitwise and rule 0 of server_update
// (the same chain) equals this sum plus the AXPY bit for bit.  The weights
// (K floats) come through the read-only cache.  No shared memory, no
// atomics, no second pass.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define GROUP 8  // rows a thread loads ahead of its FMA chain

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

// Rows k0 .. k0 + GROUP - 1 of this thread's columns and their weights; rows
// past the cohort read as 0 and are never consumed.
template <typename T>
__device__ __forceinline__ void load_group(T* v, float* w, const T* __restrict__ col,
                                           const float* __restrict__ weights, int k0,
                                           int k_rows, long long row) {
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    if (k0 + j < k_rows) {
      v[j] = __ldg(col + (long long)(k0 + j) * row);
      w[j] = __ldg(weights + k0 + j);
    } else {
      v[j] = T{};
      w[j] = 0.0f;
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS) fedavg_reduce_kernel(
    const float* __restrict__ updates, const float* __restrict__ weights, int k_rows,
    long long p_cols, float* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  const long long col = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (col >= p_cols) return;
  const T* src = reinterpret_cast<const T*>(updates + col);
  const long long row = p_cols / VEC;  // one row of updates, in T
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  T cur[GROUP];
  float w_cur[GROUP];
  load_group(cur, w_cur, src, weights, 0, k_rows, row);
  for (int k0 = 0; k0 < k_rows; k0 += GROUP) {
    T next[GROUP];
    float w_next[GROUP];
    load_group(next, w_next, src, weights, k0 + GROUP, k_rows, row);  // in flight meanwhile
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (k0 + j < k_rows) fma_vec(acc, w_cur[j], cur[j]);
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      cur[j] = next[j];
      w_cur[j] = w_next[j];
    }
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
