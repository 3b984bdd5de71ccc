// FedAvg weighted cohort sum for Hopper (sm_90a): out[p] = sum_k w[k] u[k, p].
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_reduce.py
// (_reduce_kernel, launched by fedavg_reduce's pallas_call): a (1, K) x
// (K, P) product with an fp32 accumulator, the update rows in fp32 or bf16
// (the bf16 lane's rows, upcast in the tile there, as here).
//
// What bounds it on this card: bytes.  It reads K*P update values once and
// writes P outputs, two flops per value read: at the main path's K = 10,
// P = 159,010 that is about 7.0 MB, a bound near 2.1 us at 3.35 TB/s (bf16
// rows: 3.8 MB, 1.1 us).
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
//
// bf16 rows: the same kernel over 2-byte elements (the row type E is a
// template parameter).  A run of VEC columns is one VEC*2-byte load
// (VEC = 2 at the main path's P: 4 bytes a row), each value widened to fp32
// exactly (a bf16 is the high half of its fp32), then the same fmaf chain in
// the same order.  The output stays fp32.
//
// B2g, fedavg_reduce_grid_kernel: G lanes' sums in one launch, out[g, p] =
// sum_k w[g, k] u[g, k, p], the lane as the grid's second dimension
// (blockIdx.y).  Each lane runs the same column code on its own rows,
// weights and output row, so a lane is bitwise B2 on that lane.  With VEC
// dividing P, every lane's rows start VEC-aligned when the first lane's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define GROUP 8  // rows a thread loads ahead of its FMA chain

// A run of VEC adjacent elements of type E: the type one load moves, and
// its values widened to fp32 (exactly).
template <typename E, int VEC>
struct Run;
template <>
struct Run<float, 1> {
  using T = float;
  static __device__ __forceinline__ void widen(T v, float* x) { x[0] = v; }
};
template <>
struct Run<float, 2> {
  using T = float2;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = v.x;
    x[1] = v.y;
  }
};
template <>
struct Run<float, 4> {
  using T = float4;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

// bf16 bits -> fp32 (element 0 of a run in the low half: little-endian)
__device__ __forceinline__ float bf16_bits(unsigned bits) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(bits & 0xffffu)));
}
template <>
struct Run<__nv_bfloat16, 1> {
  using T = unsigned short;
  static __device__ __forceinline__ void widen(T v, float* x) { x[0] = bf16_bits(v); }
};
template <>
struct Run<__nv_bfloat16, 2> {
  using T = unsigned int;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = bf16_bits(v);
    x[1] = bf16_bits(v >> 16);
  }
};
template <>
struct Run<__nv_bfloat16, 4> {
  using T = uint2;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = bf16_bits(v.x);
    x[1] = bf16_bits(v.x >> 16);
    x[2] = bf16_bits(v.y);
    x[3] = bf16_bits(v.y >> 16);
  }
};

template <typename E, int VEC>
__device__ __forceinline__ void fma_vec(float* acc, float w, typename Run<E, VEC>::T v) {
  float x[VEC];
  Run<E, VEC>::widen(v, x);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = fmaf(w, x[j], acc[j]);
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

// This thread's run of VEC columns of one (K, P) cohort: the fmaf chain over
// ascending k from 0.0, stored to out.
template <typename E, int VEC>
__device__ __forceinline__ void reduce_run(const E* __restrict__ updates,
                                           const float* __restrict__ weights, int k_rows,
                                           long long p_cols, float* __restrict__ out) {
  using T = typename Run<E, VEC>::T;
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
      if (k0 + j < k_rows) fma_vec<E, VEC>(acc, w_cur[j], cur[j]);
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      cur[j] = next[j];
      w_cur[j] = w_next[j];
    }
  }
  store_vec(out + col, acc, typename Run<float, VEC>::T{});
}

template <typename E, int VEC>
__global__ void __launch_bounds__(THREADS) fedavg_reduce_kernel(
    const E* __restrict__ updates, const float* __restrict__ weights, int k_rows,
    long long p_cols, float* __restrict__ out) {
  reduce_run<E, VEC>(updates, weights, k_rows, p_cols, out);
}

template <typename E, int VEC>
__global__ void __launch_bounds__(THREADS) fedavg_reduce_grid_kernel(
    const E* __restrict__ updates, const float* __restrict__ weights, int k_rows,
    long long p_cols, float* __restrict__ out) {
  const long long g = blockIdx.y;
  reduce_run<E, VEC>(updates + g * k_rows * p_cols, weights + g * k_rows, k_rows, p_cols,
                     out + g * p_cols);
}

// One launch of B2 (lanes == 0: a 1-D grid) or B2g (lanes >= 1: a lane a
// grid row).
template <typename E, int VEC>
static void launch_vec(const E* updates, const float* weights, int lanes, int k_rows,
                       long long p_cols, float* out, unsigned blocks, cudaStream_t st) {
  if (lanes == 0)
    fedavg_reduce_kernel<E, VEC><<<blocks, THREADS, 0, st>>>(updates, weights, k_rows, p_cols,
                                                             out);
  else
    fedavg_reduce_grid_kernel<E, VEC><<<dim3(blocks, lanes), THREADS, 0, st>>>(
        updates, weights, k_rows, p_cols, out);
}

template <typename E>
static int launch_rows(const E* updates, const float* weights, int lanes, int k_rows,
                       long long p_cols, int vec, float* out, unsigned blocks, cudaStream_t st) {
  switch (vec) {
    case 4:
      launch_vec<E, 4>(updates, weights, lanes, k_rows, p_cols, out, blocks, st);
      break;
    case 2:
      launch_vec<E, 2>(updates, weights, lanes, k_rows, p_cols, out, blocks, st);
      break;
    case 1:
      launch_vec<E, 1>(updates, weights, lanes, k_rows, p_cols, out, blocks, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

static int launch_any(const void* updates, int row_bytes, const float* weights, int lanes,
                      int k_rows, long long p_cols, int vec, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long threads_needed = p_cols / vec;
  const unsigned blocks = (unsigned)((threads_needed + THREADS - 1) / THREADS);
  if (blocks == 0) return (int)cudaSuccess;
  if (row_bytes == 4)
    return launch_rows(static_cast<const float*>(updates), weights, lanes, k_rows, p_cols, vec,
                       out, blocks, st);
  if (row_bytes == 2)
    return launch_rows(static_cast<const __nv_bfloat16*>(updates), weights, lanes, k_rows,
                       p_cols, vec, out, blocks, st);
  return (int)cudaErrorInvalidValue;
}

// Launch on `stream`.  `row_bytes` is the update rows' element size: 4
// (fp32) or 2 (bf16).  `vec` (1, 2 or 4) must divide p_cols, the rows must
// be aligned to vec * row_bytes bytes and out to vec * 4 (the wrapper picks
// it).  Allocates nothing; returns cudaGetLastError() (0 = success).
extern "C" int fedavg_reduce_launch(const void* updates, int row_bytes, const float* weights,
                                    int k_rows, long long p_cols, int vec, float* out,
                                    void* stream) {
  return launch_any(updates, row_bytes, weights, 0, k_rows, p_cols, vec, out, stream);
}

// B2g: `lanes` (1 .. 65,535) cohorts of (k_rows, p_cols) rows, lane-major,
// (lanes, k_rows) weights, (lanes, p_cols) out; otherwise as above.
extern "C" int fedavg_reduce_grid_launch(const void* updates, int row_bytes,
                                         const float* weights, int lanes, int k_rows,
                                         long long p_cols, int vec, float* out, void* stream) {
  if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  return launch_any(updates, row_bytes, weights, lanes, k_rows, p_cols, vec, out, stream);
}
