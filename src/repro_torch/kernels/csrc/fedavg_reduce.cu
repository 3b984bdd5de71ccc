// FedAvg weighted cohort sum for Hopper (sm_90a): out[g, p] = sum_k w[g, k] u[g, k, p].
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_reduce.py
// (_reduce_kernel, launched by fedavg_reduce's pallas_call): a (1, K) x
// (K, P) product with an fp32 accumulator, the update rows in fp32 or bf16
// (the bf16 lane's rows, upcast in the tile there, as here).  One kernel
// serves B2, fedavg_reduce (one lane), and B2g, fedavg_reduce_grid (G lanes
// in one launch, the lane as the grid's second dimension, as the
// reference's engine runs the kernel under its grid's vmap).
//
// What bounds it on this card: bytes.  It reads K*P update values once and
// writes P outputs, two flops per value read: at the main path's K = 10,
// P = 159,010 about 7.0 MB, 2.1 us at 3.35 TB/s (bf16 rows 3.8 MB, 1.1 us);
// at the bench grid's G = 24, K = 2 45.8 MB, 13.7 us (bf16 rows 30.5 MB,
// 9.1 us).
//
// What holds a streamer short of that bound: bytes in flight and the
// threads that carry them.  A thread that owns one run of VEC columns and
// lives for one load a row (VEC = 2 at every catalog model's P, 2 mod 4)
// keeps 8 bytes a row in flight, 4 on bf16 rows; on the bench grid that is
// 1.9 million threads in 14,928 blocks, and bf16 rows, two-thirds of the
// bytes, took as long as fp32 rows (20.3 against 19.6 us on an H100).
//
// Design: a thread owns RUNS runs of VEC columns of one column tile (run u
// of thread t at run (tile * RUNS + u) * THREADS + t, so each warp load is
// coalesced) and issues every row's loads for all its runs before the first
// FMA.  The wide plan takes RUNS = 16 / (VEC * element size): 16 bytes a
// thread a row whatever P's residue and the element size, so bf16 rows keep
// as many bytes in flight as fp32 rows with half the threads.  Loads go out
// in groups of LOADS = GROUP rows x RUNS runs, the next group issued before
// the current one's FMAs (at K <= GROUP the whole cohort is one group).  The
// grid is (tiles, lanes), a block a column tile of THREADS * VEC * RUNS
// columns; a thread past the row leaves at once (measured faster at the
// main path's one lane than predicating its loads).  The wrapper's plan
// (kernels/fedavg_reduce.py::column_plan) takes the wide runs where the
// lanes' tiles at that width give every SM FILL_PER_SM blocks, else one run
// a thread.
//
// Why this design: of the three ways to keep 16 bytes a thread a row, this
// one (several runs a thread, all their loads first) needs no realignment
// and no shared memory, and it measured at 0.84-0.91 of the bytes bound on
// the grids (H100 80GB HBM3 at 700 W, chip_smoke.py --wrapper-times, graph
// replay): the bench grid's (24, 2, 159,010) in 16.1-16.2 us on fp32 rows
// (of 13.7) and 10.1-10.3 us on bf16 rows (of 9.1), fl-cifar10-cnn's (24,
// 2, 1,070,794) in 101.2 / 70.5-71.0 us (of 92.1 / 61.4).  Aligned 16-byte
// loads realigned in registers could gain at most the rest and cost a
// funnel shift per word and a head and tail per row; staging through shared
// memory with cp.async measured slower than 8-byte pairs for rsu_reduce's
// rows.  A block a tile beat a wave of blocks walking tiles at every shape
// timed.
//
// Order: each output is one fmaf chain over ascending k from +0.0, whatever
// the plan, so a run repeats itself bitwise, lane g of B2g is bitwise B2 on
// that lane, and rule 0 of server_update (the same chain) equals this sum
// plus the AXPY bit for bit.  The weights (K floats a lane) come through the
// read-only cache.  bf16 rows widen to fp32 exactly at the FMA (a bf16 is
// the high half of its fp32).  64-bit offsets between lanes and rows: a
// grid may pass 2^31 elements (a row's runs stay below 2^31).  No shared
// memory, no atomics, no second pass.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define LOADS 8  // row loads a thread issues in a group: GROUP rows x RUNS runs

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

// The wide plan's runs a thread: RUNS runs of VEC elements make 16 bytes.
template <typename E, int VEC>
constexpr int wide_runs() {
  return 16 / (VEC * (int)sizeof(E)) > 1 ? 16 / (VEC * (int)sizeof(E)) : 1;
}

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

// Rows k0 .. k0 + GROUP - 1 of this thread's RUNS runs (run u's row 0 at
// src[u]) and their weights; rows past the cohort and runs past the row read
// as 0 and are never stored.
template <typename T, int GROUP, int RUNS>
__device__ __forceinline__ void load_group(T (&v)[GROUP][RUNS], float (&w)[GROUP],
                                           const T* const (&src)[RUNS],
                                           const bool (&live)[RUNS],
                                           const float* __restrict__ weights, int k0,
                                           int k_rows, int row) {
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const bool in = k0 + j < k_rows;
    w[j] = in ? __ldg(weights + k0 + j) : 0.0f;
#pragma unroll
    for (int u = 0; u < RUNS; ++u)
      v[j][u] = in && live[u] ? __ldg(src[u] + (long long)(k0 + j) * row) : T{};
  }
}

// B2 (gridDim.y == 1) and B2g: this thread's RUNS runs of column tile
// blockIdx.x of lane blockIdx.y's (K, P) rows, K weights and P outputs: the
// fmaf chain over ascending k from 0.0 for each column, stored to out.
template <typename E, int VEC, int RUNS>
__global__ void __launch_bounds__(THREADS) fedavg_reduce_kernel(
    const E* __restrict__ updates, const float* __restrict__ weights, int k_rows,
    long long p_cols, float* __restrict__ out) {
  using T = typename Run<E, VEC>::T;
  constexpr int GROUP = LOADS / RUNS;
  const long long g = blockIdx.y;
  updates += g * k_rows * p_cols;
  weights += g * k_rows;
  out += g * p_cols;
  const int row = (int)(p_cols / VEC);  // one row of updates, in runs
  int run[RUNS];
  bool live[RUNS];
  const T* src[RUNS];
#pragma unroll
  for (int u = 0; u < RUNS; ++u) {
    run[u] = (blockIdx.x * RUNS + u) * THREADS + threadIdx.x;
    live[u] = run[u] < row;
    src[u] = reinterpret_cast<const T*>(updates) + run[u];
  }
  if (!live[0]) return;  // past the row: so are the later runs
  float acc[RUNS][VEC];
#pragma unroll
  for (int u = 0; u < RUNS; ++u)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[u][j] = 0.0f;
  T cur[GROUP][RUNS];
  float w_cur[GROUP];
  load_group(cur, w_cur, src, live, weights, 0, k_rows, row);
  for (int k0 = 0; k0 < k_rows; k0 += GROUP) {
    T next[GROUP][RUNS];
    float w_next[GROUP];
    load_group(next, w_next, src, live, weights, k0 + GROUP, k_rows, row);  // in flight meanwhile
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (k0 + j < k_rows)
#pragma unroll
        for (int u = 0; u < RUNS; ++u) fma_vec<E, VEC>(acc[u], w_cur[j], cur[j][u]);
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      w_cur[j] = w_next[j];
#pragma unroll
      for (int u = 0; u < RUNS; ++u) cur[j][u] = next[j][u];
    }
  }
#pragma unroll
  for (int u = 0; u < RUNS; ++u)
    if (live[u]) store_vec(out + (long long)run[u] * VEC, acc[u], typename Run<float, VEC>::T{});
}

template <typename E>
using Kernel = void (*)(const E*, const float*, int, long long, float*);

// The instantiation for (vec, runs): runs is 1 or the wide plan's count.
template <typename E, int VEC>
static Kernel<E> kernel_runs(int runs) {
  constexpr int WIDE = wide_runs<E, VEC>();
  if (runs == 1) return fedavg_reduce_kernel<E, VEC, 1>;
  if (runs == WIDE) return fedavg_reduce_kernel<E, VEC, WIDE>;
  return nullptr;
}

template <typename E>
static Kernel<E> kernel_for(int vec, int runs) {
  switch (vec) {
    case 4:
      return kernel_runs<E, 4>(runs);
    case 2:
      return kernel_runs<E, 2>(runs);
    case 1:
      return kernel_runs<E, 1>(runs);
    default:
      return nullptr;
  }
}

template <typename E>
static int launch_rows(const void* updates, const float* weights, int lanes, int k_rows,
                       long long p_cols, int vec, int runs, float* out, cudaStream_t st) {
  const Kernel<E> kernel = kernel_for<E>(vec, runs);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const long long per_tile = (long long)THREADS * vec * runs;
  const long long tiles = (p_cols + per_tile - 1) / per_tile;
  kernel<<<dim3((unsigned)tiles, (unsigned)lanes), THREADS, 0, st>>>(
      static_cast<const E*>(updates), weights, k_rows, p_cols, out);
  return (int)cudaGetLastError();
}

// Launch on `stream`: `lanes` (1 .. 65,535) cohorts of (k_rows, p_cols)
// rows, lane-major, (lanes, k_rows) weights, (lanes, p_cols) out; B2 is
// lanes = 1.  `row_bytes` is the rows' element size: 4 (fp32) or 2 (bf16).
// The plan (kernels/fedavg_reduce.py::column_plan): `vec` (1, 2 or 4) must
// divide p_cols, the rows must be aligned to vec * row_bytes bytes and out
// to vec * 4; `runs` is 1 or 16 / (vec * row_bytes) (at least 1).  A block
// a column tile of THREADS * vec * runs columns of a lane; a row's runs
// number below 2^31.  Allocates nothing; returns cudaGetLastError() (0 =
// success).
extern "C" int fedavg_reduce_launch(const void* updates, int row_bytes, const float* weights,
                                    int lanes, int k_rows, long long p_cols, int vec, int runs,
                                    float* out, void* stream) {
  if (lanes < 1 || lanes > 65535 || k_rows < 1 || p_cols < 0 || vec < 1 ||
      p_cols % vec != 0 || p_cols / vec > INT_MAX - THREADS * LOADS)
    return (int)cudaErrorInvalidValue;
  if (p_cols == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_bytes == 4)
    return launch_rows<float>(updates, weights, lanes, k_rows, p_cols, vec, runs, out, st);
  if (row_bytes == 2)
    return launch_rows<__nv_bfloat16>(updates, weights, lanes, k_rows, p_cols, vec, runs, out,
                                      st);
  return (int)cudaErrorInvalidValue;
}
