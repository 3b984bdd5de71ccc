// Segment reduce of client updates by RSU attachment for Hopper (sm_90a):
//
//   partials[r, p] = carry[r, p] + sum_k m[k, r] * u[k, p]
//   mass[r]        = sum_k m[k, r],      m[k, r] = (rid[k] == r) ? w[k] : 0
//
// Replaces the Pallas TPU kernel src/repro/kernels/rsu_reduce.py (_seg_kernel,
// launched by rsu_reduce's pallas_call): the edge half of two-tier FedAvg,
// one (R, K) x (K, P) product against the one-hot routing matrix.
//
// What bounds it on this card: bytes.  It reads K*P update values once (and
// the R*P carry, when there is one) and writes R*P partials, 2*R flops per
// value read: at the streamed lane's chunk (K = 4, P = 159,010, R = 10, with
// the carry) that is about 15.3 MB, a bound near 4.6 us at 3.35 TB/s.
//
// Design: a grid axis over groups of RSU_GROUP (32) RSUs, so R is bounded
// only by the grid's y-extent (65,535 groups).  Each thread owns a run of VEC
// adjacent columns and keeps one fp32 accumulator per RSU of its block's
// group and column in registers (RB accumulators per column, RB a
// compile-time bound on the group's size).  It walks k in ascending order
// from +0.0 and adds the one-hot product itself, (rid[k] == r ? w[k] : 0) *
// u[k, p], to every RSU's accumulator of its group: the rows of other RSUs
// are not skipped, so a non-finite row and signed zeros come out as the
// reference's contraction gives them.  Loads are VEC*4-byte vectors on
// neighbouring addresses, so every warp load is coalesced; w and rid (K
// values each) come through the read-only cache.  The carry is added once,
// after the sum: carry + sum, which rounds as the round's ``partials +
// part_c`` does, and out may alias carry (each thread reads its carry
// columns before writing them), so a chunk walk updates its (R, P)
// partials in place.  The first block of each group also writes the
// group's mass: thread r sums column r0 + r of the routing matrix in
// ascending k.  The order of every sum is fixed, so a run repeats itself
// bitwise.  With R > 32 every group's block reads the K update rows again
// (from L2 at the streamed lane's chunk sizes).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define RSU_GROUP 32    // RSUs per block (grid axis y)
#define MAX_GROUPS 65535u

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

__device__ __forceinline__ void unpack(float* x, float v) { x[0] = v; }
__device__ __forceinline__ void unpack(float* x, float2 v) {
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ void unpack(float* x, float4 v) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void pack(float* out, const float* x, float) { *out = x[0]; }
__device__ __forceinline__ void pack(float* out, const float* x, float2) {
  *reinterpret_cast<float2*>(out) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void pack(float* out, const float* x, float4) {
  *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
}

template <int VEC, int RB>
__global__ void rsu_reduce_kernel(const float* __restrict__ updates,
                                  const float* __restrict__ weights,
                                  const int* __restrict__ rid, int k_rows, int n_rsu,
                                  long long p_cols, const float* carry, float* out,
                                  float* __restrict__ mass) {
  using T = typename Vec<VEC>::T;
  const int r0 = blockIdx.y * RSU_GROUP;  // this block's group: RSUs r0 .. r0 + nr - 1
  const int nr = min(RSU_GROUP, n_rsu - r0);
  if (blockIdx.x == 0 && threadIdx.x < nr) {
    const int r = r0 + threadIdx.x;
    float m = 0.0f;
    for (int k = 0; k < k_rows; ++k) m = m + (__ldg(rid + k) == r ? __ldg(weights + k) : 0.0f);
    mass[r] = m;
  }
  const long long col = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= p_cols) return;
  float acc[RB][VEC];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.0f;
  for (int k = 0; k < k_rows; ++k) {
    const float w = __ldg(weights + k);
    const int rk = __ldg(rid + k);
    float u[VEC];
    unpack(u, __ldg(reinterpret_cast<const T*>(updates + (long long)k * p_cols + col)));
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float m = rk == r0 + r ? w : 0.0f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(m, u[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= nr) break;
    float* dst = out + (long long)(r0 + r) * p_cols + col;
    if (carry != nullptr) {
      float c[VEC];
      unpack(c, *reinterpret_cast<const T*>(carry + (long long)(r0 + r) * p_cols + col));
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] = c[j] + acc[r][j];
    }
    pack(dst, acc[r], T{});
  }
}

template <int VEC>
static int launch_rb(int rb, dim3 blocks, cudaStream_t st, const float* updates,
                     const float* weights, const int* rid, int k_rows, int n_rsu,
                     long long p_cols, const float* carry, float* out, float* mass) {
#define RSU_CASE(RB_)                                                                  \
  case RB_:                                                                            \
    rsu_reduce_kernel<VEC, RB_><<<blocks, THREADS, 0, st>>>(                           \
        updates, weights, rid, k_rows, n_rsu, p_cols, carry, out, mass);               \
    break;
  switch (rb) {
    RSU_CASE(1)
    RSU_CASE(2)
    RSU_CASE(4)
    RSU_CASE(8)
    RSU_CASE(16)
    RSU_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RSU_CASE
  return (int)cudaSuccess;
}

// Launch on `stream`.  `carry` may be null (the sum alone) or equal to `out`
// (in place).  `vec` (1, 2 or 4) must divide p_cols and every (R, P) / (K, P)
// pointer must be aligned to vec * 4 bytes; 1 <= n_rsu <= 32 * 65535 (the
// grid's y-extent; the wrapper checks both).  Allocates nothing; returns
// cudaGetLastError() (0 = success).
extern "C" int rsu_reduce_launch(const float* updates, const float* weights, const int* rid,
                                 int k_rows, int n_rsu, long long p_cols, int vec,
                                 const float* carry, float* out, float* mass,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rsu < 1 || k_rows < 0) return (int)cudaErrorInvalidValue;
  const unsigned groups = (unsigned)((n_rsu + RSU_GROUP - 1) / RSU_GROUP);
  if (groups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  int rb = 1;
  while (rb < n_rsu && rb < RSU_GROUP) rb *= 2;
  const long long threads_needed = (p_cols + vec - 1) / vec;
  long long blocks_ll = (threads_needed + THREADS - 1) / THREADS;
  if (blocks_ll < 1) blocks_ll = 1;  // block 0 of each group still writes the mass
  const dim3 blocks((unsigned)blocks_ll, groups);
  int status;
  switch (vec) {
    case 4:
      status = launch_rb<4>(rb, blocks, st, updates, weights, rid, k_rows, n_rsu, p_cols,
                            carry, out, mass);
      break;
    case 2:
      status = launch_rb<2>(rb, blocks, st, updates, weights, rid, k_rows, n_rsu, p_cols,
                            carry, out, mass);
      break;
    case 1:
      status = launch_rb<1>(rb, blocks, st, updates, weights, rid, k_rows, n_rsu, p_cols,
                            carry, out, mass);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (status != (int)cudaSuccess) return status;
  return (int)cudaGetLastError();
}
