// Single-token GQA attention over a ring-buffer KV cache for Hopper (sm_90a):
//
//   out[b, h, g, :] = sum_c p[c] * v[b, c, h, :],   p = softmax over the visible c of
//   s[c] = cap(q[b, h, g, :] . k[b, c, h, :] / sqrt(D)),
//   visible: 0 <= kv_pos[b, c] <= pos[b] and (window <= 0 or pos[b] - kv_pos[b, c] < window),
//   cap(s) = softcap * tanh(s / softcap) when softcap > 0.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_decode.py (_swa_decode_kernel,
// launched by swa_decode's pallas_call): the decode step's attention, once per layer
// and step.  A row with no visible slot gives 0, as kernels/ref.py's swa_decode does.
//
// What bounds it on this card: bytes.  It reads the whole K and V cache once,
// 2 * B * C * Hkv * D elements, and does 4 flops per element per query head of the
// group: at hymba-1.5b's decode (B = 4, C = 1024, Hkv = 5, G = 5, D = 64, bf16) that
// is 5.24 MB, a bound near 1.6 us at 3.35 TB/s, against 26 MFLOP (0.4 us on the fp32
// cores).
//
// Design: one block of 256 threads per (b, kv head) holds the G query rows in shared
// memory as fp32 and walks the C slots in tiles of 256, keeping the online softmax's
// running max, normalizer and a (G, D) fp32 accumulator.  Per tile: (1) each thread
// scores one slot for all G heads (the K row through L1, q broadcast from shared
// memory), masked slots get -inf; (2) one warp per head takes the tile's max, turns
// the scores into exp(s - m) in place and rescales the running sums (a head with
// nothing visible yet keeps m = -inf and adds zeros, never exp(-inf + inf)); (3) each
// thread owns (g, d) accumulators and adds p[c] * v[c, d] over the tile, neighbouring
// threads on neighbouring d, so the V reads coalesce.  Every sum runs in a fixed
// order, so a run repeats itself bitwise.  At hymba's shapes the grid is 20 blocks on
// 132 SMs: the cache is read by few SMs, and splitting C across blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define TILE 256  // slots per tile: one per thread in the score pass
#define G_MAX 16
#define D_MAX 256
#define E_MAX ((G_MAX * D_MAX + THREADS - 1) / THREADS)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kv_pos,
                      const int* __restrict__ pos, int n_slots, int hkv, int groups,
                      int head_dim, int window, float softcap, float sqrt_d,
                      float* __restrict__ out) {
  __shared__ float qs[G_MAX * D_MAX];
  __shared__ float ps[G_MAX * TILE];  // scores, then exp(s - m)
  __shared__ float m_run[G_MAX], l_run[G_MAX], corr[G_MAX];

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gd = groups * head_dim;
  const long long q_off = ((long long)b * hkv + h) * gd;
  const long long row = (long long)hkv * head_dim;  // elements between two slots
  const T* kb = k + (long long)b * n_slots * row + (long long)h * head_dim;
  const T* vb = v + (long long)b * n_slots * row + (long long)h * head_dim;
  const int* pb = kv_pos + (long long)b * n_slots;
  const int iq = pos[b];

  for (int i = tid; i < gd; i += THREADS) qs[i] = to_f32(q[q_off + i]);
  if (tid < groups) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.0f;
  }
  float acc[E_MAX];
#pragma unroll
  for (int e = 0; e < E_MAX; ++e) acc[e] = 0.0f;
  __syncthreads();

  for (int t0 = 0; t0 < n_slots; t0 += TILE) {
    const int n = min(TILE, n_slots - t0);
    // (1) scores, one slot per thread
    if (tid < n) {
      const int jk = pb[t0 + tid];
      const bool visible = jk >= 0 && jk <= iq && (window <= 0 || iq - jk < window);
      if (visible) {
        float s[G_MAX];
#pragma unroll
        for (int g = 0; g < G_MAX; ++g) s[g] = 0.0f;
        const T* kr = kb + (long long)(t0 + tid) * row;
        for (int d = 0; d < head_dim; ++d) {
          const float kd = to_f32(kr[d]);
#pragma unroll
          for (int g = 0; g < G_MAX; ++g)
            if (g < groups) s[g] = fmaf(qs[g * head_dim + d], kd, s[g]);
        }
#pragma unroll
        for (int g = 0; g < G_MAX; ++g) {
          if (g < groups) {
            float x = s[g] / sqrt_d;
            if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
            ps[g * TILE + tid] = x;
          }
        }
      } else {
        for (int g = 0; g < groups; ++g) ps[g * TILE + tid] = -INFINITY;
      }
    }
    __syncthreads();
    // (2) per head: the tile's max, exp(s - m) in place, the running sums rescaled
    for (int g = warp; g < groups; g += THREADS / 32) {
      float* pg = ps + g * TILE;
      float mx = -INFINITY;
      for (int c = lane; c < n; c += 32) mx = fmaxf(mx, pg[c]);
      mx = warp_max(mx);
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      if (m_new == -INFINITY) {
        for (int c = lane; c < n; c += 32) pg[c] = 0.0f;
      } else {
        for (int c = lane; c < n; c += 32) {
          const float e = expf(pg[c] - m_new);
          pg[c] = e;
          sum = sum + e;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float cr = m_new == -INFINITY ? 1.0f : expf(m_old - m_new);
        corr[g] = cr;
        l_run[g] = l_run[g] * cr + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
    // (3) acc = acc * corr + sum_c p[c] * v[c]
#pragma unroll
    for (int e = 0; e < E_MAX; ++e) {
      const int idx = tid + e * THREADS;
      if (idx < gd) {
        const int g = idx / head_dim;
        const int d = idx - g * head_dim;
        const float* pg = ps + g * TILE;
        const T* vc = vb + (long long)t0 * row + d;
        float a = acc[e] * corr[g];
        for (int c = 0; c < n; ++c) a = fmaf(pg[c], to_f32(vc[(long long)c * row]), a);
        acc[e] = a;
      }
    }
    __syncthreads();
  }
  // (4) normalize; a row with nothing visible is 0
#pragma unroll
  for (int e = 0; e < E_MAX; ++e) {
    const int idx = tid + e * THREADS;
    if (idx < gd) {
      const float l = l_run[idx / head_dim];
      out[q_off + idx] = l > 0.0f ? acc[e] / l : 0.0f;
    }
  }
}

// Launch on `stream`.  q (B, hkv, G, D), k / v (B, C, hkv, D) of one element type
// (dtype 0 = float32, 1 = bfloat16), kv_pos (B, C) and pos (B,) int32, all contiguous;
// out (B, hkv, G, D) float32.  1 <= G <= 16, 1 <= D <= 256, C >= 1 (the wrapper checks).
// Allocates nothing; returns cudaGetLastError() (0 = success).
extern "C" int swa_decode_launch(const void* q, const void* k, const void* v,
                                 const int* kv_pos, const int* pos, int batch, int n_slots,
                                 int hkv, int groups, int head_dim, int window, float softcap,
                                 float sqrt_d, int dtype, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups < 1 || groups > G_MAX || head_dim < 1 || head_dim > D_MAX || n_slots < 1 ||
      batch < 1 || hkv < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(batch * hkv);
  if (dtype == 0) {
    swa_decode_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), kv_pos, pos, n_slots, hkv, groups, head_dim, window,
        softcap, sqrt_d, out);
  } else if (dtype == 1) {
    swa_decode_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), kv_pos, pos, n_slots, hkv, groups, head_dim,
        window, softcap, sqrt_d, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
