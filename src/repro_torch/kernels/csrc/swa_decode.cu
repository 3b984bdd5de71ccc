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
// Design: split-KV decode in one launch.  The grid is (split of C, b * Hkv): at
// hymba's shape 8 splits of 128 slots for each of 20 (b, kv head) pairs, 160 blocks
// of 256 threads, one wave (the wrapper takes 64-slot splits for rows over 128
// bytes and 32 for rows over 256, so the staged rows fit shared memory).  Each block
//   (1) copies its slots' K rows, then its V rows, into shared memory as two cp.async
//       groups of 16-byte copies (4-byte copies when a row is not a multiple of 16
//       bytes, element copies when it is not one of 4), the G query rows as fp32 and
//       each slot's visibility, a thread per slot;
//   (2) once K has landed, scores its slots a thread per (slot, heads): thread t takes
//       slot t % split and the heads t / split, t / split + 256 / split, ..., one
//       fmaf chain per head in ascending d.  With 16-byte rows each K read is one
//       16-byte load and the staged rows are 16 bytes longer than a K row, so the
//       lanes of a warp, on neighbouring slots, hit distinct bank groups; the query
//       values are the same for the whole warp (broadcast).  A masked slot scores -inf;
//   (3) per head, takes the split's max m, turns the scores into exp(s - m) in place
//       and sums them into l (a split that sees no slot keeps m = -inf, l = 0 and
//       p = 0, never exp(-inf + inf));
//   (4) once V has landed, sums p * v into an unnormalized (G, D) fp32 accumulator,
//       four neighbouring d per thread with 16-byte rows (one per thread otherwise),
//       and writes it, m and l to scratch;
//   (5) counts itself in on the (b, kv head)'s arrival counter after a fence; the last
//       block to arrive combines the splits in ascending split order, skipping those
//       with m = -inf: M = max m_s, L = sum l_s exp(m_s - M), out = sum acc_s
//       exp(m_s - M) / L, and 0 where no split sees a slot; it then resets the counter
//       to 0.  It takes the splits in chunks of 64 (one chunk up to C = 4,096 slots),
//       rescaling the sums so far when a chunk raises M, as the online softmax does.
//       Per chunk, every split's m and l are loaded at once into shared memory while
//       each thread's first eight accumulators are already on their way; a thread
//       owns four neighbouring outputs and loads them as one 16-byte load per split,
//       eight splits at a time, so the L2 reads overlap.  Between chunks a thread
//       keeps its running sums in `out` (its own outputs), which keeps this code,
//       run by one block per (b, kv head) on an SM that has not run it before,
//       short.  The wrapper zeroes the counters once per device.
// Every sum runs in a fixed order, so a run repeats itself bitwise.  Products that
// should fuse are written as fmaf (the library is built with --fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define G_MAX 16
#define D_MAX 256
#define SPLIT_MAX 128
#define CHUNK 64   // splits per step of the combine
#define SG (G_MAX / (THREADS / SPLIT_MAX))  // heads per thread in the score pass
#define BATCH 8    // splits whose accumulators a thread loads at a time

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

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ int align16(int bytes) { return (bytes + 15) & ~15; }
__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

// 16 bytes of K as floats: four fp32 or eight bf16 values.
__device__ __forceinline__ void unpack16(float* out, uint4 raw, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(float* out, uint4 raw, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Four neighbouring V values as floats (8-byte aligned for bf16, 16 for fp32).
__device__ __forceinline__ void load4(float* out, const float* v) {
  const float4 f = *reinterpret_cast<const float4*>(v);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
__device__ __forceinline__ void load4(float* out, const __nv_bfloat16* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// Byte offsets of the block's shared-memory arrays, each 16-byte aligned.
struct Layout {
  int qs, ps, ml, ks, vs, wc, total;
};

__host__ __device__ __forceinline__ Layout layout(int groups, int head_dim, int split,
                                                  int pitch, int esize) {
  Layout s;
  int o = 0;
  s.qs = o;  // (G, D) query rows, fp32
  o += align16(groups * head_dim * 4);
  s.ps = o;  // (G, split) scores, then exp(s - m)
  o += align16(groups * split * 4);
  s.ml = o;  // the split's m and l per head
  o += align16(2 * groups * 4);
  s.ks = o;  // (split, D) K rows, `pitch` elements apart
  o += align16(split * pitch * esize);
  s.vs = o;  // (split, D) V rows, `pitch` elements apart
  o += align16(split * pitch * esize);
  s.wc = o;  // the combine: (G, CHUNK) maxima, weights and sums; running M, L, rescale
  o += align16((3 * groups * CHUNK + 3 * groups) * 4);
  s.total = o;
  return s;
}

// n rows of head_dim elements, `row` elements apart in global memory, into
// shared rows `pitch` elements apart: vec_bytes-wide cp.async copies (16 or 4), or
// plain element copies (vec_bytes 0) when a row is not a multiple of 4 bytes.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int n, int head_dim, int pitch,
                                          long long row, int vec_bytes, int tid) {
  const int row_bytes = head_dim * (int)sizeof(T);
  if (vec_bytes == 16 || vec_bytes == 4) {
    const int per_row = row_bytes / vec_bytes;
    for (int e = tid; e < n * per_row; e += THREADS) {
      const int c = e / per_row;
      const int part = e - c * per_row;
      const char* s = reinterpret_cast<const char*>(src + c * row) + part * vec_bytes;
      char* d = reinterpret_cast<char*>(dst + c * pitch) + part * vec_bytes;
      if (vec_bytes == 16)
        cp_async<16>(d, s);
      else
        cp_async<4>(d, s);
    }
  } else {
    for (int e = tid; e < n * head_dim; e += THREADS) {
      const int c = e / head_dim;
      const int d = e - c * head_dim;
      dst[c * pitch + d] = src[c * row + d];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kv_pos,
                      const int* __restrict__ pos, int n_slots, int hkv, int groups,
                      int head_dim, int window, float softcap, float sqrt_d, int split,
                      int vec_bytes, float* __restrict__ out, float* __restrict__ scratch,
                      int* __restrict__ counters) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  __shared__ int vis[SPLIT_MAX];
  const bool vec16 = vec_bytes == 16;
  const int pitch = vec16 ? head_dim + 16 / (int)sizeof(T) : head_dim;  // staged row, elements
  const Layout L = layout(groups, head_dim, split, pitch, (int)sizeof(T));
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* ps = reinterpret_cast<float*>(smem + L.ps);
  float* m_split = reinterpret_cast<float*>(smem + L.ml);
  float* l_split = m_split + groups;
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  T* vs = reinterpret_cast<T*>(smem + L.vs);

  const int n_splits = gridDim.x;
  const int sp = blockIdx.x;
  const int bh = blockIdx.y;  // b * hkv + h
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gd = groups * head_dim;
  const long long row = (long long)hkv * head_dim;  // elements between two slots
  const int c0 = sp * split;
  const int n = min(split, n_slots - c0);
  const long long first = ((long long)b * n_slots + c0) * row + (long long)h * head_dim;

  // (1) K, then V, of this split's slots; the query rows
  copy_rows(ks, k + first, n, head_dim, pitch, row, vec_bytes, tid);
  cp_commit();
  copy_rows(vs, v + first, n, head_dim, pitch, row, vec_bytes, tid);
  cp_commit();
  for (int i = tid; i < gd; i += THREADS) qs[i] = to_f32(q[(long long)bh * gd + i]);
  const int iq = pos[b];
  for (int c = tid; c < n; c += THREADS) {
    const int jk = kv_pos[(long long)b * n_slots + c0 + c];
    vis[c] = jk >= 0 && jk <= iq && (window <= 0 || iq - jk < window);
  }
  cp_wait<1>();
  __syncthreads();

  // (2) scores: thread t scores slot t % split for heads t / split + i * hs
  {
    const int hs = THREADS / split;
    const int c = tid % split;
    const int gh = tid / split;
    if (c < n && gh < hs) {
      if (!vis[c]) {
        for (int g = gh; g < groups; g += hs) ps[g * split + c] = -INFINITY;
      } else {
        float sc[SG];
#pragma unroll
        for (int i = 0; i < SG; ++i) sc[i] = 0.0f;
        const T* kr = ks + c * pitch;
        if (vec16) {
          constexpr int VALS = 16 / (int)sizeof(T);
          for (int d0 = 0; d0 < head_dim; d0 += VALS) {
            float kv[VALS];
            unpack16(kv, *reinterpret_cast<const uint4*>(kr + d0), T{});
#pragma unroll
            for (int i = 0; i < SG; ++i) {
              const int g = gh + i * hs;
              if (g < groups) {
                const float* qg = qs + g * head_dim + d0;
#pragma unroll
                for (int j = 0; j < VALS; j += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qg + j);
                  sc[i] = fmaf(qv.x, kv[j], sc[i]);
                  sc[i] = fmaf(qv.y, kv[j + 1], sc[i]);
                  sc[i] = fmaf(qv.z, kv[j + 2], sc[i]);
                  sc[i] = fmaf(qv.w, kv[j + 3], sc[i]);
                }
              }
            }
          }
        } else {
          for (int d = 0; d < head_dim; ++d) {
            const float kd = to_f32(kr[d]);
#pragma unroll
            for (int i = 0; i < SG; ++i) {
              const int g = gh + i * hs;
              if (g < groups) sc[i] = fmaf(qs[g * head_dim + d], kd, sc[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < SG; ++i) {
          const int g = gh + i * hs;
          if (g < groups) {
            float x = sc[i] / sqrt_d;
            if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
            ps[g * split + c] = x;
          }
        }
      }
    }
  }
  __syncthreads();

  // (3) per head: the split's max, exp(s - m) in place, their sum
  for (int g = warp; g < groups; g += WARPS) {
    float* pg = ps + g * split;
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, pg[c]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < n; c += 32) {
      const float e = mx == -INFINITY ? 0.0f : expf(pg[c] - mx);
      pg[c] = e;
      sum = sum + e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_split[g] = mx;
      l_split[g] = sum;
    }
  }
  cp_wait<0>();
  __syncthreads();

  // (4) the split's unnormalized sum of p * v, with m and l, to scratch:
  //     per (b, kv head, split) [acc (G, D), padded to 4][m (G)][l (G)], padded to 4
  const int acc_pad = align4(gd);
  const int stride = acc_pad + align4(2 * groups);
  float* part = scratch + ((long long)bh * n_splits + sp) * stride;
  if (vec16) {  // D % 4 == 0: four neighbouring d per thread
    for (int e = 4 * tid; e < gd; e += 4 * THREADS) {
      const int g = e / head_dim;
      const float* pg = ps + g * split;
      const T* vc = vs + (e - g * head_dim);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      for (int c = 0; c < n; ++c) {
        const float p = pg[c];
        float vv[4];
        load4(vv, vc + c * pitch);
        a0 = fmaf(p, vv[0], a0);
        a1 = fmaf(p, vv[1], a1);
        a2 = fmaf(p, vv[2], a2);
        a3 = fmaf(p, vv[3], a3);
      }
      *reinterpret_cast<float4*>(part + e) = make_float4(a0, a1, a2, a3);
    }
  } else {
    for (int e = tid; e < gd; e += THREADS) {
      const int g = e / head_dim;
      const int d = e - g * head_dim;
      const float* pg = ps + g * split;
      float a = 0.0f;
      for (int c = 0; c < n; ++c) a = fmaf(pg[c], to_f32(vs[c * pitch + d]), a);
      part[e] = a;
    }
  }
  if (tid < groups) {
    part[acc_pad + tid] = m_split[tid];
    part[acc_pad + groups + tid] = l_split[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // (5) the last block of this (b, kv head): combine the splits in ascending order
  const float* base = scratch + (long long)bh * n_splits * stride;
  float* m_c = reinterpret_cast<float*>(smem + L.wc);  // (G, CHUNK) m_s
  float* w_c = m_c + groups * CHUNK;                   // (G, CHUNK) exp(m_s - M)
  float* l_c = w_c + groups * CHUNK;                   // (G, CHUNK) l_s
  float* m_run = l_c + groups * CHUNK;                 // (G,) M so far
  float* l_run = m_run + groups;                       // (G,) L so far
  float* rescale = l_run + groups;                     // (G,) exp(M_old - M_new)
  if (tid < groups) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.0f;
  }
  const float4* base4 = reinterpret_cast<const float4*>(base);
  const int stride4 = stride / 4;
  float* ob = out + (long long)bh * gd;
  for (int s0 = 0; s0 < n_splits; s0 += CHUNK) {
    const int sc = min(CHUNK, n_splits - s0);
    const bool last_chunk = s0 + CHUNK >= n_splits;
    // this thread's first quad: its first BATCH accumulators, in flight
    // while m and l land
    float4 pre[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      pre[j] = 4 * tid < gd && j < sc ? __ldcg(base4 + (long long)(s0 + j) * stride4 + tid)
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();  // m_run / l_run set; the last chunk's weights used up
    for (int i = tid; i < groups * sc; i += THREADS) {
      const int g = i / sc;
      const int s = i - g * sc;
      const float* p = base + (long long)(s0 + s) * stride + acc_pad;
      m_c[g * CHUNK + s] = __ldcg(p + g);
      l_c[g * CHUNK + s] = __ldcg(p + groups + g);
    }
    __syncthreads();
    for (int g = warp; g < groups; g += WARPS) {
      float mx = -INFINITY;
      for (int s = lane; s < sc; s += 32) mx = fmaxf(mx, m_c[g * CHUNK + s]);
      mx = warp_max(mx);
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, mx);
      // a split that sees no slot (m = -inf, l = 0) weighs 0: skipped
      for (int s = lane; s < sc; s += 32) {
        const float m_s = m_c[g * CHUNK + s];
        w_c[g * CHUNK + s] = m_s == -INFINITY ? 0.0f : expf(m_s - m_new);
      }
      __syncwarp();
      if (lane == 0) {
        const float r = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
        float l = l_run[g] * r;
        for (int s = 0; s < sc; ++s) l = l + l_c[g * CHUNK + s] * w_c[g * CHUNK + s];
        l_run[g] = l;
        m_run[g] = m_new;
        rescale[g] = r;
      }
    }
    __syncthreads();
    for (int e = 4 * tid; e < gd; e += 4 * THREADS) {
      const int nq = min(4, gd - e);
      int g[4];
      float a[4];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        g[q4] = min(e + q4, gd - 1) / head_dim;
        a[q4] = s0 == 0 || q4 >= nq ? 0.0f : ob[e + q4] * rescale[g[q4]];
      }
      const float4* p = base4 + (long long)s0 * stride4 + (e / 4);
      for (int s = 0; s < sc; s += BATCH) {
        float4 v[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
          v[j] = e == 4 * tid && s == 0 ? pre[j]
                 : s + j < sc           ? __ldcg(p + (long long)(s + j) * stride4)
                                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          if (s + j < sc) {
            a[0] = a[0] + v[j].x * w_c[g[0] * CHUNK + s + j];
            a[1] = a[1] + v[j].y * w_c[g[1] * CHUNK + s + j];
            a[2] = a[2] + v[j].z * w_c[g[2] * CHUNK + s + j];
            a[3] = a[3] + v[j].w * w_c[g[3] * CHUNK + s + j];
          }
        }
      }
      // the running sums, or after the last chunk the outputs (0 where no
      // split sees a slot)
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        if (q4 < nq) {
          const float l = l_run[g[q4]];
          ob[e + q4] = !last_chunk ? a[q4] : l > 0.0f ? a[q4] / l : 0.0f;
        }
      }
    }
  }
  if (tid == 0) counters[bh] = 0;  // ready for the next launch
}

template <typename T>
static int launch_typed(dim3 grid, int smem, cudaStream_t st, const void* q, const void* k,
                        const void* v, const int* kv_pos, const int* pos, int n_slots, int hkv,
                        int groups, int head_dim, int window, float softcap, float sqrt_d,
                        int split, int vec_bytes, float* out, float* scratch, int* counters) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        swa_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  swa_decode_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_pos,
      pos, n_slots, hkv, groups, head_dim, window, softcap, sqrt_d, split, vec_bytes, out,
      scratch, counters);
  return (int)cudaGetLastError();
}

// Launch on `stream`.  q (B, hkv, G, D), k / v (B, C, hkv, D) of one element type
// (dtype 0 = float32, 1 = bfloat16), kv_pos (B, C) and pos (B,) int32, all contiguous;
// out (B, hkv, G, D) float32.  1 <= G <= 16, 1 <= D <= 256, C >= 1, B * hkv <= 65535;
// split (1..128) slots per block; vec_bytes 16 or 4 (a row's bytes a multiple of it and
// k and v aligned to it) or 0 (element copies); 16-byte aligned scratch of B * hkv *
// ceil(C / split) * (align4(G * D) + align4(2 G)) floats and B * hkv counters, all 0.
// Allocates nothing; returns cudaGetLastError() (0 = success).
extern "C" int swa_decode_launch(const void* q, const void* k, const void* v,
                                 const int* kv_pos, const int* pos, int batch, int n_slots,
                                 int hkv, int groups, int head_dim, int window, float softcap,
                                 float sqrt_d, int dtype, int split, int vec_bytes, float* out,
                                 float* scratch, int* counters, void* stream) {
  if (groups < 1 || groups > G_MAX || head_dim < 1 || head_dim > D_MAX || n_slots < 1 ||
      batch < 1 || hkv < 1 || (long long)batch * hkv > 65535 || split < 1 ||
      split > SPLIT_MAX || (vec_bytes != 0 && vec_bytes != 4 && vec_bytes != 16) ||
      (dtype != 0 && dtype != 1) || scratch == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  if (vec_bytes != 0 && (head_dim * esize) % vec_bytes != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_slots + split - 1) / split), (unsigned)(batch * hkv));
  const int pitch = vec_bytes == 16 ? head_dim + 16 / esize : head_dim;
  const int smem = layout(groups, head_dim, split, pitch, esize).total;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(grid, smem, st, q, k, v, kv_pos, pos, n_slots, hkv, groups,
                               head_dim, window, softcap, sqrt_d, split, vec_bytes, out,
                               scratch, counters);
  return launch_typed<__nv_bfloat16>(grid, smem, st, q, k, v, kv_pos, pos, n_slots, hkv,
                                     groups, head_dim, window, softcap, sqrt_d, split,
                                     vec_bytes, out, scratch, counters);
}
