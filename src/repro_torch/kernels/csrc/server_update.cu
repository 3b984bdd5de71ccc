// Fused server update for Hopper (sm_90a): weighted cohort sum, then the
// server rule, then the parameter step, in one pass over the columns.
//
// Replaces the Pallas TPU kernel src/repro/kernels/server_update.py
// (_update_kernel + _rule_math, launched by server_update's pallas_call) and
// its buffered form server_update_buffered, which reaches the same call with
// the (Kb, P) fedbuff ring appended as extra update rows.
//
// For each column p:
//   delta = sum_k w[k] u[k, p]  (+ sum_j bw[j] ring[j, p] when *drain)
//   rule by its global AGGREGATOR_ORDER index: 1 FedAvgM, 2 FedAdam,
//   3 FedYogi, anything else the plain AXPY;
//   params' = params + step, and m', v' for the moment rules 1-3.
//
// What bounds it on this card: bytes.  A moment rule reads K (+ Kb) update
// rows and params, m, v once and writes params', m', v' once, a few flops
// per value: at K = 10, P = 159,010 that is 10.2 MB, a bound near 3.0 us at
// 3.35 TB/s.  The AXPY rules (fedavg, stale, fedbuff) leave the moments as
// they are, so the kernel neither reads nor writes them and the caller keeps
// its m and v: 18 rows plus params in and params' out, 12.7 MB and 3.8 us,
// on the fedbuff lane with the Kb = 8 ring draining.
//
// Design: the fedavg_reduce GEMV with the rule fused behind it.  Each thread
// owns VEC adjacent columns and loads them with one VEC*4-byte vector load
// per row, neighbouring threads on neighbouring addresses.  The cohort rows
// and the ring rows come through two pointers: the (K + Kb, P) concatenation
// is never built.  One fp32 accumulator per column starts at +0.0 and takes
// fmaf over the cohort rows in ascending k, then over the ring rows in
// ascending slot, so rule 0 reproduces fedavg_reduce + params + delta bit
// for bit.  When *drain is false the ring rows are not read at all, which is
// the reference's zero-weight rows exactly (a +0.0-started accumulator never
// holds -0.0 except on underflow) and saves their bytes.  The library is
// compiled with --fmad=false, so every multiply and add of the rule rounds on
// its own as the plain PyTorch ops do; sqrtf and the division stay IEEE.
// The rule's constants (1 - beta) come from the host, computed in double and
// rounded to float once, as the reference's Python floats are.
//
// Precision (the bf16 lane): the cohort rows and the ring share one row type
// E, fp32 or bf16, and params / params' one master type M, fp32 or bf16;
// m, v, m' and v' are fp32.  A bf16 value widens to fp32 exactly on its
// load, every sum and the rule run in fp32 as above, and a bf16 params' is
// rounded once, to nearest even (__float2bfloat16_rn), as the reference's
// astype(params.dtype).  A run of VEC bf16 values is one VEC*2-byte load.
//
// B3g / B4g, server_update_grid_kernel: the same pass for G lanes in one
// launch, as the reference's engine runs _update_kernel under its grid's
// vmap with the rule a traced per-lane operand.  The lane is the grid's
// second dimension (blockIdx.y); a block reads its lane's rule index and
// drain flag once, so every branch is uniform in it, and runs the
// one-lane column code (update_run) on its lane's rows: each lane is bitwise
// B3 / B4 on that lane.  Bytes bound it as above, G times over: at the async
// grid's G = 24, K = 2, P = 159,010 under fedbuff 61.1 MB with no lane
// draining (18.2 us) and 183 MB with every lane draining 8 ring rows
// (54.7 us).  When some lane may run a moment rule every lane writes m' and
// v' (an AXPY lane's are its m and v, written through), so the caller takes
// all three outputs from the one launch; when none may, the moments are
// neither read nor written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

// VEC adjacent elements of type E: one load into fp32 (exact), one store
// from fp32 (rounded to nearest even for bf16).
template <typename E, int VEC>
struct Vec;
template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* x) { x[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* x) { *p = x[0]; }
};
template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
};
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

__device__ __forceinline__ float widen(unsigned bits) {  // the low 16 bits, a bf16
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(bits & 0xffffu)));
}
__device__ __forceinline__ unsigned narrow(float x) {  // fp32 -> bf16 bits, nearest even
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
    x[0] = widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* x) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)narrow(x[0]);
  }
};
template <>
struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
    const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p));
    x[0] = widen(v);
    x[1] = widen(v >> 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* x) {
    *reinterpret_cast<unsigned*>(p) = narrow(x[0]) | narrow(x[1]) << 16;
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = widen(v.x);
    x[1] = widen(v.x >> 16);
    x[2] = widen(v.y);
    x[3] = widen(v.y >> 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* x) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(narrow(x[0]) | narrow(x[1]) << 16, narrow(x[2]) | narrow(x[3]) << 16);
  }
};

struct Rule {
  int idx;  // global AGGREGATOR_ORDER index
  float eta, beta1, one_m_beta1, beta2, one_m_beta2, tau;
};

// Rules 1-3 carry the server moments; the others are the AXPY alone.
__host__ __device__ __forceinline__ bool has_moments(int idx) { return idx >= 1 && idx <= 3; }

// jnp.sign: -1, 0 or +1 (0 at a tie; NaN passes through)
__device__ __forceinline__ float sign3(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// One column of the rule, each expression in the reference's order.
__device__ __forceinline__ void apply_rule(const Rule& r, float d, float p, float m, float v,
                                           float* po, float* mo, float* vo) {
  float m_new = m, v_new = v, step = d;
  if (r.idx == 1) {  // fedavgm
    m_new = r.beta1 * m + d;
    step = r.eta * m_new;
  } else if (r.idx == 2) {  // fedadam
    m_new = r.beta1 * m + r.one_m_beta1 * d;
    v_new = r.beta2 * v + r.one_m_beta2 * (d * d);
    step = r.eta * m_new / (sqrtf(v_new) + r.tau);
  } else if (r.idx == 3) {  // fedyogi
    m_new = r.beta1 * m + r.one_m_beta1 * d;
    const float d2 = d * d;
    v_new = v - r.one_m_beta2 * d2 * sign3(v - d2);
    step = r.eta * m_new / (sqrtf(v_new) + r.tau);
  }
  *po = p + step;
  *mo = m_new;
  *vo = v_new;
}

// This thread's run of VEC columns of one lane: the cohort's fmaf chain,
// then the ring's when `drain`, then the rule.  Under an AXPY rule the
// moments are neither read nor written, unless m_out is given: then m' and
// v' are m and v written through (B3g's lanes of a registry that holds a
// moment rule, whose outputs every lane fills).
template <typename E, typename M, int VEC>
__device__ __forceinline__ void update_run(const E* __restrict__ updates,
                                           const float* __restrict__ weights, int k_rows,
                                           const E* __restrict__ ring,
                                           const float* __restrict__ ring_w, int kb_rows,
                                           bool drain, long long p_cols,
                                           const M* __restrict__ params,
                                           const float* __restrict__ m_in,
                                           const float* __restrict__ v_in, const Rule& rule,
                                           M* __restrict__ p_out, float* __restrict__ m_out,
                                           float* __restrict__ v_out) {
  const long long col = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= p_cols) return;
  float acc[VEC], x[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  for (int k = 0; k < k_rows; ++k) {
    const float w = __ldg(weights + k);
    Vec<E, VEC>::load(updates + (long long)k * p_cols + col, x);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = fmaf(w, x[j], acc[j]);
  }
  if (kb_rows > 0 && drain) {
    for (int k = 0; k < kb_rows; ++k) {
      const float w = __ldg(ring_w + k);
      Vec<E, VEC>::load(ring + (long long)k * p_cols + col, x);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(w, x[j], acc[j]);
    }
  }
  float p[VEC], po[VEC];
  Vec<M, VEC>::load(params + col, p);
  if (!has_moments(rule.idx)) {  // the AXPY
#pragma unroll
    for (int j = 0; j < VEC; ++j) po[j] = p[j] + acc[j];
    Vec<M, VEC>::store(p_out + col, po);
    if (m_out != nullptr) {
      float mv[VEC];
      Vec<float, VEC>::load(m_in + col, mv);
      Vec<float, VEC>::store(m_out + col, mv);
      Vec<float, VEC>::load(v_in + col, mv);
      Vec<float, VEC>::store(v_out + col, mv);
    }
    return;
  }
  if (m_in == nullptr) {  // a moment rule on a lane launched without moments: refuse
    // the step visibly (the wrapper's registry check makes this unreachable)
#pragma unroll
    for (int j = 0; j < VEC; ++j) po[j] = __int_as_float(0x7fffffff);
    Vec<M, VEC>::store(p_out + col, po);
    return;
  }
  float m[VEC], v[VEC], mo[VEC], vo[VEC];
  Vec<float, VEC>::load(m_in + col, m);
  Vec<float, VEC>::load(v_in + col, v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) apply_rule(rule, acc[j], p[j], m[j], v[j], &po[j], &mo[j], &vo[j]);
  Vec<M, VEC>::store(p_out + col, po);
  Vec<float, VEC>::store(m_out + col, mo);
  Vec<float, VEC>::store(v_out + col, vo);
}

template <typename E, typename M, int VEC>
__global__ void server_update_kernel(const E* __restrict__ updates,
                                     const float* __restrict__ weights, int k_rows,
                                     const E* __restrict__ ring,
                                     const float* __restrict__ ring_w, int kb_rows,
                                     const bool* __restrict__ drain, long long p_cols,
                                     const M* __restrict__ params,
                                     const float* __restrict__ m_in,
                                     const float* __restrict__ v_in, Rule rule,
                                     M* __restrict__ p_out, float* __restrict__ m_out,
                                     float* __restrict__ v_out) {
  update_run<E, M, VEC>(updates, weights, k_rows, ring, ring_w, kb_rows,
                        kb_rows > 0 && *drain, p_cols, params, m_in, v_in, rule, p_out, m_out,
                        v_out);
}

// B3g / B4g: G lanes in one launch, the lane as the grid's second dimension
// (blockIdx.y).  Lane g reads its rule (a global AGGREGATOR_ORDER index) and
// its drain flag once, into shared memory, so the branch is uniform in the
// block; its rows, weights, ring, params, moments and outputs are row g of
// each (lanes, ...) operand.  Each lane runs update_run as B3 / B4 does, so
// a lane is bitwise the one-lane kernel on that lane.
template <typename E, typename M, int VEC>
__global__ void server_update_grid_kernel(
    const E* __restrict__ updates, const float* __restrict__ weights, int k_rows,
    const E* __restrict__ ring, const float* __restrict__ ring_w, int kb_rows,
    const bool* __restrict__ drain, long long p_cols, const M* __restrict__ params,
    const float* __restrict__ m_in, const float* __restrict__ v_in,
    const int* __restrict__ rules, Rule rule, M* __restrict__ p_out,
    float* __restrict__ m_out, float* __restrict__ v_out) {
  const long long g = blockIdx.y;
  __shared__ int lane_rule;
  __shared__ bool lane_drain;
  if (threadIdx.x == 0) {
    lane_rule = rules[g];
    lane_drain = kb_rows > 0 && drain[g];
  }
  __syncthreads();
  Rule r = rule;
  r.idx = lane_rule;
  const long long row = g * p_cols;
  const bool moments = m_in != nullptr;
  update_run<E, M, VEC>(updates + g * k_rows * p_cols, weights + g * k_rows, k_rows,
                        kb_rows > 0 ? ring + g * kb_rows * p_cols : nullptr,
                        kb_rows > 0 ? ring_w + g * kb_rows : nullptr, kb_rows, lane_drain,
                        p_cols, params + row, moments ? m_in + row : nullptr,
                        moments ? v_in + row : nullptr, r, p_out + row,
                        moments ? m_out + row : nullptr, moments ? v_out + row : nullptr);
}

template <typename E, typename M>
static int launch_types(const void* updates, const float* weights, int lanes, int k_rows,
                        const void* ring, const float* ring_w, int kb_rows, const bool* drain,
                        long long p_cols, const void* params, const float* m, const float* v,
                        const int* rules, Rule rule, int vec, void* p_out, float* m_out,
                        float* v_out, unsigned blocks, cudaStream_t st) {
  const E* u = static_cast<const E*>(updates);
  const E* r = static_cast<const E*>(ring);
  const M* p = static_cast<const M*>(params);
  M* po = static_cast<M*>(p_out);
#define SU_LAUNCH(V)                                                                        \
  if (lanes == 0)                                                                           \
    server_update_kernel<E, M, V><<<blocks, THREADS, 0, st>>>(                              \
        u, weights, k_rows, r, ring_w, kb_rows, drain, p_cols, p, m, v, rule, po, m_out,    \
        v_out);                                                                             \
  else                                                                                      \
    server_update_grid_kernel<E, M, V><<<dim3(blocks, lanes), THREADS, 0, st>>>(            \
        u, weights, k_rows, r, ring_w, kb_rows, drain, p_cols, p, m, v, rules, rule, po,    \
        m_out, v_out)
  switch (vec) {
    case 4:
      SU_LAUNCH(4);
      break;
    case 2:
      SU_LAUNCH(2);
      break;
    case 1:
      SU_LAUNCH(1);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SU_LAUNCH
  return (int)cudaGetLastError();
}

// One launch of B3 / B4 (lanes == 0) or B3g / B4g (lanes >= 1).
static int launch_any(const void* updates, int row_bytes, const float* weights, int lanes,
                      int k_rows, const void* ring, const float* ring_w, int kb_rows,
                      const bool* drain, long long p_cols, const void* params, int param_bytes,
                      const float* m, const float* v, const int* rules, Rule rule, int vec,
                      void* p_out, float* m_out, float* v_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kb_rows > 0 && (ring == nullptr || ring_w == nullptr || drain == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long threads_needed = p_cols / vec;
  const unsigned blocks = (unsigned)((threads_needed + THREADS - 1) / THREADS);
  if (blocks == 0) return (int)cudaSuccess;
#define SU_TYPES(E, M)                                                                      \
  launch_types<E, M>(updates, weights, lanes, k_rows, ring, ring_w, kb_rows, drain, p_cols, \
                     params, m, v, rules, rule, vec, p_out, m_out, v_out, blocks, st)
  if (row_bytes == 4 && param_bytes == 4) return SU_TYPES(float, float);
  if (row_bytes == 2 && param_bytes == 4) return SU_TYPES(__nv_bfloat16, float);
  if (row_bytes == 4 && param_bytes == 2) return SU_TYPES(float, __nv_bfloat16);
  if (row_bytes == 2 && param_bytes == 2) return SU_TYPES(__nv_bfloat16, __nv_bfloat16);
#undef SU_TYPES
  return (int)cudaErrorInvalidValue;
}

// Launch on `stream`.  `row_bytes` is the element size of the update rows
// and the ring (4: fp32, 2: bf16), `param_bytes` that of params and p_out.
// `ring`, `ring_w` and `drain` may be null with kb_rows = 0 (the unbuffered
// form); `m`, `v`, `m_out` and `v_out` may be null unless rule_idx is a
// moment rule (1-3).  `vec` (1, 2 or 4) must divide p_cols and every pointer
// must be aligned to vec elements of its own type (the wrapper picks it).
// `rnd` is reserved for schedule-aware rules and ignored, as in the
// reference.  Allocates nothing; returns cudaGetLastError() (0 = success).
extern "C" int server_update_launch(const void* updates, int row_bytes, const float* weights,
                                    int k_rows, const void* ring, const float* ring_w,
                                    int kb_rows, const bool* drain, long long p_cols,
                                    const void* params, int param_bytes, const float* m,
                                    const float* v, int rule_idx, int rnd, float eta,
                                    float beta1, float one_m_beta1, float beta2,
                                    float one_m_beta2, float tau, int vec, void* p_out,
                                    float* m_out, float* v_out, void* stream) {
  (void)rnd;
  if (has_moments(rule_idx) &&
      (m == nullptr || v == nullptr || m_out == nullptr || v_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const Rule rule{rule_idx, eta, beta1, one_m_beta1, beta2, one_m_beta2, tau};
  return launch_any(updates, row_bytes, weights, 0, k_rows, ring, ring_w, kb_rows, drain,
                    p_cols, params, param_bytes, m, v, nullptr, rule, vec, p_out, m_out, v_out,
                    stream);
}

// B3g / B4g: `lanes` (1 .. 65,535) lanes, lane-major: (lanes, k_rows, p_cols)
// updates and (lanes, k_rows) weights; with kb_rows > 0 a (lanes, kb_rows,
// p_cols) ring, (lanes, kb_rows) ring weights and (lanes,) drain flags;
// (lanes, p_cols) params, m, v and outputs; `rules` (lanes,) int32 global
// AGGREGATOR_ORDER indices on the device.  `m`, `v`, `m_out` and `v_out`
// are all null (no lane may run a moment rule: the moments stay the
// caller's) or all given (every lane writes m' and v', an AXPY lane's
// through).  Otherwise as above.
extern "C" int server_update_grid_launch(const void* updates, int row_bytes,
                                         const float* weights, int lanes, int k_rows,
                                         const void* ring, const float* ring_w, int kb_rows,
                                         const bool* drain, long long p_cols,
                                         const void* params, int param_bytes, const float* m,
                                         const float* v, const int* rules, int rnd, float eta,
                                         float beta1, float one_m_beta1, float beta2,
                                         float one_m_beta2, float tau, int vec, void* p_out,
                                         float* m_out, float* v_out, void* stream) {
  (void)rnd;
  if (lanes < 1 || lanes > 65535 || rules == nullptr) return (int)cudaErrorInvalidValue;
  const bool any = m != nullptr || v != nullptr || m_out != nullptr || v_out != nullptr;
  const bool all = m != nullptr && v != nullptr && m_out != nullptr && v_out != nullptr;
  if (any && !all) return (int)cudaErrorInvalidValue;
  const Rule rule{0, eta, beta1, one_m_beta1, beta2, one_m_beta2, tau};
  return launch_any(updates, row_bytes, weights, lanes, k_rows, ring, ring_w, kb_rows, drain,
                    p_cols, params, param_bytes, m, v, rules, rule, vec, p_out, m_out, v_out,
                    stream);
}
