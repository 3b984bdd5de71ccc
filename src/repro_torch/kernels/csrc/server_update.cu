// Fused server update for Hopper (sm_90a): weighted cohort sum, then the
// server rule, then the parameter step, in one pass over the columns.
//
// Replaces the Pallas TPU kernel src/repro/kernels/server_update.py
// (_update_kernel + _rule_math, launched by server_update's pallas_call) and
// its buffered form server_update_buffered, which reaches the same call with
// the (Kb, P) fedbuff ring appended as extra update rows.  One kernel serves
// B3 / B4 (one lane) and B3g / B4g (G lanes in one launch, as the
// reference's engine runs _update_kernel under its grid's vmap with the rule
// a traced per-lane operand).
//
// For each column p of a lane:
//   delta = sum_k w[k] u[k, p]  (+ sum_j bw[j] ring[j, p] when the lane drains)
//   rule by its global AGGREGATOR_ORDER index: 1 FedAvgM, 2 FedAdam,
//   3 FedYogi, anything else the plain AXPY;
//   params' = params + step, and m', v' for the moment rules 1-3.
//
// What bounds it on this card: bytes.  A moment rule reads K (+ Kb) update
// rows and params, m, v once and writes params', m', v' once, a few flops
// per value: at K = 10, P = 159,010 that is 10.2 MB, a bound near 3.0 us at
// 3.35 TB/s (bf16 rows 7.0 MB, 2.1 us).  The AXPY rules (fedavg, stale,
// fedbuff) leave the moments as they are, so the kernel neither reads nor
// writes them and the caller keeps its m and v: 18 rows plus params in and
// params' out, 12.7 MB and 3.8 us, on the fedbuff lane with the Kb = 8 ring
// draining.  G lanes move G times the bytes: at the async grid's G = 24,
// K = 2, P = 159,010 under fedbuff 61.1 MB with no lane draining (18.2 us)
// and 183 MB with every lane draining 8 ring rows (54.7 us).
//
// What holds it short of that bound: as for fedavg_reduce.cu, bytes in
// flight; here also the latencies a thread waits out in a row.  One run of
// VEC columns a thread (4 bytes a row on bf16 rows at the catalog's P), one
// row loaded an iteration of a loop bounded at run time and params, m and v
// read only after the chain kept a one-lane call at 0.39-0.45 of its bound
// on bf16 rows.
//
// Design: fedavg_reduce.cu's column streamer with the rule fused behind it.
// A thread owns RUNS runs of VEC columns of one column tile (run u of
// thread t at run (tile * RUNS + u) * THREADS + t: each warp load
// coalesced); the wide plan's RUNS = 16 / (VEC * element size) gives 16
// bytes a thread a row.  params (and m, v where they are read) are loaded
// first; then the cohort rows, and when the lane drains the ring rows, each
// in groups of LOADS = GROUP rows x RUNS runs, the next group issued before
// the current one's FMAs.  Cohort and ring are two pointers and two loops:
// the (K + Kb, P) concatenation is never built.  The grid is (tiles,
// lanes), a block a column tile; kernels/fedavg_reduce.py::column_plan
// picks the runs.  One fp32 accumulator per column starts at +0.0 and takes
// fmaf over the cohort rows in ascending k, then over the ring rows in
// ascending slot, whatever the plan, so rule 0 reproduces fedavg_reduce +
// params + delta bit for bit and a lane of B3g / B4g is B3 / B4 on that
// lane bit for bit.  When a lane does not drain its ring rows are not read
// at all, which is the reference's zero-weight rows exactly (a +0.0-started
// accumulator never holds -0.0 except on underflow) and saves their bytes.
// The library is compiled with --fmad=false, so every multiply and add of
// the rule rounds on its own as the plain PyTorch ops do; sqrtf and the
// division stay IEEE.  The rule's constants (1 - beta) come from the host,
// computed in double and rounded to float once, as the reference's Python
// floats are.
//
// Why this form of the chain: registers.  The kernel keeps params, m, v and
// two groups of rows live across the chain; a form that ran cohort and ring
// as one row sequence needed about half again as many registers, fit 4-5
// blocks an SM and lost to the first design at B3g and B4g.  Timed on an
// H100 against one group at a time, sixteen rows a group at one run, four
// loads a group and a row loop unrolled by four, this form (56-95
// registers) was the only one no slower than the first design at every
// shape (chip_smoke.py --wrapper-times, graph replay, 700 W): e.g. B4g with
// every lane draining 62.4-62.5 against 63.5 us (fp32 rows) and 39.7-40.1
// against 41.3-41.4 (bf16), B4 on bf16 rows 4.95 against 5.8, B3g
// 69.9-70.0 against 71.0-71.1.

// Lanes: a block reads its lane's rule index and drain flag once, into
// shared memory, so every branch is uniform in it.  When some lane may run
// a moment rule every lane writes m' and v' (an AXPY lane's are its m and v,
// written through), so the caller takes all three outputs from the one
// launch; when none may, the moments are neither read nor written.
//
// Precision (the bf16 lane): the cohort rows and the ring share one row type
// E, fp32 or bf16, and params / params' one master type M, fp32 or bf16;
// m, v, m' and v' are fp32.  A bf16 value widens to fp32 exactly, every sum
// and the rule run in fp32 as above, and a bf16 params' is rounded once, to
// nearest even (__float2bfloat16_rn), as the reference's astype(params.dtype).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define LOADS 8  // row loads a thread issues in a group: GROUP rows x RUNS runs

__device__ __forceinline__ float widen(unsigned bits) {  // the low 16 bits, a bf16
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(bits & 0xffffu)));
}
__device__ __forceinline__ unsigned narrow(float x) {  // fp32 -> bf16 bits, nearest even
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// A run of VEC adjacent elements of type E: the type one load moves, its
// values widened to fp32 (exactly), and fp32 values stored as one run
// (rounded to nearest even for bf16).
template <typename E, int VEC>
struct Run;
template <>
struct Run<float, 1> {
  using T = float;
  static __device__ __forceinline__ void widen(T v, float* x) { x[0] = v; }
  static __device__ __forceinline__ T pack(const float* x) { return x[0]; }
};
template <>
struct Run<float, 2> {
  using T = float2;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = v.x;
    x[1] = v.y;
  }
  static __device__ __forceinline__ T pack(const float* x) { return make_float2(x[0], x[1]); }
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
  static __device__ __forceinline__ T pack(const float* x) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <>
struct Run<__nv_bfloat16, 1> {
  using T = unsigned short;
  static __device__ __forceinline__ void widen(T v, float* x) { x[0] = ::widen(v); }
  static __device__ __forceinline__ T pack(const float* x) { return (T)narrow(x[0]); }
};
template <>
struct Run<__nv_bfloat16, 2> {
  using T = unsigned int;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = ::widen(v);
    x[1] = ::widen(v >> 16);
  }
  static __device__ __forceinline__ T pack(const float* x) {
    return narrow(x[0]) | narrow(x[1]) << 16;
  }
};
template <>
struct Run<__nv_bfloat16, 4> {
  using T = uint2;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = ::widen(v.x);
    x[1] = ::widen(v.x >> 16);
    x[2] = ::widen(v.y);
    x[3] = ::widen(v.y >> 16);
  }
  static __device__ __forceinline__ T pack(const float* x) {
    return make_uint2(narrow(x[0]) | narrow(x[1]) << 16, narrow(x[2]) | narrow(x[3]) << 16);
  }
};

// The wide plan's runs a thread: RUNS runs of VEC rows' elements make 16 bytes.
template <typename E, int VEC>
constexpr int wide_runs() {
  return 16 / (VEC * (int)sizeof(E)) > 1 ? 16 / (VEC * (int)sizeof(E)) : 1;
}

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

// Rows j0 .. j0 + GROUP - 1 of this thread's RUNS runs (row 0 of the
// cohort or ring at `base`, in runs of the row type) and their weights; rows
// past n_rows and runs past the row read as 0 and are never stored.
template <typename T, int GROUP, int RUNS>
__device__ __forceinline__ void load_group(T (&v)[GROUP][RUNS], float (&w)[GROUP],
                                           const T* __restrict__ base,
                                           const float* __restrict__ weights, int j0,
                                           int n_rows, int row, const int (&run)[RUNS],
                                           const bool (&live)[RUNS]) {
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const bool in = j0 + j < n_rows;
    w[j] = in ? __ldg(weights + j0 + j) : 0.0f;
#pragma unroll
    for (int u = 0; u < RUNS; ++u)
      v[j][u] = in && live[u] ? __ldg(base + (long long)(j0 + j) * row + run[u]) : T{};
  }
}

// Rows 0 .. n_rows - 1 of one lane's cohort (or ring) into this thread's
// RUNS accumulators: groups of GROUP rows, the next group's loads issued
// before the current group's FMAs, each column's fmaf chain in ascending
// row order.
template <typename E, int VEC, int RUNS, int GROUP>
__device__ __forceinline__ void chain(float (&acc)[RUNS][VEC],
                                      const typename Run<E, VEC>::T* __restrict__ base,
                                      const float* __restrict__ weights, int n_rows, int row,
                                      const int (&run)[RUNS], const bool (&live)[RUNS]) {
  using T = typename Run<E, VEC>::T;
  T cur[GROUP][RUNS];
  float w_cur[GROUP];
  load_group(cur, w_cur, base, weights, 0, n_rows, row, run, live);
  for (int j0 = 0; j0 < n_rows; j0 += GROUP) {
    T next[GROUP][RUNS];
    float w_next[GROUP];
    load_group(next, w_next, base, weights, j0 + GROUP, n_rows, row, run, live);  // in flight
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (j0 + j < n_rows)
#pragma unroll
        for (int u = 0; u < RUNS; ++u) {
          float x[VEC];
          Run<E, VEC>::widen(cur[j][u], x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[u][e] = fmaf(w_cur[j], x[e], acc[u][e]);
        }
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      w_cur[j] = w_next[j];
#pragma unroll
      for (int u = 0; u < RUNS; ++u) cur[j][u] = next[j][u];
    }
  }
}

// This thread's RUNS runs of one column tile of one lane: params (and m, v
// where read) loaded first, then the fmaf chain over the row sequence from
// +0.0, then the rule.  Under an AXPY rule the moments are neither read nor
// written, unless m_out is given: then m' and v' are m and v written through
// (the lanes of a B3g registry that holds a moment rule, whose outputs
// every lane fills).
template <typename E, typename M, int VEC, int RUNS>
__device__ __forceinline__ void update_tile(const E* __restrict__ updates,
                                            const float* __restrict__ weights, int k_rows,
                                            const E* __restrict__ ring,
                                            const float* __restrict__ ring_w, int kb_rows,
                                            int row, const M* __restrict__ params,
                                            const float* __restrict__ m_in,
                                            const float* __restrict__ v_in, const Rule& rule,
                                            M* __restrict__ p_out, float* __restrict__ m_out,
                                            float* __restrict__ v_out) {
  using T = typename Run<E, VEC>::T;
  using TM = typename Run<M, VEC>::T;
  using TF = typename Run<float, VEC>::T;
  constexpr int GROUP = LOADS / RUNS;  // RUNS <= 8
  int run[RUNS];
  bool live[RUNS];
#pragma unroll
  for (int u = 0; u < RUNS; ++u) {
    run[u] = (blockIdx.x * RUNS + u) * THREADS + threadIdx.x;
    live[u] = run[u] < row;
  }
  const bool moments = has_moments(rule.idx);
  const bool read_mv = moments ? m_in != nullptr : m_out != nullptr;
  TM p_raw[RUNS];
  TF m_raw[RUNS], v_raw[RUNS];
#pragma unroll
  for (int u = 0; u < RUNS; ++u) {
    p_raw[u] = live[u] ? __ldg(reinterpret_cast<const TM*>(params) + run[u]) : TM{};
    m_raw[u] = live[u] && read_mv ? __ldg(reinterpret_cast<const TF*>(m_in) + run[u]) : TF{};
    v_raw[u] = live[u] && read_mv ? __ldg(reinterpret_cast<const TF*>(v_in) + run[u]) : TF{};
  }
  float acc[RUNS][VEC];
#pragma unroll
  for (int u = 0; u < RUNS; ++u)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[u][e] = 0.0f;
  chain<E, VEC, RUNS, GROUP>(acc, reinterpret_cast<const T*>(updates), weights, k_rows, row,
                             run, live);
  if (kb_rows > 0)  // the lane drains its ring
    chain<E, VEC, RUNS, GROUP>(acc, reinterpret_cast<const T*>(ring), ring_w, kb_rows, row, run,
                               live);
#pragma unroll
  for (int u = 0; u < RUNS; ++u) {
    if (!live[u]) continue;
    float p[VEC], po[VEC];
    Run<M, VEC>::widen(p_raw[u], p);
    if (!moments) {  // the AXPY
#pragma unroll
      for (int e = 0; e < VEC; ++e) po[e] = p[e] + acc[u][e];
      reinterpret_cast<TM*>(p_out)[run[u]] = Run<M, VEC>::pack(po);
      if (m_out != nullptr) {
        reinterpret_cast<TF*>(m_out)[run[u]] = m_raw[u];
        reinterpret_cast<TF*>(v_out)[run[u]] = v_raw[u];
      }
      continue;
    }
    if (m_in == nullptr) {  // a moment rule on a lane launched without moments: refuse
      // the step visibly (the wrapper's registry check makes this unreachable)
#pragma unroll
      for (int e = 0; e < VEC; ++e) po[e] = __int_as_float(0x7fffffff);
      reinterpret_cast<TM*>(p_out)[run[u]] = Run<M, VEC>::pack(po);
      continue;
    }
    float m[VEC], v[VEC], mo[VEC], vo[VEC];
    Run<float, VEC>::widen(m_raw[u], m);
    Run<float, VEC>::widen(v_raw[u], v);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      apply_rule(rule, acc[u][e], p[e], m[e], v[e], &po[e], &mo[e], &vo[e]);
    reinterpret_cast<TM*>(p_out)[run[u]] = Run<M, VEC>::pack(po);
    reinterpret_cast<TF*>(m_out)[run[u]] = Run<float, VEC>::pack(mo);
    reinterpret_cast<TF*>(v_out)[run[u]] = Run<float, VEC>::pack(vo);
  }
}

template <typename X>
__device__ __forceinline__ X* lane_row(X* p, long long offset) {
  return p == nullptr ? nullptr : p + offset;
}

// B3 / B4 (gridDim.y == 1, rules null: the lane runs rule.idx) and B3g /
// B4g (rules[g], a global AGGREGATOR_ORDER index, for lane g = blockIdx.y).
// The lane's rule and drain flag are read once, into shared memory, so each
// branch is uniform in the block; its rows, weights, ring, params, moments
// and outputs are row g of each (lanes, ...) operand; the block is column
// tile blockIdx.x of the lane.
template <typename E, typename M, int VEC, int RUNS>
__global__ void __launch_bounds__(THREADS) server_update_kernel(
    const E* __restrict__ updates, const float* __restrict__ weights, int k_rows,
    const E* __restrict__ ring, const float* __restrict__ ring_w, int kb_rows,
    const bool* __restrict__ drain, long long p_cols,
    const M* __restrict__ params, const float* __restrict__ m_in,
    const float* __restrict__ v_in, const int* __restrict__ rules, Rule rule,
    M* __restrict__ p_out, float* __restrict__ m_out, float* __restrict__ v_out) {
  const long long g = blockIdx.y;
  __shared__ int lane_rule;
  __shared__ bool lane_drain;
  if (threadIdx.x == 0) {
    lane_rule = rules != nullptr ? rules[g] : rule.idx;
    lane_drain = kb_rows > 0 && drain[g];
  }
  __syncthreads();
  Rule r = rule;
  r.idx = lane_rule;
  const long long lane = g * p_cols;
  update_tile<E, M, VEC, RUNS>(updates + g * k_rows * p_cols, weights + g * k_rows, k_rows,
                               lane_drain ? ring + g * kb_rows * p_cols : nullptr,
                               lane_drain ? ring_w + g * kb_rows : nullptr,
                               lane_drain ? kb_rows : 0, (int)(p_cols / VEC), params + lane,
                               lane_row(m_in, lane), lane_row(v_in, lane), r, p_out + lane,
                               lane_row(m_out, lane), lane_row(v_out, lane));
}

template <typename E, typename M>
using Kernel = void (*)(const E*, const float*, int, const E*, const float*, int, const bool*,
                        long long, const M*, const float*, const float*, const int*, Rule, M*,
                        float*, float*);

// The instantiation for (vec, runs): runs is 1 or the wide plan's count.
template <typename E, typename M, int VEC>
static Kernel<E, M> kernel_runs(int runs) {
  constexpr int WIDE = wide_runs<E, VEC>();
  if (runs == 1) return server_update_kernel<E, M, VEC, 1>;
  if (runs == WIDE) return server_update_kernel<E, M, VEC, WIDE>;
  return nullptr;
}

template <typename E, typename M>
static Kernel<E, M> kernel_for(int vec, int runs) {
  switch (vec) {
    case 4:
      return kernel_runs<E, M, 4>(runs);
    case 2:
      return kernel_runs<E, M, 2>(runs);
    case 1:
      return kernel_runs<E, M, 1>(runs);
    default:
      return nullptr;
  }
}

template <typename E, typename M>
static int launch_types(const void* updates, const float* weights, int lanes, int k_rows,
                        const void* ring, const float* ring_w, int kb_rows, const bool* drain,
                        long long p_cols, const void* params, const float* m, const float* v,
                        const int* rules, Rule rule, int vec, int runs, void* p_out,
                        float* m_out, float* v_out, cudaStream_t st) {
  const Kernel<E, M> kernel = kernel_for<E, M>(vec, runs);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const long long per_tile = (long long)THREADS * vec * runs;
  const long long tiles = (p_cols + per_tile - 1) / per_tile;
  kernel<<<dim3((unsigned)tiles, (unsigned)lanes), THREADS, 0, st>>>(
      static_cast<const E*>(updates), weights, k_rows, static_cast<const E*>(ring), ring_w,
      kb_rows, drain, p_cols, static_cast<const M*>(params), m, v, rules, rule,
      static_cast<M*>(p_out), m_out, v_out);
  return (int)cudaGetLastError();
}

// Launch on `stream`: `lanes` (1 .. 65,535) lanes, lane-major: (lanes,
// k_rows, p_cols) updates and (lanes, k_rows) weights; with kb_rows > 0 a
// (lanes, kb_rows, p_cols) ring, (lanes, kb_rows) ring weights and (lanes,)
// drain flags (kb_rows = 0: ring, ring_w and drain may be null); (lanes,
// p_cols) params, m, v and outputs.  `row_bytes` is the element size of the
// update rows and the ring (4: fp32, 2: bf16), `param_bytes` that of params
// and p_out.  `rules` null: every lane runs rule_idx (B3 / B4, lanes = 1),
// and m, v, m_out and v_out may be null unless rule_idx is a moment rule
// (1-3).  `rules` given: (lanes,) int32 global AGGREGATOR_ORDER indices on
// the device (B3g / B4g), and m, v, m_out and v_out are all null (no lane
// may run a moment rule: the moments stay the caller's) or all given (every
// lane writes m' and v', an AXPY lane's through).  The plan
// (kernels/fedavg_reduce.py::column_plan): `vec` (1, 2 or 4) must divide
// p_cols and align every pointer to vec elements of its own type; `runs` is
// 1 or 16 / (vec * row_bytes) (at least 1).  A block a column tile of
// THREADS * vec * runs columns of a lane; a row's runs number below 2^31.
// `rnd` is reserved for schedule-aware rules and ignored, as in the
// reference.  Allocates nothing; returns cudaGetLastError() (0 = success).
extern "C" int server_update_launch(const void* updates, int row_bytes, const float* weights,
                                    int lanes, int k_rows, const void* ring,
                                    const float* ring_w, int kb_rows, const bool* drain,
                                    long long p_cols, const void* params, int param_bytes,
                                    const float* m, const float* v, const int* rules,
                                    int rule_idx, int rnd, float eta, float beta1,
                                    float one_m_beta1, float beta2, float one_m_beta2,
                                    float tau, int vec, int runs, void* p_out, float* m_out,
                                    float* v_out, void* stream) {
  (void)rnd;
  if (lanes < 1 || lanes > 65535 || k_rows < 1 || kb_rows < 0 || p_cols < 0 || vec < 1 ||
      p_cols % vec != 0 || p_cols / vec > INT_MAX - THREADS * 8)
    return (int)cudaErrorInvalidValue;
  if (kb_rows > 0 && (ring == nullptr || ring_w == nullptr || drain == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool any = m != nullptr || v != nullptr || m_out != nullptr || v_out != nullptr;
  const bool all = m != nullptr && v != nullptr && m_out != nullptr && v_out != nullptr;
  if (rules == nullptr ? has_moments(rule_idx) && !all : any && !all)
    return (int)cudaErrorInvalidValue;
  if (p_cols == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Rule rule{rules == nullptr ? rule_idx : 0, eta, beta1, one_m_beta1, beta2,
                  one_m_beta2, tau};
#define SU_TYPES(E, M)                                                                      \
  launch_types<E, M>(updates, weights, lanes, k_rows, ring, ring_w, kb_rows, drain, p_cols, \
                     params, m, v, rules, rule, vec, runs, p_out, m_out, v_out, st)
  if (row_bytes == 4 && param_bytes == 4) return SU_TYPES(float, float);
  if (row_bytes == 2 && param_bytes == 4) return SU_TYPES(__nv_bfloat16, float);
  if (row_bytes == 4 && param_bytes == 2) return SU_TYPES(float, __nv_bfloat16);
  if (row_bytes == 2 && param_bytes == 2) return SU_TYPES(__nv_bfloat16, __nv_bfloat16);
#undef SU_TYPES
  return (int)cudaErrorInvalidValue;
}
