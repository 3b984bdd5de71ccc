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
// the carry) that is about 15.3 MB, a bound near 4.6 us at 3.35 TB/s; at the
// fleet's chunk (K = 32) 33.1 MB, 9.9 us.  Covering HBM's latency at that
// rate takes several MB in flight, so the design is about keeping them there.
//
// Layout.  A grid axis over groups of RSU_GROUP (32) RSUs, so R is bounded
// only by the grid's y-extent (65,535 groups), and blocks of THREADS (128)
// threads along P.  Each thread owns COLS (4) columns as COLS / VEC runs of
// VEC adjacent columns, the runs THREADS * VEC columns apart, so each warp
// load or store of a run is one contiguous, coalesced span.  VEC (4, 2 or 1)
// divides P and aligns every row (the wrapper's choice): at P = 159,010 rows
// are only 8-byte aligned, and every access is an 8-byte pair.
//
// Bytes in flight.  Each thread streams its columns of the update rows
// through a ring of STAGES (2) slabs of SLAB (4) rows in shared memory with
// cp.async: the prologue issues the carry tile and the first 8 rows at once,
// and each slab's slots are refilled with the slab two ahead as soon as its
// FMAs have read them, so 4-8 rows (64-128 bytes a thread) stay on their way
// while the FMAs run.  With the carry that is 36 KB a block, ~11 MB over the
// 311 blocks of P = 159,010 (all resident, 2-3 an SM); on the card a deeper
// ring was no faster and 4 slabs of 8 rows (2 blocks an SM) slower.  A
// thread reads back only what it copied itself, so no barrier is needed; a
// short last slab (K not a multiple of SLAB) issues and sums only its rows.
// The 8-byte copies go through L1 (cp.async.ca); 16-byte-aligned rows take
// 16-byte copies past it (.cg).  Copying the 16-byte-aligned cover of each
// 8-byte-aligned row segment with the whole block, a barrier a slab, was
// slower on the card than the 8-byte pairs.
//
// The carry overlaps.  The carry tile (the group's rows of this thread's
// columns) is the first cp.async group, issued before any update row, and
// sits in shared memory until the epilogue; out may alias carry (each
// thread reads its carry columns before writing them), so a chunk walk
// updates its (R, P) partials in place.  The partials are stored with the
// default cache policy: the next chunk reads them back as its carry, from L2.
//
// Accumulators: RB per column, RB the smallest of RB_LIST not below the
// group's size (R = 10 runs exactly 10).  The mass is summed by warp 0 of the
// last column block in the same row loop, lane l for RSU r0 + l (RSU_GROUP is
// a warp), so no serial loop runs before the columns.
//
// Summation order, unchanged: each partial is one fmaf chain in ascending k
// from +0.0 over the one-hot product (rid[k] == r ? w[k] : 0) * u[k, p], added
// for every RSU of the group (rows of other RSUs are not skipped, so a
// non-finite row and signed zeros come out as the reference's contraction
// gives them), then carry + sum (one rounding in fp32; bf16 below), as the
// round's ``partials + part_c``; the mass sums m[k, r] in ascending k from +0.0.  Only the loads
// are issued early.  The order of every sum is fixed, so a run repeats
// itself bitwise.  With R > 32 every group's blocks read the K update rows
// again (from L2 at the streamed lane's chunk sizes).
//
// Precision (the bf16 lane): the update rows come as E, fp32 or bf16, and
// the partials, carry included, as O, fp32 or (for bf16 rows) bf16 (the
// reference's out_dtype; the bf16 lane's chunk carry); weights, mass and every
// accumulator stay fp32.  The ring and the carry tile hold the operands in
// their own types, a bf16 value widening to fp32 exactly when a thread reads
// it back.  A piece of VEC bf16 values is VEC*2 bytes: 4 or 8 go by cp.async
// as above, but cp.async has no 2-byte form, so the pieces of odd-P bf16 rows
// (VEC = 1) are a plain load and a store to the thread's slot, which it alone
// reads back.  The partials round as the JAX round rounds them: with a bf16
// out, the sum is rounded to bf16 first (its part_c), then added to the
// carry in fp32 and rounded again (partials + part_c, two roundings); with
// an fp32 out the first rounding is exact and the carry add rounds once, as
// before.  A bf16 store rounds to nearest even (__float2bfloat16_rn).
//
// B5g (rsu_reduce_launch with lanes > 1): G lanes of the batched grid
// round's chunk walk in one launch, the reference kernel under the engine's
// vmap.  The lane is the grid's third dimension (blockIdx.z, up to 65,535
// lanes): a block offsets the rows, weights, ids, carry, partials and
// masses by its lane (64-bit offsets: (G, K, P) rows, (G, K) weights and
// ids, (G, R, P) carry and out, (G, R) mass) and runs the column code above
// on its lane alone, so every lane is bitwise B5 on that lane, carry in
// place included.  B5 is the same launch at one lane.  Every partial is
// carry + sum, so every carry row is read and written, touched by the
// chunk or not: a row no id names still changes where the chunk holds a
// non-finite value (0 * inf) or the carry a -0.0.  At the streamed grid's
// chunk (G = 8, K = 4, R = 10, P = 159,010, with the carry) that is 122 MB
// over 2,488 blocks; the rows its ids touch need 61 MB or less.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128     // threads a block
#define COLS 4          // columns a thread
#define RSU_GROUP 32    // RSUs a block (grid axis y)
#define MAX_GROUPS 65535u
#define SLAB 4          // update rows a cp.async group
#define STAGES 2        // slabs in the ring
// accumulator counts: 10 is every catalog scenario's R (ring length / RSU spacing)
#define RB_LIST(X) X(1) X(2) X(4) X(8) X(10) X(16) X(32)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One piece of BYTES bytes from global into this thread's shared slot:
// cp.async for 4, 8 (through L1) and 16 bytes (past it); a plain load and
// store for 2, which cp.async cannot copy.
template <int BYTES>
__device__ __forceinline__ void copy_piece(void* dst, const void* src) {
  if constexpr (BYTES == 2) {
    *static_cast<unsigned short*>(dst) = __ldg(static_cast<const unsigned short*>(src));
  } else if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// VEC adjacent elements of type E as one value of T, widened to fp32
// (exactly) and narrowed from it (bf16: to nearest even).
template <typename E, int VEC>
struct Piece;
template <>
struct Piece<float, 1> {
  using T = float;
  static __device__ __forceinline__ void widen(T v, float* x) { x[0] = v; }
  static __device__ __forceinline__ T narrow(const float* x) { return x[0]; }
};
template <>
struct Piece<float, 2> {
  using T = float2;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = v.x;
    x[1] = v.y;
  }
  static __device__ __forceinline__ T narrow(const float* x) { return make_float2(x[0], x[1]); }
};
template <>
struct Piece<float, 4> {
  using T = float4;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  static __device__ __forceinline__ T narrow(const float* x) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
};

__device__ __forceinline__ float bf16_to_f32(unsigned bits) {  // the low 16 bits
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(bits & 0xffffu)));
}
__device__ __forceinline__ unsigned f32_to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
template <>
struct Piece<__nv_bfloat16, 1> {
  using T = unsigned short;
  static __device__ __forceinline__ void widen(T v, float* x) { x[0] = bf16_to_f32(v); }
  static __device__ __forceinline__ T narrow(const float* x) { return (T)f32_to_bf16(x[0]); }
};
template <>
struct Piece<__nv_bfloat16, 2> {
  using T = unsigned;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = bf16_to_f32(v);
    x[1] = bf16_to_f32(v >> 16);
  }
  static __device__ __forceinline__ T narrow(const float* x) {
    return f32_to_bf16(x[0]) | f32_to_bf16(x[1]) << 16;
  }
};
template <>
struct Piece<__nv_bfloat16, 4> {
  using T = uint2;
  static __device__ __forceinline__ void widen(T v, float* x) {
    x[0] = bf16_to_f32(v.x);
    x[1] = bf16_to_f32(v.x >> 16);
    x[2] = bf16_to_f32(v.y);
    x[3] = bf16_to_f32(v.y >> 16);
  }
  static __device__ __forceinline__ T narrow(const float* x) {
    return make_uint2(f32_to_bf16(x[0]) | f32_to_bf16(x[1]) << 16,
                      f32_to_bf16(x[2]) | f32_to_bf16(x[3]) << 16);
  }
};

// x rounded to O and back (the part_c of the JAX round; exact for fp32)
template <typename O>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(O) == 2)
    return bf16_to_f32(f32_to_bf16(x));
  else
    return x;
}

// This thread's valid runs of one row (`src` its first column) into its
// shared slot `dst` ([run][thread] VEC-element pieces, one row of the block).
template <typename E, int VEC>
__device__ __forceinline__ void copy_row(E* dst, const E* src, unsigned valid) {
#pragma unroll
  for (int q = 0; q < COLS / VEC; ++q)
    if (valid >> q & 1u)
      copy_piece<VEC * (int)sizeof(E)>(dst + q * THREADS * VEC, src + q * THREADS * VEC);
}

template <typename E, int VEC>
__device__ __forceinline__ void read_row(float* x, const E* slot) {
  using T = typename Piece<E, VEC>::T;
#pragma unroll
  for (int q = 0; q < COLS / VEC; ++q)
    Piece<E, VEC>::widen(*reinterpret_cast<const T*>(slot + q * THREADS * VEC), x + q * VEC);
}

template <typename E, typename O, int VEC, int RB>
__global__ void __launch_bounds__(THREADS)
rsu_reduce_kernel(const E* __restrict__ updates, const float* __restrict__ weights,
                  const int* __restrict__ rid, int k_rows, int n_rsu, long long p_cols,
                  const O* carry, O* out, float* __restrict__ mass) {
  using TO = typename Piece<O, VEC>::T;
  constexpr int RUNS = COLS / VEC;
  constexpr int SLOT = THREADS * COLS;  // elements of one row's slot (the block's columns)
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  // this block's lane (0 for B5): its rows, weights, ids, carry, out and mass
  const long long lane = blockIdx.z;
  updates += lane * k_rows * p_cols;
  weights += lane * k_rows;
  rid += lane * k_rows;
  if (carry != nullptr) carry += lane * n_rsu * p_cols;
  out += lane * n_rsu * p_cols;
  mass += lane * n_rsu;
  // this thread's pieces: element (q * THREADS + t) * VEC of every slot
  E* ring = reinterpret_cast<E*>(smem) + t * VEC;                    // [STAGES * SLAB] slots
  O* csm = reinterpret_cast<O*>(smem + STAGES * SLAB * SLOT * sizeof(E)) + t * VEC;  // [RB]
  const int r0 = blockIdx.y * RSU_GROUP;                  // RSUs r0 .. r0 + nr - 1
  const int nr = min(RSU_GROUP, n_rsu - r0);
  const long long col = (long long)blockIdx.x * SLOT + (long long)t * VEC;  // run 0's first
  unsigned valid = 0;
#pragma unroll
  for (int q = 0; q < RUNS; ++q)
    if (col + (long long)q * THREADS * VEC < p_cols) valid |= 1u << q;
  const bool mass_warp = blockIdx.x == gridDim.x - 1 && t < 32;
  if (valid == 0 && !mass_warp) return;

  // prologue: the carry tile, then the first STAGES slabs, one group each
  if (carry != nullptr) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < nr)
        copy_row<O, VEC>(csm + r * SLOT, carry + (long long)(r0 + r) * p_cols + col, valid);
  }
  cp_commit();
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
#pragma unroll
    for (int j = 0; j < SLAB; ++j) {
      const int k = s * SLAB + j;
      if (k < k_rows)
        copy_row<E, VEC>(ring + (s * SLAB + j) * SLOT, updates + (long long)k * p_cols + col,
                         valid);
    }
    cp_commit();
  }

  float acc[RB][COLS];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.0f;
  float msum = 0.0f;  // the mass warp: lane l sums RSU r0 + l's column of m
  const int n_slabs = (k_rows + SLAB - 1) / SLAB;
  for (int i = 0; i < n_slabs; ++i) {
    const int k0 = i * SLAB;
    float w[SLAB];
    int id[SLAB];
#pragma unroll
    for (int j = 0; j < SLAB; ++j) {
      w[j] = k0 + j < k_rows ? __ldg(weights + k0 + j) : 0.0f;
      id[j] = k0 + j < k_rows ? __ldg(rid + k0 + j) : -1;
    }
    cp_wait<STAGES - 1>();  // slab i (and the carry) landed
    E* slab = ring + (i % STAGES) * SLAB * SLOT;
#pragma unroll
    for (int j = 0; j < SLAB; ++j) {
      if (k0 + j >= k_rows) break;
      float u[COLS];
      read_row<E, VEC>(u, slab + j * SLOT);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float m = id[j] == r0 + r ? w[j] : 0.0f;
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] = fmaf(m, u[c], acc[r][c]);
      }
      if (mass_warp) msum = msum + (id[j] == r0 + t ? w[j] : 0.0f);
    }
    // refill the slots just read with the slab STAGES ahead
#pragma unroll
    for (int j = 0; j < SLAB; ++j) {
      const int k = k0 + STAGES * SLAB + j;
      if (k < k_rows)
        copy_row<E, VEC>(slab + j * SLOT, updates + (long long)k * p_cols + col, valid);
    }
    cp_commit();
  }
  cp_wait<0>();

  if (mass_warp && t < nr) mass[r0 + t] = msum;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= nr) break;
    float v[COLS];
    if (carry != nullptr) {
      read_row<O, VEC>(v, csm + r * SLOT);
#pragma unroll
      for (int c = 0; c < COLS; ++c) v[c] = v[c] + round_to<O>(acc[r][c]);
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c) v[c] = acc[r][c];
    }
    O* dst = out + (long long)(r0 + r) * p_cols + col;
#pragma unroll
    for (int q = 0; q < RUNS; ++q)
      if (valid >> q & 1u)
        *reinterpret_cast<TO*>(dst + q * THREADS * VEC) = Piece<O, VEC>::narrow(v + q * VEC);
  }
}

template <typename E, typename O, int VEC, int RB>
static int launch_cfg(dim3 blocks, cudaStream_t st, const E* updates, const float* weights,
                      const int* rid, int k_rows, int n_rsu, long long p_cols, const O* carry,
                      O* out, float* mass) {
  const int smem = (int)((STAGES * SLAB * sizeof(E) + (carry != nullptr ? RB * sizeof(O) : 0))
                         * THREADS * COLS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rsu_reduce_kernel<E, O, VEC, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  rsu_reduce_kernel<E, O, VEC, RB><<<blocks, THREADS, smem, st>>>(
      updates, weights, rid, k_rows, n_rsu, p_cols, carry, out, mass);
  return (int)cudaGetLastError();
}

template <typename E, typename O>
static int launch_types(int vec, int group, dim3 blocks, cudaStream_t st, const void* updates,
                        const float* weights, const int* rid, int k_rows, int n_rsu,
                        long long p_cols, const void* carry, void* out, float* mass) {
  const E* u = static_cast<const E*>(updates);
  const O* c = static_cast<const O*>(carry);
  O* o = static_cast<O*>(out);
#define RSU_CASE(V, RB_)                                                               \
  if (vec == V && group <= RB_)                                                        \
    return launch_cfg<E, O, V, RB_>(blocks, st, u, weights, rid, k_rows, n_rsu, p_cols, \
                                    c, o, mass);
#define RSU_VEC4(RB_) RSU_CASE(4, RB_)
#define RSU_VEC2(RB_) RSU_CASE(2, RB_)
#define RSU_VEC1(RB_) RSU_CASE(1, RB_)
  RB_LIST(RSU_VEC4)
  RB_LIST(RSU_VEC2)
  RB_LIST(RSU_VEC1)
#undef RSU_VEC1
#undef RSU_VEC2
#undef RSU_VEC4
#undef RSU_CASE
  return (int)cudaErrorInvalidValue;
}

// Launch `lanes` lanes on `stream`: B5 is one lane, B5g (the batched grid
// round's chunk) 1 to 65,535.  `updates` is (lanes, k_rows, p_cols),
// `weights` and `rid` (lanes, k_rows), `carry` and `out` (lanes, n_rsu,
// p_cols), `mass` (lanes, n_rsu), each lane-major and contiguous.
// `row_bytes` is the update rows' element size and `out_bytes` that of carry
// and out (4: fp32, 2: bf16; bf16 out only from bf16 rows, the one pairing
// the round makes).  `carry` may be null (the sum alone) or equal to `out`
// (in place).  `vec` (1, 2 or 4) must divide p_cols and every (R, P) /
// (K, P) pointer must be aligned to vec elements of its own type;
// 1 <= n_rsu <= 32 * 65535 (the grid's y-extent; the wrapper checks both).
// Allocates nothing; returns cudaGetLastError() (0 = success).
extern "C" int rsu_reduce_launch(const void* updates, int row_bytes, const float* weights,
                                 const int* rid, int lanes, int k_rows, int n_rsu,
                                 long long p_cols, int vec, const void* carry, void* out,
                                 int out_bytes, float* mass, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rsu < 1 || k_rows < 0 || p_cols < 0 || lanes < 1 || lanes > (int)MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  const unsigned groups = (unsigned)((n_rsu + RSU_GROUP - 1) / RSU_GROUP);
  if (groups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  const int group = n_rsu < RSU_GROUP ? n_rsu : RSU_GROUP;
  long long blocks_ll = (p_cols + THREADS * COLS - 1) / (THREADS * COLS);
  if (blocks_ll < 1) blocks_ll = 1;  // the last block of each group still writes the mass
  const dim3 blocks((unsigned)blocks_ll, groups, (unsigned)lanes);
#define RSU_TYPES(E, O)                                                                    \
  launch_types<E, O>(vec, group, blocks, st, updates, weights, rid, k_rows, n_rsu, p_cols, \
                     carry, out, mass)
  if (row_bytes == 4 && out_bytes == 4) return RSU_TYPES(float, float);
  if (row_bytes == 2 && out_bytes == 2) return RSU_TYPES(__nv_bfloat16, __nv_bfloat16);
  if (row_bytes == 2 && out_bytes == 4) return RSU_TYPES(__nv_bfloat16, float);
#undef RSU_TYPES
  return (int)cudaErrorInvalidValue;
}

