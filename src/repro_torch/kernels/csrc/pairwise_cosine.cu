// NT Gram product for Hopper (sm_90a): out[i, j] = sum_k x[i, k] * y[j, k].
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_cosine.py
// (_matmul_nt_kernel, launched by gram_nt's pallas_call and reached through
// pairwise_cosine): the stage-3 cosine Gram of the row-normalized update
// sketches, an (N, D) x (M, D)^T product with an fp32 accumulator.
//
// What bounds it on this card: operations.  With x != y it does 2*N*M*D
// flops on (N + M)*D + N*M values.  The Gram of x with itself (what
// pairwise_cosine asks for) is symmetric and needs only its N(N+1)/2
// distinct outputs, N(N+1)*D flops on N*D + N*N values: at the stage-3
// shape (N = 100, D = 1024) 10.3 MFLOP on 0.45 MB, a bound near 0.15 us on
// the 67 TFLOP/s fp32 cores (a launch costs more); at N = 20,000 it is
// 410 GFLOP, 6.1 ms.
//
// Design: a SIMT tiled GEMM on the fp32 cores, no tensor cores (TF32 would
// keep ten mantissa bits of the cosines).  A block of 16 x 16 threads owns a
// BM x BM output tile, BM = 16 * TM; thread (ty, tx) owns the TM x TM
// outputs at rows ty + 16 i and columns tx + 16 j.  The wrapper launches
// the symmetric form for x = y and sizes the grid from the shape
// (kernels/pairwise_cosine.py::plan):
// - Upper triangle only.  With x = y the grid walks a linear index over the
//   tiles on and above the diagonal (column-major: t = bj (bj + 1) / 2 +
//   bi), decoded to (bi, bj) by a square root corrected in integers, so it
//   is exact at any tile count.  Each output with row <= column is stored
//   from registers; each with row < column is stored again at (column,
//   row) through a shared-memory staging tile, read down its columns so
//   that both stores coalesce.  Every lower output is a copy of an upper
//   one, so the Gram is bitwise symmetric whatever order a sum runs in.
//   With x != y the grid covers the full rectangle and nothing is mirrored.
// - Loads in flight.  D is walked in slabs of 32 through a three-stage
//   cp.async ring in dynamic shared memory: while the FMAs run on one slab
//   the next two are on their way.  Slabs are stored (row, k) with a pitch
//   of 36 floats, so one 16-byte load gives a thread four k of one row and
//   the 16 rows a warp reads land on distinct bank groups.  Global copies
//   are 16 bytes when D is a multiple of 4 and the rows are 16-byte
//   aligned, 4 bytes otherwise; rows past N or M and k past D are
//   zero-filled by the copy (no padding copy), and a zero term leaves an
//   accumulator that is never -0 unchanged.
// - A filled card at small N.  Large N uses 128 x 128 tiles (8 x 8 per
//   thread), smaller N 32 x 32 tiles (2 x 2).  When those leave fewer
//   tiles than SMs, D is split across blocks as well, still in one launch:
//   each block writes its partial tile to scratch, counts itself in on a
//   per-tile arrival counter (after a fence), and the last block to arrive
//   sums the partials in
//   ascending split order (loading several splits' values at a time, so the
//   L2 reads overlap), stores the tile and resets the counter to 0.  The
//   counters are zeroed once per device by the wrapper; no float atomics,
//   so a run repeats itself bitwise.
// Each partial is one fmaf chain in ascending k from +0.0.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256     // 16 x 16
#define BK 32           // k values per pipeline stage
#define PITCH (BK + 4)  // floats per staged row: 16-byte aligned, conflict-free float4 reads
#define STAGES 3

template <int TM>
struct Cfg {
  static constexpr int BM = 16 * TM;                // tile rows and columns
  static constexpr int STAGE = 2 * BM * PITCH;      // floats per stage: x rows, then y rows
  static constexpr int PIPE = STAGES * STAGE;
  static constexpr int OUT_PITCH = BM + 1;          // the mirror's staging tile
  static constexpr int OUT = BM * OUT_PITCH;
  static constexpr int SMEM = (PIPE > OUT ? PIPE : OUT) * 4;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? BYTES : 0;  // 0: nothing read, the destination zero-filled
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
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

// Tile t of the upper triangle, t = bj (bj + 1) / 2 + bi with bi <= bj.
__device__ __forceinline__ void upper_tile(long long t, int& bi, int& bj) {
  int j = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((long long)j * (j + 1) / 2 > t) --j;
  while ((long long)(j + 1) * (j + 2) / 2 <= t) ++j;
  bj = j;
  bi = (int)(t - (long long)j * (j + 1) / 2);
}

// Copy k slab [k0, k0 + BK) of x rows row0.. and y rows col0.. into stage `st`.
template <int TM, int VEC>
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ x,
                                           const float* __restrict__ y, int row0, int col0,
                                           int n, int m, int d, int k0, int tid) {
  constexpr int BM = Cfg<TM>::BM;
  constexpr int PER_ROW = BK / VEC;
  constexpr int PER_OP = BM * PER_ROW;  // a multiple of THREADS
#pragma unroll
  for (int i = 0; i < 2 * PER_OP / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const bool is_y = c >= PER_OP;
    const int cc = is_y ? c - PER_OP : c;
    const int r = cc / PER_ROW;
    const int kk = (cc % PER_ROW) * VEC;
    const int g = (is_y ? col0 : row0) + r;
    const float* base = is_y ? y : x;
    const bool ok = g < (is_y ? m : n) && k0 + kk < d;  // VEC = 4: d % 4 == 0
    const float* src = ok ? base + (long long)g * d + k0 + kk : base;
    cp_async<VEC * 4>(st + (is_y ? BM * PITCH : 0) + r * PITCH + kk, src, ok);
  }
}

// acc[i][j] += sum over k-slabs [kt0, kt1) of x[row0 + ty + 16 i, k] * y[col0 + tx + 16 j, k].
template <int TM, int VEC>
__device__ __forceinline__ void mainloop(float (&acc)[TM][TM], float* smem,
                                         const float* __restrict__ x,
                                         const float* __restrict__ y, int row0, int col0, int n,
                                         int m, int d, int kt0, int kt1, int tid, int tx,
                                         int ty) {
  constexpr int BM = Cfg<TM>::BM;
  constexpr int STAGE = Cfg<TM>::STAGE;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt0 + s < kt1)
      load_stage<TM, VEC>(smem + s * STAGE, x, y, row0, col0, n, m, d, (kt0 + s) * BK, tid);
    cp_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_wait<STAGES - 2>();  // slab kt has landed (for this thread's copies) ...
    __syncthreads();        // ... for every thread's, and slab kt - 1's stage is free
    const int nxt = kt + STAGES - 1;
    if (nxt < kt1)
      load_stage<TM, VEC>(smem + ((nxt - kt0) % STAGES) * STAGE, x, y, row0, col0, n, m, d,
                          nxt * BK, tid);
    cp_commit();
    const float* xs = smem + ((kt - kt0) % STAGES) * STAGE;
    const float* ys = xs + BM * PITCH;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + (ty + 16 * i) * PITCH + kk);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(ys + (tx + 16 * j) * PITCH + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free for the epilogue
}

// Store the tile.  symmetric: the outputs with row <= column from registers,
// and those with row < column again at (column, row) through shared memory.
template <int TM>
__device__ __forceinline__ void store_tile(const float (&acc)[TM][TM], float* smem,
                                           float* __restrict__ out, int n, int m, int row0,
                                           int col0, bool symmetric, int tid, int tx, int ty) {
  constexpr int BM = Cfg<TM>::BM;
  constexpr int OP = Cfg<TM>::OUT_PITCH;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < n && c < m && (!symmetric || r <= c)) out[(long long)r * m + c] = acc[i][j];
    }
  }
  if (!symmetric) return;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) smem[(ty + 16 * i) * OP + tx + 16 * j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < BM * BM; e += THREADS) {
    const int rl = e % BM;  // neighbouring threads: neighbouring rows -> one output row
    const int cl = e / BM;
    const int r = row0 + rl;
    const int c = col0 + cl;
    if (r < c && c < n) out[(long long)c * n + r] = smem[rl * OP + cl];
  }
}

template <int TM, int VEC>
__global__ void __launch_bounds__(THREADS)
    gram_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m, int d,
                int symmetric, int col_tiles, int splits, float* __restrict__ out,
                float* __restrict__ scratch, int* __restrict__ counters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  constexpr int BM = Cfg<TM>::BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long blk = blockIdx.x;
  const int split = (int)(blk % splits);
  const long long tile = blk / splits;
  int bi, bj;
  if (symmetric) {
    upper_tile(tile, bi, bj);
  } else {
    bi = (int)(tile / col_tiles);
    bj = (int)(tile % col_tiles);
  }
  const int row0 = bi * BM;
  const int col0 = bj * BM;
  const int kt_all = (d + BK - 1) / BK;
  const int kt0 = (int)((long long)split * kt_all / splits);
  const int kt1 = (int)((long long)(split + 1) * kt_all / splits);

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;
  mainloop<TM, VEC>(acc, smem, x, y, row0, col0, n, m, d, kt0, kt1, tid, tx, ty);

  if (splits > 1) {
    // this split's partial tile to scratch; the last block of the tile to
    // arrive sums all of them in ascending split order
    float* part = scratch + tile * splits * (BM * BM);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
        part[(long long)split * (BM * BM) + (ty + 16 * i) * BM + tx + 16 * j] = acc[i][j];
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(counters + tile, 1) == splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    constexpr int BATCH = TM * TM >= 32 ? 1 : 32 / (TM * TM);  // splits per batch of loads
    for (int s0 = 0; s0 < splits; s0 += BATCH) {
      float v[BATCH][TM][TM];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j)
            v[u][i][j] = s0 + u < splits
                             ? __ldcg(part + (long long)(s0 + u) * (BM * BM) +
                                      (ty + 16 * i) * BM + tx + 16 * j)
                             : 0.0f;
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j)
            if (s0 + u < splits) acc[i][j] = s0 + u == 0 ? v[u][i][j] : acc[i][j] + v[u][i][j];
    }
    if (tid == 0) counters[tile] = 0;  // ready for the next launch
  }
  store_tile<TM>(acc, smem, out, n, m, row0, col0, symmetric != 0, tid, tx, ty);
}

template <int TM, int VEC>
static int launch_cfg(unsigned blocks, cudaStream_t st, const float* x, const float* y, int n,
                      int m, int d, int symmetric, int col_tiles, int splits, float* out,
                      float* scratch, int* counters) {
  constexpr int smem = Cfg<TM>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gram_kernel<TM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  gram_kernel<TM, VEC><<<blocks, THREADS, smem, st>>>(x, y, n, m, d, symmetric, col_tiles,
                                                      splits, out, scratch, counters);
  return (int)cudaGetLastError();
}

// Launch on `stream`: x (n, d) and y (m, d) row-major fp32, out (n, m) fp32.
// symmetric = 1 asks for x x^T (y == x, m == n) over the upper tiles, mirrored.
// tm (2 or 8) sets the tile, BM = 16 tm; splits >= 1 the number of blocks
// that share each tile's k range, with scratch of tiles * splits * BM * BM
// floats and `counters` (one int per tile, all 0) when splits > 1; vec (1 or
// 4) the global copy width in floats: 4 needs d % 4 == 0 and 16-byte aligned
// x and y.  Allocates nothing; returns cudaGetLastError() (0 = success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gram_nt_launch(const float* x, const float* y, int n, int m, int d,
                              int symmetric, int tm, int splits, int vec, float* out,
                              float* scratch, int* counters, void* stream) {
  if (n < 0 || m < 0 || d < 0 || splits < 1 || (vec != 1 && vec != 4) ||
      (tm != 2 && tm != 8))
    return (int)cudaErrorInvalidValue;
  if (symmetric && (x != y || n != m)) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (scratch == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return (int)cudaSuccess;
  const long long bm = 16 * tm;
  const long long row_tiles = (n + bm - 1) / bm;
  const long long col_tiles = (m + bm - 1) / bm;
  const long long tiles = symmetric ? row_tiles * (row_tiles + 1) / 2 : row_tiles * col_tiles;
  const long long blocks = tiles * splits;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned b = (unsigned)blocks;
  const int ct = (int)col_tiles;
#define GRAM_CASE(TM_, VEC_)                                                                 \
  if (tm == TM_ && vec == VEC_)                                                              \
    return launch_cfg<TM_, VEC_>(b, st, x, y, n, m, d, symmetric, ct, splits, out, scratch, \
                                 counters);
  GRAM_CASE(8, 4)
  GRAM_CASE(8, 1)
  GRAM_CASE(2, 4)
  GRAM_CASE(2, 1)
#undef GRAM_CASE
  return (int)cudaErrorInvalidValue;
}
