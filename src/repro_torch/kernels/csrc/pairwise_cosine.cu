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
// 410 GFLOP, 6.1 ms.  This kernel computes the full N x N square there, so
// half of its work is redundant.
//
// Design: a plain SIMT tiled GEMM on the fp32 cores, no tensor cores (TF32
// would keep ten mantissa bits of the cosines).  A block of 16 x 16 threads
// owns a 64 x 64 output tile; each thread a 4 x 4 register micro-tile.  The
// contraction walks D in slabs of 32: the block stages its 64 rows of x and
// 64 rows of y for the slab in shared memory, transposed to (k, row), and
// every thread then reads its four x values and four y values per k as one
// 16-byte load each.  Global loads put 32 neighbouring threads on the 32
// consecutive k of one row, so every warp load is coalesced.  Rows past N
// or M and columns past D load as zero (no padding copy); a zero term adds
// +0 to an accumulator that is never -0, so it changes nothing.  Each
// output is one fmaf chain in ascending k from +0.0: output (i, j) and
// output (j, i) run the same chain (fmaf rounds the exact product once,
// and the product commutes), so a Gram with x = y comes out bitwise
// symmetric, whatever tile holds each half.  No atomics, no second pass.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 64          // output rows and columns per block
#define SLAB 32          // k values per shared-memory slab
#define MICRO 4          // outputs per thread along each axis
#define THREADS 256      // (TILE / MICRO)^2
#define PITCH (TILE + 4) // row pitch of the (k, row) slabs: keeps float4 alignment

__global__ void __launch_bounds__(THREADS)
gram_nt_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m,
               int d, float* __restrict__ out) {
  __shared__ __align__(16) float xs[SLAB][PITCH];
  __shared__ __align__(16) float ys[SLAB][PITCH];

  const int tid = threadIdx.x;
  const int tx = tid % (TILE / MICRO);  // column group
  const int ty = tid / (TILE / MICRO);  // row group
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  // the loaders: lane k of the slab, rows ld_row, ld_row + 8, ...
  const int ld_k = tid % SLAB;
  const int ld_row = tid / SLAB;
  constexpr int LD_STEP = THREADS / SLAB;

  float acc[MICRO][MICRO];
#pragma unroll
  for (int r = 0; r < MICRO; ++r)
#pragma unroll
    for (int c = 0; c < MICRO; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += SLAB) {
    const int k = k0 + ld_k;
    const bool k_in = k < d;
#pragma unroll
    for (int i = 0; i < TILE / LD_STEP; ++i) {
      const int r = ld_row + i * LD_STEP;
      const int gi = row0 + r;
      const int gj = col0 + r;
      xs[ld_k][r] = (k_in && gi < n) ? __ldg(x + (long long)gi * d + k) : 0.0f;
      ys[ld_k][r] = (k_in && gj < m) ? __ldg(y + (long long)gj * d + k) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < SLAB; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * MICRO]);
      const float4 b = *reinterpret_cast<const float4*>(&ys[kk][tx * MICRO]);
      const float av[MICRO] = {a.x, a.y, a.z, a.w};
      const float bv[MICRO] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < MICRO; ++r)
#pragma unroll
        for (int c = 0; c < MICRO; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MICRO; ++r) {
    const int gi = row0 + ty * MICRO + r;
    if (gi >= n) continue;
#pragma unroll
    for (int c = 0; c < MICRO; ++c) {
      const int gj = col0 + tx * MICRO + c;
      if (gj < m) out[(long long)gi * m + gj] = acc[r][c];
    }
  }
}

// Launch on `stream`: x (n, d) and y (m, d) row-major fp32, out (n, m) fp32.
// Allocates nothing; returns cudaGetLastError() (0 = success), or
// cudaErrorInvalidValue for a shape the grid cannot cover.
extern "C" int gram_nt_launch(const float* x, const float* y, int n, int m, int d,
                              float* out, void* stream) {
  if (n < 0 || m < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return (int)cudaSuccess;
  const unsigned row_tiles = (unsigned)((n + TILE - 1) / TILE);
  const unsigned col_tiles = (unsigned)((m + TILE - 1) / TILE);
  if (row_tiles > 65535u) return (int)cudaErrorInvalidValue;
  const dim3 grid(col_tiles, row_tiles);
  gram_nt_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, y, n, m, d, out);
  return (int)cudaGetLastError();
}
