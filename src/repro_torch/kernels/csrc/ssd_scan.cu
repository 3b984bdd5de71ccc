// Mamba2 SSD chunked scan for Hopper (sm_90a).  Per batch row b and head, over chunks
// of Q steps, with cs = inclusive cumsum(dt * A) inside the chunk:
//
//   y[q] = sum_{k <= q} (C_q . B_k) exp(cs_q - cs_k) dt_k x_k  +  exp(cs_q) C_q . h
//   h   <- exp(cs_last) h + S,   S = sum_k exp(cs_last - cs_k) dt_k x_k (x) B_k
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (_ssd_chunk_kernel,
// launched by ssd_scan's pallas_call): the prefill's SSM scan, once per layer.
//
// What bounds it on this card: bytes.  At hymba-1.5b's prefill (B = 4, S = 2048,
// nh = 50, hp = 64, ds = 16, Q = 128, bf16) it moves about 160 MB (y out in fp32 is
// 105 MB of it; about 48 us at 3.35 TB/s) for about 5.2 GFLOP, nearly all of it in four
// products (C B^T, M x, B^T (w x) and C h^T: about 10 us on the tensor cores).
//
// Design.  Only h runs in series, so one block of 128 threads takes one (b, head,
// chunk): 3,200 blocks at hymba's prefill, five resident an SM.  A block copies its
// chunk's dt, B and C, then x, into shared memory (cp.async, zero-padded to whole mma
// tiles), forms cs by a scan of 32 steps a warp, computes the chunk's own state S, then
// takes h_{c-1} from the block of the chunk before, publishes h_c = exp(cs_last) h_{c-1}
// + S, and last forms y with h_{c-1}.  The chain runs through the output h itself:
// each block overwrites its (b, head)'s h with its outgoing state and raises that
// row's count (release); the next chunk's block waits for the count (acquire), so the
// last chunk leaves the final state there.  Blocks take their (b, head, chunk) from an
// atomic ticket in chunk order, so a block waits only on a lower ticket, held by a
// block already running: no deadlock whatever the card keeps resident.  The block that
// draws the last ticket zeroes the ticket, and each chain's last block its count, so
// the counters are zeroed once per device (kernels/build.py::counters).
//
// The products run on the tensor cores (mma.sync) at fp32's accuracy.  With bf16 x, B
// and C (the model's), they are bf16 m16n8k16 products: x, B and C are exact, and the
// fp32 operand (M, w x, h) is split into three bf16 parts (24 bits), each product
// issued three times; the operands come through ldmatrix (.trans for x and B^T).  M =
// (C B^T) exp(cs_q - cs_k) dt_k never leaves registers: G = C B^T's accumulator,
// scaled, is M x's A operand, 16 steps at a time, and the next G is issued before this
// step's exponentials.  With fp32 inputs they are TF32 m16n8k8 products, each operand
// split into a TF32 high part and its remainder (three products, dropping lo * lo).
// The k <= q test comes BEFORE the exponential: above the diagonal its argument is
// -inf, so it gives 0 and never overflows (inf * 0 would be NaN), without a branch.
// Padded steps have dt = 0 and B = C = x = 0, which leave cs and the state unchanged,
// so a ragged last chunk is exact; hp pads with zero columns to whole units of 64.
// Shared memory is e Qp (xp + 2 bp) + 4 (hp64 (ds16 + 4) + 3 Q32) bytes (e the element
// size; Qp, ds16, hp64, Q32: Q, ds, hp, Q rounded up to 16, 16, 64, 32; xp, bp the row
// pitches, 4 mod 8 words so that the fragment reads are free of bank conflicts):
// 37,376 at hymba's head in bf16, 205,312 at mamba2's ds = 128 in fp32.  Every sum
// runs in a fixed order, whichever block draws which ticket, so a run repeats itself
// bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "grants.cuh"

#define THREADS 128
#define WARPS (THREADS / 32)
#define YT 8     // n-tiles of 8 columns of hp in one unit of the y product
#define CHAIN 8  // state elements a thread carries along the chain at once

__device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// an fp32 value as a TF32 high part and the remainder (the mma reads the remainder's
// top 19 bits: x to within 2^-21)
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  uint32_t hi;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b at fp32's accuracy: the small cross terms first, then hi * hi (lo * lo,
// 2^-22 of the product, dropped)
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4], Split b0, Split b1) {
  mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, each lane giving one row's address
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

// (a, b) as three bf16 pairs, high part first, that sum to them within 2^-24 each
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = a - __low2float(h);
  b = b - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(m), b - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// exp(x) on the MUFU unit, results below 2^-126 flushed to 0 (of no weight beside
// the terms they are summed with); exp(-inf) = 0
__device__ __forceinline__ float exp_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// an asynchronous copy into shared memory of `bytes` (16 or 4), zero-filled when !full
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}

// rows x cols of src (row r at src + r * src_pitch) into dst (pitch `pitch` elements),
// zero-filled to rows_pad x cols_pad.  vec: rows of whole 16-byte pieces on 16-byte
// boundaries, copied asynchronously (the caller waits); else element by element.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src, long long src_pitch,
                                      int rows, int rows_pad, int cols, int cols_pad,
                                      bool vec) {
  const T zero = T(0.0f);
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int pieces = cols / E;
    for (int i = threadIdx.x; i < rows_pad * pieces; i += THREADS) {
      const int r = i / pieces;
      const int e = (i - r * pieces) * E;
      cp_async<16>(dst + r * pitch + e, src + (r < rows ? r : 0) * src_pitch + e, r < rows);
    }
    const int tail = cols_pad - cols;
    for (int i = threadIdx.x; i < rows_pad * tail; i += THREADS) {
      const int r = i / tail;
      dst[r * pitch + cols + (i - r * tail)] = zero;
    }
  } else {
    for (int i = threadIdx.x; i < rows_pad * cols_pad; i += THREADS) {
      const int r = i / cols_pad;
      const int p = i - r * cols_pad;
      dst[r * pitch + p] = r < rows && p < cols ? src[r * src_pitch + p] : zero;
    }
  }
}

// shared memory row pitch, in elements, of a tile of `cols` columns padded to a multiple
// of `tile` (16 or 64): a byte multiple of 16 (whole cp.async pieces) and 4 mod 8 words
// (the fragment reads hit 32 distinct banks)
template <typename T>
__host__ __device__ __forceinline__ int pitch(int cols, int tile) {
  return (cols + tile - 1) / tile * tile + (sizeof(T) == 2 ? 8 : 4);
}

// d += G = C B^T in TF32: rows qa, qa + 8 of C against steps k8..k8+7 of B (a 16 x 8
// tile), as the accumulator fragment holds it
__device__ __forceinline__ void gram(float (&d)[4], const float* cm, const float* bs, int bp,
                                     int qa, int k8, int ds16, int g, int t) {
#pragma unroll 1
  for (int n8 = 0; n8 < ds16; n8 += 8) {
    const float* ca = cm + qa * bp + n8 + t;
    const Split a[4] = {split(ca[0]), split(ca[8 * bp]), split(ca[4]), split(ca[8 * bp + 4])};
    const float* bb = bs + (k8 + g) * bp + n8 + t;
    mma3(d, a, split(bb[0]), split(bb[4]));
  }
}

// d[0], d[1] += G = C B^T in bf16: rows q0..q0+15 of C against steps k0..k0+7 and
// k0+8..k0+15 of B, as the accumulator fragments hold them (lr, lm: this lane's
// ldmatrix row and matrix)
__device__ __forceinline__ void gram16(float (&d)[2][4], const __nv_bfloat16* cm,
                                       const __nv_bfloat16* bs, int bp, int q0, int k0,
                                       int ds16, int lr, int lm) {
#pragma unroll 1
  for (int n16 = 0; n16 < ds16; n16 += 16) {
    uint32_t a[4], b[4];
    ldsm_x4(a, cm + (q0 + (lm & 1) * 8 + lr) * bp + n16 + (lm >> 1) * 8);
    ldsm_x4(b, bs + (k0 + (lm >> 1) * 8 + lr) * bp + n16 + (lm & 1) * 8);
    mma_bf16(d[0], a, b[0], b[1]);
    mma_bf16(d[1], a, b[2], b[3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 5)
    ssd_scan_kernel(const T* __restrict__ xh, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bs,
                    const T* __restrict__ Cs, const float* __restrict__ h0, int batch, int seq,
                    int nh, int hp, int ds, int Q, bool vec_x, bool vec_bc,
                    float* __restrict__ y, float* __restrict__ hout, int* counters) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  // hp pads to whole y units of YT * 8 columns (zero columns), so that no fragment loop
  // tests a column count
  const int Qp = round_up(Q, 16), hp64 = round_up(hp, YT * 8), ds16 = round_up(ds, 16);
  const int Q32 = round_up(Q, 32);
  const int xp = pitch<T>(hp, YT * 8), bp = pitch<T>(ds, 16), dp = ds16 + 4;
  T* xs = reinterpret_cast<T*>(smem);      // (Qp, xp): x of the chunk
  T* bs = xs + Qp * xp;                    // (Qp, bp): B
  T* cm = bs + Qp * bp;                    // (Qp, bp): C
  float* dts = reinterpret_cast<float*>(cm + Qp * bp);  // (Q32,): dt
  float* hs = dts + Q32;                   // (hp64, dp): S, then h_{c-1}, as [p][n]
  float* css = hs + hp64 * dp;             // (Q32,): cs
  float* ws = css + Q32;                   // (Q32,): exp(cs_last - cs_k) dt_k

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragment's row group and column pair
  const int rows_bh = batch * nh;
  const int nc = (seq + Q - 1) / Q;
  const int hpds = hp * ds;
  int* ticket = counters;  // then one chain count per (b, head)

  // (1) the ticket, in chunk-major order: a chunk waits only on lower tickets, each
  // held by a block already running.  The last block to draw zeroes it for the next
  // launch.
  __shared__ int s_ticket;
  if (tid == 0) {
    const int tk = atomicAdd(ticket, 1);
    if (tk == (int)gridDim.x - 1) *ticket = 0;
    s_ticket = tk;
  }
  __syncthreads();
  const int c = s_ticket / rows_bh;
  const int bh = s_ticket - c * rows_bh;
  const int b = bh / nh, head = bh - b * nh;
  const int qc = min(Q, seq - c * Q);
  const long long step0 = (long long)b * seq + (long long)c * Q;

  // stage the chunk: dt, B and C as one group of copies, then x, in flight while the
  // scan runs
  for (int i = tid; i < Q32; i += THREADS)
    cp_async<4>(dts + i, dt + (step0 + min(i, qc - 1)) * nh + head, i < qc);
  stage(bs, bp, Bs + step0 * ds, ds, qc, Qp, ds, ds16, vec_bc);
  stage(cm, bp, Cs + step0 * ds, ds, qc, Qp, ds, ds16, vec_bc);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage(xs, xp, xh + step0 * nh * hp + (long long)head * hp, (long long)nh * hp, qc, Qp, hp,
        hp64, vec_x);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  // (2) cs: an inclusive scan of dt A, 32 steps a warp, each segment then carrying
  // the totals of those before it, summed in order (ws holds the totals meanwhile)
  const float a = A[head];
  for (int k0 = warp * 32; k0 < Q32; k0 += THREADS) {
    float v = dts[k0 + lane] * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = v + u;
    }
    css[k0 + lane] = v;
    if (lane == 31) ws[k0 / 32] = v;
  }
  __syncthreads();
  for (int i = 32 + tid; i < Q32; i += THREADS) {
    float carry = ws[0];
    for (int seg = 1; seg < i / 32; ++seg) carry = carry + ws[seg];
    css[i] = css[i] + carry;
  }
  __syncthreads();
  const float cs_last = css[Q32 - 1];
  for (int i = tid; i < Q32; i += THREADS) ws[i] = expf(cs_last - css[i]) * dts[i];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // x
  __syncthreads();
  const float decay = expf(cs_last);
  const int k_end = round_up(qc, 8);  // steps past it are zero

  // (3) the chunk's own state S^T (ds16, hp64) = B^T (w x)
  const int nj = hp64 / 8;
  const int lr = lane & 7, lm = lane >> 3;  // this lane's ldmatrix row and matrix
  if constexpr (BF16) {
    // bf16: 16 x 16 tiles (two of hp's 8-column tiles), 16 steps a pass; B^T and x
    // through ldmatrix.trans, w x in three bf16 parts
    const int npair = nj / 2;
    for (int tile = warp; tile < (ds16 / 16) * npair; tile += WARPS) {
      const int n0 = tile / npair * 16, j8 = (tile % npair) * 16;
      float s[2][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < round_up(qc, 16); k0 += 16) {
        uint32_t a[4], xb[4], bh[4], bm[4], bl[4];
        ldsm_x4_trans(a, bs + (k0 + (lm >> 1) * 8 + lr) * bp + n0 + (lm & 1) * 8);
        ldsm_x4_trans(xb, xs + (k0 + (lm & 1) * 8 + lr) * xp + j8 + (lm >> 1) * 8);
        // xb[e]: x at steps (2t, 2t + 1) + 8 (e & 1), column j8 + 8 (e >> 1) + g
        const float w[4] = {ws[k0 + 2 * t], ws[k0 + 2 * t + 1], ws[k0 + 8 + 2 * t],
                            ws[k0 + 9 + 2 * t]};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split3(w[2 * (e & 1)] * __uint_as_float(xb[e] << 16),
                 w[2 * (e & 1) + 1] * __uint_as_float(xb[e] & 0xffff0000u), bh[e], bm[e],
                 bl[e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_bf16(s[h], a, bl[2 * h], bl[2 * h + 1]);
          mma_bf16(s[h], a, bm[2 * h], bm[2 * h + 1]);
          mma_bf16(s[h], a, bh[2 * h], bh[2 * h + 1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* hr = hs + (j8 + 8 * h + 2 * t) * dp + n0 + g;
        hr[0] = s[h][0];
        hr[dp] = s[h][1];
        hr[8] = s[h][2];
        hr[dp + 8] = s[h][3];
      }
    }
  } else {
    // fp32: TF32 16 x 8 tiles, 8 steps a pass, k permuted as in M x
    for (int tile = warp; tile < (ds16 / 16) * nj; tile += WARPS) {
      const int n0 = tile / nj * 16, j8 = (tile % nj) * 8;
      float s[4] = {};
      for (int k8 = 0; k8 < k_end; k8 += 8) {
        const int ka = k8 + 2 * t;
        const T* ba = bs + ka * bp + n0 + g;
        const Split a[4] = {split(ba[0]), split(ba[8]), split(ba[bp]), split(ba[bp + 8])};
        const T* xa = xs + ka * xp + j8 + g;
        mma3(s, a, split(ws[ka] * xa[0]), split(ws[ka + 1] * xa[xp]));
      }
      float* hr = hs + (j8 + 2 * t) * dp + n0 + g;
      hr[0] = s[0];
      hr[dp] = s[1];
      hr[8] = s[2];
      hr[dp + 8] = s[3];
    }
  }
  __syncthreads();

  // (4) the chain: h_{c-1} from the chunk before, h_c out, through the output h
  float* slot = hout + (long long)bh * hpds;
  int* progress = counters + 1 + bh;
  if (c > 0 && tid == 0) {
    while (load_acquire(progress) < c) __nanosleep(32);
  }
  __syncthreads();
  for (int i0 = 0; i0 < hpds; i0 += CHAIN * THREADS) {
    float prev[CHAIN];  // all of a thread's loads in flight at once
#pragma unroll
    for (int r = 0; r < CHAIN; ++r) {
      const int i = i0 + r * THREADS + tid;
      prev[r] = i >= hpds ? 0.0f
                : c > 0 ? __ldcg(slot + i)
                : h0 != nullptr ? h0[(long long)bh * hpds + i] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < CHAIN; ++r) {
      const int i = i0 + r * THREADS + tid;
      if (i < hpds) {
        const int p = i / ds, n = i - p * ds;
        const float sv = hs[p * dp + n];
        hs[p * dp + n] = prev[r];
        __stcg(slot + i, decay * prev[r] + sv);
      }
    }
  }
  __syncthreads();  // the block's stores ordered before thread 0's release; hs is h_{c-1}
  if (tid == 0) {
    if (c + 1 < nc)
      store_release(progress, c + 1);
    else if (nc > 1)
      *progress = 0;  // the chain's end: ready for the next launch
  }

  // (5) y: units of 16 rows x YT * 8 columns, in row order, dealt to the warps in a
  // snake so that each warp's share of the triangle is even
  const int n_pc = hp64 / (YT * 8);
  const int units = Qp / 16 * n_pc;
  for (int s = 0; s * WARPS < units; ++s) {
    const int u = s * WARPS + ((s & 1) ? WARPS - 1 - warp : warp);
    if (u >= units) continue;
    const int q0 = u / n_pc * 16;
    const int p0 = u % n_pc * (YT * 8);
    if (q0 >= qc) continue;
    const int qa = q0 + g, qb = qa + 8;
    const float csa = css[qa], csb = css[qb];
    const int kq = min(q0 + 16, k_end);
    float acc[YT][4] = {};
    // the entering state's share, exp(cs_q) C_q . h_{c-1}
    if constexpr (BF16) {
      // bf16 C through ldmatrix, h in three bf16 parts, 16 state columns a pass
#pragma unroll 1
      for (int n16 = 0; n16 < ds16; n16 += 16) {
        uint32_t a[4];
        ldsm_x4(a, cm + (q0 + (lm & 1) * 8 + lr) * bp + n16 + (lm >> 1) * 8);
#pragma unroll
        for (int j = 0; j < YT; ++j) {
          const float* hb = hs + (p0 + j * 8 + g) * dp + n16 + 2 * t;
          const float2 hu = *reinterpret_cast<const float2*>(hb);
          const float2 hv = *reinterpret_cast<const float2*>(hb + 8);
          uint32_t uh, um, ul, vh, vm, vl;
          split3(hu.x, hu.y, uh, um, ul);
          split3(hv.x, hv.y, vh, vm, vl);
          mma_bf16(acc[j], a, ul, vl);
          mma_bf16(acc[j], a, um, vm);
          mma_bf16(acc[j], a, uh, vh);
        }
      }
    } else {
#pragma unroll 1
      for (int n8 = 0; n8 < ds16; n8 += 8) {
        const T* ca = cm + qa * bp + n8 + t;
        const Split a[4] = {split(ca[0]), split(ca[8 * bp]), split(ca[4]), split(ca[8 * bp + 4])};
#pragma unroll
        for (int j = 0; j < YT; ++j) {
          const float* hb = hs + (p0 + j * 8 + g) * dp + n8 + t;
          mma3(acc[j], a, split(hb[0]), split(hb[4]));
        }
      }
    }
    const float ea = expf(csa), eb = expf(csb);
#pragma unroll
    for (int j = 0; j < YT; ++j) {
      acc[j][0] = acc[j][0] * ea;
      acc[j][1] = acc[j][1] * ea;
      acc[j][2] = acc[j][2] * eb;
      acc[j][3] = acc[j][3] * eb;
    }
    // the chunk's own steps k <= q: M = (C B^T) exp(cs_q - cs_k) dt_k, then M x.  G =
    // C B^T of the next steps is issued before this step's exponentials, so that its
    // latency hides behind them.
    if constexpr (BF16) {
      // bf16 x, B, C: 16 steps a pass on the bf16 tensor cores, C, B and x through
      // ldmatrix; M in three bf16 parts (24 bits), the accumulator of G as M's A operand
      float gn[2][4] = {};
      gram16(gn, cm, bs, bp, q0, 0, ds16, lr, lm);
      for (int k0 = 0; k0 <= q0; k0 += 16) {
        const float gq[2][4] = {{gn[0][0], gn[0][1], gn[0][2], gn[0][3]},
                                {gn[1][0], gn[1][1], gn[1][2], gn[1][3]}};
        if (k0 < q0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) gn[h][0] = gn[h][1] = gn[h][2] = gn[h][3] = 0.0f;
          gram16(gn, cm, bs, bp, q0, k0 + 16, ds16, lr, lm);
        }
        // M's A fragment: a0 (qa, steps ka, kb of the first 8), a1 (qb, the same),
        // a2 and a3 the same for the second 8; in three parts
        uint32_t mh[4], mm[4], ml[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ka = k0 + 8 * h + 2 * t, kb = ka + 1;
          const float cka = css[ka], ckb = css[kb], dta = dts[ka], dtb = dts[kb];
          const float m0 = gq[h][0] * exp_ftz(ka <= qa ? csa - cka : -INFINITY) * dta;
          const float m1 = gq[h][1] * exp_ftz(kb <= qa ? csa - ckb : -INFINITY) * dtb;
          const float m2 = gq[h][2] * exp_ftz(ka <= qb ? csb - cka : -INFINITY) * dta;
          const float m3 = gq[h][3] * exp_ftz(kb <= qb ? csb - ckb : -INFINITY) * dtb;
          split3(m0, m1, mh[2 * h], mm[2 * h], ml[2 * h]);
          split3(m2, m3, mh[2 * h + 1], mm[2 * h + 1], ml[2 * h + 1]);
        }
#pragma unroll
        for (int j = 0; j < YT; j += 2) {
          // x steps k0.. and k0+8.. at columns j and j + 1, transposed into B fragments
          uint32_t b[4];
          ldsm_x4_trans(b, xs + (k0 + (lm & 1) * 8 + lr) * xp + p0 + (j + (lm >> 1)) * 8);
          mma_bf16(acc[j], ml, b[0], b[1]);
          mma_bf16(acc[j], mm, b[0], b[1]);
          mma_bf16(acc[j], mh, b[0], b[1]);
          mma_bf16(acc[j + 1], ml, b[2], b[3]);
          mma_bf16(acc[j + 1], mm, b[2], b[3]);
          mma_bf16(acc[j + 1], mh, b[2], b[3]);
        }
      }
    } else {
      float gn[4] = {};
      gram(gn, cm, bs, bp, qa, 0, ds16, g, t);
      for (int k8 = 0; k8 < kq; k8 += 8) {
        // gq: G[qa][ka], G[qa][kb], G[qb][ka], G[qb][kb]
        const float gq[4] = {gn[0], gn[1], gn[2], gn[3]};
        if (k8 + 8 < kq) {
          gn[0] = gn[1] = gn[2] = gn[3] = 0.0f;
          gram(gn, cm, bs, bp, qa, k8 + 8, ds16, g, t);
        }
        const int ka = k8 + 2 * t, kb = ka + 1;
        const float cka = css[ka], ckb = css[kb], dta = dts[ka], dtb = dts[kb];
        const float m0 = gq[0] * exp_ftz(ka <= qa ? csa - cka : -INFINITY) * dta;
        const float m1 = gq[1] * exp_ftz(kb <= qa ? csa - ckb : -INFINITY) * dtb;
        const float m2 = gq[2] * exp_ftz(ka <= qb ? csb - cka : -INFINITY) * dta;
        const float m3 = gq[3] * exp_ftz(kb <= qb ? csb - ckb : -INFINITY) * dtb;
        // as the A operand: fragment k = t is step ka, k = t + 4 is step kb
        const Split a[4] = {split(m0), split(m2), split(m1), split(m3)};
#pragma unroll
        for (int j = 0; j < YT; ++j) {
          const T* xa = xs + ka * xp + p0 + j * 8 + g;
          mma3(acc[j], a, split(xa[0]), split(xa[xp]));
        }
      }
    }
    float* ya = y + (step0 + qa) * nh * hp + (long long)head * hp;
    float* yb = ya + 8LL * nh * hp;
#pragma unroll
    for (int j = 0; j < YT; ++j) {
      const int p = p0 + j * 8 + 2 * t;
      if (qa < qc) {
        if (p < hp) ya[p] = acc[j][0];
        if (p + 1 < hp) ya[p + 1] = acc[j][1];
      }
      if (qb < qc) {
        if (p < hp) yb[p] = acc[j][2];
        if (p + 1 < hp) yb[p + 1] = acc[j][3];
      }
    }
  }
}

template <typename T>
static int launch_typed(int smem, cudaStream_t st, const void* xh, const float* dt,
                        const float* A, const void* Bs, const void* Cs, const float* h0,
                        int batch, int seq, int nh, int hp, int ds, int Q, bool vec_x,
                        bool vec_bc, float* y, float* hout, int* counters) {
  // above 48 KB a block's dynamic shared memory must be opted into, per
  // device (grants.cuh); one Grants an element type, as one kernel each
  static Grants granted;
  const cudaError_t err = grant_on_device((const void*)ssd_scan_kernel<T>, granted, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)batch * nh * ((seq + Q - 1) / Q));
  ssd_scan_kernel<T><<<blocks, THREADS, smem, st>>>(
      static_cast<const T*>(xh), dt, A, static_cast<const T*>(Bs), static_cast<const T*>(Cs),
      h0, batch, seq, nh, hp, ds, Q, vec_x, vec_bc, y, hout, counters);
  return (int)cudaSuccess;
}

// Launch on `stream`.  xh (B, S, nh, hp), Bs / Cs (B, S, ds) of one element type
// (dtype 0 = float32, 1 = bfloat16); dt (B, S, nh), A (nh,), h0 (B, nh, hp, ds) or null,
// y (B, S, nh, hp) and hout (B, nh, hp, ds) float32; all contiguous.  1 <= Q <= S;
// smem as the header note gives it, within the card's opt-in limit (the wrapper
// checks); counters: at least 1 + B nh int32, zero before the first launch and left
// zero by every launch.
// Allocates nothing; returns cudaGetLastError() (0 = success).
extern "C" int ssd_scan_launch(const void* xh, const float* dt, const float* A,
                               const void* Bs, const void* Cs, const float* h0, int batch,
                               int seq, int nh, int hp, int ds, int Q, int smem, int dtype,
                               float* y, float* hout, int* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || seq < 1 || nh < 1 || hp < 1 || ds < 1 || Q < 1 || Q > seq)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long Qp = (Q + 15) / 16 * 16, hp64 = (hp + YT * 8 - 1) / (YT * 8) * (YT * 8);
  const long long ds16 = (ds + 15) / 16 * 16;
  const long long Q32 = (Q + 31) / 32 * 32;
  const long long esize = dtype == 0 ? 4 : 2;
  const long long xp =
      dtype == 0 ? pitch<float>(hp, YT * 8) : pitch<__nv_bfloat16>(hp, YT * 8);
  const long long bp = dtype == 0 ? pitch<float>(ds, 16) : pitch<__nv_bfloat16>(ds, 16);
  const long long need =
      esize * Qp * (xp + 2 * bp) + 4 * (hp64 * (ds16 + 4) + 3 * Q32);
  if (smem != need) return (int)cudaErrorInvalidValue;
  if ((long long)batch * nh * ((seq + Q - 1) / Q) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // asynchronous 16-byte copies where every row is whole 16-byte pieces on 16-byte
  // boundaries
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_x = hp * esize % 16 == 0 && aligned(xh);
  const bool vec_bc = ds * esize % 16 == 0 && aligned(Bs) && aligned(Cs);
  int status;
  if (dtype == 0)
    status = launch_typed<float>(smem, st, xh, dt, A, Bs, Cs, h0, batch, seq, nh, hp, ds, Q,
                                 vec_x, vec_bc, y, hout, counters);
  else
    status = launch_typed<__nv_bfloat16>(smem, st, xh, dt, A, Bs, Cs, h0, batch, seq, nh, hp,
                                         ds, Q, vec_x, vec_bc, y, hout, counters);
  if (status != (int)cudaSuccess) return status;
  return (int)cudaGetLastError();
}
