// Mamba2 SSD chunked scan for Hopper (sm_90a).  Per batch row b and head, over chunks
// of Q steps, with cs = inclusive cumsum(dt * A) inside the chunk:
//
//   y[q] = sum_{k <= q} (C_q . B_k) exp(cs_q - cs_k) dt_k x_k  +  exp(cs_q) C_q . h
//   h   <- exp(cs_last) h + sum_k exp(cs_last - cs_k) dt_k x_k (x) B_k
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (_ssd_chunk_kernel,
// launched by ssd_scan's pallas_call): the prefill's SSM scan, once per layer.
//
// What bounds it on this card: operations on the fp32 cores.  Per chunk the work needs
// the causal half of C B^T once per batch row (Q^2 ds / 2 multiply-adds) and, per head,
// the masked product with x (Q^2 hp / 2), the carried state's share and the state
// update (2 Q hp ds): at hymba-1.5b's prefill (B = 4, S = 2048, nh = 50, hp = 64,
// ds = 16, Q = 128) about 5.2 GFLOP, near 77 us at 67 TFLOP/s, against about 160 MB
// moved (x in bf16, y out in fp32; about 48 us at 3.35 TB/s).  This kernel forms
// C B^T again for every head, a small share (ds = 16 < hp = 64).
//
// Design: heads are independent (one B/C group), so one block of 256 threads per
// (b, head) walks the chunks in order and keeps its head's (hp, ds) state in shared
// memory for the whole sequence; the TPU program's (nh, hp, ds) state in one program
// does not carry over.  Per chunk it stages dt, and B, C transposed to (ds, Q), in
// shared memory as fp32; one thread forms cs in step order; the threads fill the
// (Q, Q) chunk matrix M[q, k] = (C_q . B_k) exp(cs_q - cs_k) dt_k, testing k <= q
// BEFORE the exponential (above the diagonal exp(cs_q - cs_k) overflows and inf * 0
// would be NaN); then y (threads over (q, p), x read through L1, neighbouring threads
// on neighbouring p so the reads coalesce) and last the state (threads over (n, p)).
// The last chunk's loops stop at S: the reference pads with dt = 0 steps, which leave
// cs and the state unchanged, so this is exact.  No h0 starts from zeros.  y is
// written in fp32, as the Pallas kernel's is; the model rounds it.  Shared memory is
// 4 (hp ds + 2 ds Q + Q^2 + 3 Q) bytes: 87.5 KB at hymba's head (two blocks an SM),
// 225.5 KB at mamba2's ds = 128 (the wrapper refuses a tile the card cannot hold).
// Every sum runs in a fixed order, so a run repeats itself bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const T* __restrict__ xh, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bs,
                    const T* __restrict__ Cs, const float* __restrict__ h0, int seq, int nh,
                    int hp, int ds, int Q, float* __restrict__ y, float* __restrict__ hout) {
  extern __shared__ float smem[];
  float* h = smem;              // (ds, hp): h[n * hp + p]
  float* bt = h + hp * ds;      // (ds, Q): B of the chunk, transposed
  float* ct = bt + ds * Q;      // (ds, Q): C of the chunk, transposed
  float* mq = ct + ds * Q;      // (Q, Q): M[q * Q + k]
  float* dtc = mq + Q * Q;      // (Q,)
  float* cs = dtc + Q;          // (Q,)
  float* wk = cs + Q;           // (Q,): exp(cs_last - cs_k) dt_k

  const int b = blockIdx.x / nh;
  const int head = blockIdx.x % nh;
  const int tid = threadIdx.x;
  const float a = A[head];
  const int hpds = hp * ds;
  const long long state_off = ((long long)b * nh + head) * hpds;
  for (int i = tid; i < hpds; i += THREADS) {
    const int n = i / hp, p = i - n * hp;
    h[i] = h0 != nullptr ? h0[state_off + (long long)p * ds + n] : 0.0f;
  }
  const long long x_row = (long long)nh * hp;  // elements between two steps of x / y

  for (int c0 = 0; c0 < seq; c0 += Q) {
    const int qc = min(Q, seq - c0);
    const long long step0 = (long long)b * seq + c0;
    for (int i = tid; i < qc; i += THREADS) dtc[i] = dt[(step0 + i) * nh + head];
    for (int i = tid; i < qc * ds; i += THREADS) {
      const int k = i / ds, n = i - k * ds;
      const long long g = (step0 + k) * ds + n;
      bt[n * Q + k] = to_f32(Bs[g]);
      ct[n * Q + k] = to_f32(Cs[g]);
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int k = 0; k < qc; ++k) {
        s = s + dtc[k] * a;
        cs[k] = s;
      }
    }
    __syncthreads();
    const float cs_last = cs[qc - 1];
    for (int i = tid; i < qc; i += THREADS) wk[i] = expf(cs_last - cs[i]) * dtc[i];
    for (int i = tid; i < qc * qc; i += THREADS) {
      const int q = i / qc, k = i - q * qc;
      float m = 0.0f;
      if (k <= q) {
        float g = 0.0f;
        for (int n = 0; n < ds; ++n) g = fmaf(ct[n * Q + q], bt[n * Q + k], g);
        m = g * expf(cs[q] - cs[k]) * dtc[k];
      }
      mq[q * Q + k] = m;
    }
    __syncthreads();
    const T* xc = xh + step0 * x_row + (long long)head * hp;
    float* yc = y + step0 * x_row + (long long)head * hp;
    for (int i = tid; i < qc * hp; i += THREADS) {
      const int q = i / hp, p = i - q * hp;
      float acc = 0.0f;
      for (int k = 0; k <= q; ++k) acc = fmaf(mq[q * Q + k], to_f32(xc[k * x_row + p]), acc);
      float ch = 0.0f;
      for (int n = 0; n < ds; ++n) ch = fmaf(ct[n * Q + q], h[n * hp + p], ch);
      yc[q * x_row + p] = acc + ch * expf(cs[q]);
    }
    __syncthreads();
    const float decay = expf(cs_last);
    for (int i = tid; i < hpds; i += THREADS) {
      const int n = i / hp, p = i - n * hp;
      float s = 0.0f;
      for (int k = 0; k < qc; ++k) s = fmaf(to_f32(xc[k * x_row + p]) * wk[k], bt[n * Q + k], s);
      h[i] = h[i] * decay + s;
    }
    __syncthreads();
  }
  for (int i = tid; i < hpds; i += THREADS) {
    const int n = i / hp, p = i - n * hp;
    hout[state_off + (long long)p * ds + n] = h[i];
  }
}

template <typename T>
static int launch_typed(unsigned blocks, int smem, cudaStream_t st, const void* xh,
                        const float* dt, const float* A, const void* Bs, const void* Cs,
                        const float* h0, int seq, int nh, int hp, int ds, int Q, float* y,
                        float* hout) {
  // above 48 KB a block's dynamic shared memory must be opted into
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  ssd_scan_kernel<T><<<blocks, THREADS, smem, st>>>(
      static_cast<const T*>(xh), dt, A, static_cast<const T*>(Bs), static_cast<const T*>(Cs),
      h0, seq, nh, hp, ds, Q, y, hout);
  return (int)cudaSuccess;
}

// Launch on `stream`.  xh (B, S, nh, hp), Bs / Cs (B, S, ds) of one element type
// (dtype 0 = float32, 1 = bfloat16); dt (B, S, nh), A (nh,), h0 (B, nh, hp, ds) or null,
// y (B, S, nh, hp) and hout (B, nh, hp, ds) float32; all contiguous.  1 <= Q <= S;
// smem = 4 (hp ds + 2 ds Q + Q^2 + 3 Q) bytes, within the card's opt-in limit (the
// wrapper checks).  Allocates nothing; returns cudaGetLastError() (0 = success).
extern "C" int ssd_scan_launch(const void* xh, const float* dt, const float* A,
                               const void* Bs, const void* Cs, const float* h0, int batch,
                               int seq, int nh, int hp, int ds, int Q, int smem, int dtype,
                               float* y, float* hout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || seq < 1 || nh < 1 || hp < 1 || ds < 1 || Q < 1 || Q > seq)
    return (int)cudaErrorInvalidValue;
  const long long need = 4LL * ((long long)hp * ds + 2LL * ds * Q + (long long)Q * Q + 3LL * Q);
  if (smem != need) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(batch * nh);
  int status;
  if (dtype == 0)
    status = launch_typed<float>(blocks, smem, st, xh, dt, A, Bs, Cs, h0, seq, nh, hp, ds, Q,
                                 y, hout);
  else if (dtype == 1)
    status = launch_typed<__nv_bfloat16>(blocks, smem, st, xh, dt, A, Bs, Cs, h0, seq, nh,
                                         hp, ds, Q, y, hout);
  else
    return (int)cudaErrorInvalidValue;
  if (status != (int)cudaSuccess) return status;
  return (int)cudaGetLastError();
}
