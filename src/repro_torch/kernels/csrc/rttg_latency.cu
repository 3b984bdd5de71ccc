// Fused RTTG -> latency geometry chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rttg_latency.py
// (_chain_kernel, launched by _rttg_latency's pallas_call).  Per client:
// the optional n_steps OU-mean Euler predictor, the attachment to the nearest
// live RSU (masked argmin, strict < over ascending r, dark RSUs at +inf),
// per-RSU load counts, 3D distance, path-loss SNR, congestion (rush wave x
// day envelope), Shannon rate / load, latency = air + propagation + queue +
// handover, and connected = (snr >= snr_min) & forced.
//
// What bounds it on this card: nothing but the launch.  At the main path's
// shapes (N = 100 clients, R = 10 RSUs) it moves under 3 KB and does about
// 5e4 flops, well under a microsecond of memory or arithmetic time.
//
// Design: the per-RSU counts are the one quantity that crosses clients.
// The TPU kernel carried them across an ordered two-phase grid in VMEM
// scratch; Hopper blocks run in no order, so the chain runs as two launches
// on one stream.  Launch 1 predicts, attaches and atomically adds each client
// into an int32 (R,) histogram (integer adds are exact in any order).
// Launch 2 recomputes the cheap elementwise predict+attach, reads the
// finished counts and writes latency, connectivity and (optionally) the RSU
// id.  One thread per client; each block stages the scalars and the R live
// flags in shared memory.  Built with --fmad=false and without fast math, so
// every multiply and add rounds as the plain PyTorch version's separate ops
// do and log10f / powf / log2f / sinf stay within ulps of it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Layout of the packed float32 scalar operand (kernels/rttg_latency.py SCALARS).
enum {
  S_T, S_MODEL_BYTES, S_RING, S_SPACING, S_THETA, S_MEAN_SPEED, S_CARRIER,
  S_EIRP, S_NOISE, S_SNR_MIN, S_BANDWIDTH, S_OVERHEAD, S_BACKHAUL, S_QUEUE,
  S_RUSH_AMP, S_RUSH_PERIOD, S_DAY_AMP, S_DAY_PERIOD, S_DAY_H2, S_COUNT
};

#define PI_F 3.14159265358979323846f
#define THREADS 256

// jnp.mod / torch.remainder: the result takes the divisor's sign.
__device__ __forceinline__ float ring_mod(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.0f && ((r < 0.0f) != (m < 0.0f))) r += m;
  return r;
}

struct Attach {
  float speed;  // predicted (or current) speed
  float d_min;  // ring distance to the attached RSU (+inf when all are dark)
  int rid;
};

__device__ __forceinline__ void stage(const float* __restrict__ scalars,
                                      const uint8_t* __restrict__ live, int n_rsu,
                                      float* s, uint8_t* s_live) {
  for (int j = threadIdx.x; j < S_COUNT; j += blockDim.x) s[j] = scalars[j];
  for (int j = threadIdx.x; j < n_rsu; j += blockDim.x) s_live[j] = live[j];
  __syncthreads();
}

__device__ __forceinline__ Attach predict_attach(const float* s, const uint8_t* s_live,
                                                 int n_rsu, float pos, float speed,
                                                 float accel, int n_steps, float dt) {
  const float ring = s[S_RING];
  if (n_steps > 0) {
    const float decay = 1.0f - s[S_THETA] * dt;
    const float v_max = 3.0f * s[S_MEAN_SPEED];
    for (int k = 0; k < n_steps; ++k) {
      accel = accel * decay;
      speed = fminf(fmaxf(speed + accel * dt, 1.0f), v_max);
      pos = ring_mod(pos + speed * dt, ring);
    }
  }
  Attach a{speed, INFINITY, 0};
  for (int r = 0; r < n_rsu; ++r) {
    float d = fabsf(pos - (float)r * s[S_SPACING]);
    d = fminf(d, ring - d);
    if (!s_live[r]) d = INFINITY;
    if (d < a.d_min) {
      a.d_min = d;
      a.rid = r;
    }
  }
  return a;
}

extern "C" __global__ void rttg_count_kernel(
    const float* __restrict__ scalars, const uint8_t* __restrict__ live, int n_rsu,
    const float* __restrict__ pos, const float* __restrict__ speed,
    const float* __restrict__ accel, int n, int n_steps, float dt,
    int* __restrict__ counts) {
  __shared__ float s[S_COUNT];
  extern __shared__ uint8_t s_live[];
  stage(scalars, live, n_rsu, s, s_live);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Attach a = predict_attach(s, s_live, n_rsu, pos[i], speed[i], accel[i], n_steps, dt);
  atomicAdd(&counts[a.rid], 1);
}

extern "C" __global__ void rttg_finish_kernel(
    const float* __restrict__ scalars, const uint8_t* __restrict__ live, int n_rsu,
    const float* __restrict__ pos, const float* __restrict__ speed,
    const float* __restrict__ accel, const uint8_t* __restrict__ forced, int n,
    int n_steps, float dt, float horizon_s, const int* __restrict__ counts,
    float* __restrict__ lat, uint8_t* __restrict__ conn, int* __restrict__ rid_out) {
  __shared__ float s[S_COUNT];
  extern __shared__ uint8_t s_live[];
  stage(scalars, live, n_rsu, s, s_live);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Attach a = predict_attach(s, s_live, n_rsu, pos[i], speed[i], accel[i], n_steps, dt);
  const float t_eff = n_steps > 0 ? s[S_T] + horizon_s : s[S_T];

  const float dist3d = sqrtf(a.d_min * a.d_min + 225.0f + 25.0f);
  const float load = (float)counts[a.rid];

  // network.latency_from_geometry, expression for expression
  const float dmax = fmaxf(dist3d, 1.0f);
  const float pl = 32.4f + 20.0f * log10f(s[S_CARRIER]) + 30.0f * log10f(dmax);
  const float snr = s[S_EIRP] - pl - s[S_NOISE];
  const float snr_lin = powf(10.0f, snr / 10.0f);
  // rttg.congestion_factor(t_eff) with its day_envelope
  const float x_day = PI_F * t_eff / fmaxf(s[S_DAY_PERIOD], 1e-3f);
  const float s1 = sinf(x_day), s2 = sinf(2.0f * x_day);
  const float env = 1.0f + s[S_DAY_AMP] * (s1 * s1 + s[S_DAY_H2] * s2 * s2);
  const float ph = sinf(PI_F * t_eff / fmaxf(s[S_RUSH_PERIOD], 1e-3f));
  const float congestion = 1.0f + s[S_RUSH_AMP] * ph * ph * env;
  const float load_eff = load * congestion;
  float rate = s[S_BANDWIDTH] / fmaxf(load_eff, 1.0f) * log2f(1.0f + snr_lin);
  rate = fmaxf(rate, 1e4f);
  const float payload_bits = 8.0f * (s[S_MODEL_BYTES] + s[S_OVERHEAD]);
  const float t_air = 2.0f * payload_bits / rate;
  const float t_prop = 2.0f * dist3d / 299792458.0f + 2.0f * s[S_BACKHAUL];
  const float t_queue = s[S_QUEUE] * load_eff;
  const float edge = dist3d / (0.5f * s[S_SPACING]);
  const float t_ho =
      0.2f * fminf(fmaxf(edge - 0.7f, 0.0f), 1.0f) * a.speed / s[S_MEAN_SPEED];
  lat[i] = t_air + t_prop + t_queue + t_ho;
  const bool ok = snr >= s[S_SNR_MIN];
  conn[i] = (ok && (forced == nullptr || forced[i] != 0)) ? 1 : 0;
  if (rid_out != nullptr) rid_out[i] = a.rid;
}

// Zero the counts, then the two launches, all on `stream`.  Allocates
// nothing; returns the CUDA error code of the sequence (0 = success).
extern "C" int rttg_latency_launch(
    const float* scalars, const uint8_t* live, int n_rsu, const float* pos,
    const float* speed, const float* accel, const uint8_t* forced, int n,
    int n_steps, float dt, float horizon_s, int* counts, float* lat,
    uint8_t* conn, int* rid_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * n_rsu, st);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t shmem = (size_t)n_rsu;
  rttg_count_kernel<<<blocks, THREADS, shmem, st>>>(scalars, live, n_rsu, pos, speed,
                                                    accel, n, n_steps, dt, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rttg_finish_kernel<<<blocks, THREADS, shmem, st>>>(
      scalars, live, n_rsu, pos, speed, accel, forced, n, n_steps, dt, horizon_s,
      counts, lat, conn, rid_out);
  return (int)cudaGetLastError();
}
