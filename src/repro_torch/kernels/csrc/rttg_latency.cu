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
// What bounds it on this card: one launch and a dependent chain, not bytes or
// operations.  At the main path's shapes (N = 100 clients, R = 10 RSUs) it
// moves under 3 KB and does about 5e4 flops, far under a microsecond of
// memory or arithmetic time.  A call costs its launch, then each client's
// predictor, n_steps = predict_horizon_s / sim_dt_s = 50 dependent Euler
// steps, then the argmin over R and the latency tail.
//
// Design: one launch a call at every N, each client's predictor run once.
// The per-RSU counts are the one quantity that crosses clients; the TPU
// kernel carried them across an ordered two-phase grid in VMEM scratch.
// - N <= ONE_BLOCK_MAX (1,024): one block, a thread per client.  Each thread
//   predicts and attaches its client and keeps (rid, d_min, speed) in
//   registers; the block counts into a shared-memory histogram (one shared
//   add per distinct RSU of a warp, found with __match_any_sync),
//   __syncthreads(), and every thread finishes its client from the counts.
//   No global scratch.
// - Above: a cooperative launch of GRID_THREADS-thread blocks, no more than
//   the card holds resident, thread g taking clients g, g + grid threads, ...
//   Each block counts into shared memory as above, adds its nonzero counts
//   into a global (R,) array (one add per block and RSU, not per client),
//   and waits at a grid barrier (an arrival count); then it reads the
//   finished counts.  The last block to read them zeroes them and the two
//   barrier counts, so the next call finds them at zero (the wrapper zeroes
//   the buffer once per device).  A thread's first client stays in registers
//   across the barrier; a thread with more (above ~135,000 clients at R = 10)
//   keeps the others' attachments in a global spill.
//   Integer adds are exact in any order: a call repeats itself bit for bit.
// - The predictor's wrap: for x in [0, 2 ring), fmodf(x, ring) is x, or
//   x - ring above ring (exact by Sterbenz's lemma), and the kernel takes
//   that compare and select instead of fmodf, a software loop without fast
//   math; any other x takes fmodf, so the result is torch.remainder's bit
//   for bit.  After the first step pos lies in [0, ring], and where
//   3 mean_speed dt <= ring / 2 (4.2 m against 5 km on the main path's
//   ring) every later step lands in (0, 1.5 ring]: the 49 steps after the
//   first run with no range test and no branch.
// - Shared memory: the 17 scalars, then R int32 counts and R live flags, 5R
//   bytes dynamic: 160 KB at the largest R = 32,768, opted into above 48 KB,
//   one block an SM there.
// Built with --fmad=false and without fast math, so every multiply and add
// rounds as the plain PyTorch version's separate ops do and log10f / powf /
// log2f / sinf stay within ulps of it.
//
// B1g, rttg_latency_grid_kernel and rttg_latency_grid_tiles_kernel (one body,
// grid_lanes, compiled twice): G lanes of the batched grid round in one
// launch, each lane's own scenario row, kinematics row, t and forced row; up
// to GRID_LANE_MAX (4,096, the dense neighbour search's limit,
// core/messages.py DENSE_MAX_N) clients a lane.  What bounds it is ALU issue
// and latency: a predicted client is ~505 dependent operations (fmad-free),
// 24 lanes of 4,096 clients ~5e7, ~1.7 us of issue on 132 SMs; one block a
// lane keeps G SMs busy and runs up to four clients a thread in turn.  So
// kernels/rttg_latency.py::grid_plan cuts a wide lane's clients into T
// tiles, one block each, so that the T G blocks cover the card's SMs, one
// client a thread where residency allows.  Thread tid of a block takes its
// clients tid, tid + blockDim.x, ... (at most GRID_PER_THREAD = 4), their
// attachments in a fixed-size register array.  A block loads its first
// client's kinematics, t and model_bytes beside its scenario row, then
// counts its clients into a shared-memory histogram as B1 does
// (__match_any_sync, one add per distinct RSU of a warp).
// - T = 1, rttg_latency_grid_kernel, dim3(G) blocks (blockIdx.x the lane):
//   lanes of fewer than 768 clients (where one block a lane measured faster
//   than the spread), of more than POLL_RSU_MAX RSUs, G >= SMs, or too few
//   resident blocks for two tiles a lane.  The block's histogram is the
//   lane's; one __syncthreads(), then each thread finishes its clients as B1
//   does.  No counters, no barrier.
// - T > 1, rttg_latency_grid_tiles_kernel, a cooperative launch of dim3(T,
//   G) blocks (every block resident; blockIdx.x the tile, blockIdx.y the
//   lane), tile b holding clients [b N / T, (b + 1) N / T): each block adds
//   its nonzero counts into lane g's R totals, in a (G, R + 1) int32 region
//   (the R totals, then a departure count).  A tiled lane has at most
//   POLL_RSU_MAX (32) RSUs, and the totals are their own flag: they sum to N
//   once every tile's adds have landed and not before (every add is
//   positive), so warp 0 polls them (one relaxed load a lane) until they do
//   and keeps that read; no fence and no arrival count, one L2 round trip
//   after the last add.  Meanwhile one
//   thread computes the lane's terms of the latency (LaneConst: path loss
//   offset, congestion, payload, backhaul) once for the block.  Each block
//   then takes a departure ticket, whose latency hides behind its finish;
//   the lane's last block to depart zeroes the lane's totals and its count,
//   so every call leaves the region at zero (the wrapper zeroes it once per
//   device).
// Integer counts are exact in any order, each client runs the same
// predict_attach and finish_lane (B1's finish, its lane terms computed once a
// block by the same operations), so a lane is bitwise B1 on that lane at every
// (G, N, T) (B1's cooperative launch above 1,024 clients included), RSU ids
// too.  The scenario operand is (G, row_bytes): the S_COUNT float32
// scalars, the R live flags, padding to 4 bytes.  With a rid_out pointer
// each client's attachment id lands beside its latency (the two-tier lanes'
// realized pass), as B1's does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grants.cuh"

// Layout of the scenario operand (kernels/rttg_latency.py SCENARIO_SCALARS):
// S_COUNT float32 scalars, then the R uint8 live flags.
enum {
  S_RING, S_SPACING, S_THETA, S_MEAN_SPEED, S_CARRIER, S_EIRP, S_NOISE, S_SNR_MIN,
  S_BANDWIDTH, S_OVERHEAD, S_BACKHAUL, S_QUEUE, S_RUSH_AMP, S_RUSH_PERIOD, S_DAY_AMP,
  S_DAY_PERIOD, S_DAY_H2, S_COUNT
};

#define PI_F 3.14159265358979323846f
#define ONE_BLOCK_MAX 1024  // up to this many clients: one block, a thread each
#define GRID_THREADS 256    // block size of the cooperative launch above it
#define GRID_PER_THREAD 4   // B1g: clients a thread at most
#define GRID_LANE_MAX (GRID_PER_THREAD * ONE_BLOCK_MAX)  // B1g: clients a lane, DENSE_MAX_N
#define GRID_TILE_THREADS 256  // B1g: the block size that its resident count is taken at
#define POLL_RSU_MAX 32        // B1g: the most RSUs of a tiled lane (one warp polls them)
#define FULL_MASK 0xffffffffu

// jnp.mod / torch.remainder: the result takes the divisor's sign.
__device__ __forceinline__ float ring_mod(float x, float m) {
  if (x >= 0.0f && x < 2.0f * m) return x >= m ? x - m : x;
  float r = fmodf(x, m);
  if (r != 0.0f && ((r < 0.0f) != (m < 0.0f))) r += m;
  return r;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

struct Attach {
  float speed;  // predicted (or current) speed
  float d_min;  // ring distance to the attached RSU (+inf when all are dark)
  int rid;
};

// One OU-mean Euler step of accel and speed; returns pos + speed dt, unwrapped.
__device__ __forceinline__ float euler(float& accel, float& speed, float pos, float decay,
                                       float dt, float v_max) {
  accel = accel * decay;
  speed = fminf(fmaxf(speed + accel * dt, 1.0f), v_max);
  return pos + speed * dt;
}

__device__ __forceinline__ Attach predict_attach(const float* s, const uint8_t* s_live,
                                                 int n_rsu, float pos, float speed,
                                                 float accel, int n_steps, float dt) {
  const float ring = s[S_RING];
  if (n_steps > 0) {
    const float decay = 1.0f - s[S_THETA] * dt;
    const float v_max = 3.0f * s[S_MEAN_SPEED];
    pos = ring_mod(euler(accel, speed, pos, decay, dt, v_max), ring);
    // Now pos lies in [0, ring] (a remainder may round up to ring).  With
    // dt > 0, 1 <= speed <= v_max and v_max dt <= ring / 2, every later
    // pos + speed dt lies in (0, 1.5 ring]: its wrap needs no range test.
    if (dt > 0.0f && v_max >= 1.0f && v_max * dt <= 0.5f * ring) {
      for (int k = 1; k < n_steps; ++k) {
        const float x = euler(accel, speed, pos, decay, dt, v_max);
        pos = x >= ring ? x - ring : x;
      }
    } else {
      for (int k = 1; k < n_steps; ++k)
        pos = ring_mod(euler(accel, speed, pos, decay, dt, v_max), ring);
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

// The terms of network.latency_from_geometry that depend only on the lane
// (its scenario, t_eff and model_bytes).
struct LaneConst {
  float pl0;            // 32.4 + 20 log10(carrier)
  float congestion;     // rttg.congestion_factor(t_eff)
  float air_num;        // 2 payload_bits
  float prop_backhaul;  // 2 backhaul
  float half_spacing;   // 0.5 spacing
};

__device__ __forceinline__ LaneConst lane_const(const float* s, float t_eff, float model_bytes) {
  LaneConst k;
  k.pl0 = 32.4f + 20.0f * log10f(s[S_CARRIER]);
  // rttg.congestion_factor(t_eff) with its day_envelope
  const float x_day = PI_F * t_eff / fmaxf(s[S_DAY_PERIOD], 1e-3f);
  const float s1 = sinf(x_day), s2 = sinf(2.0f * x_day);
  const float env = 1.0f + s[S_DAY_AMP] * (s1 * s1 + s[S_DAY_H2] * s2 * s2);
  const float ph = sinf(PI_F * t_eff / fmaxf(s[S_RUSH_PERIOD], 1e-3f));
  k.congestion = 1.0f + s[S_RUSH_AMP] * ph * ph * env;
  const float payload_bits = 8.0f * (model_bytes + s[S_OVERHEAD]);
  k.air_num = 2.0f * payload_bits;
  k.prop_backhaul = 2.0f * s[S_BACKHAUL];
  k.half_spacing = 0.5f * s[S_SPACING];
  return k;
}

// network.latency_from_geometry and the connectivity test for one client,
// the lane's terms from lane_const.  Each sum and product rounds as it would
// written out in one expression: 32.4 + 20 log10(c) + 30 log10(d) adds left
// to right, 2 payload_bits / rate multiplies first.
__device__ __forceinline__ void finish_lane(const float* s, const LaneConst& k, Attach a,
                                            float load, int i,
                                            const uint8_t* __restrict__ forced,
                                            float* __restrict__ lat, uint8_t* __restrict__ conn,
                                            int* __restrict__ rid_out) {
  const float dist3d = sqrtf(a.d_min * a.d_min + 225.0f + 25.0f);
  const float dmax = fmaxf(dist3d, 1.0f);
  const float pl = k.pl0 + 30.0f * log10f(dmax);
  const float snr = s[S_EIRP] - pl - s[S_NOISE];
  const float snr_lin = powf(10.0f, snr / 10.0f);
  const float load_eff = load * k.congestion;
  float rate = s[S_BANDWIDTH] / fmaxf(load_eff, 1.0f) * log2f(1.0f + snr_lin);
  rate = fmaxf(rate, 1e4f);
  const float t_air = k.air_num / rate;
  const float t_prop = 2.0f * dist3d / 299792458.0f + k.prop_backhaul;
  const float t_queue = s[S_QUEUE] * load_eff;
  const float edge = dist3d / k.half_spacing;
  const float t_ho =
      0.2f * fminf(fmaxf(edge - 0.7f, 0.0f), 1.0f) * a.speed / s[S_MEAN_SPEED];
  lat[i] = t_air + t_prop + t_queue + t_ho;
  const bool ok = snr >= s[S_SNR_MIN];
  conn[i] = (ok && (forced == nullptr || forced[i] != 0)) ? 1 : 0;
  if (rid_out != nullptr) rid_out[i] = a.rid;
}

// One client's latency and connectivity, its lane's terms computed beside it
// (inlined into one block of code, so the two chains interleave).
__device__ __forceinline__ void finish(const float* s, Attach a, float load, float t_eff,
                                       float model_bytes, int i,
                                       const uint8_t* __restrict__ forced,
                                       float* __restrict__ lat, uint8_t* __restrict__ conn,
                                       int* __restrict__ rid_out) {
  finish_lane(s, lane_const(s, t_eff, model_bytes), a, load, i, forced, lat, conn, rid_out);
}

// counts: (R + 2,) int32, zero on entry (the R totals, then the arrival and
// departure counts of the grid barrier); read only when gridDim.x > 1.
// spill: (3 N,) int32 (rid, d_min bits, speed bits), touched only by threads
// with more than one client.
extern "C" __global__ void __launch_bounds__(ONE_BLOCK_MAX) rttg_latency_kernel(
    const uint8_t* __restrict__ scenario, int n_rsu, const float* __restrict__ t,
    const float* __restrict__ model_bytes, const float* __restrict__ pos,
    const float* __restrict__ speed, const float* __restrict__ accel,
    const uint8_t* __restrict__ forced, int n, int n_steps, float dt, float horizon_s,
    int* __restrict__ counts, int* __restrict__ spill, float* __restrict__ lat,
    uint8_t* __restrict__ conn, int* __restrict__ rid_out) {
  __shared__ float s[S_COUNT];
  __shared__ int s_last;
  extern __shared__ int s_dyn[];
  int* hist = s_dyn;                                            // (R,) counts
  uint8_t* s_live = reinterpret_cast<uint8_t*>(s_dyn + n_rsu);  // (R,) live flags
  const int tid = threadIdx.x;
  const float* scalars = reinterpret_cast<const float*>(scenario);
  for (int j = tid; j < S_COUNT; j += blockDim.x) s[j] = scalars[j];
  for (int r = tid; r < n_rsu; r += blockDim.x) {
    s_live[r] = scenario[S_COUNT * sizeof(float) + r];
    hist[r] = 0;
  }
  __syncthreads();

  // Predict and attach each client once; count it into the block's histogram.
  const int lane = tid & 31;
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + tid;
  Attach first{0.0f, 0.0f, 0};
  for (int c = 0; i0 - lane + c * stride < n; ++c) {  // a warp-uniform trip count
    const int i = i0 + c * stride;
    const unsigned active = __ballot_sync(FULL_MASK, i < n);
    if (i < n) {
      const Attach a =
          predict_attach(s, s_live, n_rsu, pos[i], speed[i], accel[i], n_steps, dt);
      const unsigned peers = __match_any_sync(active, a.rid);
      if (lane == __ffs(peers) - 1) atomicAdd(hist + a.rid, __popc(peers));
      if (c == 0) {
        first = a;
      } else {
        spill[i] = a.rid;
        spill[n + i] = __float_as_int(a.d_min);
        spill[2 * n + i] = __float_as_int(a.speed);
      }
    }
  }
  __syncthreads();

  if (gridDim.x > 1) {
    // every block's counts into the totals, then a grid barrier
    int* arrived = counts + n_rsu;
    int* departed = arrived + 1;
    for (int r = tid; r < n_rsu; r += blockDim.x) {
      const int h = hist[r];
      if (h != 0) atomicAdd(counts + r, h);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      atomicAdd(arrived, 1);
      while (load_acquire(arrived) < (int)gridDim.x) {
      }
      __threadfence();
    }
    __syncthreads();
    for (int r = tid; r < n_rsu; r += blockDim.x) hist[r] = __ldcg(counts + r);
    __syncthreads();
    // the last block to read the totals leaves them and the barrier at zero
    if (tid == 0) s_last = atomicAdd(departed, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (s_last) {
      for (int r = tid; r < n_rsu; r += blockDim.x) counts[r] = 0;
      if (tid == 0) {
        *arrived = 0;
        *departed = 0;
      }
    }
  }

  const float t_now = *t;
  const float t_eff = n_steps > 0 ? t_now + horizon_s : t_now;
  const float mb = *model_bytes;
  for (int c = 0, i = i0; i < n; ++c, i += stride) {
    Attach a = first;
    if (c > 0) a = Attach{__int_as_float(spill[2 * n + i]), __int_as_float(spill[n + i]), spill[i]};
    finish(s, a, (float)hist[a.rid], t_eff, mb, i, forced, lat, conn, rid_out);
  }
}

// B1g's body: TILED, T = gridDim.x tiles a lane (blockIdx.y the lane, R <=
// POLL_RSU_MAX); otherwise one block a lane (blockIdx.x the lane).
// scenario: (G, row_bytes) lane rows; t: (G,); pos / speed / accel / forced
// / lat / conn / rid_out: (G, n), lane-major; counts: (G, R + 1) int32, zero
// on entry, read only when TILED.
template <bool TILED>
__device__ __forceinline__ void grid_lanes(
    const uint8_t* __restrict__ scenario, int row_bytes, int n_rsu, const float* __restrict__ t,
    const float* __restrict__ model_bytes, const float* __restrict__ pos,
    const float* __restrict__ speed, const float* __restrict__ accel,
    const uint8_t* __restrict__ forced, int n, int n_steps, float dt, float horizon_s,
    int* __restrict__ counts, float* __restrict__ lat, uint8_t* __restrict__ conn,
    int* __restrict__ rid_out) {
  __shared__ float s[S_COUNT];
  __shared__ LaneConst s_k;
  __shared__ int s_last;
  extern __shared__ int s_dyn[];
  int* hist = s_dyn;                                            // (R,) counts
  uint8_t* s_live = reinterpret_cast<uint8_t*>(s_dyn + n_rsu);  // (R,) live flags
  const int tid = threadIdx.x;
  const int g = TILED ? (int)blockIdx.y : (int)blockIdx.x;
  const int tiles = TILED ? (int)gridDim.x : 1;
  // This block's tile of lane g, clients [lo, hi); tiles <= n <= 4,096, so
  // blockIdx.x * n stays in an int.  Thread tid takes lo + tid + c * blockDim.x.
  int lo = 0, hi = n;
  if (TILED) {
    lo = (int)blockIdx.x * n / tiles;
    hi = ((int)blockIdx.x + 1) * n / tiles;
  }
  const int base = g * n;  // the launch keeps G * n below 2^31
  // The first client's kinematics, t and model_bytes are loaded beside the
  // scenario row, so that their latencies overlap.
  const int i0 = base + lo + tid;
  const bool has0 = lo + tid < hi;
  const float pos0 = has0 ? pos[i0] : 0.0f, speed0 = has0 ? speed[i0] : 0.0f,
              accel0 = has0 ? accel[i0] : 0.0f;
  const float t_now = t[g];
  const float mb = *model_bytes;
  const uint8_t* row = scenario + (long long)g * row_bytes;
  const float* scalars = reinterpret_cast<const float*>(row);
  for (int j = tid; j < S_COUNT; j += blockDim.x) s[j] = scalars[j];
  for (int r = tid; r < n_rsu; r += blockDim.x) {
    s_live[r] = row[S_COUNT * sizeof(float) + r];
    hist[r] = 0;
  }
  __syncthreads();

  // Predict and attach this thread's clients and count each into the tile's
  // histogram; the loop unrolls, so the attachments stay in registers.
  const int lane = tid & 31;
  Attach a[GRID_PER_THREAD];
#pragma unroll
  for (int c = 0; c < GRID_PER_THREAD; ++c) {
    const int j = lo + tid + c * (int)blockDim.x;
    a[c] = Attach{0.0f, 0.0f, 0};
    if (j - lane < hi) {  // warp-uniform: some client of this warp is live
      const unsigned active = __ballot_sync(FULL_MASK, j < hi);
      if (j < hi) {
        const int i = base + j;
        a[c] = c == 0 ? predict_attach(s, s_live, n_rsu, pos0, speed0, accel0, n_steps, dt)
                      : predict_attach(s, s_live, n_rsu, pos[i], speed[i], accel[i], n_steps,
                                       dt);
        const unsigned peers = __match_any_sync(active, a[c].rid);
        if (lane == __ffs(peers) - 1) atomicAdd(hist + a[c].rid, __popc(peers));
      }
    }
  }
  __syncthreads();

  const float t_eff = n_steps > 0 ? t_now + horizon_s : t_now;
  LaneConst k = {};
  int ticket = 0;
  if (TILED) {
    // The tile's counts into lane g's totals.  They sum to n once every
    // tile's adds have landed, and not before (every add is positive), so
    // warp 0 polls them and keeps the last read: no fence, no arrival count.
    // Thread kt (warp 1's first, or the only warp's) computes the lane's
    // constants meanwhile.
    int* totals = counts + (long long)g * (n_rsu + 1);
    const int kt = blockDim.x > 32 ? 32 : 0;
    for (int r = tid; r < n_rsu; r += blockDim.x) {
      const int h = hist[r];
      if (h != 0) atomicAdd(totals + r, h);
    }
    if (tid == kt) s_k = lane_const(s, t_eff, mb);
    if (tid < 32) {
      int v = 0;
      do {
        v = tid < n_rsu ? load_relaxed(totals + tid) : 0;
      } while (__reduce_add_sync(FULL_MASK, v) < n);
      if (tid < n_rsu) hist[tid] = v;
    }
    __syncthreads();
    k = s_k;
    // the departure ticket's latency hides behind the finish
    if (tid == 0) ticket = atomicAdd(totals + n_rsu, 1);
  }

  // One block a lane finishes as B1 does, its lane terms interleaved with each
  // client's; a tile takes them from s_k.
#pragma unroll
  for (int c = 0; c < GRID_PER_THREAD; ++c) {
    const int j = lo + tid + c * (int)blockDim.x;
    if (j < hi) {
      const float load = (float)hist[a[c].rid];
      if (!TILED)
        finish(s, a[c], load, t_eff, mb, base + j, forced, lat, conn, rid_out);
      else
        finish_lane(s, k, a[c], load, base + j, forced, lat, conn, rid_out);
    }
  }

  if (TILED) {
    // the last of the lane's blocks to depart leaves its totals and count at zero
    if (tid == 0) s_last = ticket == tiles - 1;
    __syncthreads();
    if (s_last) {
      int* totals = counts + (long long)g * (n_rsu + 1);
      for (int r = tid; r <= n_rsu; r += blockDim.x) totals[r] = 0;
    }
  }
}

// B1g's two kernels, each with its own registers: one block a lane (T = 1),
// and T tiles a lane (a cooperative launch).  At least one block an SM: under
// __launch_bounds__(1024) alone ptxas aims at two and spills a thread's
// attachments at 32 registers; with one it spills none.
extern "C" __global__ void __launch_bounds__(ONE_BLOCK_MAX, 1) rttg_latency_grid_kernel(
    const uint8_t* __restrict__ scenario, int row_bytes, int n_rsu, const float* __restrict__ t,
    const float* __restrict__ model_bytes, const float* __restrict__ pos,
    const float* __restrict__ speed, const float* __restrict__ accel,
    const uint8_t* __restrict__ forced, int n, int n_steps, float dt, float horizon_s,
    int* __restrict__ counts, float* __restrict__ lat, uint8_t* __restrict__ conn,
    int* __restrict__ rid_out) {
  grid_lanes<false>(scenario, row_bytes, n_rsu, t, model_bytes, pos, speed, accel, forced, n,
                    n_steps, dt, horizon_s, counts, lat, conn, rid_out);
}

extern "C" __global__ void __launch_bounds__(ONE_BLOCK_MAX, 1) rttg_latency_grid_tiles_kernel(
    const uint8_t* __restrict__ scenario, int row_bytes, int n_rsu, const float* __restrict__ t,
    const float* __restrict__ model_bytes, const float* __restrict__ pos,
    const float* __restrict__ speed, const float* __restrict__ accel,
    const uint8_t* __restrict__ forced, int n, int n_steps, float dt, float horizon_s,
    int* __restrict__ counts, float* __restrict__ lat, uint8_t* __restrict__ conn,
    int* __restrict__ rid_out) {
  grid_lanes<true>(scenario, row_bytes, n_rsu, t, model_bytes, pos, speed, accel, forced, n,
                   n_steps, dt, horizon_s, counts, lat, conn, rid_out);
}

static int shared_bytes(int n_rsu) { return n_rsu * (int)(sizeof(int) + sizeof(uint8_t)); }

// Above 48 KB a block's dynamic shared memory must be opted into, per kernel
// and per device (grants.cuh).
static cudaError_t grant(int smem) {
  static Grants granted;
  return grant_on_device((const void*)rttg_latency_kernel, granted, smem);
}

// Blocks of the launch plan for n clients on the current device: 1 up to
// ONE_BLOCK_MAX clients; above, as many GRID_THREADS-thread blocks as the
// clients need and the card holds resident.  Minus the CUDA error on failure.
extern "C" int rttg_latency_blocks(int n, int n_rsu) {
  if (n <= ONE_BLOCK_MAX) return 1;
  const int smem = shared_bytes(n_rsu);
  cudaError_t err = grant(smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rttg_latency_kernel,
                                                        GRID_THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  const long long need = ((long long)n + GRID_THREADS - 1) / GRID_THREADS;
  const long long resident = (long long)per_sm * sms;
  return (int)(need < resident ? need : resident);
}

// One launch on `stream` with `blocks` from rttg_latency_blocks.  t and
// model_bytes are device scalars.  counts (R + 2 int32, zero) is needed when
// blocks > 1, spill (3 N int32) when blocks * GRID_THREADS < n.  Allocates
// nothing; returns the launch's CUDA error code (0 = success).
extern "C" int rttg_latency_launch(
    const uint8_t* scenario, int n_rsu, const float* t, const float* model_bytes,
    const float* pos, const float* speed, const float* accel, const uint8_t* forced, int n,
    int n_steps, float dt, float horizon_s, int blocks, int* counts, int* spill, float* lat,
    uint8_t* conn, int* rid_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = shared_bytes(n_rsu);
  cudaError_t err = grant(smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks == 1) {
    if (n > ONE_BLOCK_MAX) return (int)cudaErrorInvalidValue;
    const int threads = (n + 31) / 32 * 32;
    rttg_latency_kernel<<<1, threads, smem, st>>>(scenario, n_rsu, t, model_bytes, pos,
                                                  speed, accel, forced, n, n_steps, dt,
                                                  horizon_s, counts, spill, lat, conn,
                                                  rid_out);
    return (int)cudaGetLastError();
  }
  if (blocks < 1 || counts == nullptr ||
      ((long long)blocks * GRID_THREADS < n && spill == nullptr))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&scenario, &n_rsu, &t,     &model_bytes, &pos,   &speed,
                  &accel,    &forced, &n,    &n_steps,     &dt,    &horizon_s,
                  &counts,   &spill,  &lat,  &conn,        &rid_out};
  return (int)cudaLaunchCooperativeKernel((const void*)rttg_latency_kernel, dim3(blocks),
                                          dim3(GRID_THREADS), args, (size_t)smem, st);
}

static cudaError_t grant_grid(int smem) {
  static Grants granted, granted_tiles;
  const cudaError_t err =
      grant_on_device((const void*)rttg_latency_grid_kernel, granted, smem);
  if (err != cudaSuccess) return err;
  return grant_on_device((const void*)rttg_latency_grid_tiles_kernel, granted_tiles, smem);
}

// B1g's launch plan inputs on the current device: its SM count and the
// GRID_TILE_THREADS-thread blocks of the tiled kernel an SM holds resident at
// R = n_rsu (every smaller block holds at least as many).  The wrapper keeps
// the answer per device and R.  Returns the CUDA error code.
extern "C" int rttg_latency_grid_resident(int n_rsu, int* sms, int* per_sm) {
  if (n_rsu < 1 || sms == nullptr || per_sm == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(n_rsu);
  cudaError_t err = grant_grid(smem);
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, rttg_latency_grid_tiles_kernel,
                                                        GRID_TILE_THREADS, smem);
  return (int)err;
}

// B1g: one launch on `stream` for lanes of n <= GRID_LANE_MAX clients, in
// `tiles` blocks a lane of `threads` threads (the plan of
// kernels/rttg_latency.py::grid_plan).  scenario is (lanes, row_bytes) with
// row_bytes a multiple of 4 holding S_COUNT floats and n_rsu flags; t is
// (lanes,) on the device; counts ((lanes, n_rsu + 1) int32, zero) is needed
// when tiles > 1, which launches cooperatively; rid_out (lanes, n) int32 may
// be null (no ids).  A plan whose tiles do not cover the lane at
// GRID_PER_THREAD clients a thread, that tiles a lane of more than
// POLL_RSU_MAX RSUs, or whose blocks the card does not hold resident is
// refused with cudaErrorInvalidValue.  Allocates nothing; returns the
// launch's CUDA error code.
extern "C" int rttg_latency_grid_launch(
    const uint8_t* scenario, int row_bytes, int n_rsu, int lanes, const float* t,
    const float* model_bytes, const float* pos, const float* speed, const float* accel,
    const uint8_t* forced, int n, int n_steps, float dt, float horizon_s, int tiles,
    int threads, int* counts, float* lat, uint8_t* conn, int* rid_out, void* stream) {
  if (lanes < 1 || n < 1 || n > GRID_LANE_MAX || n_rsu < 1 || row_bytes % 4 != 0 ||
      row_bytes < S_COUNT * (int)sizeof(float) + n_rsu || (long long)lanes * n > 0x7fffffffLL ||
      tiles < 1 || tiles > n || threads < 32 || threads > ONE_BLOCK_MAX || threads % 32 != 0 ||
      (long long)threads * GRID_PER_THREAD < (n + tiles - 1) / tiles ||
      (tiles > 1 && (counts == nullptr || n_rsu > POLL_RSU_MAX)))
    return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(n_rsu);
  cudaError_t err = grant_grid(smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiles == 1) {
    rttg_latency_grid_kernel<<<lanes, threads, smem, st>>>(
        scenario, row_bytes, n_rsu, t, model_bytes, pos, speed, accel, forced, n, n_steps, dt,
        horizon_s, counts, lat, conn, rid_out);
    return (int)cudaGetLastError();
  }
  void* args[] = {&scenario, &row_bytes, &n_rsu,  &t,         &model_bytes, &pos,
                  &speed,    &accel,     &forced, &n,         &n_steps,     &dt,
                  &horizon_s, &counts,   &lat,    &conn,      &rid_out};
  err = cudaLaunchCooperativeKernel((const void*)rttg_latency_grid_tiles_kernel,
                                    dim3(tiles, lanes), dim3(threads), args, (size_t)smem, st);
  if (err == cudaErrorCooperativeLaunchTooLarge) {
    (void)cudaGetLastError();  // not sticky: leave no stale error for the next launch
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
