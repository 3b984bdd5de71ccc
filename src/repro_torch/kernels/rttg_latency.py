"""Fused RTTG -> latency geometry chain: CUDA kernel and its plain version.

Port of ``repro/kernels/rttg_latency.py`` (Pallas ``_chain_kernel``).  Per
client: [predict n Euler steps] -> attach to the nearest live RSU -> per-RSU
load -> SNR / latency -> connectivity (and optionally the RSU id).

``rttg_latency`` dispatches on the tensors' device: CUDA tensors launch the
hand-written kernel (``csrc/rttg_latency.cu``, one launch a call), CPU
tensors run ``rttg_latency_plain``, the composition of the core pure forms
chained as ``repro/kernels/ref.py::rttg_latency`` chains them.  There is no
fallback from one to the other.  The PRNG stays outside: the
connection-rate Bernoulli mask comes in as ``forced``.

``rttg_latency_grid`` is the batched grid round's form (B1g, the reference
kernel under the engine's ``vmap``): G lanes of up to ``GRID_MAX_N``
(4,096) clients, each with its own scenario, kinematics, time and forced
mask, in one launch.  ``grid_plan`` keeps one block a lane for lanes under
``GRID_SPREAD_MIN`` clients or of more than ``GRID_POLL_RSU_MAX`` RSUs, and
otherwise cuts each lane's clients into T tiles, one block each, so that the
T x G blocks cover the card's SMs (one client a thread where residency
allows, at most four); with T > 1 the launch is cooperative and a lane's
blocks meet on its per-lane RSU totals.  Each lane is bitwise
``rttg_latency`` on that lane, the RSU ids too when asked for; its plain
version is ``rttg_latency_grid_plain``.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from repro_torch.core.network import (
    connected_from_snr,
    latency_from_geometry,
    snr_from_dist,
)
from repro_torch.core.rttg import n_rsu_of, rsu_geometry, rsu_up_mask
from repro_torch.core.trajectory import horizon_steps, predict_kinematics
from repro_torch.kernels import count_launch, indexed, on_card, refuse_grad

# The float32 scalars of the scenario operand, in the order of the .cu
# source's S_* enum; the R uint8 live flags follow them.
SCENARIO_SCALARS = (
    "ring_length_m", "rsu_spacing_m", "ou_theta", "mean_speed_mps", "carrier_ghz",
    "eirp_dbm", "noise_dbm", "snr_min_db", "bandwidth_hz", "overhead_bytes", "backhaul_s",
    "queue_s_per_vehicle", "rush_amp", "rush_period_s", "day_amp", "day_period_s",
    "day_harmonic2",
)
GRID_THREADS = 256  # block size of the kernel's cooperative launch (N > 1,024)
MAX_RSU = 32768
# Clients a lane of rttg_latency_grid (the .cu source's GRID_LANE_MAX: one
# block of 1,024 threads, up to four clients a thread).  It is
# core.messages.DENSE_MAX_N, the largest fleet the dense neighbour search and
# fusion take, so the batched grid round (fl.rounds.grid_round_fits) serves
# every N that search does.
GRID_MAX_N = 4096
GRID_PER_THREAD = 4  # clients a thread of rttg_latency_grid at most
# The largest block of a multi-tile B1g plan; the resident count that bounds
# the plan is taken at it (a smaller block is resident at least as often).
GRID_TILE_THREADS = 256
GRID_POLL_RSU_MAX = 32  # the most RSUs of a tiled lane (the .cu source's POLL_RSU_MAX)
# The fewest clients a lane that grid_plan spreads over tiles: below, one
# block a lane measured faster on an H100 than the spread, predicted and
# realized passes together (chip_smoke.py's b1g_plan_crossover), the
# barrier's round trip costing more than the SMs it adds save.
GRID_SPREAD_MIN = 768

# Kernel launches made by ``rttg_latency`` (one per call on CUDA tensors).
launches = 0
# Kernel launches made by ``rttg_latency_grid`` (one per call on CUDA tensors).
grid_launches = 0

# Per-device caches, keyed on indexed devices (``kernels.indexed``).
_OPERANDS = {}  # (id(cfg), device, grid) -> (weakref to cfg, scenario operand)
_BLOCKS = {}  # (device, N, R) -> blocks of the kernel's launch plan
_RESIDENT = {}  # (device, R) -> (SMs, resident GRID_TILE_THREADS-thread B1g blocks an SM)


def rttg_latency_plain(pos, speed, accel, t, model_bytes, forced, cfg, predict,
                       want_rid=False):
    """(N,) kinematics -> (latency f32, connected bool[, rid int32]).

    The unfused composition: predict_kinematics -> rsu_geometry ->
    latency_from_geometry / connected_from_snr.
    """
    t = torch.as_tensor(t, dtype=torch.float32, device=pos.device)
    if predict:
        n = horizon_steps(cfg.predict_horizon_s, cfg)
        pos, speed, accel = predict_kinematics(pos, speed, accel, n, cfg)
        t = t + cfg.predict_horizon_s
    rid, dist3d, load = rsu_geometry(pos, cfg)
    lat = latency_from_geometry(t, speed, dist3d, load, model_bytes, cfg)
    conn = connected_from_snr(snr_from_dist(dist3d, cfg), cfg, forced)
    if want_rid:
        return lat, conn, rid.to(torch.int32)
    return lat, conn


def scenario_operand(cfg, device) -> torch.Tensor:
    """``cfg``'s fixed kernel operand on ``device``, as uint8: the float32
    bytes of ``SCENARIO_SCALARS``, then ``rsu_up_mask(cfg)`` as 0 / 1.

    Built once per ``ScenarioParams`` object and device (plain torch, no
    host sync) and kept while the object lives.
    """
    return _operand(cfg, device, grid=False)


def grid_operand(cfg, device) -> torch.Tensor:
    """A lane view's kernel operand on ``device``: ``(G, row_bytes)`` uint8,
    each row one lane's ``scenario_operand`` zero-padded to a multiple of 4
    bytes.  Built once per lane-view object and device and kept while the
    object lives: once per ``run_grid``."""
    return _operand(cfg, device, grid=True)


def _operand(cfg, device, grid: bool) -> torch.Tensor:
    device = indexed(device)
    key = (id(cfg), device, grid)
    hit = _OPERANDS.get(key)
    if hit is not None and hit[0]() is cfg:
        return hit[1]
    scalars = torch.stack([torch.as_tensor(getattr(cfg, name), dtype=torch.float32,
                                           device=device).reshape(-1)
                           for name in SCENARIO_SCALARS], dim=-1)  # (G, S); one lane (1, S)
    lanes = scalars.shape[0]
    live = rsu_up_mask(cfg).to(device=device, dtype=torch.uint8).reshape(lanes, -1)
    pad = -(scalars.shape[1] * 4 + live.shape[1]) % 4 if grid else 0
    operand = torch.cat([scalars.view(torch.uint8), live, live.new_zeros((lanes, pad))], dim=1)
    operand = operand if grid else operand[0]
    _OPERANDS[key] = (weakref.ref(cfg, lambda _, key=key: _OPERANDS.pop(key, None)), operand)
    return operand


def launch_blocks(lib, device, n: int, n_rsu: int) -> int:
    """Blocks of the kernel's launch plan (1 up to 1,024 clients), per shape."""
    from repro_torch.kernels.build import check

    device = indexed(device)
    key = (device, n, n_rsu)
    blocks = _BLOCKS.get(key)
    if blocks is None:
        with torch.cuda.device(device):
            blocks = lib.rttg_latency_blocks(n, n_rsu)
        if blocks < 1:
            check(-blocks, "rttg_latency")
        _BLOCKS[key] = blocks
    return blocks


def _check_vector(name, x, n, dtype, device):
    if x.device != device or x.dtype != dtype or x.shape != (n,) or not x.is_contiguous():
        raise ValueError(
            f"rttg_latency: {name} must be a contiguous ({n},) {dtype} tensor on "
            f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}"
        )


def _device_scalar(name, x, device):
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.numel() != 1:
        raise ValueError(f"rttg_latency: {name} must be a scalar, got shape {tuple(x.shape)}")
    return x


def _rttg_latency_cuda(pos, speed, accel, t, model_bytes, forced, cfg, predict,
                       want_rid):
    from repro_torch.kernels.build import check, counters, library

    refuse_grad("rttg_latency", pos, speed, accel, t, model_bytes)
    device = pos.device
    n = pos.shape[0]
    n_rsu = n_rsu_of(cfg)
    if n < 1 or n > 2**30 or n_rsu < 1 or n_rsu > MAX_RSU:
        raise ValueError(f"rttg_latency: need 1 <= N <= 2**30 and 1 <= R <= {MAX_RSU}, "
                         f"got N={n}, R={n_rsu}")
    for name, x in (("pos", pos), ("speed", speed), ("accel", accel)):
        _check_vector(name, x, n, torch.float32, device)
    if forced is not None:
        _check_vector("forced", forced, n, torch.bool, device)
    t = _device_scalar("t", t, device)
    model_bytes = _device_scalar("model_bytes", model_bytes, device)
    operand = scenario_operand(cfg, device)
    lib = library()
    blocks = launch_blocks(lib, device, n, n_rsu)
    counts = counters(device, "rttg_latency", n_rsu + 2) if blocks > 1 else None
    spill = (torch.empty((3 * n,), dtype=torch.int32, device=device)
             if blocks * GRID_THREADS < n else None)
    n_steps = horizon_steps(cfg.predict_horizon_s, cfg) if predict else 0
    horizon_s = float(cfg.predict_horizon_s) if predict else 0.0
    lat = torch.empty((n,), dtype=torch.float32, device=device)
    conn = torch.empty((n,), dtype=torch.bool, device=device)
    rid = torch.empty((n,), dtype=torch.int32, device=device) if want_rid else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with on_card(pos):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.rttg_latency_launch(
            operand.data_ptr(), n_rsu, t.data_ptr(), model_bytes.data_ptr(), pos.data_ptr(),
            speed.data_ptr(), accel.data_ptr(), ptr(forced), n, n_steps,
            float(cfg.sim_dt_s), horizon_s, blocks, ptr(counts), ptr(spill), lat.data_ptr(),
            conn.data_ptr(), ptr(rid), stream,
        )
    check(status, "rttg_latency")
    count_launch(__name__)
    if want_rid:
        return lat, conn, rid
    return lat, conn


def rttg_latency(pos, speed, accel, t, model_bytes, forced, cfg, *, predict: bool,
                 want_rid: bool = False):
    """Fused geometry chain -> (latency (N,) f32, connected (N,) bool[, rid]).

    ``cfg`` is a ``ScenarioParams``; ``t`` and ``model_bytes`` may be 0-dim
    tensors (the kernel reads them on the device, so no host sync).  CUDA
    tensors go to the kernel, CPU tensors to ``rttg_latency_plain``.
    """
    if pos.is_cuda:
        return _rttg_latency_cuda(pos, speed, accel, t, model_bytes, forced, cfg,
                                  predict, want_rid)
    if pos.device.type != "cpu":
        raise ValueError(f"rttg_latency: unsupported device {pos.device}")
    return rttg_latency_plain(pos, speed, accel, t, model_bytes, forced, cfg,
                              predict, want_rid)


def rttg_latency_grid_plain(pos, speed, accel, t, model_bytes, forced, cfg, predict,
                            want_rid=False):
    """``(G, N)`` kinematics, ``(G,)`` times and a ``scenarios.lane_view``
    scenario -> (latency (G, N) f32, connected (G, N) bool[, rid (G, N)
    int32]): the plain version's composition over the lane axis."""
    t = torch.as_tensor(t, dtype=torch.float32, device=pos.device)[:, None]
    return rttg_latency_plain(pos, speed, accel, t, model_bytes, forced, cfg, predict,
                              want_rid)


def grid_plan(lanes: int, n: int, n_rsu: int, sms: int, per_sm: int,
              spread_min: int = GRID_SPREAD_MIN) -> tuple:
    """B1g's launch plan for ``lanes`` lanes of ``n`` clients and ``n_rsu``
    RSUs on a card of ``sms`` SMs holding ``per_sm`` ``GRID_TILE_THREADS``-
    thread blocks each resident -> (tiles a lane T, threads a block, clients
    a thread at most).

    Tile b of a lane holds its clients ``[b n // T, (b + 1) n // T)``; a
    thread takes the tile's clients ``tid, tid + threads, ...``.  T = 1 (one
    block a lane, as many warps as cover ``n`` up to 1,024 threads) for n <
    ``spread_min``, n_rsu > ``GRID_POLL_RSU_MAX``, ``lanes >= sms`` and
    where fewer than two tiles a lane stay resident (so also for n <= 32).
    Otherwise the fewest clients a thread for which the tiles fit ``sms *
    per_sm`` blocks, and T as large as covering the SMs asks (``ceil(sms /
    lanes)`` tiles a lane, no more than a warp's 32 clients each) and
    residency allows, or as the block size cap needs.
    """
    threads = min(-(-n // 32) * 32, 1024)
    one = (1, threads, -(-n // threads))
    if n < spread_min or n_rsu > GRID_POLL_RSU_MAX or lanes >= sms:
        return one
    cap = sms * per_sm // lanes  # tiles a lane that stay resident
    want = min(-(-sms // lanes), -(-n // 32))
    for per_thread in range(1, GRID_PER_THREAD + 1):
        need = -(-n // (GRID_TILE_THREADS * per_thread))
        if need <= cap:
            tiles = max(need, min(want, cap))
            break
    else:
        return one
    if tiles < 2:
        return one
    tile = -(-n // tiles)
    threads = -(-tile // (32 * per_thread)) * 32
    return tiles, threads, -(-tile // threads)


def grid_resident(lib, device, n_rsu: int) -> tuple:
    """(SMs, resident ``GRID_TILE_THREADS``-thread tiled B1g blocks an SM) on
    ``device`` at R = ``n_rsu``, from the C side once per (device, R)."""
    from repro_torch.kernels.build import check

    device = indexed(device)
    key = (device, n_rsu)
    hit = _RESIDENT.get(key)
    if hit is None:
        sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            status = lib.rttg_latency_grid_resident(n_rsu, ctypes.addressof(sms),
                                                    ctypes.addressof(per_sm))
        check(status, "rttg_latency_grid")
        hit = _RESIDENT[key] = (sms.value, per_sm.value)
    return hit


def grid_launch_plan(lib, device, lanes: int, n: int, n_rsu: int) -> tuple:
    """``grid_plan`` on ``device``, its SMs and residency from ``grid_resident``."""
    return grid_plan(lanes, n, n_rsu, *grid_resident(lib, device, n_rsu))


def _rttg_latency_grid_cuda(pos, speed, accel, t, model_bytes, forced, cfg, predict,
                            want_rid):
    from repro_torch.kernels.build import check, counters, library

    refuse_grad("rttg_latency_grid", pos, speed, accel, t, model_bytes)
    device = pos.device
    if pos.dim() != 2:
        raise ValueError(f"rttg_latency_grid: pos must be (G, N), got {tuple(pos.shape)}")
    G, n = pos.shape
    n_rsu = n_rsu_of(cfg)
    if not (1 <= n <= GRID_MAX_N and 1 <= G and G * n < 2**31 and 1 <= n_rsu <= MAX_RSU):
        raise ValueError(f"rttg_latency_grid: need 1 <= N <= {GRID_MAX_N}, 1 <= G, "
                         f"G * N < 2**31 and 1 <= R <= {MAX_RSU}, got G={G}, N={n}, "
                         f"R={n_rsu}")
    for name, x, dtype in (("pos", pos, torch.float32), ("speed", speed, torch.float32),
                           ("accel", accel, torch.float32), ("forced", forced, torch.bool)):
        if x is not None and (x.device != device or x.dtype != dtype or x.shape != (G, n)
                              or not x.is_contiguous()):
            raise ValueError(f"rttg_latency_grid: {name} must be a contiguous ({G}, {n}) "
                             f"{dtype} tensor on {device}, got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
    if (t.device != device or t.dtype != torch.float32 or t.shape != (G,)
            or not t.is_contiguous()):
        raise ValueError(f"rttg_latency_grid: t must be a contiguous ({G},) float32 tensor "
                         f"on {device}")
    model_bytes = _device_scalar("model_bytes", model_bytes, device)
    operand = grid_operand(cfg, device)
    if operand.shape[0] != G:
        raise ValueError(f"rttg_latency_grid: the scenario has {operand.shape[0]} lanes, "
                         f"the kinematics {G}")
    lib = library()
    tiles, threads, _ = grid_launch_plan(lib, device, G, n, n_rsu)
    counts = counters(device, "rttg_latency_grid", G * (n_rsu + 1)) if tiles > 1 else None
    n_steps = horizon_steps(cfg.predict_horizon_s, cfg) if predict else 0
    horizon_s = float(cfg.predict_horizon_s) if predict else 0.0
    lat = torch.empty((G, n), dtype=torch.float32, device=device)
    conn = torch.empty((G, n), dtype=torch.bool, device=device)
    rid = torch.empty((G, n), dtype=torch.int32, device=device) if want_rid else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with on_card(pos):
        status = lib.rttg_latency_grid_launch(
            operand.data_ptr(), operand.shape[1], n_rsu, G, t.data_ptr(),
            model_bytes.data_ptr(), pos.data_ptr(), speed.data_ptr(), accel.data_ptr(),
            ptr(forced), n, n_steps, float(cfg.sim_dt_s), horizon_s, tiles, threads,
            ptr(counts), lat.data_ptr(), conn.data_ptr(), ptr(rid),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(status, "rttg_latency_grid")
    count_launch(__name__, "grid_launches")
    if want_rid:
        return lat, conn, rid
    return lat, conn


def rttg_latency_grid(pos, speed, accel, t, model_bytes, forced, cfg, *, predict: bool,
                      want_rid: bool = False):
    """G lanes' geometry chains -> (latency (G, N) f32, connected (G, N)
    bool[, rid (G, N) int32]).

    ``pos`` / ``speed`` / ``accel`` / ``forced`` are ``(G, N)``, ``t`` a
    ``(G,)`` tensor, ``cfg`` a ``scenarios.lane_view`` stack.  CUDA tensors
    go to the kernel (one launch, N <= ``GRID_MAX_N``; a failed build or
    launch raises), CPU tensors to ``rttg_latency_grid_plain``.
    """
    if pos.is_cuda:
        return _rttg_latency_grid_cuda(pos, speed, accel, t, model_bytes, forced, cfg, predict,
                                       want_rid)
    if pos.device.type != "cpu":
        raise ValueError(f"rttg_latency_grid: unsupported device {pos.device}")
    return rttg_latency_grid_plain(pos, speed, accel, t, model_bytes, forced, cfg, predict,
                                   want_rid)
