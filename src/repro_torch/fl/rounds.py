"""The FL round core (``repro.fl.rounds``): one round = one ``round_step``.

A round runs the paper's selector (fuse CAM/CPM -> predict the topology and
price its latency -> elect over the data clusters), trains the cohort,
costs the round on the realized topology, and applies the FedAvg update to
the flat ``(P,)`` global model.  Selection is a fixed-size mask compacted
into K cohort slots, as in the JAX package, so the shapes never depend on
the data.

The port runs the fp32 lanes of the reference with every registered server
rule (``fl.aggregators.AGGREGATOR_ORDER``), flat or two-tier; the bf16 lane
raises ``NotImplementedError``.  The geometry is fused by default
(``fused=True``: both geometry passes go through the ``rttg_latency``
kernel); ``fused=False`` composes the RTTG API instead (``fuse_messages ->
predict_rttg -> latency_model / connectivity``, and ``build_rttg`` on the
mid-round twin), the same arithmetic, so the two lanes agree bit for bit
through the plain versions.  The unfused lane builds ``(N, N)`` adjacency
matrices and stops at ``messages.DENSE_MAX_N`` vehicles.  The kernels of a
fused round: ``rttg_latency`` twice (predicted and realized topology), then
one server step.  The single-rule ``("fedavg",)`` registry
keeps the plain ``fedavg_reduce`` + AXPY step; any other registry runs the
fused ``server_update`` kernel, or ``server_update_buffered`` when it holds
``fedbuff`` (the in-flight ring's drained rows join the same reduce).

Two-tier aggregation (``FLConfig.hierarchical``): the FedAvg weights are
normalized by the per-RSU masses of the live RSUs (bitwise the flat weights
while every RSU is live, the sample counts being integers).  With
``client_block = B > 0`` the cohort is also STREAMED: chunks of B slots
train in turn and ``rsu_reduce`` adds each chunk into ``(R, P)`` per-RSU
partials (one launch per chunk), and the server step reduces the R partials
at the live mask's weights.  The round's economics are computed before any
training, by the same expressions in every lane.

Randomness follows the reference stream for stream: every draw comes from
the experiment key ``RoundState.key`` folded by round and by name.  Keys
and the round counter live on the host (a key is two words; deriving one is
cheaper there than a launch); everything else lives on the run's device.
So does the aggregator index: a registry is resolved to its global rule
index on the host, while every data-dependent decision of the server step
(who parks, whether the ring drains, whether the model moves) stays a
device tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.config import FLConfig
from repro_torch.core import messages
from repro_torch.core.clustering import apply_sketch, kmeans_cluster, sketch_sign_vector
from repro_torch.core.fusion import fuse_kinematics, fuse_messages
from repro_torch.core.messages import emit_cams, emit_cpms
from repro_torch.core.network import connectivity, forced_connections, latency_model
from repro_torch.core.rttg import build_rttg, n_rsu_of, rsu_up_mask
from repro_torch.core.trajectory import predict_rttg
from repro_torch.core.selection import STRATEGIES
from repro_torch.core.twin import TwinState, advance_twin, init_twin_state
from repro_torch.fl.aggregators import (
    AGGREGATOR_ORDER,
    FEDBUFF_IDX,
    STALE_IDX,
    init_opt_vectors,
    server_hp,
    staleness_scale,
    validate_aggregators,
)
from repro_torch.fl.client import make_local_trainer
from repro_torch.fl.partition import client_sample_counts, make_test_set, partition_clients
from repro_torch.fl.server import apply_delta_flat, normalized_weights, rsu_normalized_weights
from repro_torch.kernels.fedavg_reduce import fedavg_reduce
from repro_torch.kernels.rsu_reduce import rsu_reduce
from repro_torch.kernels.rttg_latency import rttg_latency
from repro_torch.kernels.server_update import server_update, server_update_buffered
from repro_torch.utils import prng
from repro_torch.utils.pytree import flatten_to_vector, unflatten_from_vector

STRATEGY_ORDER: Tuple[str, ...] = ("greedy", "gossip", "data", "network", "contextual")

# Twin integration splits every advance into this many equal sub-steps.
ADVANCE_SUBSTEPS = 15


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


class RoundState(NamedTuple):
    """Everything a round mutates.

    ``params`` is the flat (P,) fp32 global model; ``opt_m`` / ``opt_v`` the
    server-moment vectors (zeros: plain fedavg carries them untouched);
    ``sketch_sign`` the per-experiment Rademacher signs.  The ``buf_*``
    leaves are the fedbuff ring: ``Kb = FLConfig.buffer_size`` slots holding
    deadline-missers' update rows, with arrival time, dispatch time,
    sample-count weight and occupancy; other rules carry them as inert
    zeros.  ``round`` is a Python int and ``key`` a host tensor; the rest
    lives on the run's device.
    """

    params: torch.Tensor
    opt_m: torch.Tensor
    opt_v: torch.Tensor
    twin: TwinState
    sketches: torch.Tensor  # (N, sketch_dim)
    sketch_age: torch.Tensor  # (N,) rounds since last report
    clusters: torch.Tensor  # (N,) int64 data-cluster labels
    sketch_sign: torch.Tensor  # (P padded,)
    buf_delta: torch.Tensor  # (Kb, P)
    buf_arrive: torch.Tensor  # (Kb,)
    buf_sent: torch.Tensor  # (Kb,)
    buf_weight: torch.Tensor  # (Kb,)
    buf_mask: torch.Tensor  # (Kb,) bool
    round: int
    sim_time: torch.Tensor  # () f32
    key: torch.Tensor  # (2,) host key words

    def to(self, device) -> "RoundState":
        """The same state with every device leaf on ``device`` (keys stay)."""
        moved = {f: _to(getattr(self, f), device) for f in self._fields
                 if f not in ("twin", "key")}
        return self._replace(twin=TwinState(*[_to(x, device) for x in self.twin]),
                             **moved)


class RoundData(NamedTuple):
    """Per-experiment constants: client shards + global test set."""

    images: torch.Tensor  # (N, n, H, W, C)
    labels: torch.Tensor  # (N, n)
    counts: torch.Tensor  # (N,) f32 per-client sample counts
    test_x: torch.Tensor
    test_y: torch.Tensor

    def to(self, device) -> "RoundData":
        return RoundData(*[_to(x, device) for x in self])


class RoundMetrics(NamedTuple):
    """Per-round telemetry (0-dim tensors on the run's device)."""

    round: torch.Tensor
    sim_time: torch.Tensor
    duration: torch.Tensor
    n_selected: torch.Tensor
    n_succeeded: torch.Tensor
    n_buffered: torch.Tensor
    n_drained: torch.Tensor
    mean_pred_latency: torch.Tensor
    mean_real_latency: torch.Tensor
    test_acc: torch.Tensor
    test_loss: torch.Tensor


@dataclasses.dataclass
class RoundRecord:
    """Host-side view of one round."""

    round: int
    sim_time: float
    duration: float
    n_selected: int
    n_succeeded: int
    mean_pred_latency: float
    mean_real_latency: float
    test_acc: float
    test_loss: float
    n_buffered: int = 0
    n_drained: int = 0


def cohort_size_for(fl: FLConfig, strategies: Sequence[str]) -> int:
    """Static cohort width: greedy trains every connected client."""
    return fl.num_clients if "greedy" in strategies else fl.n_select


def regions_of(pos: torch.Tensor, cfg, n_regions: int = 10) -> torch.Tensor:
    """(C,) home road region per CAV (geographic non-iid ownership)."""
    return torch.floor(pos / cfg.ring_length_m * n_regions).to(torch.int64) % n_regions


def twin_init_key(key: torch.Tensor) -> torch.Tensor:
    """The fold chain from an experiment key to its twin-init key."""
    return prng.fold_in_str(prng.fold_in_str(key, "traffic-twin"), "init")


def init_state_for_key(api, fl: FLConfig, scn, key: torch.Tensor, device):
    """One experiment's initial ``RoundState`` plus its (C,) home regions.

    ``key`` is the already-folded experiment key (see ``init_state``).
    """
    params = api.init(prng.fold_in_str(key, "model-init"), device)
    params_vec = flatten_to_vector(params)
    P = params_vec.shape[0]
    sketch_sign = sketch_sign_vector(prng.fold_in_str(key, "selector"), P,
                                     fl.sketch_dim, device)
    twin = init_twin_state(scn, twin_init_key(key), device)
    regions = regions_of(twin.pos, scn)
    N, Kb = fl.num_clients, fl.buffer_size
    opt_m, opt_v = init_opt_vectors(params_vec)
    f32 = dict(dtype=torch.float32, device=device)
    state = RoundState(
        params=params_vec,
        opt_m=opt_m,
        opt_v=opt_v,
        twin=twin,
        sketches=torch.zeros((N, fl.sketch_dim), **f32),
        sketch_age=torch.full((N,), math.inf, **f32),
        clusters=torch.zeros((N,), dtype=torch.int64, device=device),
        sketch_sign=sketch_sign,
        buf_delta=torch.zeros((Kb, P), **f32),
        buf_arrive=torch.zeros((Kb,), **f32),
        buf_sent=torch.zeros((Kb,), **f32),
        buf_weight=torch.zeros((Kb,), **f32),
        buf_mask=torch.zeros((Kb,), dtype=torch.bool, device=device),
        round=0,
        sim_time=torch.zeros((), **f32),
        key=key.cpu(),
    )
    return state, regions


def init_state(api, fl: FLConfig, scn, dataset: str, strategy: str,
               key: torch.Tensor, device):
    """Initial state of one experiment from the seed key (folds strategy + dataset)."""
    if fl.num_clients != scn.num_vehicles:
        raise ValueError("every FL client is a CAV: num_clients must equal num_vehicles")
    key = prng.fold_in_str(key, f"fl-sim/{strategy}/{dataset}")
    return init_state_for_key(api, fl, scn, key, device)


def make_round_data(key: torch.Tensor, dataset: str, fl: FLConfig,
                    regions: torch.Tensor, device) -> RoundData:
    """Client shards + test set from (experiment key, home regions)."""
    images, labels = partition_clients(key, dataset, fl, regions, device)
    test_x, test_y = make_test_set(key, dataset, device=device)
    return RoundData(images, labels, client_sample_counts(labels), test_x, test_y)


def _check_lane(fl: FLConfig, fused: bool) -> None:
    if fl.client_block < 0:
        raise ValueError(f"client_block must be >= 0, got {fl.client_block}")
    if fl.client_block and not fl.hierarchical:
        raise ValueError(
            "client_block streaming segments the cohort by RSU attachment; "
            "set hierarchical=True to enable it"
        )
    if not fused and fl.num_clients > messages.DENSE_MAX_N:
        raise ValueError(
            f"the unfused geometry (fused=False) builds (N, N) RTTG adjacency matrices; "
            f"it runs up to {messages.DENSE_MAX_N} vehicles, got {fl.num_clients}: "
            "use fused=True"
        )
    if fl.param_dtype != "float32" or fl.compute_dtype != "float32":
        raise NotImplementedError("the bf16 precision lane is not ported yet "
                                  "(see ROADMAP.md)")


def make_warmup(loss_fn, fl: FLConfig, param_spec):
    """Deadline-rule bootstrap: every client reports one gradient sketch,
    then the first clustering runs.  (state, data) -> state."""
    one_step = make_local_trainer(loss_fn, fl.learning_rate, 1, fl.batch_size)

    @torch.no_grad()
    def warmup(state: RoundState, data: RoundData) -> RoundState:
        bs = fl.batch_size
        params = unflatten_from_vector(state.params, param_spec)
        _, vecs = one_step(params, data.images[:, :bs], data.labels[:, :bs],
                           prng.fold_in_str(state.key, "warmup"))
        sketches = apply_sketch(vecs, state.sketch_sign, fl.sketch_dim)
        k_km = prng.fold_in_str(prng.fold_in(state.key, 0), "kmeans")
        clusters, _ = kmeans_cluster(sketches, k_km, fl.num_clusters)
        return state._replace(sketches=sketches,
                              sketch_age=torch.zeros_like(state.sketch_age),
                              clusters=clusters)

    return warmup


def make_round_step(loss_fn, fl: FLConfig, cohort_size: int, model_bytes: float,
                    param_spec, strategies: Sequence[str] = STRATEGY_ORDER,
                    fused: bool = True, aggregators: Sequence[str] = ("fedavg",)):
    """Build the round transition for a fixed FL config.

    Returned fn: ``round_step(state, scn, strategy_idx, aggregator_idx,
    data, do_eval, do_recluster=None) -> (state, metrics)``.
    ``strategy_idx`` indexes ``strategies`` and ``aggregator_idx``
    ``aggregators`` (host ints).  ``do_recluster`` defaults to the
    ``recluster_every`` schedule of the round counter.
    """
    strategies = tuple(strategies)
    _check_lane(fl, fused)
    aggregators = validate_aggregators(aggregators)
    # local aggregator index -> global AGGREGATOR_ORDER index (the kernel's
    # rule switch and the STALE / FEDBUFF tests speak global)
    agg_global = tuple(AGGREGATOR_ORDER.index(a) for a in aggregators)
    plain_fedavg = aggregators == ("fedavg",)
    # a registry holding fedbuff routes every lane through the buffered
    # kernel (drain=False is the unbuffered step exactly)
    has_fedbuff = "fedbuff" in aggregators
    Kb, buffer_fill = fl.buffer_size, fl.buffer_fill
    hp = server_hp(fl)
    trainer = make_local_trainer(loss_fn, fl.learning_rate, fl.local_epochs,
                                 fl.batch_size, mu=fl.fedprox_mu)
    hierarchical, B = fl.hierarchical, fl.client_block
    n_select = fl.n_select
    N, K = fl.num_clients, cohort_size
    compute_s = fl.local_epochs * fl.compute_s_per_epoch
    cr = fl.connection_rate

    def _predicted(twin, scn, rk, mb):
        """Stages 1+2: fused observations -> predicted latency / connectivity."""
        k_obs = prng.fold_in_str(rk, "observe")
        cams = emit_cams(twin, scn, k_obs)
        cpms = emit_cpms(twin, scn, k_obs)
        k_cr = prng.fold_in_str(rk, "cr")
        if fused:
            pos, speed, accel, _ = fuse_kinematics(cams, cpms, scn)
            return rttg_latency(pos, speed, accel, twin.t, mb,
                                forced_connections(k_cr, cr, (N,), twin.pos.device), scn,
                                predict=True)
        future = predict_rttg(fuse_messages(cams, cpms, twin.t, scn), scn.predict_horizon_s, scn)
        return latency_model(future, mb, scn), connectivity(future, scn, cr, k_cr)

    def _realized(mid_twin, scn, rk, mb):
        """Mid-round geometry on the TRUE evolved topology (and, on the
        two-tier lanes, each client's RSU)."""
        k_cr = prng.fold_in_str(rk, "upload-cr")
        if fused:
            return rttg_latency(mid_twin.pos, mid_twin.speed, mid_twin.accel, mid_twin.t, mb,
                                forced_connections(k_cr, cr, (N,), mid_twin.pos.device), scn,
                                predict=False, want_rid=hierarchical)
        mid = build_rttg(mid_twin.t, mid_twin.pos, mid_twin.speed, mid_twin.accel,
                         torch.zeros_like(mid_twin.pos), scn)
        out = (latency_model(mid, mb, scn), connectivity(mid, scn, cr, k_cr))
        return out + (mid.rsu_id.to(torch.int32),) if hierarchical else out

    @torch.no_grad()
    def round_step(state: RoundState, scn, strategy_idx, aggregator_idx,
                   data: RoundData, do_eval, do_recluster=None):
        device = state.params.device
        f32 = dict(dtype=torch.float32, device=device)
        nan = torch.full((), math.nan, **f32)
        mb = torch.tensor(float(model_bytes), **f32)
        rk = prng.fold_in(state.key, state.round)

        # ---- stages 1+2: fuse CAM/CPM, predict, price the topology -----
        lat_pred, connected = _predicted(state.twin, scn, rk, mb)

        # ---- stage 4: elect --------------------------------------------
        name = strategies[int(strategy_idx)]
        mask = STRATEGIES[name](prng.fold_in_str(rk, name), connected, lat_pred,
                                state.clusters, n_select, fl.gamma)
        n_selected = mask.sum().to(torch.int32)

        # ---- fixed-size cohort: selected ids ascending, then padding ---
        ar = torch.arange(N, device=device)
        idx = torch.sort(torch.where(mask, ar, N + ar)).values[:K]
        slot_valid = idx < N
        idx_c = torch.where(slot_valid, idx, 0)

        # ---- realized round economics on the TRUE evolved topology -----
        compute_i = compute_s * state.twin.compute_factor[idx_c]
        nsel_f = torch.clamp_min(n_selected.to(torch.float32), 1.0)
        mean_compute = torch.where(slot_valid, compute_i, 0.0).sum() / nsel_f
        mid_twin = advance_twin(state.twin, scn, prng.fold_in_str(rk, "mid"),
                                mean_compute, ADVANCE_SUBSTEPS)
        real_lat, still_conn, *attached = _realized(mid_twin, scn, rk, mb)
        ok = slot_valid & still_conn[idx_c]
        ok_any = ok.any()
        timeout = torch.tensor(fl.round_timeout_s, **f32)
        per_slot = real_lat[idx_c] + compute_i
        # a selected client that missed the deadline costs the full timeout;
        # padding slots must not contribute to the round maximum
        slot_pay = torch.where(ok, per_slot, timeout)
        dur_core = torch.where(slot_valid, slot_pay, -math.inf).max()
        duration = torch.where(n_selected > 0, dur_core + fl.server_agg_s, timeout)

        # ---- FedAvg weights (flat, or RSU-routed two-tier) -------------
        counts_k = data.counts[idx_c]
        if hierarchical:
            R = n_rsu_of(scn)
            live = rsu_up_mask(scn)
            rid_k = attached[0][idx_c]
            # the attachment argmin never picks a dark RSU: folding liveness
            # in keeps a dark RSU's partial from ever reaching the server
            live_k = live[rid_k.long()]

            def _w_strict(m, c):
                return rsu_normalized_weights(m & live_k, c, rid_k, live, R)[0]

            def _w_stale(m, c):
                # discounted counts are not integers: the flat normalizer
                # keeps the stale lane bitwise with its flat sibling
                return rsu_normalized_weights(m & live_k, c, rid_k, live, R,
                                              mass_norm=False)[0]
        else:
            _w_strict = _w_stale = normalized_weights
        w = _w_strict(ok, counts_k)
        upd_any = ok_any
        gidx = agg_global[int(aggregator_idx)]
        if gidx == STALE_IDX:
            # stragglers keep a weight discounted by their realized round
            # time; any selected client moves the model
            disc = torch.where(ok, 1.0, staleness_scale(per_slot, timeout))
            w = _w_stale(slot_valid, counts_k * disc)
            upd_any = n_selected > 0

        # ---- fedbuff: drain arrived ring slots, place new stragglers ---
        # Mask-based on the fixed (Kb,) slot axis: the occupied slots that
        # have ARRIVED by round end drain (discounted by their realized
        # lateness, gated on the fill threshold) into the server step; this
        # round's deadline-missers compact into the freed slots.
        n_buffered = n_drained = torch.zeros((), dtype=torch.int32, device=device)
        if has_fedbuff:
            is_fedbuff = gidx == FEDBUFF_IDX
            end_time = state.sim_time + duration
            arrived = state.buf_mask & (state.buf_arrive <= end_time)
            n_arrived = arrived.sum().to(torch.int32)
            drain_fire = (n_arrived >= buffer_fill) & is_fedbuff
            disc_b = staleness_scale(torch.clamp_min(end_time - state.buf_sent, 0.0), timeout)
            # normalized by the UNDISCOUNTED drained mass, so the discount
            # shrinks the step instead of cancelling out
            mass_b = torch.where(arrived, state.buf_weight, 0.0).sum()
            drained = drain_fire & arrived
            bw = torch.where(drained, state.buf_weight * disc_b / torch.clamp_min(mass_b, 1e-9),
                             0.0)
            keep = state.buf_mask & ~drained
            # the i-th straggler takes the i-th free slot; ranks past the
            # free capacity get slot 2*Kb and drop (newest overflow dropped)
            strag = slot_valid & ~ok & is_fedbuff
            ar_b = torch.arange(Kb, device=device)
            free_order = torch.sort(torch.where(keep, Kb + ar_b, ar_b)).values
            rank = torch.cumsum(strag, 0) - 1
            slot = torch.where(strag & (rank < Kb), free_order[rank.clamp(0, Kb - 1)], 2 * Kb)
            n_buffered = (strag & (slot < Kb)).sum().to(torch.int32)
            n_drained = torch.where(drain_fire, n_arrived, 0).to(torch.int32)
            if is_fedbuff:
                # a drain with no in-round survivor is still a server step
                upd_any = ok_any | drain_fire

        # ---- local training, survivors' sketches, the edge reduce ------
        params = unflatten_from_vector(state.params, param_spec)
        buf = {f: getattr(state, f) for f in
               ("buf_delta", "buf_arrive", "buf_sent", "buf_weight", "buf_mask")}
        if has_fedbuff:
            # drained slots empty now; this round's stragglers fill them below
            buf = {f: keep if f == "buf_mask" else torch.where(
                keep.reshape((Kb,) + (1,) * (x.dim() - 1)), x, 0.0) for f, x in buf.items()}
        if B:
            # the streamed two-tier lane: chunks of B slots train and reduce
            # straight into the (R, P) per-RSU partials, so the (K, P) update
            # matrix never exists.  Per-client keys come from ONE cohort-wide
            # split (the unblocked trainer's stream); padding slots repeat
            # key 0 and train zeroed data into zero-masked updates.
            n_chunks = -(-K // B)
            pad = n_chunks * B - K

            def _pad(x, fill):
                return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)]) if pad else x

            keys = prng.split(prng.fold_in_str(rk, "local"), K)
            keys = torch.cat([keys, keys[:1].expand(pad, 2)]) if pad else keys
            idx_p, valid_p, w_p, ok_p, rid_p = (_pad(idx_c, 0), _pad(slot_valid, False),
                                                _pad(w, 0.0), _pad(ok, False), _pad(rid_k, 0))
            slot_p = _pad(slot, 2 * Kb) if has_fedbuff else None
            partials, sketches, sketch_age = None, state.sketches, state.sketch_age
            for c in range(n_chunks):
                cs = slice(c * B, (c + 1) * B)
                vb = _train(trainer, params, data, idx_p[cs], valid_p[cs], keys[cs])
                partials, _ = rsu_reduce(vb, w_p[cs], rid_p[cs], R, carry=partials)
                sketches, sketch_age = _report(sketches, sketch_age, vb, ok_p[cs],
                                               idx_p[cs], state.sketch_sign, fl.sketch_dim, N)
                if has_fedbuff:
                    # straggler rows park in the ring (padding slots drop)
                    buf["buf_delta"] = _scatter_rows(buf["buf_delta"], slot_p[cs], vb)
            # the server tier: R partials, the weights already applied at the edge
            red, red_w = partials, live.to(torch.float32)
        else:
            vecs = _train(trainer, params, data, idx_c, slot_valid,
                          prng.fold_in_str(rk, "local"))
            sketches, sketch_age = _report(state.sketches, state.sketch_age, vecs, ok,
                                           idx_c, state.sketch_sign, fl.sketch_dim, N)
            if has_fedbuff:
                buf["buf_delta"] = _scatter_rows(buf["buf_delta"], slot, vecs)
            red, red_w = vecs, w
        sketch_age = sketch_age + 1.0

        # ---- server update over deadline survivors (one fused pass) ----
        opt_m, opt_v = state.opt_m, state.opt_v
        if plain_fedavg:
            delta = fedavg_reduce(red, red_w)
            params_vec = torch.where(ok_any, apply_delta_flat(state.params, delta),
                                     state.params)
        else:
            if has_fedbuff:
                # the PRE-scatter ring: bw is nonzero only on slots drained now
                new = server_update_buffered(red, red_w, state.buf_delta, bw, state.params,
                                             opt_m, opt_v, gidx, state.round, drain_fire,
                                             **hp._asdict())
            else:
                new = server_update(red, red_w, state.params, opt_m, opt_v, gidx,
                                    state.round, **hp._asdict())
            params_vec, opt_m, opt_v = [torch.where(upd_any, n, o) for n, o in
                                        zip(new, (state.params, opt_m, opt_v))]

        # ---- fedbuff: the ring's metadata follows the row scatter -------
        if has_fedbuff:
            # a parked update lands one full deadline later (or at its
            # realized round time, if even slower)
            arrive_k = state.sim_time + torch.maximum(per_slot, timeout)
            rows = {"buf_arrive": arrive_k, "buf_sent": state.sim_time.expand(K),
                    "buf_weight": counts_k,
                    "buf_mask": torch.ones((K,), dtype=torch.bool, device=device)}
            for f, new_rows in rows.items():
                buf[f] = _scatter_rows(buf[f], slot, new_rows)

        # ---- advance the twin to round end -----------------------------
        base = TwinState(*[torch.where(ok_any, m, o) for m, o in zip(mid_twin, state.twin)])
        already = torch.where(ok_any, mean_compute, 0.0)
        rem = torch.clamp_min(duration - already, 1e-3)
        twin = advance_twin(base, scn, prng.fold_in_str(rk, "adv"), rem, ADVANCE_SUBSTEPS)

        # ---- end of round: recluster on schedule, eval -----------------
        new_round = state.round + 1
        if do_recluster is None:
            do_recluster = new_round % max(fl.recluster_every, 1) == 0
        clusters = state.clusters
        if do_recluster:
            k_km = prng.fold_in_str(prng.fold_in(state.key, new_round), "kmeans")
            clusters = kmeans_cluster(sketches, k_km, fl.num_clusters)[0]
        sim_time = state.sim_time + duration
        if do_eval:
            tree = unflatten_from_vector(params_vec, param_spec)
            _, m = loss_fn(tree, {"images": data.test_x, "labels": data.test_y})
            test_acc, test_loss = m["accuracy"], m["ce"]
        else:
            test_acc, test_loss = nan, nan

        has_sel = n_selected > 0
        metrics = RoundMetrics(
            round=torch.tensor(new_round, dtype=torch.int32, device=device),
            sim_time=sim_time,
            duration=duration,
            n_selected=n_selected,
            n_succeeded=ok.sum().to(torch.int32),
            n_buffered=n_buffered,
            n_drained=n_drained,
            mean_pred_latency=torch.where(
                has_sel, torch.where(mask, lat_pred, 0.0).sum() / nsel_f, nan),
            mean_real_latency=torch.where(
                has_sel, torch.where(slot_valid, real_lat[idx_c], 0.0).sum() / nsel_f, nan),
            test_acc=test_acc,
            test_loss=test_loss,
        )
        new_state = state._replace(
            params=params_vec,
            opt_m=opt_m,
            opt_v=opt_v,
            twin=twin,
            sketches=sketches,
            sketch_age=sketch_age,
            clusters=clusters,
            round=new_round,
            sim_time=sim_time,
            **buf,
        )
        return new_state, metrics

    return round_step


def _train(trainer, params, data: RoundData, idx, valid, key) -> torch.Tensor:
    """(B, P) updates of the clients ``idx``; invalid slots train zeroed
    data and come out as zero rows."""
    imgs = data.images[idx]
    imgs = imgs * valid.reshape(valid.shape + (1,) * (imgs.dim() - 1))
    lbls = torch.where(valid[:, None], data.labels[idx], 0)
    _, vecs = trainer(params, imgs, lbls, key)
    return vecs * valid[:, None]


def _report(sketches, sketch_age, vecs, ok, idx, sign, sketch_dim, n):
    """Deadline rule: the survivors' sketches land on their rows, their age
    resets to 0; the other rows drop."""
    sks = apply_sketch(vecs, sign, sketch_dim)
    scatter = torch.where(ok, idx, n)
    return (_scatter_rows(sketches, scatter, sks),
            _scatter_rows(sketch_age, scatter, sks.new_zeros(idx.shape)))


def _scatter_rows(base: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``base`` with ``base[idx[i]] = rows[i]``; indices >= len(base) drop
    (they land on a sink row past the end)."""
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros((1,) + base.shape[1:])])
    out[torch.clamp_max(idx, n)] = rows
    return out[:n]


def metrics_to_records(metrics: RoundMetrics) -> list:
    """Convert stacked (T,) ``RoundMetrics`` into host ``RoundRecord``s."""
    m = {f: getattr(metrics, f).detach().cpu().tolist() for f in metrics._fields}
    ints = ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained")
    return [
        RoundRecord(**{f: (int(m[f][i]) if f in ints else float(m[f][i]))
                       for f in metrics._fields})
        for i in range(len(m["round"]))
    ]
