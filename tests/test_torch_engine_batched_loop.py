"""The batched grid round against the lane loop, bit for bit on the CPU.

The same lanes through both of the engine's paths: ``_lanes`` (stacked,
the batched warm-up, one round of every lane at once) and ``_lane_list``
(one state a lane, warmed up and run one after another through the
one-lane round step, PR 25's lane loop).  On the CPU at one thread every
metric and every state leaf of every lane must be equal bit for bit, NaN
alike: the batched round runs the one-lane round's expressions on the same
values.  Grids: the five strategies x seeds ``(0, 1)`` x scenarios
``("ring", "platoon", "rsu_outage")`` at N = 12 (with ``greedy`` in the
engine every lane trains K = 12 slots), in fp32 and with bf16 update rows;
a bf16 master with FedProx at an odd N; the economics at N = 9 with two
local epochs and batches of 4.  The core forms that the batched round
broadcasts over the lane axis are held the same way, lane by lane against
their one-lane calls.
"""
import numpy as np
import pytest
import torch

from repro_torch.config import FLConfig, ModelConfig
from repro_torch.core import clustering, fusion, messages, rttg, selection, twin
from repro_torch.core.scenarios import (lane_view, scenario_config, scenario_lane,
                                        scenario_params, stack_scenarios)
from repro_torch.fl import ExperimentEngine, client, rounds, server
from repro_torch.models import build_model
from repro_torch.utils import prng
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import FL, MLP
from test_torch_engine_batched import STRATEGIES

CONFIGS = {
    "fp32": dict(FL),
    "bf16 rows": dict(FL, compute_dtype="bfloat16"),
    "bf16 master, fedprox, N=13": dict(FL, num_clients=13, param_dtype="bfloat16",
                                       compute_dtype="bfloat16", fedprox_mu=0.01),
    "N=9, 2 epochs, batch 4": dict(FL, num_clients=9, samples_per_client=10, batch_size=4,
                                   local_epochs=2, num_clusters=3),
}
SCENARIOS = ("ring", "platoon", "rsu_outage")


def state_lane(stacked, g: int):
    """Lane ``g`` of a ``rounds.stack_states`` stack, as the one-lane round
    carries it (the twin's ``t`` back to 0-dim)."""
    lane_twin = twin.TwinState(*[x[g] for x in stacked.twin])
    return stacked._replace(twin=lane_twin._replace(t=lane_twin.t[0]), **{
        f: getattr(stacked, f)[g] for f in stacked._fields if f not in ("twin", "round")})


def _same(x, y) -> bool:
    if isinstance(x, torch.Tensor):
        return x.shape == y.shape and x.dtype == y.dtype and bool(
            ((x == y) | (torch.isnan(x) & torch.isnan(y))).all()) if x.is_floating_point() \
            else torch.equal(x, y)
    return x == y


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batched_sweep_is_the_lane_loop_bitwise(name):
    eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**CONFIGS[name]), "mnist",
                           device="cpu", strategies=STRATEGIES)
    assert eng.batched
    seeds = (0, 1) if name == "fp32" else (0,)
    runs = [(st, "fedavg", s, sc) for st in STRATEGIES for s in seeds for sc in SCENARIOS]
    batched, loop = eng._lanes(runs), eng._lane_list(runs)
    got, want = eng._sweep(batched, 3, 2), eng._sweep(loop, 3, 2)
    for f in got._fields:
        assert _same(getattr(got, f), getattr(want, f)), f
    for g, run in enumerate(runs):
        lane = state_lane(batched.state, g)
        for f in lane._fields:
            x, y = getattr(lane, f), getattr(loop.states[g], f)
            same = all(_same(p, q) for p, q in zip(x, y)) if f == "twin" else _same(x, y)
            assert same, (run, f)


# ---- the core forms over the lane axis, lane by lane ---------------------------------

G_SCN = ("ring", "highway", "urban_grid", "rush_hour", "rsu_outage", "platoon",
         "hetero_fleet", "day_cycle", "platoon")


@pytest.fixture(scope="module")
def lanes():
    """Nine lanes (every catalog scenario, platoon twice), N = 20: each
    lane's scenario and twin, their lane view and stack, and (G, 2) keys."""
    n = 20
    scns = [scenario_params(scenario_config(s, num_vehicles=n)) for s in G_SCN]
    keys = torch.stack([prng.fold_in(prng.key(3), g) for g in range(len(G_SCN))])
    twins = [twin.init_twin_state(scn, prng.fold_in_str(k, "twin"), "cpu")
             for scn, k in zip(scns, keys)]
    twins = [t._replace(accel=0.3 * prng.normal(prng.fold_in(k, 9), (n,))) for t, k in
             zip(twins, keys)]
    stacked = twin.TwinState(*[torch.stack(xs) for xs in zip(*twins)])
    stacked = stacked._replace(t=(stacked.t + 40.0 * torch.arange(len(G_SCN)))[:, None])
    twins = [t._replace(t=stacked.t[g, 0]) for g, t in enumerate(twins)]
    return scns, lane_view(stack_scenarios(scns)), keys, twins, stacked


def _rows(batched, singles):
    for g, one in enumerate(singles):
        assert torch.equal(batched[g], one), g


def test_keys_fold_and_draw_lane_by_lane(lanes):
    _, _, keys, _, _ = lanes
    k = prng.fold_in_str(prng.fold_in(keys, 7), "observe")
    _rows(k, [prng.fold_in_str(prng.fold_in(x, 7), "observe") for x in keys])
    _rows(prng.split(k, 5), [prng.split(x, 5) for x in k])
    for draw in (lambda x: prng.normal(x, (20,)), lambda x: prng.bernoulli(x, 0.7, (20,)),
                 lambda x: prng.randint(x, (), 0, 20), lambda x: prng.permutation(x, 20),
                 lambda x: prng.uniform(x, (4, 5))):
        _rows(draw(k), [draw(x) for x in k])


def test_twin_advance_lane_by_lane(lanes):
    scns, view, keys, twins, stacked = lanes
    dur = torch.linspace(0.5, 9.0, len(scns))
    got = twin.advance_twin(stacked, view, keys, dur[:, None], 15)
    for g, (t1, scn) in enumerate(zip(twins, scns)):
        want = twin.advance_twin(t1, scn, keys[g], dur[g], 15)
        assert torch.equal(got.t[g, 0], want.t)
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a[g], b), g


def test_messages_fusion_and_geometry_lane_by_lane(lanes):
    scns, view, keys, twins, stacked = lanes
    cams, cpms = messages.emit_cams(stacked, view, keys), messages.emit_cpms(stacked, view, keys)
    fused = fusion.fuse_kinematics(cams, cpms, view)
    geo = rttg.rsu_geometry(fused[0], view)
    for g, (t1, scn) in enumerate(zip(twins, scns)):
        c1, p1 = messages.emit_cams(t1, scn, keys[g]), messages.emit_cpms(t1, scn, keys[g])
        for f in ("pos", "speed", "accel"):
            assert torch.equal(cams[f][g], c1[f]), f
        for f in ("obj", "pos", "speed", "accel", "var", "valid"):
            assert torch.equal(cpms[f][g], p1[f]), f
        f1 = fusion.fuse_kinematics(c1, p1, scn)
        for a, b in zip(fused, f1):
            assert torch.equal(a[g], b), g
        for a, b in zip(geo, rttg.rsu_geometry(f1[0], scn)):
            assert torch.equal(a[g], b), g


@pytest.mark.parametrize("name", STRATEGIES)
def test_each_strategy_elects_lane_by_lane(lanes, name):
    scns, _, keys, _, _ = lanes
    G, n = len(scns), 20
    connected = prng.bernoulli(prng.fold_in(prng.key(5), 1), 0.8, (G, n))
    lat = prng.uniform(prng.fold_in(prng.key(5), 2), (G, n))
    lat = torch.where(lat < 0.2, 0.25, lat)  # ties: the lower index first
    clusters = prng.randint(prng.fold_in(prng.key(5), 3), (G, n), 0, 4)
    got = selection.STRATEGIES[name](keys, connected, lat, clusters, 5, 0.5)
    _rows(got, [selection.STRATEGIES[name](keys[g], connected[g], lat[g], clusters[g], 5, 0.5)
                for g in range(G)])


def test_kmeans_clusters_lane_by_lane(lanes):
    _, _, keys, _, _ = lanes
    x = prng.normal(prng.key(8), (len(keys), 20, 16))
    x[2, 5:] = x[2, 4]  # repeated points: empty clusters re-seed
    labels, cents = clustering.kmeans_cluster(x, keys, 4)
    for g, k in enumerate(keys):
        lab1, cen1 = clustering.kmeans_cluster(x[g], k, 4)
        assert torch.equal(labels[g], lab1) and torch.equal(cents[g], cen1), g


def test_trainer_per_client_starts_and_weights_lane_by_lane():
    api = build_model(ModelConfig(**MLP))
    G, K, n = 3, 4, 16
    starts = torch.stack([rounds.flatten_to_vector(api.init(prng.fold_in(prng.key(1), g), "cpu"))
                          for g in range(G)])
    images = prng.uniform(prng.key(2), (G, K, n, 28, 28, 1))
    labels = prng.randint(prng.key(3), (G, K, n), 0, 10)
    keys = prng.split(torch.stack([prng.fold_in(prng.key(4), g) for g in range(G)]), K)
    trainer = client.make_local_trainer(api.loss, 0.05, 2, 8, mu=0.01)
    rows = rounds.unflatten_from_vector(starts.repeat_interleave(K, dim=0), api.spec)
    _, vecs = trainer(rows, images.flatten(0, 1), labels.flatten(0, 1), keys.flatten(0, 1),
                      batch_dims=1)
    for g in range(G):
        _, want = trainer(rounds.unflatten_from_vector(starts[g], api.spec), images[g],
                          labels[g], keys[g])
        assert torch.equal(vecs.view(G, K, -1)[g], want), g
    mask = prng.bernoulli(prng.key(6), 0.6, (G, K))
    counts = prng.randint(prng.key(7), (G, K), 1, 64).float()
    _rows(server.normalized_weights(mask, counts),
          [server.normalized_weights(mask[g], counts[g]) for g in range(G)])


def test_stack_states_round_trips():
    api = build_model(ModelConfig(**MLP))
    fl = FLConfig(**FL)
    scn = scenario_params(scenario_config("platoon", num_vehicles=fl.num_clients))
    states = [rounds.init_state_for_key(api, fl, scn, rounds.experiment_key("mnist", s, 0),
                                        "cpu")[0] for s in STRATEGIES]
    stacked = rounds.stack_states(states)
    assert stacked.twin.t.shape == (len(states), 1) and stacked.key.shape == (len(states), 2)
    assert stacked.params.shape == (len(states),) + states[0].params.shape
    for g, one in enumerate(states):
        lane = state_lane(stacked, g)
        assert all(torch.equal(a, b) for a, b in zip(lane.twin, one.twin))
        assert all(_same(getattr(lane, f), getattr(one, f)) for f in one._fields if f != "twin")
    with pytest.raises(ValueError, match="round counter"):
        rounds.stack_states([states[0], states[1]._replace(round=1)])
    view = lane_view(stack_scenarios([scn, scn]))
    assert view.ring_length_m.shape == (2, 1) and view.n_rsu == scn.n_rsu
    assert torch.equal(scenario_lane(stack_scenarios([scn, scn]), 1).ring_length_m,
                       scn.ring_length_m)
    assert np.isclose(float(view.rad_per_m[0, 0]), float(scn.rad_per_m))
