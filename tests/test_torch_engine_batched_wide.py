"""The batched grid round above 1,024 clients, and lane groups.

One reference ``run_grid`` and two port ``run_grid`` calls of a
``("fedavg",)`` grid at N = 1,030 (above one block of B1g's threads, and
not a multiple of 32): strategies ``("contextual", "gossip")`` x seed 0 x
scenarios ``("ring", "platoon")``, 2 rounds, the MLP of
``tests/test_torch_engine.py`` (4 samples a client in batches of 4, CR
0.7: the synthetic shards' draw dominates a CPU set-up at this N), computed
once per module.  The port's engine takes the batched round; held against
the reference lane for lane (``assert_lane_matches``: integers equal, floats
within rtol 2e-4, atol 1e-5) and against the port's lane loop bit for bit
(the route forced by monkeypatching ``engine.grid_round_fits``; the loop
reads the batched run's data rows, drawn once).

Lane groups: a 10-lane grid at N = 12 whose budgets are monkeypatched to
cut it into groups of 3 or of 4 (the last one short) equals the unsplit
run lane for lane, bit for bit, with the same ``runs``; each group's data
rows are de-duplicated within it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.config import ModelConfig as JModelConfig
from repro.fl.engine import ExperimentEngine as JEngine
from repro_torch.config import FLConfig, ModelConfig
from repro_torch.configs import get_config
from repro_torch.core import messages
from repro_torch.fl import ExperimentEngine, engine
from repro_torch.fl.rounds import make_round_data
from repro_torch.kernels import rttg_latency
from repro_torch.utils.pytree import flat_size_of
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import FL, MLP, assert_lane_matches

WIDE = 1030
WIDE_FL = dict(FL, num_clients=WIDE, samples_per_client=4, batch_size=4)
WIDE_STRATEGIES = ("contextual", "gossip")
WIDE_GRID = dict(seeds=(0,), scenarios=("ring", "platoon"), rounds=2, eval_every=1)
WIDE_LANES = len(WIDE_STRATEGIES) * 2
STRATEGIES = ("greedy", "gossip", "data", "network", "contextual")
GROUP_GRID = dict(seeds=(0,), scenarios=("ring", "platoon"), rounds=2, eval_every=2)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_metrics_bitwise(a, b, what):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y)), f"{what}: {f}"


@pytest.fixture(scope="module")
def wide():
    """(batched engine, its result, the lane loop's result, reference
    metrics and runs) of the N = 1,030 grid."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = JEngine(JModelConfig(**MLP), JFLConfig(**WIDE_FL), "mnist",
                      strategies=WIDE_STRATEGIES, aggregators=("fedavg",)).run_grid(**WIDE_GRID)
        ref = jax.tree_util.tree_map(np.asarray, ref.metrics), ref.runs
        drawn = {}

        def rows_once(key, dataset, fl, regions, device):
            k = (tuple(key.tolist()), dataset, regions.numpy().tobytes())
            if k not in drawn:
                drawn[k] = make_round_data(key, dataset, fl, regions, device)
            return drawn[k]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(engine, "make_round_data", rows_once)
            eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**WIDE_FL), "mnist",
                                   device="cpu", strategies=WIDE_STRATEGIES)
            res = eng.run_grid(**WIDE_GRID)
            mp.setattr(engine, "grid_round_fits", lambda fl, aggregators: False)
            loop_eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**WIDE_FL), "mnist",
                                        device="cpu", strategies=WIDE_STRATEGIES)
            assert not loop_eng.batched
            loop = loop_eng.run_grid(**WIDE_GRID)
        assert len(drawn) == WIDE_LANES  # one row a (strategy, data signature)
        return eng, res, loop, ref
    finally:
        torch.set_num_threads(prev)


def test_the_gridded_limit_is_the_dense_search_limit():
    assert rttg_latency.GRID_MAX_N == messages.DENSE_MAX_N == 4096


def test_the_wide_grid_takes_the_batched_round_in_one_group(wide):
    eng, res, _, (_, ref_runs) = wide
    assert eng.batched and eng.cohort_size == FLConfig(**WIDE_FL).n_select
    assert eng.lanes_per_group() >= WIDE_LANES
    assert res.runs == [tuple(r) for r in ref_runs] and len(res.runs) == WIDE_LANES
    for f in res.metrics._fields:
        assert getattr(res.metrics, f).shape == (WIDE_LANES, WIDE_GRID["rounds"]), f
    assert int(res.metrics.n_selected.min()) > 0
    assert bool(torch.isfinite(res.metrics.test_acc).all())


@pytest.mark.parametrize("g", range(WIDE_LANES))
def test_wide_batched_lane_matches_the_reference(wide, g):
    _, res, _, (ref, ref_runs) = wide
    assert_lane_matches(type(res.metrics)(*[x[g] for x in res.metrics]),
                        type(ref)(*[x[g] for x in ref]), str(ref_runs[g]))


def test_wide_batched_grid_is_the_lane_loop_bit_for_bit(wide):
    _, res, loop, _ = wide
    assert loop.runs == res.runs
    assert_metrics_bitwise(res.metrics, loop.metrics, "batched vs lane loop")


# ---- lane groups -----------------------------------------------------------------

@pytest.fixture(scope="module")
def unsplit():
    """(engine, result) of the 10-lane N = 12 grid in one group."""
    eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cpu",
                           strategies=STRATEGIES)
    assert eng.batched and eng.lanes_per_group() >= 10
    return eng, eng.run_grid(**GROUP_GRID)


@pytest.mark.parametrize("budget,size", [("GRID_ROW_BYTES", 3), ("GRID_PAIR_BYTES", 4)])
def test_a_grid_in_lane_groups_is_the_unsplit_grid_bit_for_bit(unsplit, monkeypatch, budget,
                                                                size):
    eng, want = unsplit
    per_lane = {"GRID_ROW_BYTES": eng.cohort_size * flat_size_of(eng.param_spec) * 4,
                "GRID_PAIR_BYTES": 5 * 4 * eng.fl.num_clients ** 2}[budget]
    monkeypatch.setattr(engine, budget, size * per_lane + per_lane // 2)
    assert eng.lanes_per_group() == size
    seen = []
    lanes_of = eng._lanes

    def spy(group, *device):
        lanes = lanes_of(group, *device)
        seen.append((len(group), int(lanes.rows.counts.shape[0]),
                     len({(st, seed, sc == "platoon") for st, _, seed, sc in group})))
        return lanes

    monkeypatch.setattr(eng, "_lanes", spy)
    got = eng.run_grid(**GROUP_GRID)
    sizes = [s for s, _, _ in seen]
    assert len(sizes) >= 3 and sum(sizes) == 10 and sizes[-1] < size
    assert all(s == size for s in sizes[:-1])
    assert all(rows == unique for _, rows, unique in seen)  # de-duplicated within a group
    assert got.runs == want.runs
    assert_metrics_bitwise(got.metrics, want.metrics, f"grouped by {budget}")


@pytest.mark.parametrize("n,strategies,lanes", [
    (4096, ("contextual", "gossip", "network"), 12),  # the pair tables bind
    (4096, ("greedy", "contextual", "gossip"), 2),  # K = N: the trainer's rows bind
    (2048, ("contextual", "gossip", "network"), 24),
])
def test_lane_groups_at_fl_mnist_mlp_width(n, strategies, lanes):
    fl = FLConfig(num_clients=n, samples_per_client=32, batch_size=32, num_clusters=5,
                  local_epochs=1)
    eng = ExperimentEngine(get_config("fl-mnist-mlp"), fl, "mnist", strategies=strategies,
                           device="cpu", warmup=False)
    assert eng.batched
    assert min(eng.lanes_per_group(), 24) == lanes
    runs = [(st, "fedavg", 0, sc) for st in strategies for sc in range(8)]
    groups = eng._groups(runs)
    assert [r for g in groups for r in g] == runs and max(map(len, groups)) <= lanes
    loop = dataclasses.replace(fl, num_clients=messages.DENSE_MAX_N + 1)
    assert not ExperimentEngine(get_config("fl-mnist-mlp"), loop, "mnist",
                                strategies=strategies, device="cpu", warmup=False).batched
