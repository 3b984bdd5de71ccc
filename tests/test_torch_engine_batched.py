"""The batched grid round against the JAX package's engine, lane for lane.

One reference ``run_grid`` and one port ``run_grid`` of a ``("fedavg",)``
grid with all five strategies x seed 0 x scenarios ``("ring", "platoon")``
(the MLP of ``tests/test_engine.py``, N = 12, CR 0.7, ``recluster_every``
2, 3 rounds, ``eval_every`` 2) are computed once per module.  The port's
engine takes the batched round (one round of every lane at once; with
``greedy`` in the engine every lane trains K = N slots, and the strategy
switch picks each lane's mask on the device).  Tolerance as in
``tests/test_torch_engine.py``: integers equal, floats within rtol 2e-4,
atol 1e-5, NaN where the reference has NaN.

Which path an engine takes: engines up to ``messages.DENSE_MAX_N`` = 4,096
clients the batched round, flat or two-tier, whatever their registry;
larger fleets the lane loop; decided once, in ``__init__``, with no
argument of its own.
"""
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.config import ModelConfig as JModelConfig
from repro.fl.engine import ExperimentEngine as JEngine
from repro_torch.config import FLConfig, ModelConfig
from repro_torch.fl import ExperimentEngine, engine, rounds
from repro_torch.fl.aggregators import AGGREGATOR_ORDER
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import FL, MLP, N, assert_lane_matches

STRATEGIES = ("greedy", "gossip", "data", "network", "contextual")
GRID = dict(seeds=(0,), scenarios=("ring", "platoon"), rounds=3, eval_every=2)
LANES = len(STRATEGIES) * 2


@pytest.fixture(scope="module")
def grids():
    """(port engine, port result, reference metrics and runs) of the grid."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = JEngine(JModelConfig(**MLP), JFLConfig(**FL), "mnist", strategies=STRATEGIES,
                      aggregators=("fedavg",)).run_grid(**GRID)
        ref = jax.tree_util.tree_map(np.asarray, ref.metrics), ref.runs
        eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cpu",
                               strategies=STRATEGIES)
        return eng, eng.run_grid(**GRID), ref
    finally:
        torch.set_num_threads(prev)


def test_the_five_strategy_grid_takes_the_batched_round(grids):
    eng, res, (_, ref_runs) = grids
    assert eng.batched and eng.cohort_size == N
    assert res.runs == [tuple(r) for r in ref_runs] and len(res.runs) == LANES
    for f in res.metrics._fields:
        assert getattr(res.metrics, f).shape == (LANES, GRID["rounds"]), f


@pytest.mark.parametrize("g", range(LANES))
def test_batched_lane_matches_the_reference(grids, g):
    _, res, (ref, ref_runs) = grids
    assert_lane_matches(type(res.metrics)(*[x[g] for x in res.metrics]),
                        type(ref)(*[x[g] for x in ref]), str(ref_runs[g]))


def test_batched_grid_exercises_every_strategy_and_the_eval_schedule(grids):
    _, res, _ = grids
    m = res.metrics
    n_sel = {s: int(m.n_selected[res.index_of(s, 0, "ring")].sum()) for s in STRATEGIES}
    assert n_sel["greedy"] > n_sel["gossip"] > 0  # greedy takes every connected client
    assert bool((m.n_succeeded <= m.n_selected).all())
    assert bool(torch.isnan(m.test_acc[:, 0]).all()) and bool(torch.isfinite(m.test_acc[:, 1:]).all())
    assert int(m.n_buffered.sum()) == int(m.n_drained.sum()) == 0


def test_run_single_through_the_batched_round_is_its_grid_row_bitwise(grids):
    eng, res, _ = grids
    single = eng.run_single("data", 0, "platoon", rounds=GRID["rounds"],
                            eval_every=GRID["eval_every"])
    row = res.records("data", 0, "platoon")
    for a, b in zip(single, row):
        for f, x in a.__dict__.items():
            y = getattr(b, f)
            assert x == y or (np.isnan(x) and np.isnan(y)), (f, x, y)


# ---- which path an engine takes ---------------------------------------------------

def _engine(**fl_kw):
    kw = {k: fl_kw.pop(k) for k in ("aggregators", "strategies") if k in fl_kw}
    return ExperimentEngine(ModelConfig(**MLP), FLConfig(**dict(FL, **fl_kw)), "mnist",
                            device="cpu", warmup=False, **kw)


@pytest.mark.parametrize("kw,batched", [
    (dict(), True),
    (dict(strategies=STRATEGIES), True),
    (dict(compute_dtype="bfloat16"), True),
    (dict(num_clients=1024), True),
    (dict(num_clients=1025), True),
    (dict(num_clients=4096), True),
    (dict(aggregators=("fedbuff",)), True),
    (dict(aggregators=("fedavg", "fedadam")), True),
    (dict(aggregators=("fedadam",)), True),
    (dict(hierarchical=True), True),
    (dict(hierarchical=True, client_block=4), True),
    (dict(hierarchical=True, client_block=4, num_clients=1025), True),
    (dict(hierarchical=True, client_block=4, num_clients=4096), True),
    (dict(hierarchical=True, client_block=4, num_clients=4097), False),
    (dict(num_clients=4097), False),
])
def test_the_engine_picks_its_path_once_from_registry_lane_and_size(kw, batched):
    eng = _engine(**kw)
    assert eng.batched is batched
    assert hasattr(eng, "_grid_step") is batched
    lanes = eng._lanes([("contextual", eng.aggregators[0], 0, "ring")]) \
        if eng.fl.num_clients == N else None
    if lanes is not None:
        assert isinstance(lanes, engine._GridLanes if batched else engine._Lanes)


def test_no_argument_chooses_the_path():
    """No constructor argument picks the batched round or the lane loop
    (``processes`` picks how a sharded grid's shards run, not the round)."""
    params = list(inspect.signature(ExperimentEngine.__init__).parameters)
    assert params == ["self", "model_cfg", "fl_cfg", "dataset", "strategies", "num_clients",
                      "aggregators", "warmup", "device", "mesh", "processes"]


def test_the_batched_round_refuses_lanes_it_does_not_serve():
    fl = FLConfig(**FL)
    for bad in (dataclasses.replace(fl, num_clients=4097),
                dataclasses.replace(fl, hierarchical=True, client_block=4, num_clients=4097)):
        with pytest.raises(ValueError, match="batched grid round"):
            rounds.make_grid_round_step(None, bad, N, 1.0, [], STRATEGIES)
    with pytest.raises(ValueError, match="client_block"):  # streaming needs two tiers
        rounds.make_grid_round_step(None, dataclasses.replace(fl, client_block=4), N, 1.0, [],
                                    STRATEGIES)
    assert rounds.grid_round_fits(fl, ("fedavg",))
    assert rounds.grid_round_fits(fl, ("fedavg", "fedbuff"))
    assert rounds.grid_round_fits(dataclasses.replace(fl, hierarchical=True), ("fedavg",))
    assert rounds.grid_round_fits(dataclasses.replace(fl, hierarchical=True, client_block=4),
                                  AGGREGATOR_ORDER)
    for n in (1025, 4096):
        assert rounds.grid_round_fits(dataclasses.replace(fl, num_clients=n), ("fedbuff",))
    assert not rounds.grid_round_fits(dataclasses.replace(fl, num_clients=4097), ("fedbuff",))
