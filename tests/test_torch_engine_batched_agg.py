"""The batched grid round under the full aggregator registry against the JAX
package's engine, lane for lane.

One reference ``run_grid`` and one port ``run_grid`` of a grid with every
rule of the catalog (``("fedavg", "fedavgm", "fedadam", "fedyogi",
"stale", "fedbuff")``) x strategies ``("greedy", "contextual")`` x seed 0 x
scenarios ``("ring", "platoon")`` (the MLP of ``tests/test_engine.py``, N =
12, CR 0.7, ``recluster_every`` 2, 3 rounds, ``eval_every`` 2) are computed
once per module: 24 lanes.  The port's engine takes the batched round: each
lane's rule is a ``(G,)`` device index, the ``stale`` lanes' weights and the
``fedbuff`` lanes' ring are selected per lane, and every lane goes through
the buffered server step (the registry holds ``fedbuff``), whose ring parks
stragglers and drains them.  Tolerance as in ``tests/test_torch_engine.py``:
integers equal, floats within rtol 2e-4, atol 1e-5, NaN where the reference
has NaN.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.config import ModelConfig as JModelConfig
from repro.fl.engine import ExperimentEngine as JEngine
from repro_torch.config import FLConfig, ModelConfig
from repro_torch.fl import ExperimentEngine
from repro_torch.fl.aggregators import AGGREGATOR_ORDER
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import FL, MLP, N, assert_lane_matches

STRATEGIES = ("greedy", "contextual")
SCENARIOS = ("ring", "platoon")
GRID = dict(seeds=(0,), scenarios=SCENARIOS, rounds=3, eval_every=2)
LANES = len(STRATEGIES) * len(AGGREGATOR_ORDER) * len(SCENARIOS)


@pytest.fixture(scope="module")
def grids():
    """(port engine, port result, reference metrics and runs) of the grid."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = JEngine(JModelConfig(**MLP), JFLConfig(**FL), "mnist", strategies=STRATEGIES,
                      aggregators=AGGREGATOR_ORDER).run_grid(**GRID)
        ref = jax.tree_util.tree_map(np.asarray, ref.metrics), ref.runs
        eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cpu",
                               strategies=STRATEGIES, aggregators=AGGREGATOR_ORDER)
        return eng, eng.run_grid(**GRID), ref
    finally:
        torch.set_num_threads(prev)


def test_the_full_registry_grid_takes_the_batched_round(grids):
    eng, res, (_, ref_runs) = grids
    assert eng.batched and eng.cohort_size == N
    assert res.runs == [tuple(r) for r in ref_runs] and len(res.runs) == LANES
    lanes = eng._lanes([("contextual", a, 0, "ring") for a in AGGREGATOR_ORDER])
    assert lanes.rule_idx.dtype == torch.int32
    assert lanes.rule_idx.tolist() == list(range(len(AGGREGATOR_ORDER)))


@pytest.mark.parametrize("g", range(LANES))
def test_batched_lane_under_its_rule_matches_the_reference(grids, g):
    _, res, (ref, ref_runs) = grids
    assert_lane_matches(type(res.metrics)(*[x[g] for x in res.metrics]),
                        type(ref)(*[x[g] for x in ref]), str(ref_runs[g]))


def test_the_ring_parks_and_drains_on_the_fedbuff_lanes_only(grids):
    _, res, _ = grids
    m = res.metrics
    fedbuff = torch.tensor([r[1] == "fedbuff" for r in res.runs])
    assert int(m.n_buffered[fedbuff].sum()) > 0 and int(m.n_drained[fedbuff].sum()) > 0
    assert int(m.n_buffered[~fedbuff].sum()) == int(m.n_drained[~fedbuff].sum()) == 0


def test_each_lane_runs_its_own_rule(grids):
    """Lanes that share strategy, seed and scenario elect alike in round 1
    but end on different models: every rule's final loss is its own."""
    _, res, _ = grids
    m = res.metrics
    for st in STRATEGIES:
        for sc in SCENARIOS:
            rows = [res.index_of(st, 0, sc, aggregator=a) for a in AGGREGATOR_ORDER]
            assert len({int(m.n_selected[g, 0]) for g in rows}) == 1, (st, sc)
            losses = [float(m.test_loss[g, -1]) for g in rows]
            assert len(set(losses)) >= 4, (st, sc, losses)
