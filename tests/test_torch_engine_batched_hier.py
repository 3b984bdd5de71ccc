"""The batched grid round on the two-tier lanes against the JAX package's
engine, lane for lane.

Two grids, each one reference ``run_grid`` and one port ``run_grid``
computed once per module (the MLP of ``tests/test_engine.py``):

* the reference's hierarchical smoke probe
  (``benchmarks/engine_throughput.py::smoke``: ``hierarchical=True``,
  ``client_block=3``, ``warmup=False``, contextual x the six rules x
  ``("rush_hour", "rsu_outage")``, seed 0, 1 round), at the bench's N = 20
  (32 samples, batches of 16, 4 clusters, K = 2: one chunk of three slots,
  the last a padding slot): 12 lanes, every one through the buffered server
  step (the registry holds ``fedbuff``), ``rsu_outage``'s dark RSUs
  dropping their clients;
* a streamed grid of several chunks: N = 12, K = 5 (``select_fraction``
  0.42), ``client_block=2`` (3 chunks, the last padded), CR 0.7,
  ``("fedavg", "fedadam", "fedbuff")`` x ``("ring", "rsu_outage")``, 3
  rounds, eval every 2, with the warm-up.

The port's engines take the batched round.  Tolerance as in
``tests/test_torch_engine.py``: integers equal, floats within rtol 2e-4,
atol 1e-5, NaN where the reference has NaN.
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
from repro_torch.core.rttg import rsu_up_mask
from repro_torch.fl import ExperimentEngine
from repro_torch.fl.aggregators import AGGREGATOR_ORDER
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import FL, MLP, assert_lane_matches

# engine_throughput.py::smoke's FLConfig at the bench's N = 20, two-tier
PROBE_FL = dict(num_clients=20, samples_per_client=32, batch_size=16, num_clusters=4,
                local_epochs=1, hierarchical=True, client_block=3)
PROBE = dict(strategies=("contextual",), aggregators=AGGREGATOR_ORDER, warmup=False)
PROBE_GRID = dict(seeds=(0,), scenarios=("rush_hour", "rsu_outage"), rounds=1, eval_every=1)
STREAMED_FL = dict(FL, select_fraction=0.42, hierarchical=True, client_block=2)
STREAMED = dict(strategies=("contextual",), aggregators=("fedavg", "fedadam", "fedbuff"))
STREAMED_GRID = dict(seeds=(0,), scenarios=("ring", "rsu_outage"), rounds=3, eval_every=2)
GRIDS = {"probe": (PROBE_FL, PROBE, PROBE_GRID), "streamed": (STREAMED_FL, STREAMED,
                                                             STREAMED_GRID)}
LANES = {"probe": 12, "streamed": 6}


@pytest.fixture(scope="module")
def grids():
    """name -> (port engine, port result, reference metrics and runs)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, (fl, engine, grid) in GRIDS.items():
            ref = JEngine(JModelConfig(**MLP), JFLConfig(**fl), "mnist", **engine).run_grid(**grid)
            ref = jax.tree_util.tree_map(np.asarray, ref.metrics), ref.runs
            eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**fl), "mnist", device="cpu",
                                   **engine)
            out[name] = eng, eng.run_grid(**grid), ref
        return out
    finally:
        torch.set_num_threads(prev)


@pytest.mark.parametrize("name", list(GRIDS))
def test_the_two_tier_grid_takes_the_batched_round(grids, name):
    eng, res, (_, ref_runs) = grids[name]
    fl = GRIDS[name][0]
    assert eng.batched and eng.fl.hierarchical and eng.fl.client_block == fl["client_block"]
    assert res.runs == [tuple(r) for r in ref_runs] and len(res.runs) == LANES[name]
    assert -(-eng.cohort_size // fl["client_block"]) == (1 if name == "probe" else 3)


@pytest.mark.parametrize("name,g", [(n, g) for n in GRIDS for g in range(LANES[n])])
def test_batched_two_tier_lane_matches_the_reference(grids, name, g):
    _, res, (ref, ref_runs) = grids[name]
    assert_lane_matches(type(res.metrics)(*[x[g] for x in res.metrics]),
                        type(ref)(*[x[g] for x in ref]), f"{name} {ref_runs[g]}")


def test_the_probe_runs_dark_rsus_on_rsu_outage(grids):
    """The probe's rsu_outage lanes carry dark RSUs in their lane view (the
    rush_hour lanes none), and every lane elected and evaluated."""
    eng, res, _ = grids["probe"]
    live = rsu_up_mask(eng._lanes(res.runs).scn)
    outage = torch.tensor([r[3] == "rsu_outage" for r in res.runs])
    assert not bool(live[outage].all()) and bool(live[~outage].all())
    m = res.metrics
    assert int(m.n_selected.min()) > 0 and bool(torch.isfinite(m.test_acc).all())


def test_the_streamed_fedbuff_lanes_park(grids):
    _, res, _ = grids["streamed"]
    fedbuff = torch.tensor([r[1] == "fedbuff" for r in res.runs])
    assert int(res.metrics.n_buffered[fedbuff].sum()) > 0
    assert int(res.metrics.n_buffered[~fedbuff].sum()) == 0


def test_a_two_tier_grid_over_the_gridded_limit_keeps_the_lane_loop():
    from repro_torch.core.messages import DENSE_MAX_N

    fl = FLConfig(**dict(STREAMED_FL, num_clients=DENSE_MAX_N + 1))
    eng = ExperimentEngine(ModelConfig(**MLP), fl, "mnist", device="cpu", **STREAMED)
    assert not eng.batched
    for n in (1025, DENSE_MAX_N):  # above one block of B1g, and its limit
        small = dataclasses.replace(fl, num_clients=n)
        assert ExperimentEngine(ModelConfig(**MLP), small, "mnist", device="cpu",
                                **STREAMED).batched
