"""An engine grid on Dirichlet client shards against the JAX package's, lane for lane.

One reference ``run_grid`` and one port ``run_grid`` of the same 4-lane grid
(``("contextual",)`` x ``("fedavg",)`` x seeds ``(0, 1)`` x scenarios
``("ring", "rush_hour")``, 2 rounds, ``eval_every`` 1; the MLP of
``tests/test_engine.py``, N = 12, ``dirichlet_alpha`` 0.5), computed once per
module; the port's takes the batched round.  Tolerance as
``test_torch_engine.py``'s: integers equal, floats within rtol 2e-4, atol
1e-5.  Each lane's client labels equal the reference's ``make_round_data``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.config import ModelConfig as JModelConfig
from repro.core import scenarios as jscenarios
from repro.fl import rounds as jrounds
from repro.fl.engine import ExperimentEngine as JEngine
from repro_torch.config import FLConfig, ModelConfig
from repro_torch.fl import ExperimentEngine
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import MLP, assert_lane_matches

FL = dict(num_clients=12, samples_per_client=64, local_epochs=1, num_clusters=4,
          batch_size=32, dirichlet_alpha=0.5)
ENGINE = dict(strategies=("contextual",))
GRID = dict(seeds=(0, 1), scenarios=("ring", "rush_hour"), rounds=2, eval_every=1)
LANES = 4


@pytest.fixture(scope="module")
def grids():
    """(port engine, port result, reference metrics as numpy, reference runs)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = JEngine(JModelConfig(**MLP), JFLConfig(**FL), "mnist", **ENGINE).run_grid(**GRID)
        eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cpu",
                               **ENGINE)
        return eng, eng.run_grid(**GRID), jax.tree_util.tree_map(np.asarray, ref.metrics), \
            ref.runs
    finally:
        torch.set_num_threads(prev)


def test_grid_takes_the_batched_round_in_the_reference_order(grids):
    eng, res, _, ref_runs = grids
    assert eng.batched
    assert res.runs == [tuple(r) for r in ref_runs] and len(res.runs) == LANES


@pytest.mark.parametrize("g", range(LANES))
def test_grid_lane_matches_the_reference(grids, g):
    _, res, ref, ref_runs = grids
    assert_lane_matches(type(res.metrics)(*[x[g] for x in res.metrics]),
                        type(ref)(*[x[g] for x in ref]), str(ref_runs[g]))
    assert bool(torch.isfinite(res.metrics.test_acc[g]).all())


@pytest.mark.parametrize("seed,scenario", [(0, "ring"), (1, "rush_hour")])
def test_lane_labels_are_the_reference_dirichlet_shards(grids, seed, scenario):
    eng = grids[0]
    _, data, _, _ = eng.init_run("contextual", seed, scenario)
    jkey = jrounds.experiment_key("mnist", "contextual", seed)
    jscn = jscenarios.scenario_params(jscenarios.scenario_config(scenario, num_vehicles=12))
    want = jrounds.make_round_data(jkey, "mnist", JFLConfig(**FL),
                                   jrounds.derive_regions(jkey, jscn))
    np.testing.assert_array_equal(data.labels.numpy(), np.asarray(want.labels))
    # Dirichlet(0.5) shards: some client holds more than the default's 2 classes
    counts = np.stack([np.bincount(r, minlength=10) for r in np.asarray(want.labels)])
    assert (counts > 0).sum(1).max() > 2
