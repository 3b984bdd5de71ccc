"""The port's experiment engine: the fleet lane's form against the JAX
package's engine, and the engine against the port's own ``FLSimulation``.

The fleet form is ``benchmarks/engine_throughput.py::fleet``'s engine at
N = 12: two-tier aggregation with the cohort streamed in chunks of 4
(``client_block``), no warm-up, one lane, 2 rounds.  Tolerance as in
``tests/test_torch_engine.py``: integers equal, floats within rtol 2e-4,
atol 1e-5, NaN where the reference has NaN.

Against ``FLSimulation``: the first lane of each data row is the
simulation of the same (strategy, seed, scenario) bit for bit, when both
build the same round step (no ``greedy`` in the engine, the registry
``(fl.aggregator,)``, eval every round).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.config import ModelConfig as JModelConfig
from repro.fl.engine import ExperimentEngine as JEngine
from repro_torch.config import FLConfig, ModelConfig, TrafficConfig
from repro_torch.core.scenarios import scenario_config
from repro_torch.fl import ExperimentEngine, FLSimulation
from repro_torch.utils import prng
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import FL, MLP, N, assert_lane_matches

# engine_throughput.py::fleet's FLConfig at N = 12 (its select_fraction
# formula gives the whole fleet: K = 12 in 3 chunks of 4)
FLEET = dict(num_clients=N, samples_per_client=2, batch_size=2, num_clusters=8,
             local_epochs=1, sketch_dim=64, select_fraction=1.0, hierarchical=True,
             client_block=4)
FLEET_ENGINE = dict(strategies=("contextual",), aggregators=("fedavg",), warmup=False)
FLEET_GRID = dict(seeds=(0,), scenarios=("ring",), rounds=2, eval_every=2)


def test_fleet_lane_matches_the_reference():
    ref = JEngine(JModelConfig(**MLP), JFLConfig(**FLEET), "mnist", **FLEET_ENGINE)
    ref = ref.run_grid(**FLEET_GRID)
    eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FLEET), "mnist", device="cpu",
                           **FLEET_ENGINE)
    got = eng.run_grid(**FLEET_GRID)
    assert got.runs == [tuple(r) for r in ref.runs] == [("contextual", "fedavg", 0, "ring")]
    assert eng.cohort_size == N and eng.fl.client_block == 4
    ref_m = jax.tree_util.tree_map(np.asarray, ref.metrics)
    assert_lane_matches(type(got.metrics)(*[x[0] for x in got.metrics]),
                        type(ref_m)(*[x[0] for x in ref_m]), "fleet lane")
    assert bool(torch.isnan(got.metrics.test_acc[0, 0])) and got.metrics.n_selected.min() > 0


def _same(a, b) -> bool:
    return all(x == y or (np.isnan(x) and np.isnan(y))
               for x, y in zip(a.__dict__.values(), b.__dict__.values()))


@pytest.mark.parametrize("aggregator", ["fedavg", "fedbuff"])
def test_first_lane_of_each_data_row_is_the_simulation_bitwise(aggregator):
    fl = FLConfig(**dict(FL, aggregator=aggregator))
    eng = ExperimentEngine(ModelConfig(**MLP), fl, "mnist", device="cpu",
                           strategies=("contextual", "gossip"), aggregators=(aggregator,))
    scenarios = ("ring", "platoon")
    res = eng.run_grid(seeds=(0,), scenarios=scenarios, rounds=2, eval_every=1)
    for strategy in eng.strategies:
        for scenario in scenarios:
            sim = FLSimulation(ModelConfig(**MLP), fl, scenario_config(scenario, num_vehicles=N),
                               "mnist", strategy, prng.key(0), device="cpu")
            want = sim.run(2)
            got = res.records(strategy, 0, scenario)
            assert all(_same(a, b) for a, b in zip(got, want)), (strategy, scenario, got, want)


def test_lanes_sharing_a_data_row_read_it_by_reference(monkeypatch):
    """ring and urban_grid share their (strategy, seed) row; platoon has its own."""
    from repro_torch.fl import engine

    built = []
    real = engine.make_round_data
    monkeypatch.setattr(engine, "make_round_data",
                        lambda *a, **kw: built.append(a[0]) or real(*a, **kw))
    eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cpu")
    res = eng.run_grid(seeds=(0, 1), scenarios=("ring", "urban_grid", "platoon"), rounds=1)
    assert len(res.runs) == 6 and len(built) == 4  # per seed: the shared row, platoon's


def test_custom_scenarios_are_labelled_by_position():
    eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cpu",
                           warmup=False)
    dense = TrafficConfig(num_vehicles=N, ring_length_m=4_000.0, rsu_spacing_m=400.0)
    res = eng.run_grid(seeds=(0,), scenarios=(TrafficConfig(num_vehicles=N), "ring", dense),
                       rounds=1)
    assert [r[3] for r in res.runs] == ["custom-0", "ring", "custom-2"]
    assert res.records("contextual", 0, "custom-2")[0].round == 1


def test_grid_refuses_scenarios_whose_static_fields_differ():
    """As the reference's ``stack_scenarios`` does, before any lane is built."""
    eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cpu",
                           warmup=False)
    two_lanes = TrafficConfig(num_vehicles=N, num_lanes=2)
    with pytest.raises(ValueError, match="static fields"):
        eng.run_grid(seeds=(0,), scenarios=("ring", two_lanes), rounds=1)


def test_engine_without_a_device_argument_needs_a_card():
    """The engine runs on cuda by default and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cuda")


def test_the_engine_adopts_num_clients():
    eng = ExperimentEngine(ModelConfig(**MLP), dataclasses.replace(FLConfig(**FL), num_clients=7),
                           "mnist", device="cpu", num_clients=N, warmup=False)
    assert eng.fl.num_clients == N
    assert len(eng.run_grid(seeds=(0,), scenarios=("ring",), rounds=1).runs) == 1
