"""The CNN datasets through the port's round paths, on the CPU.

One ``round_step`` of a narrow CIFAR-10 CNN (``channels=(4, 8)``,
``d_ff=16``, N = 8 clients of 32 samples) from a JAX ``RoundState`` /
``RoundData`` injected through ``convert``, against the reference round.
The reference CNN's gradient fails to linearize under ``jax.jit`` with the
installed JAX (ROADMAP.md queue C), so its warm-up and round run under
``jax.disable_jit()``, op by op.  Then the engine's batched sweep against its
lane loop on flat and two-tier lanes, and ``fl_sim.run_experiment`` on
CIFAR-10 and SVHN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.config import FLConfig
from repro_torch.configs import get_config
from repro_torch.core.scenarios import scenario_config, scenario_params
from repro_torch.fl import ExperimentEngine, rounds
from repro_torch.fl.aggregators import AGGREGATOR_ORDER
from repro_torch.launch import fl_sim
from test_torch_bridge import (  # noqa: F401  (_one_thread: autouse fixture)
    REGISTRY_ROUND_TOL,
    _one_thread,
    assert_round_matches,
    data_to_numpy,
    state_to_numpy,
)
from test_torch_engine_batched_loop import state_lane

NARROW = dict(channels=(4, 8), d_ff=16)
N = 8
FL = dict(num_clients=N, samples_per_client=32, batch_size=16, local_epochs=1, num_clusters=3)


def test_one_round_from_an_injected_jax_state_matches_the_reference():
    """A warmed-up JAX state, one contextual round on each side: integers
    exact, floats within ``REGISTRY_ROUND_TOL``.  (Op by op, the reference's
    k-means takes ~10 s a clustering, so the round is one that does not
    re-cluster; the warm-up clusters once.)"""
    from repro.config import FLConfig as JFLConfig
    from repro.configs import get_config as jget_config
    from repro.core.scenarios import scenario_config as jscenario_config
    from repro.core.scenarios import scenario_params as jscenario_params
    from repro.fl.rounds import (experiment_key, flat_spec_of, init_state_traced,
                                 make_round_data, make_round_step, make_warmup)
    from repro.models import build_model as jbuild_model
    from repro.sharding import split_params
    from repro.utils import tree_bytes
    from repro_torch.models import build_model

    jfl = JFLConfig(**FL)
    api = jbuild_model(jget_config("fl-cifar10-cnn").replace(**NARROW))
    init_params = lambda k: split_params(api.init(k))[0]
    tc = jscenario_config("ring", num_vehicles=N)
    key = experiment_key("cifar10", "contextual", 0)
    spec_tree = jax.eval_shape(init_params, jax.random.key(0))
    spec, mb = flat_spec_of(spec_tree), float(tree_bytes(spec_tree))
    state, regions = jax.jit(lambda k: init_state_traced(init_params, jfl, tc, k))(key)
    data = make_round_data(key, "cifar10", jfl, regions)
    K = 2
    with jax.disable_jit():
        state = make_warmup(api.loss, jfl, spec)(state, data)
        js, jm = make_round_step(api.loss, jfl, K, mb, spec, strategies=("contextual",))(
            state, jscenario_params(tc), jnp.int32(0), jnp.int32(0), data, True)

    tapi = build_model(get_config("fl-cifar10-cnn").replace(**NARROW))
    assert mb == 4.0 * sum(int(np.prod(s)) for _, s in tapi.spec)
    tstep = rounds.make_round_step(tapi.loss, FLConfig(**FL), K, mb, tapi.spec,
                                   strategies=("contextual",))
    ts, tm = tstep(convert.state_from_numpy(state_to_numpy(state)),
                   scenario_params(scenario_config("ring", num_vehicles=N)), 0, 0,
                   convert.data_from_numpy(data_to_numpy(data)), True)
    assert int(tm.n_succeeded) > 0 and not bool(torch.isnan(tm.test_acc))
    assert_round_matches(tm, ts, jm, js, REGISTRY_ROUND_TOL)


# the engine tests' tolerance (tests/test_torch_engine.py): the grouped
# convolution sums a model's channels in an order that depends on how many
# models it holds, so the batched round's G * K models and the lane loop's K
# differ in the last places of every conv (up to ~1e-5 of logits of order 1
# on the CPU) and the two paths are not bit for bit as the MLP's are
GRID_RTOL, GRID_ATOL = 2e-4, 1e-5
INTS = ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained")
# (registry, the lanes' rules, FL config)
CASES = {
    "flat, fedavg": (("fedavg",), ("fedavg",), dict(FL)),
    "flat, full registry, CR 0.7": (AGGREGATOR_ORDER, ("fedadam", "fedbuff"),
                                    dict(FL, connection_rate=0.7)),
    "two-tier streamed in 2 chunks": (("fedavg",), ("fedavg",),
                                      dict(FL, select_fraction=0.5, hierarchical=True,
                                           client_block=2)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_batched_sweep_matches_the_lane_loop(name):
    registry, rules, fl = CASES[name]
    eng = ExperimentEngine(get_config("fl-cifar10-cnn").replace(**NARROW), FLConfig(**fl),
                           "cifar10", device="cpu", strategies=("contextual", "gossip"),
                           aggregators=registry)
    assert eng.batched
    # one (strategy, seed) data row: its 2,000 test images are most of the set-up
    runs = [("contextual", a, 0, sc) for a in rules for sc in ("ring", "rsu_outage")]
    batched, loop = eng._lanes(runs), eng._lane_list(runs)
    got, want = eng._sweep(batched, 2, 2), eng._sweep(loop, 2, 2)
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f in INTS:
            assert torch.equal(a, b), f
        else:
            torch.testing.assert_close(a, b, rtol=GRID_RTOL, atol=GRID_ATOL, equal_nan=True,
                                       msg=f)
    assert bool(torch.isfinite(got.test_acc[:, -1]).all())
    for g, run in enumerate(runs):
        lane = state_lane(batched.state, g)
        for f in ("sketch_age", "clusters", "buf_mask"):
            assert torch.equal(getattr(lane, f), getattr(loop.states[g], f)), (run, f)
        torch.testing.assert_close(lane.params, loop.states[g].params, rtol=GRID_RTOL,
                                   atol=GRID_ATOL, msg=str(run))


@pytest.mark.parametrize("dataset", ["cifar10", "svhn"])
def test_fl_sim_runs_the_cnn_datasets(dataset):
    out = fl_sim.run_experiment(dataset, "contextual", 2, num_clients=10, samples_per_client=64,
                                device="cpu")
    assert out["dataset"] == dataset and len(out["rounds"]) == 2
    assert all(np.isfinite(r["test_acc"]) and np.isfinite(r["test_loss"])
               for r in out["rounds"])
    assert out["rounds"][-1]["n_succeeded"] > 0
