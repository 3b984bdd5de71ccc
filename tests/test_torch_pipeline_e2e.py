"""The pipeline end to end against the JAX package: the quickstart and the unfused round.

``python -m repro_torch.launch.quickstart`` runs ``examples/quickstart.py``'s
sequence (twin, the selector's four stages, one FedAvg round at N=40) and
must print the same stage lines, elect the same clients and find the same
cluster sizes.  The unfused round lane (``make_round_step(fused=False)``:
the RTTG API composed stage by stage) runs one round from an injected JAX
state for each strategy against the JAX unfused round, within
``REGISTRY_ROUND_TOL``; on the CPU the port's fused round, which runs the
plain ``rttg_latency``, is the unfused round bit for bit.
"""
import contextlib
import io
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scenarios as jsc
from repro.fl.rounds import STRATEGY_ORDER as JSTRATEGY_ORDER
from repro.fl.rounds import cohort_size_for as jcohort_size_for
from repro.fl.rounds import flat_spec_of
from repro.fl.rounds import make_round_step as jmake_round_step
from repro.sharding import split_params
from repro.utils import tree_bytes
from repro_torch import convert
from repro_torch.config import FLConfig
from repro_torch.configs import get_config
from repro_torch.core import messages, scenarios
from repro_torch.fl import rounds
from repro_torch.fl.simulation import FLSimulation
from repro_torch.launch import quickstart
from repro_torch.utils import prng
from test_torch_bridge import (  # noqa: F401  (_one_thread: autouse fixture)
    _one_thread,
    assert_round_matches,
    data_to_numpy,
    jax_experiment,
    small_fl_kwargs,
    small_models,
    state_to_numpy,
)

N = 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the quickstart, end to end ------------------------------------------------

def test_quickstart_matches_the_jax_example():
    """``examples/quickstart.py`` and ``python -m repro_torch.launch.quickstart``:
    the same stage lines, elected ids and cluster sizes; accuracies on the
    2,000 test images within 2e-3 (a logit near a tie may flip a few
    images: the model init and data agree to a few ulps, not bitwise)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        g = runpy.run_path(os.path.join(ROOT, "examples", "quickstart.py"))
    ref_lines = out.getvalue().splitlines()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = quickstart.run(device="cpu")
    lines = out.getvalue().splitlines()
    assert lines[:-1] == ref_lines[:-1]
    assert got["elected"] == np.asarray(g["idx"]).tolist() and got["elected"]
    assert got["cluster_sizes"] == np.asarray(g["sizes"]).tolist()
    assert got["acc_before"] == pytest.approx(float(g["before"]), abs=2e-3)
    assert got["acc_after"] == pytest.approx(float(g["after"]), abs=2e-3)
    np.testing.assert_allclose(got["latency_pred"].numpy(),
                               np.asarray(g["sel"]["latency_pred"]), rtol=1e-5, atol=1e-5)


def test_quickstart_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])


# ---- the unfused round lane ------------------------------------------------------

@pytest.fixture(scope="module")
def unfused_env():
    """The JAX unfused round at CR 0.7 from round 4 (it ends re-clustering)."""
    state, data, fl, api = jax_experiment(connection_rate=0.7)
    state = state._replace(round=jnp.int32(4))
    spec_tree = jax.eval_shape(lambda k: split_params(api.init(k))[0], jax.random.key(0))
    mb = float(tree_bytes(spec_tree))
    K = jcohort_size_for(fl, JSTRATEGY_ORDER)
    jstep = jax.jit(jmake_round_step(api.loss, fl, K, mb, flat_spec_of(spec_tree),
                                     fused=False))
    _, tapi = small_models()
    tfl = FLConfig(**small_fl_kwargs(N, connection_rate=0.7))
    tstep = rounds.make_round_step(tapi.loss, tfl, K, mb, tapi.spec, fused=False)
    return dict(state=state, data=data, jstep=jstep, tstep=tstep)


@pytest.mark.parametrize("strategy", JSTRATEGY_ORDER)
def test_unfused_round_matches_the_jax_unfused_round(unfused_env, strategy):
    env = unfused_env
    sidx = JSTRATEGY_ORDER.index(strategy)
    zero = jnp.zeros((), jnp.int32)
    jscn = jsc.scenario_params(jsc.scenario_config("ring", num_vehicles=N))
    js, jm = env["jstep"](env["state"], jscn, jnp.int32(sidx), zero, env["data"], True)
    ts = convert.state_from_numpy(state_to_numpy(env["state"]))
    td = convert.data_from_numpy(data_to_numpy(env["data"]))
    scn = scenarios.scenario_params(scenarios.scenario_config("ring", num_vehicles=N))
    ts2, tm = env["tstep"](ts, scn, sidx, 0, td, True)
    assert int(tm.n_selected) > 0
    assert_round_matches(tm, ts2, jm, js)


def _assert_bitwise(a, b):
    (sa, ma), (sb, mb) = a, b
    for f in sa._fields:
        x, y = getattr(sa, f), getattr(sb, f)
        if f == "twin":
            assert all(torch.equal(p, q) for p, q in zip(x, y)), f
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        else:
            assert x == y, f
    for f in ma._fields:
        x, y = getattr(ma, f), getattr(mb, f)
        assert torch.equal(x, y) or bool(torch.isnan(x).all() and torch.isnan(y).all()), f


@pytest.mark.parametrize("scenario,cr,hierarchical", [("ring", 1.0, False), ("ring", 0.7, False),
                                                      ("rsu_outage", 0.7, True)])
def test_fused_and_unfused_rounds_are_bitwise_equal_on_the_cpu(scenario, cr, hierarchical):
    """Through the plain ``rttg_latency`` the fused lane is the unfused
    composition itself: every state leaf and metric bit for bit."""
    fl = FLConfig(**small_fl_kwargs(N, connection_rate=cr, hierarchical=hierarchical))
    sim = FLSimulation(get_config("fl-mnist-mlp").replace(d_ff=32), fl,
                       scenarios.scenario_config(scenario, num_vehicles=N), "mnist",
                       "contextual", prng.key(0), device="cpu")
    sim.warmup_sketches()
    unfused = rounds.make_round_step(sim.api.loss, fl, rounds.cohort_size_for(fl, ("contextual",)),
                                     sim.model_bytes, sim.param_spec, ("contextual",),
                                     fused=False)
    state = sim.state
    for _ in range(2):
        a = sim._step(state, sim.scn, 0, 0, sim.data, True)
        b = unfused(state, sim.scn, 0, 0, sim.data, True)
        _assert_bitwise(a, b)
        state = a[0]
    assert int(a[1].n_selected) > 0


def test_unfused_lane_refuses_fleet_sizes(monkeypatch):
    _, tapi = small_models()
    fl = FLConfig(**small_fl_kwargs(N))
    rounds.make_round_step(tapi.loss, fl, 2, 1.0, tapi.spec, fused=False)
    monkeypatch.setattr(messages, "DENSE_MAX_N", N - 1)
    with pytest.raises(ValueError, match="fused=True"):
        rounds.make_round_step(tapi.loss, fl, 2, 1.0, tapi.spec, fused=False)
    rounds.make_round_step(tapi.loss, fl, 2, 1.0, tapi.spec, fused=True)

