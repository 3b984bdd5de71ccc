"""The slice as a whole: one port ``round_step`` against the JAX ``round_step``.

A JAX ``RoundState`` / ``RoundData`` (N=20 clients, 64 samples each, a
32-unit MLP, warmed up, at round 4 so the round ends with a re-clustering)
is injected into the port through ``convert``; one round runs on each side,
for each of the five strategies at CR 1.0 and 0.7.  Integers must match
exactly: ``n_selected``, ``n_succeeded``, the elected cohort, the reporting
cohort (``sketch_age``) and the new clusters.  Floats match within the
tolerances below: XLA contracts multiply-adds into FMAs and orders sums
differently from torch, a few ulps per op that the round compounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import fusion as jfu
from repro.core import messages as jmsg
from repro.core import selection as jsel
from repro.core.scenarios import scenario_config as jscenario_config
from repro.core.scenarios import scenario_params as jscenario_params
from repro.fl.rounds import STRATEGY_ORDER as JSTRATEGY_ORDER
from repro.fl.rounds import cohort_size_for as jcohort_size_for
from repro.fl.rounds import flat_spec_of
from repro.fl.rounds import make_round_step as jmake_round_step
from repro.kernels import ref as jref
from repro.sharding import split_params
from repro.utils import fold_in_str, tree_bytes
from repro_torch import convert
from repro_torch.config import FLConfig
from repro_torch.core.fusion import fuse_kinematics
from repro_torch.core.messages import emit_cams, emit_cpms
from repro_torch.core.scenarios import scenario_config, scenario_params
from repro_torch.core.selection import STRATEGIES
from repro_torch.fl import rounds
from repro_torch.kernels.rttg_latency import rttg_latency
from repro_torch.utils import prng
from test_torch_bridge import (  # noqa: F401  (_one_thread: autouse fixture)
    _one_thread,
    data_to_numpy,
    jax_experiment,
    small_fl_kwargs,
    small_models,
    state_to_numpy,
)

N = 20
FLOAT_TOL = {  # (rtol, atol) per compared float leaf
    "params": (0.0, 1e-6),
    "sketches": (0.0, 1e-5),
    "sim_time": (1e-5, 1e-6),
    "twin.t": (1e-5, 1e-6),
    "twin.pos": (1e-6, 1e-2),  # positions ~1e4 m: an ulp there is ~1e-3
    "twin.speed": (1e-5, 1e-5),
    "twin.accel": (1e-5, 1e-5),
    "duration": (1e-5, 1e-6),
    "mean_pred_latency": (1e-5, 1e-6),
    "mean_real_latency": (1e-5, 1e-6),
    "test_acc": (0.0, 1e-6),
    "test_loss": (1e-5, 1e-6),
}


@pytest.fixture(scope="module", params=[1.0, 0.7], ids=["cr1.0", "cr0.7"])
def env(request):
    """Both sides' round programs for every strategy (one JAX compile per CR)."""
    cr = request.param
    state, data, fl, api = jax_experiment(connection_rate=cr)
    state = state._replace(round=jnp.int32(4))  # new_round 5: re-cluster
    spec_tree = jax.eval_shape(lambda k: split_params(api.init(k))[0], jax.random.key(0))
    mb = float(tree_bytes(spec_tree))
    K = jcohort_size_for(fl, JSTRATEGY_ORDER)
    jstep = jax.jit(jmake_round_step(api.loss, fl, K, mb, flat_spec_of(spec_tree)))
    _, tapi = small_models()
    tfl = FLConfig(**small_fl_kwargs(N, connection_rate=cr))
    tstep = rounds.make_round_step(tapi.loss, tfl, K, mb, tapi.spec)
    return dict(state=state, data=data, jstep=jstep, tstep=tstep, cr=cr)


def _elected(jstate, strategy):
    """The elected cohort of round ``jstate.round`` on both sides, stage by stage
    (fusion -> predicted geometry -> election; no forced CR mask)."""
    fl = FLConfig(**small_fl_kwargs(N))
    n_select, gamma = fl.n_select, fl.gamma
    jscn = jscenario_params(jscenario_config("ring", num_vehicles=N))
    rk = jax.random.fold_in(jstate.key, jstate.round)
    k_obs = fold_in_str(rk, "observe")
    pos, speed, accel, _ = jfu.fuse_kinematics(jmsg.emit_cams(jstate.twin, jscn, k_obs),
                                               jmsg.emit_cpms(jstate.twin, jscn, k_obs), jscn)
    lat, conn = jref.rttg_latency(pos, speed, accel, jstate.twin.t, 636_040.0, None, jscn, True)
    ref = jsel.STRATEGIES[strategy](fold_in_str(rk, strategy), conn, lat,
                                    jstate.clusters, n_select, gamma)
    ts = convert.state_from_numpy(state_to_numpy(jstate))
    scn = scenario_params(scenario_config("ring", num_vehicles=N))
    tk = prng.fold_in(ts.key, ts.round)
    t_obs = prng.fold_in_str(tk, "observe")
    fused = fuse_kinematics(emit_cams(ts.twin, scn, t_obs), emit_cpms(ts.twin, scn, t_obs), scn)
    tlat, tconn = rttg_latency(*fused[:3], ts.twin.t, 636_040.0, None, scn, predict=True)
    got = STRATEGIES[strategy](prng.fold_in_str(tk, strategy), tconn, tlat,
                               ts.clusters, n_select, gamma)
    return np.flatnonzero(np.asarray(ref)), np.flatnonzero(got.numpy())


@pytest.mark.parametrize("strategy", JSTRATEGY_ORDER)
def test_one_round_matches_the_jax_round(env, strategy):
    sidx = JSTRATEGY_ORDER.index(strategy)
    state, data = env["state"], env["data"]
    zero = jnp.zeros((), jnp.int32)
    js, jm = env["jstep"](state, jscenario_params(jscenario_config("ring", num_vehicles=N)),
                          jnp.int32(sidx), zero, data, True)
    ts = convert.state_from_numpy(state_to_numpy(state))
    td = convert.data_from_numpy(data_to_numpy(data))
    scn = scenario_params(scenario_config("ring", num_vehicles=N))
    ts2, tm = env["tstep"](ts, scn, sidx, 0, td, True)

    for f in ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained"):
        assert int(getattr(tm, f)) == int(getattr(jm, f)), f
    ref, got = state_to_numpy(js), convert.state_to_numpy(ts2)
    np.testing.assert_array_equal(got["sketch_age"], ref["sketch_age"])  # who reported
    np.testing.assert_array_equal(got["clusters"], ref["clusters"])
    np.testing.assert_array_equal(got["twin"]["lane"], ref["twin"]["lane"])
    assert int(got["round"]) == int(ref["round"]) == 5
    for name, (rtol, atol) in FLOAT_TOL.items():
        if name.startswith("twin."):
            a, b = got["twin"][name[5:]], ref["twin"][name[5:]]
        elif name in got:
            a, b = got[name], ref[name]
        else:
            a, b = float(getattr(tm, name)), float(getattr(jm, name))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("strategy", JSTRATEGY_ORDER)
def test_elected_cohort_indices_match(env, strategy):
    ref, got = _elected(env["state"], strategy)
    np.testing.assert_array_equal(got, ref)
    assert len(got) > 0
