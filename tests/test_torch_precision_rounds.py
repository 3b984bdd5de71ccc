"""One round of each bf16 lane of the port against the JAX round, from an injected state.

A JAX ``RoundState`` / ``RoundData`` of the bf16 lane (N=20, 64 samples
each, a 32-unit MLP, warmed up by JAX) passes into the port through
``convert``, bf16 leaves as their bits; one round runs on each side:

* the flat ``("fedavg",)`` lane (the main path at ``--dtype bfloat16``),
  at round 4 so the round ends with a re-clustering;
* fedadam and ``stale`` at CR 0.7 (stragglers);
* fedbuff in a round that both drains the bf16 ring and parks in it;
* the streamed two-tier lane (K=7 in chunks of 3, bf16 rows, bf16 chunk
  partials and carry) under fedbuff, also in a drain-and-park round;
* fedadam with a bf16 master (``param_dtype="bfloat16"``).

Integers exact: ``n_selected``, ``n_succeeded``, ``n_buffered``,
``n_drained``, the reporting cohort (``sketch_age``), clusters and the
ring's mask.  The economics (``sim_time``, ``duration``, the ring's times
and weights) as ``test_torch_bridge.REGISTRY_ROUND_TOL`` holds them in the
fp32 lane: the bf16 lane prices the halved upload by the same expressions.
The model-side floats within ``ULPS`` bf16 ulps of the leaf's largest
magnitude: the clients' forward passes run in bf16 on both sides, and
torch and XLA round a bf16 product or sum at other places (XLA keeps some
fused intermediates in fp32), so an update row may differ by an ulp that
the server step carries on; measured, the worst leaf sits at about half an
ulp.  Test accuracy within one of the 2,000 test images, loss rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scenarios import scenario_config as jscenario_config
from repro.core.scenarios import scenario_params as jscenario_params
from repro.fl.aggregators import AGGREGATOR_ORDER as JAGGREGATOR_ORDER
from repro.fl.rounds import flat_spec_of
from repro.fl.rounds import make_round_step as jmake_round_step
from repro.sharding import split_params
from repro.utils import tree_bytes
from repro_torch import convert
from repro_torch.config import FLConfig
from repro_torch.core.scenarios import scenario_config, scenario_params
from repro_torch.fl import rounds
from repro_torch.fl.aggregators import AGGREGATOR_ORDER, FEDBUFF_IDX, STALE_IDX
from test_torch_bridge import (  # noqa: F401  (_one_thread: autouse fixture)
    REGISTRY_ROUND_TOL,
    _one_thread,
    data_to_numpy,
    jax_experiment,
    small_fl_kwargs,
    small_models,
    state_to_numpy,
)

N = 20
ULPS = 2
FEDADAM_IDX = AGGREGATOR_ORDER.index("fedadam")
MODEL_LEAVES = ("params", "opt_m", "opt_v", "buf_delta", "sketches")
ECONOMICS = ("sim_time", "duration", "buf_arrive", "buf_sent", "buf_weight")


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of ``x`` (0 for an all-zero leaf)."""
    top = float(np.abs(x).max()) if x.size else 0.0
    return 0.0 if top == 0.0 else 2.0 ** (np.floor(np.log2(top)) - 7)


def _assert_bf16_round_matches(tm, ts, jm, js):
    for f in ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained"):
        assert int(getattr(tm, f)) == int(getattr(jm, f)), f
    ref, got = state_to_numpy(js), convert.state_to_numpy(ts)
    for f in ("sketch_age", "clusters", "buf_mask"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    for f in ("params", "buf_delta"):  # the carry keeps the reference's dtypes
        assert str(getattr(ts, f).dtype) == f"torch.{ref[f].dtype.name}", f
    for f in MODEL_LEAVES:
        want = ref[f].astype(np.float32)
        np.testing.assert_allclose(got[f], want, rtol=0.0, atol=ULPS * _bf16_ulp(want),
                                   err_msg=f)
    for f in ECONOMICS:
        a, b = (got[f], ref[f]) if f in got else (float(getattr(tm, f)), float(getattr(jm, f)))
        rtol, atol = REGISTRY_ROUND_TOL[f]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f)
    assert abs(float(tm.test_acc) - float(jm.test_acc)) <= 5e-4
    np.testing.assert_allclose(float(tm.test_loss), float(jm.test_loss), rtol=1e-4)


def _env(**kw):
    """Both sides' full-registry round programs for one bf16 config."""
    state, data, fl, api = jax_experiment(n_clients=N, **kw)
    spec_tree = jax.eval_shape(lambda k: split_params(api.init(k))[0], jax.random.key(0))
    mb = float(tree_bytes(spec_tree))
    jstep = jax.jit(jmake_round_step(api.loss, fl, fl.n_select, mb, flat_spec_of(spec_tree),
                                     ("contextual",), aggregators=JAGGREGATOR_ORDER))
    _, tapi = small_models()
    tfl = FLConfig(**small_fl_kwargs(N, **kw))
    tstep = rounds.make_round_step(tapi.loss, tfl, tfl.n_select, mb, tapi.spec,
                                   ("contextual",), aggregators=AGGREGATOR_ORDER)
    scn = (jscenario_params(jscenario_config("ring", num_vehicles=N)),
           scenario_params(scenario_config("ring", num_vehicles=N)))
    return dict(state=state, data=data, jstep=jstep, tstep=tstep, scn=scn)


def _one_round(env, rule, state):
    """One round of ``rule`` from the JAX ``state`` on both sides."""
    jscn, scn = env["scn"]
    js, jm = env["jstep"](state, jscn, jnp.int32(0), jnp.int32(rule), env["data"], True)
    ts = convert.state_from_numpy(state_to_numpy(state))
    td = convert.data_from_numpy(data_to_numpy(env["data"]))
    assert ts.buf_delta.dtype == torch.bfloat16  # the ring crossed as bf16 bits
    ts2, tm = env["tstep"](ts, scn, 0, rule, td, True)
    _assert_bf16_round_matches(tm, ts2, jm, js)
    return jm


def _drain_and_park_state(env, rule):
    """The JAX state before a round of ``rule`` that both drains and parks."""
    jscn = env["scn"][0]
    state = env["state"]
    for _ in range(10):
        prev = state
        state, m = env["jstep"](prev, jscn, jnp.int32(0), jnp.int32(rule), env["data"], True)
        if int(m.n_drained) > 0 and int(m.n_buffered) > 0:
            return prev
    raise AssertionError("no drain-and-park round in 10")


@pytest.fixture(scope="module")
def flat_env():
    """The flat lane at CR 0.7, K = 7, a fill threshold of 1 (fedbuff drains)."""
    return _env(compute_dtype="bfloat16", connection_rate=0.7, select_fraction=0.35,
                buffer_fill=1)


def test_flat_fedavg_round_matches_the_jax_round(flat_env):
    """At round 4: new round 5 re-clusters on the bf16 lane's sketches."""
    state = flat_env["state"]._replace(round=jnp.int32(4))
    jm = _one_round(flat_env, 0, state)
    assert int(jm.n_succeeded) > 0


@pytest.mark.parametrize("rule", [FEDADAM_IDX, STALE_IDX])
def test_flat_rule_round_matches_the_jax_round(flat_env, rule):
    """From the state after one JAX round of the rule (moments moved)."""
    js, _ = flat_env["jstep"](flat_env["state"], flat_env["scn"][0], jnp.int32(0),
                              jnp.int32(rule), flat_env["data"], True)
    _one_round(flat_env, rule, js)


def test_flat_fedbuff_round_that_drains_and_parks(flat_env):
    _one_round(flat_env, FEDBUFF_IDX, _drain_and_park_state(flat_env, FEDBUFF_IDX))


def test_streamed_fedbuff_round_that_drains_and_parks():
    """The streamed two-tier lane: K = 7 in chunks of 3 (the last padded by
    2), bf16 rows reduced into bf16 per-RSU partials with a bf16 carry."""
    env = _env(compute_dtype="bfloat16", connection_rate=0.5, select_fraction=0.35,
               buffer_fill=1, hierarchical=True, client_block=3)
    _one_round(env, FEDBUFF_IDX, _drain_and_park_state(env, FEDBUFF_IDX))
    js, _ = env["jstep"](env["state"], env["scn"][0], jnp.int32(0), jnp.int32(0),
                         env["data"], True)
    _one_round(env, 0, js)


def test_bf16_master_fedadam_round_matches_the_jax_round():
    """``param_dtype="bfloat16"``: the server step reads and writes a bf16
    master (moments fp32), from the state after one JAX fedadam round."""
    env = _env(compute_dtype="bfloat16", param_dtype="bfloat16", connection_rate=0.7,
               select_fraction=0.35)
    assert env["state"].params.dtype == jnp.bfloat16
    js, _ = env["jstep"](env["state"], env["scn"][0], jnp.int32(0), jnp.int32(FEDADAM_IDX),
                         env["data"], True)
    _one_round(env, FEDADAM_IDX, js)
