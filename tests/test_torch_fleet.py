"""The port's fleet-size geometry against its dense forms and the JAX package.

Above ``messages.DENSE_MAX_N`` vehicles the neighbour search is the windowed
search on the sorted ring (``messages.nearest_windowed``) and the fusion
sums a compact ``(object, slot)`` table; below it both are the dense
``(N, N)`` forms.  What is held:

* the windowed search gives the dense search's distances and object ids
  exactly, and JAX's ``emit_cpms`` object ids, at N in {8, 9, 17, 18, 200,
  2000} (the window wrapping onto itself up to N = 17), for uniform
  positions, a cluster across the ring's wrap point, and duplicated
  positions on both sides of vehicles, where the dense recompute must run;
* ``emit_cpms`` on the windowed form against JAX's: ``obj`` and ``valid``
  exactly, the noisy kinematics within rtol 1e-5 / atol 1e-5 (XLA and torch
  round a few ulps apart, as in ``test_torch_core``);
* the compact fusion against the dense one and JAX's ``fuse_kinematics``
  within rtol 1e-5 / atol 1e-4 (positions of ~1e4 m), at the same sizes;
* which form runs is decided by the threshold, pinned at 4,096;
* one fleet-shaped streamed round (N=300 with the threshold lowered to 100,
  2 samples per client, K=30 in chunks of 8, no warm-up) from an injected
  JAX state matches the JAX round through ``assert_round_matches``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as jfu
from repro.core import messages as jmsg
from repro.core import scenarios as jsc
from repro.core import twin as jtw
from repro.fl.rounds import flat_spec_of
from repro.fl.rounds import make_round_step as jmake_round_step
from repro.sharding import split_params
from repro.utils import tree_bytes
from repro_torch import convert
from repro_torch.config import FLConfig
from repro_torch.core import fusion, messages, scenarios
from repro_torch.core.twin import TwinState
from repro_torch.fl import rounds
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

RTOL, ATOL = 1e-5, 1e-5
L = 10_000.0  # the ring scenario's length
SIZES = [8, 9, 17, 18, 200, 2000]
_jinit = jax.jit(jtw.init_twin_state)
_jcams, _jcpms = jax.jit(jmsg.emit_cams), jax.jit(jmsg.emit_cpms)
_jfuse = jax.jit(jfu.fuse_kinematics)


def _positions(n, mode, seed=0):
    rng = np.random.default_rng(seed * 1009 + n)
    pos = rng.uniform(0.0, L, n).astype(np.float32)
    if mode == "wrap":  # a cluster straddling the wrap point
        pos = np.mod(rng.uniform(-15.0, 15.0, n), L).astype(np.float32)
    elif mode == "dup":
        # vehicles stacked at equal positions on both sides of vehicle 0,
        # and a second half that repeats positions of the first
        pos[1:7] = pos[0] + 4.0
        pos[7:13] = pos[0] - 4.0
        pos[n // 2:] = pos[rng.integers(0, n // 2, n - n // 2)]
        pos = np.mod(pos, L).astype(np.float32)
    return pos


def _twins(n, pos, seed=1):
    """(JAX twin, port twin, JAX scn, port scn) on the ring at ``pos``."""
    jscn = jsc.scenario_params(jsc.scenario_config("ring", num_vehicles=n))
    st = _jinit(jscn, jax.random.key(seed))._replace(pos=jnp.asarray(pos))
    tst = TwinState(*[torch.from_numpy(np.array(x)) for x in st])
    return st, tst, jscn, scenarios.scenario_params(scenarios.scenario_config("ring",
                                                                              num_vehicles=n))


def tkey(jk):
    return prng.wrap_key_data(np.asarray(jax.random.key_data(jk)))


@pytest.mark.parametrize("mode", ["uniform", "wrap", "dup"])
@pytest.mark.parametrize("n", SIZES)
def test_windowed_search_equals_the_dense_search_and_jax(n, mode):
    pos = _positions(n, mode)
    st, tst, jscn, _ = _twins(n, pos)
    before = messages.dense_rows
    dist, obj = messages.nearest_windowed(torch.from_numpy(pos), torch.tensor(L), 8)
    recomputed = messages.dense_rows - before
    d_dense, o_dense = messages.nearest_dense(torch.from_numpy(pos), torch.tensor(L), 8)
    assert torch.equal(obj, o_dense) and torch.equal(dist, d_dense)
    want = _jcpms(st, jscn, jax.random.key(0))["obj"]
    np.testing.assert_array_equal(obj.numpy(), np.asarray(want))
    if mode == "dup" and n > 17:
        assert recomputed > 0  # the tie reaches past the window
    if n <= 17:
        assert recomputed == 0  # every vehicle is inside the window


@pytest.mark.parametrize("n", [18, 200, 2000])
def test_windowed_emit_cpms_matches_jax(n, monkeypatch):
    monkeypatch.setattr(messages, "DENSE_MAX_N", 0)
    st, tst, jscn, tscn = _twins(n, _positions(n, "dup", seed=3))
    jk = jax.random.key(5)
    want = _jcpms(st, jscn, jk)
    got = messages.emit_cpms(tst, tscn, tkey(jk))
    for k in ("src", "obj", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("pos", "speed", "accel", "var"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["uniform", "dup"])
@pytest.mark.parametrize("n", SIZES)
def test_compact_fusion_matches_the_dense_fusion_and_jax(n, mode, monkeypatch):
    st, _, jscn, tscn = _twins(n, _positions(n, mode, seed=7))
    jk = jax.random.key(9)
    cams, cpms = _jcams(st, jscn, jk), _jcpms(st, jscn, jk)
    want = _jfuse(cams, cpms, jscn)
    to_t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    monkeypatch.setattr(messages, "DENSE_MAX_N", n)
    dense = fusion.fuse_kinematics(to_t(cams), to_t(cpms), tscn)
    monkeypatch.setattr(messages, "DENSE_MAX_N", 0)
    compact = fusion.fuse_kinematics(to_t(cams), to_t(cpms), tscn)
    for name, a, b, c in zip(("pos", "speed", "accel", "pos_var"), compact, dense, want):
        assert a.dtype == torch.float32 and a.shape == (n,)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=RTOL, atol=1e-4,
                                   err_msg=name)


def test_the_threshold_picks_the_form(monkeypatch):
    assert messages.DENSE_MAX_N == 4096
    calls = []
    for name in ("nearest_dense", "nearest_windowed"):
        real = getattr(messages, name)
        monkeypatch.setattr(messages, name,
                            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    _, tst, _, tscn = _twins(30, _positions(30, "uniform"))
    monkeypatch.setattr(messages, "DENSE_MAX_N", 30)
    messages.emit_cpms(tst, tscn, prng.key(0))
    monkeypatch.setattr(messages, "DENSE_MAX_N", 29)
    messages.emit_cpms(tst, tscn, prng.key(0))
    assert calls == ["nearest_dense", "nearest_windowed"]


def test_fleet_shaped_streamed_round_matches_the_jax_round(monkeypatch):
    """The fleet bench's settings at N=300: 2 samples per client, batch 2,
    8 clusters, 64-wide sketches, K=30 in chunks of 8, no warm-up."""
    monkeypatch.setattr(messages, "DENSE_MAX_N", 100)
    n = 300
    kw = dict(samples_per_client=2, batch_size=2, num_clusters=8, sketch_dim=64,
              select_fraction=0.1, hierarchical=True, client_block=8)
    state, data, fl, api = jax_experiment(n_clients=n, warmup=False, **kw)
    spec_tree = jax.eval_shape(lambda k: split_params(api.init(k))[0], jax.random.key(0))
    mb = float(tree_bytes(spec_tree))
    jstep = jax.jit(jmake_round_step(api.loss, fl, fl.n_select, mb, flat_spec_of(spec_tree),
                                     ("contextual",), aggregators=("fedavg",)))
    jscn = jsc.scenario_params(jsc.scenario_config("ring", num_vehicles=n))
    js, jm = jstep(state, jscn, jnp.int32(0), jnp.int32(0), data, True)
    _, tapi = small_models()
    tfl = FLConfig(**small_fl_kwargs(n, **kw))
    assert tfl.n_select == 30
    tstep = rounds.make_round_step(tapi.loss, tfl, tfl.n_select, mb, tapi.spec,
                                   ("contextual",))
    ts, tm = tstep(convert.state_from_numpy(state_to_numpy(state)),
                   scenarios.scenario_params(scenarios.scenario_config("ring", num_vehicles=n)),
                   0, 0, convert.data_from_numpy(data_to_numpy(data)), True)
    assert int(jm.n_selected) > 0
    assert_round_matches(tm, ts, jm, js)
