"""JAX <-> port bridge for the port's tests, and the ``convert`` round trips.

The helpers here turn the JAX package's arrays and NamedTuples into numpy
(the half ``repro_torch.convert`` leaves to the caller) and compare a port
round with a JAX round; the other ``test_torch_*`` files import them.  The
tests hold ``convert`` to its contract: weights and a whole ``RoundState`` /
``RoundData`` pass from JAX through numpy into the port and back with every
leaf unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert


@pytest.fixture(autouse=True)
def _one_thread():
    """Six xdist workers share the CPU: one torch thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tree_to_numpy(tree):
    """A JAX pytree of dicts/lists/arrays -> the same structure of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


def state_to_numpy(state) -> dict:
    """A JAX ``RoundState`` -> dict of numpy arrays (the key as its uint32 words)."""
    d = {f: np.asarray(getattr(state, f)) for f in state._fields if f not in ("twin", "key")}
    d["twin"] = {f: np.asarray(getattr(state.twin, f)) for f in state.twin._fields}
    d["key"] = np.asarray(jax.random.key_data(state.key))
    return d


def data_to_numpy(data) -> dict:
    return {f: np.asarray(getattr(data, f)) for f in data._fields}


def small_fl_kwargs(n_clients=20, **kw):
    """The CPU tests' size: N=20 clients, 64 samples each, one epoch."""
    base = dict(num_clients=n_clients, samples_per_client=64, batch_size=64,
                local_epochs=1, num_clusters=3)
    base.update(kw)
    return base


def small_models(d_ff=32):
    """(JAX api, port api) for fl-mnist-mlp narrowed to ``d_ff`` hidden units."""
    from repro.configs import get_config
    from repro.models import build_model
    from repro_torch.configs import get_config as tget_config
    from repro_torch.models import build_model as tbuild_model

    api = build_model(get_config("fl-mnist-mlp").replace(d_ff=d_ff))
    tapi = tbuild_model(tget_config("fl-mnist-mlp").replace(d_ff=d_ff))
    return api, tapi


def jax_experiment(strategy="contextual", scenario="ring", n_clients=20, d_ff=32,
                   warmup=True, **fl_kw):
    """A JAX (state, data, fl, api) for one small experiment, warmed up."""
    from repro.config import FLConfig
    from repro.core.scenarios import scenario_config
    from repro.fl.rounds import (
        experiment_key, flat_spec_of, init_state_traced, make_round_data, make_warmup,
    )
    from repro.sharding import split_params

    fl = FLConfig(**small_fl_kwargs(n_clients, **fl_kw))
    api, _ = small_models(d_ff)
    init_params = lambda k: split_params(api.init(k))[0]
    tc = scenario_config(scenario, num_vehicles=n_clients)
    key = experiment_key("mnist", strategy, 0)
    state, regions = jax.jit(lambda k: init_state_traced(init_params, fl, tc, k))(key)
    data = make_round_data(key, "mnist", fl, regions)
    if warmup:
        spec = flat_spec_of(jax.eval_shape(init_params, jax.random.key(0)))
        state = jax.jit(make_warmup(api.loss, fl, spec))(state, data)
    return state, data, fl, api


REGISTRY_ROUND_TOL = {  # (rtol, atol) per compared float leaf
    # the adaptive rules' step m / (sqrt(v) + tau) magnifies the ulp-level
    # drift of the cohort sum by up to (1 - beta1) / tau
    "params": (0.0, 5e-6),
    "opt_m": (0.0, 1e-8),
    "opt_v": (1e-5, 1e-12),
    "buf_delta": (0.0, 1e-7),
    "buf_arrive": (1e-6, 1e-5),
    "buf_sent": (1e-6, 1e-5),
    "buf_weight": (0.0, 0.0),  # sample counts
    "sketches": (0.0, 1e-5),
    "sim_time": (1e-5, 1e-6),
    "duration": (1e-5, 1e-6),
    "test_acc": (0.0, 1e-6),
    "test_loss": (1e-5, 1e-6),
}


def assert_round_matches(tm, ts, jm, js, tol=None):
    """Integers exact, floats within ``tol`` (default ``REGISTRY_ROUND_TOL``):
    one port round against one JAX round (``tm``/``ts`` port metrics and
    state, ``jm``/``js`` JAX)."""
    for f in ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained"):
        assert int(getattr(tm, f)) == int(getattr(jm, f)), f
    ref, got = state_to_numpy(js), convert.state_to_numpy(ts)
    for f in ("sketch_age", "clusters", "buf_mask"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    for name, (rtol, atol) in (tol or REGISTRY_ROUND_TOL).items():
        a, b = (got[name], ref[name]) if name in got else \
            (float(getattr(tm, name)), float(getattr(jm, name)))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def test_round_state_round_trip_is_exact():
    """JAX RoundState -> numpy -> port -> numpy: every leaf, the key words
    and every dtype unchanged."""
    state, data, _, _ = jax_experiment(warmup=False)
    state = state._replace(round=jnp.int32(3), sim_time=jnp.float32(12.25))
    ref = state_to_numpy(state)
    ported = convert.state_from_numpy(ref)
    assert ported.round == 3 and ported.key.dtype == torch.int64
    back = convert.state_to_numpy(ported)
    assert set(back) == set(ref)
    for name, a in ref.items():
        if name == "twin":
            for f, x in a.items():
                assert back[name][f].dtype == x.dtype, f
                np.testing.assert_array_equal(back[name][f], x, err_msg=f)
        else:
            assert back[name].dtype == a.dtype, name
            np.testing.assert_array_equal(back[name], a, err_msg=name)


def test_round_data_round_trip_is_exact():
    _, data, _, _ = jax_experiment(warmup=False)
    ref = data_to_numpy(data)
    back = convert.data_to_numpy(convert.data_from_numpy(ref))
    for name, a in ref.items():
        assert back[name].dtype == a.dtype, name
        np.testing.assert_array_equal(back[name], a, err_msg=name)


def test_params_tree_and_vector_convert_to_the_same_flat_vector():
    from repro.sharding import split_params
    from repro.utils import flatten_to_vector

    api, _ = small_models()
    tree = split_params(api.init(jax.random.key(5)))[0]
    vec = np.asarray(flatten_to_vector(tree)[0])
    from_tree = convert.params_from_numpy(tree_to_numpy(tree))
    from_vec = convert.params_from_numpy(vec)
    np.testing.assert_array_equal(from_tree.numpy(), vec)
    np.testing.assert_array_equal(from_vec.numpy(), vec)
    with pytest.raises(ValueError):
        convert.params_from_numpy(vec.reshape(2, -1))
