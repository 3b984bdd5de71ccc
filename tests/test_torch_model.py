"""The port's MLP and local trainer against the JAX package.

The flat layout must be JAX's exactly (sorted-key leaf order, ``(in, out)``
weights): a JAX-initialised vector round-trips bit for bit.  Logits, loss
and the cohort's ``(K, P)`` update vectors match within float tolerance:
the matmuls and their gradients sum in another order in torch, and XLA
contracts the SGD step into FMAs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.client import make_local_trainer as jmake_local_trainer
from repro.sharding import split_params
from repro.utils import flatten_to_vector as jflatten
from repro_torch import convert
from repro_torch.fl.client import make_local_trainer
from repro_torch.utils import prng
from repro_torch.utils.pytree import flat_spec_of, flatten_to_vector, unflatten_from_vector
from test_torch_bridge import _one_thread, small_models, tree_to_numpy  # noqa: F401


@pytest.mark.parametrize("d_ff", [32, 200])
def test_flat_layout_round_trips_a_jax_init_exactly(d_ff):
    api, tapi = small_models(d_ff)
    tree = split_params(api.init(jax.random.key(3)))[0]
    vec, (_, shapes, _) = jflatten(tree)
    vec = np.asarray(vec)
    port_tree = convert.params_tree_from_numpy(tree_to_numpy(tree))
    assert flat_spec_of(port_tree) == tapi.spec
    assert [s for _, s in tapi.spec] == [tuple(s) for s in shapes]
    flat = flatten_to_vector(port_tree)
    np.testing.assert_array_equal(flat.numpy(), vec)
    back = unflatten_from_vector(torch.from_numpy(vec.copy()), tapi.spec)
    np.testing.assert_array_equal(back["fc1"]["w"].numpy(), np.asarray(tree["fc1"]["w"]))
    np.testing.assert_array_equal(flatten_to_vector(back).numpy(), vec)


def test_port_init_matches_jax_init():
    api, tapi = small_models(32)
    jk = jax.random.key(4)
    ref = np.asarray(jflatten(split_params(api.init(jk))[0])[0])
    got = flatten_to_vector(tapi.init(prng.wrap_key_data(np.asarray(jax.random.key_data(jk))),
                                      "cpu"))
    # truncated normals agree to a few ulps (tests/test_torch_prng.py)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    return images, labels


def test_logits_and_loss_match():
    api, tapi = small_models(32)
    tree = split_params(api.init(jax.random.key(5)))[0]
    images, labels = _batch(48, 0)
    from repro.models.cnn import cnn_logits

    ref_logits = cnn_logits(tree, api.cfg, jnp.asarray(images))
    ref_loss, ref_m = api.loss(tree, {"images": jnp.asarray(images), "labels": jnp.asarray(labels)})
    port = convert.params_tree_from_numpy(tree_to_numpy(tree))
    from repro_torch.models.mlp import mlp_logits

    logits = mlp_logits(port, torch.from_numpy(images))
    loss, m = tapi.loss(port, {"images": torch.from_numpy(images),
                               "labels": torch.from_numpy(labels.astype(np.int64))})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    assert float(m["accuracy"]) == float(ref_m["accuracy"])


@pytest.mark.parametrize("epochs,n,bs", [(1, 64, 64), (3, 64, 16)])
def test_cohort_updates_match(epochs, n, bs):
    """(K, P) update vectors from the same params, data and key."""
    api, tapi = small_models(32)
    tree = split_params(api.init(jax.random.key(6)))[0]
    K = 5
    rng = np.random.default_rng(epochs)
    images = rng.normal(size=(K, n, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, (K, n)).astype(np.int32)
    jk = jax.random.key(7)
    _, ref = jmake_local_trainer(api.loss, 0.05, epochs, bs)(
        tree, jnp.asarray(images), jnp.asarray(labels), jk)
    _, got = make_local_trainer(tapi.loss, 0.05, epochs, bs)(
        convert.params_tree_from_numpy(tree_to_numpy(tree)), torch.from_numpy(images),
        torch.from_numpy(labels.astype(np.int64)),
        prng.wrap_key_data(np.asarray(jax.random.key_data(jk))))
    assert got.shape == (K, ref.shape[1])
    ref = np.asarray(ref)
    # updates are ~1e-3; gradients sum in another order: 1e-4 of the largest
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())


def test_unported_trainer_lanes_raise():
    """The bf16 compute lane trains: the forward in bf16 inside the
    differentiated closure, fp32 gradients into the fp32 SGD state, as
    ``repro.fl.client`` does.  The
    updates stay fp32 and sit within 2% of the largest of JAX's (both sides
    round every bf16 product, at different places: XLA keeps some fused
    intermediates in fp32), and differ from the fp32 trainer's."""
    api, tapi = small_models(32)
    tree = split_params(api.init(jax.random.key(6)))[0]
    K, n, bs = 4, 32, 16
    rng = np.random.default_rng(9)
    images = rng.normal(size=(K, n, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, (K, n)).astype(np.int32)
    jk = jax.random.key(7)
    _, ref = jmake_local_trainer(api.loss, 0.05, 2, bs, compute_dtype=jnp.bfloat16)(
        tree, jnp.asarray(images), jnp.asarray(labels), jk)
    args = (convert.params_tree_from_numpy(tree_to_numpy(tree)), torch.from_numpy(images),
            torch.from_numpy(labels.astype(np.int64)),
            prng.wrap_key_data(np.asarray(jax.random.key_data(jk))))
    _, got = make_local_trainer(tapi.loss, 0.05, 2, bs, compute_dtype=torch.bfloat16)(*args)
    _, fp32 = make_local_trainer(tapi.loss, 0.05, 2, bs)(*args)
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=0.02 * np.abs(ref).max())
    assert not torch.equal(got, fp32)
