"""The port's CNNs (``fl-cifar10-cnn``, ``fl-svhn-cnn``) against the JAX package.

The flat layout must be JAX's exactly (sorted keys, list items in index
order, HWIO kernels): a JAX-initialised tree round-trips bit for bit.
Logits, loss and the cohort's ``(K, P)`` update vectors match within float
tolerance: the convolutions, matmuls and their gradients sum in another
order in torch, and XLA contracts the SGD step into FMAs.

The reference CNN's gradient cannot be taken under ``jax.jit`` with the
installed JAX (its ``reduce_window`` max-pool fails to linearize, ROADMAP.md
queue C), so the reference trainer runs under ``jax.disable_jit()``: the same
program, op by op.  Narrow CNNs (``channels=(4, 8)``, ``d_ff=16`` for
CIFAR-10's, ``(3, 6)`` and 12 for SVHN's) keep that fast; the layout, init
and forward also run at full width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_image_dataset as jmake_image_dataset
from repro.fl.client import make_local_trainer as jmake_local_trainer
from repro.models.cnn import cnn_logits as jcnn_logits
from repro.sharding import split_params
from repro.utils import flatten_to_vector as jflatten
from repro_torch import convert
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.client import make_local_trainer
from repro_torch.models.cnn import cnn_logits
from repro_torch.utils import prng
from repro_torch.utils.pytree import (flat_size_of, flat_spec_of, flatten_to_vector, tree_cast,
                                      tree_map, unflatten_from_vector)
from test_torch_bridge import _one_thread, tree_to_numpy  # noqa: F401

ARCHS = ("fl-cifar10-cnn", "fl-svhn-cnn")
DATASET = {"fl-cifar10-cnn": "cifar10", "fl-svhn-cnn": "svhn"}
FULL_P = {"fl-cifar10-cnn": 1_070_794, "fl-svhn-cnn": 603_034}
NARROW = {"fl-cifar10-cnn": dict(channels=(4, 8), d_ff=16),
          "fl-svhn-cnn": dict(channels=(3, 6), d_ff=12)}


def cnn_models(arch, narrow=True):
    """(JAX api, port api) for ``arch``, narrowed to ``NARROW`` by default."""
    from repro.configs import get_config
    from repro.models import build_model
    from repro_torch.configs import get_config as tget_config
    from repro_torch.models import build_model as tbuild_model

    kw = NARROW[arch] if narrow else {}
    return (build_model(get_config(arch).replace(**kw)),
            tbuild_model(tget_config(arch).replace(**kw)))


def jax_init(api, seed):
    return split_params(api.init(jax.random.key(seed)))[0]


def port_tree(tree):
    return convert.params_tree_from_numpy(tree_to_numpy(tree))


def _batch(shape, seed, lead=()):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=lead + shape).astype(np.float32)
    labels = rng.integers(0, 10, lead + shape[:1]).astype(np.int32)
    return images, labels


@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_is_the_reference_flat_layout(arch, narrow):
    api, tapi = cnn_models(arch, narrow)
    leaves = jax.tree_util.tree_leaves(
        jax.eval_shape(lambda k: split_params(api.init(k))[0], jax.random.key(0)))
    assert [s for _, s in tapi.spec] == [tuple(x.shape) for x in leaves]
    assert [p for p, _ in tapi.spec] == [
        ("convs", 0, "b"), ("convs", 0, "w"), ("convs", 1, "b"), ("convs", 1, "w"),
        ("fc1", "b"), ("fc1", "w"), ("fc2", "b"), ("fc2", "w")]
    if not narrow:
        assert flat_size_of(tapi.spec) == FULL_P[arch]


@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flat_layout_round_trips_a_jax_init_exactly(arch, narrow):
    api, tapi = cnn_models(arch, narrow)
    tree = jax_init(api, 3)
    vec = np.asarray(jflatten(tree)[0])
    port = port_tree(tree)
    assert isinstance(port["convs"], list) and len(port["convs"]) == 2
    assert flat_spec_of(port) == tapi.spec
    np.testing.assert_array_equal(flatten_to_vector(port).numpy(), vec)
    back = unflatten_from_vector(torch.from_numpy(vec.copy()), tapi.spec)
    assert isinstance(back["convs"], list)
    for i in range(2):
        for leaf in ("b", "w"):
            np.testing.assert_array_equal(back["convs"][i][leaf].numpy(),
                                          np.asarray(tree["convs"][i][leaf]))
    np.testing.assert_array_equal(flatten_to_vector(back).numpy(), vec)
    np.testing.assert_array_equal(convert.params_from_numpy(tree_to_numpy(tree)).numpy(), vec)
    # the numpy carrier gives the same structure back, lists included
    again = convert.tree_to_numpy(port)
    np.testing.assert_array_equal(again["convs"][1]["w"], np.asarray(tree["convs"][1]["w"]))


def test_list_nodes_through_tree_map_and_batched_unflatten():
    """``tree_map`` (and through it ``tree_cast``) walks lists; a batched
    vector unflattens into leaves with the batch dims in front."""
    api, tapi = cnn_models("fl-cifar10-cnn")
    port = port_tree(jax_init(api, 1))
    half = tree_cast(port, torch.bfloat16)
    assert half["convs"][0]["w"].dtype == torch.bfloat16
    doubled = tree_map(lambda a, b: a + b, port, port)
    torch.testing.assert_close(doubled["convs"][1]["w"], 2 * port["convs"][1]["w"],
                               rtol=0, atol=0)
    vec = flatten_to_vector(port)
    stacked = unflatten_from_vector(torch.stack([vec, -vec]), tapi.spec)
    assert stacked["convs"][0]["w"].shape == (2, 3, 3, 3, 4)
    assert stacked["convs"][1]["w"].shape == (2, 3, 3, 4, 8)
    assert torch.equal(flatten_to_vector(stacked, batch_dims=1)[1], -vec)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_jax_init(arch):
    api, tapi = cnn_models(arch, narrow=False)
    jk = jax.random.key(4)
    ref = np.asarray(jflatten(jax_init(api, 4))[0])
    got = flatten_to_vector(tapi.init(prng.wrap_key_data(np.asarray(jax.random.key_data(jk))),
                                      "cpu"))
    # truncated normals agree to a few ulps (tests/test_torch_prng.py); the conv
    # std is a float32 quotient on both sides
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    assert got.shape == (FULL_P[arch],)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match(arch, narrow, dtype):
    api, tapi = cnn_models(arch, narrow)
    tree = jax_init(api, 5)
    images, labels = _batch((24, 32, 32, 3), 0)
    jbatch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    tbatch = {"images": torch.from_numpy(images),
              "labels": torch.from_numpy(labels.astype(np.int64))}
    port = port_tree(tree)
    if dtype == "bfloat16":
        tree = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), tree)
        port = tree_cast(port, torch.bfloat16)
    ref_logits = np.asarray(jcnn_logits(tree, api.cfg, jbatch["images"]).astype(jnp.float32))
    ref_loss, ref_m = api.loss(tree, jbatch)
    logits = cnn_logits(port, tbatch["images"])
    loss, m = tapi.loss(port, tbatch)
    assert logits.dtype == getattr(torch, dtype) and logits.shape == (24, 10)
    scale = np.abs(ref_logits).max()
    if dtype == "float32":
        # the convs and matmuls sum in another order: a few fp32 ulps
        np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        assert float(m["accuracy"]) == float(ref_m["accuracy"])
    else:
        # every activation rounds to bf16 (8 bits) at places that differ
        # between XLA and torch: within 2% of the largest logit, loss 1%
        np.testing.assert_allclose(logits.float().numpy(), ref_logits, rtol=0,
                                   atol=0.02 * scale)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-2)
    assert loss.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_models_match_one_at_a_time(arch):
    """M models with leading-dim leaves against each model alone: the
    grouped convolution sums a model's channels in an order that depends on
    how many models it holds (on the CPU up to ~1e-5 of logits of order 1),
    so 2e-5 of the largest logit.  One model also takes a leading batch of
    batches."""
    api, tapi = cnn_models(arch)
    M = 4
    vecs = torch.stack([flatten_to_vector(port_tree(jax_init(api, s))) for s in range(M)])
    stacked = unflatten_from_vector(vecs, tapi.spec)
    images, labels = _batch((12, 32, 32, 3), 1, lead=(M,))
    images = torch.from_numpy(images)
    got = cnn_logits(stacked, images)
    one = torch.stack([cnn_logits(unflatten_from_vector(vecs[m], tapi.spec), images[m])
                       for m in range(M)])
    assert got.shape == (M, 12, 10)
    scale = float(one.abs().max())
    torch.testing.assert_close(got, one, rtol=0, atol=2e-5 * scale)
    with pytest.raises(ValueError):  # M models take a batch each
        cnn_logits(stacked, images[0])
    loss, m = tapi.loss(stacked, {"images": images,
                                  "labels": torch.from_numpy(labels.astype(np.int64))})
    assert loss.shape == (M,) and m["accuracy"].shape == (M,)
    # one model over a leading batch of batches
    flat = cnn_logits(unflatten_from_vector(vecs[0], tapi.spec), images)
    assert flat.shape == (M, 12, 10)
    torch.testing.assert_close(flat[1], cnn_logits(unflatten_from_vector(vecs[0], tapi.spec),
                                                   images[1]), rtol=0, atol=2e-5 * scale)


def _jax_trainer_run(loss_fn, tree, epochs, n, dtype, seed=2):
    """The reference cohort trainer (K = 3, batches of 16, lr 0.05) run op
    by op, and the port's on the same params, data and key."""
    K, bs = 3, 16
    images, labels = _batch((n, 32, 32, 3), seed, lead=(K,))
    jk = jax.random.key(7)
    with jax.disable_jit():
        _, ref = jmake_local_trainer(loss_fn, 0.05, epochs, bs, compute_dtype=dtype)(
            tree, jnp.asarray(images), jnp.asarray(labels), jk)
    args = (port_tree(tree), torch.from_numpy(images), torch.from_numpy(labels.astype(np.int64)),
            prng.wrap_key_data(np.asarray(jax.random.key_data(jk))))
    return np.asarray(ref), args


@pytest.mark.parametrize("arch", ARCHS)
def test_cohort_updates_match_the_reference_trainer(arch):
    """fp32 (K, P) update vectors over 2 epochs of 2 steps: updates of
    ~1e-2 whose gradients sum in another order, within 1e-4 of the largest
    (the MLP test's tolerance)."""
    api, tapi = cnn_models(arch)
    tree = jax_init(api, 6)
    ref, args = _jax_trainer_run(api.loss, tree, 2, 32, None)
    _, got = make_local_trainer(tapi.loss, 0.05, 2, 16)(*args)
    assert got.shape == ref.shape == (3, flat_size_of(tapi.spec)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())


def _cnn_loss_bias_sums_in_fp32(params, batch):
    """``repro.models.cnn.cnn_loss`` with each conv's bias added in fp32 and
    rounded back: the same forward values (a sum of two bf16 numbers rounds
    once either way), but the bias gradient, the sum of the cotangent over
    (B, H, W), then accumulates in fp32 as torch's does."""
    x = batch["images"].astype(params["fc2"]["w"].dtype)
    for conv in params["convs"]:
        x = jax.lax.conv_general_dilated(x, conv["w"], (1, 1), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        x = (x.astype(jnp.float32) + conv["b"].astype(jnp.float32)).astype(x.dtype)
        x = jax.lax.reduce_window(jax.nn.relu(x), jnp.asarray(-jnp.inf, x.dtype), jax.lax.max,
                                  (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    x = x.reshape(x.shape[0], -1)
    x = jax.nn.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    logits = (x @ params["fc2"]["w"] + params["fc2"]["b"]).astype(jnp.float32)
    gold = jnp.take_along_axis(logits, batch["labels"][:, None], axis=-1)[:, 0]
    return jnp.mean(jax.scipy.special.logsumexp(logits, axis=-1) - gold), {}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_cohort_updates_match_the_reference_trainer(arch):
    """The bf16 compute lane (forward in bf16, fp32 gradients into the fp32
    SGD state), within 2% of the largest update (the MLP test's tolerance).

    On the CPU the reference sums a bf16 bias gradient in bf16: the
    transpose of its broadcast add reduces (B, H, W) = 16,384 cotangents of
    1 to 256, where torch accumulates in fp32 and rounds once (asserted
    below).  After one SGD step every weight leaf of the two trainers agrees
    within the tolerance, while a conv bias can differ by a fifth of its own
    largest update.  So the two-epoch run is held against the reference
    trainer on ``_cnn_loss_bias_sums_in_fp32``, the reference model whose
    bias sums accumulate as the port's do, and the one-step run's weight
    leaves against the unmodified reference."""
    ones = jnp.ones((16, 32, 32, 4), jnp.bfloat16)
    bias_grad = jax.grad(lambda b: jnp.sum((ones + b).astype(jnp.float32)))
    assert float(bias_grad(jnp.zeros((4,), jnp.bfloat16))[0]) == 256.0
    b = torch.zeros(4, dtype=torch.bfloat16, requires_grad=True)
    (torch.ones(16, 32, 32, 4, dtype=torch.bfloat16) + b).float().sum().backward()
    assert float(b.grad[0]) == 16384.0

    api, tapi = cnn_models(arch)
    tree = jax_init(api, 6)
    ref, args = _jax_trainer_run(_cnn_loss_bias_sums_in_fp32, tree, 2, 32, jnp.bfloat16)
    _, got = make_local_trainer(tapi.loss, 0.05, 2, 16, compute_dtype=torch.bfloat16)(*args)
    _, fp32 = make_local_trainer(tapi.loss, 0.05, 2, 16)(*args)
    assert got.dtype == torch.float32 and not torch.equal(got, fp32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=0.02 * np.abs(ref).max())

    ref, args = _jax_trainer_run(api.loss, tree, 1, 16, jnp.bfloat16)
    _, got = make_local_trainer(tapi.loss, 0.05, 1, 16, compute_dtype=torch.bfloat16)(*args)
    got, off = got.numpy(), 0
    for path, shape in tapi.spec:
        n = int(np.prod(shape))
        if path[-1] == "w":
            np.testing.assert_allclose(got[:, off:off + n], ref[:, off:off + n], rtol=0,
                                       atol=0.02 * np.abs(ref).max(), err_msg=str(path))
        off += n


@pytest.mark.parametrize("dataset", ["mnist", "cifar10", "svhn"])
def test_make_image_dataset_matches_the_reference(dataset):
    jk = jax.random.key(11)
    key = prng.wrap_key_data(np.asarray(jax.random.key_data(jk)))
    ref_x, ref_y = jmake_image_dataset(jk, dataset, 40)
    x, y = make_image_dataset(key, dataset, 40, device="cpu")
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref_y))
    # normal draws through erf_inv agree to a few ulps (tests/test_torch_prng.py)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), rtol=1e-6, atol=1e-6)
    given = np.arange(12) % 10
    ref_x, _ = jmake_image_dataset(jk, dataset, 12, labels=jnp.asarray(given))
    x, y = make_image_dataset(key, dataset, 12, labels=torch.from_numpy(given))
    assert y.dtype == torch.int64 and np.array_equal(y.numpy(), given)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), rtol=1e-6, atol=1e-6)
