"""Dirichlet client shards: ``prng.exponential`` / ``loggamma`` / ``dirichlet``,
the batched ``categorical`` and ``partition_labels`` at ``dirichlet_alpha > 0``,
against ``jax.random`` and ``repro.fl.partition``.

``loggamma`` is JAX's Marsaglia-Tsang rejection on per-element split keys;
its normals and logs agree with XLA's to an ulp or so, so the floats are
held within rtol 1e-5 / atol 1e-6 (an acceptance that flipped on such an
ulp would draw a different value and fail that).  Labels are integers and
held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.fl.partition import partition_labels as jpartition_labels
from repro_torch.config import FLConfig
from repro_torch.fl.partition import partition_labels
from repro_torch.utils import prng
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

ALPHAS = (0.05, 0.3, 0.5, 1.0, 2.5, 10.0)
SEEDS = (0, 1, 7)
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("seed", SEEDS)
def test_exponential_matches_jax(seed):
    got = prng.exponential(prng.key(seed), (64, 10)).numpy()
    want = np.asarray(jax.random.exponential(jax.random.key(seed), (64, 10)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("seed", SEEDS)
def test_loggamma_matches_jax(alpha, seed):
    got = prng.loggamma(prng.key(seed), torch.full((10,), alpha), (64, 10))
    want = np.asarray(jax.random.loggamma(jax.random.key(seed), jnp.full((10,), alpha),
                                          (64, 10)))
    assert got.shape == (64, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_loggamma_takes_per_element_alphas():
    alpha = np.array([[0.05, 0.3, 1.0], [2.5, 10.0, 0.5]], np.float32)
    got = prng.loggamma(prng.key(3), torch.from_numpy(alpha))
    want = np.asarray(jax.random.loggamma(jax.random.key(3), jnp.asarray(alpha)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("seed", SEEDS)
def test_dirichlet_matches_jax(alpha, seed):
    got = prng.dirichlet(prng.key(seed), torch.full((10,), alpha), (64,))
    want = np.asarray(jax.random.dirichlet(jax.random.key(seed), jnp.full((10,), alpha),
                                           (64,)))
    assert got.shape == (64, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_with_batched_keys_is_jax_vmap(seed):
    rng = np.random.default_rng(seed)
    logits = np.log(rng.dirichlet(np.full(10, 0.3), 12) + 1e-9).astype(np.float32)
    jkeys = jax.random.split(jax.random.key(seed), 12)
    want = jax.vmap(lambda k, lg: jax.random.categorical(k, lg, shape=(50,)))(
        jkeys, jnp.asarray(logits))
    got = prng.categorical(prng.split(prng.key(seed), 12), torch.from_numpy(logits), (50,))
    assert got.shape == (12, 50) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one key and 1-D logits: the unbatched draw as before
    one = prng.categorical(prng.key(seed), torch.from_numpy(logits[0]), (4, 5))
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jax.random.categorical(jax.random.key(seed),
                                                       jnp.asarray(logits[0]), shape=(4, 5))))


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
@pytest.mark.parametrize("alpha", [0.3, 0.5])
@pytest.mark.parametrize("seed", [0, 5])
def test_partition_labels_match_the_reference(dataset, alpha, seed):
    kw = dict(num_clients=20, samples_per_client=64, dirichlet_alpha=alpha)
    want = np.asarray(jpartition_labels(jax.random.key(seed), dataset, JFLConfig(**kw)))
    got = partition_labels(prng.key(seed), dataset, FLConfig(**kw),
                           regions=torch.arange(20) % 4)  # the regions take no part
    assert got.shape == (20, 64) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # skewed: some client misses a class it would hold under uniform shards
    assert any(len(np.unique(row)) < 10 for row in want)
