"""The port's threefry2x32 PRNG against ``jax.random`` (partitionable threefry).

Keys, raw bits, ``uniform``, ``randint``, ``bernoulli`` and ``permutation``
must match bit for bit.  ``normal`` and ``truncated_normal`` evaluate XLA's
float32 ``erf_inv`` polynomial; ``log1p`` and ``sqrt`` round differently in
about 1% of draws, so they are held to 4 ulps of the JAX value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.utils import fold_in_str
from repro_torch.utils import prng
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

ULPS = 4  # normal / truncated_normal: see the module docstring


def kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def assert_within_ulps(a, b, ulps=ULPS):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.float32(1e-30)))
    bad = np.abs(a.astype(np.float64) - b.astype(np.float64)) > tol
    assert not bad.any(), f"{bad.sum()} draws beyond {ulps} ulps, e.g. {a[bad][:3]} vs {b[bad][:3]}"


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_key_fold_in_and_split_are_exact(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(kd(jk), tk.numpy())
    for data in (0, 1, 7, 123_456_789, 2**32 - 1):
        np.testing.assert_array_equal(kd(jax.random.fold_in(jk, data)),
                                      prng.fold_in(tk, data).numpy())
    for tag in ("traffic-twin", "fl-sim/contextual/mnist", "kmeans", ""):
        np.testing.assert_array_equal(kd(fold_in_str(jk, tag)),
                                      prng.fold_in_str(tk, tag).numpy())
    for num in (1, 2, 3, 7):
        np.testing.assert_array_equal(kd(jax.random.split(jk, num)),
                                      prng.split(tk, num).numpy())
    # batched: a (n, 2) key array folds and splits row by row
    jks, tks = jax.random.split(jk, 4), prng.split(tk, 4)
    np.testing.assert_array_equal(kd(jax.vmap(lambda k: jax.random.split(k, 3))(jks)),
                                  prng.split(tks, 3).numpy())
    fold_many = np.stack([kd(jax.random.fold_in(jk, i)) for i in range(15)])
    np.testing.assert_array_equal(fold_many, prng.fold_in(tk, torch.arange(15)).numpy())


@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 7), (2, 3, 4)])
def test_bits_are_exact(shape):
    jk, tk = jax.random.key(11), prng.key(11)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(jk, shape)).astype(np.int64),
                                  prng.bits(tk, shape).numpy())


@pytest.mark.parametrize("lo,hi,shape", [(0, 3, (50,)), (0, 2, (4, 64)), (0, 100, ()),
                                         (5, 17, (9,)), (0, 10, (2000,)), (3, 3, (4,))])
def test_randint_is_exact(lo, hi, shape):
    jk, tk = jax.random.key(3), prng.key(3)
    np.testing.assert_array_equal(np.asarray(jax.random.randint(jk, shape, lo, hi)),
                                  prng.randint(tk, shape, lo, hi).numpy())


@pytest.mark.parametrize("p", [0.1, 0.5, 0.7, 1.0])
def test_bernoulli_is_exact(p):
    jk, tk = jax.random.key(5), prng.key(5)
    np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(jk, p, (1000,))),
                                  prng.bernoulli(tk, p, (1000,)).numpy())


@pytest.mark.parametrize("n", [1, 10, 64, 256, 2000])
def test_permutation_is_exact(n):
    jk, tk = jax.random.key(9), prng.key(9)
    np.testing.assert_array_equal(np.asarray(jax.random.permutation(jk, n)),
                                  prng.permutation(tk, n).numpy())


def test_batched_draws_match_vmap():
    jks, tks = jax.random.split(jax.random.key(2), 4), prng.split(prng.key(2), 4)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (6,), 0, 2))(jks)),
        prng.randint(tks, (6,), 0, 2).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 64))(jks)),
        prng.permutation(tks, 64).numpy())
    assert_within_ulps(jax.vmap(lambda k: jax.random.normal(k, (5, 3)))(jks),
                       prng.normal(tks, (5, 3)).numpy())


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 12_345.0), (-0.9544997, 0.9544997)])
def test_uniform_is_exact(lo, hi):
    jk, tk = jax.random.key(42), prng.key(42)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (5000,), jnp.float32, lo, hi)),
        prng.uniform(tk, (5000,), lo, hi).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normal_within_ulps(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    assert_within_ulps(jax.random.normal(jk, (20_000,)), prng.normal(tk, (20_000,)).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_truncated_normal_within_ulps(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    ref = np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, (20_000,)))
    got = prng.truncated_normal(tk, -2.0, 2.0, (20_000,)).numpy()
    assert_within_ulps(ref, got)
    assert (np.abs(got) < 2.0).all()


def test_erf_inv_handles_the_poles():
    x = torch.tensor([-1.0, 1.0, 0.0])
    out = prng.erf_inv(x)
    assert out[0] < -1e30 and out[1] > 1e30 and out[2] == 0.0


def test_draws_leave_torch_global_rng_untouched():
    before = torch.random.get_rng_state().clone()
    k = prng.key(0)
    prng.normal(k, (100,))
    prng.permutation(k, 50)
    prng.randint(k, (10,), 0, 5)
    assert torch.equal(before, torch.random.get_rng_state())
