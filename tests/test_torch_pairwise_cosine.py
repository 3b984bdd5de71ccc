"""The port's pairwise-cosine Gram (``kernels.pairwise_cosine``) against the JAX package.

Inputs are made from a seed with numpy and go through both sides: the
port's plain versions (what a CPU tensor runs) against ``repro.kernels.ref``
and against the Pallas kernel in interpret mode, at the reference's own
shapes (``tests/test_kernels.py``: the 128 / 512 tile edges, a single row,
D = 1), in fp32 and bf16 input.  The tolerance is atol 1e-5 for both
(cosines of size 1 summed over up to 2,000 terms in another order): both
sides widen the same bf16 values to fp32 exactly, so a bf16 input differs
only in summation order, as an fp32 one does.  The CUDA kernel itself runs
only on the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jcl
from repro.kernels import pairwise_cosine as jpairwise_cosine
from repro.kernels import ref as jref
from repro.kernels.pairwise_cosine import gram_nt as jgram_nt
from repro_torch.core import pairwise_cosine as core_pairwise_cosine
from repro_torch.kernels import pairwise_cosine as pc
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

SHAPES = [(7, 64), (100, 1024), (128, 512), (33, 2000), (127, 511), (129, 513), (1, 512),
          (256, 1)]
ATOL = 1e-5


def _rows(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values on both sides (bf16 rounds to nearest-even on both)."""
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_pairwise_cosine_matches_the_oracle_and_interpret_mode(n, d, dtype):
    jx, tx = _pair(_rows(n, d, n * d), dtype)
    got = pc.pairwise_cosine_plain(tx)
    assert got.dtype == torch.float32 and got.shape == (n, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.pairwise_cosine(jx)), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpairwise_cosine(jx, interpret=True)),
                               atol=ATOL, rtol=0)
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    before = pc.launches
    assert torch.equal(pc.pairwise_cosine(tx), got)
    assert pc.launches == before
    np.testing.assert_allclose(np.diag(got.numpy()), 1.0, atol=ATOL)


@pytest.mark.parametrize("n,m,d", [(128, 256, 512), (256, 128, 1024)])
def test_plain_gram_nt_matches_the_interpret_mode_kernel(n, m, d):
    """x != y and N != M, at shapes the Pallas kernel takes unpadded."""
    x, y = _rows(n, d, 1), _rows(m, d, 2)
    got = pc.gram_nt_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (n, m)
    ref = np.asarray(jgram_nt(jnp.asarray(x), jnp.asarray(y), interpret=True))
    # unnormalized rows: |x.y| up to ~3 sqrt(d); 1e-5 relative
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.sqrt(d))
    assert torch.equal(pc.gram_nt(torch.from_numpy(x), torch.from_numpy(y)), got)


@pytest.mark.parametrize("n,m,d", [(7, 3, 64), (33, 100, 2000), (1, 5, 1)])
def test_plain_gram_nt_is_the_fp32_nt_product(n, m, d):
    x, y = _rows(n, d, 3), _rows(m, d, 4)
    got = pc.gram_nt_plain(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(y))
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
                      @ jnp.asarray(y).T)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.sqrt(d))


@pytest.mark.parametrize("n,d", [(100, 1024), (33, 2000), (7, 64)])
def test_core_pairwise_cosine_matches_the_jax_core(n, d):
    x = _rows(n, d, 7 + n)
    got = core_pairwise_cosine(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jcl.pairwise_cosine(jnp.asarray(x))),
                               atol=1e-5, rtol=0)


def test_a_zero_row_gives_an_exactly_zero_row_and_column():
    x = _rows(9, 300, 11)
    x[4] = 0.0
    got = pc.pairwise_cosine_plain(torch.from_numpy(x)).numpy()
    assert not got[4].any() and not got[:, 4].any()
    ref = np.asarray(jref.pairwise_cosine(jnp.asarray(x)))
    np.testing.assert_array_equal(ref[4], 0.0)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    keep = np.arange(9) != 4
    np.testing.assert_allclose(np.diag(got)[keep], 1.0, atol=1e-5)


def test_wrappers_raise_on_a_device_that_is_neither_cpu_nor_cuda():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pc.gram_nt(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        pc.pairwise_cosine(x)
