"""The two-tier lanes' grid kernels on the CPU: B5g's plain version and B1g's
RSU ids against the JAX package under ``vmap``, and B5g's refusals.

The reference runs its grid as one ``jax.vmap`` of the round, so its
``rsu_reduce`` then sees a leading grid axis; ``rsu_reduce_grid_plain``
(what ``rsu_reduce_grid`` runs on CPU tensors) is held against
``jax.vmap(repro.kernels.ref.rsu_reduce)`` with and without a carry (the
JAX round's ``partials + part_c``), fp32 and bf16 rows, fp32 and bf16
partials, ids outside ``[0, R)`` among them, R = 1, 10 and 40 and several G:
bit for bit on dyadic rows with integer weights (every sum exact before
each rounding), else within the one-lane tests' tolerances
(``tests/test_torch_hierarchical.py``, ``tests/test_torch_precision.py``):
rtol 1e-5 in fp32 and one bf16 ulp in bf16 partials, atol 1e-6 of
``sum_k |m_kr u_k|``.  Each lane of the grid plain version is the
one-lane ``rsu_reduce_plain`` on that lane bit for bit, carry in place
included.  ``rttg_latency_grid_plain(..., want_rid=True)``'s ids equal
``jax.vmap(ref.rttg_latency(..., want_rid=True))``'s exactly, and its
latency and connectivity are the call without ids bit for bit.  The CUDA
kernel runs in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import rsu_reduce as rsu_mod
from repro_torch.kernels import rttg_latency as rttg_mod
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_grid_kernels import CATALOG, _grid

BF16_ULP = 2.0 ** -7


def _operands(G, K, P, R, seed, dyadic):
    """(G, K, P) rows, (G, K) weights, (G, K) int32 ids (some outside [0, R))
    and a (G, R, P) carry, as numpy arrays."""
    rng = np.random.default_rng(seed)
    if dyadic:  # 7 significant bits, integer weights: every sum exact in fp32
        u = (rng.integers(-64, 65, (G, K, P)) * 2.0 ** -12).astype(np.float32)
        w = rng.integers(0, 5, (G, K)).astype(np.float32)
        carry = (rng.integers(-64, 65, (G, R, P)) * 2.0 ** -10).astype(np.float32)
    else:
        u = (1e-3 * rng.standard_normal((G, K, P))).astype(np.float32)
        w = rng.random((G, K)).astype(np.float32)
        carry = (1e-3 * rng.standard_normal((G, R, P))).astype(np.float32)
    rid = rng.integers(0, R, (G, K)).astype(np.int32)
    if G * K >= 4:  # ids the reduce must drop: -1 and R + 3
        flat = rid.reshape(-1)
        flat[1::5], flat[3::5] = -1, R + 3
    return u, w, rid, carry


def _pair(x, dtype):
    """A numpy array -> (the JAX array in ``dtype``, the port's tensor with
    the same bits)."""
    j = jnp.asarray(x).astype(dtype)
    return j, convert.params_tree_from_numpy(np.asarray(j))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("rows,out", [("float32", "float32"), ("bfloat16", "float32"),
                                      ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("G,K,P,R", [(1, 1, 1, 1), (3, 4, 515, 10), (12, 3, 301, 10),
                                     (5, 7, 2049, 40)])
def test_rsu_reduce_grid_plain_matches_the_vmapped_reference(G, K, P, R, rows, out,
                                                             with_carry, dyadic):
    u, w, rid, carry = _operands(G, K, P, R, G * 31 + K * 7 + P + R, dyadic)
    (uj, ut), (wj, wt), (ij, it) = (_pair(u, jnp.dtype(rows)), _pair(w, jnp.float32),
                                    _pair(rid, jnp.int32))
    cj, ct = _pair(carry, jnp.dtype(out))
    od = jnp.dtype(out)
    ref = jax.vmap(lambda a, b, c: jref.rsu_reduce(a, b, c, R, out_dtype=od))
    want, want_mass = ref(uj, wj, ij)
    if with_carry:  # the JAX round's chunk walk: partials + part_c
        want = cj + want
    before = rsu_mod.grid_launches
    got, mass = rsu_mod.rsu_reduce_grid(ut, wt, it, R, carry=ct.clone() if with_carry else None,
                                        out_dtype=getattr(torch, out))
    assert rsu_mod.grid_launches == before  # CPU tensors never reach the kernel
    assert got.shape == (G, R, P) and mass.shape == (G, R)
    assert str(got.dtype) == f"torch.{out}" and mass.dtype == torch.float32
    a, b = got.float().numpy(), _np(want)
    if dyadic:
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(mass.numpy(), np.asarray(want_mass))
    else:  # the CPU's product sums in another order than XLA's dot
        scale = float(np.abs(np.asarray(ref(jnp.abs(uj), wj, ij)[0], np.float32)).max())
        rtol = BF16_ULP if out == "bfloat16" else 1e-5
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6 * scale)
        np.testing.assert_allclose(mass.numpy(), np.asarray(want_mass), rtol=1e-6, atol=0.0)
    assert bool(((rid < 0) | (rid >= R)).any()) == (G * K >= 4)


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("rows,out", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
def test_each_lane_of_the_grid_plain_version_is_the_one_lane_plain_version(rows, out,
                                                                          with_carry):
    G, K, P, R = 6, 5, 1029, 10
    u, w, rid, carry = (torch.from_numpy(x) for x in _operands(G, K, P, R, 9, False))
    u, carry = u.to(rows), carry.to(out)
    grid_carry = carry.clone() if with_carry else None
    got, mass = rsu_mod.rsu_reduce_grid_plain(u, w, rid, R, grid_carry, out)
    if with_carry:
        assert got is grid_carry  # updated in place, as the kernel updates it
    for g in range(G):
        one, one_mass = rsu_mod.rsu_reduce_plain(u[g], w[g], rid[g], R,
                                                 carry[g].clone() if with_carry else None, out)
        assert torch.equal(got[g], one) and torch.equal(mass[g], one_mass), g


def test_a_chunk_walk_through_the_grid_plain_version_is_each_lanes_walk():
    """Three chunks of 2 rows, the first without a carry, the rest in place:
    every lane is its one-lane walk bit for bit."""
    G, K, P, R = 4, 6, 300, 10
    u, w, rid, _ = (torch.from_numpy(x) for x in _operands(G, K, P, R, 5, False))
    carry = None
    for c in range(0, K, 2):
        cs = slice(c, c + 2)
        carry, _ = rsu_mod.rsu_reduce_grid(u[:, cs].contiguous(), w[:, cs].contiguous(),
                                           rid[:, cs].contiguous(), R, carry=carry)
    for g in range(G):
        one = None
        for c in range(0, K, 2):
            one, _ = rsu_mod.rsu_reduce(u[g, c:c + 2], w[g, c:c + 2], rid[g, c:c + 2], R,
                                        carry=one)
        assert torch.equal(carry[g], one), g


@pytest.mark.parametrize("predict", [True, False])
@pytest.mark.parametrize("n,cr", [(1, 1.0), (20, 0.7), (100, 0.7)])
def test_rttg_latency_grid_plain_ids_match_the_vmapped_reference(n, cr, predict):
    jscn, (pos, speed, accel, t, forced), view, port = _grid(n, cr, seed=n)
    mb = jnp.float32(636_040.0)
    lane = lambda p, s, a, tt, f, scn: jref.rttg_latency(  # noqa: E731
        p, s, a, tt, mb, f, scn, predict, want_rid=True)
    ref = jax.jit(jax.vmap(lane, in_axes=(0, 0, 0, 0, None if forced is None else 0, 0)))(
        pos, speed, accel, t, forced, jscn)
    before = rttg_mod.grid_launches
    lat, conn, rid = rttg_mod.rttg_latency_grid(*port[:4], 636_040.0, port[4], view,
                                                predict=predict, want_rid=True)
    assert rttg_mod.grid_launches == before
    assert rid.shape == (len(CATALOG), n) and rid.dtype == torch.int32
    np.testing.assert_array_equal(rid.numpy(), np.asarray(ref[2]))
    without = rttg_mod.rttg_latency_grid(*port[:4], 636_040.0, port[4], view, predict=predict)
    assert torch.equal(lat, without[0]) and torch.equal(conn, without[1])
    if n == 100:  # rsu_outage's dark RSUs are never attached
        g = CATALOG.index("rsu_outage")
        live = rttg_mod.rsu_up_mask(view)[g]
        assert bool(live[rid[g].long()].all()) and not bool(live.all())


def _ok_operands(G=2, K=3, P=8, R=4, rows=torch.float32):
    return (torch.zeros((G, K, P), dtype=rows), torch.ones((G, K)),
            torch.zeros((G, K), dtype=torch.int32), R)


@pytest.mark.parametrize("what", ["strided rows", "two-dim rows", "fp16 rows",
                                  "bf16 partials of fp32 rows", "no RSU", "no row",
                                  "too many lanes", "weights of another lane count",
                                  "int64 ids", "strided ids", "carry of another shape",
                                  "carry of another dtype"])
def test_rsu_reduce_grid_refuses_what_the_kernel_does_not_take(what):
    """The wrapper's checks before a launch, run on CPU tensors (the card
    tests call the wrapper itself)."""
    u, w, rid, R = _ok_operands()
    carry, out = None, torch.float32
    if what == "strided rows":
        u = torch.zeros((2, 8, 3)).transpose(1, 2)
    elif what == "two-dim rows":
        u = u[0]
    elif what == "fp16 rows":
        u = u.half()
    elif what == "bf16 partials of fp32 rows":
        out = torch.bfloat16
    elif what == "no RSU":
        R = 0
    elif what == "no row":
        u, w, rid = u[:, :0], w[:, :0], rid[:, :0]
    elif what == "too many lanes":
        u, w, rid = (x.expand((rsu_mod.MAX_LANES + 1,) + x.shape[1:]).contiguous()
                     for x in (u[:1, :1, :1], w[:1, :1], rid[:1, :1]))
    elif what == "weights of another lane count":
        w = w[:1]
    elif what == "int64 ids":
        rid = rid.long()
    elif what == "strided ids":
        rid = torch.zeros((3, 2), dtype=torch.int32).t()
    elif what == "carry of another shape":
        carry = torch.zeros((2, R - 1, 8))
    elif what == "carry of another dtype":
        carry = torch.zeros((2, R, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rsu_reduce"):
        rsu_mod._operands_cuda("rsu_reduce_grid", u, w, rid, R, carry, out, 1)


def test_rsu_reduce_grid_accepts_the_round_operands_and_rejects_other_devices():
    u, w, rid, R = _ok_operands(rows=torch.bfloat16)
    carry = torch.zeros((2, R, 8), dtype=torch.bfloat16)
    out, mass, vec = rsu_mod._operands_cuda("rsu_reduce_grid", u, w, rid, R, carry,
                                            torch.bfloat16, 1)
    assert out is carry and mass.shape == (2, R) and vec == 4
    with pytest.raises(ValueError, match="unsupported device"):
        rsu_mod.rsu_reduce_grid(torch.zeros((2, 3, 8), device="meta"), w, rid, R)
