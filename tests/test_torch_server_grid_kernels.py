"""The batched round's server kernels, B3g and B4g: plain versions against the
JAX package under ``vmap``, and lane by lane against the one-lane plain
versions.

The reference runs its grid as one ``jax.vmap`` of the round, with the
aggregator index a traced per-lane operand, so ``server_update`` and
``server_update_buffered`` then see a leading grid axis and a ``(G,)`` rule.
``server_update_grid_plain`` and ``server_update_buffered_grid_plain`` are
held against ``repro.kernels.ref``'s ``server_update`` /
``server_update_buffered`` under ``jax.vmap`` (the oracle the Pallas kernel
is held to), with every lane's rule drawn from a registry, ``drain`` mixed
across lanes, and fp32 or bf16 rows and master.  Tolerance as the one-lane
tests state it (``tests/test_torch_aggregators.py``,
``tests/test_torch_precision.py``): m' and v' within rtol 1e-5 and 1e-6 of
``sum_k |w_k u_k|`` (another summation order), params' within 100 times
that atol (the adaptive step magnifies the sum's error by up to
``(1 - beta1) / tau``), a bf16 params' within one bf16 ulp.  Each lane must
also be bit for bit the one-lane plain version on that lane.  On the CPU the
wrappers run the plain versions and count no launch; the CUDA kernel runs in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import server_update as su_mod
from test_torch_bridge import _one_thread  # noqa: F401

BF16_ULP = 2.0 ** -7
FULL = (0, 1, 2, 3, 4, 5)
NO_MOMENTS = (0, 4, 5)  # fedavg, stale, fedbuff: the AXPY rules
HP = dict(eta=0.7, beta1=0.9, beta2=0.99, tau=1e-3)


def _operands(G, K, P, Kb, registry, seed):
    """Numpy operands of G lanes: rows, normalized weights, params, moments,
    a ring with its weights, each lane's rule (every rule of the registry
    present when G allows) and a mixed drain."""
    rng = np.random.default_rng(seed)
    u = (1e-3 * rng.standard_normal((G, K, P))).astype(np.float32)
    w = rng.random((G, K)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    params = (0.05 * rng.standard_normal((G, P))).astype(np.float32)
    m = (1e-4 * rng.standard_normal((G, P))).astype(np.float32)
    v = ((1e-3 * rng.standard_normal((G, P))) ** 2).astype(np.float32)
    ring = (1e-3 * rng.standard_normal((G, Kb, P))).astype(np.float32)
    bw = rng.random((G, Kb)).astype(np.float32)
    rules = np.array([registry[g % len(registry)] for g in range(G)], dtype=np.int32)
    drain = np.arange(G) % 3 != 1
    return u, w, params, m, v, ring, bw, rules, drain


def _cast(x, dtype):
    """The same values for both sides: a numpy fp32 array in ``dtype``, as
    a JAX array and as a torch tensor (bf16 rounds to nearest even on both)."""
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, rows, wts, master, what):
    scale = float(np.max(np.abs(wts)[:, None, :] @ np.abs(rows)))
    for name, a, b, atol in zip(("params", "m", "v"), got, want,
                                (1e-4 * scale, 1e-6 * scale, 1e-6 * scale)):
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        if name == "params" and master == "bfloat16":
            assert a.dtype == torch.bfloat16, what
            np.testing.assert_allclose(a.float().numpy(), b, rtol=BF16_ULP, atol=atol,
                                       err_msg=f"{what} {name}")
        else:
            assert a.dtype == torch.float32, what
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=atol,
                                       err_msg=f"{what} {name}")


def _ref_update(u, w, p, m, v, rules):
    lane = lambda u, w, p, m, v, a: jref.server_update(u, w, p, m, v, a, jnp.int32(3), **HP)  # noqa: E731
    return jax.jit(jax.vmap(lane))(u, w, p, m, v, jnp.asarray(rules))


def _ref_buffered(u, w, ring, bw, p, m, v, rules, drain):
    lane = lambda u, w, r, b, p, m, v, a, d: jref.server_update_buffered(  # noqa: E731
        u, w, r, b, p, m, v, a, jnp.int32(3), d, **HP)
    return jax.jit(jax.vmap(lane))(u, w, ring, bw, p, m, v, jnp.asarray(rules),
                                   jnp.asarray(drain))


SHAPES = [(1, 1, 1), (6, 2, 2049), (12, 12, 1031), (24, 2, 4097)]


@pytest.mark.parametrize("rows,master", [("float32", "float32"), ("bfloat16", "float32"),
                                         ("float32", "bfloat16"), ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("G,K,P", SHAPES)
def test_server_update_grid_plain_matches_the_vmapped_reference(G, K, P, rows, master):
    u, w, params, m, v, _, _, rules, _ = _operands(G, K, P, 1, FULL, G * 7 + K + P)
    (uj, ut), (pj, pt) = _cast(u, rows), _cast(params, master)
    want = _ref_update(uj, jnp.asarray(w), pj, jnp.asarray(m), jnp.asarray(v), rules)
    before = su_mod.grid_launches
    got = su_mod.server_update_grid(ut, torch.from_numpy(w), pt, torch.from_numpy(m),
                                    torch.from_numpy(v), torch.from_numpy(rules), 3, **HP)
    assert su_mod.grid_launches == before  # CPU tensors never reach the kernel
    assert [x.shape for x in got] == [(G, P)] * 3
    _assert_close(got, want, _f32(uj), w, master, f"G={G} K={K} P={P} {rows}/{master}")


@pytest.mark.parametrize("rows,master", [("float32", "float32"), ("bfloat16", "float32"),
                                         ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("G,K,Kb,P", [(1, 1, 1, 1), (6, 2, 8, 2049), (12, 12, 3, 1031),
                                      (24, 2, 8, 4097)])
def test_server_update_buffered_grid_plain_matches_the_vmapped_reference(G, K, Kb, P, rows,
                                                                         master):
    u, w, params, m, v, ring, bw, rules, drain = _operands(G, K, P, Kb, FULL, G + K + Kb + P)
    (uj, ut), (rj, rt), (pj, pt) = _cast(u, rows), _cast(ring, rows), _cast(params, master)
    want = _ref_buffered(uj, jnp.asarray(w), rj, jnp.asarray(bw), pj, jnp.asarray(m),
                         jnp.asarray(v), rules, drain)
    before = su_mod.buffered_grid_launches
    got = su_mod.server_update_buffered_grid(
        ut, torch.from_numpy(w), rt, torch.from_numpy(bw), pt, torch.from_numpy(m),
        torch.from_numpy(v), torch.from_numpy(rules), 3, torch.from_numpy(drain), **HP)
    assert su_mod.buffered_grid_launches == before
    # a drained lane sums its ring rows too; the others their cohort alone
    all_rows = np.concatenate([_f32(uj), _f32(rj)], axis=1)
    all_w = np.concatenate([w, np.where(drain[:, None], bw, 0.0)], axis=1)
    _assert_close(got, want, all_rows, all_w, master,
                  f"G={G} K={K} Kb={Kb} P={P} {rows}/{master}")


@pytest.mark.parametrize("registry", [FULL, NO_MOMENTS, (2,), (4, 5)])
def test_grid_plain_versions_are_the_one_lane_plain_versions_lane_by_lane(registry):
    G, K, Kb, P = 9, 3, 4, 515
    u, w, params, m, v, ring, bw, rules, drain = _operands(G, K, P, Kb, registry, 41)
    t = [torch.from_numpy(x) for x in (u, w, params, m, v, ring, bw, rules, drain)]
    u, w, params, m, v, ring, bw, rules, drain = t
    got = su_mod.server_update_grid(u, w, params, m, v, rules, 0, registry=registry, **HP)
    buf = su_mod.server_update_buffered_grid(u, w, ring, bw, params, m, v, rules, 0, drain,
                                             registry=registry, **HP)
    for g in range(G):
        one = su_mod.server_update(u[g], w[g], params[g], m[g], v[g], int(rules[g]), 0, **HP)
        one_b = su_mod.server_update_buffered(u[g], w[g], ring[g], bw[g], params[g], m[g],
                                              v[g], int(rules[g]), 0, drain[g], **HP)
        for a, b, x, y in zip(got, one, buf, one_b):
            assert torch.equal(a[g], b) and torch.equal(x[g], y), (g, int(rules[g]))
    if not any(r in su_mod.MOMENT_RULES for r in registry):
        # no lane may move the moments: they come back as given, as the kernel's
        assert got[1] is m and got[2] is v and buf[1] is m and buf[2] is v


def test_a_lane_that_does_not_drain_is_the_unbuffered_update_bitwise():
    G, K, Kb, P = 6, 2, 8, 1030
    u, w, params, m, v, ring, bw, rules, _ = (torch.from_numpy(x) for x in
                                              _operands(G, K, P, Kb, FULL, 5))
    u[:, :, ::4] = 0.0  # columns whose delta is an exact +0.0
    off = torch.zeros((G,), dtype=torch.bool)
    a = su_mod.server_update_grid(u, w, params, m, v, rules, 0)
    b = su_mod.server_update_buffered_grid(u, w, ring, bw, params, m, v, rules, 0, off)
    for x, y in zip(a, b):
        assert torch.equal(x, y) and torch.equal(torch.signbit(x), torch.signbit(y))


def test_grid_plain_versions_refuse_a_lane_rule_outside_the_registry():
    u, w, params, m, v, ring, bw, rules, drain = (torch.from_numpy(x) for x in
                                                  _operands(3, 2, 8, 2, FULL, 7))
    with pytest.raises(ValueError, match="not in the registry"):
        su_mod.server_update_grid(u, w, params, m, v, rules, 0, registry=NO_MOMENTS)
    with pytest.raises(ValueError, match="not in the registry"):
        su_mod.server_update_buffered_grid(u, w, ring, bw, params, m, v, rules, 0, drain,
                                           registry=(0,))


def test_grid_wrappers_reject_devices_they_do_not_serve():
    x = torch.zeros((2, 4), device="meta")
    rules = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        su_mod.server_update_grid(torch.zeros((2, 2, 4), device="meta"), x[:, :2], x, x, x,
                                  rules, 0)
    with pytest.raises(ValueError):
        su_mod.server_update_buffered_grid(torch.zeros((2, 2, 4), device="meta"), x[:, :2],
                                           torch.zeros((2, 1, 4), device="meta"), x[:, :1], x,
                                           x, x, rules, 0, rules.bool())
