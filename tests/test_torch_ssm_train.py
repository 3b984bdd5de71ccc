"""Training the ``ssm`` / ``hybrid`` families: the SSD scan's gradient.

At ``ssm_chunk`` 128 the reference's chunk body forms ``exp(cs_q - cs_k)``
over the whole (Q, Q) square; above the diagonal the exponent reaches ~|A|
dt Q, so at A = -16, dt = 0.05 the fp32 ``exp`` overflows to inf and the
backward multiplies the zero cotangent of the masked entries by it: NaN.
The port masks the exponent to ``-inf`` there before the ``exp``
(``kernels.ssd_scan.ssd_chunk``).  Held here:

- the forward is the unmasked formulation (a copy below) bit for bit, and
  its gradient at that point finite and within rtol 1e-4 (atol 1e-6 of the
  largest magnitude) of the same scan in float64, where the unmasked copy's
  and the reference's are NaN;
- at dt = 0.02, where the reference is finite, the gradient within rtol
  2e-5 (atol 2e-5 of the largest magnitude) of ``jax.grad`` of
  ``repro.models.ssm.ssd_scan``;
- under grad mode the plain scan checkpoints each chunk (the training
  path), and gives the uncheckpointed loop's y, h and gradients bit for bit;
- ``models.ssm.ssm_forward`` trains through the plain scan and prefills
  through the ``ssd_scan`` wrapper;
- the hymba-1.5b and mamba2-130m smoke configs at ``ssm_chunk`` 128 and S =
  160 (a ragged second chunk): loss within ``test_torch_lm_train.py``'s
  LOSS_RTOL of the reference's; the gradient finite (the reference's is
  NaN) and each leaf within 1e-4 of its largest magnitude of the port's
  float64 run (the model's loss with every ``torch.float32`` it names read
  as ``torch.float64``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import build_model as jbuild
from repro.models import ssm as jssm
from repro.sharding import split_params
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import build_model
from repro_torch.models import ssm
from repro_torch.utils import prng
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_bridge import _one_thread, tree_to_numpy  # noqa: F401  (autouse fixture)
from test_torch_lm_train import LOSS_RTOL

A_C1 = (-1.0, -16.0)
F64_TOL = 1e-4


def unmasked_chunk(h, x_c, dt_c, B_c, C_c, A):
    """``ssd_chunk`` before the repair: the reference's chunk body, the
    decay's exponent unmasked (its gradient is NaN where ``exp`` overflows)."""
    Q = x_c.shape[1]
    x_c = x_c.to(torch.float32)
    B_c = B_c.to(torch.float32)
    C_c = C_c.to(torch.float32)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    cs = torch.cumsum(dt_c * A, dim=1)
    G = torch.einsum("bqn,bkn->bqk", C_c, B_c)
    decay = torch.exp(cs[:, :, None, :] - cs[:, None, :, :])
    M = G[..., None] * decay * dt_c[:, None, :, :]
    M = torch.where(tri[None, :, :, None], M, torch.zeros(()))
    y = torch.einsum("bqkh,bkhp->bqhp", M, x_c)
    y = y + torch.einsum("bqn,bhpn->bqhp", C_c, h) * torch.exp(cs)[..., None]
    sdecay = torch.exp(cs[:, -1:, :] - cs) * dt_c
    Sc = torch.einsum("bkn,bkhp->bhpn", B_c, x_c * sdecay[..., None])
    h = torch.exp(cs[:, -1, :])[:, :, None, None] * h + Sc
    return y, h


def chunk_loop(body, xh, dt, A, Bs, Cs, chunk, h0=None):
    """``ssd_scan_plain``'s chunk loop in float32 with no checkpoint, each
    chunk through ``body``."""
    Bsz, S, nh, hp = xh.shape
    ds = Bs.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    dt = dt.to(torch.float32)
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bs = torch.nn.functional.pad(Bs, (0, 0, 0, pad))
        Cs = torch.nn.functional.pad(Cs, (0, 0, 0, pad))
    h = (torch.zeros((Bsz, nh, hp, ds), dtype=torch.float32)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for c in range((S + pad) // Q):
        sl = slice(c * Q, (c + 1) * Q)
        y, h = body(h, xh[:, sl], dt[:, sl], Bs[:, sl], Cs[:, sl], A)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def unmasked_scan(*a):
    """``ssd_scan_plain`` before the repair."""
    return chunk_loop(unmasked_chunk, *a)


def uncheckpointed_scan(*a):
    """``ssd_scan_plain`` with every chunk's temporaries kept for the backward."""
    return chunk_loop(ssd.ssd_chunk, *a)


def operands(B, S, nh, hp, ds, dt, A=None, with_h0=False, seed=0, dtype=np.float32):
    """numpy operands: xh, dt (constant, or drawn in [0.01, 0.1] when None), A
    (given, or drawn in [-16, -1]), Bs, Cs and h0 (or None)."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, nh, hp)).astype(dtype)
    dts = (np.full((B, S, nh), dt) if dt is not None
           else rng.uniform(0.01, 0.1, (B, S, nh))).astype(np.float32)
    As = np.asarray(A if A is not None else -rng.uniform(1.0, 16.0, nh), np.float32)
    Bs = rng.standard_normal((B, S, ds)).astype(dtype)
    Cs = rng.standard_normal((B, S, ds)).astype(dtype)
    h0 = 0.1 * rng.standard_normal((B, nh, hp, ds)).astype(np.float32) if with_h0 else None
    return xh, dts, As, Bs, Cs, h0


def leaves(ops, dtype=None, grad=True):
    """numpy operands -> torch tensors (``dtype`` for the float ones), with grad."""
    out = []
    for x in ops:
        if x is None:
            out.append(None)
            continue
        t = torch.from_numpy(np.array(x))
        if dtype is not None:
            t = t.to(dtype)
        out.append(t.requires_grad_(grad))
    return out


def scan_grads(fn, ops, chunk, dtype=None, **kw):
    """(y, h, the gradients of sum(y * wy) + sum(h * wh) for every operand)."""
    ts = leaves(ops, dtype)
    y, h = fn(*ts[:5], chunk, ts[5], **kw)
    g = np.random.default_rng(99)
    wy = torch.from_numpy(g.standard_normal(tuple(y.shape)).astype(np.float32)).to(y.dtype)
    wh = torch.from_numpy(g.standard_normal(tuple(h.shape)).astype(np.float32)).to(h.dtype)
    ((y * wy).sum() + (h * wh).sum()).backward()
    return y.detach(), h.detach(), [None if t is None else t.grad for t in ts]


def assert_grads_close(got, want, rtol, scale_tol, what):
    for i, (a, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        assert bool(torch.isfinite(a).all()), f"{what}: operand {i} has a non-finite gradient"
        w = w.to(torch.float64)
        atol = scale_tol * float(w.abs().max())
        torch.testing.assert_close(a.to(torch.float64), w, rtol=rtol, atol=atol,
                                   msg=f"{what}: operand {i}")


@pytest.mark.parametrize("S,chunk,with_h0,x_dtype", [
    (128, 128, False, torch.float32), (160, 128, True, torch.float32),
    (40, 16, False, torch.float32), (160, 128, True, torch.bfloat16)])
def test_forward_is_the_unmasked_scan_bit_for_bit(S, chunk, with_h0, x_dtype):
    ops = operands(2, S, 2, 8, 8, 0.05 if S == 128 else None, A_C1 if S == 128 else None,
                   with_h0)
    ts = leaves(ops, grad=False)
    for i in (0, 3, 4):
        ts[i] = ts[i].to(x_dtype)
    got = ssd.ssd_scan_plain(*ts[:5], chunk, ts[5])
    want = unmasked_scan(*ts[:5], chunk, ts[5])
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_c1_gradient_is_finite_and_matches_float64():
    """Q = S = 128, A = (-1, -16), dt = 0.05: the unmasked scan's and the
    reference's gradients are NaN; the port's is finite and the float64 one's."""
    ops = operands(2, 128, 2, 8, 8, 0.05, A_C1, with_h0=True)
    _, _, g_old = scan_grads(unmasked_scan, ops, 128)
    assert not all(bool(torch.isfinite(g).all()) for g in g_old if g is not None)
    y, h, g32 = scan_grads(ssd.ssd_scan_plain, ops, 128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    y64, h64, g64 = scan_grads(ssd.ssd_scan_plain, ops, 128, dtype=torch.float64)
    torch.testing.assert_close(y.double(), y64, rtol=1e-4, atol=1e-5)
    assert_grads_close(g32, g64, F64_TOL, 1e-6, "C1")
    # the JAX package still has the fault
    jg = jax.grad(lambda *a: jnp.sum(jssm.ssd_scan(*a, 128)[0]), argnums=(1, 2))(
        *(jnp.asarray(x) for x in ops[:5]))
    assert not all(np.isfinite(np.asarray(x)).all() for x in jg)


@pytest.mark.parametrize("S,chunk,with_h0", [(128, 128, False), (160, 128, True),
                                              (40, 16, True)])
def test_gradient_matches_jax_where_the_reference_is_finite(S, chunk, with_h0):
    """dt = 0.02: |A| dt Q <= 41, the reference's fp32 exp stays finite."""
    ops = operands(2, S, 3, 8, 8, 0.02, with_h0=with_h0, seed=S)
    y, h, got = scan_grads(ssd.ssd_scan_plain, ops, chunk)
    g = np.random.default_rng(99)
    wy = g.standard_normal(tuple(y.shape)).astype(np.float32)
    wh = g.standard_normal(tuple(h.shape)).astype(np.float32)
    jops = [None if x is None else jnp.asarray(x) for x in ops]

    def objective(xh, dt, A, Bs, Cs, h0):
        jy, jh = jssm.ssd_scan(xh, dt, A, Bs, Cs, chunk, h0)
        return jnp.sum(jy * wy) + jnp.sum(jh * wh)

    argnums = (0, 1, 2, 3, 4, 5) if with_h0 else (0, 1, 2, 3, 4)
    want = jax.grad(objective, argnums=argnums)(*jops)
    want = [torch.from_numpy(np.array(w)) for w in want] + ([] if with_h0 else [None])
    assert all(bool(torch.isfinite(w).all()) for w in want if w is not None)
    assert_grads_close(got, want, 2e-5, 2e-5, f"S={S} chunk={chunk}")


@pytest.mark.parametrize("S,chunk,with_h0", [(128, 128, False), (160, 64, True),
                                              (40, 16, True)])
def test_checkpointed_scan_is_the_plain_scan_bit_for_bit(S, chunk, with_h0, monkeypatch):
    ops = operands(2, S, 2, 8, 8, None, with_h0=with_h0, seed=7)
    y0, h0, g0 = scan_grads(uncheckpointed_scan, ops, chunk)
    calls = []
    wrapped = ssd.checkpoint

    def spy(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return wrapped(*a, **kw)

    monkeypatch.setattr(ssd, "checkpoint", spy)
    y1, h1, g1 = scan_grads(ssd.ssd_scan_plain, ops, chunk)
    assert calls == [False] * (-(-S // chunk))  # one checkpoint a chunk, under grad mode
    with torch.no_grad():
        ssd.ssd_scan_plain(*leaves(ops, grad=False)[:5], chunk, leaves(ops, grad=False)[5])
    assert len(calls) == -(-S // chunk)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)


def test_ssm_forward_trains_through_the_plain_scan_and_prefills_through_the_wrapper(
        monkeypatch):
    cfg = get_smoke_config("mamba2-130m")
    params = build_model(cfg).init(prng.key(0), "cpu")
    p = {k: v[0] for k, v in params["blocks"][0]["ssm"].items()}
    x = 0.5 * torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(0))
    calls = []
    wrapped = ssd.ssd_scan

    def spy(*a, **kw):
        calls.append(a[0].requires_grad)
        return wrapped(*a, **kw)

    monkeypatch.setattr(ssd, "ssd_scan", spy)
    trained = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    y_train, _ = ssm.ssm_forward(trained, x, cfg)
    assert calls == [] and y_train.requires_grad
    with torch.no_grad():
        y_prefill, _ = ssm.ssm_forward(trained, x, cfg)
    assert calls == [False]
    y_frozen, _ = ssm.ssm_forward(p, x, cfg)  # grad mode on, nothing requires grad
    assert calls == [False, False]
    assert torch.equal(y_train.detach(), y_prefill) and torch.equal(y_prefill, y_frozen)


def _lm_batch(cfg, B=2, S=160, seed=0):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets[rng.random((B, S)) < 0.2] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": targets}


def _port_loss_and_grads(cfg, params_np, batch, dtype):
    api = build_model(cfg)
    params = tree_map(lambda t: t.to(dtype).requires_grad_(True),
                      convert.params_tree_from_numpy(params_np))
    loss, _ = api.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), [p.grad for p in tree_leaves(params)]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m"])
def test_chunk_128_loss_and_gradient(arch, monkeypatch):
    jcfg = jget_smoke(arch).replace(ssm_chunk=128)
    cfg = get_smoke_config(arch).replace(ssm_chunk=128)
    assert cfg.dtype == "float32"
    api = jbuild(jcfg)
    params, _ = split_params(api.init(jax.random.key(0)))
    batch = _lm_batch(cfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(api.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = jax.tree_util.tree_leaves(jgrads)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrads)  # C1 in the reference
    params_np = tree_to_numpy(params)
    loss, grads = _port_loss_and_grads(cfg, params_np, batch, torch.float32)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    with monkeypatch.context() as m:
        m.setattr(torch, "float32", torch.float64)
        loss64, grads64 = _port_loss_and_grads(cfg, params_np, batch, torch.float64)
    assert grads64[0].dtype == torch.float64
    np.testing.assert_allclose(loss, loss64, rtol=LOSS_RTOL)
    assert len(grads) == len(jgrads)
    for i, (g, w) in enumerate(zip(grads, grads64)):
        assert bool(torch.isfinite(g).all()), f"{arch} leaf {i}"
        err = float((g.double() - w).abs().max())
        assert err <= F64_TOL * float(w.abs().max()), f"{arch} leaf {i}: {err}"
