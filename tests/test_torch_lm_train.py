"""The LM zoo's training objective (``LMApi.loss``) and its gradient against the JAX package.

Each family's smoke config goes through ``repro.models.build_model(cfg).loss``
under ``jax.value_and_grad`` and ``repro_torch.models.build_model(cfg).loss``
under autograd, from the same weights (the JAX init, converted) and the same
numpy-seeded batch, B = 2, S = 24, with some targets -1 (no target):
qwen1.5-0.5b (dense, tied head), gemma2-9b (the attention and final
softcaps; ``loss_chunk`` replaced by 16 < S, so the chunked CE runs over
two chunks, the second padded), mixtral-8x7b (the MoE aux loss, the router's
gradient), internvl2-76b (vlm: the image positions get no target),
whisper-small (encdec), hymba-1.5b and mamba2-130m (the SSD scan's plain
version, differentiable on the CPU).  Tolerances: in fp32 loss, ce and aux
within rtol 2e-6, each gradient leaf within 2e-5 of its largest magnitude
(another summation order of the same fp32 products); in bf16 the loss
within rtol 2e-2 and each gradient leaf within 5e-2 in relative L2 norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import build_model as jbuild
from repro.models import layers as jL
from repro.sharding import split_params
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_bridge import _one_thread, tree_to_numpy  # noqa: F401  (autouse fixture)

B, S = 2, 24
ARCHS = ("qwen1.5-0.5b", "gemma2-9b", "mixtral-8x7b", "internvl2-76b", "whisper-small",
         "hymba-1.5b", "mamba2-130m")
LOSS_RTOL, GRAD_TOL = 2e-6, 2e-5
BF16_LOSS_RTOL, BF16_GRAD_REL = 2e-2, 5e-2


def _cfg(get, arch, dtype="float32"):
    cfg = get(arch).replace(dtype=dtype)
    if arch == "gemma2-9b":
        cfg = cfg.replace(loss_chunk=16)  # below S: the chunked CE, 24 -> 2 chunks of 16
    return cfg


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets[rng.random((B, S)) < 0.2] = -1
    out = {"tokens": tokens, "targets": targets}
    if cfg.family == "vlm":
        out["image_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (0.02 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def reference():
    """Per (arch, dtype): the JAX params (numpy) and (loss, metrics, grads)."""
    cache = {}

    def _get(arch, dtype="float32"):
        if (arch, dtype) not in cache:
            cfg = _cfg(jget_smoke, arch, dtype)
            api = jbuild(cfg)
            params, _ = split_params(api.init(jax.random.key(0)))
            batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
            (loss, met), grads = jax.jit(jax.value_and_grad(api.loss, has_aux=True))(
                params, batch)
            f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))  # noqa: E731
            cache[arch, dtype] = (tree_to_numpy(params), float(loss),
                                  {k: float(v) for k, v in met.items()},
                                  [f32(g) for g in jax.tree_util.tree_leaves(grads)])
        return cache[arch, dtype]

    return _get


def _port(arch, params_np, dtype="float32"):
    """The port's (loss, metrics, grads in flat order, the params tree)."""
    cfg = _cfg(get_smoke_config, arch, dtype)
    api = build_model(cfg)
    params = tree_map(lambda p: p.requires_grad_(True),
                      convert.params_tree_from_numpy(params_np))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, met = api.loss(params, batch)
    loss.backward()
    leaves = tree_leaves(params)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
    return float(loss.detach()), {k: float(v.detach()) for k, v in met.items()}, grads, params


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax(reference, arch):
    params_np, jloss, jmet, jgrads = reference(arch)
    loss, met, grads, _ = _port(arch, params_np)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert sorted(met) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(met[k], jmet[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert len(grads) == len(jgrads)
    for i, (g, w) in enumerate(zip(grads, jgrads)):
        assert tuple(g.shape) == w.shape
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * scale, f"{arch} gradient leaf {i}: {err} vs scale {scale}"


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b"])
def test_bf16_loss_and_gradient_match_jax(reference, arch):
    """bf16 params: the gradients come in bf16, as the reference's do."""
    params_np, jloss, _, jgrads = reference(arch, "bfloat16")
    loss, _, grads, params = _port(arch, params_np, "bfloat16")
    np.testing.assert_allclose(loss, jloss, rtol=BF16_LOSS_RTOL)
    for i, (g, w, p) in enumerate(zip(grads, jgrads, tree_leaves(params))):
        assert g.dtype == p.dtype
        rel = np.linalg.norm(g.float().numpy() - w) / max(np.linalg.norm(w), 1e-12)
        assert rel <= BF16_GRAD_REL, f"{arch} bf16 gradient leaf {i}: relative error {rel}"


def test_moe_aux_loss_reaches_the_router(reference):
    """mixtral: the aux term is in the loss, and the router gets a gradient
    (through the gates and the aux loss; held against the reference's by
    ``test_loss_and_gradient_match_jax``)."""
    params_np, _, jmet, _ = reference("mixtral-8x7b")
    assert jmet["aux"] > 0
    _, met, _, params = _port("mixtral-8x7b", params_np)
    np.testing.assert_allclose(met["aux"], jmet["aux"], rtol=LOSS_RTOL)
    grad = params["blocks"][0]["moe"]["router"].grad
    assert grad is not None and float(grad.abs().max()) > 0


def test_vlm_image_positions_get_no_target(reference):
    """internvl2: the loss is the CE over the text positions only: the same
    loss from the logits of the text positions alone."""
    params_np, jloss, _, _ = reference("internvl2-76b")
    cfg = _cfg(get_smoke_config, "internvl2-76b")
    params = convert.params_tree_from_numpy(params_np)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        x = tf._assemble_input(params, cfg, batch)
        pos = torch.arange(x.shape[1])[None].expand(B, -1)
        h, caches, _ = tf.forward_seq(params, cfg, x, pos, "train")
        logits = tf._logits(params, cfg, h)[:, cfg.num_image_tokens:]
        t = batch["targets"]
        ce = L.cross_entropy_loss(logits, torch.clamp_min(t, 0), t >= 0)
    assert caches is None
    np.testing.assert_allclose(float(ce), jloss, rtol=LOSS_RTOL)


def test_chunked_ce_is_the_whole_ce(reference):
    """gemma2's chunked path (2 chunks of 16, the last padded with -1 targets)
    against the whole-logits CE of the same hidden states, and the reference."""
    params_np, jloss, _, _ = reference("gemma2-9b")
    cfg = _cfg(get_smoke_config, "gemma2-9b")
    params = convert.params_tree_from_numpy(params_np)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        loss, met = tf.lm_loss(params, cfg, batch)
        whole, _ = tf.lm_loss(params, cfg.replace(loss_chunk=0), batch)
    np.testing.assert_allclose(float(met["ce"]), float(whole), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("cap,masked", [(0.0, True), (30.0, True), (30.0, False)])
def test_cross_entropy_loss_matches_the_reference(cap, masked):
    rng = np.random.default_rng(3)
    logits = (10 * rng.standard_normal((3, 5, 40))).astype(np.float32)
    targets = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = rng.random((3, 5)) < 0.6 if masked else None
    got = L.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                               None if mask is None else torch.from_numpy(mask), cap)
    want = jL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                                 None if mask is None else jnp.asarray(mask), cap)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_an_empty_mask_gives_zero_loss():
    logits = torch.randn(2, 3, 7)
    got = L.cross_entropy_loss(logits, torch.zeros(2, 3, dtype=torch.int64),
                               torch.zeros(2, 3, dtype=torch.bool))
    assert float(got) == 0.0


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixtral-8x7b"])
def test_train_mode_builds_no_cache_and_prefill_is_unchanged(arch):
    """``forward_seq`` in train mode gives the prefill mode's hidden states and
    aux with no cache."""
    cfg = get_smoke_config(arch)
    api = build_model(cfg)
    from repro_torch.utils import prng

    params = api.init(prng.key(0), "cpu")
    x = tf._embed_tokens(params, cfg, torch.arange(2 * 20).reshape(2, 20) % cfg.vocab_size)
    pos = torch.arange(20)[None].expand(2, -1)
    with torch.no_grad():
        ht, ct, at = tf.forward_seq(params, cfg, x, pos, "train")
        hp, cp, ap = tf.forward_seq(params, cfg, x, pos, "prefill")
    assert ct is None and cp is not None
    assert torch.equal(ht, hp)
    assert (at is None) == (ap is None) == (cfg.family != "moe")
    if at is not None:
        assert torch.equal(at, ap)
