"""Transformer primitives of the LM zoo (``repro.models.layers``).

The reference's layouts and dtypes, so the tests compare like with like:

- Parameters are plain dicts of tensors.  Layer stacks carry a leading
  ``layers`` axis; dense weights stay ``(d, H, hd)`` / ``(H, hd, d)`` /
  ``(d, ff)`` and go through ``einsum``, not ``nn.Linear``'s ``(out, in)``.
- Activations are in the config's dtype (bf16 at full width); norms,
  softmax and rope run in fp32.  Where the reference asks for an fp32
  accumulation of bf16 operands (``preferred_element_type``) the operands
  are upcast first: a bf16 product is exact in fp32, so this is the same sum.
- ``blocked_attention`` is the reference's query-blocked attention in plain
  torch ops (its masks, softcap and the cast of the probabilities to
  ``v.dtype`` before the PV product).  The decode side goes through the
  hand-written ``kernels.swa_decode`` instead (``models/transformer.py``).
- ``cache_write`` updates the ring-buffer cache in place (the reference
  returns new arrays); the caller owns the cache.
- ``cross_entropy_loss`` is the training objective's token-level CE.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.utils import prng


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


# Elements of one weight drawn at a time: a draw keeps several 8-byte
# temporaries per element alive (threefry's int64 words, ``uniform``'s float64
# multiply-add), so a full-width stack (mistral-nemo-12b's 2.9 G-element
# ``w_gate``) is drawn range by range into its tensor.
INIT_CHUNK = 2 ** 26


def _chunked(draw, std: float, shape, dtype, device):
    """``(std * draw(n, start)).to(dtype)`` over a tensor of ``shape``, the single
    draw bit for bit, filled ``INIT_CHUNK`` elements at a time."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - start)
        flat[start:start + n] = std * draw(n, start)
    return out


def _scaled_truncated_normal(key, std: float, shape, dtype, device):
    """``(std * truncated_normal(key, -2, 2, shape)).to(dtype)``, chunked."""
    device = key.device if device is None else torch.device(device)
    return _chunked(lambda n, start: prng.truncated_normal(key, -2.0, 2.0, (n,), device, start),
                    std, shape, dtype, device)


def scaled_normal(key, std: float, shape, dtype, device=None):
    """``(std * normal(key, shape)).to(dtype)``, chunked (whisper's ``pos_embed``)."""
    device = key.device if device is None else torch.device(device)
    return _chunked(lambda n, start: prng.normal(key, (n,), device, start),
                    std, shape, dtype, device)


def dense_init(key, shape, in_axis_dims=None, dtype=torch.float32, scale=1.0, device=None):
    """Truncated-normal fan-in init (``std * truncated_normal(-2, 2)``)."""
    fan_in = in_axis_dims if in_axis_dims is not None else shape[0]
    std = scale / math.sqrt(max(fan_in, 1))
    return _scaled_truncated_normal(key, std, shape, dtype, device)


def zeros_init(shape, dtype=torch.float32, device=None):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(shape, dtype=torch.float32, device=None):
    return torch.ones(shape, dtype=dtype, device=device)


def init_embedding(key, vocab: int, d: int, dtype, device=None):
    return _scaled_truncated_normal(key, 0.02, (vocab, d), dtype, device)


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps=1e-5, zero_centered=False):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    if zero_centered:  # gemma-style (1 + w)
        w = 1.0 + w
    return (y * w).to(x.dtype)


def layer_norm(x, weight, bias, eps=1e-5):
    """fp32 LayerNorm with the population variance (``jnp.var``'s)."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def rope_frequencies(head_dim: int, rope_style: str, theta: float, device=None):
    """Inverse frequencies; '2d' (chatglm) rotates only the first half."""
    rot = head_dim if rope_style == "full" else head_dim // 2
    exponent = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponent)


def apply_rope(x, positions, inv_freq, rope_style: str):
    """x: (B, S, H, D); positions: (B, S) or (S,).  Interleaved pairs."""
    if rope_style == "none":
        return x
    d = x.shape[-1]
    rot = d if rope_style == "full" else d // 2
    xf = x.to(torch.float32)
    x_rot, x_pass = xf[..., :rot], xf[..., rot:]
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * inv_freq  # (B, S, rot/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated, x_pass], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def softcap(scores, cap: float):
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def blocked_attention(q, k, v, q_positions, kv_positions, *, causal: bool, window: int = 0,
                      cap: float = 0.0, block_q: int = 1024):
    """Attention over query blocks with positional masks (the reference's).

    q (B, Sq, H, D); k, v (B, Skv, Hkv, D); q_positions (B, Sq);
    kv_positions (B, Skv), -1 = empty.  Peak transient (B, H, block_q, Skv).
    """
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    groups = H // Hkv
    scale = 1.0 / math.sqrt(D)
    block_q = min(block_q, Sq)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    jk = kv_positions[:, None, None, None, :]  # (B,1,1,1,Skv)
    outs = []
    for s0 in range(0, Sq, block_q):
        qblk = q[:, s0:s0 + block_q]
        bq = qblk.shape[1]
        qg = qblk.reshape(B, bq, Hkv, groups, D).to(torch.float32)
        scores = torch.einsum("bqhgd,bshd->bhgqs", qg, kf) * scale
        scores = softcap(scores, cap)
        iq = q_positions[:, s0:s0 + block_q][:, None, None, :, None]  # (B,1,1,bq,1)
        mask = jk >= 0
        if causal:
            mask = mask & (jk <= iq)
        if window > 0:
            mask = mask & ((iq - jk) < window)
        mask = mask & (iq >= 0)
        scores = torch.where(mask, scores, torch.tensor(-1e30, dtype=torch.float32,
                                                        device=scores.device))
        m = torch.amax(scores, dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        s = torch.sum(e, dim=-1, keepdim=True)
        p_attn = (e / torch.clamp_min(s, 1e-30)).to(v.dtype)
        out = torch.einsum("bhgqs,bshd->bqhgd", p_attn.to(torch.float32), vf)
        outs.append(out.reshape(B, bq, H, D).to(v.dtype))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer (projection + output)
# ---------------------------------------------------------------------------


def init_attention(key, cfg, num_layers: int, dtype, device=None, cross: bool = False):
    """Stacked attention params for ``num_layers`` layers; a cross-attention
    (``cross``) has no bias."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ks = prng.split(key, 4)
    L = num_layers
    params = {
        "wq": dense_init(ks[0], (L, d, H, hd), d, dtype, device=device),
        "wk": dense_init(ks[1], (L, d, KV, hd), d, dtype, device=device),
        "wv": dense_init(ks[2], (L, d, KV, hd), d, dtype, device=device),
        "wo": dense_init(ks[3], (L, H, hd, d), H * hd, dtype, device=device),
    }
    if cfg.qkv_bias and not cross:
        params["bq"] = zeros_init((L, H, hd), dtype, device)
        params["bk"] = zeros_init((L, KV, hd), dtype, device)
        params["bv"] = zeros_init((L, KV, hd), dtype, device)
    return params


def project_qkv(p, x, kv_repeat: int = 1, x_kv=None):
    """q, k, v projections; k and v come from ``x_kv`` where it is given
    (cross-attention); ``kv_repeat`` repeats kv heads after projection."""
    src = x if x_kv is None else x_kv
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if kv_repeat > 1:
        k = torch.repeat_interleave(k, kv_repeat, dim=2)
        v = torch.repeat_interleave(v, kv_repeat, dim=2)
    return q, k, v


def attn_output(p, ctx):
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"].to(ctx.dtype))


# ---------------------------------------------------------------------------
# KV cache (ring buffer for windowed layers)
# ---------------------------------------------------------------------------


def cache_write(cache_k, cache_v, cache_pos, k, v, positions):
    """Write one decode step (Sq == 1) into a ring-buffer KV cache, in place.

    cache_k/v: (B, C, H, D); cache_pos: (B, C) absolute positions (-1 empty);
    positions: (B,) absolute position of the incoming token (slot pos % C).
    """
    C = cache_k.shape[1]
    slot = (positions % C).long()
    b = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k[b, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[b, slot] = v[:, 0].to(cache_v.dtype)
    cache_pos[b, slot] = positions.to(cache_pos.dtype)
    return cache_k, cache_v, cache_pos


def ring_positions(prefilled: int, cache_len: int, device=None) -> torch.Tensor:
    """The positions a ring of ``cache_len`` slots holds after a context of
    ``prefilled`` tokens: slot ``s`` keeps the latest ``p < prefilled`` with
    ``p % cache_len == s``, or -1.  -> (cache_len,) int32."""
    slots = torch.arange(cache_len, device=device)
    base = (prefilled - 1) // cache_len * cache_len
    cand = base + slots
    cand = torch.where(cand >= prefilled, cand - cache_len, cand)
    return torch.where(cand < 0, torch.full_like(cand, -1), cand).to(torch.int32)


def init_cache(batch: int, cache_len: int, kv_heads: int, head_dim: int, dtype, device=None):
    return {
        "k": torch.zeros((batch, cache_len, kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, kv_heads, head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_swiglu(key, d: int, ff: int, num_layers: int, dtype, device=None):
    k1, k2, k3 = prng.split(key, 3)
    L = num_layers
    return {
        "w_gate": dense_init(k1, (L, d, ff), d, dtype, device=device),
        "w_up": dense_init(k2, (L, d, ff), d, dtype, device=device),
        "w_down": dense_init(k3, (L, ff, d), ff, dtype, device=device),
    }


def swiglu(p, x):
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(x.dtype))


def init_gelu_mlp(key, d: int, ff: int, num_layers: int, dtype, device=None):
    k1, k2 = prng.split(key, 2)
    L = num_layers
    return {
        "w1": dense_init(k1, (L, d, ff), d, dtype, device=device),
        "b1": zeros_init((L, ff), dtype, device),
        "w2": dense_init(k2, (L, ff, d), ff, dtype, device=device),
        "b2": zeros_init((L, d), dtype, device),
    }


def gelu_mlp(p, x):
    """The GELU is ``jax.nn.gelu``'s default, the tanh approximation, in fp32."""
    h = torch.einsum("bsd,df->bsf", x, p["w1"].to(x.dtype)) + p["b1"].to(x.dtype)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return torch.einsum("bsf,fd->bsd", h, p["w2"].to(x.dtype)) + p["b2"].to(x.dtype)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def masked_nll(logits, targets, mask, cap: float = 0.0):
    """(sum of the token NLL over ``mask``, the mask's token count), both fp32;
    logits (B, S, V), targets and mask (B, S).  The softcap is applied first."""
    lf = softcap(logits.to(torch.float32), cap)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    mask = mask.to(torch.float32)
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def cross_entropy_loss(logits, targets, mask=None, cap: float = 0.0):
    """Mean token-level CE in fp32; logits (B, S, V), targets (B, S).  The
    softcap is applied first; with a ``mask`` the mean is over its tokens,
    ``sum(nll * mask) / max(sum(mask), 1)``."""
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.bool, device=targets.device)
    nll, count = masked_nll(logits, targets, mask, cap)
    return nll / torch.clamp_min(count, 1.0)
