"""Whisper-style encoder-decoder backbone of the port (``repro.models.encdec``),
audio frontend stubbed.

The mel-spectrogram + conv feature extractor is stubbed as in the reference:
the model consumes precomputed frame embeddings ``(B, encoder_seq, d)``.
Encoder: bidirectional pre-LN blocks with GELU MLPs and sinusoidal positions.
Decoder: causal self-attention, cross-attention to the encoder output, GELU
MLP.  The encoder and decoder parameters are stacked on a leading layer
axis, as in the reference, and a Python loop over that axis takes the place
of ``lax.scan`` (no remat).  Prefill attention is ``layers.blocked_attention``
in plain torch; each decode step runs both of its attentions per layer through
``kernels.swa_decode``: the self-attention over its ring, the cross-attention
over the cached encoder K / V with the query placed at the last frame, so
that every frame is visible (the reference's ``causal=False``).
``encdec_decode_step`` updates the cache it is given in place and returns it.
``encdec_loss`` is the training objective: the decoder's sequence path with
no cache built, the CE with no softcap and no auxiliary loss.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.transformer import decode_attention, layer_slices, torch_dtype
from repro_torch.utils import prng


def _sinusoid(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) fp32: sin on the even columns, cos on the odd ones."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    log_base = torch.log(torch.tensor(10_000.0, dtype=torch.float32, device=device))
    ang = pos * torch.exp(-dim * log_base / d)
    out = torch.zeros((seq, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


def init_encdec(key, cfg, device=None) -> dict:
    """Parameter tree of the reference's ``init_encdec``, from the same key
    split (``ks[7]`` unused)."""
    dtype = torch_dtype(cfg)
    device = key.device if device is None else torch.device(device)
    Le, Ld, d = cfg.encoder_layers, cfg.num_layers, cfg.d_model
    ks = prng.split(key, 8)

    def ones(n):
        return L.ones_init((n, d), dtype, device)

    def zeros(n):
        return L.zeros_init((n, d), dtype, device)

    return {
        "embed": L.init_embedding(ks[0], cfg.padded_vocab, d, dtype, device),
        "pos_embed": L.scaled_normal(ks[1], 0.01, (cfg.max_position_embeddings, d), dtype,
                                     device),
        "encoder": {
            "attn": L.init_attention(ks[2], cfg, Le, dtype, device),
            "mlp": L.init_gelu_mlp(ks[3], d, cfg.d_ff, Le, dtype, device),
            "ln1": ones(Le), "ln1b": zeros(Le), "ln2": ones(Le), "ln2b": zeros(Le),
        },
        "decoder": {
            "self_attn": L.init_attention(ks[4], cfg, Ld, dtype, device),
            "cross_attn": L.init_attention(ks[5], cfg, Ld, dtype, device, cross=True),
            "mlp": L.init_gelu_mlp(ks[6], d, cfg.d_ff, Ld, dtype, device),
            "ln1": ones(Ld), "ln1b": zeros(Ld), "lnx": ones(Ld), "lnxb": zeros(Ld),
            "ln2": ones(Ld), "ln2b": zeros(Ld),
        },
        "final_norm": L.ones_init((d,), dtype, device),
        "final_norm_b": L.zeros_init((d,), dtype, device),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    """(B, S) int32 ``arange(S)`` per row, materialized (``swa_decode`` takes
    contiguous operands only)."""
    return torch.arange(S, dtype=torch.int32, device=device)[None, :].repeat(B, 1)


def encode(params, cfg, frames):
    """frames: stubbed embeddings (B, S_enc, d) -> encoder output."""
    x = frames.to(torch_dtype(cfg))
    B, S, _ = x.shape
    x = x + _sinusoid(S, cfg.d_model, x.device).to(x.dtype)[None]
    positions = _positions(B, S, x.device)
    for bp in layer_slices(params["encoder"], cfg.encoder_layers):
        h = L.layer_norm(x, bp["ln1"], bp["ln1b"], cfg.norm_eps)
        q, k, v = L.project_qkv(bp["attn"], h)
        a = L.blocked_attention(q, k, v, positions, positions, causal=False,
                                block_q=cfg.attn_block_q)
        x = x + L.attn_output(bp["attn"], a)
        h = L.layer_norm(x, bp["ln2"], bp["ln2b"], cfg.norm_eps)
        x = x + L.gelu_mlp(bp["mlp"], h)
    return x


def _logits(params, cfg, x):
    x = L.layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
    return torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))


def _embed(params, cfg, tok):
    x = params["embed"][tok.long()].to(torch_dtype(cfg))
    return x + params["pos_embed"][:tok.shape[1]].to(x.dtype)[None]


def _decoder_seq(params, cfg, x, enc, positions, cache_len=None):
    """The decoder over a whole sequence -> (x, cache): with ``cache_len`` the
    decode cache's stacked ``self`` entries {k, v, pos, xk, xv} (a ring of
    ``cache_len`` slots), else None (training builds no cache)."""
    dtype = torch_dtype(cfg)
    B, S = positions.shape
    enc_pos = _positions(B, enc.shape[1], x.device)
    per_layer = []
    for bp in layer_slices(params["decoder"], cfg.num_layers):
        h = L.layer_norm(x, bp["ln1"], bp["ln1b"], cfg.norm_eps)
        q, k, v = L.project_qkv(bp["self_attn"], h, cfg.kv_repeat)
        a = L.blocked_attention(q, k, v, positions, positions, causal=True,
                                block_q=cfg.attn_block_q)
        x = x + L.attn_output(bp["self_attn"], a)
        h = L.layer_norm(x, bp["lnx"], bp["lnxb"], cfg.norm_eps)
        qx, kx, vx = L.project_qkv(bp["cross_attn"], h, 1, x_kv=enc)
        a = L.blocked_attention(qx, kx, vx, positions, enc_pos, causal=False,
                                block_q=cfg.attn_block_q)
        x = x + L.attn_output(bp["cross_attn"], a)
        h = L.layer_norm(x, bp["ln2"], bp["ln2b"], cfg.norm_eps)
        x = x + L.gelu_mlp(bp["mlp"], h)
        if cache_len is not None:
            ck = torch.zeros((B, cache_len) + tuple(k.shape[2:]), dtype=dtype, device=x.device)
            cv = torch.zeros_like(ck)
            cp = torch.full((B, cache_len), -1, dtype=torch.int32, device=x.device)
            ck[:, :S], cv[:, :S], cp[:, :S] = k, v, positions
            per_layer.append({"k": ck, "v": cv, "pos": cp, "xk": kx.to(dtype),
                              "xv": vx.to(dtype)})
    if cache_len is None:
        return x, None
    return x, {name: torch.stack([c[name] for c in per_layer]) for name in per_layer[0]}


def encdec_loss(params, cfg, batch):
    """Training objective -> (loss, {"ce"}); ``batch`` holds frames (B, S_enc,
    d), tokens (B, S) and targets (B, S), -1 for no target."""
    enc = encode(params, cfg, batch["frames"])
    tok = batch["tokens"]
    x = _embed(params, cfg, tok)
    x, _ = _decoder_seq(params, cfg, x, enc, _positions(*tok.shape, x.device))
    targets = batch["targets"]
    loss = L.cross_entropy_loss(_logits(params, cfg, x), torch.clamp_min(targets, 0),
                                targets >= 0)
    return loss, {"ce": loss}


def encdec_prefill(params, cfg, batch, max_seq=None):
    """Encoder plus decoder prompt -> (last-token logits (B, V), decode cache).

    ``batch`` holds ``frames`` (B, S_enc, d) and ``tokens`` (B, S).
    ``max_seq`` sizes the self-attention ring (>= S; default S).  The cache
    is the reference's tree: ``pos`` (B,), ``self`` {k, v, pos, xk, xv}, each
    stacked over the decoder layers, and ``enc_pos`` (B, S_enc) int32.
    """
    enc = encode(params, cfg, batch["frames"])
    tok = batch["tokens"]
    B, S = tok.shape
    x = _embed(params, cfg, tok)
    x, caches = _decoder_seq(params, cfg, x, enc, _positions(B, S, x.device),
                             cache_len=max(max_seq or S, S))
    logits = _logits(params, cfg, x[:, -1:, :])[:, 0]
    return logits, {"pos": torch.full((B,), S, dtype=torch.int32, device=x.device),
                    "self": caches, "enc_pos": _positions(B, enc.shape[1], x.device)}


def encdec_decode_step(params, cfg, cache, tokens):
    """One decoder token against the cached self and cross K / V: tokens (B,) ->
    (logits (B, V), cache).  The self-attention ring is written in place."""
    pos = cache["pos"]
    x = params["embed"][tokens[:, None].long()].to(torch_dtype(cfg))
    x = x + params["pos_embed"][pos.long()][:, None].to(x.dtype)
    enc_pos = cache["enc_pos"]
    # the query sits at the last frame: every frame is visible, the reference's causal=False
    enc_last = torch.full_like(pos, enc_pos.shape[1] - 1, dtype=torch.int32)
    pos32 = pos.to(torch.int32)
    sc = cache["self"]
    for li, bp in enumerate(layer_slices(params["decoder"], cfg.num_layers)):
        h = L.layer_norm(x, bp["ln1"], bp["ln1b"], cfg.norm_eps)
        q, k, v = L.project_qkv(bp["self_attn"], h, cfg.kv_repeat)
        ck, cv, cp = L.cache_write(sc["k"][li], sc["v"][li], sc["pos"][li], k, v, pos)
        x = x + L.attn_output(bp["self_attn"], decode_attention(q, ck, cv, cp, pos32))
        h = L.layer_norm(x, bp["lnx"], bp["lnxb"], cfg.norm_eps)
        qx = torch.einsum("bsd,dhk->bshk", h, bp["cross_attn"]["wq"].to(h.dtype))
        a = decode_attention(qx, sc["xk"][li], sc["xv"][li], enc_pos, enc_last)
        x = x + L.attn_output(bp["cross_attn"], a)
        h = L.layer_norm(x, bp["ln2"], bp["ln2b"], cfg.norm_eps)
        x = x + L.gelu_mlp(bp["mlp"], h)
    logits = _logits(params, cfg, x)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache


def init_encdec_cache(cfg, batch: int, seq_len: int, prefilled: int = 0, device=None) -> dict:
    """The reference's ``zoo._encdec_cache``: zero K / V, slots below
    ``prefilled`` marked with their own position, the rest -1."""
    dtype = torch_dtype(cfg)
    kv_eff = cfg.num_kv_heads * cfg.kv_repeat
    hd = cfg.resolved_head_dim
    Ld = cfg.num_layers
    k = torch.zeros((Ld, batch, seq_len, kv_eff, hd), dtype=dtype, device=device)
    slots = torch.arange(seq_len, dtype=torch.int32, device=device)
    cand = torch.where(slots < prefilled, slots, torch.full_like(slots, -1))
    xk = torch.zeros((Ld, batch, cfg.encoder_seq, kv_eff, hd), dtype=dtype, device=device)
    return {
        "pos": torch.full((batch,), prefilled, dtype=torch.int32, device=device),
        "self": {"k": k, "v": torch.zeros_like(k),
                 "pos": cand[None, None, :].repeat(Ld, batch, 1),
                 "xk": xk, "xv": torch.zeros_like(xk)},
        "enc_pos": _positions(batch, cfg.encoder_seq, device),
    }
