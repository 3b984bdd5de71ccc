"""Decoder-only LM engine of the port (``repro.models.transformer``), every
decoder-only family of the reference:

  dense  : ln -> GQA attn -> res -> ln -> SwiGLU -> res
  moe    : ln -> GQA attn -> res -> ln -> MoE FFN -> res
  ssm    : ln -> mamba2 mixer -> res                       (no attn, no MLP)
  hybrid : ln -> (GQA attn || mamba2) averaged -> res -> ln -> SwiGLU -> res
  vlm    : dense blocks; stubbed image patch embeddings go in front of the
           token embeddings at prefill

Layers are stacked with a leading ``layers`` axis per pattern sub-layer, as
in the reference; a Python loop over that axis takes the place of
``lax.scan``.  Sequence-mode attention is ``layers.blocked_attention`` in
plain torch and the MoE FFN is ``models.moe.moe_ffn`` in plain torch; every
decode step's attention goes through ``kernels.swa_decode`` and every
prefill's SSM scan through ``kernels.ssd_scan`` (hand-written CUDA on the
card, their plain versions on the CPU).  The reference's ``act_shard``
annotations and remat policies are dropped (``sharding.act_shard`` is a
no-op); only the chunked loss (``_chunked_ce``) and the training scan's
chunks (``models/ssm.py``) keep their remat.

Sharded serving (the ``dense``, ``moe``, ``vlm``, ``ssm`` and ``hybrid``
families): inside
``sharding.activation_sharding`` each process runs one rank of a ``(1,
model)`` mesh on its blocks of the weights (``lm_param_axes`` resolved under
``SERVE_RULES``; ``sharding.make_rank`` reads the layout off those specs,
never assumes it).  q, k and v are projected on the rank's heads (RoPE,
``blocked_attention`` and the ring cache unchanged, the cache holding the
rank's kv heads, decode through ``swa_decode`` on them), ``wo`` gives a
partial sum; the SwiGLU's ``w_gate`` / ``w_up`` hold the rank's ffn columns
and ``w_down`` its rows; the MoE layer is ``moe.moe_ffn_local``; each of
these ends in one sum over ``model`` (``Rank.all_reduce``).  The embedding
holds the rank's vocab rows: a token outside them gives 0, and the sum over
ranks is exact, ``embed_scale`` applied after it; the LM head gives the
rank's vocab columns, gathered to the whole vocab, so every rank takes the
same greedy argmax.  The mamba2 mixer (``ssm`` and ``hybrid``) runs on the
rank's ``ssm_inner`` columns and ends in its own sum over ``model``
(``models/ssm.py``): an ``ssm`` block adds it to the residual as it is, a
``hybrid`` block norms it (``ssm_out_norm``) beside its attention branch,
which is replicated where its heads do not divide the ranks (hymba-1.5b's 25
heads and 5 kv heads on 4: every rank runs every head, no sum).  A rank's
decode cache holds the blocks it computes (``init_lm_cache`` inside the
context): its kv heads, and its SSM state, ``h`` ``(B, heads, Rank.ssm_hp,
ds)`` and ``conv`` ``(B, width - 1, (c1 - c0) + 2 ds)``.  The reference's
resolved cache spec (``lm_cache_axes`` under ``SERVE_RULES``) replicates ``h``
where ``ssm_heads`` does not divide the ranks (hymba-1.5b on 4), while each
rank here holds only the block it computes; the tests gather the ranks'
blocks into the reference's layout.  Outside the context nothing of this
runs: the unsharded path's ops are as they were.

``lm_loss`` is the training objective: ``forward_seq`` in its ``train`` mode
(no cache is built), the MoE layers' load-balance losses summed over the
layers in fp32, and the CE over the whole logits or chunk by chunk.  It is
differentiable by autograd and runs no kernel: under grad mode the ``ssm``
and ``hybrid`` families' scan is the plain one (``models/ssm.py``).
``lm_decode_step`` updates the cache it is given in place and returns it.
The ``encdec`` family (whisper-small) lives in ``models/encdec.py``, which
shares this module's helpers, the rank-aware ones among them
(``project_qkv_local``, ``attn_out_summed``, ``embed_rows``,
``gather_vocab``; its GELU MLP sums over ``model`` in ``layers.gelu_mlp``);
``models.zoo.build_lm`` picks the engine.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import swa_decode as _swa
from repro_torch.models import layers as L
from repro_torch.models.moe import MOE_AXES, init_moe, moe_ffn
from repro_torch.models.ssm import SSM_PARAM_AXES, SSM_STATE_AXES, init_ssm, init_ssm_state, \
    ssm_forward
from repro_torch.sharding.context import current_rank
from repro_torch.utils import prng

PORTED_FAMILIES = ("hybrid", "ssm", "dense", "moe", "vlm", "encdec")


def check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"LM family {cfg.family!r} ({cfg.name}) is not ported yet (see ROADMAP.md); "
            f"ported: {', '.join(PORTED_FAMILIES)}")


def torch_dtype(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


# ---------------------------------------------------------------------------
# pattern helpers
# ---------------------------------------------------------------------------


def pattern_period(cfg) -> int:
    return max(len(cfg.layer_pattern), 1)


def pattern_kinds(cfg) -> tuple:
    return tuple(cfg.layer_kind(i) for i in range(pattern_period(cfg)))


def kind_window(cfg, kind: str, long_ctx_cap: int = 0) -> int:
    """Static attention window for a sub-layer kind (0 = unlimited)."""
    if kind == "full":
        return 0
    if kind == "global":
        return long_ctx_cap
    return cfg.sliding_window


def cache_len_for(cfg, kind: str, seq_len: int) -> int:
    w = kind_window(cfg, kind, long_ctx_cap=0)
    if kind == "global" and cfg.variant == "swa-capped":
        w = 32_768
    return min(seq_len, w) if w else seq_len


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _has_attn(cfg) -> bool:
    return cfg.family in ("dense", "moe", "vlm", "hybrid")


def _has_ssm(cfg) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _ffn_kind(cfg):
    if cfg.family == "moe":
        return "moe"
    if cfg.family in ("dense", "vlm", "hybrid"):
        return "swiglu"
    return None  # ssm: no FFN (mamba2 mixer only)


def init_lm(key, cfg, device=None, shard=None) -> dict:
    """Parameter tree (dict of tensors) of an LM, drawn as the reference's:
    block key ``bk[0]`` draws the attention, ``bk[1]`` the SSM, ``bk[2]`` the FFN.
    ``shard``: each leaf's block (``sharding.init_shard``: a rank's shard)."""
    check_family(cfg)
    p = pattern_period(cfg)
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} % pattern {p} != 0")
    Lp = cfg.num_layers // p
    dtype = torch_dtype(cfg)
    device = key.device if device is None else torch.device(device)
    keys = prng.split(key, 3 + p)
    d = cfg.d_model
    b = lambda tree, name: L.blocks_of(tree, name)  # noqa: E731
    params: dict[str, Any] = {
        "embed": L.init_embedding(keys[0], cfg.padded_vocab, d, dtype, device, b(shard, "embed")),
        "final_norm": L.ones_init((d,), dtype, device, b(shard, "final_norm")),
        "blocks": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(keys[1], (d, cfg.padded_vocab), d, dtype,
                                         device=device, block=b(shard, "lm_head"))
    for i in range(p):
        bk = prng.split(keys[3 + i], 4)
        bs = None if shard is None else shard["blocks"][i]
        block = {"ln1": L.ones_init((Lp, d), dtype, device, b(bs, "ln1"))}
        if _has_attn(cfg):
            block["attn"] = L.init_attention(bk[0], cfg, Lp, dtype, device, shard=b(bs, "attn"))
        if _has_ssm(cfg):
            block["ssm"] = init_ssm(bk[1], cfg, Lp, dtype, device, b(bs, "ssm"))
            if cfg.family == "hybrid":
                block["attn_out_norm"] = L.ones_init((Lp, d), dtype, device,
                                                     b(bs, "attn_out_norm"))
                block["ssm_out_norm"] = L.ones_init((Lp, d), dtype, device,
                                                    b(bs, "ssm_out_norm"))
        ffn = _ffn_kind(cfg)
        if ffn == "moe":
            block["moe"] = init_moe(bk[2], cfg, Lp, dtype, device, b(bs, "moe"))
        elif ffn == "swiglu":
            block["mlp"] = L.init_swiglu(bk[2], d, cfg.d_ff, Lp, dtype, device, b(bs, "mlp"))
        if ffn:
            block["ln2"] = L.ones_init((Lp, d), dtype, device, b(bs, "ln2"))
        params["blocks"].append(block)
    return params


def lm_param_axes(cfg) -> dict:
    """The logical axes of ``init_lm``'s leaves, one name (or None) a
    dimension: the reference's annotations (``repro.sharding.split_params``
    of its ``init_lm``)."""
    check_family(cfg)
    norm = ("layers", "embed")
    axes: dict[str, Any] = {"embed": ("vocab", "embed"), "final_norm": ("embed",),
                            "blocks": []}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    for _ in range(pattern_period(cfg)):
        block: dict[str, Any] = {"ln1": norm}
        if _has_attn(cfg):
            block["attn"] = L.attention_axes(cfg.qkv_bias)
        if _has_ssm(cfg):
            block["ssm"] = dict(SSM_PARAM_AXES)
            if cfg.family == "hybrid":
                block["attn_out_norm"] = block["ssm_out_norm"] = norm
        ffn = _ffn_kind(cfg)
        if ffn == "moe":
            block["moe"] = dict(MOE_AXES)
        elif ffn == "swiglu":
            block["mlp"] = dict(L.SWIGLU_AXES)
        if ffn:
            block["ln2"] = norm
        axes["blocks"].append(block)
    return axes


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_lm_cache(cfg, batch: int, seq_len: int, prefilled: int = 0, device=None) -> dict:
    """Decode-state tree; ``prefilled`` marks positions [0, prefilled) as
    already written (slot p % C holds the latest such position).  Inside
    ``activation_sharding``, the rank's blocks: its kv heads and SSM state."""
    check_family(cfg)
    p = pattern_period(cfg)
    kinds = pattern_kinds(cfg)
    Lp = cfg.num_layers // p
    dtype = torch_dtype(cfg)
    rank = current_rank()
    kv_eff = rank.kv_heads if rank is not None else cfg.num_kv_heads * cfg.kv_repeat
    hd = cfg.resolved_head_dim
    layers_cache = []
    for i in range(p):
        entry = {}
        if _has_attn(cfg):
            C = cache_len_for(cfg, kinds[i], seq_len)
            k = torch.zeros((Lp, batch, C, kv_eff, hd), dtype=dtype, device=device)
            pos = torch.full((Lp, batch, C), -1, dtype=torch.int32, device=device)
            if prefilled:
                pos = L.ring_positions(prefilled, C, device)[None, None, :].expand(
                    Lp, batch, C).contiguous()
            entry["attn"] = {"k": k, "v": torch.zeros_like(k), "pos": pos}
        if _has_ssm(cfg):
            st = init_ssm_state(batch, cfg, dtype, device)
            entry["ssm"] = {n: a[None].expand((Lp,) + a.shape).contiguous()
                            for n, a in st.items()}
        layers_cache.append(entry)
    return {"pos": torch.full((batch,), prefilled, dtype=torch.int32, device=device),
            "layers": layers_cache}


def lm_cache_axes(cfg) -> dict:
    """The logical axes of ``init_lm_cache``'s leaves (the reference's; a sharded
    rank's SSM state is the block it computes, see the module docstring)."""
    check_family(cfg)
    layers_axes = []
    for _ in range(pattern_period(cfg)):
        entry: dict[str, Any] = {}
        if _has_attn(cfg):
            kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
            entry["attn"] = {"k": kv, "v": kv, "pos": ("layers", "batch", "kv_seq")}
        if _has_ssm(cfg):
            entry["ssm"] = {k: ("layers",) + v for k, v in SSM_STATE_AXES.items()}
        layers_axes.append(entry)
    return {"pos": ("batch",), "layers": layers_axes}


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def project_qkv_local(bp, x, kv_repeat: int = 1, x_kv=None):
    """q, k, v of the heads this process holds (``layers.project_qkv``; k and v
    from ``x_kv`` where it is given): all of them, or inside
    ``activation_sharding`` the rank's query heads and the kv heads they attend
    (``Rank.kv_take``)."""
    q, k, v = L.project_qkv(bp, x, kv_repeat, x_kv)
    rank = current_rank()
    if rank is not None and rank.kv_take is not None:
        a, b = rank.kv_take
        k, v = k[:, :, a:b], v[:, :, a:b]
    return q, k, v


def attn_out_summed(bp, ctx):
    """The output projection; a rank's over its heads is a partial sum, summed
    over ``model``."""
    out = L.attn_output(bp, ctx)
    rank = current_rank()
    if rank is not None and rank.heads_sharded:
        out = rank.all_reduce(out)
    return out


def _attn_seq(cfg, bp, x, positions, inv_freq, window: int, cache_len):
    """Sequence-mode attention; returns (out, cache_entry), the entry None
    where ``cache_len`` is None (training builds no cache)."""
    q, k, v = project_qkv_local(bp, x, cfg.kv_repeat)
    q = L.apply_rope(q, positions, inv_freq, cfg.rope_style)
    k = L.apply_rope(k, positions, inv_freq, cfg.rope_style)
    out = L.blocked_attention(q, k, v, positions, positions, causal=True, window=window,
                              cap=cfg.attn_logit_softcap, block_q=cfg.attn_block_q)
    out = attn_out_summed(bp, out)
    if cache_len is None:
        return out, None
    B, S = x.shape[0], x.shape[1]
    C = cache_len
    # a ring buffer of C slots holding the last min(C, S) positions (slot = pos % C)
    T = min(C, S)
    ptail = positions[..., S - T:].expand(B, T)
    slots = ptail[0] % C
    shape = (B, C) + tuple(k.shape[2:])
    ck = torch.zeros(shape, dtype=k.dtype, device=k.device)
    cv = torch.zeros(shape, dtype=v.dtype, device=v.device)
    cp = torch.full((B, C), -1, dtype=torch.int32, device=k.device)
    ck[:, slots] = k[:, S - T:]
    cv[:, slots] = v[:, S - T:]
    cp[:, slots] = ptail.to(torch.int32)
    return out, {"k": ck, "v": cv, "pos": cp}


def _attn_decode(cfg, bp, x, pos, inv_freq, window: int, cache):
    """Single-token attention against a ring-buffer cache (updated in place),
    through ``kernels.swa_decode``."""
    q, k, v = project_qkv_local(bp, x, cfg.kv_repeat)
    q = L.apply_rope(q, pos[:, None], inv_freq, cfg.rope_style)
    k = L.apply_rope(k, pos[:, None], inv_freq, cfg.rope_style)
    ck, cv, cp = L.cache_write(cache["k"], cache["v"], cache["pos"], k, v, pos)
    out = decode_attention(q, ck, cv, cp, pos.to(torch.int32), window, cfg.attn_logit_softcap)
    return attn_out_summed(bp, out), {"k": ck, "v": cv, "pos": cp}


def decode_attention(q, k, v, kv_pos, pos, window: int = 0, softcap: float = 0.0):
    """(B, 1, H, D) queries against one layer's cache (B, C, Hkv, D) through
    ``kernels.swa_decode`` -> (B, 1, H, D) in q's dtype."""
    B, _, H, D = q.shape
    hkv = k.shape[2]
    # query head hkv_i * G + g attends kv head hkv_i (layers.blocked_attention's grouping)
    out = _swa.swa_decode(q.reshape(B, hkv, H // hkv, D), k, v, kv_pos, pos, window=window,
                          softcap=softcap)
    return out.to(q.dtype).reshape(B, 1, H, D)


def apply_block(cfg, kind: str, bp, x, positions, inv_freq, mode: str, cache=None,
                seq_len_hint: int = 0):
    """One sub-layer in ``mode`` ``prefill``, ``decode`` or ``train``.  Returns
    (x, new_cache_entry, aux): the cache entries the block has (none in
    ``train``), and the MoE layer's load-balance loss (None without one)."""
    window = kind_window(cfg, kind, long_ctx_cap=32_768 if cfg.variant == "swa-capped" else 0)
    decode = mode == "decode"
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps, cfg.zero_centered_norm)
    new_cache = {}
    aux = None
    if "attn" in bp:
        if decode:
            a, ac = _attn_decode(cfg, bp["attn"], h, positions, inv_freq, window, cache["attn"])
        else:
            C = None if mode == "train" else cache_len_for(cfg, kind, seq_len_hint or h.shape[1])
            a, ac = _attn_seq(cfg, bp["attn"], h, positions, inv_freq, window, C)
        if mode != "train":
            new_cache["attn"] = ac
    if "ssm" in bp:
        s, st = ssm_forward(bp["ssm"], h, cfg, state=cache["ssm"] if decode else None,
                            decode=decode)
        if mode != "train":
            new_cache["ssm"] = st
    if cfg.family == "ssm":
        return x + s, new_cache, aux
    if cfg.family == "hybrid":
        a = L.rms_norm(a, bp["attn_out_norm"], cfg.norm_eps)
        s = L.rms_norm(s, bp["ssm_out_norm"], cfg.norm_eps)
        x = x + 0.5 * (a + s)  # in the model dtype, as the reference rounds it
    else:  # dense / moe / vlm
        x = x + a
    if "ln2" in bp:
        h2 = L.rms_norm(x, bp["ln2"], cfg.norm_eps, cfg.zero_centered_norm)
        if "moe" in bp:
            y, aux = moe_ffn(bp["moe"], h2, cfg)
        else:
            y = L.swiglu(bp["mlp"], h2)
            rank = current_rank()
            if rank is not None and rank.mlp_sharded:  # a partial sum over the rank's ffn
                y = rank.all_reduce(y)
        x = x + y
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# full forward passes
# ---------------------------------------------------------------------------


def _layer_slice(tree, i: int):
    """Layer ``i``'s views of a stacked cache tree (written in place by decode)."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def layer_slices(tree, n: int) -> list:
    """The ``n`` layer slices of a stacked tree, one ``unbind`` a leaf: its
    backward stacks the layers' gradients in one op, where indexing layer by
    layer would add one full-size zero-padded gradient a layer."""
    if isinstance(tree, dict):
        parts = {k: layer_slices(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def embed_rows(embed, tokens, dtype):
    """The embedding rows of ``tokens`` in ``dtype``.  Inside
    ``activation_sharding`` a rank holds its vocab rows: a token outside them
    gives 0; one rank holds each token's row, so the sum over ranks is exact."""
    rank = current_rank()
    if rank is not None and rank.vocab_range is not None:
        v0, v1 = rank.vocab_range
        local = tokens.long() - v0
        inside = (local >= 0) & (local < v1 - v0)
        rows = embed[torch.where(inside, local, torch.zeros_like(local))]
        return rank.all_reduce(torch.where(inside[..., None], rows,
                                           torch.zeros_like(rows))).to(dtype)
    return embed[tokens.long()].to(dtype)


def _embed_tokens(params, cfg, tokens):
    x = embed_rows(params["embed"], tokens, torch_dtype(cfg))
    if cfg.embed_scale:
        # the reference's Python scalar is weakly typed: it rounds to the model
        # dtype before the product (sqrt(3584) is 59.75 in bf16)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def _assemble_input(params, cfg, batch):
    """Token embeddings, with the stubbed image patches in front for ``vlm``."""
    x = _embed_tokens(params, cfg, batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    return x


def _head(params, cfg):
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _logits(params, cfg, x):
    """Final norm and LM head; ``final_logit_softcap`` belongs to the loss, as in
    the reference, and is not applied here.  A rank's head holds its vocab
    columns: the ranks' logits are gathered to the whole vocab."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.zero_centered_norm)
    return gather_vocab(torch.einsum("bsd,dv->bsv", x, _head(params, cfg).to(x.dtype)))


def gather_vocab(logits):
    """Logits over the whole vocab: inside ``activation_sharding`` a rank's
    head gives its vocab columns, gathered over ``model`` in rank order."""
    rank = current_rank()
    if rank is not None and rank.vocab_range is not None:
        logits = rank.all_gather(logits, dim=-1)
    return logits


def _ce_chunk(xb, head, tb, cap: float):
    """One chunk's (sum of masked NLL, token count), both fp32."""
    logits = torch.einsum("bsd,dv->bsv", xb, head.to(xb.dtype))
    return L.masked_nll(logits, torch.clamp_min(tb, 0), tb >= 0, cap)


def _chunked_ce(params, cfg, x, targets, chunk: int):
    """CE over sequence chunks of ``chunk`` positions (targets padded with -1):
    each chunk's (B, chunk, V) fp32 logits are recomputed in the backward
    (``torch.utils.checkpoint``) instead of kept, so the whole (B, S, V)
    logits never stand at once.  -> sum of NLL / max(token count, 1)."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.zero_centered_norm)
    head = _head(params, cfg)
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    s_nll = s_cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S + pad, chunk):
        nll, cnt = checkpoint(_ce_chunk, x[:, c0:c0 + chunk], head,
                              targets[:, c0:c0 + chunk], cfg.final_logit_softcap,
                              use_reentrant=False)
        s_nll, s_cnt = s_nll + nll, s_cnt + cnt
    return s_nll / torch.clamp_min(s_cnt, 1.0)


def lm_loss(params, cfg, batch):
    """Training objective -> (loss, {"ce", "aux"}); ``batch`` holds tokens (B,
    S) and targets (B, S), -1 for no target, and for ``vlm`` image_embeds,
    whose positions get no target.  loss = ce + router_aux_loss * aux."""
    if current_rank() is not None:
        raise NotImplementedError("lm_loss: sharded training is not ported yet (ROADMAP A13)")
    x = _assemble_input(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    x, _, aux = forward_seq(params, cfg, x, positions, "train")
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    targets = batch["targets"]
    if cfg.family == "vlm":
        pad = torch.full((B, cfg.num_image_tokens), -1, dtype=targets.dtype,
                         device=targets.device)
        targets = torch.cat([pad, targets], dim=1)
    if cfg.loss_chunk and S > cfg.loss_chunk:
        loss = _chunked_ce(params, cfg, x, targets, cfg.loss_chunk)
    else:
        loss = L.cross_entropy_loss(_logits(params, cfg, x), torch.clamp_min(targets, 0),
                                    targets >= 0, cfg.final_logit_softcap)
    return loss + cfg.router_aux_loss * aux, {"ce": loss, "aux": aux}


def forward_seq(params, cfg, x, positions, mode: str = "prefill", max_seq=None):
    """All layers in sequence mode -> (x, caches, aux).  In ``prefill`` mode
    caches[i] stacks sub-layer i's entries over the layer axis, as the
    reference's scan does; in ``train`` mode no cache is built (caches is
    None).  aux sums the MoE layers' load-balance losses in fp32, layer by
    layer from zero (None for a family without MoE layers)."""
    check_family(cfg)
    p = pattern_period(cfg)
    kinds = pattern_kinds(cfg)
    inv_freq = L.rope_frequencies(cfg.resolved_head_dim, cfg.rope_style, cfg.rope_theta,
                                  x.device)
    S = max_seq or x.shape[1]
    Lp = cfg.num_layers // p
    blocks = [layer_slices(b, Lp) for b in params["blocks"]]
    per_layer = [[] for _ in range(p)]
    aux = None
    for li in range(Lp):
        for i in range(p):
            x, nc, a = apply_block(cfg, kinds[i], blocks[i][li], x, positions, inv_freq, mode,
                                   seq_len_hint=S)
            per_layer[i].append(nc)
            if a is not None:
                aux = a if aux is None else aux + a
    if mode == "train":
        return x, None, aux
    return x, [_stack(entries) for entries in per_layer], aux


def _stack(entries):
    first = entries[0]
    if isinstance(first, dict):
        return {k: _stack([e[k] for e in entries]) for k in first}
    return torch.stack(entries)


def lm_prefill(params, cfg, batch, max_seq=None):
    """Full-context forward -> (last-token logits (B, V), decode cache).

    ``batch`` holds ``tokens`` (B, S), and for ``vlm`` ``image_embeds`` (B,
    num_image_tokens, d): positions then run over both.  ``max_seq`` sizes
    the decode KV budget (>= the positions prefilled); default all of them.
    """
    x = _assemble_input(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    x, caches, _ = forward_seq(params, cfg, x, positions, "prefill", max_seq=max_seq or S)
    logits = _logits(params, cfg, x[:, -1:, :])[:, 0]
    return logits, {"pos": torch.full((B,), S, dtype=torch.int32, device=x.device),
                    "layers": caches}


def lm_decode_step(params, cfg, cache, tokens):
    """One decode step: tokens (B,) -> (logits (B, V), cache).  The stacked
    caches are updated in place, layer by layer, and returned."""
    check_family(cfg)
    p = pattern_period(cfg)
    kinds = pattern_kinds(cfg)
    pos = cache["pos"]
    x = _embed_tokens(params, cfg, tokens[:, None])
    inv_freq = L.rope_frequencies(cfg.resolved_head_dim, cfg.rope_style, cfg.rope_theta,
                                  x.device)
    Lp = cfg.num_layers // p
    blocks = [layer_slices(b, Lp) for b in params["blocks"]]
    for li in range(Lp):
        for i in range(p):
            lc = _layer_slice(cache["layers"][i], li)
            x, nc, _ = apply_block(cfg, kinds[i], blocks[i][li], x, pos, inv_freq, "decode",
                                   cache=lc)
            # an attention entry was written in place; an SSM state is new
            for name, new in nc.get("ssm", {}).items():
                cache["layers"][i]["ssm"][name][li] = new.to(lc["ssm"][name].dtype)
    logits = _logits(params, cfg, x)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache
