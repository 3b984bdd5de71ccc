"""Mamba2 (state-space duality) mixer of the LM zoo (``repro.models.ssm``).

Sequence mode runs the chunked SSD scan.  Under grad mode with an operand
that requires grad (training) it is ``kernels.ssd_scan.ssd_scan_plain``,
each chunk rematerialized, on whatever device the operands are on (the
reference trains through its plain scan under ``jax.checkpoint`` too);
otherwise (prefill) ``kernels.ssd_scan``: the hand-written CUDA kernel on
the card, its plain version on the CPU.  Decode mode is the single-token
recurrence in plain torch (no TPU kernel covers it).  Layout as in the
reference: one B/C group shared by the heads, a separate projection per
stream.

Where bf16 rounds (the model dtype at full width): the causal conv sums its
taps in the model dtype, tap by tap from the first, as the reference does;
softplus, the gate and the norm run in fp32.

Sharded (inside ``sharding.activation_sharding``, a ``Rank`` whose
``ssm_sharded`` is set): ``in_z`` / ``in_x`` give the rank's ``ssm_inner``
columns ``[c0, c1)``; the depthwise conv runs on those columns and the last
``2 ds`` (B and C, whole on every rank); the scan (``kernels.ssd_scan``) and
the decode recurrence run over the rank's heads, ``Rank.ssm_hp`` columns
each: its whole heads, or virtual heads that take their parent head's
``dt``, ``A`` and ``D`` (``Rank.ssm_parent``); the ``D`` skip and the
``silu(z)`` gate are local.  The gated norm's mean of squares runs over the
whole ``d_inner``: each rank sums its squares in fp32 and the sums are summed
over ``model`` before the division.  ``out_proj`` over the rank's rows gives
a partial sum, summed over ``model``.  The state a rank carries is the block
it computes: ``h`` ``(B, heads, ssm_hp, ds)``, ``conv`` ``(B, width - 1, (c1
- c0) + 2 ds)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.layers import blocks_of, dense_init, ones_init, rms_norm, take, zeros_init
from repro_torch.sharding.context import current_rank
from repro_torch.utils import prng


def init_ssm(key, cfg, num_layers: int, dtype, device=None, shard=None):
    """The mixer's stacked params; ``shard``: each leaf's block (a rank's
    shard; the small per-head fp32 leaves are drawn whole and cut)."""
    d, di, ds, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads
    w = cfg.ssm_conv_width
    conv_dim = di + 2 * ds
    ks = prng.split(key, 8)
    L = num_layers
    b = lambda name: blocks_of(shard, name)  # noqa: E731
    # A initialized in [1, 16], dt_bias ~ softplus^-1 of dt in [1e-3, 1e-1]
    log = lambda x: torch.log(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    a0 = torch.exp(prng.uniform(ks[0], (L, nh), log(1.0), log(16.0), device))
    dt0 = torch.exp(prng.uniform(ks[1], (L, nh), log(1e-3), log(1e-1), device))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    return {
        "in_z": dense_init(ks[2], (L, d, di), d, dtype, device=device, block=b("in_z")),
        "in_x": dense_init(ks[3], (L, d, di), d, dtype, device=device, block=b("in_x")),
        "in_B": dense_init(ks[4], (L, d, ds), d, dtype, device=device, block=b("in_B")),
        "in_C": dense_init(ks[5], (L, d, ds), d, dtype, device=device, block=b("in_C")),
        "in_dt": dense_init(ks[6], (L, d, nh), d, dtype, device=device, block=b("in_dt")),
        "conv_w": dense_init(ks[7], (L, w, conv_dim), w, dtype, device=device,
                             block=b("conv_w")),
        "conv_b": zeros_init((L, conv_dim), dtype, device, b("conv_b")),
        "A_log": take(torch.log(a0), b("A_log")),
        "dt_bias": take(dt_bias, b("dt_bias")),
        "D": ones_init((L, nh), torch.float32, device, b("D")),
        "norm_w": ones_init((L, di), dtype, device, b("norm_w")),
        "out_proj": dense_init(ks[0], (L, di, d), di, dtype, device=device,
                               block=b("out_proj")),
    }


# the logical axes of ``init_ssm``'s leaves (the reference's annotations) and
# of ``init_ssm_state``'s
SSM_PARAM_AXES = {
    "in_z": ("layers", "embed", "ssm_inner"),
    "in_x": ("layers", "embed", "ssm_inner"),
    "in_B": ("layers", "embed", "ssm_state"),
    "in_C": ("layers", "embed", "ssm_state"),
    "in_dt": ("layers", "embed", "ssm_heads"),
    "conv_w": ("layers", "conv", None),
    "conv_b": ("layers", None),
    "A_log": ("layers", "ssm_heads"),
    "dt_bias": ("layers", "ssm_heads"),
    "D": ("layers", "ssm_heads"),
    "norm_w": ("layers", "ssm_inner"),
    "out_proj": ("layers", "ssm_inner", "embed"),
}
SSM_STATE_AXES = {
    "h": ("batch", "ssm_heads", None, "ssm_state"),
    "conv": ("batch", "conv", None),
}


def local_layout(cfg):
    """(columns, heads, head width) of the mixer this process runs: the whole
    mixer, or inside ``activation_sharding`` the rank's block of it."""
    rank = current_rank()
    if rank is not None and rank.ssm_sharded:
        c0, c1 = rank.ssm_cols
        return c1 - c0, (c1 - c0) // rank.ssm_hp, rank.ssm_hp
    return cfg.ssm_d_inner, cfg.ssm_num_heads, cfg.ssm_head_dim


def init_ssm_state(batch: int, cfg, dtype, device=None):
    """A zero decode state; inside ``activation_sharding`` the rank's block."""
    di, nh, hp = local_layout(cfg)
    ds = cfg.ssm_state
    conv_dim = di + 2 * ds
    return {
        "h": torch.zeros((batch, nh, hp, ds), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def gather_state(parts, cfg):
    """The ranks' SSM states, each the block it computes, as one state in the
    reference's layout.  ``parts``: in rank order, ``(cols, {"h", "conv"})``,
    ``cols`` the rank's ``Rank.ssm_cols``; a leaf may carry leading axes
    (layers), ``h`` ``(..., heads, hp_v, ds)`` and ``conv`` ``(..., width - 1,
    (c1 - c0) + 2 ds)``.  -> ``{"h": (..., nh, hp, ds), "conv": (..., width -
    1, d_inner + 2 ds)}``; B and C's conv columns are rank 0's (every rank
    holds them whole)."""
    ds, di = cfg.ssm_state, cfg.ssm_d_inner
    cols = [c for c, _ in parts]
    if [c0 for c0, _ in cols] != [0] + [c1 for _, c1 in cols[:-1]] or cols[-1][1] != di:
        raise ValueError(f"gather_state: the ranks' columns {cols} do not tile [0, {di})")
    h = torch.cat([st["h"].flatten(-3, -2) for _, st in parts], dim=-2)
    conv = torch.cat([st["conv"][..., :c1 - c0] for (c0, c1), st in parts]
                     + [parts[0][1]["conv"][..., -2 * ds:]], dim=-1)
    return {"h": h.unflatten(-2, (cfg.ssm_num_heads, cfg.ssm_head_dim)), "conv": conv}


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv; xbc (B, S, C), w (width, C); taps summed in the
    model dtype from the first, then silu in fp32."""
    width = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = pad[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return F.silu((out + b[None, None, :]).to(torch.float32)).to(xbc.dtype)


def _norm_over_ranks(x, weight, eps, width, rank):
    """``layers.rms_norm`` over a row cut over ``model``: each rank's fp32
    squares summed, the sums summed over ``model``, divided by the whole
    ``width``; then the rank's columns scaled by its block of ``weight``."""
    xf = x.to(torch.float32)
    var = rank.all_reduce(torch.sum(torch.square(xf), dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps) * weight.to(torch.float32)).to(x.dtype)


def ssm_forward(p, x, cfg, state=None, decode: bool = False):
    """One mamba2 mixer; ``p`` is one layer's slice (a rank's blocks inside
    ``activation_sharding``).

    Sequence mode: x (B, S, d) -> (y, new_state); ``state`` may give h0.
    Decode mode: x (B, 1, d) + state -> (y (B, 1, d), new_state).
    """
    ds = cfg.ssm_state
    di, nh, hp = local_layout(cfg)
    rank = current_rank()
    sharded = rank is not None and rank.ssm_sharded
    z = torch.einsum("bsd,de->bse", x, p["in_z"].to(x.dtype))
    xc = torch.einsum("bsd,de->bse", x, p["in_x"].to(x.dtype))
    Bc = torch.einsum("bsd,dn->bsn", x, p["in_B"].to(x.dtype))
    Cc = torch.einsum("bsd,dn->bsn", x, p["in_C"].to(x.dtype))
    dt_raw = torch.einsum("bsd,dh->bsh", x, p["in_dt"].to(x.dtype))
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])  # (nh,)
    D = p["D"]
    w, b = p["conv_w"], p["conv_b"]
    if sharded:
        c0, c1 = rank.ssm_cols
        bc = cfg.ssm_d_inner  # B and C's conv channels follow the inner ones
        w = torch.cat([w[:, c0:c1], w[:, bc:]], dim=1)
        b = torch.cat([b[c0:c1], b[bc:]])
        if rank.ssm_parent is not None:  # virtual heads take their parent's dt, A, D
            parent = rank.ssm_parent_index(x.device)
            dt, A, D = dt[..., parent], A[parent], D[parent]

    xbc = torch.cat([xc, Bc, Cc], dim=-1)

    if decode:
        assert state is not None
        conv_in = torch.cat([state["conv"], xbc], dim=1)  # (B, width, C)
        new_conv = conv_in[:, 1:, :]
        width = w.shape[0]
        out = conv_in[:, 0, :] * w[0][None, :]
        for i in range(1, width):
            out = out + conv_in[:, i, :] * w[i][None, :]
        out = out + b[None, :]
        xbc_t = F.silu(out.to(torch.float32)).to(x.dtype)  # (B, C)
        xs, Bss, Css = torch.split(xbc_t, [di, ds, ds], dim=-1)
        xhh = xs.reshape(-1, nh, hp).to(torch.float32)
        dt1 = dt[:, 0]  # (B, nh)
        dA = torch.exp(dt1 * A)  # (B, nh)
        h = state["h"] * dA[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhpn", Bss.to(torch.float32), dt1, xhh)
        y = torch.einsum("bhpn,bn->bhp", h, Css.to(torch.float32))
        y = y + D[None, :, None] * xhh
        y = y.reshape(-1, 1, di).to(x.dtype)
        new_state = {"h": h, "conv": new_conv}
    else:
        xbc_t = _causal_conv(xbc, w, b)
        xs, Bss, Css = torch.split(xbc_t, [di, ds, ds], dim=-1)
        xhh = xs.reshape(x.shape[0], -1, nh, hp)
        h0 = state["h"] if state is not None else None
        ops = (xhh.contiguous(), dt.contiguous(), A.contiguous(), Bss.contiguous(),
               Css.contiguous())
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in ops + (h0,)):
            y, h = _ssd.ssd_scan_plain(*ops, cfg.ssm_chunk, h0)
        else:
            y, h = _ssd.ssd_scan(*ops, cfg.ssm_chunk, h0)
        y = y.to(xhh.dtype)  # the reference's scan returns y in xh's dtype
        y = y.to(torch.float32) + D[None, None, :, None] * xhh.to(torch.float32)
        y = y.reshape(x.shape[0], -1, di).to(x.dtype)
        width = w.shape[0]
        tail = F.pad(xbc, (0, 0, width - 1, 0))[:, -(width - 1):, :]
        new_state = {"h": h, "conv": tail}

    gated = (y.to(torch.float32) * F.silu(z.to(torch.float32))).to(x.dtype)
    if sharded:
        out = _norm_over_ranks(gated, p["norm_w"], cfg.norm_eps, cfg.ssm_d_inner, rank)
        y = torch.einsum("bse,ed->bsd", out, p["out_proj"].to(x.dtype))
        return rank.all_reduce(y), new_state  # a partial sum over the rank's rows
    out = rms_norm(gated, p["norm_w"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", out, p["out_proj"].to(x.dtype)), new_state
