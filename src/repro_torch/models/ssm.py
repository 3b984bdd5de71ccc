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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.layers import dense_init, ones_init, rms_norm, zeros_init
from repro_torch.utils import prng


def init_ssm(key, cfg, num_layers: int, dtype, device=None):
    d, di, ds, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads
    w = cfg.ssm_conv_width
    conv_dim = di + 2 * ds
    ks = prng.split(key, 8)
    L = num_layers
    # A initialized in [1, 16], dt_bias ~ softplus^-1 of dt in [1e-3, 1e-1]
    log = lambda x: torch.log(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    a0 = torch.exp(prng.uniform(ks[0], (L, nh), log(1.0), log(16.0), device))
    dt0 = torch.exp(prng.uniform(ks[1], (L, nh), log(1e-3), log(1e-1), device))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    return {
        "in_z": dense_init(ks[2], (L, d, di), d, dtype, device=device),
        "in_x": dense_init(ks[3], (L, d, di), d, dtype, device=device),
        "in_B": dense_init(ks[4], (L, d, ds), d, dtype, device=device),
        "in_C": dense_init(ks[5], (L, d, ds), d, dtype, device=device),
        "in_dt": dense_init(ks[6], (L, d, nh), d, dtype, device=device),
        "conv_w": dense_init(ks[7], (L, w, conv_dim), w, dtype, device=device),
        "conv_b": zeros_init((L, conv_dim), dtype, device),
        "A_log": torch.log(a0),
        "dt_bias": dt_bias,
        "D": ones_init((L, nh), torch.float32, device),
        "norm_w": ones_init((L, di), dtype, device),
        "out_proj": dense_init(ks[0], (L, di, d), di, dtype, device=device),
    }


def init_ssm_state(batch: int, cfg, dtype, device=None):
    nh, hp, ds = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return {
        "h": torch.zeros((batch, nh, hp, ds), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
    }


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


def ssm_forward(p, x, cfg, state=None, decode: bool = False):
    """One mamba2 mixer; ``p`` is one layer's slice.

    Sequence mode: x (B, S, d) -> (y, new_state); ``state`` may give h0.
    Decode mode: x (B, 1, d) + state -> (y (B, 1, d), new_state).
    """
    di, ds, nh, hp = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    z = torch.einsum("bsd,de->bse", x, p["in_z"].to(x.dtype))
    xc = torch.einsum("bsd,de->bse", x, p["in_x"].to(x.dtype))
    Bc = torch.einsum("bsd,dn->bsn", x, p["in_B"].to(x.dtype))
    Cc = torch.einsum("bsd,dn->bsn", x, p["in_C"].to(x.dtype))
    dt_raw = torch.einsum("bsd,dh->bsh", x, p["in_dt"].to(x.dtype))
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])  # (nh,)

    xbc = torch.cat([xc, Bc, Cc], dim=-1)
    w, b = p["conv_w"], p["conv_b"]

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
        y = y + p["D"][None, :, None] * xhh
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
        y = y.to(torch.float32) + p["D"][None, None, :, None] * xhh.to(torch.float32)
        y = y.reshape(x.shape[0], -1, di).to(x.dtype)
        width = w.shape[0]
        tail = F.pad(xbc, (0, 0, width - 1, 0))[:, -(width - 1):, :]
        new_state = {"h": h, "conv": tail}

    gated = y.to(torch.float32) * F.silu(z.to(torch.float32))
    out = rms_norm(gated.to(x.dtype), p["norm_w"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", out, p["out_proj"].to(x.dtype)), new_state
