"""Mixture-of-Experts FFN of the port (``repro.models.moe``): top-K routing
and a capacity-bounded dispatch into ``(E, C, d)`` expert buffers.

This is the reference's single-program path (``_moe_gspmd``); its
expert-parallel ``shard_map`` path has no target on one card.  Routing
follows Mixtral: a softmax over every expert in fp32, the top K,
renormalized gates.  Each expert takes at most ``capacity(N, K, E)``
token copies, in (token, k) order; the rest are dropped.

Which copies drop depends on the exact order of the top K, so it is taken
by a stable descending sort: ties go to the lower expert index, as
``lax.top_k`` breaks them.  The dispatch makes no device-to-host sync and
no float accumulation.  Every copy is written without accumulate into one
flat buffer of ``E * C + 1`` rows: a kept copy into its own row
``e * C + slot``, a dropped one into the spare last row, which is then cut
off.  So each kept row receives exactly one copy, and the buffer equals the
reference's scatter-add bit for bit.  The expert products are three
``torch.bmm`` in the model dtype, where the reference has ``einsum``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.utils import prng


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(N: int, K: int, E: int, factor: float = 1.25) -> int:
    """Slots per expert for ``N`` tokens, in the reference's Python float
    arithmetic: ``factor * K * N / E`` truncated, at least 1, rounded up to a
    multiple of 128, and no more than ``N`` rounded up the same way."""
    C = _round_up(max(int(factor * K * N / E), 1), 128)
    return min(C, _round_up(N, 128))


def init_moe(key, cfg, num_layers: int, dtype, device=None) -> dict:
    """The router ``(L, d, E)`` in fp32; the experts' SwiGLU weights in ``dtype``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    kr, kg, ku, kd = prng.split(key, 4)
    L = num_layers
    return {
        "router": dense_init(kr, (L, d, E), d, torch.float32, device=device),
        "w_gate": dense_init(kg, (L, E, d, ff), d, dtype, device=device),
        "w_up": dense_init(ku, (L, E, d, ff), d, dtype, device=device),
        "w_down": dense_init(kd, (L, E, ff, d), ff, dtype, device=device),
    }


class Routing(NamedTuple):
    expert: torch.Tensor  # (N * K,) int64 expert id of each (token, k) copy
    gate: torch.Tensor  # (N * K,) fp32 renormalized gate
    slot: torch.Tensor  # (N * K,) int64 arrival order at its expert
    keep: torch.Tensor  # (N * K,) bool: slot < capacity
    capacity: int
    aux: torch.Tensor  # () fp32 load-balance loss


def route(router, xt, K: int, capacity_factor: float = 1.25) -> Routing:
    """Top-K routing of tokens ``xt`` (N, d) and each copy's slot."""
    probs = torch.softmax(xt.to(torch.float32) @ router.to(torch.float32), dim=-1)  # (N, E)
    eidx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :K]
    return assign(probs, eidx, capacity_factor)


def assign(probs, eidx, capacity_factor: float = 1.25) -> Routing:
    """The routing of each token's copies to experts ``eidx`` (N, K), given the
    router probabilities ``probs`` (N, E): renormalized gates, the aux loss,
    each copy's slot in (token, k) order and whether it fits the capacity."""
    (N, E), K = probs.shape, eidx.shape[1]
    gates = probs.gather(1, eidx)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch / Mixtral form)
    experts = torch.arange(E, device=probs.device)
    counts = (eidx[..., None] == experts).to(torch.float32).sum(dim=1)  # (N, E)
    aux = E * torch.sum(probs.mean(dim=0) * (counts.mean(dim=0) / K))

    flat_e = eidx.reshape(N * K)
    onehot = (flat_e[:, None] == experts).to(torch.int32)  # (NK, E)
    slot = torch.gather(torch.cumsum(onehot, dim=0), 1, flat_e[:, None])[:, 0] - 1
    C = capacity(N, K, E, capacity_factor)
    return Routing(flat_e, gates.reshape(N * K), slot, slot < C, C, aux)


def moe_ffn(p, x, cfg, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (y, aux_loss), ``p`` one layer's slice."""
    B, S, d = x.shape
    K = cfg.experts_per_token
    N = B * S
    xt = x.reshape(N, d)
    r = route(p["router"], xt, K, capacity_factor)
    E, C = p["router"].shape[-1], r.capacity

    # dispatch: kept copies to row e * C + slot, dropped ones to the spare row E * C
    row = torch.where(r.keep, r.expert * C + r.slot, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[row] = xt[:, None, :].expand(N, K, d).reshape(N * K, d)
    buf = buf[:E * C].view(E, C, d)

    # the experts' SwiGLU
    g = torch.bmm(buf, p["w_gate"].to(x.dtype))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    out_e = torch.bmm(h, p["w_down"].to(x.dtype)).view(E * C, d)

    # combine: a dropped copy reads its expert's last slot and weighs 0, as the reference's
    y_cp = out_e[torch.where(r.keep, row, r.expert * C + C - 1)].to(torch.float32)
    y_cp = y_cp * (r.gate * r.keep.to(torch.float32))[:, None]
    y = y_cp.view(N, K, d).sum(dim=1)
    return y.view(B, S, d).to(x.dtype), r.aux
