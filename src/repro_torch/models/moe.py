"""Mixture-of-Experts FFN of the port (``repro.models.moe``): top-K routing
and a capacity-bounded dispatch into ``(E, C, d)`` expert buffers.

``moe_ffn`` is the reference's single-program path (``_moe_gspmd``).
``moe_ffn_local`` is its explicit expert-parallel path (``_moe_shard_map``'s
``local_fn``), which ``moe_ffn`` takes inside ``sharding.activation_sharding``
on a mesh whose ``model`` axis has more than one rank: every rank holds the
same tokens and routes them itself (no collective), with the local capacity
(rounded to 8, not 128), and either (expert-sharded, when ``experts``
resolves to ``model``) keeps only the copies routed to its own E / tp
experts, or (ff-sliced, when ``expert_mlp`` does) runs every expert over its
slice of the ffn.  The one collective is a sum of the combined output over
``model``.  Expert-sharded with K = 2, each output element gets at most two
non-zero partials across the ranks (its token's two copies), so the sum adds
exact zeros and does not depend on the order the collective sums in.
Routing follows Mixtral: a softmax over every expert in fp32, the top K,
renormalized gates.  Each expert takes at most ``capacity(N, K, E)`` (the
local path: ``local_capacity``) token copies, in (token, k) order; the rest
are dropped.

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

from repro_torch.models.layers import blocks_of, dense_init
from repro_torch.sharding import context as _context
from repro_torch.utils import prng


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(N: int, K: int, E: int, factor: float = 1.25) -> int:
    """Slots per expert for ``N`` tokens, in the reference's Python float
    arithmetic: ``factor * K * N / E`` truncated, at least 1, rounded up to a
    multiple of 128, and no more than ``N`` rounded up the same way."""
    C = _round_up(max(int(factor * K * N / E), 1), 128)
    return min(C, _round_up(N, 128))


def local_capacity(n: int, K: int, E: int, factor: float = 1.25) -> int:
    """Slots per expert of ``moe_ffn_local`` for ``n`` local tokens: ``factor *
    K * n / E`` truncated, at least 1, rounded up to a multiple of 8, and no
    more than ``n * K`` rounded up the same way (``_moe_shard_map``'s)."""
    C = _round_up(max(int(factor * K * n / E), 1), 8)
    return min(C, _round_up(n * K, 8))


def init_moe(key, cfg, num_layers: int, dtype, device=None, shard=None) -> dict:
    """The router ``(L, d, E)`` in fp32; the experts' SwiGLU weights in ``dtype``.
    ``shard``: each leaf's block (a rank's shard)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    kr, kg, ku, kd = prng.split(key, 4)
    L = num_layers
    b = lambda name: blocks_of(shard, name)  # noqa: E731
    return {
        "router": dense_init(kr, (L, d, E), d, torch.float32, device=device, block=b("router")),
        "w_gate": dense_init(kg, (L, E, d, ff), d, dtype, device=device, block=b("w_gate")),
        "w_up": dense_init(ku, (L, E, d, ff), d, dtype, device=device, block=b("w_up")),
        "w_down": dense_init(kd, (L, E, ff, d), ff, dtype, device=device, block=b("w_down")),
    }


# the logical axes of ``init_moe``'s leaves (the reference's annotations)
MOE_AXES = {
    "router": ("layers", "embed", None),
    "w_gate": ("layers", "experts", "embed", "expert_mlp"),
    "w_up": ("layers", "experts", "embed", "expert_mlp"),
    "w_down": ("layers", "experts", "expert_mlp", "embed"),
}


class Routing(NamedTuple):
    expert: torch.Tensor  # (N * K,) int64 expert id of each (token, k) copy
    gate: torch.Tensor  # (N * K,) fp32 renormalized gate
    slot: torch.Tensor  # (N * K,) int64 arrival order at its expert
    keep: torch.Tensor  # (N * K,) bool: slot < capacity
    capacity: int
    aux: torch.Tensor  # () fp32 load-balance loss


def route(router, xt, K: int, capacity_factor: float = 1.25, capacity=None) -> Routing:
    """Top-K routing of tokens ``xt`` (N, d) and each copy's slot; ``capacity``
    (slots per expert) defaults to ``capacity(N, K, E, capacity_factor)``."""
    probs = torch.softmax(xt.to(torch.float32) @ router.to(torch.float32), dim=-1)  # (N, E)
    eidx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :K]
    return assign(probs, eidx, capacity_factor, capacity)


def assign(probs, eidx, capacity_factor: float = 1.25, slots=None) -> Routing:
    """The routing of each token's copies to experts ``eidx`` (N, K), given the
    router probabilities ``probs`` (N, E): renormalized gates, the aux loss,
    each copy's slot in (token, k) order and whether it fits the capacity
    (``slots`` an expert, else ``capacity(N, K, E, capacity_factor)``)."""
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
    C = capacity(N, K, E, capacity_factor) if slots is None else slots
    return Routing(flat_e, gates.reshape(N * K), slot, slot < C, C, aux)


def moe_ffn(p, x, cfg, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (y, aux_loss), ``p`` one layer's slice.  Inside
    ``activation_sharding`` on a mesh whose ``model`` axis has more than one
    rank, the expert-parallel ``moe_ffn_local`` on the rank's shard of ``p``."""
    rank = _context.current_rank()
    if rank is not None and rank.model > 1:
        return moe_ffn_local(p, x, cfg, rank, capacity_factor)
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


def moe_ffn_local(p, x, cfg, rank, capacity_factor: float = 1.25):
    """The expert-parallel MoE layer on one rank (``_moe_shard_map``'s
    ``local_fn``): x (B, S, d), the same on every rank of ``model``, and the
    rank's blocks of ``p`` -> (y, aux_loss), y summed over ``model``
    (``rank.all_reduce``), aux from the local routing.  A dropped copy reads
    slot ``C - 1`` and weighs 0; the copies of the other ranks' experts weigh 0
    too (expert-sharded).  The gate product and the K-sum stay in x's dtype,
    as the reference's, before the sum over ranks."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    n = B * S
    xt = x.reshape(n, d)
    C = local_capacity(n, K, E, capacity_factor)
    r = route(p["router"], xt, K, capacity_factor, capacity=C)
    slot = torch.where(r.keep, r.slot, C - 1)
    if rank.expert_sharded:
        e_loc = p["w_gate"].shape[0]
        mine = torch.div(r.expert, e_loc, rounding_mode="floor") == rank.model_index
        le = torch.where(mine, r.expert % e_loc, torch.zeros_like(r.expert))
        use = r.keep & mine
    else:  # ff-sliced: every expert over the rank's slice of the ffn
        e_loc, le, use = E, r.expert, r.keep

    # dispatch: copies in use to row le * C + slot, the others to the spare row
    row = le * C + slot
    buf = torch.zeros((e_loc * C + 1, d), dtype=x.dtype, device=x.device)
    buf[torch.where(use, row, e_loc * C)] = xt[:, None, :].expand(n, K, d).reshape(n * K, d)
    buf = buf[:e_loc * C].view(e_loc, C, d)

    g = torch.bmm(buf, p["w_gate"].to(x.dtype))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    out_e = torch.bmm(h, p["w_down"].to(x.dtype)).view(e_loc * C, d)

    y_cp = out_e[row]
    y_cp = y_cp * (r.gate * use.to(torch.float32))[:, None].to(y_cp.dtype)
    y = y_cp.view(n, K, d).sum(dim=1)
    y = rank.all_reduce(y)  # the one collective: expert outputs (or ff partials)
    return y.view(B, S, d).to(x.dtype), r.aux
