"""The runtime of a sharded model: each rank's blocks, its local layout and
the collectives over the mesh's ``model`` axis.

The reference leaves this to GSPMD: one program over a ``("data",
"model")`` mesh, each leaf laid out by its resolved spec, the collectives
inferred.  Here one process runs each rank (``launch/serve.py``, a worker of
``utils/procs.py::ShardPool`` a rank) and every layout is explicit:

- ``leaf_block(spec, shape, mesh, coords)``: the slice of each dimension
  that a rank holds, for a leaf of that spec.  A dimension sharded over
  several axes is cut in their order, the first the major one, as a
  ``PartitionSpec`` cuts it.
- ``shard_tree(tree, axes, mesh, rules, coords)``: a full tree cut into a
  rank's blocks, the way weights drawn or converted elsewhere are carried
  over (a JAX numpy tree goes through ``convert.params_tree_from_numpy``
  first).
- ``init_shard(api, key, rank)``: a rank's blocks drawn directly, each
  element at its index in the whole leaf (``utils/prng.py``'s ``at``), bit
  for bit ``shard_tree`` of the whole draw, without ever drawing the whole.
- ``Rank``: what a rank's forward needs, all of it read off the leaves'
  resolved specs (``make_rank``): its mesh coordinates, its ``model``
  process group, which leaves are sharded, and the local sizes of heads, kv
  heads, experts, ffn and vocab, and of the mamba2 mixer: the rank's
  ``ssm_inner`` columns and the heads it scans over them.  Where the SSD
  heads replicate while their columns shard (hymba-1.5b's 50 heads on 4
  ranks: 800 columns a rank, 12.5 heads of 64), the rank scans *virtual
  heads* of ``gcd(hp, c0, c1 - c0)`` columns, each with its parent head's
  ``dt``, ``A`` and ``D``: the recurrence is separable along a head's
  columns, since ``dt``, ``A``, B and C are shared across them.  A layout
  that the sharded forward does not implement (query heads sharded while the
  kv heads they need are not cut the same way; SSD heads sharded while the
  inner columns are not theirs; a replicated leaf of the mixer cut; an
  ``encdec`` model whose cross-attention, encoder attention or encoder MLP is
  not cut as the decoder's, or whose ``b2`` or ``pos_embed`` is cut; ``data``
  > 1) raises ``NotImplementedError``.  An ``encdec`` tree has no
  ``blocks``: its layout is read off the stacked ``decoder`` (self-attention,
  GELU MLP) and ``embed``, and checked against ``encoder`` and
  ``decoder.cross_attn``.
- ``Rank.all_reduce`` / ``Rank.all_gather``: sums and concatenations over
  ``model``.  With NCCL they take the tensors where they lie.  With ``gloo``
  on CUDA tensors (ranks sharing one card) both copy to the host and back
  explicitly: ``gloo``'s all-gather takes no CUDA tensor, and the same rule
  for both keeps the one-card mesh's path one path.  Any failure of a
  collective raises; nothing falls back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import leaf_shape, mesh_sizes, resolve_pspec, tree_map_axes, \
    tree_pspecs


def coords_of(index: int, mesh) -> Dict[str, int]:
    """The mesh coordinates of rank ``index`` (row-major over the mesh's axes,
    the last axis the fastest)."""
    sizes = mesh_sizes(mesh)
    out = {}
    for axis in reversed(list(sizes)):
        index, out[axis] = divmod(index, sizes[axis])
    return {a: out[a] for a in sizes}


def leaf_block(spec, shape, mesh, coords) -> Tuple[slice, ...]:
    """The slices, one a dimension, of a leaf of ``shape`` and ``spec`` that
    the rank at ``coords`` holds."""
    sizes = mesh_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append(slice(0, n))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, at = 1, 0
        for a in axes:
            parts *= sizes[a]
            at = at * sizes[a] + coords[a]
        size = n // parts
        out.append(slice(at * size, (at + 1) * size))
    return tuple(out)


def tree_blocks(axes, shapes, mesh, rules, coords):
    """Each leaf's block (``leaf_block``) for the rank at ``coords``."""
    specs = tree_pspecs(axes, shapes, mesh, rules)
    return tree_map_axes(lambda _, spec, shaped: leaf_block(spec, leaf_shape(shaped), mesh,
                                                            coords), axes, specs, shapes)


def shard_tree(tree, axes, mesh, rules, coords):
    """A full tree of tensors cut into the blocks of the rank at ``coords``,
    each block a tensor of its own (the full tree can be dropped)."""
    blocks = tree_blocks(axes, tree, mesh, rules, coords)
    return tree_map_axes(lambda _, t, b: t[b].clone(), axes, tree, blocks)


def param_shapes(api):
    """The parameter tree of ``api`` on the ``meta`` device: shapes and
    dtypes, nothing drawn."""
    from repro_torch.utils import prng

    return api.init(prng.key(0), "meta")


def init_shard(api, key, rank: "Rank", device=None):
    """The rank's blocks of ``api.init(key, device)``, drawn directly."""
    blocks = tree_blocks(api.param_axes(), param_shapes(api), rank.mesh, rank.rules,
                         rank.coords)
    return api.init(key, device, shard=blocks)


@dataclasses.dataclass
class Rank:
    """One rank of a ``("data", "model")`` mesh and its local layout.

    ``heads`` / ``kv_heads`` / ``experts`` / ``ffn`` / ``vocab``: the local
    sizes (query heads, cache kv heads after ``kv_repeat``, experts, the ffn
    of a dense MLP or of each expert, vocab rows of the embedding).
    ``heads_sharded``: q / k / v and ``wo`` hold local heads (the attention
    output is a partial sum); ``kv_take``: the slice of the projected (and
    repeated) kv heads the local query heads attend, None for all of them;
    ``mlp_sharded``: the dense SwiGLU's ffn is cut (its output a partial
    sum); ``expert_sharded``: the MoE layer's experts are cut (else its ffn);
    ``vocab_range``: the embedding's rows and the LM head's columns the rank
    holds, None when replicated.  The mamba2 mixer: ``ssm_sharded``, its
    ``ssm_inner`` columns are cut (``ssm_cols``, the rank's ``[c0, c1)``; the
    out projection a partial sum, the gated norm's mean of squares summed
    over ``model``); ``ssm_hp``, the width of the heads the rank scans over
    them; ``ssm_parent``, each such head's index into the rank's per-head
    leaves (``in_dt``'s columns, ``A_log``, ``dt_bias``, ``D``), None where
    they are one to one."""

    index: int
    world: int
    mesh: Dict[str, int]
    coords: Dict[str, int]
    rules: dict
    group: Any = None
    host_collectives: bool = False
    heads: int = 0
    kv_heads: int = 0
    experts: int = 0
    ffn: int = 0
    vocab: int = 0
    heads_sharded: bool = False
    kv_take: Optional[Tuple[int, int]] = None
    mlp_sharded: bool = False
    expert_sharded: bool = False
    vocab_range: Optional[Tuple[int, int]] = None
    ssm_sharded: bool = False
    ssm_cols: Optional[Tuple[int, int]] = None
    ssm_hp: int = 0
    ssm_parent: Optional[Tuple[int, ...]] = None
    _parent_index: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def ssm_parent_index(self, device) -> torch.Tensor:
        """``ssm_parent`` as an int64 tensor on ``device``, made once a device."""
        key = str(torch.device(device))
        if key not in self._parent_index:
            self._parent_index[key] = torch.tensor(self.ssm_parent, dtype=torch.int64,
                                                   device=device)
        return self._parent_index[key]

    @property
    def model(self) -> int:
        return self.mesh.get("model", 1)

    @property
    def model_index(self) -> int:
        return self.coords.get("model", 0)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over ``model`` (a new tensor on x's device)."""
        if self.model == 1:
            return x
        if self.group is None:
            raise RuntimeError("Rank.all_reduce: this rank has no process group")
        buf = x.cpu() if self.host_collectives else x.contiguous().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.to(x.device)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` along ``model``, concatenated on ``dim`` in rank order."""
        if self.model == 1:
            return x
        if self.group is None:
            raise RuntimeError("Rank.all_gather: this rank has no process group")
        src = x.cpu() if self.host_collectives else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.model)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)


def _range(block: slice) -> Tuple[int, int]:
    return block.start, block.stop


def make_rank(api, mesh, rules, index: int, group=None, host_collectives: bool = False) -> Rank:
    """Rank ``index`` of ``mesh`` for the model of ``api`` under ``rules``:
    its coordinates, its blocks' specs and the local layout they give; the
    blocks a layer holds (attention, mamba2 mixer, MoE or dense MLP; an
    encoder-decoder's stacks) are read off the parameter tree."""
    cfg = api.cfg
    sizes = mesh_sizes(mesh)
    world = math.prod(sizes.values())
    if sizes.get("data", 1) > 1:
        raise NotImplementedError(
            f"{cfg.name}: a mesh with data = {sizes['data']} > 1 is not ported yet "
            "(ROADMAP A13, data > 1); serve on a (1, model) mesh")
    coords = coords_of(index, sizes)
    shapes = param_shapes(api)
    specs = tree_pspecs(api.param_axes(), shapes, sizes, rules)
    rank = Rank(index, world, sizes, coords, rules, group, host_collectives)

    def block(path):
        spec, shaped = specs, shapes
        for p in path:
            spec, shaped = spec[p], shaped[p]
        return leaf_block(spec, tuple(shaped.shape), sizes, coords)

    def whole(path):
        shaped = shapes
        for p in path:
            shaped = shaped[p]
        return block(path) == tuple(slice(0, n) for n in shaped.shape)

    if cfg.family == "encdec":
        _encdec_layout(rank, api, block, whole)
        return rank
    layer = shapes["blocks"][0]
    if "attn" in layer:
        _attention_layout(rank, api, block, ("blocks", 0, "attn"),
                          api.cache_axes()["layers"][0]["attn"])
    if "ssm" in layer:
        _ssm_layout(rank, cfg, block, whole)
    if "moe" in layer:
        wg = block(("blocks", 0, "moe", "w_gate"))
        rank.expert_sharded = wg[1] != slice(0, cfg.num_experts)
        rank.experts, rank.ffn = wg[1].stop - wg[1].start, wg[3].stop - wg[3].start
        if rank.model > 1 and not rank.expert_sharded and rank.ffn == cfg.d_ff:
            raise NotImplementedError(f"{cfg.name}: neither the experts nor their ffn shard "
                                      f"over model = {rank.model}")
    elif "mlp" in layer:
        wg = block(("blocks", 0, "mlp", "w_gate"))[2]
        rank.mlp_sharded = wg != slice(0, cfg.d_ff)
        rank.ffn = wg.stop - wg.start
    rows = _vocab_layout(rank, cfg, block)
    if not cfg.tie_embeddings and block(("lm_head",))[1] != rows:
        raise NotImplementedError(f"{cfg.name}: lm_head's vocab is not cut as embed's")
    return rank


def _vocab_layout(rank: Rank, cfg, block) -> slice:
    """The embedding's vocab rows the rank holds (-> their block)."""
    rows = block(("embed",))[0]
    rank.vocab = rows.stop - rows.start
    rank.vocab_range = None if rank.vocab == cfg.padded_vocab else _range(rows)
    return rows


def _attention_layout(rank: Rank, api, block, at, cache_axes) -> None:
    """The query heads' block, the kv heads projected, those the cache holds:
    the attention at ``at`` (a path into the tree), its cache's axes
    ``cache_axes`` (``k`` read)."""
    cfg, sizes, coords = api.cfg, rank.mesh, rank.coords
    H, kv_eff = cfg.num_heads, cfg.num_kv_heads * cfg.kv_repeat
    G = H // kv_eff
    attn = block(at + ("wq",))[2]
    rank.heads_sharded = attn != slice(0, H)
    h0, h1 = _range(attn)
    want = (h0 // G, (h1 - 1) // G + 1)  # the kv heads the local query heads attend
    wk = block(at + ("wk",))[2]
    proj = (wk.start * cfg.kv_repeat, wk.stop * cfg.kv_repeat)
    k_shape = (1, 1, 1, kv_eff, 1)  # (layers, batch, kv_seq, kv_heads, head_dim)
    k_spec = resolve_pspec(cache_axes["k"], k_shape, sizes, rank.rules)
    cache = leaf_block(k_spec, k_shape, sizes, coords)[3]
    local_g = (h1 - h0) // (want[1] - want[0])
    if (_range(cache) != want or not proj[0] <= want[0] < want[1] <= proj[1]
            or local_g * (want[1] - want[0]) != h1 - h0 or (local_g < G and G % local_g)):
        raise NotImplementedError(
            f"{cfg.name} on {sizes}: query heads {h0}-{h1 - 1} attend kv heads "
            f"{want[0]}-{want[1] - 1}, but the rank projects kv heads {proj[0]}-{proj[1] - 1} "
            f"and its cache holds {cache.start}-{cache.stop - 1}; this layout is not ported "
            "(ROADMAP A13)")
    rank.heads, rank.kv_heads = h1 - h0, want[1] - want[0]
    rank.kv_take = None if want == proj else (want[0] - proj[0], want[1] - proj[0])
    if block(at + ("wo",))[1] != attn:
        raise NotImplementedError(f"{cfg.name}: wo's heads are not cut as wq's")


def _encdec_layout(rank: Rank, api, block, whole) -> None:
    """whisper's layout: the heads read off the decoder's self-attention (its
    ring cache ``self.k``; ``xk`` must resolve alike), the cross-attention's and
    the encoder's attention cut as it is; the ffn off the decoder's GELU MLP,
    the encoder's cut alike; the vocab off ``embed``'s rows (the logits come
    from ``embed``: there is no ``lm_head``).  ``pos_embed`` and each MLP's
    ``b2`` are held whole (``b2`` is added once, after the sum over
    ``model``)."""
    cfg, sizes = api.cfg, rank.mesh
    cache = api.cache_axes()["self"]
    _attention_layout(rank, api, block, ("decoder", "self_attn"), cache)
    if rank.model > 1 and (cfg.kv_repeat != 1 or rank.kv_take is not None):
        raise NotImplementedError(
            f"{cfg.name} on {sizes}: kv_repeat {cfg.kv_repeat} with the heads cut; the "
            "sharded encoder-decoder projects the kv heads its query heads attend "
            "(ROADMAP A13)")
    k_shape = (1, 1, 1, cfg.num_kv_heads * cfg.kv_repeat, 1)
    if resolve_pspec(cache["xk"], k_shape, sizes, rank.rules) != \
            resolve_pspec(cache["k"], k_shape, sizes, rank.rules):
        raise NotImplementedError(f"{cfg.name} on {sizes}: the cache's xk is not cut as k")
    for at in (("decoder", "cross_attn"), ("encoder", "attn")):
        for name in ("wq", "wk", "wv", "wo"):
            if block(at + (name,))[1:] != block(("decoder", "self_attn", name))[1:]:
                raise NotImplementedError(
                    f"{cfg.name} on {sizes}: {'.'.join(at + (name,))} is not cut as "
                    f"decoder.self_attn.{name}")
    w1 = block(("decoder", "mlp", "w1"))[2]
    rank.mlp_sharded, rank.ffn = w1 != slice(0, cfg.d_ff), w1.stop - w1.start
    for at in ("decoder", "encoder"):
        for name, dim in (("w1", 2), ("b1", 1), ("w2", 1)):
            if block((at, "mlp", name))[dim] != w1:
                raise NotImplementedError(f"{cfg.name} on {sizes}: {at}.mlp.{name}'s ffn is "
                                          "not cut as decoder.mlp.w1's")
        if not whole((at, "mlp", "b2")):
            raise NotImplementedError(f"{cfg.name} on {sizes}: {at}.mlp.b2 is cut; it is "
                                      "added once, after the sum over model")
    if not whole(("pos_embed",)):
        raise NotImplementedError(f"{cfg.name} on {sizes}: pos_embed is cut; the sharded "
                                  "decoder holds it whole")
    _vocab_layout(rank, cfg, block)


def _ssm_layout(rank: Rank, cfg, block, whole) -> None:
    """The mamba2 mixer's layout: the rank's ``ssm_inner`` columns (``in_x``), its
    ``ssm_heads`` block (``in_dt``), and the heads it scans over those columns,
    whole heads where the heads shard, virtual heads where they replicate."""
    nh, hp, di, sizes = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_d_inner, rank.mesh
    ssm = lambda name: block(("blocks", 0, "ssm", name))  # noqa: E731
    cols, heads = ssm("in_x")[2], ssm("in_dt")[2]
    (c0, c1), (h0, h1) = _range(cols), _range(heads)
    for name, dim, want in (("in_z", 2, cols), ("norm_w", 1, cols), ("out_proj", 1, cols),
                            ("A_log", 1, heads), ("dt_bias", 1, heads), ("D", 1, heads)):
        if ssm(name)[dim] != want:
            raise NotImplementedError(f"{cfg.name} on {sizes}: {name} is not cut as "
                                      f"{'in_x' if want is cols else 'in_dt'}")
    for name in ("in_B", "in_C", "conv_w", "conv_b"):
        if not whole(("blocks", 0, "ssm", name)):
            raise NotImplementedError(f"{cfg.name} on {sizes}: {name} is cut; the sharded "
                                      "mixer holds it whole (ROADMAP A13)")
    rank.ssm_cols, rank.ssm_sharded = (c0, c1), (c0, c1) != (0, di)
    if (h0, h1) != (0, nh):
        if (h0 * hp, h1 * hp) != (c0, c1):
            raise NotImplementedError(
                f"{cfg.name} on {sizes}: SSD heads {h0}-{h1 - 1} are sharded, but the rank's "
                f"inner columns {c0}-{c1 - 1} are not theirs ({h0 * hp}-{h1 * hp - 1}); this "
                "layout is not ported (ROADMAP A13)")
        rank.ssm_hp = hp
    elif rank.ssm_sharded:  # heads replicated, columns cut: virtual heads
        rank.ssm_hp = math.gcd(hp, c0, c1 - c0)
        rank.ssm_parent = tuple(c // hp for c in range(c0, c1, rank.ssm_hp))
    else:
        rank.ssm_hp = hp


__all__ = ["Rank", "coords_of", "leaf_block", "tree_blocks", "shard_tree", "param_shapes",
           "init_shard", "make_rank"]
