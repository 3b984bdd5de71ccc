"""Carry weights and round state across from the JAX package, through numpy.

The JAX package's parameters come as a tree of numpy leaves (nested dicts
and lists: ``{"convs": [], "fc1": {"b", "w"}, "fc2": {"b", "w"}}`` for the
MLP, a ``blocks`` list of dicts for the decoder-only LMs, ``encoder`` /
``decoder`` dicts of stacked leaves for ``encdec``, bf16 leaves as
``ml_dtypes.bfloat16`` arrays), an LM decode cache likewise, or as
the flat ``(P,)`` vector of its ``flatten_to_vector``; a whole
``RoundState`` / ``RoundData`` comes as a dict of numpy arrays keyed by the
NamedTuple's field names, with ``twin`` a nested dict and ``key`` the two
uint32 words of the PRNG key.  This module takes and gives numpy only; the
JAX -> numpy half lives with whoever holds the JAX arrays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.twin import TwinState
from repro_torch.fl.rounds import RoundData, RoundState
from repro_torch.utils import prng
from repro_torch.utils.pytree import flatten_to_vector

# dtypes the JAX package stores these leaves in (the port holds ids as int64)
_INT32_LEAVES = ("clusters", "lane", "labels", "test_y")


def _tensor(x, device) -> torch.Tensor:
    """A numpy array -> a tensor of the same dtype.  ``torch.from_numpy``
    refuses a bf16 array (``ml_dtypes.bfloat16``), so its 16-bit patterns
    cross as ``uint16`` and are viewed back as ``torch.bfloat16``."""
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_tree_from_numpy(tree, device="cpu"):
    """A numpy parameter tree (dicts and lists, e.g. the LM zoo's ``blocks``
    or whisper's stacked ``encoder`` / ``decoder`` dicts) -> the same
    structure of tensors, each leaf keeping its dtype; empty lists (the
    MLP's ``convs``) are dropped."""
    if isinstance(tree, dict):
        return {name: params_tree_from_numpy(value, device) for name, value in tree.items()
                if not (isinstance(value, (list, tuple)) and not value)}
    if isinstance(tree, (list, tuple)):
        return [params_tree_from_numpy(value, device) for value in tree]
    return _tensor(tree, device)


def lm_cache_from_numpy(cache, device="cpu") -> dict:
    """A JAX LM decode cache as numpy -> the port's: the top-level ``pos``
    (B,) and per pattern sub-layer ``attn`` {k, v, pos} and ``ssm`` {h, conv},
    stacked over the layer axis; or an ``encdec`` cache, ``pos``, ``self``
    {k, v, pos, xk, xv} stacked over the decoder layers and ``enc_pos``
    (B, S_enc); dtypes kept (positions int32), the same generic walk."""
    return params_tree_from_numpy(cache, device)


def tree_to_numpy(tree):
    """The port's tensors (dicts and lists) -> numpy; bf16 leaves as float32."""
    if isinstance(tree, dict):
        return {name: tree_to_numpy(value) for name, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(value) for value in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_numpy(params, device="cpu") -> torch.Tensor:
    """A numpy parameter tree or flat ``(P,)`` vector -> the port's flat
    vector: fp32, or bf16 for a bf16 vector (a bf16 master); a tree
    flattens to fp32, as ``flatten_to_vector`` does in both packages."""
    if isinstance(params, np.ndarray):
        if params.ndim != 1:
            raise ValueError(f"a flat parameter vector is 1-D, got shape {params.shape}")
        if params.dtype.name != "bfloat16":
            params = params.astype(np.float32)
        return _tensor(params, device)
    return flatten_to_vector(params_tree_from_numpy(params, device))


def _leaf_from_numpy(name, x, device):
    x = np.asarray(x)
    if x.dtype.kind in "iu":
        return _tensor(x.astype(np.int64), device)
    return _tensor(x, device)


def state_from_numpy(d: Dict, device="cpu") -> RoundState:
    """A RoundState dict of numpy arrays -> the port's ``RoundState``."""
    fields = {}
    for name in RoundState._fields:
        if name == "twin":
            fields[name] = TwinState(*[_leaf_from_numpy(f, d["twin"][f], device)
                                       for f in TwinState._fields])
        elif name == "key":
            fields[name] = prng.wrap_key_data(np.asarray(d["key"], np.uint32))
        elif name == "round":
            fields[name] = int(np.asarray(d["round"]))
        else:
            fields[name] = _leaf_from_numpy(name, d[name], device)
    return RoundState(**fields)


def _leaf_to_numpy(name, x):
    x = x.detach().cpu()
    a = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return a.astype(np.int32) if name in _INT32_LEAVES else a


def state_to_numpy(state: RoundState) -> Dict:
    """The port's ``RoundState`` -> a dict of numpy arrays in the JAX dtypes,
    bf16 leaves (the bf16 lane's ring and master) as float32, which is exact."""
    out = {}
    for name in RoundState._fields:
        value = getattr(state, name)
        if name == "twin":
            out[name] = {f: _leaf_to_numpy(f, getattr(value, f)) for f in TwinState._fields}
        elif name == "key":
            out[name] = prng.key_data(value)
        elif name == "round":
            out[name] = np.asarray(value, np.int32)
        else:
            out[name] = _leaf_to_numpy(name, value)
    return out


def data_from_numpy(d: Dict, device="cpu") -> RoundData:
    """A RoundData dict of numpy arrays -> the port's ``RoundData``."""
    return RoundData(*[_leaf_from_numpy(f, d[f], device) for f in RoundData._fields])


def data_to_numpy(data: RoundData) -> Dict:
    return {f: _leaf_to_numpy(f, getattr(data, f)) for f in RoundData._fields}
