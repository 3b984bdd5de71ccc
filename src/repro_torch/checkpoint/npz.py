"""Step-indexed ``.npz`` checkpoints of tensor trees (``repro.checkpoint.npz``).

The file is the JAX package's: one ``.npy`` member per leaf, keyed by the
``"||"``-joined JAX path strings of the leaf (``['blocks']||[0]||['attn']||['wq']``),
written as ``np.savez`` writes it.  A bf16 leaf is stored as the reference
stores an ``ml_dtypes.bfloat16`` array: its raw 2-byte patterns under the
descr ``'<V2'``.  So an fp32 checkpoint written by either package restores
into the other, and a bf16 leaf's member is the same bytes from both.
``restore`` reads a ``'<V2'`` member back into a bf16 tensor without
``ml_dtypes`` (the reference's own ``restore`` cannot cast it).

Writes are atomic (a temporary file in the directory, then a rename), and
only the newest ``keep`` checkpoints stay.
"""
from __future__ import annotations

import os
import re
import tempfile
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves_with_path

PyTree = Any
_SEP = "||"
_BF16_DESCR = "<V2"


def _key(path) -> str:
    """JAX's path string of a leaf: ``['name']`` for a dict key, ``[i]`` for a list index."""
    return _SEP.join(f"[{p!r}]" if isinstance(p, str) else f"[{p}]" for p in path)


def _write_leaf(fid, x: torch.Tensor) -> None:
    t = x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        np.lib.format.write_array_header_1_0(
            fid, {"descr": _BF16_DESCR, "fortran_order": False, "shape": tuple(t.shape)})
        fid.write(t.view(torch.int16).numpy().tobytes())
    else:
        np.lib.format.write_array(fid, t.numpy(), allow_pickle=False)


def _read_leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a writable copy; 0-dim stays 0-dim
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    """Step-indexed npz checkpoints with atomic writes."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.npz")

    def save(self, step: int, tree: PyTree) -> str:
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(fd)
        try:
            # np.savez's container: stored members, each opened for zip64
            with zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED,
                                 allowZip64=True) as zf:
                for path, leaf in tree_leaves_with_path(tree):
                    with zf.open(_key(path) + ".npy", "w", force_zip64=True) as fid:
                        _write_leaf(fid, leaf)
            os.replace(tmp, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._gc()
        return self._path(step)

    def steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            m = re.match(r"step_(\d+)\.npz$", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: PyTree) -> PyTree:
        """Restore into the structure of ``like``: each leaf in ``like``'s leaf's
        dtype and device; a missing leaf or a shape mismatch raises."""
        with np.load(self._path(step)) as data:

            def build(node, path):
                if isinstance(node, dict):
                    return {k: build(v, path + (k,)) for k, v in node.items()}
                if isinstance(node, (list, tuple)):
                    return [build(v, path + (i,)) for i, v in enumerate(node)]
                key = _key(path)
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                arr = data[key]
                if tuple(arr.shape) != tuple(node.shape):
                    raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model "
                                     f"{tuple(node.shape)}")
                return _read_leaf(arr, node)

            return build(like, ())

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            os.unlink(self._path(s))
