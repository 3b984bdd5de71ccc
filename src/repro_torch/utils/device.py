"""Device resolution for the port's entry points, and the grid mesh."""
from __future__ import annotations

from typing import Dict

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; ``cuda`` unless the caller asks.

    Raises when CUDA is asked for and no card is present: an entry point
    never carries on quietly on the CPU.  On the card, float32 matrix
    products and convolutions run in full float32 (no TF32): the JAX
    reference is full float32, and TF32 keeps only about three digits.  The
    CNNs' convolutions take cuDNN's deterministic algorithms, picked by its
    heuristics rather than by timing, so a round repeats bit for bit.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the port on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device


class GridMesh(tuple):
    """A frozen tuple of indexed ``torch.device``s, one a grid shard.

    ``GridMesh(("cuda:0", "cuda:1"))`` shards a grid over two cards,
    ``GridMesh(("cuda:0", "cuda:0"))`` cuts it in two on one card.  A
    ``cuda`` device without an index is the current card; CUDA devices
    raise without a card, as every entry point does.
    """

    __slots__ = ()

    def __new__(cls, devices):
        devs = []
        for d in devices:
            d = resolve_device(d)
            if d.type == "cuda":
                if d.index is None:
                    d = torch.device("cuda", torch.cuda.current_device())
                if d.index >= torch.cuda.device_count():
                    raise ValueError(f"GridMesh: {d} is not a visible card "
                                     f"({torch.cuda.device_count()} visible)")
            devs.append(d)
        if not devs:
            raise ValueError("GridMesh: a mesh needs at least one device")
        return super().__new__(cls, devs)

    @property
    def shape(self) -> Dict[str, int]:
        """The mesh's one axis, as the reference's mesh names it."""
        return {"data": len(self)}


class LMMesh:
    """A 2-D ``("data", "model")`` array of indexed ``torch.device``s for a
    sharded LM, one a rank: ``LMMesh([["cuda:0", "cuda:1"]])`` is data = 1,
    model = 2.  A flat sequence is one data row.  A device may repeat
    (``LMMesh([["cuda:0"] * 4])``: four ranks on one card; every CPU mesh).
    ``shape`` is ``{"data": rows, "model": columns}``, as the reference's
    ``Mesh`` gives it; ``devices`` lists them in rank order (row-major);
    ``backend`` is the collectives' backend the mesh asks for: ``nccl`` when
    every rank has a card of its own, ``gloo`` when ranks share a card or run
    on the CPU.  CUDA devices raise without a card, as every entry point does."""

    def __init__(self, devices):
        rows = [list(r) for r in devices] if isinstance(devices[0], (list, tuple)) \
            else [list(devices)]
        if len({len(r) for r in rows}) != 1 or not rows[0]:
            raise ValueError("LMMesh: every data row needs the same, non-zero number of ranks")
        self.rows = tuple(tuple(GridMesh(r)) for r in rows)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.rows), "model": len(self.rows[0])}

    @property
    def devices(self) -> tuple:
        return tuple(d for row in self.rows for d in row)

    @property
    def backend(self) -> str:
        devs = self.devices
        if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
            return "nccl"
        return "gloo"

    def __repr__(self) -> str:
        return f"LMMesh({[[str(d) for d in r] for r in self.rows]})"
