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
