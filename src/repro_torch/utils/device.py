"""Device resolution for the port's entry points."""
from __future__ import annotations

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
