"""Elementwise ops whose CPU result must not depend on where an element sits.

On the CPU, PyTorch runs a contiguous elementwise op through SIMD code in
chunks of the vector width and through the op's scalar form on the tail of
each contiguous run.  For most ops the two agree bit for bit; for
``atan2`` and ``pow`` they differ in the last place for a few per cent of
inputs.  So a value computed in a ``(N,)`` lane and the same value computed
in row g of a ``(G, N)`` stack could differ, and the batched grid round
would not reproduce the lane loop.  ``per_element`` hands such an op
strided inputs, which PyTorch evaluates element by element through the
scalar form, so every element takes the same code whatever the shape, the
tail and the thread split.  A CUDA op evaluates every element alike and is
called as it is.

A reduction has the same trap on the card: a CUDA reduction kernel's
summation order can depend on how many rows it reduces at once (on an H100,
``(24, 2000).mean(-1)`` rounds some rows unlike ``(12, 2000).mean(-1)``), so
a lane's eval loss would depend on the size of its lane group or shard.
``row_mean`` sums each row in a fixed order of elementwise adds.
"""
from __future__ import annotations

import torch


def per_element(fn, *xs):
    """``fn(*xs)``, every element through the same code on the CPU."""
    if not any(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in xs):
        return fn(*xs)
    strided = []
    for x in xs:
        if isinstance(x, torch.Tensor) and x.dim():
            buf = x.new_empty(x.shape + (2,))[..., 0]  # every stride doubled
            x = buf.copy_(x)
        strided.append(x)
    return fn(*strided)


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the last axis, each row summed in pairwise halves (the
    axis zero-padded to a power of two), every step an elementwise add: a
    row's result depends on its own values alone, on any device."""
    n = x.shape[-1]
    width = 1 << (n - 1).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0] / n
