"""Deterministic synthetic image datasets (``repro.data.synthetic``).

Class-conditional images with the shapes of the paper's datasets: each class
has a fixed random prototype, samples are ``prototype + noise``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.utils import prng


@dataclass(frozen=True)
class ImageSpec:
    name: str
    shape: Tuple[int, int, int]  # H, W, C
    num_classes: int
    noise: float
    proto_scale: float


DATASETS = {
    "mnist": ImageSpec("mnist", (28, 28, 1), 10, 0.85, 1.0),
    "cifar10": ImageSpec("cifar10", (32, 32, 3), 10, 1.60, 1.0),
    "svhn": ImageSpec("svhn", (32, 32, 3), 10, 1.20, 1.0),
}


def dataset_spec(name: str) -> ImageSpec:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASETS)}")
    return DATASETS[name]


def class_prototypes(key: torch.Tensor, spec: ImageSpec, device) -> torch.Tensor:
    """Fixed per-class prototype images, (num_classes, H, W, C)."""
    k = prng.fold_in_str(key, f"proto/{spec.name}")
    return spec.proto_scale * prng.normal(k, (spec.num_classes, *spec.shape), device)
