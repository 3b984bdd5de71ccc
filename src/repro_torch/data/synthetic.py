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


def make_image_dataset(key: torch.Tensor, name: str, num_samples: int, labels=None,
                       device=None):
    """Sample ``(images (n, H, W, C) f32, labels (n,) int64)``; with
    ``labels`` given, the images condition on them
    (``repro.data.synthetic.make_image_dataset``)."""
    spec = dataset_spec(name)
    device = key.device if device is None else torch.device(device)
    kp, kl, kn = (prng.fold_in_str(key, "proto"), prng.fold_in_str(key, "labels"),
                  prng.fold_in_str(key, "noise"))
    protos = class_prototypes(kp, spec, device)
    if labels is None:
        labels = prng.randint(kl, (num_samples,), 0, spec.num_classes, device)
    labels = torch.as_tensor(labels, dtype=torch.int64, device=device)
    noise = spec.noise * prng.normal(kn, (num_samples, *spec.shape), device)
    return protos[labels] + noise, labels


def make_lm_batch(key: torch.Tensor, batch: int, seq_len: int, vocab: int,
                  device=None) -> dict:
    """Token batch with learnable structure: x[t+1] = perm[x[t]] w.p. 0.7.

    ``repro.data.synthetic.make_lm_batch``: Zipf(1.1) draws over the first
    ``min(vocab, 4096)`` ids, a fixed permutation chain and a 0.7 coin per
    position; the reference's ``lax.scan`` over positions is a loop here.
    -> ``tokens`` and ``targets``, int64 ``(batch, seq_len - 1)``.
    """
    device = key.device if device is None else torch.device(device)
    kz, kp, kc = (prng.fold_in_str(key, "zipf"), prng.fold_in_str(key, "perm"),
                  prng.fold_in_str(key, "coin"))
    v_eff = min(vocab, 4096)  # concentrate mass so structure is learnable
    ranks = torch.arange(1, v_eff + 1, dtype=torch.float32, device=device)
    logits = -1.1 * torch.log(ranks)
    draws = prng.categorical(kz, logits, (batch, seq_len), device)
    perm = prng.permutation(kp, v_eff, device)
    coin = prng.bernoulli(kc, 0.7, (batch, seq_len), device)
    tokens = torch.empty((batch, seq_len), dtype=torch.int64, device=device)
    tokens[:, 0] = draws[:, 0]
    for t in range(1, seq_len):
        tokens[:, t] = torch.where(coin[:, t], perm[tokens[:, t - 1]], draws[:, t])
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
