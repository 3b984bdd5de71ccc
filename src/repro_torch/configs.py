"""The paper's own FL task models (section IV): MLP / CNN-S / CNN-M.

Declared as in ``repro/configs/paper_models.py``.  Only ``fl-mnist-mlp``
runs in the port so far; the two CNNs are declared for the catalog and
refused by ``models.build_model``.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig


def _mk(name, image_shape, channels, d_ff) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="cnn" if channels else "mlp",
        d_ff=d_ff,
        image_shape=image_shape,
        num_classes=10,
        channels=channels,
        dtype="float32",
    )


PAPER_MODELS = {
    "fl-mnist-mlp": _mk("fl-mnist-mlp", (28, 28, 1), (), 200),
    "fl-cifar10-cnn": _mk("fl-cifar10-cnn", (32, 32, 3), (32, 64), 256),
    "fl-svhn-cnn": _mk("fl-svhn-cnn", (32, 32, 3), (24, 48), 192),
}

PAPER_MODEL_BY_DATASET = {
    "mnist": "fl-mnist-mlp",
    "cifar10": "fl-cifar10-cnn",
    "svhn": "fl-svhn-cnn",
}


def get_config(name: str) -> ModelConfig:
    if name not in PAPER_MODELS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(PAPER_MODELS)}")
    return PAPER_MODELS[name]
