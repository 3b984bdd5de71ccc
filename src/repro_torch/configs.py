"""Architecture configs of the port: the paper's FL task models and the LM zoo.

Declared as in ``repro/configs/``: ``get_config(arch)`` gives the exact
assigned config, ``get_smoke_config(arch)`` the reduced same-family variant
the CPU tests run.  Of the FL models only ``fl-mnist-mlp`` runs so far (the
two CNNs are declared and refused by ``models.build_model``); of the LM zoo
only ``hymba-1.5b``.  The other LM arch ids of the reference raise
``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig


def _mk(name, image_shape, channels, d_ff) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="cnn" if channels else "mlp",
        num_layers=len(channels),
        d_model=0,
        num_heads=0,
        num_kv_heads=0,
        d_ff=d_ff,
        vocab_size=0,
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


def hymba_15b() -> ModelConfig:
    """hymba-1.5b: hybrid, parallel attention + mamba heads per layer
    [arXiv:2411.13676].

    The normed input feeds a sliding-window GQA branch and a mamba2 mixer
    branch; the two normalized outputs are averaged.  As in the reference:
    uniform SWA (Hymba keeps 3 full-attention layers) and no meta tokens.
    """
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        head_dim=64,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
        sliding_window=1024,
        max_position_embeddings=1_048_576,
        train_microbatches=4,
        source="arXiv:2411.13676",
    )


def hymba_15b_smoke() -> ModelConfig:
    return hymba_15b().replace(
        name="hymba-1.5b-smoke",
        num_layers=2,
        d_model=192,
        num_heads=6,
        num_kv_heads=2,
        head_dim=32,
        d_ff=384,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=16,
        sliding_window=32,
        dtype="float32",
        remat_policy="none",
    )


LM_ARCHS = {"hymba-1.5b": (hymba_15b, hymba_15b_smoke)}

# The reference's other LM arch ids: known, not ported yet.
UNPORTED_LM_ARCHS = ("chatglm3-6b", "gemma2-9b", "internvl2-76b", "mamba2-130m",
                     "mistral-nemo-12b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b",
                     "qwen1.5-0.5b", "whisper-small")

ALL_ARCH_IDS = tuple(sorted(PAPER_MODELS)) + tuple(sorted(LM_ARCHS))


def _lookup(name: str, smoke: bool) -> ModelConfig:
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    if name in LM_ARCHS:
        return LM_ARCHS[name][1 if smoke else 0]()
    if name in UNPORTED_LM_ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (see ROADMAP.md); "
            f"ported: {', '.join(ALL_ARCH_IDS)}")
    raise KeyError(f"unknown model {name!r}; known: {sorted(ALL_ARCH_IDS)}")


def get_config(name: str) -> ModelConfig:
    return _lookup(name, smoke=False)


def get_smoke_config(name: str) -> ModelConfig:
    return _lookup(name, smoke=True)
