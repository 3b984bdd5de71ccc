"""Architecture configs of the port: the paper's FL task models and the LM zoo.

Declared as in ``repro/configs/``: ``get_config(arch)`` gives the exact
assigned config, ``get_smoke_config(arch)`` the reduced same-family variant
the CPU tests run.  Every FL model runs: ``fl-mnist-mlp`` and the two CNNs
``fl-cifar10-cnn`` and ``fl-svhn-cnn``; of the LM zoo every family:
``hybrid`` (hymba-1.5b), ``ssm`` (mamba2-130m), ``dense``
(qwen1.5-0.5b, gemma2-9b, mistral-nemo-12b, chatglm3-6b), ``moe``
(mixtral-8x7b, phi3.5-moe-42b-a6.6b), ``vlm`` (internvl2-76b) and ``encdec``
(whisper-small).  An unknown arch id raises ``KeyError``.
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


def mamba2_130m() -> ModelConfig:
    """mamba2-130m: attention-free SSD (state-space duality) [arXiv:2405.21060]."""
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=0,  # attention-free
        num_kv_heads=0,
        d_ff=0,  # mamba2 blocks have no separate MLP
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,  # d_inner 1536 -> 24 SSD heads
        ssm_expand=2,
        ssm_chunk=128,
        rope_style="none",
        tie_embeddings=True,
        sharding_profile="dp",
        remat_policy="dots",
        loss_chunk=0,
        max_position_embeddings=1_048_576,
        source="arXiv:2405.21060",
    )


def mamba2_130m_smoke() -> ModelConfig:
    return mamba2_130m().replace(
        name="mamba2-130m-smoke",
        num_layers=2,
        d_model=256,
        vocab_size=512,
        ssm_state=32,
        ssm_head_dim=32,
        ssm_chunk=16,
        dtype="float32",
        remat_policy="none",
    )


def qwen15_05b() -> ModelConfig:
    """qwen1.5-0.5b: dense MHA with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,  # qwen1.5-0.5b ties lm_head to the embedding
        rope_theta=1e6,
        sharding_profile="dp",
        remat_policy="dots",
        loss_chunk=0,
        max_position_embeddings=32_768,
        source="hf:Qwen/Qwen1.5-0.5B",
    )


def qwen15_05b_smoke() -> ModelConfig:
    return qwen15_05b().replace(
        name="qwen1.5-0.5b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=512,
        dtype="float32",
        remat_policy="none",
    )


def gemma2_9b() -> ModelConfig:
    """gemma2-9b: dense GQA, local/global alternation, logit softcaps
    [arXiv:2408.00118].  The base config keeps full-attention global layers;
    ``gemma2_9b_long_ctx`` is the ``swa-capped`` variant."""
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=256000,
        head_dim=256,  # gemma2-9b decouples head_dim
        kv_repeat=2,
        sliding_window=4096,
        layer_pattern=("local", "global"),
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        zero_centered_norm=True,
        embed_scale=True,
        train_microbatches=4,
        max_position_embeddings=8_192,
        source="arXiv:2408.00118",
    )


def gemma2_9b_long_ctx() -> ModelConfig:
    """The sliding-window variant that runs long_500k (global layers 32k)."""
    return gemma2_9b().replace(variant="swa-capped", max_position_embeddings=1_048_576)


def gemma2_9b_smoke() -> ModelConfig:
    return gemma2_9b().replace(
        name="gemma2-9b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        kv_repeat=1,
        sliding_window=32,
        max_position_embeddings=256,
        dtype="float32",
        remat_policy="none",
    )


def mistral_nemo_12b() -> ModelConfig:
    """mistral-nemo-12b: dense GQA, 128k context, head_dim 128
    [hf:mistralai/Mistral-Nemo-Base-2407]."""
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=131072,
        head_dim=128,  # nemo decouples head_dim from d_model / num_heads
        kv_repeat=2,
        rope_theta=1e6,
        max_position_embeddings=131_072,  # "128k ctx"
        train_microbatches=8,
        source="hf:mistralai/Mistral-Nemo-Base-2407",
    )


def mistral_nemo_12b_smoke() -> ModelConfig:
    return mistral_nemo_12b().replace(
        name="mistral-nemo-12b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        head_dim=32,
        kv_repeat=1,
        dtype="float32",
        remat_policy="none",
    )


def chatglm3_6b() -> ModelConfig:
    """chatglm3-6b: dense GQA (2 KV heads) with 2d RoPE [arXiv:2406.12793]."""
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        kv_repeat=8,  # kv 2 -> 16
        rope_style="2d",  # chatglm rotates half the head dim
        qkv_bias=True,
        train_microbatches=4,
        max_position_embeddings=32_768,
        source="arXiv:2406.12793",
    )


def chatglm3_6b_smoke() -> ModelConfig:
    return chatglm3_6b().replace(
        name="chatglm3-6b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        kv_repeat=1,
        dtype="float32",
        remat_policy="none",
    )


def mixtral_8x7b() -> ModelConfig:
    """mixtral-8x7b: 8-expert top-2 MoE with sliding-window attention
    [arXiv:2401.04088]."""
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        num_experts=8,
        experts_per_token=2,
        kv_repeat=2,
        sliding_window=4096,
        layer_pattern=("local",),  # every layer windowed (SWA), Mistral-style
        rope_theta=1e6,
        max_position_embeddings=131_072,
        train_microbatches=8,
        source="arXiv:2401.04088",
    )


def mixtral_8x7b_smoke() -> ModelConfig:
    return mixtral_8x7b().replace(
        name="mixtral-8x7b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        num_experts=4,
        kv_repeat=1,
        sliding_window=32,
        dtype="float32",
        remat_policy="none",
    )


def phi35_moe_42b() -> ModelConfig:
    """phi3.5-moe-42b-a6.6b: 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE-instruct]."""
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        num_experts=16,
        experts_per_token=2,
        kv_repeat=2,  # kv 8 -> 16, as the reference shards the cache
        rope_theta=10_000.0,
        max_position_embeddings=131_072,
        train_microbatches=4,
        source="hf:microsoft/Phi-3.5-MoE-instruct",
    )


def phi35_moe_42b_smoke() -> ModelConfig:
    return phi35_moe_42b().replace(
        name="phi3.5-moe-42b-a6.6b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        num_experts=4,
        kv_repeat=1,
        dtype="float32",
        remat_policy="none",
    )


def internvl2_76b() -> ModelConfig:
    """internvl2-76b: the VLM's language decoder [arXiv:2404.16821].  The
    vision encoder is stubbed, as in the reference: ``num_image_tokens``
    precomputed patch embeddings go in front of the text tokens."""
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        kv_repeat=2,
        num_image_tokens=256,
        rope_theta=5e5,
        max_position_embeddings=131_072,
        train_microbatches=16,
        serve_fsdp=True,
        attn_block_q=256,
        source="arXiv:2404.16821",
    )


def internvl2_76b_smoke() -> ModelConfig:
    return internvl2_76b().replace(
        name="internvl2-76b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        kv_repeat=1,
        num_image_tokens=4,
        dtype="float32",
        remat_policy="none",
    )


def whisper_small() -> ModelConfig:
    """whisper-small: encoder-decoder ASR backbone, conv frontend stubbed
    [arXiv:2212.04356].

    The encoder takes precomputed frame embeddings (B, 1500, 768) (the mel +
    conv stub); decoding runs the decoder with a self-attention KV cache and
    the cached cross-attention K / V.
    """
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        encoder_layers=12,
        encoder_seq=1500,
        rope_style="none",  # whisper uses absolute positions
        attn_block_q=256,
        train_microbatches=2,
        max_position_embeddings=33_024,
        source="arXiv:2212.04356",
    )


def whisper_small_smoke() -> ModelConfig:
    return whisper_small().replace(
        name="whisper-small-smoke",
        num_layers=2,
        encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        encoder_seq=16,
        max_position_embeddings=128,
        dtype="float32",
        remat_policy="none",
    )


LM_ARCHS = {
    "chatglm3-6b": (chatglm3_6b, chatglm3_6b_smoke),
    "gemma2-9b": (gemma2_9b, gemma2_9b_smoke),
    "hymba-1.5b": (hymba_15b, hymba_15b_smoke),
    "internvl2-76b": (internvl2_76b, internvl2_76b_smoke),
    "mamba2-130m": (mamba2_130m, mamba2_130m_smoke),
    "mistral-nemo-12b": (mistral_nemo_12b, mistral_nemo_12b_smoke),
    "mixtral-8x7b": (mixtral_8x7b, mixtral_8x7b_smoke),
    "phi3.5-moe-42b-a6.6b": (phi35_moe_42b, phi35_moe_42b_smoke),
    "qwen1.5-0.5b": (qwen15_05b, qwen15_05b_smoke),
    "whisper-small": (whisper_small, whisper_small_smoke),
}

ALL_ARCH_IDS = tuple(sorted(PAPER_MODELS)) + tuple(sorted(LM_ARCHS))


def _lookup(name: str, smoke: bool) -> ModelConfig:
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    if name in LM_ARCHS:
        return LM_ARCHS[name][1 if smoke else 0]()
    raise KeyError(f"unknown model {name!r}; known: {sorted(ALL_ARCH_IDS)}")


def get_config(name: str) -> ModelConfig:
    return _lookup(name, smoke=False)


def get_smoke_config(name: str) -> ModelConfig:
    return _lookup(name, smoke=True)
