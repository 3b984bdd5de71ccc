"""The paper's MNIST model: a two-layer MLP (``repro.models.cnn``, MLP branch).

Parameters are a dict ``{"fc1": {"b", "w"}, "fc2": {"b", "w"}}`` with dense
weights stored ``(in, out)`` as in the JAX package (not ``nn.Linear``'s
``(out, in)``), so the flat layout of ``utils.pytree`` matches it leaf for
leaf.  Every leaf may carry leading batch dims (one model per client): the
matmuls broadcast over them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.utils import prng
from repro_torch.utils.elementwise import row_mean


def dense_init(key, shape, fan_in: int, device, scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init (``repro.models.layers.dense_init``)."""
    std = scale / math.sqrt(max(fan_in, 1))
    return std * prng.truncated_normal(key, -2.0, 2.0, shape, device)


def param_spec(cfg: ModelConfig):
    """The flat-layout spec of the MLP's parameters, from the config alone."""
    H, W, C = cfg.image_shape
    return [
        (("fc1", "b"), (cfg.d_ff,)),
        (("fc1", "w"), (H * W * C, cfg.d_ff)),
        (("fc2", "b"), (cfg.num_classes,)),
        (("fc2", "w"), (cfg.d_ff, cfg.num_classes)),
    ]


def init_mlp(key, cfg: ModelConfig, device) -> dict:
    """Parameters of the MLP family, drawn from ``key`` as ``init_cnn`` draws them."""
    if cfg.family != "mlp":
        raise ValueError(f"models.mlp builds the mlp family, got {cfg.family!r} "
                         "(the cnn family is models.cnn)")
    H, W, C = cfg.image_shape
    flat = H * W * C
    ks = prng.split(key, 4)
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
    return {
        "fc1": {"w": dense_init(ks[-2], (flat, cfg.d_ff), flat, device),
                "b": zeros(cfg.d_ff)},
        "fc2": {"w": dense_init(ks[-1], (cfg.d_ff, cfg.num_classes), cfg.d_ff, device),
                "b": zeros(cfg.num_classes)},
    }


def mlp_logits(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images (..., B, H, W, C) -> logits (..., B, num_classes)."""
    x = images.to(params["fc2"]["w"].dtype)
    x = x.reshape(x.shape[:-3] + (-1,))
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"][..., None, :])
    return x @ params["fc2"]["w"] + params["fc2"]["b"][..., None, :]


def loss_from_logits(logits: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy over the last batch axis, in fp32 whatever the
    logits' dtype -> (loss (...,), metrics).

    With grad mode off (the rounds' eval) the metric ``ce``, the rounds'
    test loss, is the same mean through ``row_mean``, whose value for a row
    does not depend on how many rows are evaluated together (a lane's test
    loss is the same in any lane group, shard or lane loop).  Under grad
    mode (a local step, which reads only ``loss``) ``ce`` is ``loss``.
    """
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    loss = nll.mean(dim=-1)
    ce = loss if torch.is_grad_enabled() else row_mean(nll)
    acc = (torch.argmax(logits, dim=-1) == labels).to(torch.float32).mean(dim=-1)
    return loss, {"ce": ce, "accuracy": acc}


def mlp_loss(params: dict, batch: dict):
    """Mean cross-entropy over the last batch axis -> (loss (...,), metrics)."""
    return loss_from_logits(mlp_logits(params, batch["images"]), batch["labels"])
