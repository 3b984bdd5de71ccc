"""The paper's CIFAR-10 and SVHN models: a small CNN (``repro.models.cnn``).

Parameters are ``{"convs": [{"b", "w"}, ...], "fc1": {"b", "w"}, "fc2":
{"b", "w"}}`` with conv kernels stored HWIO ``(3, 3, in, out)`` and dense
weights ``(in, out)``, as in the JAX package, so the flat layout of
``utils.pytree`` matches it leaf for leaf.  Each conv is a 3x3 stride-1
``SAME`` convolution, bias, ReLU and a 2x2 stride-2 max-pool; the features
flatten in NHWC order ``(h, w, c)``, the order ``fc1.w``'s rows are laid out
in.

Every leaf may carry one leading model dim (one model per client, or per
lane of the batched grid): the M models' convolutions run as one grouped
convolution, each model a group of channels, and the dense layers as one
batched matmul.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.mlp import dense_init, loss_from_logits
from repro_torch.utils import prng


def conv_init(key, shape, device, scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init of an HWIO kernel, its std in float32 as
    the reference computes it (``scale / sqrt(float32(fan_in))``)."""
    fan_in = shape[0] * shape[1] * shape[2]
    std = (torch.tensor(scale, dtype=torch.float32, device=device)
           / torch.sqrt(torch.tensor(fan_in, dtype=torch.float32, device=device)))
    return std * prng.truncated_normal(key, -2.0, 2.0, shape, device)


def _flat_features(cfg: ModelConfig) -> int:
    H, W, _ = cfg.image_shape
    for _ in cfg.channels:
        H, W = H // 2, W // 2  # a 2x2 max-pool after each conv
    return H * W * cfg.channels[-1]


def _check(cfg: ModelConfig) -> None:
    if cfg.family != "cnn" or not cfg.channels:
        raise ValueError(f"models.cnn builds the cnn family with conv channels, got family "
                         f"{cfg.family!r}, channels {cfg.channels}")


def param_spec(cfg: ModelConfig):
    """The flat-layout spec of the CNN's parameters, from the config alone."""
    _check(cfg)
    spec, in_c = [], cfg.image_shape[2]
    for i, out_c in enumerate(cfg.channels):
        spec += [(("convs", i, "b"), (out_c,)), (("convs", i, "w"), (3, 3, in_c, out_c))]
        in_c = out_c
    flat = _flat_features(cfg)
    return spec + [
        (("fc1", "b"), (cfg.d_ff,)),
        (("fc1", "w"), (flat, cfg.d_ff)),
        (("fc2", "b"), (cfg.num_classes,)),
        (("fc2", "w"), (cfg.d_ff, cfg.num_classes)),
    ]


def init_cnn(key, cfg: ModelConfig, device) -> dict:
    """Parameters of the CNN family, drawn from ``key`` as ``init_cnn`` draws them."""
    _check(cfg)
    ks = prng.split(key, 2 + 2 * len(cfg.channels))
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
    convs, in_c = [], cfg.image_shape[2]
    for i, out_c in enumerate(cfg.channels):
        convs.append({"w": conv_init(ks[i], (3, 3, in_c, out_c), device), "b": zeros(out_c)})
        in_c = out_c
    flat = _flat_features(cfg)
    return {
        "convs": convs,
        "fc1": {"w": dense_init(ks[-2], (flat, cfg.d_ff), flat, device), "b": zeros(cfg.d_ff)},
        "fc2": {"w": dense_init(ks[-1], (cfg.d_ff, cfg.num_classes), cfg.d_ff, device),
                "b": zeros(cfg.num_classes)},
    }


def cnn_logits(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images -> logits, for one model or M stacked ones.

    One model (leaves without a leading dim): images ``(..., B, H, W, C)``
    -> ``(..., B, num_classes)``.  M models (leaves ``(M, ...)``): images
    ``(M, B, H, W, C)``, model m on its own batch -> ``(M, B,
    num_classes)``.  Activations follow ``fc2.w``'s dtype and the images
    are cast to it (the bf16 lane).
    """
    fc2_w = params["fc2"]["w"]
    lead = fc2_w.shape[:-2]
    if len(lead) > 1 or (lead and images.shape[:-4] != lead):
        raise ValueError(f"cnn_logits: parameters with leading dims {tuple(lead)} take images "
                         f"(M, B, H, W, C) for M models, got {tuple(images.shape)}")
    M = lead[0] if lead else 1
    x = images.to(fc2_w.dtype)
    batch = x.shape[:-3]
    H, W, C = x.shape[-3:]
    x = x.reshape(M, -1, H, W, C)
    B = x.shape[1]
    # NHWC per model -> NCHW with the models as channel groups: (B, M * C, H, W)
    x = x.permute(1, 0, 4, 2, 3).reshape(B, M * C, H, W)
    for conv in params["convs"]:
        kh, kw, cin, cout = conv["w"].shape[-4:]
        w = conv["w"].reshape(M, kh, kw, cin, cout).permute(0, 4, 3, 1, 2)
        x = F.conv2d(x, w.reshape(M * cout, cin, kh, kw), padding=(kh // 2, kw // 2), groups=M)
        x = torch.relu(x + conv["b"].reshape(M * cout, 1, 1))
        x = F.max_pool2d(x, 2, 2)
    # -> (M, B, h * w * c), each model's features in NHWC order
    _, _, h, w = x.shape
    x = x.reshape(B, M, -1, h, w).permute(1, 0, 3, 4, 2).reshape(M, B, -1)
    fc1, fc2 = params["fc1"], params["fc2"]
    x = torch.relu(x @ fc1["w"].reshape(M, *fc1["w"].shape[-2:]) + fc1["b"].reshape(M, 1, -1))
    x = x @ fc2_w.reshape(M, *fc2_w.shape[-2:]) + fc2["b"].reshape(M, 1, -1)
    return x.reshape(batch + (-1,))


def cnn_loss(params: dict, batch: dict):
    """Mean cross-entropy over the last batch axis -> (loss (...,), metrics)."""
    return loss_from_logits(cnn_logits(params, batch["images"]), batch["labels"])
