"""The port's models: the FL task MLP and CNN and every family of the LM zoo
(dense, moe, ssm, hybrid, vlm, encdec).

``build_model(cfg)`` gives the FL ``ModelApi`` for ``mlp`` and ``cnn`` and
hands the LM families to ``models.zoo.build_lm``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.config import ModelConfig
from repro_torch.models import cnn as _cnn
from repro_torch.models import mlp as _mlp


class ModelApi(NamedTuple):
    cfg: ModelConfig
    init: Callable  # (key, device) -> params dict
    loss: Callable  # (params, batch) -> (loss, metrics)
    spec: list  # flat-layout (path, shape) spec of the parameters


def build_model(cfg: ModelConfig):
    if cfg.family == "mlp":
        return ModelApi(cfg, init=lambda key, device: _mlp.init_mlp(key, cfg, device),
                        loss=_mlp.mlp_loss, spec=_mlp.param_spec(cfg))
    if cfg.family == "cnn":
        return ModelApi(cfg, init=lambda key, device: _cnn.init_cnn(key, cfg, device),
                        loss=_cnn.cnn_loss, spec=_cnn.param_spec(cfg))
    from repro_torch.models.zoo import build_lm

    return build_lm(cfg)
