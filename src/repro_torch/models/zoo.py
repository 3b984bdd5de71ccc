"""The LM zoo's uniform API (``repro.models.zoo``), for the ported families.

``build_lm(cfg)`` returns an ``LMApi`` with

  init(key, device)                     -> parameter tree
  loss(params, batch)                   -> (loss, metrics)   [the training objective]
  prefill(params, batch, max_seq=None)  -> (last-token logits, cache)
  decode_step(params, cache, tokens)    -> (logits, cache)   [cache updated in place]
  init_cache(batch, seq_len, prefilled=0, device=None) -> cache tree

Every family of the reference is ported: the decoder-only ``dense``,
``moe``, ``ssm``, ``hybrid`` and ``vlm`` (``models/transformer.py``; a
``vlm`` prefill batch also holds ``image_embeds``) and ``encdec``
(``models/encdec.py``; its prefill batch holds ``frames`` and ``tokens``).
A training batch adds ``targets`` (B, S) to the prefill batch's entries.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.config import ModelConfig
from repro_torch.models import encdec as _encdec
from repro_torch.models import transformer as _tf


class LMApi(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def build_lm(cfg: ModelConfig) -> LMApi:
    _tf.check_family(cfg)
    if cfg.family == "encdec":
        return LMApi(
            cfg,
            init=lambda key, device=None: _encdec.init_encdec(key, cfg, device),
            loss=lambda p, b: _encdec.encdec_loss(p, cfg, b),
            prefill=lambda p, b, max_seq=None: _encdec.encdec_prefill(p, cfg, b, max_seq),
            decode_step=lambda p, c, t: _encdec.encdec_decode_step(p, cfg, c, t),
            init_cache=lambda batch, seq, prefilled=0, device=None: _encdec.init_encdec_cache(
                cfg, batch, seq, prefilled, device),
        )
    return LMApi(
        cfg,
        init=lambda key, device=None: _tf.init_lm(key, cfg, device),
        loss=lambda p, b: _tf.lm_loss(p, cfg, b),
        prefill=lambda p, b, max_seq=None: _tf.lm_prefill(p, cfg, b, max_seq),
        decode_step=lambda p, c, t: _tf.lm_decode_step(p, cfg, c, t),
        init_cache=lambda batch, seq, prefilled=0, device=None: _tf.init_lm_cache(
            cfg, batch, seq, prefilled, device),
    )
