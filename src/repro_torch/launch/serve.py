"""Batched serving on the port: prefill a prompt batch, decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --full \\
      --batch 4 --prompt-len 2048 --gen 32

The flags of ``repro.launch.serve`` (``--arch --batch --prompt-len --gen
--full``) plus ``--device`` (default ``cuda``; it raises without a card,
``cpu`` runs the kernels' plain versions).  ``--arch`` takes every LM arch
id of the reference; its default is the reference's, ``qwen1.5-0.5b``.
Weights are drawn from a seed as the reference draws them
(``fold_in_str(key(0), "init")``, prompts from ``"prompts"``, a ``vlm``'s
stubbed image embeddings from ``"img"``, an ``encdec``'s stubbed audio frames
from ``"frames"``), and the two ``[serve]`` lines are the reference's; each
time ends in ``torch.cuda.synchronize()`` on the card.  As in the reference,
an ``encdec`` prefill gets no ``max_seq``: its self-attention ring holds
``prompt_len`` slots, and decoding past them overwrites the oldest.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.config import ModelConfig
from repro_torch.configs import LM_ARCHS, get_config, get_smoke_config
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.models import build_model
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor  # (batch, gen) greedy tokens, the first from the prefill
    setup_s: float  # weights drawn on the device, prompts made
    prefill_s: float
    decode_s: float  # gen - 1 decode steps
    logits: torch.Tensor  # the last step's (batch, vocab) logits
    params: dict
    cache: dict  # after the last decode step
    prompts: dict  # "tokens" (batch, prompt_len); a vlm's "image_embeds"; an encdec's "frames"
    cfg: ModelConfig  # the config served


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str = "qwen1.5-0.5b", batch: int = 4, prompt_len: int = 64, gen: int = 32,
          full: bool = False, device="cuda", cfg: ModelConfig | None = None) -> ServeResult:
    """The CLI's run: the generated tokens, the three times, and what the
    run ends with (last logits, weights, cache, prompts).  A ``cfg`` given
    (say, a config cut in depth) takes the place of ``arch`` and ``full``."""
    device = resolve_device(device)
    if cfg is None:
        cfg = get_config(arch) if full else get_smoke_config(arch)
    api = build_model(cfg)
    key = prng.key(0, device)
    t0 = time.perf_counter()
    params = api.init(prng.fold_in_str(key, "init"), device)
    b = make_lm_batch(prng.fold_in_str(key, "prompts"), batch, prompt_len + 1,
                      cfg.vocab_size, device)
    prompts = {"tokens": b["tokens"][:, :prompt_len]}
    if cfg.family == "vlm":
        prompts["image_embeds"] = 0.02 * prng.normal(
            prng.fold_in_str(key, "img"), (batch, cfg.num_image_tokens, cfg.d_model))
    if cfg.family == "encdec":
        prompts["frames"] = 0.02 * prng.normal(
            prng.fold_in_str(key, "frames"), (batch, cfg.encoder_seq, cfg.d_model))
    _sync(device)
    setup_s = time.perf_counter() - t0

    max_seq = None if cfg.family == "encdec" else prompt_len + gen + cfg.num_image_tokens
    out, logits, cache, prefill_s, decode_s = generate(api, params, prompts, gen, max_seq,
                                                       device)
    return ServeResult(out, setup_s, prefill_s, decode_s, logits, params, cache, prompts, cfg)


def generate(api, params: dict, prompts: dict, gen: int, max_seq, device):
    """Prefill ``prompts`` (into a cache of ``max_seq`` positions), then ``gen -
    1`` greedy decode steps, under ``no_grad`` -> (tokens (batch, gen), the
    last logits, the cache, prefill s, decode s)."""
    device = torch.device(device)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, prompts, max_seq)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        tokens = torch.argmax(logits, dim=-1)
        generated = [tokens]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache = api.decode_step(params, cache, tokens)
            tokens = torch.argmax(logits, dim=-1)
            generated.append(tokens)
        out = torch.stack(generated, dim=1)
        _sync(device)
        decode_s = time.perf_counter() - t0
    return out, logits, cache, prefill_s, decode_s


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=sorted(LM_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = serve(args.arch, args.batch, args.prompt_len, args.gen, args.full, args.device)
    print(f"[serve] {res.cfg.name}: prefill {args.batch}x{args.prompt_len} in {res.prefill_s:.2f}s")
    print(f"[serve] decoded {args.gen} tokens/seq in {res.decode_s:.2f}s "
          f"({args.batch * args.gen / res.decode_s:.1f} tok/s); "
          f"sample row: {res.tokens[0][:16].tolist()}")
    return res


if __name__ == "__main__":
    main()
