"""Batched serving on the port: prefill, then greedy decode through the
sliding-window ring cache, at the mixtral-8x7b smoke config
(``examples/serve_decode.py``).

The cache of each attention layer holds ``min(sliding_window, prompt + gen)``
slots however far decoding goes; every decode step's attention is
``kernels.swa_decode`` (B7 on the card).  Weights from ``key(0)`` and the
prompts from ``key(1)``, as the example draws them; the same three lines.

  PYTHONPATH=src python -m repro_torch.launch.serve_decode [--device cpu]

Runs on the card by default; ``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.launch.serve import generate
from repro_torch.models import build_model
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

BATCH, PROMPT, GEN = 4, 48, 24


def run(device="cuda", verbose: bool = True) -> torch.Tensor:
    """The example's run -> the greedy tokens (BATCH, GEN), the first from the
    prefill."""
    say = print if verbose else (lambda *a: None)
    device = resolve_device(device)
    cfg = get_smoke_config("mixtral-8x7b")
    api = build_model(cfg)
    params = api.init(prng.key(0, device), device)
    b = make_lm_batch(prng.key(1, device), BATCH, PROMPT + 1, cfg.vocab_size, device)
    prompts = {"tokens": b["tokens"][:, :PROMPT]}
    tokens, _, cache, _, _ = generate(api, params, prompts, GEN, PROMPT + GEN, device)
    k_shape = tuple(cache["layers"][0]["attn"]["k"].shape)  # the ring's, as at the prefill
    say(f"prefill {BATCH}x{PROMPT}: cache per pattern-position {k_shape} "
        f"(ring window = {min(cfg.sliding_window, PROMPT + GEN)} slots)")
    say(f"decoded {GEN} tokens x {BATCH} seqs; cache pos now {int(cache['pos'][0])}")
    say(f"sample: {tokens[0].tolist()}")
    return tokens


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
