"""The LM trainer of the port (``repro.launch.train``).

Trains one arch of the LM zoo on synthetic LM data: the smoke config by
default, the published config with ``--full``; data, step function,
optimizer, checkpointing and metrics, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --full --steps 5 [--batch 8 --seq 128 --ckpt-dir DIR --ckpt-every N]

The flags of ``repro.launch.train`` plus ``--device`` (default ``cuda``; it
raises without a card, ``cpu`` runs the plain torch path).  Weights are
drawn as the reference draws them (``init(fold_in_str(key(0), "init"))``)
and step s trains on ``make_batch(cfg, fold_in(key(0), s), batch, seq)``,
so the printed lines are the reference's.  No kernel runs in training: the
``ssm`` and ``hybrid`` families' scan is the plain torch one under grad mode
(``models/ssm.py``), on the card as on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.configs import ALL_ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.models import build_model
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_size


def make_batch(cfg: ModelConfig, key: torch.Tensor, batch: int, seq: int) -> dict:
    """One training batch on the key's device: tokens and targets (batch, seq),
    a ``vlm``'s stubbed image embeddings, an ``encdec``'s stubbed frames."""
    b = make_lm_batch(key, batch, seq + 1, cfg.vocab_size)
    out = {"tokens": b["tokens"][:, :seq], "targets": b["targets"][:, :seq]}
    if cfg.family == "vlm":
        out["image_embeds"] = 0.02 * prng.normal(
            prng.fold_in_str(key, "img"), (batch, cfg.num_image_tokens, cfg.d_model))
    if cfg.family == "encdec":
        out["frames"] = 0.02 * prng.normal(
            prng.fold_in_str(key, "frames"), (batch, cfg.encoder_seq, cfg.d_model))
    return out


@dataclasses.dataclass
class TrainResult:
    cfg: ModelConfig
    state: TrainState  # after the last step
    losses: list  # each step's loss
    step_s: list  # each step's wall seconds, batch made and step taken (synchronized)
    n_params: int


def train(arch: str = "qwen1.5-0.5b", steps: int = 20, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, full: bool = False, ckpt_dir: str = "", ckpt_every: int = 0,
          device="cuda", verbose: bool = True) -> TrainResult:
    """The CLI's run."""
    say = print if verbose else (lambda *a: None)
    device = resolve_device(device)
    cfg = get_config(arch) if full else get_smoke_config(arch)
    if cfg.family in ("cnn", "mlp"):
        raise SystemExit("use repro_torch.launch.fl_sim for the FL task models")
    api = build_model(cfg)
    key = prng.key(0, device)
    params = api.init(prng.fold_in_str(key, "init"), device)
    n_params = tree_size(params)
    say(f"[train] {cfg.name}: {n_params / 1e6:.2f}M params on 1 device(s)")

    train_step, opt = make_train_step(api, TrainConfig(learning_rate=lr))
    state = TrainState(params, opt.init(params))
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    losses, step_s = [], []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        ts = time.perf_counter()
        b = make_batch(cfg, prng.fold_in(key, step), batch, seq)
        state, metrics = train_step(state, b)
        loss = float(metrics["loss"])  # waits for the step
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if step % max(steps // 10, 1) == 0 or step == 1:
            say(f"  step {step:4d}  loss={loss:.4f}  ({time.perf_counter() - t0:.1f}s)")
        if ckpt and ckpt_every and step % ckpt_every == 0:
            path = ckpt.save(step, state.params)
            say(f"  checkpoint -> {path}")
    say(f"[train] done in {time.perf_counter() - t0:.1f}s; final loss {losses[-1]:.4f}")
    return TrainResult(cfg, state, losses, step_s, n_params)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ALL_ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true", help="the published config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return train(a.arch, a.steps, a.batch, a.seq, a.lr, a.full, a.ckpt_dir, a.ckpt_every,
                 a.device)


if __name__ == "__main__":
    main()
