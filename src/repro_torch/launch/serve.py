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

Sharded over cards (``--model-shards N``, or ``serve(..., mesh=LMMesh)``):

  python -m repro_torch.launch.serve --arch mixtral-8x7b --full --model-shards 4

``ShardedServer`` starts one worker process a rank (``utils/procs.py::
ShardPool``); each joins a process group (a ``file://`` rendezvous in a
fresh temporary directory; ``nccl`` when every rank has its own card, ``gloo``
when ranks share a card or run on the CPU: ``LMMesh.backend``, chosen from the
mesh and never on a failure) and draws its own blocks of the weights under
``sharding.SERVE_RULES`` (``sharding.init_shard``: bit for bit those blocks
of the one-process draw).  The prefill and the greedy decode then run on
every rank at once inside ``sharding.activation_sharding``, as one
``ShardPool.run``; every rank gets the same tokens (asserted), and its
times, peak memory and kernel launches come back with them.  A rank that
fails makes the call raise.  Every family serves sharded on a ``(1, N)``
mesh (mamba2-130m and hymba-1.5b: ``--arch hymba-1.5b --full
--model-shards 4``; whisper-small: ``--arch whisper-small --full
--model-shards 4``, each rank's frames the CLI's and its self ring
``prompt_len`` slots, as unsharded).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig
from repro_torch.configs import LM_ARCHS, get_config, get_smoke_config
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.kernels import add_launches, launch_counts
from repro_torch.models import build_model
from repro_torch.sharding import SERVE_RULES, activation_sharding, init_shard, make_rank
from repro_torch.utils import prng
from repro_torch.utils.device import LMMesh, resolve_device
from repro_torch.utils.procs import ShardPool
from repro_torch.utils.pytree import tree_nbytes, tree_size


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor  # (batch, gen) greedy tokens, the first from the prefill
    setup_s: float  # weights drawn on the device, prompts made
    prefill_s: float
    decode_s: float  # gen - 1 decode steps
    logits: torch.Tensor  # the last step's (batch, vocab) logits
    params: dict | None  # None when sharded (the ranks hold them)
    cache: dict | None  # after the last decode step; None when sharded
    prompts: dict  # "tokens" (batch, prompt_len); a vlm's "image_embeds"; an encdec's "frames"
    cfg: ModelConfig  # the config served
    # sharded: each rank's setup_s, prefill_s, decode_s, held_bytes and
    # peak_bytes (the card's, None on the CPU), launches, hook (what a hook
    # reported); the times above are the slowest rank's
    ranks: list | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg, batch: int, prompt_len: int, device) -> dict:
    """The CLI's prompts from the reference's seed: tokens, and a ``vlm``'s
    stubbed image embeddings or an ``encdec``'s stubbed audio frames."""
    key = prng.key(0, device)
    b = make_lm_batch(prng.fold_in_str(key, "prompts"), batch, prompt_len + 1,
                      cfg.vocab_size, device)
    prompts = {"tokens": b["tokens"][:, :prompt_len]}
    if cfg.family == "vlm":
        prompts["image_embeds"] = 0.02 * prng.normal(
            prng.fold_in_str(key, "img"), (batch, cfg.num_image_tokens, cfg.d_model))
    if cfg.family == "encdec":
        prompts["frames"] = 0.02 * prng.normal(
            prng.fold_in_str(key, "frames"), (batch, cfg.encoder_seq, cfg.d_model))
    return prompts


def max_seq_for(cfg, prompt_len: int, gen: int):
    """The decode budget the CLI prefills with (None for ``encdec``)."""
    return None if cfg.family == "encdec" else prompt_len + gen + cfg.num_image_tokens


def serve(arch: str = "qwen1.5-0.5b", batch: int = 4, prompt_len: int = 64, gen: int = 32,
          full: bool = False, device="cuda", cfg: ModelConfig | None = None,
          mesh: LMMesh | None = None) -> ServeResult:
    """The CLI's run: the generated tokens, the three times, and what the
    run ends with (last logits, weights, cache, prompts).  A ``cfg`` given
    (say, a config cut in depth) takes the place of ``arch`` and ``full``.
    With ``mesh``, sharded over its ranks (``ShardedServer``; ``device`` is
    then the mesh's)."""
    if cfg is None:
        cfg = get_config(arch) if full else get_smoke_config(arch)
    if mesh is not None:
        with ShardedServer(mesh) as server:
            server.load(cfg)
            return server.generate(batch, prompt_len, gen)
    device = resolve_device(device)
    api = build_model(cfg)
    key = prng.key(0, device)
    t0 = time.perf_counter()
    params = api.init(prng.fold_in_str(key, "init"), device)
    prompts = make_prompts(cfg, batch, prompt_len, device)
    _sync(device)
    setup_s = time.perf_counter() - t0

    out, logits, cache, prefill_s, decode_s = generate(api, params, prompts, gen,
                                                       max_seq_for(cfg, prompt_len, gen), device)
    return ServeResult(out, setup_s, prefill_s, decode_s, logits, params, cache, prompts, cfg)


class ShardedServer:
    """A sharded LM server on ``mesh`` (an ``LMMesh``): one worker process a
    rank, started with the process group joined (``start_s``: the pool's
    start-up).  ``load(cfg)`` draws each rank's blocks of the weights;
    ``generate(batch, prompt_len, gen)`` serves the CLI's prompts; ``close()``
    (or leaving ``with``) destroys the process group, ends the workers and
    removes the rendezvous directory."""

    def __init__(self, mesh: LMMesh):
        self.mesh, self.cfg = mesh, None
        self.backend = mesh.backend
        self._dir = tempfile.mkdtemp(prefix="lm-mesh-")
        init_method = "file://" + os.path.join(self._dir, "rendezvous")
        try:
            self.pool = ShardPool(mesh.devices, init=_rank_start,
                                  init_args=(self.backend, init_method, mesh.shape))
        except BaseException:
            shutil.rmtree(self._dir, ignore_errors=True)
            raise
        self.start_s = self.pool.start_s

    @property
    def world(self) -> int:
        return len(self.mesh.devices)

    def load(self, cfg: ModelConfig) -> list:
        """Each rank drops what it held and draws its blocks of ``cfg``'s
        weights.  -> each rank's ``{"setup_s", "params", "param_bytes"}``
        (its seconds, elements and bytes)."""
        self.cfg = cfg
        return self.pool.run(_rank_load, [(cfg,)] * self.world)

    def run(self, fn, args=()) -> list:
        """``fn(worker, *args)`` on every rank, a top-level function: the
        worker's ``state`` holds ``api``, ``rank`` and ``params``."""
        return self.pool.run(fn, [tuple(args)] * self.world)

    def generate(self, batch: int, prompt_len: int, gen: int, forced=None,
                 hook=None) -> ServeResult:
        """The CLI's prefill and ``gen - 1`` greedy decode steps on every rank
        at once (``forced``: teacher-forced, as ``generate`` takes it).
        ``hook``: a picklable callable (a top-level one, or a
        ``functools.partial`` of one) whose result, a context manager with a
        ``report()``, each rank enters around its run; the reports come back
        in ``ranks``.  The workers' kernel launches are added to this
        process's counters."""
        if self.cfg is None:
            raise RuntimeError("ShardedServer.generate: load(cfg) first")
        outs = self.run(_rank_generate, (batch, prompt_len, gen, forced, hook))
        for r, o in enumerate(outs[1:], 1):
            if not torch.equal(o["tokens"], outs[0]["tokens"]):
                raise AssertionError(f"sharded serve: rank {r}'s tokens differ from rank 0's")
        total: dict = {}
        for o in outs:
            for k, n in o["launches"].items():
                total[k] = total.get(k, 0) + n
        add_launches(total)
        first = outs[0]
        return ServeResult(first["tokens"], max(o["setup_s"] for o in outs),
                           max(o["prefill_s"] for o in outs), max(o["decode_s"] for o in outs),
                           first["logits"], None, None, first["prompts"], self.cfg,
                           ranks=[{k: v for k, v in o.items() if k not in ("tokens", "logits",
                                                                            "prompts")}
                                  for o in outs])

    def close(self) -> None:
        """Destroy the process group, end the workers (idempotent)."""
        try:
            if self.pool.alive:
                self.run(_rank_stop)
        finally:
            self.pool.close()
            shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "ShardedServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _rank_start(worker, backend: str, init_method: str, mesh_shape: dict) -> dict:
    """A rank's start-up: its device's settings, then the process group; its
    blocks resolve under ``SERVE_RULES``."""
    resolve_device(worker.device)
    dist.init_process_group(backend, init_method=init_method, world_size=worker.world,
                            rank=worker.rank)
    return {"backend": backend, "mesh": dict(mesh_shape), "rules": SERVE_RULES, "params": None}


def _rank_load(worker, cfg) -> dict:
    """Draw the rank's blocks of ``cfg``'s weights (``sharding.init_shard``)."""
    state, device = worker.state, worker.device
    state["params"] = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    api = build_model(cfg)
    host = state["backend"] == "gloo" and device.type == "cuda"
    rank = make_rank(api, state["mesh"], state["rules"], worker.rank, dist.group.WORLD, host)
    t0 = time.perf_counter()
    params = init_shard(api, prng.fold_in_str(prng.key(0, device), "init"), rank, device)
    _sync(device)
    state.update(api=api, rank=rank, params=params, setup_s=time.perf_counter() - t0)
    return {"setup_s": state["setup_s"], "params": tree_size(params),
            "param_bytes": tree_nbytes(params)}


def _rank_generate(worker, batch: int, prompt_len: int, gen: int, forced, hook) -> dict:
    """One rank's prefill and decode (``generate``) inside ``activation_sharding``
    -> its tokens, last logits and prompts (on the CPU), times, memory,
    launch deltas and the hook's report."""
    state, device = worker.state, worker.device
    api, rank, cfg = state["api"], state["rank"], state["api"].cfg
    t0 = time.perf_counter()
    prompts = make_prompts(cfg, batch, prompt_len, device)
    _sync(device)
    setup_s = state["setup_s"] + time.perf_counter() - t0  # the weights' draw and the prompts
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device) if cuda else None
    before = launch_counts()
    ctx = hook() if hook is not None else contextlib.nullcontext()
    with ctx, activation_sharding(state["mesh"], state["rules"], rank):
        tokens, logits, cache, prefill_s, decode_s = generate(
            api, state["params"], prompts, gen, max_seq_for(cfg, prompt_len, gen), device,
            forced)
    after = launch_counts()
    out = {"tokens": tokens.cpu(), "logits": logits.float().cpu(),
           "prompts": {k: v.cpu() for k, v in prompts.items()},
           "setup_s": setup_s, "prefill_s": prefill_s, "decode_s": decode_s,
           "held_bytes": held, "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda
           else None, "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
           "hook": ctx.report() if hook is not None else None}
    del cache
    if cuda:
        torch.cuda.empty_cache()
    return out


def _rank_stop(worker) -> None:
    worker.state["params"] = None
    dist.destroy_process_group()


def generate(api, params: dict, prompts: dict, gen: int, max_seq, device, forced=None):
    """Prefill ``prompts`` (into a cache of ``max_seq`` positions), then ``gen -
    1`` greedy decode steps, under ``no_grad`` -> (tokens (batch, gen), the
    last logits, the cache, prefill s, decode s).  ``forced`` (batch, gen - 1):
    decode step i is fed ``forced[:, i]`` in place of the token picked before
    it (a teacher-forced run, to hold two runs step by step); the tokens
    returned are still the greedy picks."""
    device = torch.device(device)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, prompts, max_seq)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        tokens = torch.argmax(logits, dim=-1)
        generated = [tokens]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            feed = tokens if forced is None else forced[:, i].to(tokens)
            logits, cache = api.decode_step(params, cache, feed)
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
    ap.add_argument("--model-shards", type=int, default=0,
                    help="serve sharded over N ranks of a (1, N) mesh: cards 0 to N-1, or "
                         "N CPU ranks with --device cpu (0: unsharded)")
    args = ap.parse_args(argv)
    mesh = None
    if args.model_shards:
        from repro_torch.launch.mesh import make_lm_mesh

        mesh = make_lm_mesh(args.model_shards, device=args.device)
    res = serve(args.arch, args.batch, args.prompt_len, args.gen, args.full, args.device,
                mesh=mesh)
    print(f"[serve] {res.cfg.name}: prefill {args.batch}x{args.prompt_len} in {res.prefill_s:.2f}s")
    print(f"[serve] decoded {args.gen} tokens/seq in {res.decode_s:.2f}s "
          f"({args.batch * args.gen / res.decode_s:.1f} tok/s); "
          f"sample row: {res.tokens[0][:16].tolist()}")
    if res.ranks:
        for r, o in enumerate(res.ranks):
            peak = "" if o["peak_bytes"] is None else f", peak {o['peak_bytes'] / 2**30:.2f} GiB"
            print(f"[serve] rank {r}: set-up {o['setup_s']:.2f}s, prefill {o['prefill_s']:.2f}s, "
                  f"decode {o['decode_s']:.2f}s{peak}")
    return res


if __name__ == "__main__":
    main()
