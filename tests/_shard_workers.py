"""Worker-side functions for the tests of ``repro_torch.utils.procs.ShardPool``.

A spawned worker unpickles the function it runs by its module's name, so
these live in a module of their own that imports neither JAX nor a test
module.  Each takes the worker (``procs.Worker``) first.
"""
import os
import time

import torch

from repro_torch.fl import engine
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import count_launch


def whoami(worker):
    """-> (rank, device, world, pid, torch threads, what init left)."""
    return (worker.rank, str(worker.device), worker.world, os.getpid(),
            torch.get_num_threads(), worker.state)


def remember(worker, value):
    """A pool ``init``: the worker keeps ``(rank, value)`` as its state."""
    return worker.rank, value


def boom(worker, rank):
    """Raise on rank ``rank``; the others answer."""
    if worker.rank == rank:
        raise ValueError(f"boom on rank {rank}")
    return worker.rank


def nap(worker, seconds):
    """Sleep ``seconds`` (a call that something can interrupt)."""
    time.sleep(seconds)
    return worker.rank


def counted_sweep(worker, *args):
    """The engine's shard body, with ``rank + 1`` B1g and ``2 (rank + 1)``
    B2g launches counted first, as a card's sweep would count them."""
    for _ in range(worker.rank + 1):
        count_launch("repro_torch.kernels.rttg_latency", "grid_launches")
        count_launch("repro_torch.kernels.fedavg_reduce", "grid_launches")
        count_launch("repro_torch.kernels.fedavg_reduce", "grid_launches")
    out = engine._shard_sweep(worker, *args)
    for k, v in ((("rttg_latency", "grid_launches"), worker.rank + 1),
                 (("fedavg_reduce", "grid_launches"), 2 * (worker.rank + 1))):
        out["launches"][k] = out["launches"].get(k, 0) + v
    return out


def stub_build(worker, build_dir, log):
    """``kernels.build.build()`` into ``build_dir`` with the compile stubbed:
    a slow compile (1 s, so that another process arrives meanwhile) that
    appends its pid to ``log`` and writes the library.  -> (pid, the
    build's seconds, 0.0 where the library was found built, its path)."""
    kbuild.BUILD_DIR = type(kbuild.BUILD_DIR)(build_dir)
    kbuild._nvcc = lambda: "nvcc"

    def compile_and_link(nvcc, obj_dir, lib):
        with open(log, "a") as f:
            f.write(f"{os.getpid()}\n")
        time.sleep(1.0)
        tmp = obj_dir / lib.name
        tmp.write_bytes(b"stub")
        os.replace(tmp, lib)
        return ""

    kbuild._compile_and_link = compile_and_link
    info = kbuild.build()
    return os.getpid(), info.seconds, str(info.path)


def moe_local(worker, p, x, E, K, expert_sharded):
    """``models.moe.moe_ffn_local`` on this rank's block of the one-layer MoE
    weights ``p`` (whole tensors: expert-sharded, the rank's E / world
    experts; else its slice of every expert's ffn), over the process group a
    ``launch.serve.ShardedServer`` joined -> y as float32."""
    import types

    import torch.distributed as dist

    from repro_torch.models import moe
    from repro_torch.sharding import SERVE_RULES
    from repro_torch.sharding.shard import Rank, coords_of

    n, r = worker.world, worker.rank
    mesh = {"data": 1, "model": n}
    rank = Rank(r, n, mesh, coords_of(r, mesh), SERVE_RULES, group=dist.group.WORLD,
                expert_sharded=expert_sharded)
    if expert_sharded:
        e = E // n
        local = {w: p[w][r * e:(r + 1) * e] for w in ("w_gate", "w_up", "w_down")}
    else:
        f = p["w_gate"].shape[-1] // n
        local = {"w_gate": p["w_gate"][..., r * f:(r + 1) * f],
                 "w_up": p["w_up"][..., r * f:(r + 1) * f],
                 "w_down": p["w_down"][:, r * f:(r + 1) * f]}
    local["router"] = p["router"]
    cfg = types.SimpleNamespace(num_experts=E, experts_per_token=K)
    with torch.no_grad():
        y, _ = moe.moe_ffn_local(local, x, cfg, rank)
    return y.float()


def serve_states(worker, batch, prompt, gen, forced):
    """The serve CLI's run on this ``ShardedServer`` rank (``launch.serve.generate``
    inside ``activation_sharding``, as ``ShardedServer.generate`` runs it) ->
    the rank's tokens, last logits, ``ssm_cols`` and the final cache's state
    (on the CPU, fp32; positions int32): an encoder-decoder's ``self`` entries,
    or the SSM states, one ``{"h", "conv"}`` a sub-layer."""
    from repro_torch.launch import serve
    from repro_torch.sharding import activation_sharding

    state = worker.state
    api, rank = state["api"], state["rank"]
    cfg = api.cfg
    prompts = serve.make_prompts(cfg, batch, prompt, worker.device)
    with activation_sharding(state["mesh"], state["rules"], rank):
        tokens, logits, cache, _, _ = serve.generate(
            api, state["params"], prompts, gen, serve.max_seq_for(cfg, prompt, gen),
            worker.device, forced)
    out = {"tokens": tokens.cpu(), "logits": logits.float().cpu(), "cols": rank.ssm_cols}
    if "self" in cache:
        out["self"] = {k: v.cpu() if k == "pos" else v.float().cpu()
                       for k, v in cache["self"].items()}
    else:
        out["ssm"] = [{k: v.float().cpu() for k, v in entry["ssm"].items()}
                      for entry in cache["layers"] if "ssm" in entry]
    return out


def hold_params(worker, whole):
    """Replace this rank's weights by its blocks of ``whole`` (a full tree of
    CPU tensors, ``sharding.shard_tree``), on its device -> the blocks' shapes."""
    from repro_torch.sharding import shard_tree
    from repro_torch.utils.pytree import tree_map

    state = worker.state
    api, rank = state["api"], state["rank"]
    blocks = shard_tree(whole, api.param_axes(), state["mesh"], state["rules"], rank.coords)
    state["params"] = tree_map(lambda t: t.to(worker.device), blocks)
    return tree_map(lambda t: tuple(t.shape), state["params"])
