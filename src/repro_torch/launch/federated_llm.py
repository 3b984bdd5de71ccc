"""Contextual client selection for federated LM fine-tuning, on the port
(``examples/federated_llm.py``).

Each CAV holds a private token stream; the server federates the smoke-size
qwen1.5-0.5b with the four-stage contextual pipeline electing each round's
cohort (``core.ContextualSelector``).  Each elected client takes one
``-0.01 * grad`` step of ``LMApi.loss``; FedAvg aggregates the cohort's
update trees in plain torch (``fl.server.fedavg_aggregate``); the updates'
flat vectors become the clients' sketches, and the selector re-clusters.
The same config, keys and lines as the JAX example.

  PYTHONPATH=src python -m repro_torch.launch.federated_llm [--rounds 5] [--device cpu]

Runs on the card by default; ``--device cpu`` runs the plain kernel versions.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.config import FLConfig, TrafficConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import ContextualSelector, TrafficTwin
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.fl.server import fedavg_aggregate, normalized_weights
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import build_model
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (flatten_to_vector, tree_global_norm, tree_map,
                                      tree_nbytes, tree_sub)


def run(rounds: int = 5, clients: int = 16, seq: int = 64, device="cuda",
        verbose: bool = True) -> list:
    """The example's rounds -> one dict a round: ``cohort`` (client ids),
    ``clusters`` (theirs), ``eval_loss`` and ``update_norm`` (the global norm
    of the round's change to the params)."""
    say = print if verbose else (lambda *a: None)
    device = resolve_device(device)
    cfg = get_smoke_config("qwen1.5-0.5b")
    api = build_model(cfg)
    key = prng.key(0, device)
    params = api.init(key, device)
    payload = tree_nbytes(params)
    say(f"federating {cfg.name}: {payload / 1e6:.1f} MB payload, {clients} CAV clients")

    N = clients
    fl_cfg = FLConfig(num_clients=N, num_clusters=4, select_fraction=0.25)
    traffic = TrafficConfig(num_vehicles=N)
    twin = TrafficTwin(traffic, key, device)
    state = twin.init_state()
    selector = ContextualSelector(fl_cfg, traffic, key, device)

    def client_batch(c: int, rnd: int) -> dict:
        # per-client private token streams: two latent "dialects" -> clusters
        k = prng.fold_in_str(prng.key(1000 + c % 2, device), f"r{rnd}c{c}")
        return make_lm_batch(k, 2, seq, cfg.vocab_size)

    def local_update(p, batch):
        return tree_map(lambda g: -0.01 * g, value_and_grad(api.loss, p, batch)[2])

    eval_b = make_lm_batch(prng.key(7, device), 4, seq, cfg.vocab_size)
    out = []
    for rnd in range(rounds):
        selector.observe(state)
        sel = selector.select("contextual", payload)
        idx = torch.nonzero(sel["mask"])[:, 0]
        ups = [local_update(params, client_batch(c, rnd)) for c in idx.tolist()]
        updates = tree_map(lambda *xs: torch.stack(xs), *ups)
        n = idx.numel()
        w = normalized_weights(torch.ones((n,), dtype=torch.bool, device=device),
                               torch.ones((n,), device=device))
        new = fedavg_aggregate(params, updates, w)
        update_norm = float(tree_global_norm(tree_sub(new, params)))
        params = new
        selector.report_updates(idx, torch.stack([flatten_to_vector(u) for u in ups]))
        selector.recluster()
        state = twin.advance(state, prng.fold_in(key, rnd), 5.0)
        with torch.no_grad():
            loss = float(api.loss(params, eval_b)[0])
        cl = selector.clusters[idx].tolist()
        say(f"round {rnd}: cohort={idx.tolist()} clusters={cl} eval loss={loss:.3f}")
        out.append({"cohort": idx.tolist(), "clusters": cl, "eval_loss": loss,
                    "update_norm": update_norm})
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.rounds, a.clients, a.seq, a.device)


if __name__ == "__main__":
    main()
