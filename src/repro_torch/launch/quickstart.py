"""Quickstart: one contextual-selection FL round, stage by stage, on the port.

The port of ``examples/quickstart.py``: the paper's four-stage pipeline run
explicitly (no simulation wrapper), so each artifact shows: the fused RTTG,
the predicted latencies, the client clusters and the Fast-gamma election;
then the elected cohort trains and FedAvg aggregates.  The same config
(N=40, 5 clusters, the 128-wide MLP), the same keys and the same lines as
the JAX example.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cuda|cpu]

Runs on the card by default; ``--device cpu`` runs the plain kernel versions.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.config import FLConfig, ModelConfig, TrafficConfig
from repro_torch.core import ContextualSelector, TrafficTwin
from repro_torch.fl.client import make_local_trainer
from repro_torch.fl.partition import make_test_set, partition_clients
from repro_torch.fl.server import fedavg_aggregate, normalized_weights
from repro_torch.models import build_model
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_bytes

N = 40


def run(device="cuda", verbose: bool = True) -> dict:
    """The example's sequence -> its artifacts (elected ids, cluster sizes,
    predicted latencies, accuracies before and after the FedAvg round)."""
    device = resolve_device(device)
    say = print if verbose else (lambda *a: None)
    fl_cfg = FLConfig(num_clients=N, samples_per_client=128, num_clusters=5)
    traffic_cfg = TrafficConfig(num_vehicles=N)
    model_cfg = ModelConfig(name="mlp", family="mlp", num_layers=0, d_model=0, num_heads=0,
                            num_kv_heads=0, d_ff=128, vocab_size=0, image_shape=(28, 28, 1),
                            num_classes=10, channels=())

    key = prng.key(0)
    api = build_model(model_cfg)
    params = api.init(key, device)
    model_bytes = tree_bytes(api.spec)
    say(f"global model: {model_bytes / 1e6:.2f} MB payload")

    # --- the C-ITS digital twin ------------------------------------------
    twin = TrafficTwin(traffic_cfg, key, device)
    state = twin.advance(twin.init_state(), prng.key(1), 10.0)
    say(f"twin: {N} CAVs, mean speed {float(state.speed.mean()) * 3.6:.0f} km/h")

    # --- stage 1+2: V2X fusion and latency prediction --------------------
    selector = ContextualSelector(fl_cfg, traffic_cfg, key, device)
    selector.observe(state)
    say(f"stage 1: fused RTTG with {N} nodes")
    lat, _ = selector.predicted_latency(model_bytes)
    say(f"stage 2: predicted latency {float(lat.min()):.2f}..{float(lat.max()):.2f} s "
        f"(horizon {traffic_cfg.predict_horizon_s}s)")

    # --- stage 3: data-level grouping ------------------------------------
    images, labels = partition_clients(key, "mnist", fl_cfg, device=device)
    trainer = make_local_trainer(api.loss, fl_cfg.learning_rate, 1, fl_cfg.batch_size)
    bs = fl_cfg.batch_size
    _, vecs = trainer(params, images[:, :bs], labels[:, :bs], prng.key(2))
    selector.report_updates(torch.arange(N), vecs)
    selector.recluster()
    sizes = torch.bincount(selector.clusters, minlength=fl_cfg.num_clusters).tolist()
    say(f"stage 3: k-means on update sketches -> cluster sizes {sizes}")

    # --- stage 4: Fast-gamma election ------------------------------------
    sel = selector.select("contextual", model_bytes)
    idx = torch.nonzero(sel["mask"])[:, 0]
    say(f"stage 4: elected clients {idx.tolist()} "
        f"(mean predicted latency {float(sel['latency_pred'][idx].mean()):.2f}s)")

    # --- train the cohort + FedAvg ---------------------------------------
    updates, _ = trainer(params, images[idx], labels[idx], prng.key(3))
    n = idx.numel()
    w = normalized_weights(torch.ones((n,), dtype=torch.bool, device=device),
                           torch.full((n,), fl_cfg.samples_per_client, device=device))
    new_params = fedavg_aggregate(params, updates, w)

    tx, ty = make_test_set(key, "mnist", device=device)
    with torch.no_grad():
        before = float(api.loss(params, {"images": tx, "labels": ty})[1]["accuracy"])
        after = float(api.loss(new_params, {"images": tx, "labels": ty})[1]["accuracy"])
    say(f"FedAvg round: test accuracy {before:.3f} -> {after:.3f}")
    return {"elected": idx.tolist(), "cluster_sizes": sizes,
            "latency_pred": sel["latency_pred"], "acc_before": before, "acc_after": after}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
