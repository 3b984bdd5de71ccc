"""FL-over-C-ITS experiment driver on the port (the paper's section IV runs).

  PYTHONPATH=src python -m repro_torch.launch.fl_sim --dataset mnist \\
      --strategy contextual --rounds 60 --out artifacts/fl/mnist_contextual.json

The flags of ``repro.launch.fl_sim`` plus ``--device`` (default ``cuda``;
``cpu`` runs the plain kernel versions).  ``--aggregator`` takes the whole
registered catalog (``fedavg``, ``fedavgm``, ``fedadam``, ``fedyogi``,
``stale``, ``fedbuff``); ``--dtype bfloat16`` turns on the mixed-precision
lane (bf16 client updates, fedbuff ring and chunk partials, and the halved
upload they cost, over the fp32 master and moments), as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.config import FLConfig
from repro_torch.configs import PAPER_MODEL_BY_DATASET, get_config
from repro_torch.core.scenarios import SCENARIOS, scenario_config
from repro_torch.core.selection import STRATEGIES
from repro_torch.fl.aggregators import AGGREGATOR_ORDER
from repro_torch.fl.simulation import FLSimulation, time_to_accuracy
from repro_torch.utils import prng


def run_experiment(
    dataset: str,
    strategy: str,
    rounds: int,
    connection_rate: float = 1.0,
    classes_per_client: int = 2,
    num_clients: int = 100,
    seed: int = 0,
    local_epochs: int | None = None,
    samples_per_client: int = 256,
    time_budget_s: float | None = None,
    verbose: bool = False,
    predict_horizon_s: float | None = None,
    scenario: str = "ring",
    aggregator: str = "fedavg",
    dtype: str = "float32",
    device: str = "cuda",
):
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; registered catalog: "
                         f"{', '.join(sorted(SCENARIOS))}")
    if aggregator not in AGGREGATOR_ORDER:
        raise ValueError(
            f"unknown aggregator {aggregator!r}; registered catalog: "
            f"{', '.join(AGGREGATOR_ORDER)} (see repro_torch/fl/aggregators.py)"
        )
    if dtype not in FLConfig.SUPPORTED_DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; supported dtypes: "
                         f"{', '.join(FLConfig.SUPPORTED_DTYPES)}")
    model_cfg = get_config(PAPER_MODEL_BY_DATASET[dataset])
    # paper section IV-A: 3 local epochs on MNIST, 1 on CIFAR-10/SVHN
    epochs = local_epochs if local_epochs is not None else (3 if dataset == "mnist" else 1)
    fl = FLConfig(
        num_clients=num_clients,
        local_epochs=epochs,
        connection_rate=connection_rate,
        classes_per_client=classes_per_client,
        samples_per_client=samples_per_client,
        num_clusters=10,
        aggregator=aggregator,
        seed=seed,
        compute_dtype=dtype,
    )
    tr = scenario_config(scenario, num_vehicles=num_clients)
    if predict_horizon_s is not None:
        tr = dataclasses.replace(tr, predict_horizon_s=predict_horizon_s)
    sim = FLSimulation(model_cfg, fl, tr, dataset, strategy, prng.key(seed), device=device)
    history = sim.run(rounds, time_budget_s=time_budget_s, verbose=verbose)
    return {
        "dataset": dataset,
        "strategy": strategy,
        "aggregator": aggregator,
        "connection_rate": connection_rate,
        "scenario": scenario,
        "classes_per_client": classes_per_client,
        "num_clients": num_clients,
        "seed": seed,
        "dtype": dtype,
        "device": str(sim.device),
        "rounds": [dataclasses.asdict(r) for r in history],
        "time_to_acc_0.5": time_to_accuracy(history, 0.5),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist", choices=sorted(PAPER_MODEL_BY_DATASET))
    ap.add_argument("--strategy", default="contextual", choices=sorted(STRATEGIES))
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--connection-rate", type=float, default=1.0)
    ap.add_argument("--scenario", default="ring")
    ap.add_argument("--aggregator", default="fedavg")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--classes-per-client", type=int, default=2)
    ap.add_argument("--num-clients", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-budget", type=float, default=None)
    ap.add_argument("--out", default="")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.scenario not in SCENARIOS:
        ap.error(f"unknown scenario {args.scenario!r}; registered catalog: "
                 f"{', '.join(sorted(SCENARIOS))}")
    if args.aggregator not in AGGREGATOR_ORDER:
        ap.error(f"unknown aggregator {args.aggregator!r}; registered catalog: "
                 f"{', '.join(AGGREGATOR_ORDER)}")
    if args.dtype not in FLConfig.SUPPORTED_DTYPES:
        ap.error(f"unknown dtype {args.dtype!r}; supported dtypes: "
                 f"{', '.join(FLConfig.SUPPORTED_DTYPES)}")
    result = run_experiment(
        args.dataset, args.strategy, args.rounds, args.connection_rate,
        args.classes_per_client, args.num_clients, args.seed,
        time_budget_s=args.time_budget, verbose=not args.quiet,
        scenario=args.scenario, aggregator=args.aggregator, dtype=args.dtype,
        device=args.device,
    )
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {args.out}")
    print(f"time-to-0.5-acc: {result['time_to_acc_0.5']}")


if __name__ == "__main__":
    main()
