"""The paper's section IV experiment on the port (``examples/fl_cits_benchmark.py``).

Trains the FL task model over simulated CAV clients under three selection
strategies (``contextual``, ``network``, ``gossip``) through
``launch.fl_sim.run_experiment`` and prints each one's rounds, simulated
time, final accuracy and time to 0.5 accuracy, then contextual's reduction
against gossip (the shape of the paper's Fig. 3 / Tab. I).  The example's
flags and lines.

  PYTHONPATH=src python -m repro_torch.launch.fl_cits_benchmark [--rounds 120] \\
      [--dataset mnist] [--clients 100] [--device cpu]

Runs on the card by default; ``--device cpu`` runs the plain kernel versions.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import PAPER_MODEL_BY_DATASET
from repro_torch.launch.fl_sim import run_experiment

STRATEGIES = ("contextual", "network", "gossip")


def run(rounds: int = 120, dataset: str = "mnist", clients: int = 100, device="cuda",
        verbose: bool = True) -> dict:
    """The example's runs -> ``{strategy: run_experiment's result}``."""
    say = print if verbose else (lambda *a: None)
    results = {}
    for strategy in STRATEGIES:
        say(f"\n--- {strategy} ---")
        r = run_experiment(dataset, strategy, rounds, num_clients=clients,
                           samples_per_client=128, verbose=False, device=device)
        last = r["rounds"][-1]
        results[strategy] = r
        say(f"{strategy}: {len(r['rounds'])} rounds, sim_time={last['sim_time']:.0f}s, "
            f"final acc={last['test_acc']:.3f}, time-to-0.5={r['time_to_acc_0.5']}")
    t_ctx = results["contextual"]["time_to_acc_0.5"]
    t_gos = results["gossip"]["time_to_acc_0.5"]
    if t_ctx and t_gos:
        say(f"\ncontextual vs gossip time-to-0.5-acc reduction: {t_gos / t_ctx:.1f}x "
            f"(paper Tab. I reports ~20x on real datasets)")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--dataset", default="mnist", choices=sorted(PAPER_MODEL_BY_DATASET))
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.rounds, a.dataset, a.clients, a.device)


if __name__ == "__main__":
    main()
