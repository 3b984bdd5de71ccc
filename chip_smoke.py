"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --wrapper-times CHECKOUT

The second form runs phases 1 and 2 and then only ``rttg_latency``'s and
``fedavg_reduce``'s wrappers as the round calls them (phase 5's profile of
them), from the ``src/`` of another checkout (say, the parent commit's
``git archive``), so that two trees can be compared in one call.

Phases (any failure raises and exits non-zero):

1. device: name, count, ``nvidia-smi`` name and power limit; no card fails;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc into ``build/kernels`` and print the seconds and ptxas's registers
   and spills per kernel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at the edges, each call repeated bitwise:
   ``rttg_latency`` around its one-block limit (1,024 and 1,025 clients), at
   the fleet's 100,000 and at 300,000 (more clients than resident threads),
   at R = 1, 40 and 32,768, and with positions at the predictor's wrap (0,
   just under the ring, the ring, past twice the ring, below 0);
   ``rttg_latency`` also at the engine grids' N = 20 in each of the 8 catalog
   scenarios, predicted and realized, at CR 1.0 and 0.7;
   ``rttg_latency_grid`` (B1g, the batched grid round's geometry) on 24
   lanes over the 8 catalog scenarios at N = 20 and 100, predicted and
   realized, CR 1.0 and 0.7, and at one lane, one client, 1,024 clients and
   a dark-RSU lane beside a live one: every lane bit for bit a
   ``rttg_latency`` call on that lane, conn exact and latency within rtol
   1e-5 of its plain version, repeated bitwise; B1g with the RSU ids (the
   two-tier grids' realized pass) on the hierarchical probe's 12 lanes at N =
   20, the streamed grid's 8 at N = 100 and two lanes of 1,024, the ids bit
   for bit B1's and the plain version's; ``rsu_reduce_grid`` (B5g, the
   two-tier grids' chunk walk) on the probe's (12, 3, 159,010) and the
   streamed grid's (8, 4, 159,010) chunks, at R = 10, 33 and 40, an odd P
   with rows off their alignment and one lane of one row, with and without
   the carry, fp32 rows and bf16 rows into fp32 and bf16 partials: every lane
   bit for bit an ``rsu_reduce`` call on that lane, within its plain
   version's tolerance, repeated bitwise; ``fedavg_reduce_grid`` (B2g)
   on 24 lanes at K = 2 and 10, P = 159,010, fp32 and bf16 rows, and at one
   lane, K = 1, an odd P and rows off their alignment: every lane bit for
   bit a ``fedavg_reduce`` call, within its plain version's tolerance,
   repeated bitwise; ``server_update_grid`` and
   ``server_update_buffered_grid`` (B3g / B4g, the batched round's server
   step) on 24, 40 and 48 lanes at K = 2 and 20, the 8-slot ring, P =
   159,010, every rule mixed across lanes and ``drain`` mixed, fp32 and
   bf16 rows and master, the registry with no moment rule, and at one lane,
   an odd P, one ring slot and rows off their alignment: every lane bit for
   bit a ``server_update`` (``server_update_buffered``) call on that lane,
   within its plain version's tolerance, repeated bitwise;
   ``fedavg_reduce`` at K = 1, 2, 7, 8, 9, 10, 17 and 100, odd P included;
   ``server_update`` for every rule
   and ``server_update_buffered`` for both ``drain`` states (also at the
   async engine grid's K = 2 beside its 8-slot ring), and their two
   bitwise contracts (rule 0 is ``fedavg_reduce`` + the AXPY; no drain is
   the unbuffered update); ``fedavg_reduce`` and ``fedavg_reduce_grid`` at
   the CNN datasets' P (fl-cifar10-cnn's 1,070,794 and fl-svhn-cnn's
   603,034): B2 at K = 10 on fp32 and bf16 rows, B2g at (24, 2) and, on bf16
   rows, (24, 10), and B2g on a (9, 256, 1,070,794) bf16 grid whose last
   lane starts past 2^31 elements, every lane bit for bit B2's;
   ``rsu_reduce`` with and without its carry, on
   random, dyadic and special operands, at R = 10, 33, 40 and 100 (one and
   several 32-RSU groups) and at its launch plan's edges (K off its 4-row
   slab, ragged and odd P, 16- and 8-byte rows, the fleet's padded last
   chunk), each launch repeated bitwise, and a chunk walk bit for bit at
   R = 10 and 40;
   the bf16 lane's rows through the same four kernels: ``fedavg_reduce`` at
   (10, 159,010), the precision engine grid's (2, 159,010), K = 1, odd P, P = 2 mod 4 and rows one element off their
   4-byte alignment; ``server_update`` under every rule with an fp32 and a
   bf16 master, its buffered form with a bf16 ring draining and not, and
   both contracts on bf16 rows; ``rsu_reduce`` with bf16 rows into bf16 and
   fp32 partials, with and without its carry, at K = 4 and 32, R = 10, 33
   and 40, odd P and 2-byte-aligned rows, the fleet's padded chunk, the
   bf16 carry's two roundings (the JAX round's ``partials + part_c``) on
   operands where one rounding differs, and bf16 chunk walks;
   ``swa_decode`` and ``ssd_scan`` at hymba-1.5b's shapes in bf16 and fp32,
   at the ssm and dense families' serving shapes (gemma2-9b's wrapped
   4,096-slot ring and its global layers at D=256 with softcap 50, G=2 at
   D=128, qwen1.5-0.5b's G=1 at D=64, mamba2-130m's prefill), at the moe and
   vlm families' (mixtral-8x7b's wrapped 4,096-slot ring at G=2, phi3.5-moe's
   B=4, internvl2-76b's G=4), at whisper-small's self ring (64 slots,
   wrapped) and cross-attention (1,500 frames, every one visible) and at
   their edges (a ragged split, one slot, G=1, a partly filled and a
   wrapped ring, rows with no visible slot, softcap; a window narrower than
   a split, G=16 at D=256, rows of 4-byte and 2-byte multiples; one step, a
   ragged last chunk, Q > S, a given h0, mamba2's ds=128 head, 12,800
   chunks on the chain, odd hp and ds, chunks of 16), each repeated bitwise;
   ``pairwise_cosine`` at the reference's
   shapes (the 128 / 512 tile edges, one row, D=1) in fp32 and bf16 and at
   its launch plan's tile and split edges, with a zero row, bitwise
   symmetric, repeated bitwise, and ``gram_nt`` with x != y, N != M;
4. main path: ``FLSimulation`` (ring / contextual / mnist, 100 vehicles,
   fl-mnist-mlp, the paper's section IV-A defaults) for 5 rounds on the card,
   with the kernels' launch counts, and one round replayed from the same
   state on the card and on the CPU;
4b. aggregator lanes: the same simulation at CR 0.7 (Table I) for 5 rounds
   under each of ``fedavgm``, ``fedadam``, ``fedyogi``, ``stale`` and
   ``fedbuff``, each with its launch counts and a card-vs-CPU replay; then
   the round-level contracts: the full registry at index 0 is the fedavg
   round, and fedbuff with its buffer disabled is too, bit for bit;
4c. two-tier lanes (N=100): contract (a), the hierarchical round is the
   flat round bit for bit, for ``("fedavg",)`` and every rule of the full
   registry at CR 0.7; then 5 rounds each of the streamed lane
   (``client_block=4``: 3 ``rsu_reduce`` launches a round) on ring under
   ``fedavg`` and ``fedbuff`` and on rsu_outage under ``fedavg``, each round's
   economics bitwise those of the unblocked hierarchical round from the same
   state, and a card-vs-CPU replay; the same on ring with an RSU every 250 m
   (R = 40, past one 32-RSU group);
4d. fleet: the fleet bench's settings and engine (``ExperimentEngine``, 2
   samples per client, K=100 in chunks of 32, no warm-up) at N=20,000 for 1
   round and N=100,000 for 2: the engine's set-up (``_lanes``) and then its
   round loop one grid round at a time, with the set-up time, each round's
   wall, peak memory (the set-up's and the rounds'), launches, the neighbour
   rows recomputed densely and the final state finite; at N=20,000 the
   engine's first round again from its initial state (bitwise) and on the
   dense neighbour search and fusion, which must give the same neighbours
   and integers;
4e. serving: ``python -m repro_torch.launch.serve --arch hymba-1.5b --full``'s
   run (bf16, B=4, prompt 2048, gen 32: the prefill fills a wrapped 1024-slot
   ring and spans 16 SSD chunks) with set-up, prefill and decode times, peak
   memory, the sample row and the launch counts (32 ``ssd_scan``, 32 x 31
   ``swa_decode``); then the same architecture cut to 2 layers, in fp32 and
   bf16, prefill and 4 decode steps on the card against the CPU's plain path
   from the same weights; then, at full width and depth in fp32, 2 decode
   steps against one longer prefill; then the ssm and dense families, 2
   layers card-vs-CPU in fp32 and bf16 for mamba2-130m (S=300, a ragged
   chunk), gemma2-9b (one local and one global layer, S=4100, one row) and
   chatglm3-6b (S=600), and mamba2-130m's decode vs prefill in fp32 at full
   depth; then one MoE layer of mixtral-8x7b and of phi3.5-moe at full width
   on a skewed input that drops copies, card vs CPU in fp32 and bf16 (expert
   ids, slots and kept mask exactly, no device-to-host sync on the card), and
   2 layers card-vs-CPU in fp32 and bf16 for mixtral-8x7b (S=600),
   phi3.5-moe (S=600) and internvl2-76b (S=300 after its 256 image tokens),
   and whisper-small cut to 2 + 2 layers (4 x 64 behind 1,500 frames, its
   ring wrapping, as the CLI prefills it) (the families' serving runs come
   last, after phase 5);
4f. pipeline: ``python -m repro_torch.launch.quickstart`` on the card and
   on the CPU (the same elected ids and cluster sizes); three rounds of
   ``ContextualSelector`` at full width (ring, N=100, sketch_dim 1024,
   fl-mnist-mlp updates, 10 clusters, contextual), each with one counted
   ``pairwise_cosine`` launch (the stage-3 Gram) and per-stage wall times;
   one selector round replayed on the CPU's plain path; one main-path
   round through the unfused lane against the fused lane;
4g. bf16 lane: ``python -m repro_torch.launch.fl_sim --dtype bfloat16``'s
   main path for 5 rounds, one round each of ``fedadam`` and ``stale``, 5
   of ``fedbuff`` (its bf16 ring must park and drain), 3 of the streamed
   two-tier lane (``fedbuff``, ``client_block=4``: bf16 chunk partials and
   carry) and 2 of ``fedadam`` with a bf16 master, each with its launch
   counts and its first round replayed on the CPU's plain path (integers
   equal, floats within ``BF16_REPLAY``); then one fleet round at
   N=100,000 in bf16, its peak memory beside the fp32 fleet round's;
4h. engine: ``benchmarks/engine_throughput.py``'s grids through
   ``ExperimentEngine`` (3 strategies x the 8 catalog scenarios, N=20, 5
   rounds, eval every 5): the 24-run grid through the batched round, cold
   and warm, exactly 10 ``rttg_latency_grid`` and 5 ``fedavg_reduce_grid``
   launches a sweep and no one-lane B1 or B2, every lane's final accuracy
   finite; the same lanes through the lane loop on the card (240 B1, 120
   B2) against the batched grid, every lane within ``GRID_TOL``; two lanes
   replayed on the CPU's plain path; the same 24 runs through
   ``FLSimulation`` (240 B1, 120 B2); each path's set-up and round loop
   timed apart; one batched grid round and one lane-loop grid round
   profiled in turns (batched, loop, batched);
   the batched round loop under ``torch.cuda.set_sync_debug_mode("error")``
   (where the round core synchronizes, the first such operation and then
   the count by source line under ``"warn"``; none may lie outside
   ``utils/prng.py``'s host keys and scalars);
   ``async_lane``'s grid (``fedbuff``, CR 0.7) through the batched round,
   cold and warm (exactly 10 B1g and 5 B4g a sweep, some lane parks and
   drains), against its lane loop on the card (240 B1, 120 B4), its most
   parking lane replayed on the CPU, its batched grid round profiled twice,
   and its sync check; ``engine_throughput.py::smoke``'s grid
   at N = 20 (contextual x the six rules x the 8 scenarios, 48 lanes, 1
   round: 2 B1g and 1 B4g) against its lane loop and one lane a rule on the
   CPU, and the same grid without fedbuff (40 lanes: 2 B1g and 1 B3g)
   against its lane loop; ``precision_lane``'s grid (bf16 rows, the batched
   round: 10 B1g and 5 B2g) with one lane replayed on the CPU; then the
   two-tier grids through the batched round, cold and warm:
   ``engine_throughput.py::smoke``'s hierarchical probe (N = 20,
   ``client_block=3``, no warm-up, contextual x the six rules x rush_hour /
   rsu_outage, 12 lanes, 1 round: exactly 2 B1g, 1 B5g and 1 B4g) and a
   streamed grid (N = 100, K = 10 in 3 chunks of 4, ``("fedavg",)`` x the 8
   scenarios, 3 rounds: exactly 6 B1g, 9 B5g and 3 B2g), each against its
   lane loop on the card (24 B1, 12 B5, 12 B4; 48 B1, 72 B5, 24 B2) within
   ``GRID_TOL`` and two lanes on the CPU's plain path; the streamed grid's
   set-up and rounds timed apart, its batched round profiled beside a
   lane-loop round (batched, loop, batched), and its sync check;
4i. CNN datasets: ``FLSimulation`` (ring / contextual, ``fl_sim``'s
   defaults: N=100, K=10, 256 samples, batches of 64, 1 local epoch) at
   fl-cifar10-cnn for 5 rounds and fl-svhn-cnn for 3, full width, exactly 2
   ``rttg_latency`` and 1 ``fedavg_reduce`` launches a round, each first
   round replayed (bitwise on the card, within ``CNN_REPLAY`` on the CPU)
   and a round profiled; at CIFAR's width the full registry at index 0 is
   the ``("fedavg",)`` round and the hierarchical round the flat one, bit
   for bit; the three datasets' final accuracy side by side; the bench's
   24-lane grid (N=20, 5 rounds, eval every 5) at fl-cifar10-cnn through the
   batched round, cold and warm (exactly 10 B1g and 5 B2g a sweep) against
   its lane loop within ``GRID_TOL`` and one lane on the CPU, set-up and
   round loop timed apart, a grid round profiled with and without the eval,
   the sweeps' peak memory; the bf16 lane at CIFAR-10 for 3 rounds beside
   fp32's accuracy; ``fl_sim --dataset cifar10 --rounds 2`` (4 B1, 2 B2);
4j. Dirichlet shards and the last two examples: a 4-lane ``("fedavg",)``
   engine grid at ``dirichlet_alpha`` 0.5 (contextual x seeds 0, 1 x ring /
   rush_hour, N=20, 3 rounds) through the batched round (exactly 6 B1g and 3
   B2g), each lane's labels equal to the CPU's and its records within
   ``GRID_TOL`` of a CPU engine's; ``python -m
   repro_torch.launch.serve_decode`` (the mixtral-8x7b smoke config, one
   ``swa_decode`` an attention layer a decode step), its greedy tokens the
   CPU's; ``python -m repro_torch.launch.fl_cits_benchmark --rounds 3
   --clients 20`` (2 B1 and 1 B2 a round), its records within ``GRID_TOL``
   of the CPU's;
5. times: each kernel (CUDA events, after warm-up) beside its bound, its
   plain version and a one-call PyTorch yardstick (``pairwise_cosine`` at
   (100, 1024), (256, 4096) and (20,000, 1,024)), and for every kernel and
   yardstick whose events read under ~30 us (the host's launch rate, not the
   device) its profiled device time per call (``rsu_reduce``'s with and
   without its carry, beside a copy of its rows; ``ssd_scan``'s beside its
   events, its bound with the products at the TF32 tensor-core rate and
   beside it the fp32-core figure; both also at the ssm and dense families'
   serving shapes and whisper-small's two decode shapes, printed beside the
   kernels line); the round's wall time
   (the fedavg, fedadam, fedbuff and streamed lanes), and profiled rounds (with ``rsu_reduce``'s calls and
   device time per call in the streamed and fleet rounds), a profiled
   decode step and prefill (with ``ssd_scan``'s calls and time per call);
   ``rttg_latency`` at N=100 predicted and realized and at N=100,000
   predicted; ``rttg_latency_grid`` at the bench grid's 24 lanes (N=20,
   predicted) beside the lane loop's 24 ``rttg_latency`` launches, and
   ``fedavg_reduce_grid`` at its (24, 2, 159,010) on fp32 and bf16 rows
   beside the lane loop's 24 ``fedavg_reduce`` launches and ``torch.bmm``,
   each with its device time from CUDA graph replays; B4g at the async
   grid's (24, 2, Kb 8, 159,010) with no lane and every lane draining,
   beside the lane loop's 24 B4 launches, and B3g at the smoke grid's 40
   lanes (K = 2, rules 0-4), each by CUDA graph replay; B5g at the streamed
   grid's chunk (8, 4, R 10, 159,010) with its carry, without one (the first
   chunk) and on bf16 rows and partials, beside its bound, its plain
   version, the lane loop's 8 B5 launches and ``torch.baddbmm`` /
   ``torch.bmm``, by CUDA graph replay;
   B2 at the CNN main paths' (10, P) on fp32 and bf16 rows and B2g at the
   CIFAR-10 and SVHN grids' (24, 2, P), beside ``torch.mv`` / ``torch.bmm``
   and their bounds (``cnn_shapes`` of their rows in the kernels line);
   ``rttg_latency`` and ``fedavg_reduce`` through their
   wrappers as the round calls them: device ops and device time per call; B2-B5 on the
   bf16 lane's rows beside their fp32 rows (the ``bf16_rows`` JSON line),
   and the bf16 main path's round wall and profile;
6. serving the ssm and dense families: the CLI's run at full width and
   depth in bf16 for mamba2-130m (4 x 2048, 32 tokens), qwen1.5-0.5b (4 x
   2048, 32), gemma2-9b (2 x 4160, 16: the local layers' ring wraps),
   mistral-nemo-12b and chatglm3-6b (2 x 512, 8), each with its times, peak
   memory, exact launch counts and one profiled decode step; then the moe
   and vlm families the same way at full width and 16 layers (no more fits
   one card): mixtral-8x7b (2 x 4160, 16: its window ring wraps),
   phi3.5-moe (4 x 2048, 32) and internvl2-76b (2 x (256 image + 512), 16),
   each also with the copies its prefill dropped over capacity; last, the
   encdec family: whisper-small at full width and depth (12 + 12 layers), 4 x
   64 behind 4 x 1,500 frames, 32 tokens, exactly 2 x 12 ``swa_decode``
   launches a decode step.
7. training (after the serving runs): ``python -m repro_torch.launch.train
   --arch ARCH --full --steps 5`` for qwen1.5-0.5b (464,118,784 bf16
   parameters), hymba-1.5b (1,641,790,720; 4 microbatches) and mamba2-130m
   (129,100,224), bf16 but for the SSM's per-head fp32 leaves (4,800 and
   1,728), fp32 AdamW moments, B=8 x 128: finite losses, the step
   times, tokens/s and peak memory, no kernel launched (the ssm / hybrid scan
   is the plain one under grad mode); 5 (qwen1.5-0.5b) and 3 (hymba-1.5b)
   AdamW steps on one repeated batch (the loss must fall); one profiled step
   each;
   qwen1.5-0.5b at full
   width cut to 2 layers, fp32, one step on the card against the CPU
   (loss, the global and each leaf's gradient norm, in each leaf fewer than
   1e-3 of the elements more than lr / 10 apart); every family's smoke
   config, the ssm and hybrid ones too, one step card vs CPU at one
   microbatch and at the config's own count; ``python -m
   repro_torch.launch.federated_llm --rounds 2`` on the card, its cohorts and
   clusters the CPU's, eval losses within rtol 1e-5 and each round's update
   norm within rtol 1e-4.

The last three lines are the kernels' JSON record (their fp32 rows;
``swa_decode``'s launches summed over every serving run; ``rttg_latency``'s,
``fedavg_reduce``'s and ``server_update_buffered``'s with one sweep of each
engine grid of phases 4h, 4i and 4j, the CNN paths of phase 4i and the
example paths of phase 4j, the parts named in their ``launches_by_path``;
``rttg_latency_grid``'s, ``fedavg_reduce_grid``'s, ``server_update_grid``'s,
``server_update_buffered_grid``'s and ``rsu_reduce_grid``'s from one sweep
of each engine grid, the two-tier ones included),
the card's name and power limit, and the device JSON.  Each phase's
heading carries the seconds since the script started.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 non-tensor rate, TF32
# tensor-core rate (dense).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_ULP = 2.0 ** -7  # one unit in the last place of a bf16 in [1, 2)
ROUNDS = 5
# (vehicles, rounds) of the fleet phase: BENCH_engine.json's fleet runs
FLEET = ((20_000, 1), (100_000, 2))
LANES = ("fedavgm", "fedadam", "fedyogi", "stale", "fedbuff")
# the CNN datasets' models (phase 4i): P of fl-cifar10-cnn and fl-svhn-cnn
CNN_P = {"cifar10": 1_070_794, "svhn": 603_034}


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rsu_carry_rows(rid, n_rsu: int, updates, carry) -> int:
    """The carry rows an in-place chunk of ``rsu_reduce`` (``rid`` ``(K,)``)
    or ``rsu_reduce_grid`` (``(G, K)``) must read and write on this data:
    the distinct (lane, id) pairs with the id in ``[0, n_rsu)``.  A row no id
    names comes out as it went in, unless a row holds a non-finite value
    (0 * inf reaches every RSU's partial) or the carry a -0.0 (+0.0 after the
    add); then every row counts.  The kernel reads and writes every row."""
    lanes = rid.numel() // rid.shape[-1]
    if not bool(torch.isfinite(updates).all()) or bool(torch.signbit(carry[carry == 0]).any()):
        return lanes * n_rsu
    hit = rid.long()[..., None] == torch.arange(n_rsu, device=rid.device)
    return int(hit.any(dim=-2).sum())


def rsu_bounds(lanes: int, K: int, R: int, P: int, carry_rows: float) -> dict:
    """Bounds ``(ms, by, bytes)`` of ``lanes`` lanes of ``rsu_reduce`` at K
    rows, R RSUs and P columns, fp32 (``carry``, ``dense``, ``first``) and
    bf16 rows and partials (the same keys + ``16``).  Each input read once
    (rows, weights, ids, and the carry when there is one), each output
    written once (partials, mass); 2 flops per row value (its one RSU's
    multiply-add) plus the carry's add per partial.  ``carry``: in place,
    ``carry_rows`` carry rows read and written (``rsu_carry_rows`` of this
    run's ids); ``dense``: every carry row, the traffic the kernel makes;
    ``first``: no carry, every partial written."""
    out = {}
    for size, sfx in ((4, ""), (2, "16")):
        fixed = lanes * (K * P * size + 2 * K * 4 + R * 4)
        for key, rows in (("carry", carry_rows), ("dense", lanes * R), ("first", None)):
            moved = lanes * R * P * size if rows is None else rows * P * size * 2
            n_bytes = fixed + moved
            flops = lanes * 2 * K * P + (0 if rows is None else rows * P)
            out[key + sfx] = bound(n_bytes, flops) + (n_bytes,)
    return out


START = time.perf_counter()


def phase(name: str) -> None:
    print(f"\n=== {name} [{time.perf_counter() - START:.0f} s]", flush=True)


def rttg_inputs(scenario: str, n: int, seed: int, cr: float, device, **scn_kw):
    from repro_torch.core.scenarios import scenario_config, scenario_params
    from repro_torch.utils import prng

    scn = scenario_params(scenario_config(scenario, num_vehicles=n, **scn_kw), device)
    k = prng.split(prng.key(seed), 4)
    pos = prng.uniform(k[0], (n,), 0.0, scn.ring_length_m, device)
    speed = 14.0 + 4.0 * prng.normal(k[1], (n,), device)
    accel = 0.3 * prng.normal(k[2], (n,), device)
    forced = prng.bernoulli(k[3], cr, (n,), device) if cr < 1.0 else None
    t = torch.tensor(77.5, device=device)
    return scn, pos, speed, accel, t, forced


def wrap_edges(pos, ring):
    """``pos`` with its first entries at the predictor's wrap: 0, just under
    the ring and the ring (the compare-and-subtract path), 2 ring and beyond
    and below 0 (the fmodf path)."""
    edges = torch.stack([0.0 * ring, torch.nextafter(ring, 0.0 * ring), ring, 2.0 * ring,
                         3.5 * ring, -1.0 + 0.0 * ring, -0.5 * ring, -2.5 * ring])
    return torch.cat([edges, pos[len(edges):]])


def check_rttg(scenario, n, predict, cr, want_rid, device, at_wrap=False, **scn_kw) -> float:
    """Two wrapper calls against the plain version: conn and rid exact,
    latency within rtol 1e-5, the second call bit for bit the first."""
    from repro_torch.kernels.rttg_latency import rttg_latency, rttg_latency_plain

    scn, pos, speed, accel, t, forced = rttg_inputs(scenario, n, n + 7, cr, device, **scn_kw)
    if at_wrap:
        pos = wrap_edges(pos, scn.ring_length_m)
    mb = 636_040.0
    got, again = [rttg_latency(pos, speed, accel, t, mb, forced, scn, predict=predict,
                               want_rid=want_rid) for _ in range(2)]
    ref = rttg_latency_plain(pos, speed, accel, t, mb, forced, scn, predict, want_rid)
    torch.cuda.synchronize()
    what = f"{scenario}, N={n}, R={scn.n_rsu}, predict={predict}, at_wrap={at_wrap}"
    if not torch.equal(got[1], ref[1]):
        raise AssertionError(f"rttg_latency conn differs ({what})")
    if want_rid and not torch.equal(got[2], ref[2]):
        raise AssertionError(f"rttg_latency rid differs ({what})")
    if not bool(torch.isfinite(got[0]).all()):
        raise AssertionError(f"rttg_latency produced non-finite latency ({what})")
    # transcendentals (log10f, powf, log2f, sinf) may differ by an ulp or two
    # between the kernel and PyTorch's elementwise kernels: rtol 1e-5
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-7)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"rttg_latency does not repeat bitwise ({what})")
    err = float((got[0] - ref[0]).abs().max())
    print(f"rttg_latency {scenario:10s} N={n:6d} R={scn.n_rsu:5d} "
          f"ring={float(scn.ring_length_m):g} m predict={predict!s:5s} "
          f"CR={cr} rid={want_rid!s:5s}{' at the wrap' if at_wrap else ''} "
          f"max_abs_err={err:.3e} conn/rid exact, repeat bitwise")
    return err


def offset_rows(u, dtype, offset=0):
    """``u`` in ``dtype``, its rows starting ``offset`` elements into their
    storage (offset 1 takes a bf16 row off its 4-byte alignment)."""
    K, P = u.shape
    out = torch.empty((K * P + offset,), dtype=dtype, device=u.device)[offset:].view(K, P)
    return out.copy_(u)


def check_fedavg(K, P, device, rows=torch.float32, offset=0) -> float:
    """Two launches against the plain version (rows in ``rows``)."""
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce, fedavg_reduce_plain
    from repro_torch.utils import prng

    k = prng.split(prng.key(K * 100_003 + P), 2)
    u = 1e-3 * prng.normal(k[0], (K, P), device)
    if rows != torch.float32 or offset:
        u = offset_rows(u, rows, offset)
    w = prng.uniform(k[1], (K,), device=device)
    w = w / w.sum()
    got, again = fedavg_reduce(u, w), fedavg_reduce(u, w)
    ref = fedavg_reduce_plain(u, w)
    torch.cuda.synchronize()
    # the two sum K products in different orders: tolerance scaled by sum |w u|
    scale = float((w.abs() @ u.float().abs()).max())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    if not torch.equal(got, again):
        raise AssertionError(f"fedavg_reduce does not repeat bitwise (K={K}, P={P})")
    err = float((got - ref).abs().max())
    print(f"fedavg_reduce K={K:3d} P={P:7d} {str(rows)[6:]} rows offset={offset} "
          f"max_abs_err={err:.3e} (scale {scale:.3e}), repeat bitwise")
    return err


def grid_lane_inputs(scenarios, n, seed, cr, device):
    """G lanes of ``rttg_inputs``, one a scenario: each lane's own
    ``ScenarioParams`` (B1's), their ``lane_view`` stack (B1g's), ``(G, N)``
    kinematics, ``(G,)`` times (a lane apart by 3.25 s) and ``(G, N)`` forced
    masks (None at CR 1)."""
    from repro_torch.core.scenarios import lane_view, stack_scenarios

    lanes = [rttg_inputs(sc, n, seed + 101 * g, cr, device) for g, sc in enumerate(scenarios)]
    scns = [lane[0] for lane in lanes]
    pos, speed, accel = (torch.stack([lane[i] for lane in lanes]) for i in (1, 2, 3))
    t = torch.stack([lane[4] + 3.25 * g for g, lane in enumerate(lanes)])
    forced = torch.stack([lane[5] for lane in lanes]) if cr < 1.0 else None
    return scns, lane_view(stack_scenarios(scns)), pos, speed, accel, t, forced


def check_rttg_grid(scenarios, n, predict, cr, device, want_rid=False) -> float:
    """B1g on G = len(scenarios) lanes: bit for bit G calls of B1 (one a
    lane, on the lane's own scenario), RSU ids included with ``want_rid``;
    against its plain version conn (and ids) exact, latency within
    ``check_rttg``'s rtol 1e-5; a second call bit for bit the first."""
    from repro_torch.kernels.rttg_latency import (rttg_latency, rttg_latency_grid,
                                                  rttg_latency_grid_plain)

    scns, view, pos, speed, accel, t, forced = grid_lane_inputs(scenarios, n, n + 11, cr,
                                                                device)
    G = len(scenarios)
    mb = torch.tensor(636_040.0, device=device)
    got, again = [rttg_latency_grid(pos, speed, accel, t, mb, forced, view, predict=predict,
                                    want_rid=want_rid) for _ in range(2)]
    lanes = [rttg_latency(pos[g], speed[g], accel[g], t[g], mb,
                          None if forced is None else forced[g], scns[g], predict=predict,
                          want_rid=want_rid)
             for g in range(G)]
    ref = rttg_latency_grid_plain(pos, speed, accel, t, mb, forced, view, predict, want_rid)
    torch.cuda.synchronize()
    what = (f"G={G} ({', '.join(sorted(set(scenarios)))}), N={n}, predict={predict}, "
            f"CR={cr}, want_rid={want_rid}")
    for g in range(G):
        if not all(torch.equal(x[g], y) for x, y in zip(got, lanes[g])):
            raise AssertionError(f"rttg_latency_grid lane {g} is not rttg_latency's ({what})")
    if not all(torch.equal(got[i], ref[i]) for i in range(1, len(got))):
        raise AssertionError(f"rttg_latency_grid conn or ids differ from the plain version "
                             f"({what})")
    if not bool(torch.isfinite(got[0]).all()):
        raise AssertionError(f"rttg_latency_grid produced non-finite latency ({what})")
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-7)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"rttg_latency_grid does not repeat bitwise ({what})")
    err = float((got[0] - ref[0]).abs().max())
    print(f"rttg_latency_grid {what}: every lane bitwise rttg_latency's, conn"
          f"{' and ids' if want_rid else ''} exact, max_abs_err={err:.3e} vs plain, repeat "
          "bitwise")
    return err


def check_fedavg_grid(G, K, P, device, rows=torch.float32, offset=0) -> float:
    """B2g on (G, K, P) rows in ``rows`` (``offset`` elements into their
    storage): bit for bit G calls of B2 (one a lane), against its plain
    version at ``check_fedavg``'s tolerance, a second call bit for bit."""
    from repro_torch.kernels.fedavg_reduce import (fedavg_reduce, fedavg_reduce_grid,
                                                   fedavg_reduce_grid_plain)
    from repro_torch.utils import prng

    k = prng.split(prng.key(G * 1_000_003 + K * 100_003 + P), 2)
    u = 1e-3 * prng.normal(k[0], (G, K, P), device)
    if rows != torch.float32 or offset:
        u = offset_rows(u.view(G * K, P), rows, offset).view(G, K, P)
    w = prng.uniform(k[1], (G, K), device=device)
    w = w / w.sum(dim=-1, keepdim=True)
    got, again = fedavg_reduce_grid(u, w), fedavg_reduce_grid(u, w)
    lanes = torch.stack([fedavg_reduce(u[g], w[g]) for g in range(G)])
    ref = fedavg_reduce_grid_plain(u, w)
    torch.cuda.synchronize()
    what = f"G={G}, K={K}, P={P}, {str(rows)[6:]} rows, offset={offset}"
    if not torch.equal(got, lanes):
        raise AssertionError(f"fedavg_reduce_grid is not fedavg_reduce lane by lane ({what})")
    scale = float((w.abs()[:, None, :] @ u.float().abs()).max())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    if not torch.equal(got, again):
        raise AssertionError(f"fedavg_reduce_grid does not repeat bitwise ({what})")
    err = float((got - ref).abs().max())
    print(f"fedavg_reduce_grid {what}: every lane bitwise fedavg_reduce's, max_abs_err="
          f"{err:.3e} vs plain (scale {scale:.3e}), repeat bitwise")
    return err


def check_fedavg_grid_past_int32(device, G=9, K=256, P=CNN_P["cifar10"]) -> None:
    """B2g on bf16 rows whose element offsets pass 2^31: lane 8's rows start
    at 8 * 256 * 1,070,794 = 2.19e9 (4.9 GB of rows; a greedy grid of K = N
    = 100 at G = 24 passes 2^31 as well).  Every lane bit for bit a B2 call,
    the last lane within ``check_fedavg``'s tolerance of its plain version,
    a second launch bit for bit the first."""
    from repro_torch.kernels.fedavg_reduce import (fedavg_reduce, fedavg_reduce_grid,
                                                   fedavg_reduce_plain)

    gen = torch.Generator(device=device)
    gen.manual_seed(29)
    u = torch.randn((G, K, P), generator=gen, device=device, dtype=torch.bfloat16) * 1e-3
    w = torch.rand((G, K), generator=gen, device=device)
    w = w / w.sum(dim=-1, keepdim=True)
    if (G - 1) * K * P < 2 ** 31:
        raise AssertionError("the last lane's rows do not start past 2^31 elements")
    got, again = fedavg_reduce_grid(u, w), fedavg_reduce_grid(u, w)
    for g in range(G):
        if not torch.equal(got[g], fedavg_reduce(u[g], w[g])):
            raise AssertionError(f"fedavg_reduce_grid past 2^31: lane {g} is not fedavg_reduce's")
    if not torch.equal(got, again):
        raise AssertionError("fedavg_reduce_grid past 2^31 does not repeat bitwise")
    ref = fedavg_reduce_plain(u[-1], w[-1])
    scale = float((w[-1].abs() @ u[-1].float().abs()).max())
    torch.testing.assert_close(got[-1], ref, rtol=1e-5, atol=1e-6 * scale)
    print(f"fedavg_reduce_grid G={G}, K={K}, P={P}, bf16 rows ({G * K * P:,} elements, lane "
          f"{G - 1} from element {(G - 1) * K * P:,}): every lane bitwise fedavg_reduce's, the "
          f"last within tolerance of plain (max_abs_err {float((got[-1] - ref).abs().max()):.3e}),"
          " repeat bitwise")
    del u, got, again, ref
    torch.cuda.empty_cache()


def server_operands(K, P, seed, device, exact=False):
    """(updates, weights, params, m, v) for the server kernels.

    ``exact``: dyadic updates and weights (7 and 3 significant bits) whose
    weighted sums are exact in fp32 in any order, so the kernel's delta and
    the plain version's are the same number, and ``v == delta**2`` ties are
    ties on both sides (Yogi's ``sign(0) == 0``).
    """
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if exact:
        u = torch.randint(-64, 65, (K, P), generator=g, device=device).float() * 2.0 ** -12
        w = torch.randint(1, 9, (K,), generator=g, device=device).float() / 16
    else:
        u = 1e-3 * torch.randn((K, P), generator=g, device=device)
        w = torch.rand((K,), generator=g, device=device)
        w = w / w.sum()
    params = 0.05 * torch.randn((P,), generator=g, device=device)
    m = 1e-4 * torch.randn((P,), generator=g, device=device)
    v = (1e-3 * torch.randn((P,), generator=g, device=device)) ** 2
    return u, w, params, m, v


def assert_server_close(got, ref, scale, what) -> float:
    """The kernel against its plain version: another summation order, rtol
    1e-5 with an atol scaled by sum_k |w_k u_k|; params get 100x that atol,
    the adaptive step m / (sqrt(v) + tau) magnifying the sum's error by up
    to (1 - beta1) / tau = 100; a bf16 params' rtol one bf16 ulp (2^-7: the
    sum's last fp32 bit may round it the other way)."""
    err = 0.0
    for name, a, b, atol in zip(("params", "m", "v"), got, ref,
                                (1e-4 * scale, 1e-6 * scale, 1e-6 * scale)):
        if a.dtype != b.dtype:
            raise AssertionError(f"{what} {name}: dtype {a.dtype}, plain {b.dtype}")
        rtol = BF16_ULP if a.dtype == torch.bfloat16 else 1e-5
        a, b = a.float(), b.float()
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=lambda m: f"{what} {name}: {m}")
        err = max(err, float((a - b).abs().max()))
    return err


def check_server_update(K, P, rule, device, exact=False, rows=torch.float32,
                        master=torch.float32) -> float:
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce_plain
    from repro_torch.kernels.server_update import server_update, server_update_plain

    u, w, params, m, v = server_operands(K, P, K * 7 + P + rule, device, exact)
    u, params = u.to(rows), params.to(master)  # the dyadic rows are exact in bf16
    if exact:  # Yogi's sign ties: v == delta**2 on every 7th column
        d = fedavg_reduce_plain(u, w)
        v[::7] = (d * d)[::7]
    got = server_update(u, w, params, m, v, rule, 3)
    ref = server_update_plain(u, w, params, m, v, rule, 3)
    torch.cuda.synchronize()
    scale = float((w.abs() @ u.float().abs()).max())
    return assert_server_close(got, ref, scale, f"server_update K={K} P={P} rule={rule} "
                                                f"rows {rows} master {master}")


def check_server_buffered(K, Kb, P, rule, drain, device, rows=torch.float32,
                          master=torch.float32) -> float:
    from repro_torch.kernels.server_update import (
        server_update_buffered, server_update_buffered_plain)

    u, w, params, m, v = server_operands(K, P, K * 11 + Kb + P + rule, device)
    ring, bw, *_ = server_operands(Kb, P, Kb * 13 + P + rule, device)
    u, ring, params = u.to(rows), ring.to(rows), params.to(master)
    flag = torch.tensor(drain, device=device)
    got = server_update_buffered(u, w, ring, bw, params, m, v, rule, 3, flag)
    ref = server_update_buffered_plain(u, w, ring, bw, params, m, v, rule, 3, flag)
    torch.cuda.synchronize()
    cat, wts = (torch.cat([u, ring]), torch.cat([w, bw])) if drain else (u, w)
    scale = float((wts.abs() @ cat.float().abs()).max())
    return assert_server_close(got, ref, scale,
                               f"server_update_buffered K={K} Kb={Kb} drain={drain} rule={rule} "
                               f"rows {rows} master {master}")


def check_server_contracts(K, P, device, rows=torch.float32, master=torch.float32) -> None:
    """(a) rule 0 == fedavg_reduce + apply_delta_flat and (b) drain=False ==
    the unbuffered update, every rule: bit for bit, signs of zeros included."""
    from repro_torch.fl.server import apply_delta_flat
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce
    from repro_torch.kernels.server_update import server_update, server_update_buffered

    u, w, params, m, v = server_operands(K, P, 5 * K + P, device)
    u[:, ::5] = 0.0  # columns whose delta is an exact +0.0
    ring, bw, *_ = server_operands(8, P, 3 * P, device)
    u, ring, params = u.to(rows), ring.to(rows), params.to(master)
    off = torch.tensor(False, device=device)
    a = server_update(u, w, params, m, v, 0, 0)
    want = apply_delta_flat(params, fedavg_reduce(u, w))
    if not (torch.equal(a[0], want) and torch.equal(a[1], m) and torch.equal(a[2], v)):
        raise AssertionError(f"contract (a) fails at K={K} P={P}")
    for rule in range(6):
        plain = server_update(u, w, params, m, v, rule, 0)
        buffered = server_update_buffered(u, w, ring, bw, params, m, v, rule, 0, off)
        for x, y in zip(plain, buffered):
            if not (torch.equal(x, y) and torch.equal(torch.signbit(x), torch.signbit(y))):
                raise AssertionError(f"contract (b) fails at K={K} P={P} rule={rule}")
    print(f"server_update contracts (a) and (b) bitwise at K={K} P={P}, rows {rows}, "
          f"master {master}")


# every global AGGREGATOR_ORDER index, and the AXPY rules alone (a registry
# with no moment rule: B3g / B4g then neither read nor write m and v)
ALL_RULES = (0, 1, 2, 3, 4, 5)
AXPY_RULES = (0, 4, 5)


def server_grid_operands(G, K, Kb, P, registry, seed, device, rows=torch.float32,
                         master=torch.float32, offset=0):
    """G lanes of ``server_operands`` with a (G, Kb, P) ring, each lane's
    rule from ``registry`` (every rule of it on the first lanes, then
    drawn) and a drain flag (the first two lanes draining and not, then
    drawn); the rows and ring in ``rows`` (``offset`` elements into their
    storage), params in ``master``."""
    lanes = [server_operands(K, P, seed + g, device) for g in range(G)]
    u, w, params, m, v = (torch.stack(xs) for xs in zip(*lanes))
    ring = torch.stack([server_operands(Kb, P, seed + 7 * G + g, device)[0] for g in range(G)])
    gen_dev = torch.Generator(device=device)
    gen_dev.manual_seed(seed)
    bw = torch.rand((G, Kb), generator=gen_dev, device=device)
    if rows != torch.float32 or offset:
        u = offset_rows(u.view(G * K, P), rows, offset).view(G, K, P)
        ring = offset_rows(ring.view(G * Kb, P), rows, offset).view(G, Kb, P)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    pick = torch.randint(0, len(registry), (G,), generator=gen)
    pick[:min(G, len(registry))] = torch.arange(min(G, len(registry)))
    rules = torch.tensor(registry, dtype=torch.int32)[pick].to(device)
    drain = torch.rand((G,), generator=gen) < 0.5
    drain[:2] = torch.tensor([True, False])[:G]
    return u, w, params.to(master), m, v, ring, bw, rules, drain.to(device)


def check_server_grid(G, K, Kb, P, registry, buffered, device, rows=torch.float32,
                      master=torch.float32, offset=0) -> float:
    """B3g (or, ``buffered``, B4g) on G lanes whose rules (and drain flags)
    differ: every lane bit for bit a B3 (B4) call on that lane (an AXPY
    lane's m' and v' its m and v; the caller's own m and v when the
    registry holds no moment rule), against its plain version within
    ``assert_server_close``'s tolerance, a second launch bit for bit."""
    from repro_torch.kernels.server_update import (
        server_update, server_update_buffered, server_update_buffered_grid,
        server_update_buffered_grid_plain, server_update_grid, server_update_grid_plain)

    u, w, params, m, v, ring, bw, rules, drain = server_grid_operands(
        G, K, Kb, P, registry, G * 7 + K * 5 + Kb + P, device, rows, master, offset)
    if buffered:
        def call():
            return server_update_buffered_grid(u, w, ring, bw, params, m, v, rules, 3, drain,
                                               registry=registry)
        ref = server_update_buffered_grid_plain(u, w, ring, bw, params, m, v, rules, 3, drain,
                                                registry=registry)
    else:
        def call():
            return server_update_grid(u, w, params, m, v, rules, 3, registry=registry)
        ref = server_update_grid_plain(u, w, params, m, v, rules, 3, registry=registry)
    got, again = call(), call()
    what = (f"{'server_update_buffered_grid' if buffered else 'server_update_grid'} G={G} K={K}"
            f"{f' Kb={Kb}' if buffered else ''} P={P} rules {registry} rows "
            f"{str(rows)[6:]} master {str(master)[6:]} offset={offset}")
    for g, rule in enumerate(rules.tolist()):
        one = (server_update_buffered(u[g], w[g], ring[g], bw[g], params[g], m[g], v[g], rule, 3,
                                      drain[g]) if buffered
               else server_update(u[g], w[g], params[g], m[g], v[g], rule, 3))
        if not all(torch.equal(a[g], b) for a, b in zip(got, one)):
            raise AssertionError(f"{what}: lane {g} (rule {rule}) is not the one-lane kernel's")
    if registry == AXPY_RULES and not (got[1] is m and got[2] is v):
        raise AssertionError(f"{what}: the moments were not handed back untouched")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: does not repeat bitwise")
    wts = torch.cat([w, torch.where(drain[:, None], bw, 0.0)], 1) if buffered else w
    cat = torch.cat([u, ring], 1) if buffered else u
    scale = float((wts.abs()[:, None, :] @ cat.float().abs()).max())
    err = assert_server_close(got, ref, scale, what)
    print(f"{what}: every lane bitwise the one-lane kernel's, max_abs_err={err:.3e} vs plain, "
          f"repeat bitwise")
    return err


def rsu_operands(K, P, R, mode, device, offset=0):
    """(updates, weights, rid, carry) for ``rsu_reduce``.  ``rand``: normal
    rows, uniform weights; every other mode: dyadic rows and carry (7
    significant bits) and integer weights, whose sums are exact in any
    order, then ``one_rsu`` (all on one RSU), ``hole`` (an RSU never
    attached), ``masked`` (an RSU whose clients all weigh 0) or
    ``out_of_range`` (ids -1 and R + 3, which contribute nothing).  The
    updates start ``offset`` floats into their storage (``offset = P``: a
    row slice ``u[1:]``)."""
    g = torch.Generator(device=device)
    g.manual_seed(K * 7919 + P * 31 + R)
    if mode == "rand":
        u = 1e-3 * torch.randn((K * P + offset,), generator=g, device=device)
        w = torch.rand((K,), generator=g, device=device)
        carry = 1e-3 * torch.randn((R, P), generator=g, device=device)
    else:
        u = torch.randint(-64, 65, (K * P + offset,), generator=g,
                          device=device).float() * 2.0 ** -12
        w = torch.randint(0, 5, (K,), generator=g, device=device).float()
        carry = torch.randint(-64, 65, (R, P), generator=g, device=device).float() * 2.0 ** -10
    u = u[offset:].view(K, P)
    rid = torch.randint(0, R, (K,), generator=g, device=device).to(torch.int32)
    if mode == "one_rsu":
        rid[:] = R - 1
    elif mode == "hole":
        rid[rid == R // 2] = (R // 2 + 1) % R
    elif mode == "masked":
        w[rid == R // 2] = 0.0
    elif mode == "out_of_range":
        rid[::2] = R + 3
        rid[1::3] = -1
    return u, w, rid, carry


def check_rsu(K, P, R, mode, with_carry, device, offset=0, pad=0, rows=torch.float32,
              out=torch.float32) -> float:
    """The kernel against ``rsu_reduce_plain``: random operands within rtol
    1e-5 (one bf16 ulp, 2^-7, for bf16 partials) and 1e-6 of sum_k |m_kr
    u_k| (another summation order), the other modes bit for bit; a
    never-attached or all-zero-weight RSU's row is its carry (or exactly 0)
    and its mass exactly 0; a second launch repeats the first bit for bit.
    ``offset``: the updates start that many elements into their storage;
    ``pad``: the last ``pad`` rows are the round's padding slots (weight 0,
    id 0); ``rows`` / ``out``: the rows' and the partials' (and carry's)
    dtypes (the dyadic operands are exact in bf16)."""
    from repro_torch.kernels.rsu_reduce import rsu_reduce, rsu_reduce_plain

    u, w, rid, carry = rsu_operands(K, P, R, mode, device, 0 if rows != torch.float32
                                    else offset)
    if rows != torch.float32:
        u = offset_rows(u, rows, offset)
    carry = carry.to(out)
    if pad:
        w[K - pad:], rid[K - pad:] = 0.0, 0
    got, mass = rsu_reduce(u, w, rid, R, carry=carry.clone() if with_carry else None,
                           out_dtype=out)
    ref, ref_mass = rsu_reduce_plain(u, w, rid, R, carry.clone() if with_carry else None,
                                     out_dtype=out)
    again, again_mass = rsu_reduce(u, w, rid, R, carry=carry.clone() if with_carry else None,
                                   out_dtype=out)
    torch.cuda.synchronize()
    what = (f"rsu_reduce K={K} P={P} R={R} {mode} carry={with_carry} offset={offset} pad={pad} "
            f"rows {rows} out {out}")
    if got.dtype != out:
        raise AssertionError(f"{what}: partials in {got.dtype}")
    if not (torch.equal(got, again) and torch.equal(mass, again_mass)):
        raise AssertionError(f"{what}: a second launch differs from the first")
    if mode == "rand":
        scale = float(rsu_reduce_plain(u.float().abs(), w, rid, R)[0].max())
        rtol = BF16_ULP if out == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-6 * scale,
                                   msg=lambda m: f"{what}: {m}")
        torch.testing.assert_close(mass, ref_mass, rtol=1e-6, atol=0.0)
    elif not (torch.equal(got, ref) and torch.equal(mass, ref_mass)):
        raise AssertionError(f"{what}: not bitwise")
    if mode in ("hole", "masked") and R > 1:
        base = carry[R // 2] if with_carry else torch.zeros_like(got[0])
        if not (torch.equal(got[R // 2], base) and float(mass[R // 2]) == 0.0):
            raise AssertionError(f"{what}: the idle RSU's row or mass moved")
    return float((got.float() - ref.float()).abs().max())


def check_rsu_two_roundings(device) -> None:
    """Chunk sums 2^-8 + 2^-20 on a bf16 carry of 1, at the streamed lane's
    chunk (K=4, P=159,010, R=10): the JAX round rounds the sum to bf16 first
    (2^-8), then the carry add (1 + 2^-8, a tie to even: 1.0); one rounding
    would give 1 + 2^-7.  The kernel must give the plain version's 1.0."""
    from repro_torch.kernels.rsu_reduce import rsu_reduce, rsu_reduce_plain

    K, P, R = 4, 159_010, 10
    u = torch.zeros((K, P), dtype=torch.bfloat16, device=device)
    u[0], u[1], u[2] = 2.0 ** -8, 2.0 ** -20, 2.0 ** -9
    w = torch.ones(K, device=device)
    rid = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=device)
    carry = torch.ones((R, P), dtype=torch.bfloat16, device=device)
    got, _ = rsu_reduce(u, w, rid, R, carry=carry.clone(), out_dtype=torch.bfloat16)
    ref, _ = rsu_reduce_plain(u, w, rid, R, carry.clone(), out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    one = float(torch.tensor(1.0 + 2.0 ** -8 + 2.0 ** -20).to(torch.bfloat16))
    if not (torch.equal(got, ref) and bool((got[0] == 1.0).all()) and one == 1.0 + 2.0 ** -7):
        raise AssertionError(f"rsu_reduce bf16 carry: {got[0, :4].tolist()}, plain "
                             f"{ref[0, :4].tolist()}, want 1.0 (two roundings), not {one}")
    print("rsu_reduce bf16 carry rounds twice as the JAX round: 1 + bf16(2^-8 + 2^-20) -> 1.0 "
          f"(one rounding would give {one}), bitwise the plain version")


def check_rsu_walk(K, B, device, R=10, rows=torch.float32, out=torch.float32) -> None:
    """The streamed lane's chunk walk (the first chunk without a carry, the
    rest in place) against the per-chunk plain sums (fp32: zeros plus each
    chunk's sum; bf16: the plain walk with its carry), bit for bit."""
    from repro_torch.kernels.rsu_reduce import rsu_reduce, rsu_reduce_plain

    P = 159_010
    u, w, rid, _ = rsu_operands(K, P, R, "exact", device)
    u = u.to(rows)
    carry, acc = None, torch.zeros((R, P), dtype=out, device=device)
    for i in range(0, K, B):
        cs = slice(i, i + B)
        carry, _ = rsu_reduce(u[cs], w[cs], rid[cs], R, carry=carry, out_dtype=out)
        acc = rsu_reduce_plain(u[cs], w[cs], rid[cs], R, acc, out_dtype=out)[0]
    if not torch.equal(carry, acc):
        raise AssertionError(f"rsu_reduce chunk walk K={K} B={B} R={R} rows {rows} out {out} "
                             "is not the chunk composition")
    print(f"rsu_reduce chunk walk K={K} in chunks of {B}, R={R}, rows {rows}, out {out}: "
          "bitwise the per-chunk plain sums")


def check_rsu_grid(G, K, P, R, with_carry, device, rows=torch.float32, out=torch.float32,
                   offset=0) -> float:
    """B5g on G lanes of random chunks (each lane its own rows, weights and
    ids; ids -1 and R + 3 among them; the last slot a padding slot, weight 0
    and id 0), the rows ``offset`` elements into their storage: bit for bit
    G calls of B5 (one a lane, the carry in place in both), against its
    plain version at ``check_rsu``'s tolerance, a second launch bit for bit
    the first."""
    from repro_torch.kernels.rsu_reduce import rsu_reduce, rsu_reduce_grid, rsu_reduce_grid_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(G * 1_000_003 + K * 7919 + P * 31 + R)
    u = 1e-3 * torch.randn((G * K, P), generator=gen, device=device)
    u = offset_rows(u, rows, offset).view(G, K, P)
    w = torch.rand((G, K), generator=gen, device=device)
    rid = torch.randint(0, R, (G, K), generator=gen, device=device).to(torch.int32)
    rid.view(-1)[1::5], rid.view(-1)[3::7] = -1, R + 3
    w[:, K - 1], rid[:, K - 1] = 0.0, 0
    carry = (1e-3 * torch.randn((G, R, P), generator=gen, device=device)).to(out) \
        if with_carry else None

    def call():
        return rsu_reduce_grid(u, w, rid, R, carry=None if carry is None else carry.clone(),
                               out_dtype=out)

    (got, mass), (again, again_mass) = call(), call()
    one = [rsu_reduce(u[g], w[g], rid[g], R, carry=None if carry is None else carry[g].clone(),
                      out_dtype=out) for g in range(G)]
    ref, ref_mass = rsu_reduce_grid_plain(u, w, rid, R,
                                          None if carry is None else carry.clone(), out)
    torch.cuda.synchronize()
    what = (f"rsu_reduce_grid G={G} K={K} P={P} R={R} carry={with_carry} rows {str(rows)[6:]} "
            f"out {str(out)[6:]} offset={offset}")
    for g in range(G):
        if not (torch.equal(got[g], one[g][0]) and torch.equal(mass[g], one[g][1])):
            raise AssertionError(f"{what}: lane {g} is not rsu_reduce's")
    if not (torch.equal(got, again) and torch.equal(mass, again_mass)):
        raise AssertionError(f"{what}: a second launch differs from the first")
    scale = float(rsu_reduce_grid_plain(u.float().abs(), w, rid, R)[0].max())
    rtol = BF16_ULP if out == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-6 * scale,
                               msg=lambda m: f"{what}: {m}")
    torch.testing.assert_close(mass, ref_mass, rtol=1e-6, atol=0.0)
    err = float((got.float() - ref.float()).abs().max())
    print(f"{what}: every lane bitwise rsu_reduce's, max_abs_err={err:.3e} vs plain (scale "
          f"{scale:.3e}), repeat bitwise")
    return err


def swa_operands(B, C, hkv, G, D, dtype, fills, device, seed=0):
    """q, k, v drawn from ``seed``; row b's ring holds a context of ``fills[b]``
    tokens (slot p % C keeps the latest p) and its query sits at fills[b] - 1."""
    from repro_torch.models.layers import ring_positions

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.randn((B, hkv, G, D), generator=g, device=device).to(dtype)
    k = torch.randn((B, C, hkv, D), generator=g, device=device).to(dtype)
    v = torch.randn((B, C, hkv, D), generator=g, device=device).to(dtype)
    kv_pos = torch.stack([ring_positions(f, C, device) for f in fills])
    pos = torch.tensor([f - 1 for f in fills], dtype=torch.int32, device=device)
    return q, k, v, kv_pos, pos


def check_swa(B, C, hkv, G, D, window, softcap, fills, dtype, device, blind=()) -> float:
    """``swa_decode`` against its plain version within 2e-5 (rtol and atol, on
    outputs of size ~1: the online softmax and ``fmaf`` dots sum in another
    order than the plain two-pass softmax); rows in ``blind`` see no slot and
    must come out exactly 0 (``ref.swa_decode``'s answer)."""
    from repro_torch.kernels.swa_decode import swa_decode, swa_decode_plain

    q, k, v, kv_pos, pos = swa_operands(B, C, hkv, G, D, dtype, fills, device)
    for r in blind:
        kv_pos[r] = -1
    from repro_torch.kernels import swa_decode as swa

    before = swa.launches
    got = swa_decode(q, k, v, kv_pos, pos, window=window, softcap=softcap)
    ref = swa_decode_plain(q, k, v, kv_pos, pos, window, softcap)
    torch.cuda.synchronize()
    what = (f"swa_decode B={B} C={C} Hkv={hkv} G={G} D={D} window={window} "
            f"softcap={softcap} fills={fills} {str(dtype)[6:]}")
    if swa.launches != before + 1:
        raise AssertionError(f"{what}: the wrapper did not launch the kernel once")
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5, msg=lambda m: f"{what}: {m}")
    if not torch.equal(got, swa_decode(q, k, v, kv_pos, pos, window=window, softcap=softcap)):
        raise AssertionError(f"{what}: a second launch differs from the first")
    for r in blind:
        if not torch.equal(got[r], torch.zeros_like(got[r])):
            raise AssertionError(f"{what}: row {r} sees no slot but is not 0")
    err = float((got - ref).abs().max())
    print(f"{what}{' blind rows ' + str(list(blind)) if blind else ''}: "
          f"max_abs_err={err:.3e} (tol 2e-5), repeats bitwise")
    return err


def ssd_operands(B, S, nh, hp, ds, dtype, device, with_h0=False, seed=0):
    """x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1)); A = -exp(0.3 N(0, 1))."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn((B, S, nh, hp), generator=g, device=device).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, S, nh), generator=g, device=device))
    A = -torch.exp(0.3 * torch.randn((nh,), generator=g, device=device))
    Bs = torch.randn((B, S, ds), generator=g, device=device).to(dtype)
    Cs = torch.randn((B, S, ds), generator=g, device=device).to(dtype)
    h0 = torch.randn((B, nh, hp, ds), generator=g, device=device) if with_h0 else None
    return x, dt, A, Bs, Cs, h0


def check_ssd(B, S, nh, hp, ds, chunk, with_h0, dtype, device) -> float:
    """``ssd_scan`` against its plain version: y and h within 1e-4 of their
    max |value| (the two cumsums of dt * A round differently, and
    exp(cs_q - cs_k) carries cs's absolute rounding, an ulp of |cs| <= ~100
    being ~1e-5, as a relative error)."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    x, dt, A, Bs, Cs, h0 = ssd_operands(B, S, nh, hp, ds, dtype, device, with_h0)
    got = ssd_scan(x, dt, A, Bs, Cs, chunk, h0)
    ref = ssd_scan_plain(x, dt, A, Bs, Cs, chunk, h0)
    torch.cuda.synchronize()
    what = (f"ssd_scan B={B} S={S} nh={nh} hp={hp} ds={ds} Q={min(chunk, S)} "
            f"h0={with_h0} {str(dtype)[6:]}")
    errs = []
    for name, a, b in zip(("y", "h"), got, ref):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale,
                                   msg=lambda m: f"{what} {name}: {m}")
        errs.append(float((a - b).abs().max()) / scale)
    again = ssd_scan(x, dt, A, Bs, Cs, chunk, h0)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: a second launch differs from the first")
    print(f"{what}: max_abs_err / max|value| y {errs[0]:.3e}, h {errs[1]:.3e} (tol 1e-4), "
          f"repeats bitwise")
    return max(float((a - b).abs().max()) for a, b in zip(got, ref))


def gram_rows(n, d, dtype, device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn((n, d), generator=g, device=device).to(dtype)


def check_gram(n, d, dtype, device, zero_row=None) -> float:
    """``pairwise_cosine`` against its plain version within atol 1e-5 (the
    reference's fp32 test bound: cosines of size 1 summed in another order);
    the Gram bitwise symmetric, its diagonal within 1e-5 of 1 for nonzero
    rows, and a zero row exactly zero in its row and column."""
    from repro_torch.kernels import pairwise_cosine as pc

    x = gram_rows(n, d, dtype, device, n * 10_007 + d)
    if zero_row is not None:
        x[zero_row] = 0
    before = pc.launches
    got = pc.pairwise_cosine(x)
    ref = pc.pairwise_cosine_plain(x)
    torch.cuda.synchronize()
    what = (f"pairwise_cosine N={n} D={d} {str(dtype)[6:]}"
            f"{f' zero row {zero_row}' if zero_row is not None else ''}")
    if pc.launches != before + 1:
        raise AssertionError(f"{what}: the wrapper did not launch the kernel once")
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5, msg=lambda m: f"{what}: {m}")
    if not torch.equal(got, got.T):
        raise AssertionError(f"{what}: the Gram is not bitwise symmetric")
    if not torch.equal(got, pc.pairwise_cosine(x)):
        raise AssertionError(f"{what}: a second launch differs from the first")
    keep = torch.ones((n,), dtype=torch.bool, device=device)
    if zero_row is not None:
        keep[zero_row] = False
        if got[zero_row].any() or got[:, zero_row].any():
            raise AssertionError(f"{what}: the zero row's row / column is not exactly 0")
    if not bool(((got.diagonal()[keep] - 1.0).abs() <= 1e-5).all()):
        raise AssertionError(f"{what}: a diagonal entry is more than 1e-5 from 1")
    err = float((got - ref).abs().max())
    tm, splits, _ = pc.plan(n, n, d, True)
    print(f"{what} ({16 * tm}x{16 * tm} tiles, D in {splits}): max_abs_err={err:.3e} "
          f"(tol 1e-5), bitwise symmetric, repeats bitwise, diagonal within 1e-5 of 1")
    return err


def check_gram_nt(n, m, d, device) -> float:
    """``gram_nt`` with x != y and N != M on unnormalized rows: within 1e-6
    of ``max |x| |y|^T`` (another summation order)."""
    from repro_torch.kernels.pairwise_cosine import gram_nt, gram_nt_plain

    x = gram_rows(n, d, torch.float32, device, 1 + n)
    y = gram_rows(m, d, torch.float32, device, 2 + m)
    got, ref = gram_nt(x, y), gram_nt_plain(x, y)
    torch.cuda.synchronize()
    scale = float((x.abs() @ y.abs().T).max())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    if not torch.equal(got, gram_nt(x, y)):
        raise AssertionError("gram_nt: a second launch differs from the first")
    err = float((got - ref).abs().max())
    print(f"gram_nt N={n} M={m} D={d}: max_abs_err={err:.3e} (scale {scale:.3e}), repeats "
          f"bitwise")
    return err


def kernel_modules():
    from repro_torch.kernels import (fedavg_reduce, pairwise_cosine, rsu_reduce, rttg_latency,
                                     server_update, ssd_scan, swa_decode)

    return (rttg_latency, fedavg_reduce, server_update, rsu_reduce, swa_decode, ssd_scan,
            pairwise_cosine)


def read_launches() -> dict:
    rttg, fedavg, su, rsu, swa, ssd, gram = kernel_modules()
    return {"rttg_latency": rttg.launches, "fedavg_reduce": fedavg.launches,
            "rttg_latency_grid": rttg.grid_launches, "fedavg_reduce_grid": fedavg.grid_launches,
            "server_update": su.launches, "server_update_buffered": su.buffered_launches,
            "server_update_grid": su.grid_launches,
            "server_update_buffered_grid": su.buffered_grid_launches,
            "rsu_reduce": rsu.launches, "rsu_reduce_grid": rsu.grid_launches,
            "swa_decode": swa.launches, "ssd_scan": ssd.launches,
            "pairwise_cosine": gram.launches}


def reset_launches() -> None:
    rttg, fedavg, su, rsu, swa, ssd, gram = kernel_modules()
    rttg.launches = fedavg.launches = su.launches = su.buffered_launches = rsu.launches = 0
    rttg.grid_launches = fedavg.grid_launches = su.grid_launches = rsu.grid_launches = 0
    su.buffered_grid_launches = 0
    swa.launches = ssd.launches = gram.launches = 0


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


# The ssm and dense families' serving runs: (arch, batch, prompt, gen).  gemma2-9b's
# 4,160-token prompt wraps its local layers' 4,096-slot ring; its global layers keep
# every position.
FAMILY_RUNS = (("mamba2-130m", 4, 2048, 32), ("qwen1.5-0.5b", 4, 2048, 32),
               ("gemma2-9b", 2, 4160, 16), ("mistral-nemo-12b", 2, 512, 8),
               ("chatglm3-6b", 2, 512, 8))
# The moe and vlm families' runs: (arch, batch, prompt, gen, layers).  At full depth
# none fits one card (bf16 weights: mixtral-8x7b 87.0 GiB, phi3.5-moe 78.0,
# internvl2-76b 131), so each runs at full width and 16 layers: 43.7, 39.2 and 29.4
# GiB beside what the script holds.  mixtral's 4,160-token prompt wraps its 4,096-slot
# window ring; internvl2's 512 tokens follow its 256 image tokens.
MOE_VLM_RUNS = (("mixtral-8x7b", 2, 4160, 16, 16), ("phi3.5-moe-42b-a6.6b", 4, 2048, 32, 16),
                ("internvl2-76b", 2, 512, 16, 16))
# The encdec family's run: ``--arch whisper-small --full`` at the CLI's defaults, 12 +
# 12 layers.  The prefill (no max_seq, as the CLI's) leaves a 64-slot self ring that
# wraps on the first decode step; the cross-attention reads 1,500 cached frames.
ENCDEC_RUNS = (("whisper-small", 4, 64, 32),)


def expected_serving_launches(cfg, steps: int) -> dict:
    """A prefill and ``steps`` decode steps: ``ssd_scan`` once per SSM layer (the
    prefill), ``swa_decode`` once per attention layer and step (twice per
    decoder layer and step in an ``encdec`` model: self and cross); no other
    kernel."""
    from repro_torch.models.transformer import _has_attn, _has_ssm

    want = dict.fromkeys(read_launches(), 0)
    if cfg.family == "encdec":
        want.update(swa_decode=2 * cfg.num_layers * steps)
        return want
    want.update(ssd_scan=cfg.num_layers if _has_ssm(cfg) else 0,
                swa_decode=cfg.num_layers * steps if _has_attn(cfg) else 0)
    return want


class count_drops:
    """Within the block, the (token, k) copies ``moe.route`` leaves over capacity,
    summed on the card over every MoE layer and call (no sync until read)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.route, self.total = moe, moe.route, []

        def route(*a, **kw):
            r = self.route(*a, **kw)
            self.total.append((~r.keep).sum())
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def read(self) -> int:
        return int(sum(self.total)) if self.total else 0


def cut_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers; an encoder-decoder's encoder too."""
    return cfg.replace(num_layers=layers, encoder_layers=min(cfg.encoder_layers, layers))


def serve_full(device, card, arch="hymba-1.5b", batch=4, prompt=2048, gen=32, layers=None):
    """The serving CLI's run at full width (``--arch arch --full``), at full depth
    or cut to ``layers``; launch counts zeroed just before and read just after,
    held exactly to ``expected_serving_launches``; an MoE model's dropped copies
    counted."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod

    cfg = get_config(arch)
    depth = f"{cfg.num_layers} layers"
    if layers:
        depth = f"{layers} of {cfg.num_layers} layers"
        cfg = cut_depth(cfg, layers)
    elif cfg.encoder_layers:
        depth = f"{cfg.encoder_layers} + {cfg.num_layers} layers"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    with count_drops() as drops:
        res = serve_mod.serve(arch, batch, prompt, gen, device=device, cfg=cfg)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - held
    n_params = sum(x.numel() for x in _leaves(res.params))
    img = f" + {cfg.num_image_tokens} image tokens" if cfg.num_image_tokens else ""
    if cfg.encoder_seq:
        img = f" behind {batch}x{cfg.encoder_seq} encoder frames"
    print(f"{arch} {cfg.dtype}, {depth}, {n_params:,} parameters: set-up (init on the card "
          f"through the port's threefry, prompts) {res.setup_s:.2f} s; prefill "
          f"{batch}x{prompt}{img} {res.prefill_s * 1e3:.1f} ms; {gen - 1} decode steps "
          f"{res.decode_s * 1e3:.1f} ms ({res.decode_s / (gen - 1) * 1e3:.2f} ms a step, "
          f"{batch * gen / res.decode_s:.1f} tok/s as the CLI counts); peak memory "
          f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held [{card}]")
    if cfg.family == "moe":
        print(f"{arch}: {drops.read():,} (token, k) copies dropped over capacity in the "
              f"prefill's {cfg.num_layers} MoE layers ({batch * prompt * cfg.experts_per_token:,} "
              f"copies a layer)")
    print(f"sample row: {res.tokens[0][:16].tolist()}")
    print(f"launches: {launches}")
    want = expected_serving_launches(cfg, gen - 1)  # the first token comes from the prefill
    if launches != want:
        raise AssertionError(f"{arch} serving launches: expected {want}, got {launches}")
    if tuple(res.tokens.shape) != (batch, gen) or not (
            0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.padded_vocab):
        raise AssertionError(f"{arch} serving tokens: shape {tuple(res.tokens.shape)}, range "
                             f"[{int(res.tokens.min())}, {int(res.tokens.max())}]")
    if not bool(torch.isfinite(res.logits).all()):
        raise AssertionError(f"{arch} serving: non-finite logits")
    return res, launches


def serve_families(device, card, runs) -> dict:
    """Each run (arch, batch, prompt, gen[, layers]) through ``serve_full``, then
    one more decode step under the profiler (device ops, busy time and idle
    share); each run's weights and cache are freed before the next.  -> each
    run's launch counts."""
    from repro_torch.models import build_model

    counts = {}
    for arch, batch, prompt, gen, *layers in runs:
        res, counts[arch] = serve_full(device, card, arch, batch, prompt, gen, *layers)
        cfg = res.cfg
        api = build_model(cfg)
        tok = res.tokens[:, -1]
        last = prompt + cfg.num_image_tokens + gen - 1
        with torch.no_grad():
            profile_round(f"decode step, {arch} {cfg.num_layers} layers B={batch} "
                          f"(position {last})",
                          lambda: api.decode_step(res.params, res.cache, tok), card)
        del res, api, tok
        torch.cuda.empty_cache()
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# the serving path on the card against the CPU's plain path: 2 layers at full
# width.  fp32: both sides compute in fp32 and differ only in summation order
# (cuBLAS vs the CPU's GEMMs, the kernels' online softmax and step-ordered
# cumsum), ~1e-5 relative through 2 layers: 5e-4 leaves 10x room on logits of
# size ~4.  bf16: every activation rounds to 8 significant bits and a GEMM summed
# in another order flips roundings (one step is 2^-6 at |logits| in [2, 4)):
# 0.125, eight such steps.
PATH_TOL = {"float32": 5e-4, "bfloat16": 0.125}


# A routing flip: the card and the CPU rank two experts of a token the other way
# round.  Their layer inputs differ by rounding (bf16: ulps of 2^-8 relative in
# the residual stream), so a token whose router probabilities lie closer than
# that can route to another expert on each; then the two paths compute different
# functions.  ``pin_routes`` lets the CPU take the card's choice there and
# reports the flip; a flip is allowed only within these margins (router
# probability units) of a tie.  bf16: 49 flips in the two MoE configs' 2-layer
# prefills of 1,200 tokens, the widest 2.8e-3 apart (NVIDIA H100 80GB HBM3, 700 W):
# 1e-2 leaves 3.5x.  fp32 rounds 2^16 times finer and flipped nowhere there.
FLIP_MARGIN = {"float32": 1e-5, "bfloat16": 1e-2}


class pin_routes:
    """Within the block, ``moe.route`` records each call's experts on the card;
    the CPU's calls, made in the same order, take the card's experts where the
    two differ, with gates and slots recomputed from the CPU's own router
    probabilities.  ``flips``: (call, token, card experts, CPU experts, the CPU's
    probability gap between them)."""

    def __init__(self):
        self.card, self.flips, self.calls = [], [], 0

    @staticmethod
    def on_card(xt) -> bool:
        return xt.is_cuda

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.route = moe, moe.route

        def route(router, xt, K, capacity_factor=1.25):
            r = self.route(router, xt, K, capacity_factor)
            if self.on_card(xt):
                self.card.append(r.expert)
                return r
            call, self.calls = self.calls, self.calls + 1
            e = self.card.pop(0).cpu()
            if torch.equal(e, r.expert):
                return r
            N = xt.shape[0]
            probs = torch.softmax(xt.float() @ router.float(), dim=-1)
            mine, theirs = r.expert.view(N, K), e.view(N, K)
            for n in (mine != theirs).any(dim=1).nonzero()[:, 0].tolist():
                gap = float((probs[n, mine[n]] - probs[n, theirs[n]]).abs().max())
                self.flips.append((call, n, theirs[n].tolist(), mine[n].tolist(), gap))
            return moe.assign(probs, theirs, capacity_factor)

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def path_vs_plain(dtype: str, device, arch="hymba-1.5b", S=1100, batch=2) -> float:
    """``arch`` cut to 2 layers at full width: a prefill of ``S`` tokens and 4
    decode steps on the card and on the CPU from the same weights, logits
    within ``PATH_TOL``; the card's run launches its kernels as many times as
    ``expected_serving_launches`` says.  hymba-1.5b's S = 1100 passes its
    1024 window (the ring wraps) and spans 9 SSD chunks.  A ``vlm``'s image
    embeddings, drawn as the serve CLI draws them, go in front of the S tokens.
    In an MoE model a routing flip (``pin_routes``) is printed with its token,
    layer and margin, must lie within ``FLIP_MARGIN`` of a tie, and the CPU
    follows the card's choice there."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.utils import prng

    cfg = cut_depth(get_config(arch), 2).replace(dtype=dtype)
    api = build_model(cfg)
    key = prng.key(0, device)
    params = api.init(prng.fold_in_str(key, "init"), device)
    cpu_params = tree_to(params, "cpu")
    steps = 4
    toks = make_lm_batch(prng.fold_in_str(key, "prompts"), batch, S + steps + 1,
                         cfg.vocab_size, device)["tokens"]
    prompt = {"tokens": toks[:, :S]}
    if cfg.family == "vlm":
        prompt["image_embeds"] = 0.02 * prng.normal(
            prng.fold_in_str(key, "img"), (batch, cfg.num_image_tokens, cfg.d_model))
    budget = S + cfg.num_image_tokens + steps
    if cfg.family == "encdec":
        prompt["frames"] = 0.02 * prng.normal(
            prng.fold_in_str(key, "frames"), (batch, cfg.encoder_seq, cfg.d_model))
        budget = None  # as the CLI prefills it: an S-slot ring, wrapping from step 0
    before = read_launches()
    with torch.no_grad(), pin_routes() as pins:
        lg, cg = api.prefill(params, prompt, budget)
        t0 = time.perf_counter()
        lc, cc = api.prefill(cpu_params, tree_to(prompt, "cpu"), budget)
        cpu_s = time.perf_counter() - t0
        pairs = [(lg, lc)]
        for i in range(steps):
            lg, cg = api.decode_step(params, cg, toks[:, S + i])
            lc, cc = api.decode_step(cpu_params, cc, toks[:, S + i].cpu())
            pairs.append((lg, lc))
    after = read_launches()
    for call, n, card_e, cpu_e, gap in pins.flips:
        step, layer = divmod(call, cfg.num_layers)
        where = "prefill" if step == 0 else f"decode step {step - 1}"
        print(f"{arch} {dtype} routing flip: {where}, layer {layer}, token {n}: card experts "
              f"{card_e}, CPU {cpu_e}, CPU router probabilities {gap:.3e} apart "
              f"(allowed {FLIP_MARGIN[dtype]})")
        if gap > FLIP_MARGIN[dtype]:
            raise AssertionError(f"{arch} path vs plain {dtype}: a routing flip {gap:.3e} "
                                 f"from a tie")
    want = expected_serving_launches(cfg, steps)
    if {k: after[k] - before[k] for k in after} != want:
        raise AssertionError(f"{arch} path vs plain: the card's path missed its kernels")
    tol = PATH_TOL[dtype]
    errs, same = [], []
    for i, (a, b) in enumerate(pairs):
        a = a.cpu().float()
        b = b.float()
        torch.testing.assert_close(a, b, rtol=tol, atol=tol,
                                   msg=lambda m: f"{arch} path vs plain {dtype} step {i}: {m}")
        errs.append(float((a - b).abs().max()))
        same.append(bool(torch.equal(a.argmax(-1), b.argmax(-1))))
    kinds = f" ({', '.join(cfg.layer_pattern)})" if cfg.layer_pattern else ""
    img = f" after {cfg.num_image_tokens} image tokens" if cfg.num_image_tokens else ""
    if cfg.family == "encdec":
        kinds, img = " + 2 encoder layers", f" behind {cfg.encoder_seq} frames"
    print(f"{arch} cut to 2 layers{kinds}, {dtype}, B={batch}, prompt {S}{img} + {steps} "
          f"decode steps: "
          f"card vs CPU logits max_abs_err per step {', '.join(f'{e:.3e}' for e in errs)} "
          f"(tol {tol}, |logits| <= {float(pairs[0][1].float().abs().max()):.2f}); greedy "
          f"tokens agree: {same}; CPU prefill {cpu_s:.1f} s"
          + (f"; {len(pins.flips)} routing flip(s) at near-ties" if cfg.family == "moe" else ""))
    return max(errs)


def moe_layer_vs_cpu(dtype: str, device, arch: str, B=2, S=512) -> int:
    """One MoE layer of ``arch`` at full width on the card and on the CPU, on
    identical inputs: seeded weights (1 / sqrt(fan-in)) and an input that leans
    along router column 0, so that expert overflows its capacity.  Expert ids,
    slots and the kept mask equal exactly; y and aux within ``PATH_TOL``; the
    card's call makes no device-to-host sync.  -> the copies dropped."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(arch)
    d, ff, E, K = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.experts_per_token
    wdt = getattr(torch, dtype)
    g = torch.Generator(device=device)
    g.manual_seed(7)

    def draw(shape, fan_in, dt=wdt):
        return (torch.randn(shape, generator=g, device=device) / math.sqrt(fan_in)).to(dt)

    p = {"router": draw((d, E), d, torch.float32), "w_gate": draw((E, d, ff), d),
         "w_up": draw((E, d, ff), d), "w_down": draw((E, ff, d), ff)}
    col = p["router"][:, 0]
    x = (0.5 * torch.randn((B, S, d), generator=g, device=device)
         + 6.0 * col / col.norm()).to(wdt)
    cpu_p, cpu_x = tree_to(p, "cpu"), x.cpu()
    torch.cuda.synchronize()
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe.moe_ffn(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        yc, auxc = moe.moe_ffn(cpu_p, cpu_x, cfg)
        r = moe.route(p["router"], x.reshape(B * S, d), K)
        rc = moe.route(cpu_p["router"], cpu_x.reshape(B * S, d), K)
    what = f"{arch} MoE layer {dtype}, N={B * S}, C={r.capacity}"
    for f in ("expert", "slot", "keep"):
        a, b = getattr(r, f).cpu(), getattr(rc, f)
        if not torch.equal(a, b):
            bad = int((a != b).nonzero()[0, 0]) // K
            probs = torch.softmax(cpu_x.reshape(B * S, d)[bad].float() @ cpu_p["router"], -1)
            top = torch.sort(probs, descending=True).values
            raise AssertionError(f"{what}: {f} differs card vs CPU, first at token {bad}, "
                                 f"whose top-{K + 1} probabilities are {top[:K + 1].tolist()}")
    drops = int((~rc.keep).sum())
    if drops == 0:
        raise AssertionError(f"{what}: the skewed input dropped no copy")
    tol = PATH_TOL[dtype]
    torch.testing.assert_close(y.cpu().float(), yc.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{what} y card vs CPU: {m}")
    torch.testing.assert_close(aux.cpu(), auxc, rtol=tol, atol=tol,
                               msg=lambda m: f"{what} aux card vs CPU: {m}")
    print(f"{what}: {drops} of {B * S * K} copies dropped, expert ids / slots / kept mask "
          f"equal card vs CPU, y max_abs_err {float((y.cpu().float() - yc.float()).abs().max()):.3e} "
          f"(|y| <= {float(yc.float().abs().max()):.2f}), aux {float(aux):.6f} vs "
          f"{float(auxc):.6f} (tol {tol}); no device-to-host sync in the card's call")
    return drops


def decode_vs_prefill(device, arch="hymba-1.5b") -> float:
    """tests/test_models.py::test_decode_matches_prefill at full width and depth
    (fp32, the dtype that test runs): 2 decode steps after a prefill against one
    prefill of the longer context, atol = rtol = 2e-2 (that test's).  S = 1030
    passes hymba-1.5b's window (the ring has wrapped) and leaves a ragged last
    SSD chunk of 6."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.utils import prng

    cfg = get_config(arch).replace(dtype="float32")
    api = build_model(cfg)
    params = api.init(prng.key(0, device), device)
    S = 1030
    budget = S + 4
    toks = make_lm_batch(prng.key(3, device), 2, S + 5, cfg.vocab_size, device)["tokens"]
    with torch.no_grad():
        _, cache = api.prefill(params, {"tokens": toks[:, :S]}, budget)
        for i in range(2):
            ld, cache = api.decode_step(params, cache, toks[:, S + i])
        lfull, _ = api.prefill(params, {"tokens": toks[:, :S + 2]}, budget)
    torch.testing.assert_close(ld, lfull, rtol=2e-2, atol=2e-2)
    err = float((ld - lfull).abs().max())
    print(f"{arch} fp32, {cfg.num_layers} layers: 2 decode steps after a {S}-token prefill vs one "
          f"{S + 2}-token prefill: max_abs_err {err:.3e} (tol 2e-2), greedy tokens agree: "
          f"{bool(torch.equal(ld.argmax(-1), lfull.argmax(-1)))}")
    return err


def check_records(state, records, eval_rounds=None) -> None:
    """Every metric and every float leaf of ``state`` finite; with
    ``eval_rounds``, the test metrics NaN on the other rounds (no eval)."""
    for rec in records:
        for k, v in rec.__dict__.items():
            if eval_rounds is not None and k in ("test_acc", "test_loss") \
                    and rec.round not in eval_rounds:
                if not math.isnan(v):
                    raise AssertionError(f"round {rec.round}: {k} = {v} without an eval")
            elif not math.isfinite(v):
                raise AssertionError(f"round {rec.round}: {k} = {v} is not finite")
    for f in ("params", "opt_m", "opt_v", "buf_delta"):
        if not bool(torch.isfinite(getattr(state, f)).all()):
            raise AssertionError(f"{f} has non-finite entries")


def drive(sim, server: str, rsu_per_round: int = 0, rounds: int = ROUNDS):
    """Warm-up and ``rounds`` rounds, launch counts zeroed just before and
    read just after: per round 2 rttg_latency, ``rsu_per_round`` rsu_reduce
    and 1 ``server`` launch, nothing else.  -> (the state before each round
    and after the last, records, launches)."""
    reset_launches()
    sim.warmup_sketches()
    states, records = [], []
    for _ in range(rounds):
        states.append(sim.state)
        records.append(sim.run_round())
    states.append(sim.state)
    torch.cuda.synchronize()
    launches = read_launches()
    for rec in records:
        print(json.dumps(rec.__dict__))
    print(f"launches over {rounds} round(s): {launches}")
    want = dict.fromkeys(launches, 0)
    want.update(rttg_latency=2 * rounds, rsu_reduce=rsu_per_round * rounds,
                **{server: rounds})
    if launches != want:
        raise AssertionError(f"expected {want}, got {launches}")
    check_records(sim.state, records)
    return states, records, launches


def replay(sim, state0, first, traffic, params_atol: float, acc_atol: float = 1e-6,
           leaf_tol=(1e-4, 1e-7), loss_rtol: float = 1e-4) -> None:
    """The first round again from ``state0``: on the card (it must repeat
    bitwise) and on the CPU through the plain versions (the same integers;
    the moments and the ring within ``leaf_tol``, (rtol, atol))."""
    from repro_torch.core.scenarios import scenario_params
    from repro_torch.fl.rounds import RoundMetrics, metrics_to_records

    s_gpu, m_gpu = sim._step(state0, sim.scn, 0, 0, sim.data, True)
    again = metrics_to_records(RoundMetrics(*[x[None] for x in m_gpu]))[0]
    if again != first:
        raise AssertionError(f"replayed round differs on the card: {again} vs {first}")
    scn_cpu = scenario_params(traffic, "cpu")
    s_cpu, m_cpu = sim._step(state0.to("cpu"), scn_cpu, 0, 0, sim.data.to("cpu"), True)
    cpu = metrics_to_records(RoundMetrics(*[x[None] for x in m_cpu]))[0]
    for f in ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained"):
        if getattr(cpu, f) != getattr(first, f):
            raise AssertionError(f"cuda vs cpu: {f} {getattr(first, f)} != {getattr(cpu, f)}")
    for f in ("sketch_age", "buf_mask"):
        if not torch.equal(getattr(s_gpu, f).cpu(), getattr(s_cpu, f)):
            raise AssertionError(f"cuda vs cpu: {f} differs (the reporting cohort / the ring)")
    # float order differs between the card and the CPU (GEMMs, reductions,
    # transcendentals): metrics rtol 1e-4, the model after one round by
    # ``params_atol``, test accuracy by ``acc_atol``
    for f in ("sim_time", "duration", "mean_pred_latency", "mean_real_latency",
              "test_acc", "test_loss"):
        a, b = getattr(first, f), getattr(cpu, f)
        if not math.isclose(a, b, rel_tol=loss_rtol if f == "test_loss" else 1e-4,
                            abs_tol=acc_atol if f == "test_acc" else 1e-6):
            raise AssertionError(f"cuda vs cpu: {f} {a} vs {b}")
    for f in ("params", "buf_delta"):
        if getattr(s_gpu, f).dtype != getattr(s_cpu, f).dtype:
            raise AssertionError(f"cuda vs cpu: {f} in {getattr(s_gpu, f).dtype} vs "
                                 f"{getattr(s_cpu, f).dtype}")
    torch.testing.assert_close(s_gpu.params.cpu().float(), s_cpu.params.float(), rtol=0,
                               atol=params_atol)
    for f in ("opt_m", "opt_v", "buf_delta"):
        torch.testing.assert_close(getattr(s_gpu, f).cpu().float(), getattr(s_cpu, f).float(),
                                   rtol=leaf_tol[0], atol=leaf_tol[1])
    print(f"cuda vs cpu, one round from the same state: integers equal, max |dparams| = "
          f"{float((s_gpu.params.cpu().float() - s_cpu.params.float()).abs().max()):.3e}")


def profile_round(label, fn, card):
    """One call of ``fn`` (a round, a decode step, a prefill) under
    torch.profiler, the device traced alone (a host trace would slow the call
    it measures): wall, device busy time and idle share, and the device
    kernels by total time.  -> {"wall_ms", "ops", "busy_ms", "idle"} (None
    when the profiler saw no device activity)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    if not dev:
        print(f"profiled {label}: the profiler recorded no device activity; "
              "device busy share not measured")
        return None
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    print(f"profiled {label}: wall {wall * 1e3:.1f} ms, {len(dev)} device "
          f"kernels/copies, device busy {busy_us / 1e3:.2f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f} [{card}]")
    by_name = {}
    for e in dev:
        c, us_ = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, us_ + e.time_range.elapsed_us())
    for name, (c, us_) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {c:5d} x {us_ / max(c, 1):9.2f} us = {us_ / 1e3:8.3f} ms  {name[:80]}")
    for name, (c, us_) in by_name.items():
        # B5 in the path, with its carry and rows warm in L2; B8 in the prefill
        for kernel in ("rsu_reduce", "ssd_scan"):
            if kernel in name:
                print(f"  {kernel} in this profile: {c} calls x {us_ / c:.2f} us of device "
                      f"time = {us_ / 1e3:.3f} ms  ({name[:60]}) [{card}]")
    return {"wall_ms": wall * 1e3, "ops": len(dev), "busy_ms": busy_us / 1e3,
            "idle": 1 - busy_us / 1e6 / wall}


def assert_rounds_bitwise(a, b, what) -> None:
    """Two rounds' (state, metrics) equal bit for bit (NaN metrics alike)."""
    (sa, ma), (sb, mb) = a, b
    for f in sa._fields:
        x, y = getattr(sa, f), getattr(sb, f)
        same = (all(torch.equal(p, q) for p, q in zip(x, y)) if f == "twin" else
                torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        if not same:
            raise AssertionError(f"{what}: state leaf {f} differs")
    for f in ma._fields:
        x, y = getattr(ma, f), getattr(mb, f)
        if not (torch.equal(x, y) or bool(torch.isnan(x).all() and torch.isnan(y).all())):
            raise AssertionError(f"{what}: metric {f} differs")
    print(f"{what}: every state leaf and metric bitwise")


SELECTOR_ROUNDS = 3
# card vs CPU tolerances of a selector round: positions ~1e4 m (an ulp is
# ~1e-3 m) through the fusion's atan2 / sin / cos, which round an ulp apart
# on the two devices, then 50 predictor steps; latency through log10 / pow
RTTG_TOL = {"pos": (1e-6, 1e-2), "speed": (1e-5, 1e-5), "accel": (1e-5, 1e-5),
            "pos_var": (1e-5, 1e-6), "rsu_dist": (1e-5, 2e-2)}


def selector_rounds(device, card):
    """The paper's pipeline stage by stage at full width: ring, N=100,
    sketch_dim 1024, fl-mnist-mlp updates (P = 159,010), 10 clusters,
    contextual.  Each round: observe -> predicted_latency -> report (the last
    cohort's updates; every client's first update before round 0) ->
    recluster -> the stage-3 Gram ``core.pairwise_cosine(sketches)`` ->
    select -> train the elected cohort and FedAvg -> end_round; the twin then
    advances 10 s.  Launch counts zeroed just before the rounds and read just
    after: one ``pairwise_cosine`` a round, nothing else.  -> (the inputs and
    outputs of every round, launches, per-stage wall ms)."""
    from repro_torch import core
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl.client import make_local_trainer
    from repro_torch.fl.partition import partition_clients
    from repro_torch.fl.server import fedavg_aggregate, normalized_weights
    from repro_torch.models import build_model
    from repro_torch.utils import prng
    from repro_torch.utils.pytree import tree_bytes

    n = 100
    fl = FLConfig(num_clients=n, samples_per_client=256, num_clusters=10, sketch_dim=1024)
    traffic = core.scenario_config("ring", num_vehicles=n)
    key = prng.key(0)
    api = build_model(get_config("fl-mnist-mlp"))
    params = api.init(key, device)
    mb = tree_bytes(api.spec)
    twin = core.TrafficTwin(traffic, key, device)
    tstate = twin.advance(twin.init_state(), prng.key(1), 10.0)
    sel = core.ContextualSelector(fl, traffic, key, device)
    images, labels = partition_clients(key, "mnist", fl, device=device)
    trainer = make_local_trainer(api.loss, fl.learning_rate, 1, fl.batch_size)
    bs = fl.batch_size
    _, vecs = trainer(params, images[:, :bs], labels[:, :bs], prng.key(2))
    ids = torch.arange(n, device=device)
    torch.cuda.synchronize()
    stages = ("observe", "predict", "report", "recluster", "gram", "select", "train+fedavg",
              "end_round")
    stage_ms = {k: [] for k in stages}
    rounds_ = []
    reset_launches()
    for r in range(SELECTOR_ROUNDS):
        snap = dict(round=sel._round, sketches=sel.sketches, sketch_age=sel.sketch_age,
                    clusters=sel.clusters, twin=tstate, ids=ids, vecs=vecs)
        clock = {"t": time.perf_counter()}

        def lap(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stage_ms[name].append((now - clock["t"]) * 1e3)
            clock["t"] = now

        rttg = sel.observe(tstate)
        lap("observe")
        lat, _ = sel.predicted_latency(mb)
        lap("predict")
        sel.report_updates(ids, vecs)
        lap("report")
        sel.recluster()
        lap("recluster")
        gram = core.pairwise_cosine(sel.sketches)
        lap("gram")
        out = sel.select("contextual", mb)
        lap("select")
        idx = torch.nonzero(out["mask"])[:, 0]
        updates, vecs = trainer(params, images[idx], labels[idx], prng.fold_in(prng.key(3), r))
        k = idx.numel()
        w = normalized_weights(torch.ones((k,), dtype=torch.bool, device=device),
                               torch.full((k,), float(fl.samples_per_client), device=device))
        params = fedavg_aggregate(params, updates, w)
        lap("train+fedavg")
        snap.update(rttg=rttg, lat=lat, sketches_out=sel.sketches, clusters_out=sel.clusters,
                    gram=gram, select=out)
        sel.end_round()
        lap("end_round")
        rounds_.append(snap)
        ids = idx
        tstate = twin.advance(tstate, prng.fold_in(prng.key(4), r), 10.0)
        if k < 1 or not bool(torch.isfinite(lat).all()):
            raise AssertionError(f"selector round {r}: {k} elected, latency finite: "
                                 f"{bool(torch.isfinite(lat).all())}")
        if not torch.equal(gram, gram.T):
            raise AssertionError(f"selector round {r}: the stage-3 Gram is not symmetric")
        sizes = torch.bincount(sel.clusters, minlength=fl.num_clusters).tolist()
        print(f"round {r}: elected {idx.tolist()}, cluster sizes {sizes}, predicted latency "
              f"{float(lat.min()):.3f}..{float(lat.max()):.3f} s, Gram off-diagonal mean "
              f"{float((gram.sum() - gram.diagonal().sum()) / (n * n - n)):.4f}")
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"launches over {SELECTOR_ROUNDS} selector rounds: {launches}")
    want = dict.fromkeys(launches, 0)
    want.update(pairwise_cosine=SELECTOR_ROUNDS)
    if launches != want:
        raise AssertionError(f"expected {want}, got {launches}")
    print("per-stage wall time (ms, each stage ends in a synchronize; rounds "
          f"{', '.join(str(i) for i in range(SELECTOR_ROUNDS))}) [{card}]:")
    for name in stages:
        print(f"  {name:13s} {', '.join(f'{x:.2f}' for x in stage_ms[name])}")
    return dict(fl=fl, traffic=traffic, key=key, mb=mb, rounds=rounds_, launches=launches,
                stage_ms=stage_ms)


def selector_replay_cpu(run) -> None:
    """Round 1 again from its state on the CPU's plain path: RSU ids, loads,
    adjacency, connectivity, the mask and the cluster labels equal; floats
    within ``RTTG_TOL``, latency rtol 1e-4, sketches atol 1e-6 and the Gram
    atol 1e-5 (card and CPU sum in other orders)."""
    from repro_torch import core

    snap = run["rounds"][1]
    sel = core.ContextualSelector(run["fl"], run["traffic"], run["key"], "cpu")
    sel._round = snap["round"]
    sel.sketches, sel.sketch_age = snap["sketches"].cpu(), snap["sketch_age"].cpu()
    sel.clusters = snap["clusters"].cpu()
    rttg = sel.observe(core.TwinState(*[x.cpu() for x in snap["twin"]]))
    lat, _ = sel.predicted_latency(run["mb"])
    sel.report_updates(snap["ids"].cpu(), snap["vecs"].cpu())
    sel.recluster()
    gram = core.pairwise_cosine(sel.sketches)
    out = sel.select("contextual", run["mb"])
    card_rttg, card_out = snap["rttg"], snap["select"]
    for f in ("rsu_id", "load", "adj"):
        if not torch.equal(getattr(card_rttg, f).cpu(), getattr(rttg, f)):
            raise AssertionError(f"selector replay: rttg.{f} differs between card and CPU")
    for f, (rtol, atol) in RTTG_TOL.items():
        torch.testing.assert_close(getattr(card_rttg, f).cpu(), getattr(rttg, f), rtol=rtol,
                                   atol=atol, msg=lambda m: f"selector replay rttg.{f}: {m}")
    torch.testing.assert_close(snap["lat"].cpu(), lat, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(snap["sketches_out"].cpu(), sel.sketches, rtol=0, atol=1e-6)
    torch.testing.assert_close(snap["gram"].cpu(), gram, rtol=0, atol=1e-5)
    if not torch.equal(snap["clusters_out"].cpu(), sel.clusters):
        raise AssertionError("selector replay: cluster labels differ between card and CPU")
    for f in ("mask", "connected"):
        if not torch.equal(card_out[f].cpu(), out[f]):
            raise AssertionError(f"selector replay: {f} differs between card and CPU")
    print(f"selector round {snap['round']} replayed on the CPU: RSU ids, loads, adjacency, "
          f"connectivity, mask and cluster labels equal; max |dlatency| "
          f"{float((snap['lat'].cpu() - lat).abs().max()):.3e} s, max |dGram| "
          f"{float((snap['gram'].cpu() - gram).abs().max()):.3e}")


def fused_vs_unfused(sim, state0) -> bool:
    """One main-path round from ``state0`` through the unfused lane (the RTTG
    API, plain torch on the card) against the fused lane (``rttg_latency``):
    integers and booleans equal, floats within rtol 1e-5; the unfused round
    launches no ``rttg_latency``.  -> whether every leaf was bitwise."""
    from repro_torch.fl.rounds import cohort_size_for, make_round_step

    fused = sim._step(state0, sim.scn, 0, 0, sim.data, True)
    unfused_step = make_round_step(sim.api.loss, sim.fl, cohort_size_for(sim.fl, ("contextual",)),
                                   sim.model_bytes, sim.param_spec, ("contextual",),
                                   fused=False)
    reset_launches()
    unfused = unfused_step(state0, sim.scn, 0, 0, sim.data, True)
    torch.cuda.synchronize()
    lu = read_launches()
    want = dict.fromkeys(lu, 0)
    want.update(fedavg_reduce=1)
    if lu != want:
        raise AssertionError(f"unfused round: expected launches {want}, got {lu}")
    (sf, mf), (su, mu) = fused, unfused
    bitwise = []

    def same(what, x, y):
        if x.dtype.is_floating_point:
            torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6, equal_nan=True,
                                       msg=lambda m: f"fused vs unfused {what}: {m}")
            bitwise.append((what, bool(torch.equal(x, y) or (x.isnan() & y.isnan()).all())))
        elif not torch.equal(x, y):
            raise AssertionError(f"fused vs unfused: {what} differs")

    for f in sf._fields:
        x, y = getattr(sf, f), getattr(su, f)
        if f == "twin":
            for name, a, b in zip(x._fields, x, y):
                same(f"twin.{name}", a, b)
        elif isinstance(x, torch.Tensor):
            same(f, x, y)
        elif x != y:
            raise AssertionError(f"fused vs unfused: {f} {x} != {y}")
    for f in mf._fields:
        same(f"metric {f}", getattr(mf, f), getattr(mu, f))
    differ = [w for w, b in bitwise if not b]
    print(f"fused vs unfused round (main path, from the first round's state): integers and "
          f"booleans equal, floats within rtol 1e-5; bitwise: "
          f"{'every leaf and metric' if not differ else 'all but ' + ', '.join(differ)}; "
          f"unfused launches {lu}")
    return not differ


def device_profile(fn, calls: int = 20, names=()):
    """``fn``'s device time (us) and device ops per call, from torch.profiler:
    over every kernel, copy and memset, or with ``names`` over those whose name
    holds one of them (NaN and 0 when the profiler records no device activity)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
           and (not names or any(n in e.name for n in names))]
    if not dev:
        return math.nan, 0.0
    return sum(e.time_range.elapsed_us() for e in dev) / calls, len(dev) / calls


def device_us_per_call(fn, calls: int = 20) -> float:
    """Mean device time of ``fn``'s kernels per call, from torch.profiler
    (NaN when the profiler records no device activity)."""
    return device_profile(fn, calls)[0]


def wrapper_times(device, card) -> None:
    """``rttg_latency`` and ``fedavg_reduce`` called as the round calls them,
    through the wrappers of the ``repro_torch`` on ``sys.path``: per call, the
    profiled device time and device ops of everything the call issues, and
    of the kernels' own ops (their names, and memsets).  ``rttg_latency`` at
    the main path's predicted call (N=100, R=10, 50 steps, CR 1), its
    realized call (0 steps) and the fleet's predicted call (N=100,000);
    ``fedavg_reduce`` at K=10, P=159,010 beside ``torch.mv``, cycling
    operand copies that exceed the 50 MB L2."""
    from repro_torch.kernels import fedavg_reduce as fedavg_mod
    from repro_torch.kernels import rttg_latency as rttg_mod
    from repro_torch.utils import prng

    mb = torch.tensor(636_040.0, device=device)
    for label, n, predict in (("predicted", 100, True), ("realized", 100, False),
                              ("predicted", 100_000, True)):
        scn, pos, speed, accel, t, _ = rttg_inputs("ring", n, 3, 1.0, device)

        def call(pos=pos, speed=speed, accel=accel, t=t, scn=scn, predict=predict):
            rttg_mod.rttg_latency(pos, speed, accel, t, mb, None, scn, predict=predict)

        ev_us = time_ms(call, iters=100, warmup=10) * 1e3
        all_us, all_ops = device_profile(call)
        own_us, own_ops = device_profile(call, names=("rttg", "Memset"))
        print(f"rttg_latency wrapper, {label} call at N={n}, R={scn.n_rsu}: device ops per "
              f"call {all_ops:g} ({all_us:.2f} us), of them the kernel's {own_ops:g} "
              f"({own_us:.2f} us); events {ev_us:.2f} us a call [{card}]")
    K, P = 10, 159_010
    us = [1e-3 * prng.normal(prng.fold_in(prng.key(11), i), (K, P), device) for i in range(16)]
    w = torch.full((K,), 0.1, dtype=torch.float32, device=device)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(us)
        return us[it["i"]]

    fed_us, fed_ops = device_profile(lambda: fedavg_mod.fedavg_reduce(nxt(), w))
    mv_us, _ = device_profile(lambda: torch.mv(nxt().t(), w))
    print(f"fedavg_reduce wrapper K={K} P={P}: device ops per call {fed_ops:g}, device time "
          f"{fed_us:.2f} us; torch.mv {mv_us:.2f} us (kernel {fed_us / mv_us:.3f}x) [{card}]")


def graph_us(fn, reps: int = 50) -> float:
    """Device time of one ``fn`` call, in us: CUDA events around replays of
    a CUDA graph that holds ``reps`` calls, so the host's launch cost drops
    out (the profiler's windows can miss events late in the script; a graph
    replay has no host in it).  ``fn`` launches on the current stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (5 * reps)


def time_grid_kernels(kernels, lib, grid_launches, main_err, bf16_times, device, card):
    """B1g and B2g at the bench grid's shapes, each beside the lane loop's G
    one-lane calls, appended to ``kernels``: CUDA events over back-to-back
    launches of the C entry point, and the device time a launch from CUDA
    graph replays.  B1g: 24 lanes over the 8 catalog scenarios, N=20, R=10,
    predicted (50 steps), CR 1.  B2g: (24, 2, 159,010), fp32 and bf16 rows,
    cycling copies that exceed the 50 MB L2 (45.8 MB a copy in fp32), beside
    ``torch.bmm(w[:, None, :], u)``."""
    from repro_torch.core.trajectory import horizon_steps
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce_grid_plain
    from repro_torch.kernels.rttg_latency import (grid_operand, rttg_latency_grid_plain,
                                                  scenario_operand)
    from repro_torch.utils import prng

    def stream():
        return torch.cuda.current_stream(device).cuda_stream

    G, n = 24, 20
    mb = torch.tensor(636_040.0, device=device)
    scns, view, pos, speed, accel, t, _ = grid_lane_inputs(GRID_SCENARIOS * 3, n, 5, 1.0,
                                                           device)
    R, steps = view.n_rsu, horizon_steps(view.predict_horizon_s, view)
    dt, hs = float(view.sim_dt_s), float(view.predict_horizon_s)
    op = grid_operand(view, device)
    ops = [scenario_operand(scn, device) for scn in scns]
    lat = torch.empty((G, n), dtype=torch.float32, device=device)
    conn = torch.empty((G, n), dtype=torch.bool, device=device)

    def b1g():
        kbuild.check(lib.rttg_latency_grid_launch(
            op.data_ptr(), op.shape[1], R, G, t.data_ptr(), mb.data_ptr(), pos.data_ptr(),
            speed.data_ptr(), accel.data_ptr(), None, n, steps, dt, hs, lat.data_ptr(),
            conn.data_ptr(), None, stream()), "rttg_latency_grid")

    def b1_lanes():  # the lane loop's geometry: one B1 launch a lane
        for g in range(G):
            kbuild.check(lib.rttg_latency_launch(
                ops[g].data_ptr(), R, t[g:].data_ptr(), mb.data_ptr(), pos[g].data_ptr(),
                speed[g].data_ptr(), accel[g].data_ptr(), None, n, steps, dt, hs, 1, None,
                None, lat[g].data_ptr(), conn[g].data_ptr(), None, stream()), "rttg_latency")

    b1g_t = (time_ms(b1g), time_ms(lambda: rttg_latency_grid_plain(pos, speed, accel, t, mb,
                                                                    None, view, True),
                                   iters=20, warmup=3), graph_us(b1g), graph_us(b1_lanes, 4))
    # bytes: 3 f32 inputs a client, each lane's scenario row and t, model_bytes;
    # f32 lat and bool conn out.  Flops as rttg_latency's, per lane
    b1g_bytes = G * (n * 4 * 3 + op.shape[1] + 4 + n * 4 + n) + 4
    b_ms, b_by = bound(b1g_bytes, G * n * (8 * steps + 6 * R + 45))
    kernels.append({
        "name": "rttg_latency_grid", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rttg_latency.cu",
        "replaces": "src/repro/kernels/rttg_latency.py:242",
        "launches": sum(g["rttg_latency_grid"] for g in grid_launches.values()),
        "launches_by_path": {f"engine {grid} grid": g["rttg_latency_grid"]
                             for grid, g in grid_launches.items() if g["rttg_latency_grid"]},
        "max_abs_err": main_err["rttg_latency_grid"],
        "ms": b1g_t[0], "plain_ms": b1g_t[1], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "device_us": b1g_t[2],
    })
    print(f"rttg_latency_grid G={G} N={n} R={R} predict (50 steps), one launch: events "
          f"{b1g_t[0] * 1e3:.2f} us, device time {b1g_t[2]:.2f} us (graph replay); the lane "
          f"loop's {G} rttg_latency launches {b1g_t[3]:.2f} us of device time; plain "
          f"{b1g_t[1] * 1e3:.1f} us; bound {b_ms * 1e3:.5f} us ({b_by}) [{card}]")

    K, P = 2, 159_010
    us = [1e-3 * prng.normal(prng.fold_in(prng.key(13), i), (G, K, P), device) for i in range(4)]
    us16 = [x.to(torch.bfloat16) for x in us] + [
        (1e-3 * prng.normal(prng.fold_in(prng.key(14), i), (G, K, P), device))
        .to(torch.bfloat16) for i in range(4)]
    w = torch.full((G, K), 0.5, dtype=torch.float32, device=device)
    out = torch.empty((G, P), dtype=torch.float32, device=device)
    vec = 2 if P % 2 == 0 else 1
    it = {"i": 0}

    def nxt(rows):
        it["i"] = (it["i"] + 1) % len(rows)
        return rows[it["i"]]

    def b2g(rows=us):
        u = nxt(rows)
        kbuild.check(lib.fedavg_reduce_grid_launch(u.data_ptr(), u.element_size(), w.data_ptr(),
                                                   G, K, P, vec, out.data_ptr(), stream()),
                     "fedavg_reduce_grid")

    def b2_lanes(rows=us):  # the lane loop's reduce: one B2 launch a lane
        u = nxt(rows)
        for g in range(G):
            kbuild.check(lib.fedavg_reduce_launch(u[g].data_ptr(), u.element_size(),
                                                  w[g].data_ptr(), K, P, vec, out[g].data_ptr(),
                                                  stream()), "fedavg_reduce")

    def bmm():
        return torch.bmm(w[:, None, :], nxt(us))

    b2g_t = (time_ms(b2g), time_ms(lambda: fedavg_reduce_grid_plain(nxt(us), w), iters=50,
                                   warmup=5),
             time_ms(bmm), graph_us(b2g), graph_us(bmm), graph_us(b2_lanes, 4))
    b2g_bytes = G * K * P * 4 + G * K * 4 + G * P * 4
    b_ms, b_by = bound(b2g_bytes, 2 * G * K * P)
    kernels.append({
        "name": "fedavg_reduce_grid", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/fedavg_reduce.py:43",
        "launches": sum(g["fedavg_reduce_grid"] for g in grid_launches.values()),
        "launches_by_path": {f"engine {grid} grid": g["fedavg_reduce_grid"]
                             for grid, g in grid_launches.items() if g["fedavg_reduce_grid"]},
        "max_abs_err": main_err["fedavg_reduce_grid"],
        "ms": b2g_t[0], "plain_ms": b2g_t[1], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": b2g_t[2], "device_us": b2g_t[3], "library_device_us": b2g_t[4],
    })
    print(f"fedavg_reduce_grid G={G} K={K} P={P} (vec {vec}): events {b2g_t[0] * 1e3:.2f} us, "
          f"device time {b2g_t[3]:.2f} us (graph replay; {b2g_bytes / (b2g_t[3] * 1e3):.0f} "
          f"GB/s); the lane loop's {G} fedavg_reduce launches {b2g_t[5]:.2f} us; torch.bmm "
          f"events {b2g_t[2] * 1e3:.2f} us, device time {b2g_t[4]:.2f} us; plain "
          f"{b2g_t[1] * 1e3:.1f} us; bound {b_ms * 1e3:.2f} us ({b_by}, "
          f"{b2g_bytes / 1e6:.1f} MB) [{card}]")
    b16 = (time_ms(lambda: b2g(us16)),
           time_ms(lambda: fedavg_reduce_grid_plain(nxt(us16), w), iters=50, warmup=5),
           graph_us(lambda: b2g(us16)))
    b16_bytes = G * K * P * 2 + G * K * 4 + G * P * 4
    b16_bound = bound(b16_bytes, 2 * G * K * P)
    bf16_times["fedavg_reduce_grid"] = b16 + (b16_bound, b16_bytes)
    print(f"fedavg_reduce_grid G={G} K={K} P={P} bf16 rows: events {b16[0] * 1e3:.2f} us, "
          f"device time {b16[2]:.2f} us (graph replay), plain {b16[1] * 1e3:.1f} us, bound "
          f"{b16_bound[0] * 1e3:.2f} us ({b16_bound[1]}, {b16_bytes / 1e6:.1f} MB) [{card}]")


def time_cnn_reduces(kernels, lib, main_err, device, card) -> None:
    """B2 and B2g at the CNN datasets' P (phase 4i), added to their rows of
    ``kernels`` under ``cnn_shapes``: B2 at the main path's K = 10 on fp32
    and bf16 rows, B2g at the bench grid's (24, 2), at fl-cifar10-cnn's P =
    1,070,794 and fl-svhn-cnn's 603,034.  CUDA events over back-to-back
    launches of the C entry point cycling copies that together exceed the
    50 MB L2, the device time a launch from CUDA graph replays, beside the
    plain version, ``torch.mv`` / ``torch.bmm`` on fp32 rows and the bound."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce_grid_plain, fedavg_reduce_plain

    def stream():  # the current stream at each launch: a graph captures on its own
        return torch.cuda.current_stream(device).cuda_stream

    gen = torch.Generator(device=device)
    gen.manual_seed(31)
    rows_by_name = {row["name"]: row for row in kernels}
    for name in ("fedavg_reduce", "fedavg_reduce_grid"):
        rows_by_name[name]["cnn_shapes"] = []
    for dataset, P in CNN_P.items():
        for name, G, K, rows in (("fedavg_reduce", 0, 10, torch.float32),
                                 ("fedavg_reduce", 0, 10, torch.bfloat16),
                                 ("fedavg_reduce_grid", 24, 2, torch.float32)):
            shape = (G, K, P) if G else (K, P)
            item = torch.tensor([], dtype=rows).element_size()
            n_bytes = (G or 1) * (K * P * item + K * 4 + P * 4)
            us = [(1e-3 * torch.randn(shape, generator=gen, device=device)).to(rows)
                  for _ in range(max(2, math.ceil(100e6 / n_bytes)))]
            w = torch.full(shape[:-1], 1.0 / K, dtype=torch.float32, device=device)
            out = torch.empty(shape[:-2] + (P,), dtype=torch.float32, device=device)
            vec = 4 if P % 4 == 0 else 2 if P % 2 == 0 else 1
            it = {"i": 0}

            def nxt(us=us):
                it["i"] = (it["i"] + 1) % len(us)
                return us[it["i"]]

            def launch(G=G, K=K, P=P, w=w, out=out, vec=vec, nxt=nxt):
                u = nxt()
                if G:
                    status = lib.fedavg_reduce_grid_launch(u.data_ptr(), u.element_size(),
                                                           w.data_ptr(), G, K, P, vec,
                                                           out.data_ptr(), stream())
                else:
                    status = lib.fedavg_reduce_launch(u.data_ptr(), u.element_size(),
                                                      w.data_ptr(), K, P, vec, out.data_ptr(),
                                                      stream())
                kbuild.check(status, "fedavg_reduce_grid" if G else "fedavg_reduce")

            plain = fedavg_reduce_grid_plain if G else fedavg_reduce_plain
            yardstick = None
            if rows == torch.float32:
                yardstick = ((lambda: torch.bmm(w[:, None, :], nxt())) if G
                             else (lambda: torch.mv(nxt().t(), w)))
            b_ms, b_by = bound(n_bytes, 2 * (G or 1) * K * P)
            row = {"dataset": dataset, "shape": list(shape), "rows": str(rows)[6:],
                   "ms": time_ms(launch), "plain_ms": time_ms(lambda: plain(nxt(), w), iters=20,
                                                               warmup=3),
                   "device_us": graph_us(launch), "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": time_ms(yardstick) if yardstick else None,
                   "max_abs_err": main_err["cnn"][f"fedavg_reduce_grid P={P}" if G else
                                                  f"fedavg_reduce {str(rows)[6:]} P={P}"]}
            rows_by_name[name]["cnn_shapes"].append(row)
            lib_txt = (f", {'torch.bmm' if G else 'torch.mv'} {row['library_ms'] * 1e3:.2f} us"
                       if yardstick else "")
            print(f"{name} {tuple(shape)} {row['rows']} rows ({dataset}): events "
                  f"{row['ms'] * 1e3:.2f} us, device time {row['device_us']:.2f} us (graph replay, "
                  f"{n_bytes / (row['device_us'] * 1e3):.0f} GB/s), plain "
                  f"{row['plain_ms'] * 1e3:.1f} us{lib_txt}, bound {b_ms * 1e3:.2f} us ({b_by}, "
                  f"{n_bytes / 1e6:.1f} MB) [{card}]")
            del us, w, out
    torch.cuda.empty_cache()


def time_server_grid(kernels, lib, grid_launches, main_err, device, card):
    """B4g and B3g at the engine grids' shapes, appended to ``kernels``: CUDA
    events over back-to-back launches of the C entry point and the device
    time a launch from CUDA graph replays, cycling two operand sets (each
    past the 50 MB L2), beside the plain version (the one-lane plain version
    lane by lane) and, for B4g, the lane loop's G B4 launches.  B4g: the
    async grid's (24, 2, Kb 8, 159,010), fp32, the ``("fedbuff",)`` registry
    (no moment rule: m and v neither read nor written), with no lane and
    with every lane draining.  B3g: the smoke grid without fedbuff, 40 lanes
    at K = 2 under rules 0-4 (8 lanes each), m' and v' written by every lane."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.server_update import (MOMENT_RULES,
                                                   server_update_buffered_grid_plain,
                                                   server_update_grid_plain)

    def stream():
        return torch.cuda.current_stream(device).cuda_stream

    P, K, Kb = 159_010, 2, 8
    hp = (1.0, 0.9, 1.0 - 0.9, 0.99, 1.0 - 0.99, 1e-3)
    rows_of = {}

    def operands(G, rules, seed):
        sets = []
        for i in range(2):
            u, w, params, m, v, ring, bw, _, _ = server_grid_operands(
                G, K, Kb, P, rules, seed + 101 * i, device)
            sets.append((u, w, params, m, v, ring, bw))
        return sets

    def launcher(G, sets, rule_t, drain_t, buffered, moments):
        outs = [torch.empty((G, P), dtype=torch.float32, device=device) for _ in range(3)]
        it = {"i": 0}

        def launch():
            it["i"] ^= 1
            u, w, params, m, v, ring, bw = sets[it["i"]]
            ring_args = (ring.data_ptr(), bw.data_ptr(), Kb, drain_t.data_ptr()) if buffered \
                else (None, None, 0, None)
            mv = (m.data_ptr(), v.data_ptr()) if moments else (None, None)
            kbuild.check(lib.server_update_grid_launch(
                u.data_ptr(), 4, w.data_ptr(), G, K, *ring_args, P, params.data_ptr(), 4, *mv,
                rule_t.data_ptr(), 0, *hp, 2, outs[0].data_ptr(),
                *((outs[1].data_ptr(), outs[2].data_ptr()) if moments else (None, None)),
                stream()), "server_update_grid")
        return launch

    # B4g: 24 fedbuff lanes, no moments
    G = 24
    sets = operands(G, (5,), 300)
    rule5 = torch.full((G,), 5, dtype=torch.int32, device=device)
    t4 = {}
    for label, drain in (("none draining", False), ("all draining", True)):
        drain_t = torch.full((G,), drain, dtype=torch.bool, device=device)
        launch = launcher(G, sets, rule5, drain_t, True, False)
        u, w, params, m, v, ring, bw = sets[0]

        def plain(u=u, w=w, ring=ring, bw=bw, params=params, m=m, v=v, drain_t=drain_t):
            return server_update_buffered_grid_plain(u, w, ring, bw, params, m, v, rule5, 0,
                                                     drain_t, registry=(5,))

        def lanes(drain_t=drain_t):  # the lane loop's server step: one B4 launch a lane
            u, w, params, m, v, ring, bw = sets[0]
            out = torch.empty((P,), dtype=torch.float32, device=device)
            for g in range(G):
                kbuild.check(lib.server_update_launch(
                    u[g].data_ptr(), 4, w[g].data_ptr(), K, ring[g].data_ptr(),
                    bw[g].data_ptr(), Kb, drain_t[g:].data_ptr(), P, params[g].data_ptr(), 4,
                    None, None, 5, 0, *hp, 2, out.data_ptr(), None, None, stream()),
                    "server_update")

        rows = K + (Kb if drain else 0)
        n_bytes = G * (rows * P * 4 + K * 4 + Kb * 4 + 1 + 4 + 2 * P * 4)
        t4[label] = dict(ms=time_ms(launch), plain_ms=time_ms(plain, iters=10, warmup=2),
                         device_us=graph_us(launch), loop_device_us=graph_us(lanes, 4),
                         bound=bound(n_bytes, G * (2 * rows * P + P)), bytes=n_bytes)
        t = t4[label]
        print(f"server_update_buffered_grid G={G} K={K} Kb={Kb} P={P} fedbuff, {label}, one "
              f"launch: events {t['ms'] * 1e3:.2f} us, device time {t['device_us']:.2f} us "
              f"(graph replay; {n_bytes / (t['device_us'] * 1e3):.0f} GB/s); the lane loop's "
              f"{G} server_update_buffered launches {t['loop_device_us']:.2f} us; plain "
              f"{t['plain_ms'] * 1e3:.1f} us; bound {t['bound'][0] * 1e3:.2f} us "
              f"({t['bound'][1]}, {n_bytes / 1e6:.1f} MB) [{card}]")
    rows_of["server_update_buffered_grid"] = t4
    del sets

    # B3g: 40 lanes, rules 0-4, every lane writes m' and v'
    G = 40
    registry = (0, 1, 2, 3, 4)
    sets = operands(G, registry, 400)
    rules = torch.tensor([registry[g // 8] for g in range(G)], dtype=torch.int32, device=device)
    launch = launcher(G, sets, rules, None, False, True)
    u, w, params, m, v, _, _ = sets[0]

    def plain3():
        return server_update_grid_plain(u, w, params, m, v, rules, 0, registry=registry)

    n_moment = sum(1 for r in rules.tolist() if r in MOMENT_RULES)
    n_bytes = G * (K * P * 4 + K * 4 + 4 + 2 * P * 4 + 4 * P * 4)
    t3 = dict(ms=time_ms(launch), plain_ms=time_ms(plain3, iters=10, warmup=2),
              device_us=graph_us(launch),
              bound=bound(n_bytes, G * 2 * K * P + n_moment * 12 * P + (G - n_moment) * P),
              bytes=n_bytes)
    print(f"server_update_grid G={G} K={K} P={P} rules 0-4 (m', v' from every lane), one "
          f"launch: events {t3['ms'] * 1e3:.2f} us, device time {t3['device_us']:.2f} us (graph "
          f"replay; {n_bytes / (t3['device_us'] * 1e3):.0f} GB/s); plain "
          f"{t3['plain_ms'] * 1e3:.1f} us; bound {t3['bound'][0] * 1e3:.2f} us "
          f"({t3['bound'][1]}, {n_bytes / 1e6:.1f} MB) [{card}]")
    del sets

    for name, t, extra in (
            ("server_update_grid", t3, {}),
            ("server_update_buffered_grid", t4["none draining"], {
                "ms_all_draining": t4["all draining"]["ms"],
                "device_us_all_draining": t4["all draining"]["device_us"],
                "bound_ms_all_draining": t4["all draining"]["bound"][0],
                "loop_device_us": t4["none draining"]["loop_device_us"],
                "loop_device_us_all_draining": t4["all draining"]["loop_device_us"]})):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/server_update.cu",
            "replaces": "src/repro/kernels/server_update.py:124" if name == "server_update_grid"
            else "src/repro/kernels/server_update.py:164",
            "launches": sum(g[name] for g in grid_launches.values()),
            "launches_by_path": {f"engine {grid} grid": g[name]
                                 for grid, g in grid_launches.items() if g[name]},
            "max_abs_err": main_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": None, "device_us": t["device_us"], **extra,
        })


def time_rsu_grid(kernels, lib, grid_launches, main_err, bf16_times, device, card):
    """B5g at the streamed two-tier grid's chunk, (G 8, K 4, R 10, P
    159,010), appended to ``kernels``: CUDA events over back-to-back
    launches of the C entry point and the device time a launch from CUDA
    graph replays, with the carry updated in place (the steady chunk) and
    without one (the first chunk), fp32 and bf16 rows and partials, cycling
    two operand sets (each past the 50 MB L2); beside the plain version (the
    one-lane plain version lane by lane), the lane loop's 8 B5 launches and
    one ``torch.baddbmm(carry, m^T, u)`` (``torch.bmm`` for the first chunk),
    ``m`` the (G, K, R) weighted one-hot."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.rsu_reduce import rsu_reduce_grid_plain, vector_width

    def stream():
        return torch.cuda.current_stream(device).cuda_stream

    G, K, R, P = 8, 4, 10, 159_010
    sets = []
    for i in range(2):
        gen = torch.Generator(device=device)
        gen.manual_seed(500 + i)
        u = 1e-3 * torch.randn((G, K, P), generator=gen, device=device)
        w = torch.rand((G, K), generator=gen, device=device)
        rid = torch.randint(0, R, (G, K), generator=gen, device=device).to(torch.int32)
        carry = 1e-3 * torch.randn((G, R, P), generator=gen, device=device)
        m = torch.nn.functional.one_hot(rid.long(), R).float() * w[..., None]
        sets.append({"u": u, "w": w, "rid": rid, "carry": carry, "m": m,
                     "u16": u.to(torch.bfloat16), "carry16": carry.to(torch.bfloat16)})
    # the carry rows the ids touch, counted before the timed launches update it
    carry_rows = sum(rsu_carry_rows(x["rid"], R, x["u"], x["carry"]) for x in sets) / len(sets)
    out = torch.empty((G, R, P), dtype=torch.float32, device=device)
    out16 = torch.empty((G, R, P), dtype=torch.bfloat16, device=device)
    mass = torch.empty((G, R), dtype=torch.float32, device=device)
    vec = vector_width(P, sets[0]["u"], out)
    it = {"i": 0}

    def nxt():
        it["i"] ^= 1
        return sets[it["i"]]

    def b5g(with_carry, half=False):
        x = nxt()
        u = x["u16"] if half else x["u"]
        c = x["carry16"] if half else x["carry"]
        o = c if with_carry else out16 if half else out
        kbuild.check(lib.rsu_reduce_launch(
            u.data_ptr(), u.element_size(), x["w"].data_ptr(), x["rid"].data_ptr(), G, K, R, P,
            vec, c.data_ptr() if with_carry else None, o.data_ptr(), o.element_size(),
            mass.data_ptr(), stream()), "rsu_reduce_grid")

    def b5_lanes():  # the lane loop's chunk: one B5 launch a lane, each in place
        x = nxt()
        for g in range(G):
            kbuild.check(lib.rsu_reduce_launch(
                x["u"][g].data_ptr(), 4, x["w"][g].data_ptr(), x["rid"][g].data_ptr(), 1, K, R,
                P, vec, x["carry"][g].data_ptr(), x["carry"][g].data_ptr(), 4,
                mass[g].data_ptr(), stream()), "rsu_reduce")

    def baddbmm():
        x = nxt()
        return torch.baddbmm(x["carry"], x["m"].transpose(1, 2), x["u"])

    def bmm():
        x = nxt()
        return torch.bmm(x["m"].transpose(1, 2), x["u"])

    def plain():
        x = nxt()
        return rsu_reduce_grid_plain(x["u"], x["w"], x["rid"], R, x["carry"])

    t = {"ms": time_ms(lambda: b5g(True)), "first_ms": time_ms(lambda: b5g(False)),
         "ms16": time_ms(lambda: b5g(True, True)),
         "plain_ms": time_ms(plain, iters=10, warmup=2),
         "library_ms": time_ms(baddbmm), "bmm_ms": time_ms(bmm),
         "device_us": graph_us(lambda: b5g(True)), "first_device_us": graph_us(lambda: b5g(False)),
         "device_us16": graph_us(lambda: b5g(True, True)),
         "first_device_us16": graph_us(lambda: b5g(False, True)),
         "library_device_us": graph_us(baddbmm), "bmm_device_us": graph_us(bmm),
         "loop_device_us": graph_us(b5_lanes, 4)}
    bounds = rsu_bounds(G, K, R, P, carry_rows)
    kernels.append({
        "name": "rsu_reduce_grid", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rsu_reduce.cu",
        "replaces": "src/repro/kernels/rsu_reduce.py:120",
        "launches": sum(g["rsu_reduce_grid"] for g in grid_launches.values()),
        "launches_by_path": {f"engine {grid} grid": g["rsu_reduce_grid"]
                             for grid, g in grid_launches.items() if g["rsu_reduce_grid"]},
        "max_abs_err": main_err["rsu_reduce_grid"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bounds["carry"][0],
        "bound_by": bounds["carry"][1], "library_ms": t["library_ms"],
        "carry_rows": carry_rows, "dense_bound_ms": bounds["dense"][0],
        "device_us": t["device_us"], "library_device_us": t["library_device_us"],
        "first_chunk": {"ms": t["first_ms"], "device_us": t["first_device_us"],
                        "bound_ms": bounds["first"][0], "bmm_ms": t["bmm_ms"],
                        "bmm_device_us": t["bmm_device_us"]},
        "loop_device_us": t["loop_device_us"],
    })
    bf16_times["rsu_reduce_grid"] = (t["ms16"], None, t["device_us16"],
                                     bounds["carry16"][:2], bounds["carry16"][2])
    print(f"rsu_reduce_grid G={G} K={K} R={R} P={P} (vec {vec}), one launch: with the carry "
          f"events {t['ms'] * 1e3:.2f} us, device time {t['device_us']:.2f} us (graph replay; "
          f"{bounds['carry'][0] * 1e3 / t['device_us']:.3f} of the bound "
          f"{bounds['carry'][0] * 1e3:.2f} us, {bounds['carry'][2] / 1e6:.1f} MB with the "
          f"{carry_rows:.1f} carry rows its ids touch of {G * R}; "
          f"{bounds['dense'][0] * 1e3 / t['device_us']:.3f} of the dense "
          f"{bounds['dense'][0] * 1e3:.2f} us, {bounds['dense'][2] / 1e6:.1f} MB, "
          f"{bounds['dense'][2] / (t['device_us'] * 1e3):.0f} GB/s); the lane loop's {G} "
          f"rsu_reduce launches {t['loop_device_us']:.2f} us; torch.baddbmm events "
          f"{t['library_ms'] * 1e3:.2f} us, device time {t['library_device_us']:.2f} us; plain "
          f"{t['plain_ms'] * 1e3:.1f} us [{card}]")
    print(f"rsu_reduce_grid G={G} K={K} R={R} P={P} first chunk (no carry): events "
          f"{t['first_ms'] * 1e3:.2f} us, device time {t['first_device_us']:.2f} us "
          f"({bounds['first'][0] * 1e3 / t['first_device_us']:.3f} of the bound "
          f"{bounds['first'][0] * 1e3:.2f} us, {bounds['first'][2] / 1e6:.1f} MB); torch.bmm "
          f"events {t['bmm_ms'] * 1e3:.2f} us, device time {t['bmm_device_us']:.2f} us [{card}]")
    print(f"rsu_reduce_grid G={G} K={K} R={R} P={P} bf16 rows and partials: with the carry "
          f"events {t['ms16'] * 1e3:.2f} us, device time {t['device_us16']:.2f} us "
          f"({bounds['carry16'][0] * 1e3 / t['device_us16']:.3f} of the bound "
          f"{bounds['carry16'][0] * 1e3:.2f} us, {bounds['carry16'][2] / 1e6:.1f} MB; "
          f"{bounds['dense16'][0] * 1e3 / t['device_us16']:.3f} of the dense "
          f"{bounds['dense16'][0] * 1e3:.2f} us), first "
          f"chunk {t['first_device_us16']:.2f} us (bound {bounds['first16'][0] * 1e3:.2f} us) "
          f"[{card}]")


def time_gram(kernels, lib, stream, sel_run, main_err, device, card):
    """``pairwise_cosine`` at the stage-3 shape (100, 1024), the reference
    kernel bench's (256, 4096) and the fleet's N with the default sketch
    (20,000, 1,024): the C entry point on normalized rows with a preallocated
    output and scratch (the symmetric form, as the wrapper plans it),
    cycling operand copies that exceed the 50 MB L2; the wrapper; the plain
    version; and one ``torch.mm(xn, xn.T)`` (cuBLAS SGEMM, TF32 off)."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.pairwise_cosine import (_normalize, pairwise_cosine,
                                                     pairwise_cosine_plain, plan)

    rows = {}
    for n, d, copies, iters in ((100, 1024, 160, 200), (256, 4096, 16, 200),
                                (20_000, 1024, 1, 5)):
        xs = [gram_rows(n, d, torch.float32, device, 500 + i) for i in range(copies)]
        xns = [_normalize(x) for x in xs]
        out = torch.empty((n, n), dtype=torch.float32, device=device)
        tm, splits, tiles = plan(n, n, d, True)
        scratch = torch.empty((tiles * splits * (16 * tm) ** 2 if splits > 1 else 1,),
                              dtype=torch.float32, device=device)
        arrivals = kbuild.counters(device, "gram_nt", tiles)
        it = {"i": 0}

        def nxt(seq):
            it["i"] = (it["i"] + 1) % len(seq)
            return seq[it["i"]]

        def launch():
            xn = nxt(xns)
            kbuild.check(lib.gram_nt_launch(xn.data_ptr(), xn.data_ptr(), n, n, d, 1, tm, splits,
                                            4, out.data_ptr(), scratch.data_ptr(),
                                            arrivals.data_ptr(), stream), "gram_nt")

        def library():
            xn = nxt(xns)
            return torch.mm(xn, xn.T)

        warm = 1 if iters < 20 else 10
        t = {}
        for _ in range(2):  # the first pass warms up, the second is kept
            t = {"kernel": time_ms(launch, iters, warm),
                 "wrapper": time_ms(lambda: pairwise_cosine(nxt(xs)), iters, warm),
                 "plain": time_ms(lambda: pairwise_cosine_plain(nxt(xs)), iters, warm),
                 "library": time_ms(library, iters, warm)}
        # x = x: the Gram is symmetric, so the work is its N(N+1)/2 distinct
        # dot products of 2D flops each; the kernel computes all N^2 of them
        flops = n * (n + 1) * d
        b_ms, b_by = bound(n * d * 4 + n * n * 4, flops)
        t.update(bound=b_ms, bound_by=b_by, flops=flops)
        rows[(n, d)] = t
        if copies > 1:  # small shapes: the device time per call under the profiler
            dev_us = {name: device_us_per_call(fn) for name, fn in
                      (("kernel", launch), ("torch.mm", library))}
            print(f"pairwise_cosine N={n} D={d} device time per call (profiler): kernel "
                  f"{dev_us['kernel']:.2f} us, torch.mm {dev_us['torch.mm']:.2f} us [{card}]")
        print(f"pairwise_cosine N={n} D={d} ({16 * tm}x{16 * tm} tiles, {tiles} of them, D in "
              f"{splits}): kernel {t['kernel'] * 1e3:.2f} us "
              f"({flops / (t['kernel'] * 1e-3) / 1e12:.2f} useful TFLOP/s), wrapper "
              f"{t['wrapper'] * 1e3:.2f} us, plain {t['plain'] * 1e3:.2f} us, torch.mm "
              f"{t['library'] * 1e3:.2f} us ({flops / (t['library'] * 1e-3) / 1e12:.2f} "
              f"useful TFLOP/s), bound {b_ms * 1e3:.3f} us ({b_by}: {flops / 1e6:.1f} MFLOP, "
              f"{(n * d * 4 + n * n * 4) / 1e6:.2f} MB) [{card}]")
        del xs, xns, out, scratch
        torch.cuda.empty_cache()
    t = rows[(100, 1024)]
    kernels.append({
        "name": "pairwise_cosine", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pairwise_cosine.cu",
        "replaces": "src/repro/kernels/pairwise_cosine.py:54",
        "launches": sel_run["launches"]["pairwise_cosine"],
        "max_abs_err": main_err["pairwise_cosine"], "ms": t["kernel"], "plain_ms": t["plain"],
        "bound_ms": t["bound"], "bound_by": t["bound_by"], "library_ms": t["library"],
    })


def _cycle(xs):
    """A function that returns the next of ``xs`` on each call, round and round."""
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(xs)
        return xs[it["i"]]

    return nxt


def time_swa(lib, stream, B, C, hkv, G, D, window, softcap, fills, device, card) -> dict:
    """``swa_decode`` (bf16) at one decode shape: the C entry point with
    preallocated outputs, cycling operand copies that together exceed the
    50 MB L2 (each layer reads its own cache), the plain version, and one
    ``scaled_dot_product_attention`` call with the same boolean mask (GQA
    through ``enable_gqa``); CUDA events and profiled device time.  -> the
    times in ms and the bound."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.swa_decode import (scratch_numel, split_len, swa_decode_plain,
                                                vector_bytes)

    F = torch.nn.functional
    dtype = torch.bfloat16
    set_bytes = 2 * B * C * hkv * D * 2
    n_copies = max(2, -(-100_000_000 // set_bytes))
    sets = [swa_operands(B, C, hkv, G, D, dtype, fills, device, seed=i)
            for i in range(n_copies)]
    out = torch.empty((B, hkv, G, D), dtype=torch.float32, device=device)
    sqrt_d = float(torch.sqrt(torch.tensor(D, dtype=torch.float32)))
    scratch = torch.empty((scratch_numel(B, C, hkv, G, D, 2),), dtype=torch.float32,
                          device=device)
    arrivals = kbuild.counters(device, "swa_decode", B * hkv)
    split, vec = split_len(D, 2), vector_bytes(D, 2, *sets[0][1:3])
    nxt = _cycle(sets)

    def swa_launch():
        q, k, v, kv_pos, pos = nxt()
        kbuild.check(lib.swa_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(), pos.data_ptr(),
            B, C, hkv, G, D, window, softcap, sqrt_d, 1, split, vec, out.data_ptr(),
            scratch.data_ptr(), arrivals.data_ptr(), stream), "swa_decode")

    def swa_plain():
        return swa_decode_plain(*nxt(), window, softcap)

    def visible(kv_pos, pos):
        vis = (kv_pos >= 0) & (kv_pos <= pos[:, None])
        return vis & (pos[:, None] - kv_pos < window) if window > 0 else vis

    # the library call's operands: heads-major views of the same cache and the
    # visibility mask, made once (the mask is an input of the call); SDPA has no
    # softcap, so at softcap > 0 it times the uncapped attention
    lib_sets = [(q.reshape(B, hkv * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
                 visible(kv_pos, pos)[:, None, None, :]) for q, k, v, kv_pos, pos in sets]
    nxt_lib = _cycle(lib_sets)

    def swa_library():
        q, k, v, mask = nxt_lib()
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    t = {}
    for _ in range(2):  # the first pass warms up, the second is kept
        t = {"kernel": time_ms(swa_launch), "plain": time_ms(swa_plain, iters=50, warmup=5),
             "library": time_ms(swa_library)}
    dev_us = {"kernel": device_us_per_call(swa_launch),
              "scaled_dot_product_attention": device_us_per_call(swa_library)}
    q, k, v, kv_pos, pos = sets[0]
    vis = int(visible(kv_pos, pos).sum())
    isz = k.element_size()
    swa_bytes = (q.numel() * isz + 2 * k.numel() * isz + kv_pos.numel() * 4 + B * 4
                 + out.numel() * 4)
    # per visible slot and query head: a D-long dot and a D-long p * v (4 D
    # flops) and ~4 for the scale, exp and sums (~2 more for a softcap's divide
    # and tanh); per query head D divides
    swa_flops = vis * hkv * G * (4 * D + 4 + (2 if softcap > 0 else 0)) + B * hkv * G * D
    b_ms, b_by = bound(swa_bytes, swa_flops)
    what = (f"swa_decode B={B} C={C} Hkv={hkv} G={G} D={D} window={window} "
            f"softcap={softcap} bf16 ({-(-C // split)} splits of {split} slots, {vec}-byte "
            f"copies)")
    print(f"{what}: kernel {t['kernel'] * 1e3:.2f} us "
          f"({swa_bytes / (t['kernel'] * 1e-3) / 1e9:.0f} GB/s), "
          f"plain {t['plain'] * 1e3:.2f} us, scaled_dot_product_attention "
          f"{t['library'] * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}: "
          f"{swa_bytes / 1e6:.2f} MB, {swa_flops / 1e6:.1f} MFLOP) [{card}]")
    print(f"  device time per call (profiler): kernel {dev_us['kernel']:.2f} us "
          f"({swa_bytes / (dev_us['kernel'] * 1e-6) / 1e9:.0f} GB/s), "
          f"scaled_dot_product_attention {dev_us['scaled_dot_product_attention']:.2f} us "
          f"[{card}]")
    return {"ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t["library"]}


def time_ssd(lib, stream, Bz, S, nh, hp, ds, Q, device, card) -> dict:
    """``ssd_scan`` (bf16) at one prefill shape: the C entry point with
    preallocated outputs on two operand sets in turns, and the plain version;
    CUDA events and profiled device time.  The bound counts the products at
    the TF32 tensor-core rate and the rest at the fp32 rate.  -> the times in
    ms and the bound."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.ssd_scan import counter_count, smem_bytes, ssd_scan_plain

    dtype = torch.bfloat16
    ssd_sets = [ssd_operands(Bz, S, nh, hp, ds, dtype, device, seed=i) for i in range(2)]
    y = torch.empty((Bz, S, nh, hp), dtype=torch.float32, device=device)
    h = torch.empty((Bz, nh, hp, ds), dtype=torch.float32, device=device)
    smem = smem_bytes(Q, hp, ds, 2)
    chain = kbuild.counters(device, "ssd_scan", counter_count(Bz, nh))
    nxt = _cycle(ssd_sets)

    def ssd_launch():
        x, dt, A, Bs, Cs, _ = nxt()
        kbuild.check(lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bs.data_ptr(), Cs.data_ptr(), None,
            Bz, S, nh, hp, ds, Q, smem, 1, y.data_ptr(), h.data_ptr(), chain.data_ptr(),
            stream), "ssd_scan")

    def ssd_plain():
        x, dt, A, Bs, Cs, _ = nxt()
        return ssd_scan_plain(x, dt, A, Bs, Cs, Q)

    ts = {}
    for _ in range(2):
        ts = {"kernel": time_ms(ssd_launch, iters=20, warmup=3),
              "plain": time_ms(ssd_plain, iters=5, warmup=2)}
    ssd_dev = device_us_per_call(ssd_launch)
    x, dt, A, Bs, Cs, _ = ssd_sets[0]
    isz = x.element_size()
    ssd_bytes = (x.numel() * isz + dt.numel() * 4 + A.numel() * 4 + 2 * Bs.numel() * isz
                 + y.numel() * 4 + h.numel() * 4)
    # per chunk of qc steps (t = qc (qc + 1) / 2 pairs k <= q), the products: C . B
    # once per batch row (t ds multiply-adds); per head the masked product (t hp),
    # the carried state's share and the state update (qc hp ds each); the rest, per
    # head: x * w (qc hp) and M's scale (3 t)
    products = rest = 0
    for c0 in range(0, S, Q):
        qc = min(Q, S - c0)
        tri = qc * (qc + 1) // 2
        products += Bz * 2 * tri * ds + Bz * nh * (2 * tri * hp + 4 * qc * hp * ds)
        rest += Bz * nh * (qc * hp + 3 * tri)
    ssd_flops = products + rest
    t_ops = (products / TF32_FLOPS_PER_S + rest / FP32_FLOPS_PER_S) * 1e3
    t_bytes = ssd_bytes / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    fp32_ms, _ = bound(0.0, ssd_flops)
    print(f"ssd_scan B={Bz} S={S} nh={nh} hp={hp} ds={ds} Q={Q} bf16: kernel "
          f"{ts['kernel'] * 1e3:.1f} us, plain {ts['plain'] * 1e3:.1f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}: {ssd_bytes / 1e6:.1f} MB; {ssd_flops / 1e9:.2f} GFLOP "
          f"take {t_ops * 1e3:.2f} us with the products on the TF32 tensor cores, "
          f"{fp32_ms * 1e3:.2f} us all on the fp32 cores; "
          f"{ssd_flops / (ts['kernel'] * 1e-3) / 1e12:.2f} TFLOP/s achieved) [{card}]")
    print(f"  device time per call (profiler): kernel {ssd_dev:.2f} us "
          f"({ssd_bytes / (ssd_dev * 1e-6) / 1e9:.0f} GB/s) [{card}]")
    return {"ms": ts["kernel"], "plain_ms": ts["plain"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


# The serving kernels' shapes in the ssm, dense, moe, vlm and encdec families'
# runs (FAMILY_RUNS, MOE_VLM_RUNS, ENCDEC_RUNS): B7 on the cache after
# ``kv_repeat`` at the last decode step, B8 at the prefill.
FAMILY_SWA_SHAPES = {  # arch: (B, C, Hkv, G, D, window, softcap, fills)
    "qwen1.5-0.5b": (4, 2080, 16, 1, 64, 0, 0.0, (2079,) * 4),
    "gemma2-9b local": (2, 4096, 16, 1, 256, 4096, 50.0, (4175,) * 2),
    "gemma2-9b global": (2, 4176, 16, 1, 256, 0, 50.0, (4175,) * 2),
    "mistral-nemo-12b / chatglm3-6b": (2, 520, 16, 2, 128, 0, 0.0, (519,) * 2),
    "mixtral-8x7b": (2, 4096, 16, 2, 128, 4096, 0.0, (4175,) * 2),
    "phi3.5-moe-42b-a6.6b": (4, 2080, 16, 2, 128, 0, 0.0, (2079,) * 4),
    "internvl2-76b": (2, 784, 16, 4, 128, 0, 0.0, (783,) * 2),
    "whisper-small self": (4, 64, 12, 1, 64, 0, 0.0, (95,) * 4),
    "whisper-small cross": (4, 1500, 12, 1, 64, 0, 0.0, (1500,) * 4),
}
FAMILY_SSD_SHAPES = {"mamba2-130m": (4, 2048, 24, 64, 128, 128)}


def time_serving_kernels(kernels, lib, stream, serve_launches, main_err, device, card):
    """``swa_decode`` at hymba-1.5b's decode and ``ssd_scan`` at its prefill
    (bf16), the kernels' JSON rows; then each at the other families' shapes
    (``FAMILY_SWA_SHAPES``, ``FAMILY_SSD_SHAPES``), printed beside them."""
    print("hymba-1.5b's serving shapes (the kernels line):")
    kernels.append(dict(
        name="swa_decode", route="cuda", source="src/repro_torch/kernels/csrc/swa_decode.cu",
        replaces="src/repro/kernels/swa_decode.py:114",
        launches=serve_launches["swa_decode"], max_abs_err=main_err["swa_decode"],
        **time_swa(lib, stream, 4, 1024, 5, 5, 64, 1024, 0.0, (2080,) * 4, device, card)))
    kernels.append(dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:124",
        launches=serve_launches["ssd_scan"], max_abs_err=main_err["ssd_scan"],
        **time_ssd(lib, stream, 4, 2048, 50, 64, 16, 128, device, card)))
    for arch, shape in FAMILY_SWA_SHAPES.items():
        print(f"{arch}'s decode shape:")
        time_swa(lib, stream, *shape, device, card)
    for arch, shape in FAMILY_SSD_SHAPES.items():
        print(f"{arch}'s prefill shape:")
        time_ssd(lib, stream, *shape, device, card)
    torch.cuda.empty_cache()


# card vs CPU tolerances of a bf16 round: the clients' forward passes run in
# bf16, and cuBLAS and the CPU's GEMMs round a product at other places, so an
# update row may differ by a bf16 ulp (~4e-6 at |u| ~ 1e-3) that the server
# step carries on: the model after one round by 1e-4 (10x what that gives),
# by 2e-3 under fedadam (its step magnifies a delta's error up to (1 - beta1)
# / tau = 100) and with a bf16 master (one bf16 ulp at |params| ~ 0.15 is
# 9.8e-4); the moments and the bf16 ring within two bf16 ulps (2^-6) and
# 1e-5; test accuracy by 4 of the 2,000 test images, test loss rtol 1e-3
BF16_REPLAY = dict(acc_atol=2e-3, leaf_tol=(2 * BF16_ULP, 1e-5), loss_rtol=1e-3)


def bf16_lane(fl, traffic, fp32_records, fleet_runs, device, card):
    """``fl_sim --dtype bfloat16``: the main path for ROUNDS rounds, then its
    aggregator lanes (fedadam and stale 1 round, fedbuff ROUNDS rounds, which
    must park and drain), the streamed two-tier lane (fedbuff, 3 rounds) and
    fedadam with a bf16 master (2 rounds), each with its launch counts and
    its first round replayed on the CPU's plain path; then one fleet round
    at N = 100,000 with its peak memory beside the fp32 fleet round's.
    -> (sims, launches) by lane."""
    from repro_torch.configs import get_config
    from repro_torch.fl.simulation import FLSimulation
    from repro_torch.utils import prng

    phase("bf16 lane: fl_sim --dtype bfloat16, ring / contextual / mnist, N=100, on cuda")
    fl16 = dataclasses.replace(fl, compute_dtype="bfloat16")
    sims, launches = {}, {}
    for label, agg, kw, server, n_rounds, atol in (
            ("fedavg", "fedavg", {}, "fedavg_reduce", ROUNDS, 1e-4),
            ("fedadam", "fedadam", dict(connection_rate=0.7), "server_update", 1, 2e-3),
            ("stale", "stale", dict(connection_rate=0.7), "server_update", 1, 1e-4),
            ("fedbuff", "fedbuff", dict(connection_rate=0.7), "server_update_buffered", ROUNDS,
             1e-4),
            ("streamed ring/fedbuff", "fedbuff",
             dict(connection_rate=0.7, hierarchical=True, client_block=4),
             "server_update_buffered", 3, 1e-4),
            ("fedadam, bf16 master", "fedadam",
             dict(connection_rate=0.7, param_dtype="bfloat16"), "server_update", 2, 2e-3)):
        fl_l = dataclasses.replace(fl16, aggregator=agg, **kw)
        rsu = -(-fl_l.n_select // fl_l.client_block) if fl_l.client_block else 0
        sim_l = FLSimulation(get_config("fl-mnist-mlp"), fl_l, traffic, "mnist", "contextual",
                             prng.key(0), device=device)
        st = sim_l.state
        if st.buf_delta.dtype != torch.bfloat16 or st.opt_m.dtype != torch.float32 or \
                st.params.dtype != getattr(torch, fl_l.param_dtype):
            raise AssertionError(f"bf16 {label}: carry dtypes {st.params.dtype} "
                                 f"{st.opt_m.dtype} {st.buf_delta.dtype}")
        print(f"-- bf16 {label} ({server}), {n_rounds} round(s), params {st.params.dtype}")
        states, recs, launches[label] = drive(sim_l, server, rsu_per_round=rsu,
                                              rounds=n_rounds)
        if label == "fedbuff" and not (sum(r.n_buffered for r in recs)
                                       and sum(r.n_drained for r in recs)):
            raise AssertionError("bf16 fedbuff: the bf16 ring neither parked nor drained")
        replay(sim_l, states[0], recs[0], traffic, params_atol=atol, **BF16_REPLAY)
        sims[label] = sim_l
        if label == "fedavg":
            main_recs = recs
    print(f"main path accuracy after {ROUNDS} rounds: fp32 {fp32_records[-1].test_acc:.4f}, "
          f"bf16 {main_recs[-1].test_acc:.4f}; mean predicted latency of round 1: fp32 "
          f"{fp32_records[0].mean_pred_latency:.4f} s, bf16 {main_recs[0].mean_pred_latency:.4f} "
          f"s (the bf16 upload is half the bytes)")

    n = max(fleet_runs)  # the fleet phase's largest, 100,000
    fl_f, traffic_f, _, fp32_peak = fleet_runs[n]
    phase(f"bf16 lane: a fleet round at N={n}, hierarchical, client_block=32, no warm-up")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sim_f = FLSimulation(get_config("fl-mnist-mlp"), dataclasses.replace(
        fl_f, compute_dtype="bfloat16"), traffic_f, "mnist", "contextual", prng.key(0),
                         device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    held_round = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    rec = sim_f.run_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["fleet"] = read_launches()
    round_peak = torch.cuda.max_memory_allocated() - held_round
    n_chunks = -(-fl_f.n_select // fl_f.client_block)
    print(json.dumps(rec.__dict__), f"wall {wall * 1e3:.1f} ms")
    print(f"bf16 fleet N={n}: set-up {setup_s:.2f} s (peak {setup_peak / 2**30:.3f} GiB above "
          f"the {held / 2**30:.2f} GiB held); peak memory in the round {round_peak / 2**30:.3f} "
          f"GiB ({round_peak / 2**20:.1f} MiB), the fp32 fleet round's in this call "
          f"{fp32_peak / 2**30:.3f} GiB ({fp32_peak / 2**20:.1f} MiB); launches "
          f"{launches['fleet']} [{card}]")
    want = dict.fromkeys(launches["fleet"], 0)
    want.update(rttg_latency=2, rsu_reduce=n_chunks, fedavg_reduce=1)
    if launches["fleet"] != want:
        raise AssertionError(f"bf16 fleet: expected {want}, got {launches['fleet']}")
    check_records(sim_f.state, [rec])
    del sim_f
    torch.cuda.empty_cache()
    return sims, launches


# benchmarks/engine_throughput.py's timed grid (``_run``, ``async_lane``,
# ``precision_lane``): 3 strategies x seed 0 x the 8 catalog scenarios, N = 20
GRID_STRATEGIES = ("contextual", "gossip", "network")
GRID_SCENARIOS = ("ring", "highway", "urban_grid", "rush_hour", "rsu_outage", "platoon",
                  "hetero_fleet", "day_cycle")
GRID_ROUNDS = GRID_EVAL_EVERY = 5
# card vs CPU over a lane's 5 rounds: the engine tests' tolerance (the
# reference's own scan-vs-loop one), rtol 2e-4, atol 1e-5; the bf16 lane's test
# accuracy and loss as ``BF16_REPLAY``'s
GRID_TOL = dict(rtol=2e-4, atol=1e-5, acc_atol=1e-5, loss_rtol=2e-4)
BF16_GRID_TOL = dict(GRID_TOL, acc_atol=BF16_REPLAY["acc_atol"],
                     loss_rtol=BF16_REPLAY["loss_rtol"])


def grid_fl(**kw):
    """``engine_throughput.py::_grid_cfgs``' FLConfig (N = 20, 64 samples),
    ``kw`` replacing or adding fields."""
    from repro_torch.config import FLConfig

    return FLConfig(**{**dict(num_clients=20, samples_per_client=64, batch_size=32,
                              num_clusters=5, local_epochs=1), **kw})


def smoke_fl():
    """``engine_throughput.py::smoke``'s FLConfig at the bench's N = 20 (its
    ``--clients``): 32 samples, batches of 16, 4 clusters, CR 1.0 (K = 2)."""
    from repro_torch.config import FLConfig

    return FLConfig(num_clients=20, samples_per_client=32, batch_size=16, num_clusters=4,
                    local_epochs=1)


@dataclasses.dataclass(frozen=True)
class Grid:
    """A grid of phase 4h: its axes (seed 0), rounds and eval schedule."""

    strategies: tuple
    aggregators: tuple
    scenarios: tuple = GRID_SCENARIOS
    rounds: int = GRID_ROUNDS
    eval_every: int = GRID_EVAL_EVERY
    chunks: int = 0  # the streamed two-tier lanes' chunks a round (0: not streamed)

    def runs(self) -> list:
        return [(st, a, 0, sc) for st in self.strategies for a in self.aggregators
                for sc in self.scenarios]

    def lane_rounds(self) -> int:
        return len(self.runs()) * self.rounds

    def batched_want(self, server: str) -> dict:
        """A batched sweep's launches: 2 B1g, one B5g a chunk and one
        ``server`` a grid round, whatever G."""
        want = {"rttg_latency_grid": 2 * self.rounds, server: self.rounds}
        return {**want, "rsu_reduce_grid": self.chunks * self.rounds} if self.chunks else want

    def loop_want(self, server: str) -> dict:
        """A lane-loop sweep's launches: 2 B1, one B5 a chunk and one
        ``server`` a lane-round."""
        want = {"rttg_latency": 2 * self.lane_rounds(), server: self.lane_rounds()}
        return {**want, "rsu_reduce": self.chunks * self.lane_rounds()} if self.chunks else want


BENCH = Grid(GRID_STRATEGIES, ("fedavg",))
ASYNC = Grid(GRID_STRATEGIES, ("fedbuff",))
# engine_throughput.py::smoke: contextual x the whole registry x the catalog, 1
# round; and the same without fedbuff, whose lanes take B3g instead of B4g
RULES = ("fedavg", "fedavgm", "fedadam", "fedyogi", "stale", "fedbuff")
SMOKE = Grid(("contextual",), RULES, rounds=1, eval_every=1)
SMOKE_SYNC = Grid(("contextual",), RULES[:-1], rounds=1, eval_every=1)
# the two-tier grids: engine_throughput.py::smoke's hierarchical probe
# (client_block=3, no warm-up; K = 2, one chunk with a padding slot), and a
# streamed grid at N = 100 (K = 10 in 3 chunks of 4, the last padded by 2)
SMOKE_HIER = Grid(("contextual",), RULES, scenarios=("rush_hour", "rsu_outage"), rounds=1,
                  eval_every=1, chunks=1)
STREAMED_HIER = Grid(("contextual",), ("fedavg",), rounds=3, eval_every=3, chunks=3)


def grid_sweeps(eng, grid: Grid, want: dict, n_warm: int, card: str):
    """A cold and ``n_warm`` warm sweeps of ``grid``, each with its launch
    counts zeroed just before and read just after: exactly ``want`` (a
    sweep's launches by kernel), nothing else.
    -> (the first result, the walls (cold first), one sweep's launches)."""
    walls, first = [], None
    for _ in range(1 + n_warm):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run_grid(seeds=(0,), scenarios=grid.scenarios, rounds=grid.rounds,
                           strategies=grid.strategies, aggregators=grid.aggregators,
                           eval_every=grid.eval_every)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = read_launches()
        expected = dict.fromkeys(launches, 0)
        expected.update(want)
        if launches != expected:
            raise AssertionError(f"engine grid: expected {expected}, got {launches}")
        first = first or res
    acc = first.final_accuracy()
    if not all(math.isfinite(a) for a in acc.values()):
        raise AssertionError(f"engine grid: a lane's final accuracy is not finite: {acc}")
    print(f"{len(first.runs)} lanes x {grid.rounds} rounds "
          f"({'batched round' if eng.batched else 'lane loop'}): "
          f"walls (cold first) {', '.join(f'{w:.3f}' for w in walls)} s "
          f"({grid.lane_rounds() / walls[-1]:.2f} lane-rounds/s in the last); launches a sweep "
          f"{ {k: v for k, v in launches.items() if v} }; final accuracy "
          f"{min(acc.values()):.4f}-{max(acc.values()):.4f} [{card}]")
    return first, walls, launches


def grid_vs_loop(eng, grid: Grid, res, tol, server: str, card):
    """The batched grid against the card's lane loop on the same lanes
    (``_lane_list`` set-up, per-lane warm-up, one lane after another, one
    ``server`` launch a lane-round): integers equal, floats within ``tol``,
    NaN alike, every lane.  -> the loop's set-up and round-loop walls."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = eng._lane_list(grid.runs())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop = eng._sweep(lanes, grid.rounds, grid.eval_every)
    torch.cuda.synchronize()
    wall = {"setup_s": t1 - t0, "rounds_s": time.perf_counter() - t1}
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want.update(grid.loop_want(server))
    if launches != want:
        raise AssertionError(f"lane loop: expected {want}, got {launches}")
    worst = 0.0
    for f in loop._fields:
        a, b = getattr(res.metrics, f), getattr(loop, f)
        if f in ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained"):
            if not torch.equal(a, b):
                raise AssertionError(f"batched vs loop: {f} differs in lanes "
                                     f"{torch.nonzero((a != b).any(1)).flatten().tolist()}")
            continue
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"batched vs loop: {f} NaNs differ")
        rtol = tol["loss_rtol"] if f == "test_loss" else tol["rtol"]
        atol = tol["acc_atol"] if f == "test_acc" else tol["atol"]
        a, b = a.nan_to_num(), b.nan_to_num()
        over = (a - b).abs() / (atol + rtol * b.abs())
        worst = max(worst, float(over.max()))
    if worst > 1.0:
        raise AssertionError(f"batched vs loop: a float differs by {worst:.3f} of the tolerance")
    print(f"batched grid vs the lane loop on the card, {len(grid.runs())} lanes x {grid.rounds} "
          f"rounds: integers equal, floats within the tolerance (worst {worst:.3f} of it); the "
          f"loop's set-up {wall['setup_s']:.3f} s and {grid.rounds} rounds "
          f"{wall['rounds_s']:.3f} s with {launches['rttg_latency']} B1, "
          f"{launches['rsu_reduce']} B5 and {launches[server]} {server} launches [{card}]")
    return wall


def check_records_close(got, want, tol, what) -> float:
    """Round records (``RoundRecord`` or their dicts) card vs CPU: integers
    equal, floats within ``tol`` (``GRID_TOL``'s keys), NaN alike.  -> the
    worst float's share of its tolerance."""
    worst = 0.0
    for a, b in zip(got, want):
        a = a if isinstance(a, dict) else dataclasses.asdict(a)
        b = b if isinstance(b, dict) else dataclasses.asdict(b)
        for f, y in b.items():
            x = a[f]
            if f in ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained"):
                if x != y:
                    raise AssertionError(f"{what} round {b['round']}: {f} card {x} vs cpu {y}")
                continue
            if math.isnan(x) or math.isnan(y):
                if not (math.isnan(x) and math.isnan(y)):
                    raise AssertionError(f"{what} round {b['round']}: {f} {x} vs {y} (NaN)")
                continue
            rtol = tol["loss_rtol"] if f == "test_loss" else tol["rtol"]
            atol = tol["acc_atol"] if f == "test_acc" else tol["atol"]
            if not math.isclose(x, y, rel_tol=rtol, abs_tol=atol):
                raise AssertionError(f"{what} round {b['round']}: {f} card {x} vs cpu {y}")
            worst = max(worst, abs(x - y) / (atol + rtol * abs(y)))
    return worst


def lane_vs_cpu(res, eng, grid: Grid, lane, tol, card) -> float:
    """One lane of the card's grid against the same lane on the CPU's plain
    path (``run_single`` of a CPU engine of the same strategies, registry and
    config): integers equal, floats within ``tol``, NaN alike.  ``lane``'s
    data row must be its own scenario's (``run_single`` builds its own):
    any lane but a platoon one whose row came from another scenario."""
    from repro_torch.fl import ExperimentEngine

    strategy, aggregator, seed, scenario = lane
    cpu = ExperimentEngine(eng.api.cfg, eng.fl, eng.dataset, strategies=eng.strategies,
                           aggregators=eng.aggregators, warmup=eng.warmup_enabled, device="cpu")
    want = cpu.run_single(strategy, seed, scenario, rounds=grid.rounds,
                          eval_every=grid.eval_every, aggregator=aggregator)
    got = res.records(strategy, seed, scenario, aggregator=aggregator)
    worst = check_records_close(got, want, tol, str(lane))
    print(f"{lane}: {grid.rounds} round(s) on the card vs the CPU's plain path: integers equal, "
          f"floats within the tolerance (worst {worst:.3f} of it) [{card}]")
    return worst


def sync_check(eng, grid: Grid, card) -> dict:
    """The warm sweep's round loop (``ExperimentEngine._sweep``, lanes built
    outside it) under ``torch.cuda.set_sync_debug_mode("error")``.  If an
    operation synchronizes, print the first, then run the loop again under
    ``"warn"`` and count the warnings by source line."""
    import collections
    import traceback
    import warnings

    runs = grid.runs()
    lanes = eng._lanes(runs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._sweep(lanes, grid.rounds, grid.eval_every)
        first = None
    except RuntimeError as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__) if "repro_torch" in f.filename]
        where = frames[-1] if frames else traceback.extract_tb(e.__traceback__)[-1]
        first = (f"{os.path.relpath(where.filename, ROOT)}:{where.lineno} "
                 f"({where.line.strip()}): {str(e).splitlines()[0]}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if first is None:
        print(f"sync check: the round loop ran {grid.rounds} rounds of {len(runs)} lanes under "
              "set_sync_debug_mode('error') without a device-to-host sync")
        return {"mode": "error", "syncs": 0}
    print(f"sync check: set_sync_debug_mode('error') trips in the round core: {first}")
    lanes = eng._lanes(runs)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng._sweep(lanes, grid.rounds, grid.eval_every)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = collections.Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                                for w in syncs)
    # the round core's own syncs: any outside the host keys and scalars of
    # utils/prng.py
    core_sites = {k: v for k, v in sites.items() if "utils/prng.py" not in k}
    print(f"sync check under 'warn': {len(syncs)} synchronizing operations in "
          f"{grid.lane_rounds()} lane-rounds ({len(syncs) / grid.lane_rounds():.2f} a "
          f"lane-round); by source line: {dict(sites.most_common())}; outside utils/prng.py: "
          f"{core_sites} [{card}]")
    if core_sites:
        raise AssertionError(f"the batched round synchronizes outside utils/prng.py: "
                             f"{core_sites}")
    return {"mode": "warn", "first": first, "syncs": len(syncs), "sites": dict(sites)}


def engine_phase(device, card) -> dict:
    """Phase 4h: ``benchmarks/engine_throughput.py``'s grids through
    ``ExperimentEngine`` on the card.  -> the launch counts of one sweep of
    each grid, by grid."""
    from repro_torch.configs import get_config
    from repro_torch.core.scenarios import scenario_config
    from repro_torch.fl import ExperimentEngine, FLSimulation
    from repro_torch.utils import prng

    model = get_config("fl-mnist-mlp")
    runs = BENCH.runs()
    lane_rounds = BENCH.lane_rounds()
    summary, launches = {"card": card}, {}

    phase("engine: the bench's 24-run grid (3 strategies x 8 scenarios, N=20, 5 rounds, "
          "eval every 5, ('fedavg',)) through ExperimentEngine on cuda, the batched round")
    fl = grid_fl()
    eng = ExperimentEngine(model, fl, "mnist", strategies=GRID_STRATEGIES,
                           aggregators=("fedavg",), device=device)
    if not eng.batched:
        raise AssertionError("the ('fedavg',) grid engine did not take the batched round")
    res, walls, launches["fedavg"] = grid_sweeps(eng, BENCH,
                                                 BENCH.batched_want("fedavg_reduce_grid"), 1, card)
    summary.update(cold_s=walls[0], warm_s=walls[1], rounds_per_s=lane_rounds / walls[1])
    split = {"loop": grid_vs_loop(eng, BENCH, res, GRID_TOL, "fedavg_reduce", card)}
    for lane in (("contextual", "fedavg", 0, "ring"), ("network", "fedavg", 0, "platoon")):
        lane_vs_cpu(res, eng, BENCH, lane, GRID_TOL, card)

    phase("engine: the same 24 runs through FLSimulation on cuda (the bench's serial_s)")
    serial, serial_acc = [], {}
    for _ in range(2):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for st in GRID_STRATEGIES:
            for sc in GRID_SCENARIOS:
                sim = FLSimulation(model, fl, scenario_config(sc, num_vehicles=fl.num_clients),
                                   "mnist", st, prng.key(0), device=device)
                serial_acc[(st, sc)] = sim.run(GRID_ROUNDS)[-1].test_acc
        torch.cuda.synchronize()
        serial.append(time.perf_counter() - t0)
    sl = read_launches()
    want = dict.fromkeys(sl, 0)
    want.update(rttg_latency=2 * lane_rounds, fedavg_reduce=lane_rounds)
    if sl != want:
        raise AssertionError(f"FLSimulation sweep: expected {want}, got {sl}")
    # a data row's first lane (ring, platoon) is its simulation's run
    worst = max(abs(res.final_accuracy()[(st, "fedavg", 0, sc)] - serial_acc[(st, sc)])
                for st in GRID_STRATEGIES for sc in ("ring", "platoon"))
    if worst > GRID_TOL["atol"]:
        raise AssertionError(f"engine vs FLSimulation final accuracy differs by {worst}")
    summary.update(serial_cold_s=serial[0], serial_s=serial[1],
                   serial_rounds_per_s=lane_rounds / serial[1])
    print(f"FLSimulation, the same {len(runs)} runs (eval every round): cold {serial[0]:.3f} s, "
          f"warm {serial[1]:.3f} s "
          f"({summary['serial_rounds_per_s']:.1f} lane-rounds/s; engine "
          f"{summary['rounds_per_s']:.1f}); final accuracy of the rows' first lanes within "
          f"{worst:.2e} of the engine's [{card}]")

    phase("engine: the batched set-up and round loop timed apart, then one grid round "
          "profiled, batched, lane loop and batched (24 lanes, no eval)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = eng._lanes(runs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng._sweep(batched, GRID_ROUNDS, GRID_EVAL_EVERY)
    torch.cuda.synchronize()
    split["batched"] = {"setup_s": t1 - t0, "rounds_s": time.perf_counter() - t1}
    summary["split"] = split
    print(f"set-up (lanes built and warmed up) / {GRID_ROUNDS} rounds: batched "
          f"{split['batched']['setup_s']:.3f} / {split['batched']['rounds_s']:.3f} s, lane loop "
          f"{split['loop']['setup_s']:.3f} / {split['loop']['rounds_s']:.3f} s [{card}]")
    loop = eng._lane_list(runs)
    profiles = {"batched": [], "loop": []}
    # one lane-loop profile: the profiler's ~110,000 events of a loop round
    # take over a minute to gather
    for which in ("batched", "loop", "batched"):
        lanes = batched if which == "batched" else loop
        profiles[which].append(profile_round(
            f"engine grid round ({which}), {len(runs)} lanes (N=20, K=2)",
            lambda lanes=lanes: eng._grid_round(lanes, False, False), card))
    summary["profiles"] = profiles
    del batched, loop, lanes

    phase("engine: the warm sweep's round loop under torch.cuda.set_sync_debug_mode")
    summary["sync"] = sync_check(eng, BENCH, card)

    phase("engine: async_lane's grid (('fedbuff',), CR 0.7) through ExperimentEngine, the "
          "batched round, then its lane loop")
    fl_a = grid_fl(connection_rate=0.7)
    eng_a = ExperimentEngine(model, fl_a, "mnist", strategies=GRID_STRATEGIES,
                             aggregators=("fedbuff",), device=device)
    if not eng_a.batched:
        raise AssertionError("the ('fedbuff',) grid engine did not take the batched round")
    res_a, walls, launches["async"] = grid_sweeps(
        eng_a, ASYNC, ASYNC.batched_want("server_update_buffered_grid"), 1, card)
    parked, drained = int(res_a.metrics.n_buffered.sum()), int(res_a.metrics.n_drained.sum())
    if not (parked and drained):
        raise AssertionError(f"async grid: {parked} parked, {drained} drained")
    print(f"async grid: {parked} updates parked, {drained} drained over the grid")
    loop_wall = grid_vs_loop(eng_a, ASYNC, res_a, GRID_TOL, "server_update_buffered", card)
    summary["async"] = dict(cold_s=walls[0], warm_s=walls[1], parked=parked, drained=drained,
                            loop=loop_wall)
    # the ring / platoon lane that parks most (each the first of its data row)
    firsts = [(st, "fedbuff", 0, sc) for st in GRID_STRATEGIES for sc in ("ring", "platoon")]
    lane = max(firsts, key=lambda r: int(res_a.metrics.n_buffered[res_a.runs.index(r)].sum()))
    lane_vs_cpu(res_a, eng_a, ASYNC, lane, GRID_TOL, card)
    batched_a = eng_a._lanes(ASYNC.runs())
    eng_a._sweep(batched_a, 2, 5)  # two rounds in: the ring holds updates
    summary["async"]["profiles"] = [profile_round(
        f"async grid round (batched), {len(ASYNC.runs())} lanes (N=20, K=2, Kb=8)",
        lambda: eng_a._grid_round(batched_a, False, False), card) for _ in range(2)]
    del batched_a
    phase("engine: the async grid's round loop under torch.cuda.set_sync_debug_mode")
    summary["async"]["sync"] = sync_check(eng_a, ASYNC, card)

    for grid, server, loop_server, name in (
            (SMOKE, "server_update_buffered_grid", "server_update_buffered", "smoke"),
            (SMOKE_SYNC, "server_update_grid", "server_update", "smoke_sync")):
        phase(f"engine: engine_throughput.py::smoke's grid at N=20 (contextual x "
              f"{len(grid.aggregators)} rules x 8 scenarios, 1 round), the batched round, "
              f"then its lane loop")
        eng_s = ExperimentEngine(model, smoke_fl(), "mnist", strategies=grid.strategies,
                                 aggregators=grid.aggregators, device=device)
        if not eng_s.batched:
            raise AssertionError(f"the {name} grid engine did not take the batched round")
        res_s, walls, launches[name] = grid_sweeps(eng_s, grid, grid.batched_want(server), 0,
                                                   card)
        loop_wall = grid_vs_loop(eng_s, grid, res_s, GRID_TOL, loop_server, card)
        summary[name] = dict(cold_s=walls[0], loop=loop_wall)
        if name == "smoke":  # one lane a rule on the CPU's plain path
            for rule, sc in zip(grid.aggregators, GRID_SCENARIOS):
                lane_vs_cpu(res_s, eng_s, grid, ("contextual", rule, 0, sc), GRID_TOL, card)

    phase("engine: precision_lane's grid (compute_dtype bfloat16, ('fedavg',))")
    fl_p = dataclasses.replace(fl, compute_dtype="bfloat16")
    eng_p = ExperimentEngine(model, fl_p, "mnist", strategies=GRID_STRATEGIES,
                             aggregators=("fedavg",), device=device)
    if eng_p.init_run("contextual", 0, "ring")[0].buf_delta.dtype != torch.bfloat16:
        raise AssertionError("precision grid: the lanes' update rows are not bf16")
    res_p, walls, launches["precision"] = grid_sweeps(
        eng_p, BENCH, BENCH.batched_want("fedavg_reduce_grid"), 0, card)
    summary["precision"] = dict(cold_s=walls[0])
    lane_vs_cpu(res_p, eng_p, BENCH, ("gossip", "fedavg", 0, "ring"), BF16_GRID_TOL, card)
    two_tier_grids(model, device, card, summary, launches)
    summary["launches"] = launches
    print(json.dumps({"engine_grid": summary}))
    return launches


def two_tier_grids(model, device, card, summary, launches) -> None:
    """Phase 4h's two-tier grids through the batched round: the reference's
    hierarchical smoke probe, then a streamed grid of three chunks, each
    cold and warm with its exact launches, against its lane loop on the
    card and two lanes on the CPU's plain path; the streamed grid's round
    profiled beside a lane-loop round, and its round loop's sync check."""
    from repro_torch.fl import ExperimentEngine

    phase("engine: engine_throughput.py::smoke's hierarchical probe at N=20 (contextual x 6 "
          "rules x rush_hour / rsu_outage, client_block=3, no warm-up, 1 round), the batched "
          "round, then its lane loop")
    fl_h = dataclasses.replace(smoke_fl(), hierarchical=True, client_block=3)
    eng_h = ExperimentEngine(model, fl_h, "mnist", strategies=SMOKE_HIER.strategies,
                             aggregators=SMOKE_HIER.aggregators, warmup=False, device=device)
    if not eng_h.batched or -(-eng_h.cohort_size // fl_h.client_block) != SMOKE_HIER.chunks:
        raise AssertionError("the hierarchical probe did not take the batched round in one "
                             "chunk")
    res_h, walls, launches["smoke_hier"] = grid_sweeps(
        eng_h, SMOKE_HIER, SMOKE_HIER.batched_want("server_update_buffered_grid"), 1, card)
    loop_wall = grid_vs_loop(eng_h, SMOKE_HIER, res_h, GRID_TOL, "server_update_buffered", card)
    summary["smoke_hier"] = dict(cold_s=walls[0], warm_s=walls[1], loop=loop_wall)
    for lane in (("contextual", "fedadam", 0, "rush_hour"),
                 ("contextual", "fedbuff", 0, "rsu_outage")):
        lane_vs_cpu(res_h, eng_h, SMOKE_HIER, lane, GRID_TOL, card)

    phase("engine: a streamed two-tier grid (contextual x ('fedavg',) x 8 scenarios, N=100, "
          "K=10 in 3 chunks of 4, 3 rounds, eval at the end), the batched round, then its "
          "lane loop")
    fl_s = grid_fl(num_clients=100, hierarchical=True, client_block=4)
    eng_s = ExperimentEngine(model, fl_s, "mnist", strategies=STREAMED_HIER.strategies,
                             aggregators=STREAMED_HIER.aggregators, device=device)
    if not eng_s.batched or -(-eng_s.cohort_size // fl_s.client_block) != STREAMED_HIER.chunks:
        raise AssertionError("the streamed two-tier grid did not take the batched round in 3 "
                             "chunks")
    res_s, walls, launches["streamed_hier"] = grid_sweeps(
        eng_s, STREAMED_HIER, STREAMED_HIER.batched_want("fedavg_reduce_grid"), 1, card)
    loop_wall = grid_vs_loop(eng_s, STREAMED_HIER, res_s, GRID_TOL, "fedavg_reduce", card)
    summary["streamed_hier"] = dict(cold_s=walls[0], warm_s=walls[1], loop=loop_wall)
    for lane in (("contextual", "fedavg", 0, "ring"), ("contextual", "fedavg", 0, "rsu_outage")):
        lane_vs_cpu(res_s, eng_s, STREAMED_HIER, lane, GRID_TOL, card)
    runs = STREAMED_HIER.runs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = eng_s._lanes(runs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng_s._sweep(batched, STREAMED_HIER.rounds, STREAMED_HIER.eval_every)
    torch.cuda.synchronize()
    summary["streamed_hier"]["batched"] = {"setup_s": t1 - t0,
                                           "rounds_s": time.perf_counter() - t1}
    print(f"streamed two-tier grid, set-up / {STREAMED_HIER.rounds} rounds: batched "
          f"{t1 - t0:.3f} / {summary['streamed_hier']['batched']['rounds_s']:.3f} s, lane loop "
          f"{loop_wall['setup_s']:.3f} / {loop_wall['rounds_s']:.3f} s [{card}]")
    loop = eng_s._lane_list(runs)
    profiles = {"batched": [], "loop": []}
    for which in ("batched", "loop", "batched"):
        lanes = batched if which == "batched" else loop
        profiles[which].append(profile_round(
            f"streamed two-tier grid round ({which}), {len(runs)} lanes (N=100, K=10 in 3 "
            f"chunks)", lambda lanes=lanes: eng_s._grid_round(lanes, False, False), card))
    summary["streamed_hier"]["profiles"] = profiles
    del batched, loop, lanes
    phase("engine: the streamed two-tier grid's round loop under torch.cuda.set_sync_debug_mode")
    summary["streamed_hier"]["sync"] = sync_check(eng_s, STREAMED_HIER, card)


# the CNN datasets' main path (phase 4i): launch_fl_sim.run_experiment's
# defaults for CIFAR-10 and SVHN (N = 100, K = 10, 256 samples, batches of 64,
# one local epoch, ("fedavg",), CR 1.0, fp32) for this many rounds
CNN_RUNS = (("cifar10", "fl-cifar10-cnn", 5), ("svhn", "fl-svhn-cnn", 3))
# card vs CPU after one CNN round: each client's 4 SGD steps sum every conv's
# and matmul's products in another order on each device (cuDNN vs the CPU's
# convolutions), ~1e-6 relative a step on updates of ~1e-2
CNN_REPLAY = dict(params_atol=1e-5, acc_atol=1e-3)  # test accuracy: 2 of the 2,000 images
CNN_BF16_ROUNDS = 3


def cnn_phase(fl, mnist_records, device, card) -> dict:
    """Phase 4i: the CNN datasets on the card.  ``FLSimulation`` at
    fl-cifar10-cnn (5 rounds) and fl-svhn-cnn (3 rounds) at full width with
    ``fl_sim``'s defaults, exactly 2 B1 and 1 B2 a round, each first round
    replayed (bitwise on the card, within ``CNN_REPLAY`` on the CPU) and a
    round profiled; the round-level contracts at CIFAR's width; the final
    accuracy of the three datasets side by side; the bench's 24-lane grid at
    fl-cifar10-cnn through the batched round (10 B1g and 5 B2g a sweep)
    against its lane loop and one lane on the CPU, its set-up and round loop
    timed apart, a grid round profiled with and without the eval, its peak
    memory; the bf16 lane at CIFAR-10; ``fl_sim --dataset cifar10 --rounds
    2``.  -> launches by path (the main paths' and one batched sweep's)."""
    from repro_torch.configs import get_config
    from repro_torch.core.scenarios import scenario_config
    from repro_torch.fl import ExperimentEngine
    from repro_torch.fl.aggregators import AGGREGATOR_ORDER
    from repro_torch.fl.rounds import make_round_step
    from repro_torch.fl.simulation import FLSimulation
    from repro_torch.launch import fl_sim
    from repro_torch.utils import prng

    fl_cnn = dataclasses.replace(fl, local_epochs=1)
    traffic = scenario_config("ring", num_vehicles=fl.num_clients)
    launches, final, sims = {}, {"mnist": mnist_records[-1].test_acc}, {}
    for dataset, arch, n_rounds in CNN_RUNS:
        phase(f"CNN datasets: FLSimulation ring / contextual / {dataset} ({arch}, full width) "
              f"on cuda, {n_rounds} rounds")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sim = FLSimulation(get_config(arch), fl_cnn, traffic, dataset, "contextual",
                           prng.key(0), device=device)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        states, recs, launches[f"the {dataset} main path"] = drive(sim, "fedavg_reduce",
                                                                    rounds=n_rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        print(f"{dataset}: P={sim.state.params.numel():,} N={fl_cnn.num_clients} "
              f"K={fl_cnn.n_select}; set-up {setup_s:.2f} s, warm-up and {n_rounds} rounds "
              f"{wall:.2f} s, peak memory {peak / 2**30:.2f} GiB above the {held / 2**30:.2f} "
              f"GiB held [{card}]")
        replay(sim, states[0], recs[0], traffic, **CNN_REPLAY)
        profile_round(f"{dataset} main-path round (N=100, K=10, 4 steps of 64 a client, eval)",
                      lambda: sim._step(states[-1], sim.scn, 0, 0, sim.data, True), card)
        final[dataset] = recs[-1].test_acc
        sims[dataset] = (sim, states[0], recs)

    phase("CNN datasets: the round-level contracts at fl-cifar10-cnn")
    sim, state0, cifar_recs = sims["cifar10"]
    K = fl_cnn.n_select
    fedavg_round = sim._step(state0, sim.scn, 0, 0, sim.data, True)
    general = make_round_step(sim.api.loss, fl_cnn, K, sim.model_bytes, sim.param_spec,
                              ("contextual",), aggregators=AGGREGATOR_ORDER)
    assert_rounds_bitwise(general(state0, sim.scn, 0, 0, sim.data, True), fedavg_round,
                          "cifar10: full registry at index 0 vs the ('fedavg',) round")
    hier = make_round_step(sim.api.loss, dataclasses.replace(fl_cnn, hierarchical=True), K,
                           sim.model_bytes, sim.param_spec, ("contextual",))
    assert_rounds_bitwise(hier(state0, sim.scn, 0, 0, sim.data, True), fedavg_round,
                          "cifar10: contract (a), hierarchical ('fedavg',) round vs the flat one")
    del general, hier, fedavg_round
    print(f"final test accuracy (ring / contextual, N=100): mnist {final['mnist']:.4f} "
          f"(fl-mnist-mlp, {ROUNDS} rounds of 3 epochs), cifar10 {final['cifar10']:.4f} "
          f"(fl-cifar10-cnn, {CNN_RUNS[0][2]} rounds of 1 epoch), svhn {final['svhn']:.4f} "
          f"(fl-svhn-cnn, {CNN_RUNS[1][2]} rounds of 1 epoch) [{card}]")

    phase("CNN datasets: the bench's 24-run grid at fl-cifar10-cnn (3 strategies x 8 scenarios, "
          "N=20, 5 rounds, eval every 5, ('fedavg',)), the batched round, then its lane loop")
    eng = ExperimentEngine(get_config("fl-cifar10-cnn"), grid_fl(), "cifar10",
                           strategies=GRID_STRATEGIES, aggregators=("fedavg",), device=device)
    if not eng.batched:
        raise AssertionError("the fl-cifar10-cnn grid engine did not take the batched round")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res, walls, launches["engine cifar10 grid"] = grid_sweeps(
        eng, BENCH, BENCH.batched_want("fedavg_reduce_grid"), 1, card)
    sweep_peak = torch.cuda.max_memory_allocated() - held
    loop_wall = grid_vs_loop(eng, BENCH, res, GRID_TOL, "fedavg_reduce", card)
    lane_vs_cpu(res, eng, BENCH, ("contextual", "fedavg", 0, "ring"), GRID_TOL, card)
    runs = BENCH.runs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = eng._lanes(runs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng._sweep(batched, GRID_ROUNDS, GRID_EVAL_EVERY)
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t1
    print(f"cifar10 grid, {len(runs)} lanes: warm sweep {walls[1]:.3f} s "
          f"({BENCH.lane_rounds() / walls[1]:.2f} lane-rounds/s), set-up (lanes built and warmed "
          f"up) {t1 - t0:.3f} s and {GRID_ROUNDS} rounds {rounds_s:.3f} s batched, lane loop "
          f"{loop_wall['setup_s']:.3f} s and {loop_wall['rounds_s']:.3f} s; peak memory in the "
          f"sweeps {sweep_peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held [{card}]")
    for do_eval in (False, True):
        profile_round(f"cifar10 engine grid round (batched), {len(runs)} lanes (N=20, K=2), "
                      f"{'with' if do_eval else 'no'} eval",
                      lambda do_eval=do_eval: eng._grid_round(batched, do_eval, False), card)
    del batched, eng, res
    torch.cuda.empty_cache()

    phase(f"CNN datasets: the bf16 lane at fl-cifar10-cnn (compute_dtype bfloat16), "
          f"{CNN_BF16_ROUNDS} rounds")
    fl16 = dataclasses.replace(fl_cnn, compute_dtype="bfloat16")
    sim16 = FLSimulation(get_config("fl-cifar10-cnn"), fl16, traffic, "cifar10", "contextual",
                         prng.key(0), device=device)
    st16, recs16, launches["the cifar10 bf16 main path"] = drive(
        sim16, "fedavg_reduce", rounds=CNN_BF16_ROUNDS)
    replay(sim16, st16[0], recs16[0], traffic, params_atol=1e-4, **BF16_REPLAY)
    print(f"cifar10 test accuracy after {CNN_BF16_ROUNDS} rounds: fp32 "
          f"{cifar_recs[CNN_BF16_ROUNDS - 1].test_acc:.4f}, bf16 {recs16[-1].test_acc:.4f} "
          f"[{card}]")
    del sim16, st16

    phase("CNN datasets: python -m repro_torch.launch.fl_sim --dataset cifar10 --rounds 2 on cuda")
    reset_launches()
    t0 = time.perf_counter()
    out = fl_sim.run_experiment("cifar10", "contextual", 2, device=str(device))
    torch.cuda.synchronize()
    got = read_launches()
    want = dict.fromkeys(got, 0)
    want.update(rttg_latency=4, fedavg_reduce=2)
    if got != want:
        raise AssertionError(f"fl_sim --dataset cifar10: expected {want}, got {got}")
    launches["fl_sim --dataset cifar10"] = got
    accs = [r["test_acc"] for r in out["rounds"]]
    if out["device"] != str(device) or not all(math.isfinite(a) for a in accs):
        raise AssertionError(f"fl_sim --dataset cifar10: device {out['device']}, accuracy {accs}")
    print(f"fl_sim --dataset cifar10 --rounds 2 on {out['device']}: {time.perf_counter() - t0:.2f}"
          f" s, test accuracy by round {accs}, launches {got} [{card}]")
    del sims
    torch.cuda.empty_cache()
    return launches


# Phase 4j: an engine grid on Dirichlet client shards (``dirichlet_alpha`` 0.5,
# the reference engine test's), ("fedavg",) x contextual x seeds 0, 1 x two
# scenarios at the bench's N = 20, 3 rounds, eval every round
DIRICHLET_GRID = dict(seeds=(0, 1), scenarios=("ring", "rush_hour"), rounds=3, eval_every=1)
# ``launch.fl_cits_benchmark``'s run on the card: 3 strategies x 3 rounds, N = 20
FL_CITS = dict(rounds=3, clients=20)


def dirichlet_and_examples_phase(device, card):
    """Phase 4j: the port's last paths on the card.  A 4-lane ``("fedavg",)``
    engine grid on Dirichlet shards through the batched round (exactly 2 B1g
    and 1 B2g a round), each lane's labels equal to the CPU's and its records
    within ``GRID_TOL`` of the CPU's; ``python -m
    repro_torch.launch.serve_decode`` (one B7 launch an attention layer a
    decode step), its tokens the CPU's; ``python -m
    repro_torch.launch.fl_cits_benchmark --rounds 3 --clients 20`` (2 B1 and 1
    B2 a round), its records within ``GRID_TOL`` of the CPU's.  -> (the grid's
    launches, the two examples' launches by path)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.fl import ExperimentEngine
    from repro_torch.launch import fl_cits_benchmark, serve_decode

    phase("Dirichlet shards: a 4-lane ('fedavg',) engine grid at dirichlet_alpha 0.5 (N=20, "
          "3 rounds) on cuda, the batched round")
    fl = grid_fl(dirichlet_alpha=0.5)
    model = get_config("fl-mnist-mlp")
    eng = ExperimentEngine(model, fl, "mnist", strategies=("contextual",), device=device)
    if not eng.batched:
        raise AssertionError("the Dirichlet grid engine did not take the batched round")
    reset_launches()
    t0 = time.perf_counter()
    res = eng.run_grid(**DIRICHLET_GRID)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grid = read_launches()
    rounds = DIRICHLET_GRID["rounds"]
    want = dict.fromkeys(grid, 0)
    want.update(rttg_latency_grid=2 * rounds, fedavg_reduce_grid=rounds)
    if grid != want:
        raise AssertionError(f"Dirichlet grid: expected {want}, got {grid}")
    cpu = ExperimentEngine(model, fl, "mnist", strategies=("contextual",), device="cpu")
    ref = cpu.run_grid(**DIRICHLET_GRID)
    worst, classes = 0.0, []
    for run in res.runs:
        strategy, aggregator, seed, scenario = run
        labels = eng.init_run(strategy, seed, scenario)[1].labels
        want_labels = cpu.init_run(strategy, seed, scenario)[1].labels
        if not torch.equal(labels.cpu(), want_labels):
            raise AssertionError(f"Dirichlet grid {run}: the card's labels are not the CPU's")
        classes.append(int((torch.nn.functional.one_hot(want_labels, 10).sum(1) > 0)
                           .sum(1).max()))
        worst = max(worst, check_records_close(
            res.records(strategy, seed, scenario, aggregator=aggregator),
            ref.records(strategy, seed, scenario, aggregator=aggregator), GRID_TOL, str(run)))
    acc = res.final_accuracy()
    print(f"Dirichlet grid, {len(res.runs)} lanes x {rounds} rounds on the card in {wall:.3f} s: "
          f"launches {({k: v for k, v in grid.items() if v})}; labels the CPU's (up to "
          f"{max(classes)} classes a client), records within GRID_TOL of the CPU's (worst "
          f"{worst:.3f} of it); final accuracy {min(acc.values()):.4f}-"
          f"{max(acc.values()):.4f} [{card}]")
    del eng, cpu, res, ref
    torch.cuda.empty_cache()

    phase("examples: python -m repro_torch.launch.serve_decode on cuda (mixtral-8x7b smoke, "
          "4 x 48, 24 tokens)")
    paths = {}
    reset_launches()
    t0 = time.perf_counter()
    tokens = serve_decode.main([])
    torch.cuda.synchronize()
    sd_s = time.perf_counter() - t0
    got = read_launches()
    cfg = get_smoke_config("mixtral-8x7b")
    want = dict.fromkeys(got, 0)
    want.update(swa_decode=cfg.num_layers * (serve_decode.GEN - 1))
    if got != want:
        raise AssertionError(f"serve_decode: expected {want}, got {got}")
    cpu_tokens = serve_decode.run("cpu", verbose=False)
    if not torch.equal(tokens.cpu(), cpu_tokens):
        raise AssertionError(f"serve_decode: the card's tokens {tokens.tolist()} are not the "
                             f"CPU's {cpu_tokens.tolist()}")
    paths["serve_decode"] = got
    print(f"serve_decode on the card in {sd_s:.2f} s: greedy tokens the CPU's, launches "
          f"{({k: v for k, v in got.items() if v})} [{card}]")

    phase(f"examples: python -m repro_torch.launch.fl_cits_benchmark --rounds "
          f"{FL_CITS['rounds']} --clients {FL_CITS['clients']} on cuda")
    argv = ["--rounds", str(FL_CITS["rounds"]), "--clients", str(FL_CITS["clients"])]
    reset_launches()
    t0 = time.perf_counter()
    out = fl_cits_benchmark.main(argv)
    torch.cuda.synchronize()
    fc_s = time.perf_counter() - t0
    got = read_launches()
    n = len(fl_cits_benchmark.STRATEGIES) * FL_CITS["rounds"]
    want = dict.fromkeys(got, 0)
    want.update(rttg_latency=2 * n, fedavg_reduce=n)
    if got != want:
        raise AssertionError(f"fl_cits_benchmark: expected {want}, got {got}")
    paths["fl_cits_benchmark"] = got
    ref = fl_cits_benchmark.run(FL_CITS["rounds"], clients=FL_CITS["clients"], device="cpu",
                                verbose=False)
    worst = max(check_records_close(out[s]["rounds"], ref[s]["rounds"], GRID_TOL, s)
                for s in fl_cits_benchmark.STRATEGIES)
    print(f"fl_cits_benchmark on the card in {fc_s:.2f} s: records within GRID_TOL of the "
          f"CPU's (worst {worst:.3f} of it), launches {({k: v for k, v in got.items() if v})} "
          f"[{card}]")
    torch.cuda.empty_cache()
    return grid, paths


# The LM trainer (phase 7).  Every family trains through plain torch on the card
# (the ssm / hybrid scan through ``ssd_scan_plain`` under grad mode): no kernel
# runs, so every launch count must stay 0.
TRAIN_LR = 3e-4
# ``launch.train --full --steps 5`` at the CLI's defaults: (arch, parameters)
TRAIN_FULL = (("qwen1.5-0.5b", 464_118_784), ("hymba-1.5b", 1_641_790_720),
              ("mamba2-130m", 129_100_224))
# the full runs that also take AdamW steps on one repeated batch (the loss must
# fall): arch -> steps
TRAIN_REPEATED = {"qwen1.5-0.5b": 5, "hymba-1.5b": 3}
# The families' smoke configs, card vs CPU: (arch, batch) at one microbatch
# and at the config's own count (batch = max(4, m))
TRAIN_SMOKE_ARCHS = ("qwen1.5-0.5b", "gemma2-9b", "mistral-nemo-12b", "chatglm3-6b",
                     "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "internvl2-76b", "whisper-small",
                     "hymba-1.5b", "mamba2-130m")


def assert_no_launches(what: str) -> None:
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"{what}: the path runs no kernel, but launched {launches}")


def train_step_card_vs_cpu(cfg, batch, seq, device, label, params=None):
    """One AdamW step (``launch.steps.make_train_step``) on the card and on the CPU
    from the same weights (drawn on the card, copied) and the trainer's first
    batch.  Loss and metrics within rtol 1e-5; at one microbatch the gradient's
    global norm within rtol 1e-4 and each leaf's gradient norm within rtol 1e-4
    (atol 1e-5 of the global norm); in each leaf fewer than 1e-3 of the
    elements more than lr / 10 apart after the step (AdamW's first step is
    about ``lr * sign(g)``, so a wrong gradient moves its elements by ~2 lr)."""
    from repro_torch.config import TrainConfig
    from repro_torch.launch.steps import TrainState, make_train_step, value_and_grad
    from repro_torch.launch.train import make_batch
    from repro_torch.models import build_model
    from repro_torch.utils import prng
    from repro_torch.utils.pytree import tree_global_norm

    api = build_model(cfg)
    step, opt = make_train_step(api, TrainConfig(learning_rate=TRAIN_LR))
    if params is None:
        params = api.init(prng.fold_in_str(prng.key(0, device), "init"), device)
    b = make_batch(cfg, prng.fold_in(prng.key(0, device), 1), batch, seq)
    sides = {}
    reset_launches()
    for side, p, bb in (("card", params, b), ("cpu", tree_to(params, "cpu"), tree_to(b, "cpu"))):
        state, met = step(TrainState(p, opt.init(p)), bb)
        norms = None
        if cfg.train_microbatches == 1:
            g = value_and_grad(api.loss, p, bb)[2]
            # squares summed in fp32 by torch.sum: the CPU's vector_norm of a
            # large fp32 leaf is off by up to 2e-2 relative (torch 2.13, 155 M elements)
            norms = (tree_global_norm(g).cpu(), [tree_global_norm(x).cpu() for x in _leaves(g)])
            del g
        sides[side] = (state, met, norms)
        if side == "card":
            assert_no_launches(f"{label} train step")
    (sg, mg, ng), (sc, mc, nc) = sides["card"], sides["cpu"]
    for k in mc:
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=1e-6,
                                   msg=f"{label}: {k}")
    if ng is not None:
        torch.testing.assert_close(ng[0], nc[0], rtol=1e-4, atol=0, msg=f"{label}: grad norm")
        for i, (a, c) in enumerate(zip(ng[1], nc[1])):
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5 * float(nc[0]),
                                       msg=f"{label}: leaf {i}'s grad norm, card {float(a)!r} "
                                       f"vs CPU {float(c)!r}")
    worst, worst_share, apart, n = 0.0, 0.0, 0, 0
    for i, (a, c) in enumerate(zip(_leaves(sg.params), _leaves(sc.params))):
        d = (a.cpu().float() - c.float()).abs()
        k = int((d > TRAIN_LR / 10).sum())
        if k >= 1e-3 * d.numel():
            raise AssertionError(f"{label}: leaf {i} {tuple(d.shape)}: {k:,} of {d.numel():,} "
                                 f"elements more than lr / 10 apart, card vs CPU")
        worst, worst_share = max(worst, float(d.max())), max(worst_share, k / d.numel())
        apart += k
        n += d.numel()
    print(f"{label}: card vs CPU loss {float(mg['loss']):.6f} vs {float(mc['loss']):.6f}"
          + (f", grad norm {float(ng[0]):.6f} vs {float(nc[0]):.6f}, {len(nc[1])} leaves' "
             f"grad norms within rtol 1e-4" if ng is not None else "")
          + f"; params' max |d| {worst:.3e} (lr = {TRAIN_LR:.1e}), {apart:,} of {n:,} "
          f"elements > lr / 10 apart, at most {worst_share:.2e} of a leaf")


def train_full(arch: str, n_params: int, device, card) -> None:
    """``python -m repro_torch.launch.train --arch ARCH --full --steps 5`` on the
    card: the exact parameter count, bf16 params (the SSM's per-head leaves
    fp32) and fp32 AdamW moments,
    finite losses, no kernel launched; its step times (median past the first),
    tokens/s and peak memory above what was held; for ``TRAIN_REPEATED`` its
    AdamW steps on one repeated batch (the loss must fall); one profiled step."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_batch
    from repro_torch.models import build_model
    from repro_torch.utils import prng
    from repro_torch.utils.pytree import tree_leaves

    batch, seq = 8, 128  # the CLI's defaults
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    res = train_mod.main(["--arch", arch, "--full", "--steps", "5"])
    assert_no_launches(f"{arch} training")
    peak = torch.cuda.max_memory_allocated() - held
    params = res.state.params
    if res.n_params != n_params:
        raise AssertionError(f"{arch}: {res.n_params:,} parameters, expected {n_params:,}")
    # bf16 params but the SSM's per-head fp32 leaves (A_log, dt_bias, D: (layers,
    # heads)), as the reference draws them; fp32 moments
    def fp32_ok(x):
        return res.cfg.family in ("ssm", "hybrid") and x.dtype == torch.float32 \
            and x.dim() == 2 and x.shape[-1] == res.cfg.ssm_num_heads

    if any(x.dtype != torch.bfloat16 and not fp32_ok(x) for x in tree_leaves(params)) or any(
            x.dtype != torch.float32 for x in tree_leaves(res.state.opt_state.mu)
            + tree_leaves(res.state.opt_state.nu)):
        raise AssertionError(f"{arch}: params must be bf16 (the SSM's per-head leaves fp32) "
                             f"and the AdamW moments fp32")
    n_fp32 = sum(x.numel() for x in tree_leaves(params) if x.dtype == torch.float32)
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"{arch}: losses {res.losses}")
    step_ms = sorted(res.step_s[1:])[len(res.step_s[1:]) // 2] * 1e3  # median past the first
    print(f"{arch} --full training: {res.n_params:,} parameters ({n_fp32:,} of them the "
          f"SSM's fp32 per-head leaves, the rest bf16), fp32 AdamW moments, "
          f"B={batch} x {seq} tokens, {res.cfg.train_microbatches} microbatch(es); step times "
          f"{', '.join(f'{x * 1e3:.1f}' for x in res.step_s)} ms (the first warms the card "
          f"up); median past the first {step_ms:.1f} ms, "
          f"{batch * seq / step_ms * 1e3:,.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB "
          f"above the {held / 2**30:.2f} GiB held; launches {read_launches()} [{card}]")

    cfg = get_config(arch)
    step, _ = make_train_step(build_model(cfg), TrainConfig(learning_rate=TRAIN_LR))
    b = make_batch(cfg, prng.fold_in(prng.key(0, device), 1), batch, seq)
    state = res.state
    if arch in TRAIN_REPEATED:
        losses = []
        reset_launches()
        for _ in range(TRAIN_REPEATED[arch]):
            state, met = step(state, b)
            losses.append(float(met["loss"]))
        assert_no_launches(f"{arch} repeated batch")
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"{arch}: the loss on one repeated batch does not fall: "
                                 f"{losses}")
        print(f"{arch}: {len(losses)} AdamW steps on one repeated batch, loss "
              f"{' -> '.join(f'{x:.4f}' for x in losses)}")
    profile_round(f"train step, {arch} full, B={batch} x {seq}", lambda: step(state, b), card)
    del res, state, params, step, b
    torch.cuda.empty_cache()


def train_phase(device, card) -> None:
    """Phase 7: ``python -m repro_torch.launch.train --arch ARCH --full --steps
    5`` on the card for qwen1.5-0.5b, hymba-1.5b and mamba2-130m
    (``train_full``); qwen1.5-0.5b cut to 2 layers card vs CPU in fp32; every
    smoke config card vs CPU at one microbatch and at its own count, the ssm and
    hybrid ones too; ``federated_llm --rounds 2`` on the card against the CPU."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import federated_llm

    for a, n in TRAIN_FULL:
        train_full(a, n, device, card)
    arch = "qwen1.5-0.5b"

    # full width cut to 2 layers, fp32, card vs CPU
    train_step_card_vs_cpu(cut_depth(get_config(arch), 2).replace(dtype="float32"), 2, 64, device,
                           f"{arch} full width, 2 layers, fp32, B=2 x 64")
    torch.cuda.empty_cache()
    # every family's smoke config at m = 1 and its own m
    for a in TRAIN_SMOKE_ARCHS:
        cfg = get_smoke_config(a)
        for m in sorted({1, cfg.train_microbatches}):
            train_step_card_vs_cpu(cfg.replace(train_microbatches=m), max(4, m), 32, device,
                                   f"{a} smoke, m={m}, B={max(4, m)} x 32")
    # the federated-LM example on the card against the CPU
    reset_launches()
    t0 = time.perf_counter()
    fed = federated_llm.main(["--rounds", "2"])
    torch.cuda.synchronize()
    fed_s = time.perf_counter() - t0
    assert_no_launches("federated_llm")
    fed_cpu = federated_llm.run(2, device="cpu", verbose=False)
    # the card and the CPU differed by 4.8e-7 in eval loss on an H100, while a
    # round moves it by ~1e-3: the losses within rtol 1e-5, each round's update
    # norm within rtol 1e-4
    for g, c in zip(fed, fed_cpu):
        if (g["cohort"], g["clusters"]) != (c["cohort"], c["clusters"]) \
                or not math.isclose(g["eval_loss"], c["eval_loss"], rel_tol=1e-5) \
                or not math.isclose(g["update_norm"], c["update_norm"], rel_tol=1e-4):
            raise AssertionError(f"federated_llm card vs CPU: {g} vs {c}")
    print(f"federated_llm --rounds 2 on the card in {fed_s:.2f} s: cohorts and clusters "
          f"the CPU's, eval losses {[r['eval_loss'] for r in fed]} vs "
          f"{[r['eval_loss'] for r in fed_cpu]}, update norms "
          f"{[r['update_norm'] for r in fed]} vs {[r['update_norm'] for r in fed_cpu]} [{card}]")


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 1
    other = None
    if argv:
        if len(argv) != 2 or argv[0] != "--wrapper-times":
            print("usage: python3 chip_smoke.py [--wrapper-times CHECKOUT]", file=sys.stderr)
            return 2
        other = os.path.abspath(argv[1])
        sys.path.insert(0, os.path.join(other, "src"))  # before any repro_torch import

    # ---- 1. device -------------------------------------------------------
    phase("device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device: {kind} (count {count})")
    print(f"nvidia-smi: {card}")
    device = torch.device("cuda:0")

    from repro_torch.utils.device import resolve_device

    resolve_device(device)  # full-fp32 matmuls (no TF32)

    # ---- 2. build --------------------------------------------------------
    phase("build")
    from repro_torch.kernels import build as kbuild

    info = kbuild.build(force=True)
    print(f"built {os.path.relpath(info.path, ROOT)} in {info.seconds:.2f} s")
    for line in info.ptxas_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line \
                or "Compiling entry" in line:
            print("  " + line.strip())
    kbuild.library()
    if other is not None:
        phase(f"wrapper times of {other}")
        wrapper_times(device, card)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": count}}))
        return 0

    # ---- 3. kernels against their plain versions ------------------------
    phase("kernels vs plain versions")
    main_err = {"rttg_latency": 0.0, "fedavg_reduce": 0.0}
    for predict in (True, False):
        e = check_rttg("ring", 100, predict, 1.0, False, device)
        main_err["rttg_latency"] = max(main_err["rttg_latency"], e)
    check_rttg("ring", 100, False, 1.0, True, device)
    # the launch plan's edges: one block up to 1,024 clients, then a cooperative
    # grid; 300,000 clients outnumber the card's resident threads
    for n in (1, 257, 1024, 1025, 4096, 100_000, 300_000):
        check_rttg("ring", n, True, 1.0, True, device)
    check_rttg("ring", 100_000, False, 0.7, True, device)
    # R = 1, 40 and the largest, 32,768 (160 KB of shared memory a block)
    for spacing in (10_000.0, 250.0, 10_000.0 / 32768):
        for n in (100, 5000):
            check_rttg("ring", n, True, 1.0, True, device, rsu_spacing_m=spacing)
    # positions at the wrap, on the 10 km ring and on a 5 m one, where
    # 3 mean_speed dt > ring / 2 sends every step through the tested wrap
    for ring_kw in ({}, {"ring_length_m": 5.0, "rsu_spacing_m": 1.0}):
        for n in (100, 4096):
            for predict in (True, False):
                check_rttg("ring", n, predict, 1.0, True, device, at_wrap=True, **ring_kw)
    check_rttg("rsu_outage", 100, True, 1.0, True, device)
    check_rttg("rush_hour", 257, True, 0.7, False, device)
    check_rttg("day_cycle", 100, False, 0.5, True, device)
    # the engine grids' calls (phase 4h): N = 20 in every catalog scenario, each
    # with its own ring and RSU count, predicted and realized, at CR 1.0 and 0.7
    for sc in GRID_SCENARIOS:
        for predict in (True, False):
            for cr in (1.0, 0.7):
                check_rttg(sc, 20, predict, cr, False, device)
    # B1g (the batched grid round's geometry, one block a lane): the bench grid's
    # 24 lanes over the 8 catalog scenarios at N = 20 and 100, predicted and
    # realized, CR 1.0 and 0.7; then one lane, one client, 1,024 clients, and a
    # dark-RSU lane beside a live one
    main_err["rttg_latency_grid"] = 0.0
    for n in (20, 100):
        for predict in (True, False):
            for cr in (1.0, 0.7):
                e = check_rttg_grid(GRID_SCENARIOS * 3, n, predict, cr, device)
                if (n, predict, cr) == (20, True, 1.0):
                    main_err["rttg_latency_grid"] = e
    for scenarios, n in ((("ring",), 20), (("highway",) * 5, 1), (("day_cycle",) * 3, 1024),
                         (("rush_hour", "urban_grid"), 1024), (("rsu_outage", "ring"), 100)):
        for predict in (True, False):
            check_rttg_grid(scenarios, n, predict, 0.7, device)
    # B1g's RSU ids (the two-tier grids' realized pass): the smoke probe's 12
    # lanes at N = 20, the streamed grid's 8 at N = 100, and the one-block edge
    for scenarios, n in ((("rush_hour", "rsu_outage") * 6, 20), (GRID_SCENARIOS, 100),
                         (("rsu_outage", "ring"), 1024)):
        for predict in (True, False):
            check_rttg_grid(scenarios, n, predict, 0.7, device, want_rid=True)
    main_err["fedavg_reduce"] = check_fedavg(10, 159_010, device)
    for K, P in ((1, 159_010), (10, 2049), (1, 1), (10, 4096), (7, 159_011), (8, 4097),
                 (9, 2049), (17, 159_010), (17, 4097), (100, 38_656),
                 (2, 159_010)):  # the engine grids' cohort (phase 4h)
        check_fedavg(K, P, device)
    main_err["server_update"] = main_err["server_update_buffered"] = 0.0
    for K, P in ((10, 159_010), (1, 1), (1, 2047), (5, 2049), (100, 38_656)):
        errs = [check_server_update(K, P, rule, device, exact) for rule in range(6)
                for exact in (False, True)]
        if (K, P) == (10, 159_010):
            main_err["server_update"] = max(errs)
        print(f"server_update K={K:3d} P={P:7d} rules 0-5, random and exact operands: "
              f"max_abs_err={max(errs):.3e}")
    for Kb in (1, 8):
        for drain in (False, True):
            errs = [check_server_buffered(10, Kb, 159_010, rule, drain, device)
                    for rule in range(6)]
            if Kb == 8:
                main_err["server_update_buffered"] = max(
                    main_err["server_update_buffered"], *errs)
            print(f"server_update_buffered K=10 Kb={Kb} P=159010 drain={drain!s:5s} "
                  f"rules 0-5: max_abs_err={max(errs):.3e}")
    check_server_buffered(1, 1, 1, 2, True, device)
    check_server_buffered(5, 3, 2049, 3, True, device)
    # the async engine grid's lane-loop call (phase 4h): K = 2 beside the 8-slot ring
    for drain in (False, True):
        errs = [check_server_buffered(2, 8, 159_010, rule, drain, device) for rule in range(6)]
        print(f"server_update_buffered K=2 Kb=8 P=159010 drain={drain!s:5s} rules 0-5: "
              f"max_abs_err={max(errs):.3e}")
    for K, P in ((10, 159_010), (5, 2049), (1, 1)):
        check_server_contracts(K, P, device)
    main_err["rsu_reduce"] = 0.0
    for K, P, R, offset, pad in (
            (4, 159_010, 10, 0, 0), (32, 159_010, 10, 0, 0), (1, 1, 1, 0, 0),
            (1, 515, 10, 0, 0), (7, 515, 10, 0, 0), (5, 2049, 1, 0, 0), (7, 515, 33, 0, 0),
            (4, 159_010, 33, 0, 0), (32, 159_010, 100, 0, 0),
            # the launch plan's edges: K off the 4-row slab, ragged and odd P,
            # 16-byte rows (P = 4096) and 8-byte ones (a storage offset of 2;
            # a row slice u[1:] at P = 159,010), the fleet's padded last chunk
            # (4 clients, 28 padding slots), 40 RSUs
            (3, 159_010, 10, 0, 0), (31, 159_010, 10, 0, 0), (33, 159_010, 10, 0, 0),
            (4, 3, 10, 0, 0), (5, 1029, 10, 0, 0), (4, 159_011, 10, 0, 0),
            (6, 4096, 10, 0, 0), (6, 4096, 10, 2, 0), (4, 159_010, 10, 159_010, 0),
            (32, 159_010, 10, 0, 28), (5, 2049, 40, 0, 0)):
        errs = [check_rsu(K, P, R, mode, with_carry, device, offset, pad)
                for mode in ("rand", "exact", "one_rsu", "hole", "masked", "out_of_range")
                for with_carry in (False, True)]
        if (K, P, offset, pad) == (4, 159_010, 0, 0) and R == 10:
            main_err["rsu_reduce"] = max(errs)
        print(f"rsu_reduce K={K:2d} P={P:7d} R={R:3d} offset={offset} pad={pad}: random, "
              f"dyadic, one RSU, unattached, zero-weight and out-of-range ids, with and "
              f"without carry, each repeated bitwise: max_abs_err={max(errs):.3e}")
    check_rsu_walk(10, 4, device)
    check_rsu_walk(100, 32, device)
    check_rsu_walk(100, 32, device, R=40)
    # the bf16 lane: B2-B5 read 2-byte rows (and B5 writes 2-byte partials)
    # in their own bodies; the same checks at the main shapes and the edges
    f32, bf16 = torch.float32, torch.bfloat16
    main_err["bf16"] = {"fedavg_reduce": check_fedavg(10, 159_010, device, bf16)}
    # K = 1, odd P, P = 2 mod 4 (4-byte pieces), a row one element off its
    # 4-byte alignment (2-byte loads), a ragged K past the load group
    for K, P, offset in ((1, 159_010, 0), (7, 159_011, 0), (10, 4098, 0), (10, 4096, 1),
                         (1, 1, 0), (17, 4097, 0), (10, 159_010, 1),
                         (2, 159_010, 0)):  # the precision engine grid's cohort
        check_fedavg(K, P, device, bf16, offset)
    for master in (f32, bf16):
        for K, P in ((10, 159_010), (1, 1), (5, 2049), (3, 159_011)):
            errs = [check_server_update(K, P, rule, device, exact, rows=bf16, master=master)
                    for rule in range(6) for exact in (False, True)]
            if (K, P, master) == (10, 159_010, f32):
                main_err["bf16"]["server_update"] = max(errs)
            print(f"server_update K={K:3d} P={P:7d} bf16 rows, {str(master)[6:]} master, rules "
                  f"0-5, random and exact operands: max_abs_err={max(errs):.3e}")
        for drain in (False, True):
            errs = [check_server_buffered(10, 8, 159_010, rule, drain, device, rows=bf16,
                                          master=master) for rule in range(6)]
            if master == f32:
                main_err["bf16"]["server_update_buffered"] = max(
                    main_err["bf16"].get("server_update_buffered", 0.0), *errs)
            print(f"server_update_buffered K=10 Kb=8 P=159010 bf16 rows and ring, "
                  f"{str(master)[6:]} master, drain={drain!s:5s} rules 0-5: "
                  f"max_abs_err={max(errs):.3e}")
        check_server_buffered(5, 3, 2049, 3, True, device, rows=bf16, master=master)
        for K, P in ((10, 159_010), (5, 2049), (1, 1)):
            check_server_contracts(K, P, device, rows=bf16, master=master)
    for out in (bf16, f32):
        for K, P, R, offset, pad in (
                (4, 159_010, 10, 0, 0), (32, 159_010, 10, 0, 0), (4, 159_010, 40, 0, 0),
                (32, 159_010, 40, 0, 0), (5, 159_011, 10, 0, 0), (4, 3, 10, 0, 0),
                (1, 1, 1, 0, 0), (6, 4096, 10, 2, 0), (6, 4096, 10, 1, 0),
                (4, 159_010, 10, 1, 0), (32, 159_010, 10, 0, 28), (7, 515, 33, 0, 0)):
            errs = [check_rsu(K, P, R, mode, with_carry, device, offset, pad, rows=bf16,
                              out=out)
                    for mode in ("rand", "exact", "one_rsu", "hole", "masked", "out_of_range")
                    for with_carry in (False, True)]
            if (K, P, R, offset, pad, out) == (4, 159_010, 10, 0, 0, bf16):
                main_err["bf16"]["rsu_reduce"] = max(errs)
            print(f"rsu_reduce K={K:2d} P={P:7d} R={R:3d} offset={offset} pad={pad} bf16 rows, "
                  f"{str(out)[6:]} partials: every mode with and without carry, each repeated "
                  f"bitwise: max_abs_err={max(errs):.3e}")
    # B2g (the batched grid round's reduce, a lane a grid row): the bench grid's
    # 24 lanes at K = 2 and 10, P = 159,010, fp32 and bf16 rows; then one lane,
    # K = 1, an odd P and rows off their vector alignment
    main_err["fedavg_reduce_grid"] = 0.0
    for rows in (f32, bf16):
        for K in (2, 10):
            e = check_fedavg_grid(24, K, 159_010, device, rows)
            if (K, rows) == (2, f32):
                main_err["fedavg_reduce_grid"] = e
            if (K, rows) == (2, bf16):
                main_err["bf16"]["fedavg_reduce_grid"] = e
        for G, K, P, offset in ((1, 2, 159_010, 0), (24, 1, 159_010, 0), (3, 7, 159_011, 0),
                                (5, 3, 159_010, 1), (2, 9, 4097, 1), (1, 1, 1, 0)):
            check_fedavg_grid(G, K, P, device, rows, offset)
    # B2 and B2g at the CNN datasets' P (phase 4i): fl-cifar10-cnn's 1,070,794
    # and fl-svhn-cnn's 603,034 (both 2 mod 4: runs of 2), the main path's
    # cohort K = 10 in fp32 and bf16 rows, the bench grid's (24, 2) and (24, 10);
    # then a grid whose last lane starts past 2^31 elements
    main_err["cnn"] = {}
    for P in CNN_P.values():
        for rows in (f32, bf16):
            main_err["cnn"][f"fedavg_reduce {str(rows)[6:]} P={P}"] = check_fedavg(
                10, P, device, rows)
        main_err["cnn"][f"fedavg_reduce_grid P={P}"] = check_fedavg_grid(24, 2, P, device)
    check_fedavg_grid(24, 10, CNN_P["cifar10"], device, bf16)
    check_fedavg_grid_past_int32(device)
    # B3g / B4g (the batched grid round's server step, a lane a grid row): the
    # engine grids' lanes (24 and 48; 40, the smoke grid without fedbuff) at K = 2
    # and K = N = 20 (an engine with greedy), the 8-slot ring, P = 159,010, every
    # rule mixed across lanes and drain mixed; fp32 and bf16 rows and master; the
    # registry with no moment rule; then one lane, an odd P, one ring slot and
    # rows off their vector alignment
    main_err["server_update_grid"] = main_err["server_update_buffered_grid"] = 0.0
    for G, K in ((24, 2), (40, 2), (48, 2), (24, 20), (48, 20)):
        for buffered in (False, True):
            e = check_server_grid(G, K, 8, 159_010, ALL_RULES, buffered, device)
            if (G, K) == ((24, 2) if buffered else (40, 2)):
                main_err["server_update_buffered_grid" if buffered else "server_update_grid"] = e
    for rows, master in ((bf16, f32), (f32, bf16), (bf16, bf16)):
        for G, K in ((24, 2), (48, 20)):
            for buffered in (False, True):
                check_server_grid(G, K, 8, 159_010, ALL_RULES, buffered, device, rows, master)
    for G in (24, 48):
        for buffered in (False, True):
            check_server_grid(G, 2, 8, 159_010, AXPY_RULES, buffered, device)
    for G, K, Kb, P, offset in ((1, 2, 8, 159_010, 0), (5, 3, 8, 2049, 0),
                                (6, 2, 1, 159_010, 0), (7, 2, 8, 159_011, 0),
                                (6, 3, 2, 4098, 1), (1, 1, 1, 1, 0)):
        for rows in (f32, bf16):
            for buffered in (False, True):
                check_server_grid(G, K, Kb, P, ALL_RULES, buffered, device, rows, rows, offset)
    check_rsu_two_roundings(device)
    for K, B, R in ((10, 4, 10), (100, 32, 10), (100, 32, 40)):
        check_rsu_walk(K, B, device, R=R, rows=bf16, out=bf16)
    # B5g (the two-tier grids' chunk walk, a lane a grid layer): the smoke
    # probe's chunk (12 lanes, 3 slots, the last padding), the streamed grid's
    # (8 lanes, 4 slots) with and without the carry, R = 40, an odd P with rows
    # off their vector alignment; fp32 rows, bf16 rows into fp32 and bf16 partials
    main_err["rsu_reduce_grid"] = 0.0
    for rows, out in ((f32, f32), (bf16, f32), (bf16, bf16)):
        for G, K, P, R, offset in ((12, 3, 159_010, 10, 0), (8, 4, 159_010, 10, 0),
                                   (8, 4, 159_010, 40, 0), (5, 3, 159_011, 10, 1),
                                   (3, 4, 4096, 33, 2), (1, 1, 1, 1, 0)):
            for with_carry in (False, True):
                e = check_rsu_grid(G, K, P, R, with_carry, device, rows, out, offset)
                if (G, K, R, with_carry, rows, out) == (8, 4, 10, True, f32, f32):
                    main_err["rsu_reduce_grid"] = e
    main_err["swa_decode"] = main_err["ssd_scan"] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        # hymba-1.5b's decode: B=4, a full 1024-slot ring after 2,080 tokens
        e = check_swa(4, 1024, 5, 5, 64, 1024, 0.0, (2080,) * 4, dtype, device)
        if dtype == torch.bfloat16:
            main_err["swa_decode"] = e
    check_swa(2, 1000, 2, 3, 64, 0, 0.0, (1000, 640), torch.float32, device)  # ragged tile
    check_swa(3, 1, 2, 4, 32, 0, 0.0, (1, 5, 9), torch.bfloat16, device)  # one slot
    check_swa(2, 300, 4, 1, 128, 64, 0.0, (300, 77), torch.float32, device)  # G = 1
    check_swa(3, 1024, 5, 5, 64, 1024, 0.0, (300, 5000, 700), torch.bfloat16, device)
    check_swa(3, 1024, 5, 5, 64, 1024, 0.0, (2080, 2080, 2080), torch.bfloat16, device,
              blind=(1,))
    check_swa(2, 512, 2, 2, 256, 0, 50.0, (400, 5000), torch.float32, device)  # softcap
    # the split-KV design's edges (128-slot splits; 64 for rows over 128 bytes, 32 over 256)
    check_swa(2, 300, 2, 3, 64, 17, 0.0, (300, 250), torch.bfloat16, device)  # narrow window
    check_swa(1, 1024, 2, 2, 64, 0, 0.0, (100,), torch.float32, device)  # empty splits
    check_swa(2, 1000, 5, 5, 64, 1024, 0.0, (1000, 2080), torch.bfloat16, device,
              blind=(0,))  # a blind row over 16 splits, a ragged last split
    for dtype in (torch.bfloat16, torch.float32):
        check_swa(1, 200, 2, 16, 256, 0, 50.0, (200,), dtype, device)  # G 16, D 256
        check_swa(2, 130, 3, 2, 36, 0, 0.0, (130, 90), dtype, device)  # 4-byte multiple rows
        check_swa(1, 70, 2, 3, 17, 16, 0.0, (200,), dtype, device)  # odd D
        # past 64 splits: the combine's chunks, a later one raising the max, and
        # (window 500, row 0) a first chunk that sees no slot
        check_swa(2, 9000, 2, 3, 64, 500, 0.0, (9000, 12000), dtype, device)
        check_swa(1, 9000, 2, 3, 64, 0, 0.0, (9000,), dtype, device)
    for dtype in (torch.bfloat16, torch.float32):
        # hymba-1.5b's prefill: B=4, S=2048, 50 heads of (64 x 16), Q=128
        e = check_ssd(4, 2048, 50, 64, 16, 128, False, dtype, device)
        if dtype == torch.bfloat16:
            main_err["ssd_scan"] = e
    check_ssd(2, 1, 3, 16, 8, 128, False, torch.float32, device)  # one step
    check_ssd(2, 200, 4, 32, 16, 128, True, torch.bfloat16, device)  # ragged chunk, h0
    check_ssd(3, 100, 2, 8, 32, 128, False, torch.float32, device)  # Q > S
    check_ssd(1, 300, 24, 64, 128, 128, True, torch.float32, device)  # mamba2's head
    # the chunk-parallel design's edges: many resident waves on the chain, hp and ds
    # off the mma tiles, the smoke config's chunks of 16
    check_ssd(8, 4096, 50, 64, 16, 128, False, torch.bfloat16, device)
    check_ssd(1, 77, 2, 13, 9, 32, True, torch.float32, device)
    check_ssd(3, 100, 12, 32, 16, 16, True, torch.bfloat16, device)
    # the ssm and dense families' serving shapes: gemma2-9b's local layers (16 kv
    # heads, D 256, softcap 50, the 4,096-slot ring wrapped) and global layers (every
    # position, no window), mistral-nemo-12b / chatglm3-6b (G 2, D 128), qwen1.5-0.5b
    # (G 1, D 64); mamba2-130m's prefill
    for dtype in (torch.bfloat16, torch.float32):
        check_swa(2, 4096, 16, 1, 256, 4096, 50.0, (4176, 4170), dtype, device)
        check_swa(2, 4176, 16, 1, 256, 0, 50.0, (4176, 4170), dtype, device)
        check_swa(2, 520, 16, 2, 128, 0, 0.0, (520, 513), dtype, device)
        check_swa(4, 2080, 16, 1, 64, 0, 0.0, (2080,) * 4, dtype, device)
        check_ssd(4, 2048, 24, 64, 128, 128, False, dtype, device)
    # the moe and vlm families' serving shapes: mixtral-8x7b's 4,096-slot window ring
    # wrapped (G 2, D 128), phi3.5-moe's full attention at B 4, internvl2-76b's G 4
    for dtype in (torch.bfloat16, torch.float32):
        check_swa(2, 4096, 16, 2, 128, 4096, 0.0, (4176, 4170), dtype, device)
        check_swa(4, 2080, 16, 2, 128, 0, 0.0, (2080, 2079, 1500, 2080), dtype, device)
        check_swa(2, 784, 16, 4, 128, 0, 0.0, (784, 700), dtype, device)
    # whisper-small's decode: the self ring of 64 slots wrapped at position 94, and
    # the cross-attention over 1,500 frames (not a multiple of the 128-slot split)
    # with the query at frame 1,499, so that every frame is visible
    for dtype in (torch.bfloat16, torch.float32):
        check_swa(4, 64, 12, 1, 64, 0, 0.0, (95,) * 4, dtype, device)
        check_swa(4, 1500, 12, 1, 64, 0, 0.0, (1500,) * 4, dtype, device)
    main_err["pairwise_cosine"] = 0.0
    # the reference's shapes (tests/test_kernels.py): 128 / 512 tile edges,
    # one row, D = 1; the stage-3 shape is (100, 1024)
    for n, d in ((7, 64), (100, 1024), (128, 512), (33, 2000), (127, 511), (129, 513),
                 (1, 512), (256, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            e = check_gram(n, d, dtype, device)
            if (n, d) == (100, 1024) and dtype == torch.float32:
                main_err["pairwise_cosine"] = e
    check_gram(100, 1024, torch.float32, device, zero_row=37)
    check_gram(9, 300, torch.bfloat16, device, zero_row=0)
    # the launch plan's edges: 32 x 32 tiles at and past a tile edge with D
    # split 1-16 ways, unsplit up to N = 1920, 128 x 128 tiles from N = 1921
    for n, d in ((1, 33), (32, 64), (33, 64), (65, 100), (97, 33), (200, 128), (960, 64),
                 (961, 64), (1920, 64), (1921, 64), (2000, 96)):
        check_gram(n, d, torch.float32, device, zero_row=n // 2)
    # 49,141 upper tiles: the tile index decodes exactly (a float square root
    # alone is off by one near there)
    check_gram(40_000, 32, torch.float32, device, zero_row=12_345)
    torch.cuda.empty_cache()
    for n, m, d in ((128, 256, 512), (33, 100, 2000), (1, 5, 1), (100, 7, 1024), (40, 50, 1000),
                    (700, 900, 256), (2100, 1900, 64)):
        check_gram_nt(n, m, d, device)

    # ---- 4. main path ----------------------------------------------------
    phase("main path: FLSimulation ring / contextual / mnist on cuda")
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.core.scenarios import scenario_config
    from repro_torch.fl.simulation import FLSimulation
    from repro_torch.utils import prng

    # launch_fl_sim.run_experiment's defaults for mnist (paper section IV-A)
    fl = FLConfig(num_clients=100, local_epochs=3, connection_rate=1.0,
                  classes_per_client=2, samples_per_client=256, num_clusters=10,
                  aggregator="fedavg", seed=0, compute_dtype="float32")
    traffic = scenario_config("ring", num_vehicles=100)
    t0 = time.perf_counter()
    sim = FLSimulation(get_config("fl-mnist-mlp"), fl, traffic, "mnist", "contextual",
                       prng.key(0), device=device)
    torch.cuda.synchronize()
    print(f"set-up (init + client shards on the card): {time.perf_counter() - t0:.2f} s; "
          f"P={sim.state.params.numel()} N={fl.num_clients} K={fl.n_select}")

    states, records, launches = drive(sim, "fedavg_reduce")
    state0 = states[0]
    replay(sim, state0, records[0], traffic, params_atol=1e-5)

    # ---- 4b. the aggregator lanes --------------------------------------------
    phase("aggregator lanes: FLSimulation at CR 0.7 under each server rule on cuda")
    from repro_torch.fl.aggregators import AGGREGATOR_ORDER, FEDBUFF_IDX
    from repro_torch.fl.rounds import RoundMetrics, make_round_step, metrics_to_records

    lane_sims, lane_launches = {}, {}
    for lane in LANES:
        # Table I's connection rate 0.7: some of the cohort miss the
        # deadline, so stale reweights, fedbuff parks and drains
        fl_lane = dataclasses.replace(fl, aggregator=lane, connection_rate=0.7)
        sim_lane = FLSimulation(get_config("fl-mnist-mlp"), fl_lane, traffic, "mnist",
                                "contextual", prng.key(0), device=device)
        server = "server_update_buffered" if lane == "fedbuff" else "server_update"
        print(f"-- {lane} ({server})")
        lane_states, recs, lane_launches[lane] = drive(sim_lane, server)
        s0 = lane_states[0]
        if lane == "fedbuff":
            parked = sum(r.n_buffered for r in recs)
            landed = sum(r.n_drained for r in recs)
            if not (parked and landed):
                raise AssertionError(f"fedbuff at CR 0.7: {parked} parked, {landed} drained")
        # the adaptive rules' step m / (sqrt(v) + tau) magnifies the card-vs-CPU
        # drift of the update sum by up to (1 - beta1) / tau = 100
        replay(sim_lane, s0, recs[0], traffic,
               params_atol=1e-4 if lane in ("fedadam", "fedyogi") else 1e-5,
               acc_atol=1e-3)  # two of the 2,000 test images
        lane_sims[lane] = sim_lane

    # contract (a): the full registry at index 0 is the ("fedavg",) round;
    # fedbuff with its buffer disabled (fill at the cohort, CR 1.0) is too
    K = fl.n_select
    general = make_round_step(sim.api.loss, fl, K, sim.model_bytes, sim.param_spec,
                              ("contextual",), aggregators=AGGREGATOR_ORDER)
    fedavg_round = sim._step(state0, sim.scn, 0, 0, sim.data, True)
    assert_rounds_bitwise(general(state0, sim.scn, 0, 0, sim.data, True), fedavg_round,
                          "full registry at index 0 vs the ('fedavg',) round")
    off = make_round_step(sim.api.loss, dataclasses.replace(fl, buffer_fill=K), K,
                          sim.model_bytes, sim.param_spec, ("contextual",),
                          aggregators=AGGREGATOR_ORDER)
    s_off, m_off = off(state0, sim.scn, 0, FEDBUFF_IDX, sim.data, True)
    if not (int(m_off.n_succeeded) == int(m_off.n_selected) > 0
            and int(m_off.n_buffered) == 0):
        raise AssertionError("disabled-buffer premise: a straggler at CR 1.0")
    assert_rounds_bitwise((s_off, m_off), fedavg_round,
                          "fedbuff with the buffer disabled vs the ('fedavg',) round")

    # ---- 4c. the two-tier lanes at the paper setting ---------------------------
    phase("two-tier lanes: hierarchical and client_block=4 streaming, N=100, on cuda")
    hier = make_round_step(sim.api.loss, dataclasses.replace(fl, hierarchical=True), K,
                           sim.model_bytes, sim.param_spec, ("contextual",))
    assert_rounds_bitwise(hier(state0, sim.scn, 0, 0, sim.data, True), fedavg_round,
                          "contract (a): hierarchical ('fedavg',) round vs the flat one")
    fl07 = dataclasses.replace(fl, connection_rate=0.7)
    flat07, hier07 = (make_round_step(sim.api.loss, dataclasses.replace(fl07, hierarchical=h),
                                      K, sim.model_bytes, sim.param_spec, ("contextual",),
                                      aggregators=AGGREGATOR_ORDER) for h in (False, True))
    s07 = lane_sims["fedbuff"].state  # CR 0.7, the ring occupied
    for rule, name in enumerate(AGGREGATOR_ORDER):
        assert_rounds_bitwise(hier07(s07, sim.scn, 0, rule, sim.data, True),
                              flat07(s07, sim.scn, 0, rule, sim.data, True),
                              f"contract (a): hierarchical vs flat, full registry, {name}, CR 0.7")

    streamed_sims, two_tier_launches = {}, {}
    for label, scenario, agg, cr, spacing in (
            ("ring/fedavg", "ring", "fedavg", 1.0, None),
            ("ring/fedbuff", "ring", "fedbuff", 0.7, None),
            ("rsu_outage/fedavg", "rsu_outage", "fedavg", 1.0, None),
            # an RSU every 250 m: R = 40, past one 32-RSU group of rsu_reduce
            ("ring R=40/fedavg", "ring", "fedavg", 0.7, 250.0)):
        fl_s = dataclasses.replace(fl, aggregator=agg, connection_rate=cr, hierarchical=True,
                                   client_block=4)
        traffic_s = scenario_config(scenario, num_vehicles=100,
                                    **({} if spacing is None else {"rsu_spacing_m": spacing}))
        sim_s = FLSimulation(get_config("fl-mnist-mlp"), fl_s, traffic_s, "mnist",
                             "contextual", prng.key(0), device=device)
        server = "server_update_buffered" if agg == "fedbuff" else "fedavg_reduce"
        n_chunks = -(-K // fl_s.client_block)
        print(f"-- {label} at CR {cr}: R={sim_s.scn.n_rsu}, K={K} in {n_chunks} chunks of "
              f"{fl_s.client_block} ({server})")
        st, recs, two_tier_launches[label] = drive(sim_s, server, rsu_per_round=n_chunks)
        # each round against the unblocked hierarchical round from the same
        # state: the economics bit for bit, the model within 1e-6 (the
        # cohort sum reassociates per RSU and chunk)
        unblocked = make_round_step(sim_s.api.loss, dataclasses.replace(fl_s, client_block=0),
                                    K, sim_s.model_bytes, sim_s.param_spec, ("contextual",),
                                    aggregators=(agg,))
        worst = 0.0
        for i, rec in enumerate(recs):
            s_u, m_u = unblocked(st[i], sim_s.scn, 0, 0, sim_s.data, True)
            u_rec = metrics_to_records(RoundMetrics(*[x[None] for x in m_u]))[0]
            for f in ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained",
                      "duration", "sim_time", "mean_pred_latency", "mean_real_latency"):
                if getattr(u_rec, f) != getattr(rec, f):
                    raise AssertionError(f"{label} round {rec.round}: {f} "
                                         f"{getattr(rec, f)} != unblocked {getattr(u_rec, f)}")
            for f in ("sketch_age", "clusters", "buf_mask"):
                if not torch.equal(getattr(s_u, f), getattr(st[i + 1], f)):
                    raise AssertionError(f"{label} round {rec.round}: {f} differs")
            torch.testing.assert_close(st[i + 1].params, s_u.params, rtol=0, atol=1e-6)
            worst = max(worst, float((st[i + 1].params - s_u.params).abs().max()))
        print(f"{label}: economics bitwise the unblocked hierarchical lane's in every round, "
              f"max |dparams| = {worst:.3e}")
        if agg == "fedbuff" and not (sum(r.n_buffered for r in recs) and
                                     sum(r.n_drained for r in recs)):
            raise AssertionError(f"{label}: the ring neither parked nor drained")
        replay(sim_s, st[0], recs[0], traffic_s, params_atol=1e-5, acc_atol=1e-3)
        streamed_sims[label] = sim_s

    # ---- 4d. fleet rounds ---------------------------------------------------
    from repro_torch.core import messages
    from repro_torch.core.fusion import fuse_kinematics
    from repro_torch.fl import ExperimentEngine
    from repro_torch.fl.engine import _eval_flags, _recluster_flags

    fleet_launches, fleet_runs = {}, {}
    for n, n_rounds in FLEET:
        phase(f"fleet: N={n}, {n_rounds} round(s) through ExperimentEngine, hierarchical, "
              "client_block=32, no warm-up")
        # benchmarks/engine_throughput.py::fleet's settings and engine
        fl_f = FLConfig(num_clients=n, samples_per_client=2, batch_size=2, num_clusters=8,
                        local_epochs=1, sketch_dim=64,
                        select_fraction=min(max(100.0 / n, 1e-6), 1.0), hierarchical=True,
                        client_block=32, aggregator="fedavg", seed=0)
        traffic_f = scenario_config("ring", num_vehicles=n)
        eng_f = ExperimentEngine(get_config("fl-mnist-mlp"), fl_f, "mnist",
                                 strategies=("contextual",), aggregators=("fedavg",),
                                 warmup=False, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by the earlier phases
        # the engine's run as ``run_grid`` makes it: its set-up (``_lanes``), then
        # its round loop (``_sweep``'s), one grid round at a time so each is timed
        t0 = time.perf_counter()
        lanes_f = eng_f._lanes([("contextual", "fedavg", 0, "ring")])
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated() - held
        state_f0, scn_f0, data_f0 = lanes_f.states[0], lanes_f.scns[0], lanes_f.rows[0]
        torch.cuda.reset_peak_memory_stats()
        held_rounds = torch.cuda.memory_allocated()
        reset_launches()
        rows0 = messages.dense_rows
        walls, ms_f = [], []
        for do_eval, do_recluster in zip(_eval_flags(n_rounds, n_rounds),
                                         _recluster_flags(n_rounds, fl_f.recluster_every)):
            t0 = time.perf_counter()
            ms_f.append(RoundMetrics(*[x[0] for x in eng_f._grid_round(
                lanes_f, do_eval, do_recluster)]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        fleet_launches[n] = launches_f = read_launches()
        rows = messages.dense_rows - rows0
        round_peak = torch.cuda.max_memory_allocated() - held_rounds
        recs = metrics_to_records(RoundMetrics(*[torch.stack(xs) for xs in zip(*ms_f)]))
        fleet_runs[n] = (fl_f, traffic_f, setup_peak, round_peak)
        n_chunks = -(-fl_f.n_select // fl_f.client_block)
        for rec in recs:
            print(json.dumps(rec.__dict__))
        print(f"engine set-up (_lanes: init, data row) {setup_s:.2f} s, peak "
              f"{setup_peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB the earlier phases "
              f"hold; N={n} K={fl_f.n_select} in {n_chunks} chunks of {fl_f.client_block}; "
              f"round walls {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms "
              f"({n_rounds / sum(walls):.3f} rounds/s), peak memory in the rounds "
              f"{round_peak / 2**30:.2f} GiB above the {held_rounds / 2**30:.2f} GiB held "
              f"before them; launches: {launches_f}; neighbour rows recomputed densely: {rows} "
              f"of {n * n_rounds} [{card}]")
        want = dict.fromkeys(launches_f, 0)
        want.update(rttg_latency=2 * n_rounds, rsu_reduce=n_chunks * n_rounds,
                    fedavg_reduce=n_rounds)
        if launches_f != want:
            raise AssertionError(f"expected {want}, got {launches_f}")
        check_records(lanes_f.states[0], recs, eval_rounds={n_rounds})
        del lanes_f
        if n != FLEET[0][0]:
            continue
        # the first round again from its state: the windowed search and compact
        # fusion (it must repeat the engine's round bitwise), then the dense forms
        rk = prng.fold_in(state_f0.key, state_f0.round)
        k_obs = prng.fold_in_str(rk, "observe")
        forms, saved = {}, messages.DENSE_MAX_N
        for form, limit in (("windowed", saved), ("dense", n)):
            messages.DENSE_MAX_N = limit
            try:
                cpms = messages.emit_cpms(state_f0.twin, scn_f0, k_obs)
                kin = fuse_kinematics(messages.emit_cams(state_f0.twin, scn_f0, k_obs), cpms,
                                      scn_f0)
                s_x, m_x = eng_f._round_step(state_f0, scn_f0, 0, 0, data_f0, True)
            finally:
                messages.DENSE_MAX_N = saved
            forms[form] = (cpms["obj"], kin, s_x,
                           metrics_to_records(RoundMetrics(*[x[None] for x in m_x]))[0])
        (obj_w, kin_w, s_w, rec_w), (obj_d, kin_d, s_d, rec_d) = forms["windowed"], forms["dense"]
        if rec_w != recs[0]:
            raise AssertionError(f"fleet N={n}: the round replayed on the card differs")
        if not torch.equal(obj_w, obj_d):
            raise AssertionError(f"fleet N={n}: the windowed neighbours differ from the dense")
        # fused positions ~1e4 m (an ulp ~1e-3 m); the dense table sums N
        # columns in a tree, the compact one its few slots in sequence
        for name, a, b, atol in zip(("pos", "speed", "accel", "pos_var"), kin_w, kin_d,
                                    (1e-2, 1e-5, 1e-5, 1e-7)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=atol,
                                       msg=lambda m: f"fleet N={n} fused {name}: {m}")
        for f in ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained"):
            if getattr(rec_w, f) != getattr(rec_d, f):
                raise AssertionError(f"fleet N={n} dense vs windowed: {f} differs")
        for f in ("sketch_age", "clusters"):
            if not torch.equal(getattr(s_w, f), getattr(s_d, f)):
                raise AssertionError(f"fleet N={n} dense vs windowed: {f} differs")
        torch.testing.assert_close(s_w.params, s_d.params, rtol=0, atol=1e-6)
        print(f"fleet N={n}: the engine's round repeats bitwise from its initial state; dense "
              f"vs windowed neighbours equal, integers equal, max |dpos| = "
              f"{float((kin_w[0] - kin_d[0]).abs().max()):.3e} m")
    # phase 5 profiles a fleet round from the initial state
    fleet_n = n
    fleet_step = lambda: eng_f._round_step(state_f0, scn_f0, 0, 0, data_f0, False)  # noqa: E731

    # ---- 4e. serving ---------------------------------------------------------
    phase("serving: hymba-1.5b at full width, bf16, B=4, prompt 2048, gen 32")
    served, serve_launches = serve_full(device, card)
    phase("serving: the path on the card vs the plain path on the CPU")
    main_err["path"] = {dt: path_vs_plain(dt, device) for dt in ("float32", "bfloat16")}
    phase("serving: decode vs prefill on the card")
    decode_vs_prefill(device)
    torch.cuda.empty_cache()
    phase("serving: the families' paths on the card vs the plain path on the CPU")
    # mamba2-130m: a ragged last chunk (300 = 2 x 128 + 44); gemma2-9b: one local and
    # one global layer, 4 past the 4,096 window (one row: the CPU's share of the
    # time); chatglm3-6b: the 2d rope, the bias, G = 2
    for arch, S, batch in (("mamba2-130m", 300, 2), ("gemma2-9b", 4100, 1),
                           ("chatglm3-6b", 600, 2)):
        for dt in ("float32", "bfloat16"):
            path_vs_plain(dt, device, arch, S, batch)
        torch.cuda.empty_cache()
    phase("serving: mamba2-130m decode vs prefill on the card")
    decode_vs_prefill(device, "mamba2-130m")
    torch.cuda.empty_cache()
    phase("serving: one MoE layer at full width on the card vs the CPU, a skewed input")
    for arch in ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b"):
        for dt in ("float32", "bfloat16"):
            moe_layer_vs_cpu(dt, device, arch)
        torch.cuda.empty_cache()
    phase("serving: the moe and vlm families' paths on the card vs the plain path on the CPU")
    # mixtral-8x7b: 600 tokens, G 2 through its window; phi3.5-moe: 16 experts;
    # internvl2-76b: 300 tokens after its 256 image embeddings, G 4
    for arch, S, batch in (("mixtral-8x7b", 600, 2), ("phi3.5-moe-42b-a6.6b", 600, 2),
                           ("internvl2-76b", 300, 2)):
        for dt in ("float32", "bfloat16"):
            path_vs_plain(dt, device, arch, S, batch)
        torch.cuda.empty_cache()
    phase("serving: the encdec family's path on the card vs the plain path on the CPU")
    # whisper-small: 2 + 2 layers, 4 x 64 behind 1,500 frames, the 64-slot ring wrapping
    for dt in ("float32", "bfloat16"):
        path_vs_plain(dt, device, "whisper-small", 64, 4)
    torch.cuda.empty_cache()

    # ---- 4f. the four-stage pipeline, stage by stage ---------------------------
    phase("pipeline: python -m repro_torch.launch.quickstart on cuda (N=40)")
    from repro_torch.launch import quickstart

    t0 = time.perf_counter()
    qs = quickstart.run(device)
    torch.cuda.synchronize()
    qs_s = time.perf_counter() - t0
    qs_cpu = quickstart.run("cpu", verbose=False)
    if (qs["elected"], qs["cluster_sizes"]) != (qs_cpu["elected"], qs_cpu["cluster_sizes"]):
        raise AssertionError(f"quickstart card vs CPU: elected {qs['elected']} vs "
                             f"{qs_cpu['elected']}, sizes {qs['cluster_sizes']} vs "
                             f"{qs_cpu['cluster_sizes']}")
    for f in ("acc_before", "acc_after"):
        if abs(qs[f] - qs_cpu[f]) > 2e-3:  # four of the 2,000 test images
            raise AssertionError(f"quickstart card vs CPU: {f} {qs[f]} vs {qs_cpu[f]}")
    print(f"quickstart on the card in {qs_s:.2f} s; card vs CPU: elected ids and cluster "
          f"sizes equal, accuracies {qs['acc_before']:.4f} -> {qs['acc_after']:.4f} vs "
          f"{qs_cpu['acc_before']:.4f} -> {qs_cpu['acc_after']:.4f} [{card}]")
    phase("pipeline: ContextualSelector at full width (ring, N=100, sketch_dim 1024, "
          "fl-mnist-mlp updates), 3 rounds")
    sel_run = selector_rounds(device, card)
    phase("pipeline: a selector round on the card vs the CPU's plain path")
    selector_replay_cpu(sel_run)
    phase("pipeline: the unfused round lane vs the fused lane on the card")
    fused_vs_unfused(sim, state0)

    # ---- 4g. the bf16 lane ----------------------------------------------------
    bf16_sims, bf16_launches = bf16_lane(fl, traffic, records, fleet_runs, device, card)

    # ---- 4h. the experiment engine ---------------------------------------------
    grid_launches = engine_phase(device, card)

    # ---- 4i. the CNN datasets ----------------------------------------------------
    path_launches = cnn_phase(fl, records, device, card)
    grid_launches["cifar10"] = path_launches.pop("engine cifar10 grid")

    # ---- 4j. Dirichlet shards and the two remaining examples -----------------
    grid_launches["dirichlet"], example_launches = dirichlet_and_examples_phase(device, card)
    path_launches.update(example_launches)

    def by_path(name, first, first_path="the main path"):
        """The parts of a kernel's ``launches``: ``first`` on ``first_path``,
        one sweep of each engine grid and each CNN or example path that
        launched it."""
        return {first_path: first,
                **{f"engine {grid} grid": g[name] for grid, g in grid_launches.items() if g[name]},
                **{path: c[name] for path, c in path_launches.items() if c[name]}}

    # ---- 5. times ----------------------------------------------------------
    phase(f"times on {card}")
    from repro_torch.kernels.build import library
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce_plain
    from repro_torch.kernels.rttg_latency import (launch_blocks, rttg_latency_plain,
                                                  scenario_operand)
    from repro_torch.core.trajectory import horizon_steps

    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    kernels = []

    # rttg_latency's C entry point with its operands prepared: the main path's
    # predicted call (N=100, R=10, 50 predictor steps, CR = 1, no rid), its
    # realized call (0 steps) and the fleet's predicted call (N=100,000)
    mb = torch.tensor(636_040.0, device=device)
    times = {}
    for label, n, predict in (("predict", 100, True), ("realized", 100, False),
                              ("fleet", 100_000, True)):
        scn, pos, speed, accel, t, _ = rttg_inputs("ring", n, 3, 1.0, device)
        R = scn.n_rsu
        op = scenario_operand(scn, device)
        blocks = launch_blocks(lib, device, n, R)
        counts = kbuild.counters(device, "rttg_latency", R + 2)
        spill = torch.empty((3 * n,), dtype=torch.int32, device=device)
        lat = torch.empty((n,), dtype=torch.float32, device=device)
        conn = torch.empty((n,), dtype=torch.bool, device=device)
        steps = horizon_steps(scn.predict_horizon_s, scn)
        ns = steps if predict else 0
        hs = float(scn.predict_horizon_s) if predict else 0.0

        def launch(op=op, R=R, t=t, pos=pos, speed=speed, accel=accel, n=n, ns=ns, hs=hs,
                   blocks=blocks, counts=counts, spill=spill, lat=lat, conn=conn, dt=scn.sim_dt_s):
            kbuild.check(lib.rttg_latency_launch(
                op.data_ptr(), R, t.data_ptr(), mb.data_ptr(), pos.data_ptr(), speed.data_ptr(),
                accel.data_ptr(), None, n, ns, float(dt), hs, blocks, counts.data_ptr(),
                spill.data_ptr(), lat.data_ptr(), conn.data_ptr(), None, stream),
                "rttg_latency")

        plain_args = (pos, speed, accel, t, mb, None, scn, predict)
        times[label] = (
            time_ms(launch),
            time_ms(lambda a=plain_args: rttg_latency_plain(*a), iters=20, warmup=3),
            device_us_per_call(launch),
            blocks,
        )
    n, R = 100, 10
    # bytes: 3 f32 inputs, 17 scalars, R live flags, t and model_bytes in; f32
    # lat and bool conn out
    rttg_bytes = n * 4 * 3 + 17 * 4 + R + 2 * 4 + n * 4 + n
    # flops per client: 8 per predictor step, 6 per RSU in the argmin, ~45 in
    # the latency/SNR/congestion tail (counting each transcendental as one)
    rttg_flops = n * (8 * steps + 6 * R + 45)
    b_ms, b_by = bound(rttg_bytes, rttg_flops)
    kernels.append({
        "name": "rttg_latency", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rttg_latency.cu",
        "replaces": "src/repro/kernels/rttg_latency.py:242",
        # the main path's and one sweep of each engine grid's (phase 4h)
        "launches": sum(by_path("rttg_latency", launches["rttg_latency"]).values()),
        "launches_by_path": by_path("rttg_latency", launches["rttg_latency"]),
        "max_abs_err": main_err["rttg_latency"],
        "ms": times["predict"][0], "plain_ms": times["predict"][1], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
    })
    for label, what in (("predict", "N=100 R=10 predict (50 steps)"),
                        ("realized", "N=100 R=10 realized (0 steps)"),
                        ("fleet", "N=100,000 R=10 predict (50 steps)")):
        ms, plain_ms, dev_us, blocks = times[label]
        print(f"rttg_latency {what}, {blocks} block(s), one launch: kernel {ms * 1e3:.2f} us "
              f"(device time {dev_us:.2f} us), plain {plain_ms * 1e3:.1f} us"
              + (f", bound {b_ms * 1e3:.5f} us ({b_by})" if label == "predict" else "")
              + f" [{card}]")
    wrapper_times(device, card)

    # fedavg_reduce at K=10, P=159,010; cycle through copies that together
    # exceed the 50 MB L2, so each launch streams its rows from HBM
    K, P = 10, 159_010
    n_copies = 16
    us = [1e-3 * prng.normal(prng.fold_in(prng.key(11), i), (K, P), device)
          for i in range(n_copies)]
    # the bf16 rows: twice the copies, so they too exceed the L2
    us16 = [x.to(torch.bfloat16) for x in us] + [
        (1e-3 * prng.normal(prng.fold_in(prng.key(12), i), (K, P), device)).to(torch.bfloat16)
        for i in range(n_copies)]
    w = torch.full((K,), 0.1, dtype=torch.float32, device=device)
    out = torch.empty((P,), dtype=torch.float32, device=device)
    vec = 2 if P % 2 == 0 else 1
    it = {"i": 0}

    def nxt(rows=us):
        it["i"] = (it["i"] + 1) % len(rows)
        return rows[it["i"]]

    def fed_launch(rows=us):
        u_ = nxt(rows)
        kbuild.check(lib.fedavg_reduce_launch(u_.data_ptr(), u_.element_size(), w.data_ptr(), K,
                                              P, vec, out.data_ptr(), stream), "fedavg_reduce")

    fed_ms = time_ms(fed_launch)
    fed_plain = time_ms(lambda: fedavg_reduce_plain(nxt(), w))
    fed_lib = time_ms(lambda: torch.mv(nxt().t(), w))
    fed_dev = (device_us_per_call(fed_launch), device_us_per_call(lambda: torch.mv(nxt().t(), w)))
    fed_bytes = K * P * 4 + K * 4 + P * 4
    b_ms, b_by = bound(fed_bytes, 2 * K * P)
    kernels.append({
        "name": "fedavg_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/fedavg_reduce.py:43",
        "launches": sum(by_path("fedavg_reduce", launches["fedavg_reduce"]).values()),
        "launches_by_path": by_path("fedavg_reduce", launches["fedavg_reduce"]),
        "max_abs_err": main_err["fedavg_reduce"],
        "ms": fed_ms, "plain_ms": fed_plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": fed_lib,
    })
    print(f"fedavg_reduce K={K} P={P} (vec {vec}): kernel {fed_ms * 1e3:.2f} us, plain "
          f"{fed_plain * 1e3:.2f} us, torch.mv {fed_lib * 1e3:.2f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}), {fed_bytes / (fed_ms * 1e-3) / 1e9:.0f} GB/s; device "
          f"time per call (profiler): kernel {fed_dev[0]:.2f} us, torch.mv {fed_dev[1]:.2f} us "
          f"[{card}]")
    # the bf16 lane's rows: the kernel reads 2-byte rows (no library call
    # computes bf16 rows into an fp32 sum in one call: torch.mv would need
    # the rows upcast first)
    fed16 = (time_ms(lambda: fed_launch(us16)),
             time_ms(lambda: fedavg_reduce_plain(nxt(us16), w)),
             device_us_per_call(lambda: fed_launch(us16)))
    fed16_bytes = K * P * 2 + K * 4 + P * 4
    b16 = bound(fed16_bytes, 2 * K * P)
    bf16_times = {"fedavg_reduce": fed16 + (b16, fed16_bytes)}
    print(f"fedavg_reduce K={K} P={P} bf16 rows (vec {vec}): kernel {fed16[0] * 1e3:.2f} us "
          f"(device time {fed16[2]:.2f} us, fp32 rows {fed_dev[0]:.2f} us), plain "
          f"{fed16[1] * 1e3:.2f} us, bound {b16[0] * 1e3:.2f} us ({b16[1]}, "
          f"{fed16_bytes / 1e6:.2f} MB; fp32 rows {b_ms * 1e3:.2f} us), "
          f"{fed16_bytes / fed16[2] / 1e3:.0f} GB/s by device time [{card}]")

    time_grid_kernels(kernels, lib, grid_launches, main_err, bf16_times, device, card)
    time_cnn_reduces(kernels, lib, main_err, device, card)
    time_server_grid(kernels, lib, grid_launches, main_err, device, card)
    time_rsu_grid(kernels, lib, grid_launches, main_err, bf16_times, device, card)

    # server_update (fedadam, rule 2) and server_update_buffered (fedbuff,
    # rule 5, draining all Kb = 8 ring rows) at K=10, P=159,010, cycling
    # through operand sets that together exceed the L2, as above
    from repro_torch.fl.aggregators import ServerHP
    from repro_torch.kernels.server_update import (
        MOMENT_RULES, server_update, server_update_buffered, server_update_buffered_plain,
        server_update_plain)

    Kb = fl.buffer_size
    sets = [server_operands(K, P, 100 + i, device) for i in range(n_copies)]
    rings = [server_operands(Kb, P, 200 + i, device)[:2] for i in range(n_copies)]
    # the bf16 lane's rows and ring over the fp32 master and moments
    sets16 = [(u.to(torch.bfloat16), *rest) for u, *rest in sets]
    rings16 = [(ring.to(torch.bfloat16), bw) for ring, bw in rings]
    outs = [torch.empty((P,), dtype=torch.float32, device=device) for _ in range(3)]
    on = torch.tensor(True, device=device)
    hp = ServerHP()

    def nxt_set(half=False):
        it["i"] = (it["i"] + 1) % n_copies
        return (sets16 if half else sets)[it["i"]], (rings16 if half else rings)[it["i"]]

    def su_launch(rule, buffered, half=False):
        (u, w_, p_, m_, v_), (ring, bw) = nxt_set(half)
        ring_args = (ring.data_ptr(), bw.data_ptr(), Kb, on.data_ptr()) if buffered \
            else (None, None, 0, None)
        kbuild.check(lib.server_update_launch(
            u.data_ptr(), u.element_size(), w_.data_ptr(), K, *ring_args, P, p_.data_ptr(),
            p_.element_size(), m_.data_ptr(), v_.data_ptr(), rule, 0, hp.eta, hp.beta1,
            1.0 - hp.beta1, hp.beta2, 1.0 - hp.beta2, hp.tau, vec,
            *[o.data_ptr() for o in outs], stream), "server_update")

    def su_plain(rule, buffered, half=False):
        (u, w_, p_, m_, v_), (ring, bw) = nxt_set(half)
        if buffered:
            return server_update_buffered_plain(u, w_, ring, bw, p_, m_, v_, rule, 0, on)
        return server_update_plain(u, w_, p_, m_, v_, rule, 0)

    def su_wrapper(rule, buffered):
        (u, w_, p_, m_, v_), (ring, bw) = nxt_set()
        if buffered:
            return server_update_buffered(u, w_, ring, bw, p_, m_, v_, rule, 0, on)
        return server_update(u, w_, p_, m_, v_, rule, 0)

    su_runs = {"server_update": (2, False, 0, sum(
                   lane_launches[x]["server_update"] for x in LANES)),
               "server_update_buffered": (5, True, Kb, lane_launches["fedbuff"][
                   "server_update_buffered"] + grid_launches["async"]["server_update_buffered"])}
    su_paths = {"server_update_buffered": by_path(
        "server_update_buffered", lane_launches["fedbuff"]["server_update_buffered"],
        "the fedbuff lane")}
    # two passes over the pair, each kernel timed in turn; the first pass is a
    # warm-up (a call's first server timing reads slow), the second is kept
    su_times, su16 = {}, {}
    for _ in range(2):
        for name, (rule, buffered, _rows, _n) in su_runs.items():
            su_times[name] = (time_ms(lambda: su_launch(rule, buffered)),
                              time_ms(lambda: su_plain(rule, buffered)),
                              time_ms(lambda: su_wrapper(rule, buffered)),
                              device_us_per_call(lambda: su_launch(rule, buffered)))
            su16[name] = (time_ms(lambda: su_launch(rule, buffered, True)),
                          time_ms(lambda: su_plain(rule, buffered, True)),
                          device_us_per_call(lambda: su_launch(rule, buffered, True)))
    for name, (rule, buffered, rows_b, n_launch) in su_runs.items():
        ms, plain_ms, wrap_ms, dev_us = su_times[name]
        rows = K + rows_b
        # each input read once (rows, weights, drain flag, params, and m, v
        # under a moment rule), each output written once (params', and m', v'
        # under a moment rule: the AXPY rules leave the moments untouched);
        # 2 flops per row value plus ~12 per column for a moment rule, 1 for the AXPY
        moments = rule in MOMENT_RULES
        su_bytes = (rows * P * 4 + rows * 4 + (1 if buffered else 0)
                    + (6 if moments else 2) * P * 4)
        b_ms, b_by = bound(su_bytes, 2 * rows * P + (12 if moments else 1) * P)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/server_update.cu",
            "replaces": "src/repro/kernels/server_update.py:124" if not buffered
            else "src/repro/kernels/server_update.py:164",
            "launches": n_launch, **({"launches_by_path": su_paths[name]}
                                     if name in su_paths else {}),
            "max_abs_err": main_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        print(f"{name} K={K} Kb={rows_b} P={P} rule {rule} (vec {vec}): kernel "
              f"{ms * 1e3:.2f} us (device time {dev_us:.2f} us), wrapper {wrap_ms * 1e3:.2f} us, "
              f"plain {plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}), "
              f"{su_bytes / (ms * 1e-3) / 1e9:.0f} GB/s [{card}]")
        # the same call on bf16 rows (and ring), the master and moments fp32
        b16_bytes = su_bytes - rows * P * 2
        b16 = bound(b16_bytes, 2 * rows * P + (12 if moments else 1) * P)
        bf16_times[name] = su16[name] + (b16, b16_bytes)
        print(f"{name} K={K} Kb={rows_b} P={P} rule {rule} bf16 rows, fp32 master: kernel "
              f"{su16[name][0] * 1e3:.2f} us (device time {su16[name][2]:.2f} us, fp32 rows "
              f"{dev_us:.2f} us), plain {su16[name][1] * 1e3:.2f} us, bound {b16[0] * 1e3:.2f} us "
              f"({b16[1]}, {b16_bytes / 1e6:.2f} MB), {b16_bytes / su16[name][2] / 1e3:.0f} GB/s "
              f"by device time [{card}]")

    # rsu_reduce at the streamed lanes' chunks: R=10, the paper's K=4 and the
    # fleet's K=32, each with its carry (the steady chunk) and the first
    # chunk without one, cycling through copies that exceed the L2 as above
    from repro_torch.kernels.rsu_reduce import rsu_reduce, rsu_reduce_plain, vector_width

    R = 10
    rsu_times = {}
    for K_c in (4, 32):
        ops = [rsu_operands(K_c, P, R, "rand", device) for _ in range(n_copies)]
        # the bf16 lane's chunk: bf16 rows into bf16 partials and carry
        ops16 = [(u_.to(torch.bfloat16), w_, rid_, c_.to(torch.bfloat16))
                 for u_, w_, rid_, c_ in ops]
        routes = [torch.nn.functional.one_hot(rid_.long(), R).float() * w_[:, None]
                  for _, w_, rid_, _ in ops]
        out_c = torch.empty((R, P), dtype=torch.float32, device=device)
        out16 = torch.empty((R, P), dtype=torch.bfloat16, device=device)
        mass_c = torch.empty((R,), dtype=torch.float32, device=device)
        vec_c = vector_width(P, ops[0][0], out_c)
        if vector_width(P, ops16[0][0], out16) != vec_c:
            raise AssertionError("the bf16 chunk takes another vector width")
        rows_c = torch.empty((K_c, P), dtype=torch.float32, device=device)
        # the carry rows the ids touch, counted before the timed launches
        carry_rows = sum(rsu_carry_rows(rid_, R, u_, c_) for u_, _, rid_, c_ in ops) / n_copies

        def nxt_rsu(half=False):
            it["i"] = (it["i"] + 1) % n_copies
            return (ops16 if half else ops)[it["i"]], routes[it["i"]]

        def rsu_launch(with_carry, half=False, K_c=K_c):
            (u_, w_, rid_, c_), _ = nxt_rsu(half)
            out_ = c_ if with_carry else out16 if half else out_c
            kbuild.check(lib.rsu_reduce_launch(
                u_.data_ptr(), u_.element_size(), w_.data_ptr(), rid_.data_ptr(), 1, K_c, R, P,
                vec_c, c_.data_ptr() if with_carry else None, out_.data_ptr(),
                out_.element_size(), mass_c.data_ptr(), stream), "rsu_reduce")

        def rsu_plain_call(half=False):
            (u_, w_, rid_, c_), _ = nxt_rsu(half)
            return rsu_reduce_plain(u_, w_, rid_, R, c_, out_dtype=c_.dtype)

        def rsu_library():
            (u_, _, _, c_), m_ = nxt_rsu()
            return torch.addmm(c_, m_.t(), u_)

        def rsu_wrapper():
            (u_, w_, rid_, c_), _ = nxt_rsu()
            return rsu_reduce(u_, w_, rid_, R, carry=c_)

        def rows_copy():  # the card's copy rate at this size, for the bound's share
            (u_, _, _, _), _ = nxt_rsu()
            return rows_c.copy_(u_)

        t = {}
        for _ in range(2):  # the first pass warms up, the second is kept
            t = {"carry": time_ms(lambda: rsu_launch(True)),
                 "first": time_ms(lambda: rsu_launch(False)),
                 "plain": time_ms(rsu_plain_call), "library": time_ms(rsu_library),
                 "wrapper": time_ms(rsu_wrapper),
                 "carry_dev": device_us_per_call(lambda: rsu_launch(True)),
                 "first_dev": device_us_per_call(lambda: rsu_launch(False)),
                 "library_dev": device_us_per_call(rsu_library),
                 "copy_dev": device_us_per_call(rows_copy),
                 "carry16": time_ms(lambda: rsu_launch(True, True)),
                 "plain16": time_ms(lambda: rsu_plain_call(True)),
                 "carry16_dev": device_us_per_call(lambda: rsu_launch(True, True)),
                 "first16_dev": device_us_per_call(lambda: rsu_launch(False, True))}
        for key, (b_ms, b_by, b_bytes) in rsu_bounds(1, K_c, R, P, carry_rows).items():
            t[key + "_bound"] = (b_ms, b_by)
            t[key + "_bytes"] = b_bytes
        t["carry_rows"] = carry_rows
        rsu_times[K_c] = t
        print(f"rsu_reduce K={K_c} P={P} R={R} (vec {vec_c}): "
              f"kernel with carry {t['carry'] * 1e3:.2f} us (bound {t['carry_bound'][0] * 1e3:.2f} us "
              f"with the {carry_rows:.1f} carry rows its ids touch of {R}, dense "
              f"{t['dense_bound'][0] * 1e3:.2f} us, "
              f"{t['dense_bytes'] / (t['carry'] * 1e-3) / 1e9:.0f} GB/s), first chunk "
              f"{t['first'] * 1e3:.2f} us (bound {t['first_bound'][0] * 1e3:.2f} us), "
              f"wrapper {t['wrapper'] * 1e3:.2f} us, plain {t['plain'] * 1e3:.2f} us, "
              f"torch.addmm {t['library'] * 1e3:.2f} us; device time per call (profiler): "
              f"kernel with carry {t['carry_dev']:.2f} us "
              f"({t['carry_dev'] / t['library_dev']:.3f}x torch.addmm's "
              f"{t['library_dev']:.2f} us, {t['carry_bound'][0] * 1e3 / t['carry_dev']:.3f} of "
              f"the bound, {t['dense_bound'][0] * 1e3 / t['carry_dev']:.3f} of the dense), first "
              f"chunk {t['first_dev']:.2f} us "
              f"({t['first_bound'][0] * 1e3 / t['first_dev']:.3f} of the bound); the kernel "
              f"moves {t['dense_bytes'] / t['carry_dev'] / 1e3:.0f} GB/s, a copy of its rows "
              f"{2 * K_c * P * 4 / t['copy_dev'] / 1e3:.0f} GB/s ({t['copy_dev']:.2f} us) [{card}]")
        print(f"rsu_reduce K={K_c} P={P} R={R} bf16 rows and partials (vec {vec_c}): kernel "
              f"with carry {t['carry16'] * 1e3:.2f} us (device time {t['carry16_dev']:.2f} us, "
              f"fp32 {t['carry_dev']:.2f} us; bound {t['carry16_bound'][0] * 1e3:.2f} us, "
              f"{t['carry16_bytes'] / 1e6:.2f} MB, dense {t['dense16_bound'][0] * 1e3:.2f} us, "
              f"{t['dense16_bytes'] / t['carry16_dev'] / 1e3:.0f} GB/s), first chunk device "
              f"time {t['first16_dev']:.2f} us (fp32 {t['first_dev']:.2f} us; bound "
              f"{t['first16_bound'][0] * 1e3:.2f} us), plain {t['plain16'] * 1e3:.2f} us [{card}]")
        bf16_times[f"rsu_reduce K={K_c}"] = (t["carry16"], t["plain16"], t["carry16_dev"],
                                             t["carry16_bound"], t["carry16_bytes"])
    t = rsu_times[4]
    kernels.append({
        "name": "rsu_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rsu_reduce.cu",
        "replaces": "src/repro/kernels/rsu_reduce.py:120",
        "launches": sum(x["rsu_reduce"] for x in two_tier_launches.values())
        + sum(x["rsu_reduce"] for x in fleet_launches.values()),
        "max_abs_err": main_err["rsu_reduce"], "ms": t["carry"], "plain_ms": t["plain"],
        "bound_ms": t["carry_bound"][0], "bound_by": t["carry_bound"][1],
        "library_ms": t["library"], "carry_rows": t["carry_rows"],
        "dense_bound_ms": t["dense_bound"][0],
    })
    # the bf16 rows of B2-B5 (the fp32 rows stand in the kernels line below)
    print(json.dumps({"bf16_rows": {
        name: {"ms": v[0], "plain_ms": v[1], "device_us": v[2], "bound_ms": v[3][0],
               "bound_by": v[3][1], "bytes": v[4]} for name, v in bf16_times.items()},
        "max_abs_err": main_err["bf16"], "bf16_lane_launches": bf16_launches}))

    time_serving_kernels(kernels, lib, stream, serve_launches, main_err, device, card)
    time_gram(kernels, lib, stream, sel_run, main_err, device, card)

    # the rounds: wall time ending in a synchronize, then profiled rounds
    for label, s_ in (("fedavg", sim), ("bf16 fedavg", bf16_sims["fedavg"]),
                      ("fedadam", lane_sims["fedadam"]),
                      ("bf16 fedadam", bf16_sims["fedadam"]),
                      ("fedbuff", lane_sims["fedbuff"]),
                      ("streamed ring/fedavg", streamed_sims["ring/fedavg"]),
                      ("streamed ring/fedbuff", streamed_sims["ring/fedbuff"])):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"round wall time, {label} lane (N=100, K=10, 3 epochs): "
              f"{', '.join(f'{x * 1e3:.1f}' for x in walls)} ms [{card}]")
    for label, step in (("fedavg N=100", sim.step), ("bf16 fedavg N=100", bf16_sims["fedavg"].step),
                        ("streamed fedavg N=100", streamed_sims["ring/fedavg"].step),
                        (f"fleet N={fleet_n}", fleet_step)):
        profile_round(f"round, {label}", step, card)
    from repro_torch.configs import get_config as lm_config
    from repro_torch.models import build_model as lm_build

    lm_api = lm_build(lm_config("hymba-1.5b"))
    tok = served.tokens[:, -1]
    with torch.no_grad():
        profile_round("decode step, hymba-1.5b B=4 (position 2079)",
                      lambda: lm_api.decode_step(served.params, served.cache, tok), card)
        profile_round("prefill, hymba-1.5b 4x2048",
                      lambda: lm_api.prefill(served.params, served.prompts, 2080), card)
    # last: whole decode steps profiled before phase 5's device_profile calls made
    # those calls read half the device time (torch 2.11 on an H100 80GB HBM3)
    phase("serving: the ssm and dense families at full width and depth, bf16")
    family_launches = serve_families(device, card, FAMILY_RUNS)
    phase("serving: the moe and vlm families at full width, 16 layers, bf16")
    family_launches.update(serve_families(device, card, MOE_VLM_RUNS))
    phase("serving: the encdec family at full width and depth, bf16")
    family_launches.update(serve_families(device, card, ENCDEC_RUNS))

    # ---- 7. training ----------------------------------------------------------
    phase("training: the LM zoo's trainer on the card")
    train_phase(device, card)
    torch.cuda.empty_cache()

    # B7's launches over every serving run: hymba-1.5b's and the families'
    swa_row = next(k for k in kernels if k["name"] == "swa_decode")
    family_launches["serve_decode"] = path_launches["serve_decode"]  # phase 4j's
    swa_row["launches"] += sum(c["swa_decode"] for c in family_launches.values())
    print(f"swa_decode launches by serving run: hymba-1.5b {serve_launches['swa_decode']}, "
          + ", ".join(f"{a} {c['swa_decode']}" for a, c in family_launches.items())
          + f"; {swa_row['launches']} in all")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
