"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: name, count, ``nvidia-smi`` name and power limit; no card fails;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc into ``build/kernels`` and print the seconds and ptxas's registers
   and spills per kernel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at the edges; ``server_update`` for every rule
   and ``server_update_buffered`` for both ``drain`` states, and their two
   bitwise contracts (rule 0 is ``fedavg_reduce`` + the AXPY; no drain is
   the unbuffered update); ``rsu_reduce`` with and without its carry, on
   random, dyadic and special operands, and a chunk walk bit for bit;
   ``swa_decode`` and ``ssd_scan`` at hymba-1.5b's shapes in bf16 and fp32
   and at their edges (a ragged tile, one slot, G=1, a partly filled and a
   wrapped ring, rows with no visible slot, softcap; one step, a ragged last
   chunk, Q > S, a given h0, mamba2's ds=128 head); ``pairwise_cosine`` at
   the reference's shapes (the 128 / 512 tile edges, one row, D=1) in fp32
   and bf16, with a zero row, bitwise symmetric, and ``gram_nt`` with
   x != y, N != M;
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
   state, and a card-vs-CPU replay;
4d. fleet: the fleet bench's settings (2 samples per client, K=100 in chunks
   of 32, no warm-up) at N=20,000 for 1 round and N=100,000 for 2, with set-up
   and round times, peak memory, launches and the neighbour rows recomputed
   densely; at N=20,000 one round again on the dense neighbour search and
   fusion, which must give the same neighbours and integers;
4e. serving: ``python -m repro_torch.launch.serve --arch hymba-1.5b --full``'s
   run (bf16, B=4, prompt 2048, gen 32: the prefill fills a wrapped 1024-slot
   ring and spans 16 SSD chunks) with set-up, prefill and decode times, peak
   memory, the sample row and the launch counts (32 ``ssd_scan``, 32 x 31
   ``swa_decode``); then the same architecture cut to 2 layers, in fp32 and
   bf16, prefill and 4 decode steps on the card against the CPU's plain path
   from the same weights; then, at full width and depth in fp32, 2 decode
   steps against one longer prefill;
4f. pipeline: ``python -m repro_torch.launch.quickstart`` on the card and
   on the CPU (the same elected ids and cluster sizes); three rounds of
   ``ContextualSelector`` at full width (ring, N=100, sketch_dim 1024,
   fl-mnist-mlp updates, 10 clusters, contextual), each with one counted
   ``pairwise_cosine`` launch (the stage-3 Gram) and per-stage wall times;
   one selector round replayed on the CPU's plain path; one main-path
   round through the unfused lane against the fused lane;
5. times: each kernel (CUDA events, after warm-up) beside its bound, its
   plain version and a one-call PyTorch yardstick (``pairwise_cosine`` at
   (100, 1024), (256, 4096) and (20,000, 1,024), with the profiled device
   time of the kernel and of ``torch.mm`` at the two small shapes, where
   the events read the host's launch rate), the round's wall time
   (the fedavg, fedadam, fedbuff and streamed lanes), and profiled rounds,
   a profiled decode step and prefill.

The last two lines are the kernels' JSON record and the device JSON.
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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 non-tensor rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
ROUNDS = 5
# (vehicles, rounds) of the fleet phase: BENCH_engine.json's fleet runs
FLEET = ((20_000, 1), (100_000, 2))
LANES = ("fedavgm", "fedadam", "fedyogi", "stale", "fedbuff")


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


def phase(name: str) -> None:
    print(f"\n=== {name}", flush=True)


def rttg_inputs(scenario: str, n: int, seed: int, cr: float, device):
    from repro_torch.core.scenarios import scenario_config, scenario_params
    from repro_torch.utils import prng

    scn = scenario_params(scenario_config(scenario, num_vehicles=n), device)
    k = prng.split(prng.key(seed), 4)
    pos = prng.uniform(k[0], (n,), 0.0, scn.ring_length_m, device)
    speed = 14.0 + 4.0 * prng.normal(k[1], (n,), device)
    accel = 0.3 * prng.normal(k[2], (n,), device)
    forced = prng.bernoulli(k[3], cr, (n,), device) if cr < 1.0 else None
    t = torch.tensor(77.5, device=device)
    return scn, pos, speed, accel, t, forced


def check_rttg(scenario, n, predict, cr, want_rid, device) -> float:
    from repro_torch.kernels.rttg_latency import rttg_latency, rttg_latency_plain

    scn, pos, speed, accel, t, forced = rttg_inputs(scenario, n, n + 7, cr, device)
    mb = 636_040.0
    got = rttg_latency(pos, speed, accel, t, mb, forced, scn, predict=predict,
                       want_rid=want_rid)
    ref = rttg_latency_plain(pos, speed, accel, t, mb, forced, scn, predict, want_rid)
    torch.cuda.synchronize()
    if not torch.equal(got[1], ref[1]):
        raise AssertionError(f"rttg_latency conn differs ({scenario}, N={n}, predict={predict})")
    if want_rid and not torch.equal(got[2], ref[2]):
        raise AssertionError(f"rttg_latency rid differs ({scenario}, N={n})")
    if not bool(torch.isfinite(got[0]).all()):
        raise AssertionError("rttg_latency produced non-finite latency")
    # transcendentals (log10f, powf, log2f, sinf) may differ by an ulp or two
    # between the kernel and PyTorch's elementwise kernels: rtol 1e-5
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-7)
    err = float((got[0] - ref[0]).abs().max())
    print(f"rttg_latency {scenario:10s} N={n:5d} predict={predict!s:5s} CR={cr} "
          f"rid={want_rid!s:5s} max_abs_err={err:.3e} conn/rid exact")
    return err


def check_fedavg(K, P, device) -> float:
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce, fedavg_reduce_plain
    from repro_torch.utils import prng

    k = prng.split(prng.key(K * 100_003 + P), 2)
    u = 1e-3 * prng.normal(k[0], (K, P), device)
    w = prng.uniform(k[1], (K,), device=device)
    w = w / w.sum()
    got = fedavg_reduce(u, w)
    ref = fedavg_reduce_plain(u, w)
    torch.cuda.synchronize()
    # the two sum K products in different orders: tolerance scaled by sum |w u|
    scale = float((w.abs() @ u.abs()).max())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    err = float((got - ref).abs().max())
    print(f"fedavg_reduce K={K:3d} P={P:7d} max_abs_err={err:.3e} (scale {scale:.3e})")
    return err


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
    to (1 - beta1) / tau = 100."""
    err = 0.0
    for name, a, b, atol in zip(("params", "m", "v"), got, ref,
                                (1e-4 * scale, 1e-6 * scale, 1e-6 * scale)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol, msg=lambda m: f"{what} {name}: {m}")
        err = max(err, float((a - b).abs().max()))
    return err


def check_server_update(K, P, rule, device, exact=False) -> float:
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce_plain
    from repro_torch.kernels.server_update import server_update, server_update_plain

    u, w, params, m, v = server_operands(K, P, K * 7 + P + rule, device, exact)
    if exact:  # Yogi's sign ties: v == delta**2 on every 7th column
        d = fedavg_reduce_plain(u, w)
        v[::7] = (d * d)[::7]
    got = server_update(u, w, params, m, v, rule, 3)
    ref = server_update_plain(u, w, params, m, v, rule, 3)
    torch.cuda.synchronize()
    scale = float((w.abs() @ u.abs()).max())
    return assert_server_close(got, ref, scale, f"server_update K={K} P={P} rule={rule}")


def check_server_buffered(K, Kb, P, rule, drain, device) -> float:
    from repro_torch.kernels.server_update import (
        server_update_buffered, server_update_buffered_plain)

    u, w, params, m, v = server_operands(K, P, K * 11 + Kb + P + rule, device)
    ring, bw, *_ = server_operands(Kb, P, Kb * 13 + P + rule, device)
    flag = torch.tensor(drain, device=device)
    got = server_update_buffered(u, w, ring, bw, params, m, v, rule, 3, flag)
    ref = server_update_buffered_plain(u, w, ring, bw, params, m, v, rule, 3, flag)
    torch.cuda.synchronize()
    rows, wts = (torch.cat([u, ring]), torch.cat([w, bw])) if drain else (u, w)
    scale = float((wts.abs() @ rows.abs()).max())
    return assert_server_close(got, ref, scale,
                               f"server_update_buffered K={K} Kb={Kb} drain={drain} rule={rule}")


def check_server_contracts(K, P, device) -> None:
    """(a) rule 0 == fedavg_reduce + apply_delta_flat and (b) drain=False ==
    the unbuffered update, every rule: bit for bit, signs of zeros included."""
    from repro_torch.fl.server import apply_delta_flat
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce
    from repro_torch.kernels.server_update import server_update, server_update_buffered

    u, w, params, m, v = server_operands(K, P, 5 * K + P, device)
    u[:, ::5] = 0.0  # columns whose delta is an exact +0.0
    ring, bw, *_ = server_operands(8, P, 3 * P, device)
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
    print(f"server_update contracts (a) and (b) bitwise at K={K} P={P}")


def rsu_operands(K, P, R, mode, device):
    """(updates, weights, rid, carry) for ``rsu_reduce``.  ``rand``: normal
    rows, uniform weights; every other mode: dyadic rows and carry (7
    significant bits) and integer weights, whose sums are exact in any
    order, then ``one_rsu`` (all on one RSU), ``hole`` (an RSU never
    attached), ``masked`` (an RSU whose clients all weigh 0) or
    ``out_of_range`` (ids -1 and R + 3, which contribute nothing)."""
    g = torch.Generator(device=device)
    g.manual_seed(K * 7919 + P * 31 + R)
    if mode == "rand":
        u = 1e-3 * torch.randn((K, P), generator=g, device=device)
        w = torch.rand((K,), generator=g, device=device)
        carry = 1e-3 * torch.randn((R, P), generator=g, device=device)
    else:
        u = torch.randint(-64, 65, (K, P), generator=g, device=device).float() * 2.0 ** -12
        w = torch.randint(0, 5, (K,), generator=g, device=device).float()
        carry = torch.randint(-64, 65, (R, P), generator=g, device=device).float() * 2.0 ** -10
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


def check_rsu(K, P, R, mode, with_carry, device) -> float:
    """The kernel against ``rsu_reduce_plain``: random operands within rtol
    1e-5 and 1e-6 of sum_k |m_kr u_k| (another summation order), the other
    modes bit for bit; a never-attached or all-zero-weight RSU's row is its
    carry (or exactly 0) and its mass exactly 0."""
    from repro_torch.kernels.rsu_reduce import rsu_reduce, rsu_reduce_plain

    u, w, rid, carry = rsu_operands(K, P, R, mode, device)
    got, mass = rsu_reduce(u, w, rid, R, carry=carry.clone() if with_carry else None)
    ref, ref_mass = rsu_reduce_plain(u, w, rid, R, carry.clone() if with_carry else None)
    torch.cuda.synchronize()
    what = f"rsu_reduce K={K} P={P} R={R} {mode} carry={with_carry}"
    if mode == "rand":
        scale = float(rsu_reduce_plain(u.abs(), w, rid, R)[0].max())
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale,
                                   msg=lambda m: f"{what}: {m}")
        torch.testing.assert_close(mass, ref_mass, rtol=1e-6, atol=0.0)
    elif not (torch.equal(got, ref) and torch.equal(mass, ref_mass)):
        raise AssertionError(f"{what}: not bitwise")
    if mode in ("hole", "masked") and R > 1:
        base = carry[R // 2] if with_carry else torch.zeros_like(got[0])
        if not (torch.equal(got[R // 2], base) and float(mass[R // 2]) == 0.0):
            raise AssertionError(f"{what}: the idle RSU's row or mass moved")
    return float((got - ref).abs().max())


def check_rsu_walk(K, B, device) -> None:
    """The streamed lane's chunk walk (the first chunk without a carry, the
    rest in place) against zeros + the per-chunk plain sums, bit for bit."""
    from repro_torch.kernels.rsu_reduce import rsu_reduce, rsu_reduce_plain

    P, R = 159_010, 10
    u, w, rid, _ = rsu_operands(K, P, R, "exact", device)
    carry, acc = None, torch.zeros((R, P), device=device)
    for i in range(0, K, B):
        carry, _ = rsu_reduce(u[i:i + B], w[i:i + B], rid[i:i + B], R, carry=carry)
        acc = acc + rsu_reduce_plain(u[i:i + B], w[i:i + B], rid[i:i + B], R)[0]
    if not torch.equal(carry, acc):
        raise AssertionError(f"rsu_reduce chunk walk K={K} B={B} is not the chunk composition")
    print(f"rsu_reduce chunk walk K={K} in chunks of {B}: bitwise the per-chunk plain sums")


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
    got = swa_decode(q, k, v, kv_pos, pos, window=window, softcap=softcap)
    ref = swa_decode_plain(q, k, v, kv_pos, pos, window, softcap)
    torch.cuda.synchronize()
    what = (f"swa_decode B={B} C={C} Hkv={hkv} G={G} D={D} window={window} "
            f"softcap={softcap} fills={fills} {str(dtype)[6:]}")
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5, msg=lambda m: f"{what}: {m}")
    for r in blind:
        if not torch.equal(got[r], torch.zeros_like(got[r])):
            raise AssertionError(f"{what}: row {r} sees no slot but is not 0")
    err = float((got - ref).abs().max())
    print(f"{what}{' blind rows ' + str(list(blind)) if blind else ''}: "
          f"max_abs_err={err:.3e} (tol 2e-5)")
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
    print(f"{what}: max_abs_err / max|value| y {errs[0]:.3e}, h {errs[1]:.3e} (tol 1e-4)")
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
    keep = torch.ones((n,), dtype=torch.bool, device=device)
    if zero_row is not None:
        keep[zero_row] = False
        if got[zero_row].any() or got[:, zero_row].any():
            raise AssertionError(f"{what}: the zero row's row / column is not exactly 0")
    if not bool(((got.diagonal()[keep] - 1.0).abs() <= 1e-5).all()):
        raise AssertionError(f"{what}: a diagonal entry is more than 1e-5 from 1")
    err = float((got - ref).abs().max())
    print(f"{what}: max_abs_err={err:.3e} (tol 1e-5), bitwise symmetric, diagonal within "
          f"1e-5 of 1")
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
            "server_update": su.launches, "server_update_buffered": su.buffered_launches,
            "rsu_reduce": rsu.launches, "swa_decode": swa.launches, "ssd_scan": ssd.launches,
            "pairwise_cosine": gram.launches}


def reset_launches() -> None:
    rttg, fedavg, su, rsu, swa, ssd, gram = kernel_modules()
    rttg.launches = fedavg.launches = su.launches = su.buffered_launches = rsu.launches = 0
    swa.launches = ssd.launches = gram.launches = 0


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def serve_full(device, card):
    """The serving CLI's run at full width; launch counts zeroed just before
    and read just after: 32 ``ssd_scan`` (the prefill) and 32 x 31
    ``swa_decode`` (the first token comes from the prefill), nothing else."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod

    batch, prompt, gen = 4, 2048, 32
    cfg = get_config("hymba-1.5b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    res = serve_mod.serve("hymba-1.5b", batch, prompt, gen, full=True, device=device)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - held
    n_params = sum(x.numel() for x in _leaves(res.params))
    print(f"hymba-1.5b {cfg.dtype}, {n_params:,} parameters: set-up (init on the card "
          f"through the port's threefry, prompts) {res.setup_s:.2f} s; prefill "
          f"{batch}x{prompt} {res.prefill_s * 1e3:.1f} ms; {gen - 1} decode steps "
          f"{res.decode_s * 1e3:.1f} ms ({res.decode_s / (gen - 1) * 1e3:.2f} ms a step, "
          f"{batch * gen / res.decode_s:.1f} tok/s as the CLI counts); peak memory "
          f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held [{card}]")
    print(f"sample row: {res.tokens[0][:16].tolist()}")
    print(f"launches: {launches}")
    want = dict.fromkeys(launches, 0)
    want.update(ssd_scan=cfg.num_layers, swa_decode=cfg.num_layers * (gen - 1))
    if launches != want:
        raise AssertionError(f"serving launches: expected {want}, got {launches}")
    if tuple(res.tokens.shape) != (batch, gen) or not (
            0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.padded_vocab):
        raise AssertionError(f"serving tokens: shape {tuple(res.tokens.shape)}, range "
                             f"[{int(res.tokens.min())}, {int(res.tokens.max())}]")
    if not bool(torch.isfinite(res.logits).all()):
        raise AssertionError("serving: non-finite logits")
    return res, launches


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


def path_vs_plain(dtype: str, device) -> float:
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.utils import prng

    cfg = get_config("hymba-1.5b").replace(num_layers=2, dtype=dtype)
    api = build_model(cfg)
    key = prng.key(0, device)
    params = api.init(prng.fold_in_str(key, "init"), device)
    cpu_params = tree_to(params, "cpu")
    S, steps, batch = 1100, 4, 2  # past the 1024 window: the ring wraps; 9 SSD chunks
    toks = make_lm_batch(prng.fold_in_str(key, "prompts"), batch, S + steps + 1,
                         cfg.vocab_size, device)["tokens"]
    before = read_launches()
    with torch.no_grad():
        lg, cg = api.prefill(params, {"tokens": toks[:, :S]}, S + steps)
        t0 = time.perf_counter()
        lc, cc = api.prefill(cpu_params, {"tokens": toks[:, :S].cpu()}, S + steps)
        cpu_s = time.perf_counter() - t0
        pairs = [(lg, lc)]
        for i in range(steps):
            lg, cg = api.decode_step(params, cg, toks[:, S + i])
            lc, cc = api.decode_step(cpu_params, cc, toks[:, S + i].cpu())
            pairs.append((lg, lc))
    after = read_launches()
    if (after["ssd_scan"] - before["ssd_scan"], after["swa_decode"] - before["swa_decode"]) \
            != (cfg.num_layers, cfg.num_layers * steps):
        raise AssertionError("path vs plain: the card's path missed its kernels")
    tol = PATH_TOL[dtype]
    errs, same = [], []
    for i, (a, b) in enumerate(pairs):
        a = a.cpu().float()
        b = b.float()
        torch.testing.assert_close(a, b, rtol=tol, atol=tol,
                                   msg=lambda m: f"path vs plain {dtype} step {i}: {m}")
        errs.append(float((a - b).abs().max()))
        same.append(bool(torch.equal(a.argmax(-1), b.argmax(-1))))
    print(f"hymba-1.5b cut to 2 layers, {dtype}, B={batch}, prompt {S} + {steps} decode steps: "
          f"card vs CPU logits max_abs_err per step {', '.join(f'{e:.3e}' for e in errs)} "
          f"(tol {tol}, |logits| <= {float(pairs[0][1].float().abs().max()):.2f}); greedy "
          f"tokens agree: {same}; CPU prefill {cpu_s:.1f} s")
    return max(errs)


def decode_vs_prefill(device) -> float:
    """tests/test_models.py::test_decode_matches_prefill at full width and depth
    (fp32, the dtype that test runs): 2 decode steps after a prefill against one
    prefill of the longer context, atol = rtol = 2e-2 (that test's)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.utils import prng

    cfg = get_config("hymba-1.5b").replace(dtype="float32")
    api = build_model(cfg)
    params = api.init(prng.key(0, device), device)
    S = 1030  # past the window, so the ring has wrapped
    budget = S + 4
    toks = make_lm_batch(prng.key(3, device), 2, S + 5, cfg.vocab_size, device)["tokens"]
    with torch.no_grad():
        _, cache = api.prefill(params, {"tokens": toks[:, :S]}, budget)
        for i in range(2):
            ld, cache = api.decode_step(params, cache, toks[:, S + i])
        lfull, _ = api.prefill(params, {"tokens": toks[:, :S + 2]}, budget)
    torch.testing.assert_close(ld, lfull, rtol=2e-2, atol=2e-2)
    err = float((ld - lfull).abs().max())
    print(f"hymba-1.5b fp32, 32 layers: 2 decode steps after a {S}-token prefill vs one "
          f"{S + 2}-token prefill: max_abs_err {err:.3e} (tol 2e-2), greedy tokens agree: "
          f"{bool(torch.equal(ld.argmax(-1), lfull.argmax(-1)))}")
    return err


def check_records(sim, records) -> None:
    """Every metric and every float state leaf finite."""
    for rec in records:
        for k, v in rec.__dict__.items():
            if not math.isfinite(v):
                raise AssertionError(f"round {rec.round}: {k} = {v} is not finite")
    for f in ("params", "opt_m", "opt_v", "buf_delta"):
        if not bool(torch.isfinite(getattr(sim.state, f)).all()):
            raise AssertionError(f"{f} has non-finite entries")


def drive(sim, server: str, rsu_per_round: int = 0):
    """Warm-up and ROUNDS rounds, launch counts zeroed just before and read
    just after: per round 2 rttg_latency, ``rsu_per_round`` rsu_reduce and 1
    ``server`` launch, nothing else.  -> (the state before each round and
    after the last, records, launches)."""
    reset_launches()
    sim.warmup_sketches()
    states, records = [], []
    for _ in range(ROUNDS):
        states.append(sim.state)
        records.append(sim.run_round())
    states.append(sim.state)
    torch.cuda.synchronize()
    launches = read_launches()
    for rec in records:
        print(json.dumps(rec.__dict__))
    print(f"launches over {ROUNDS} rounds: {launches}")
    want = dict.fromkeys(launches, 0)
    want.update(rttg_latency=2 * ROUNDS, rsu_reduce=rsu_per_round * ROUNDS,
                **{server: ROUNDS})
    if launches != want:
        raise AssertionError(f"expected {want}, got {launches}")
    check_records(sim, records)
    return states, records, launches


def replay(sim, state0, first, traffic, params_atol: float, acc_atol: float = 1e-6) -> None:
    """The first round again from ``state0``: on the card (it must repeat
    bitwise) and on the CPU through the plain versions (the same integers)."""
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
        if not math.isclose(a, b, rel_tol=1e-4, abs_tol=acc_atol if f == "test_acc" else 1e-6):
            raise AssertionError(f"cuda vs cpu: {f} {a} vs {b}")
    torch.testing.assert_close(s_gpu.params.cpu(), s_cpu.params, rtol=0, atol=params_atol)
    for f in ("opt_m", "opt_v", "buf_delta"):
        torch.testing.assert_close(getattr(s_gpu, f).cpu(), getattr(s_cpu, f), rtol=1e-4,
                                   atol=1e-7)
    print(f"cuda vs cpu, one round from the same state: integers equal, "
          f"max |dparams| = {float((s_gpu.params.cpu() - s_cpu.params).abs().max()):.3e}")


def profile_round(label, fn, card) -> None:
    """One call of ``fn`` (a round, a decode step, a prefill) under
    torch.profiler: wall, device busy time and idle share, and the device
    kernels by total time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
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
        return
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


def device_us_per_call(fn, calls: int) -> float:
    """Mean device time of ``fn``'s kernels per call, from torch.profiler
    (NaN when the profiler records no device activity)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    if not dev:
        return math.nan
    return sum(e.time_range.elapsed_us() for e in dev) / calls


def time_gram(kernels, lib, stream, sel_run, main_err, device, card):
    """``pairwise_cosine`` at the stage-3 shape (100, 1024), the reference
    kernel bench's (256, 4096) and the fleet's N with the default sketch
    (20,000, 1,024): the C entry point on normalized rows with a preallocated
    output, cycling operand copies that exceed the 50 MB L2; the wrapper; the
    plain version; and one ``torch.mm(xn, xn.T)`` (cuBLAS SGEMM, TF32 off)."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.pairwise_cosine import (_normalize, pairwise_cosine,
                                                     pairwise_cosine_plain)

    rows = {}
    for n, d, copies, iters in ((100, 1024, 160, 200), (256, 4096, 16, 200),
                                (20_000, 1024, 1, 5)):
        xs = [gram_rows(n, d, torch.float32, device, 500 + i) for i in range(copies)]
        xns = [_normalize(x) for x in xs]
        out = torch.empty((n, n), dtype=torch.float32, device=device)
        it = {"i": 0}

        def nxt(seq):
            it["i"] = (it["i"] + 1) % len(seq)
            return seq[it["i"]]

        def launch():
            xn = nxt(xns)
            kbuild.check(lib.gram_nt_launch(xn.data_ptr(), xn.data_ptr(), n, n, d,
                                            out.data_ptr(), stream), "gram_nt")

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
            dev_us = {name: device_us_per_call(fn, 20) for name, fn in
                      (("kernel", launch), ("torch.mm", library))}
            print(f"pairwise_cosine N={n} D={d} device time per call (profiler): kernel "
                  f"{dev_us['kernel']:.2f} us, torch.mm {dev_us['torch.mm']:.2f} us [{card}]")
        print(f"pairwise_cosine N={n} D={d}: kernel {t['kernel'] * 1e3:.2f} us "
              f"({flops / (t['kernel'] * 1e-3) / 1e12:.2f} useful TFLOP/s), wrapper "
              f"{t['wrapper'] * 1e3:.2f} us, plain {t['plain'] * 1e3:.2f} us, torch.mm "
              f"{t['library'] * 1e3:.2f} us ({flops / (t['library'] * 1e-3) / 1e12:.2f} "
              f"useful TFLOP/s), bound {b_ms * 1e3:.3f} us ({b_by}: {flops / 1e6:.1f} MFLOP, "
              f"{(n * d * 4 + n * n * 4) / 1e6:.2f} MB) [{card}]")
        del xs, xns, out
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


def time_serving_kernels(kernels, lib, stream, serve_launches, main_err, device, card):
    """``swa_decode`` at hymba-1.5b's decode and ``ssd_scan`` at its prefill
    (bf16): the C entry point with preallocated outputs, cycling operand copies
    that exceed the 50 MB L2 (each layer reads its own cache), the plain
    version, and for ``swa_decode`` one ``scaled_dot_product_attention`` call
    with the same boolean mask (GQA through ``enable_gqa``)."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.ssd_scan import smem_bytes, ssd_scan_plain
    from repro_torch.kernels.swa_decode import swa_decode_plain

    F = torch.nn.functional
    B, C, hkv, G, D, window = 4, 1024, 5, 5, 64, 1024
    dtype, n_copies = torch.bfloat16, 16
    sets = [swa_operands(B, C, hkv, G, D, dtype, (2080,) * B, device, seed=i)
            for i in range(n_copies)]
    out = torch.empty((B, hkv, G, D), dtype=torch.float32, device=device)
    sqrt_d = float(torch.sqrt(torch.tensor(D, dtype=torch.float32)))
    it = {"i": 0}

    def nxt(xs):
        it["i"] = (it["i"] + 1) % len(xs)
        return xs[it["i"]]

    def swa_launch():
        q, k, v, kv_pos, pos = nxt(sets)
        kbuild.check(lib.swa_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(), pos.data_ptr(),
            B, C, hkv, G, D, window, 0.0, sqrt_d, 1, out.data_ptr(), stream), "swa_decode")

    def swa_plain():
        return swa_decode_plain(*nxt(sets), window)

    # the library call's operands: heads-major views of the same cache and the
    # visibility mask, made once (the mask is an input of the call)
    lib_sets = []
    for q, k, v, kv_pos, pos in sets:
        vis = (kv_pos >= 0) & (kv_pos <= pos[:, None]) & (pos[:, None] - kv_pos < window)
        lib_sets.append((q.reshape(B, hkv * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
                         vis[:, None, None, :]))

    def swa_library():
        q, k, v, mask = nxt(lib_sets)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    t = {}
    for _ in range(2):  # the first pass warms up, the second is kept
        t = {"kernel": time_ms(swa_launch), "plain": time_ms(swa_plain, iters=50, warmup=5),
             "library": time_ms(swa_library)}
    q, k, v, kv_pos, pos = sets[0]
    vis = int(((kv_pos >= 0) & (kv_pos <= pos[:, None]) & (pos[:, None] - kv_pos < window))
              .sum())
    isz = k.element_size()
    swa_bytes = (q.numel() * isz + 2 * k.numel() * isz + kv_pos.numel() * 4 + B * 4
                 + out.numel() * 4)
    # per visible slot and query head: a D-long dot and a D-long p * v (4 D
    # flops) and ~4 for the scale, exp and sums; per query head D divides
    swa_flops = vis * hkv * G * (4 * D + 4) + B * hkv * G * D
    b_ms, b_by = bound(swa_bytes, swa_flops)
    print(f"swa_decode B={B} C={C} Hkv={hkv} G={G} D={D} bf16, full ring: kernel "
          f"{t['kernel'] * 1e3:.2f} us ({swa_bytes / (t['kernel'] * 1e-3) / 1e9:.0f} GB/s), "
          f"plain {t['plain'] * 1e3:.2f} us, scaled_dot_product_attention "
          f"{t['library'] * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}: "
          f"{swa_bytes / 1e6:.2f} MB, {swa_flops / 1e6:.1f} MFLOP) [{card}]")
    kernels.append({
        "name": "swa_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_decode.cu",
        "replaces": "src/repro/kernels/swa_decode.py:114",
        "launches": serve_launches["swa_decode"], "max_abs_err": main_err["swa_decode"],
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": t["library"],
    })

    Bz, S, nh, hp, ds, Q = 4, 2048, 50, 64, 16, 128
    ssd_sets = [ssd_operands(Bz, S, nh, hp, ds, dtype, device, seed=i) for i in range(2)]
    y = torch.empty((Bz, S, nh, hp), dtype=torch.float32, device=device)
    h = torch.empty((Bz, nh, hp, ds), dtype=torch.float32, device=device)
    smem = smem_bytes(Q, hp, ds)

    def ssd_launch():
        x, dt, A, Bs, Cs, _ = nxt(ssd_sets)
        kbuild.check(lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bs.data_ptr(), Cs.data_ptr(), None,
            Bz, S, nh, hp, ds, Q, smem, 1, y.data_ptr(), h.data_ptr(), stream), "ssd_scan")

    def ssd_plain():
        x, dt, A, Bs, Cs, _ = nxt(ssd_sets)
        return ssd_scan_plain(x, dt, A, Bs, Cs, Q)

    ts = {}
    for _ in range(2):
        ts = {"kernel": time_ms(ssd_launch, iters=20, warmup=3),
              "plain": time_ms(ssd_plain, iters=5, warmup=2)}
    x, dt, A, Bs, Cs, _ = ssd_sets[0]
    isz = x.element_size()
    ssd_bytes = (x.numel() * isz + dt.numel() * 4 + A.numel() * 4 + 2 * Bs.numel() * isz
                 + y.numel() * 4 + h.numel() * 4)
    # per chunk of qc steps (t = qc (qc + 1) / 2 pairs k <= q): C . B once per
    # batch row (t ds multiply-adds); per head the masked product (t hp), the
    # carried state's share and the state update (qc hp ds each), x * w (qc hp)
    # and M's scale (3 t)
    ssd_flops = 0
    for c0 in range(0, S, Q):
        qc = min(Q, S - c0)
        tri = qc * (qc + 1) // 2
        ssd_flops += Bz * 2 * tri * ds
        ssd_flops += Bz * nh * (2 * tri * hp + 4 * qc * hp * ds + qc * hp + 3 * tri)
    b_ms, b_by = bound(ssd_bytes, ssd_flops)
    print(f"ssd_scan B={Bz} S={S} nh={nh} hp={hp} ds={ds} Q={Q} bf16: kernel "
          f"{ts['kernel'] * 1e3:.1f} us, plain {ts['plain'] * 1e3:.1f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}: {ssd_bytes / 1e6:.1f} MB, {ssd_flops / 1e9:.2f} GFLOP; "
          f"{ssd_flops / (ts['kernel'] * 1e-3) / 1e12:.2f} TFLOP/s achieved) [{card}]")
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:124",
        "launches": serve_launches["ssd_scan"], "max_abs_err": main_err["ssd_scan"],
        "ms": ts["kernel"], "plain_ms": ts["plain"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 1

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

    # ---- 3. kernels against their plain versions ------------------------
    phase("kernels vs plain versions")
    main_err = {"rttg_latency": 0.0, "fedavg_reduce": 0.0}
    for predict in (True, False):
        e = check_rttg("ring", 100, predict, 1.0, False, device)
        main_err["rttg_latency"] = max(main_err["rttg_latency"], e)
    check_rttg("ring", 100, False, 1.0, True, device)
    for n in (1, 257, 4096):
        check_rttg("ring", n, True, 1.0, True, device)
    check_rttg("rsu_outage", 100, True, 1.0, True, device)
    check_rttg("rush_hour", 257, True, 0.7, False, device)
    check_rttg("day_cycle", 100, False, 0.5, True, device)
    main_err["fedavg_reduce"] = check_fedavg(10, 159_010, device)
    for K, P in ((1, 159_010), (10, 2049), (1, 1), (10, 4096)):
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
    for K, P in ((10, 159_010), (5, 2049), (1, 1)):
        check_server_contracts(K, P, device)
    main_err["rsu_reduce"] = 0.0
    for K, P, R in ((4, 159_010, 10), (32, 159_010, 10), (1, 1, 1), (1, 515, 10),
                    (7, 515, 10), (5, 2049, 1)):
        errs = [check_rsu(K, P, R, mode, with_carry, device)
                for mode in ("rand", "exact", "one_rsu", "hole", "masked", "out_of_range")
                for with_carry in (False, True)]
        if (K, P) == (4, 159_010):
            main_err["rsu_reduce"] = max(errs)
        print(f"rsu_reduce K={K:2d} P={P:7d} R={R:2d} random, dyadic, one RSU, unattached, "
              f"zero-weight and out-of-range ids, with and without carry: "
              f"max_abs_err={max(errs):.3e}")
    check_rsu_walk(10, 4, device)
    check_rsu_walk(100, 32, device)
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
    for dtype in (torch.bfloat16, torch.float32):
        # hymba-1.5b's prefill: B=4, S=2048, 50 heads of (64 x 16), Q=128
        e = check_ssd(4, 2048, 50, 64, 16, 128, False, dtype, device)
        if dtype == torch.bfloat16:
            main_err["ssd_scan"] = e
    check_ssd(2, 1, 3, 16, 8, 128, False, torch.float32, device)  # one step
    check_ssd(2, 200, 4, 32, 16, 128, True, torch.bfloat16, device)  # ragged chunk, h0
    check_ssd(3, 100, 2, 8, 32, 128, False, torch.float32, device)  # Q > S
    check_ssd(1, 300, 24, 64, 128, 128, True, torch.float32, device)  # mamba2's head
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
    for n, m, d in ((128, 256, 512), (33, 100, 2000), (1, 5, 1), (100, 7, 1024)):
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
    for label, scenario, agg, cr in (("ring/fedavg", "ring", "fedavg", 1.0),
                                     ("ring/fedbuff", "ring", "fedbuff", 0.7),
                                     ("rsu_outage/fedavg", "rsu_outage", "fedavg", 1.0)):
        fl_s = dataclasses.replace(fl, aggregator=agg, connection_rate=cr, hierarchical=True,
                                   client_block=4)
        traffic_s = scenario_config(scenario, num_vehicles=100)
        sim_s = FLSimulation(get_config("fl-mnist-mlp"), fl_s, traffic_s, "mnist",
                             "contextual", prng.key(0), device=device)
        server = "server_update_buffered" if agg == "fedbuff" else "fedavg_reduce"
        n_chunks = -(-K // fl_s.client_block)
        print(f"-- {label} at CR {cr}: K={K} in {n_chunks} chunks of {fl_s.client_block} "
              f"({server})")
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

    fleet_launches = {}
    for n, n_rounds in FLEET:
        phase(f"fleet: N={n}, {n_rounds} round(s), hierarchical, client_block=32, no warm-up")
        # benchmarks/engine_throughput.py::fleet's settings
        fl_f = FLConfig(num_clients=n, samples_per_client=2, batch_size=2, num_clusters=8,
                        local_epochs=1, sketch_dim=64,
                        select_fraction=min(max(100.0 / n, 1e-6), 1.0), hierarchical=True,
                        client_block=32, aggregator="fedavg", seed=0)
        traffic_f = scenario_config("ring", num_vehicles=n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by the earlier phases
        t0 = time.perf_counter()
        sim_f = FLSimulation(get_config("fl-mnist-mlp"), fl_f, traffic_f, "mnist",
                             "contextual", prng.key(0), device=device)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated() - held
        torch.cuda.reset_peak_memory_stats()
        held_rounds = torch.cuda.memory_allocated()
        state_f0 = sim_f.state
        reset_launches()
        rows0 = messages.dense_rows
        walls, recs = [], []
        for _ in range(n_rounds):
            t0 = time.perf_counter()
            recs.append(sim_f.run_round())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        fleet_launches[n] = launches_f = read_launches()
        rows = messages.dense_rows - rows0
        round_peak = torch.cuda.max_memory_allocated() - held_rounds
        n_chunks = -(-fl_f.n_select // fl_f.client_block)
        print(f"set-up {setup_s:.2f} s (peak {setup_peak / 2**30:.2f} GiB above the "
              f"{held / 2**30:.2f} GiB the earlier phases hold); N={n} "
              f"K={fl_f.n_select} in {n_chunks} chunks of {fl_f.client_block} [{card}]")
        for rec, wall in zip(recs, walls):
            print(json.dumps(rec.__dict__), f"wall {wall * 1e3:.1f} ms")
        print(f"launches over {n_rounds} round(s): {launches_f}; peak memory in the rounds "
              f"{round_peak / 2**30:.2f} GiB above the {held_rounds / 2**30:.2f} GiB held "
              f"before them; neighbour rows recomputed densely: {rows} "
              f"of {n * n_rounds} [{card}]")
        want = dict.fromkeys(launches_f, 0)
        want.update(rttg_latency=2 * n_rounds, rsu_reduce=n_chunks * n_rounds,
                    fedavg_reduce=n_rounds)
        if launches_f != want:
            raise AssertionError(f"expected {want}, got {launches_f}")
        check_records(sim_f, recs)
        if n != FLEET[0][0]:
            continue
        # the first round again from its state: the windowed search and compact
        # fusion (as above; it must repeat bitwise), then the dense forms
        rk = prng.fold_in(state_f0.key, state_f0.round)
        k_obs = prng.fold_in_str(rk, "observe")
        forms, saved = {}, messages.DENSE_MAX_N
        for form, limit in (("windowed", saved), ("dense", n)):
            messages.DENSE_MAX_N = limit
            try:
                cpms = messages.emit_cpms(state_f0.twin, sim_f.scn, k_obs)
                kin = fuse_kinematics(messages.emit_cams(state_f0.twin, sim_f.scn, k_obs), cpms,
                                      sim_f.scn)
                s_x, m_x = sim_f._step(state_f0, sim_f.scn, 0, 0, sim_f.data, True)
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
        print(f"fleet N={n}: the round repeats bitwise on the card; dense vs windowed "
              f"neighbours equal, integers equal, max |dpos| = "
              f"{float((kin_w[0] - kin_d[0]).abs().max()):.3e} m")
    fleet_sim = sim_f

    # ---- 4e. serving ---------------------------------------------------------
    phase("serving: hymba-1.5b at full width, bf16, B=4, prompt 2048, gen 32")
    served, serve_launches = serve_full(device, card)
    phase("serving: the path on the card vs the plain path on the CPU")
    main_err["path"] = {dt: path_vs_plain(dt, device) for dt in ("float32", "bfloat16")}
    phase("serving: decode vs prefill on the card")
    decode_vs_prefill(device)
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

    # ---- 5. times ----------------------------------------------------------
    phase(f"times on {card}")
    from repro_torch.kernels.build import library
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce_plain
    from repro_torch.kernels.rttg_latency import pack_scalars, rttg_latency, rttg_latency_plain
    from repro_torch.core.rttg import rsu_up_mask
    from repro_torch.core.trajectory import horizon_steps

    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    kernels = []

    # rttg_latency at the main path's predicted-topology call: N=100, R=10,
    # 50 predictor steps, CR = 1 (no forced mask), no rid
    scn, pos, speed, accel, t, _ = rttg_inputs("ring", 100, 3, 1.0, device)
    n, R = 100, scn.n_rsu
    mb = 636_040.0
    scalars = pack_scalars(t, mb, scn, device)
    live = rsu_up_mask(scn).to(torch.uint8).contiguous()
    counts = torch.empty((R,), dtype=torch.int32, device=device)
    lat = torch.empty((n,), dtype=torch.float32, device=device)
    conn = torch.empty((n,), dtype=torch.bool, device=device)
    steps = horizon_steps(scn.predict_horizon_s, scn)
    times = {}
    for predict in (True, False):
        ns = steps if predict else 0
        hs = float(scn.predict_horizon_s) if predict else 0.0

        def launch(ns=ns, hs=hs):
            kbuild.check(lib.rttg_latency_launch(
                scalars.data_ptr(), live.data_ptr(), R, pos.data_ptr(), speed.data_ptr(),
                accel.data_ptr(), None, n, ns, float(scn.sim_dt_s), hs,
                counts.data_ptr(), lat.data_ptr(), conn.data_ptr(), None, stream),
                "rttg_latency")

        times[predict] = (
            time_ms(launch),
            time_ms(lambda p=predict: rttg_latency_plain(pos, speed, accel, t, mb, None, scn, p),
                    iters=20, warmup=3),
        )
    wrapper_ms = time_ms(lambda: rttg_latency(pos, speed, accel, t, mb, None, scn, predict=True),
                         iters=50, warmup=5)
    # bytes: 3 f32 inputs + 19 scalars + R live flags in, f32 lat + bool conn out
    rttg_bytes = n * 4 * 3 + 19 * 4 + R + n * 4 + n
    # flops per client: 8 per predictor step, 6 per RSU in the argmin, ~45 in
    # the latency/SNR/congestion tail (counting each transcendental as one)
    rttg_flops = n * (8 * steps + 6 * R + 45)
    b_ms, b_by = bound(rttg_bytes, rttg_flops)
    kernels.append({
        "name": "rttg_latency", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rttg_latency.cu",
        "replaces": "src/repro/kernels/rttg_latency.py:242",
        "launches": launches["rttg_latency"], "max_abs_err": main_err["rttg_latency"],
        "ms": times[True][0], "plain_ms": times[True][1], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
    })
    print(f"rttg_latency N=100 R={R} predict (50 steps): kernel {times[True][0] * 1e3:.2f} us, "
          f"plain {times[True][1] * 1e3:.1f} us, bound {b_ms * 1e3:.5f} us ({b_by}) [{card}]")
    print(f"rttg_latency N=100 R={R} realized (0 steps): kernel {times[False][0] * 1e3:.2f} us, "
          f"plain {times[False][1] * 1e3:.1f} us [{card}]")
    print(f"rttg_latency wrapper as the round calls it (operand packing included): "
          f"{wrapper_ms * 1e3:.1f} us [{card}]")

    # fedavg_reduce at K=10, P=159,010; cycle through copies that together
    # exceed the 50 MB L2, so each launch streams its rows from HBM
    K, P = 10, 159_010
    n_copies = 16
    us = [1e-3 * prng.normal(prng.fold_in(prng.key(11), i), (K, P), device)
          for i in range(n_copies)]
    w = torch.full((K,), 0.1, dtype=torch.float32, device=device)
    out = torch.empty((P,), dtype=torch.float32, device=device)
    vec = 2 if P % 2 == 0 else 1
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % n_copies
        return us[it["i"]]

    def fed_launch():
        kbuild.check(lib.fedavg_reduce_launch(nxt().data_ptr(), w.data_ptr(), K, P, vec,
                                              out.data_ptr(), stream), "fedavg_reduce")

    fed_ms = time_ms(fed_launch)
    fed_plain = time_ms(lambda: fedavg_reduce_plain(nxt(), w))
    fed_lib = time_ms(lambda: torch.mv(nxt().t(), w))
    fed_bytes = K * P * 4 + K * 4 + P * 4
    b_ms, b_by = bound(fed_bytes, 2 * K * P)
    kernels.append({
        "name": "fedavg_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/fedavg_reduce.py:43",
        "launches": launches["fedavg_reduce"], "max_abs_err": main_err["fedavg_reduce"],
        "ms": fed_ms, "plain_ms": fed_plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": fed_lib,
    })
    print(f"fedavg_reduce K={K} P={P} (vec {vec}): kernel {fed_ms * 1e3:.2f} us, plain "
          f"{fed_plain * 1e3:.2f} us, torch.mv {fed_lib * 1e3:.2f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}), {fed_bytes / (fed_ms * 1e-3) / 1e9:.0f} GB/s [{card}]")

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
    outs = [torch.empty((P,), dtype=torch.float32, device=device) for _ in range(3)]
    on = torch.tensor(True, device=device)
    hp = ServerHP()

    def nxt_set():
        it["i"] = (it["i"] + 1) % n_copies
        return sets[it["i"]], rings[it["i"]]

    def su_launch(rule, buffered):
        (u, w_, p_, m_, v_), (ring, bw) = nxt_set()
        ring_args = (ring.data_ptr(), bw.data_ptr(), Kb, on.data_ptr()) if buffered \
            else (None, None, 0, None)
        kbuild.check(lib.server_update_launch(
            u.data_ptr(), w_.data_ptr(), K, *ring_args, P, p_.data_ptr(), m_.data_ptr(),
            v_.data_ptr(), rule, 0, hp.eta, hp.beta1, 1.0 - hp.beta1, hp.beta2,
            1.0 - hp.beta2, hp.tau, vec, *[o.data_ptr() for o in outs], stream),
            "server_update")

    def su_plain(rule, buffered):
        (u, w_, p_, m_, v_), (ring, bw) = nxt_set()
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
                   "server_update_buffered"])}
    # two passes over the pair, each kernel timed in turn; the first pass is a
    # warm-up (a call's first server timing reads slow), the second is kept
    su_times = {}
    for _ in range(2):
        for name, (rule, buffered, _rows, _n) in su_runs.items():
            su_times[name] = (time_ms(lambda: su_launch(rule, buffered)),
                              time_ms(lambda: su_plain(rule, buffered)),
                              time_ms(lambda: su_wrapper(rule, buffered)))
    for name, (rule, buffered, rows_b, n_launch) in su_runs.items():
        ms, plain_ms, wrap_ms = su_times[name]
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
            "launches": n_launch, "max_abs_err": main_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        print(f"{name} K={K} Kb={rows_b} P={P} rule {rule} (vec {vec}): kernel "
              f"{ms * 1e3:.2f} us, wrapper {wrap_ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}), "
              f"{su_bytes / (ms * 1e-3) / 1e9:.0f} GB/s [{card}]")

    # rsu_reduce at the streamed lanes' chunks: R=10, the paper's K=4 and the
    # fleet's K=32, each with its carry (the steady chunk) and the first
    # chunk without one, cycling through copies that exceed the L2 as above
    from repro_torch.kernels.rsu_reduce import rsu_reduce, rsu_reduce_plain

    R = 10
    rsu_times = {}
    for K_c in (4, 32):
        ops = [rsu_operands(K_c, P, R, "rand", device) for _ in range(n_copies)]
        routes = [torch.nn.functional.one_hot(rid_.long(), R).float() * w_[:, None]
                  for _, w_, rid_, _ in ops]
        out_c = torch.empty((R, P), dtype=torch.float32, device=device)
        mass_c = torch.empty((R,), dtype=torch.float32, device=device)
        vec_c = 2 if P % 2 == 0 else 1

        def nxt_rsu():
            it["i"] = (it["i"] + 1) % n_copies
            return ops[it["i"]], routes[it["i"]]

        def rsu_launch(with_carry, K_c=K_c):
            (u_, w_, rid_, c_), _ = nxt_rsu()
            kbuild.check(lib.rsu_reduce_launch(
                u_.data_ptr(), w_.data_ptr(), rid_.data_ptr(), K_c, R, P, vec_c,
                c_.data_ptr() if with_carry else None,
                c_.data_ptr() if with_carry else out_c.data_ptr(), mass_c.data_ptr(),
                stream), "rsu_reduce")

        def rsu_plain_call():
            (u_, w_, rid_, c_), _ = nxt_rsu()
            return rsu_reduce_plain(u_, w_, rid_, R, c_)

        def rsu_library():
            (u_, _, _, c_), m_ = nxt_rsu()
            return torch.addmm(c_, m_.t(), u_)

        def rsu_wrapper():
            (u_, w_, rid_, c_), _ = nxt_rsu()
            return rsu_reduce(u_, w_, rid_, R, carry=c_)

        t = {}
        for _ in range(2):  # the first pass warms up, the second is kept
            t = {"carry": time_ms(lambda: rsu_launch(True)),
                 "first": time_ms(lambda: rsu_launch(False)),
                 "plain": time_ms(rsu_plain_call), "library": time_ms(rsu_library),
                 "wrapper": time_ms(rsu_wrapper)}
        # each input read once (rows, weights, ids, and the carry when there is
        # one), each output written once (partials, mass); 2 flops per row value
        # (its one RSU's multiply-add) plus the carry's add per partial
        for key, with_carry in (("carry", True), ("first", False)):
            b_bytes = K_c * P * 4 + 2 * K_c * 4 + R * P * 4 * (2 if with_carry else 1) + R * 4
            t[key + "_bound"] = bound(b_bytes, 2 * K_c * P + (R * P if with_carry else 0))
            t[key + "_bytes"] = b_bytes
        rsu_times[K_c] = t
        print(f"rsu_reduce K={K_c} P={P} R={R} (vec {vec_c}): kernel with carry "
              f"{t['carry'] * 1e3:.2f} us (bound {t['carry_bound'][0] * 1e3:.2f} us, "
              f"{t['carry_bytes'] / (t['carry'] * 1e-3) / 1e9:.0f} GB/s), first chunk "
              f"{t['first'] * 1e3:.2f} us (bound {t['first_bound'][0] * 1e3:.2f} us), "
              f"wrapper {t['wrapper'] * 1e3:.2f} us, plain {t['plain'] * 1e3:.2f} us, "
              f"torch.addmm {t['library'] * 1e3:.2f} us [{card}]")
    t = rsu_times[4]
    kernels.append({
        "name": "rsu_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rsu_reduce.cu",
        "replaces": "src/repro/kernels/rsu_reduce.py:120",
        "launches": sum(x["rsu_reduce"] for x in two_tier_launches.values())
        + sum(x["rsu_reduce"] for x in fleet_launches.values()),
        "max_abs_err": main_err["rsu_reduce"], "ms": t["carry"], "plain_ms": t["plain"],
        "bound_ms": t["carry_bound"][0], "bound_by": t["carry_bound"][1],
        "library_ms": t["library"],
    })

    time_serving_kernels(kernels, lib, stream, serve_launches, main_err, device, card)
    time_gram(kernels, lib, stream, sel_run, main_err, device, card)

    # the rounds: wall time ending in a synchronize, then profiled rounds
    for label, s_ in (("fedavg", sim), ("fedadam", lane_sims["fedadam"]),
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
    for label, s_ in (("fedavg N=100", sim), ("streamed fedavg N=100",
                                              streamed_sims["ring/fedavg"]),
                      (f"fleet N={fleet_sim.fl.num_clients}", fleet_sim)):
        profile_round(f"round, {label}", s_.step, card)
    from repro_torch.configs import get_config as lm_config
    from repro_torch.models import build_model as lm_build

    lm_api = lm_build(lm_config("hymba-1.5b"))
    tok = served.tokens[:, -1]
    with torch.no_grad():
        profile_round("decode step, hymba-1.5b B=4 (position 2079)",
                      lambda: lm_api.decode_step(served.params, served.cache, tok), card)
        profile_round("prefill, hymba-1.5b 4x2048",
                      lambda: lm_api.prefill(served.params, served.prompts, 2080), card)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
