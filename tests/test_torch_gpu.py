"""The port's CUDA kernels and main path on the card (marked ``gpu``).

Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX (the card's machine has none): each kernel is held
against its plain PyTorch version on the card.  Connectivity and RSU ids
exactly (also around the geometry kernel's one-block limit, past the
card's resident threads, its lane-batched form at its launch plan's edges
(up to 4,096 clients a lane, one block or T tiles a lane; its per-lane
counters at zero after each call and after a CUDA-graph replay), at R = 1, 40 and 32,768 and with positions at
the predictor's wrap, each call repeated bit for bit); latency within rtol 1e-5 (the kernel's ``log10f`` / ``powf`` /
``log2f`` / ``sinf`` and PyTorch's elementwise kernels may round an ulp
apart); the FedAvg sum within 1e-6 of ``sum_k |w_k u_k|`` (another
summation order); the server update's ``m`` and ``v`` within the same,
its ``params`` within 100 times that (the adaptive step
``m / (sqrt(v) + tau)`` magnifies the sum's error by up to
``(1 - beta1) / tau``), and its two contracts bit for bit.  The RSU segment
reduce within 1e-6 of ``sum_k |m_kr u_k|`` on random operands and bit for
bit on dyadic ones (any order sums those exactly), a chunk walk included,
at 10 RSUs and past one 32-RSU group of the kernel (33, 40 and 100), and at
its launch plan's edges (K off its 4-row slab, ragged and odd P, 16- and
8-byte aligned rows, the fleet's padded last chunk), each launch repeated
bit for bit.  The column streamers (B2 / B2g, B3 / B4 / B3g / B4g) at their
launch plan's edges (``fedavg_reduce.column_plan``): P at each residue mod 8
but 0 and 4, rows 0-7 elements off their alignment, K = 1 to 17, 1 to 131
lanes, fp32 and bf16 rows, each lane bit for bit the one-lane kernel, the
FedAvg sum bit for bit its plain version on dyadic operands, and the server
update's two contracts on bf16 rows.
The two-tier rounds: the hierarchical lane is the flat lane bit for bit
(contract (a)), and the streamed lane launches one ``rsu_reduce`` per
chunk.  At fleet size the windowed neighbour search is the dense one
exactly and the compact fusion the dense fusion within rtol 1e-5.  The
pairwise-cosine Gram within atol 1e-5 of its plain version (TF32 off),
bitwise symmetric and repeated bitwise, also at its launch plan's tile and
split edges; the split-KV decode at its split edges (a window narrower than
a split, empty and ragged splits, blind rows, narrow rows, more than 64
splits); a selector round on the card against the CPU (RSU ids,
connectivity, masks and cluster labels equal), and the unfused round
against the fused one (integers equal, floats within rtol 1e-5).  The MoE
layer on a skewed input that drops copies: routing equal card vs CPU, no
device-to-host sync; the smoke moe, vlm and encdec LMs served card vs CPU.  The
CNN datasets' models at full width, forward and trainer card vs CPU, and a
narrow CNN's round repeated bit for bit on the card.  The LM trainer: one
step of the dense, moe, vlm and encdec smoke LMs card vs CPU (loss within
rtol 1e-5, params within 2 lr), no kernel launched, the ssm and hybrid
ones too (their scan is the plain one under grad mode); ``ssd_scan`` and
``swa_decode`` refusing an operand that requires grad under grad mode (no
kernel has a backward).  Dirichlet shards drawn on the card as on the CPU.
Without a card every test skips, decided in the fixture.
"""
import pytest
import torch

from repro_torch.core.scenarios import scenario_config, scenario_params
from repro_torch.kernels import fedavg_reduce as fedavg_mod
from repro_torch.kernels import rsu_reduce as rsu_mod
from repro_torch.kernels import rttg_latency as rttg_mod
from repro_torch.kernels import server_update as su_mod
from repro_torch.utils import prng

pytestmark = pytest.mark.gpu

BF16_ULP = 2.0 ** -7  # one unit in the last place of a bf16 in [1, 2)


@pytest.fixture
def dev():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _geometry(name, n, cr, dev, **scn_kw):
    scn = scenario_params(scenario_config(name, num_vehicles=n, **scn_kw), dev)
    k = prng.split(prng.key(n), 4)
    pos = prng.uniform(k[0], (n,), 0.0, scn.ring_length_m, dev)
    speed = 14.0 + prng.normal(k[1], (n,), dev)
    accel = 0.3 * prng.normal(k[2], (n,), dev)
    forced = prng.bernoulli(k[3], cr, (n,), dev) if cr < 1.0 else None
    return scn, pos, speed, accel, forced


@pytest.mark.parametrize("n", [1, 100, 257, 4096])
@pytest.mark.parametrize("name,predict,cr", [("ring", True, 1.0), ("rsu_outage", False, 0.6),
                                             ("day_cycle", True, 0.7)])
def test_rttg_latency_kernel_matches_plain(dev, n, name, predict, cr):
    scn, pos, speed, accel, forced = _geometry(name, n, cr, dev)
    t = torch.tensor(77.5, device=dev)
    before = rttg_mod.launches
    got = rttg_mod.rttg_latency(pos, speed, accel, t, 636_040.0, forced, scn,
                                predict=predict, want_rid=True)
    assert rttg_mod.launches == before + 1
    ref = rttg_mod.rttg_latency_plain(pos, speed, accel, t, 636_040.0, forced, scn,
                                      predict, want_rid=True)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-7)


def _rttg_twice_vs_plain(scn, pos, speed, accel, forced, predict):
    """Two wrapper calls against the plain version: connectivity and RSU ids
    exactly, latency within rtol 1e-5, the second call bit for bit the first."""
    t = torch.tensor(77.5, device=pos.device)
    before = rttg_mod.launches
    got, again = [rttg_mod.rttg_latency(pos, speed, accel, t, 636_040.0, forced, scn,
                                        predict=predict, want_rid=True) for _ in range(2)]
    assert rttg_mod.launches == before + 2
    ref = rttg_mod.rttg_latency_plain(pos, speed, accel, t, 636_040.0, forced, scn,
                                      predict, want_rid=True)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-7)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


# around the one-block limit (1,024 clients), the fleet's 100,000, and
# 300,000: more clients than the card holds resident threads
@pytest.mark.parametrize("n", [1024, 1025, 100_000, 300_000])
@pytest.mark.parametrize("predict", [True, False])
def test_rttg_latency_kernel_launch_plan_edges(dev, n, predict):
    scn, pos, speed, accel, forced = _geometry("ring", n, 0.7, dev)
    _rttg_twice_vs_plain(scn, pos, speed, accel, forced, predict)


# R = 1, 40 and the largest, 32,768 (160 KB of shared memory a block)
@pytest.mark.parametrize("spacing", [10_000.0, 250.0, 10_000.0 / 32768])
@pytest.mark.parametrize("n", [100, 5000])
def test_rttg_latency_kernel_rsu_counts(dev, spacing, n):
    scn, pos, speed, accel, forced = _geometry("ring", n, 1.0, dev, rsu_spacing_m=spacing)
    assert scn.n_rsu == round(10_000.0 / spacing)
    _rttg_twice_vs_plain(scn, pos, speed, accel, forced, True)


# a 5 m ring: 3 mean_speed dt > ring / 2, so every step takes the tested wrap
@pytest.mark.parametrize("ring_kw", [{}, {"ring_length_m": 5.0, "rsu_spacing_m": 1.0}])
@pytest.mark.parametrize("n", [100, 4096])
@pytest.mark.parametrize("predict", [True, False])
def test_rttg_latency_kernel_positions_at_the_wrap(dev, n, predict, ring_kw):
    """0, just under the ring and the ring itself take the predictor's
    compare-and-subtract wrap; 2 ring and beyond, and below 0, take fmodf."""
    scn, pos, speed, accel, forced = _geometry("ring", n, 1.0, dev, **ring_kw)
    ring = scn.ring_length_m
    edges = torch.stack([0.0 * ring, torch.nextafter(ring, 0.0 * ring), ring, 2.0 * ring,
                         3.5 * ring, -1.0 + 0.0 * ring, -0.5 * ring, -2.5 * ring])
    pos = torch.cat([edges, pos[len(edges):]])
    _rttg_twice_vs_plain(scn, pos, speed, accel, forced, predict)


@pytest.mark.parametrize("K,P", [(1, 1), (1, 159_010), (10, 2049), (10, 4096), (10, 159_010),
                                 (7, 159_011), (8, 4097), (9, 2049), (17, 159_010),
                                 (17, 4097), (100, 38_656)])
def test_fedavg_reduce_kernel_matches_plain(dev, K, P):
    u = 1e-3 * prng.normal(prng.key(K + P), (K, P), dev)
    w = prng.uniform(prng.key(K), (K,), device=dev)
    before = fedavg_mod.launches
    got = fedavg_mod.fedavg_reduce(u, w)
    assert fedavg_mod.launches == before + 1
    ref = fedavg_mod.fedavg_reduce_plain(u, w)
    scale = float((w.abs() @ u.abs()).max())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    # a fixed summation order: a second launch repeats the first bitwise
    assert torch.equal(got, fedavg_mod.fedavg_reduce(u, w))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    u = torch.zeros((4, 8), device=dev)
    # bf16 rows go through the kernel
    ub = (1e-3 * torch.randn((4, 8), device=dev)).to(torch.bfloat16)
    w = torch.rand(4, device=dev)
    before = fedavg_mod.launches
    torch.testing.assert_close(fedavg_mod.fedavg_reduce(ub, w),
                               fedavg_mod.fedavg_reduce_plain(ub, w), rtol=1e-5, atol=1e-8)
    assert fedavg_mod.launches == before + 1
    with pytest.raises(ValueError):
        fedavg_mod.fedavg_reduce(u.to(torch.float16), torch.ones(4, device=dev))
    with pytest.raises(ValueError):
        fedavg_mod.fedavg_reduce(u.t(), torch.ones(8, device=dev))  # not contiguous
    scn = scenario_params(scenario_config("ring", num_vehicles=8), dev)
    x = torch.zeros(8, device=dev)
    with pytest.raises(ValueError):
        rttg_mod.rttg_latency(x, x.double(), x, 0.0, 1.0, None, scn, predict=False)


def _server_operands(K, P, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u = 1e-3 * torch.randn((K, P), generator=g, device=dev)
    w = torch.rand((K,), generator=g, device=dev)
    params = 0.05 * torch.randn((P,), generator=g, device=dev)
    m = 1e-4 * torch.randn((P,), generator=g, device=dev)
    v = (1e-3 * torch.randn((P,), generator=g, device=dev)) ** 2
    return u, w / w.sum(), params, m, v


def _assert_server_close(got, ref, u, w):
    scale = float((w.abs() @ u.float().abs()).max())
    for a, b, atol in zip(got, ref, (1e-4 * scale, 1e-6 * scale, 1e-6 * scale)):
        assert a.dtype == b.dtype
        # a bf16 params' may round the other way on the sum's last fp32 bit
        rtol = BF16_ULP if a.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("rule", range(6))
@pytest.mark.parametrize("K,P", [(1, 1), (1, 2047), (5, 2049), (10, 159_010), (100, 38_656)])
def test_server_update_kernel_matches_plain(dev, K, P, rule):
    u, w, params, m, v = _server_operands(K, P, dev, K + P + rule)
    before = su_mod.launches
    got = su_mod.server_update(u, w, params, m, v, rule, 3)
    assert su_mod.launches == before + 1
    if rule not in su_mod.MOMENT_RULES:  # the AXPY rules hand the moments back untouched
        assert got[1] is m and got[2] is v
    _assert_server_close(got, su_mod.server_update_plain(u, w, params, m, v, rule, 3), u, w)


@pytest.mark.parametrize("drain", [False, True])
@pytest.mark.parametrize("Kb", [1, 8])
@pytest.mark.parametrize("rule", range(6))
def test_server_update_buffered_kernel_matches_plain(dev, rule, Kb, drain):
    u, w, params, m, v = _server_operands(10, 159_010, dev, rule)
    ring, bw, *_ = _server_operands(Kb, 159_010, dev, Kb + 100)
    flag = torch.tensor(drain, device=dev)
    before = su_mod.buffered_launches
    got = su_mod.server_update_buffered(u, w, ring, bw, params, m, v, rule, 3, flag)
    assert su_mod.buffered_launches == before + 1
    ref = su_mod.server_update_buffered_plain(u, w, ring, bw, params, m, v, rule, 3, flag)
    rows, wts = (torch.cat([u, ring]), torch.cat([w, bw])) if drain else (u, w)
    _assert_server_close(got, ref, rows, wts)


@pytest.mark.parametrize("K,P", [(1, 1), (5, 2049), (10, 159_010)])
def test_server_update_contracts_bitwise(dev, K, P):
    """(a) rule 0 is fedavg_reduce + apply_delta_flat; (b) drain=False is the
    unbuffered update for every rule, signs of zeros included."""
    from repro_torch.fl.server import apply_delta_flat

    u, w, params, m, v = _server_operands(K, P, dev, 7 * P)
    u[:, ::3] = 0.0  # columns whose delta is an exact +0.0
    p2, m2, v2 = su_mod.server_update(u, w, params, m, v, 0, 0)
    assert torch.equal(p2, apply_delta_flat(params, fedavg_mod.fedavg_reduce(u, w)))
    assert torch.equal(m2, m) and torch.equal(v2, v)
    ring, bw, *_ = _server_operands(8, P, dev, P)
    off = torch.tensor(False, device=dev)
    for rule in range(6):
        plain = su_mod.server_update(u, w, params, m, v, rule, 0)
        buffered = su_mod.server_update_buffered(u, w, ring, bw, params, m, v, rule, 0, off)
        for a, b in zip(plain, buffered):
            assert torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))


def test_server_update_wrappers_refuse_what_the_kernel_does_not_take(dev):
    u, w, params, m, v = _server_operands(4, 8, dev, 0)
    # bf16 rows and a bf16 ring go through the kernel
    ub = u.to(torch.bfloat16)
    _assert_server_close(su_mod.server_update(ub, w, params, m, v, 2, 0),
                         su_mod.server_update_plain(ub, w, params, m, v, 2, 0), u, w)
    with pytest.raises(ValueError):
        su_mod.server_update(u.to(torch.float16), w, params, m, v, 2, 0)
    with pytest.raises(ValueError):
        su_mod.server_update(torch.zeros((8, 4), device=dev).t(), w, params, m, v, 2, 0)
    with pytest.raises(ValueError):
        su_mod.server_update(u, w, params[:4], m, v, 2, 0)  # the wrong length
    ring = torch.zeros((2, 8), device=dev)
    on = torch.tensor(True, device=dev)
    rb = (1e-3 * torch.randn((2, 8), device=dev)).to(torch.bfloat16)
    _assert_server_close(
        su_mod.server_update_buffered(ub, w, rb, w[:2], params, m, v, 5, 0, on),
        su_mod.server_update_buffered_plain(ub, w, rb, w[:2], params, m, v, 5, 0, on),
        torch.cat([u, rb.float()]), torch.cat([w, w[:2]]))
    with pytest.raises(ValueError):  # the ring's rows in another dtype than the cohort's
        su_mod.server_update_buffered(u, w, rb, w[:2], params, m, v, 5, 0, on)
    with pytest.raises(ValueError):
        su_mod.server_update_buffered(u, w, torch.zeros((8, 2), device=dev).t(), w[:2],
                                      params, m, v, 5, 0, torch.tensor(True, device=dev))
    with pytest.raises(ValueError):  # drain must stay on the card, a 0-dim bool
        su_mod.server_update_buffered(u, w, ring, w[:2], params, m, v, 5, 0,
                                      torch.tensor(True))


@pytest.mark.parametrize("aggregator", ["fedadam", "fedbuff"])
def test_aggregator_lane_rounds_on_the_card_match_the_cpu(dev, aggregator):
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl.simulation import FLSimulation

    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1, num_clusters=3,
                  connection_rate=0.6, aggregator=aggregator)
    traffic = scenario_config("ring", num_vehicles=20)
    cfg = get_config("fl-mnist-mlp").replace(d_ff=32)
    gpu = FLSimulation(cfg, fl, traffic, "mnist", "contextual", prng.key(0), device=dev)
    cpu = FLSimulation(cfg, fl, traffic, "mnist", "contextual", prng.key(0), device="cpu")
    before = (su_mod.launches, su_mod.buffered_launches, fedavg_mod.launches)
    rg, rc = gpu.run(2), cpu.run(2)
    buffered = aggregator == "fedbuff"
    assert (su_mod.launches, su_mod.buffered_launches, fedavg_mod.launches) == (
        before[0] + 2 * (not buffered), before[1] + 2 * buffered, before[2])
    for a, b in zip(rg, rc):
        assert (a.n_selected, a.n_succeeded, a.n_buffered, a.n_drained) == (
            b.n_selected, b.n_succeeded, b.n_buffered, b.n_drained)
        assert abs(a.test_acc - b.test_acc) <= 0.01


def test_main_path_rounds_on_the_card_match_the_cpu(dev):
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl.simulation import FLSimulation

    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1,
                  num_clusters=3)
    traffic = scenario_config("ring", num_vehicles=20)
    cfg = get_config("fl-mnist-mlp").replace(d_ff=32)
    gpu = FLSimulation(cfg, fl, traffic, "mnist", "contextual", prng.key(0), device=dev)
    cpu = FLSimulation(cfg, fl, traffic, "mnist", "contextual", prng.key(0), device="cpu")
    before = (rttg_mod.launches, fedavg_mod.launches)
    rg, rc = gpu.run(2), cpu.run(2)
    assert (rttg_mod.launches, fedavg_mod.launches) == (before[0] + 4, before[1] + 2)
    for a, b in zip(rg, rc):
        assert (a.n_selected, a.n_succeeded) == (b.n_selected, b.n_succeeded)
        assert abs(a.test_acc - b.test_acc) <= 0.01


def _rsu_operands(K, P, R, dev, seed, exact, offset=0):
    """(updates, weights, rid, carry); ``exact``: dyadic updates and carry,
    integer weights, whose sums are exact in any order.  The updates start
    ``offset`` floats into their storage (``offset = P``: a row slice
    ``u[1:]``)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if exact:
        u = torch.randint(-64, 65, (K * P + offset,), generator=g,
                          device=dev).float() * 2.0 ** -12
        w = torch.randint(0, 5, (K,), generator=g, device=dev).float()
        carry = torch.randint(-64, 65, (R, P), generator=g, device=dev).float() * 2.0 ** -10
    else:
        u = 1e-3 * torch.randn((K * P + offset,), generator=g, device=dev)
        w = torch.rand((K,), generator=g, device=dev)
        carry = 1e-3 * torch.randn((R, P), generator=g, device=dev)
    rid = torch.randint(0, R, (K,), generator=g, device=dev).to(torch.int32)
    return u[offset:].view(K, P), w, rid, carry


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("mode", ["rand", "exact", "same", "hole", "masked", "out_of_range"])
@pytest.mark.parametrize("K,P,R,offset,pad", [
    pytest.param(*shape, 0, 0, id="-".join(map(str, shape))) for shape in (
        (4, 159_010, 10), (32, 159_010, 10), (1, 1, 1), (1, 515, 10), (7, 515, 10),
        (5, 2049, 1),
        # beyond one block's group of 32 RSUs
        (7, 515, 33), (4, 159_010, 33), (32, 2049, 100),
        # K off the kernel's 4-row slab; ragged and odd P
        (3, 159_010, 10), (31, 159_010, 10), (33, 159_010, 10), (4, 3, 10),
        (5, 1029, 10), (4, 159_011, 10), (6, 4096, 10))] + [
    # 8-byte rows at P % 4 == 0, and a row slice u[1:] at P = 159,010
    pytest.param(6, 4096, 10, 2, 0, id="6-4096-10-offset2"),
    pytest.param(4, 159_010, 10, 159_010, 0, id="4-159010-10-rowslice"),
    # the fleet's padded last chunk: 4 clients, then 28 padding slots
    pytest.param(32, 159_010, 10, 0, 28, id="32-159010-10-pad28"),
    pytest.param(5, 2049, 40, 0, 0, id="5-2049-40")])
def test_rsu_reduce_kernel_matches_plain(dev, K, P, R, offset, pad, mode, carry):
    u, w, rid, c = _rsu_operands(K, P, R, dev, K * 31 + P + R, exact=mode != "rand",
                                 offset=offset)
    if pad:
        w[K - pad:], rid[K - pad:] = 0.0, 0
    if mode == "same":
        rid[:] = R - 1
    elif mode == "hole":
        rid[rid == R // 2] = (R // 2 + 1) % R
    elif mode == "masked":
        w[rid == R // 2] = 0.0
    elif mode == "out_of_range":
        rid[::2] = R + 3
        rid[1::3] = -1
    before = rsu_mod.launches
    got, mass = rsu_mod.rsu_reduce(u, w, rid, R, carry=c.clone() if carry else None)
    assert rsu_mod.launches == before + 1
    want, want_mass = rsu_mod.rsu_reduce_plain(u, w, rid, R, c.clone() if carry else None)
    if mode == "rand":
        scale = float(rsu_mod.rsu_reduce_plain(u.abs(), w, rid, R)[0].max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)
        torch.testing.assert_close(mass, want_mass, rtol=1e-6, atol=0.0)
    else:
        assert torch.equal(got, want) and torch.equal(mass, want_mass)
    if mode in ("hole", "masked") and R > 1:
        base = c[R // 2] if carry else torch.zeros(P, device=dev)
        assert torch.equal(got[R // 2], base) and float(mass[R // 2]) == 0.0
    # a fixed summation order: a second launch repeats the first bitwise
    assert torch.equal(got, rsu_mod.rsu_reduce(u, w, rid, R, carry=c.clone() if carry
                                               else None)[0])


@pytest.mark.parametrize("K,B", [(10, 4), (100, 32)])
def test_rsu_reduce_chunk_walk_is_the_chunkwise_plain_composition(dev, K, B):
    """The streamed lane's walk (the first chunk without a carry, the rest
    in place) against zeros + the per-chunk plain sums, bit for bit."""
    P, R = 159_010, 10
    u, w, rid, _ = _rsu_operands(K, P, R, dev, K + B, exact=True)
    carry, acc = None, torch.zeros((R, P), device=dev)
    for i in range(0, K, B):
        carry, _ = rsu_mod.rsu_reduce(u[i:i + B], w[i:i + B], rid[i:i + B], R, carry=carry)
        acc = acc + rsu_mod.rsu_reduce_plain(u[i:i + B], w[i:i + B], rid[i:i + B], R)[0]
    assert torch.equal(carry, acc)


@pytest.mark.parametrize("R", [33, 100])
def test_rsu_reduce_chunk_walk_beyond_one_rsu_group(dev, R):
    """The chunk walk at R > 32 (several RSU groups per column block), bit
    for bit the per-chunk plain sums."""
    P = 4099
    u, w, rid, _ = _rsu_operands(40, P, R, dev, R, exact=True)
    carry, acc = None, torch.zeros((R, P), device=dev)
    for i in range(0, 40, 16):
        carry, _ = rsu_mod.rsu_reduce(u[i:i + 16], w[i:i + 16], rid[i:i + 16], R, carry=carry)
        acc = acc + rsu_mod.rsu_reduce_plain(u[i:i + 16], w[i:i + 16], rid[i:i + 16], R)[0]
    assert torch.equal(carry, acc)


def test_rsu_reduce_non_finite_row_poisons_every_rsu_as_the_plain_version(dev):
    u, w, rid, _ = _rsu_operands(5, 2049, 4, dev, 3, exact=True)
    u[2, :7] = float("inf")
    got, _ = rsu_mod.rsu_reduce(u, w, rid, 4)
    want, _ = rsu_mod.rsu_reduce_plain(u, w, rid, 4)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[:, :7]).any())
    torch.testing.assert_close(got, want, equal_nan=True)


def test_rsu_reduce_wrapper_refuses_what_the_kernel_does_not_take(dev):
    u, w, rid, c = _rsu_operands(4, 8, 3, dev, 0, exact=False)
    # bf16 rows go through the kernel, into fp32 and bf16 partials
    for out in (torch.float32, torch.bfloat16):
        got = rsu_mod.rsu_reduce(u.to(torch.bfloat16), w, rid, 3, out_dtype=out)[0]
        want = rsu_mod.rsu_reduce_plain(u.to(torch.bfloat16), w, rid, 3, out_dtype=out)[0]
        assert got.dtype == out
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-8)
    with pytest.raises(ValueError):
        rsu_mod.rsu_reduce(u.to(torch.float16), w, rid, 3)
    with pytest.raises(ValueError):  # bf16 partials come from bf16 rows only
        rsu_mod.rsu_reduce(u, w, rid, 3, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # the carry must be in out_dtype
        rsu_mod.rsu_reduce(u.to(torch.bfloat16), w, rid, 3, carry=c.clone(),
                           out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        rsu_mod.rsu_reduce(u, w, rid, 0)
    with pytest.raises(ValueError):  # past the grid's 65,535 groups of 32 RSUs
        rsu_mod.rsu_reduce(u, w, rid, rsu_mod.MAX_RSU + 1)
    with pytest.raises(ValueError):
        rsu_mod.rsu_reduce(u, w, rid.long(), 3)
    with pytest.raises(ValueError):
        rsu_mod.rsu_reduce(torch.zeros((8, 4), device=dev).t(), w, rid, 3)
    with pytest.raises(ValueError):
        rsu_mod.rsu_reduce(u, w, rid, 3, carry=c[:2])


def _two_tier_sims(dev, aggregator, cr, traffic_kw=None, **kw):
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl.simulation import FLSimulation

    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1, num_clusters=3,
                  select_fraction=0.35, connection_rate=cr, aggregator=aggregator, **kw)
    traffic = scenario_config("ring", num_vehicles=20, **(traffic_kw or {}))
    cfg = get_config("fl-mnist-mlp").replace(d_ff=32)
    return FLSimulation(cfg, fl, traffic, "mnist", "contextual", prng.key(0), device=dev)


@pytest.mark.parametrize("aggregator", ["fedavg", "fedavgm", "fedadam", "fedyogi", "stale",
                                        "fedbuff"])
def test_hierarchical_lane_is_the_flat_lane_bitwise_on_the_card(dev, aggregator):
    """Contract (a): every ring RSU is live and the counts are integers."""
    flat = _two_tier_sims(dev, aggregator, 0.7)
    hier = _two_tier_sims(dev, aggregator, 0.7, hierarchical=True)
    for _ in range(3):
        mf, mh = flat.step(), hier.step()
        for f in mf._fields:
            a, b = getattr(mf, f), getattr(mh, f)
            assert torch.equal(a, b) or bool(torch.isnan(a) & torch.isnan(b)), f
    for f in ("params", "opt_m", "opt_v", "sketches", "sketch_age", "buf_delta", "buf_mask"):
        assert torch.equal(getattr(flat.state, f), getattr(hier.state, f)), f


@pytest.mark.parametrize("aggregator", ["fedavg", "fedbuff"])
def test_streamed_lane_on_the_card_launches_one_reduce_per_chunk(dev, aggregator):
    """K = 7 in chunks of 3: three launches a round; the economics are the
    unblocked hierarchical lane's, the model within 1e-6."""
    hier = _two_tier_sims(dev, aggregator, 0.7, hierarchical=True)
    streamed = _two_tier_sims(dev, aggregator, 0.7, hierarchical=True, client_block=3)
    for _ in range(3):
        mh = hier.step()
        before = rsu_mod.launches
        mb = streamed.step()
        assert rsu_mod.launches == before + 3
        for f in ("n_selected", "n_succeeded", "n_buffered", "n_drained", "duration",
                  "sim_time"):
            assert torch.equal(getattr(mh, f), getattr(mb, f)), f
    torch.testing.assert_close(streamed.state.params, hier.state.params, rtol=0, atol=1e-6)


def test_streamed_lane_with_40_rsus_on_the_card_matches_the_cpu(dev):
    """The 10 km ring with an RSU every 250 m (R = 40: two RSU groups per
    column block) on the streamed lane: two rounds on the card and on the
    CPU from the same seed, three reduce launches a round, the same cohort
    counts and test accuracy within 0.01."""
    wide = dict(rsu_spacing_m=250.0)
    card = _two_tier_sims(dev, "fedavg", 0.7, wide, hierarchical=True, client_block=3)
    cpu = _two_tier_sims("cpu", "fedavg", 0.7, wide, hierarchical=True, client_block=3)
    assert card.scn.n_rsu == 40
    before = rsu_mod.launches
    rg, rc = card.run(2), cpu.run(2)
    assert rsu_mod.launches == before + 2 * 3
    for a, b in zip(rg, rc):
        assert (a.n_selected, a.n_succeeded, a.n_buffered, a.n_drained) == (
            b.n_selected, b.n_succeeded, b.n_buffered, b.n_drained)
        assert abs(a.test_acc - b.test_acc) <= 0.01


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("n", [4097, 20_000])
def test_fleet_geometry_on_the_card_matches_the_dense_forms(dev, n, dup):
    """The windowed neighbour search gives the dense search's neighbours and
    distances exactly; the compact fusion the dense fusion's kinematics
    within rtol 1e-5 (positions ~1e4 m: atol 1e-2), and repeats bitwise."""
    from repro_torch.core import fusion, messages
    from repro_torch.core.twin import init_twin_state

    scn = scenario_params(scenario_config("ring", num_vehicles=n), dev)
    twin = init_twin_state(scn, prng.key(n), dev)
    if dup:  # a third of the fleet at positions the others already hold
        twin = twin._replace(pos=torch.cat([twin.pos[: n - n // 3], twin.pos[: n // 3]]))
    before = messages.dense_rows
    dist, obj = messages.nearest_windowed(twin.pos, scn.ring_length_m, 8)
    assert messages.dense_rows > before
    d_dense, o_dense = messages.nearest_dense(twin.pos, scn.ring_length_m, 8)
    assert torch.equal(obj, o_dense) and torch.equal(dist, d_dense)
    key = prng.key(1)
    cams = messages.emit_cams(twin, scn, key)
    cpms = messages.emit_cpms(twin, scn, key)
    compact = fusion.fuse_kinematics(cams, cpms, scn)
    assert all(torch.equal(a, b) for a, b in zip(compact, fusion.fuse_kinematics(cams, cpms,
                                                                                   scn)))
    saved = messages.DENSE_MAX_N
    messages.DENSE_MAX_N = n
    try:
        dense = fusion.fuse_kinematics(cams, cpms, scn)
    finally:
        messages.DENSE_MAX_N = saved
    for a, b, atol in zip(compact, dense, (1e-2, 1e-5, 1e-5, 1e-7)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)


# ---- the bf16 lane: B2-B5 read 2-byte rows in their own bodies -----------------------
def _bf16_rows(K, P, dev, seed, offset=0):
    """(K, P) bf16 rows starting ``offset`` elements into their storage."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u = (1e-3 * torch.randn((K * P + offset,), generator=g, device=dev)).to(torch.bfloat16)
    return u[offset:].view(K, P), torch.rand((K,), generator=g, device=dev)


# the main shape, K = 1, odd P, P = 2 mod 4, rows one element off their 4-byte
# alignment, a ragged K past the load group of 8
@pytest.mark.parametrize("K,P,offset", [(10, 159_010, 0), (1, 159_010, 0), (7, 159_011, 0),
                                        (10, 4098, 0), (10, 4096, 1), (1, 1, 0),
                                        (17, 4097, 0)])
def test_fedavg_reduce_kernel_bf16_rows_match_plain(dev, K, P, offset):
    u, w = _bf16_rows(K, P, dev, K + P + offset, offset)
    before = fedavg_mod.launches
    got = fedavg_mod.fedavg_reduce(u, w)
    assert fedavg_mod.launches == before + 1 and got.dtype == torch.float32
    ref = fedavg_mod.fedavg_reduce_plain(u, w)
    scale = float((w.abs() @ u.float().abs()).max())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    assert torch.equal(got, fedavg_mod.fedavg_reduce(u, w))


@pytest.mark.parametrize("master", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", range(6))
@pytest.mark.parametrize("K,P", [(10, 159_010), (1, 1), (5, 2049), (3, 159_011)])
def test_server_update_kernel_bf16_rows_match_plain(dev, K, P, rule, master):
    u, w, params, m, v = _server_operands(K, P, dev, K + P + rule)
    ub, pm = u.to(torch.bfloat16), params.to(master)
    before = su_mod.launches
    got = su_mod.server_update(ub, w, pm, m, v, rule, 3)
    assert su_mod.launches == before + 1 and got[0].dtype == master
    _assert_server_close(got, su_mod.server_update_plain(ub, w, pm, m, v, rule, 3), ub, w)


@pytest.mark.parametrize("master", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drain", [False, True])
@pytest.mark.parametrize("rule", range(6))
def test_server_update_buffered_kernel_bf16_ring_matches_plain(dev, rule, drain, master):
    u, w, params, m, v = _server_operands(10, 159_010, dev, rule)
    ring, bw, *_ = _server_operands(8, 159_010, dev, 108)
    ub, rb, pm = u.to(torch.bfloat16), ring.to(torch.bfloat16), params.to(master)
    flag = torch.tensor(drain, device=dev)
    got = su_mod.server_update_buffered(ub, w, rb, bw, pm, m, v, rule, 3, flag)
    ref = su_mod.server_update_buffered_plain(ub, w, rb, bw, pm, m, v, rule, 3, flag)
    rows, wts = (torch.cat([ub, rb]), torch.cat([w, bw])) if drain else (ub, w)
    _assert_server_close(got, ref, rows, wts)


@pytest.mark.parametrize("master", [torch.float32, torch.bfloat16])
def test_server_update_contracts_bitwise_on_bf16_rows(dev, master):
    """The two contracts with bf16 rows and ring: (a) rule 0 is fedavg_reduce
    + apply_delta_flat, in the master dtype; (b) drain=False is the
    unbuffered update, every rule."""
    from repro_torch.fl.server import apply_delta_flat

    u, w, params, m, v = _server_operands(10, 159_010, dev, 5)
    u[:, ::3] = 0.0
    ub, pm = u.to(torch.bfloat16), params.to(master)
    p2, _, _ = su_mod.server_update(ub, w, pm, m, v, 0, 0)
    assert torch.equal(p2, apply_delta_flat(pm, fedavg_mod.fedavg_reduce(ub, w)))
    ring, bw, *_ = _server_operands(8, 159_010, dev, 6)
    off = torch.tensor(False, device=dev)
    for rule in range(6):
        plain = su_mod.server_update(ub, w, pm, m, v, rule, 0)
        buffered = su_mod.server_update_buffered(ub, w, ring.to(torch.bfloat16), bw, pm, m, v,
                                                 rule, 0, off)
        for a, b in zip(plain, buffered):
            assert torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("mode", ["rand", "exact"])
@pytest.mark.parametrize("K,P,R,offset", [
    (4, 159_010, 10, 0), (32, 159_010, 10, 0), (4, 159_010, 40, 0), (32, 159_010, 40, 0),
    (5, 159_011, 10, 0), (4, 3, 10, 0), (1, 1, 1, 0), (6, 4096, 10, 2), (6, 4096, 10, 1)])
def test_rsu_reduce_kernel_bf16_rows_match_plain(dev, K, P, R, offset, mode, carry, out):
    """bf16 rows into fp32 or bf16 partials, at the streamed lane's and the
    fleet's chunks, R = 10 and 40, odd P (the 2-byte plain-load pieces), 8-
    and 2-byte-aligned rows: dyadic operands bit for bit, random ones within
    one bf16 ulp (a last fp32 bit may round a bf16 partial the other way)."""
    u, w, rid, c = _rsu_operands(K, P, R, dev, K * 31 + P + R, exact=mode == "exact")
    ub = torch.empty((K * P + offset,), dtype=torch.bfloat16, device=dev)[offset:].view(K, P)
    ub.copy_(u)  # exact for the dyadic rows
    cb = c.to(out)
    before = rsu_mod.launches
    got, mass = rsu_mod.rsu_reduce(ub, w, rid, R, carry=cb.clone() if carry else None,
                                   out_dtype=out)
    assert rsu_mod.launches == before + 1 and got.dtype == out
    want, want_mass = rsu_mod.rsu_reduce_plain(ub, w, rid, R, cb.clone() if carry else None,
                                               out_dtype=out)
    if mode == "exact":
        assert torch.equal(got, want) and torch.equal(mass, want_mass)
    else:
        scale = float(rsu_mod.rsu_reduce_plain(ub.float().abs(), w, rid, R)[0].max())
        rtol = BF16_ULP if out == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-6 * scale)
        torch.testing.assert_close(mass, want_mass, rtol=1e-6, atol=0.0)
    again, _ = rsu_mod.rsu_reduce(ub, w, rid, R, carry=cb.clone() if carry else None,
                                  out_dtype=out)
    assert torch.equal(got, again)


def test_rsu_reduce_kernel_bf16_carry_rounds_twice(dev):
    """A chunk sum of 2^-8 + 2^-20 on a bf16 carry of 1: the kernel rounds
    the sum to bf16 (2^-8), adds the carry in fp32 and rounds again (a tie
    to even: 1.0), as the JAX round's partials + part_c; one rounding would
    give 1 + 2^-7."""
    P, R = 4099, 3
    u = torch.zeros((2, P), dtype=torch.bfloat16, device=dev)
    u[0], u[1] = 2.0 ** -8, 2.0 ** -20
    w = torch.ones(2, device=dev)
    rid = torch.zeros(2, dtype=torch.int32, device=dev)
    carry = torch.ones((R, P), dtype=torch.bfloat16, device=dev)
    got, _ = rsu_mod.rsu_reduce(u, w, rid, R, carry=carry.clone(), out_dtype=torch.bfloat16)
    want, _ = rsu_mod.rsu_reduce_plain(u, w, rid, R, carry.clone(), out_dtype=torch.bfloat16)
    assert torch.equal(got, want) and bool((got == 1.0).all())


@pytest.mark.parametrize("K,B,R", [(10, 4, 10), (100, 32, 10), (100, 32, 40)])
def test_rsu_reduce_bf16_chunk_walk_is_the_plain_walk(dev, K, B, R):
    """The bf16 streamed lane's walk (bf16 partials, the carry in place)
    against the plain walk, bit for bit on dyadic operands."""
    P = 159_010
    u, w, rid, _ = _rsu_operands(K, P, R, dev, K + B + R, exact=True)
    ub = u.to(torch.bfloat16)
    carry = want = None
    for i in range(0, K, B):
        cs = slice(i, i + B)
        carry, _ = rsu_mod.rsu_reduce(ub[cs], w[cs], rid[cs], R, carry=carry,
                                      out_dtype=torch.bfloat16)
        want, _ = rsu_mod.rsu_reduce_plain(ub[cs], w[cs], rid[cs], R, want,
                                           out_dtype=torch.bfloat16)
    assert torch.equal(carry, want)


@pytest.mark.parametrize("aggregator,kw", [("fedavg", {}), ("fedadam", {}), ("fedbuff", {}),
                                           ("fedbuff", dict(hierarchical=True, client_block=3)),
                                           ("fedadam", dict(param_dtype="bfloat16"))])
def test_bf16_lane_rounds_on_the_card_match_the_cpu(dev, aggregator, kw):
    """Two bf16 rounds on the card and on the CPU from the same seed: the
    same cohort counts, test accuracy within 0.01, the carry's dtypes kept."""
    card = _two_tier_sims(dev, aggregator, 0.7, compute_dtype="bfloat16", **kw)
    cpu = _two_tier_sims("cpu", aggregator, 0.7, compute_dtype="bfloat16", **kw)
    rg, rc = card.run(2), cpu.run(2)
    for a, b in zip(rg, rc):
        assert (a.n_selected, a.n_succeeded, a.n_buffered, a.n_drained) == (
            b.n_selected, b.n_succeeded, b.n_buffered, b.n_drained)
        assert abs(a.test_acc - b.test_acc) <= 0.01
    assert card.state.buf_delta.dtype == torch.bfloat16
    assert card.state.params.dtype == cpu.state.params.dtype


# ---- the serving path's kernels: swa_decode (B7) and ssd_scan (B8) -------------------
#
# swa_decode against its plain version within 2e-5 (rtol and atol; the kernel's online
# softmax and ``fmaf`` dots sum in another order than the plain two-pass softmax, on
# outputs of size ~1); a row with no visible slot exactly 0.  ssd_scan within 1e-4 of
# max |y| and max |h|: the two ``cumsum(dt * A)`` round differently and
# ``exp(cs_q - cs_k)`` carries cs's absolute rounding (an ulp of |cs| <= ~100 is ~1e-5)
# as a relative error.


def _swa_operands(B, C, hkv, G, D, dtype, dev, fills, seed=0):
    """q, k, v drawn from ``seed``; row b's ring holds a context of ``fills[b]`` tokens
    (-1 where none) and the query sits at position fills[b] - 1."""
    from repro_torch.models.layers import ring_positions

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((B, hkv, G, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, C, hkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, C, hkv, D), generator=g, device=dev).to(dtype)
    kv_pos = torch.stack([ring_positions(f, C, dev) for f in fills])
    pos = torch.tensor([f - 1 for f in fills], dtype=torch.int32, device=dev)
    return q, k, v, kv_pos, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,hkv,G,D,window,softcap,fills", [
    (4, 1024, 5, 5, 64, 1024, 0.0, (2080, 2080, 2080, 2080)),  # hymba-1.5b decode
    # gemma2-9b's local layers: 16 kv heads (8 repeated twice), D 256, softcap 50, the
    # 4,096-slot ring wrapped
    (2, 4096, 16, 1, 256, 4096, 50.0, (4176, 4170)),
    (2, 520, 16, 2, 128, 0, 0.0, (520, 513)),  # mistral-nemo-12b / chatglm3-6b: G 2, D 128
    # mixtral-8x7b: G 2, D 128 on its 4,096-slot window ring, wrapped
    (2, 4096, 16, 2, 128, 4096, 0.0, (4176, 4170)),
    (4, 2080, 16, 2, 128, 0, 0.0, (2080, 2079, 1500, 2080)),  # phi3.5-moe: B 4, no window
    (2, 784, 16, 4, 128, 0, 0.0, (784, 700)),  # internvl2-76b: G 4, image tokens first
    # the three configs' per-rank shapes served sharded over 4 ranks (kv heads / 4)
    (2, 4096, 4, 2, 128, 4096, 0.0, (4176, 4170)),  # mixtral-8x7b
    (4, 2080, 4, 2, 128, 0, 0.0, (2080, 2079, 1500, 2080)),  # phi3.5-moe
    (2, 784, 4, 4, 128, 0, 0.0, (784, 700)),  # internvl2-76b
    # whisper-small: the self ring of 64 slots wrapped, and the cross-attention over the
    # 1,500 cached frames with the query at the last one (every frame visible)
    (4, 64, 12, 1, 64, 0, 0.0, (95, 95, 95, 95)),
    (4, 1500, 12, 1, 64, 0, 0.0, (1500, 1500, 1500, 1500)),
    # whisper-small's per-rank shapes served sharded over 4 ranks: 3 heads a rank, the
    # 64-slot self ring after the prompt, the 1,500-frame cross-attention
    (4, 64, 3, 1, 64, 0, 0.0, (64, 64, 64, 64)),
    (4, 1500, 3, 1, 64, 0, 0.0, (1500, 1500, 1500, 1500)),
    (2, 1000, 2, 3, 64, 0, 0.0, (1000, 640)),  # C not a multiple of the 256-slot tile
    (3, 1, 2, 4, 32, 0, 0.0, (1, 5, 9)),  # one slot
    (2, 300, 4, 1, 128, 64, 0.0, (300, 77)),  # G = 1, a window inside the ring
    (2, 512, 2, 2, 256, 0, 50.0, (400, 5000)),  # a partly filled ring; softcap 50; D 256
    (1, 64, 1, 16, 32, 17, 30.0, (3000,)),  # a wrapped ring, pos far beyond C; G 16
    # the split-KV design's edges (128-slot splits; 64 for rows over 128 bytes, 32 over 256)
    (2, 300, 2, 3, 64, 17, 0.0, (300, 250)),  # a window narrower than a split
    (1, 1024, 2, 2, 64, 0, 0.0, (100,)),  # splits 2..15 hold no slot
    (1, 200, 2, 16, 256, 0, 50.0, (200,)),  # G 16, D 256, softcap 50
    (2, 130, 3, 2, 36, 0, 0.0, (130, 90)),  # a row of 4-byte multiples, not 16
    (1, 70, 2, 3, 17, 16, 0.0, (200,)),  # odd D: element copies in bf16
    # past 64 splits the last block combines in chunks, rescaling between them
    (1, 9000, 2, 3, 64, 0, 0.0, (9000,)),
    (2, 9000, 1, 2, 64, 500, 0.0, (9000, 12000)),  # row 0: the first chunk sees nothing
])
def test_swa_decode_kernel_matches_plain(dev, dtype, B, C, hkv, G, D, window, softcap, fills):
    from repro_torch.kernels import swa_decode as swa

    q, k, v, kv_pos, pos = _swa_operands(B, C, hkv, G, D, dtype, dev, fills)
    before = swa.launches
    got = swa.swa_decode(q, k, v, kv_pos, pos, window=window, softcap=softcap)
    assert swa.launches == before + 1
    ref = swa.swa_decode_plain(q, k, v, kv_pos, pos, window, softcap)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
    # a fixed order: a second launch repeats the first bitwise
    assert torch.equal(got, swa.swa_decode(q, k, v, kv_pos, pos, window=window,
                                           softcap=softcap))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_decode_row_with_no_visible_slot_is_zero(dev, dtype):
    """Row 1's ring is empty and row 2's slots all lie after its query: both give
    exactly 0, as ``ref.swa_decode`` does; row 0 is an ordinary row."""
    from repro_torch.kernels import swa_decode as swa

    q, k, v, kv_pos, pos = _swa_operands(3, 300, 2, 3, 64, dtype, dev, (300, 300, 300))
    kv_pos[1] = -1
    pos[2] = -1
    got = swa.swa_decode(q, k, v, kv_pos, pos, window=1024)
    ref = swa.swa_decode_plain(q, k, v, kv_pos, pos, 1024)
    assert torch.equal(got[1:], torch.zeros_like(got[1:]))
    assert torch.equal(ref[1:], torch.zeros_like(ref[1:]))
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_decode_blind_rows_across_many_splits_are_zero(dev, dtype):
    """hymba's decode shape (16 splits per (b, kv head)) with row 1's ring
    empty and row 2's window past every slot: exactly 0 there; the run
    repeats bitwise."""
    from repro_torch.kernels import swa_decode as swa

    q, k, v, kv_pos, pos = _swa_operands(4, 1024, 5, 5, 64, dtype, dev, (2080,) * 4)
    kv_pos[1] = -1
    kv_pos[2] = torch.clamp(kv_pos[2], max=1000)  # every slot before pos - window
    before = swa.launches
    got = swa.swa_decode(q, k, v, kv_pos, pos, window=1024)
    assert swa.launches == before + 1
    ref = swa.swa_decode_plain(q, k, v, kv_pos, pos, 1024)
    assert torch.equal(got[1:3], torch.zeros_like(got[1:3]))
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, swa.swa_decode(q, k, v, kv_pos, pos, window=1024))


def test_swa_decode_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels import swa_decode as swa

    q, k, v, kv_pos, pos = _swa_operands(1, 8, 1, 2, 32, torch.float32, dev, (8,))
    with pytest.raises(NotImplementedError):
        swa.swa_decode(q.half(), k.half(), v.half(), kv_pos, pos)
    with pytest.raises(ValueError):
        swa.swa_decode(q, k.to(torch.bfloat16), v, kv_pos, pos)  # mixed dtypes
    with pytest.raises(ValueError):
        swa.swa_decode(q, k, v, kv_pos.long(), pos)
    big = torch.zeros((1, 1, 17, 32), device=dev)
    with pytest.raises(ValueError):
        swa.swa_decode(big, k, v, kv_pos, pos)  # G = 17
    many = torch.zeros((swa.MAX_BATCH_HEADS + 1, 1, 1, 1), device=dev)
    with pytest.raises(ValueError):  # B * Hkv past the grid's y-extent
        swa.swa_decode(many, many, many,
                       torch.zeros((swa.MAX_BATCH_HEADS + 1, 1), dtype=torch.int32, device=dev),
                       torch.zeros((swa.MAX_BATCH_HEADS + 1,), dtype=torch.int32, device=dev))


def _ssd_operands(B, S, nh, hp, ds, dtype, dev, seed=0, with_h0=False):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((B, S, nh, hp), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, S, nh), generator=g, device=dev))
    A = -torch.exp(0.3 * torch.randn((nh,), generator=g, device=dev))
    Bs = torch.randn((B, S, ds), generator=g, device=dev).to(dtype)
    Cs = torch.randn((B, S, ds), generator=g, device=dev).to(dtype)
    h0 = torch.randn((B, nh, hp, ds), generator=g, device=dev) if with_h0 else None
    return x, dt, A, Bs, Cs, h0


def _assert_ssd_close(got, ref):
    for a, b in zip(got, ref):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hp,ds,chunk,with_h0", [
    (4, 2048, 50, 64, 16, 128, False),  # hymba-1.5b prefill
    (4, 2048, 24, 64, 128, 128, False),  # mamba2-130m prefill
    (2, 1, 3, 16, 8, 128, False),  # one step
    (2, 200, 4, 32, 16, 128, True),  # S not a multiple of Q, a given h0
    (3, 100, 2, 8, 32, 128, False),  # Q > S: one chunk of S
    (1, 300, 24, 64, 128, 128, True),  # mamba2-130m's head: the largest shared tile
    (8, 4096, 50, 64, 16, 128, False),  # 12,800 blocks, many resident waves: the chain
    (2, 1000, 50, 64, 16, 128, True),  # hymba's head with an h0, a ragged last chunk
    (2, 300, 3, 36, 24, 128, True),  # hp, ds not whole mma tiles
    (1, 77, 2, 13, 9, 32, True),  # odd hp and ds, a ragged chunk of 13 steps
    (2, 40, 12, 32, 16, 16, False),  # the smoke config's prefill: chunks of 16
    (3, 100, 12, 32, 16, 16, True),  # chunks of 16, a ragged last one, an h0
    # the per-rank shapes served sharded over 4 ranks: mamba2-130m's 6 heads,
    # hymba-1.5b's 25 virtual heads of 32, the half-head test config's 5 of 16
    (4, 2048, 6, 64, 128, 128, False),
    (4, 2048, 25, 32, 16, 128, False),
    (2, 40, 5, 16, 16, 16, False),
    (2, 40, 5, 16, 16, 16, True),
])
def test_ssd_scan_kernel_matches_plain(dev, dtype, B, S, nh, hp, ds, chunk, with_h0):
    from repro_torch.kernels import ssd_scan as ssd

    x, dt, A, Bs, Cs, h0 = _ssd_operands(B, S, nh, hp, ds, dtype, dev, with_h0=with_h0)
    before = ssd.launches
    got = ssd.ssd_scan(x, dt, A, Bs, Cs, chunk, h0)
    assert ssd.launches == before + 1
    ref = ssd.ssd_scan_plain(x, dt, A, Bs, Cs, chunk, h0)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _assert_ssd_close(got, ref)
    again = ssd.ssd_scan(x, dt, A, Bs, Cs, chunk, h0)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_ssd_scan_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels import ssd_scan as ssd

    x, dt, A, Bs, Cs, _ = _ssd_operands(1, 16, 2, 8, 8, torch.float32, dev)
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt.to(torch.bfloat16), A, Bs, Cs, 8)
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, A, Bs.to(torch.bfloat16), Cs, 8)
    x, dt, A, Bs, Cs, _ = _ssd_operands(1, 256, 1, 256, 256, torch.float32, dev)
    with pytest.raises(ValueError):  # a (Q, ds) / (hp, ds) tile beyond shared memory
        ssd.ssd_scan(x, dt, A, Bs, Cs, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_serving_on_the_card_matches_the_cpu(dev, dtype):
    """The smoke hybrid LM: prefill past the window (the ring wraps, the last SSD chunk
    is partial) and 3 decode steps on the card through the kernels, and on the CPU
    through the plain versions from the same weights.  fp32 logits within 1e-4; bf16
    within 0.0625 (a few bf16 steps at |logits| ~ 4: GEMMs summed in another order
    flip roundings of the 8-bit activations)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.models import build_model

    cfg = get_smoke_config("hymba-1.5b").replace(dtype=dtype)
    api = build_model(cfg)
    params = api.init(prng.key(0), dev)
    cpu_params = _tree_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 44), generator=torch.Generator().manual_seed(1))
    before = (ssd.launches, swa.launches)
    with torch.no_grad():
        lg, cg = api.prefill(params, {"tokens": toks[:, :40].to(dev)}, 44)
        lc, cc = api.prefill(cpu_params, {"tokens": toks[:, :40]}, 44)
        outs = [(lg, lc)]
        for i in range(3):
            lg, cg = api.decode_step(params, cg, toks[:, 40 + i].to(dev))
            lc, cc = api.decode_step(cpu_params, cc, toks[:, 40 + i])
            outs.append((lg, lc))
    layers = cfg.num_layers
    assert (ssd.launches, swa.launches) == (before[0] + layers, before[1] + 3 * layers)
    tol = 1e-4 if dtype == "float32" else 0.0625
    for a, b in outs:
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen1.5-0.5b", "gemma2-9b",
                                  "mistral-nemo-12b", "chatglm3-6b"])
def test_family_serving_on_the_card_matches_the_cpu(dev, arch):
    """The ssm and dense smoke LMs in fp32: prefill past gemma2-smoke's 32-slot
    window (mamba2-smoke's last chunk partial) and 3 decode steps on the card
    through the kernels and on the CPU from the same weights, logits within 1e-4;
    ``ssd_scan`` once per SSM layer, ``swa_decode`` once per attention layer a step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch)
    api = build_model(cfg)
    params = api.init(prng.key(0), dev)
    cpu_params = _tree_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 44), generator=torch.Generator().manual_seed(1))
    before = (ssd.launches, swa.launches)
    with torch.no_grad():
        lg, cg = api.prefill(params, {"tokens": toks[:, :40].to(dev)}, 44)
        lc, cc = api.prefill(cpu_params, {"tokens": toks[:, :40]}, 44)
        outs = [(lg, lc)]
        for i in range(3):
            lg, cg = api.decode_step(params, cg, toks[:, 40 + i].to(dev))
            lc, cc = api.decode_step(cpu_params, cc, toks[:, 40 + i])
            outs.append((lg, lc))
    ssm_layers = cfg.num_layers if cfg.family == "ssm" else 0
    attn_layers = cfg.num_layers - ssm_layers
    assert (ssd.launches, swa.launches) == (before[0] + ssm_layers,
                                            before[1] + 3 * attn_layers)
    for a, b in outs:
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# ---- pairwise_cosine and the four-stage pipeline ------------------------------

GRAM_SHAPES = [(7, 64), (100, 1024), (128, 512), (33, 2000), (127, 511), (129, 513),
               (1, 512), (256, 1)]


def _gram_rows(n, d, dev, seed, dtype=torch.float32):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn((n, d), generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", GRAM_SHAPES)
def test_pairwise_cosine_kernel_matches_plain(dev, n, d, dtype):
    """Within atol 1e-5 of the plain version (TF32 off), bitwise symmetric,
    the diagonal within 1e-5 of 1."""
    from repro_torch.kernels import pairwise_cosine as pc
    from repro_torch.utils.device import resolve_device

    resolve_device(dev)
    x = _gram_rows(n, d, dev, n * 10_007 + d, dtype)
    before = pc.launches
    got = pc.pairwise_cosine(x)
    assert pc.launches == before + 1
    ref = pc.pairwise_cosine_plain(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    assert torch.equal(got, got.T)
    assert bool(((got.diagonal() - 1.0).abs() <= 1e-5).all())


def test_pairwise_cosine_zero_row_is_exactly_zero_on_the_card(dev):
    from repro_torch.kernels import pairwise_cosine as pc

    x = _gram_rows(100, 1024, dev, 3)
    x[37] = 0
    got = pc.pairwise_cosine(x)
    assert not got[37].any() and not got[:, 37].any()
    torch.testing.assert_close(got, pc.pairwise_cosine_plain(x), rtol=0, atol=1e-5)


# the launch plan's edges (kernels/pairwise_cosine.py::plan): one row; 32 x 32
# tiles at and past a tile edge, with D split 1, 2, 8 and 16 ways; unsplit 32 x
# 32 tiles up to N = 1920 and the switch to 128 x 128 tiles at N = 1921
GRAM_EDGES = [(1, 33), (32, 64), (33, 64), (64, 100), (65, 100), (97, 33), (100, 1024),
              (129, 513), (200, 128), (960, 64), (961, 64), (1920, 64), (1921, 64),
              (2000, 96)]


@pytest.mark.parametrize("n,d", GRAM_EDGES)
def test_pairwise_cosine_at_the_plans_tile_and_split_edges(dev, n, d):
    """One launch; within atol 1e-5 of the plain version, bitwise symmetric,
    the diagonal within 1e-5 of 1, a zero row exactly zero in its row and
    column, and a second call bitwise the first."""
    from repro_torch.kernels import pairwise_cosine as pc
    from repro_torch.utils.device import resolve_device

    resolve_device(dev)
    x = _gram_rows(n, d, dev, n + 7 * d)
    x[n // 2] = 0
    before = pc.launches
    got = pc.pairwise_cosine(x)
    assert pc.launches == before + 1
    torch.testing.assert_close(got, pc.pairwise_cosine_plain(x), rtol=0, atol=1e-5)
    assert torch.equal(got, got.T)
    assert not got[n // 2].any() and not got[:, n // 2].any()
    keep = torch.arange(n, device=dev) != n // 2
    assert bool(((got.diagonal()[keep] - 1.0).abs() <= 1e-5).all())
    assert torch.equal(got, pc.pairwise_cosine(x))


@pytest.mark.parametrize("n,m,d", [(128, 256, 512), (33, 100, 2000), (1, 5, 1), (100, 7, 1024),
                                   (40, 50, 1000), (700, 900, 256), (2100, 1900, 64)])
def test_gram_nt_kernel_matches_plain(dev, n, m, d):
    from repro_torch.kernels import pairwise_cosine as pc
    from repro_torch.utils.device import resolve_device

    resolve_device(dev)
    x, y = _gram_rows(n, d, dev, 1 + n), _gram_rows(m, d, dev, 2 + m)
    got = pc.gram_nt(x, y)
    scale = float((x.abs() @ y.abs().T).max())
    torch.testing.assert_close(got, pc.gram_nt_plain(x, y), rtol=1e-5, atol=1e-6 * scale)
    assert torch.equal(got, pc.gram_nt(x, y))


def test_gram_nt_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels import pairwise_cosine as pc

    x = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        pc.gram_nt(x, torch.zeros((4, 9), device=dev))  # another D
    with pytest.raises(ValueError):
        pc.gram_nt(x, torch.zeros((4, 8)))  # y on the CPU
    with pytest.raises(ValueError):
        pc.gram_nt(x[0], x)  # not (N, D)


def test_selector_round_on_the_card_matches_the_cpu(dev):
    """One ContextualSelector round (ring, N=100, sketch_dim 1024, random
    updates) on the card and on the CPU from the same state: RSU ids, loads,
    adjacency, connectivity, masks and cluster labels equal; one Gram launch."""
    from repro_torch import core
    from repro_torch.config import FLConfig
    from repro_torch.kernels import pairwise_cosine as pc
    from repro_torch.utils.device import resolve_device

    resolve_device(dev)
    n = 100
    fl = FLConfig(num_clients=n, connection_rate=0.7)
    traffic = scenario_config("ring", num_vehicles=n)
    twin = core.TrafficTwin(traffic, prng.key(0), dev)
    st = twin.advance(twin.init_state(), prng.key(1), 10.0)
    vecs = 1e-2 * _gram_rows(n, 5000, dev, 4)
    outs = {}
    for where in (dev, torch.device("cpu")):
        sel = core.ContextualSelector(fl, traffic, prng.key(0), where)
        rttg = sel.observe(core.TwinState(*[x.to(where) for x in st]))
        lat, _ = sel.predicted_latency(407_080)
        sel.report_updates(torch.arange(n), vecs.to(where))
        sel.recluster()
        before = pc.launches
        gram = core.pairwise_cosine(sel.sketches)
        assert pc.launches == before + (1 if where.type == "cuda" else 0)
        out = sel.select("contextual", 407_080)
        outs[where.type] = (rttg, lat, sel.clusters, gram, out)
    (rg, lg, cg, gg, og), (rc, lc, cc, gc, oc) = outs["cuda"], outs["cpu"]
    for f in ("rsu_id", "load", "adj"):
        assert torch.equal(getattr(rg, f).cpu(), getattr(rc, f)), f
    torch.testing.assert_close(rg.pos.cpu(), rc.pos, rtol=1e-6, atol=1e-2)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gg.cpu(), gc, rtol=0, atol=1e-5)
    assert torch.equal(cg.cpu(), cc)
    for f in ("mask", "connected"):
        assert torch.equal(og[f].cpu(), oc[f]), f
    assert int(og["mask"].sum()) > 0


@pytest.mark.parametrize("cr", [1.0, 0.7])
def test_unfused_round_on_the_card_matches_the_fused_round(dev, cr):
    """The unfused lane (plain torch on the card) against the fused lane
    (the rttg_latency kernel): integers equal, floats within rtol 1e-5."""
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl.rounds import cohort_size_for, make_round_step
    from repro_torch.fl.simulation import FLSimulation

    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1, num_clusters=3,
                  connection_rate=cr)
    sim = FLSimulation(get_config("fl-mnist-mlp").replace(d_ff=32), fl,
                       scenario_config("ring", num_vehicles=20), "mnist", "contextual",
                       prng.key(0), device=dev)
    sim.warmup_sketches()
    unfused = make_round_step(sim.api.loss, fl, cohort_size_for(fl, ("contextual",)),
                              sim.model_bytes, sim.param_spec, ("contextual",), fused=False)
    before = rttg_mod.launches
    (su, mu) = unfused(sim.state, sim.scn, 0, 0, sim.data, True)
    assert rttg_mod.launches == before
    (sf, mf) = sim._step(sim.state, sim.scn, 0, 0, sim.data, True)
    for f in ("round", "n_selected", "n_succeeded"):
        assert int(getattr(mf, f)) == int(getattr(mu, f)), f
    for f in ("sketch_age", "clusters", "buf_mask"):
        assert torch.equal(getattr(sf, f), getattr(su, f)), f
    for f in ("sim_time", "duration", "mean_pred_latency", "mean_real_latency"):
        torch.testing.assert_close(getattr(mu, f), getattr(mf, f), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(su.params, sf.params, rtol=1e-5, atol=1e-7)


def _skewed_moe_layer(cfg, dtype, dev, B=2, S=256):
    """One layer's weights and an input leaning along router column 0."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def draw(shape, fan_in, dt=dtype):
        return (torch.randn(shape, generator=g, device=dev) / fan_in ** 0.5).to(dt)

    p = {"router": draw((d, E), d, torch.float32), "w_gate": draw((E, d, ff), d),
         "w_up": draw((E, d, ff), d), "w_down": draw((E, ff, d), ff)}
    col = p["router"][:, 0]
    x = (0.5 * torch.randn((B, S, d), generator=g, device=dev) + 6.0 * col / col.norm())
    return p, x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"])
def test_moe_layer_on_the_card_matches_the_cpu(dev, arch, dtype):
    """The smoke MoE layer on a skewed input that drops copies: expert ids, slots
    and the kept mask equal on the card and the CPU, y within 1e-4 (fp32) /
    0.0625 (bf16) on identical inputs, and the card's call syncs with the host
    nowhere."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    cfg = get_smoke_config(arch)
    p, x = _skewed_moe_layer(cfg, dtype, dev)
    cp, cx = _tree_to(p, "cpu"), x.cpu()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_ffn(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    yc, auxc = moe.moe_ffn(cp, cx, cfg)
    N, d = x.shape[0] * x.shape[1], x.shape[2]
    r = moe.route(p["router"], x.reshape(N, d), cfg.experts_per_token)
    rc = moe.route(cp["router"], cx.reshape(N, d), cfg.experts_per_token)
    for f in ("expert", "slot", "keep"):
        assert torch.equal(getattr(r, f).cpu(), getattr(rc, f)), f
    assert int((~rc.keep).sum()) > 0
    tol = 1e-4 if dtype == torch.float32 else 0.0625
    torch.testing.assert_close(y.cpu().float(), yc.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(aux.cpu(), auxc, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "internvl2-76b"])
def test_moe_and_vlm_serving_on_the_card_matches_the_cpu(dev, arch, dtype):
    """The smoke moe and vlm LMs through the serve CLI's code on the card and the
    CPU: the same prompt tokens, image embeddings within 4 ulps (the draw's
    ``erf_inv`` polynomial may round apart on the two), one ``swa_decode``
    launch per layer and decode step, logits within 1e-4 (fp32) / 0.0625 (bf16)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import serve

    cfg = get_smoke_config(arch).replace(dtype=dtype)
    before = swa.launches
    card = serve.serve(batch=2, prompt_len=40, gen=4, device=dev, cfg=cfg)
    assert swa.launches == before + 3 * cfg.num_layers
    cpu = serve.serve(batch=2, prompt_len=40, gen=4, device="cpu", cfg=cfg)
    tol = 1e-4 if dtype == "float32" else 0.0625
    assert torch.equal(card.prompts["tokens"].cpu(), cpu.prompts["tokens"])
    if cfg.family == "vlm":
        torch.testing.assert_close(card.prompts["image_embeds"].cpu(),
                                   cpu.prompts["image_embeds"], rtol=4 * 2.0 ** -23, atol=0)
    torch.testing.assert_close(card.logits.cpu().float(), cpu.logits.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_serving_on_the_card_matches_the_cpu(dev, dtype):
    """The smoke whisper-small through the serve CLI's code on the card and the
    CPU: frames within 4 ulps, two ``swa_decode`` launches per decoder layer
    and decode step, logits within 1e-4 (fp32) / 0.0625 (bf16)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import serve

    cfg = get_smoke_config("whisper-small").replace(dtype=dtype)
    before = swa.launches
    card = serve.serve(batch=2, prompt_len=8, gen=4, device=dev, cfg=cfg)
    assert swa.launches == before + 2 * cfg.num_layers * 3
    cpu = serve.serve(batch=2, prompt_len=8, gen=4, device="cpu", cfg=cfg)
    tol = 1e-4 if dtype == "float32" else 0.0625
    assert torch.equal(card.prompts["tokens"].cpu(), cpu.prompts["tokens"])
    torch.testing.assert_close(card.prompts["frames"].cpu(), cpu.prompts["frames"],
                               rtol=4 * 2.0 ** -23, atol=0)
    torch.testing.assert_close(card.logits.cpu().float(), cpu.logits.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("aggregators", [("fedavg",), ("fedavg", "fedbuff")])
def test_engine_grid_on_the_card_matches_the_cpu(dev, aggregators):
    """A 4-lane grid per aggregator (contextual / gossip x ring / platoon, N=20,
    CR 0.7, 3 rounds, eval every 2) on the card against the CPU's plain path:
    integers equal, floats within rtol 2e-4, atol 1e-5 (the engine tests'
    tolerance), NaN alike.  Both registries take the batched round: exactly
    2 rttg_latency_grid launches a round and one server launch, whatever the
    lanes: fedavg_reduce_grid for ("fedavg",), server_update_buffered_grid
    for a registry holding fedbuff; no one-lane launch."""
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl import ExperimentEngine

    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1, num_clusters=3,
                  batch_size=32, connection_rate=0.7, recluster_every=2)
    grid = dict(seeds=(0,), scenarios=("ring", "platoon"), rounds=3, eval_every=2)
    out = {}
    for where in (dev, torch.device("cpu")):
        eng = ExperimentEngine(get_config("fl-mnist-mlp").replace(d_ff=32), fl, "mnist",
                               strategies=("contextual", "gossip"), aggregators=aggregators,
                               device=where)
        counters = lambda: (rttg_mod.launches, fedavg_mod.launches,  # noqa: E731
                            su_mod.buffered_launches, rttg_mod.grid_launches,
                            fedavg_mod.grid_launches, su_mod.buffered_grid_launches)
        before = counters()
        out[where.type] = eng.run_grid(**grid)
        after = counters()
        if where.type == "cuda":
            fedbuff = "fedbuff" in aggregators
            assert eng.batched
            assert [a - b for a, b in zip(after, before)] == (
                [0, 0, 0, 2 * grid["rounds"], 0 if fedbuff else grid["rounds"],
                 grid["rounds"] if fedbuff else 0])
    got, ref = out["cuda"], out["cpu"]
    assert got.runs == ref.runs
    for f in got.metrics._fields:
        a, b = getattr(got.metrics, f).cpu(), getattr(ref.metrics, f)
        if a.dtype == torch.int32:
            assert torch.equal(a, b), f
        else:
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f
            torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5, equal_nan=True, msg=f)


def _grid_lanes(scenarios, n, cr, dev, **scn_kw):
    """G lanes of ``_geometry``, one a scenario: each lane's own scenario,
    their lane view, (G, N) kinematics, (G,) times, (G, N) forced or None."""
    from repro_torch.core.scenarios import lane_view, stack_scenarios

    lanes = [_geometry(name, n, cr, dev, **scn_kw) for name in scenarios]
    scns = [lane[0] for lane in lanes]
    pos, speed, accel = (torch.stack([lane[i] for lane in lanes]) for i in (1, 2, 3))
    forced = torch.stack([lane[4] for lane in lanes]) if cr < 1.0 else None
    t = 77.5 + 3.25 * torch.arange(len(scenarios), dtype=torch.float32, device=dev)
    return scns, lane_view(stack_scenarios(scns)), pos, speed, accel, t, forced


CATALOG = ("ring", "highway", "urban_grid", "rush_hour", "rsu_outage", "platoon",
           "hetero_fleet", "day_cycle")


@pytest.mark.parametrize("scenarios,n", [(CATALOG * 3, 20), (CATALOG * 3, 100), (("ring",), 1),
                                         (("day_cycle", "rush_hour"), 1024),
                                         (("rsu_outage", "ring"), 100)])
@pytest.mark.parametrize("predict", [True, False])
@pytest.mark.parametrize("cr", [1.0, 0.7])
def test_rttg_latency_grid_kernel_is_the_one_lane_kernel_lane_by_lane(dev, scenarios, n,
                                                                      predict, cr):
    """B1g: one launch for G lanes, each lane bit for bit B1 on that lane;
    against its plain version connectivity exactly, latency within rtol 1e-5;
    a second call bit for bit the first."""
    scns, view, pos, speed, accel, t, forced = _grid_lanes(scenarios, n, cr, dev)
    before = rttg_mod.grid_launches
    got, again = [rttg_mod.rttg_latency_grid(pos, speed, accel, t, 636_040.0, forced, view,
                                             predict=predict) for _ in range(2)]
    assert rttg_mod.grid_launches == before + 2
    ref = rttg_mod.rttg_latency_grid_plain(pos, speed, accel, t, 636_040.0, forced, view, predict)
    for g, scn in enumerate(scns):
        lat, conn = rttg_mod.rttg_latency(pos[g], speed[g], accel[g], t[g], 636_040.0,
                                          None if forced is None else forced[g], scn,
                                          predict=predict)
        assert torch.equal(got[0][g], lat) and torch.equal(got[1][g], conn), g
    assert torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-7)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,K,P,offset", [(24, 2, 159_010, 0), (24, 10, 159_010, 0),
                                          (1, 2, 159_010, 0), (24, 1, 159_010, 0),
                                          (3, 7, 159_011, 0), (5, 3, 159_010, 1),
                                          (1, 1, 1, 0)])
def test_fedavg_reduce_grid_kernel_is_the_one_lane_kernel_lane_by_lane(dev, G, K, P, offset,
                                                                       rows):
    """B2g: one launch for G lanes, each lane bit for bit B2 on that lane,
    against its plain version within 1e-6 of sum_k |w_k u_k|, repeated
    bitwise.  ``offset`` starts the rows one element off their alignment."""
    u = 1e-3 * prng.normal(prng.key(G + K + P), (G, K, P), dev)
    u = torch.empty((G * K * P + offset,), dtype=rows, device=dev)[offset:].view(G, K, P).copy_(u)
    w = prng.uniform(prng.key(G * K), (G, K), device=dev)
    before = fedavg_mod.grid_launches
    got = fedavg_mod.fedavg_reduce_grid(u, w)
    assert fedavg_mod.grid_launches == before + 1
    lanes = torch.stack([fedavg_mod.fedavg_reduce(u[g], w[g]) for g in range(G)])
    assert torch.equal(got, lanes)
    ref = fedavg_mod.fedavg_reduce_grid_plain(u, w)
    scale = float((w.abs()[:, None, :] @ u.float().abs()).max())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    assert torch.equal(got, fedavg_mod.fedavg_reduce_grid(u, w))


def test_grid_wrappers_refuse_what_the_kernels_do_not_take(dev):
    scns, view, pos, speed, accel, t, _ = _grid_lanes(("ring", "highway"), 8, 1.0, dev)
    with pytest.raises(ValueError):
        rttg_mod.rttg_latency_grid(pos[:1], speed[:1], accel[:1], t[:1], 1.0, None, view,
                                   predict=True)  # one lane of kinematics, two of scenario
    with pytest.raises(ValueError):
        rttg_mod.rttg_latency_grid(pos, speed, accel, t[:1], 1.0, None, view, predict=True)
    big = _grid_lanes(("ring",), 4097, 1.0, dev)
    with pytest.raises(ValueError, match="4096"):
        rttg_mod.rttg_latency_grid(*big[2:5], big[5], 1.0, None, big[1], predict=True)
    u = torch.zeros((2, 3, 8), device=dev)
    with pytest.raises(ValueError):
        fedavg_mod.fedavg_reduce_grid(u, torch.ones((2, 2), device=dev))
    with pytest.raises(ValueError):
        fedavg_mod.fedavg_reduce_grid(u.half(), torch.ones((2, 3), device=dev))
    with pytest.raises(ValueError):
        fedavg_mod.fedavg_reduce_grid(u.transpose(0, 1), torch.ones((3, 2), device=dev))


def test_batched_grid_on_the_card_matches_its_lane_loop(dev):
    """The five-strategy ("fedavg",) grid (N=20, CR 0.7, 3 rounds) through the
    batched round and through the lane loop on the same lanes, both on the
    card: integers equal, floats within rtol 2e-4, atol 1e-5, NaN alike."""
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl import ExperimentEngine

    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1, num_clusters=3,
                  batch_size=32, connection_rate=0.7, recluster_every=2)
    eng = ExperimentEngine(get_config("fl-mnist-mlp").replace(d_ff=32), fl, "mnist",
                           strategies=("greedy", "gossip", "data", "network", "contextual"),
                           device=dev)
    runs = [(st, "fedavg", 0, sc) for st in eng.strategies for sc in ("ring", "platoon")]
    batched = eng._sweep(eng._lanes(runs), 3, 2)
    loop = eng._sweep(eng._lane_list(runs), 3, 2)
    for f in batched._fields:
        a, b = getattr(batched, f).cpu(), getattr(loop, f).cpu()
        if a.dtype == torch.int32:
            assert torch.equal(a, b), f
        else:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5, equal_nan=True, msg=f)


ALL_RULES = (0, 1, 2, 3, 4, 5)
AXPY_RULES = (0, 4, 5)


def _server_grid_operands(G, K, Kb, P, registry, rows, master, dev, seed):
    """G lanes of server operands on the card: rows and ring in ``rows``,
    params in ``master``, each lane's rule from ``registry`` (all of them
    present when G allows, then drawn), drain mixed across lanes."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u = (1e-3 * torch.randn((G, K, P), generator=g, device=dev)).to(rows)
    w = torch.rand((G, K), generator=g, device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    params = (0.05 * torch.randn((G, P), generator=g, device=dev)).to(master)
    m = 1e-4 * torch.randn((G, P), generator=g, device=dev)
    v = (1e-3 * torch.randn((G, P), generator=g, device=dev)) ** 2
    ring = (1e-3 * torch.randn((G, Kb, P), generator=g, device=dev)).to(rows)
    bw = torch.rand((G, Kb), generator=g, device=dev)
    reg = torch.tensor(registry, dtype=torch.int32, device=dev)
    pick = torch.randint(0, len(registry), (G,), generator=g, device=dev)
    pick[:min(G, len(registry))] = torch.arange(min(G, len(registry)), device=dev)
    drain = torch.rand((G,), generator=g, device=dev) < 0.5
    drain[:2] = torch.tensor([True, False], device=dev)[:G]
    return u, w, params, m, v, ring, bw, reg[pick].contiguous(), drain


@pytest.mark.parametrize("buffered", [False, True])
@pytest.mark.parametrize("registry", [ALL_RULES, AXPY_RULES])
@pytest.mark.parametrize("rows,master", [(torch.float32, torch.float32),
                                         (torch.bfloat16, torch.float32),
                                         (torch.float32, torch.bfloat16),
                                         (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("G,K,Kb,P", [(24, 2, 8, 159_010), (48, 2, 8, 159_010),
                                      (24, 20, 8, 159_010), (1, 2, 8, 159_010),
                                      (5, 3, 8, 2049), (6, 2, 1, 159_010)])
def test_server_update_grid_kernel_is_the_one_lane_kernel_lane_by_lane(dev, G, K, Kb, P, rows,
                                                                       master, registry,
                                                                       buffered):
    """B3g / B4g: one launch for G lanes whose rules (and, buffered, drain
    flags) differ, each lane bit for bit B3 / B4 on that lane (an AXPY lane's
    m' and v' its m and v when the registry holds a moment rule; m and v
    themselves when it holds none), against the plain version within the
    one-lane tolerance, and a second launch bit for bit the first."""
    u, w, params, m, v, ring, bw, rules, drain = _server_grid_operands(
        G, K, Kb, P, registry, rows, master, dev, G * 1000 + K + Kb + P)
    if buffered:
        call = lambda: su_mod.server_update_buffered_grid(  # noqa: E731
            u, w, ring, bw, params, m, v, rules, 3, drain, registry=registry)
        plain = su_mod.server_update_buffered_grid_plain(u, w, ring, bw, params, m, v, rules, 3,
                                                         drain, registry=registry)
        counter = "buffered_grid_launches"
    else:
        call = lambda: su_mod.server_update_grid(u, w, params, m, v, rules, 3,  # noqa: E731
                                                 registry=registry)
        plain = su_mod.server_update_grid_plain(u, w, params, m, v, rules, 3, registry=registry)
        counter = "grid_launches"
    before = getattr(su_mod, counter)
    got, again = call(), call()
    assert getattr(su_mod, counter) == before + 2
    for g, rule in enumerate(rules.tolist()):
        if buffered:
            one = su_mod.server_update_buffered(u[g], w[g], ring[g], bw[g], params[g], m[g],
                                                v[g], rule, 3, drain[g])
        else:
            one = su_mod.server_update(u[g], w[g], params[g], m[g], v[g], rule, 3)
        for a, b in zip(got, one):
            assert torch.equal(a[g], b), (g, rule)
    if registry == AXPY_RULES:
        assert got[1] is m and got[2] is v
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    wts = torch.cat([w, torch.where(drain[:, None], bw, 0.0)], 1) if buffered else w
    cat = torch.cat([u, ring], 1) if buffered else u
    scale = float((wts.abs()[:, None, :] @ cat.float().abs()).max())
    for a, b, atol in zip(got, plain, (1e-4 * scale, 1e-6 * scale, 1e-6 * scale)):
        assert a.dtype == b.dtype
        rtol = BF16_ULP if a.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


def test_server_update_grid_wrappers_refuse_what_the_kernel_does_not_take(dev):
    u, w, params, m, v, ring, bw, rules, drain = _server_grid_operands(
        3, 2, 4, 8, ALL_RULES, torch.float32, torch.float32, dev, 0)
    with pytest.raises(ValueError):  # the rule index must be int32
        su_mod.server_update_grid(u, w, params, m, v, rules.long(), 0)
    with pytest.raises(ValueError):  # on the rows' device
        su_mod.server_update_grid(u, w, params, m, v, rules.cpu(), 0)
    with pytest.raises(ValueError):
        su_mod.server_update_grid(u.to(torch.float16), w, params, m, v, rules, 0)
    with pytest.raises(ValueError):
        su_mod.server_update_grid(u.transpose(1, 2).contiguous().transpose(1, 2), w, params, m,
                                  v, rules, 0)
    with pytest.raises(ValueError):  # one lane of params for three of rows
        su_mod.server_update_grid(u, w, params[:1], m, v, rules, 0)
    with pytest.raises(ValueError):
        su_mod.server_update_grid(u[0], w[0], params[0], m[0], v[0], rules[:1], 0)
    with pytest.raises(ValueError):  # the ring in another dtype than the rows
        su_mod.server_update_buffered_grid(u, w, ring.to(torch.bfloat16), bw, params, m, v,
                                           rules, 0, drain)
    with pytest.raises(ValueError):  # drain stays on the card, (G,) bool
        su_mod.server_update_buffered_grid(u, w, ring, bw, params, m, v, rules, 0, drain.cpu())
    with pytest.raises(ValueError):
        su_mod.server_update_buffered_grid(u, w, ring, bw, params, m, v, rules, 0, drain[:2])
    with pytest.raises(ValueError):
        su_mod.server_update_buffered_grid(u, w, ring, bw[:, :2], params, m, v, rules, 0, drain)
    big = torch.zeros((su_mod.MAX_LANES + 1, 1, 1), device=dev)
    with pytest.raises(ValueError):  # past the grid's second dimension
        su_mod.server_update_grid(big, big[:, :, 0], big[:, 0], big[:, 0], big[:, 0],
                                  torch.zeros((big.shape[0],), dtype=torch.int32, device=dev), 0)


# ---- the column streamers' launch plan (fedavg_reduce.column_plan) at its edges -----
def _column_rows(G, K, P, rows, offset, dev, seed, exact):
    """(G, K, P) rows in ``rows`` starting ``offset`` elements into their
    storage, and (G, K) weights.  ``exact``: dyadic rows (7 significant
    bits, exact in bf16) and weights (3 bits) whose weighted sums are exact
    in fp32 in any order, so every summation order gives the same bits."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if exact:
        u = torch.randint(-64, 65, (G, K, P), generator=g, device=dev).float() * 2.0 ** -12
        w = torch.randint(1, 9, (G, K), generator=g, device=dev).float() / 16
    else:
        u = 1e-3 * torch.randn((G, K, P), generator=g, device=dev)
        w = torch.rand((G, K), generator=g, device=dev)
    store = torch.empty((G * K * P + offset,), dtype=rows, device=dev)
    return store[offset:].view(G, K, P).copy_(u), w


def _b2g_is_b2_and_plain(u, w, exact):
    """B2g on (G, K, P) rows: each lane bit for bit B2 on that lane, the
    plain version bit for bit on exact operands (else within 1e-6 of sum_k
    |w_k u_k|), a second launch bit for bit the first."""
    G = u.shape[0]
    before = fedavg_mod.grid_launches
    got = fedavg_mod.fedavg_reduce_grid(u, w)
    assert fedavg_mod.grid_launches == before + 1
    for g in range(G):
        assert torch.equal(got[g], fedavg_mod.fedavg_reduce(u[g], w[g])), g
    ref = fedavg_mod.fedavg_reduce_grid_plain(u, w)
    if exact:
        assert torch.equal(got, ref)
    else:
        scale = float((w.abs()[:, None, :] @ u.float().abs()).max())
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    assert torch.equal(got, fedavg_mod.fedavg_reduce_grid(u, w))


# P at each residue mod 8 but 0 and 4 (P * item not a multiple of 16: the rows
# of a lane start at different alignments), rows 0-7 elements off their
# storage's alignment (the load width falls to 1 or 2 elements, the runs a
# thread rise to keep 16 bytes a row)
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("residue", [1, 2, 3, 5, 6, 7])
def test_fedavg_reduce_plan_at_every_residue_and_offset(dev, residue, offset, rows, exact):
    P = 8 * 5000 + residue
    u, w = _column_rows(3, 3, P, rows, offset, dev, residue * 10 + offset, exact)
    _b2g_is_b2_and_plain(u, w, exact)


# the cohort's rows against the load groups (K = 1, the wide plan's group of 2
# and 4 rows, past 8, past 16) and the lanes (one, the bench grid's 24, 131 >
# the H100's 132 SMs' worth of plans at one block a lane)
@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 24, 131])
@pytest.mark.parametrize("K", [1, 2, 3, 9, 17])
def test_fedavg_reduce_plan_across_cohorts_and_lanes(dev, K, G, rows):
    u, w = _column_rows(G, K, 159_010, rows, 0, dev, 100 * K + G, exact=False)
    _b2g_is_b2_and_plain(u, w, exact=False)


@pytest.mark.parametrize("buffered", [False, True])
@pytest.mark.parametrize("rows,master", [(torch.float32, torch.float32),
                                         (torch.bfloat16, torch.float32),
                                         (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("offset", [0, 1, 3, 6])
@pytest.mark.parametrize("residue", [1, 2, 3, 5, 6, 7])
def test_server_update_plan_at_every_residue(dev, residue, offset, rows, master, buffered):
    """B3g / B4g at P of each residue mod 8 but 0 and 4, rows and ring
    ``offset`` elements off their alignment: each lane (every rule, drain
    mixed) bit for bit B3 / B4 on that lane, within the plain version's
    tolerance, a second launch bit for bit the first."""
    P = 8 * 3000 + residue
    u, w, params, m, v, ring, bw, rules, drain = _server_grid_operands(
        6, 3, 2, P, ALL_RULES, torch.float32, master, dev, 31 * residue + offset)
    store = torch.empty((u.numel() + ring.numel() + offset,), dtype=rows, device=dev)
    u = store[offset:offset + u.numel()].view(u.shape).copy_(u)
    ring = store[offset + u.numel():].view(ring.shape).copy_(ring)
    if buffered:
        call = lambda: su_mod.server_update_buffered_grid(  # noqa: E731
            u, w, ring, bw, params, m, v, rules, 3, drain)
        plain = su_mod.server_update_buffered_grid_plain(u, w, ring, bw, params, m, v, rules, 3,
                                                         drain)
    else:
        call = lambda: su_mod.server_update_grid(u, w, params, m, v, rules, 3)  # noqa: E731
        plain = su_mod.server_update_grid_plain(u, w, params, m, v, rules, 3)
    got = call()
    for g, rule in enumerate(rules.tolist()):
        one = (su_mod.server_update_buffered(u[g], w[g], ring[g], bw[g], params[g], m[g], v[g],
                                             rule, 3, drain[g]) if buffered
               else su_mod.server_update(u[g], w[g], params[g], m[g], v[g], rule, 3))
        for a, b in zip(got, one):
            assert torch.equal(a[g], b), (g, rule)
    assert all(torch.equal(a, b) for a, b in zip(got, call()))
    wts = torch.cat([w, torch.where(drain[:, None], bw, 0.0)], 1) if buffered else w
    cat = torch.cat([u, ring], 1) if buffered else u
    scale = float((wts.abs()[:, None, :] @ cat.float().abs()).max())
    for a, b, atol in zip(got, plain, (1e-4 * scale, 1e-6 * scale, 1e-6 * scale)):
        rtol = BF16_ULP if a.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("master", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residue", [1, 2, 3, 5, 6, 7])
def test_server_update_contracts_bitwise_on_bf16_rows_at_every_residue(dev, residue, master):
    """B3 / B4's two contracts on bf16 rows and ring at P of each residue mod
    8 but 0 and 4, the rows one element off their alignment: (a) rule 0 is
    fedavg_reduce + apply_delta_flat; (b) drain=False is the unbuffered
    update, every rule, signs of zeros included."""
    from repro_torch.fl.server import apply_delta_flat

    P = 8 * 20_000 + residue
    u, w, params, m, v = _server_operands(10, P, dev, residue)
    u[:, ::3] = 0.0
    ub = torch.empty((10 * P + 1,), dtype=torch.bfloat16, device=dev)[1:].view(10, P).copy_(u)
    pm = params.to(master)
    p2, m2, v2 = su_mod.server_update(ub, w, pm, m, v, 0, 0)
    assert torch.equal(p2, apply_delta_flat(pm, fedavg_mod.fedavg_reduce(ub, w)))
    assert torch.equal(m2, m) and torch.equal(v2, v)
    ring, bw, *_ = _server_operands(8, P, dev, residue + 50)
    rb = ring.to(torch.bfloat16)
    off = torch.tensor(False, device=dev)
    for rule in range(6):
        plain = su_mod.server_update(ub, w, pm, m, v, rule, 0)
        buffered = su_mod.server_update_buffered(ub, w, rb, bw, pm, m, v, rule, 0, off)
        for a, b in zip(plain, buffered):
            assert torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("aggregators,cr", [(("fedavg", "fedavgm", "fedadam", "fedyogi", "stale",
                                              "fedbuff"), 0.7),
                                             (("fedavgm", "fedadam", "fedyogi", "stale"), 0.7),
                                             (("fedbuff",), 0.7)])
def test_batched_grid_under_every_rule_on_the_card_matches_its_lane_loop(dev, aggregators, cr):
    """A registry's grid (contextual / greedy x its rules x ring / platoon,
    N=20, 3 rounds) through the batched round (2 B1g and one B3g or B4g a
    round, no one-lane launch) and through the lane loop, both on the card:
    integers equal, floats within rtol 2e-4, atol 1e-5, NaN alike."""
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl import ExperimentEngine

    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1, num_clusters=3,
                  batch_size=32, connection_rate=cr, recluster_every=2)
    eng = ExperimentEngine(get_config("fl-mnist-mlp").replace(d_ff=32), fl, "mnist",
                           strategies=("contextual", "greedy"), aggregators=aggregators,
                           device=dev)
    assert eng.batched
    runs = [(st, a, 0, sc) for st in eng.strategies for a in aggregators
            for sc in ("ring", "platoon")]
    lanes = eng._lanes(runs)
    counters = lambda: (rttg_mod.launches, su_mod.launches, su_mod.buffered_launches,  # noqa: E731
                        rttg_mod.grid_launches, su_mod.grid_launches,
                        su_mod.buffered_grid_launches)
    before = counters()
    batched = eng._sweep(lanes, 3, 2)
    fedbuff = "fedbuff" in aggregators
    assert [a - b for a, b in zip(counters(), before)] == [0, 0, 0, 6, 0 if fedbuff else 3,
                                                           3 if fedbuff else 0]
    loop = eng._sweep(eng._lane_list(runs), 3, 2)
    for f in batched._fields:
        a, b = getattr(batched, f).cpu(), getattr(loop, f).cpu()
        if a.dtype == torch.int32:
            assert torch.equal(a, b), f
        else:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5, equal_nan=True, msg=f)
    if fedbuff:
        assert int(batched.n_buffered.sum()) > 0


def _rsu_grid_operands(G, K, P, R, rows, out, offset, dev, seed):
    """B5g's operands: (G, K, P) rows in ``rows`` starting ``offset``
    elements into their storage, (G, K) weights, (G, K) int32 ids with some
    outside [0, R) and padding slots (weight 0, id 0), a (G, R, P) carry in
    ``out``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u = 1e-3 * torch.randn((G, K, P), generator=g, device=dev)
    u = torch.empty((G * K * P + offset,), dtype=rows, device=dev)[offset:].view(G, K, P).copy_(u)
    w = torch.rand((G, K), generator=g, device=dev)
    rid = torch.randint(0, R, (G, K), generator=g, device=dev).to(torch.int32)
    flat = rid.view(-1)
    flat[1::5], flat[3::7] = -1, R + 3
    w[:, K - 1:], rid[:, K - 1:] = 0.0, 0  # the round's padding slot
    carry = (1e-3 * torch.randn((G, R, P), generator=g, device=dev)).to(out)
    return u, w, rid, carry


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("rows,out", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("G,K,P,R,offset", [(12, 3, 159_010, 10, 0), (8, 4, 159_010, 10, 0),
                                            (5, 4, 2049, 40, 0), (3, 5, 159_011, 10, 0),
                                            (4, 4, 4096, 10, 2), (6, 2, 159_010, 33, 1),
                                            (1, 1, 1, 1, 0)])
def test_rsu_reduce_grid_kernel_is_the_one_lane_kernel_lane_by_lane(dev, G, K, P, R, offset,
                                                                    rows, out, carry):
    """B5g: one launch for G lanes, each lane bit for bit B5 on that lane
    (the carry updated in place in both); against its plain version within
    rtol 1e-5 (one bf16 ulp for bf16 partials) and 1e-6 of sum_k |m_kr u_k|;
    a second launch bit for bit the first."""
    u, w, rid, c = _rsu_grid_operands(G, K, P, R, rows, out, offset, dev, G * 7 + K + P + R)
    before, one_before = rsu_mod.grid_launches, rsu_mod.launches
    got, mass = rsu_mod.rsu_reduce_grid(u, w, rid, R, carry=c.clone() if carry else None,
                                        out_dtype=out)
    assert rsu_mod.grid_launches == before + 1 and rsu_mod.launches == one_before
    assert got.shape == (G, R, P) and got.dtype == out and mass.shape == (G, R)
    for g in range(G):
        one, one_mass = rsu_mod.rsu_reduce(u[g], w[g], rid[g], R,
                                           carry=c[g].clone() if carry else None, out_dtype=out)
        assert torch.equal(got[g], one) and torch.equal(mass[g], one_mass), g
    ref, ref_mass = rsu_mod.rsu_reduce_grid_plain(u, w, rid, R, c.clone() if carry else None,
                                                  out)
    scale = float(rsu_mod.rsu_reduce_grid_plain(u.float().abs(), w, rid, R)[0].max())
    rtol = BF16_ULP if out == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-6 * scale)
    torch.testing.assert_close(mass, ref_mass, rtol=1e-6, atol=0.0)
    again, _ = rsu_mod.rsu_reduce_grid(u, w, rid, R, carry=c.clone() if carry else None,
                                       out_dtype=out)
    assert torch.equal(got, again)


@pytest.mark.parametrize("rows,out", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("R", [10, 40])
def test_rsu_reduce_grid_chunk_walk_is_each_lanes_b5_walk(dev, R, rows, out):
    """Eight lanes' walk of 10 slots in chunks of 4 (the streamed grid's
    K = 10, the last chunk padded by 2): the first chunk without a carry,
    the rest in place, every lane bit for bit its one-lane B5 walk."""
    G, K, B, P = 8, 12, 4, 159_010
    u, w, rid, _ = _rsu_grid_operands(G, K, P, R, rows, out, 0, dev, R)
    w[:, 10:], rid[:, 10:] = 0.0, 0
    carry = None
    for c in range(0, K, B):
        carry, _ = rsu_mod.rsu_reduce_grid(u[:, c:c + B].contiguous(),
                                           w[:, c:c + B].contiguous(),
                                           rid[:, c:c + B].contiguous(), R, carry=carry,
                                           out_dtype=out)
    for g in range(G):
        one = None
        for c in range(0, K, B):
            one, _ = rsu_mod.rsu_reduce(u[g, c:c + B], w[g, c:c + B], rid[g, c:c + B], R,
                                        carry=one, out_dtype=out)
        assert torch.equal(carry[g], one), g


def test_rsu_reduce_grid_wrapper_refuses_what_the_kernel_does_not_take(dev):
    u, w, rid, c = _rsu_grid_operands(2, 3, 8, 4, torch.float32, torch.float32, 0, dev, 1)
    with pytest.raises(ValueError):  # strided rows
        rsu_mod.rsu_reduce_grid(u.transpose(0, 1).contiguous().transpose(0, 1), w, rid, 4)
    with pytest.raises(ValueError):  # fp16 rows
        rsu_mod.rsu_reduce_grid(u.half(), w, rid, 4)
    with pytest.raises(ValueError):  # bf16 partials from fp32 rows
        rsu_mod.rsu_reduce_grid(u, w, rid, 4, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # int64 ids
        rsu_mod.rsu_reduce_grid(u, w, rid.long(), 4)
    with pytest.raises(ValueError):  # strided ids
        rsu_mod.rsu_reduce_grid(u, w, rid.t().contiguous().t(), 4)
    with pytest.raises(ValueError):  # weights on the host
        rsu_mod.rsu_reduce_grid(u, w.cpu(), rid, 4)
    with pytest.raises(ValueError):  # a carry of another lane count
        rsu_mod.rsu_reduce_grid(u, w, rid, 4, carry=c[:1].clone())
    with pytest.raises(ValueError):  # one lane's rows: B5's form
        rsu_mod.rsu_reduce_grid(u[0], w[0], rid[0], 4)
    big = torch.zeros((rsu_mod.MAX_LANES + 1, 1, 1), device=dev)
    with pytest.raises(ValueError):  # past the grid's third dimension
        rsu_mod.rsu_reduce_grid(big, big[:, :, 0], big[:, :, 0].to(torch.int32), 1)


@pytest.mark.parametrize("scenarios,n", [(CATALOG * 3, 20), (CATALOG, 100),
                                         (("rsu_outage", "ring"), 1024)])
@pytest.mark.parametrize("predict", [True, False])
def test_rttg_latency_grid_kernel_ids_are_the_one_lane_kernels(dev, scenarios, n, predict):
    """B1g's RSU ids (the two-tier lanes' realized pass): each lane's ids,
    latency and connectivity bit for bit B1's with ids on that lane; the ids
    equal the plain version's exactly; asking for them changes nothing else."""
    scns, view, pos, speed, accel, t, forced = _grid_lanes(scenarios, n, 0.7, dev)
    before = rttg_mod.grid_launches
    lat, conn, rid = rttg_mod.rttg_latency_grid(pos, speed, accel, t, 636_040.0, forced, view,
                                                predict=predict, want_rid=True)
    assert rttg_mod.grid_launches == before + 1 and rid.dtype == torch.int32
    for g, scn in enumerate(scns):
        one = rttg_mod.rttg_latency(pos[g], speed[g], accel[g], t[g], 636_040.0, forced[g], scn,
                                    predict=predict, want_rid=True)
        assert all(torch.equal(a[g], b) for a, b in zip((lat, conn, rid), one)), g
    ref = rttg_mod.rttg_latency_grid_plain(pos, speed, accel, t, 636_040.0, forced, view,
                                           predict, want_rid=True)
    assert torch.equal(rid, ref[2]) and torch.equal(conn, ref[1])
    without = rttg_mod.rttg_latency_grid(pos, speed, accel, t, 636_040.0, forced, view,
                                         predict=predict)
    assert torch.equal(lat, without[0]) and torch.equal(conn, without[1])


def _grid_counters_are_zero(dev, G, n_rsu):
    """B1g's per-lane counter region (``(G, R + 1)`` int32: the RSU totals,
    then the departure count) reads all zeros."""
    from repro_torch.kernels.build import counters

    region = counters(dev, "rttg_latency_grid", G * (n_rsu + 1))[:G * (n_rsu + 1)]
    return int(torch.count_nonzero(region)) == 0


def _grid_graph_replays_bitwise(dev, view, pos, speed, accel, t, forced, predict, want_rid):
    """One B1g call captured into a CUDA graph (after a warm-up call on a side
    stream) and replayed: the replay's outputs are the eager call's bit for
    bit and the counter region reads zeros after it."""
    mb = torch.tensor(636_040.0, device=dev)

    def call():
        return rttg_mod.rttg_latency_grid(pos, speed, accel, t, mb, forced, view,
                                          predict=predict, want_rid=want_rid)

    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = call()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(static, eager))
    assert _grid_counters_are_zero(dev, pos.shape[0], view.n_rsu)


def _wide_grid_lanes(scenarios, n, dev, **scn_kw):
    """``_grid_lanes`` at CR 0.7 with lane g's positions moved on by 97 g
    metres round its ring, so that lanes of one scenario differ."""
    scns, view, pos, speed, accel, t, forced = _grid_lanes(scenarios, n, 0.7, dev, **scn_kw)
    shift = 97.0 * torch.arange(len(scenarios), dtype=torch.float32, device=dev)[:, None]
    pos = torch.remainder(pos + shift, view.ring_length_m)
    return scns, view, pos, speed, accel, t, forced


def _grid_lanes_of(G):
    """G lanes over the catalog (dark-RSU lanes beside live ones); one lane is
    rsu_outage's (dark RSUs)."""
    return (("rsu_outage",) + CATALOG * (G // len(CATALOG) + 1))[:G]


# B1g at its launch plan's edges: lanes of up to 4,096 clients, one a thread up to
# four, in one block a lane (N < 768, G >= SMs) or in T tiles of a cooperative
# launch; one lane (rsu_outage: dark RSUs), two (the greedy grid's lane group), 24
# over the catalog and 133 (more lanes than SMs), predicted and realized, with and
# without the ids
@pytest.mark.parametrize("n", [32, 33, 256, 257, 767, 768, 1023, 1025, 2048, 4095, 4096])
@pytest.mark.parametrize("G", [1, 2, 24, 133], ids=["G1", "G2", "G24", "G133"])
@pytest.mark.parametrize("predict", [True, False])
@pytest.mark.parametrize("want_rid", [False, True])
def test_rttg_latency_grid_kernel_above_one_block_is_the_one_lane_kernel(dev, n, G,
                                                                        predict, want_rid):
    """Every lane bit for bit a B1 call on that lane, ids included; conn (and
    ids) exactly the plain version's, latency within rtol 1e-5; a second call
    bit for bit the first; the per-lane counters at zero after each call and
    after a CUDA-graph replay of one."""
    scns, view, pos, speed, accel, t, forced = _wide_grid_lanes(_grid_lanes_of(G), n, dev)
    before = rttg_mod.grid_launches
    got = rttg_mod.rttg_latency_grid(pos, speed, accel, t, 636_040.0, forced, view,
                                     predict=predict, want_rid=want_rid)
    assert _grid_counters_are_zero(dev, G, view.n_rsu)
    again = rttg_mod.rttg_latency_grid(pos, speed, accel, t, 636_040.0, forced, view,
                                       predict=predict, want_rid=want_rid)
    assert _grid_counters_are_zero(dev, G, view.n_rsu)
    assert rttg_mod.grid_launches == before + 2
    for g, scn in enumerate(scns):
        one = rttg_mod.rttg_latency(pos[g], speed[g], accel[g], t[g], 636_040.0, forced[g], scn,
                                    predict=predict, want_rid=want_rid)
        assert all(torch.equal(a[g], b) for a, b in zip(got, one)), g
    ref = rttg_mod.rttg_latency_grid_plain(pos, speed, accel, t, 636_040.0, forced, view,
                                           predict, want_rid=want_rid)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], ref[1:]))
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-7)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _grid_graph_replays_bitwise(dev, view, pos, speed, accel, t, forced, predict, want_rid)


# R = 1 (lanes of 4,096 in tiles), R = 40 (past the 32 RSUs whose totals one warp
# polls) and R = 32,768 (160 KB of shared memory a block): above 32 RSUs one block
# a lane, four clients a thread at N = 4,096
@pytest.mark.parametrize("spacing", [10_000.0, 250.0, 10_000.0 / 32768],
                         ids=["R1", "R40", "R32768"])
@pytest.mark.parametrize("G,n", [(2, 33), (24, 257), (2, 4096), (24, 4096)])
@pytest.mark.parametrize("predict", [True, False])
def test_rttg_latency_grid_kernel_at_the_rsu_count_edges(dev, spacing, G, n, predict):
    """As above on ring lanes with one RSU and with 32,768; the plain version
    lane by lane (its (G, N, R) distances at R = 32,768 would take tens of
    GB)."""
    from repro_torch.kernels.build import library

    scns, view, pos, speed, accel, t, forced = _wide_grid_lanes(("ring",) * G, n, dev,
                                                                rsu_spacing_m=spacing)
    assert view.n_rsu == round(10_000.0 / spacing)
    tiles = rttg_mod.grid_launch_plan(library(), dev, G, n, view.n_rsu)[0]
    assert (tiles > 1) == (view.n_rsu <= rttg_mod.GRID_POLL_RSU_MAX
                           and n >= rttg_mod.GRID_SPREAD_MIN)
    got, again = [rttg_mod.rttg_latency_grid(pos, speed, accel, t, 636_040.0, forced, view,
                                             predict=predict, want_rid=True)
                  for _ in range(2)]
    assert _grid_counters_are_zero(dev, G, view.n_rsu)
    for g, scn in enumerate(scns):
        one = rttg_mod.rttg_latency(pos[g], speed[g], accel[g], t[g], 636_040.0, forced[g], scn,
                                    predict=predict, want_rid=True)
        assert all(torch.equal(a[g], b) for a, b in zip(got, one)), g
        ref = rttg_mod.rttg_latency_plain(pos[g], speed[g], accel[g], t[g], 636_040.0,
                                          forced[g], scn, predict, want_rid=True)
        assert torch.equal(got[1][g], ref[1]) and torch.equal(got[2][g], ref[2]), g
        torch.testing.assert_close(got[0][g], ref[0], rtol=1e-5, atol=1e-7)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _grid_graph_replays_bitwise(dev, view, pos, speed, accel, t, forced, predict, True)


def test_rttg_latency_grid_launch_refuses_a_plan_it_cannot_run(dev):
    """The C entry refuses, with cudaErrorInvalidValue (1), tiles that do not
    cover a lane at four clients a thread, more blocks than the card holds
    resident, a multi-tile launch without its counters and tiles of a lane
    of more than 32 RSUs; a refused launch leaves no error behind."""
    from repro_torch.kernels.build import counters, library

    scns, view, pos, speed, accel, t, _ = _grid_lanes(("ring", "highway"), 4096, 1.0, dev)
    lib = library()
    op = rttg_mod.grid_operand(view, dev)
    mb = torch.tensor(636_040.0, device=dev)
    lat = torch.empty_like(pos)
    conn = torch.empty(pos.shape, dtype=torch.bool, device=dev)
    cnt = counters(dev, "rttg_latency_grid", 2 * (view.n_rsu + 1))
    stream = torch.cuda.current_stream().cuda_stream

    def launch(tiles, threads, counts, n_rsu=view.n_rsu, op=op):
        return lib.rttg_latency_grid_launch(
            op.data_ptr(), op.shape[1], n_rsu, 2, t.data_ptr(), mb.data_ptr(),
            pos.data_ptr(), speed.data_ptr(), accel.data_ptr(), None, 4096, 50, 0.1, 5.0, tiles,
            threads, counts, lat.data_ptr(), conn.data_ptr(), None, stream)

    assert launch(1, 512, None) == 1  # 2,048 of 4,096 clients
    assert launch(2, 256, cnt.data_ptr()) == 1  # tiles of 2,048 on 1,024 slots
    assert launch(4096, 32, cnt.data_ptr()) == 1  # 8,192 blocks: past residency
    assert launch(16, 256, None) == 1  # tiles without counters
    # tiles of lanes of 33 RSUs (rows of 33 dark RSUs, room enough)
    rows33 = torch.zeros((2, 104), dtype=torch.uint8, device=dev)
    assert launch(16, 256, cnt.data_ptr(), n_rsu=33, op=rows33) == 1
    assert launch(1, 1024, None) == 0  # no stale error from the refusals
    assert launch(16, 256, cnt.data_ptr()) == 0
    torch.cuda.synchronize()
    assert _grid_counters_are_zero(dev, 2, view.n_rsu)


@pytest.mark.parametrize("name,fl_kw,aggregators,rounds", [
    ("probe", dict(samples_per_client=32, batch_size=16, num_clusters=4, client_block=3),
     ("fedavg", "fedavgm", "fedadam", "fedyogi", "stale", "fedbuff"), 1),
    ("streamed", dict(samples_per_client=64, batch_size=32, num_clusters=3, client_block=2,
                      select_fraction=0.25, connection_rate=0.7), ("fedavg", "fedbuff"), 3),
    ("unstreamed", dict(samples_per_client=64, batch_size=32, num_clusters=3,
                        connection_rate=0.7), ("fedavg",), 3),
])
def test_batched_two_tier_grid_on_the_card_matches_its_lane_loop(dev, name, fl_kw, aggregators,
                                                                 rounds):
    """Two-tier grids (N=20; contextual x the registry x rush_hour /
    rsu_outage, no warm-up) through the batched round, with exactly 2 B1g,
    one B5g a chunk and one server launch a round and no one-lane launch,
    and through the lane loop, both on the card: integers equal, floats
    within rtol 2e-4, atol 1e-5, NaN alike.  The probe is
    engine_throughput.py::smoke's hierarchical grid (K = 2 in one chunk of
    3); streamed is K = 5 in 3 chunks of 2."""
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl import ExperimentEngine

    fl = FLConfig(num_clients=20, local_epochs=1, hierarchical=True, **fl_kw)
    eng = ExperimentEngine(get_config("fl-mnist-mlp").replace(d_ff=32), fl, "mnist",
                           strategies=("contextual",), aggregators=aggregators, warmup=False,
                           device=dev)
    assert eng.batched
    runs = [("contextual", a, 0, sc) for a in aggregators for sc in ("rush_hour", "rsu_outage")]
    lanes = eng._lanes(runs)
    counters = lambda: (rttg_mod.launches, rsu_mod.launches, fedavg_mod.launches,  # noqa: E731
                        su_mod.launches, su_mod.buffered_launches, rttg_mod.grid_launches,
                        rsu_mod.grid_launches, fedavg_mod.grid_launches, su_mod.grid_launches,
                        su_mod.buffered_grid_launches)
    before = counters()
    batched = eng._sweep(lanes, rounds, rounds)
    chunks = -(-eng.cohort_size // fl.client_block) if fl.client_block else 0
    server = {("fedavg",): 7}.get(tuple(aggregators), 9 if "fedbuff" in aggregators else 8)
    want = [0] * 10
    want[5], want[6], want[server] = 2 * rounds, chunks * rounds, rounds
    assert [a - b for a, b in zip(counters(), before)] == want
    loop = eng._sweep(eng._lane_list(runs), rounds, rounds)
    for f in batched._fields:
        a, b = getattr(batched, f).cpu(), getattr(loop, f).cpu()
        if a.dtype == torch.int32:
            assert torch.equal(a, b), f
        else:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5, equal_nan=True, msg=f)


# ---- the CNN datasets' models (fl-cifar10-cnn, fl-svhn-cnn) on the card ------------


def _cnn(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    return build_model(get_config(arch))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["fl-cifar10-cnn", "fl-svhn-cnn"])
def test_cnn_forward_on_the_card_matches_the_cpu(dev, arch, dtype):
    """The full-width CNN, one model and 5 stacked ones, card vs CPU (cuDNN
    and the CPU's convolutions sum in other orders): fp32 within 1e-4 of the
    largest logit, bf16 within 2% of it; a second call on the card bitwise
    the first."""
    from repro_torch.models.cnn import cnn_logits
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.pytree import (flatten_to_vector, tree_cast, tree_map,
                                          unflatten_from_vector)

    resolve_device(dev)
    api = _cnn(arch)
    vecs = torch.stack([flatten_to_vector(api.init(prng.key(s), "cpu")) for s in range(5)])
    images = prng.normal(prng.key(9), (5, 16, 32, 32, 3))
    for params, x in ((unflatten_from_vector(vecs[0], api.spec), images[0]),
                      (unflatten_from_vector(vecs, api.spec), images)):
        cpu = cnn_logits(tree_cast(params, dtype), x)
        gpu_params = tree_cast(tree_map(lambda t: t.to(dev), params), dtype)
        got, again = (cnn_logits(gpu_params, x.to(dev)) for _ in range(2))
        assert torch.equal(got, again) and got.dtype == dtype
        scale = float(cpu.float().abs().max())
        tol = 1e-4 if dtype == torch.float32 else 0.02
        torch.testing.assert_close(got.cpu().float(), cpu.float(), rtol=0, atol=tol * scale)


@pytest.mark.parametrize("arch", ["fl-cifar10-cnn", "fl-svhn-cnn"])
def test_cnn_trainer_on_the_card_matches_the_cpu(dev, arch):
    """The cohort trainer (K = 4, 2 epochs of 2 steps) at full width, card vs
    CPU: updates within 1e-3 of the largest (gradients summed in other
    orders through 4 steps); repeated on the card bit for bit (cuDNN set
    deterministic by ``resolve_device``)."""
    from repro_torch.fl.client import make_local_trainer
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.pytree import tree_map

    resolve_device(dev)
    api = _cnn(arch)
    params = api.init(prng.key(1), "cpu")
    images = prng.normal(prng.key(2), (4, 32, 32, 32, 3))
    labels = prng.randint(prng.key(3), (4, 32), 0, 10)
    train = make_local_trainer(api.loss, 0.05, 2, 16)
    _, cpu = train(params, images, labels, prng.key(4))
    gpu_args = (tree_map(lambda t: t.to(dev), params), images.to(dev), labels.to(dev),
                prng.key(4))
    (_, got), (_, again) = train(*gpu_args), train(*gpu_args)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=1e-3 * float(cpu.abs().max()))


@pytest.mark.parametrize("dataset", ["cifar10", "svhn"])
def test_cnn_round_repeats_bitwise_on_the_card(dev, dataset):
    """One narrow-CNN round of ``FLSimulation`` from the same state twice on
    the card: every state leaf and metric bit for bit, with 2 B1 and 1 B2
    launches each; and against the CPU's plain path, the same integers."""
    from repro_torch.config import FLConfig
    from repro_torch.configs import PAPER_MODEL_BY_DATASET, get_config
    from repro_torch.fl.simulation import FLSimulation

    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1, num_clusters=3)
    traffic = scenario_config("ring", num_vehicles=20)
    cfg = get_config(PAPER_MODEL_BY_DATASET[dataset]).replace(channels=(4, 8), d_ff=16)
    sim = FLSimulation(cfg, fl, traffic, dataset, "contextual", prng.key(0), device=dev)
    sim.warmup_sketches()
    s0 = sim.state
    before = (rttg_mod.launches, fedavg_mod.launches)
    runs = [sim._step(s0, sim.scn, 0, 0, sim.data, True) for _ in range(2)]
    assert (rttg_mod.launches, fedavg_mod.launches) == (before[0] + 4, before[1] + 2)
    (sa, ma), (sb, mb) = runs
    for f in sa._fields:
        x, y = getattr(sa, f), getattr(sb, f)
        same = (all(torch.equal(p, q) for p, q in zip(x, y)) if f == "twin" else
                torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        assert same, f
    for f in ma._fields:
        assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    cpu = FLSimulation(cfg, fl, traffic, dataset, "contextual", prng.key(0), device="cpu")
    _, mc = cpu._step(s0.to("cpu"), cpu.scn, 0, 0, sim.data.to("cpu"), True)
    for f in ("round", "n_selected", "n_succeeded"):
        assert int(getattr(mc, f)) == int(getattr(ma, f)), f
    assert abs(float(mc.test_acc) - float(ma.test_acc)) <= 0.01


# ---- LM training: no kernel with a gradient ------------------------------------

TRAIN_LR = 3e-4


def _train_one_step(arch, m, B, device, params):
    """One AdamW step of ``launch.steps.make_train_step`` at ``m`` microbatches on
    the trainer's first batch (``launch.train.make_batch``, S = 32)."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.launch.train import make_batch
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch).replace(train_microbatches=m)
    step, opt = make_train_step(build_model(cfg), TrainConfig(learning_rate=TRAIN_LR))
    batch = make_batch(cfg, prng.fold_in(prng.key(0, device), 1), B, 32)
    return step(TrainState(params, opt.init(params)), batch)


@pytest.mark.parametrize("arch,m,B", [("qwen1.5-0.5b", 1, 4), ("mixtral-8x7b", 1, 4),
                                      ("mixtral-8x7b", 8, 8), ("internvl2-76b", 1, 2),
                                      ("whisper-small", 2, 4)])
def test_smoke_trainer_on_the_card_matches_the_cpu(dev, arch, m, B):
    """One train step of the dense, moe, vlm and encdec smoke LMs (fp32) on the
    card and on the CPU from the same weights: loss and metrics within rtol
    1e-5, every parameter within 2 lr (AdamW's first step is about
    ``lr * sign(g)``) and fewer than 0.1 % more than lr / 10 apart; the moments
    fp32; no kernel launched (this path runs none)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves

    params = build_model(get_smoke_config(arch)).init(prng.key(0), "cpu")
    before = (ssd.launches, swa.launches)
    sg, mg = _train_one_step(arch, m, B, dev, _tree_to(params, dev))
    sc, mc = _train_one_step(arch, m, B, "cpu", params)
    assert (ssd.launches, swa.launches) == before
    for k in mc:
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=1e-6, msg=k)
    for a, b in zip(tree_leaves(sg.params), tree_leaves(sc.params)):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2 * TRAIN_LR
        assert float((d > TRAIN_LR / 10).float().mean()) < 1e-3
    assert all(x.dtype == torch.float32 for x in tree_leaves(sg.opt_state.nu))


def test_ssd_scan_refuses_an_operand_that_requires_grad(dev):
    """B8 has no backward: under grad mode an operand that requires grad raises
    (naming the differentiable plain scan); with grad off, or no operand requiring
    grad, it launches."""
    from repro_torch.kernels import ssd_scan as ssd

    x, dt, A, Bs, Cs, _ = _ssd_operands(2, 40, 3, 16, 8, torch.float32, dev)
    before = ssd.launches
    for i, name in enumerate(("xh", "dt", "A", "Bs", "Cs")):
        ops = [x, dt, A, Bs, Cs]
        ops[i] = ops[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward.*ssd_scan_plain"):
            ssd.ssd_scan(*ops, 16)
        with torch.no_grad():
            ssd.ssd_scan(*ops, 16)
    h0 = torch.zeros((2, 3, 16, 8), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan_plain, as models.ssm does"):
        ssd.ssd_scan(x, dt, A, Bs, Cs, 16, h0)
    ssd.ssd_scan(x, dt, A, Bs, Cs, 16)
    assert ssd.launches == before + 6


def test_swa_decode_refuses_an_operand_that_requires_grad(dev):
    from repro_torch.kernels import swa_decode as swa

    q, k, v, kv_pos, pos = _swa_operands(2, 64, 2, 2, 32, torch.float32, dev, (40, 64))
    before = swa.launches
    for i in range(3):
        ops = [q, k, v]
        ops[i] = ops[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="swa_decode: the CUDA kernel has no backward"):
            swa.swa_decode(*ops, kv_pos, pos)
        with torch.no_grad():
            swa.swa_decode(*ops, kv_pos, pos)
    assert swa.launches == before + 3


@pytest.mark.parametrize("arch,m,B", [("hymba-1.5b", 1, 4), ("hymba-1.5b", 4, 4),
                                      ("mamba2-130m", 1, 4)])
def test_ssm_and_hybrid_trainers_on_the_card_match_the_cpu(dev, arch, m, B):
    """The ssm and hybrid smoke LMs train through the plain scan on the card
    (``models/ssm.py`` routes by grad mode): one step card vs CPU as the other
    families', no ``ssd_scan`` launch; a prefill under ``no_grad`` then still
    launches B8 once per SSM layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_smoke_config(arch)
    api = build_model(cfg)
    params = api.init(prng.key(0), "cpu")
    before = ssd.launches
    sg, mg = _train_one_step(arch, m, B, dev, _tree_to(params, dev))
    sc, mc = _train_one_step(arch, m, B, "cpu", params)
    assert ssd.launches == before
    for k in mc:
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=1e-6, msg=k)
    for a, b in zip(tree_leaves(sg.params), tree_leaves(sc.params)):
        assert bool(torch.isfinite(a).all())
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2 * TRAIN_LR
        assert float((d > TRAIN_LR / 10).float().mean()) < 1e-3
    with torch.no_grad():
        api.prefill(sg.params, {"tokens": torch.zeros((2, 24), dtype=torch.int64, device=dev)},
                    32)
    assert ssd.launches == before + cfg.num_layers


@pytest.mark.parametrize("alpha", [0.05, 0.5, 2.5])
def test_loggamma_and_partition_labels_on_the_card_match_the_cpu(dev, alpha):
    """Dirichlet shards drawn on the card: ``loggamma`` within rtol 1e-5 of the
    CPU's draw, ``partition_labels`` equal."""
    from repro_torch.config import FLConfig
    from repro_torch.fl.partition import partition_labels

    alphas = torch.full((10,), alpha)
    g = prng.loggamma(prng.key(3, dev), alphas.to(dev), (64, 10))
    c = prng.loggamma(prng.key(3), alphas, (64, 10))
    assert g.device.type == "cuda"
    torch.testing.assert_close(g.cpu(), c, rtol=1e-5, atol=1e-6)
    fl = FLConfig(num_clients=100, samples_per_client=256, dirichlet_alpha=alpha)
    for dataset in ("mnist", "cifar10"):
        lg = partition_labels(prng.key(0, dev), dataset, fl, device=dev)
        assert lg.device.type == "cuda"
        assert torch.equal(lg.cpu(), partition_labels(prng.key(0), dataset, fl))


# ---- the engine's sharded grid, and the kernels on any card ---------------------------

def _same_metrics(a, b) -> bool:
    return all(torch.equal(x, y) if not x.is_floating_point() else
               torch.equal(torch.isnan(x), torch.isnan(y))
               and torch.equal(x.nan_to_num(), y.nan_to_num()) for x, y in zip(a, b))


def test_two_shards_on_one_card_are_the_unsharded_grid_bitwise(dev):
    """The 6-lane pad grid (two seeds x ring / rush_hour / platoon, N=20, 2
    rounds) on ``GridMesh((cuda:0, cuda:0))``: every metric of every lane
    the unsharded grid's on cuda:0 bit for bit, the launches those of the
    shards' lane groups (one group a shard)."""
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl import ExperimentEngine
    from repro_torch.launch.mesh import GridMesh

    card = torch.device("cuda", 0)
    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1, num_clusters=3,
                  batch_size=32, recluster_every=2)
    model = get_config("fl-mnist-mlp").replace(d_ff=32)
    grid = dict(seeds=(0, 1), scenarios=("ring", "rush_hour", "platoon"), rounds=2,
                eval_every=2)
    base = ExperimentEngine(model, fl, "mnist", device=card)
    sharded = ExperimentEngine(model, fl, "mnist", mesh=GridMesh((card, card)))
    assert sharded.device == card and sharded.grid_shards() == 2
    want = base.run_grid(**grid)
    before = rttg_mod.grid_launches, fedavg_mod.grid_launches
    got = sharded.run_grid(**grid)
    assert (rttg_mod.grid_launches - before[0], fedavg_mod.grid_launches - before[1]) == (8, 4)
    assert got.runs == want.runs and _same_metrics(got.metrics, want.metrics)
    assert got.metrics.test_acc.device == card
    assert sharded.last_data_plan == {"total_rows": 4, "rows_per_shard": 2, "n_shards": 2}


@pytest.fixture
def two_cards(dev):
    """Cards 0 and 1, or a skip below two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _process_lane_vs_one_card(mesh, processes):
    """The 6-lane pad grid (as above) through the process lane on ``mesh``
    against the unsharded grid on cuda:0: every lane bit for bit, the
    workers' launches added to this process's counters exactly (2 B1g and
    1 B2g a round of each shard's one lane group), one worker a shard on its
    device, each with its sweep seconds and card peak."""
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl import ExperimentEngine

    card = torch.device("cuda", 0)
    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1, num_clusters=3,
                  batch_size=32, recluster_every=2)
    model = get_config("fl-mnist-mlp").replace(d_ff=32)
    grid = dict(seeds=(0, 1), scenarios=("ring", "rush_hour", "platoon"), rounds=2,
                eval_every=2)
    want = ExperimentEngine(model, fl, "mnist", device=card).run_grid(**grid)
    n = len(mesh)
    with ExperimentEngine(model, fl, "mnist", mesh=mesh, processes=processes) as eng:
        assert eng.processes and eng.device == card
        before = rttg_mod.grid_launches, fedavg_mod.grid_launches
        got = eng.run_grid(**grid)
        assert (rttg_mod.grid_launches - before[0],
                fedavg_mod.grid_launches - before[1]) == (4 * n, 2 * n)
        assert got.runs == want.runs and _same_metrics(got.metrics, want.metrics)
        assert got.metrics.test_acc.device == card
        stats = eng.last_shard_stats
        assert [s["device"] for s in stats] == [str(d) for d in mesh]
        assert all(s["peak_bytes"] > 0 and s["sweep_s"] > 0 for s in stats)
        assert len({s["pid"] for s in stats}) == n and eng.pool_start_s > 0
        pool = eng._pool
    assert eng._pool is None and not pool.alive


def test_the_process_lane_of_two_workers_on_one_card_is_the_one_card_grid_bitwise(dev):
    from repro_torch.launch.mesh import GridMesh

    card = torch.device("cuda", 0)
    _process_lane_vs_one_card(GridMesh((card, card)), True)


def test_the_process_lane_on_every_card_is_the_one_card_grid_bitwise(two_cards):
    """``make_grid_mesh()`` on two or more cards takes the process lane by
    default: a worker a card."""
    from repro_torch.launch.mesh import make_grid_mesh

    _process_lane_vs_one_card(make_grid_mesh(), None)


def _on_thread(fn, current):
    """``fn()`` on a new host thread whose current device is ``current``."""
    import threading

    out = {}

    def run():
        torch.cuda.set_device(current)
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller's thread
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.mark.parametrize("operands_on", [0, 1])
def test_wrappers_launch_on_their_operands_card_from_any_current_device(two_cards,
                                                                        operands_on):
    """Operands on one card, the calling thread's current device the other:
    B1, B1g, B2, B2g, B3, B5 and B6 each give their plain version's result
    on the operands' card (the launch went to that card)."""
    from repro_torch.kernels import pairwise_cosine as pc_mod

    card, other = two_cards[operands_on], two_cards[1 - operands_on]
    scn, pos, speed, accel, forced = _geometry("ring", 100, 0.7, card)
    t = torch.tensor(77.5, device=card)
    scns, view, gpos, gspeed, gaccel, gt, gforced = _grid_lanes(CATALOG, 100, 0.7, card)
    u = torch.randn((10, 4099), device=card)
    w = torch.rand((10,), device=card)
    gu, gw = torch.randn((3, 2, 4099), device=card), torch.rand((3, 2), device=card)
    params, m = (torch.randn((4099,), device=card) for _ in range(2))
    v = torch.rand((4099,), device=card)  # fedadam's second moment: not negative
    rid = torch.randint(0, 10, (10,), dtype=torch.int32, device=card)

    def calls():
        return (rttg_mod.rttg_latency(pos, speed, accel, t, 636_040.0, forced, scn,
                                      predict=True, want_rid=True),
                rttg_mod.rttg_latency_grid(gpos, gspeed, gaccel, gt, 636_040.0, gforced, view,
                                           predict=True),
                fedavg_mod.fedavg_reduce(u, w), fedavg_mod.fedavg_reduce_grid(gu, gw),
                su_mod.server_update(u, w, params, m, v, 2, 1),
                rsu_mod.rsu_reduce(u, w, rid, 10), pc_mod.pairwise_cosine(u))

    got = _on_thread(calls, other)
    torch.cuda.synchronize(card)
    b1, b1g, b2, b2g, b3, b5, b6 = got
    assert all(x.device == card for x in (b1[0], b1g[0], b2, b2g, b3[0], b5[0], b6))
    ref = rttg_mod.rttg_latency_plain(pos, speed, accel, t, 636_040.0, forced, scn, True,
                                      want_rid=True)
    assert torch.equal(b1[1], ref[1]) and torch.equal(b1[2], ref[2])
    torch.testing.assert_close(b1[0], ref[0], rtol=1e-5, atol=1e-7)
    ref = rttg_mod.rttg_latency_grid_plain(gpos, gspeed, gaccel, gt, 636_040.0, gforced, view,
                                           True, False)
    assert torch.equal(b1g[1], ref[1])
    torch.testing.assert_close(b1g[0], ref[0], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(b2, fedavg_mod.fedavg_reduce_plain(u, w), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b2g, fedavg_mod.fedavg_reduce_grid_plain(gu, gw), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(b3, su_mod.server_update_plain(u, w, params, m, v, 2, 1)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(b5, rsu_mod.rsu_reduce_plain(u, w, rid, 10)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b6, pc_mod.pairwise_cosine_plain(u), rtol=0, atol=1e-5)


def test_kernels_above_48kb_of_shared_memory_on_card_1_after_card_0(two_cards):
    """B1g at R = 32,768 (160 KB a block) and B8 at mamba2-130m's head (its
    largest shared tile) on card 0, then on card 1: the grant is the card's
    own, so the second card's launches run and match their plain versions."""
    from repro_torch.kernels import ssd_scan as ssd

    assert ssd.smem_bytes(128, 64, 128, 4) > 48 * 1024
    for card in two_cards:
        scns, view, pos, speed, accel, t, forced = _wide_grid_lanes(
            ("ring",) * 2, 257, card, rsu_spacing_m=10_000.0 / 32768)
        assert view.n_rsu == 32768
        got = rttg_mod.rttg_latency_grid(pos, speed, accel, t, 636_040.0, forced, view,
                                         predict=True)
        for g, scn in enumerate(scns):
            ref = rttg_mod.rttg_latency_plain(pos[g], speed[g], accel[g], t[g], 636_040.0,
                                              forced[g], scn, True)
            assert torch.equal(got[1][g], ref[1])
            torch.testing.assert_close(got[0][g], ref[0], rtol=1e-5, atol=1e-7)
        x, dt, A, Bs, Cs, h0 = _ssd_operands(1, 300, 24, 64, 128, torch.float32, card,
                                             with_h0=True)
        _assert_ssd_close(ssd.ssd_scan(x, dt, A, Bs, Cs, 128, h0),
                          ssd.ssd_scan_plain(x, dt, A, Bs, Cs, 128, h0))


def _sharded_vs_one_card(mesh, arch="internvl2-76b", **overrides):
    """``arch``'s smoke config (fp32; ``overrides`` replaced) served sharded on
    ``mesh`` against one card's run: greedy tokens equal on every rank and to
    one card's, the last logits within ``chip_smoke.py``'s fp32 path
    tolerance, ``swa_decode`` launched once an attention layer, decode step and
    rank (twice a decoder layer for an encoder-decoder: self and cross),
    ``ssd_scan`` once an SSM layer and rank."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import serve
    from repro_torch.models.transformer import _has_attn, _has_ssm

    cfg = get_smoke_config(arch).replace(**overrides)
    want = serve.serve(cfg=cfg, batch=2, prompt_len=40, gen=8, device="cuda:0")
    before = swa.launches, ssd.launches
    got = serve.serve(cfg=cfg, batch=2, prompt_len=40, gen=8, mesh=mesh)
    n = len(mesh.devices)
    attn = 2 * cfg.num_layers if cfg.family == "encdec" else \
        cfg.num_layers if _has_attn(cfg) else 0
    assert swa.launches - before[0] == n * attn * 7
    assert ssd.launches - before[1] == (n * cfg.num_layers if _has_ssm(cfg) else 0)
    assert torch.equal(got.tokens, want.tokens.cpu())
    torch.testing.assert_close(got.logits, want.logits.float().cpu(), rtol=5e-4, atol=5e-4)
    assert len(got.ranks) == n and all(r["peak_bytes"] > 0 for r in got.ranks)
    return got


def test_sharded_serve_of_two_ranks_on_one_card_is_one_cards(dev):
    """Two ranks sharing cuda:0 (``gloo``, the collectives through the host)."""
    from repro_torch.utils.device import LMMesh

    mesh = LMMesh([["cuda:0", "cuda:0"]])
    assert mesh.backend == "gloo"
    _sharded_vs_one_card(mesh)


@pytest.mark.parametrize("arch,overrides", [
    ("mamba2-130m", {}),  # 16 heads, 4 a rank
    ("hymba-1.5b", {}),  # 12 heads, 3 a rank; its attention replicated
    ("hymba-1.5b", {"d_model": 160}),  # 10 heads replicated: 5 virtual heads of 16 a rank
])
def test_sharded_ssm_serve_of_four_ranks_on_one_card_is_one_cards(dev, arch, overrides):
    """The ssm and hybrid families on four ranks sharing cuda:0 (``gloo``): B8 on
    each rank's heads, whole or virtual."""
    from repro_torch.utils.device import LMMesh

    _sharded_vs_one_card(LMMesh([["cuda:0"] * 4]), arch, **overrides)


@pytest.mark.parametrize("overrides", [
    {},  # 4 heads, 1 a rank
    {"num_heads": 6, "num_kv_heads": 6, "d_model": 192},  # 6 heads replicated, MLP cut
])
def test_sharded_encdec_serve_of_four_ranks_on_one_card_is_one_cards(dev, overrides):
    """whisper-small on four ranks sharing cuda:0 (``gloo``): B7 on each rank's
    self- and cross-attention heads."""
    from repro_torch.utils.device import LMMesh

    _sharded_vs_one_card(LMMesh([["cuda:0"] * 4]), "whisper-small", **overrides)


def test_sharded_serve_over_two_cards_is_one_cards(two_cards):
    """A rank a card over ``nccl`` (``make_lm_mesh(2)``)."""
    from repro_torch.launch.mesh import make_lm_mesh

    mesh = make_lm_mesh(2)
    assert mesh.backend == "nccl" and mesh.devices == two_cards
    _sharded_vs_one_card(mesh)
