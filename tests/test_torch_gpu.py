"""The port's CUDA kernels and main path on the card (marked ``gpu``).

Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX (the card's machine has none): each kernel is held
against its plain PyTorch version on the card.  Connectivity and RSU ids
exactly; latency within rtol 1e-5 (the kernel's ``log10f`` / ``powf`` /
``log2f`` / ``sinf`` and PyTorch's elementwise kernels may round an ulp
apart); the FedAvg sum within 1e-6 of ``sum_k |w_k u_k|`` (another
summation order); the server update's ``m`` and ``v`` within the same,
its ``params`` within 100 times that (the adaptive step
``m / (sqrt(v) + tau)`` magnifies the sum's error by up to
``(1 - beta1) / tau``), and its two contracts bit for bit.  The RSU segment
reduce within 1e-6 of ``sum_k |m_kr u_k|`` on random operands and bit for
bit on dyadic ones (any order sums those exactly), a chunk walk included.
The two-tier rounds: the hierarchical lane is the flat lane bit for bit
(contract (a)), and the streamed lane launches one ``rsu_reduce`` per
chunk.  At fleet size the windowed neighbour search is the dense one
exactly and the compact fusion the dense fusion within rtol 1e-5.  The
pairwise-cosine Gram within atol 1e-5 of its plain version (TF32 off) and
bitwise symmetric; a selector round on the card against the CPU (RSU ids,
connectivity, masks and cluster labels equal), and the unfused round
against the fused one (integers equal, floats within rtol 1e-5).  Without
a card every test skips, decided in the fixture.
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


@pytest.fixture
def dev():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _geometry(name, n, cr, dev):
    scn = scenario_params(scenario_config(name, num_vehicles=n), dev)
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


@pytest.mark.parametrize("K,P", [(1, 1), (1, 159_010), (10, 2049), (10, 4096), (10, 159_010)])
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
    with pytest.raises(NotImplementedError):
        fedavg_mod.fedavg_reduce(u.to(torch.bfloat16), torch.ones(4, device=dev))
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
    scale = float((w.abs() @ u.abs()).max())
    for a, b, atol in zip(got, ref, (1e-4 * scale, 1e-6 * scale, 1e-6 * scale)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)


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
    with pytest.raises(NotImplementedError):
        su_mod.server_update(u.to(torch.bfloat16), w, params, m, v, 2, 0)
    with pytest.raises(ValueError):
        su_mod.server_update(torch.zeros((8, 4), device=dev).t(), w, params, m, v, 2, 0)
    with pytest.raises(ValueError):
        su_mod.server_update(u, w, params[:4], m, v, 2, 0)  # the wrong length
    ring = torch.zeros((2, 8), device=dev)
    with pytest.raises(NotImplementedError):
        su_mod.server_update_buffered(u, w, ring.to(torch.bfloat16), w[:2], params, m, v,
                                      5, 0, torch.tensor(True, device=dev))
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


def _rsu_operands(K, P, R, dev, seed, exact):
    """(updates, weights, rid, carry); ``exact``: dyadic updates and carry,
    integer weights, whose sums are exact in any order."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if exact:
        u = torch.randint(-64, 65, (K, P), generator=g, device=dev).float() * 2.0 ** -12
        w = torch.randint(0, 5, (K,), generator=g, device=dev).float()
        carry = torch.randint(-64, 65, (R, P), generator=g, device=dev).float() * 2.0 ** -10
    else:
        u = 1e-3 * torch.randn((K, P), generator=g, device=dev)
        w = torch.rand((K,), generator=g, device=dev)
        carry = 1e-3 * torch.randn((R, P), generator=g, device=dev)
    rid = torch.randint(0, R, (K,), generator=g, device=dev).to(torch.int32)
    return u, w, rid, carry


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("mode", ["rand", "exact", "same", "hole", "masked", "out_of_range"])
@pytest.mark.parametrize("K,P,R", [(4, 159_010, 10), (32, 159_010, 10), (1, 1, 1),
                                   (1, 515, 10), (7, 515, 10), (5, 2049, 1)])
def test_rsu_reduce_kernel_matches_plain(dev, K, P, R, mode, carry):
    u, w, rid, c = _rsu_operands(K, P, R, dev, K * 31 + P + R, exact=mode != "rand")
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
    with pytest.raises(NotImplementedError):
        rsu_mod.rsu_reduce(u.to(torch.bfloat16), w, rid, 3)
    with pytest.raises(ValueError):
        rsu_mod.rsu_reduce(u, w, rid, rsu_mod.MAX_RSU + 1)
    with pytest.raises(ValueError):
        rsu_mod.rsu_reduce(u, w, rid.long(), 3)
    with pytest.raises(ValueError):
        rsu_mod.rsu_reduce(torch.zeros((8, 4), device=dev).t(), w, rid, 3)
    with pytest.raises(ValueError):
        rsu_mod.rsu_reduce(u, w, rid, 3, carry=c[:2])


def _two_tier_sims(dev, aggregator, cr, **kw):
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.fl.simulation import FLSimulation

    fl = FLConfig(num_clients=20, samples_per_client=64, local_epochs=1, num_clusters=3,
                  select_fraction=0.35, connection_rate=cr, aggregator=aggregator, **kw)
    traffic = scenario_config("ring", num_vehicles=20)
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
    (2, 1000, 2, 3, 64, 0, 0.0, (1000, 640)),  # C not a multiple of the 256-slot tile
    (3, 1, 2, 4, 32, 0, 0.0, (1, 5, 9)),  # one slot
    (2, 300, 4, 1, 128, 64, 0.0, (300, 77)),  # G = 1, a window inside the ring
    (2, 512, 2, 2, 256, 0, 50.0, (400, 5000)),  # a partly filled ring; softcap 50; D 256
    (1, 64, 1, 16, 32, 17, 30.0, (3000,)),  # a wrapped ring, pos far beyond C; G 16
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
    (2, 1, 3, 16, 8, 128, False),  # one step
    (2, 200, 4, 32, 16, 128, True),  # S not a multiple of Q, a given h0
    (3, 100, 2, 8, 32, 128, False),  # Q > S: one chunk of S
    (1, 300, 24, 64, 128, 128, True),  # mamba2-130m's head: the largest shared tile
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


@pytest.mark.parametrize("n,m,d", [(128, 256, 512), (33, 100, 2000), (1, 5, 1), (100, 7, 1024)])
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
