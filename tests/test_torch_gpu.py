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
``(1 - beta1) / tau``), and its two contracts bit for bit.  Without a card
every test skips, decided in the fixture.
"""
import pytest
import torch

from repro_torch.core.scenarios import scenario_config, scenario_params
from repro_torch.kernels import fedavg_reduce as fedavg_mod
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
