"""The port's two kernels: plain versions against the JAX package, wrappers' routing.

On the CPU each wrapper runs its kernel's plain version.  That plain version
is held against the JAX oracle (``repro.kernels.ref``) and against the
Pallas kernel in interpret mode, run as ``tests/test_round_fused.py`` runs
it.  Connectivity and RSU ids must match exactly; latency within rtol 1e-5
(torch and XLA round ``log10`` / ``pow`` / ``log2`` / ``sin`` a few ulps
apart, and XLA contracts multiply-adds into FMAs).  The FedAvg sum within
rtol 1e-5 of ``sum_k |w_k u_k|`` (the two sum K products in different
orders).  Two facts the geometry kernel rests on are checked here too: its
predictor's wrap without ``fmodf`` is ``torch.remainder`` bit for bit on
``[0, 2 ring)``, and its scenario operand holds the scenario's scalars and
live flags, built once per scenario.  The CUDA kernels themselves run in
``tests/test_torch_gpu.py``
(marked ``gpu``, skipped where there is no card) and in ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scenarios import scenario_config as jscenario_config
from repro.core.scenarios import scenario_params as jscenario_params
from repro.kernels import fedavg_reduce as jfedavg_reduce
from repro.kernels import ref as jref
from repro.kernels import rttg_latency as jrttg_latency
from repro_torch.core.rttg import rsu_up_mask
from repro_torch.core.scenarios import SCENARIOS, scenario_config, scenario_params
from repro_torch.kernels import fedavg_reduce as fedavg_mod
from repro_torch.kernels import rttg_latency as rttg_mod
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

LAT_RTOL, LAT_ATOL = 1e-5, 1e-7


def _geometry(name, n, cr, seed=0):
    """JAX-side inputs; the port gets the same arrays through numpy."""
    scn = jscenario_params(jscenario_config(name, num_vehicles=n))
    ks = jax.random.split(jax.random.key(seed), 4)
    pos = jax.random.uniform(ks[0], (n,), jnp.float32, 0.0, float(scn.ring_length_m))
    speed = 14.0 + jax.random.normal(ks[1], (n,))
    accel = 0.3 * jax.random.normal(ks[2], (n,))
    forced = jax.random.bernoulli(ks[3], cr, (n,)) if cr < 1.0 else None
    return scn, pos, speed, accel, forced


def _port(name, n, pos, speed, accel, forced):
    t = lambda x: torch.from_numpy(np.array(x))
    scn = scenario_params(scenario_config(name, num_vehicles=n))
    return scn, t(pos), t(speed), t(accel), None if forced is None else t(forced)


@pytest.mark.parametrize("name", ["ring", "rush_hour", "rsu_outage", "day_cycle"])
@pytest.mark.parametrize("n,cr", [(1, 1.0), (20, 1.0), (20, 0.6), (257, 0.6)])
@pytest.mark.parametrize("predict", [True, False])
def test_rttg_latency_plain_matches_ref_and_interpret_kernel(name, n, cr, predict):
    jscn, pos, speed, accel, forced = _geometry(name, n, cr)
    t, mb = jnp.float32(77.5), jnp.float32(636_040.0)
    ref = jax.jit(lambda *a: jref.rttg_latency(*a, predict, want_rid=True))(
        pos, speed, accel, t, mb, forced, jscn)
    kern = jrttg_latency(pos, speed, accel, t, mb, forced, jscn, predict=predict,
                         want_rid=True, interpret=True)
    scn, *xs = _port(name, n, pos, speed, accel, forced)
    before = rttg_mod.launches
    lat, conn, rid = rttg_mod.rttg_latency(xs[0], xs[1], xs[2], torch.tensor(77.5),
                                           636_040.0, xs[3], scn, predict=predict,
                                           want_rid=True)
    assert rttg_mod.launches == before  # CPU tensors never reach the kernel
    assert lat.dtype == torch.float32 and conn.dtype == torch.bool and rid.dtype == torch.int32
    for other in (ref, kern):
        np.testing.assert_array_equal(conn.numpy(), np.asarray(other[1]))
        np.testing.assert_array_equal(rid.numpy(), np.asarray(other[2]))
        np.testing.assert_allclose(lat.numpy(), np.asarray(other[0]),
                                   rtol=LAT_RTOL, atol=LAT_ATOL)


def test_rttg_latency_two_output_form_equals_rid_form():
    jscn, pos, speed, accel, forced = _geometry("ring", 20, 0.6)
    scn, p, s, a, f = _port("ring", 20, pos, speed, accel, forced)
    lat2, conn2 = rttg_mod.rttg_latency(p, s, a, 3.0, 1e5, f, scn, predict=True)
    lat3, conn3, _ = rttg_mod.rttg_latency(p, s, a, 3.0, 1e5, f, scn, predict=True,
                                           want_rid=True)
    assert torch.equal(lat2, lat3) and torch.equal(conn2, conn3)


@pytest.mark.parametrize("K", [1, 10])
@pytest.mark.parametrize("P", [1, 2049, 159_010])
def test_fedavg_reduce_plain_matches_ref_and_interpret_kernel(K, P):
    rng = np.random.default_rng(K * 7 + P)
    u = (1e-3 * rng.normal(size=(K, P))).astype(np.float32)
    w = rng.random(K).astype(np.float32)
    w /= w.sum()
    ref = np.asarray(jref.fedavg_reduce(jnp.asarray(u), jnp.asarray(w)))
    kern = np.asarray(jfedavg_reduce(jnp.asarray(u), jnp.asarray(w), interpret=True))
    before = fedavg_mod.launches
    got = fedavg_mod.fedavg_reduce(torch.from_numpy(u), torch.from_numpy(w))
    assert fedavg_mod.launches == before  # CPU tensors never reach the kernel
    assert got.shape == (P,) and got.dtype == torch.float32
    scale = float((np.abs(w) @ np.abs(u)).max())
    for other in (ref, kern):
        np.testing.assert_allclose(got.numpy(), other, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ring_wrap_fast_path_is_remainder_bitwise(name):
    """The kernel's predictor wraps ``x`` in ``[0, 2 ring)`` by one compare
    and one subtraction (exact by Sterbenz's lemma): bit for bit
    ``torch.remainder``, at every catalog ring length and its edges."""
    ring = torch.tensor(scenario_config(name).ring_length_m, dtype=torch.float32)
    two = 2.0 * ring
    below = lambda x: torch.nextafter(x, torch.zeros(()))  # noqa: E731
    edges = torch.stack([torch.tensor(0.0), torch.tensor(-0.0), below(ring), ring,
                         torch.nextafter(ring, two), below(two)])
    rng = np.random.default_rng(len(name))
    drawn = torch.from_numpy(rng.uniform(0.0, float(two), 100_000).astype(np.float32))
    x = torch.cat([edges, drawn[drawn < two]])
    assert bool((x >= 0).all() and (x < two).all())
    fast = torch.where(x >= ring, x - ring, x)
    assert torch.equal(fast.view(torch.int32), torch.remainder(x, ring).view(torch.int32))


def test_rttg_scenario_operand_is_built_once_per_scenario():
    scn = scenario_params(scenario_config("rsu_outage", num_vehicles=8))
    op = rttg_mod.scenario_operand(scn, "cpu")
    S = len(rttg_mod.SCENARIO_SCALARS)
    assert op.dtype == torch.uint8 and op.shape == (4 * S + scn.n_rsu,)
    want = torch.stack([getattr(scn, f) for f in rttg_mod.SCENARIO_SCALARS])
    assert torch.equal(op[:4 * S].view(torch.float32), want)
    assert torch.equal(op[4 * S:], rsu_up_mask(scn).to(torch.uint8))
    assert 0 < int(op[4 * S:].sum()) < scn.n_rsu  # the outage darkens some RSUs
    assert rttg_mod.scenario_operand(scn, "cpu") is op  # a second call reuses it
    other = scenario_params(scenario_config("rsu_outage", num_vehicles=8))
    assert rttg_mod.scenario_operand(other, "cpu") is not op
    n_cached = len(rttg_mod._OPERANDS)
    del other
    assert len(rttg_mod._OPERANDS) == n_cached - 1  # dropped with its scenario


def test_wrappers_reject_devices_they_do_not_serve():
    scn = scenario_params(scenario_config("ring", num_vehicles=4))
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        rttg_mod.rttg_latency(x, x, x, 0.0, 1.0, None, scn, predict=False)
    with pytest.raises(ValueError):
        fedavg_mod.fedavg_reduce(torch.zeros((2, 4), device="meta"), x[:2])
