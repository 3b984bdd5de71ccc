"""The batched round's two kernels, B1g and B2g: plain versions against the
JAX package under ``vmap``, the wrappers' routing, and the port's package
surface.

The reference runs its grid as one ``jax.vmap`` of the round, so its
kernels then see a leading grid axis; ``rttg_latency_grid_plain`` and
``fedavg_reduce_grid_plain`` are held against ``repro.kernels.ref``'s
``rttg_latency`` and ``fedavg_reduce`` under ``jax.vmap``, over a
reference ``stack_scenarios`` stack of the 8 catalog scenarios (one lane
each), at CR 1.0 and 0.7, predicted and realized.  Tolerances as the
one-lane kernels' tests state them (``tests/test_torch_kernels.py``):
connectivity exactly, latency within rtol 1e-5 / atol 1e-7, the FedAvg sum
within rtol 1e-5 and 1e-5 of ``sum_k |w_k u_k|``.  On the CPU the wrappers
run the plain versions and count no launch; the CUDA kernels run in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

The package surface: every name of ``repro.core.__all__`` and
``repro.fl.__all__`` resolves in the port, but the documented exception
(``init_state_traced``, whose counterpart is ``init_state_for_key``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
import repro.fl
from repro.core.scenarios import scenario_config as jscenario_config
from repro.core.scenarios import scenario_params as jscenario_params
from repro.core.scenarios import stack_scenarios as jstack_scenarios
from repro.kernels import ref as jref
from repro_torch.core.rttg import rsu_up_mask
from repro_torch.core.scenarios import lane_view, scenario_config, scenario_params, stack_scenarios
from repro_torch.kernels import fedavg_reduce as fedavg_mod
from repro_torch.kernels import rttg_latency as rttg_mod
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_kernels import LAT_ATOL, LAT_RTOL

CATALOG = ("ring", "highway", "urban_grid", "rush_hour", "rsu_outage", "platoon",
           "hetero_fleet", "day_cycle")


def _grid(n, cr, seed=0):
    """The reference's stacked scenario and (G, N) kinematics; the port's
    lane view and the same arrays through numpy."""
    G = len(CATALOG)
    jscn = jstack_scenarios([jscenario_params(jscenario_config(s, num_vehicles=n))
                             for s in CATALOG])
    ks = jax.random.split(jax.random.key(seed), 4)
    ring = jscn.ring_length_m[:, None]
    pos = jax.random.uniform(ks[0], (G, n), jnp.float32) * ring
    speed = 14.0 + jax.random.normal(ks[1], (G, n))
    accel = 0.3 * jax.random.normal(ks[2], (G, n))
    forced = jax.random.bernoulli(ks[3], cr, (G, n)) if cr < 1.0 else None
    t = 77.5 + 3.25 * jnp.arange(G, dtype=jnp.float32)
    view = lane_view(stack_scenarios([scenario_params(scenario_config(s, num_vehicles=n))
                                      for s in CATALOG]))
    port = [None if x is None else torch.from_numpy(np.array(x))
            for x in (pos, speed, accel, t, forced)]
    return jscn, (pos, speed, accel, t, forced), view, port


@pytest.mark.parametrize("n,cr", [(1, 1.0), (20, 1.0), (20, 0.7), (100, 0.7)])
@pytest.mark.parametrize("predict", [True, False])
def test_rttg_latency_grid_plain_matches_the_vmapped_reference(n, cr, predict):
    jscn, (pos, speed, accel, t, forced), view, port = _grid(n, cr)
    mb = jnp.float32(636_040.0)
    lane = lambda p, s, a, tt, f, scn: jref.rttg_latency(p, s, a, tt, mb, f, scn, predict)  # noqa: E731
    ref = jax.jit(jax.vmap(lane, in_axes=(0, 0, 0, 0, None if forced is None else 0, 0)))(
        pos, speed, accel, t, forced, jscn)
    before = rttg_mod.grid_launches
    lat, conn = rttg_mod.rttg_latency_grid(*port[:4], 636_040.0, port[4], view, predict=predict)
    assert rttg_mod.grid_launches == before  # CPU tensors never reach the kernel
    assert lat.shape == conn.shape == (len(CATALOG), n)
    assert lat.dtype == torch.float32 and conn.dtype == torch.bool
    np.testing.assert_array_equal(conn.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref[0]), rtol=LAT_RTOL, atol=LAT_ATOL)
    if cr < 1.0 and n > 1:
        assert 0 < int(conn.sum()) < conn.numel()


def test_rttg_latency_grid_plain_is_the_one_lane_plain_version_bitwise():
    _, _, view, (pos, speed, accel, t, forced) = _grid(20, 0.7, seed=3)
    for predict in (True, False):
        lat, conn = rttg_mod.rttg_latency_grid_plain(pos, speed, accel, t, 636_040.0, forced,
                                                     view, predict)
        for g, name in enumerate(CATALOG):
            scn = scenario_params(scenario_config(name, num_vehicles=20))
            one = rttg_mod.rttg_latency(pos[g], speed[g], accel[g], t[g], 636_040.0, forced[g],
                                        scn, predict=predict)
            assert torch.equal(lat[g], one[0]) and torch.equal(conn[g], one[1]), name


@pytest.mark.parametrize("G,K,P", [(1, 1, 1), (8, 2, 2049), (3, 12, 159_010), (24, 2, 4097)])
def test_fedavg_reduce_grid_plain_matches_the_vmapped_reference(G, K, P):
    rng = np.random.default_rng(G * 31 + K * 7 + P)
    u = (1e-3 * rng.normal(size=(G, K, P))).astype(np.float32)
    w = rng.random((G, K)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    ref = np.asarray(jax.vmap(jref.fedavg_reduce)(jnp.asarray(u), jnp.asarray(w)))
    before = fedavg_mod.grid_launches
    got = fedavg_mod.fedavg_reduce_grid(torch.from_numpy(u), torch.from_numpy(w))
    assert fedavg_mod.grid_launches == before
    assert got.shape == (G, P) and got.dtype == torch.float32
    scale = float(np.max(np.abs(w)[:, None, :] @ np.abs(u)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * scale)
    for g in range(G):  # lane g is the one-lane plain version's sum, bit for bit
        assert torch.equal(got[g], fedavg_mod.fedavg_reduce(torch.from_numpy(u[g]),
                                                            torch.from_numpy(w[g])))
    bf = torch.from_numpy(u).to(torch.bfloat16)
    got16 = fedavg_mod.fedavg_reduce_grid(bf, torch.from_numpy(w))
    ref16 = np.asarray(jax.vmap(jref.fedavg_reduce)(jnp.asarray(u).astype(jnp.bfloat16),
                                                    jnp.asarray(w)))
    np.testing.assert_allclose(got16.numpy(), ref16, rtol=1e-5, atol=1e-5 * scale)


def test_grid_operand_holds_each_lane_row_once_per_view():
    view = lane_view(stack_scenarios([scenario_params(scenario_config(s, num_vehicles=8))
                                      for s in CATALOG]))
    op = rttg_mod.grid_operand(view, "cpu")
    S, R = len(rttg_mod.SCENARIO_SCALARS), view.n_rsu
    assert op.dtype == torch.uint8 and op.shape == (len(CATALOG), 4 * S + R + (-R) % 4)
    assert op.shape[1] % 4 == 0
    want = torch.cat([getattr(view, f) for f in rttg_mod.SCENARIO_SCALARS], dim=1)
    assert torch.equal(op[:, :4 * S].contiguous().view(torch.float32), want)
    assert torch.equal(op[:, 4 * S:4 * S + R], rsu_up_mask(view).to(torch.uint8))
    assert int(op[:, 4 * S + R:].sum()) == 0
    dark = int((op[CATALOG.index("rsu_outage"), 4 * S:4 * S + R] == 0).sum())
    assert dark == 4 and int(op[0, 4 * S:4 * S + R].sum()) == R
    assert rttg_mod.grid_operand(view, "cpu") is op


def test_grid_wrappers_reject_devices_they_do_not_serve():
    view = lane_view(stack_scenarios([scenario_params(scenario_config("ring", num_vehicles=4))]))
    x = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError):
        rttg_mod.rttg_latency_grid(x, x, x, torch.zeros(1, device="meta"), 1.0, None, view,
                                   predict=False)
    with pytest.raises(ValueError):
        fedavg_mod.fedavg_reduce_grid(torch.zeros((1, 2, 4), device="meta"), x[:, :2])


# ---- the package surface -------------------------------------------------------------

def test_every_reference_core_name_resolves_in_the_port():
    import repro_torch.core as core

    assert sorted(core.__all__) == sorted(repro.core.__all__)
    for name in repro.core.__all__:
        assert getattr(core, name) is not None, name


def test_every_reference_fl_name_resolves_in_the_port():
    import repro_torch.fl as fl

    exceptions = {"init_state_traced": "init_state_for_key"}
    for name in repro.fl.__all__:
        assert getattr(fl, exceptions.get(name, name)) is not None, name
        assert (name in fl.__all__) == (name not in exceptions), name
    with pytest.raises(AttributeError):
        fl.init_state_traced  # noqa: B018


def test_init_experiment_is_init_state_and_its_data():
    from repro_torch.config import FLConfig, ModelConfig
    from repro_torch.fl import init_experiment, rounds
    from repro_torch.models import build_model
    from repro_torch.utils import prng
    from test_torch_engine import FL, MLP

    api, fl = build_model(ModelConfig(**MLP)), FLConfig(**FL)
    scn = scenario_params(scenario_config("platoon", num_vehicles=fl.num_clients))
    state, data = init_experiment(api, fl, scn, "mnist", "gossip", prng.key(4), "cpu")
    want, regions = rounds.init_state(api, fl, scn, "mnist", "gossip", prng.key(4), "cpu")
    assert torch.equal(state.params, want.params) and torch.equal(state.key, want.key)
    ref = rounds.make_round_data(want.key, "mnist", fl, regions, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(data, ref))
