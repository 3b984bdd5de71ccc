"""The port's selection pipeline against the JAX package's ``core`` modules.

Same inputs (made from a seed with numpy, or drawn from the same key) go
through both.  Integer and boolean outputs (lanes, perceived object ids,
validity, cluster labels, selection masks) must match exactly.  Floats
match within ``RTOL``/``ATOL``: XLA contracts multiply-adds into FMAs and
rounds transcendentals differently from torch, a few ulps per op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.config import TrafficConfig as JTrafficConfig
from repro.core import clustering as jcl
from repro.core import fusion as jfu
from repro.core import messages as jmsg
from repro.core import scenarios as jsc
from repro.core import selection as jsel
from repro.core import twin as jtw
from repro_torch.config import FLConfig, TrafficConfig
from repro_torch.core import clustering, fusion, messages, scenarios, selection, twin
from repro_torch.utils import prng
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-5, 1e-5


def tkey(jk):
    return prng.wrap_key_data(np.asarray(jax.random.key_data(jk)))


def scn_pair(name, n):
    return (jsc.scenario_params(jsc.scenario_config(name, num_vehicles=n)),
            scenarios.scenario_params(scenarios.scenario_config(name, num_vehicles=n)))


def twin_to_torch(state):
    return twin.TwinState(*[torch.from_numpy(np.array(x)) for x in state])


def test_config_copies_match_the_reference():
    """The port's own FLConfig / TrafficConfig keep the reference's fields and defaults."""
    for mine, ref in ((FLConfig, JFLConfig), (TrafficConfig, JTrafficConfig)):
        assert dataclasses.asdict(mine()) == dataclasses.asdict(ref())
    assert FLConfig().n_select == JFLConfig().n_select
    assert sorted(scenarios.SCENARIOS) == sorted(jsc.SCENARIOS)
    for name in jsc.SCENARIOS:
        assert (dataclasses.asdict(scenarios.scenario_config(name, 37))
                == dataclasses.asdict(jsc.scenario_config(name, 37)))


def _field_defaults(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING else "<required>")
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("arch", ["fl-mnist-mlp", "fl-cifar10-cnn", "fl-svhn-cnn",
                                  "hymba-1.5b", "mamba2-130m", "qwen1.5-0.5b", "gemma2-9b",
                                  "mistral-nemo-12b", "chatglm3-6b", "mixtral-8x7b",
                                  "phi3.5-moe-42b-a6.6b", "internvl2-76b", "whisper-small"])
def test_model_config_copy_matches_the_reference(arch):
    """The port's ModelConfig keeps the reference's fields, required fields and
    defaults, and its configs (full and smoke) equal the reference's field for
    field, derived properties included."""
    from repro.config import ModelConfig as JModelConfig
    from repro.configs import get_config as jget, get_smoke_config as jget_smoke
    from repro_torch.config import ModelConfig
    from repro_torch.configs import get_config, get_smoke_config

    assert _field_defaults(ModelConfig) == _field_defaults(JModelConfig)
    for mine, ref in ((get_config(arch), jget(arch)), (get_smoke_config(arch), jget_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        for prop in ("resolved_head_dim", "padded_vocab", "q_per_kv", "ssm_d_inner",
                     "ssm_num_heads"):
            assert getattr(mine, prop) == getattr(ref, prop), prop
        assert [mine.layer_kind(i) for i in range(4)] == [ref.layer_kind(i) for i in range(4)]


def test_unported_lm_archs_raise_naming_the_roadmap():
    """No arch id is left unported: the port's ids are the reference's, and an
    unknown id raises ``KeyError``."""
    from repro.configs import ALL_ARCH_IDS
    from repro_torch.configs import ALL_ARCH_IDS as PORTED, get_config

    assert sorted(PORTED) == sorted(ALL_ARCH_IDS)
    for arch in PORTED:
        assert get_config(arch).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("name", sorted(jsc.SCENARIOS))
def test_twin_init_and_advance_match(name):
    n = 20
    jscn, tscn = scn_pair(name, n)
    jk = jax.random.key(7)
    ref = jax.jit(lambda k, s: jtw.init_twin_state(s, k))(jk, jscn)
    got = twin.init_twin_state(tscn, tkey(jk), "cpu")
    np.testing.assert_array_equal(got.lane.numpy(), np.asarray(ref.lane))
    for f in ("t", "pos", "speed", "accel", "compute_factor"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    # advance from the SAME state: 15 exact-OU substeps of a 3.7 s duration
    ka = jax.random.key(8)
    adv = jax.jit(lambda s, sc, k: jtw.advance_twin(s, sc, k, jnp.float32(3.7),
                                                    num_substeps=15))(ref, jscn, ka)
    got = twin.advance_twin(twin_to_torch(ref), tscn, tkey(ka), 3.7, 15)
    for f in ("t", "pos", "speed", "accel"):
        # positions are ~1e4 m: rtol, not atol, carries them
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(adv, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def _twin_with_ties(n=20):
    """A ring twin whose positions repeat, so CPM neighbour distances tie."""
    jscn, tscn = scn_pair("ring", n)
    st = jax.jit(lambda k, s: jtw.init_twin_state(s, k))(jax.random.key(1), jscn)
    pos = np.asarray(st.pos).copy()
    pos[1::2] = pos[0::2]  # pairs at the same position: equal distances
    pos[5] = pos[4] + 10.0
    pos[6] = pos[4] - 10.0  # two neighbours of vehicle 4 tie at 10 m
    st = st._replace(pos=jnp.asarray(pos))
    return st, jscn, tscn


def test_emit_cams_and_cpms_match_with_distance_ties():
    st, jscn, tscn = _twin_with_ties()
    jk = jax.random.key(3)
    tst = twin_to_torch(st)
    cams_j, cams_t = jmsg.emit_cams(st, jscn, jk), messages.emit_cams(tst, tscn, tkey(jk))
    cpms_j, cpms_t = jmsg.emit_cpms(st, jscn, jk), messages.emit_cpms(tst, tscn, tkey(jk))
    for k in ("src", "obj"):
        np.testing.assert_array_equal(cams_t[k].numpy(), np.asarray(cams_j[k]))
        np.testing.assert_array_equal(cpms_t[k].numpy(), np.asarray(cpms_j[k]))
    np.testing.assert_array_equal(cpms_t["valid"].numpy(), np.asarray(cpms_j["valid"]))
    for k in ("pos", "speed", "accel", "var"):
        np.testing.assert_allclose(cams_t[k].numpy(), np.asarray(cams_j[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(cpms_t[k].numpy(), np.asarray(cpms_j[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_fuse_kinematics_matches():
    st, jscn, tscn = _twin_with_ties()
    jk = jax.random.key(4)
    cams = jmsg.emit_cams(st, jscn, jk)
    cpms = jmsg.emit_cpms(st, jscn, jk)
    ref = jfu.fuse_kinematics(cams, cpms, jscn)
    to_t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    got = fusion.fuse_kinematics(to_t(cams), to_t(cpms), tscn)
    for name, a, b in zip(("pos", "speed", "accel", "pos_var"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("n,d,k,seed", [(20, 64, 3, 0), (20, 64, 5, 1), (40, 128, 10, 2)])
def test_kmeans_labels_match_exactly(n, d, k, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d))
    x = centers[rng.integers(0, k, n)] + 0.3 * rng.normal(size=(n, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    jk = jax.random.key(seed)
    labels_j, cents_j = jcl.kmeans_cluster(jnp.asarray(x), jk, k)
    labels_t, cents_t = clustering.kmeans_cluster(torch.from_numpy(x), tkey(jk), k)
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    np.testing.assert_allclose(cents_t.numpy(), np.asarray(cents_j), rtol=1e-4, atol=1e-5)


def test_sketches_match():
    jk = jax.random.key(6)
    P, D = 5000, 256
    sign_j = jcl.sketch_sign_vector(jk, P, D)
    sign_t = clustering.sketch_sign_vector(tkey(jk), P, D, "cpu")
    np.testing.assert_array_equal(sign_t.numpy(), np.asarray(sign_j))
    v = np.random.default_rng(0).normal(size=(3, P)).astype(np.float32)
    ref = jax.vmap(lambda u: jcl.apply_sketch(u, sign_j, D))(jnp.asarray(v))
    got = clustering.apply_sketch(torch.from_numpy(v), sign_t, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)


def _selection_inputs(n, seed, ties):
    rng = np.random.default_rng(seed)
    connected = rng.random(n) < 0.8
    lat = rng.uniform(0.05, 2.0, n).astype(np.float32)
    if ties:
        lat = np.round(lat, 1).astype(np.float32)  # many equal latencies
    clusters = rng.integers(0, 4, n).astype(np.int32)
    return connected, lat, clusters


@pytest.mark.parametrize("strategy", sorted(jsel.STRATEGIES))
@pytest.mark.parametrize("n,seed,ties", [(20, 0, False), (20, 1, True), (64, 2, True)])
@pytest.mark.parametrize("n_select,gamma", [(2, 0.1), (7, 0.5)])
def test_selection_masks_match_exactly(strategy, n, seed, ties, n_select, gamma):
    connected, lat, clusters = _selection_inputs(n, seed, ties)
    jk = jax.random.key(seed + 100)
    ref = jsel.STRATEGIES[strategy](jk, jnp.asarray(connected), jnp.asarray(lat),
                                    jnp.asarray(clusters), n_select, gamma)
    got = selection.STRATEGIES[strategy](
        tkey(jk), torch.from_numpy(connected), torch.from_numpy(lat),
        torch.from_numpy(clusters.astype(np.int64)), n_select, gamma)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_per_cluster_rank_and_sizes_match_on_ties():
    connected, lat, clusters = _selection_inputs(30, 3, True)
    score = np.where(connected, lat, np.float32(1e30)).astype(np.float32)
    ref_rank = jsel._per_cluster_rank(jnp.asarray(score), jnp.asarray(clusters))
    got_rank = selection._per_cluster_rank(torch.from_numpy(score),
                                           torch.from_numpy(clusters.astype(np.int64)))
    np.testing.assert_array_equal(got_rank.numpy(), np.asarray(ref_rank))
    ref_size = jsel._cluster_sizes(jnp.asarray(clusters), jnp.asarray(connected))
    got_size = selection._cluster_sizes(torch.from_numpy(clusters.astype(np.int64)),
                                        torch.from_numpy(connected))
    np.testing.assert_array_equal(got_size.numpy(), np.asarray(ref_size))
