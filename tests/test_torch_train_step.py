"""The port's LM train step, trainer CLI and federated-LM run against the JAX package.

``repro_torch.launch.steps.make_train_step`` against
``repro.launch.steps.make_train_step`` (jitted): 3 AdamW steps from the
same weights on the same numpy-seeded batches (B x 32 tokens), at one
microbatch and at the config's own count (mixtral-8x7b's 8 at B = 16,
whisper-small's 2, hymba-1.5b's 4; mamba2-130m's is 1).  Tolerances: each
step's loss and metrics within rtol 2e-6; after 3 steps every parameter within 6 lr of the reference's (AdamW's
step is about ``lr * sign(g)``, so where a gradient is rounding noise the
two may step apart by up to 2 lr a step) and fewer than 0.1 % of the
elements more than lr / 10 apart.  A batch whose rows do not divide into
the microbatches drops the last ``B % m`` rows, as the reference does (the
step equals the step on the first rows bit for bit); a batch of fewer rows
than microbatches raises.

``python -m repro_torch.launch.train`` on the CPU prints the reference's
losses and writes checkpoints that the reference restores; ``python -m
repro_torch.launch.federated_llm --rounds 2`` elects the reference's
cohorts, with eval losses within 1e-3.
"""
import contextlib
import io
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCkpt
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import build_model as jbuild
from repro.sharding import split_params
from repro.utils import fold_in_str as jfold_in_str
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch import federated_llm, steps, train
from repro_torch.models import build_model
from repro_torch.utils import prng
from repro_torch.utils.pytree import tree_leaves
from test_torch_bridge import _one_thread, tree_to_numpy  # noqa: F401  (autouse fixture)

S = 32
LR = 3e-4
LOSS_RTOL = 2e-6


def _batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (0.02 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def reference():
    """Per (arch, m): the JAX api, initial params and jitted train step."""
    cache = {}

    def _get(arch, m):
        if (arch, m) not in cache:
            cfg = jget_smoke(arch).replace(train_microbatches=m)
            api = jbuild(cfg)
            params, _ = split_params(api.init(jfold_in_str(jax.random.key(0), "init")))
            step, opt = jsteps.make_train_step(api, JTrainConfig(learning_rate=LR))
            cache[arch, m] = (api, params, opt, jax.jit(step))
        return cache[arch, m]

    return _get


def _port_state(arch, m, params_np):
    api = build_model(get_smoke_config(arch).replace(train_microbatches=m))
    step, opt = steps.make_train_step(api, TrainConfig(learning_rate=LR))
    params = convert.params_tree_from_numpy(params_np)
    return steps.TrainState(params, opt.init(params)), step


def _assert_params_close(got, want, what):
    for i, (a, w) in enumerate(zip(tree_leaves(got), jax.tree_util.tree_leaves(want))):
        d = np.abs(a.float().numpy() - np.asarray(w.astype(jnp.float32)))
        assert d.max() <= 6 * LR, f"{what} leaf {i}: {d.max()}"
        assert (d > LR / 10).mean() < 1e-3, f"{what} leaf {i}: {(d > LR / 10).mean()}"


@pytest.mark.parametrize("arch,m,B", [("qwen1.5-0.5b", 1, 4), ("mixtral-8x7b", 8, 16),
                                      ("whisper-small", 2, 4), ("hymba-1.5b", 4, 4),
                                      ("mamba2-130m", 1, 4)])
def test_three_train_steps_match_the_reference(reference, arch, m, B):
    api, params, opt, jstep = reference(arch, m)
    js = jsteps.TrainState(params, opt.init(params))
    ts, tstep = _port_state(arch, m, tree_to_numpy(params))
    for i in range(3):
        b = _batch(api.cfg, B, i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"{arch} m={m} step {i + 1} {k}")
    assert int(ts.opt_state.step) == int(js.opt_state.step) == 3
    _assert_params_close(ts.params, js.params, f"{arch} m={m}")
    for x in tree_leaves(ts.opt_state.mu) + tree_leaves(ts.opt_state.nu):
        assert x.dtype == torch.float32


def test_rows_past_the_last_whole_microbatch_take_no_part():
    """B = 10 at m = 4: the step is the step on the first 8 rows, bit for bit."""
    arch = "qwen1.5-0.5b"
    cfg = get_smoke_config(arch).replace(train_microbatches=4)
    params = build_model(cfg).init(prng.key(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 10, 0).items()}
    outs = []
    for batch in (b, {k: v[:8] for k, v in b.items()}):
        state, step = _port_state(arch, 4, convert.tree_to_numpy(params))
        outs.append(step(state, batch))
    (s1, m1), (s2, m2) = outs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(s1.params), tree_leaves(s2.params)))


def test_a_batch_smaller_than_the_microbatches_raises():
    cfg = get_smoke_config("mixtral-8x7b")
    assert cfg.train_microbatches == 8
    params = build_model(cfg).init(prng.key(0), "cpu")
    state, step = _port_state("mixtral-8x7b", 8, convert.tree_to_numpy(params))
    with pytest.raises(ValueError, match="cannot be cut into its 8 microbatches"):
        step(state, {k: torch.from_numpy(v) for k, v in _batch(cfg, 4, 0).items()})


def test_prefill_and_decode_steps_run_with_grad_off():
    cfg = get_smoke_config("qwen1.5-0.5b")
    api = build_model(cfg)
    params = api.init(prng.key(0), "cpu")
    tok = torch.arange(8).reshape(2, 4)
    logits, cache = steps.make_prefill_step(api)(params, {"tokens": tok})
    with torch.no_grad():
        want, _ = api.prefill(params, {"tokens": tok})
    assert torch.equal(logits, want) and not logits.requires_grad
    out, _ = steps.make_decode_step(api)(params, cache, tok[:, -1])
    assert out.shape == (2, cfg.padded_vocab) and not out.requires_grad


def _losses(text):
    return [float(x) for x in re.findall(r"step +\d+ +loss=([0-9.]+)", text)]


def test_train_cli_prints_the_reference_losses_and_its_checkpoints_restore(reference, tmp_path):
    """4 steps at B = 4, seq 32 with a checkpoint every 2 steps; the reference's
    steps on the reference's batches (``repro.launch.train.make_batch``)."""
    api, params, opt, jstep = reference("qwen1.5-0.5b", 1)
    js = jsteps.TrainState(params, opt.init(params))
    key = jax.random.key(0)
    want = []
    for s in range(1, 5):
        js, jm = jstep(js, jtrain.make_batch(api.cfg, jax.random.fold_in(key, s), 4, S))
        want.append(float(jm["loss"]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train.main(["--steps", "4", "--batch", "4", "--seq", str(S), "--device", "cpu",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    text = out.getvalue()
    assert text.startswith("[train] qwen1.5-0.5b-smoke: 1.44M params on 1 device(s)\n")
    assert "checkpoint -> " in text and "[train] done in" in text
    np.testing.assert_allclose(res.losses, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(_losses(text), np.round(want, 4), atol=1.5e-4)
    assert CheckpointManager(str(tmp_path)).steps() == [2, 4]
    restored = JCkpt(str(tmp_path)).restore(4, js.params)
    for a, b in zip(tree_leaves(res.state.params), jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _assert_params_close(res.state.params, js.params, "train CLI")


def test_train_cli_refuses_the_fl_models():
    with pytest.raises(SystemExit, match="fl_sim"):
        train.main(["--arch", "fl-mnist-mlp", "--device", "cpu", "--steps", "1"])


def test_federated_llm_elects_the_reference_cohorts(monkeypatch):
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["federated_llm.py", "--rounds", "2"])
    with contextlib.redirect_stdout(out):
        runpy.run_path("examples/federated_llm.py", run_name="__main__")
    ref = re.findall(r"round (\d+): cohort=(\[[^]]*\]) clusters=(\[[^]]*\]) eval loss=([0-9.]+)",
                     out.getvalue())
    got = federated_llm.run(2, device="cpu", verbose=False)
    assert len(ref) == len(got) == 2
    for (rnd, cohort, clusters, loss), g in zip(ref, got):
        assert str(g["cohort"]) == cohort and str(g["clusters"]) == clusters
        assert abs(g["eval_loss"] - float(loss)) <= 1e-3
