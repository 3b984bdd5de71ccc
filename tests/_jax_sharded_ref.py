"""The reference's sharded runs, for ``tests/test_torch_lm_sharded.py``,
``tests/test_torch_lm_sharded_ssm.py`` and
``tests/test_torch_lm_sharded_encdec.py``.

Run as a script in a process of its own: it asks JAX for four CPU devices
(``jax_num_cpu_devices``, set before JAX starts; jax 0.9.0 ignores
``--xla_force_host_platform_device_count``) and writes an ``.npz``:

- ``serve/<arch>/<dtype>/{tokens,logits}``: the reference's serve
  CLI (``repro.launch.serve``) at ``--batch 2 --prompt-len 40 --gen 8``, the
  smoke config in that dtype, params replicated, prefill and decode jitted
  under ``activation_sharding`` of a ``(data 1, model 4)`` mesh with
  ``SERVE_RULES``: every MoE layer dispatches to ``_moe_shard_map``; the
  greedy tokens (2, 8) and each step's logits (8, 2, V), the prefill's first;
  for a model with an SSM mixer also ``serve/<arch>/<dtype>/ssm/<i>/{h,conv}``,
  sub-layer i's state in the final cache (fp32); for an encoder-decoder
  (its stubbed frames from ``"frames"``, no ``max_seq``, as the CLI
  prefills it) ``serve/<arch>/<dtype>/self/{k,v,xk,xv}``, the final cache's
  (fp32) and ``.../self/pos``.  An ``<arch>`` may carry overrides of the
  smoke config, ``ARCH:key=value,...`` (integers), e.g.
  ``hymba-1.5b:d_model=160``;
- ``moe/<case>/y``: ``_moe_shard_map`` on the operands in ``moe/<case>/*``
  of the input file, on the ``(1, 4)`` mesh, and ``moe1/<case>/y`` on a
  ``(1, 1)`` mesh.

    python tests/_jax_sharded_ref.py IN.npz OUT.npz ARCH [ARCH ...]
"""
import sys

import jax

jax.config.update("jax_num_cpu_devices", 4)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.data import make_lm_batch  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.sharding import SERVE_RULES, activation_sharding, split_params  # noqa: E402
from repro.utils import fold_in_str  # noqa: E402

BATCH, PROMPT, GEN = 2, 40, 8
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def smoke_config(spec: str):
    """The smoke config of ``ARCH[:key=value,...]``, the overrides applied."""
    arch, _, over = spec.partition(":")
    kw = dict(item.split("=") for item in over.split(",")) if over else {}
    return get_smoke_config(arch).replace(**{k: int(v) for k, v in kw.items()})


def serve(arch: str, dtype: str, mesh) -> dict:
    cfg = smoke_config(arch).replace(dtype=dtype)
    api = build_model(cfg)
    key = jax.random.key(0)
    params, _ = split_params(api.init(fold_in_str(key, "init")))
    b = make_lm_batch(fold_in_str(key, "prompts"), BATCH, PROMPT + 1, cfg.vocab_size)
    batch = {"tokens": b["tokens"][:, :PROMPT]}
    if cfg.family == "vlm":
        batch["image_embeds"] = 0.02 * jax.random.normal(
            fold_in_str(key, "img"), (BATCH, cfg.num_image_tokens, cfg.d_model))
    if cfg.family == "encdec":
        batch["frames"] = 0.02 * jax.random.normal(
            fold_in_str(key, "frames"), (BATCH, cfg.encoder_seq, cfg.d_model))
    max_seq = None if cfg.family == "encdec" else PROMPT + GEN + (cfg.num_image_tokens or 0)
    with activation_sharding(mesh, SERVE_RULES):
        logits, cache = jax.jit(lambda p, x: api.prefill(p, x, max_seq))(params, batch)
        decode = jax.jit(api.decode_step)
        tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out, steps = [tokens], [logits]
        for _ in range(GEN - 1):
            logits, cache = decode(params, cache, tokens)
            tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            out.append(tokens)
            steps.append(logits)
    got = {"tokens": np.asarray(jnp.stack(out, axis=1)),
           "logits": np.asarray(jnp.stack(steps).astype(jnp.float32))}
    if cfg.family == "encdec":
        for k, v in cache["self"].items():
            got[f"self/{k}"] = np.asarray(v if k == "pos" else v.astype(jnp.float32))
        return got
    for i, entry in enumerate(cache["layers"]):
        for k, v in entry.get("ssm", {}).items():
            got[f"ssm/{i}/{k}"] = np.asarray(v.astype(jnp.float32))
    return got


class _Cfg:
    def __init__(self, E, K):
        self.num_experts, self.experts_per_token = E, K


def main(argv) -> None:
    src, dst, archs = argv[0], argv[1], argv[2:]
    devs = np.array(jax.devices())
    mesh4 = Mesh(devs[:4].reshape(1, 4), ("data", "model"))
    mesh1 = Mesh(devs[:1].reshape(1, 1), ("data", "model"))
    out = {}
    for arch in archs:
        for dtype in DTYPES:
            for k, v in serve(arch, dtype, mesh4).items():
                out[f"serve/{arch}/{dtype}/{k}"] = v
    ops = np.load(src)
    cases = sorted({k.split("/")[1] for k in ops.files if k.startswith("moe/")})
    for case in cases:
        g = {k.split("/")[2]: ops[k] for k in ops.files if k.startswith(f"moe/{case}/")}
        dt = DTYPES[str(g["dtype"])]
        p = {"router": jnp.asarray(g["router"], jnp.float32)}
        for w in ("w_gate", "w_up", "w_down"):
            p[w] = jnp.asarray(g[w], jnp.float32).astype(dt)
        x = jnp.asarray(g["x"], jnp.float32).astype(dt)
        cfg = _Cfg(int(g["E"]), int(g["K"]))
        for name, mesh in (("moe", mesh4), ("moe1", mesh1)):
            y, _ = jax.jit(lambda p, x, mesh=mesh: jmoe._moe_shard_map(p, x, cfg, mesh))(p, x)
            out[f"{name}/{case}/y"] = np.asarray(y.astype(jnp.float32))
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
