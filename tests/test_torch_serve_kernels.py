"""The serving path's two kernels: their plain versions against the JAX package.

``repro_torch.kernels.swa_decode`` (B7) and ``repro_torch.kernels.ssd_scan``
(B8) run their plain PyTorch versions on CPU tensors; these tests hold them
against ``repro.kernels.ref``, against the Pallas kernels in interpret mode
(as ``tests/test_kernels.py`` runs them) and, for the scan, against the
model's jnp ``models/ssm.py::ssd_scan``.  Inputs are drawn with numpy from a
seed and handed to both sides.  Tolerances:

- ``swa_decode``: 2e-5 (``tests/test_kernels.py``'s), fp32 softmax sums in
  another order on outputs of size ~1.  On a row with no visible slot the
  port gives ``ref.swa_decode``'s exact 0; the Pallas kernel's ``-1e30``
  fill averages every slot's ``v`` there, so that row is held to ``ref``.
  The card kernel's split-KV algebra (per-split max, sum and unnormalized
  accumulator, combined in ascending split order with empty splits
  skipped), written here in plain torch, is held to ``ref`` at the same
  2e-5.
- ``ssd_scan``: 5e-4 against the per-token recurrence and the interpret-mode
  kernel (``tests/test_kernels.py``'s: the chunked form reassociates the
  recurrence), 1e-5 against the jnp chunked scan, the same algorithm.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd_kernel
from repro.kernels import swa_decode as jswa_kernel
from repro.models.ssm import ssd_scan as jssd_model
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import swa_decode as swa
from repro_torch.models.layers import ring_positions
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)


def _swa_inputs(b, hkv, g, d, c, fills, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv, g, d)).astype(dtype)
    k = rng.standard_normal((b, c, hkv, d)).astype(dtype)
    v = rng.standard_normal((b, c, hkv, d)).astype(dtype)
    kv_pos = np.stack([ring_positions(f, c).numpy() for f in fills]).astype(np.int32)
    pos = np.array([f - 1 for f in fills], np.int32)
    return q, k, v, kv_pos, pos


def _port_swa(q, k, v, kv_pos, pos, window, softcap):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v, kv_pos, pos)]
    before = swa.launches
    out = swa.swa_decode(*t, window=window, softcap=softcap).numpy()
    assert swa.launches == before  # CPU tensors: the plain version, no launch
    return out


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 30.0), (37, 50.0)])
@pytest.mark.parametrize("b,hkv,g,d,c,fills", [
    (2, 4, 2, 64, 300, (300, 290)),  # test_kernels.py's shapes, filled rings
    (1, 1, 8, 128, 512, (600,)),  # a wrapped ring
    (3, 2, 1, 32, 65, (20, 65, 1000)),  # partly filled, full, wrapped; G = 1
    (2, 2, 3, 32, 32, (40, 7)),  # hymba smoke's decode ring (window 32)
])
def test_plain_swa_decode_matches_ref_and_the_interpret_kernel(window, softcap, b, hkv, g, d,
                                                               c, fills):
    q, k, v, kv_pos, pos = _swa_inputs(b, hkv, g, d, c, fills, seed=b * c + d)
    got = _port_swa(q, k, v, kv_pos, pos, window, softcap)
    args = [jnp.asarray(x) for x in (q, k, v, kv_pos, pos)]
    want = np.asarray(jref.swa_decode(*args, window=window, softcap=softcap))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    pallas = np.asarray(jswa_kernel(*args, window=window, softcap=softcap, block_c=128,
                                    interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


def _split_kv_decode(q, k, v, kv_pos, pos, window, softcap, split):
    """``csrc/swa_decode.cu``'s algebra in plain torch.  Each split of
    ``split`` slots keeps its max m (-inf when it sees no slot), l = sum
    exp(s - m) and the unnormalized acc = sum exp(s - m) v; the splits are
    then combined in ascending order, skipping those with m = -inf:
    M = max m, L = sum l exp(m - M), out = sum acc exp(m - M) / L, 0 where
    no split sees a slot."""
    qf, kf, vf = (torch.from_numpy(np.asarray(x, np.float32)) for x in (q, k, v))
    jk = torch.from_numpy(kv_pos)[:, None, None, :]
    iq = torch.from_numpy(pos)[:, None, None, None]
    s = torch.einsum("bhgd,bchd->bhgc", qf, kf) / math.sqrt(q.shape[-1])
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    visible = (jk >= 0) & (jk <= iq)
    if window > 0:
        visible = visible & ((iq - jk) < window)
    s = torch.where(visible, s, -torch.inf)
    parts = []
    for c0 in range(0, k.shape[1], split):
        sc = s[..., c0:c0 + split]
        m = sc.amax(-1, keepdim=True)
        seen = m > -torch.inf
        p = torch.where(seen, torch.exp(sc - torch.where(seen, m, 0.0)), 0.0)
        acc = torch.einsum("bhgc,bchd->bhgd", p, vf[:, c0:c0 + split])
        parts.append((m, p.sum(-1, keepdim=True), acc, seen))
    big = torch.stack([m for m, *_ in parts]).amax(0)
    total = torch.zeros_like(big)
    out = torch.zeros_like(parts[0][2])
    for m, l, acc, seen in parts:  # ascending split order
        w = torch.where(seen, torch.exp(m - torch.where(seen, big, 0.0)), 0.0)
        total = total + l * w
        out = out + acc * w
    return torch.where(total > 0, out / torch.where(total > 0, total, 1.0), 0.0).numpy()


@pytest.mark.parametrize("split", [1, 7, 64])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 30.0), (37, 50.0)])
@pytest.mark.parametrize("b,hkv,g,d,c,fills", [
    (2, 4, 2, 64, 300, (300, 290)),
    (1, 1, 8, 128, 512, (600,)),
    (3, 2, 1, 32, 65, (20, 65, 1000)),  # row 0: every split past the 3rd is empty
    (2, 2, 3, 32, 32, (40, 7)),
])
def test_split_kv_combine_matches_ref(split, window, softcap, b, hkv, g, d, c, fills):
    q, k, v, kv_pos, pos = _swa_inputs(b, hkv, g, d, c, fills, seed=b * c + d)
    got = _split_kv_decode(q, k, v, kv_pos, pos, window, softcap, split)
    args = [jnp.asarray(x) for x in (q, k, v, kv_pos, pos)]
    want = np.asarray(jref.swa_decode(*args, window=window, softcap=softcap))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("split", [1, 7, 64])
def test_split_kv_combine_gives_blind_rows_refs_zero(split):
    """Row 1's ring is empty, row 2's query precedes every slot: every split
    of those rows is skipped and the row is exactly 0, as ``ref`` gives."""
    q, k, v, kv_pos, pos = _swa_inputs(3, 2, 3, 32, 64, (64, 64, 64), seed=5)
    kv_pos[1] = -1
    pos[2] = -1
    got = _split_kv_decode(q, k, v, kv_pos, pos, 32, 0.0, split)
    want = np.asarray(jref.swa_decode(*[jnp.asarray(x) for x in (q, k, v, kv_pos, pos)],
                                      window=32))
    assert np.array_equal(got[1:], np.zeros_like(got[1:]))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_swa_decode_row_with_no_visible_slot_is_refs_zero():
    """Row 1's ring is empty, row 2's query precedes every slot: ``ref`` and the
    port give 0 there; the other rows agree with the interpret-mode kernel."""
    q, k, v, kv_pos, pos = _swa_inputs(3, 2, 3, 32, 64, (64, 64, 64), seed=5)
    kv_pos[1] = -1
    pos[2] = -1
    got = _port_swa(q, k, v, kv_pos, pos, 32, 0.0)
    args = [jnp.asarray(x) for x in (q, k, v, kv_pos, pos)]
    want = np.asarray(jref.swa_decode(*args, window=32))
    assert np.array_equal(got[1:], np.zeros_like(got[1:]))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    pallas = np.asarray(jswa_kernel(*args, window=32, block_c=32, interpret=True))
    np.testing.assert_allclose(got[0], pallas[0], rtol=2e-5, atol=2e-5)


def test_plain_swa_decode_takes_bf16_as_ref_does():
    """bf16 q, k, v: fp32 scores of exact bf16 products, as ``ref`` computes them."""
    q, k, v, kv_pos, pos = _swa_inputs(2, 2, 3, 64, 100, (100, 150), seed=11)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = swa.swa_decode(qb, kb, vb, torch.from_numpy(kv_pos), torch.from_numpy(pos),
                         window=64).numpy()
    j = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (qb, kb, vb)]
    want = np.asarray(jref.swa_decode(*j, jnp.asarray(kv_pos), jnp.asarray(pos), window=64))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_ring_positions_match_the_reference_cache():
    """``ring_positions`` is ``init_lm_cache``'s ring of a ``prefilled`` context."""
    from repro.configs import get_smoke_config
    from repro.models.transformer import init_lm_cache

    cfg = get_smoke_config("hymba-1.5b")
    for seq, pre in ((40, 37), (50, 100), (20, 7), (32, 32), (33, 1)):
        want = np.asarray(init_lm_cache(cfg, 1, seq, pre)["layers"][0]["attn"]["pos"])[0, 0]
        got = ring_positions(pre, min(seq, cfg.sliding_window)).numpy()
        np.testing.assert_array_equal(got, want)


def _ssd_inputs(b, s, nh, hp, ds, seed, with_h0=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)  # softplus
    A = (-np.exp(0.3 * rng.standard_normal((nh,)))).astype(np.float32)
    Bs = rng.standard_normal((b, s, ds)).astype(np.float32)
    Cs = rng.standard_normal((b, s, ds)).astype(np.float32)
    h0 = rng.standard_normal((b, nh, hp, ds)).astype(np.float32) if with_h0 else None
    return x, dt, A, Bs, Cs, h0


def _port_ssd(x, dt, A, Bs, Cs, h0, chunk):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, dt, A, Bs, Cs)]
    before = ssd.launches
    y, h = ssd.ssd_scan(*t, chunk, None if h0 is None else torch.from_numpy(h0))
    assert ssd.launches == before
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("b,s,nh,hp,ds,q,with_h0", [
    (2, 48, 3, 16, 8, 16, True), (1, 40, 2, 8, 32, 8, True), (3, 33, 4, 32, 16, 16, True),
    (2, 40, 12, 32, 16, 16, False),  # hymba smoke's prefill: S=40 in chunks of 16
    (1, 1, 2, 8, 8, 16, False),  # one step
    (2, 10, 2, 8, 8, 16, True),  # Q > S: one chunk of S
])
def test_plain_ssd_scan_matches_the_recurrence_and_the_interpret_kernel(b, s, nh, hp, ds, q,
                                                                        with_h0):
    x, dt, A, Bs, Cs, h0 = _ssd_inputs(b, s, nh, hp, ds, seed=b * s, with_h0=with_h0)
    y, h = _port_ssd(x, dt, A, Bs, Cs, h0, q)
    j = [jnp.asarray(a) for a in (x, dt, A, Bs, Cs)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_ref, h_ref = jref.ssd_naive(*j, jh0)
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(h, np.asarray(h_ref), atol=5e-4, rtol=5e-4)
    y_k, h_k = jssd_kernel(*j, chunk=q, h0=jh0, interpret=True)
    np.testing.assert_allclose(y, np.asarray(y_k), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(h, np.asarray(h_k), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("b,s,nh,hp,ds,q", [(2, 64, 4, 16, 16, 16), (2, 40, 12, 32, 16, 16),
                                            (1, 37, 3, 8, 8, 8)])
def test_plain_ssd_scan_matches_the_models_jnp_scan(b, s, nh, hp, ds, q):
    """The same chunked algorithm as ``models/ssm.py::ssd_scan`` (fp32 in, so its
    ``y.astype(xh.dtype)`` is exact): within 1e-5."""
    x, dt, A, Bs, Cs, h0 = _ssd_inputs(b, s, nh, hp, ds, seed=7 + s, with_h0=True)
    y, h = _port_ssd(x, dt, A, Bs, Cs, h0, q)
    y_j, h_j = jssd_model(*[jnp.asarray(a) for a in (x, dt, A, Bs, Cs)], q, jnp.asarray(h0))
    np.testing.assert_allclose(y, np.asarray(y_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h, np.asarray(h_j), atol=1e-5, rtol=1e-5)


def test_plain_ssd_scan_bf16_inputs_round_as_the_models_scan():
    """bf16 x, B, C (the full-width model's): the port's fp32 y rounded to bf16 at
    the call site against the jnp scan's bf16 y, within one bf16 step (2^-8
    relative) of the values; h (fp32 on both sides) within 1e-5."""
    x, dt, A, Bs, Cs, _ = _ssd_inputs(2, 40, 4, 16, 16, seed=3, with_h0=False)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bs, Cs)]
    y, h = ssd.ssd_scan(tb[0], torch.from_numpy(dt), torch.from_numpy(A), tb[1], tb[2], 16)
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tb]
    y_j, h_j = jssd_model(jb[0], jnp.asarray(dt), jnp.asarray(A), jb[1], jb[2], 16)
    y_port = y.to(torch.bfloat16).float().numpy()
    y_jax = np.asarray(y_j.astype(jnp.float32))
    np.testing.assert_allclose(y_port, y_jax, rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=1e-5, rtol=1e-5)


# the card's opt-in shared memory per block (NVIDIA H100: 227 KB)
H100_SMEM_OPTIN = 232_448


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m"])
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("element_size", [2, 4])
def test_ssd_scan_block_fits_the_card_at_the_zoos_heads(arch, smoke, element_size):
    """A block of the card kernel (one chunk of one head) fits the H100's opt-in
    shared memory at each SSM config's (Q, hp, ds), the full and the smoke sizes,
    with x, B and C in bf16 or fp32."""
    cfg = (jget_smoke if smoke else jget_config)(arch)
    Q, hp, ds = cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_state
    assert ssd.smem_bytes(Q, hp, ds, element_size) <= H100_SMEM_OPTIN


@pytest.mark.parametrize("Q,hp,ds,element_size,fits", [
    (128, 64, 16, 2, True),  # hymba-1.5b
    (128, 64, 128, 4, True),  # mamba2-130m in fp32, the largest tile the zoo needs
    (128, 256, 16, 4, True),
    (256, 256, 256, 4, False),  # the tile the card wrapper refuses
    (256, 256, 256, 2, False),
    (1024, 64, 16, 2, False),
])
def test_ssd_scan_shared_memory_at_the_edges(Q, hp, ds, element_size, fits):
    assert (ssd.smem_bytes(Q, hp, ds, element_size) <= H100_SMEM_OPTIN) == fits


def test_ssd_scan_counters_at_hymbas_prefill():
    """B = 4, nh = 50: the ticket and one chain count per (b, head)."""
    assert ssd.counter_count(4, 50) == 1 + 200
