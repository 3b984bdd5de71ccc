"""Mamba2 SSD chunked scan: CUDA kernel and its plain version.

Port of ``repro/kernels/ssd_scan.py`` (Pallas ``_ssd_chunk_kernel``), the
prefill's state-space scan: xh ``(B, S, nh, hp)``, dt ``(B, S, nh)`` fp32
(after softplus), A ``(nh,)`` negative, Bs / Cs ``(B, S, ds)`` (one group
shared by the heads) and an optional initial state h0 ``(B, nh, hp, ds)``
fp32.  The sequence runs in chunks of ``Q = min(chunk, S)`` steps; within a
chunk, with ``cs = cumsum(dt * A)``,

    y[q]  = sum_{k <= q} (C_q . B_k) exp(cs_q - cs_k) dt_k x_k + exp(cs_q) C_q . h
    h'    = exp(cs_Q) h + sum_k exp(cs_Q - cs_k) dt_k x_k (x) B_k

-> y ``(B, S, nh, hp)`` fp32 and the final state ``(B, nh, hp, ds)`` fp32.
CUDA tensors launch ``csrc/ssd_scan.cu`` (one block per chunk of one head,
the state chained from chunk to chunk through the output h); CPU tensors run
``ssd_scan_plain``.  There is no fallback from one to the other.  The
kernel has no backward: training runs ``ssd_scan_plain`` on either device
(``models/ssm.py`` picks it by grad mode), and the wrapper refuses a
grad-requiring operand on the card.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import count_launch, on_card, refuse_grad

# Kernel launches made by ``ssd_scan`` (one per call on CUDA tensors).
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pitch(cols: int, tile: int, element_size: int) -> int:
    """Row pitch in elements of a staged tile: ``cols`` padded to ``tile``, plus 8
    bf16 or 4 fp32 elements (16-byte multiples, 4 mod 8 words)."""
    return _up(cols, tile) + (8 if element_size == 2 else 4)


def smem_bytes(Q: int, hp: int, ds: int, element_size: int) -> int:
    """Shared memory of one block (one chunk of one head): x, B and C of the chunk
    in the input's element type, then its dt, the (hp, ds) state and two more (Q,)
    rows in fp32.  Q and ds round up to whole mma tiles (16), hp to whole units of
    64 output columns, the tiles' rows carry pitch padding and the rows of length Q
    round up to 32."""
    Qp, hp64, ds16, Q32 = _up(Q, 16), _up(hp, 64), _up(ds, 16), _up(Q, 32)
    tiles = Qp * (_pitch(hp, 64, element_size) + 2 * _pitch(ds, 16, element_size))
    return element_size * tiles + 4 * (hp64 * (ds16 + 4) + 3 * Q32)


def counter_count(B: int, nh: int) -> int:
    """int32 counters of a launch: the ticket and one chain count per (b, head)."""
    return 1 + B * nh


def ssd_chunk(h, x_c, dt_c, B_c, C_c, A):
    """One chunk of the scan: carried state h (B, nh, hp, ds) fp32 and the
    chunk's x (B, Q, nh, hp), dt (B, Q, nh) fp32, B / C (B, Q, ds) -> (y (B, Q,
    nh, hp) fp32, h'); x, B and C are read in h's dtype.

    The reference's ``one_chunk``, but the decay's exponent is masked to
    ``-inf`` above the diagonal before the ``exp``: there ``cs_q - cs_k``
    reaches ~|A| dt Q (~102 at A = -16, dt = 0.05, Q = 128), ``exp``
    overflows to inf, and the backward would multiply the zero cotangent the
    ``where`` leaves there by it (NaN).  The forward is the unmasked one bit
    for bit: those entries are zeroed either way."""
    Q = x_c.shape[1]
    x_c = x_c.to(h.dtype)
    B_c = B_c.to(h.dtype)
    C_c = C_c.to(h.dtype)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x_c.device))[None, :, :, None]
    cs = torch.cumsum(dt_c * A, dim=1)  # inclusive
    G = torch.einsum("bqn,bkn->bqk", C_c, B_c)
    expo = cs[:, :, None, :] - cs[:, None, :, :]  # (B, Q, Q, nh)
    decay = torch.exp(torch.where(tri, expo, torch.full((), -math.inf, device=expo.device)))
    M = G[..., None] * decay * dt_c[:, None, :, :]
    M = torch.where(tri, M, torch.zeros((), device=M.device))
    y = torch.einsum("bqkh,bkhp->bqhp", M, x_c)
    y = y + torch.einsum("bqn,bhpn->bqhp", C_c, h) * torch.exp(cs)[..., None]
    sdecay = torch.exp(cs[:, -1:, :] - cs) * dt_c  # (B, Q, nh)
    Sc = torch.einsum("bkn,bkhp->bhpn", B_c, x_c * sdecay[..., None])
    h = torch.exp(cs[:, -1, :])[:, :, None, None] * h + Sc
    return y, h


def ssd_scan_plain(xh, dt, A, Bs, Cs, chunk: int, h0=None):
    """The chunked scan of ``repro/models/ssm.py::ssd_scan`` in torch, with y
    left in fp32 (the kernel's output; the model rounds it at the call site);
    float64 operands compute in float64.

    Under grad mode each chunk runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint(one_chunk, policy=nothing_saveable)``): the
    backward keeps only each chunk's inputs and carried state and recomputes
    the (B, Q, Q, nh) temporaries.  The values are the same bit for bit."""
    Bsz, S, nh, hp = xh.shape
    ds = Bs.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    f = torch.promote_types(xh.dtype, torch.float32)  # float64 operands stay float64
    dt = dt.to(f)
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bs = torch.nn.functional.pad(Bs, (0, 0, 0, pad))
        Cs = torch.nn.functional.pad(Cs, (0, 0, 0, pad))
    nc = (S + pad) // Q
    h = (torch.zeros((Bsz, nh, hp, ds), dtype=f, device=xh.device)
         if h0 is None else h0.to(f))
    remat = torch.is_grad_enabled()
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        args = (h, xh[:, sl], dt[:, sl], Bs[:, sl], Cs[:, sl], A)
        y, h = (checkpoint(ssd_chunk, *args, use_reentrant=False) if remat
                else ssd_chunk(*args))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def _check(name, x, shape, dtype, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"ssd_scan: {name} must be a contiguous {shape} {dtype} tensor "
                         f"on {device}, got {tuple(x.shape)} {x.dtype} on {x.device}")


def _ssd_scan_cuda(xh, dt, A, Bs, Cs, chunk, h0):
    from repro_torch.kernels.build import check, counters, library

    # no backward: training calls ssd_scan_plain (models/ssm.py routes by grad mode)
    refuse_grad("ssd_scan", xh, dt, A, Bs, Cs, h0,
                use="call ssd_scan_plain, as models.ssm does")
    if xh.dtype not in _DTYPE_CODES:
        raise NotImplementedError(f"ssd_scan: the kernel takes float32 or bfloat16, "
                                  f"got {xh.dtype}")
    if xh.dim() != 4:
        raise ValueError(f"ssd_scan: xh must be (B, S, nh, hp), got {tuple(xh.shape)}")
    Bsz, S, nh, hp = xh.shape
    ds = Bs.shape[-1]
    if S < 1 or chunk < 1 or Bsz * nh < 1:
        raise ValueError(f"ssd_scan: needs S >= 1 and chunk >= 1, got S={S} chunk={chunk}")
    device = xh.device
    _check("xh", xh, (Bsz, S, nh, hp), xh.dtype, device)
    _check("dt", dt, (Bsz, S, nh), torch.float32, device)
    _check("A", A, (nh,), torch.float32, device)
    _check("Bs", Bs, (Bsz, S, ds), xh.dtype, device)
    _check("Cs", Cs, (Bsz, S, ds), xh.dtype, device)
    if h0 is not None:
        _check("h0", h0, (Bsz, nh, hp, ds), torch.float32, device)
    Q = min(chunk, S)
    need = smem_bytes(Q, hp, ds, xh.element_size())
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(f"ssd_scan: a block needs {need} bytes of shared memory at "
                         f"Q={Q} hp={hp} ds={ds}, the card gives {limit}")
    y = torch.empty((Bsz, S, nh, hp), dtype=torch.float32, device=device)
    h = torch.empty((Bsz, nh, hp, ds), dtype=torch.float32, device=device)
    chain = counters(device, "ssd_scan", counter_count(Bsz, nh))
    with on_card(xh):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = library().ssd_scan_launch(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bs.data_ptr(), Cs.data_ptr(),
            None if h0 is None else h0.data_ptr(), Bsz, S, nh, hp, ds, Q, need,
            _DTYPE_CODES[xh.dtype], y.data_ptr(), h.data_ptr(), chain.data_ptr(), stream,
        )
    check(status, "ssd_scan")
    count_launch(__name__)
    return y, h


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bs: torch.Tensor,
             Cs: torch.Tensor, chunk: int = 128, h0=None):
    """Chunked SSD -> (y (B, S, nh, hp) fp32, final state (B, nh, hp, ds) fp32).

    On the card xh, Bs and Cs share one dtype (float32 or bfloat16); dt, A
    and h0 are float32, and no operand may require grad under grad mode
    (the kernel has no backward); the plain version is differentiable.
    """
    if xh.is_cuda:
        return _ssd_scan_cuda(xh, dt, A, Bs, Cs, chunk, h0)
    if xh.device.type != "cpu":
        raise ValueError(f"ssd_scan: unsupported device {xh.device}")
    return ssd_scan_plain(xh, dt, A, Bs, Cs, chunk, h0)
