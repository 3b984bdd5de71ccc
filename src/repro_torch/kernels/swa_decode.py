"""Single-token GQA attention over a ring-buffer KV cache: CUDA kernel and
its plain version.

Port of ``repro/kernels/swa_decode.py`` (Pallas ``_swa_decode_kernel``), the
decode step's attention: q ``(B, Hkv, G, D)`` against k, v ``(B, C, Hkv, D)``
whose slots hold the absolute positions ``kv_pos`` ``(B, C)`` (-1 = empty);
the query sits at ``pos`` ``(B,)``.  A slot is visible when
``0 <= kv_pos <= pos`` and, with ``window > 0``, ``pos - kv_pos < window``;
``softcap > 0`` caps the scores as ``softcap * tanh(s / softcap)``.
-> ``(B, Hkv, G, D)`` fp32.  A row with no visible slot gives 0, as
``repro.kernels.ref.swa_decode`` does (the Pallas kernel's ``-1e30`` fill
would average every slot's ``v`` there).  CUDA tensors launch
``csrc/swa_decode.cu``; CPU tensors run ``swa_decode_plain``.  There is no
fallback from one to the other.  The kernel splits the C slots across blocks
(``split_len`` slots each) and the last block of each (b, kv head) combines
the splits in the same launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad

# Kernel launches made by ``swa_decode`` (one per call on CUDA tensors).
launches = 0

# The kernel keeps a (G, D) query tile and G score rows in shared memory.
MAX_GROUP = 16
MAX_HEAD_DIM = 256
# (b, kv head) pairs run along the grid's y axis
MAX_BATCH_HEADS = 65535
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def split_len(head_dim: int, element_size: int) -> int:
    """Slots per block of the kernel: 128, 64 for rows over 128 bytes, 32 for
    rows over 256 (the block stages its slots' K and V rows in shared memory)."""
    row = head_dim * element_size
    return 128 if row <= 128 else 64 if row <= 256 else 32


def scratch_numel(B: int, C: int, hkv: int, G: int, D: int, element_size: int) -> int:
    """fp32 scratch of one call: per (b, kv head, split) the split's (G, D)
    accumulator and its max and sum per head, each padded to 4 floats."""
    per_split = 4 * (-(-G * D // 4) + -(-2 * G // 4))
    return B * hkv * -(-C // split_len(D, element_size)) * per_split


def vector_bytes(D: int, element_size: int, *tensors) -> int:
    """The kernel's copy width: 16 or 4 bytes when a row and every tensor's
    address are multiples of it, else 0 (element copies)."""
    row = D * element_size
    for width in (16, 4):
        if row % width == 0 and all(t.data_ptr() % width == 0 for t in tensors):
            return width
    return 0


def swa_decode_plain(q, k, v, kv_pos, pos, window: int = 0, softcap: float = 0.0):
    """``repro.kernels.ref.swa_decode`` in torch: fp32 scores, ``-inf``
    masks, a guarded max, ``p = e / max(l, 1e-30)``, ``p @ v`` in fp32."""
    D = q.shape[-1]
    scores = torch.einsum("bhgd,bchd->bhgc", q.to(torch.float32), k.to(torch.float32))
    scores = scores / torch.sqrt(torch.tensor(D, dtype=torch.float32, device=q.device))
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    jk = kv_pos[:, None, None, :]
    iq = pos[:, None, None, None]
    mask = (jk >= 0) & (jk <= iq)
    if window > 0:
        mask = mask & ((iq - jk) < window)
    scores = torch.where(mask, scores, torch.tensor(-torch.inf, device=q.device))
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    l = torch.sum(e, dim=-1, keepdim=True)
    p = e / torch.clamp_min(l, 1e-30)
    return torch.einsum("bhgc,bchd->bhgd", p, v.to(torch.float32))


def _check(name, x, shape, dtype, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"swa_decode: {name} must be a contiguous {shape} {dtype} tensor "
                         f"on {device}, got {tuple(x.shape)} {x.dtype} on {x.device}")


def _swa_decode_cuda(q, k, v, kv_pos, pos, window, softcap):
    from repro_torch.kernels.build import check, counters, library

    refuse_grad("swa_decode", q, k, v)
    global launches
    if q.dtype not in _DTYPE_CODES:
        raise NotImplementedError(f"swa_decode: the kernel takes float32 or bfloat16, "
                                  f"got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"swa_decode: q must be (B, Hkv, G, D), got {tuple(q.shape)}")
    B, hkv, G, D = q.shape
    if k.dim() != 4:
        raise ValueError(f"swa_decode: k must be (B, C, Hkv, D), got {tuple(k.shape)}")
    C = k.shape[1]
    if not (1 <= G <= MAX_GROUP and 1 <= D <= MAX_HEAD_DIM and C >= 1
            and 1 <= B * hkv <= MAX_BATCH_HEADS):
        raise ValueError(f"swa_decode: the kernel takes 1 <= G <= {MAX_GROUP}, "
                         f"1 <= D <= {MAX_HEAD_DIM}, C >= 1 and 1 <= B * Hkv <= "
                         f"{MAX_BATCH_HEADS}, got G={G} D={D} C={C} B={B} Hkv={hkv}")
    device = q.device
    _check("q", q, (B, hkv, G, D), q.dtype, device)
    _check("k", k, (B, C, hkv, D), q.dtype, device)
    _check("v", v, (B, C, hkv, D), q.dtype, device)
    _check("kv_pos", kv_pos, (B, C), torch.int32, device)
    _check("pos", pos, (B,), torch.int32, device)
    out = torch.empty((B, hkv, G, D), dtype=torch.float32, device=device)
    esize = q.element_size()
    scratch = torch.empty((scratch_numel(B, C, hkv, G, D, esize),), dtype=torch.float32,
                          device=device)
    arrivals = counters(device, "swa_decode", B * hkv)
    sqrt_d = float(torch.sqrt(torch.tensor(D, dtype=torch.float32)))
    stream = torch.cuda.current_stream(device).cuda_stream
    status = library().swa_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(), pos.data_ptr(),
        B, C, hkv, G, D, int(window), float(softcap), sqrt_d, _DTYPE_CODES[q.dtype],
        split_len(D, esize), vector_bytes(D, esize, k, v), out.data_ptr(),
        scratch.data_ptr(), arrivals.data_ptr(), stream,
    )
    check(status, "swa_decode")
    launches += 1
    return out


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_pos: torch.Tensor,
               pos: torch.Tensor, window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Ring-buffer GQA decode attention -> (B, Hkv, G, D) fp32.

    On the card q, k, v share one dtype (float32 or bfloat16) and
    ``kv_pos`` / ``pos`` are int32.
    """
    if q.is_cuda:
        return _swa_decode_cuda(q, k, v, kv_pos, pos, window, softcap)
    if q.device.type != "cpu":
        raise ValueError(f"swa_decode: unsupported device {q.device}")
    return swa_decode_plain(q, k, v, kv_pos, pos, window, softcap)
