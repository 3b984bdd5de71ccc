"""Pairwise cosine similarity (the stage-3 Gram): CUDA kernel and its plain version.

Port of ``repro/kernels/pairwise_cosine.py`` (Pallas ``_matmul_nt_kernel``
behind ``gram_nt`` and ``pairwise_cosine``).  ``gram_nt(x, y)`` is the NT
product ``x @ y.T`` in fp32; ``pairwise_cosine(x)`` row-normalizes ``x`` in
plain torch, as the JAX wrapper does outside its ``pallas_call``, and takes
the Gram of the normalized rows.  CUDA tensors launch
``csrc/pairwise_cosine.cu``; CPU tensors run ``gram_nt_plain``.  There is
no fallback from one to the other.  The kernel sums every output in
ascending k, so the Gram of ``x`` with itself is bitwise symmetric on the
card; a zero row gives an exactly zero row and column.
"""
from __future__ import annotations

import torch

# Kernel launches made by ``gram_nt`` (one per call on CUDA tensors).
launches = 0


def gram_nt_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x (N, D) @ y (M, D)^T -> (N, M)`` in fp32."""
    return x.float() @ y.float().T


def _normalize(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return xf / torch.clamp_min(torch.linalg.vector_norm(xf, dim=1, keepdim=True), 1e-12)


def pairwise_cosine_plain(x: torch.Tensor) -> torch.Tensor:
    """``(N, D) -> (N, N)`` cosine similarity, fp32 (``ref.pairwise_cosine``)."""
    xn = _normalize(x)
    return gram_nt_plain(xn, xn)


def _gram_nt_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.build import check, library

    global launches
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"gram_nt: need x (N, D) and y (M, D), got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if y.device != x.device:
        raise ValueError(f"gram_nt: x on {x.device} but y on {y.device}")
    # the kernel reads fp32 rows: a bf16 row widens exactly
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    N, D = x.shape
    M = y.shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = library().gram_nt_launch(x.data_ptr(), y.data_ptr(), N, M, D, out.data_ptr(),
                                      stream)
    check(status, "gram_nt")
    launches += 1
    return out


def gram_nt(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x (N, D) @ y (M, D)^T -> (N, M)`` fp32: the kernel on the card."""
    if x.is_cuda:
        return _gram_nt_cuda(x, y)
    if x.device.type != "cpu":
        raise ValueError(f"gram_nt: unsupported device {x.device}")
    return gram_nt_plain(x, y)


def pairwise_cosine(x: torch.Tensor) -> torch.Tensor:
    """``(N, D) -> (N, N)`` cosine similarity, fp32: rows normalized (norm
    clamped at 1e-12), then their Gram through ``gram_nt``."""
    xn = _normalize(x)
    return gram_nt(xn, xn)
