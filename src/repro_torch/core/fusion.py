"""Stage 1: V2X message fusion (``repro.core.fusion.fuse_kinematics``).

Inverse-variance fusion of one CAM self-report plus up to MAX_PERCEIVED CPM
detections per vehicle; positions are fused on the unit circle to respect
the ring's wraparound.  ``fuse_messages`` wraps the fused kinematics into
the RTTG (the unfused composition and the selector).  ``fuse_kinematics``
also fuses G lanes at once (``messages``' batched form, up to
``messages.DENSE_MAX_N`` vehicles): ``(G, N)`` outputs, each lane's row its
one-lane fusion.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import messages
from repro_torch.core.rttg import RTTG, build_rttg, table_scalar
from repro_torch.utils.elementwise import per_element


def _cpm_sums_dense(terms: torch.Tensor, obj: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(5, ..., N) sums over a dense ``(object, sender)`` table, one row per
    object and one table per lane: ``(5, G, N, N)`` for ``(G, N, P)`` CPMs."""
    N = obj.shape[-2]
    batch = obj.shape[:-2]
    lanes = math.prod(batch)
    dense = torch.zeros((5, lanes, N, N), dtype=torch.float32, device=terms.device)
    lane = torch.arange(lanes, device=terms.device)[:, None]
    dense[:, lane, obj.reshape(lanes, -1), src.reshape(-1)] = terms.reshape(5, lanes, -1)
    return dense.sum(dim=-1).reshape((5,) + batch + (N,))


def _cpm_sums_compact(terms: torch.Tensor, obj: torch.Tensor) -> torch.Tensor:
    """(5, N) sums over a compact ``(object, slot)`` table.

    Each object's detections take its slots in ascending sender order; the
    width is the largest in-degree, read back once.  The slots are added
    one after another from zero: the sequential sum in the order the JAX
    package's scatter-add meets the terms, padding slots adding +0.
    """
    N = obj.shape[0]
    flat = obj.reshape(-1)
    order = torch.sort(flat, stable=True).indices  # by object, then sender
    counts = torch.bincount(flat, minlength=N)
    width = int(counts.max())
    start = torch.cumsum(counts, 0) - counts
    owner = flat[order]
    slot = torch.arange(flat.numel(), device=flat.device) - start[owner]
    table = torch.zeros((5, N, width), dtype=torch.float32, device=terms.device)
    table[:, owner, slot] = terms.reshape(5, -1)[:, order]
    acc = torch.zeros((5, N), dtype=torch.float32, device=terms.device)
    for s in range(width):
        acc = acc + table[:, :, s]
    return acc


def fuse_kinematics(cams: dict, cpms: dict, cfg):
    """Fused ``(pos, speed, accel, pos_var)`` per vehicle.

    The JAX package scatter-adds the CPM terms onto their object ids.  On
    CUDA a float ``index_add_`` sums in a different order on every run, so
    here each term lands in a slot of its object's row and the rows are
    summed in a fixed order: a run on the card repeats itself bitwise.  Up
    to ``messages.DENSE_MAX_N`` vehicles the table is the dense
    ``(object, sender)`` one (a sender lists an object at most once, so no
    slot is written twice); above it, the compact ``(object, slot)`` table.
    """
    N = cams["pos"].shape[-1]
    L = cfg.ring_length_m
    obj = cpms["obj"]
    w_cpm = cpms["valid"].to(torch.float32) / cpms["var"]
    theta = cpms["pos"] * table_scalar(cfg.rad_per_m)
    terms = torch.stack([
        w_cpm,
        w_cpm * torch.cos(theta),
        w_cpm * torch.sin(theta),
        w_cpm * cpms["speed"],
        w_cpm * cpms["accel"],
    ])  # (5, N, P)
    if N <= messages.DENSE_MAX_N:
        sums = _cpm_sums_dense(terms, obj, cpms["src"])
    else:
        sums = _cpm_sums_compact(terms, obj)
    sum_w, sum_cos, sum_sin, sum_speed, sum_accel = sums

    w_cam = 1.0 / cams["var"]
    th_cam = cams["pos"] * cfg.rad_per_m
    sum_w = sum_w + w_cam
    sum_cos = sum_cos + w_cam * torch.cos(th_cam)
    sum_sin = sum_sin + w_cam * torch.sin(th_cam)
    sum_speed = sum_speed + w_cam * cams["speed"]
    sum_accel = sum_accel + w_cam * cams["accel"]

    pos = torch.remainder(
        per_element(torch.atan2, sum_sin / sum_w, sum_cos / sum_w) * cfg.m_per_rad, L
    )
    return pos, sum_speed / sum_w, sum_accel / sum_w, 1.0 / sum_w


def fuse_messages(cams: dict, cpms: dict, t, cfg) -> RTTG:
    pos, speed, accel, pos_var = fuse_kinematics(cams, cpms, cfg)
    return build_rttg(t, pos, speed, accel, pos_var, cfg)
