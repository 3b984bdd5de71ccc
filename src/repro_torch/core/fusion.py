"""Stage 1: V2X message fusion (``repro.core.fusion.fuse_kinematics``).

Inverse-variance fusion of one CAM self-report plus up to MAX_PERCEIVED CPM
detections per vehicle; positions are fused on the unit circle to respect
the ring's wraparound.
"""
from __future__ import annotations

import math

import torch


def fuse_kinematics(cams: dict, cpms: dict, cfg):
    """Fused ``(pos, speed, accel, pos_var)`` per vehicle.

    The JAX package scatter-adds the CPM terms onto their object ids.  On
    CUDA a float ``index_add_`` sums in a different order on every run, so
    here each term lands in a dense ``(object, sender)`` slot (a sender
    lists an object at most once, so no slot is written twice) and each
    object's row is summed: a fixed order, so a run on the card repeats
    itself bitwise.
    """
    N = cams["pos"].shape[0]
    L = cfg.ring_length_m
    obj = cpms["obj"]
    src = cpms["src"]
    w_cpm = cpms["valid"].to(torch.float32) / cpms["var"]
    theta = cpms["pos"] * (2 * math.pi / L)
    terms = torch.stack([
        w_cpm,
        w_cpm * torch.cos(theta),
        w_cpm * torch.sin(theta),
        w_cpm * cpms["speed"],
        w_cpm * cpms["accel"],
    ])  # (5, N, P)
    dense = torch.zeros((5, N, N), dtype=torch.float32, device=terms.device)
    dense[:, obj.reshape(-1), src.reshape(-1)] = terms.reshape(5, -1)
    sum_w, sum_cos, sum_sin, sum_speed, sum_accel = dense.sum(dim=2)

    w_cam = 1.0 / cams["var"]
    th_cam = cams["pos"] * (2 * math.pi / L)
    sum_w = sum_w + w_cam
    sum_cos = sum_cos + w_cam * torch.cos(th_cam)
    sum_sin = sum_sin + w_cam * torch.sin(th_cam)
    sum_speed = sum_speed + w_cam * cams["speed"]
    sum_accel = sum_accel + w_cam * cams["accel"]

    pos = torch.remainder(
        torch.atan2(sum_sin / sum_w, sum_cos / sum_w) * (L / (2 * math.pi)), L
    )
    return pos, sum_speed / sum_w, sum_accel / sum_w, 1.0 / sum_w
