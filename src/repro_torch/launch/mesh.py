"""The grid mesh (``repro.launch.mesh.make_grid_mesh``): the devices that
share an experiment grid's lanes; and the LM mesh (``make_lm_mesh``), the
``("data", "model")`` ranks a sharded LM serves on.

The reference's 1-D ``("data",)`` mesh shards a grid's lanes over every
visible device, one ``shard_map`` program for all of them, every shard at
once.  Here a mesh is a tuple of devices: ``ExperimentEngine(...,
mesh=make_grid_mesh())`` cuts the grid into contiguous shards, one a
device, and sweeps each shard's lane groups on its own card in a worker
process of its own (``utils.procs.ShardPool``), all at once.  A device may
appear more than once (``GridMesh((cuda:0, cuda:0))``, every CPU mesh):
its shards then run in turn on the calling thread, unless the engine is
built with ``processes=True``.  ``GridMesh`` itself lives in
``utils.device``, beside ``resolve_device``, so that the engine does not
depend on the command-line launchers of ``launch``.

``make_lm_mesh`` gives an ``LMMesh`` (``utils.device``): a 2-D array of
devices, one a rank, which ``launch/serve.py::serve(mesh=...)`` serves on,
a worker process a rank.

The reference's ``make_production_mesh`` and ``make_host_mesh`` are TPU pod
shapes ((16, 16) and (2, 16, 16) chips over ``("data", "model")``) and are
not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.utils.device import GridMesh, LMMesh, resolve_device

__all__ = ["GridMesh", "LMMesh", "make_grid_mesh", "make_lm_mesh"]


def make_grid_mesh(num_devices: Optional[int] = None, device="cuda") -> GridMesh:
    """A 1-D ``("data",)`` mesh for grid-sharded sweeps.

    On ``cuda`` (the default): cards 0 to ``num_devices - 1``, every visible
    card when ``num_devices`` is None; raises without CUDA (there is no CPU
    fallback).  ``device="cpu"``: ``num_devices`` shards on the one CPU
    device, as the reference's forced host device count gives; the count is
    required there.
    """
    device = resolve_device(device)
    if device.type == "cpu":
        if num_devices is None:
            raise ValueError("make_grid_mesh: device='cpu' needs num_devices (the shard count)")
        return GridMesh([device] * num_devices)
    visible = torch.cuda.device_count()
    n = visible if num_devices is None else num_devices
    if not 1 <= n <= visible:
        raise ValueError(f"make_grid_mesh: {n} cards asked for, {visible} visible")
    return GridMesh([torch.device("cuda", i) for i in range(n)])


def make_lm_mesh(model: Optional[int] = None, data: int = 1, device="cuda") -> LMMesh:
    """A ``(data, model)`` mesh of ranks for a sharded LM.

    On ``cuda`` (the default): cards 0 to ``data * model - 1``, a rank a card
    (``model`` defaults to every visible card); raises without CUDA, or when
    fewer cards are visible (no CPU fallback).  ``device="cpu"``: that many
    ranks on the CPU; ``model`` is required there.  ``data`` > 1 makes the
    mesh, but no sharded path takes it yet (ROADMAP A13).
    """
    device = resolve_device(device)
    if device.type == "cpu":
        if model is None:
            raise ValueError("make_lm_mesh: device='cpu' needs model (the rank count)")
        return LMMesh([[device] * model for _ in range(data)])
    visible = torch.cuda.device_count()
    model = visible // data if model is None else model
    if not 1 <= data * model <= visible:
        raise ValueError(f"make_lm_mesh: {data} x {model} cards asked for, {visible} visible")
    return LMMesh([[torch.device("cuda", r * model + c) for c in range(model)]
                   for r in range(data)])
