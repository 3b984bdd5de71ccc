"""Non-iid data partitioning across CAV clients (``repro.fl.partition``).

Each client owns ``classes_per_client`` of the 10 classes, chosen by its
home road region (geographic non-iid) when ``regions`` is given.  Dirichlet
mode (``FLConfig.dirichlet_alpha > 0``) draws each client's class
proportions from Dirichlet(alpha) instead (``prng.dirichlet``, JAX's draw)
and its labels from them (``prng.categorical``), whatever the regions.  Class
prototypes are shared across clients; sample noise is per client.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.data.synthetic import class_prototypes, dataset_spec
from repro_torch.utils import prng


def client_class_sets(key, num_clients: int, num_classes: int, k: int, device):
    """(C, k) class ids owned per client (uniform random assignment)."""
    ks = prng.split(prng.fold_in_str(key, "class-sets"), num_clients)
    return prng.permutation(ks, num_classes, device)[:, :k]


def geographic_class_sets(regions: torch.Tensor, num_classes: int, k: int):
    """(C, k): the client in region r owns classes r, r+1, ... mod num_classes."""
    r = regions.to(torch.int64)[:, None]
    return torch.remainder(r + torch.arange(k, device=regions.device)[None, :], num_classes)


def partition_labels(key, dataset: str, cfg: FLConfig, regions=None, device="cpu"):
    """(C, n) int64 per-client sample labels."""
    spec = dataset_spec(dataset)
    C, n = cfg.num_clients, cfg.samples_per_client
    kd = prng.fold_in_str(key, f"data/{dataset}")
    if cfg.dirichlet_alpha > 0:
        alphas = torch.full((spec.num_classes,), cfg.dirichlet_alpha, dtype=torch.float32,
                            device=device)
        props = prng.dirichlet(prng.fold_in_str(kd, "dirichlet"), alphas, (C,), device)
        kl = prng.split(prng.fold_in_str(kd, "labels"), C)
        return prng.categorical(kl, torch.log(props + 1e-9), (n,), device)
    k = max(min(cfg.classes_per_client, spec.num_classes), 1)
    if regions is not None:
        own = geographic_class_sets(regions.to(device), spec.num_classes, k)
    else:
        own = client_class_sets(kd, C, spec.num_classes, k, device)
    kl = prng.split(prng.fold_in_str(kd, "labels"), C)
    pick = prng.randint(kl, (n,), 0, k, device)
    return torch.gather(own, 1, pick)


def client_images(key, dataset: str, labels: torch.Tensor) -> torch.Tensor:
    """(C, n, H, W, ch) images: shared prototypes + per-client noise."""
    spec = dataset_spec(dataset)
    C, n = labels.shape
    device = labels.device
    kd = prng.fold_in_str(key, f"data/{dataset}")
    protos = class_prototypes(kd, spec, device)
    kn = prng.split(prng.fold_in_str(kd, "noise"), C)
    noise = spec.noise * prng.normal(kn, (n, *spec.shape), device)
    return protos[labels] + noise


def client_sample_counts(labels: torch.Tensor) -> torch.Tensor:
    """(C,) f32 usable-sample counts (negative labels mark padding)."""
    return (labels >= 0).sum(dim=1).to(torch.float32)


def rsu_sample_mass(weights: torch.Tensor, rid: torch.Tensor, n_rsu: int) -> torch.Tensor:
    """(R,) per-RSU aggregation mass: the weights summed by attachment;
    ``(G, K)`` weights and ids give each lane's ``(G, R)``.

    The JAX package scatter-adds; here it is the column sum of the one-hot
    ``(K, R)`` routing matrix, a fixed order on every device (a float
    ``index_add_`` on CUDA adds in another order on each run).  An id
    outside ``[0, R)`` contributes nothing.  Sample counts are
    integer-valued, so the per-RSU masses sum to the flat sum exactly.
    """
    onehot = rid.to(torch.int64)[..., :, None] == torch.arange(n_rsu, device=rid.device)
    return (onehot.to(torch.float32) * weights.to(torch.float32)[..., :, None]).sum(dim=-2)


def partition_clients(key, dataset: str, cfg: FLConfig, regions=None, device="cpu"):
    """(images (C, n, H, W, ch), labels (C, n)) for all C clients."""
    labels = partition_labels(key, dataset, cfg, regions, device)
    return client_images(key, dataset, labels), labels


def shard_local_rows(data_idx, n_shards: int):
    """Plan shard-local RoundData placement for a sharded grid.

    ``data_idx``: (G,) global de-duplicated row index per grid lane, G a
    multiple of ``n_shards`` (the engine pads first); lanes go to shards in
    contiguous runs.  Returns

      * ``shard_rows`` (n_shards, M) int32: the global rows each shard
        builds, M the most unique rows any shard's lanes read (a shard that
        reads fewer repeats its first row);
      * ``local_idx`` (G,) int32: each lane's row as an index into its
        shard's M rows.

    Host-side numpy, known when the grid is built; equal to the reference's
    ``repro.fl.partition.shard_local_rows``.
    """
    didx = np.asarray(data_idx, np.int32)
    G = didx.shape[0]
    if G % n_shards:
        raise ValueError(f"shard_local_rows: {G} lanes do not split into {n_shards} shards")
    per = G // n_shards
    locals_ = [list(dict.fromkeys(didx[s * per:(s + 1) * per].tolist()))
               for s in range(n_shards)]
    M = max(len(r) for r in locals_)
    shard_rows = np.stack([np.asarray(r + [r[0]] * (M - len(r)), np.int32) for r in locals_])
    local_idx = np.empty((G,), np.int32)
    for s, rows in enumerate(locals_):
        pos = {g: i for i, g in enumerate(rows)}
        local_idx[s * per:(s + 1) * per] = [pos[g] for g in didx[s * per:(s + 1) * per].tolist()]
    return shard_rows, local_idx


def make_test_set(key, dataset: str, n_test: int = 2_000, device="cpu"):
    """Global iid test set with the same shared prototypes."""
    spec = dataset_spec(dataset)
    kd = prng.fold_in_str(key, f"data/{dataset}")
    protos = class_prototypes(kd, spec, device)
    kt = prng.fold_in_str(kd, "test")
    labels = prng.randint(prng.fold_in_str(kt, "labels"), (n_test,), 0,
                          spec.num_classes, device)
    noise = spec.noise * prng.normal(prng.fold_in_str(kt, "noise"),
                                     (n_test, *spec.shape), device)
    return protos[labels] + noise, labels
