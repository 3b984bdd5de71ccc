"""The four-stage contextual client-selection pipeline (``repro.core.pipeline``).

``ContextualSelector`` owns the server-side state of the pipeline: the last
fused RTTG, per-client update sketches (with their age in rounds, for the
deadline rule) and the current clustering.  Per FL round:

  observe(twin_state)  -> fuse CAM/CPM into an RTTG            (stage 1)
  predicted_latency    -> propagate + latency model             (stage 2)
  report_update(s)     -> refresh clients' gradient sketches    (stage 3 in)
  recluster()          -> cosine k-means over the sketches      (stage 3)
  select(strategy,...) -> Fast-gamma / baselines                (stage 4)

The same object serves the four baseline strategies, so every paradigm sees
the same fusion and prediction.  Keys follow the JAX package's tree: the
selector key is ``fold_in_str(key, "selector")``, each round's key
``fold_in(selector key, round)``, and from it ``"observe"``, ``"cr"``,
``"kmeans"`` and the strategy's name.  The state tensors live on the
selector's device, the keys on the host.  The ``TrafficConfig`` is lifted
once, as the reference's selector rounds it (``scenarios.traffic_params``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import FLConfig, TrafficConfig
from repro_torch.core.clustering import kmeans_cluster, update_sketch
from repro_torch.core.fusion import fuse_messages
from repro_torch.core.messages import emit_cams, emit_cpms
from repro_torch.core.network import connectivity, latency_model
from repro_torch.core.rttg import RTTG
from repro_torch.core.scenarios import traffic_params
from repro_torch.core.selection import select_clients
from repro_torch.core.trajectory import predict_rttg
from repro_torch.core.twin import TwinState
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


class ContextualSelector:
    """Runs on ``cuda`` unless ``device="cpu"`` is passed; raises when CUDA
    is asked for and no card is present."""

    def __init__(self, fl_cfg: FLConfig, traffic_cfg: TrafficConfig, key: torch.Tensor,
                 device="cuda"):
        self.fl = fl_cfg
        self.traffic = traffic_cfg
        self.device = resolve_device(device)
        self.params = traffic_params(traffic_cfg, self.device)
        self.key = prng.fold_in_str(key, "selector")
        N = fl_cfg.num_clients
        f32 = dict(dtype=torch.float32, device=self.device)
        self.sketches = torch.zeros((N, fl_cfg.sketch_dim), **f32)
        self.sketch_age = torch.full((N,), torch.inf, **f32)  # rounds since report
        self.clusters = torch.zeros((N,), dtype=torch.int64, device=self.device)
        self.rttg: Optional[RTTG] = None
        self._round = 0

    def _round_key(self) -> torch.Tensor:
        return prng.fold_in(self.key, self._round)

    def _need_rttg(self, what: str) -> None:
        if self.rttg is None:
            raise RuntimeError(f"ContextualSelector: observe() before {what}()")

    # ---- stage 1: V2X fusion -------------------------------------------
    def observe(self, twin_state: TwinState) -> RTTG:
        k = prng.fold_in_str(self._round_key(), "observe")
        tr = self.params
        self.rttg = fuse_messages(emit_cams(twin_state, tr, k), emit_cpms(twin_state, tr, k),
                                  twin_state.t, tr)
        return self.rttg

    # ---- stage 2: prediction + latency ---------------------------------
    def predicted_latency(self, model_bytes: float, horizon_s: Optional[float] = None):
        self._need_rttg("predicted_latency")
        h = self.traffic.predict_horizon_s if horizon_s is None else horizon_s
        future = predict_rttg(self.rttg, h, self.params)
        return latency_model(future, model_bytes, self.params), future

    def connected_mask(self, rttg: RTTG) -> torch.Tensor:
        k = prng.fold_in_str(self._round_key(), "cr")
        return connectivity(rttg, self.params, self.fl.connection_rate, k)

    # ---- stage 3: data-level grouping ----------------------------------
    def report_update(self, client_id: int, update_vec: torch.Tensor) -> None:
        """Deadline rule: clients that report before the next recluster get
        fresh sketches; the others keep stale ones (their age grows)."""
        self.report_updates(torch.tensor([client_id]), update_vec[None])

    def report_updates(self, client_ids, update_vecs: torch.Tensor) -> None:
        ids = torch.as_tensor(client_ids, device=self.device).to(torch.int64)
        sks = update_sketch(update_vecs.to(self.device), self.key, self.fl.sketch_dim)
        self.sketches = self.sketches.index_put((ids,), sks)
        self.sketch_age = self.sketch_age.index_put((ids,), torch.zeros_like(sks[:, 0]))

    def recluster(self) -> None:
        k = prng.fold_in_str(self._round_key(), "kmeans")
        self.clusters, _ = kmeans_cluster(self.sketches, k, self.fl.num_clusters)

    # ---- stage 4: selection ---------------------------------------------
    def select(self, strategy: str, model_bytes: float) -> dict:
        """Stages 2 + 4 for the current round: the participation mask and the
        intermediate signals (for logging)."""
        self._need_rttg("select")
        k = self._round_key()
        tr, fl = self.params, self.fl
        mb = torch.tensor(float(model_bytes), dtype=torch.float32, device=self.device)
        future = predict_rttg(self.rttg, tr.predict_horizon_s, tr)
        lat_pred = latency_model(future, mb, tr)
        connected = connectivity(future, tr, fl.connection_rate, prng.fold_in_str(k, "cr"))
        mask = select_clients(strategy, prng.fold_in_str(k, strategy), connected, lat_pred,
                              self.clusters, fl.n_select, fl.gamma)
        return {"mask": mask, "connected": connected, "latency_pred": lat_pred,
                "future_rttg": future, "n_select": fl.n_select}

    def end_round(self) -> None:
        self.sketch_age = self.sketch_age + 1.0
        self._round += 1
        if self._round % max(self.fl.recluster_every, 1) == 0:
            self.recluster()
