"""Configuration dataclasses of the port.

Own copies of the JAX package's ``ModelConfig``, ``FLConfig``,
``TrafficConfig``, ``TrainConfig`` and ``ShapeConfig`` (field for field, same
defaults:
the paper's section IV-A setting for ``FLConfig`` and ``TrafficConfig``).
The port imports nothing of the JAX package, so these are kept in step with
``repro.config`` by the tests, which compare the fields and defaults.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (``repro.config.ModelConfig``), every field.

    The FL image models and the LM zoo share it, as in the reference; the
    fields a family does not read keep their defaults.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | cnn | mlp
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    router_aux_loss: float = 0.01

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # --- attention flavour ---
    rope_theta: float = 10_000.0
    rope_style: str = "full"  # full | 2d | none
    sliding_window: int = 0  # 0 => full attention
    layer_pattern: Tuple[str, ...] = ()
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qkv_bias: bool = False
    max_position_embeddings: int = 131_072
    kv_repeat: int = 1
    embed_scale: bool = False
    zero_centered_norm: bool = False
    attn_block_q: int = 512

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0

    # --- VLM (internvl2) ---
    num_image_tokens: int = 0

    # --- hybrid (hymba) ---
    hybrid_parallel: bool = False

    # --- CNN/MLP (the paper's own FL models) ---
    image_shape: Tuple[int, int, int] = (0, 0, 0)
    num_classes: int = 0
    channels: Tuple[int, ...] = ()

    # --- numerics / misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    remat_policy: str = "minimal"  # kept for the configs; no remat in the port
    scan_layers: bool = True
    loss_chunk: int = 512
    train_microbatches: int = 1
    serve_fsdp: bool = False
    sharding_profile: str = "tp"
    variant: str = ""
    source: str = ""  # citation for the assigned config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def layer_kind(self, i: int) -> str:
        """Attention flavour of layer ``i`` ('full', 'local', 'global')."""
        if not self.layer_pattern:
            return "local" if self.sliding_window else "full"
        return self.layer_pattern[i % len(self.layer_pattern)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training-step hyperparameters of the LM zoo (``repro.config.TrainConfig``)."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | sgd | momentum
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


INPUT_SHAPES: dict = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class TrafficConfig:
    """Digital-twin road / radio model (``repro.config.TrafficConfig``)."""

    num_vehicles: int = 100
    ring_length_m: float = 10_000.0
    num_lanes: int = 3
    rsu_spacing_m: float = 1_000.0
    mean_speed_mps: float = 14.0
    speed_std_mps: float = 6.0
    accel_std: float = 0.8
    ou_theta: float = 0.3
    cam_rate_hz: float = 10.0
    carrier_ghz: float = 5.9
    bandwidth_hz: float = 8e6
    eirp_dbm: float = 33.0
    noise_dbm: float = -95.0
    snr_min_db: float = 3.0
    backhaul_s: float = 0.010
    queue_s_per_vehicle: float = 0.010
    overhead_bytes: int = 2_048
    sim_dt_s: float = 0.1
    predict_horizon_s: float = 5.0
    rush_amp: float = 0.0
    rush_period_s: float = 900.0
    rsu_outage_frac: float = 0.0
    platoon_size: int = 4
    platoon_coupling: float = 0.0
    platoon_gap_m: float = 25.0
    compute_lognorm_std: float = 0.35
    fleet_truck_frac: float = 0.0
    fleet_bus_frac: float = 0.0
    fleet_truck_factor: float = 1.0
    fleet_bus_factor: float = 1.0
    day_amp: float = 0.0
    day_period_s: float = 7_200.0
    day_harmonic2: float = 0.0


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning round configuration (``repro.config.FLConfig``).

    Every field of the reference is kept, so configs convert one to one;
    the lanes this port does not run yet (``hierarchical``, ``client_block``,
    bfloat16) are refused by ``fl.rounds.make_round_step``.  Every
    registered aggregator runs, with its ``server_*`` hyperparameters,
    ``fedprox_mu`` and the fedbuff ring's ``buffer_size`` / ``buffer_fill``.
    """

    num_clients: int = 100
    select_fraction: float = 0.10
    local_epochs: int = 1
    batch_size: int = 64
    learning_rate: float = 1e-3
    strategy: str = "contextual"
    num_clusters: int = 10
    gamma: float = 0.10
    sketch_dim: int = 1024
    connection_rate: float = 1.0
    classes_per_client: int = 2
    dirichlet_alpha: float = 0.0
    samples_per_client: int = 512
    compute_s_per_epoch: float = 0.5
    server_agg_s: float = 0.05
    round_timeout_s: float = 15.0
    recluster_every: int = 5
    aggregator: str = "fedavg"
    server_lr: float = 1.0
    server_beta1: float = 0.9
    server_beta2: float = 0.99
    server_tau: float = 1e-3
    fedprox_mu: float = 0.0
    hierarchical: bool = False
    client_block: int = 0
    buffer_size: int = 8
    buffer_fill: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    seed: int = 0

    SUPPORTED_DTYPES = ("float32", "bfloat16")

    def __post_init__(self):
        if self.round_timeout_s <= 0:
            raise ValueError(
                "round_timeout_s must be positive: the staleness discount "
                "timeout / (timeout + lateness) degenerates to 0/0 = NaN at "
                f"a non-positive deadline, got {self.round_timeout_s!r}"
            )
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {self.buffer_size!r}")
        if self.buffer_fill < 1:
            raise ValueError(f"buffer_fill must be >= 1, got {self.buffer_fill!r}")
        for name in ("param_dtype", "compute_dtype"):
            value = getattr(self, name)
            if value not in self.SUPPORTED_DTYPES:
                raise ValueError(
                    f"unknown {name} {value!r}; supported dtypes: "
                    f"{', '.join(self.SUPPORTED_DTYPES)}"
                )

    @property
    def n_select(self) -> int:
        """Per-round selection budget (the paper's 10% rate, at least 1)."""
        return max(int(round(self.select_fraction * self.num_clients)), 1)
