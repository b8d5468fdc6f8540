"""Typed configuration tree of nerve_tpu_torch.

A copy of ``nerve_tpu/config/schema.py``, which imports no framework: the
same frozen dataclasses with the same defaults (those of the JAX package's
``default.yaml``), built from nested dicts with dotted-path overrides. The
port keeps its own copy, since it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Tuple


# --------------------------------------------------------------------------- #
# Project / hardware
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ProjectConfig:
    name: str = "nerve-tpu"
    version: str = "0.1.0"
    seed: int = 42
    # 'tpu' | 'cpu' — jax platform preference (reference: cuda/cpu/mps,
    # default.yaml:9). On TPU pods, mesh config below governs layout.
    platform: str = "tpu"


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (no analogue in the single-device reference).

    Axes:
      data    — batch/data parallelism for all training loops.
      client  — federated-simulation axis; FedAvg = weighted psum over it.
      model   — reserved for spatial (halo-sharded conv) parallelism at 4K+.
    """

    data: int = -1  # -1: all remaining devices
    client: int = 1
    model: int = 1


# --------------------------------------------------------------------------- #
# Models  (reference: default.yaml:12-32, EnhancementConfig
#          nerve_cl/models/enhancement_engine.py:18-37)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class FrameRecoveryConfig:
    enabled: bool = True
    base_channels: int = 64
    temporal_window: int = 2
    use_attention: bool = True


@dataclass(frozen=True)
class SuperResolutionConfig:
    enabled: bool = True
    scale_factor: int = 2
    num_features: int = 64
    num_residual_blocks: int = 8
    temporal_window: int = 1
    use_temporal: bool = True


@dataclass(frozen=True)
class EnhancementConfig:
    """Pipeline config — parity with EnhancementConfig
    (nerve_cl/models/enhancement_engine.py:18-37)."""

    mode: str = "sequential"  # sequential | parallel
    upscale_first: bool = False
    use_lightweight_sr: bool = False


@dataclass(frozen=True)
class ModelConfig:
    frame_recovery: FrameRecoveryConfig = field(default_factory=FrameRecoveryConfig)
    super_resolution: SuperResolutionConfig = field(default_factory=SuperResolutionConfig)
    enhancement: EnhancementConfig = field(default_factory=EnhancementConfig)
    # Compute dtype for the conv stacks ('bfloat16' | 'float32'); params stay f32.
    compute_dtype: str = "bfloat16"


# --------------------------------------------------------------------------- #
# Training  (reference: default.yaml:35-59, train_baseline.py argparse)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class LossConfig:
    pixel_loss: float = 1.0
    perceptual_loss: float = 0.0
    temporal_loss: float = 0.0
    pixel_loss_type: str = "mse"  # mse | l1 | charbonnier


@dataclass(frozen=True)
class AugmentationConfig:
    random_crop: bool = True
    crop_size: int = 256
    random_flip: bool = True
    random_rotate: bool = False
    color_jitter: float = 0.1


@dataclass(frozen=True)
class TrainingConfig:
    epochs: int = 100
    batch_size: int = 16
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    optimizer: str = "adamw"  # adamw | adam | sgd
    scheduler: str = "cosine"  # cosine | constant
    warmup_epochs: int = 5
    grad_clip_norm: float = 0.0  # 0 disables
    losses: LossConfig = field(default_factory=LossConfig)
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)


# --------------------------------------------------------------------------- #
# Continual learning  (reference: default.yaml:62-87)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class MemoryConfig:
    capacity: int = 1000
    strategy: str = "reservoir"  # reservoir | fifo | stratified | importance | diversity
    recency_weight: float = 0.3  # StreamingEpisodicMemory only


@dataclass(frozen=True)
class EWCConfig:
    lam: float = 5000.0
    mode: str = "online"  # online | separate
    decay: float = 0.999
    fisher_samples: int = 200


@dataclass(frozen=True)
class MAMLConfig:
    inner_lr: float = 0.01
    outer_lr: float = 1e-3
    inner_steps: int = 5
    first_order: bool = True


@dataclass(frozen=True)
class DistillationConfig:
    enabled: bool = True
    temperature: float = 4.0
    alpha: float = 0.5


@dataclass(frozen=True)
class ContinualConfig:
    enabled: bool = True
    strategy: str = "ewc_replay"  # ewc | replay | maml | ewc_replay | si
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    ewc: EWCConfig = field(default_factory=EWCConfig)
    maml: MAMLConfig = field(default_factory=MAMLConfig)
    distillation: DistillationConfig = field(default_factory=DistillationConfig)


# --------------------------------------------------------------------------- #
# Federated learning  (reference: default.yaml:90-114)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class PrivacyConfig:
    """Parity with nerve_cl/federated/privacy.py:14-20."""

    enabled: bool = True
    mechanism: str = "dp-sgd"
    epsilon: float = 8.0
    delta: float = 1e-5
    max_grad_norm: float = 1.0
    noise_multiplier: float = 1.0


@dataclass(frozen=True)
class ClusteringConfig:
    enabled: bool = True
    num_clusters: int = 8
    method: str = "kmeans"
    update_frequency: int = 10


@dataclass(frozen=True)
class FederatedConfig:
    enabled: bool = True
    num_clients: int = 100
    clients_per_round: int = 10
    min_fit_clients: int = 2
    num_rounds: int = 100
    local_epochs: int = 5
    aggregation: str = "fedavg"  # fedavg | fedprox
    fedprox_mu: float = 0.01
    server_address: str = "[::]:8080"
    keep_last_versions: int = 5
    privacy: PrivacyConfig = field(default_factory=PrivacyConfig)
    clustering: ClusteringConfig = field(default_factory=ClusteringConfig)


# --------------------------------------------------------------------------- #
# ABR  (reference: default.yaml:117-152, ABRConfig nerve_cl/abr/agent.py:12-21)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class QualityLevelConfig:
    resolution: int
    bitrate: float  # kbps


DEFAULT_QUALITY_LADDER: Tuple[QualityLevelConfig, ...] = (
    QualityLevelConfig(360, 365.0),
    QualityLevelConfig(480, 750.0),
    QualityLevelConfig(720, 1500.0),
    QualityLevelConfig(1080, 3000.0),
    QualityLevelConfig(1440, 6000.0),
)


@dataclass(frozen=True)
class ABRAgentConfig:
    hidden_dims: Tuple[int, ...] = (256, 256)
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_ratio: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    update_epochs: int = 10
    max_grad_norm: float = 0.5


@dataclass(frozen=True)
class ABRRewardConfig:
    quality_weight: float = 1.0
    rebuffer_weight: float = 10.0
    smoothness_weight: float = 0.1
    battery_weight: float = 0.1


@dataclass(frozen=True)
class ABRConfig:
    enabled: bool = True
    algorithm: str = "ppo"
    quality_ladder: Tuple[QualityLevelConfig, ...] = DEFAULT_QUALITY_LADDER
    upscale_factors: Tuple[float, ...] = (1.0, 1.5, 2.0, 3.0)
    agent: ABRAgentConfig = field(default_factory=ABRAgentConfig)
    reward: ABRRewardConfig = field(default_factory=ABRRewardConfig)


# --------------------------------------------------------------------------- #
# Data  (reference: default.yaml:155-192, scripts/download_data.sh:25-41)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class DegradationConfig:
    noise_sigma_range: Tuple[float, float] = (5.0, 25.0)
    blur_kernel_range: Tuple[int, int] = (3, 7)
    downscale_range: Tuple[float, float] = (0.25, 0.5)


@dataclass(frozen=True)
class DataConfig:
    fps: int = 30
    segment_length: int = 4
    chunk_size: int = 16
    data_dir: str = "data"
    synthetic_train_samples: int = 500
    synthetic_val_samples: int = 100
    lr_size: int = 64
    degradation: DegradationConfig = field(default_factory=DegradationConfig)


# --------------------------------------------------------------------------- #
# Metrics / MLOps / logging / checkpoint  (reference: default.yaml:194-253)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class MetricsConfig:
    quality: Tuple[str, ...] = ("psnr", "ssim", "ms_ssim", "vmaf")
    temporal: Tuple[str, ...] = ("tOF", "tLP")
    system: Tuple[str, ...] = ("latency", "throughput")


@dataclass(frozen=True)
class DriftDetectionConfig:
    enabled: bool = True
    method: str = "mmd"  # mmd | ks | psi
    threshold: float = 0.05
    window_size: int = 1000


@dataclass(frozen=True)
class ABTestingConfig:
    enabled: bool = True
    canary_percentage: float = 5.0
    evaluation_period: float = 24.0


@dataclass(frozen=True)
class MLOpsConfig:
    tracking_backend: str = "jsonl"  # jsonl | prometheus
    experiment_name: str = "nerve-tpu"
    log_interval: int = 100
    prometheus_port: int = 8000
    monitoring_enabled: bool = False
    ab_testing: ABTestingConfig = field(default_factory=ABTestingConfig)
    drift_detection: DriftDetectionConfig = field(default_factory=DriftDetectionConfig)


@dataclass(frozen=True)
class LoggingConfig:
    level: str = "INFO"
    save_dir: str = "logs"


@dataclass(frozen=True)
class CheckpointConfig:
    save_dir: str = "checkpoints"
    save_frequency: int = 5
    keep_last_n: int = 3
    save_best: bool = True
    best_metric: str = "psnr"


# --------------------------------------------------------------------------- #
# Root
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Config:
    project: ProjectConfig = field(default_factory=ProjectConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    continual: ContinualConfig = field(default_factory=ContinualConfig)
    federated: FederatedConfig = field(default_factory=FederatedConfig)
    abr: ABRConfig = field(default_factory=ABRConfig)
    data: DataConfig = field(default_factory=DataConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    mlops: MLOpsConfig = field(default_factory=MLOpsConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)


# --------------------------------------------------------------------------- #
# Construction from nested dicts / YAML
# --------------------------------------------------------------------------- #


def _coerce(ftype: Any, value: Any) -> Any:
    """Coerce a YAML value into the declared dataclass field type."""
    origin = getattr(ftype, "__origin__", None)
    if is_dataclass(ftype) and isinstance(value, dict):
        return _from_dict(ftype, value)
    if origin is tuple and isinstance(value, (list, tuple)):
        args = ftype.__args__
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(args[0], v) for v in value)
        return tuple(_coerce(t, v) for t, v in zip(args, value))
    if ftype is float and isinstance(value, (int, float)):
        return float(value)
    if ftype is int and isinstance(value, float) and value.is_integer():
        return int(value)
    return value


def _from_dict(cls: Any, data: dict) -> Any:
    kwargs = {}
    valid = {f.name: f for f in fields(cls)}
    for key, value in data.items():
        if key not in valid:
            raise KeyError(
                f"Unknown config key '{key}' for {cls.__name__}; "
                f"valid keys: {sorted(valid)}"
            )
        kwargs[key] = _coerce(_resolve_type(cls, key), value)
    return cls(**kwargs)


def _resolve_type(cls: Any, name: str) -> Any:
    import typing

    hints = typing.get_type_hints(cls)
    return hints[name]


def config_from_dict(data: dict) -> Config:
    """Build a Config from a nested dict (e.g. parsed YAML)."""
    return _from_dict(Config, data or {})


def config_to_dict(cfg: Any) -> Any:
    """Inverse of config_from_dict (for round-tripping / logging)."""
    if is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, tuple):
        return [config_to_dict(v) for v in cfg]
    return cfg


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Apply dotted-path overrides, e.g. {'training.batch_size': 8}."""
    data = config_to_dict(cfg)
    for path, value in overrides.items():
        node = data
        *parents, leaf = path.split(".")
        for p in parents:
            node = node[p]
        if leaf not in node:
            raise KeyError(f"Unknown config path '{path}'")
        node[leaf] = value
    return config_from_dict(data)
