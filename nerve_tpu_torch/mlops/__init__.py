"""MLOps layer (counterpart of ``nerve_tpu/mlops``): drift detection (the
MMD on a torch device), A/B testing and monitoring export."""

from nerve_tpu_torch.mlops.drift import DriftDetector, DriftResult, ModelDriftMonitor  # noqa: F401
from nerve_tpu_torch.mlops.ab_testing import ABTestManager, ExperimentConfig  # noqa: F401
from nerve_tpu_torch.mlops.monitoring import MetricsExporter, TrainingLogger  # noqa: F401
