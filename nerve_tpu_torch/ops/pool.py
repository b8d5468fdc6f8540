"""Pooling in NHWC layout (counterpart of ``nerve_tpu/ops/pool.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average over H, W: (B, H, W, C) → (B, C)."""
    return x.mean(dim=(1, 2))


def avg_pool2d(x: torch.Tensor, window: int) -> torch.Tensor:
    """VALID window×window average pool with stride = window (flax
    ``nn.avg_pool`` as ``MotionEstimator`` calls it): odd sizes floor."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride=window)
    return y.permute(0, 2, 3, 1)
