"""Pooling in NHWC / NTHWC layout (counterpart of ``nerve_tpu/ops/pool.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average over H, W: (B, H, W, C) → (B, C)."""
    return x.mean(dim=(1, 2))


def avg_pool2d(x: torch.Tensor, window: int) -> torch.Tensor:
    """VALID window×window average pool with stride = window (flax
    ``nn.avg_pool`` as ``MotionEstimator`` calls it): odd sizes floor."""
    return _nhwc(F.avg_pool2d(_nchw(x), window, stride=window))


def max_pool2d(x: torch.Tensor, window: int = 3, stride: int = 2,
               padding: int = 1) -> torch.Tensor:
    """Max pool over H, W of (B, H, W, C), padded with -inf (torch
    ``MaxPool2d`` semantics, the reference's ``reduce_window``)."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride=stride, padding=padding))


def max_pool3d_spatial(x: torch.Tensor) -> torch.Tensor:
    """(1, 2, 2) VALID max pool of (B, T, H, W, C) → (B, T, H/2, W/2, C);
    odd sizes floor."""
    b, t, h, w, c = x.shape
    y = max_pool2d(x.reshape(b * t, h, w, c), 2, 2, 0)
    return y.reshape(b, t, *y.shape[1:])


def adaptive_avg_pool2d(x: torch.Tensor, output_size: int) -> torch.Tensor:
    """Adaptive average pool of (B, H, W, C) to (output_size, output_size):
    bin i spans [floor(i·H/o), ceil((i+1)·H/o)), torch's boundaries, also
    when H or W is not a multiple of o. Sums in float32, result in x's dtype."""
    y = F.adaptive_avg_pool2d(_nchw(x).float(), output_size)
    return _nhwc(y).to(x.dtype)
