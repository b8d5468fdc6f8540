"""The enhancement pipeline: frame recovery → super-resolution → strength
blend (NHWC).

Counterpart of ``nerve_tpu/models/enhancement_engine.py``:

* ``EngineConfig`` with ``with_mode`` (the presets "full", "sr_only",
  "recovery_only", "lightweight"), plus ``sr_flow_downsample`` (the SR
  net's ``flow_downsample``; 1, the reference's, by default);
* ``EnhancementEngine``: recovery of the centre frame only when a mask is
  given (the other frames of the window are its references); the SR window
  clamp-gathered around the centre with the recovered frame in its centre
  slot; the flagship or lightweight SR net; the learned
  ``enhancement_strength``, clipped to [0, 1], blending the SR frame with
  the bicubic upscale of the original centre in float32;
  ``enhance_video`` over clamped windows, one frame at a time (memory
  O(window));
* ``AdaptiveEnhancementEngine``: a content-complexity head (8×8 adaptive
  pool, Dense 64, relu, Dense 1, sigmoid) mixing budget, preference and
  complexity into the strength; ``select_mode_for_budget``.

Parameters carry the flax names (``frame_recovery``, ``super_resolution``,
``enhancement_strength``; ``engine``, ``complexity_fc1``,
``complexity_fc2``), so ``models.bridge`` loads a flax tree strictly. The
SR net runs the port's kernels on the card; recovery is plain ATen/cuDNN.
Built on the card unless ``device="cpu"``.

In eval mode a call runs under ``torch.inference_mode``. ``.train()`` is
the reference's ``train=True``: the call runs under autograd, the recovery
net with live BatchNorm and the SR net's training forward (its kernel ops
as autograd Functions, its feature body on live BatchNorm; an int8 SR net
runs its chain sites in float and its RDB stack in int8, as the reference
does), and the BatchNorm running statistics move.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from nerve_tpu_torch import ops
from nerve_tpu_torch.models.frame_recovery import FrameRecoveryNet
from nerve_tpu_torch.models.layers import DenseParams, grad_mode
from nerve_tpu_torch.models.super_resolution import (
    LightweightSuperResolution,
    SuperResolutionNet,
    resolve_device,
)

MODES = {
    "full": dict(frame_recovery_enabled=True, super_resolution_enabled=True,
                 use_lightweight_sr=False),
    "recovery_only": dict(frame_recovery_enabled=True, super_resolution_enabled=False),
    "sr_only": dict(frame_recovery_enabled=False, super_resolution_enabled=True,
                    use_lightweight_sr=False),
    "lightweight": dict(frame_recovery_enabled=False, super_resolution_enabled=True,
                        use_lightweight_sr=True),
}


@dataclass(frozen=True)
class EngineConfig:
    """The pipeline's static configuration."""

    frame_recovery_enabled: bool = True
    recovery_base_channels: int = 64
    recovery_temporal_window: int = 2

    super_resolution_enabled: bool = True
    scale_factor: int = 2
    sr_num_features: int = 64
    sr_num_residual_blocks: int = 8
    sr_temporal_window: int = 1
    sr_flow_downsample: int = 1

    use_lightweight_sr: bool = False
    # int8 serving of the flagship SR net (models.quantize.quantize_engine).
    sr_quantized: bool = False
    sr_quantized_chains: bool = False
    enhancement_mode: str = "sequential"

    def with_mode(self, mode: str) -> "EngineConfig":
        """The config under one of the mode presets (``MODES``)."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        return dataclasses.replace(self, **MODES[mode])

    @property
    def window(self) -> int:
        """Frames of ``enhance_video``'s window: 2 · max(recovery, SR window) + 1."""
        return 2 * max(self.recovery_temporal_window, self.sr_temporal_window) + 1


class EnhancementEngine(nn.Module):
    """Recovery → SR over a temporal window (see module doc).

    ``forward(frames (B, T, H, W, C), center_idx=None, corruption_mask=None
    (B, H, W, 1), enhancement_strength=None)`` → dict with ``enhanced``
    (B, sH, sW, C) float32, and ``recovered`` / ``super_resolved`` where
    those stages ran. ``recovery=False`` builds no recovery net even where
    the config enables it (the adaptive engine, which never passes a mask);
    a masked call then raises.
    """

    def __init__(self, config: EngineConfig = EngineConfig(),
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None, recovery: bool = True):
        super().__init__()
        self.config = cfg = config
        self.dtype = dtype
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev, generator=generator)
        if cfg.frame_recovery_enabled and recovery:
            self.frame_recovery = FrameRecoveryNet(
                base_channels=cfg.recovery_base_channels,
                temporal_window=cfg.recovery_temporal_window, **kw)
        if cfg.super_resolution_enabled:
            if cfg.use_lightweight_sr:
                self.super_resolution = LightweightSuperResolution(
                    scale_factor=cfg.scale_factor, **kw)
            else:
                self.super_resolution = SuperResolutionNet(
                    scale_factor=cfg.scale_factor, num_features=cfg.sr_num_features,
                    num_residual_blocks=cfg.sr_num_residual_blocks,
                    temporal_window=cfg.sr_temporal_window,
                    flow_downsample=cfg.sr_flow_downsample, quantized=cfg.sr_quantized,
                    quantized_chains=cfg.sr_quantized_chains, **kw)
        self.enhancement_strength = nn.Parameter(torch.ones(1, device=dev))

    def forward(self, frames: torch.Tensor, center_idx: Optional[int] = None,
                corruption_mask: Optional[torch.Tensor] = None,
                enhancement_strength=None) -> Dict[str, torch.Tensor]:
        with grad_mode(self):
            return self._forward(frames, center_idx, corruption_mask, enhancement_strength)

    def _forward(self, frames, center_idx, corruption_mask, enhancement_strength):
        cfg = self.config
        b, t, h, w, c = frames.shape
        if center_idx is None:
            center_idx = t // 2
        results: Dict[str, torch.Tensor] = {}
        current = frames[:, center_idx]
        recovered = cfg.frame_recovery_enabled and corruption_mask is not None
        if recovered:
            if not hasattr(self, "frame_recovery"):
                raise ValueError("this engine was built without a recovery net: "
                                 "it takes no corruption mask")
            ref_idx = [i for i in range(t) if i != center_idx] or [center_idx]
            current = self.frame_recovery(current, frames[:, ref_idx], corruption_mask)
            results["recovered"] = current
        if cfg.super_resolution_enabled:
            if cfg.use_lightweight_sr:
                sr_out = self.super_resolution(current)
            else:
                sw = cfg.sr_temporal_window
                idx = torch.arange(center_idx - sw, center_idx + sw + 1).clamp_(0, t - 1)
                sr_frames = frames[:, idx.tolist()]
                if recovered:
                    sr_frames = sr_frames.clone()
                    sr_frames[:, sw] = current
                sr_out = self.super_resolution(sr_frames)
            results["super_resolved"] = sr_out
            current = sr_out
        strength = (self.enhancement_strength if enhancement_strength is None
                    else enhancement_strength)
        strength = torch.as_tensor(strength, dtype=torch.float32,
                                   device=frames.device).clamp(0.0, 1.0)
        if cfg.super_resolution_enabled:
            bicubic = ops.resize_bicubic(frames[:, center_idx], current.shape[1:3])
            current = strength * current + (1.0 - strength) * bicubic.float()
        results["enhanced"] = current
        return results

    def enhance_video(self, video: torch.Tensor, corruption_masks: Optional[torch.Tensor] = None,
                      frame_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                      ) -> torch.Tensor:
        """Every frame of (B, T, H, W, C) → (B, T, sH, sW, C): frame t is the
        centre of the clamp-gathered window t - half .. t + half (``window``
        frames), with its mask ``corruption_masks[:, t]`` (B, T, H, W, 1).
        ``frame_fn`` maps each output frame as it comes (``to_uint8`` keeps
        the stacked result small)."""
        t = video.shape[1]
        half = self.config.window // 2
        outs = []
        with grad_mode(self):
            for tc in range(t):
                idx = torch.arange(tc - half, tc + half + 1).clamp_(0, t - 1).tolist()
                mask = None if corruption_masks is None else corruption_masks[:, tc]
                out = self._forward(video[:, idx], half, mask, None)["enhanced"]
                outs.append(out if frame_fn is None else frame_fn(out))
            return torch.stack(outs, dim=1)


class AdaptiveEnhancementEngine(nn.Module):
    """The engine (without a recovery net: it runs mask-free) beside a
    content-complexity estimator; ``forward(frames, resource_budget,
    user_quality_preference)`` blends at strength 0.3 · budget + 0.3 · pref
    + 0.4 · mean(complexity), clipped to [0.3, 1]. The mode for a budget is
    the caller's choice (``select_mode_for_budget``), made before the
    forward."""

    def __init__(self, config: EngineConfig = EngineConfig(),
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None, in_channels: int = 3):
        super().__init__()
        self.config = config
        self.dtype = dtype
        dev = resolve_device(device)
        self.engine = EnhancementEngine(config, dtype, dev, generator, recovery=False)
        self.complexity_fc1 = DenseParams(64, 8 * 8 * in_channels, dev, generator)
        self.complexity_fc2 = DenseParams(1, 64, dev, generator)

    def estimate_complexity(self, frame: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, 1) complexity in [0, 1], float32."""
        with grad_mode(self):
            return self._complexity(frame)

    def _complexity(self, frame: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = ops.adaptive_avg_pool2d(frame.to(dt), 8)
        y = torch.relu(self.complexity_fc1(y.reshape(y.shape[0], -1), dt))
        return torch.sigmoid(self.complexity_fc2(y, dt)).float()

    def forward(self, frames: torch.Tensor, resource_budget: float = 1.0,
                user_quality_preference: float = 0.5) -> Dict[str, torch.Tensor]:
        with grad_mode(self):
            return self._forward(frames, resource_budget, user_quality_preference)

    def _forward(self, frames, resource_budget, user_quality_preference):
        complexity = self._complexity(frames[:, frames.shape[1] // 2])
        strength = (0.3 * torch.tensor(resource_budget, dtype=torch.float32)
                    + 0.3 * torch.tensor(user_quality_preference, dtype=torch.float32)
                    ).to(frames.device) + 0.4 * complexity.mean()
        strength = strength.clamp(0.3, 1.0)
        results = self.engine(frames, None, None, strength)
        results["complexity"] = complexity
        results["enhancement_strength"] = strength
        return results

    def enhance_video(self, video: torch.Tensor, corruption_masks=None, frame_fn=None):
        """The engine's whole-video path at its own strength."""
        return self.engine.enhance_video(video, corruption_masks, frame_fn)


def select_mode_for_budget(resource_budget: float) -> str:
    """The mode for a resource budget (thresholds 0.3 and 0.6)."""
    if resource_budget < 0.3:
        return "lightweight"
    if resource_budget < 0.6:
        return "sr_only"
    return "full"
