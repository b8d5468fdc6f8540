"""Channel-first model facade (counterpart of ``nerve_tpu/models/api.py``).

The port's models are NHWC ``nn.Module``s; these wrappers keep the
reference's public surface and tensor contracts:

* ``SuperResolutionNet(...)``: ``(B, T, C, H, W) → (B, C, sH, sW)``,
  ``forward_single``, ``get_num_parameters``, ``get_flops``;
  ``LightweightSuperResolution``: ``(B, C, H, W) → (B, C, sH, sW)``;
* ``FrameRecoveryNet``: (B, C, H, W), (B, T, C, H, W), mask (B, 1, H, W);
* ``EnhancementEngine(config)``: the result dict channel-first,
  ``enhance_video(..., as_uint8)``, ``get_model_info``,
  ``set_enhancement_mode`` (submodules that match by name and shape keep
  their weights), ``quantize_int8(calib_video, chains)``;
* ``AdaptiveEnhancementEngine``: ``adaptive_forward`` (the mode picked by
  the budget first), ``estimate_complexity``;
* ``to_uint8``, ``from_uint8`` and ``count_params``.

Inputs may be numpy arrays or tensors. uint8 frames are scaled by 1/255 on
the device; masks never are. Every class takes ``device`` (default
``"cuda"``, which raises without a card; ``"cpu"`` runs the plain
versions) and ``dtype`` (default float32, the reference's; the card serves
bfloat16); fresh weights come from a ``torch.Generator`` seeded by
``seed``. ``load_variables`` loads a flax variable tree (numpy leaves)
through ``models.bridge``, strictly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from nerve_tpu_torch.models import enhancement_engine as _engine
from nerve_tpu_torch.models import frame_recovery as _fr
from nerve_tpu_torch.models import super_resolution as _sr
from nerve_tpu_torch.models.bridge import load_flax_variables
from nerve_tpu_torch.models.quantize import quantize_engine

EnhancementConfig = _engine.EngineConfig


def _tensor(x, device) -> torch.Tensor:
    t = torch.as_tensor(x).to(device)
    return t.float() if t.dtype == torch.float64 else t


def from_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 → float32 ``x / 255``, divided where x lies, as the reference
    divides (on the card a Python-number divisor would be a multiply by its
    reciprocal, which rounds some values otherwise)."""
    return x.float() / torch.full((), 255.0, device=x.device)


def _frames_nhwc(x, device) -> torch.Tensor:
    """Frames (..., C, H, W) → (..., H, W, C) in [0, 1] on ``device``;
    uint8 scaled by 1/255 there, floats as they are (float64 as float32)."""
    t = _tensor(x, device)
    if t.dtype == torch.uint8:
        t = from_uint8(t)
    return t.movedim(-3, -1)


def _to_nhwc(x, device) -> torch.Tensor:
    """(..., C, H, W) → (..., H, W, C) on ``device``, values unchanged (masks)."""
    return _tensor(x, device).movedim(-3, -1)


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, -3)


def to_uint8(frames) -> torch.Tensor:
    """[0, 1] frames (any layout) → uint8, rounded half to even and clipped,
    where they lie."""
    x = torch.as_tensor(frames).float()
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)


def count_params(module: nn.Module) -> int:
    """Parameters of ``module`` (BatchNorm statistics and int8 state are not)."""
    return int(sum(p.numel() for p in module.parameters()))


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _merge_matching(new: nn.Module, old: nn.Module) -> None:
    """Copy every tensor of ``old`` into ``new`` where name, shape and dtype match."""
    old_state = old.state_dict()
    state = new.state_dict()
    with torch.no_grad():
        for k, t in state.items():
            o = old_state.get(k)
            if o is not None and o.shape == t.shape and o.dtype == t.dtype:
                t.copy_(o)


class _Facade:
    module: nn.Module
    device: torch.device

    def get_num_parameters(self) -> int:
        return count_params(self.module)

    def load_variables(self, variables) -> None:
        """Load a flax variable tree (numpy leaves) into the module, strictly."""
        load_flax_variables(self.module, variables)


class SuperResolutionNet(_Facade):
    """Channel-first wrapper of the flagship SR net."""

    def __init__(self, in_channels: int = 3, scale_factor: int = 2, num_features: int = 64,
                 num_residual_blocks: int = 8, temporal_window: int = 1,
                 flow_downsample: int = 1, dtype: torch.dtype = torch.float32, seed: int = 0,
                 device="cuda"):
        self.scale_factor = scale_factor
        self.temporal_window = temporal_window
        self.num_frames = 2 * temporal_window + 1
        self.device = _sr.resolve_device(device)
        self.module = _sr.SuperResolutionNet(
            in_channels, scale_factor, num_features, num_residual_blocks, temporal_window,
            flow_downsample, dtype=dtype, device=self.device,
            generator=_generator(seed)).eval()

    def __call__(self, lr_frames) -> torch.Tensor:
        """(B, T, C, H, W) → (B, C, sH, sW) in [0, 1]."""
        return _to_nchw(self.module(_frames_nhwc(lr_frames, self.device)))

    def forward_single(self, lr_frame) -> torch.Tensor:
        """(B, C, H, W) → (B, C, sH, sW): the frame repeated across the window."""
        x = torch.as_tensor(lr_frame)
        return self(x[:, None].expand(x.shape[0], self.num_frames, *x.shape[1:]))

    def get_flops(self, input_size=(128, 128)) -> int:
        return _sr.estimate_sr_flops(input_size, num_frames=self.num_frames,
                                     scale_factor=self.scale_factor)


class LightweightSuperResolution(_Facade):
    """Channel-first wrapper of the lightweight SR net."""

    def __init__(self, scale_factor: int = 2, dtype: torch.dtype = torch.float32,
                 seed: int = 0, device="cuda"):
        self.scale_factor = scale_factor
        self.device = _sr.resolve_device(device)
        self.module = _sr.LightweightSuperResolution(
            scale_factor=scale_factor, dtype=dtype, device=self.device,
            generator=_generator(seed)).eval()

    def __call__(self, x) -> torch.Tensor:
        """(B, C, H, W) → (B, C, sH, sW) in [0, 1]."""
        return _to_nchw(self.module(_frames_nhwc(x, self.device)))


class FrameRecoveryNet(_Facade):
    """Channel-first wrapper of the recovery net."""

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 temporal_window: int = 2, dtype: torch.dtype = torch.float32, seed: int = 0,
                 device="cuda"):
        self.temporal_window = temporal_window
        self.device = _sr.resolve_device(device)
        self.module = _fr.FrameRecoveryNet(in_channels, base_channels, temporal_window,
                                           dtype=dtype, device=self.device,
                                           generator=_generator(seed)).eval()

    def __call__(self, corrupted_frame, reference_frames, corruption_mask=None) -> torch.Tensor:
        """(B, C, H, W), (B, T, C, H, W), (B, 1, H, W) → (B, C, H, W) float32."""
        mask = None if corruption_mask is None else _to_nhwc(corruption_mask, self.device)
        return _to_nchw(self.module(_frames_nhwc(corrupted_frame, self.device),
                                    _frames_nhwc(reference_frames, self.device), mask))


class EnhancementEngine(_Facade):
    """Channel-first wrapper of the enhancement engine.

    One set of weights: a mode switch (``set_enhancement_mode``) builds the
    new mode's module and keeps every tensor whose name and shape match.
    """

    def __init__(self, config: Optional[_engine.EngineConfig] = None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.config = config or _engine.EngineConfig()
        self.dtype = dtype
        self.device = _sr.resolve_device(device)
        self._seed = seed
        self.module: Optional[nn.Module] = None
        self._build()

    def _make(self) -> nn.Module:
        return _engine.EnhancementEngine(self.config, self.dtype, self.device,
                                         _generator(self._seed))

    def _build(self) -> None:
        fresh = self._make().eval()
        if self.module is not None:
            _merge_matching(fresh, self.module)
        self.module = fresh

    @property
    def engine(self) -> nn.Module:
        """The ``models.enhancement_engine.EnhancementEngine`` that runs."""
        return self.module

    def __call__(self, frames, center_idx: Optional[int] = None, corruption_mask=None,
                 enhancement_strength: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """(B, T, C, H, W) [+ mask (B, 1, H, W)] → dict of (B, C, H', W')."""
        strength = (None if enhancement_strength is None
                    else torch.tensor([enhancement_strength], dtype=torch.float32))
        mask = None if corruption_mask is None else _to_nhwc(corruption_mask, self.device)
        out = self.engine(_frames_nhwc(frames, self.device), center_idx, mask, strength)
        return {k: _to_nchw(v) for k, v in out.items()}

    def enhance_video(self, video, corruption_masks=None, batch_size: int = 4,
                      as_uint8: bool = False) -> torch.Tensor:
        """(T, C, H, W) or (B, T, C, H, W) [+ masks (T, 1, H, W) or (B, T, 1,
        H, W)] → the enhanced video in the same layout. ``batch_size`` is
        taken for the reference's signature: frames run one window at a
        time. ``as_uint8`` rounds each frame to uint8 on the device as it
        comes."""
        del batch_size
        v = torch.as_tensor(video)
        squeeze = v.dim() == 4
        if squeeze:
            v = v[None]
        masks = None
        if corruption_masks is not None:
            m = torch.as_tensor(corruption_masks)
            masks = _to_nhwc(m[None] if m.dim() == 4 else m, self.device)
        out = self.module.enhance_video(_frames_nhwc(v, self.device), masks,
                                        to_uint8 if as_uint8 else None)
        out = _to_nchw(out)
        return out[0] if squeeze else out

    def get_model_info(self) -> Dict[str, Any]:
        cfg = self.config
        eng = self.engine
        total = count_params(self.module)
        info: Dict[str, Any] = {
            "config": {
                "frame_recovery_enabled": cfg.frame_recovery_enabled,
                "super_resolution_enabled": cfg.super_resolution_enabled,
                "scale_factor": cfg.scale_factor,
                "use_lightweight_sr": cfg.use_lightweight_sr,
            },
            "parameters": {"total": total, "trainable": total},
        }
        for name in ("frame_recovery", "super_resolution"):
            if hasattr(eng, name):
                info["parameters"][name] = count_params(getattr(eng, name))
        return info

    def set_enhancement_mode(self, mode: str) -> None:
        self.config = self.config.with_mode(mode)
        self._build()

    def quantize_int8(self, calib_video, chains: bool = True) -> None:
        """Serve the flagship SR net in int8: the RDB stack, and with
        ``chains`` its five conv-chain sites too. ``calib_video`` (T, C, H,
        W) or (B, T, C, H, W): the engine's window of its first frames runs
        once, with a zero mask where recovery is on; each int8 site takes
        its scales from what it is fed there
        (``models.quantize.quantize_engine``)."""
        cfg = self.config
        if not cfg.super_resolution_enabled or cfg.use_lightweight_sr:
            raise ValueError("int8 serving quantises the full SuperResolutionNet; enable "
                             "super-resolution (mode 'full'/'sr_only') first")
        self.config = dataclasses.replace(cfg, sr_quantized=True, sr_quantized_chains=chains)
        self._build()
        v = torch.as_tensor(calib_video)
        if v.dim() == 4:
            v = v[None]
        x = _frames_nhwc(v[:, :self.config.window], self.device)
        mask = x.new_zeros(x.shape[:1] + x.shape[2:4] + (1,)) \
            if self.config.frame_recovery_enabled else None
        quantize_engine(self.module, x, mask, device=self.device)


class AdaptiveEnhancementEngine(EnhancementEngine):
    """Channel-first wrapper of the adaptive engine: the resource budget
    picks the mode (``select_mode_for_budget``) before the forward, the
    content complexity sets the strength."""

    def _make(self) -> nn.Module:
        return _engine.AdaptiveEnhancementEngine(self.config, self.dtype, self.device,
                                                 _generator(self._seed))

    @property
    def engine(self) -> nn.Module:
        return self.module.engine

    def estimate_complexity(self, frame) -> torch.Tensor:
        """(B, C, H, W) → (B, 1) complexity in [0, 1]."""
        return self.module.estimate_complexity(_frames_nhwc(frame, self.device))

    def adaptive_forward(self, frames, resource_budget: float = 1.0,
                         user_quality_preference: float = 0.5) -> Dict[str, torch.Tensor]:
        mode = _engine.select_mode_for_budget(resource_budget)
        if self.config.with_mode(mode) != self.config:
            self.config = self.config.with_mode(mode)
            self._build()
        out = self.module(_frames_nhwc(frames, self.device), resource_budget,
                          user_quality_preference)
        return {k: _to_nchw(v) if v.dim() >= 3 else v for k, v in out.items()}

    def __call__(self, frames, resource_budget: float = 1.0,
                 user_quality_preference: float = 0.5):
        return self.adaptive_forward(frames, resource_budget, user_quality_preference)
