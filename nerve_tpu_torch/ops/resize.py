"""Bicubic and bilinear upsampling and resizing, NHWC.

Counterpart of ``nerve_tpu/ops/resize.py``. For an integer scale s every
output phase p has fixed taps: output ``s*k + p`` samples source
``k + (p + 0.5)/s - 0.5``, so each phase is a weighted sum of statically
shifted, edge-padded copies of the input (edge padding reproduces torch's
index clamping). Bicubic uses A = -0.75, torch's coefficient. The
``*_channels`` variants return the s² phases as channels in PixelShuffle
order without the final depth-to-space, so the SR epilogue adds its
residual before one interleave. Arithmetic stays in the input dtype, in
the reference's order. ``resize_bicubic`` to any other size gathers 4
taps per axis in float32 (indices clamped to the frame).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops.pixel_shuffle import pixel_shuffle

_A = -0.75


def _cubic_w(d: float) -> float:
    a = _A
    d = abs(d)
    if d <= 1.0:
        return (a + 2.0) * d**3 - (a + 3.0) * d**2 + 1.0
    return a * d**3 - 5.0 * a * d**2 + 8.0 * a * d - 4.0 * a


def _phase_taps(s: int, kind: str) -> List[Tuple[int, List[float]]]:
    """Static (first-tap offset, weights) per output phase for upscale by s."""
    out = []
    for p in range(s):
        f = (p + 0.5) / s - 0.5
        x0 = math.floor(f)
        t = f - x0
        if kind == "cubic":
            out.append((x0 - 1, [_cubic_w(t + 1.0), _cubic_w(t),
                                 _cubic_w(1.0 - t), _cubic_w(2.0 - t)]))
        else:
            out.append((x0, [1.0 - t, t]))
    return out


def _edge_pad(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    n = x.shape[dim]
    idx = torch.arange(-pad, n + pad, device=x.device).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def _upsample_axis_phases(x: torch.Tensor, dim: int, s: int, kind: str):
    """List of s phase tensors (same shape as x) along ``dim``."""
    pad = 2 if kind == "cubic" else 1
    xp = _edge_pad(x, dim, pad)
    n = x.shape[dim]
    phases = []
    for off, ws in _phase_taps(s, kind):
        acc = None
        for j, wj in enumerate(ws):
            # The weight is rounded to the input dtype first, as the reference
            # does with jnp.asarray(wj, x.dtype).
            wt = float(torch.tensor(wj, dtype=x.dtype))
            term = xp.narrow(dim, pad + off + j, n) * wt
            acc = term if acc is None else acc + term
        phases.append(acc)
    return phases


def _upsample_channels(x: torch.Tensor, scale: int, kind: str) -> torch.Tensor:
    """(B, H, W, C) → (B, H, W, C*s²) phase channels (PixelShuffle order)."""
    rows = _upsample_axis_phases(x, 1, scale, kind)
    grid = [_upsample_axis_phases(r, 2, scale, kind) for r in rows]  # [py][px]
    stacked = torch.stack([p for row in grid for p in row], dim=-1)  # (B,H,W,C,s²)
    b, h, w, c = x.shape
    return stacked.reshape(b, h, w, c * scale * scale)


def upsample_bicubic_channels(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bicubic (A=-0.75) upscale in pre-shuffle phase-channel space."""
    return _upsample_channels(x, scale, "cubic")


def upsample_bilinear_channels(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear upscale in pre-shuffle phase-channel space."""
    return _upsample_channels(x, scale, "linear")


def resize_bilinear(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C), half-pixel centres, no antialiasing.

    An equal integer upscale on both axes uses the phase formulation above;
    any other size goes through ``F.interpolate`` in float32, which samples
    as ``jax.image.resize(method="linear", antialias=False)`` does.
    """
    b, h, w, c = x.shape
    oh, ow = out_hw
    if oh % h == 0 and ow % w == 0 and oh // h == ow // w and oh > h:
        return pixel_shuffle(upsample_bilinear_channels(x, oh // h), oh // h)
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(oh, ow),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _cubic_contribs(in_size: int, out_size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-pixel 4-tap indices (clamped) and float32 weights along
    one axis: half-pixel centres, taps x0 - 1 .. x0 + 2."""
    scale = in_size / out_size
    x = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    x0 = torch.floor(x)
    t = x - x0
    d = torch.stack([t + 1.0, t, 1.0 - t, 2.0 - t], dim=-1).abs()
    a = _A
    near = (a + 2.0) * d**3 - (a + 3.0) * d**2 + 1.0
    far = a * d**3 - 5.0 * a * d**2 + 8.0 * a * d - 4.0 * a
    w = torch.where(d <= 1.0, near, far)
    idx = x0.long()[:, None] + torch.arange(-1, 3, device=device)[None, :]
    return idx.clamp_(0, in_size - 1), w


def _interp_axis(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    n = x.shape[dim]
    if n == out_size:
        return x
    idx, w = _cubic_contribs(n, out_size, x.device)
    taps = x.index_select(dim, idx.reshape(-1))
    shape = list(x.shape)
    shape[dim:dim + 1] = [out_size, 4]
    wshape = [1] * len(shape)
    wshape[dim], wshape[dim + 1] = out_size, 4
    return (taps.reshape(shape) * w.reshape(wshape)).sum(dim + 1)


def resize_bicubic(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """Bicubic (A = -0.75, torch's) resize of (B, H, W, C) to (B, oh, ow, C).

    An equal integer upscale on both axes takes the phase route
    (``upsample_bicubic_channels`` and one depth-to-space); any other size
    4 taps per axis in float32, H first, cast back to x's dtype.
    """
    b, h, w, c = x.shape
    oh, ow = out_hw
    if oh % h == 0 and ow % w == 0 and oh // h == ow // w and oh > h:
        return pixel_shuffle(upsample_bicubic_channels(x, oh // h), oh // h)
    y = _interp_axis(x.float(), 1, oh)
    return _interp_axis(y, 2, ow).to(x.dtype)
