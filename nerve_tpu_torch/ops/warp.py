"""Backward warping of feature maps by optical flow (NHWC).

Counterpart of ``nerve_tpu/ops/warp.py``: output pixel (x, y) samples the
features at (x + dx, y + dy) in pixel coordinates, bilinearly, with zeros
outside the image. That is ``F.grid_sample(mode="bilinear",
padding_mode="zeros", align_corners=True)`` on the grid of pixel
coordinates plus flow, normalised to [-1, 1]. The grid is built, and the
sampling done, in float32: a bfloat16 grid cannot address a 1920-pixel row
(its spacing near 1 is 2⁻⁸, several pixels). The JAX package used an XLA
gather here, not a Pallas kernel, so this is plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def flow_warp(features: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W, C) features along a (B, H, W, 2) flow (dx, dy)."""
    b, h, w, c = features.shape
    if h < 2 or w < 2:
        raise ValueError(f"flow_warp needs H, W >= 2, got {h}x{w}")
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=flow.device),
        torch.arange(w, dtype=torch.float32, device=flow.device),
        indexing="ij",
    )
    fl = flow.float()
    grid = torch.stack(
        [2.0 * (gx + fl[..., 0]) / (w - 1) - 1.0,
         2.0 * (gy + fl[..., 1]) / (h - 1) - 1.0],
        dim=-1,
    )
    out = F.grid_sample(features.permute(0, 3, 1, 2).float(), grid,
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1).to(features.dtype)
