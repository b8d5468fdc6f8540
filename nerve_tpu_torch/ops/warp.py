"""Backward warping of feature maps by optical flow (NHWC).

Counterpart of ``nerve_tpu/ops/warp.py`` (``_warp_rows``, its unchunked
path): output pixel (x, y) samples the features at (x + dx, y + dy) in
pixel coordinates, bilinearly, with zeros outside the image. The sampler is
the reference's four-tap tent: the coordinates are float32 (the flow cast
up first), the 2 × 2 patch starts at their floor clipped to
``[0, W - 2] × [0, H - 2]``, and each tap is weighted
``max(0, 1 − |coord − tap|)``, which is zero for a tap the clip pushed
inside and for a sample wholly outside the image. The dtype contract is the
reference's: the weight products ``wy · wx`` are taken in float32 and
rounded to the feature dtype, and the four products and their sum are in
the feature dtype, ``((w00·p00 + w01·p01) + w10·p10) + w11·p11``. The JAX
package used an XLA gather here, not a Pallas kernel, so this is plain
PyTorch on both devices: each 2 × 2 patch is gathered as one block of an
overlapping view of the rows and weighted in one op.
"""

from __future__ import annotations

import torch


def _tent(coord: torch.Tensor, start: torch.Tensor):
    """The bilinear weights of the two integer taps ``start`` and ``start + 1``."""
    return (torch.clamp(1.0 - (coord - start).abs(), min=0.0),
            torch.clamp(1.0 - (coord - (start + 1.0)).abs(), min=0.0))


def flow_warp(features: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W, C) features along a (B, H, W, 2) flow (dx, dy)."""
    b, h, w, c = features.shape
    if h < 2 or w < 2:
        raise ValueError(f"flow_warp needs H, W >= 2, got {h}x{w}")
    dev, dt = features.device, features.dtype
    fl = flow.to(device=dev, dtype=torch.float32)
    x = torch.arange(w, dtype=torch.float32, device=dev) + fl[..., 0]
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + fl[..., 1]
    xs = torch.clamp(torch.floor(x), 0.0, float(w - 2))
    ys = torch.clamp(torch.floor(y), 0.0, float(h - 2))
    wx0, wx1 = _tent(x, xs)
    wy0, wy1 = _tent(y, ys)
    # The patch's top-left pixel as a row of the (B·H·W, C) view; each patch
    # is one (2, 2, C) block of an overlapping view of the rows.
    base = torch.arange(b, device=dev)[:, None, None] * (h * w)
    idx = (base + ys.long() * w + xs.long()).reshape(-1)
    flat = features.reshape(b * h * w, c).contiguous()
    patches = flat.as_strided((b * h * w - w - 1, 2, 2, c), (c, w * c, c, 1))
    weights = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], dim=-1).to(dt)
    p00, p01, p10, p11 = (weights.reshape(-1, 4, 1)
                          * patches.index_select(0, idx).reshape(-1, 4, c)).unbind(1)
    return (((p00 + p01) + p10) + p11).reshape(b, h, w, c)
