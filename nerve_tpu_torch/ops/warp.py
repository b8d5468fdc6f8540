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

Under autograd the warp is a ``torch.autograd.Function`` (``_FlowWarp``),
the port of ``_flow_warp_diff``'s ``custom_vjp``: d/dflow is the vjp of the
forward with the features held constant (only the tent weights depend on
the flow), d/dfeatures the transpose of the gather, ``_features_grad``: each
output pixel's gradient times ``wy`` and ``wx``, each rounded to the feature
dtype and multiplied in float32 as ``_warp_bwd_features`` does, scattered
onto its four taps by ``index_add_`` in float32 and rounded once. The tent
differentiates as JAX does at its kinks: ``jnp.abs`` has gradient 1 at 0
(``torch.abs`` 0) and ``jnp.maximum`` ½ at a tie, which decide the gradient
at integer sample coordinates (a zero flow).
"""

from __future__ import annotations

import torch

from nerve_tpu_torch.ops import dispatch


def _abs(d: torch.Tensor) -> torch.Tensor:
    """|d| with ``jnp.abs``'s gradient: sign(d), and 1 at 0."""
    return torch.where(d >= 0, d, -d)


def _tent(coord: torch.Tensor, start: torch.Tensor):
    """The bilinear weights of the two integer taps ``start`` and ``start + 1``."""
    zero = coord.new_zeros(())
    return (torch.maximum(zero, 1.0 - _abs(coord - start)),
            torch.maximum(zero, 1.0 - _abs(coord - (start + 1.0))))


def _sampling(flow: torch.Tensor, h: int, w: int, dev):
    """Float32 sample coordinates (x, y) of a (B, H, W, 2) flow and the
    patches' clipped integer corners (xs, ys), as float32."""
    fl = flow.to(device=dev, dtype=torch.float32)
    x = torch.arange(w, dtype=torch.float32, device=dev) + fl[..., 0]
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + fl[..., 1]
    xs = torch.clamp(torch.floor(x.detach()), 0.0, float(w - 2))
    ys = torch.clamp(torch.floor(y.detach()), 0.0, float(h - 2))
    return x, y, xs, ys


def _corners(b: int, h: int, w: int, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Each patch's top-left pixel as a row of the (B·H·W, C) view."""
    base = torch.arange(b, device=xs.device)[:, None, None] * (h * w)
    return (base + ys.long() * w + xs.long()).reshape(-1)


def _warp(features: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    b, h, w, c = features.shape
    dt = features.dtype
    x, y, xs, ys = _sampling(flow, h, w, features.device)
    wx0, wx1 = _tent(x, xs)
    wy0, wy1 = _tent(y, ys)
    # Each patch is one (2, 2, C) block of an overlapping view of the rows.
    flat = features.reshape(b * h * w, c).contiguous()
    patches = flat.as_strided((b * h * w - w - 1, 2, 2, c), (c, w * c, c, 1))
    weights = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], dim=-1).to(dt)
    p00, p01, p10, p11 = (weights.reshape(-1, 4, 1)
                          * patches.index_select(0, _corners(b, h, w, xs, ys))
                          .reshape(-1, 4, c)).unbind(1)
    return (((p00 + p01) + p10) + p11).reshape(b, h, w, c)


def _features_grad(shape, dtype: torch.dtype, flow: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """d/dfeatures of the warp at the output gradient ``g``: the gather's
    transpose in float32, rounded once to ``dtype``."""
    b, h, w, c = shape
    x, y, xs, ys = _sampling(flow, h, w, g.device)
    wxs = [t.to(dtype).float().reshape(-1, 1) for t in _tent(x, xs)]
    wys = [t.to(dtype).float().reshape(-1, 1) for t in _tent(y, ys)]
    gf = g.float().reshape(-1, c)
    idx = _corners(b, h, w, xs, ys)
    acc = torch.zeros((b * h * w, c), dtype=torch.float32, device=g.device)
    for py, wy in enumerate(wys):
        for px, wx in enumerate(wxs):
            acc.index_add_(0, idx + (py * w + px), wy * (wx * gf))
    return acc.reshape(shape).to(dtype)


class _FlowWarp(torch.autograd.Function):
    """The warp with ``_fw_bwd``'s two gradients."""

    @staticmethod
    def forward(ctx, features, flow):
        ctx.save_for_backward(features, flow)
        return _warp(features, flow)

    @staticmethod
    def backward(ctx, g):
        features, flow = ctx.saved_tensors
        dfeat = dflow = None
        if ctx.needs_input_grad[0]:
            dfeat = _features_grad(features.shape, features.dtype, flow, g)
        if ctx.needs_input_grad[1]:
            (dflow,) = dispatch.recompute_vjp(lambda fl: _warp(features, fl), [flow], [True], g)
        return dfeat, dflow


def flow_warp(features: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W, C) features along a (B, H, W, 2) flow (dx, dy)."""
    _b, h, w, _c = features.shape
    if h < 2 or w < 2:
        raise ValueError(f"flow_warp needs H, W >= 2, got {h}x{w}")
    if dispatch.needs_grad(features, flow):
        return _FlowWarp.apply(features, flow)
    return _warp(features, flow)
