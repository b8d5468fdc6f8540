"""Frame recovery (inpainting) network, NHWC.

Counterpart of ``nerve_tpu/models/frame_recovery.py``: a spatial encoder
over the masked frame and its mask (7×7/2 stem, max pool, three residual
stages, CBAM; 16× down), a (2+1)D temporal encoder over the reference
frames (4× down, mean over time), a learned attention fusion of the two,
a decoder of four transposed 4×4/2 convolutions and a 3×3 conv + tanh, a
bilinear resize back to the frame where the decoder's size differs, and
the float32 mask blend ``frame · (1 - mask) + recovered · mask``.

Parameters carry the flax tree's names (``models.bridge``). Everything is
plain ATen/cuDNN, as the reference runs it on XLA, in the module's dtype
with flax's roundings (``models.layers.conv_nhwc``, ``batch_norm``); the
blend is float32. The model is built on the card unless the caller passes
``device="cpu"``.

In eval mode the forward runs under ``torch.inference_mode`` with every
BatchNorm on its running statistics. In training mode it runs under
autograd with every BatchNorm live (the stem's, the stage entries', the
residual blocks', the (2+1)D convolutions' over (B, T, H, W) and the
decoder's; ``layers.batch_norm_train``): each call moves the running
statistics, the module's buffers, to ``0.9 · old + 0.1 · batch``, as the
reference's ``apply(..., train=True, mutable=["batch_stats"])`` returns
them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from nerve_tpu_torch import ops
from nerve_tpu_torch.models.layers import (
    CBAM,
    BNParams,
    ConvParams,
    KernelParams,
    ResidualBlock,
    TemporalConv3D,
    conv_nhwc,
    conv_transpose_nhwc,
    grad_mode,
    norm,
)
from nerve_tpu_torch.models.super_resolution import resolve_device


class SpatialEncoder(nn.Module):
    """7×7/2 stem (padding 3) + BN + relu + 3×3/2 max pool, three stages of
    ``num_blocks`` residual blocks (stages 2 and 3 enter through a 1×1/2
    conv + BN), CBAM. Returns (features, skips)."""

    def __init__(self, in_channels: int, base_channels: int = 64, num_blocks: int = 2,
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.num_blocks = num_blocks
        kw = dict(device=device, generator=generator)
        bc = base_channels
        self.stem = KernelParams((7, 7, in_channels, bc), **kw)
        self.stem_bn = BNParams(bc, device)
        for name, cin, cout in (("stage1", bc, bc), ("stage2", bc, 2 * bc),
                                ("stage3", 2 * bc, 4 * bc)):
            if cin != cout:
                self.add_module(f"{name}_down", KernelParams((1, 1, cin, cout), **kw))
                self.add_module(f"{name}_down_bn", BNParams(cout, device))
            for i in range(num_blocks):
                self.add_module(f"{name}_block{i}", ResidualBlock(cout, dtype=dtype, **kw))
        self.attention = CBAM(4 * bc, dtype=dtype, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        dt = self.dtype
        x = conv_nhwc(x.to(dt), self.stem.kernel, stride=2, padding=3)
        x = ops.max_pool2d(torch.relu(norm(x, self.stem_bn, dt, self.training)), 3, 2, 1)
        skips = [x]
        for name, stride in (("stage1", 1), ("stage2", 2), ("stage3", 2)):
            if hasattr(self, f"{name}_down"):
                x = conv_nhwc(x, getattr(self, f"{name}_down").kernel, stride=stride)
                x = norm(x, getattr(self, f"{name}_down_bn"), dt, self.training)
            for i in range(self.num_blocks):
                x = getattr(self, f"{name}_block{i}")(x)
            if name != "stage3":
                skips.append(x)
        return self.attention(x), skips


class TemporalEncoder(nn.Module):
    """Three (2+1)D convolutions (64, 128, ``out_channels``) over (B, T, H,
    W, C), a (1, 2, 2) max pool after the first two, then the mean over T:
    (B, H/4, W/4, out_channels)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 256,
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = TemporalConv3D(in_channels, 64, **kw)
        self.conv2 = TemporalConv3D(64, 128, **kw)
        self.conv3 = TemporalConv3D(128, out_channels, **kw)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = ops.max_pool3d_spatial(self.conv1(frames))
        x = ops.max_pool3d_spatial(self.conv2(x))
        # The mean over T sums in float32, as jnp.mean does for bfloat16.
        return self.conv3(x).float().mean(dim=1).to(self.dtype)


class FusionModule(nn.Module):
    """The temporal features resized to the spatial ones (bilinear, as
    ``jax.image.resize`` without antialiasing), a 1×1 ``align`` of both, a
    softmax over two learned 1×1 attention logits weighting learned 1×1
    projections of each source, added to the aligned features, two
    residual blocks and CBAM."""

    def __init__(self, spatial_channels: int, temporal_channels: int, out_channels: int = 256,
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        oc = out_channels
        self.align = ConvParams(oc, (1, 1), spatial_channels + temporal_channels, **kw)
        self.attn0 = ConvParams(oc // 4, (1, 1), oc, **kw)
        self.attn1 = ConvParams(2, (1, 1), oc // 4, **kw)
        self.spatial_proj = KernelParams((1, 1, spatial_channels, oc), **kw)
        self.temporal_proj = KernelParams((1, 1, temporal_channels, oc), **kw)
        self.refine0 = ResidualBlock(oc, dtype=dtype, **kw)
        self.refine1 = ResidualBlock(oc, dtype=dtype, **kw)
        self.refine_cbam = CBAM(oc, dtype=dtype, **kw)

    def forward(self, spatial: torch.Tensor, temporal: torch.Tensor) -> torch.Tensor:
        if spatial.shape[1:3] != temporal.shape[1:3]:
            temporal = ops.resize_bilinear(temporal, spatial.shape[1:3])
        dt = self.dtype
        aligned = conv_nhwc(torch.cat([spatial, temporal], dim=-1).to(dt),
                            self.align.kernel, self.align.bias)
        a = torch.relu(conv_nhwc(aligned, self.attn0.kernel, self.attn0.bias))
        logits = conv_nhwc(a, self.attn1.kernel, self.attn1.bias)
        # jax.nn.softmax in the dtype: exp(x - max) over its sum, the max
        # held out of the gradient.
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
        attn = e / e.sum(dim=-1, keepdim=True)
        fused = (attn[..., 0:1] * conv_nhwc(spatial.to(dt), self.spatial_proj.kernel)
                 + attn[..., 1:2] * conv_nhwc(temporal.to(dt), self.temporal_proj.kernel))
        out = self.refine1(self.refine0(aligned + fused))
        return self.refine_cbam(out)


class Decoder(nn.Module):
    """Four transposed 4×4/2 convolutions (4, 2, 1, ½ × ``base_channels``
    wide), each with BN and relu (16× up), then a 3×3 conv and tanh. The
    transposed kernels stay flax's (4, 4, in, out)."""

    def __init__(self, in_channels: int, out_channels: int = 3, base_channels: int = 64,
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        bc = base_channels
        cin = in_channels
        for i, ch in enumerate([bc * 4, bc * 2, bc, bc // 2]):
            self.add_module(f"up{i + 1}", KernelParams((4, 4, cin, ch), **kw))
            self.add_module(f"up{i + 1}_bn", BNParams(ch, device))
            cin = ch
        self.final = ConvParams(out_channels, (3, 3), cin, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        for i in range(1, 5):
            x = conv_transpose_nhwc(x, getattr(self, f"up{i}").kernel)
            x = torch.relu(norm(x, getattr(self, f"up{i}_bn"), dt, self.training))
        return torch.tanh(conv_nhwc(x, self.final.kernel, self.final.bias, padding=1))


class FrameRecoveryNet(nn.Module):
    """Mask-conditioned frame recovery with temporal context.

    ``forward(corrupted (B, H, W, C), refs (B, T, H, W, C), mask (B, H, W,
    1) or None)`` → (B, H, W, C) float32, 1 in the mask marking corrupted
    pixels; pixels outside the mask are the input's, exactly. Under
    ``torch.inference_mode`` in eval mode, under autograd with live
    BatchNorm in training mode (see the module doc).
    """

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 temporal_window: int = 2, dtype: torch.dtype = torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.temporal_window = temporal_window
        self.dtype = dtype
        kw = dict(dtype=dtype, device=resolve_device(device), generator=generator)
        bc = base_channels
        self.spatial_encoder = SpatialEncoder(in_channels + 1, bc, **kw)
        self.temporal_encoder = TemporalEncoder(in_channels, 4 * bc, **kw)
        self.fusion = FusionModule(4 * bc, 4 * bc, 4 * bc, **kw)
        self.decoder = Decoder(4 * bc, in_channels, bc, **kw)

    def forward(self, corrupted: torch.Tensor, refs: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with grad_mode(self):
            return self._forward(corrupted, refs, mask)

    def _forward(self, corrupted: torch.Tensor, refs: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, h, w, _c = corrupted.shape
        if mask is None:
            mask = corrupted.new_zeros((b, h, w, 1))
        dt = self.dtype
        spatial, _skips = self.spatial_encoder(torch.cat([corrupted.to(dt), mask.to(dt)], -1))
        temporal = self.temporal_encoder(refs.to(dt))
        recovered = self.decoder(self.fusion(spatial, temporal)).float()
        if recovered.shape[1:3] != (h, w):
            recovered = ops.resize_bilinear(recovered, (h, w))
        mask32 = mask.float()
        return corrupted.float() * (1.0 - mask32) + recovered * mask32
