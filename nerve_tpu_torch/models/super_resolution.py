"""The SR networks (NHWC).

Counterpart of ``SuperResolutionNet`` with its parts and of
``LightweightSuperResolution`` in ``nerve_tpu/models/super_resolution.py``.
``SuperResolutionNet``: batched feature extraction → flow
estimation and warp of every neighbour toward the centre → attention
aggregation → residual dense blocks → global fusion + centre skip →
upsampler conv + bicubic base in phase-channel space → clamp [0, 1] → one
depth-to-space. Input (B, T, H, W, C) with T = 2·temporal_window + 1.

``LightweightSuperResolution`` is single-frame: one BN-folded chain (head
3×3, four depthwise-separable blocks, tail 3×3) through
``ops.conv_chain_apply``, then the same bicubic epilogue; in training mode
its blocks run one after another on live BatchNorm.

The kernel ops are called through the ``ops`` namespace
(``ops.conv_chain_apply``, ``ops.correlation_volume``,
``ops.rdb_chain_apply``, ``ops.depth_to_space_packed``, and for int8
serving ``ops.conv_chain_int8_apply`` and ``ops.rdb_chain_int8_apply``): on
CUDA tensors they run the hand-written kernels.

int8 serving (``quantized``: the RDB stack; ``quantized_chains``: the
feature head, flow head, attention logits, gff and upsampler convs) reads
static scales from buffers that ``models.quantize.quantize_sr`` calibrates
or ``models.bridge`` loads from the JAX ``"quant"`` collection. In
training mode the chain sites run their float layers and the RDB stack
stays int8 (a constant under autograd), as in the reference.

``SuperResolutionNet`` also trains: in ``model.train()`` its forward runs
under autograd, the feature body's three depthwise-separable blocks one
after another with live BatchNorm (as the reference's ``train=True``), and
the kernel ops as ``torch.autograd.Function``s (kernels forward, the vjp of
their plain versions backward; ``ops.dispatch``). Its eval forward runs
under ``torch.inference_mode``, or under autograd with the BatchNorm
statistics held where the caller passes ``differentiable=True`` (the
losses of ``nerve_tpu_torch.continual``). The epilogue's clamp is
``minimum(maximum(·, 0), 1)``, ``jnp.clip``'s gradient of ½ at a bound.

The models are built on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from nerve_tpu_torch import ops
from nerve_tpu_torch.models.layers import (
    CBAM,
    ConvParams,
    DepthwiseSeparableConv,
    PixelShuffleUpsampler,
    QuantizableConv,
    QuantState,
    add_chain_quant,
    maybe_quantized_chain,
    normal_param,
    zeros_param,
)
from nerve_tpu_torch.ops import rdb_int8

OUTPUT_LAYOUTS = ("nhwc", "planar", "packed")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


class FeatureExtractor(nn.Module):
    """Conv head + 3 depthwise-separable blocks with a residual."""

    def __init__(self, in_channels: int = 3, num_features: int = 64,
                 dtype: torch.dtype = torch.float32, chain_quant: str = "off",
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.head = ConvParams(num_features, (3, 3), in_channels, device=device,
                               generator=generator)
        for i in range(3):
            self.add_module(f"body{i}", DepthwiseSeparableConv(
                num_features, num_features, device, generator, dtype=dtype))
        add_chain_quant(self, "qhead", [self.head.entry("relu")], chain_quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = maybe_quantized_chain(self, "qhead", x.to(self.dtype),
                                     [self.head.entry("relu")], self.chain_quant)
        body = feat
        for i in range(3):
            body = getattr(self, f"body{i}")(body)
        return body + feat


def _epilogue(bicubic_ch: torch.Tensor, residual_ch: torch.Tensor, scale: int,
              dtype: torch.dtype, output_layout: str) -> torch.Tensor:
    """Bicubic base + residual in phase-channel space, clamped to [0, 1] in
    float32 (float64 for a float64 model), cast to ``dtype``, then one
    depth-to-space into the layout."""
    ct = torch.promote_types(residual_ch.dtype, torch.float32)
    summed = bicubic_ch.to(ct) + residual_ch.to(ct)
    out_ch = torch.minimum(torch.maximum(summed, summed.new_zeros(())),
                           summed.new_ones(())).to(dtype)
    if output_layout == "planar":
        return ops.pixel_shuffle_planar(out_ch, scale)
    if output_layout == "packed":
        return ops.depth_to_space_packed(out_ch, scale)
    return ops.pixel_shuffle(out_ch, scale)


class MotionEstimator(nn.Module):
    """Correlation volume → 4-conv flow head → (dx, dy) flow.

    ``downsample`` > 1 estimates flow on a ``downsample``² average-pooled
    grid and upsamples it bilinearly, scaling its magnitude.
    """

    def __init__(self, max_displacement: int = 4, downsample: int = 1,
                 dtype: torch.dtype = torch.float32, chain_quant: str = "off",
                 device=None, generator=None):
        super().__init__()
        self.max_displacement = max_displacement
        self.downsample = downsample
        self.dtype = dtype
        nd = (2 * max_displacement + 1) ** 2
        kw = dict(device=device, generator=generator)
        self.flow0 = ConvParams(128, (3, 3), nd, **kw)
        self.flow1 = ConvParams(64, (3, 3), 128, **kw)
        self.flow2 = ConvParams(32, (3, 3), 64, **kw)
        # Zero-initialised last layer: warping starts as the identity.
        self.flow3 = ConvParams(2, (3, 3), 32, zero_init=True, **kw)
        add_chain_quant(self, "qflow", self.entries(), chain_quant)

    def entries(self):
        return [self.flow0.entry("relu"), self.flow1.entry("relu"),
                self.flow2.entry("relu"), self.flow3.entry("none")]

    def forward(self, feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
        ds = self.downsample
        _b, h, w, _c = feat1.shape
        if ds > 1:
            feat1, feat2 = ops.avg_pool2d(feat1, ds), ops.avg_pool2d(feat2, ds)
        corr = ops.correlation_volume(feat1, feat2, self.max_displacement).to(self.dtype)
        flow = maybe_quantized_chain(self, "qflow", corr, self.entries(), self.chain_quant)
        if ds > 1:
            flow = ops.resize_bilinear(flow, (h, w)) * float(ds)
        return flow


class TemporalAggregator(nn.Module):
    """Softmax-over-T attention fusion of T aligned frames + CBAM refinement."""

    def __init__(self, num_features: int = 64, num_frames: int = 3,
                 dtype: torch.dtype = torch.float32, chain_quant: str = "off",
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        f, t = num_features, num_frames
        self.attn0 = ConvParams(f, (3, 3), t * f, **kw)
        self.attn1 = ConvParams(f, (3, 3), f, **kw)
        self.attn2 = ConvParams(t, (3, 3), f, **kw)
        self.refine = CBAM(f, dtype=dtype, **kw)
        add_chain_quant(self, "qattn", self.entries(), chain_quant)

    def entries(self):
        return [self.attn0.entry("relu"), self.attn1.entry("relu"), self.attn2.entry("none")]

    def forward(self, aligned: Sequence[torch.Tensor]) -> torch.Tensor:
        frames = list(aligned)
        dt = self.dtype
        logits = maybe_quantized_chain(self, "qattn", [fr.to(dt) for fr in frames],
                                       self.entries(), self.chain_quant)
        # Softmax over T on (B, H, W) planes, in the reference's order.
        planes = [logits[..., i].float() for i in range(len(frames))]
        m = planes[0]
        for p in planes[1:]:
            m = torch.maximum(m, p)
        exps = [torch.exp(p - m) for p in planes]
        denom = exps[0]
        for e in exps[1:]:
            denom = denom + e
        inv = (1.0 / denom).to(dt)
        weighted = frames[0] * (exps[0].to(dt) * inv)[..., None]
        for fr, e in zip(frames[1:], exps[1:]):
            weighted = weighted + fr * (e.to(dt) * inv)[..., None]
        return self.refine(weighted)


class RDBStack(nn.Module):
    """``num_blocks`` residual dense blocks, parameters named as in flax
    (``rdb{b}_dense{i}_kernel`` …, LFF as a 2-D ``(C + L·G, C)`` matrix).

    ``quantized`` serves the stack in int8 from the state ``qchain`` (the
    JAX wire format, ``ops.rdb_int8``; unit scales until calibrated), also
    in training mode, where its result carries no gradient. With
    ``quant_calibrate`` set, a forward computes the scales from its input,
    quantises into ``qchain`` and returns the exact result. Quantising and
    serving both follow ``rdb_int8.PER_CHANNEL_INT8`` as it stands at the
    call, as the JAX stack does.
    """

    def __init__(self, num_features: int = 64, num_blocks: int = 8,
                 growth_rate: int = 32, num_layers: int = 5,
                 dtype: torch.dtype = torch.float32, quantized: bool = False,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.num_blocks = num_blocks
        self.num_layers = num_layers
        self.quantized = quantized
        self.quant_calibrate = False
        for b in range(num_blocks):
            cin = num_features
            for i in range(num_layers):
                shape = (3, 3, cin, growth_rate)
                self.register_parameter(f"rdb{b}_dense{i}_kernel", normal_param(
                    shape, math.sqrt(2.0 / (9 * cin)), device, generator))
                self.register_parameter(f"rdb{b}_dense{i}_bias",
                                        zeros_param((growth_rate,), device))
                cin += growth_rate
            self.register_parameter(f"rdb{b}_lff_kernel", normal_param(
                (cin, num_features), 1.0 / math.sqrt(cin), device, generator))
            self.register_parameter(f"rdb{b}_lff_bias", zeros_param((num_features,), device))
        if quantized:
            ones = torch.ones((num_blocks, 1 + num_layers), device=device)
            self.qchain = QuantState(rdb_int8.quantize_rdb_chain(
                self._params_f32(), ones, per_channel=rdb_int8.PER_CHANNEL_INT8))

    def block_params(self, b: int) -> List[torch.Tensor]:
        """Block ``b``'s (w_0, b_0, …, lw, lb) in the compute dtype."""
        names = [f"rdb{b}_dense{i}_{k}" for i in range(self.num_layers)
                 for k in ("kernel", "bias")] + [f"rdb{b}_lff_kernel", f"rdb{b}_lff_bias"]
        return [getattr(self, n).to(self.dtype) for n in names]

    def _params_f32(self) -> List[List[torch.Tensor]]:
        # The compute-dtype params in float32, as the JAX stack quantises them.
        return [[p.float() for p in self.block_params(b)] for b in range(self.num_blocks)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        params_list = [self.block_params(b) for b in range(self.num_blocks)]
        if not self.quantized:
            return ops.rdb_chain_apply(x, params_list)
        if self.quant_calibrate:
            params_f32 = self._params_f32()
            scales = rdb_int8.calibrate_rdb_chain(x.float(), params_f32)
            self.qchain.assign(rdb_int8.quantize_rdb_chain(
                params_f32, scales, per_channel=rdb_int8.PER_CHANNEL_INT8))
            return ops.rdb_chain_apply(x, params_list)
        qchain, int32_taps = self.qchain.value(), rdb_int8.PER_CHANNEL_INT8
        # int8 in training mode too, as the reference's stack (it takes no
        # ``train``): its weights are not parameters and the input's
        # rounding passes no gradient, so the result is a constant.
        with torch.no_grad():
            return ops.rdb_chain_int8_apply(
                x, qchain, out_dtype=x.dtype, int32_taps=int32_taps,
                packed=self.qchain.packed(int32_taps,
                                          lambda: rdb_int8.packed_rdb_chain(qchain, int32_taps)))


class SuperResolutionNet(nn.Module):
    """Flagship motion-compensated temporal SR network (see module doc)."""

    def __init__(self, in_channels: int = 3, scale_factor: int = 2,
                 num_features: int = 64, num_residual_blocks: int = 8,
                 temporal_window: int = 1, flow_downsample: int = 1,
                 quantized: bool = False, quantized_chains: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale_factor = scale_factor
        self.temporal_window = temporal_window
        self.quantized = quantized
        self.quantized_chains = quantized_chains
        self.dtype = dtype
        cq = "serve" if quantized_chains else "off"
        kw = dict(device=resolve_device(device), generator=generator)
        self.feature_extractor = FeatureExtractor(in_channels, num_features, dtype, cq, **kw)
        self.motion_estimator = MotionEstimator(downsample=flow_downsample, dtype=dtype,
                                                chain_quant=cq, **kw)
        self.temporal_aggregator = TemporalAggregator(num_features, self.num_frames,
                                                      dtype, cq, **kw)
        self.rdbs = RDBStack(num_features, num_residual_blocks, dtype=dtype,
                             quantized=quantized, **kw)
        self.gff = QuantizableConv(num_features, num_features, act="relu", dtype=dtype,
                                   chain_quant=cq, **kw)
        self.upsampler = PixelShuffleUpsampler(scale_factor, in_channels, num_features,
                                               zero_init=True, dtype=dtype, chain_quant=cq,
                                               **kw)

    @property
    def num_frames(self) -> int:
        return 2 * self.temporal_window + 1

    def extract_features(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) frames → (N, H, W, F) features."""
        return self.feature_extractor(frames.to(self.dtype))

    def align_to_center(self, nb: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
        """Estimate flow and warp neighbour features onto centre features."""
        return ops.flow_warp(nb, self.motion_estimator(nb, ctr))

    def fuse_from_features(self, aligned: Sequence[torch.Tensor],
                           center_feat: torch.Tensor, center_lr: torch.Tensor,
                           output_layout: str = "nhwc") -> torch.Tensor:
        """Aligned feature list + centre LR frame → SR frame.

        ``output_layout``: 'nhwc' (B, sH, sW, C), 'planar' (B, C, sH, sW) or
        'packed' (B, sH, sW·C); the same values in each.
        """
        if output_layout not in OUTPUT_LAYOUTS:
            raise ValueError(f"unknown output_layout {output_layout!r}")
        s = self.scale_factor
        residual = self.rdbs(self.temporal_aggregator(aligned))
        fused = self.gff(residual) + center_feat
        hr_residual_ch = self.upsampler(fused)
        bicubic_ch = ops.upsample_bicubic_channels(center_lr.to(self.dtype), s)
        return _epilogue(bicubic_ch, hr_residual_ch, s, self.dtype, output_layout)

    def streaming_step(self, prev_feats: Sequence[torch.Tensor], center_feat: torch.Tensor,
                       next_feat: Sequence[torch.Tensor], center_lr: torch.Tensor,
                       output_layout: str = "nhwc") -> torch.Tensor:
        """One streaming step from cached neighbour features (see
        ``models.streaming``)."""
        nbs = list(prev_feats) + list(next_feat)
        warped = self.align_to_center(torch.cat(nbs, 0), torch.cat([center_feat] * len(nbs), 0))
        b = center_feat.shape[0]
        w = len(prev_feats)
        aligned = ([warped[i * b:(i + 1) * b] for i in range(w)] + [center_feat]
                   + [warped[(w + i) * b:(w + i + 1) * b] for i in range(len(next_feat))])
        return self.fuse_from_features(aligned, center_feat, center_lr, output_layout)

    def forward(self, lr_frames: torch.Tensor, output_layout: str = "nhwc",
                return_intermediate: bool = False, differentiable: bool = False):
        """(B, T, H, W, C) window → SR of its centre frame. With
        ``return_intermediate``, (SR, {"features": (B, T, H, W, F),
        "aligned": (B, T, H, W, F), "aggregated": (B, H, W, F)}), the
        reference's debug outputs. Under autograd in training mode, under
        ``torch.inference_mode`` in eval mode. ``differentiable`` runs the
        eval forward under autograd: the reference's ``train=False`` under
        ``jax.grad`` (BatchNorm folded from the running statistics, which
        stay as they are; its scale and bias get gradients), as the
        continual-learning losses call it."""
        if self.training or differentiable:
            return self._forward(lr_frames, output_layout, return_intermediate)
        with torch.inference_mode():
            return self._forward(lr_frames, output_layout, return_intermediate)

    def _forward(self, lr_frames: torch.Tensor, output_layout: str,
                 return_intermediate: bool):
        b, t, h, w, c = lr_frames.shape
        if t != self.num_frames:
            raise ValueError(f"expected T={self.num_frames} frames "
                             f"(2*temporal_window+1), got {t}")
        center = t // 2
        feats = self.extract_features(lr_frames.reshape(b * t, h, w, c))
        feats = feats.reshape(b, t, h, w, -1)
        center_feat = feats[:, center]
        aligned = [center_feat]
        if t > 1:
            others = [j for j in range(t) if j != center]
            nb = feats[:, others].reshape(b * len(others), h, w, -1)
            ctr = center_feat.repeat_interleave(len(others), dim=0)
            warped = self.align_to_center(nb, ctr).reshape(b, len(others), h, w, -1)
            aligned = [center_feat if j == center else warped[:, others.index(j)]
                       for j in range(t)]
        out = self.fuse_from_features(aligned, center_feat, lr_frames[:, center],
                                      output_layout)
        if return_intermediate:
            return out, {"features": feats, "aligned": torch.stack(aligned, dim=1),
                         "aggregated": self.temporal_aggregator(aligned)}
        return out


class LightweightSuperResolution(nn.Module):
    """Single-frame lightweight SR network: (B, H, W, C) → SR frame in
    [0, 1], in the layout ``output_layout`` names (see
    ``SuperResolutionNet.fuse_from_features``).

    Parameters carry the flax names (``head``, ``body0``..``body3``,
    ``tail``); the tail starts at zero, so an untrained model returns the
    clamped bicubic upscale. The eval forward builds the BN-folded 10-entry
    chain (head 3×3 → 32 + relu, four (depthwise 3×3, pointwise 1×1 + relu)
    blocks, tail 3×3 → C·s²) and runs it through ``ops.conv_chain_apply``
    in ``dtype`` (on the card 6 dense and 4 depthwise launches); the bicubic
    base comes from the input in its own dtype. It runs under
    ``torch.inference_mode``, or with ``differentiable=True`` under autograd
    (the reference's ``train=False`` under ``jax.grad``: the running
    statistics held, the fold on the tape, so ``scale``, ``bias`` and
    ``pointwise`` get gradients through it; forward only on the kernels).

    In training mode it is the reference's ``train=True`` path: the head and
    the tail through ``ops.conv_chain_apply`` one layer each (on the card 2
    dense launches, under autograd the kernels forward and the plain
    version's vjp backward), each block's ``train_forward`` between them
    (live BatchNorm; the running statistics move), then the same epilogue.
    """

    def __init__(self, in_channels: int = 3, scale_factor: int = 2,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale_factor = scale_factor
        self.dtype = dtype
        kw = dict(device=resolve_device(device), generator=generator)
        self.head = ConvParams(32, (3, 3), in_channels, **kw)
        for i in range(4):
            self.add_module(f"body{i}", DepthwiseSeparableConv(32, 32, dtype=dtype, **kw))
        self.tail = ConvParams(in_channels * scale_factor**2, (3, 3), 32, zero_init=True, **kw)

    def chain(self):
        """The BN-folded whole-body chain, as ``conv_chain_apply`` entries."""
        entries = [self.head.entry("relu")]
        for i in range(4):
            entries += getattr(self, f"body{i}").as_entries()
        return entries + [self.tail.entry("none")]

    def train_body(self, x: torch.Tensor) -> torch.Tensor:
        """The training-mode residual (phase channels); updates the blocks'
        running statistics."""
        y = ops.conv_chain_apply(x, [self.head.entry("relu")])
        for i in range(4):
            y = getattr(self, f"body{i}").train_forward(y)
        return ops.conv_chain_apply(y, [self.tail.entry("none")])

    def forward(self, x: torch.Tensor, output_layout: str = "nhwc",
                differentiable: bool = False) -> torch.Tensor:
        if output_layout not in OUTPUT_LAYOUTS:
            raise ValueError(f"unknown output_layout {output_layout!r}")
        if self.training or differentiable:
            return self._forward(x, output_layout)
        with torch.inference_mode():
            return self._forward(x, output_layout)

    def _forward(self, x: torch.Tensor, output_layout: str) -> torch.Tensor:
        s = self.scale_factor
        inp = x.to(self.dtype)
        residual_ch = self.train_body(inp) if self.training else ops.conv_chain_apply(
            inp, self.chain())
        bicubic_ch = ops.upsample_bicubic_channels(x, s)
        return _epilogue(bicubic_ch, residual_ch, s, self.dtype, output_layout)


def estimate_sr_flops(input_hw: Sequence[int] = (128, 128), num_features: int = 64,
                      num_frames: int = 3, scale_factor: int = 2) -> int:
    """Coarse FLOPs estimate of ``SuperResolutionNet`` (the reference's
    ``get_flops``)."""
    h, w = input_hw
    c, f = 3, num_features
    flops = h * w * c * f * 9
    flops += h * w * f * 81 * (num_frames - 1)
    flops += h * w * f * f * 9 * 8
    flops += h * w * f * (c * scale_factor**2) * 9
    return flops
