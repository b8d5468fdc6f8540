"""Building blocks of the SR network (NHWC, inference only).

Counterpart of ``nerve_tpu/models/layers.py``. Each module holds its
parameters in float32 under the names of the flax tree (``kernel``,
``bias``, ``BatchNorm_0.scale``, …), so ``models.bridge`` maps a flax
variable tree onto ``state_dict()`` name for name. Forwards cast weights
and activations to the module's ``dtype`` where the reference does.
Initial values are drawn from ``generator`` (normal, lecun/he scale, zero
biases); they are placeholders until real weights are loaded.

The int8 state of a quantised conv-chain site lives in buffers under the
name of the flax ``"quant"`` collection's entry (``qhead``, ``qflow``,
``qattn``, ``qconv``), in the JAX wire format (``ops.conv_chain_int8``),
and keeps its weights packed for the int8 kernel (``QuantState.packed``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerve_tpu_torch import ops
from nerve_tpu_torch.ops import conv_chain_int8

BN_EPS = 1e-5
CHAIN_QUANT_MODES = ("off", "serve", "calibrate")


def normal_param(shape: Sequence[int], std: float, device=None,
                 generator: Optional[torch.Generator] = None) -> nn.Parameter:
    """A float32 parameter drawn from N(0, std²) (std 0 gives zeros)."""
    t = torch.randn(tuple(shape), generator=generator) * std
    return nn.Parameter(t.to(device))


def zeros_param(shape: Sequence[int], device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(tuple(shape), device=device))


class KernelParams(nn.Module):
    """A bias-free kernel, stored as flax does (HWIO, or (in, out) for Dense)."""

    def __init__(self, shape: Sequence[int], device=None, generator=None):
        super().__init__()
        fan_in = math.prod(shape[:-1])
        self.kernel = normal_param(shape, 1.0 / math.sqrt(fan_in), device, generator)


class ConvParams(nn.Module):
    """An HWIO ``(kernel, bias)`` pair for the conv-chain kernel."""

    def __init__(self, features: int, kernel_size: Tuple[int, int], in_features: int,
                 zero_init: bool = False, device=None, generator=None):
        super().__init__()
        shape = (*kernel_size, in_features, features)
        std = 0.0 if zero_init else 1.0 / math.sqrt(math.prod(shape[:-1]))
        self.kernel = normal_param(shape, std, device, generator)
        self.bias = zeros_param((features,), device)

    def entry(self, act: str):
        """This layer as a ``conv_chain_apply`` entry."""
        return (self.kernel, self.bias, act)


class QuantState(nn.Module):
    """A nested tuple of tensors held as buffers named by their index.

    ``state_dict()`` keys follow the tree of the flax ``"quant"`` entry:
    for a conv chain ``(qlayers, s_in)``, ``0.{i}.0`` is layer i's ``wq``,
    ``0.{i}.1`` its ``meta`` and ``1`` is ``s_in``.

    It also keeps what :meth:`packed` built from it (the int8 kernel's
    weight image) until the state is written (:meth:`assign`,
    ``load_state_dict``) or moved (``.to()``), which drop it: int8 weights
    do not change after calibration, so a served model packs once.
    """

    def __init__(self, tree):
        super().__init__()
        self._packed = None
        self.size = len(tree)
        for i, v in enumerate(tree):
            if isinstance(v, torch.Tensor):
                self.register_buffer(str(i), v.detach().clone())
            else:
                self.add_module(str(i), QuantState(v))

    def value(self) -> tuple:
        """The tree, its leaves the buffers themselves."""
        return tuple(self._buffers[str(i)] if str(i) in self._buffers
                     else self._modules[str(i)].value() for i in range(self.size))

    def packed(self, key, build):
        """``build()`` of this state, kept until the state is written or
        moved; ``key`` names what else the result depends on (a scheme)."""
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, build())
        return self._packed[1]

    def _apply(self, *args, **kwargs):
        self._packed = None
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._packed = None
        super()._load_from_state_dict(*args, **kwargs)

    @torch.no_grad()
    def assign(self, tree) -> None:
        """Copy ``tree`` (same structure, shapes and dtypes) into the buffers."""
        self._packed = None
        if len(tree) != self.size:
            raise ValueError(f"quant tree of {len(tree)} entries, state holds {self.size}")
        for i, v in enumerate(tree):
            if str(i) in self._buffers:
                buf = self._buffers[str(i)]
                if v.shape != buf.shape or v.dtype != buf.dtype:
                    raise ValueError(f"quant entry {i}: {v.dtype} {tuple(v.shape)} for a "
                                     f"{buf.dtype} {tuple(buf.shape)} buffer")
                buf.copy_(v)
            else:
                self._modules[str(i)].assign(v)


def _float_entries(entries):
    return [(k.float(), b.float(), act) for k, b, act in entries]


def add_chain_quant(mod: nn.Module, name: str, entries, chain_quant: str) -> None:
    """Give ``mod`` the int8 state ``name`` of the chain ``entries`` unless
    ``chain_quant`` is "off": the wire format at unit activation scales, as
    flax ``init`` builds its default; real scales come from calibration."""
    if chain_quant not in CHAIN_QUANT_MODES:
        raise ValueError(f"unknown chain_quant {chain_quant!r}")
    mod.chain_quant = chain_quant
    if chain_quant != "off":
        params = _float_entries(entries)
        ones = torch.ones(len(params) + 1, device=params[0][0].device)
        setattr(mod, name, QuantState(conv_chain_int8.quantize_conv_chain(params, ones)[:2]))


def maybe_quantized_chain(mod: nn.Module, name: str, x, entries,
                          chain_quant: str = "off") -> torch.Tensor:
    """A conv chain, in int8 when asked (counterpart of the JAX function).

    ``entries``: ``[(kernel, bias, act), …]`` as for ``ops.conv_chain_apply``.
    ``chain_quant``:

    * ``"off"``: the exact bf16/float32 chain;
    * ``"serve"``: int8 weights and activations with the static scales of
      ``mod``'s state ``name`` (``ops.conv_chain_int8_apply``);
    * ``"calibrate"``: max-abs scales from this input, quantise into the
      state ``name``, and return the exact result, so that later sites
      calibrate on the unquantised distribution.

    int8 serving is inference only: a module in training mode raises.
    """
    if chain_quant == "off":
        return ops.conv_chain_apply(x, entries)
    if chain_quant not in CHAIN_QUANT_MODES:
        raise ValueError(f"unknown chain_quant {chain_quant!r}")
    if mod.training:
        raise RuntimeError("int8 chains are inference only: call .eval() first")
    state = getattr(mod, name)
    params = _float_entries(entries)
    if chain_quant == "calibrate":
        scales = conv_chain_int8.calibrate_conv_chain(x, params)
        state.assign(conv_chain_int8.quantize_conv_chain(params, scales)[:2])
        return ops.conv_chain_apply(x, entries)
    qlayers, s_in = state.value()
    dt = x[0].dtype if isinstance(x, (list, tuple)) else x.dtype
    cout = entries[-1][0].shape[-1]
    return ops.conv_chain_int8_apply(
        x, (qlayers, s_in, tuple(a for *_, a in entries)), cout, out_dtype=dt,
        packed=state.packed(cout, lambda: conv_chain_int8.packed_chain(qlayers, cout)))


class QuantizableConv(ConvParams):
    """One 3×3 conv + activation through the conv-chain kernel, or in int8
    (``chain_quant``, state ``qconv``; see :func:`maybe_quantized_chain`)."""

    def __init__(self, features: int, in_features: int, act: str = "none",
                 dtype: torch.dtype = torch.float32, chain_quant: str = "off",
                 device=None, generator=None):
        super().__init__(features, (3, 3), in_features, device=device, generator=generator)
        self.act = act
        self.dtype = dtype
        add_chain_quant(self, "qconv", [self.entry(act)], chain_quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return maybe_quantized_chain(self, "qconv", x.to(self.dtype), [self.entry(self.act)],
                                     self.chain_quant)


class BNParams(nn.Module):
    """BatchNorm parameters (scale, bias) and running statistics (mean, var)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = zeros_param((features,), device)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3×3 + pointwise 1×1 + BatchNorm + relu, eval statistics.

    The forward folds BatchNorm into the pointwise conv as the reference's
    ``as_entries`` does (layers.py:207-224) and runs the pair with the
    rounding of ``_chain_xla``, in the input's dtype. By default it is plain
    PyTorch: the reference forces this body to XLA too
    (super_resolution.py:75-78). ``use_fused`` (default off, as in the
    reference) runs the pair through ``ops.conv_chain_apply`` in ``dtype``,
    so on the card through the depthwise and dense conv kernels.
    """

    def __init__(self, features: int, in_features: int, device=None, generator=None,
                 use_fused: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_fused = use_fused
        self.dtype = dtype
        self.depthwise = KernelParams((3, 3, 1, in_features), device, generator)
        self.pointwise = KernelParams((1, 1, in_features, features), device, generator)
        self.BatchNorm_0 = BNParams(features, device)

    def folded(self):
        """(depthwise (3, 3, C), pointwise (1, 1, C, F), bias (F,)), float32."""
        bn = self.BatchNorm_0
        inv = bn.scale / torch.sqrt(bn.var + BN_EPS)
        return (self.depthwise.kernel[:, :, 0, :],
                self.pointwise.kernel * inv, bn.bias - bn.mean * inv)

    def as_entries(self):
        """The block's two ``conv_chain_apply`` entries, BatchNorm folded into
        the pointwise conv: (depthwise, zero bias, "none"), (pointwise, bias,
        "relu")."""
        kd, kp, bp = self.folded()
        return [(kd, torch.zeros_like(kd[0, 0]), "none"), (kp, bp, "relu")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_fused:
            return ops.conv_chain_apply(x.to(self.dtype), self.as_entries())
        dt = x.dtype
        kd, kp, bp = self.folded()
        h = x.permute(0, 3, 1, 2)
        h = F.conv2d(h, kd.to(dt).permute(2, 0, 1).unsqueeze(1), padding=1,
                     groups=x.shape[-1])
        h = F.conv2d(h, kp.to(dt).permute(3, 2, 0, 1))
        h = torch.relu(h.float() + bp[:, None, None]).to(dt)
        return h.permute(0, 2, 3, 1)


class PixelShuffleUpsampler(nn.Module):
    """3×3 conv to C·s² phase channels, returned before the depth-to-space.

    The reference's ``shuffle=False`` form, the one the SR network uses: its
    epilogue adds the bicubic base in phase-channel space and interleaves
    once (``SuperResolutionNet.fuse_from_features``). ``chain_quant`` serves
    the conv in int8 (state ``qconv``; see :func:`maybe_quantized_chain`).
    """

    def __init__(self, scale_factor: int, out_channels: int, in_features: int,
                 zero_init: bool = False, dtype: torch.dtype = torch.float32,
                 chain_quant: str = "off", device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.conv = ConvParams(out_channels * scale_factor**2, (3, 3), in_features,
                               zero_init=zero_init, device=device, generator=generator)
        add_chain_quant(self, "qconv", [self.conv.entry("none")], chain_quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return maybe_quantized_chain(self, "qconv", x.to(self.dtype),
                                     [self.conv.entry("none")], self.chain_quant)


class ChannelAttention(nn.Module):
    """SE-style channel attention: pool → Dense → relu → Dense → sigmoid."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        mid = max(1, channels // reduction)
        self.Dense_0 = KernelParams((channels, mid), device, generator)
        self.Dense_1 = KernelParams((mid, channels), device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = ops.global_avg_pool(x).to(dt)
        y = torch.relu(y @ self.Dense_0.kernel.to(dt))
        y = torch.sigmoid(y @ self.Dense_1.kernel.to(dt))
        return x * y[:, None, None, :]


class SpatialAttention(nn.Module):
    """Channel mean and max planes → 7×7 conv → sigmoid mask."""

    def __init__(self, kernel_size: int = 7, dtype: torch.dtype = torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        shape = (kernel_size, kernel_size, 2, 1)
        self.conv_kernel = normal_param(shape, 1.0 / math.sqrt(2 * kernel_size**2),
                                        device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        planes = torch.stack([x.mean(-1).to(dt), x.amax(-1).to(dt)], dim=1)
        k = self.conv_kernel.to(dt).float().permute(3, 2, 0, 1)
        # float32 sums over the taps, as the reference accumulates them.
        y = F.conv2d(planes.float(), k, padding=k.shape[-1] // 2)[:, 0]
        return x * torch.sigmoid(y.to(dt))[..., None]


class CBAM(nn.Module):
    """Channel attention followed by spatial attention."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.ChannelAttention_0 = ChannelAttention(channels, reduction, dtype,
                                                   device, generator)
        self.SpatialAttention_0 = SpatialAttention(7, dtype, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SpatialAttention_0(self.ChannelAttention_0(x))
