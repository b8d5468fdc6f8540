"""Sequential chains of SAME 3×3 / 1×1 convolutions with relu or none.

Counterpart of ``nerve_tpu/ops/conv_chain.py``. ``params`` is a sequence of
``(kernel, bias, act)``: kernel HWIO ``(k, k, cin, cout)`` with k ∈ {1, 3},
or rank-3 ``(3, 3, C)`` for a depthwise 3×3 layer; act ∈ {"relu", "none"}.
The input may be a list of tensors, concatenated on channels.

Numerics are those of the reference formulation ``_chain_xla``: weights
rounded to the input dtype, float32 accumulation, the convolution's sum
rounded to the input dtype, float32 bias, activation, the layer's output
rounded to the input dtype.

A CUDA tensor runs one launch per layer: ``csrc/conv_chain.cu`` for a
dense layer (counter ``conv_chain``), ``csrc/dwconv3.cu`` for a depthwise
one (counter ``conv_chain_dw3``); a list input is concatenated in device
memory first. A CPU tensor runs ``conv_chain_plain`` (``F.conv2d``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch

Entry = Tuple[torch.Tensor, torch.Tensor, str]
MAX_DW_CHANNELS = 64  # csrc/dwconv3.cu stages every channel of its tile


def _layer_specs(params: Sequence[Entry]):
    """[(kind, cin, cout, act)] with validation; kind ∈ {3x3, 1x1, dw3}."""
    specs = []
    for w, _b, act in params:
        if w.ndim == 3:
            if tuple(w.shape[:2]) != (3, 3):
                raise ValueError("depthwise conv_chain layers must be 3x3")
            specs.append(("dw3", w.shape[2], w.shape[2], act))
        else:
            kh, kw, cin, cout = w.shape
            if (kh, kw) not in ((3, 3), (1, 1)):
                raise ValueError(f"conv_chain supports 3x3/1x1 kernels, got {kh}x{kw}")
            specs.append(("3x3" if kh == 3 else "1x1", cin, cout, act))
        if act not in ("relu", "none"):
            raise ValueError(f"unknown activation {act!r}")
    for a, b in zip(specs, specs[1:]):
        if a[2] != b[1]:
            raise ValueError("conv_chain layer channel mismatch")
    return specs


def _concat(x) -> torch.Tensor:
    if isinstance(x, (list, tuple)):
        return x[0] if len(x) == 1 else torch.cat(list(x), dim=-1)
    return x


def conv_chain_plain(x, params: Sequence[Entry]) -> torch.Tensor:
    """Plain version: ``F.conv2d`` per layer on NCHW views, reference rounding."""
    x = _concat(x)
    _layer_specs(params)
    dt = x.dtype
    h = x.permute(0, 3, 1, 2)
    for w, bias, act in params:
        if w.ndim == 3:  # depthwise (3, 3, C) → (C, 1, 3, 3), groups = C
            wk = w.to(dt).permute(2, 0, 1).unsqueeze(1)
            y = F.conv2d(h, wk, padding=1, groups=w.shape[2])
        else:
            wk = w.to(dt).permute(3, 2, 0, 1)
            y = F.conv2d(h, wk, padding=w.shape[0] // 2)
        y = y.float() + bias.float()[:, None, None]
        if act == "relu":
            y = torch.relu(y)
        h = y.to(dt)
    return h.permute(0, 2, 3, 1).contiguous()


def conv_layer_launch(x: torch.Tensor, cin: int, w: torch.Tensor, bias: torch.Tensor,
                      out: torch.Tensor, out_coff: int, relu: bool) -> None:
    """Launch ``nt_conv2d``: channels [0, cin) of ``x`` → channels
    [out_coff, out_coff + cout) of ``out``; both contiguous NHWC on CUDA.
    ``w`` float32 HWIO, ``bias`` float32 (the caller rounds them)."""
    b, h, wd, xcs = x.shape
    k, _k, wcin, cout = w.shape
    if (wcin != cin or cin > xcs or out_coff + cout > out.shape[-1]
            or tuple(bias.shape) != (cout,)):
        raise ValueError(f"conv layer {tuple(w.shape)}, bias {tuple(bias.shape)} does not "
                         f"fit input {tuple(x.shape)} / output {tuple(out.shape)} at {out_coff}")
    if out.shape[:3] != x.shape[:3] or out.dtype != x.dtype:
        raise ValueError("conv layer input and output differ in size or dtype")
    if not (x.is_contiguous() and out.is_contiguous() and w.is_contiguous()
            and bias.is_contiguous() and w.dtype == bias.dtype == torch.float32):
        raise ValueError("conv layer takes contiguous tensors and float32 weights")
    _build.launch("nt_conv2d", x.device, x.data_ptr(), xcs, cin, w.data_ptr(),
                  bias.data_ptr(), out.data_ptr(), out.shape[-1], out_coff, cout,
                  b, h, wd, k, int(relu), _build.dtype_code(x))


def dwconv3_launch(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   out: torch.Tensor, relu: bool) -> None:
    """Launch ``nt_dwconv3``: one depthwise 3×3 layer, ``x`` → ``out``, both
    contiguous (B, H, W, C) on CUDA. ``w`` float32 (3, 3, C), ``bias``
    float32 (C,) (the caller rounds them)."""
    b, h, wd, c = x.shape
    if tuple(w.shape) != (3, 3, c) or tuple(bias.shape) != (c,) or out.shape != x.shape:
        raise ValueError(f"depthwise layer {tuple(w.shape)}, bias {tuple(bias.shape)} does "
                         f"not fit input {tuple(x.shape)} / output {tuple(out.shape)}")
    if not 1 <= c <= MAX_DW_CHANNELS:
        raise ValueError(f"the depthwise kernel takes 1..{MAX_DW_CHANNELS} channels, got {c}")
    if not (x.is_contiguous() and out.is_contiguous() and w.is_contiguous()
            and bias.is_contiguous() and out.dtype == x.dtype
            and w.dtype == bias.dtype == torch.float32):
        raise ValueError("depthwise layer takes contiguous tensors and float32 weights")
    _build.launch("nt_dwconv3", x.device, x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), c, b, h, wd, int(relu), _build.dtype_code(x))


def conv_chain_apply(x, params: Sequence[Entry]) -> torch.Tensor:
    """Run a conv(+relu) chain: (B, H, W, Cin) or a list → (B, H, W, Cout)."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    specs = _layer_specs(params)
    if any(t.dtype != xs[0].dtype for t in xs):
        raise ValueError("conv_chain inputs differ in dtype")
    if sum(t.shape[-1] for t in xs) != specs[0][1]:
        raise ValueError(f"conv_chain input has {sum(t.shape[-1] for t in xs)} channels, "
                         f"the first layer takes {specs[0][1]}")
    if not dispatch.use_kernel(*xs, *(p for w, b, _ in params for p in (w, b))):
        return conv_chain_plain(xs, params)
    h = _concat(xs).contiguous()
    for (w, bias, act), (kind, cin, cout, _act) in zip(params, specs):
        out = torch.empty((*h.shape[:3], cout), dtype=h.dtype, device=h.device)
        wk, bk = w.to(h.dtype).float().contiguous(), bias.float().contiguous()
        if kind == "dw3":
            dwconv3_launch(h, wk, bk, out, act == "relu")
            dispatch.launches["conv_chain_dw3"] += 1
        else:
            conv_layer_launch(h, cin, wk, bk, out, 0, act == "relu")
            dispatch.launches["conv_chain"] += 1
        h = out
    return h
