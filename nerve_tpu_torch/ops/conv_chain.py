"""Sequential chains of SAME 3×3 / 1×1 convolutions with relu or none.

Counterpart of ``nerve_tpu/ops/conv_chain.py``. ``params`` is a sequence of
``(kernel, bias, act)``: kernel HWIO ``(k, k, cin, cout)`` with k ∈ {1, 3},
or rank-3 ``(3, 3, C)`` for a depthwise 3×3 layer; act ∈ {"relu", "none"}.
The input may be a list of tensors, concatenated on channels.

Numerics are those of the reference formulation ``_chain_xla``: weights
rounded to the input dtype, float32 accumulation, the convolution's sum
rounded to the input dtype, float32 bias, activation, the layer's output
rounded to the input dtype.

A CUDA tensor runs ``csrc/conv_chain.cu``, one launch per layer; a list
input is concatenated in device memory first. A CPU tensor runs
``conv_chain_plain`` (``F.conv2d``). The depthwise layer has no CUDA kernel
yet (ROADMAP.md, Queue 2): on a CUDA tensor it raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch

Entry = Tuple[torch.Tensor, torch.Tensor, str]


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
    if any(kind == "dw3" for kind, *_ in specs):
        raise NotImplementedError(
            "conv_chain: the depthwise 3x3 (dw3) layer has no CUDA kernel yet "
            "(ROADMAP.md, Queue 2: conv-chain dw3)"
        )
    h = _concat(xs).contiguous()
    for (w, bias, act), (_kind, cin, cout, _act) in zip(params, specs):
        out = torch.empty((*h.shape[:3], cout), dtype=h.dtype, device=h.device)
        conv_layer_launch(h, cin, w.to(h.dtype).float().contiguous(),
                          bias.float().contiguous(), out, 0, act == "relu")
        dispatch.launches["conv_chain"] += 1
        h = out
    return h
