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
one (counter ``conv_chain_dw3``). A CPU tensor runs ``conv_chain_plain``
(``F.conv2d``).

The bfloat16 dense layer takes its weights as the image of
``pack_conv_weights`` (packed here once per call) and its input through TMA
tensor maps, which need 16-byte pixel strides: ``input_route`` is the rule,
by shape. A tensor whose channel count is a multiple of 8, or a list of up
to three tensors of equal width, a multiple of 16, is read in place (a
list without a concatenation); anything else (the head's 3 channels, the
flow head's 81) is first copied into one buffer zero-padded to a multiple
of 8 channels. The float32 dense layer takes float32 HWIO weights and one
tensor (a list is concatenated first).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch

Entry = Tuple[torch.Tensor, torch.Tensor, str]
MAX_DW_CHANNELS = 64  # csrc/dwconv3.cu stages every channel of its tile
N_TILES = (8, 16, 32, 64, 128)  # the bf16 kernel's output-channel tiles (wgmma N)
CHUNK = 16  # input channels per K step of the bf16 kernel
MAX_PARTS = 3  # input tensors the bf16 kernel reads in place


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


def n_tile(cout: int) -> int:
    """The bf16 kernel's output-channel tile for a layer of ``cout`` channels."""
    return next((n for n in N_TILES if cout <= n), N_TILES[-1])


def pack_conv_weights(w: torch.Tensor, nt: int | None = None) -> torch.Tensor:
    """HWIO weights ``(k, k, cin, cout)`` → the bf16 kernel's image, 1-D bf16.

    The image is ``[n-tile][chunk][tap][k half][n / 8][n % 8][k % 8]``: for
    each N tile of ``nt`` (default ``n_tile(cout)``) output channels and each 16-channel
    input chunk, the k×k taps (row-major) of a 16 × N slice in wgmma's
    K-major core matrices (8 output channels × 8 input channels, 128
    bytes), the chunk's first 8 input channels before its last 8. Input
    channels past ``cin`` and output channels past ``cout`` are zero. The
    weights are rounded to bf16 as the reference rounds them to the input
    dtype.
    """
    k, _k, cin, cout = w.shape
    nt = nt or n_tile(cout)
    ncot, nch = -(-cout // nt), -(-cin // CHUNK)
    wp = w.new_zeros((k * k, nch * CHUNK, ncot * nt), dtype=torch.bfloat16)
    wp[:, :cin, :cout] = w.reshape(k * k, cin, cout).to(torch.bfloat16)
    # (tap, chunk, k half, k % 8, n-tile, n / 8, n % 8) → the image's order
    wp = wp.reshape(k * k, nch, 2, 8, ncot, nt // 8, 8).permute(4, 1, 0, 2, 5, 6, 3)
    return wp.contiguous().reshape(-1)


def input_route(xs: Sequence[torch.Tensor], cin: int) -> str:
    """How the bf16 kernel takes the input parts ``xs`` (NHWC, concatenated
    on channels) of a layer that reads their first ``cin`` channels.

    ``"tma"``: read in place, one tensor map per part. That takes one
    contiguous, 16-byte-aligned tensor whose channel count is a multiple of
    8 (its leading ``cin`` channels are read: TMA needs 16-byte pixel
    strides), or 2-3 such tensors of equal width, a multiple of 16 (each
    16-channel chunk from one tensor), whose channels together are ``cin``.
    ``"padded"``: anything else is first copied into one buffer of
    ``ceil8(cin)`` channels, zero beyond ``cin`` (``padded_input``). Raises
    on parts that differ in batch, height or width, or hold too few
    channels.
    """
    if any(t.ndim != 4 for t in xs) or len({tuple(t.shape[:3]) for t in xs}) != 1:
        raise ValueError(f"conv layer input parts {[tuple(t.shape) for t in xs]} are not "
                         "NHWC tensors of one size")
    widths = [t.shape[-1] for t in xs]
    if sum(widths) < cin or (len(xs) > 1 and sum(widths) != cin):
        raise ValueError(f"conv layer reads {cin} channels of input parts {widths}")
    in_place = all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in xs) and (
        widths[0] % 8 == 0 if len(xs) == 1
        else len(xs) <= MAX_PARTS and len(set(widths)) == 1 and widths[0] % 16 == 0)
    return "tma" if in_place else "padded"


def padded_input(xs: Sequence[torch.Tensor], cin: int) -> torch.Tensor:
    """Channels [0, cin) of the parts ``xs`` in one contiguous buffer of
    ``ceil8(cin)`` channels, zero beyond ``cin``: one copy."""
    pad = -cin % 8
    if len(xs) == 1:
        return F.pad(xs[0][..., :cin], (0, pad))
    return torch.cat([*xs, xs[0].new_zeros((*xs[0].shape[:3], pad))], dim=-1)


def conv_layer_launch(x, cin: int, w: torch.Tensor, bias: torch.Tensor,
                      out: torch.Tensor, out_coff: int, relu: bool) -> None:
    """Launch ``nt_conv2d``: channels [0, cin) of the input → channels
    [out_coff, out_coff + cout) of ``out`` (contiguous NHWC on CUDA). ``x``
    is a tensor or a list of parts concatenated on channels; ``w`` HWIO at
    any float dtype (rounded to the input dtype here: packed by
    ``pack_conv_weights`` for bfloat16), ``bias`` float32."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    k, _k, wcin, cout = w.shape
    if (wcin != cin or out_coff + cout > out.shape[-1] or tuple(bias.shape) != (cout,)):
        raise ValueError(f"conv layer {tuple(w.shape)}, bias {tuple(bias.shape)} does not "
                         f"fit output {tuple(out.shape)} at {out_coff}")
    dt = xs[0].dtype
    if out.shape[:3] != xs[0].shape[:3] or any(t.dtype != dt for t in (*xs, out)):
        raise ValueError("conv layer input and output differ in size or dtype")
    if not (out.is_contiguous() and bias.is_contiguous() and bias.dtype == torch.float32):
        raise ValueError("conv layer takes a contiguous output and a float32 bias")
    if dt == torch.bfloat16:
        if input_route(xs, cin) == "padded":
            xs = [padded_input(xs, cin)]
        wk = pack_conv_weights(w)
    elif dt == torch.float32:
        xs = [torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0].contiguous()]
        if xs[0].shape[-1] < cin:
            raise ValueError(f"conv layer reads {cin} channels of {tuple(xs[0].shape)}")
        wk = w.float().contiguous()
    else:
        raise TypeError(f"the dense conv kernel takes float32 or bfloat16, got {dt}")
    ptrs = [t.data_ptr() for t in xs] + [xs[0].data_ptr()] * (MAX_PARTS - len(xs))
    b, h, wd, xcs = xs[0].shape
    _build.launch("nt_conv2d", out.device, *ptrs, len(xs), xcs, cin, wk.data_ptr(),
                  bias.data_ptr(), out.data_ptr(), out.shape[-1], out_coff, cout,
                  b, h, wd, k, int(relu), _build.dtype_code(out))


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
    h = xs  # the first layer reads a list input in place
    for (w, bias, act), (kind, cin, cout, _act) in zip(params, specs):
        out = torch.empty((*xs[0].shape[:3], cout), dtype=xs[0].dtype, device=xs[0].device)
        bk = bias.float().contiguous()
        if kind == "dw3":
            dwconv3_launch(_concat(h).contiguous(), w.to(out.dtype).float().contiguous(), bk,
                           out, act == "relu")
            dispatch.launches["conv_chain_dw3"] += 1
        else:
            conv_layer_launch(h, cin, w, bk, out, 0, act == "relu")
            dispatch.launches["conv_chain"] += 1
        h = out
    return h
