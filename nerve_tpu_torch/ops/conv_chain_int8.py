"""Static post-training int8 conv chains of dense SAME 3×3 / 1×1 layers.

Counterpart of ``nerve_tpu/ops/conv_chain_int8.py``: the feature head, flow
head, attention logits, gff and upsampler convs of the SR network in int8.

Scheme: per-tensor symmetric int8 activations with static scales from a
calibration forward (:func:`calibrate_conv_chain`: one scale for the chain
input, one per layer output); per-column symmetric int8 weights with the
input scale folded into the column's dequant factor; exact float32 biases.

Wire format (:func:`quantize_conv_chain`, the JAX package's): per layer,
with taps t ∈ {9, 1} and npad = cout padded to ``MIN_NOUT``,

* ``wq``: int8 ``(BIAS_SLOT + cin, t·npad)``, column ``tap·npad + n``; the
  ``BIAS_SLOT`` leading rows are zero;
* ``meta``: float32 ``(8, t·npad)``: row 0 the per-column dequant factor
  (s_in folded in), row 1 the bias, row 2 the requant factor 1/s_out, row 3
  s_out.

``qchain = (qlayers, s_in, acts)``.

Numerics (``conv_chain_int8_xla``): the input is quantised once,
``clip(rint(x / s_in), ±127)``; each tap's int32 sum is dequantised by its
column factor and rounded to bfloat16, the taps are added in float32 (dy
outer, dx inner), then the float32 bias and the activation; a layer before
the last requantises by multiplication with row 2, the last layer returns
its real value in ``out_dtype``.

A CUDA tensor runs the hand-written kernels: ``csrc/quantize_i8.cu``
quantises the input, a list's parts into their channel slots, in one
launch (counter ``quantize_i8``), and ``csrc/conv_int8.cu`` runs one launch
per layer (counter ``conv_chain_int8``) through int8 device buffers. The
layer kernel takes its weights as the image of :func:`pack_i8_weights`,
packed once per quantised layer with the layer's factors
(:func:`packed_chain`) and kept while the wire-format tensors are unchanged.
A CPU tensor runs ``conv_chain_int8_plain``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch
from nerve_tpu_torch.ops.conv_chain import _concat, _layer_specs, conv_chain_plain

BIAS_SLOT = 8  # leading zero rows of the wire format's weight matrices
MIN_NOUT = 64  # output columns are padded up to a multiple of this
QMAX = 127.0
CHUNK_I8 = 32  # input channels per K step of the int8 kernel (32 bytes a pixel)
N_TILES_I8 = (8, 16, 32)  # the int8 kernel's output-channel tiles (wgmma N)
MAX_PARTS = 3  # input tensors the quantisation kernel takes


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@contextlib.contextmanager
def exact_float32():
    """Full float32 convolutions and matrix products on the card (TF32 off)
    for the body; the previous settings come back after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def quantize_activation(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(rint(x / scale), -127, 127)`` as int8 (round half to even)."""
    return torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX).to(torch.int8)


def int_products(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x · w`` over the last axis of integer-valued x and int8 w, exact in
    float32: every partial sum is below 127²·K < 2²⁴."""
    k = w.shape[0]
    if QMAX * QMAX * k >= 2**24:
        raise ValueError(f"int8 products over K={k} are not exact in float32")
    return torch.matmul(x.float(), w.float())


def _check_dense(specs):
    for kind, _cin, _cout, _act in specs:
        if kind == "dw3":
            raise ValueError("int8 conv chains support dense 3x3/1x1 layers only "
                             "(depthwise layers stay bf16)")


def _float_params(params):
    return [(torch.as_tensor(w).float(), torch.as_tensor(b).float(), act)
            for w, b, act in params]


def calibrate_conv_chain(x, params) -> torch.Tensor:
    """(1 + L,) activation scales ``[s_in, s_y0, …]``: max-abs / 127 of the
    chain input and of each layer's output, from the exact float32 chain."""
    params = _float_params(params)
    _check_dense(_layer_specs(params))
    x = _concat([t.float() for t in x] if isinstance(x, (list, tuple)) else x.float())
    maxes = [x.abs().max()]
    with exact_float32():
        for layer in params:
            x = conv_chain_plain(x, [layer])
            maxes.append(x.abs().max())
    # An all-zero activation must not give a 0 scale (inf requant, NaN).
    return torch.clamp(torch.stack(maxes), min=1e-12) / QMAX


def quantize_conv_chain(params, scales: torch.Tensor):
    """float32 chain params + activation scales → ``(qlayers, s_in, acts)``
    in the wire format (module docstring)."""
    params = _float_params(params)
    _check_dense(_layer_specs(params))
    scales = scales.float()
    qlayers = []
    for i, (w, b, _act) in enumerate(params):
        kh, kw, cin, cout = w.shape
        npad = max(_ceil_to(cout, MIN_NOUT), MIN_NOUT)
        wp = F.pad(w, (0, npad - cout, BIAS_SLOT, 0))
        wcat = wp.permute(2, 0, 1, 3).reshape(BIAS_SLOT + cin, kh * kw * npad)
        col = torch.clamp(wcat.abs().amax(dim=0), min=1e-12) / QMAX
        wq = torch.clamp(torch.round(wcat / col), -QMAX, QMAX).to(torch.int8)
        meta = torch.zeros((8, kh * kw * npad), dtype=torch.float32, device=w.device)
        meta[0] = col * scales[i]
        meta[1, :cout] = b
        meta[2, :npad] = 1.0 / scales[i + 1]
        meta[3, :npad] = scales[i + 1]
        qlayers.append((wq, meta))
    return tuple(qlayers), scales[0], tuple(act for _w, _b, act in params)


def layer_geometry(qlayers, out_cout: int):
    """[(taps, cin, cout, npad)] of a quantised chain, read from its shapes."""
    geo = []
    for i, (wq, meta) in enumerate(qlayers):
        cin = wq.shape[0] - BIAS_SLOT
        cout = qlayers[i + 1][0].shape[0] - BIAS_SLOT if i + 1 < len(qlayers) else out_cout
        npad = max(_ceil_to(cout, MIN_NOUT), MIN_NOUT)
        taps = wq.shape[1] // npad
        if (taps not in (1, 9) or wq.shape[1] != taps * npad
                or tuple(meta.shape) != (8, taps * npad)):
            raise ValueError(f"int8 chain layer {i}: wq {tuple(wq.shape)}, meta "
                             f"{tuple(meta.shape)} do not fit cout={cout}")
        geo.append((taps, cin, cout, npad))
    return geo


def conv_chain_int8_plain(x, qlayers, s_in, acts, out_cout: int, out_dtype=None):
    """Plain version, step by step the arithmetic of ``conv_chain_int8_xla``.
    int8 values are carried as integer-valued float32 (exact)."""
    x = _concat(x)
    out_dtype = out_dtype or x.dtype
    xq = quantize_activation(x, s_in).float()
    geo = layer_geometry(qlayers, out_cout)
    with exact_float32():
        for i, ((wq, meta), (taps, _cin, cout, npad)) in enumerate(zip(qlayers, geo)):
            b, hh, ww, _ = xq.shape
            wi = wq[BIAS_SLOT:]
            if taps == 9:
                pad = F.pad(xq, (0, 0, 1, 1, 1, 1))
                acc = torch.zeros((b, hh, ww, npad), dtype=torch.float32, device=xq.device)
                for dy in range(3):
                    c0 = 3 * dy * npad
                    yi = int_products(pad[:, dy:dy + hh], wi[:, c0:c0 + 3 * npad])
                    yb = (yi * meta[0, c0:c0 + 3 * npad]).to(torch.bfloat16)
                    for dx in range(3):
                        acc = acc + yb[:, :, dx:dx + ww, dx * npad:(dx + 1) * npad].float()
            else:
                acc = (int_products(xq, wi) * meta[0]).to(torch.bfloat16).float()
            acc = acc + meta[1, :npad]
            if acts[i] == "relu":
                acc = torch.relu(acc)
            if i == len(qlayers) - 1:
                return acc[..., :out_cout].to(out_dtype)
            xq = torch.clamp(torch.round(acc[..., :cout] * meta[2, 0]), -QMAX, QMAX)
    raise ValueError("empty int8 conv chain")


def n_tile_i8(cout: int) -> int:
    """The int8 kernel's output-channel tile for a layer of ``cout`` channels
    (wider layers walk N in tiles of the last)."""
    return next((n for n in N_TILES_I8 if cout <= n), N_TILES_I8[-1])


def pack_i8_weights(wi: torch.Tensor, taps: int, ncols: int, cout: int,
                    nt: int | None = None) -> torch.Tensor:
    """Wire-format rows ``(cin, taps·ncols)`` (column ``tap·ncols + n``) → the
    int8 kernel's image, 1-D int8.

    The image is ``[n-tile][chunk][tap][k half][n / 8][n % 8][k % 16]``: for
    each N tile of ``nt`` (default ``n_tile_i8(cout)``) output channels and each 32-channel
    input chunk, the taps of a 32 × N slice in wgmma's K-major core
    matrices (8 output channels × 16 input channels, 128 bytes), the
    chunk's first 16 input channels before its last 16. Input channels past
    ``cin`` and output channels past ``cout`` are zero.
    """
    cin = wi.shape[0]
    nt = nt or n_tile_i8(cout)
    ncot, nch = -(-cout // nt), -(-cin // CHUNK_I8)
    wp = wi.new_zeros((nch * CHUNK_I8, taps, ncot * nt), dtype=torch.int8)
    wp[:cin, :, :cout] = wi.reshape(cin, taps, ncols)[:, :, :cout]
    # (chunk, k half, k % 16, tap, n-tile, n / 8, n % 8) → the image's order
    wp = wp.reshape(nch, 2, 16, taps, ncot, nt // 8, 8).permute(4, 0, 3, 1, 5, 6, 2)
    return wp.contiguous().reshape(-1)


class PackedLayerI8(NamedTuple):
    """One int8 layer as ``nt_conv2d_i8`` takes it: the weight image, the
    dequant factors (taps·cout per column, or cout per channel), the biases
    and the requant factors 1/s_out (cout each), contiguous float32."""

    w: torch.Tensor
    dq: torch.Tensor
    bias: torch.Tensor
    inv: torch.Tensor
    taps: int
    cin: int
    cout: int


def packed_chain(qlayers, out_cout: int) -> list:
    """The :class:`PackedLayerI8` of each layer of a quantised chain whose
    last layer has ``out_cout`` channels (counted in ``dispatch.packs``)."""
    packs = [PackedLayerI8(pack_i8_weights(wq[BIAS_SLOT:], taps, npad, cout),
                           meta[0].reshape(taps, npad)[:, :cout].contiguous().reshape(-1),
                           meta[1, :cout].contiguous(), meta[2, :cout].contiguous(),
                           taps, cin, cout)
             for (wq, meta), (taps, cin, cout, npad) in zip(qlayers,
                                                            layer_geometry(qlayers, out_cout))]
    dispatch.packs["int8"] += 1
    return packs


def quantize_into_plain(xs: Sequence[torch.Tensor], scale: torch.Tensor, out: torch.Tensor,
                        out_c: int) -> torch.Tensor:
    """Plain version of :func:`quantize_into`."""
    off = 0
    for t in xs:
        out[..., off:off + t.shape[-1]] = quantize_activation(t, scale)
        off += t.shape[-1]
    out[..., off:out_c] = 0
    return out


def quantize_into(xs: Sequence[torch.Tensor], scale: torch.Tensor, out: torch.Tensor,
                  out_c: int) -> torch.Tensor:
    """The parts ``xs`` (NHWC, concatenated on channels) quantised by
    ``scale`` (:func:`quantize_activation`) into int8 channels
    ``[0, Σ C)`` of ``out``, channels up to ``out_c`` zero; the rest of
    ``out`` untouched. A CUDA ``out`` runs ``nt_quantize_i8``, one launch."""
    total = sum(t.shape[-1] for t in xs)
    if (not 1 <= len(xs) <= MAX_PARTS or any(t.shape[:3] != out.shape[:3] for t in xs)
            or not total <= out_c <= out.shape[-1] or out.dtype != torch.int8):
        raise ValueError(f"int8 quantisation of {[tuple(t.shape) for t in xs]} into channels "
                         f"[0, {out_c}) of an int8 {tuple(out.shape)}")
    if not dispatch.use_kernel(*xs, scale, out):
        return quantize_into_plain(xs, scale, out, out_c)
    xs = [t.contiguous() for t in xs]
    dt = xs[0].dtype
    if (any(t.dtype != dt for t in xs) or dt not in (torch.float32, torch.bfloat16)
            or scale.dtype != torch.float32 or scale.numel() != 1 or not out.is_contiguous()):
        raise ValueError("int8 quantisation takes float32 or bfloat16 parts of one dtype, a "
                         "float32 scale and a contiguous output")
    ptrs = [t.data_ptr() for t in xs] + [xs[0].data_ptr()] * (MAX_PARTS - len(xs))
    widths = [t.shape[-1] for t in xs] + [0] * (MAX_PARTS - len(xs))
    b, h, w = out.shape[:3]
    _build.launch("nt_quantize_i8", out.device, *ptrs, len(xs), *widths, scale.data_ptr(),
                  out.data_ptr(), out.shape[-1], out_c, b, h, w, _build.dtype_code(xs[0]))
    dispatch.launches["quantize_i8"] += 1
    return out


# Tap schedules of ``nt_conv2d_i8`` (csrc/nerve_tpu_torch.h): per-tap
# dequantisation with dy or dx as the outer loop, or the nine taps summed in
# int32 and dequantised once by per-channel factors.
TAPS_DY, TAPS_DX, TAPS_INT32 = 0, 1, 2


def conv_layer_launch_i8(x: torch.Tensor, layer: PackedLayerI8, out: torch.Tensor,
                         out_coff: int, relu: bool, taps_mode: int = TAPS_DY) -> None:
    """Launch ``nt_conv2d_i8``: int8 channels [0, layer.cin) of ``x`` →
    channels [out_coff, out_coff + cout) of ``out`` (int8 requantised by
    ``layer.inv``, or the real value in bfloat16/float32). ``layer.dq``
    holds taps·cout per-column factors, or cout per-channel ones for
    ``TAPS_INT32``; a 1×1 layer takes ``TAPS_DY`` only."""
    b, h, wd, xcs = x.shape
    w, dq, bias, inv, taps, cin, cout = layer
    nt = n_tile_i8(cout)
    image = -(-cout // nt) * nt * -(-cin // CHUNK_I8) * CHUNK_I8 * taps
    if taps not in (1, 9) or w.shape != (image,) or cin > xcs or xcs % 16:
        raise ValueError(f"int8 conv layer: weight image {tuple(w.shape)} does not fit "
                         f"{taps} taps x {cin} -> {cout} on an input with {xcs} channels "
                         "(a multiple of 16)")
    ndq = cout if taps_mode == TAPS_INT32 else taps * cout
    if (taps_mode not in (TAPS_DY, TAPS_DX, TAPS_INT32) or (taps_mode != TAPS_DY and taps != 9)
            or tuple(dq.shape) != (ndq,)
            or tuple(bias.shape) != (cout,)
            or tuple(inv.shape) != (cout,) or out_coff + cout > out.shape[-1]
            or out.shape[:3] != x.shape[:3]):
        raise ValueError(f"int8 conv layer: dq {tuple(dq.shape)}, bias {tuple(bias.shape)}, "
                         f"inv {tuple(inv.shape)} or output {tuple(out.shape)} at {out_coff} "
                         f"do not fit {taps} taps x {cout} channels")
    tensors = (x, w, dq, bias, inv, out)
    if not (x.dtype == w.dtype == torch.int8 and dq.dtype == bias.dtype == inv.dtype
            == torch.float32 and all(t.is_contiguous() for t in tensors)
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        raise ValueError("int8 conv layer takes contiguous int8 activations and weights "
                         "(16-byte aligned) and float32 factors")
    _build.launch("nt_conv2d_i8", x.device, x.data_ptr(), xcs, cin, w.data_ptr(),
                  dq.data_ptr(), bias.data_ptr(), inv.data_ptr(), out.data_ptr(),
                  out.shape[-1], out_coff, cout, b, h, wd, 3 if taps == 9 else 1,
                  int(relu), _build.dtype_code(out), taps_mode)


def conv_chain_int8_apply(x, qchain, out_cout: int, out_dtype=None,
                          packed=None) -> torch.Tensor:
    """Run a quantised chain: (B, H, W, Cin) or a list → (B, H, W, out_cout).
    ``packed``: the chain's :func:`packed_chain`, or None to pack at this
    call (the kernels' path only)."""
    qlayers, s_in, acts = qchain
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    out_dtype = out_dtype or xs[0].dtype
    geo = layer_geometry(qlayers, out_cout)
    cin = sum(t.shape[-1] for t in xs)
    if cin != geo[0][1] or len(acts) != len(qlayers):
        raise ValueError(f"int8 chain input has {cin} channels, the first layer takes "
                         f"{geo[0][1]}; {len(acts)} activations for {len(qlayers)} layers")
    if not dispatch.use_kernel(*xs, s_in, *(t for layer in qlayers for t in layer)):
        return conv_chain_int8_plain(xs, qlayers, s_in, acts, out_cout, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8 chain output must be float32 or bfloat16, got {out_dtype}")
    b, h, w = xs[0].shape[:3]
    # Channel strides are multiples of 16 (TMA's 16-byte pixel strides), also
    # for the 3-channel frames and the 81-channel cost volume.
    hq = torch.empty((b, h, w, _ceil_to(cin, 16)), dtype=torch.int8, device=xs[0].device)
    quantize_into(xs, s_in, hq, hq.shape[-1])
    packed = packed_chain(qlayers, out_cout) if packed is None else packed
    if len(packed) != len(qlayers):
        raise ValueError(f"{len(packed)} packed layers for a chain of {len(qlayers)}")
    for i, layer in enumerate(packed):
        last = i == len(qlayers) - 1
        out = torch.empty((b, h, w, layer.cout if last else _ceil_to(layer.cout, 16)),
                          dtype=out_dtype if last else torch.int8, device=hq.device)
        conv_layer_launch_i8(hq, layer, out, 0, acts[i] == "relu")
        dispatch.launches["conv_chain_int8"] += 1
        hq = out
    return hq
