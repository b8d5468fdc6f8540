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

A CUDA tensor runs ``csrc/conv_int8.cu``, one launch per layer, through
int8 device buffers; a CPU tensor runs ``conv_chain_int8_plain``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch
from nerve_tpu_torch.ops.conv_chain import _concat, _layer_specs, conv_chain_plain

BIAS_SLOT = 8  # leading zero rows of the wire format's weight matrices
MIN_NOUT = 64  # output columns are padded up to a multiple of this
QMAX = 127.0


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


def tap_major(wi: torch.Tensor, taps: int, ncols: int, cout: int) -> torch.Tensor:
    """Wire-format rows ``(cin, taps·ncols)`` → the kernel's int8
    ``(taps, cout, ceil16(cin))``, zero beyond cin."""
    cin = wi.shape[0]
    w = wi.reshape(cin, taps, ncols)[:, :, :cout].permute(1, 2, 0)
    return F.pad(w, (0, _ceil_to(cin, 16) - cin)).contiguous()


def conv_layer_launch_i8(x: torch.Tensor, cin: int, w: torch.Tensor, dq: torch.Tensor,
                         bias: torch.Tensor, inv: torch.Tensor, out: torch.Tensor,
                         out_coff: int, relu: bool) -> None:
    """Launch ``nt_conv2d_i8``: int8 channels [0, cin) of ``x`` → channels
    [out_coff, out_coff + cout) of ``out`` (int8 requantised by ``inv``, or
    the real value in bfloat16/float32). ``w`` from :func:`tap_major`."""
    b, h, wd, xcs = x.shape
    taps, cout, wks = w.shape
    if taps not in (1, 9) or wks != _ceil_to(cin, 16) or cin > xcs or xcs % 16:
        raise ValueError(f"int8 conv layer: weights {tuple(w.shape)} do not fit cin={cin} "
                         f"of an input with {xcs} channels (a multiple of 16)")
    if (tuple(dq.shape) != (taps * cout,) or tuple(bias.shape) != (cout,)
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
                  int(relu), _build.dtype_code(out))


def conv_chain_int8_apply(x, qchain, out_cout: int, out_dtype=None) -> torch.Tensor:
    """Run a quantised chain: (B, H, W, Cin) or a list → (B, H, W, out_cout)."""
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
    # Channel strides are multiples of 16, so the kernel moves 16-byte rows
    # even for the 3-channel frames and the 81-channel cost volume.
    hq = torch.empty((b, h, w, _ceil_to(cin, 16)), dtype=torch.int8, device=xs[0].device)
    off = 0
    for t in xs:
        hq[..., off:off + t.shape[-1]] = quantize_activation(t, s_in)
        off += t.shape[-1]
    for i, ((wq, meta), (taps, cin_i, cout, npad)) in enumerate(zip(qlayers, geo)):
        last = i == len(qlayers) - 1
        out = torch.empty((b, h, w, cout if last else _ceil_to(cout, 16)),
                          dtype=out_dtype if last else torch.int8, device=hq.device)
        conv_layer_launch_i8(hq, cin_i, tap_major(wq[BIAS_SLOT:], taps, npad, cout),
                             meta[0].reshape(taps, npad)[:, :cout].reshape(-1),
                             meta[1, :cout], meta[2, :cout], out, 0, acts[i] == "relu")
        dispatch.launches["conv_chain_int8"] += 1
        hq = out
    return hq
