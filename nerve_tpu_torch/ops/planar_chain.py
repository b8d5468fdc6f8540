"""A conv chain on planar (channels-major) tensors, fused into one launch.

Counterpart of ``nerve_tpu/ops/planar_chain.py``: ``planar_chain_apply(x,
params)`` runs the chain of ``conv_chain_apply`` (the same ``(kernel,
bias, act)`` entries: HWIO 3×3 / 1×1 kernels, ``(3, 3, C)`` depthwise
ones) on x of shape (B, C, H, W) and returns (B, Cout, H, W). Numerics are
those of the reference formulation ``_planar_xla``: ``_chain_xla`` on the
NHWC view, one rounding to the input dtype after each convolution's sum and
after each layer.

A CUDA tensor runs ``csrc/planar_chain.cu``: the whole chain in one launch,
every intermediate in shared memory (counter ``planar_chain``). A CPU
tensor runs ``planar_chain_plain``. The JAX tile arguments (``tile``,
``fit_vmem``) are gone: the kernel picks its tile from shared memory.
"""

from __future__ import annotations

from typing import Sequence

import torch

from nerve_tpu_torch.ops import _build, dispatch
from nerve_tpu_torch.ops.conv_chain import Entry, _layer_specs, conv_chain_plain

KIND_CODES = {"3x3": 0, "1x1": 1, "dw3": 2}
MAX_LAYERS, MAX_CHANNELS = 16, 64  # csrc/planar_chain.cu


def planar_chain_plain(x: torch.Tensor, params: Sequence[Entry]) -> torch.Tensor:
    """Plain version: ``conv_chain_plain`` on the NHWC view."""
    return conv_chain_plain(x.permute(0, 2, 3, 1), params).permute(0, 3, 1, 2).contiguous()


def _ceil16(c: int) -> int:
    return -(-c // 16) * 16


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    return torch.cat([raw, raw.new_zeros(-raw.numel() % 16)])


def pack_planar_chain(params: Sequence[Entry], dtype: torch.dtype, device):
    """The kernel's weight pack (uint8 on ``device``) and layer table (int32
    on the CPU, 6 per layer: kind, cin, cout, relu, weight and bias byte
    offsets). Dense weights are ``dtype`` [taps][ceil16(cout)][ceil16(cin)
    + 8], depthwise ones float32 [9][ceil16(c)], biases float32
    [ceil16(cout)], zero wherever padded; weights are rounded through
    ``dtype`` as the reference rounds them."""
    chunks, table, off = [], [], 0
    for (w, bias, act), (kind, cin, cout, _act) in zip(params, _layer_specs(params)):
        npad = _ceil16(cout)
        wr = w.to(device=device, dtype=dtype)
        if kind == "dw3":
            wp = torch.zeros((9, npad), dtype=torch.float32, device=device)
            wp[:, :cin] = wr.float().reshape(9, cin)
        else:
            taps = 9 if kind == "3x3" else 1
            wp = torch.zeros((taps, npad, _ceil16(cin) + 8), dtype=dtype, device=device)
            wp[:, :cout, :cin] = wr.reshape(taps, cin, cout).transpose(1, 2)
        bp = torch.zeros((npad,), dtype=torch.float32, device=device)
        bp[:cout] = bias.to(device).float()
        wb, bb = _as_bytes(wp), _as_bytes(bp)
        table += [KIND_CODES[kind], cin, cout, int(act == "relu"), off, off + wb.numel()]
        chunks += [wb, bb]
        off += wb.numel() + bb.numel()
    return torch.cat(chunks), torch.tensor(table, dtype=torch.int32)


def planar_chain_apply(x: torch.Tensor, params: Sequence[Entry]) -> torch.Tensor:
    """Run a conv(+relu) chain on a planar (B, C, H, W) tensor → (B, Cout, H, W)."""
    specs = _layer_specs(params)
    if x.ndim != 4 or x.shape[1] != specs[0][1]:
        raise ValueError(f"planar_chain input {tuple(x.shape)}: the first layer takes "
                         f"{specs[0][1]} channels on axis 1")
    if not dispatch.use_kernel(x, *(p for w, b, _ in params for p in (w, b))):
        return planar_chain_plain(x, params)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the planar chain kernel takes float32 or bfloat16, got {x.dtype}")
    if len(specs) > MAX_LAYERS or max(max(s[1], s[2]) for s in specs) > MAX_CHANNELS:
        raise ValueError(f"the planar chain kernel takes up to {MAX_LAYERS} layers of up "
                         f"to {MAX_CHANNELS} channels")
    b, _c, h, w = x.shape
    x = x.contiguous()
    out = torch.empty((b, specs[-1][2], h, w), dtype=x.dtype, device=x.device)
    wpack, table = pack_planar_chain(params, x.dtype, x.device)
    _build.launch("nt_planar_chain", x.device, x.data_ptr(), out.data_ptr(), wpack.data_ptr(),
                  table.data_ptr(), len(specs), b, h, w, _build.dtype_code(x))
    dispatch.launches["planar_chain"] += 1
    return out
