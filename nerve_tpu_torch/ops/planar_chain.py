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

The kernel reads its weights from a pack (``PlanarPack``, made by
``packed_planar_chain``). Make it once for a chain and dtype and pass it as
``packed=``: a call then checks its arguments and launches once. Without
it the call packs the weights itself, about a hundred small ATen
operations. A pack whose chain, dtype or device differs from the call's is
refused, on either device, and so is one made from other weight tensors
than the call's or from weights changed in place since (by their version
counters: ``load_state_dict``, ``.copy_``); pack again after the weights
change. An inference tensor keeps no version counter, so for one made
under ``torch.inference_mode()`` only its identity is checked.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch
from nerve_tpu_torch.ops.conv_chain import Entry, _layer_specs, conv_chain_plain

KIND_CODES = {"3x3": 0, "1x1": 1, "dw3": 2}
HEAD_CODE = 3  # a first bf16 3x3 layer of at most HEAD_MAX_CIN channels, taps folded into K
HEAD_MAX_CIN, HEAD_K = 3, 32
MAX_LAYERS, MAX_CHANNELS = 16, 64  # csrc/planar_chain.cu


def planar_chain_plain(x: torch.Tensor, params: Sequence[Entry]) -> torch.Tensor:
    """Plain version: ``conv_chain_plain`` on the NHWC view."""
    return conv_chain_plain(x.permute(0, 2, 3, 1), params).permute(0, 3, 1, 2).contiguous()


def _ceil16(c: int) -> int:
    return -(-c // 16) * 16


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    return torch.cat([raw, raw.new_zeros(-raw.numel() % 16)])


def folds_head(specs, dtype: torch.dtype) -> bool:
    """Whether the kernel runs the first layer as one product over K = 32."""
    kind, cin = specs[0][:2]
    return dtype == torch.bfloat16 and kind == "3x3" and cin <= HEAD_MAX_CIN


def pack_planar_chain(params: Sequence[Entry], dtype: torch.dtype, device):
    """The kernel's weight pack (uint8 on ``device``) and layer table (int32
    on the CPU, 6 per layer: kind, cin, cout, relu, weight and bias byte
    offsets). Dense weights are ``dtype`` [taps][ceil16(cout)][ceil16(cin)
    + 8], depthwise ones float32 [9][ceil16(c)], biases float32
    [ceil16(cout)], zero wherever padded; a folded bfloat16 head (kind 3,
    ``folds_head``) is [ceil16(cout)][32 + 8] with column k = c · 9 + tap.
    Weights are rounded through ``dtype`` as the reference rounds them."""
    specs = _layer_specs(params)
    chunks, table, off = [], [], 0
    for i, ((w, bias, act), (kind, cin, cout, _act)) in enumerate(zip(params, specs)):
        npad = _ceil16(cout)
        wr = w.to(device=device, dtype=dtype)
        code = KIND_CODES[kind]
        if kind == "dw3":
            wp = torch.zeros((9, npad), dtype=torch.float32, device=device)
            wp[:, :cin] = wr.float().reshape(9, cin)
        elif i == 0 and folds_head(specs, dtype):
            code = HEAD_CODE
            wp = torch.zeros((npad, HEAD_K + 8), dtype=dtype, device=device)
            wp[:cout, :9 * cin] = wr.permute(3, 2, 0, 1).reshape(cout, 9 * cin)
        else:
            taps = 9 if kind == "3x3" else 1
            wp = torch.zeros((taps, npad, _ceil16(cin) + 8), dtype=dtype, device=device)
            wp[:, :cout, :cin] = wr.reshape(taps, cin, cout).transpose(1, 2)
        bp = torch.zeros((npad,), dtype=torch.float32, device=device)
        bp[:cout] = bias.to(device).float()
        wb, bb = _as_bytes(wp), _as_bytes(bp)
        table += [code, cin, cout, int(act == "relu"), off, off + wb.numel()]
        chunks += [wb, bb]
        off += wb.numel() + bb.numel()
    return torch.cat(chunks), torch.tensor(table, dtype=torch.int32)


def _sources(params: Sequence[Entry]):
    """The chain's weight and bias tensors and their version counters (-1
    for an inference tensor, which keeps none)."""
    tensors = tuple(t for w, b, _ in params for t in (w, b))
    return tensors, tuple(-1 if t.is_inference() else t._version for t in tensors)


@dataclass(frozen=True, eq=False)
class PlanarPack:
    """A chain's weights packed for the kernel, with what they were packed from."""

    wpack: torch.Tensor  # uint8, on the device of the calls
    table: torch.Tensor  # int32 layer table, on the CPU
    specs: tuple         # the chain's (kind, cin, cout, act) per layer
    dtype: torch.dtype
    tensors: tuple       # the weight and bias tensors packed, in chain order
    versions: tuple      # their version counters when packed

    def check(self, params: Sequence[Entry], specs, x: torch.Tensor) -> None:
        """Raise unless this pack was made from ``params``' tensors, unchanged
        since, for ``specs`` at ``x``'s dtype and device."""
        if tuple(specs) != self.specs:
            raise ValueError(f"planar chain pack made for the chain {self.specs}, "
                             f"called with {tuple(specs)}")
        if x.dtype != self.dtype or x.device != self.wpack.device:
            raise ValueError(f"planar chain pack made for {self.dtype} on {self.wpack.device}, "
                             f"called with {x.dtype} on {x.device}")
        tensors, versions = _sources(params)
        if any(a is not b for a, b in zip(tensors, self.tensors)) or versions != self.versions:
            raise ValueError("planar chain pack made from other weights, or its weights "
                             "changed since it was made: pack again")


def packed_planar_chain(params: Sequence[Entry], dtype: torch.dtype, device) -> PlanarPack:
    """Pack ``params`` once for calls on ``dtype`` tensors on ``device``."""
    wpack, table = pack_planar_chain(params, dtype, device)
    return PlanarPack(wpack, table, tuple(_layer_specs(params)), dtype, *_sources(params))


def planar_chain_apply(x: torch.Tensor, params: Sequence[Entry],
                       packed: PlanarPack | None = None) -> torch.Tensor:
    """Run a conv(+relu) chain on a planar (B, C, H, W) tensor → (B, Cout, H, W)."""
    specs = _layer_specs(params)
    if x.ndim != 4 or x.shape[1] != specs[0][1]:
        raise ValueError(f"planar_chain input {tuple(x.shape)}: the first layer takes "
                         f"{specs[0][1]} channels on axis 1")
    if packed is not None:
        packed.check(params, specs, x)
    if not dispatch.use_kernel(x, *(p for w, b, _ in params for p in (w, b))):
        return planar_chain_plain(x, params)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the planar chain kernel takes float32 or bfloat16, got {x.dtype}")
    if len(specs) > MAX_LAYERS or max(max(s[1], s[2]) for s in specs) > MAX_CHANNELS:
        raise ValueError(f"the planar chain kernel takes up to {MAX_LAYERS} layers of up "
                         f"to {MAX_CHANNELS} channels")
    if packed is None:
        packed = packed_planar_chain(params, x.dtype, x.device)
    b, _c, h, w = x.shape
    # The bf16 kernel's tensor maps need rows 16-byte aligned: ragged widths
    # run on a copy padded to 8 columns and return the first w.
    ws = w if x.dtype == torch.float32 else -(-w // 8) * 8
    x = x.contiguous() if ws == w else F.pad(x, (0, ws - w))
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty((b, specs[-1][2], h, ws), dtype=x.dtype, device=x.device)
    _build.launch("nt_planar_chain", x.device, x.data_ptr(), out.data_ptr(),
                  packed.wpack.data_ptr(), packed.table.data_ptr(), len(specs), b, h, w, ws,
                  _build.dtype_code(x))
    dispatch.launches["planar_chain"] += 1
    return out if ws == w else out[..., :w].contiguous()
