"""Residual dense block (RDB): the SR network's FLOP hot spot.

Counterpart of ``nerve_tpu/ops/rdb.py``. ``params`` is
``(w_0, b_0, …, w_{L-1}, b_{L-1}, lw, lb)``: dense layer i is a SAME 3×3
conv ``(3, 3, C + i·G, G)`` over the concatenation of the input and every
earlier layer's output, with relu; ``lw`` is the 1×1 local feature fusion
as a 2-D ``(C + L·G, C)`` matrix. The block returns
``0.2 · (concat · lw + lb) + x``.

Numerics are those of ``_rdb_xla``: each dense layer's sum is rounded to the
input dtype, plus float32 bias, relu, rounded again; the fusion runs in
float32 and rounds once.

A CUDA tensor runs the hand-written kernels: the wrapper allocates one
(B, H, W, C + L·G) concatenation buffer per block, the dense layers run
``nt_conv2d`` (``csrc/conv_chain.cu``) writing into their channel slots,
and ``nt_rdb_lff`` (``csrc/rdb.cu``) fuses and adds the residual. A CPU
tensor runs ``rdb_plain``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch
from nerve_tpu_torch.ops.conv_chain import conv_layer_launch

RES_SCALE = 0.2


def rdb_plain(x: torch.Tensor, params: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: ``F.conv2d`` dense layers, float32 einsum fusion."""
    num_layers = len(params) // 2 - 1
    lw, lb = params[-2], params[-1]
    dt = x.dtype
    feats = [x.permute(0, 3, 1, 2)]
    for i in range(num_layers):
        wk, bk = params[2 * i], params[2 * i + 1]
        inp = feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)
        y = F.conv2d(inp, wk.to(dt).permute(3, 2, 0, 1), padding=1)
        y = y.float() + bk.float()[:, None, None]
        feats.append(torch.relu(y).to(dt))
    full = torch.cat(feats, dim=1).float()
    lff = torch.einsum("bkhw,kn->bhwn", full, lw.float()) + lb.float()
    return (lff * RES_SCALE + x.float()).to(dt)


def _rdb_kernel(x: torch.Tensor, params: Sequence[torch.Tensor]) -> torch.Tensor:
    b, h, w, c = x.shape
    num_layers = len(params) // 2 - 1
    lw, lb = params[-2], params[-1]
    ctot = lw.shape[0]
    if tuple(lw.shape) != (ctot, c) or tuple(lb.shape) != (c,):
        raise ValueError(f"RDB fusion weight {tuple(lw.shape)} / bias {tuple(lb.shape)} "
                         f"does not fit C={c}")
    cat = torch.empty((b, h, w, ctot), dtype=x.dtype, device=x.device)
    cat[..., :c] = x
    off = c
    for i in range(num_layers):
        wk, bk = params[2 * i], params[2 * i + 1]
        conv_layer_launch(cat, off, wk, bk.float().contiguous(), cat, off, relu=True)
        off += wk.shape[-1]
    if off != ctot:
        raise ValueError(f"RDB dense layers give {off} channels, fusion takes {ctot}")
    return lff_launch(cat, lw, lb)


def lff_launch(cat: torch.Tensor, lw: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Launch ``nt_rdb_lff`` on a full concatenation buffer (B, H, W, C + L·G):
    ``(cat · lw + lb) · 0.2 + cat[..., :C]`` in float32, rounded once."""
    b, h, w, ctot = cat.shape
    c = lw.shape[1]
    out = torch.empty((b, h, w, c), dtype=cat.dtype, device=cat.device)
    lwf, lbf = lw.float().contiguous(), lb.float().contiguous()
    _build.launch("nt_rdb_lff", cat.device, cat.data_ptr(), ctot, lwf.data_ptr(),
                  lbf.data_ptr(), out.data_ptr(), c, b, h, w, RES_SCALE,
                  _build.dtype_code(cat))
    return out


def rdb_apply(x: torch.Tensor, params: Sequence[torch.Tensor]) -> torch.Tensor:
    """One residual dense block: (B, H, W, C) → (B, H, W, C)."""
    if not dispatch.use_kernel(x, *params):
        return rdb_plain(x, params)
    out = _rdb_kernel(x, params)
    dispatch.launches["rdb"] += 1
    return out


def rdb_chain_plain(x: torch.Tensor, params_list) -> torch.Tensor:
    for params in params_list:
        x = rdb_plain(x, params)
    return x


def rdb_chain_apply(x: torch.Tensor, params_list) -> torch.Tensor:
    """The RDB stack: the blocks of ``params_list`` in order."""
    for params in params_list:
        x = rdb_apply(x, params)
    return x
