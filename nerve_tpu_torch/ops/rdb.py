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

A CUDA tensor runs the hand-written kernels. A stack call keeps two
(B, H, W, ceil8(C + L·G)) concatenation buffers (``stack_plan``): the
stack's input is copied into channels [0, C) of the first, once; in each
block the dense layers run ``nt_conv2d`` (``csrc/conv_chain.cu``) writing
into their channel slots, and ``nt_rdb_lff`` (``csrc/rdb.cu``) fuses, adds
the residual and writes the next block's input into channels [0, C) of the
other buffer (the last block writes a (B, H, W, C) tensor). A CPU tensor
runs ``rdb_plain``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch
from nerve_tpu_torch.ops.conv_chain import conv_layer_launch, pack_conv_weights

RES_SCALE = 0.2
LFF_N_TILE = 64  # the bf16 fusion kernel's output-channel tile (csrc NT_LFF_N_TILE)


def stack_plan(num_blocks: int) -> List[Tuple[int, Optional[int]]]:
    """The buffers of a stack of ``num_blocks`` blocks on the kernels' path:
    for block k, (the buffer it reads, the buffer into whose channels
    [0, C) its fusion writes the next block's input, or None where it
    writes the stack's output). Two buffers alternate, so that no fusion
    writes the buffer it reads (a second N tile of the same pixels would
    read overwritten channels). The int8 stack (``ops.rdb_int8``) keeps the
    same plan."""
    return [(k % 2, (k + 1) % 2 if k + 1 < num_blocks else None) for k in range(num_blocks)]


def lff_plain(cat: torch.Tensor, lw: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Plain version of the fusion on the leading ``ccat`` channels of
    ``cat`` (``lw`` is (ccat, C)): ``(cat · lw + lb) · 0.2 + cat[..., :C]``
    in float32, rounded once to cat's dtype."""
    ccat, c = lw.shape
    lff = torch.matmul(cat[..., :ccat].float(), lw.float()) + lb.float()
    return (lff * RES_SCALE + cat[..., :c].float()).to(cat.dtype)


def rdb_plain(x: torch.Tensor, params: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: ``F.conv2d`` dense layers, float32 fusion (``lff_plain``)."""
    num_layers = len(params) // 2 - 1
    dt = x.dtype
    feats = [x.permute(0, 3, 1, 2)]
    for i in range(num_layers):
        wk, bk = params[2 * i], params[2 * i + 1]
        inp = feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)
        y = F.conv2d(inp, wk.to(dt).permute(3, 2, 0, 1), padding=1)
        y = y.float() + bk.float()[:, None, None]
        feats.append(torch.relu(y).to(dt))
    return lff_plain(torch.cat(feats, dim=1).permute(0, 2, 3, 1), params[-2], params[-1])


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _block_width(params: Sequence[torch.Tensor], c: int) -> int:
    """C + L·G of a block on C channels; raises where the block does not fit."""
    lw, lb = params[-2], params[-1]
    ctot = lw.shape[0]
    if tuple(lw.shape) != (ctot, c) or tuple(lb.shape) != (c,):
        raise ValueError(f"RDB fusion weight {tuple(lw.shape)} / bias {tuple(lb.shape)} "
                         f"does not fit C={c}")
    off = c + sum(params[2 * i].shape[-1] for i in range(len(params) // 2 - 1))
    if off != ctot:
        raise ValueError(f"RDB dense layers give {off} channels, fusion takes {ctot}")
    return ctot


def _rdb_chain_kernel(x: torch.Tensor, params_list) -> torch.Tensor:
    b, h, w, c = x.shape
    widths = {_block_width(params, c) for params in params_list}
    if len(widths) != 1:
        raise ValueError(f"RDB blocks of different widths {sorted(widths)} in one stack")
    ccat = widths.pop()
    # TMA reads the buffers: 16-byte pixel strides (8 bf16 channels).
    cats = [torch.empty((b, h, w, _ceil8(ccat)), dtype=x.dtype, device=x.device)
            for _ in range(min(len(params_list), 2))]
    cats[0][..., :c] = x
    out = x
    for (src, dst), params in zip(stack_plan(len(params_list)), params_list):
        cat = cats[src]
        off = c
        for i in range(len(params) // 2 - 1):
            wk, bk = params[2 * i], params[2 * i + 1]
            conv_layer_launch(cat, off, wk, bk.float().contiguous(), cat, off, relu=True)
            off += wk.shape[-1]
        out = lff_launch(cat, params[-2], params[-1], None if dst is None else cats[dst])
        dispatch.launches["rdb"] += 1
    return out


def lff_launch(cat: torch.Tensor, lw: torch.Tensor, lb: torch.Tensor,
               out: Optional[torch.Tensor] = None, out_coff: int = 0) -> torch.Tensor:
    """Launch ``nt_rdb_lff`` on the leading ``ccat`` channels of a
    concatenation buffer ``cat`` (B, H, W, ≥ ccat), ``lw`` (ccat, C) at any
    float dtype (packed in bf16 at the fusion's N tile for a bf16 ``cat``),
    ``lb`` (C,): ``(cat · lw + lb) · 0.2 + cat[..., :C]`` in float32, rounded
    once, into channels [out_coff, out_coff + C) of ``out`` (a new
    (B, H, W, C) tensor where None), which must not share ``cat``'s storage.
    Returns ``out``."""
    b, h, w, ccs = cat.shape
    ccat, c = lw.shape
    if out is None:
        out = torch.empty((b, h, w, c), dtype=cat.dtype, device=cat.device)
    if (ccat > ccs or c > ccat or tuple(lb.shape) != (c,) or out.shape[:3] != cat.shape[:3]
            or out_coff < 0 or out_coff + c > out.shape[-1]):
        raise ValueError(f"RDB fusion {tuple(lw.shape)}, bias {tuple(lb.shape)} does not fit "
                         f"{tuple(cat.shape)} -> {tuple(out.shape)} at {out_coff}")
    if not (cat.is_contiguous() and out.is_contiguous() and out.dtype == cat.dtype):
        raise ValueError("RDB fusion takes contiguous input and output of one dtype")
    if out.untyped_storage().data_ptr() == cat.untyped_storage().data_ptr():
        raise ValueError("RDB fusion output shares the concatenation buffer's storage")
    if cat.dtype == torch.bfloat16:
        if ccs % 8 or cat.data_ptr() % 16:
            raise ValueError(f"bf16 RDB fusion reads through TMA: channel stride {ccs} must "
                             "be a multiple of 8 and the buffer 16-byte aligned")
        wk = pack_conv_weights(lw.reshape(1, 1, ccat, c), LFF_N_TILE)
    elif cat.dtype == torch.float32:
        wk = lw.float().contiguous()
    else:
        raise TypeError(f"the RDB fusion takes float32 or bfloat16, got {cat.dtype}")
    lbf = lb.float().contiguous()
    _build.launch("nt_rdb_lff", cat.device, cat.data_ptr(), ccs, ccat, wk.data_ptr(),
                  lbf.data_ptr(), out.data_ptr(), out.shape[-1], out_coff, c, b, h, w,
                  RES_SCALE, _build.dtype_code(cat))
    dispatch.launches["rdb_lff"] += 1
    return out


def rdb_apply(x: torch.Tensor, params: Sequence[torch.Tensor]) -> torch.Tensor:
    """One residual dense block: (B, H, W, C) → (B, H, W, C)."""
    return rdb_chain_apply(x, [params])


def rdb_chain_plain(x: torch.Tensor, params_list) -> torch.Tensor:
    for params in params_list:
        x = rdb_plain(x, params)
    return x


def rdb_chain_apply(x: torch.Tensor, params_list) -> torch.Tensor:
    """The RDB stack: the blocks of ``params_list`` in order."""
    if not params_list:
        return x
    if not dispatch.use_kernel(x, *(p for params in params_list for p in params)):
        return rdb_chain_plain(x, params_list)
    return _rdb_chain_kernel(x, params_list)
