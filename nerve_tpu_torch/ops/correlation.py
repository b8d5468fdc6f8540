"""Cost-volume correlation for optical-flow estimation (NHWC).

Counterpart of ``nerve_tpu/ops/correlation.py``. For displacements (i, j)
in [-d, d]²::

    corr[b, h, w, (i+d)(2d+1) + (j+d)] = (1/C) Σ_c f1[b,h,w,c] · f2[b,h+i,w+j,c]

with zeros outside f2. Numerics are those of the TPU kernels: each product
is rounded to the input dtype (exact in float32 first: a bfloat16 product
fits), the products are summed in float32, the sum is multiplied by the
float32 ``1/C`` and rounded once to the input dtype. A CUDA tensor runs
``csrc/correlation.cu``; a CPU tensor runs ``correlation_plain``, the 81
shifted products.

The kernel reads its inputs by TMA, whose tensor maps need a pixel stride
that is a multiple of 16 bytes: ``kernel_inputs`` pads other channel counts
with zero channels (to a multiple of 8 in bfloat16, 4 in float32), which
add nothing to the sums, and the kernel divides by the true C.

Under autograd the volume is a ``torch.autograd.Function``
(``_Correlation``), the port of ``_correlation_tpu``'s ``custom_vjp``: the
forward is the dispatch above, the backward the vjp of
``correlation_plain`` (each product rounded to the input dtype) recomputed
from the saved f1 and f2, as ``_corr_bwd`` takes the vjp of
``_correlation_xla``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch

MAX_KERNEL_DISPLACEMENT = 4  # the kernel is instantiated for d = 1..4
LAUNCH_RECORD = ("grid", "threads", "dynamic_smem_bytes", "static_smem_bytes", "registers",
                 "spill_bytes", "tiles")


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, d: int) -> torch.Tensor:
    """Plain version: (2d+1)² shifted products in the input dtype, float32 sums."""
    b, h, w, c = f1.shape
    f2p = F.pad(f2, (0, 0, d, d, d, d))
    inv_c = torch.tensor(1.0 / c, dtype=torch.float32, device=f1.device)
    outs = []
    for i in range(2 * d + 1):
        for j in range(2 * d + 1):
            outs.append((f1 * f2p[:, i : i + h, j : j + w]).float().sum(-1))
    return (torch.stack(outs, dim=-1) * inv_c).to(f1.dtype)


def kernel_inputs(f1: torch.Tensor, f2: torch.Tensor, d: int):
    """The kernel's operands: ``(f1, f2, c)``, contiguous, with a channel
    count padded by zero channels to a pixel stride of a multiple of 16
    bytes, and the true C. Raises on what the kernel does not take."""
    if f1.dim() != 4:
        raise ValueError(f"the correlation kernel takes (B, H, W, C) inputs, got {tuple(f1.shape)}")
    if f1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the correlation kernel takes float32 or bfloat16, got {f1.dtype}")
    if not 1 <= d <= MAX_KERNEL_DISPLACEMENT:
        raise ValueError(f"the correlation kernel takes 1 <= d <= "
                         f"{MAX_KERNEL_DISPLACEMENT}, got {d}")
    if f1.numel() == 0:
        raise ValueError(f"the correlation kernel takes non-empty inputs, got {tuple(f1.shape)}")
    c = f1.shape[-1]
    per16 = 16 // f1.element_size()
    pad = -c % per16
    if pad:
        return F.pad(f1, (0, pad)), F.pad(f2, (0, pad)), c
    return f1.contiguous(), f2.contiguous(), c


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def correlation_volume(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 4,
                       planar: bool | None = None) -> torch.Tensor:
    """(B, H, W, C) × 2 → (B, H, W, (2d+1)²) cost volume, normalised by C.

    ``planar`` is the JAX argument that picks the channel-planar TPU kernel
    (``_corr_kernel_planar``) or the NHWC one (``_corr_kernel``). Both
    compute the same function on NHWC input and output, so every value
    runs ``csrc/correlation.cu``, which covers both.
    """
    del planar
    if f1.shape != f2.shape or f1.dtype != f2.dtype:
        raise ValueError(f"f1 {tuple(f1.shape)} {f1.dtype} and f2 "
                         f"{tuple(f2.shape)} {f2.dtype} differ")
    if dispatch.needs_grad(f1, f2):
        return _Correlation.apply(max_displacement, f1, f2)
    return _volume(f1, f2, max_displacement)


class _Correlation(torch.autograd.Function):
    """Forward by dispatch, backward the vjp of ``correlation_plain``."""

    @staticmethod
    def forward(ctx, d, f1, f2):
        ctx.d = d
        ctx.save_for_backward(f1, f2)
        return _volume(f1, f2, d)

    @staticmethod
    def backward(ctx, g):
        d = ctx.d
        grads = dispatch.recompute_vjp(lambda a, b: correlation_plain(a, b, d),
                                       ctx.saved_tensors, ctx.needs_input_grad[1:], g)
        return (None, *grads)


def _volume(f1: torch.Tensor, f2: torch.Tensor, d: int) -> torch.Tensor:
    if not dispatch.use_kernel(f1, f2):
        return correlation_plain(f1, f2, d)
    f1k, f2k, c = kernel_inputs(f1, f2, d)
    f1k, f2k = _aligned(f1k), _aligned(f2k)
    b, h, w, cs = f1k.shape
    out = torch.empty((b, h, w, (2 * d + 1) ** 2), dtype=f1.dtype, device=f1.device)
    _build.launch("nt_correlation", f1.device, f1k.data_ptr(), f2k.data_ptr(),
                  out.data_ptr(), b, h, w, c, cs, d, _build.dtype_code(f1))
    dispatch.launches["correlation"] += 1
    return out


def launch_record(f1: torch.Tensor, f2: torch.Tensor, d: int) -> dict:
    """What ``correlation_volume(f1, f2, d)`` launches on the card, without
    launching it: grid, threads, shared memory, and the kernel's registers
    and spill bytes (``cudaFuncGetAttributes``), and the number of tiles."""
    if not dispatch.use_kernel(f1, f2):
        raise ValueError("the launch record is the card's: pass CUDA tensors")
    f1k, f2k, c = kernel_inputs(f1, f2, d)
    f1k, f2k = _aligned(f1k), _aligned(f2k)
    b, h, w, cs = f1k.shape
    rec = (ctypes.c_int * len(LAUNCH_RECORD))()
    _build.launch("nt_correlation_launch", f1.device, f1k.data_ptr(), f2k.data_ptr(), b, h, w,
                  c, cs, d, _build.dtype_code(f1), ctypes.addressof(rec))
    return dict(zip(LAUNCH_RECORD, rec))
