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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nerve_tpu_torch.ops import _build, dispatch

MAX_KERNEL_DISPLACEMENT = 4  # the kernel is instantiated for d = 1..4


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
    d = max_displacement
    if not dispatch.use_kernel(f1, f2):
        return correlation_plain(f1, f2, d)
    if not 1 <= d <= MAX_KERNEL_DISPLACEMENT:
        raise ValueError(f"the correlation kernel takes 1 <= d <= "
                         f"{MAX_KERNEL_DISPLACEMENT}, got {d}")
    b, h, w, c = f1.shape
    f1, f2 = f1.contiguous(), f2.contiguous()
    out = torch.empty((b, h, w, (2 * d + 1) ** 2), dtype=f1.dtype, device=f1.device)
    _build.launch("nt_correlation", f1.device, f1.data_ptr(), f2.data_ptr(),
                  out.data_ptr(), b, h, w, c, d, _build.dtype_code(f1))
    dispatch.launches["correlation"] += 1
    return out
