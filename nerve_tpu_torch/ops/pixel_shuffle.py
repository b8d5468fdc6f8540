"""Sub-pixel (depth-to-space) rearrangements in NHWC layout.

Counterpart of ``nerve_tpu/ops/pixel_shuffle.py``. Channel order is
``torch.nn.PixelShuffle``'s: input channel ``c*s*s + i*s + j`` goes to
output channel ``c`` at spatial offset ``(i, j)``.

``depth_to_space_packed`` is the serving epilogue's layout: (B, sH, sW*C)
packed rows, byte-identical to row-major (B, sH, sW, C). On a CUDA tensor it
runs the hand-written kernel ``csrc/d2s_packed.cu``; on a CPU tensor its
plain version ``depth_to_space_packed_plain``.
"""

from __future__ import annotations

import torch

from nerve_tpu_torch.ops import _build, dispatch


def _check_channels(c_in: int, scale: int) -> int:
    if c_in % (scale * scale) != 0:
        raise ValueError(f"channels {c_in} not divisible by scale²={scale * scale}")
    return c_in // (scale * scale)


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, H, W, C*s²) → (B, H*s, W*s, C)."""
    b, h, w, c_in = x.shape
    c = _check_channels(c_in, scale)
    x = x.reshape(b, h, w, c, scale, scale).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * scale, w * scale, c)


def pixel_shuffle_planar(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, H, W, C*s²) → channel-first (B, C, H*s, W*s)."""
    b, h, w, c_in = x.shape
    c = _check_channels(c_in, scale)
    p = x.permute(0, 3, 1, 2).reshape(b, c, scale, scale, h, w)
    return p.permute(0, 1, 4, 2, 5, 3).reshape(b, c, h * scale, w * scale)


def depth_to_space_packed_plain(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Plain version of the d2s kernel: reshape/permute."""
    b, h, w, c_in = x.shape
    c = _check_channels(c_in, scale)
    return pixel_shuffle(x, scale).reshape(b, h * scale, w * scale * c)


def depth_to_space_packed(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, H, W, C*s²) → packed rows (B, H*s, W*s*C)."""
    if not dispatch.use_kernel(x):
        return depth_to_space_packed_plain(x, scale)
    b, h, w, c_in = x.shape
    c = _check_channels(c_in, scale)
    x = x.contiguous()
    out = torch.empty((b, h * scale, w * scale * c), dtype=x.dtype, device=x.device)
    _build.launch("nt_d2s_packed", x.device, x.data_ptr(), out.data_ptr(),
                  b, h, w, c, scale, _build.dtype_code(x))
    dispatch.launches["d2s_packed"] += 1
    return out
