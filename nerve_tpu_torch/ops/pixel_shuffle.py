"""Sub-pixel (depth-to-space) rearrangements in NHWC layout.

Counterpart of ``nerve_tpu/ops/pixel_shuffle.py``. Channel order is
``torch.nn.PixelShuffle``'s: input channel ``c*s*s + i*s + j`` goes to
output channel ``c`` at spatial offset ``(i, j)``.

``depth_to_space_packed`` is the serving epilogue's layout: (B, sH, sW*C)
packed rows, byte-identical to row-major (B, sH, sW, C). On a CUDA tensor it
runs the hand-written kernel ``csrc/d2s_packed.cu`` (persistent blocks, each
input row segment staged in shared memory once and written to all s output
rows; ``launch_record`` says how a call launches); on a CPU tensor its
plain version ``depth_to_space_packed_plain``. ``depth_to_space_packed_planar``
writes the same rows from channel-planar phases (B, C*s², H, W), the input
of ``scripts/diag_d2s.py``'s planar kernel, with ``nt_d2s_packed_planar``:
the same kernel staging each item's C*s² plane row segments
(``planar_launch_record``; C*s² up to about 7,000 planes).
"""


from __future__ import annotations

import ctypes

import torch

from nerve_tpu_torch.ops import _build, dispatch

LAUNCH_RECORD = ("grid", "threads", "dynamic_smem_bytes", "static_smem_bytes", "registers",
                 "spill_bytes", "segments", "segment_pixels", "stages", "bulk_copy",
                 "fixed_offsets")
SEG_BYTES = 16384  # csrc/d2s_packed.cu: input bytes a segment stages, about


def planar_segments(w: int, c: int, scale: int, dtype: torch.dtype) -> dict:
    """The planar kernel's segments of an input row of ``w`` pixels with C =
    ``c`` and s = ``scale`` (csrc/d2s_packed.cu ``plan``, PLANAR): pixels a
    segment (whole 16-byte runs, about ``SEG_BYTES`` of all C·s² planes),
    segments a row, staged elements from one plane's row to the next (the
    segment and 16 bytes more, so that the planes start in other banks) and
    staged bytes."""
    es = dtype.itemsize
    vec, cin = 16 // es, c * scale * scale
    seg = min(max(1, SEG_BYTES // (vec * cin * es)), -(-w // vec)) * vec
    return {"segment_pixels": seg, "segments": -(-w // seg), "plane_stride": seg + vec,
            "stage_bytes": -(-(seg + vec) * cin * es // 128) * 128}

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


def _record(entry: str, x: torch.Tensor, b: int, h: int, w: int, c: int, scale: int) -> dict:
    if not dispatch.use_kernel(x):
        raise ValueError("the launch record is the card's: pass a CUDA tensor")
    x = x.contiguous()
    out = torch.empty((b, h * scale, w * scale * c), dtype=x.dtype, device=x.device)
    rec = (ctypes.c_int * len(LAUNCH_RECORD))()
    _build.launch(entry, x.device, x.data_ptr(), out.data_ptr(), b, h, w, c, scale,
                  _build.dtype_code(x), ctypes.addressof(rec))
    return dict(zip(LAUNCH_RECORD, rec))


def launch_record(x: torch.Tensor, scale: int) -> dict:
    """What ``depth_to_space_packed(x, scale)`` launches on the card, without
    launching it: grid, threads, shared memory, the kernel's registers and
    spill bytes (``cudaFuncGetAttributes``), the row segments and their
    pixels, the stages, whether segments arrive by bulk copies (else element
    loads) and whether each thread's gather offsets are fixed."""
    b, h, w, c_in = x.shape
    return _record("nt_d2s_packed_launch", x, b, h, w, _check_channels(c_in, scale), scale)


def planar_launch_record(x: torch.Tensor, scale: int) -> dict:
    """``launch_record`` of ``depth_to_space_packed_planar(x, scale)``: its
    segments are (b, input row, W segment) items, each staging C*s² plane
    rows of ``segment_pixels``."""
    b, c, h, w = _check_planar(x, scale)
    return _record("nt_d2s_packed_planar_launch", x, b, h, w, c, scale)


def _check_planar(x: torch.Tensor, scale: int):
    b, c_in, h, w = x.shape
    return b, _check_channels(c_in, scale), h, w


def depth_to_space_packed_planar_plain(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Plain version of the planar d2s kernel: reshape/permute."""
    b, c, h, w = _check_planar(x, scale)
    x = x.reshape(b, c, scale, scale, h, w).permute(0, 4, 2, 5, 3, 1)
    return x.reshape(b, h * scale, w * scale * c)


def depth_to_space_packed_planar(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Planar phases (B, C*s², H, W) → packed rows (B, H*s, W*s*C)."""
    if not dispatch.use_kernel(x):
        return depth_to_space_packed_planar_plain(x, scale)
    b, c, h, w = _check_planar(x, scale)
    x = x.contiguous()
    out = torch.empty((b, h * scale, w * scale * c), dtype=x.dtype, device=x.device)
    _build.launch("nt_d2s_packed_planar", x.device, x.data_ptr(), out.data_ptr(),
                  b, h, w, c, scale, _build.dtype_code(x))
    dispatch.launches["d2s_packed_planar"] += 1
    return out
