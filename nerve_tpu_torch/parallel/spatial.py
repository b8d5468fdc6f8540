"""Height-sharded inference over the mesh's ``model`` axis.

Counterpart of ``nerve_tpu/parallel/spatial.py``. Each rank holds its
H-slab of the frames (``shard_rows``), takes ``halo`` boundary rows from
each neighbour (``collectives.exchange_halo``; zeros at the frame's top and
bottom), runs the whole model on its extended slab through the same kernels
as one card, and crops ``scale·halo`` output rows from each side; the slabs
gather back into the frame with ``gather_rows``. The JAX functions take and
return global arrays under ``shard_map``; these take and return this rank's
part.

Exactness contract (the JAX module's): rows farther than the receptive
field from the frame's top and bottom equal the one-device forward's
whenever the receptive field and the flow's displacement at a slab boundary
fit inside ``halo`` (R ≈ 55 rows for the 8-block flagship; ``halo=64``);
CBAM's channel attention stays exact by a sum of each slab's own rows over
the group (``layers.ChannelAttention``). The outermost ~R rows differ a
little: the edge slab's zero halo is applied once, where the one-device
forward pads before every convolution.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerve_tpu_torch.parallel import collectives
from nerve_tpu_torch.parallel.mesh import Mesh

# The row axis of each output layout of the lightweight model.
ROW_AXIS = {"nhwc": 1, "planar": 2, "packed": 1}


def _check(mesh: Mesh, axis: str, data_axis: Optional[str], rows: int, halo: int) -> int:
    """The halo to use (at most a slab); raises on a layout the mesh lacks."""
    mesh.size(axis)
    if data_axis is not None:
        mesh.size(data_axis)
        if data_axis == axis:
            raise ValueError(f"the batch and the rows cannot share the axis {axis!r}")
    return min(halo, rows)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "model", dim: int = -3) -> torch.Tensor:
    """This rank's slab of ``x`` along its row dimension ``dim`` (-3 of
    (..., H, W, C)), contiguous on the mesh's device; the counterpart of
    ``spatial_sharding`` / ``frame_sharding``. H must divide by the axis."""
    n, i = mesh.size(axis), mesh.index(axis)
    h = x.shape[dim]
    if h % n != 0:
        raise ValueError(f"H={h} not divisible by {axis} axis size {n}")
    return x.narrow(dim, i * (h // n), h // n).contiguous().to(mesh.device)


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "model", dim: int = -3) -> torch.Tensor:
    """The frame from every rank's slab along ``dim``, on every rank."""
    return torch.cat(collectives.all_gather(x, mesh.group(axis)), dim)


def spatial_sr_apply(model, frames: torch.Tensor, mesh: Mesh, axis: str = "model",
                     halo: int = 64, data_axis: Optional[str] = None,
                     differentiable: bool = False) -> torch.Tensor:
    """Height-sharded ``SuperResolutionNet`` forward over ``mesh[axis]``.

    Args:
        model: a ``SuperResolutionNet`` (NHWC), the same weights on every rank.
        frames: this rank's (B, T, Hs, W, C) slab; with ``data_axis``, of its
            batch shard (combined data × model parallelism).
        halo: boundary rows taken from each neighbour (at most Hs).
        differentiable: run under autograd (the eval forward's gradient,
            through the halo exchange and the CBAM sum), else under
            ``torch.inference_mode`` (a model in training mode always runs
            under autograd).

    Returns:
        this rank's (B, Hs·s, W·s, C) rows of the SR frame.
    """
    halo = _check(mesh, axis, data_axis, frames.shape[-3], halo)
    s = model.scale_factor
    group = mesh.group(axis)
    with model.spatial(group, halo):
        ext = collectives.exchange_halo(frames, halo, group)  # (B, T, Hs + 2·halo, W, C)
        out = model(ext, differentiable=differentiable)
    return out[:, s * halo:out.shape[1] - s * halo]


@torch.inference_mode()
def spatial_streaming_apply(model, video: torch.Tensor, mesh: Mesh, axis: str = "model",
                            halo: int = 64, data_axis: Optional[str] = None) -> torch.Tensor:
    """Height-sharded streaming video SR over ``mesh[axis]``.

    ``models.streaming``'s prime and steps on halo-extended frames: each
    step exchanges the one new frame, extracts its features once and keeps
    the carry as extended slabs; same exactness contract as
    ``spatial_sr_apply``.

    Args:
        video: this rank's (B, T, Hs, W, C) slab.

    Returns:
        this rank's (B, T, Hs·s, W·s, C) rows of the SR video.
    """
    from nerve_tpu_torch.models import streaming as streaming_lib

    halo = _check(mesh, axis, data_axis, video.shape[-3], halo)
    s, tw, t = model.scale_factor, model.temporal_window, video.shape[1]
    group = mesh.group(axis)
    with model.spatial(group, halo):
        carry = streaming_lib.streaming_prime(
            model, collectives.exchange_halo(video[:, 0], halo, group))
        outs = []
        for x_t in list(video[:, 1:].unbind(1)) + [video[:, -1]] * tw:
            carry, out = streaming_lib.streaming_step(
                model, carry, collectives.exchange_halo(x_t, halo, group))
            outs.append(out)
    ys = torch.stack(outs, dim=1)[:, len(outs) - t:]
    return ys[:, :, s * halo:ys.shape[2] - s * halo]


def spatial_lightweight_apply(model, frames: torch.Tensor, mesh: Mesh, axis: str = "model",
                              halo: int = 8, data_axis: Optional[str] = None,
                              output_layout: str = "nhwc") -> torch.Tensor:
    """Height-sharded ``LightweightSuperResolution`` forward over
    ``mesh[axis]``: its body is 6 layers of 3×3 support and a radius-2
    bicubic base, so ``halo=8`` covers it.

    Args:
        frames: this rank's (B, Hs, W, C) slab.
        output_layout: 'nhwc' (B, sHs, sW, C), 'planar' (B, C, sHs, sW) or
            'packed' (B, sHs, sW·C), cropped on the layout's row axis.
    """
    if output_layout not in ROW_AXIS:
        raise ValueError(f"unknown output_layout {output_layout!r}")
    halo = _check(mesh, axis, data_axis, frames.shape[-3], halo)
    s, dim = model.scale_factor, ROW_AXIS[output_layout]
    ext = collectives.exchange_halo(frames, halo, mesh.group(axis))
    out = model(ext, output_layout)
    return out.narrow(dim, s * halo, out.shape[dim] - 2 * s * halo)
