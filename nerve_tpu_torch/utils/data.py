"""Synthetic SR data (counterpart of ``nerve_tpu/utils/data.py``).

HR frames are smooth band-limited random images with a sharp-edge
component, LR their box decimation (area average), so SR training has
something to learn that bicubic upsampling cannot recover. Randomness comes
from an explicit ``torch.Generator`` (the JAX package's PRNG bits are not
reproduced); the datasets are numpy arrays on the host, NHWC, in [0, 1].
``batches`` is numpy and shuffles as the JAX package's does for the same
``np.random.Generator``. ``make_task_sequence`` is the continual-learning
task sequence, one dataset per content type. ``add_corruption`` draws the
frame-recovery training's rectangle masks.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

CONTENT_TYPES = ("sports", "animation", "movie", "news", "gaming")


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5 (``jax.image.resize``'s "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "cubic")``
    along one axis (an upscale: the kernel is not widened): half-pixel
    centres, each output's taps normalised to sum 1 over the input."""
    inv_scale = 1.0 / (n_out / n_in)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    w = _keys_cubic((sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs())
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_cubic(x: torch.Tensor, size: int) -> torch.Tensor:
    """(N, r, r, C) float32 → (N, size, size, C), ``size`` ≥ r: the cubic
    resize of ``jax.image.resize(x, (N, size, size, C), "cubic")``."""
    w = _cubic_weights(x.shape[1], size).to(x.device)
    return torch.einsum("nhwc,hH,wW->nHWc", x, w, w)


def smooth_random_images(generator: torch.Generator, n: int, size: int, channels: int = 3,
                         octaves: int = 4) -> torch.Tensor:
    """Multi-octave random images in [0, 1]: coarse structure down to
    half-resolution texture, each octave a cubic upscale of Gaussian noise
    weighted 0.55^o, then each image normalised to [0, 1]."""
    imgs = torch.zeros((n, size, size, channels), dtype=torch.float32)
    for o in range(octaves):
        res = max(2, size >> (octaves - o))
        noise = torch.randn((n, res, res, channels), generator=generator)
        imgs = imgs + resize_cubic(noise, size) * (0.55**o)
    lo = imgs.amin(dim=(1, 2, 3), keepdim=True)
    hi = imgs.amax(dim=(1, 2, 3), keepdim=True)
    return (imgs - lo) / torch.clamp(hi - lo, min=1e-6)


def box_decimate(hr: torch.Tensor, scale: int) -> torch.Tensor:
    """(..., s·h, s·w, C) → (..., h, w, C): the mean of each s × s block,
    summed in float64 and rounded once (exact in float32), clipped to [0, 1]."""
    *lead, hh, ww, c = hr.shape
    blocks = hr.double().reshape(*lead, hh // scale, scale, ww // scale, scale, c)
    return blocks.mean(dim=(-4, -2)).clamp(0.0, 1.0).float()


def make_sr_dataset(generator: torch.Generator, num_samples: int, lr_size: int = 64,
                    scale: int = 2, channels: int = 3,
                    content_offset: float = 0.0) -> Dict[str, np.ndarray]:
    """{'lr': (N, s, s, C), 'hr': (N, s·scale, s·scale, C)} in [0, 1].
    ``content_offset`` shifts the intensities, ``hr · (1 − 0.3·|o|) + 0.2·o``
    clipped to [0, 1], as the per-content tasks of continual learning do."""
    hr_size = lr_size * scale
    base = smooth_random_images(generator, num_samples, hr_size, channels)
    # A sigmoid-thresholded smooth field: structured edges above the LR
    # Nyquist rate, where learned SR beats interpolation.
    edges = torch.sigmoid((smooth_random_images(generator, num_samples, hr_size, channels)
                           - 0.5) * 24.0)
    hr = torch.clamp(0.55 * base + 0.45 * edges, 0.0, 1.0)
    if content_offset:
        hr = torch.clamp(hr * (1.0 - abs(content_offset) * 0.3) + content_offset * 0.2, 0.0, 1.0)
    return {"lr": box_decimate(hr, scale).numpy(), "hr": hr.numpy()}


def make_task_sequence(seed: int, num_tasks: int = 5, samples_per_task: int = 64,
                       lr_size: int = 32, scale: int = 2) -> list:
    """[(content type, dataset)] for continual learning: task i is content
    type ``CONTENT_TYPES[i % 5]``, ``make_sr_dataset`` from a generator
    seeded ``seed · 1000 + i`` at content offset ``(i − n/2) / n``."""
    tasks = []
    for i in range(num_tasks):
        offset = (i - num_tasks / 2) / max(num_tasks, 1)
        g = torch.Generator().manual_seed(seed * 1000 + i)
        tasks.append((CONTENT_TYPES[i % len(CONTENT_TYPES)],
                      make_sr_dataset(g, samples_per_task, lr_size, scale,
                                      content_offset=offset)))
    return tasks


def make_video_sr_dataset(generator: torch.Generator, num_samples: int, lr_size: int = 64,
                          scale: int = 2, num_frames: int = 3, max_shift: int = 3,
                          channels: int = 3) -> Dict[str, np.ndarray]:
    """{'lr_win': (N, T, s, s, C), 'hr': (N, s·scale, s·scale, C)} with
    inter-frame motion: each sample pans over a larger HR canvas at an
    integer velocity in [-max_shift, max_shift] HR pixels a frame, frame t
    cropped at ``margin + (t - T//2)·v`` and box-decimated; ``hr`` is the
    centre frame."""
    hr_size = lr_size * scale
    t_half = num_frames // 2
    margin = max_shift * t_half
    canvas_size = hr_size + 2 * margin
    canvas = torch.from_numpy(make_sr_dataset(generator, num_samples, canvas_size // scale,
                                              scale, channels=channels)["hr"])
    vel = torch.randint(-max_shift, max_shift + 1, (num_samples, 2), generator=generator)
    frames = []
    for t in range(num_frames):
        off = margin + vel * (t - t_half)
        frames.append(torch.stack([canvas[i, oy:oy + hr_size, ox:ox + hr_size]
                                   for i, (oy, ox) in enumerate(off.tolist())]))
    frames_hr = torch.stack(frames, dim=1)  # (N, T, hr, hr, C)
    return {"lr_win": box_decimate(frames_hr, scale).numpy(),
            "hr": frames_hr[:, t_half].contiguous().numpy()}


def add_corruption(generator: torch.Generator, frames: torch.Tensor,
                   max_block: float = 0.4) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corrupted, masks) for (B, H, W, C) ``frames``: one rectangle a
    frame, its height in [H/8, max(⌊max_block · H⌋, H/8 + 1)) and its width
    likewise, its top-left corner anywhere in the frame, the rectangle
    clipped by the frame; masks (B, H, W, 1) float32, 1 = corrupted, and
    ``corrupted = frames · (1 - mask)``. The draws come from ``generator``
    (on the CPU); the masks are built on the frames' device."""
    b, h, w, _c = frames.shape

    def draw(lo, hi):
        return torch.randint(lo, hi, (b,), generator=generator).to(frames.device)

    bh = draw(h // 8, max(int(h * max_block), h // 8 + 1))
    bw = draw(w // 8, max(int(w * max_block), w // 8 + 1))
    y0, x0 = draw(0, h), draw(0, w)
    ys = torch.arange(h, device=frames.device)[None, :, None]
    xs = torch.arange(w, device=frames.device)[None, None, :]
    mask = ((ys >= y0[:, None, None]) & (ys < (y0 + bh)[:, None, None])
            & (xs >= x0[:, None, None]) & (xs < (x0 + bw)[:, None, None]))
    mask = mask.to(torch.float32)[..., None]
    return frames * (1.0 - mask), mask


def batches(data: Dict[str, np.ndarray], batch_size: int, *,
            rng: Optional[np.random.Generator] = None,
            drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled fixed-shape minibatches over a dict-of-arrays dataset."""
    n = len(next(iter(data.values())))
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, end, batch_size):
        sel = idx[start:start + batch_size]
        yield {k: v[sel] for k, v in data.items()}


def expand_temporal(lr: torch.Tensor, num_frames: int) -> torch.Tensor:
    """(B, H, W, C) → (B, T, H, W, C) by repetition (a view)."""
    return lr[:, None].expand(lr.shape[0], num_frames, *lr.shape[1:])
