"""Streaming video SR: sliding-window inference with feature reuse.

Counterpart of ``nerve_tpu/models/streaming.py``. The carry holds the
features of the last 2w frames and the last w LR frames, so each step
extracts features of exactly one new frame. Edge policy: repeat-padding on
both sides (frame 0's window is (x0, x0, x1) for w = 1).

The JAX functions take the flax ``variables`` beside the model; here the
model holds its weights, so the signatures drop that argument and keep the
rest. Everything runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nerve_tpu_torch.models.super_resolution import SuperResolutionNet

Carry = Tuple[torch.Tensor, ...]  # (feats of last 2w frames…, lr of last w frames…)


@torch.inference_mode()
def streaming_prime(model: SuperResolutionNet, first_frame: torch.Tensor) -> Carry:
    """Carry for a stream starting at ``first_frame`` (B, H, W, C)."""
    w = model.temporal_window
    f0 = model.extract_features(first_frame)
    return tuple([f0] * (2 * w)) + tuple([first_frame] * w)


@torch.inference_mode()
def streaming_step(model: SuperResolutionNet, carry: Carry, new_frame: torch.Tensor,
                   output_layout: str = "nhwc") -> Tuple[Carry, torch.Tensor]:
    """Feed one new LR frame; emit the SR frame centred w frames back.

    Feeding x[t+1] after x[t] emits SR(x[t-w+1]).
    """
    w = model.temporal_window
    feats = list(carry[: 2 * w])
    lrs = list(carry[2 * w:])
    window_feats = feats + [model.extract_features(new_frame)]
    out = model.streaming_step(window_feats[:w], window_feats[w], window_feats[w + 1:],
                               lrs[0], output_layout)
    return tuple(window_feats[1:]) + tuple(lrs[1:] + [new_frame]), out


@torch.inference_mode()
def enhance_video_streaming(model: SuperResolutionNet, video: torch.Tensor) -> torch.Tensor:
    """SR of a whole (B, T, H, W, C) video → (B, T, sH, sW, C)."""
    t = video.shape[1]
    w = model.temporal_window
    carry = streaming_prime(model, video[:, 0])
    feed = list(video[:, 1:].unbind(1)) + [video[:, -1]] * w
    outs = []
    for x_t in feed:
        carry, out = streaming_step(model, carry, x_t)
        outs.append(out)
    ys = torch.stack(outs, dim=1)
    return ys[:, ys.shape[1] - t:]
