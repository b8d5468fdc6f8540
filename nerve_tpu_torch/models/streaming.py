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


@torch.inference_mode()
def streaming_step_pair(model: SuperResolutionNet, carry: Carry, new1: torch.Tensor,
                        new2: torch.Tensor, output_layout: str = "nhwc"
                        ) -> Tuple[Carry, Tuple[torch.Tensor, torch.Tensor]]:
    """Feed two new LR frames; emit the SR frames centred w and w - 1 back.

    Both steps' work runs batched: one feature extraction of the two new
    frames, one flow estimate and warp of all 4w (neighbour, centre) pairs,
    and one fuse tail (attention, RDB stack, fusion, upsampler, epilogue)
    at batch 2B. Equal to two ``streaming_step`` calls, a frame later.
    """
    w = model.temporal_window
    b = new1.shape[0]
    feats = list(carry[: 2 * w])
    lrs = list(carry[2 * w:])
    f_pair = model.extract_features(torch.cat([new1, new2], 0))
    wf = feats + [f_pair[:b], f_pair[b:]]  # frames t-2w+1 .. t+2; centres at w, w + 1
    prev_a, ctr_a, nxt_a = wf[:w], wf[w], wf[w + 1:2 * w + 1]
    prev_b, ctr_b, nxt_b = wf[1:w + 1], wf[w + 1], wf[w + 2:]
    nbs = prev_a + nxt_a + prev_b + nxt_b
    warped = model.align_to_center(torch.cat(nbs, 0),
                                   torch.cat([ctr_a] * (2 * w) + [ctr_b] * (2 * w), 0))
    ws = [warped[i * b:(i + 1) * b] for i in range(4 * w)]
    al_a = ws[:w] + [ctr_a] + ws[w:2 * w]
    al_b = ws[2 * w:3 * w] + [ctr_b] + ws[3 * w:]
    aligned = [torch.cat([a, c], 0) for a, c in zip(al_a, al_b)]
    center_lr = torch.cat([lrs[0], lrs[1] if w >= 2 else new1], 0)
    out = model.fuse_from_features(aligned, torch.cat([ctr_a, ctr_b], 0), center_lr,
                                   output_layout)
    return tuple(wf[2:]) + tuple((lrs + [new1, new2])[-w:]), (out[:b], out[b:])
