"""Masked-recovery quality of the port's FrameRecoveryNet.

    python -m nerve_tpu_torch.recovery_protocol [--epochs 10] [--device cuda]
    python -m nerve_tpu_torch.recovery_protocol --device cpu --epochs 1 \\
        --train-samples 8 --eval-samples 4 --size 32 --batch-size 2 --base-channels 8

Counterpart of ``scripts/recovery_protocol.py``, with its defaults:

1. a seeded synthetic video set (panning canvases, T = 5 frames of real
   motion; ``utils.data.make_video_sr_dataset`` at ``scale=1``,
   ``max_shift=2``), one for training and one, from ``seed + 1``, held out;
2. the centre frame corrupted by a random rectangle covering 10-40 % of it
   (``make_masks``, numpy's generator: the same masks as the JAX script's
   for a seed);
3. ``FrameRecoveryNet(base_channels=64, temporal_window=2)`` trained by
   ``training.recovery`` (AdamW 1e-3, decay 1e-5, cosine, full-frame MSE of
   the blended output);
4. masked-region PSNR on the held-out frames at fixed mask fractions 10,
   20, 30, 40 %, beside the zero-fill baseline.

The references are the window of five frames with the CORRUPTED centre
frame in its centre slot, as a served video holds it; the JAX script feeds
the clean centre frame there, which shows the net the pixels it must
recover. The JSON says so. The script's other side, the nerve_cl
reference trained on the same arrays, is not run: nerve_cl is not in the
repository. Runs on the card unless ``--device cpu``; the last line is one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from nerve_tpu_torch.models.frame_recovery import FrameRecoveryNet
from nerve_tpu_torch.models.super_resolution import resolve_device
from nerve_tpu_torch.training.recovery import create_recovery_state, make_recovery_train_step
from nerve_tpu_torch.utils import data as data_lib

FRACTIONS = (0.1, 0.2, 0.3, 0.4)
NUM_FRAMES = 5


def make_masks(rng: np.random.Generator, n: int, h: int, w: int, frac) -> np.ndarray:
    """(N, H, W, 1) rectangle masks each covering ~``frac`` of the frame
    (a scalar or an (N,) array): a random aspect and position, the
    rectangle placed wholly inside the frame."""
    frac = np.broadcast_to(np.asarray(frac, np.float64), (n,))
    masks = np.zeros((n, h, w, 1), np.float32)
    for i in range(n):
        area = frac[i] * h * w
        aspect = np.exp(rng.uniform(-0.7, 0.7))
        bh = int(np.clip(round(np.sqrt(area * aspect)), 1, h))
        bw = int(np.clip(round(area / bh), 1, w))
        y0 = rng.integers(0, h - bh + 1)
        x0 = rng.integers(0, w - bw + 1)
        masks[i, y0:y0 + bh, x0:x0 + bw, 0] = 1.0
    return masks


def masked_psnr(pred: np.ndarray, clean: np.ndarray, mask: np.ndarray) -> float:
    """PSNR over the masked region only (the pixels the net must invent)."""
    pred = np.clip(pred, 0.0, 1.0)
    se = ((pred - clean) ** 2) * mask
    mse = float(se.sum() / (mask.sum() * clean.shape[-1]))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def make_dataset(seed: int, n: int, size: int, num_frames: int = NUM_FRAMES):
    """{"frames": (N, T, s, s, 3), "clean": (N, s, s, 3)} panning video."""
    d = data_lib.make_video_sr_dataset(torch.Generator().manual_seed(seed), n, lr_size=size,
                                       scale=1, num_frames=num_frames, max_shift=2)
    return {"frames": d["lr_win"], "clean": d["hr"]}


def corrupted_refs(frames: np.ndarray, corrupted: np.ndarray) -> np.ndarray:
    """The window ``frames`` (N, T, H, W, C) with ``corrupted`` in its centre slot."""
    refs = frames.copy()
    refs[:, frames.shape[1] // 2] = corrupted
    return refs


def train_and_evaluate(train, test_sets, epochs: int, batch_size: int, lr: float, seed: int,
                       device, base_channels: int = 64, log=print):
    """Train a fresh net on ``train``; its masked PSNR on each of
    ``test_sets`` ({label: (corrupted, refs, mask, clean)}), the training
    seconds and the last step's loss. The mask stream is the JAX script's:
    the same draws from ``np.random.default_rng(seed + 7)`` in the same
    order (its init batch's masks included)."""
    frames, clean = train["frames"], train["clean"]
    n, _t, h, w, _c = frames.shape
    nb = n - n % batch_size
    steps_per_epoch = nb // batch_size
    rng = np.random.default_rng(seed + 7)
    make_masks(rng, batch_size, h, w, 0.25)  # the JAX script's init batch
    model = FrameRecoveryNet(base_channels=base_channels, temporal_window=2, device=device,
                             generator=torch.Generator().manual_seed(seed))
    state = create_recovery_state(model, lr, max(1, epochs * steps_per_epoch))
    step = make_recovery_train_step(model)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    t0 = time.perf_counter()
    last = float("nan")
    for epoch in range(epochs):
        perm = rng.permutation(nb)
        for i in range(steps_per_epoch):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            cl = clean[idx]
            m = make_masks(rng, batch_size, h, w, rng.uniform(0.1, 0.4, batch_size))
            cor = cl * (1.0 - m)
            _s, metrics = step(state, dev(cor), dev(corrupted_refs(frames[idx], cor)), dev(m),
                               dev(cl))
        last = float(metrics["loss"]) if steps_per_epoch else last
        log(f"[torch] epoch {epoch + 1}/{epochs}: loss={last:.5f}")
    secs = time.perf_counter() - t0

    model.eval()
    table = {}
    for label, (cor, refs, mask, cl) in test_sets.items():
        preds = [model(dev(cor[i:i + batch_size]), dev(refs[i:i + batch_size]),
                       dev(mask[i:i + batch_size])).cpu().numpy()
                 for i in range(0, cl.shape[0], batch_size)]
        table[label] = round(masked_psnr(np.concatenate(preds), cl, mask), 3)
    return table, secs, last


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--train-samples", type=int, default=240)
    p.add_argument("--eval-samples", type=int, default=48)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--base-channels", type=int, default=64,
                   help="the net's base width (the protocol's is 64)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    train = make_dataset(args.seed, args.train_samples, args.size)
    test = make_dataset(args.seed + 1, args.eval_samples, args.size)
    # Fixed eval masks per fraction.
    rng = np.random.default_rng(args.seed + 99)
    test_sets, zero_fill = {}, {}
    for frac in FRACTIONS:
        label = f"{int(frac * 100)}%"
        mask = make_masks(rng, args.eval_samples, args.size, args.size, frac)
        corrupted = test["clean"] * (1.0 - mask)
        test_sets[label] = (corrupted, corrupted_refs(test["frames"], corrupted), mask,
                            test["clean"])
        zero_fill[label] = round(masked_psnr(corrupted, test["clean"], mask), 3)
    table, secs, last = train_and_evaluate(train, test_sets, args.epochs, args.batch_size,
                                           args.lr, args.seed, device, args.base_channels)
    results = {
        "protocol": {
            "train_samples": args.train_samples, "eval_samples": args.eval_samples,
            "epochs": args.epochs, "batch_size": args.batch_size, "lr": args.lr,
            "base_channels": args.base_channels,
            "optimizer": "adamw(wd=1e-5)+cosine",
            "loss": "full-frame MSE on the blended output",
            "data": f"seeded panning video, T={NUM_FRAMES} refs, {args.size}px, "
                    "rectangle masks 10-40%",
            "refs": "the window with the corrupted centre frame in its centre slot "
                    "(the JAX script feeds the clean one there)",
            "metric": "masked-region PSNR (dB) at fixed mask fractions",
            "reference_side": "not run: nerve_cl is not in the repository",
        },
        "zero_fill_baseline": zero_fill,
        "nerve_tpu_torch": table,
        "nerve_tpu_torch_train_seconds": round(secs, 1),
        "final_loss": last,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
