"""Enhance a video file with the port's EnhancementEngine (the serving CLI).

    python -m nerve_tpu_torch.enhance video.npy -o enhanced.npy [--mode full]

Counterpart of ``experiments/enhance.py``. Input, by extension: ``.npy``
(T, C, H, W) or (T, H, W, C), uint8 or float in [0, 1]; ``.npz`` the same
under ``video`` (and optional ``masks``); ``.pt`` a tensor or
``{"video": ..., "masks": ...}``. ``--masks`` (.npy, (T, 1, H, W)) overrides
masks from the file.

Weights:

* ``--torch-checkpoint``: a nerve_cl ``EnhancementEngine`` (or, with
  ``--adaptive``, ``AdaptiveEnhancementEngine``) state dict, bare or under
  ``"model_state_dict"``, imported strictly by ``models.import_torch``;
* ``--sr-checkpoint``: a directory that ``python -m
  nerve_tpu_torch.train_baseline`` wrote (``utils.checkpoint``): its
  latest step's SR parameters and BatchNorm statistics go into the
  engine's ``super_resolution`` net, whose configuration must match;
* neither: fresh weights drawn from ``--seed``.

Output: a ``.npy`` video, uint8 unless ``--float``, and one JSON summary
line on stdout (with the kernels' launches in the process, none on the
CPU). Runs on the card (``--device cuda``, the
default; it raises without one) or on the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from nerve_tpu_torch.ops import dispatch


def load_video(path: str):
    """(video, masks or None) as numpy arrays, (T, C, H, W) and (T, 1, H, W)."""
    ext = os.path.splitext(path)[1].lower()
    masks = None
    if ext == ".npy":
        video = np.load(path)
    elif ext == ".npz":
        blob = np.load(path)
        video = blob["video"]
        masks = blob["masks"] if "masks" in blob.files else None
    elif ext in (".pt", ".pth"):
        blob = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(blob, dict):
            video = blob["video"].numpy()
            masks = blob["masks"].numpy() if "masks" in blob else None
        else:
            video = blob.numpy()
    else:
        raise SystemExit(f"unsupported input format: {ext}")
    if video.ndim != 4:
        raise SystemExit(f"expected a 4-D video, got shape {video.shape}")
    if video.shape[-1] in (1, 3) and video.shape[1] not in (1, 3):
        video = np.moveaxis(video, -1, 1)
    return video, _channel_first_masks(masks)


def _channel_first_masks(masks):
    if masks is not None and masks.shape[-1] == 1 and masks.shape[1] != 1:
        masks = np.moveaxis(masks, -1, 1)
    return masks


def build_engine(args):
    from nerve_tpu_torch.models import api
    from nerve_tpu_torch.models.enhancement_engine import EngineConfig

    cfg = EngineConfig(
        scale_factor=args.scale, sr_num_features=args.sr_features,
        sr_num_residual_blocks=args.sr_blocks, sr_temporal_window=args.sr_window,
        sr_flow_downsample=args.sr_flow_downsample,
        recovery_temporal_window=args.recovery_window,
    ).with_mode(args.mode)
    cls = api.AdaptiveEnhancementEngine if args.adaptive else api.EnhancementEngine
    engine = cls(cfg, seed=args.seed, dtype=getattr(torch, args.dtype), device=args.device)
    if args.torch_checkpoint:
        from nerve_tpu_torch.models import import_torch

        sd = import_torch.load_state_dict(args.torch_checkpoint)
        importer = (import_torch.import_adaptive_engine if args.adaptive
                    else import_torch.import_enhancement_engine)
        engine.load_variables(importer(sd, engine.config))
    elif args.sr_checkpoint:
        load_sr_checkpoint(engine.engine, args.sr_checkpoint)
    return engine


SR_MISMATCH = ("--sr-checkpoint params don't match the engine's SR subtree; pass the "
               "--scale/--sr-features/--sr-blocks/--sr-window the checkpoint was trained "
               "with (train_baseline's defaults: --sr-features 32 --sr-blocks 4).")


@torch.no_grad()
def load_sr_checkpoint(engine, directory: str) -> None:
    """The latest step that ``train_baseline`` saved in ``directory``: its
    parameters and BatchNorm statistics into ``engine.super_resolution``;
    exits with ``SR_MISMATCH`` where names or shapes differ."""
    from nerve_tpu_torch.models.layers import batch_stats
    from nerve_tpu_torch.utils.checkpoint import CheckpointManager

    sr = getattr(engine, "super_resolution", None)
    if sr is None or engine.config.use_lightweight_sr:
        raise SystemExit("--sr-checkpoint loads the flagship SR net: use --mode full or sr_only")
    restored = CheckpointManager(directory).restore_raw()
    targets = {"params": dict(sr.named_parameters()), "batch_stats": batch_stats(sr)}
    for part, tensors in targets.items():
        want = {k: tuple(t.shape) for k, t in tensors.items()}
        got = {k: tuple(v.shape) for k, v in restored.get(part, {}).items()}
        if want != got:
            raise SystemExit(SR_MISMATCH)
    for part, tensors in targets.items():
        for k, t in tensors.items():
            t.copy_(restored[part][k])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("input", help="video file (.npy/.npz/.pt)")
    p.add_argument("-o", "--output", default="enhanced.npy")
    p.add_argument("--mode", default="full",
                   choices=["full", "sr_only", "recovery_only", "lightweight"])
    p.add_argument("--scale", type=int, default=2)
    p.add_argument("--sr-features", type=int, default=64)
    p.add_argument("--sr-blocks", type=int, default=8)
    p.add_argument("--sr-window", type=int, default=1)
    p.add_argument("--sr-flow-downsample", type=int, default=1,
                   help="estimate the SR net's flow at 1/N resolution")
    p.add_argument("--recovery-window", type=int, default=2)
    p.add_argument("--strength", type=float, default=None,
                   help="override the learned enhancement strength")
    p.add_argument("--masks", default=None,
                   help=".npy corruption masks (T, 1, H, W); overrides any in the input file")
    p.add_argument("--adaptive", action="store_true", help="use AdaptiveEnhancementEngine")
    p.add_argument("--budget", type=float, default=0.8,
                   help="resource budget for --adaptive (0..1)")
    p.add_argument("--user-pref", type=float, default=0.7,
                   help="user quality preference for --adaptive (0..1)")
    p.add_argument("--float", action="store_true",
                   help="write float32 output instead of uint8")
    p.add_argument("--int8", default="off", choices=["off", "rdb", "full"],
                   help="int8 SR serving: 'rdb' the RDB stack, 'full' every conv-chain "
                        "site too; scales calibrate on the video's first window")
    p.add_argument("--torch-checkpoint", default=None,
                   help="nerve_cl EnhancementEngine state_dict (.pth)")
    p.add_argument("--sr-checkpoint", default=None,
                   help="checkpoint directory of python -m nerve_tpu_torch.train_baseline")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = p.parse_args(argv)

    video, masks = load_video(args.input)
    if args.masks:
        masks = _channel_first_masks(np.load(args.masks))
    t = video.shape[0]

    engine = build_engine(args)
    if args.adaptive:
        # The budget picks the mode; the whole-video path blends at the
        # engine's own strength.
        from nerve_tpu_torch.models.enhancement_engine import select_mode_for_budget

        mode = select_mode_for_budget(args.budget)
        if mode != args.mode:
            engine.set_enhancement_mode(mode)
            args.mode = mode
    if args.strength is not None:
        with torch.no_grad():
            engine.engine.enhancement_strength.fill_(args.strength)
    if args.int8 != "off":
        if args.mode not in ("full", "sr_only"):
            print(f"# --int8 ignored: mode {args.mode!r} has no full SR net", file=sys.stderr)
            args.int8 = "off"
        else:
            engine.quantize_int8(video, chains=args.int8 == "full")

    t0 = time.perf_counter()
    out = engine.enhance_video(video, corruption_masks=masks, as_uint8=not args.float)
    out = out.float().cpu().numpy() if args.float else out.cpu().numpy()
    wall = time.perf_counter() - t0

    np.save(args.output, out)
    print(json.dumps({
        "frames": t,
        "input_shape": list(video.shape),
        "output_shape": list(out.shape),
        "output_dtype": str(out.dtype),
        "mode": args.mode,
        "int8": args.int8,
        "seconds": round(wall, 3),
        "fps_including_compile": round(t / wall, 2),
        "output": args.output,
        "backend": engine.device.type,
        "launches": {k: v for k, v in dispatch.launches.items() if v},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
