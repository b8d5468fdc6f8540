"""Baseline supervised SR training through the port.

Counterpart of ``experiments/train_baseline.py``, with its flags and its
last line, ``{"best_psnr": ..., "final_psnr": ...}``::

    python -m nerve_tpu_torch.train_baseline --epochs 10 --num-features 64 --num-blocks 8
    python -m nerve_tpu_torch.train_baseline --device cpu --epochs 1 --train-samples 8 \\
        --val-samples 4 --lr-size 16 --num-features 8 --num-blocks 1 --batch-size 4

Synthetic LR 64² / HR 128² sets (``utils.data.make_sr_dataset``, seeded
from ``--seed``), ``SuperResolutionNet`` in the config's compute dtype with
float32 master weights, ``training.fit_sr`` with a checkpoint per epoch and
resume from ``--checkpoint-dir``. It runs on the card unless ``--device
cpu``. ``--config`` reads a JSON or YAML file (YAML needs PyYAML).

Launched by ``torchrun`` (``WORLD_SIZE`` set) it trains data parallel, as
the JAX script does over ``best_data_mesh``: each rank joins the process
group (NCCL on the card, one card a rank; gloo with ``--device cpu``),
takes ``best_data_mesh(batch_size)`` and its rows of every batch; only rank
0 prints and writes checkpoints::

    torchrun --nproc-per-node 4 -m nerve_tpu_torch.train_baseline --epochs 10
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from nerve_tpu_torch import training
from nerve_tpu_torch.config import load_config
from nerve_tpu_torch.models import SuperResolutionNet
from nerve_tpu_torch.parallel import best_data_mesh, init_distributed
from nerve_tpu_torch.utils import data as data_lib
from nerve_tpu_torch.utils.checkpoint import CheckpointManager


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="nerve_tpu_torch baseline SR training")
    p.add_argument("--config", default=None, help="JSON or YAML config path")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--scale", type=int, default=2)
    p.add_argument("--num-features", type=int, default=32)
    p.add_argument("--num-blocks", type=int, default=4)
    p.add_argument("--temporal-window", type=int, default=1)
    p.add_argument("--train-samples", type=int, default=500)
    p.add_argument("--val-samples", type=int, default=100)
    p.add_argument("--lr-size", type=int, default=64)
    p.add_argument("--checkpoint-dir", default="checkpoints/baseline")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    mesh, device = None, args.device
    if "WORLD_SIZE" in os.environ:  # launched by torchrun
        device = init_distributed(device=args.device)
        mesh = best_data_mesh(args.batch_size, device=device.type)
    lead = mesh is None or dist.get_rank() == 0
    cfg = load_config(args.config, overrides={
        "training.epochs": args.epochs,
        "training.batch_size": args.batch_size,
        "training.learning_rate": args.lr,
    })
    model = SuperResolutionNet(
        scale_factor=args.scale, num_features=args.num_features,
        num_residual_blocks=args.num_blocks, temporal_window=args.temporal_window,
        dtype=torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32,
        device=device, generator=torch.Generator().manual_seed(args.seed))
    dev = next(model.parameters()).device
    if lead:
        ranks = ("" if mesh is None
                 else f", {dist.get_world_size()} ranks (data {mesh.size('data')})")
        print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
              f"{ranks}", flush=True)
    # Synthetic sets of the reference's shapes (LR 64², HR 128², 500 / 100).
    g = torch.Generator().manual_seed(args.seed)
    train_data = data_lib.make_sr_dataset(g, args.train_samples, args.lr_size, args.scale)
    val_data = data_lib.make_sr_dataset(g, args.val_samples, args.lr_size, args.scale)
    ckpt = CheckpointManager(args.checkpoint_dir, cfg.checkpoint.keep_last_n)
    _state, history = training.fit_sr(model, train_data, val_data, cfg.training,
                                      model.num_frames, mesh=mesh, seed=args.seed,
                                      ckpt_manager=ckpt)
    ckpt.close()
    if mesh is not None:
        dist.destroy_process_group()
    if lead:
        print(json.dumps({"best_psnr": history["best_psnr"],
                          "final_psnr": history["final_psnr"]}))
    return history


if __name__ == "__main__":
    main()
