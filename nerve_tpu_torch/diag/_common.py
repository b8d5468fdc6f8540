"""Shared pieces of the diagnostic entry points: arguments, device, seeded
RDB parameters and timing."""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, List

import torch

from nerve_tpu_torch.models.super_resolution import resolve_device


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--small", action="store_true",
                   help="small shapes instead of 1080p at the flagship's width (for the CPU)")
    p.add_argument("--reps", type=int, default=5, help="timed runs per case (median)")
    return p


def device_of(args) -> torch.device:
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def rdb_params(g: torch.Generator, c: int, dev, dt=torch.float32, layers: int = 5,
               growth: int = 32, bias_std: float = 0.1) -> List[torch.Tensor]:
    """One block's (w_0, b_0, …, lw, lb), He-scaled normal weights, normal
    biases, from ``g``."""
    params, cin = [], c
    for _ in range(layers):
        params += [torch.randn((3, 3, cin, growth), generator=g) * (9 * cin) ** -0.5,
                   torch.randn((growth,), generator=g) * bias_std]
        cin += growth
    params += [torch.randn((cin, c), generator=g) * cin ** -0.5,
               torch.randn((c,), generator=g) * bias_std]
    return [p.to(dev, dt) for p in params]


def median_ms(fn: Callable, dev: torch.device, reps: int) -> float:
    """Median of ``reps`` timed calls after one warm-up: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()
