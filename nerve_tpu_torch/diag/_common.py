"""Shared pieces of the diagnostic entry points: arguments, device, seeded
RDB parameters, timing, and on the card a kernel's device time under the
profiler, its SASS opcodes and its ptxas usage."""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Callable, List, Sequence

import torch

from nerve_tpu_torch.models.super_resolution import resolve_device
from nerve_tpu_torch.ops import _build


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


def profile_calls(fn: Callable, out_dir: Path, label: str, words: Sequence[str],
                  n: int = 10) -> dict:
    """torch.profiler over ``n`` calls of ``fn`` after one warm-up: per call
    the device ms and launches of the kernels whose name holds one of
    ``words``, the other kernels' launches and the wall ms. Writes the trace
    to ``out_dir/trace_{label}.json`` and prints the row."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    out_dir.mkdir(parents=True, exist_ok=True)
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    trace = out_dir / f"trace_{label}.json"
    prof.export_chrome_trace(str(trace))
    kernels = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("cat") == "kernel"]
    mine = [e for e in kernels if any(w in e["name"] for w in words)]
    row = {"kernel_ms_per_call": sum(e["dur"] for e in mine) / 1e3 / n,
           "launches_per_call": len(mine) / n,
           "other_kernels_per_call": (len(kernels) - len(mine)) / n, "wall_ms_per_call": wall / n}
    print(f"profile {label}: {json.dumps(row)}", flush=True)
    return row


def sass_opcodes(match: Callable[[str], bool]) -> Counter:
    """Opcode counts of the built library's kernels whose mangled name
    ``match`` accepts (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True,
                          check=True).stdout
    counts, mine = Counter(), False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            mine = match(m.group(1))
            continue
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if mine and op:
            counts[op.group(1)] += 1
    return counts


def ptxas_usage(word: str) -> List[str]:
    """ptxas's registers, shared memory and spills of each built kernel whose
    mangled name holds ``word``, from the library's build log."""
    log = _build.library_path().with_suffix(".log").read_text().splitlines()
    out = []
    for i, line in enumerate(log):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m and word in m.group(1):
            usage = [u.split(":", 1)[-1].strip() for u in log[i + 1:i + 5]
                     if "spill" in u or "Used" in u]
            out.append(f"{m.group(1)}: {'; '.join(usage)}")
    return out
