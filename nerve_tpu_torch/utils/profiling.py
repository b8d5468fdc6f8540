"""Timing and tracing (counterpart of ``nerve_tpu/utils/profiling.py``).

* ``timed_chain``: the device time of one call of ``fn``, from ``iters``
  calls chained by a data dependence (each call's first argument carries a
  vanishing multiple of the last output's first element) and timed by CUDA
  events around the whole chain, after ``warmup`` chains; the port's
  ``timed_scan``. The host's launch work overlaps the card's, so a chain of
  calls whose kernels take longer than their launches reads device time;
  where the host is the slower, it reads the host's pace (the card's idle
  gaps included): a profile (``trace``) gives busy time. ``fn`` may run
  autograd (a train step) inside.
* ``trace``: a ``torch.profiler`` context over the CPU and, where there is
  a card, CUDA activity, writing a Chrome trace into a directory.
* ``Timer``: named wall-clock sections of host code.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch


def _first_tensor(out: Any) -> torch.Tensor:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    for item in out:
        try:
            return _first_tensor(item)
        except TypeError:
            continue
    raise TypeError("fn returned no tensor")


def timed_chain(fn: Callable, *args: Any, iters: int = 10, warmup: int = 1) -> Dict[str, float]:
    """{"ms_per_call", "total_ms"}: device time of ``fn(*args)`` on the card.
    ``args[0]`` must be a floating-point CUDA tensor; a host (CPU) argument
    raises, since CUDA events time only the card."""
    x = args[0]
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError("timed_chain times the card: its first argument must be a CUDA tensor")

    def chain():
        carry = x
        for _ in range(iters):
            out = _first_tensor(fn(carry, *args[1:]))
            with torch.no_grad():
                carry = x + out.reshape(-1)[0].detach().to(x.dtype) * 1e-20
        return carry

    for _ in range(warmup):
        chain()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(x.device)
    start.record()
    chain()
    end.record()
    torch.cuda.synchronize(x.device)
    total_ms = start.elapsed_time(end)
    return {"ms_per_call": total_ms / iters, "total_ms": total_ms}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU activity, and CUDA where a card is present)
    and write ``trace.json`` into ``log_dir``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Named wall-clock section timer (seconds, summed over entries)."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + time.perf_counter() - t0
