"""Device-health probe: ``python -m nerve_tpu_torch.diag.probe [--delay N]``.

Counterpart of ``scripts/tpu_probe.py``. In one process it asserts that the
device is the card, that a matrix product completes (a 256² ones product
sums to 256³), that a kernel of the port's library builds, loads and
computes (``nt_probe_scale2``, ``csrc/probe.cu``: twice an (8, 128) float32
array of ones sums to 2048) and, with ``--delay N``, that a second product
(512²) still completes N seconds later. Prints ``probe ok`` and exits 0;
anything else raises. ``--device cpu`` runs the same checks on the CPU with
the kernel's plain version.
"""

from __future__ import annotations

import argparse
import time

import torch

from nerve_tpu_torch.models.super_resolution import resolve_device
from nerve_tpu_torch.ops import _build, dispatch


def probe_scale2_plain(a: torch.Tensor) -> torch.Tensor:
    return a * 2.0


def probe_scale2(a: torch.Tensor) -> torch.Tensor:
    """``2 · a`` for a float32 tensor: the probe kernel on a CUDA tensor."""
    if not dispatch.use_kernel(a):
        return probe_scale2_plain(a)
    if a.dtype != torch.float32:
        raise TypeError(f"the probe kernel takes float32, got {a.dtype}")
    a = a.contiguous()
    out = torch.empty_like(a)
    _build.launch("nt_probe_scale2", a.device, a.data_ptr(), out.data_ptr(), a.numel())
    dispatch.launches["probe"] += 1
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--delay", type=float, default=0.0,
                   help="seconds to sleep before a second product (0 = skip)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)  # raises without a card unless --device cpu
    x = torch.ones((256, 256), device=dev)
    _expect("a 256² ones product", float((x @ x).sum()), 256.0 ** 3)
    y = probe_scale2(torch.ones((8, 128), dtype=torch.float32, device=dev))
    _expect("the probe kernel", float(y.sum()), 2048.0)
    if args.delay > 0:
        time.sleep(args.delay)
        z = torch.ones((512, 512), device=dev)
        _expect("a delayed 512² ones product", float((z @ z).sum()), 512.0 ** 3)
    print("probe ok", flush=True)
    return 0


def _expect(what: str, got: float, want: float) -> None:
    if got != want:
        raise RuntimeError(f"probe: {what} sums to {got}, not {want}")


if __name__ == "__main__":
    raise SystemExit(main())
