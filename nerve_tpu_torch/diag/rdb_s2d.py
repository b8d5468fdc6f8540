"""The s2d RDB contract beside ``pallas_dx``:
``python -m nerve_tpu_torch.diag.rdb_s2d [--device cpu] [--small]``.

Counterpart of ``scripts/diag_rdb_s2d.py``: ``rdb_s2d`` folded row pairs
into channels so that each dense layer's taps became row-phase pairs and
singles (``ops.rdb_taps.CONTRACTS["s2d"]``). The port computes the same
grouping in place with ``ops.rdb_taps_apply(..., "s2d")``. Both contracts
are held against their plain versions on a small ragged shape (max|Δ|
relative to max|plain|, limit 1.56e-2, float32 1e-4), then one block at
1080p × 64 features in bfloat16 is timed under each.
"""

from __future__ import annotations

import torch

from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.ops import rdb_taps

MODES = ("s2d", "pallas_dx")
LIMITS = {torch.float32: 1e-4, torch.bfloat16: 1.56e-2}


def check(dev, g) -> dict:
    """{(mode, dtype): max|Δ|} of the kernel against its plain version."""
    params = _common.rdb_params(g, 16, dev)
    x = torch.randn((1, 13, 37, 16), generator=g).to(dev)
    out = {}
    for dt, lim in LIMITS.items():
        for mode in MODES:
            ref = rdb_taps.rdb_taps_plain(x.to(dt), params, mode)
            err = _common.max_abs(ops.rdb_taps_apply(x.to(dt), params, mode), ref)
            print(f"check {mode:10s} {str(dt):15s} max|d| {err:.3e} (limit "
                  f"{lim:.2e} x {ref.float().abs().max().item():.3f})", flush=True)
            if not err <= lim * ref.float().abs().max().item():
                raise AssertionError(f"rdb_taps {mode} disagrees with its plain version")
            out[mode, dt] = err
    return out


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    g = torch.Generator().manual_seed(0)
    check(dev, g)
    c, h, w = (16, 10, 21) if args.small else (64, 1080, 1920)
    params = _common.rdb_params(g, c, dev, torch.bfloat16)
    x = torch.randn((1, h, w, c), generator=g).to(dev, torch.bfloat16)
    times = {mode: _common.median_ms(lambda mode=mode: ops.rdb_taps_apply(x, params, mode),
                                     dev, args.reps) for mode in MODES}
    for mode, ms in times.items():
        print(f"time {mode:10s} {ms:9.3f} ms (one block, {h}x{w}x{c} bf16; "
              f"{times['pallas_dx'] / ms:.2f}x pallas_dx)", flush=True)
    return times


if __name__ == "__main__":
    main()
