"""The cost-volume correlation at the serving shape:
``python -m nerve_tpu_torch.diag.correlation [--profile DIR] [--sass]
[--device cpu] [--small]``.

First the kernel (``csrc/correlation.cu``) against its plain version: d = 1..4
in bfloat16 and float32 at a ragged shape with partial tiles on all four
edges and padded channels, and the exact-sum case (``exact_sum_inputs``),
bit for bit. Then, at the flagship's shape (f1, f2 = 2 × 540 × 960 × 64
bfloat16, d = 4: flow at half resolution), the median of ``--reps`` (at
least 25 on the card) CUDA-event timings of one call, the plain version's,
and d = 1..4 at C = 64; beside them three least times:

* bytes, the function's bound: each input read once and the output written
  once, at 3.35 TB/s (its multiplies and adds take less at the card's
  bfloat16 rates);
* and two of the kernel's own design, which does all its work on the CUDA
  cores: a multiply and an add per product at the 67 TFLOP/s of float32
  there, and the issue rate of 2.5 instructions per product (half a
  ``mul.rn.bf16x2``, one widening, one float32 add) at one instruction per
  lane per clock, 132 SMs × 128 lanes at 1.98 GHz.

On the card it also prints the launch record (grid, threads, shared
memory, registers and spills from ``cudaFuncGetAttributes``), and with
``--profile DIR`` the kernel's device time per call under
``torch.profiler``. ``--sass`` prints the opcode counts of the bfloat16
d = 4 kernel (``cuobjdump``). It measures the ``nerve_tpu_torch`` that is
first on the path and prints its location first.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

import nerve_tpu_torch
from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.ops import correlation

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # the same, float32 outside the tensor cores
ISSUE_PER_S = 132 * 128 * 1.98e9  # SMs x lanes x boost clock: instructions a second
INSTR_PER_PRODUCT = 2.5
SERVING = (2, 540, 960, 64)  # flow at half resolution of 1080p, 64 features
SMALL = (2, 12, 40, 16)
LIMITS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # relative to max|plain|
# A ragged shape: several tiles, partial ones on all four edges, C padded.
CHECK_SHAPES = ((2, 37, 131, 64), (1, 5, 7, 20))


def exact_sum_inputs(b: int, h: int, w: int, c: int = 64, dtype=torch.bfloat16, device="cpu"):
    """Constant fields whose bfloat16 correlation is exact in any order of
    the sum, and differs where a product is not rounded to bfloat16.

    Channel pairs (2k, 2k + 1), k < (c - 2) / 2: f1 = f2 = 1 + 2⁻⁷ (product
    1 + 2⁻⁶ + 2⁻¹⁴, rounded to 1 + 2⁻⁶) and f1 = -1, f2 = 1 + 2⁻⁶: each
    pair's rounded products cancel, the unrounded ones leave 2⁻¹⁴. Channel
    c - 2: f1 = f2 = 2⁻⁹ (product 2⁻¹⁸, exact), so that the rounded sum is
    2⁻¹⁸ and not a zero that a broken kernel could also give; channel c - 1
    is 0. Every partial sum is a multiple of 2⁻¹⁸ under 32, exact in
    float32 for c <= 128. Inside the frame each value is 2⁻¹⁸ / c (c a power
    of two: 1/c is exact); with unrounded products it is (1 + 16 (c - 2) / 2)
    · 2⁻¹⁸ / c, which rounds to another bfloat16 value. Returns (f1, f2, the
    inside value)."""
    if c not in (4, 8, 16, 32, 64, 128):
        raise ValueError(f"the exact-sum case takes c a power of two in [4, 128], got {c}")
    v1, v2 = torch.zeros(c, dtype=torch.float64), torch.zeros(c, dtype=torch.float64)
    pairs = (c - 2) // 2
    v1[0:2 * pairs:2] = v2[0:2 * pairs:2] = 1 + 2.0 ** -7
    v1[1:2 * pairs:2], v2[1:2 * pairs:2] = -1.0, 1 + 2.0 ** -6
    v1[c - 2] = v2[c - 2] = 2.0 ** -9
    f1, f2 = (v.to(dtype).expand(b, h, w, c).contiguous().to(device) for v in (v1, v2))
    return f1, f2, 2.0 ** -18 / c


def bounds_ms(shape, d: int, itemsize: int) -> dict:
    """The three least times of the docstring for f1, f2 of ``shape``."""
    b, h, w, c = shape
    products = b * h * w * (2 * d + 1) ** 2 * c
    moved = (2 * b * h * w * c + b * h * w * (2 * d + 1) ** 2) * itemsize
    return {"bytes": moved / HBM_BYTES_PER_S * 1e3,
            "float32_peak": 2 * products / F32_FLOPS_PER_S * 1e3,
            "issue": products * INSTR_PER_PRODUCT / ISSUE_PER_S * 1e3}


def check(dev) -> None:
    """Kernel against plain at the check shapes, d = 1..4, both dtypes, and
    the exact-sum case bit for bit."""
    g = torch.Generator().manual_seed(3)
    for shape in CHECK_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            f1, f2 = (torch.randn(shape, generator=g).to(dev, dt) for _ in range(2))
            for d in range(1, 5):
                got = ops.correlation_volume(f1, f2, d)
                ref = correlation.correlation_plain(f1, f2, d)
                err, scale = _common.max_abs(got, ref), ref.float().abs().max().item()
                ok = (got.shape == ref.shape and got.dtype == ref.dtype
                      and err <= LIMITS[dt] * scale)
                print(f"check correlation {tuple(shape)} {dt} d={d}: max|err| {err:.3e} "
                      f"(limit {LIMITS[dt] * scale:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"correlation kernel disagrees with its plain version "
                                         f"at {shape} {dt} d={d}")
    f1, f2, inside = exact_sum_inputs(2, 19, 45, device=dev)
    got, ref = ops.correlation_volume(f1, f2, 4), correlation.correlation_plain(f1, f2, 4)
    ok = torch.equal(got, ref) and got[:, 4:-4, 4:-4].float().eq(inside).all().item()
    print(f"check correlation exact sum (2, 19, 45, 64) bf16 d=4: "
          f"{'bit-exact' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("correlation kernel differs from its plain version on the exact sum")


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR",
                   help="also trace the kernel's calls, writing the trace into DIR")
    p.add_argument("--sass", action="store_true",
                   help="also print the bfloat16 d = 4 kernel's opcode counts")
    p.set_defaults(reps=25)
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    print(f"package {nerve_tpu_torch.__file__}", flush=True)
    if dev.type == "cuda":
        print(f"device {torch.cuda.get_device_name(dev)}", flush=True)
    check(dev)
    shape = SMALL if args.small else SERVING
    g = torch.Generator().manual_seed(0)
    f1, f2 = (torch.randn(shape, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    result = {"shape": list(shape), "ms": {}, "bounds_ms": {}}
    for d in (4, 1, 2, 3):
        ms = _common.median_ms(lambda d=d: ops.correlation_volume(f1, f2, d), dev, args.reps)
        b = bounds_ms(shape, d, 2)
        result["ms"][f"d={d}"], result["bounds_ms"][f"d={d}"] = ms, b
        print(f"time correlation {tuple(shape)} bf16 d={d}: {ms:.4f} ms; bound: bytes "
              f"{b['bytes']:.4f} ms; this design's: float32 peak {b['float32_peak']:.4f} ms, "
              f"issue {b['issue']:.4f} ms (the kernel at {b['issue'] / ms:.3f} of it)", flush=True)
    result["plain_ms"] = _common.median_ms(lambda: correlation.correlation_plain(f1, f2, 4), dev,
                                           min(args.reps, 5))
    print(f"time correlation_plain {tuple(shape)} bf16 d=4: {result['plain_ms']:.3f} ms",
          flush=True)
    if dev.type == "cuda":
        result["launch"] = correlation.launch_record(f1, f2, 4)
        print(f"launch correlation d=4: {json.dumps(result['launch'])}", flush=True)
    if args.profile:
        if dev.type != "cuda":
            raise SystemExit("--profile traces the card: run it with --device cuda")
        result["profile"] = _common.profile_calls(lambda: ops.correlation_volume(f1, f2, 4),
                                                  Path(args.profile), "correlation", ("corr",))
    if args.sass:
        if dev.type != "cuda":
            raise SystemExit("--sass reads the built kernels: run it with --device cuda")
        counts = _common.sass_opcodes(lambda name: "corr_kernel" in name and "bfloat16" in name
                                      and "Li4E" in name)
        print("sass corr_kernel<bf16, 4>: " + ", ".join(f"{k} {n}" for k, n in
                                                        counts.most_common()), flush=True)
        result["sass"] = dict(counts)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
