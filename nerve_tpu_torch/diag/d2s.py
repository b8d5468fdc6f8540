"""Packed depth-to-space candidates at 1080p → 2160p:
``python -m nerve_tpu_torch.diag.d2s [--profile DIR] [--device cpu] [--small]``.

Counterpart of ``scripts/diag_d2s.py``: twelve bfloat16 phase channels
(3 colours, scale 2) into (1, 2160, 11520) packed rows, from NHWC phases
with ``ops.depth_to_space_packed`` (``nt_d2s_packed``, which covers the
script's ``d2s_packed_mxu``) and from channel-planar phases with
``ops.depth_to_space_packed_planar`` (``nt_d2s_packed_planar``, the
script's ``d2s_packed_planar``), beside the library's
``F.pixel_shuffle`` + permute for each layout. The kernels are held
bit-exact against their plain versions first (the planar one also at odd
widths with s = 3 and 4). On the card it also prints both kernels' launch
records (grid, threads, shared memory, registers and spills, segments,
pixels a segment, stages, bulk copies or element loads, fixed gather
offsets; ``ops.pixel_shuffle.launch_record`` and ``planar_launch_record``,
where the package has them) and ptxas's usage of the d2s kernels from the
build log, and with ``--profile DIR`` each kernel's device time and
launches per call under ``torch.profiler``.
It measures the ``nerve_tpu_torch`` that is first on the path and prints
its location first; the last line is one JSON object.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import torch
import torch.nn.functional as F

import nerve_tpu_torch
from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common

# The module, not ``ops.pixel_shuffle`` the function of the same name.
ps = importlib.import_module("nerve_tpu_torch.ops.pixel_shuffle")

S = 2


def library_nhwc(x):
    b, h, w, c = x.shape
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), S).permute(0, 2, 3, 1).reshape(
        b, S * h, S * w * (c // (S * S)))


def library_planar(xp):
    b, c, h, w = xp.shape
    return F.pixel_shuffle(xp, S).permute(0, 2, 3, 1).reshape(b, S * h, S * w * (c // (S * S)))


def cases(x: torch.Tensor) -> dict:
    """name -> (call, its plain version) on NHWC ``x`` and its planar copy."""
    xp = x.permute(0, 3, 1, 2).contiguous()
    return {
        "depth_to_space_packed (NHWC)": (lambda: ops.depth_to_space_packed(x, S),
                                         lambda: ps.depth_to_space_packed_plain(x, S)),
        "depth_to_space_packed_planar": (lambda: ops.depth_to_space_packed_planar(xp, S),
                                         lambda: ps.depth_to_space_packed_planar_plain(xp, S)),
        "library F.pixel_shuffle NHWC": (lambda: library_nhwc(x), None),
        "library F.pixel_shuffle planar": (lambda: library_planar(xp), None),
    }


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR",
                   help="also trace each kernel's calls, writing the traces into DIR")
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    print(f"package {nerve_tpu_torch.__file__}", flush=True)
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.rand((2, 13, 37, 12), generator=g).to(dev, dt)
        ref = ps.depth_to_space_packed_plain(x, S)
        for name, (fn, plain) in cases(x).items():
            # A kernel against its plain version, a library call against the NHWC one.
            if not torch.equal(fn(), plain() if plain else ref):
                raise AssertionError(f"{name} ({dt}) is not bit-exact")
        for shape, s in (((1, 27, 9, 41), 3), ((2, 32, 7, 33), 4)):
            xp = torch.rand(shape, generator=g).to(dev, dt)
            if not torch.equal(ops.depth_to_space_packed_planar(xp, s),
                               ps.depth_to_space_packed_planar_plain(xp, s)):
                raise AssertionError(f"the planar d2s at {shape}, s = {s} ({dt}) is not "
                                     "bit-exact")
    print("check d2s: both kernels bit-exact against their plain versions (the planar one "
          "also at odd widths, s = 3, 4), the library calls against the NHWC plain version "
          "(float32, bf16)", flush=True)
    h, w = (16, 40) if args.small else (1080, 1920)
    x = torch.rand((1, h, w, 12), generator=g).to(dev, torch.bfloat16)
    calls = cases(x)
    times = {name: _common.median_ms(fn, dev, args.reps) for name, (fn, _p) in calls.items()}
    for name, ms in times.items():
        print(f"time {name:32s} {ms:8.4f} ms ({h}x{w}x12 -> {S * h}x{S * w * 3} bf16)",
              flush=True)
    result = {"ms": times}
    if dev.type == "cuda":
        if hasattr(ps, "launch_record"):
            result["launch"] = ps.launch_record(x, S)
            print(f"launch d2s_packed: {json.dumps(result['launch'])}", flush=True)
        if hasattr(ps, "planar_launch_record"):
            result["launch_planar"] = ps.planar_launch_record(
                x.permute(0, 3, 1, 2).contiguous(), S)
            print(f"launch d2s_packed_planar: {json.dumps(result['launch_planar'])}",
                  flush=True)
        result["ptxas"] = _common.ptxas_usage("d2s")
        for line in result["ptxas"]:
            print(f"ptxas {line}", flush=True)
    if args.profile:
        if dev.type != "cuda":
            raise SystemExit("--profile traces the card: run it with --device cuda")
        result["profile"] = {
            name: _common.profile_calls(calls[name][0], Path(args.profile), label, (word,))
            for name, label, word in (
                ("depth_to_space_packed (NHWC)", "d2s_packed", "d2s_packed_kernel"),
                ("depth_to_space_packed_planar", "d2s_packed_planar", "d2s_"))}
    print(json.dumps(result))
    return times


if __name__ == "__main__":
    main()
