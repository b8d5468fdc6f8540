"""The planar chain and the kernels' launch path:
``python -m nerve_tpu_torch.diag.planar [--profile DIR] [--launch-path]
[--device cpu] [--small]``.

The seeded lightweight body (3 -> 32, 4 x (depthwise 3x3, 1x1 32 -> 32),
32 -> 12, bfloat16) on a planar 1080p frame through
``ops.planar_chain_apply`` (``csrc/planar_chain.cu``), held against its
plain version first, then timed (CUDA events, median): with its weight pack
made beforehand, with the pack made in the call, the plain version and
cuDNN's ten layers, beside the bound; then the body per frame through the
planar chain and through the per-layer kernels (``ops.conv_chain_apply``).
``--profile DIR`` traces five calls of each form with ``torch.profiler``:
device time of the planar kernel and of the other kernels per call, the
host's wall time per call, and the kernel's grid, block, registers and
shared memory.

On the card it also times the launch path: the host clock over 10,000
calls without a synchronise, divided by the count, of each step of the
probe's wrapper ``probe_scale2`` (the dispatch check, ``contiguous``,
``empty_like``, the pointers, ``_build.launch``), of the whole wrapper and
of the ATen call ``a * 2.0`` on the same (8, 128) float32 array; and the
probe's CUDA-event time beside ``a * 2.0``'s.

``--launch-path`` times the launch path alone. It calls nothing but
``_build.launch``, ``diag.probe`` and ``dispatch.use_kernel``, which every
checkout of the port has, so ``PYTHONPATH=OTHER python
nerve_tpu_torch/diag/planar.py --launch-path`` times another checkout's
launch path (parent against change in one call).
"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path

import torch

import nerve_tpu_torch
from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common, probe
from nerve_tpu_torch.diag.conv import (H, W, _sync, bound, chain_ops, cudnn_chain, nbytes,
                                       seeded_lightweight)
from nerve_tpu_torch.ops import _build, conv_chain, dispatch, planar_chain

LAUNCHES = 10_000  # host-clock calls per launch-path case
BF16_MAX = float(torch.finfo(torch.bfloat16).max)


def overflow_case(c: int, dev, seed: int = 0):
    """A finite bf16 input and a body whose second layer's sums overflow
    bf16 at a few pixels: (x (2, 3, 37, 101) planar, params). The body is
    the lightweight one's shape at width ``c`` (3 -> c, 4 x (depthwise c,
    1x1 c -> c + relu), c -> 12), every weight and bias positive, so that
    the reference carries each overflow on as +Inf, never NaN. A 3 x 3
    patch of the input is 1e4; the first depthwise layer's channel-0
    weights are scaled by the power of two 2^e that takes its sums past the
    bf16 maximum where the patch reaches them and leaves every other sum at
    least 5 % below it (so that no sum's order decides), and the next 1x1
    layer's weights from that channel by 2^-e, so that the finite values
    after it are of the input's scale again."""
    g = torch.Generator().manual_seed(seed)

    def pos(*shape, std):
        return torch.randn(shape, generator=g).abs() * std

    params = [(pos(3, 3, 3, c, std=27 ** -0.5), pos(c, std=0.1), "relu")]
    for _ in range(4):
        params += [(pos(3, 3, c, std=1 / 3), pos(c, std=0.1), "none"),
                   (pos(1, 1, c, c, std=c ** -0.5), pos(c, std=0.1), "relu")]
    params.append((pos(3, 3, c, 12, std=(9 * c) ** -0.5), pos(12, std=0.1), "none"))
    x = torch.rand((2, 3, 37, 101), generator=g)
    x[1, :, 20:23, 40:43] = 1e4
    x = x.to(torch.bfloat16)
    # The first depthwise layer's channel-0 sums as the reference forms them.
    head = planar_chain.planar_chain_plain(x, params[:1])[:, :1]
    w0 = params[1][0][..., :1].to(torch.bfloat16)
    s0 = conv_chain.depthwise_sums(head, w0).flatten()
    for e in range(1, 127):
        thr = BF16_MAX / 2.0 ** e
        over = s0 > thr
        near = (s0 > thr / 1.05) & (s0 < thr * 1.05)
        if over.any() and not near.any() and over.float().mean() < 0.01:
            break
    else:
        raise AssertionError("no scale puts the overflow apart from the other sums")
    params[1][0][..., 0] *= 2.0 ** e
    params[2][0][:, :, 0, :] *= 2.0 ** -e
    return x.to(dev), [(w.to(dev), b.to(dev), a) for w, b, a in params]


def body_cases(dev, small: bool):
    """name -> call at the serving shape, the input and the chain."""
    body = [(w.detach(), b.detach(), a) for w, b, a in seeded_lightweight(dev, 3).chain()]
    h, w = (36, 64) if small else (H, W)
    g = torch.Generator().manual_seed(5)
    xp = torch.rand((1, 3, h, w), generator=g).to(dev, torch.bfloat16)
    pk = planar_chain.packed_planar_chain(body, xp.dtype, xp.device)
    cases = {"pack made beforehand": lambda: ops.planar_chain_apply(xp, body, packed=pk),
             "pack in the call": lambda: ops.planar_chain_apply(xp, body)}
    cases["plain"] = lambda: planar_chain.planar_chain_plain(xp, body)
    cases["cuDNN, 10 layers"] = (lambda lib=cudnn_chain(body, xp.dtype):
                                 lib(xp.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
    return cases, xp, body


def per_frame(dev, xp, body, reps: int):
    """Host ms per frame (to a synchronise) of the body: planar chain (pack
    made once) against the per-layer kernels on the NHWC frame; each case
    timed ``reps`` times after a warm-up, median."""
    x = xp.permute(0, 2, 3, 1).contiguous()
    pk = planar_chain.packed_planar_chain(body, xp.dtype, xp.device)
    runs = {"planar chain": lambda: ops.planar_chain_apply(x.permute(0, 3, 1, 2), body,
                                                           packed=pk),
            "per layer": lambda: ops.conv_chain_apply(x, body)}
    out = {}
    for name, fn in runs.items():
        times = []
        for _ in range(reps + 1):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times[1:])
    return out


def profile_cases(cases, out_dir: Path, n: int = 5) -> dict:
    """torch.profiler over ``n`` calls of each kernel case: per call the
    planar kernel's and the other kernels' device ms and the host's wall ms."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    out_dir.mkdir(parents=True, exist_ok=True)
    result = {}
    for name, fn in cases.items():
        if name in ("plain", "cuDNN, 10 layers"):
            continue
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        trace = out_dir / f"trace_planar_{name.replace(' ', '_')}.json"
        prof.export_chrome_trace(str(trace))
        kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
                   if e.get("cat") == "kernel"]
        mine = [e for e in kernels if "planar" in e["name"]]
        other = [e for e in kernels if "planar" not in e["name"]]
        row = {"wall_ms_per_call": wall / n,
               "kernel_ms_per_call": sum(e["dur"] for e in mine) / 1e3 / n,
               "kernel_launches_per_call": len(mine) / n,
               "other_kernels_per_call": len(other) / n,
               "other_ms_per_call": sum(e["dur"] for e in other) / 1e3 / n}
        if mine:
            args = mine[-1].get("args", {})
            row["launch"] = {k: args.get(k) for k in ("grid", "block", "registers per thread",
                                                      "shared memory", "blocks per SM",
                                                      "warps per SM")}
        print(f"profile planar_chain ({name}): {json.dumps(row)}", flush=True)
        result[name] = row
    return result


def launch_path(dev) -> dict:
    """Host µs per launch over ``LAUNCHES`` launches without a synchronise,
    and the probe's CUDA-event ms beside ``a * 2.0``'s."""
    a = torch.rand((8, 128), generator=torch.Generator().manual_seed(1)).to(dev)
    o = torch.empty_like(a)
    _build.library()
    args = (a.data_ptr(), o.data_ptr(), a.numel())
    # The wrapper's steps one by one, then the whole wrapper and the ATen call.
    calls = {"use_kernel": lambda: dispatch.use_kernel(a),
             "contiguous": lambda: a.contiguous(),
             "empty_like": lambda: torch.empty_like(a),
             "data_ptr, numel": lambda: (a.data_ptr(), o.data_ptr(), a.numel()),
             "_build.launch": lambda: _build.launch("nt_probe_scale2", a.device, *args),
             "probe_scale2": lambda: probe.probe_scale2(a),
             "a * 2.0": lambda: a * 2.0}
    result = {}
    for name, fn in calls.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAUNCHES):
            fn()
        host = (time.perf_counter() - t0) / LAUNCHES * 1e6
        torch.cuda.synchronize()
        result[f"host_us {name}"] = host
        print(f"launch path {name:16s} {host:7.3f} us per call on the host "
              f"({LAUNCHES} calls, no synchronise)", flush=True)
    if not torch.equal(probe.probe_scale2(a), a * 2.0):
        raise AssertionError("the probe kernel is not 2 * a")
    for name in ("probe_scale2", "a * 2.0"):
        result[f"ms {name}"] = _common.median_ms(calls[name], dev, 25)
        print(f"time {name:14s} {result[f'ms {name}']:.4f} ms (CUDA events, median of 25 "
              "single calls)", flush=True)
    return result


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR",
                   help="also trace the planar chain's calls, writing the traces into DIR")
    p.add_argument("--launch-path", action="store_true",
                   help="time the launch path alone (on the card)")
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    print(f"package {nerve_tpu_torch.__file__}", flush=True)
    if dev.type == "cuda":
        print(f"device {torch.cuda.get_device_name(dev)}", flush=True)
    elif args.launch_path:
        raise SystemExit("--launch-path times the card: run it with --device cuda")
    if args.launch_path:
        result = {"launch": launch_path(dev)}
        print(json.dumps(result))
        return result
    cases, xp, body = body_cases(dev, args.small)
    ref = cases["plain"]()
    scale = ref.float().abs().max().item()
    for name, fn in cases.items():
        if name == "plain":
            continue
        err = _common.max_abs(fn(), ref)
        if not err <= 2.4e-2 * scale:  # the conv chain's bf16 level
            raise AssertionError(f"planar chain ({name}) max|err| {err} > 2.4e-2 * {scale}")
    npix = xp[0, 0].numel() * xp.shape[0]
    work = bound(chain_ops(body, npix),
                 nbytes(xp) * 5 + nbytes(*(t for w, b, _ in body for t in (w, b))), "bf16")
    result = {"ms": {name: _common.median_ms(fn, dev, args.reps) for name, fn in cases.items()},
              "bound_ms": work[0], "bound_by": work[1]}
    for name, ms in result["ms"].items():
        print(f"time planar_chain {name:22s} {ms:8.3f} ms ({tuple(xp.shape)} bf16; bound "
              f"{work[0]:.3f} ms by {work[1]})", flush=True)
    result["body_ms_per_frame"] = per_frame(dev, xp, body, max(args.reps, 5))
    print("body per frame " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                        result["body_ms_per_frame"].items()), flush=True)
    if args.profile:
        if dev.type != "cuda":
            raise SystemExit("--profile traces the card: run it with --device cuda")
        result["profile"] = profile_cases(cases, Path(args.profile))
    if dev.type == "cuda":
        result["launch"] = launch_path(dev)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
