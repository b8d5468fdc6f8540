"""Drive the PyTorch port's flagship streaming SR path once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. Build: ``nvcc`` compiles ``nerve_tpu_torch/csrc`` for ``sm_90a``.
3. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   at a small ragged shape and at the serving shapes of the flagship path
   (1080p → 2160p), in bfloat16 and float32, with median times from CUDA
   events.
4. Slice: ``SuperResolutionNet`` (64 features, 8 RDBs, temporal window 1,
   flow at half resolution, bfloat16) with seeded weights, primed on frame
   0 of a seeded 1080×1920 video and stepped with ``streaming_step(...,
   "packed")``. Every kernel's launch counter must grow in that run. The
   same frames then run with the plain versions on the card, and the two
   outputs must agree.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch

from nerve_tpu_torch import ops
from nerve_tpu_torch.models import SuperResolutionNet, streaming_prime, streaming_step
from nerve_tpu_torch.ops import _build, conv_chain, correlation, dispatch, rdb

d2s = importlib.import_module("nerve_tpu_torch.ops.pixel_shuffle")

H, W = 1080, 1920
FEATURES, BLOCKS = 64, 8
STEPS = 4  # output frames; the first is not timed
# Slice limits on the [0, 1] bfloat16 output, kernels vs plain versions.
# Measured 3.9e-3 and 6.3e-5 on an H100 (one-ulp bf16 flips carried through
# 8 RDBs); a wrong tap, channel or edge moves outputs by O(0.1).
SLICE_MAX_ABS, SLICE_MEAN_ABS = 2e-2, 5e-4

KERNELS = {  # name -> (source, TPU kernel it replaces, plain version, limits f32/bf16)
    "d2s_packed": ("nerve_tpu_torch/csrc/d2s_packed.cu",
                   "nerve_tpu/ops/pixel_shuffle.py:95", d2s.depth_to_space_packed_plain,
                   (0.0, 0.0)),
    "correlation": ("nerve_tpu_torch/csrc/correlation.cu",
                    "nerve_tpu/ops/correlation.py:52", correlation.correlation_plain,
                    (1e-5, 1e-2)),
    "conv_chain": ("nerve_tpu_torch/csrc/conv_chain.cu",
                   "nerve_tpu/ops/conv_chain.py:169", conv_chain.conv_chain_plain,
                   (1e-4, 2.4e-2)),
    "rdb": ("nerve_tpu_torch/csrc/rdb.cu", "nerve_tpu/ops/rdb.py:121",
            rdb.rdb_chain_plain, (1e-4, 1.56e-2)),
}
# The ops the model calls, and the plain version each is replaced by in
# the reference run.
OPS_OF = {"d2s_packed": "depth_to_space_packed", "correlation": "correlation_volume",
          "conv_chain": "conv_chain_apply", "rdb": "rdb_chain_apply"}


@contextlib.contextmanager
def plain_ops():
    """Route the model's four kernel ops to their plain versions."""
    saved = {op: getattr(ops, op) for op in OPS_OF.values()}
    for name, op in OPS_OF.items():
        setattr(ops, op, KERNELS[name][2])
    try:
        yield
    finally:
        for op, fn in saved.items():
            setattr(ops, op, fn)


def median_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` runs of ``fn`` on the card (CUDA events), after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _randn(g, shape, std=1.0):
    return torch.randn(shape, generator=g) * std


def conv_params(g, widths, dev, acts=None):
    out = []
    for i, (cin, cout) in enumerate(zip(widths, widths[1:])):
        act = acts[i] if acts else ("relu" if i < len(widths) - 2 else "none")
        out.append((_randn(g, (3, 3, cin, cout), (9 * cin) ** -0.5).to(dev),
                    _randn(g, (cout,), 0.1).to(dev), act))
    return out


def rdb_params(g, c, dev, dt):
    params, cin = [], c
    for _ in range(5):
        params += [_randn(g, (3, 3, cin, 32), (9 * cin) ** -0.5), _randn(g, (32,), 0.1)]
        cin += 32
    params += [_randn(g, (cin, c), cin ** -0.5), _randn(g, (c,), 0.1)]
    return [p.to(dev, dt) for p in params]


def kernel_cases(dev, dt, serving: bool):
    """name -> (label, kernel call, plain call) at small or serving shapes."""
    g = torch.Generator().manual_seed(7)

    def act(*shape):
        return _randn(g, shape).to(dev, dt)

    cases = {}
    if serving:
        x = torch.rand((1, H, W, 12), generator=g).to(dev, dt)
        f1, f2 = act(2, H // 2, W // 2, FEATURES), act(2, H // 2, W // 2, FEATURES)
        sites = [  # the path's five conv-chain sites
            (act(1, H, W, 3), conv_params(g, [3, FEATURES], dev, ["relu"])),
            (act(2, H // 2, W // 2, 81), conv_params(g, [81, 128, 64, 32, 2], dev)),
            ([act(1, H, W, FEATURES) for _ in range(3)],
             conv_params(g, [3 * FEATURES, FEATURES, FEATURES, 3], dev)),
            (act(1, H, W, FEATURES), conv_params(g, [FEATURES, FEATURES], dev, ["relu"])),
            (act(1, H, W, FEATURES), conv_params(g, [FEATURES, 12], dev, ["none"])),
        ]
        xr = act(1, H, W, FEATURES)
        plist = [rdb_params(g, FEATURES, dev, dt) for _ in range(BLOCKS)]
        label = f"serving 1080p ({BLOCKS} RDBs, 5 chain sites)"
    else:
        x = act(2, 13, 37, 12)
        f1, f2 = act(2, 11, 35, 16), act(2, 11, 35, 16)
        sites = [([act(2, 9, 35, 4) for _ in range(3)], conv_params(g, [12, 40, 20, 3, 12], dev))]
        xr = act(1, 10, 33, 16)
        plist = [rdb_params(g, 16, dev, dt) for _ in range(2)]
        label = "small ragged"

    def chains(fn):
        return lambda: [fn(xx, p) for xx, p in sites]

    cases["d2s_packed"] = (label, lambda: ops.depth_to_space_packed(x, 2),
                           lambda: d2s.depth_to_space_packed_plain(x, 2))
    cases["correlation"] = (label, lambda: ops.correlation_volume(f1, f2, 4),
                            lambda: correlation.correlation_plain(f1, f2, 4))
    cases["conv_chain"] = (label, chains(ops.conv_chain_apply),
                           chains(conv_chain.conv_chain_plain))
    cases["rdb"] = (label, lambda: ops.rdb_chain_apply(xr, plist),
                    lambda: rdb.rdb_chain_plain(xr, plist))
    return cases


def _as_list(y):
    return y if isinstance(y, list) else [y]


def check_kernels(dev) -> dict:
    """Kernel vs plain on the card; returns bf16 serving-shape numbers per kernel."""
    summary = {}
    for serving in (False, True):
        for dt in (torch.float32, torch.bfloat16):
            for name, (label, kern, plain) in kernel_cases(dev, dt, serving).items():
                lim = KERNELS[name][3][dt == torch.bfloat16]
                got, ref = _as_list(kern()), _as_list(plain())
                torch.cuda.synchronize()
                err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
                scale = max(b.float().abs().max().item() for b in ref)
                if name == "conv_chain":
                    scale = max(scale, 1.0)
                finite = all(bool(torch.isfinite(a).all()) for a in got)
                ok = finite and all(a.shape == b.shape for a, b in zip(got, ref)) and (
                    err == 0.0 if lim == 0.0 else err <= lim * scale)
                del got, ref
                ms, pms = median_ms(kern), median_ms(plain)
                print(f"kernel {name:12s} {label:38s} {str(dt):15s} max|err| {err:.3e} "
                      f"(limit {lim:g} x {scale:.3g}) kernel {ms:.3f} ms plain {pms:.3f} ms "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"{name} kernel disagrees with its plain version "
                                         f"({label}, {dt}): max|err| {err}")
                if serving and dt == torch.bfloat16:
                    summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms}
                torch.cuda.empty_cache()
    return summary


def seeded_model(dev, seed: int) -> SuperResolutionNet:
    """The flagship model with every parameter and BN statistic seeded and
    non-zero (the zero-initialised flow3/upsampler would make the flow 0)."""
    g = torch.Generator().manual_seed(seed)
    model = SuperResolutionNet(scale_factor=2, num_features=FEATURES,
                               num_residual_blocks=BLOCKS, temporal_window=1,
                               flow_downsample=2, dtype=torch.bfloat16, device=dev).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:
                v = 1.0 + 0.1 * _randn(g, p.shape) if name.endswith("scale") else 0.05 * _randn(g, p.shape)
            else:
                v = _randn(g, p.shape, math.prod(p.shape[:-1]) ** -0.5)
                if "upsampler" in name:
                    v = v * 0.1
            p.copy_(v)
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5 if name.endswith("var")
                      else 0.1 * _randn(g, buf.shape))
    return model


def run_stream(model, video):
    """Prime on frame 0 and step through the rest; (outputs, ms per timed step)."""
    carry = streaming_prime(model, video[0])
    outs, times = [], []
    for frame in video[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, out = streaming_step(model, carry, frame, "packed")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return outs, times[1:]


def run_slice(dev, card: str) -> dict:
    model = seeded_model(dev, seed=0)
    g = torch.Generator().manual_seed(1)
    video = [torch.rand((1, H, W, 3), generator=g).to(dev) for _ in range(STEPS + 1)]
    torch.cuda.reset_peak_memory_stats(dev)

    dispatch.reset_launches()
    outs, times = run_stream(model, video)
    launches = dict(dispatch.launches)
    print(f"slice launches {launches}", flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")
    for out in outs:
        if tuple(out.shape) != (1, 2 * H, 2 * W * 3):
            raise AssertionError(f"output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()) or out.min() < 0 or out.max() > 1:
            raise AssertionError("output not finite or outside [0, 1]")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    dispatch.reset_launches()
    with plain_ops():
        ref, ptimes = run_stream(model, video)
    if any(dispatch.launches.values()):
        raise AssertionError(f"the plain run launched kernels: {dispatch.launches}")
    dmax = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs, ref))
    dmean = max((a.float() - b.float()).abs().mean().item() for a, b in zip(outs, ref))
    ms, pms = statistics.median(times), statistics.median(ptimes)
    print(f"slice kernels vs plain: max|d| {dmax:.3e} (limit {SLICE_MAX_ABS}), "
          f"mean|d| {dmean:.3e} (limit {SLICE_MEAN_ABS})", flush=True)
    print(f"slice 1080p->2160p bf16 packed: {ms:.1f} ms/frame with kernels, "
          f"{pms:.1f} ms/frame plain (median of {len(times)} steps; "
          f"peak {peak:.2f} GiB) on {card}", flush=True)
    if dmax > SLICE_MAX_ABS or dmean > SLICE_MEAN_ABS:
        raise AssertionError("slice output differs from the plain versions' output")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s: {lib.name}", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or re.search(r"\b[1-9]\d* bytes spill", line):
            print(f"  {line.strip()}")

    summary = check_kernels(dev)
    launches = run_slice(dev, card)
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **summary[name]}
               for name, (src, rep, _plain, _lim) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
