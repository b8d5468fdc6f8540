"""Drive the PyTorch port's SR serving paths once on an NVIDIA GPU.

    python3 chip_smoke.py              # the checks below, ~2 min on an H100 with the build
    python3 chip_smoke.py --profile build/traces   # also profile the three slices

Phases, each of which raises on failure and prints its wall time:

1. Device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. Build: ``nvcc`` compiles ``nerve_tpu_torch/csrc`` for ``sm_90a``.
3. Kernels: each of the eight CUDA kernels against its plain PyTorch version
   on the card, at a small ragged shape and at the serving shapes of the
   flagship path (1080p → 2160p) and, for the depthwise layer and the planar
   chain, of the lightweight body at 1080p, with median times from CUDA events, the
   least time the card could take for the same work (``bound_ms``) and,
   where one PyTorch call computes the same function, that call's time
   (``library_ms``). The bf16 kernels run in bfloat16 and float32; the int8
   kernels take scales calibrated on their own inputs.
4. bf16 slice: ``SuperResolutionNet`` (64 features, 8 RDBs, temporal window
   1, flow at half resolution, bfloat16) with seeded weights, primed on
   frame 0 of a seeded 1080×1920 video and stepped with
   ``streaming_step(..., "packed")``. Every bf16 kernel's launch counter must
   grow in that run. The same frames then run with the plain versions on
   the card, and the two outputs must agree.
5. int8 slice: the same seeded model built with ``quantized=True,
   quantized_chains=True``, calibrated by ``quantize_sr`` on a (1, 3, 270,
   480, 3) crop of the video, then streamed the same way. ``rdb_int8``,
   ``conv_chain_int8``, ``correlation`` and ``d2s_packed`` must launch and
   ``rdb`` and ``conv_chain`` must not; the output must agree with the int8
   plain versions' and lie within ``INT8_MIN_PSNR`` dB of the bf16 slice's.
6. Lightweight slice: an untrained ``LightweightSuperResolution`` (zero
   tail) must return the clipped bicubic upscale within 2⁻⁸; then the model
   with every parameter and BN statistic seeded, in bfloat16, runs frame by
   frame over the same video with ``"packed"`` output. ``conv_chain``,
   ``conv_chain_dw3`` and ``d2s_packed`` must launch (6, 4 and 1 per frame),
   the flagship's other kernels must not, and the output must agree with
   the plain versions' run. Last, the same body runs through
   ``ops.planar_chain_apply`` (the one-launch planar chain) on each planar
   frame: ``planar_chain`` must launch once per frame and nothing else, and
   its result must agree with the per-layer body's.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result. It imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from nerve_tpu_torch import ops
from nerve_tpu_torch.models import (
    LightweightSuperResolution,
    SuperResolutionNet,
    quantize_sr,
    streaming_prime,
    streaming_step,
)
from nerve_tpu_torch.ops import (
    _build,
    conv_chain,
    conv_chain_int8,
    correlation,
    dispatch,
    planar_chain,
    rdb,
    rdb_int8,
)

d2s = importlib.import_module("nerve_tpu_torch.ops.pixel_shuffle")

H, W = 1080, 1920
FEATURES, BLOCKS = 64, 8
STEPS = 4  # output frames; the first is not timed
# Slice limits on the [0, 1] bfloat16 output, kernels vs plain versions.
# Measured 3.9e-3 and 6.3e-5 on an H100 (one-ulp bf16 flips carried through
# 8 RDBs); a wrong tap, channel or edge moves outputs by O(0.1).
SLICE_MAX_ABS, SLICE_MEAN_ABS = 2e-2, 5e-4
# The same for the int8 slice: one int8 step of a requantised intermediate
# that flips between the two runs moves the output by less than this.
INT8_MAX_ABS, INT8_MEAN_ABS = 2e-2, 1e-3
INT8_MIN_PSNR = 30.0  # dB, int8 slice vs bf16 slice (tests/test_quantize.py)
# The lightweight slice, kernels vs plain versions. Measured 3.9e-3 and
# 2.5e-9 on an H100 (a few one-ulp bf16 flips in 25M outputs; the
# depthwise layers are bit-exact); limits ~5x and ~6x that.
LIGHT_MAX_ABS, LIGHT_MEAN_ABS = 2e-2, 1.5e-8
# Its body through the planar chain vs through the per-layer kernels,
# relative to max|per-layer|: the conv-chain level.
PLANAR_BODY_REL = 2.4e-2
# H100 SXM data sheet: device memory rate and dense tensor-core peaks.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def conv_chain_int8_plain_op(x, qchain, out_cout, out_dtype=None):
    """``conv_chain_int8_plain`` under ``ops.conv_chain_int8_apply``'s signature."""
    qlayers, s_in, acts = qchain
    return conv_chain_int8.conv_chain_int8_plain(x, qlayers, s_in, acts, out_cout, out_dtype)


KERNELS = {  # name -> (source, TPU kernel it replaces, plain version)
    "d2s_packed": ("nerve_tpu_torch/csrc/d2s_packed.cu",
                   "nerve_tpu/ops/pixel_shuffle.py:95", d2s.depth_to_space_packed_plain),
    "correlation": ("nerve_tpu_torch/csrc/correlation.cu",
                    "nerve_tpu/ops/correlation.py:52", correlation.correlation_plain),
    "conv_chain": ("nerve_tpu_torch/csrc/conv_chain.cu",
                   "nerve_tpu/ops/conv_chain.py:169", conv_chain.conv_chain_plain),
    "conv_chain_dw3": ("nerve_tpu_torch/csrc/dwconv3.cu",
                       "nerve_tpu/ops/conv_chain.py:169", conv_chain.conv_chain_plain),
    "planar_chain": ("nerve_tpu_torch/csrc/planar_chain.cu",
                     "nerve_tpu/ops/planar_chain.py:107", planar_chain.planar_chain_plain),
    "rdb": ("nerve_tpu_torch/csrc/rdb.cu", "nerve_tpu/ops/rdb.py:121", rdb.rdb_chain_plain),
    "conv_chain_int8": ("nerve_tpu_torch/csrc/conv_int8.cu",
                        "nerve_tpu/ops/conv_chain_int8.py:135", conv_chain_int8_plain_op),
    "rdb_int8": ("nerve_tpu_torch/csrc/rdb_int8.cu", "nerve_tpu/ops/rdb_int8.py:245",
                 rdb_int8.rdb_chain_int8_plain),
}
# bf16 kernels: limits (float32, bfloat16) relative to max|plain|.
BF16_LIMITS = {"d2s_packed": (0.0, 0.0), "correlation": (1e-5, 1e-2),
               "conv_chain": (1e-4, 2.4e-2), "conv_chain_dw3": (1e-4, 2.4e-2),
               "planar_chain": (1e-4, 2.4e-2), "rdb": (1e-4, 1.56e-2)}
CHAIN_KERNELS = ("conv_chain", "conv_chain_dw3", "planar_chain")
# The ops the model calls, and the plain version each is replaced by in
# the reference runs.
OPS_OF = {"d2s_packed": "depth_to_space_packed", "correlation": "correlation_volume",
          "conv_chain": "conv_chain_apply", "conv_chain_dw3": "conv_chain_apply",
          "planar_chain": "planar_chain_apply", "rdb": "rdb_chain_apply",
          "conv_chain_int8": "conv_chain_int8_apply", "rdb_int8": "rdb_chain_int8_apply"}


@contextlib.contextmanager
def plain_ops():
    """Route the models' kernel ops to their plain versions."""
    saved = {op: getattr(ops, op) for op in OPS_OF.values()}
    for name, op in OPS_OF.items():
        setattr(ops, op, KERNELS[name][2])
    try:
        yield
    finally:
        for op, fn in saved.items():
            setattr(ops, op, fn)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


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


def conv_params(g, widths, dev, acts=None, kinds=None):
    out = []
    for i, (cin, cout) in enumerate(zip(widths, widths[1:])):
        act = acts[i] if acts else ("relu" if i < len(widths) - 2 else "none")
        k = kinds[i] if kinds else 3
        out.append((_randn(g, (k, k, cin, cout), (k * k * cin) ** -0.5).to(dev),
                    _randn(g, (cout,), 0.1).to(dev), act))
    return out


def rdb_params(g, c, dev, dt):
    params, cin = [], c
    for _ in range(5):
        params += [_randn(g, (3, 3, cin, 32), (9 * cin) ** -0.5), _randn(g, (32,), 0.1)]
        cin += 32
    params += [_randn(g, (cin, c), cin ** -0.5), _randn(g, (c,), 0.1)]
    return [p.to(dev, dt) for p in params]


# --------------------------------------------------------------------------- #
# Work counts: the bound is max(ops / peak, bytes / memory rate)
# --------------------------------------------------------------------------- #
def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pixels(x) -> int:
    x = x[0] if isinstance(x, (list, tuple)) else x
    return math.prod(x.shape[:3])


def chain_ops(params, npix: int) -> int:
    """Multiply-adds ×2 of a chain of dense convolutions."""
    return sum(2 * math.prod(w.shape) * npix for w, _b, _a in params)


def rdb_ops(plist, npix: int) -> int:
    return sum(2 * math.prod(p.shape) * npix
               for params in plist for p in params if p.ndim > 1)


def bound(ops_count: int, bytes_count: int, kind: str):
    t_ops = ops_count / PEAK_OPS_PER_S[kind]
    t_bytes = bytes_count / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


# --------------------------------------------------------------------------- #
# Library yardsticks: one PyTorch call (or one per layer) for the same function
# --------------------------------------------------------------------------- #
def library_d2s(x):
    b, h, w, c = x.shape
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).reshape(
        b, 2 * h, 2 * w * (c // 4))


def cudnn_chain(params, dt):
    """cuDNN ``F.conv2d`` per layer (``groups=C`` for a depthwise one),
    channels_last, bias in the call."""
    layers = []
    for w, b, act in params:
        wk = w.permute(2, 0, 1).unsqueeze(1) if w.ndim == 3 else w.permute(3, 2, 0, 1)
        layers.append((wk.to(dt).contiguous(memory_format=torch.channels_last), b.to(dt), act,
                       w.shape[0] // 2, w.shape[2] if w.ndim == 3 else 1))

    def run(x):
        h = conv_chain._concat(x).permute(0, 3, 1, 2)
        for w, b, act, pad, groups in layers:
            h = F.conv2d(h, w, b, padding=pad, groups=groups)
            if act == "relu":
                h = torch.relu(h)
        return h.permute(0, 2, 3, 1)
    return run


# --------------------------------------------------------------------------- #
# Kernel checks
# --------------------------------------------------------------------------- #
def serving_inputs(g, dev, dt):
    """The five conv-chain sites' inputs and parameters at 1080p."""
    def act(*shape):
        return _randn(g, shape).to(dev, dt)
    return [
        (act(1, H, W, 3), conv_params(g, [3, FEATURES], dev, ["relu"])),
        (act(2, H // 2, W // 2, 81), conv_params(g, [81, 128, 64, 32, 2], dev)),
        ([act(1, H, W, FEATURES) for _ in range(3)],
         conv_params(g, [3 * FEATURES, FEATURES, FEATURES, 3], dev)),
        (act(1, H, W, FEATURES), conv_params(g, [FEATURES, FEATURES], dev, ["relu"])),
        (act(1, H, W, FEATURES), conv_params(g, [FEATURES, 12], dev, ["none"])),
    ]


def bf16_kernel_cases(dev, dt, serving: bool):
    """name -> (label, kernel call, plain call, work) at small or serving shapes."""
    g = torch.Generator().manual_seed(7)

    def act(*shape):
        return _randn(g, shape).to(dev, dt)

    if serving:
        x = torch.rand((1, H, W, 12), generator=g).to(dev, dt)
        f1, f2 = act(2, H // 2, W // 2, FEATURES), act(2, H // 2, W // 2, FEATURES)
        sites = serving_inputs(g, dev, dt)
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

    # The seeded lightweight body: its four depthwise layers, each on a
    # 32-channel activation, and the whole chain on a planar frame.
    body = [(w.detach(), b.detach(), a) for w, b, a in seeded_lightweight(dev, 3).chain()]
    dws = [e for e in body if e[0].ndim == 3]
    shape = (1, H, W) if serving else (2, 13, 37)
    dw_in = [torch.rand((*shape, 32), generator=g).to(dev, dt) for _ in dws]
    xp = torch.rand((shape[0], 3, *shape[1:]), generator=g).to(dev, dt)
    lw_label = "lightweight body 1080p" if serving else label
    dw_libs = [cudnn_chain([e], dt) for e in dws]
    planar_lib = cudnn_chain(body, dt)

    def chains(fn):
        return lambda: [fn(xx, p) for xx, p in sites]

    def dw_layers(fn):
        return lambda: [fn(a, [e]) for a, e in zip(dw_in, dws)]

    libs = [(xx, cudnn_chain(p, dt)) for xx, p in sites]
    corr_ops = 2 * 81 * f1.shape[-1] * pixels(f1)
    out_corr = math.prod(f1.shape[:3]) * 81 * f1.element_size()
    chain_bytes = sum(nbytes(*(xx if isinstance(xx, list) else [xx]), *(t for w, b, _ in p for t in (w, b)))
                      + pixels(xx) * p[-1][0].shape[-1] * dt.itemsize for xx, p in sites)
    return {
        "d2s_packed": (label, lambda: ops.depth_to_space_packed(x, 2),
                       lambda: d2s.depth_to_space_packed_plain(x, 2),
                       lambda: library_d2s(x), bound(0, 2 * nbytes(x), "bf16")),
        "correlation": (label, lambda: ops.correlation_volume(f1, f2, 4),
                        lambda: correlation.correlation_plain(f1, f2, 4), None,
                        bound(corr_ops, nbytes(f1, f2) + out_corr, "bf16")),
        "conv_chain": (label, chains(ops.conv_chain_apply), chains(conv_chain.conv_chain_plain),
                       lambda: [fn(xx) for xx, fn in libs],
                       bound(sum(chain_ops(p, pixels(xx)) for xx, p in sites), chain_bytes,
                             "bf16")),
        "conv_chain_dw3": (lw_label, dw_layers(ops.conv_chain_apply),
                           dw_layers(conv_chain.conv_chain_plain),
                           lambda: [fn(a) for a, fn in zip(dw_in, dw_libs)],
                           bound(sum(chain_ops([e], pixels(a)) for a, e in zip(dw_in, dws)),
                                 sum(2 * nbytes(a) + nbytes(*e[:2]) for a, e in zip(dw_in, dws)),
                                 "bf16")),
        "planar_chain": (lw_label, lambda: ops.planar_chain_apply(xp, body),
                         lambda: planar_chain.planar_chain_plain(xp, body),
                         lambda: planar_lib(xp.permute(0, 2, 3, 1)),
                         bound(chain_ops(body, xp[0, 0].numel() * xp.shape[0]),
                               nbytes(xp) * 5 + nbytes(*(t for w, b, _ in body for t in (w, b))),
                               "bf16")),
        "rdb": (label, lambda: ops.rdb_chain_apply(xr, plist),
                lambda: rdb.rdb_chain_plain(xr, plist), None,
                bound(rdb_ops(plist, pixels(xr)), 2 * nbytes(xr) + nbytes(*sum(plist, [])),
                      "bf16")),
    }


def int8_kernel_cases(dev, dt, serving: bool):
    """name -> (label, kernel call, plain call, limit, work): each chain and
    the RDB stack calibrated on its own input."""
    g = torch.Generator().manual_seed(8)
    if serving:
        sites = serving_inputs(g, dev, dt)
        xr = _randn(g, (1, H, W, FEATURES), 0.5).to(dev, dt)
        plist = [rdb_params(g, FEATURES, dev, torch.float32) for _ in range(BLOCKS)]
        label = f"serving 1080p ({BLOCKS} RDBs, 5 chain sites)"
    else:
        sites = [([_randn(g, (2, 9, 35, 4)).to(dev, dt) for _ in range(3)],
                  conv_params(g, [12, 40, 20, 3, 12], dev, kinds=[3, 1, 3, 3])),
                 (_randn(g, (1, 13, 37, 3)).to(dev, dt), conv_params(g, [3, 24], dev, ["relu"]))]
        xr = _randn(g, (1, 10, 33, 16), 0.5).to(dev, dt)
        plist = [rdb_params(g, 16, dev, torch.float32) for _ in range(2)]
        label = "small ragged"
    qsites, chain_limit, chain_bytes = [], 0.0, 0
    for xx, p in sites:
        scales = conv_chain_int8.calibrate_conv_chain(xx, p)
        qchain = conv_chain_int8.quantize_conv_chain(p, scales)
        cout = p[-1][0].shape[-1]
        qsites.append((xx, qchain, cout))
        chain_limit = max(chain_limit, 2 * scales.max().item())
        chain_bytes += (nbytes(*(xx if isinstance(xx, list) else [xx]),
                               *(t for layer in qchain[0] for t in layer))
                        + pixels(xx) * cout * dt.itemsize)
    rscales = rdb_int8.calibrate_rdb_chain(xr, plist)
    qrdb = rdb_int8.quantize_rdb_chain(plist, rscales)
    rdb_bytes = 2 * nbytes(xr) + nbytes(*(t for wq, dq, meta in qrdb for t in (*wq, dq, meta)))

    def chains(fn):
        return lambda: [fn(xx, q, cout, dt) for xx, q, cout in qsites]

    return {
        "conv_chain_int8": (label, chains(ops.conv_chain_int8_apply),
                            chains(conv_chain_int8_plain_op), chain_limit,
                            bound(sum(chain_ops(p, pixels(xx)) for xx, p in sites), chain_bytes,
                                  "int8")),
        "rdb_int8": (label, lambda: ops.rdb_chain_int8_apply(xr, qrdb),
                     lambda: rdb_int8.rdb_chain_int8_plain(xr, qrdb), 4 * rscales.max().item(),
                     bound(rdb_ops(plist, pixels(xr)), rdb_bytes, "int8")),
        # Each block alone with float32 output: the JAX package's 1e-4 level.
        "rdb_int8 block f32": (label, lambda: [ops.rdb_chain_int8_apply(
            xr.float(), (blk,), out_dtype=torch.float32) for blk in qrdb[:2]],
            lambda: [rdb_int8.rdb_chain_int8_plain(xr.float(), (blk,), torch.float32)
                     for blk in qrdb[:2]], 1e-4, None),
    }


def _as_list(y):
    return y if isinstance(y, list) else [y]


def compare(name, label, dt, kern, plain, limit, rel_scale=None):
    """Kernel vs plain on the card: (max|err|, elements that differ, ms, plain ms)."""
    got, ref = _as_list(kern()), _as_list(plain())
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
    ndiff = sum(int((a != b).sum()) for a, b in zip(got, ref))
    if rel_scale is not None:
        limit *= max(max(b.float().abs().max().item() for b in ref), rel_scale)
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ok = finite and all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(got, ref)) and (
        err == 0.0 if limit == 0.0 else err <= limit)
    del got, ref
    ms, pms = median_ms(kern), median_ms(plain)
    print(f"kernel {name:18s} {label:38s} {str(dt):15s} max|err| {err:.3e} (limit {limit:.3e}) "
          f"differ {ndiff} kernel {ms:.3f} ms plain {pms:.3f} ms {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain version "
                             f"({label}, {dt}): max|err| {err}")
    torch.cuda.empty_cache()
    return err, ndiff, ms, pms


def check_kernels(dev) -> dict:
    """Kernel vs plain on the card; returns the serving-shape numbers per kernel."""
    summary = {}
    for serving in (False, True):
        for dt in (torch.float32, torch.bfloat16):
            for name, (label, kern, plain, lib, work) in bf16_kernel_cases(dev, dt, serving).items():
                lim = BF16_LIMITS[name][dt == torch.bfloat16]
                rel = 1.0 if name in CHAIN_KERNELS else 0.0
                err, _n, ms, pms = compare(name, label, dt, kern, plain, lim, rel)
                if serving and dt == torch.bfloat16:
                    summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                                     "bound_ms": work[0], "bound_by": work[1],
                                     "library_ms": median_ms(lib) if lib else None}
        # The int8 kernels take the model's bf16 activations at the serving shapes.
        for dt in (torch.bfloat16,) if serving else (torch.float32, torch.bfloat16):
            for name, (label, kern, plain, lim, work) in int8_kernel_cases(dev, dt, serving).items():
                err, _n, ms, pms = compare(name, label, dt, kern, plain, lim)
                if serving and work is not None:
                    summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                                     "bound_ms": work[0], "bound_by": work[1],
                                     "library_ms": None}
    for name, s in summary.items():
        lib = "none" if s["library_ms"] is None else f"{s['library_ms']:.3f} ms"
        print(f"bound {name:16s} {s['bound_ms']:.3f} ms ({s['bound_by']}), kernel "
              f"{s['ms']:.3f} ms: {s['bound_ms'] / s['ms']:.3f} of the bound; library {lib}",
              flush=True)
    return summary


# --------------------------------------------------------------------------- #
# The slices
# --------------------------------------------------------------------------- #
def seed_all(model, seed: int, small=("upsampler",)):
    """Overwrite every parameter and BN statistic with seeded non-zero values
    (a zero-initialised layer would hide the path behind it); kernels whose
    name holds a word of ``small`` are scaled by 0.1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:
                v = 1.0 + 0.1 * _randn(g, p.shape) if name.endswith("scale") else 0.05 * _randn(g, p.shape)
            else:
                v = _randn(g, p.shape, math.prod(p.shape[:-1]) ** -0.5)
                if any(word in name for word in small):
                    v = v * 0.1
            p.copy_(v)
        for name, buf in model.named_buffers():
            if name.endswith(("mean", "var")):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5 if name.endswith("var")
                          else 0.1 * _randn(g, buf.shape))
    return model


def seeded_model(dev, seed: int, **quant) -> SuperResolutionNet:
    """The flagship model, seeded (the zero-initialised flow3/upsampler would
    make the flow 0). ``quant`` (``quantized``, ``quantized_chains``) adds
    int8 state, which draws nothing: the same seed gives the same weights
    with or without it."""
    return seed_all(SuperResolutionNet(scale_factor=2, num_features=FEATURES,
                                       num_residual_blocks=BLOCKS, temporal_window=1,
                                       flow_downsample=2, dtype=torch.bfloat16, device=dev,
                                       **quant).eval(), seed)


def seeded_lightweight(dev, seed: int) -> LightweightSuperResolution:
    """The lightweight model in bfloat16, seeded (the zero-initialised tail
    would make the output the plain bicubic)."""
    return seed_all(LightweightSuperResolution(scale_factor=2, dtype=torch.bfloat16,
                                               device=dev).eval(), seed, small=("tail",))


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


def check_outputs(outs):
    for out in outs:
        if tuple(out.shape) != (1, 2 * H, 2 * W * 3):
            raise AssertionError(f"output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()) or out.min() < 0 or out.max() > 1:
            raise AssertionError("output not finite or outside [0, 1]")


def run_frames(model, video):
    """Each frame through the single-frame model, ``"packed"``; (outputs, ms
    per timed frame)."""
    outs, times = [], []
    for frame in video:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(model(frame, "packed"))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return outs, times[1:]


def drive(model, video, launched, idle, run=run_stream):
    """The main path with every count set to 0 just before and read just
    after; ``launched`` kernels must have run, ``idle`` ones must not."""
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    outs, times = run(model, video)
    launches = dict(dispatch.launches)
    print(f"slice launches {launches}", flush=True)
    missing = [k for k in launched if launches[k] == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")
    if any(launches[k] for k in idle):
        raise AssertionError(f"the main path launched {[k for k in idle if launches[k]]}")
    check_outputs(outs)
    return outs, times, launches, torch.cuda.max_memory_allocated() / 2**30


def against_plain(model, video, outs, max_abs, mean_abs, run=run_stream):
    dispatch.reset_launches()
    with plain_ops():
        ref, ptimes = run(model, video)
    if any(dispatch.launches.values()):
        raise AssertionError(f"the plain run launched kernels: {dispatch.launches}")
    dmax = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs, ref))
    dmean = max((a.float() - b.float()).abs().mean().item() for a, b in zip(outs, ref))
    print(f"slice kernels vs plain: max|d| {dmax:.3e} (limit {max_abs}), "
          f"mean|d| {dmean:.3e} (limit {mean_abs})", flush=True)
    if dmax > max_abs or dmean > mean_abs:
        raise AssertionError("slice output differs from the plain versions' output")
    return ptimes


def run_slice(model, video, card: str):
    outs, times, launches, peak = drive(model, video, ("d2s_packed", "correlation",
                                                       "conv_chain", "rdb"),
                                        ("conv_chain_int8", "rdb_int8"))
    ptimes = against_plain(model, video, outs, SLICE_MAX_ABS, SLICE_MEAN_ABS)
    print(f"slice 1080p->2160p bf16 packed: {statistics.median(times):.1f} ms/frame with "
          f"kernels, {statistics.median(ptimes):.1f} ms/frame plain (median of {len(times)} "
          f"steps; peak {peak:.2f} GiB) on {card}", flush=True)
    return outs, launches, statistics.median(times)


def psnr(a, b) -> float:
    mse = (a.float() - b.float()).pow(2).mean().item()
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def run_int8_slice(model, video, bf16_outs, bf16_ms, card: str):
    calib = torch.stack(video[:3], dim=1)[:, :, :270, :480]
    t0 = time.perf_counter()
    quantize_sr(model, calib, device=calib.device)
    torch.cuda.synchronize()
    print(f"int8 calibration on {tuple(calib.shape)}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    outs, times, launches, peak = drive(model, video, ("d2s_packed", "correlation",
                                                       "conv_chain_int8", "rdb_int8"),
                                        ("conv_chain", "rdb"))
    ptimes = against_plain(model, video, outs, INT8_MAX_ABS, INT8_MEAN_ABS)
    db = min(psnr(a, b) for a, b in zip(outs, bf16_outs))
    print(f"int8 slice vs bf16 slice: PSNR {db:.2f} dB (least over {len(outs)} frames; "
          f"limit {INT8_MIN_PSNR})", flush=True)
    if db < INT8_MIN_PSNR:
        raise AssertionError(f"int8 output only {db:.2f} dB from the bf16 output")
    print(f"slice 1080p->2160p int8 packed: {statistics.median(times):.1f} ms/frame with "
          f"kernels, {statistics.median(ptimes):.1f} ms/frame plain; bf16 slice "
          f"{bf16_ms:.1f} ms/frame (median of {len(times)} steps; peak {peak:.2f} GiB) "
          f"on {card}", flush=True)
    return launches


def check_untrained_lightweight(dev, frame) -> float:
    """The zero-initialised tail makes the output the clipped bicubic
    upscale (the JAX gate's check, to 2⁻⁸: the model casts to bfloat16)."""
    model = LightweightSuperResolution(scale_factor=2, dtype=torch.bfloat16, device=dev,
                                       generator=torch.Generator().manual_seed(2)).eval()
    out = model(frame).float()
    bicubic = ops.pixel_shuffle(ops.upsample_bicubic_channels(frame, 2), 2).clamp(0.0, 1.0)
    err = (out - bicubic).abs().max().item()
    print(f"lightweight untrained vs clipped bicubic: max|d| {err:.3e} (limit {2**-8:.3e})",
          flush=True)
    if not err <= 2.0**-8:
        raise AssertionError("the untrained lightweight model is not the clipped bicubic")
    return err


def run_body(model, video, planar: bool):
    """The model's BN-folded body alone on each frame: per layer through
    ``ops.conv_chain_apply`` (NHWC), or in one launch through
    ``ops.planar_chain_apply`` (planar); (residuals NHWC, ms per timed frame)."""
    outs, times = [], []
    with torch.inference_mode():
        for frame in video:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = frame.to(model.dtype)
            if planar:
                y = ops.planar_chain_apply(x.permute(0, 3, 1, 2), model.chain()).permute(0, 2, 3, 1)
            else:
                y = ops.conv_chain_apply(x, model.chain())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            outs.append(y)
    return outs, times[1:]


def run_lightweight_slice(dev, video, card: str):
    """The lightweight slice (phase 6); returns the launch counts of its
    per-layer run and of its planar-chain run."""
    check_untrained_lightweight(dev, video[0])
    model = seeded_lightweight(dev, seed=0)
    nframes = len(video)
    outs, times, launches, peak = drive(
        model, video, ("conv_chain", "conv_chain_dw3", "d2s_packed"),
        ("correlation", "rdb", "conv_chain_int8", "rdb_int8", "planar_chain"), run_frames)
    want = {"conv_chain": 6 * nframes, "conv_chain_dw3": 4 * nframes, "d2s_packed": nframes}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"lightweight launches {launches}, expected {want}")
    ptimes = against_plain(model, video, outs, LIGHT_MAX_ABS, LIGHT_MEAN_ABS, run_frames)
    print(f"slice lightweight 1080p->2160p bf16 packed: {statistics.median(times):.3f} ms/frame "
          f"with kernels, {statistics.median(ptimes):.3f} ms/frame plain (median of "
          f"{len(times)} frames; peak {peak:.2f} GiB) on {card}", flush=True)
    del outs
    # The body through the one-launch planar chain, against the per-layer body.
    dispatch.reset_launches()
    planar, ptimes = run_body(model, video, planar=True)
    planar_launches = dict(dispatch.launches)
    print(f"planar body launches {planar_launches}", flush=True)
    if planar_launches["planar_chain"] != nframes or sum(planar_launches.values()) != nframes:
        raise AssertionError("the planar body did not run one planar_chain launch per frame")
    layered, ltimes = run_body(model, video, planar=False)
    scale = max(y.float().abs().max().item() for y in layered)
    dmax = max((a.float() - b.float()).abs().max().item() for a, b in zip(planar, layered))
    print(f"lightweight body, planar chain vs per-layer kernels: max|d| {dmax:.3e} (limit "
          f"{PLANAR_BODY_REL * scale:.3e}); body {statistics.median(ptimes):.3f} ms/frame "
          f"planar chain, {statistics.median(ltimes):.3f} ms/frame per layer", flush=True)
    if not dmax <= PLANAR_BODY_REL * scale:
        raise AssertionError("the planar chain's body disagrees with the per-layer body")
    return model, launches, planar_launches


# --------------------------------------------------------------------------- #
# Profile (--profile)
# --------------------------------------------------------------------------- #
def streamer(model):
    """A frame-by-frame step function for the flagship, primed on the first call."""
    carry = []

    def step(frame):
        if not carry:
            carry.append(streaming_prime(model, frame))
            return
        carry[0], _ = streaming_step(model, carry[0], frame, "packed")
    return step


def profile(steppers, video, out_dir: Path) -> None:
    """torch.profiler over 2 steps after 3 warm-up steps of each step
    function; the device's busy time is the union of kernel intervals in the
    trace."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    out_dir.mkdir(parents=True, exist_ok=True)
    for name, step in steppers.items():
        for frame in video[:3]:
            step(frame)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for frame in video[3:5]:
                step(frame)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        trace = out_dir / f"trace_{name}.json"
        prof.export_chrome_trace(str(trace))
        kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
                   if e.get("cat") == "kernel"]
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
        busy, end = 0.0, -math.inf
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        by_name = {}
        for e in kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        total = sum(by_name.values())
        print(f"profile {name}: wall {wall:.1f} ms over 2 steps, device busy "
              f"{busy / 1e3:.1f} ms, idle share {1 - busy / 1e3 / wall:.3f}, "
              f"{len(kernels)} kernels", flush=True)
        for k, d in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
            print(f"  {d / total:6.1%} {d / 2e3:8.3f} ms/step  {k[:110]}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile both slices, writing their traces into DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    start = time.perf_counter()
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

    with phase("build"):
        lib = _build.build()
        _build.library()
        print(f"built {lib.name}", flush=True)
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or re.search(r"\b[1-9]\d* bytes spill", line):
                print(f"  {line.strip()}")
    with phase("kernels"):
        summary = check_kernels(dev)
    g = torch.Generator().manual_seed(1)
    video = [torch.rand((1, H, W, 3), generator=g).to(dev) for _ in range(STEPS + 1)]
    with phase("bf16 slice"):
        bf16_model = seeded_model(dev, seed=0)
        bf16_outs, launches, bf16_ms = run_slice(bf16_model, video, card)
    with phase("int8 slice"):
        int8_model = seeded_model(dev, seed=0, quantized=True, quantized_chains=True)
        launches8 = run_int8_slice(int8_model, video, bf16_outs, bf16_ms, card)
    del bf16_outs
    with phase("lightweight slice"):
        light_model, launches_lw, launches_planar = run_lightweight_slice(dev, video, card)
    if args.profile:
        with phase("profile"):
            profile({"bf16": streamer(bf16_model), "int8": streamer(int8_model),
                     "lightweight": lambda frame: light_model(frame, "packed")},
                    video, Path(args.profile))
    # Each kernel's launches from the run of the path that carries it.
    runs = {"conv_chain_int8": launches8, "rdb_int8": launches8,
            "conv_chain_dw3": launches_lw, "planar_chain": launches_planar}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": runs.get(name, launches)[name], **summary[name]}
               for name, (src, rep, _plain) in KERNELS.items()]
    print(f"total {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
