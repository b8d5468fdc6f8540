"""Drive the PyTorch port's SR serving paths once on an NVIDIA GPU.

    python3 chip_smoke.py              # the checks below, ~2 min on an H100 with the build
    python3 chip_smoke.py --profile build/traces   # also profile the three slices

Phases, each of which raises on failure and prints its wall time:

1. Build: ``nvcc`` compiles ``nerve_tpu_torch/csrc`` for ``sm_90a``; the
   dense-convolution and RDB-fusion kernels' SASS must hold warpgroup
   products and no ``mma.sync`` products: ``HGMMA`` and no ``HMMA`` for the
   bf16 layer and fusion, ``IGMMA`` and no ``IMMA`` for the int8 layer and
   fusion, each instance printed with its ptxas registers and spills.
2. Device: the probe of ``diag.probe`` (a matrix product and the probe
   kernel), then the card's name and power limit (``nvidia-smi``); TF32 off;
   the host cost of one launch through ``_build.launch`` and the probe's
   wrapper beside ``a * 2.0`` (``diag.planar.launch_path``: host clock over
   10,000 launches without a synchronise).
3. Kernels: each of the eleven CUDA kernels against its plain PyTorch version
   on the card, at a small ragged shape and at the serving shapes of the
   flagship path (1080p → 2160p) and, for the depthwise layer and the planar
   chain, of the lightweight body at 1080p (the planar chain with its weight
   pack made beforehand, and once more packing in the call), with median
   times from CUDA events, the
   least time the card could take for the same work (``bound_ms``) and,
   where one PyTorch call computes the same function, that call's time
   (``library_ms``). The bf16 kernels run in bfloat16 and float32; the int8
   kernels take scales calibrated on their own inputs and are bit-exact,
   the int8 RDB also in its three tap schedules over many tiles per block
   at a ragged shape; the input quantisation (``quantize_i8``) is bit-exact
   on values at and next to (k + 0.5)·s, at a scale where x · (1 / s)
   would round some of them otherwise, and past ±127; its serving shape is the
   attention site's three 64-channel frames. The RDB fusions also run alone
   (``rdb_lff``, ``rdb_lff_i8``: 224 → 64 channels at 1080p; at the small
   shape from a wider buffer into an offset slot), the int8 one bit-exact
   on values at .5 steps of the next block's scale; their library times
   are ``torch.matmul`` and ``torch._int_mm`` of the same products. The
   int8 kernels' library
   time is ``torch._int_mm``'s for the same int32 products (products only,
   ``diag.conv.int_mm_yardstick``). Then the bf16 dense
   convolution per conv-chain site and per dense layer of one RDB block,
   each beside cuDNN and its own bound (``diag.conv``, one ``{"conv"}``
   line).
4. bf16 slice: ``SuperResolutionNet`` (64 features, 8 RDBs, temporal window
   1, flow at half resolution, bfloat16) with seeded weights, primed on
   frame 0 of a seeded 1080×1920 video and stepped with
   ``streaming_step(..., "packed")``. Every bf16 kernel's launch counter must
   grow in that run (8 ``rdb`` and 8 ``rdb_lff`` per step). The same frames
   then run with the plain versions on the card, and the two outputs must
   agree.
5. int8 slice: the same seeded model built with ``quantized=True,
   quantized_chains=True``, calibrated by ``quantize_sr`` on a (1, 3, 270,
   480, 3) crop of the video, then streamed the same way. ``rdb_int8``,
   ``conv_chain_int8``, ``quantize_i8``, ``correlation`` and ``d2s_packed``
   must launch (10 ``conv_chain_int8``, 8 ``rdb_int8``, 8 ``rdb_lff_i8`` and
   6 ``quantize_i8`` per step, one more head and quantisation for the
   prime) and ``rdb``, ``rdb_lff`` and ``conv_chain`` must not; each of the
   six int8 states must pack its
   weights once in the run (no frame after the first packs); the output
   must agree with the int8 plain
   versions' and lie within ``INT8_MIN_PSNR`` dB of the bf16 slice's.
6. Diagnostic paths: (a) the kernels of the diagnostic entry points
   (``nerve_tpu_torch.diag``) against their plain versions: the int8 RDB's
   per-channel ``int32_taps`` and dx-major schemes (bit-exact), the RDB
   under each TPU rounding contract and its ablations (``ops.rdb_taps``;
   in bfloat16 a contract's mean|Δ| against its own plain version must be
   at most ¼ of that against any other contract's), the planar d2s and the
   probe kernel, at a small ragged shape in float32 and bfloat16 and at the
   serving shapes (the contracts ``pallas_dx`` and ``s2d``);
   (b) the int8 slice once more with ``rdb_int8.PER_CHANNEL_INT8 = True``
   and the model built inside ``torch.inference_mode()`` (the same checks):
   ``rdb_int8_int32_taps`` must launch, the output must agree with its
   plain run at the int8 limits and lie within ``INT8_MIN_PSNR`` dB of the
   bf16 slice's; (c) the RDB cost-attribution table of ``diag.rdb`` (one
   block at 1080p × 64) and the d2s candidates of ``diag.d2s``.
7. Lightweight slice: an untrained ``LightweightSuperResolution`` (zero
   tail) must return the clipped bicubic upscale within 2⁻⁸; then the model
   with every parameter and BN statistic seeded, in bfloat16, runs frame by
   frame over the same video with ``"packed"`` output. ``conv_chain``,
   ``conv_chain_dw3`` and ``d2s_packed`` must launch (6, 4 and 1 per frame),
   the flagship's other kernels must not, and the output must agree with
   the plain versions' run. Last, the same body runs through
   ``ops.planar_chain_apply`` (the one-launch planar chain) on each planar
   frame: ``planar_chain`` must launch once per frame and nothing else, and
   its result must agree with the per-layer body's. Both bodies take the
   model's chain folded once, the planar one its pack made once.

``--profile DIR`` profiles two steps of each slice (``diag.conv.profile``:
idle share, kernels by time, the RDB fusions', dense layers' and ATen
copies' time and launches per step). The probe (``diag.probe``) runs first
in the device phase. The line before
the last is ``{"kernels": [...]}``; the last line is
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
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.diag import d2s as diag_d2s
from nerve_tpu_torch.diag import probe
from nerve_tpu_torch.diag.planar import launch_path
from nerve_tpu_torch.diag import rdb as diag_rdb
from nerve_tpu_torch.diag.conv import (
    BLOCKS,
    FEATURES,
    STEPS,
    H,
    W,
    bound,
    chain_bytes,
    chain_ops,
    conv_params,
    cudnn_chain,
    int8_layer_shapes,
    int_mm_yardstick,
    measure,
    nbytes,
    pixels,
    profile,
    rdb_int8_shapes,
    run_frames,
    run_stream,
    seeded_lightweight,
    seeded_model,
    serving_inputs,
    streamer,
)
from nerve_tpu_torch.models import LightweightSuperResolution, quantize_sr
from nerve_tpu_torch.ops import (
    _build,
    conv_chain,
    conv_chain_int8,
    correlation,
    dispatch,
    planar_chain,
    rdb,
    rdb_int8,
    rdb_taps,
)

d2s = importlib.import_module("nerve_tpu_torch.ops.pixel_shuffle")

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


def conv_chain_int8_plain_op(x, qchain, out_cout, out_dtype=None, packed=None):
    """``conv_chain_int8_plain`` under ``ops.conv_chain_int8_apply``'s signature."""
    qlayers, s_in, acts = qchain
    return conv_chain_int8.conv_chain_int8_plain(x, qlayers, s_in, acts, out_cout, out_dtype)


def rdb_chain_int8_plain_op(x, qchain, out_dtype=None, int32_taps=None, dx_major=None,
                            packed=None):
    """``rdb_chain_int8_plain`` under ``ops.rdb_chain_int8_apply``'s signature."""
    return rdb_int8.rdb_chain_int8_plain(x, qchain, out_dtype, int32_taps, dx_major)


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
                 rdb_chain_int8_plain_op),
    # The RDB fusions alone (each also runs inside its RDB above).
    "rdb_lff": ("nerve_tpu_torch/csrc/rdb.cu", "nerve_tpu/ops/rdb.py:121", rdb.lff_plain),
    "rdb_lff_i8": ("nerve_tpu_torch/csrc/rdb_int8.cu", "nerve_tpu/ops/rdb_int8.py:245",
                   rdb_int8.lff_plain_i8),
    # The int8 paths' input quantisation: an XLA fusion in the JAX package.
    "quantize_i8": ("nerve_tpu_torch/csrc/quantize_i8.cu", "nerve_tpu/ops/conv_chain_int8.py:284",
                    conv_chain_int8.quantize_into_plain),
    # The diagnostic paths' kernels (phase 6).
    "rdb_int8_int32_taps": ("nerve_tpu_torch/csrc/conv_int8.cu",
                            "nerve_tpu/ops/rdb_int8.py:245", rdb_int8.rdb_chain_int8_plain),
    "rdb_taps": ("nerve_tpu_torch/csrc/rdb_taps.cu", "scripts/diag_rdb.py:406",
                 rdb_taps.rdb_taps_plain),
    "d2s_packed_planar": ("nerve_tpu_torch/csrc/d2s_packed.cu", "scripts/diag_d2s.py:140",
                          d2s.depth_to_space_packed_planar_plain),
    "probe": ("nerve_tpu_torch/csrc/probe.cu", "scripts/tpu_probe.py:37",
              probe.probe_scale2_plain),
}
# bf16 kernels: limits (float32, bfloat16) relative to max|plain|.
BF16_LIMITS = {"d2s_packed": (0.0, 0.0), "correlation": (1e-5, 1e-2),
               "conv_chain": (1e-4, 2.4e-2), "conv_chain_dw3": (1e-4, 2.4e-2),
               "planar_chain": (1e-4, 2.4e-2), "planar_chain pack in the call": (1e-4, 2.4e-2),
               "rdb": (1e-4, 1.56e-2),
               "rdb_lff": (1e-4, 1.56e-2)}
CHAIN_KERNELS = ("conv_chain", "conv_chain_dw3", "planar_chain", "planar_chain pack in the call")
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


PROBE_REPS = 25


def median_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` runs of ``fn`` on the card (CUDA events), after a warm-up."""
    return _common.median_ms(fn, torch.device("cuda"), reps)


def _randn(g, shape, std=1.0):
    return torch.randn(shape, generator=g) * std


# --------------------------------------------------------------------------- #
# Work counts: the bound is max(ops / peak, bytes / memory rate)
# --------------------------------------------------------------------------- #
def rdb_ops(plist, npix: int) -> int:
    return sum(2 * math.prod(p.shape) * npix
               for params in plist for p in params if p.ndim > 1)


# Dense-convolution and RDB-fusion kernels -> (their warpgroup product, the
# mma.sync product they must not issue), as cuobjdump -sass names them.
SASS_PRODUCTS = {"conv_wgmma_kernel": ("HGMMA", "HMMA"),
                 "conv_i8_wgmma_kernel": ("IGMMA", "IMMA"),
                 "lff_wgmma_kernel": ("HGMMA", "HMMA"),
                 "lff_i8_wgmma_kernel": ("IGMMA", "IMMA")}


def check_sass(lib: Path) -> None:
    """The dense-convolution kernels (``conv_wgmma_kernel<K, N>``, bf16;
    ``conv_i8_wgmma_kernel<K, N, MODE>``, int8) and the RDB fusions
    (``lff_wgmma_kernel``, ``lff_i8_wgmma_kernel``) must each be in the
    library and issue warpgroup products and no ``mma.sync`` products
    (``SASS_PRODUCTS``): print each instance's counts and its ptxas
    registers and spills."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, name, kernel = {}, None, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernel = next((k for k in SASS_PRODUCTS if re.search(rf"\d{k}[IE]", name)), None)
        elif kernel:
            gmma, mma = SASS_PRODUCTS[kernel]
            c = counts.setdefault(name, [kernel, 0, 0])
            c[1] += re.search(rf"\b{gmma}\b", line) is not None
            c[2] += re.search(rf"\b{mma}\b", line) is not None
    log = lib.with_suffix(".log").read_text().splitlines()
    for name, (kernel, gmma, mma) in sorted(counts.items()):
        args = ", ".join(re.findall(r"Li(\d+)E", name))
        usage = dict.fromkeys(u.split(":", 1)[-1].strip() for i, line in enumerate(log)
                              if "Compiling entry function" in line and name in line
                              for u in log[i + 1:i + 5] if "spill" in u or "Used" in u)
        label = f"{kernel}<{args}>" if args else kernel
        print(f"sass {label}: {gmma} {SASS_PRODUCTS[kernel][0]}, {mma} "
              f"{SASS_PRODUCTS[kernel][1]}; {'; '.join(usage)}", flush=True)
    found = {kernel for kernel, *_ in counts.values()}
    if found != set(SASS_PRODUCTS) or any(gmma == 0 or mma for _k, gmma, mma in counts.values()):
        raise AssertionError(f"the dense conv kernels do not run on warpgroup products alone: "
                             f"{counts}")


# --------------------------------------------------------------------------- #
# Library yardsticks: one PyTorch call (or one per layer) for the same function
# --------------------------------------------------------------------------- #
def library_d2s(x):
    b, h, w, c = x.shape
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).reshape(
        b, 2 * h, 2 * w * (c // 4))


# --------------------------------------------------------------------------- #
# Kernel checks
# --------------------------------------------------------------------------- #
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
        plist = [_common.rdb_params(g, FEATURES, dev, dt) for _ in range(BLOCKS)]
        label = f"serving 1080p ({BLOCKS} RDBs, 5 chain sites)"
    else:
        x = act(2, 13, 37, 12)
        f1, f2 = act(2, 11, 35, 16), act(2, 11, 35, 16)
        sites = [([act(2, 9, 35, 4) for _ in range(3)], conv_params(g, [12, 40, 20, 3, 12], dev))]
        xr = act(1, 10, 33, 16)
        plist = [_common.rdb_params(g, 16, dev, dt) for _ in range(2)]
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
    planar_pack = planar_chain.packed_planar_chain(body, dt, dev)

    def chains(fn):
        return lambda: [fn(xx, p) for xx, p in sites]

    def dw_layers(fn):
        return lambda: [fn(a, [e]) for a, e in zip(dw_in, dws)]

    libs = [(xx, cudnn_chain(p, dt)) for xx, p in sites]
    # The fusion alone: the leading C + L·G channels of the buffer in; at
    # the small shape from a wider buffer into an offset slot.
    lc, lcat, lpad, lcoff = (FEATURES, FEATURES + 160, 0, 0) if serving else (16, 176, 8, 8)
    cat = act(*xr.shape[:3], lcat + lpad) if serving else act(2, 13, 37, lcat + lpad)
    lw = _randn(g, (lcat, lc), lcat ** -0.5).to(dev, dt)
    lb = _randn(g, (lc,), 0.1).to(dev)
    lout = torch.zeros((*cat.shape[:3], lc + lcoff), dtype=dt, device=dev)
    lflat = cat.view(-1, lcat) if serving else None
    corr_ops = 2 * 81 * f1.shape[-1] * pixels(f1)
    out_corr = math.prod(f1.shape[:3]) * 81 * f1.element_size()
    site_bytes = sum(chain_bytes(xx, p, dt) for xx, p in sites)
    planar_work = bound(chain_ops(body, xp[0, 0].numel() * xp.shape[0]),
                        nbytes(xp) * 5 + nbytes(*(t for w, b, _ in body for t in (w, b))), "bf16")
    return {
        "d2s_packed": (label, lambda: ops.depth_to_space_packed(x, 2),
                       lambda: d2s.depth_to_space_packed_plain(x, 2),
                       lambda: library_d2s(x), bound(0, 2 * nbytes(x), "bf16")),
        "correlation": (label, lambda: ops.correlation_volume(f1, f2, 4),
                        lambda: correlation.correlation_plain(f1, f2, 4), None,
                        bound(corr_ops, nbytes(f1, f2) + out_corr, "bf16")),
        "conv_chain": (label, chains(ops.conv_chain_apply), chains(conv_chain.conv_chain_plain),
                       lambda: [fn(xx) for xx, fn in libs],
                       bound(sum(chain_ops(p, pixels(xx)) for xx, p in sites), site_bytes,
                             "bf16")),
        "conv_chain_dw3": (lw_label, dw_layers(ops.conv_chain_apply),
                           dw_layers(conv_chain.conv_chain_plain),
                           lambda: [fn(a) for a, fn in zip(dw_in, dw_libs)],
                           bound(sum(chain_ops([e], pixels(a)) for a, e in zip(dw_in, dws)),
                                 sum(2 * nbytes(a) + nbytes(*e[:2]) for a, e in zip(dw_in, dws)),
                                 "bf16")),
        "planar_chain": (lw_label, lambda: ops.planar_chain_apply(xp, body, packed=planar_pack),
                         lambda: planar_chain.planar_chain_plain(xp, body),
                         lambda: planar_lib(xp.permute(0, 2, 3, 1)), planar_work),
        "planar_chain pack in the call": (lw_label, lambda: ops.planar_chain_apply(xp, body),
                                          lambda: planar_chain.planar_chain_plain(xp, body),
                                          None, planar_work),
        "rdb": (label, lambda: ops.rdb_chain_apply(xr, plist),
                lambda: rdb.rdb_chain_plain(xr, plist), None,
                bound(rdb_ops(plist, pixels(xr)), 2 * nbytes(xr) + nbytes(*sum(plist, [])),
                      "bf16")),
        "rdb_lff": (f"{label}: fusion {lcat}->{lc}",
                    lambda: rdb.lff_launch(cat, lw, lb, lout, lcoff)[..., lcoff:],
                    lambda: rdb.lff_plain(cat, lw, lb),
                    (lambda: torch.matmul(lflat, lw)) if serving else None,
                    bound(2 * lcat * lc * pixels(cat),
                          pixels(cat) * (lcat + lc) * dt.itemsize + nbytes(lw, lb), "bf16")),
    }


def int8_kernel_cases(dev, dt, serving: bool):
    """name -> (label, kernel call, plain call, limit, work, library call):
    each chain and the RDB stack calibrated on its own input, every case
    bit-exact (limit 0); at the small shapes also the RDB in its three tap
    schedules over many tiles per block at a ragged shape (cin not a
    multiple of the 32-channel chunk), and the input quantisation on ties
    and values past ±127."""
    g = torch.Generator().manual_seed(8)
    if serving:
        sites = serving_inputs(g, dev, dt)
        xr = _randn(g, (1, H, W, FEATURES), 0.5).to(dev, dt)
        plist = [_common.rdb_params(g, FEATURES, dev, torch.float32) for _ in range(BLOCKS)]
        label = f"serving 1080p ({BLOCKS} RDBs, 5 chain sites)"
    else:
        sites = [([_randn(g, (2, 9, 35, 4)).to(dev, dt) for _ in range(3)],
                  conv_params(g, [12, 40, 20, 3, 12], dev, kinds=[3, 1, 3, 3])),
                 (_randn(g, (1, 13, 37, 3)).to(dev, dt), conv_params(g, [3, 24], dev, ["relu"]))]
        xr = _randn(g, (1, 10, 33, 16), 0.5).to(dev, dt)
        plist = [_common.rdb_params(g, 16, dev, torch.float32) for _ in range(2)]
        label = "small ragged"
    qsites, chain_bytes = [], 0
    for xx, p in sites:
        scales = conv_chain_int8.calibrate_conv_chain(xx, p)
        qchain = conv_chain_int8.quantize_conv_chain(p, scales)
        cout = p[-1][0].shape[-1]
        qsites.append((xx, qchain, cout, conv_chain_int8.packed_chain(qchain[0], cout)))
        chain_bytes += (nbytes(*(xx if isinstance(xx, list) else [xx]),
                               *(t for layer in qchain[0] for t in layer))
                        + pixels(xx) * cout * dt.itemsize)
    rscales = rdb_int8.calibrate_rdb_chain(xr, plist)
    qrdb = rdb_int8.quantize_rdb_chain(plist, rscales)
    prdb = rdb_int8.packed_rdb_chain(qrdb)
    rdb_bytes = 2 * nbytes(xr) + nbytes(*(t for wq, dq, meta in qrdb for t in (*wq, dq, meta)))

    def chains(fn):
        return lambda: [fn(xx, q, cout, dt, packed=pk) for xx, q, cout, pk in qsites]

    # The attention site's three 64-channel frames (the serving shape), or
    # ragged parts holding values at and next to (k + 0.5)·s, some of which
    # round otherwise under x · (1 / s) than under x / s, and values past
    # ±127·s.
    s_q = torch.tensor(0.3 if not serving else 0.05, device=dev)
    if serving:
        qparts = sites[2][0]
    else:
        qparts = []
        for c in (3, 16, 9):
            v = _randn(g, (2, 7, 11, c), 60.0)
            ties = (torch.randint(-140, 140, v.shape, generator=g) + 0.5) * 0.3
            r = torch.rand(v.shape, generator=g)
            ties = torch.where(r < 0.2, ties, torch.nextafter(ties, torch.where(
                r < 0.35, torch.tensor(float("inf")), torch.tensor(float("-inf")))))
            qparts.append(torch.where(r < 0.5, ties, v).to(dev, dt))
    # The int8 fusion alone, into the next block's int8 buffer (at the small
    # shape a wider one, at an offset): in channels [0, C / 2) the factors
    # and biases are 0 and s_in = s_next / 2, so v = x · s_in sits on .5
    # steps of s_next.
    fc, fcat = (FEATURES, FEATURES + 160) if serving else (16, 176)
    fshape = (1, H, W) if serving else (2, 13, 37)
    fpad, fcoff = (0, 0) if serving else (16, 16)
    fx = torch.randint(-127, 128, (*fshape, fcat + fpad), generator=g, dtype=torch.int8).to(dev)
    fw = torch.randint(-127, 128, (fcat, fc), generator=g, dtype=torch.int8)
    fimage = conv_chain_int8.pack_i8_weights(fw, 1, fc, fc, rdb_int8.LFF_N_TILE).to(dev)
    fdq, fbias = torch.rand(fc, generator=g) * 1e-4, _randn(g, (fc,), 0.1)
    fdq[:fc // 2], fbias[:fc // 2] = 0.0, 0.0
    fdq, fbias, fw = fdq.to(dev), fbias.to(dev), fw.to(dev)
    fs_next = torch.tensor([0.3], device=dev)
    fs_in = fs_next / 2
    fout = torch.zeros((*fshape, fcat + fpad), dtype=torch.int8, device=dev)
    fnpix = math.prod(fshape)
    qc = sum(t.shape[-1] for t in qparts)
    qbufs = [torch.empty((*qparts[0].shape[:3], -(-qc // 16) * 16), dtype=torch.int8,
                         device=dev) for _ in range(2)]
    cases = {
        "conv_chain_int8": (label, chains(ops.conv_chain_int8_apply),
                            chains(conv_chain_int8_plain_op), 0.0,
                            bound(sum(chain_ops(p, pixels(xx)) for xx, p in sites), chain_bytes,
                                  "int8"),
                            int_mm_yardstick([s for xx, p in sites
                                              for s in int8_layer_shapes(xx, p)], dev)),
        "rdb_int8": (label, lambda: ops.rdb_chain_int8_apply(xr, qrdb, packed=prdb),
                     lambda: rdb_int8.rdb_chain_int8_plain(xr, qrdb), 0.0,
                     bound(rdb_ops(plist, pixels(xr)), rdb_bytes, "int8"),
                     int_mm_yardstick(rdb_int8_shapes(pixels(xr), xr.shape[-1]), dev,
                                      repeat=len(plist))),
        # Each block alone with float32 output.
        "rdb_int8 block f32": (label, lambda: [ops.rdb_chain_int8_apply(
            xr.float(), (blk,), out_dtype=torch.float32, packed=prdb[k:k + 1])
            for k, blk in enumerate(qrdb[:2])],
            lambda: [rdb_int8.rdb_chain_int8_plain(xr.float(), (blk,), torch.float32)
                     for blk in qrdb[:2]], 0.0, None, None),
        "rdb_lff_i8": (f"{label}: fusion {fcat}->{fc}, int8 out",
                       lambda: (rdb_int8.lff_launch_i8(fx, fcat, fimage, fdq, fbias, fs_in,
                                                       fs_next, fout, fcoff),
                                fout[..., fcoff:fcoff + fc])[1],
                       lambda: rdb_int8.lff_plain_i8(fx, fw, fdq, fbias, fs_in[0], fs_next[0]),
                       0.0,
                       bound(2 * fcat * fc * fnpix, fnpix * (fcat + fc) + fimage.numel(), "int8"),
                       int_mm_yardstick([(1, fcat, fc, fnpix)], dev)),
        "quantize_i8": (f"{label}: {len(qparts)} parts, {qc} channels",
                        lambda: conv_chain_int8.quantize_into(qparts, s_q, qbufs[0],
                                                              qbufs[0].shape[-1]),
                        lambda: conv_chain_int8.quantize_into_plain(qparts, s_q, qbufs[1],
                                                                    qbufs[1].shape[-1]),
                        0.0, bound(0, nbytes(*qparts) + qbufs[0].numel(), "int8"), None),
    }
    if not serving:
        # Many tiles per block (the ping-pong rings turn over many times) at
        # ragged H, W and cin = 40 + 32 i, in each tap schedule.
        xm = _randn(g, (2, 131, 517, 40), 0.5).to(dev, dt)
        pm = [_common.rdb_params(g, 40, dev, torch.float32) for _ in range(2)]
        sm = rdb_int8.calibrate_rdb_chain(xm.float(), pm)
        for scheme, it, dx in (("per_column", False, False), ("per_column_dx", False, True),
                               ("int32_taps", True, False)):
            q = rdb_int8.quantize_rdb_chain(pm, sm, per_channel=it)
            pq = rdb_int8.packed_rdb_chain(q, it)
            cases[f"rdb_int8 many tiles {scheme}"] = (
                "ragged 2x131x517x40", lambda q=q, it=it, dx=dx, pq=pq: ops.rdb_chain_int8_apply(
                    xm, q, None, it, dx, pq),
                lambda q=q, it=it, dx=dx: rdb_int8.rdb_chain_int8_plain(xm, q, None, it, dx),
                0.0, None, None)
    return cases


def _as_list(y):
    return y if isinstance(y, list) else [y]


def compare(name, label, dt, kern, plain, limit, rel_scale=None, reps=5):
    """Kernel vs plain on the card: (max|err|, elements that differ, ms, plain ms),
    each time the median of ``reps`` calls."""
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
    ms, pms = median_ms(kern, reps), median_ms(plain, reps)
    print(f"kernel {name:24s} {label:38s} {str(dt):15s} max|err| {err:.3e} (limit {limit:.3e}) "
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
            for name, (label, kern, plain, lim, work, lib) in int8_kernel_cases(
                    dev, dt, serving).items():
                err, _n, ms, pms = compare(name, label, dt, kern, plain, lim)
                if serving and work is not None:
                    summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                                     "bound_ms": work[0], "bound_by": work[1],
                                     "library_ms": median_ms(lib) if lib else None}
                    torch.cuda.empty_cache()
    for name, s in summary.items():
        lib = "none" if s["library_ms"] is None else f"{s['library_ms']:.3f} ms"
        if name.startswith(("conv_chain_int8", "rdb_int8")) and s["library_ms"] is not None:
            lib += " (torch._int_mm, products only)"
        print(f"bound {name:16s} {s['bound_ms']:.3f} ms ({s['bound_by']}), kernel "
              f"{s['ms']:.3f} ms: {s['bound_ms'] / s['ms']:.3f} of the bound; library {lib}",
              flush=True)
    return summary


def diag_kernel_cases(dev, dt, serving: bool):
    """name -> (label, kernel call, plain call, limit, relative, library call,
    work, margin) of the diagnostic paths' kernels. ``limit`` is relative to
    max|plain| where ``relative``, else absolute; ``margin``, for the bf16
    RDB contracts, returns ``rdb_taps.contract_margin`` of the kernel's
    output."""
    g = torch.Generator().manual_seed(9)
    if serving:
        xr = _randn(g, (1, H, W, FEATURES), 0.5).to(dev, dt)
        plist = [_common.rdb_params(g, FEATURES, dev, torch.float32) for _ in range(BLOCKS)]
        xb = _randn(g, (1, H, W, FEATURES)).to(dev, dt)
        block = _common.rdb_params(g, FEATURES, dev, dt)
        xp = torch.rand((1, 12, H, W), generator=g).to(dev, dt)
        modes = ("pallas_dx", "s2d")
        label = f"serving 1080p ({BLOCKS} int8 RDBs, 1 RDB)"
    else:
        xr = _randn(g, (1, 10, 33, 16), 0.5).to(dev, dt)
        plist = [_common.rdb_params(g, 16, dev, torch.float32) for _ in range(2)]
        xb = _randn(g, (2, 13, 37, 12)).to(dev, dt)
        block = _common.rdb_params(g, 12, dev, dt)
        xp = torch.rand((2, 12, 13, 37), generator=g).to(dev, dt)
        modes = (*rdb_taps.CONTRACTS, "noshift", "nolff")
        label = "small ragged"
    rscales = rdb_int8.calibrate_rdb_chain(xr, plist)
    qpc = rdb_int8.quantize_rdb_chain(plist, rscales, per_channel=True)
    qcol = rdb_int8.quantize_rdb_chain(plist, rscales)
    rdb_bytes = 2 * nbytes(xr) + nbytes(*(t for wq, dq, meta in qpc for t in (*wq, dq, meta)))
    int8_work = bound(rdb_ops(plist, pixels(xr)), rdb_bytes, "int8")
    cases = {}
    # Both schedules are bit-exact: the same int32 sums, the same float32
    # operations in the same order.
    # The per-column schedule's products, as torch._int_mm computes them.
    int_mm = int_mm_yardstick(rdb_int8_shapes(pixels(xr), xr.shape[-1]), dev, repeat=len(plist))
    for name, q, it, dx in (("rdb_int8_int32_taps", qpc, True, False),
                            ("rdb_int8 per_column_dx", qcol, False, True)):
        pq = rdb_int8.packed_rdb_chain(q, it)
        cases[name] = (label, lambda q=q, it=it, dx=dx, pq=pq: ops.rdb_chain_int8_apply(
                           xr, q, None, it, dx, pq),
                       lambda q=q, it=it, dx=dx: rdb_int8.rdb_chain_int8_plain(xr, q, None, it, dx),
                       0.0, False, int_mm, int8_work, None)
    taps_work = bound(rdb_ops([block], pixels(xb)), 2 * nbytes(xb) + nbytes(*block), "bf16")
    lim = BF16_LIMITS["rdb"][dt == torch.bfloat16]
    for mode in modes:
        name = "rdb_taps" if mode == "pallas_dx" else f"rdb_taps {mode}"
        margin = (lambda m=mode: rdb_taps.contract_margin(ops.rdb_taps_apply(xb, block, m),
                                                          xb, block, m)
                  ) if dt == torch.bfloat16 and mode in rdb_taps.CONTRACTS else None
        cases[name] = (label, lambda m=mode: ops.rdb_taps_apply(xb, block, m),
                       lambda m=mode: rdb_taps.rdb_taps_plain(xb, block, m), lim, True, None,
                       taps_work, margin)
    cases["d2s_packed_planar"] = (
        label, lambda: ops.depth_to_space_packed_planar(xp, 2),
        lambda: d2s.depth_to_space_packed_planar_plain(xp, 2), 0.0, False,
        lambda: diag_d2s.library_planar(xp), bound(0, 2 * nbytes(xp), "bf16"), None)
    if dt == torch.float32:
        a = torch.rand((8, 128), generator=g).to(dev)
        cases["probe"] = ("(8, 128)", lambda: probe.probe_scale2(a),
                          lambda: probe.probe_scale2_plain(a), 0.0, False, lambda: a * 2.0,
                          bound(0, 2 * nbytes(a), "bf16"), None)
        # 4099 values at an odd offset: the scalar path.
        v = torch.rand(4100, generator=g).to(dev)[1:]
        cases["probe odd view"] = ("(4099,) at offset 1", lambda: probe.probe_scale2(v),
                                   lambda: probe.probe_scale2_plain(v), 0.0, False, None,
                                   None, None)
    return cases


def check_diag_kernels(dev) -> dict:
    """Phase 6a: the diagnostic paths' kernels against their plain versions;
    the serving-shape numbers of the four entries of the kernels line."""
    summary = {}
    for serving in (False, True):
        for dt in (torch.bfloat16,) if serving else (torch.float32, torch.bfloat16):
            for name, (label, kern, plain, lim, rel, lib, work, margin) in diag_kernel_cases(
                    dev, dt, serving).items():
                # The probe's time is host work: more calls for a steadier median.
                reps = PROBE_REPS if name == "probe" else 5
                err, _n, ms, pms = compare(name, label, dt, kern, plain, lim,
                                           0.0 if rel else None, reps)
                if margin is not None:
                    mine, least_other = margin()
                    ok = mine <= 0.25 * least_other
                    print(f"contract {name:24s} {label:38s} mean|d| vs its plain {mine:.3e}, "
                          f"vs the nearest other contract {least_other:.3e} "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        raise AssertionError(f"{name} is nearer another contract's plain "
                                             f"version than a quarter of its own ({label})")
                    torch.cuda.empty_cache()
                if name in KERNELS and (serving or name == "probe"):
                    summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                                     "bound_ms": work[0], "bound_by": work[1],
                                     "library_ms": median_ms(lib, reps) if lib else None}
    # matonly computes no layer, so it has no plain version: it must launch.
    g = torch.Generator().manual_seed(10)
    block = _common.rdb_params(g, 16, dev, torch.bfloat16)
    n0 = dispatch.launches["rdb_taps"]
    ops.rdb_taps_apply(_randn(g, (1, 10, 33, 16)).to(dev, torch.bfloat16), block, "matonly")
    torch.cuda.synchronize()
    if dispatch.launches["rdb_taps"] != n0 + 1:
        raise AssertionError("rdb_taps matonly did not launch")
    print("kernel rdb_taps matonly launched (no plain version: timing only)", flush=True)
    return summary


# --------------------------------------------------------------------------- #
# The slices
# --------------------------------------------------------------------------- #
def check_outputs(outs):
    for out in outs:
        if tuple(out.shape) != (1, 2 * H, 2 * W * 3):
            raise AssertionError(f"output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()) or out.min() < 0 or out.max() > 1:
            raise AssertionError("output not finite or outside [0, 1]")


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
                                                       "conv_chain", "rdb", "rdb_lff"),
                                        ("conv_chain_int8", "rdb_int8", "quantize_i8",
                                         "rdb_lff_i8"))
    steps = len(video) - 1
    if launches["rdb_lff"] != launches["rdb"] or launches["rdb"] != 8 * steps:
        raise AssertionError(f"bf16 slice launches {launches}: expected 8 rdb and 8 rdb_lff "
                             "per step")
    ptimes = against_plain(model, video, outs, SLICE_MAX_ABS, SLICE_MEAN_ABS)
    print(f"slice 1080p->2160p bf16 packed: {statistics.median(times):.1f} ms/frame with "
          f"kernels, {statistics.median(ptimes):.1f} ms/frame plain (median of {len(times)} "
          f"steps; peak {peak:.2f} GiB) on {card}", flush=True)
    return outs, launches, statistics.median(times)


def psnr(a, b) -> float:
    mse = (a.float() - b.float()).pow(2).mean().item()
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def run_int8_slice(model, video, bf16_outs, beside, card: str):
    """Calibrate and stream the int8 model; ``beside`` is (name, ms per frame)
    of the slice its time is printed beside. Returns (launches, ms per frame)."""
    calib = torch.stack(video[:3], dim=1)[:, :, :270, :480]
    t0 = time.perf_counter()
    quantize_sr(model, calib, device=calib.device)
    torch.cuda.synchronize()
    print(f"int8 calibration on {tuple(calib.shape)}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    scheme = "per-channel int32_taps" if rdb_int8.PER_CHANNEL_INT8 else "per-column"
    int32 = ("rdb_int8_int32_taps",)
    outs, times, launches, peak = drive(
        model, video, ("d2s_packed", "correlation", "conv_chain_int8", "rdb_int8", "quantize_i8",
                       "rdb_lff_i8") + (int32 if rdb_int8.PER_CHANNEL_INT8 else ()),
        ("conv_chain", "rdb", "rdb_lff") + (() if rdb_int8.PER_CHANNEL_INT8 else int32))
    # Per step five chain sites (10 layers) and the RDB stack (8 blocks, 8
    # fusions), each quantising its input once; the prime runs the head
    # once more.
    steps = len(video) - 1
    want = {"conv_chain_int8": 10 * steps + 1, "rdb_int8": 8 * steps,
            "rdb_lff_i8": 8 * steps, "quantize_i8": 6 * steps + 1}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"int8 slice launches {launches}, expected {want}")
    # Each int8 state (five chain sites, the RDB stack) packs its weights at
    # its first call and keeps them: a frame after the first packs none.
    packs = dispatch.packs["int8"]
    print(f"int8 weight packs over {steps} steps: {packs} (one per int8 state)", flush=True)
    if packs != 6:
        raise AssertionError(f"the int8 slice packed weights {packs} times, expected 6")
    ptimes = against_plain(model, video, outs, INT8_MAX_ABS, INT8_MEAN_ABS)
    db = min(psnr(a, b) for a, b in zip(outs, bf16_outs))
    print(f"int8 {scheme} slice vs bf16 slice: PSNR {db:.2f} dB (least over {len(outs)} "
          f"frames; limit {INT8_MIN_PSNR})", flush=True)
    if db < INT8_MIN_PSNR:
        raise AssertionError(f"int8 output only {db:.2f} dB from the bf16 output")
    ms = statistics.median(times)
    print(f"slice 1080p->2160p int8 {scheme} packed: {ms:.1f} ms/frame with "
          f"kernels, {statistics.median(ptimes):.1f} ms/frame plain; {beside[0]} slice "
          f"{beside[1]:.1f} ms/frame (median of {len(times)} steps; peak {peak:.2f} GiB) "
          f"on {card}", flush=True)
    return launches, ms


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
    ``ops.planar_chain_apply`` (planar, its weight pack made once); the
    chain is folded once, before the frames. (residuals NHWC, ms per timed
    frame)."""
    outs, times = [], []
    with torch.inference_mode():
        chain = model.chain()
        pack = planar_chain.packed_planar_chain(chain, model.dtype, video[0].device)
        for frame in video:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = frame.to(model.dtype)
            if planar:
                y = ops.planar_chain_apply(x.permute(0, 3, 1, 2), chain, packed=pack)
                y = y.permute(0, 2, 3, 1)
            else:
                y = ops.conv_chain_apply(x, chain)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            outs.append(y)
    return outs, times[1:]


def run_lightweight_slice(dev, video, card: str):
    """The lightweight slice (phase 7); returns the launch counts of its
    per-layer run and of its planar-chain run."""
    check_untrained_lightweight(dev, video[0])
    model = seeded_lightweight(dev, seed=0)
    nframes = len(video)
    outs, times, launches, peak = drive(
        model, video, ("conv_chain", "conv_chain_dw3", "d2s_packed"),
        ("correlation", "rdb", "conv_chain_int8", "rdb_int8", "planar_chain", "quantize_i8",
         "rdb_lff", "rdb_lff_i8"), run_frames)
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


def run_per_channel_int8_slice(dev, video, bf16_outs, int8_ms, card: str):
    """Phase 6b: the int8 slice with per-channel scales and int32 taps."""
    saved = rdb_int8.PER_CHANNEL_INT8
    rdb_int8.PER_CHANNEL_INT8 = True
    try:
        # Built inside inference mode, as serving code may build it: its int8
        # state still packs once.
        with torch.inference_mode():
            model = seeded_model(dev, seed=0, quantized=True, quantized_chains=True)
        launches, _ms = run_int8_slice(model, video, bf16_outs,
                                       ("int8 per-column", int8_ms), card)
    finally:
        rdb_int8.PER_CHANNEL_INT8 = saved
    return launches


def run_diag_paths(dev):
    """Phase 6c: the diagnostic entry points' own timed paths, each with
    the counts set to 0 just before and read just after."""
    dispatch.reset_launches()
    g = torch.Generator().manual_seed(11)
    block = _common.rdb_params(g, FEATURES, dev, torch.bfloat16)
    x = _randn(g, (1, H, W, FEATURES)).to(dev, torch.bfloat16)
    diag_rdb.report(diag_rdb.attribution(x, block, reps=5, check=False),
                    f"one block, {H}x{W}x{FEATURES} bf16")
    rdb_launches = dict(dispatch.launches)
    print(f"diag rdb launches {rdb_launches}", flush=True)
    dispatch.reset_launches()
    diag_d2s.main([])
    d2s_launches = dict(dispatch.launches)
    print(f"diag d2s launches {d2s_launches}", flush=True)
    for name, launches in (("rdb_taps", rdb_launches), ("d2s_packed_planar", d2s_launches)):
        if launches[name] == 0:
            raise AssertionError(f"the diagnostic path launched no {name} kernel")
    return rdb_launches, d2s_launches


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
    with phase("build"):
        lib = _build.build()
        _build.library()
        print(f"built {lib.name}", flush=True)
        for line in lib.with_suffix(".log").read_text().splitlines():
            if ("registers" in line or "Performance Loss" in line
                    or re.search(r"\b[1-9]\d* bytes spill", line)):
                print(f"  {line.strip()}")
        check_sass(lib)
    with phase("device"):
        dispatch.reset_launches()
        probe.main([])
        launches_probe = dict(dispatch.launches)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(card, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        launch_path(dev)
    with phase("kernels"):
        summary = check_kernels(dev)
        print(json.dumps({"conv": measure(dev, reps=5, small=False)}), flush=True)
    g = torch.Generator().manual_seed(1)
    video = [torch.rand((1, H, W, 3), generator=g).to(dev) for _ in range(STEPS + 1)]
    with phase("bf16 slice"):
        bf16_model = seeded_model(dev, seed=0)
        bf16_outs, launches, bf16_ms = run_slice(bf16_model, video, card)
    with phase("int8 slice"):
        int8_model = seeded_model(dev, seed=0, quantized=True, quantized_chains=True)
        launches8, int8_ms = run_int8_slice(int8_model, video, bf16_outs, ("bf16", bf16_ms),
                                            card)
    with phase("diagnostic paths"):
        summary.update(check_diag_kernels(dev))
        launches8pc = run_per_channel_int8_slice(dev, video, bf16_outs, int8_ms, card)
        launches_rdb, launches_d2s = run_diag_paths(dev)
    del bf16_outs
    with phase("lightweight slice"):
        light_model, launches_lw, launches_planar = run_lightweight_slice(dev, video, card)
    if args.profile:
        with phase("profile"):
            profile({"bf16": streamer(bf16_model), "int8": streamer(int8_model),
                     "lightweight": lambda frame: light_model(frame, "packed")},
                    video, Path(args.profile))
    # Each kernel's launches from the run of the path that carries it.
    runs = {"conv_chain_int8": launches8, "rdb_int8": launches8, "quantize_i8": launches8,
            "rdb_lff_i8": launches8,
            "conv_chain_dw3": launches_lw, "planar_chain": launches_planar,
            "rdb_int8_int32_taps": launches8pc, "rdb_taps": launches_rdb,
            "d2s_packed_planar": launches_d2s, "probe": launches_probe}
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
