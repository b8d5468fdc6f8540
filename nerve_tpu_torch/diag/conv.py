"""The dense convolutions where the serving paths run them, at 1080p:
``python -m nerve_tpu_torch.diag.conv [--int8] [--slices] [--device cpu] [--small]``.

``csrc/conv_chain.cu``'s layer (``nt_conv2d``) is the flagship's conv-chain
kernel and the RDB's dense-layer kernel. The cases, in bfloat16, each with
its bound (max of operations over the bf16 peak and bytes over the memory
rate, each input read and output written once) and, where one exists,
cuDNN's time for the same layers (``F.conv2d`` per layer, channels_last,
bias in the call):

* each conv-chain site of the flagship through ``ops.conv_chain_apply``:
  head, flow head, attention (three frames as a list), gff, upsampler;
  then the five together (``chip_smoke.py``'s ``conv_chain`` entry);
* one RDB block's five dense layers in the RDB's form: the leading ``cin``
  channels of the block's 224-channel buffer in, a 32-channel slot of the
  same buffer out (``ops.conv_chain.conv_layer_launch``);
* the RDB stack's 8 blocks (``ops.rdb_chain_apply``);
* with ``--int8``, the int8 dense layer (``csrc/conv_int8.cu``,
  ``nt_conv2d_i8``) and the input quantisation in the same places, each
  calibrated on its own input, weights packed once as a served model keeps
  them: each conv-chain site through ``ops.conv_chain_int8_apply``, its
  layers alone (10 runs back to back on a quantised input) and its input
  quantisation alone; each dense layer of one int8 RDB block (64…192 → 32)
  in the RDB's form, once and 10 times back to back; the int8 RDB stack's
  8 blocks per column and per channel. The
  yardstick is ``torch._int_mm``'s time for the same int32 products
  (products only: one call per 1×1 layer and per 3×3 layer on a pre-built
  int8 im2col matrix, K and N padded to multiples of 8; no im2col, no
  dequantisation), the bound that of int8 (1,979 TOPS);
* with ``--fusion``, each RDB fusion alone at 1080p (C + L·G = 224 → 64),
  10 launches back to back on one concatenation buffer, its weights as the
  serving path hands them over: the bf16 fusion through
  ``ops.rdb.lff_launch(cat, lw, lb)`` (``csrc/rdb.cu``), beside
  ``torch.matmul`` of the (npix, 224) × (224, 64) bf16 view (products
  only); the int8 fusion through ``ops.rdb_int8.lff_launch_i8`` with a
  block's packed weights into the next block's buffer
  (``csrc/rdb_int8.cu``), beside ``torch._int_mm`` of the int8 view
  (products only); each with its bound (bytes: the concatenation read and
  the output written once);
* with ``--slices``, ms per frame of the flagship's bf16 and int8 (per
  column and per channel) streaming slices and the lightweight slice,
  seeded as ``chip_smoke.py`` seeds them (median of the timed frames, the
  first untimed);
* with ``--profile DIR``, a ``torch.profiler`` trace of two steps of the
  bf16 and int8 (per column) slices (``profile``): wall and device-busy
  time, the device's idle share, the kernels by time, and per step the
  time and launches of the RDB fusions (kernel names holding ``lff``), the
  dense layers and ATen's copy kernels.

It measures the ``nerve_tpu_torch`` that is first on the path and prints
its location first, so the same file times another checkout's package:
``PYTHONPATH=OTHER python nerve_tpu_torch/diag/conv.py --slices --fusion
--profile DIR`` (the slices drive the models' public entry points only,
the fusions ``lff_launch(cat, lw, lb)`` and ``lff_launch_i8(cat, ccat,
block.lw, ldq, lbias, s_in, s_next, out)``, calls that earlier checkouts
with int8 RDBs take too; ``--int8`` needs this checkout's int8 API). The
last line is one JSON object of every time.
"""

from __future__ import annotations

import json
import math
import statistics
import time
from pathlib import Path

import torch
import torch.nn.functional as F

import nerve_tpu_torch
from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.models import (
    LightweightSuperResolution,
    SuperResolutionNet,
    quantize_sr,
    streaming_prime,
    streaming_step,
)
from nerve_tpu_torch.ops import conv_chain, rdb_int8
from nerve_tpu_torch.ops import conv_chain_int8 as cc8

H, W = 1080, 1920
FEATURES, BLOCKS, GROWTH = 64, 8, 32
STEPS = 4  # output frames of a slice; the first is not timed
# H100 SXM data sheet: device memory rate and dense tensor-core peaks.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
SITES = ("head", "flow_head", "attention", "gff", "upsampler")


def _randn(g, shape, std=1.0):
    return torch.randn(shape, generator=g) * std


def conv_params(g, widths, dev, acts=None, kinds=None):
    """Seeded He-scaled ``(kernel, bias, act)`` layers; relu but the last."""
    out = []
    for i, (cin, cout) in enumerate(zip(widths, widths[1:])):
        act = acts[i] if acts else ("relu" if i < len(widths) - 2 else "none")
        k = kinds[i] if kinds else 3
        out.append((_randn(g, (k, k, cin, cout), (k * k * cin) ** -0.5).to(dev),
                    _randn(g, (cout,), 0.1).to(dev), act))
    return out


def serving_inputs(g, dev, dt, h=H, w=W):
    """The five conv-chain sites' inputs and layers at ``h`` × ``w``, in
    ``SITES`` order: [(input, layers)]."""
    def act(*shape):
        return _randn(g, shape).to(dev, dt)
    return [
        (act(1, h, w, 3), conv_params(g, [3, FEATURES], dev, ["relu"])),
        (act(2, h // 2, w // 2, 81), conv_params(g, [81, 128, 64, 32, 2], dev)),
        ([act(1, h, w, FEATURES) for _ in range(3)],
         conv_params(g, [3 * FEATURES, FEATURES, FEATURES, 3], dev)),
        (act(1, h, w, FEATURES), conv_params(g, [FEATURES, FEATURES], dev, ["relu"])),
        (act(1, h, w, FEATURES), conv_params(g, [FEATURES, 12], dev, ["none"])),
    ]


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


def chain_bytes(x, params, dt) -> int:
    """The input, the layers' weights and biases, the last layer's output."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    return (nbytes(*xs, *(t for w, b, _ in params for t in (w, b)))
            + pixels(x) * params[-1][0].shape[-1] * dt.itemsize)


def bound(ops_count: int, bytes_count: int, kind: str):
    """(least ms, "operations" or "bytes")."""
    t_ops = ops_count / PEAK_OPS_PER_S[kind]
    t_bytes = bytes_count / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


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
# Seeded models and the slices
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


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_stream(model, video):
    """Prime on frame 0 and step through the rest; (outputs, ms per timed step)."""
    carry = streaming_prime(model, video[0])
    outs, times = [], []
    for frame in video[1:]:
        _sync(frame.device)
        t0 = time.perf_counter()
        carry, out = streaming_step(model, carry, frame, "packed")
        _sync(frame.device)
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return outs, times[1:]


def run_frames(model, video):
    """Each frame through the single-frame model, ``"packed"``; (outputs, ms
    per timed frame)."""
    outs, times = [], []
    for frame in video:
        _sync(frame.device)
        t0 = time.perf_counter()
        outs.append(model(frame, "packed"))
        _sync(frame.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return outs, times[1:]


def slices(dev, h: int, w: int) -> dict:
    """ms per frame of the bf16, int8 (per column and per channel) and
    lightweight slices."""
    g = torch.Generator().manual_seed(1)
    video = [torch.rand((1, h, w, 3), generator=g).to(dev) for _ in range(STEPS + 1)]
    calib = torch.stack(video[:3], dim=1)[:, :, :h // 4, :w // 4]
    out = {}
    with torch.inference_mode():
        out["bf16"] = statistics.median(run_stream(seeded_model(dev, 0), video)[1])
    saved = rdb_int8.PER_CHANNEL_INT8
    try:
        for name, per_channel in (("int8", False), ("int8_per_channel", True)):
            rdb_int8.PER_CHANNEL_INT8 = per_channel
            model8 = seeded_model(dev, 0, quantized=True, quantized_chains=True)
            quantize_sr(model8, calib, device=dev)
            with torch.inference_mode():
                out[name] = statistics.median(run_stream(model8, video)[1])
            del model8
    finally:
        rdb_int8.PER_CHANNEL_INT8 = saved
    with torch.inference_mode():
        out["lightweight"] = statistics.median(run_frames(seeded_lightweight(dev, 0), video)[1])
    return out


def int_mm_yardstick(shapes, dev, repeat: int = 1):
    """``torch._int_mm`` (int8 × int8 → int32) for the products of dense
    layers ``[(k, cin, cout, npix)]``: one call per layer on pre-built
    operands, an (npix, k²·cin) im2col matrix of random int8 and the
    (k²·cin, cout) weights, K and N padded to multiples of 8 (the call's
    rule); every layer ``repeat`` times. Products only. The operands are
    made at the first call (the timing's warm-up)."""
    mats = []

    def run():
        if not mats:
            g = torch.Generator(device=dev).manual_seed(0)
            for k, cin, cout, npix in shapes:
                kk, n = -(-k * k * cin // 8) * 8, -(-cout // 8) * 8
                mats.append((torch.randint(-127, 128, (npix, kk), generator=g,
                                           dtype=torch.int8, device=dev),
                             torch.randint(-127, 128, (n, kk), generator=g,
                                           dtype=torch.int8, device=dev).t()))
        return [torch._int_mm(a, b) for _ in range(repeat) for a, b in mats]
    return run


def int8_layer_shapes(x, params):
    """[(k, cin, cout, npix)] of a chain's dense layers."""
    return [(w.shape[0], w.shape[2], w.shape[3], pixels(x)) for w, _b, _a in params]


def rdb_int8_shapes(npix: int, c: int = FEATURES, blocks: int = BLOCKS):
    """[(k, cin, cout, npix)] of one RDB block's dense layers and fusion."""
    return [(3, c + GROWTH * i, GROWTH, npix) for i in range(5)] + [(1, c + 5 * GROWTH, c, npix)]


def chain_alone(xs, qchain, cout, dt, n: int = 10):
    """``n`` runs of a quantised chain's layer kernels back to back on its
    quantised input, weights packed beforehand."""
    qlayers, s_in, acts = qchain
    b, h, w = xs[0].shape[:3]
    cin = sum(t.shape[-1] for t in xs)
    hq = torch.zeros((b, h, w, -(-cin // 16) * 16), dtype=torch.int8, device=xs[0].device)
    cc8.quantize_into(xs, s_in, hq, hq.shape[-1])
    launches, x = [], hq
    for i, layer in enumerate(cc8.packed_chain(qlayers, cout)):
        last = i == len(qlayers) - 1
        out = torch.empty((b, h, w, layer.cout if last else -(-layer.cout // 16) * 16),
                          dtype=dt if last else torch.int8, device=hq.device)
        launches.append((x, layer, out, 0, acts[i] == "relu"))
        x = out
    return lambda: [cc8.conv_layer_launch_i8(*args) for _ in range(n) for args in launches]


def rdb_layer_i8(cat, layer, n: int = 1):
    """``n`` launches of one packed dense layer of an int8 RDB block in the
    RDB's form (its input channels of the block's buffer in, its slot out),
    per column, as ``rdb_chain_int8_apply`` runs it."""
    return lambda: [cc8.conv_layer_launch_i8(cat, layer, cat, layer.cin, relu=True)
                    for _ in range(n)]


# --------------------------------------------------------------------------- #
# The cases
# --------------------------------------------------------------------------- #
def rdb_layer_call(cat, cin, w, b):
    """One dense layer in the RDB's form: channels [0, cin) of ``cat`` in,
    its 32-channel slot at ``cin`` out; the kernel on the card, the plain
    version on the CPU."""
    if cat.is_cuda:  # float32 weights at bf16 values: the wrapper's input on every tree
        wf = w.to(cat.dtype).float().contiguous()
        return lambda: conv_chain.conv_layer_launch(cat, cin, wf, b, cat, cin, relu=True)
    return lambda: conv_chain.conv_chain_plain(cat[..., :cin], [(w, b, "relu")])


def kernel_alone(cat, cin, w, b, n: int = 10):
    """``n`` back-to-back launches of the layer's kernel with its weights
    packed beforehand (no wrapper glue between them), or None where this
    package has no weight pack."""
    if not (cat.is_cuda and hasattr(conv_chain, "pack_conv_weights")):
        return None
    from nerve_tpu_torch.ops import _build
    wp = conv_chain.pack_conv_weights(w)
    bh, h, wd, ctot = cat.shape
    args = (cat.data_ptr(), cat.data_ptr(), cat.data_ptr(), 1, ctot, cin, wp.data_ptr(),
            b.data_ptr(), cat.data_ptr(), ctot, cin, w.shape[-1], bh, h, wd, 3, 1,
            _build.dtype_code(cat))
    return lambda: [_build.launch("nt_conv2d", cat.device, *args) for _ in range(n)]


def measure(dev, reps: int, small: bool) -> dict:
    """Every case's times and bounds (module docstring)."""
    dt = torch.bfloat16
    h, w = (18, 70) if small else (H, W)
    g = torch.Generator().manual_seed(7)
    rows = {}

    def row(name, kern, lib, work, launches=None):
        ms = _common.median_ms(kern, dev, reps)
        lib_ms = _common.median_ms(lib, dev, reps) if lib else None
        rows[name] = {"ms": ms, "library_ms": lib_ms, "bound_ms": work[0], "bound_by": work[1]}
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
        print(f"conv {name:28s} kernel {ms:.3f} ms, library {lib_txt}, bound {work[0]:.3f} ms "
              f"({work[1]}): {work[0] / ms:.3f} of the bound", flush=True)
        torch.cuda.empty_cache() if dev.type == "cuda" else None

    sites = serving_inputs(g, dev, dt, h, w)
    for name, (x, p) in zip(SITES, sites):
        lib = cudnn_chain(p, dt)
        row(f"site {name}", lambda x=x, p=p: ops.conv_chain_apply(x, p), lambda x=x, f=lib: f(x),
            bound(chain_ops(p, pixels(x)), chain_bytes(x, p, dt), "bf16"))
    libs = [(x, cudnn_chain(p, dt)) for x, p in sites]
    row("five sites", lambda: [ops.conv_chain_apply(x, p) for x, p in sites],
        lambda: [f(x) for x, f in libs],
        bound(sum(chain_ops(p, pixels(x)) for x, p in sites),
              sum(chain_bytes(x, p, dt) for x, p in sites), "bf16"))
    del sites, libs

    block = _common.rdb_params(g, FEATURES, dev, dt)
    cat = _randn(g, (1, h, w, FEATURES + 5 * GROWTH)).to(dev, dt)
    for i in range(5):
        cin = FEATURES + i * GROWTH
        wi, bi = block[2 * i], block[2 * i + 1].float()
        lib = cudnn_chain([(wi, bi, "relu")], dt)
        npix = pixels(cat)
        name = f"rdb layer {i} ({cin}->{GROWTH})"
        row(name, rdb_layer_call(cat, cin, wi, bi), lambda cin=cin, f=lib: f(cat[..., :cin]),
            bound(2 * wi.numel() * npix, npix * (cin + GROWTH) * 2 + nbytes(wi, bi), "bf16"))
        alone = kernel_alone(cat, cin, wi, bi)
        if alone is not None:
            rows[name]["kernel_alone_ms"] = _common.median_ms(alone, dev, reps) / 10
            print(f"conv {name:28s} kernel alone {rows[name]['kernel_alone_ms']:.3f} ms "
                  "(10 back-to-back launches, weights packed once)", flush=True)
    del cat
    plist = [_common.rdb_params(g, FEATURES, dev, dt) for _ in range(2 if small else BLOCKS)]
    xr = _randn(g, (1, h, w, FEATURES)).to(dev, dt)
    row(f"rdb {len(plist)} blocks", lambda: ops.rdb_chain_apply(xr, plist), None,
        bound(sum(2 * p.numel() * pixels(xr) for q in plist for p in q if p.ndim > 1),
              2 * nbytes(xr) + nbytes(*sum(plist, [])), "bf16"))
    return rows


def measure_int8(dev, reps: int, small: bool) -> dict:
    """Every int8 case's times and bounds (module docstring)."""
    dt = torch.bfloat16
    h, w = (18, 70) if small else (H, W)
    g = torch.Generator().manual_seed(8)
    rows = {}

    def row(name, kern, lib, work, alone=None):
        ms = _common.median_ms(kern, dev, reps)
        lib_ms = _common.median_ms(lib, dev, reps) if lib else None
        rows[name] = {"ms": ms, "library_ms": lib_ms, "bound_ms": work[0], "bound_by": work[1]}
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.3f} ms (_int_mm, products only)"
        print(f"int8 {name:28s} kernel {ms:.3f} ms, library {lib_txt}, bound {work[0]:.3f} ms "
              f"({work[1]}): {work[0] / ms:.3f} of the bound", flush=True)
        for what, fn in (alone or {}).items():
            rows[name][f"{what}_ms"] = _common.median_ms(fn, dev, reps) / (
                10 if what == "kernels_alone" else 1)
            print(f"int8 {name:28s} {what} {rows[name][f'{what}_ms']:.3f} ms", flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    sites, total = [], None
    for name, (x, p) in zip(SITES, serving_inputs(g, dev, dt, h, w)):
        xs = x if isinstance(x, list) else [x]
        q = cc8.quantize_conv_chain(p, cc8.calibrate_conv_chain(xs, p))
        cout = p[-1][0].shape[-1]
        work = (chain_ops(p, pixels(x)),
                nbytes(*xs, *(t for layer in q[0] for t in layer)) + pixels(x) * cout * 2)
        sites.append((xs, q, cout, work, int8_layer_shapes(x, p), cc8.packed_chain(q[0], cout)))
        cin = sum(t.shape[-1] for t in xs)
        hq = torch.empty((*xs[0].shape[:3], -(-cin // 16) * 16), dtype=torch.int8,
                         device=xs[0].device)
        alone = None
        if dev.type == "cuda":
            alone = {"kernels_alone": chain_alone(xs, q, cout, dt),
                     "quantize": lambda xs=xs, q=q, hq=hq: cc8.quantize_into(xs, q[1], hq,
                                                                            hq.shape[-1])}
        row(f"site {name}", lambda xs=xs, q=q, c=cout, pk=sites[-1][5]: ops.conv_chain_int8_apply(
            xs, q, c, dt, packed=pk),
            int_mm_yardstick(sites[-1][4], dev) if dev.type == "cuda" else None,
            bound(*work, "int8"), alone)
        del hq
    row("five sites", lambda: [ops.conv_chain_int8_apply(xs, q, c, dt, packed=pk)
                               for xs, q, c, _w, _s, pk in sites],
        int_mm_yardstick([s for site in sites for s in site[4]], dev)
        if dev.type == "cuda" else None,
        bound(sum(s[3][0] for s in sites), sum(s[3][1] for s in sites), "int8"))
    del sites

    block = _common.rdb_params(g, FEATURES, dev)
    xcal = _randn(g, (1, min(h, 128), min(w, 256), FEATURES), 0.5).to(dev)
    qblock = rdb_int8.quantize_rdb_chain([block], rdb_int8.calibrate_rdb_chain(xcal, [block]))[0]
    cat = torch.randint(-127, 128, (1, h, w, FEATURES + 5 * GROWTH), generator=g,
                        dtype=torch.int8).to(dev)
    npix = pixels(cat)
    layers = rdb_int8.packed_block(qblock, FEATURES, 5, GROWTH, False).layers
    for i in range(5 if dev.type == "cuda" else 0):  # the RDB's form exists on the card only
        cin = FEATURES + i * GROWTH
        row(f"rdb layer {i} ({cin}->{GROWTH})", rdb_layer_i8(cat, layers[i]),
            int_mm_yardstick([(3, cin, GROWTH, npix)], dev),
            bound(2 * 9 * cin * GROWTH * npix, npix * (cin + GROWTH) + 9 * cin * GROWTH, "int8"),
            {"kernels_alone": rdb_layer_i8(cat, layers[i], 10)})
    del cat
    blocks = 2 if small else BLOCKS
    plist = [_common.rdb_params(g, FEATURES, dev) for _ in range(blocks)]
    scales = rdb_int8.calibrate_rdb_chain(xcal, plist)
    xr = _randn(g, (1, h, w, FEATURES), 0.5).to(dev, dt)
    ops_count = sum(2 * p.numel() * pixels(xr) for q in plist for p in q if p.ndim > 1)
    for scheme, per_channel in (("per column", False), ("per channel", True)):
        q = rdb_int8.quantize_rdb_chain(plist, scales, per_channel=per_channel)
        pq = rdb_int8.packed_rdb_chain(q, per_channel)
        row(f"rdb {blocks} blocks {scheme}",
            lambda q=q, pc=per_channel, pq=pq: ops.rdb_chain_int8_apply(xr, q, None, pc, None, pq),
            int_mm_yardstick(rdb_int8_shapes(pixels(xr)), dev, repeat=blocks)
            if dev.type == "cuda" else None,
            bound(ops_count, 2 * nbytes(xr) + nbytes(*(t for wq, dq, m in q
                                                       for t in (*wq, dq, m))), "int8"))
    return rows


def measure_fusions(dev, reps: int, small: bool, n: int = 10) -> dict:
    """Each RDB fusion alone (module docstring): ms per launch over ``n``
    back-to-back launches, the library's products, the bound."""
    h, w = (18, 70) if small else (H, W)
    ccat = FEATURES + 5 * GROWTH
    g = torch.Generator().manual_seed(12)
    rows = {}

    def row(name, kern, lib, work):
        ms = _common.median_ms(kern, dev, reps) / n
        lib_ms = _common.median_ms(lib, dev, reps) / n if lib else None
        rows[name] = {"ms": ms, "library_ms": lib_ms, "bound_ms": work[0], "bound_by": work[1]}
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.3f} ms (products only)"
        print(f"fusion {name:12s} kernel {ms:.3f} ms, library {lib_txt}, bound {work[0]:.3f} ms "
              f"({work[1]}): {work[0] / ms:.3f} of the bound", flush=True)

    cat = _randn(g, (1, h, w, ccat)).to(dev, torch.bfloat16)
    lw = _randn(g, (ccat, FEATURES), ccat ** -0.5).to(dev, torch.bfloat16)
    lb = _randn(g, (FEATURES,), 0.1).to(dev)
    npix, ops_count = pixels(cat), 2 * ccat * FEATURES * pixels(cat)
    flat = cat.view(npix, ccat)
    row("bf16", lambda: [ops.rdb.lff_launch(cat, lw, lb) for _ in range(n)],
        lambda: [torch.matmul(flat, lw) for _ in range(n)],
        bound(ops_count, npix * (ccat + FEATURES) * 2 + nbytes(lw, lb), "bf16"))
    del cat, flat
    block = _common.rdb_params(g, FEATURES, dev)
    xcal = _randn(g, (1, min(h, 128), min(w, 256), FEATURES), 0.5).to(dev)
    qblock = rdb_int8.quantize_rdb_chain([block], rdb_int8.calibrate_rdb_chain(xcal, [block]))[0]
    image = rdb_int8.packed_block(qblock, FEATURES, 5, GROWTH, False).lw
    meta = qblock[2]
    cats = [torch.randint(-127, 128, (1, h, w, ccat), generator=g, dtype=torch.int8).to(dev)
            for _ in range(2)]
    flat8 = cats[0].view(npix, ccat)
    w8 = qblock[0][5][rdb_int8.FEAT_OFF:].t().contiguous().t()
    row("int8", lambda: [rdb_int8.lff_launch_i8(cats[0], ccat, image, meta[1, :FEATURES],
                                                meta[1, FEATURES:2 * FEATURES], meta[2, :1],
                                                meta[2, :1], cats[1]) for _ in range(n)],
        lambda: [torch._int_mm(flat8, w8) for _ in range(n)],
        bound(ops_count, npix * (ccat + FEATURES) + image.numel(), "int8"))
    return rows


def streamer(model):
    """A frame-by-frame step function for the flagship, primed on the first call."""
    carry = []

    def step(frame):
        if not carry:
            carry.append(streaming_prime(model, frame))
            return
        carry[0], _ = streaming_step(model, carry[0], frame, "packed")
    return step


# Kernel groups the profile attributes per step, by a word of the kernel's name.
PROFILE_GROUPS = {"RDB fusions": ("lff",), "dense layers": ("conv_wgmma", "conv_i8_wgmma"),
                  "ATen copies": ("copy",)}


def profile(steppers, video, out_dir: Path) -> dict:
    """torch.profiler over 2 steps after 3 warm-up steps of each step
    function; the device's busy time is the union of kernel intervals in the
    trace. Returns per step function the ms and launches per step of each
    of ``PROFILE_GROUPS``."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    out_dir.mkdir(parents=True, exist_ok=True)
    result = {}
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
        groups = {}
        for group, words in PROFILE_GROUPS.items():
            hits = [e["dur"] for e in kernels if any(wd in e["name"] for wd in words)]
            groups[group] = {"ms_per_step": sum(hits) / 2e3, "launches_per_step": len(hits) / 2}
            print(f"profile {name} {group}: {sum(hits) / 2e3:.3f} ms/step, "
                  f"{len(hits) / 2:g} launches/step", flush=True)
        result[name] = {"wall_ms": wall, "busy_ms": busy / 1e3, "kernels": len(kernels),
                        "groups": groups}
    return result


def profile_slices(dev, h: int, w: int, out_dir: Path) -> dict:
    """``profile`` of the bf16 and int8 (per column) slices, seeded as
    ``slices`` seeds them."""
    g = torch.Generator().manual_seed(1)
    video = [torch.rand((1, h, w, 3), generator=g).to(dev) for _ in range(STEPS + 1)]
    calib = torch.stack(video[:3], dim=1)[:, :, :h // 4, :w // 4]
    model8 = seeded_model(dev, 0, quantized=True, quantized_chains=True)
    saved = rdb_int8.PER_CHANNEL_INT8
    rdb_int8.PER_CHANNEL_INT8 = False
    try:
        quantize_sr(model8, calib, device=dev)
        with torch.inference_mode():
            return profile({"bf16": streamer(seeded_model(dev, 0)), "int8": streamer(model8)},
                           video, out_dir)
    finally:
        rdb_int8.PER_CHANNEL_INT8 = saved


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--int8", action="store_true",
                   help="also time the int8 dense layer and the input quantisation")
    p.add_argument("--slices", action="store_true",
                   help="also time the bf16, int8 and lightweight slices (ms per frame)")
    p.add_argument("--fusion", action="store_true",
                   help="also time each RDB fusion alone (bf16 and int8)")
    p.add_argument("--profile", metavar="DIR",
                   help="also profile the bf16 and int8 slices, writing their traces into DIR")
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    print(f"package {nerve_tpu_torch.__file__}", flush=True)
    if dev.type == "cuda":
        print(f"device {torch.cuda.get_device_name(dev)}", flush=True)
    result = {"cases": measure(dev, args.reps, args.small)}
    if args.int8:
        result["int8"] = measure_int8(dev, args.reps, args.small)
    if args.fusion:
        if dev.type != "cuda":
            raise SystemExit("--fusion times the fusion kernels: run it with --device cuda")
        result["fusion"] = measure_fusions(dev, args.reps, args.small)
    h, w = (36, 64) if args.small else (H, W)
    if args.slices:
        result["slices"] = slices(dev, h, w)
        print("slices ms/frame " + ", ".join(f"{k} {v:.3f}" for k, v in result["slices"].items()),
              flush=True)
    if args.profile:
        if dev.type != "cuda":
            raise SystemExit("--profile traces the card: run it with --device cuda")
        result["profile"] = profile_slices(dev, h, w, Path(args.profile))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
