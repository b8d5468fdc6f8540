"""The bf16 dense convolution where the serving paths run it, at 1080p:
``python -m nerve_tpu_torch.diag.conv [--slices] [--device cpu] [--small]``.

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
* with ``--slices``, ms per frame of the flagship's bf16 and int8 streaming
  slices and the lightweight slice, seeded as ``chip_smoke.py`` seeds them
  (median of the timed frames, the first untimed).

It measures the ``nerve_tpu_torch`` that is first on the path and prints
its location first, so the same file times another checkout's package:
``PYTHONPATH=OTHER python nerve_tpu_torch/diag/conv.py --slices``. The last
line is one JSON object of every time.
"""

from __future__ import annotations

import json
import math
import statistics
import time

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
from nerve_tpu_torch.ops import conv_chain

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
    """ms per frame of the bf16, int8 (per-column) and lightweight slices."""
    g = torch.Generator().manual_seed(1)
    video = [torch.rand((1, h, w, 3), generator=g).to(dev) for _ in range(STEPS + 1)]
    with torch.inference_mode():
        bf16 = statistics.median(run_stream(seeded_model(dev, 0), video)[1])
        model8 = seeded_model(dev, 0, quantized=True, quantized_chains=True)
        quantize_sr(model8, torch.stack(video[:3], dim=1)[:, :, :h // 4, :w // 4],
                    device=dev)
        int8 = statistics.median(run_stream(model8, video)[1])
        light = statistics.median(run_frames(seeded_lightweight(dev, 0), video)[1])
    return {"bf16": bf16, "int8": int8, "lightweight": light}


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


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--slices", action="store_true",
                   help="also time the bf16, int8 and lightweight slices (ms per frame)")
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    print(f"package {nerve_tpu_torch.__file__}", flush=True)
    if dev.type == "cuda":
        print(f"device {torch.cuda.get_device_name(dev)}", flush=True)
    result = {"cases": measure(dev, args.reps, args.small)}
    if args.slices:
        h, w = (36, 64) if args.small else (H, W)
        result["slices"] = slices(dev, h, w)
        print("slices ms/frame " + ", ".join(f"{k} {v:.3f}" for k, v in result["slices"].items()),
              flush=True)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
