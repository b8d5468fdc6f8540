"""The depthwise 3×3 layers at 1080p:
``python -m nerve_tpu_torch.diag.depthwise [--profile DIR] [--sass] [--device cpu] [--small]``.

First the kernel (``csrc/dwconv3.cu``, one ``ops.conv_chain_apply`` call per
layer) against its plain version: bfloat16 and float32, relu and none, at a
ragged shape with partial tiles on all four edges, C = 32 and 64 (the
``"tma"`` route) and 12 (``"tile"`` in bfloat16). Then the median of ``--reps``
(at least 25 on the card) CUDA-event timings of three sets of layers, each
layer one ``ops.conv_chain_apply(x, [layer])`` call:

* ``lightweight``: the seeded ``LightweightSuperResolution`` body's four
  depthwise layers, each on a 1 × 1080 × 1920 × 32 bfloat16 activation (the
  lightweight serving path); ``lightweight_float32`` the same in float32;
* ``features``: three depthwise layers of the flagship ``FeatureExtractor``
  (``DepthwiseSeparableConv.as_entries``), each on 1 × 1080 × 1920 × 64
  bfloat16.
  The served model runs these in plain ATen today (``use_fused`` off); the
  set says what the kernel would take there.

Beside each set: the plain version's time, cuDNN's (``F.conv2d`` with
``groups=C`` per layer, channels_last, bias in the call) and the byte bound
(each layer's input read and output written once, and its weights, at 3.35
TB/s; the 18 FLOPs an element take far less at any of the card's rates).
On the card it also prints each set's launch record (route, grid, threads,
shared memory, registers and spills, tiles) and ptxas's usage of the
depthwise kernels from the build log; with ``--profile DIR`` each set's
device time and launches per call under ``torch.profiler`` (a layer should
be one kernel and nothing else); ``--sass`` the opcode counts of the bf16
``"tma"`` kernel. It measures the ``nerve_tpu_torch`` that is first on the
path and prints its location first; the last line is one JSON object.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

import nerve_tpu_torch
from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.diag.conv import cudnn_chain, nbytes, seeded_lightweight
from nerve_tpu_torch.models.layers import DepthwiseSeparableConv
from nerve_tpu_torch.ops import conv_chain

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
LIMITS = {torch.float32: 1e-4, torch.bfloat16: 2.4e-2}  # relative to max|plain|
CHECK_SHAPE = (2, 37, 45)  # several tiles, partial ones on every edge
FEATURES, FEATURE_LAYERS = 64, 3


def check(dev) -> None:
    """Kernel against plain, both dtypes and activations, each route."""
    g = torch.Generator().manual_seed(5)
    for c in (32, 64, 12):
        for dt in (torch.float32, torch.bfloat16):
            for act in ("relu", "none"):
                x = torch.randn((*CHECK_SHAPE, c), generator=g).to(dev, dt)
                layer = [((torch.randn((3, 3, c), generator=g) / 3).to(dev),
                          (torch.randn((c,), generator=g) * 0.1).to(dev), act)]
                got = ops.conv_chain_apply(x, layer)
                ref = conv_chain.conv_chain_plain(x, layer)
                err, scale = _common.max_abs(got, ref), ref.float().abs().max().item()
                ok = got.shape == ref.shape and got.dtype == ref.dtype and err <= LIMITS[dt] * scale
                route = conv_chain.dwconv3_route(x.shape, dt, True) if hasattr(
                    conv_chain, "dwconv3_route") else "?"
                print(f"check dw3 {(*CHECK_SHAPE, c)} {dt} {act} ({route}): max|err| {err:.3e} "
                      f"(limit {LIMITS[dt] * scale:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"depthwise kernel disagrees with its plain version at "
                                         f"C={c} {dt} {act}")


def layer_sets(dev, h: int, w: int) -> dict:
    """name -> (inputs, layers): one seeded input per layer."""
    g = torch.Generator().manual_seed(0)
    light = [e for e in seeded_lightweight(dev, 3).chain() if e[0].ndim == 3]
    light = [(wk.detach(), b.detach(), a) for wk, b, a in light]
    feats = []
    for _ in range(FEATURE_LAYERS):
        block = DepthwiseSeparableConv(FEATURES, FEATURES, dev, g)
        feats.append(tuple(t.detach() if torch.is_tensor(t) else t for t in block.as_entries()[0]))

    def inputs(layers, c, dt):
        return [torch.rand((1, h, w, c), generator=g).to(dev, dt) for _ in layers]
    return {
        "lightweight": (inputs(light, 32, torch.bfloat16), light),
        "lightweight_float32": (inputs(light, 32, torch.float32), light),
        "features": (inputs(feats, FEATURES, torch.bfloat16), feats),
    }


def bound_ms(xs, layers) -> float:
    """Bytes: each layer's input read and output written once, its weights."""
    return sum(2 * nbytes(x) + nbytes(wk, b) for x, (wk, b, _a) in zip(xs, layers)) \
        / HBM_BYTES_PER_S * 1e3


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR",
                   help="also trace each set's calls, writing the traces into DIR")
    p.add_argument("--sass", action="store_true",
                   help="also print the bfloat16 tma kernel's opcode counts")
    p.set_defaults(reps=25)
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    print(f"package {nerve_tpu_torch.__file__}", flush=True)
    if dev.type == "cuda":
        print(f"device {torch.cuda.get_device_name(dev)}", flush=True)
    check(dev)
    h, w = (36, 64) if args.small else (1080, 1920)
    result = {}
    for name, (xs, layers) in layer_sets(dev, h, w).items():
        dt = xs[0].dtype
        libs = [cudnn_chain([e], dt) for e in layers]
        row = {"shape": list(xs[0].shape), "layers": len(layers),
               "ms": _common.median_ms(
                   lambda: [ops.conv_chain_apply(x, [e]) for x, e in zip(xs, layers)],
                   dev, args.reps),
               "plain_ms": _common.median_ms(
                   lambda: [conv_chain.conv_chain_plain(x, [e]) for x, e in zip(xs, layers)],
                   dev, min(args.reps, 5)),
               "cudnn_ms": _common.median_ms(lambda: [f(x) for x, f in zip(xs, libs)], dev,
                                             args.reps),
               "bound_ms": bound_ms(xs, layers)}
        print(f"time dw3 {name} {len(layers)} x {tuple(xs[0].shape)} {dt}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, cuDNN {row['cudnn_ms']:.4f}; "
              f"bound (bytes) {row['bound_ms']:.4f} ms (the kernel at "
              f"{row['bound_ms'] / row['ms']:.3f} of it)", flush=True)
        if dev.type == "cuda" and hasattr(conv_chain, "dwconv3_launch_record"):
            row["launch"] = conv_chain.dwconv3_launch_record(xs[0])
            print(f"launch dw3 {name}: {json.dumps(row['launch'])}", flush=True)
        if args.profile:
            if dev.type != "cuda":
                raise SystemExit("--profile traces the card: run it with --device cuda")
            row["profile"] = _common.profile_calls(
                lambda: [ops.conv_chain_apply(x, [e]) for x, e in zip(xs, layers)],
                Path(args.profile), f"dw3_{name}", ("dw3",))
        result[name] = row
    if dev.type == "cuda":
        result["ptxas"] = _common.ptxas_usage("dw3")
        for line in result["ptxas"]:
            print(f"ptxas {line}", flush=True)
    if args.sass:
        if dev.type != "cuda":
            raise SystemExit("--sass reads the built kernels: run it with --device cuda")
        counts = _common.sass_opcodes(lambda n: "dw3_tma_kernel" in n and "bfloat16" in n)
        print("sass dw3_tma_kernel<bf16>: " + ", ".join(f"{k} {n}" for k, n in
                                                       counts.most_common()), flush=True)
        result["sass"] = dict(counts)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
