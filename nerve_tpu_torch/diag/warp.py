"""The flow warp at the serving shape:
``python -m nerve_tpu_torch.diag.warp [--device cpu] [--small]``.

``ops.flow_warp`` is plain PyTorch on both devices (the JAX package warps
with an XLA gather, not a Pallas kernel). This times it where the
flagship's streaming step runs it: the two neighbours' features, (2, 1080,
1920, 64) in bfloat16, along a seeded bfloat16 flow of σ 3 px; the median of
``--reps`` calls (CUDA events on the card), beside the least time the card
could take (the features and the flow read once, the output written once,
at 3.35 TB/s). It measures the ``nerve_tpu_torch`` that is first on the
path and prints its location first, so the same file times another
checkout's warp: ``PYTHONPATH=OTHER python nerve_tpu_torch/diag/warp.py``.
"""

from __future__ import annotations

import json

import torch

import nerve_tpu_torch
from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def main(argv=None) -> dict:
    args = _common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = _common.device_of(args)
    print(f"package {nerve_tpu_torch.__file__}", flush=True)
    shape = (2, 18, 40, 8) if args.small else (2, 1080, 1920, 64)
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    flow = (torch.randn((*shape[:3], 2), generator=g) * 3.0).to(dev, torch.bfloat16)
    out = ops.flow_warp(feats, flow)
    if out.shape != feats.shape or out.dtype != feats.dtype or not bool(torch.isfinite(out).all()):
        raise AssertionError("flow_warp returned a wrong or non-finite output")
    ms = _common.median_ms(lambda: ops.flow_warp(feats, flow), dev, args.reps)
    moved = 2 * feats.numel() * feats.element_size() + flow.numel() * flow.element_size()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"time flow_warp {tuple(shape)} bf16: {ms:.3f} ms, bound {bound_ms:.3f} ms (bytes)",
          flush=True)
    result = {"shape": list(shape), "ms": ms, "bound_ms": bound_ms}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
