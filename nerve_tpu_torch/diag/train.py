"""Training through the port on the card:
``python -m nerve_tpu_torch.diag.train [--profile DIR] [--device cpu --small]``.

* ``grad_cases``: each kernel op the flagship's training forward runs, at
  the training shapes (batch 16, LR 64 × 64, 64 features; ``--small``: a
  ragged 2 × 13 × 17 at 16 channels) — the attention chain on its list of
  three frames, the 8-block RDB stack, the correlation (d = 4) on the 32
  neighbour pairs, and the warp — as the model calls it (the op: an
  autograd Function, the kernels forward, the vjp of the plain version
  backward; the warp's own backward) and as plain autograd through the plain
  version, on the same inputs, weights and upstream gradient
  (``compare_grads``: max and mean |Δ| of the output and of each gradient,
  and max|plain|).
* ``train_step_timing``: the flagship train step (64 features, 8 RDBs,
  window 1, bfloat16 compute, float32 master weights, AdamW), seeded
  weights, batch 16, 64² → 128²: its launches per step, ms per step (host
  clock to a synchronise, median of 20 after 3 untimed), samples per second
  and peak device memory.
* ``profile_split`` (``--profile DIR``): the device time of two steps under
  ``torch.profiler``, each kernel put in the part of the step that launched
  it — the forward's hand-written kernels, the forward's ATen/cuDNN work,
  the backward's recompute of the plain versions (profiler range
  ``nt.recompute``), the rest of the backward, the optimiser — with the
  device's busy time and idle share, and the kernels and host operations
  (the profiler's ``cpu_op`` events) a step.

The last line is one JSON object of every number.
"""

from __future__ import annotations

import json
import math
import statistics
import time
from pathlib import Path

import torch

from nerve_tpu_torch import ops, training
from nerve_tpu_torch.config.schema import TrainingConfig
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.diag.conv import seed_all
from nerve_tpu_torch.models import SuperResolutionNet
from nerve_tpu_torch.ops import conv_chain, correlation, dispatch, rdb, warp
from nerve_tpu_torch.utils import data as data_lib

BATCH, LR_SIZE, FEATURES, BLOCKS = 16, 64, 64, 8
SMALL = (2, 13, 17, 16)  # B, H, W, C of the small cases
# Hand-written kernels by the words of their names (csrc/*.cu).
KERNEL_WORDS = ("conv_wgmma", "lff_wgmma", "conv_f32", "lff_f32", "corr_kernel", "dw3_",
                "d2s_packed", "planar_", "i8_wgmma", "quantize_i8", "taps_", "rdb_lff", "probe")
PARTS = ("train.forward", "train.backward", "train.optimizer", dispatch.RECOMPUTE_RANGE)


def _randn(g, shape, std=1.0):
    return torch.randn(shape, generator=g) * std


def _leaves(dev, dt, *tensors):
    return [t.to(dev, dt).requires_grad_(True) for t in tensors]


def grad_cases(dev, dt, small: bool = False, seed: int = 0, dims=None) -> dict:
    """name → (kernel route, plain route, leaf inputs, upstream gradient):
    each route maps the leaves to the op's output. ``dims`` (B, H, W, C,
    RDB blocks, growth) overrides the shapes that ``small`` picks."""
    g = torch.Generator().manual_seed(seed)
    b, h, w, c = SMALL if small else (BATCH, LR_SIZE, LR_SIZE, FEATURES)
    blocks, growth = (4, 8) if small else (BLOCKS, 32)
    if dims is not None:
        b, h, w, c, blocks, growth = dims
    cases = {}
    # The attention chain: three frames as a list, 3c → c → c → 3.
    frames = _leaves(dev, dt, *(_randn(g, (b, h, w, c)) for _ in range(3)))
    widths = [(3 * c, c, "relu"), (c, c, "relu"), (c, 3, "none")]
    wb = _leaves(dev, torch.float32, *(t for cin, cout, _a in widths for t in (
        _randn(g, (3, 3, cin, cout), (9 * cin) ** -0.5), _randn(g, (cout,), 0.05))))
    acts = [a for *_io, a in widths]

    def entries(t):
        return [(t[3 + 2 * i], t[4 + 2 * i], a) for i, a in enumerate(acts)]

    cases["conv_chain"] = (lambda *t: ops.conv_chain_apply(list(t[:3]), entries(t)),
                           lambda *t: conv_chain.conv_chain_plain(list(t[:3]), entries(t)),
                           frames + wb, _randn(g, (b, h, w, 3)).to(dev, dt))
    # The RDB stack: 8 blocks of 5 dense layers, growth 32 (small: 4, growth 8).
    plist = [_common.rdb_params(g, c, "cpu", growth=growth, bias_std=0.05)
             for _ in range(blocks)]
    sizes = [len(p) for p in plist]
    leaves = _leaves(dev, dt, _randn(g, (b, h, w, c)), *(p for params in plist for p in params))
    cases["rdb"] = (lambda x, *p: ops.rdb_chain_apply(x, rdb._blocks(p, sizes)),
                    lambda x, *p: rdb.rdb_chain_plain(x, rdb._blocks(p, sizes)),
                    leaves, _randn(g, (b, h, w, c)).to(dev, dt))
    # The correlation on the neighbour pairs: B·(T - 1) items, d = 4.
    pair = _leaves(dev, dt, _randn(g, (2 * b, h, w, c)), _randn(g, (2 * b, h, w, c)))
    cases["correlation"] = (lambda a, f: ops.correlation_volume(a, f, 4),
                            lambda a, f: correlation.correlation_plain(a, f, 4),
                            pair, _randn(g, (2 * b, h, w, 81)).to(dev, dt))
    # The warp of the neighbours' features along a flow of a few pixels.
    feats = _leaves(dev, dt, _randn(g, (2 * b, h, w, c)), _randn(g, (2 * b, h, w, 2), 2.0))
    cases["warp"] = (ops.flow_warp, warp._warp, feats, _randn(g, (2 * b, h, w, c)).to(dev, dt))
    return cases


def _grads(fn, leaves, g):
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    return out.detach(), [torch.zeros_like(t) if d is None else d for t, d in zip(leaves, grads)]


def compare_grads(kernel, plain, leaves, g) -> dict:
    """Both routes' output and gradients: per output and per input, max and
    mean |Δ| and max|plain|."""
    out_k, grads_k = _grads(kernel, leaves, g)
    out_p, grads_p = _grads(plain, leaves, g)

    def stats(a, b):
        d = (a.float() - b.float()).abs()
        return {"max_abs": d.max().item(), "mean_abs": d.mean().item(),
                "scale": b.float().abs().max().item()}

    return {"forward": stats(out_k, out_p),
            "grads": [stats(a, b) for a, b in zip(grads_k, grads_p)]}


def train_model(dev, seed: int, features: int = FEATURES,
                blocks: int = BLOCKS) -> SuperResolutionNet:
    """The flagship in bfloat16 (float32 master weights) in training mode,
    every parameter and BatchNorm statistic seeded (``diag.conv.seed_all``:
    the flow is not zero)."""
    model = SuperResolutionNet(scale_factor=2, num_features=features,
                               num_residual_blocks=blocks, temporal_window=1,
                               flow_downsample=1, dtype=torch.bfloat16, device=dev)
    return seed_all(model, seed).train()


def train_batches(dev, n: int, lr_size: int = LR_SIZE, batch: int = BATCH, seed: int = 0):
    """``n`` batches of ``make_video_sr_dataset`` (panning windows, T = 3) on
    the device: [(lr_win (B, 3, h, w, 3), hr (B, 2h, 2w, 3))]."""
    d = data_lib.make_video_sr_dataset(torch.Generator().manual_seed(seed), n * batch, lr_size)
    return [(torch.from_numpy(d["lr_win"][i * batch:(i + 1) * batch]).to(dev),
             torch.from_numpy(d["hr"][i * batch:(i + 1) * batch]).to(dev)) for i in range(n)]


def step_fn(model, cfg: TrainingConfig = TrainingConfig(epochs=1, warmup_epochs=0),
            steps: int = 100):
    """(state, step) over ``model`` with ``cfg``'s optimiser, ``steps``
    updates an epoch (with the default, the cosine over ``steps``)."""
    state = training.create_sr_state(model, cfg, steps)
    return state, training.make_sr_train_step(model, cfg.losses.pixel_loss_type)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_step_timing(model, batch, untimed: int = 3, timed: int = 20) -> dict:
    """Launches of one step, ms per step (host clock to a synchronise,
    median of ``timed`` after ``untimed``), samples/s and peak memory."""
    dev = batch[0].device
    state, step = step_fn(model)
    for _ in range(untimed):
        step(state, *batch)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dispatch.reset_launches()
    step(state, *batch)
    launches = {k: v for k, v in dispatch.launches.items() if v}
    times = []
    for _ in range(timed):
        _sync(dev)
        t0 = time.perf_counter()
        step(state, *batch)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return {"launches_per_step": launches, "ms_per_step": ms, "ms_min": min(times),
            "ms_max": max(times), "samples_per_s": batch[0].shape[0] / ms * 1e3,
            "peak_bytes": peak}


def _part(kernel, launch, ranges, main_tid) -> str:
    """The part of the step a kernel belongs to, from the innermost profiler
    range around its launch."""
    if launch is None:
        return "other"
    inner = None
    for ts, end, name in ranges.get(launch["tid"], ()):
        if ts <= launch["ts"] <= end and (inner is None or ts >= inner[0]):
            inner = (ts, end, name)
    name = inner[2] if inner else None
    if name == dispatch.RECOMPUTE_RANGE:
        return "backward recompute"
    if name == "train.forward":
        mine = any(w in kernel["name"] for w in KERNEL_WORDS)
        return "forward kernels" if mine else "forward ATen"
    if name == "train.optimizer":
        return "optimiser"
    if name == "train.backward" or launch["tid"] != main_tid:
        return "backward gradients"
    return "other"


def busy_us(kernels) -> float:
    """µs in which at least one of the trace's kernel events runs."""
    busy, end = 0.0, -math.inf
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_split(model, batch, out_dir: Path, steps: int = 2) -> dict:
    """Device ms per step of each part of the train step (``_part``), busy
    time and idle share, over ``steps`` profiled steps after 3 untimed."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    out_dir.mkdir(parents=True, exist_ok=True)
    state, step = step_fn(model)
    for _ in range(3):
        step(state, *batch)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, *batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    trace = out_dir / "trace_train_step.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ranges, main_tid = {}, None
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in PARTS:
            ranges.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
            if e["name"] == "train.forward":
                main_tid = e["tid"]
    split = {}
    for k in kernels:
        part = _part(k, launches.get(k.get("args", {}).get("correlation")), ranges, main_tid)
        split[part] = split.get(part, 0.0) + k["dur"] / 1e3 / steps
    busy_ms = busy_us(kernels) / 1e3 / steps
    result = {"ms_per_step": split, "busy_ms_per_step": busy_ms,
              "wall_ms_per_step": wall / steps, "idle_share": 1 - busy_ms / (wall / steps),
              "kernels_per_step": len(kernels) / steps,
              "aten_ops_per_step": sum(e.get("cat") == "cpu_op" for e in events) / steps}
    print("profile train step (device ms/step): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f"; busy {busy_ms:.3f} of wall {wall / steps:.3f}, idle share "
        f"{result['idle_share']:.3f}; {result['kernels_per_step']:g} kernels and "
        f"{result['aten_ops_per_step']:g} profiled host ops a step", flush=True)
    return result


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR", help="also profile two train steps into DIR")
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    result = {"grads": {}}
    for dt in (torch.float32, torch.bfloat16):
        for name, case in grad_cases(dev, dt, args.small).items():
            r = compare_grads(*case)
            worst = max(s["max_abs"] / max(s["scale"], 1e-30) for s in r["grads"])
            result["grads"][f"{name} {str(dt)[6:]}"] = {"forward": r["forward"],
                                                        "grad_rel_max": worst}
            print(f"grad {name} {str(dt)[6:]}: forward max|d| {r['forward']['max_abs']:.3e}, "
                  f"gradients max|d|/max|plain| {worst:.3e}", flush=True)
    features, blocks, lr_size = (16, 2, 16) if args.small else (FEATURES, BLOCKS, LR_SIZE)
    batch = train_batches(dev, 1, lr_size, batch=2 if args.small else BATCH)[0]
    result["step"] = train_step_timing(train_model(dev, 0, features, blocks), batch,
                                       timed=3 if args.small else 20)
    print(f"train step: {json.dumps(result['step'])}", flush=True)
    if args.profile:
        if dev.type != "cuda":
            raise SystemExit("--profile traces the card: run it with --device cuda")
        result["profile"] = profile_split(train_model(dev, 0), batch, Path(args.profile))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
