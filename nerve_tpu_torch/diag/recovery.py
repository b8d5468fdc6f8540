"""The recovery net's training and BatchNorm gradients against float64:
``python -m nerve_tpu_torch.diag.recovery``, or on the CPU ``--device cpu
--small``.

* ``step_against_cpu``: one recovery train step (``training.recovery``,
  float32, TF32 off) on the device and on the CPU from the same weights and
  batch: the loss, every gradient (relative L2 norm) and every new running
  statistic (max|Δ| of max|CPU|); beside each gradient's difference, both
  sides' distance from the same step in float64 on the device.
* ``step_timing``: ms per step (host clock to a synchronise, median of 10
  after 3), CUDA-event ms per step over 10 chained steps
  (``utils.profiling.timed_chain``, idle gaps included), peak
  memory, the hand-written kernels' launches per step (the net is plain
  ATen/cuDNN: none) and the losses of ``steps`` steps over fresh batches.
* ``profile_step`` (``--profile DIR``): the device time of a step by part
  (the ranges ``recovery.forward``, ``recovery.backward``,
  ``recovery.optimizer``; a backward kernel runs on autograd's thread), the
  kernels that take most of it, busy time, idle share, kernels and host
  operations a step.
* ``bn_grads_vs_float64``: each BatchNorm scale and bias gradient of the
  flagship's bfloat16 train step (64/8, batch 16, 64²) and of the
  lightweight model's float32 train step (batch 8, LR 64²) computed three
  ways on the device: the plain route in float64 (the truth), the plain
  route in the step's dtype, the kernel route; the worst relative L2 norm
  and max|Δ| of max|truth| of each route against the truth.

The default sizes are the chip's (recovery base 64, window 2, T = 5,
batch 8, 64²); ``--small`` is base 8, batch 2, 32² and narrow models. The
last line is one JSON object of every number.
"""

from __future__ import annotations

import copy
import json
import statistics
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.diag import federated as diag_fed
from nerve_tpu_torch.diag.federated import plain_route
from nerve_tpu_torch.diag import train as diag_train
from nerve_tpu_torch.diag.conv import seed_all
from nerve_tpu_torch.models.frame_recovery import FrameRecoveryNet
from nerve_tpu_torch.ops import dispatch
from nerve_tpu_torch.recovery_protocol import corrupted_refs, make_dataset, make_masks
from nerve_tpu_torch.training import pixel_loss
from nerve_tpu_torch.training.recovery import (
    create_recovery_state,
    make_recovery_train_step,
    recovery_loss,
)
from nerve_tpu_torch.utils import profiling
from nerve_tpu_torch.utils.metrics import mse

BASE, WINDOW, FRAMES, BATCH, SIZE = 64, 2, 5, 8, 64
SMALL = dict(base=8, batch=2, size=32)
def float64_copy(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` in float64: its tensors and every ``dtype`` it computes in."""
    module = copy.deepcopy(module).double()
    for sub in module.modules():
        if isinstance(getattr(sub, "dtype", None), torch.dtype):
            sub.dtype = torch.float64
    return module


def recovery_model(dev, base: int = BASE, seed: int = 0) -> FrameRecoveryNet:
    """The recovery net (window 2) in float32, every parameter and BatchNorm
    statistic seeded, in training mode."""
    return seed_all(FrameRecoveryNet(base_channels=base, temporal_window=WINDOW, device=dev),
                    seed).train()


def recovery_batches(dev, n: int, batch: int = BATCH, size: int = SIZE, seed: int = 0):
    """``n`` (corrupted, refs, mask, clean) batches as the protocol makes them:
    panning video, centre masks of 10-40 %, the corrupted centre in the refs."""
    data = make_dataset(seed, n * batch, size, FRAMES)
    rng = np.random.default_rng(seed + 7)
    out = []
    for i in range(n):
        cl = data["clean"][i * batch:(i + 1) * batch]
        m = make_masks(rng, batch, size, size, rng.uniform(0.1, 0.4, batch))
        cor = cl * (1.0 - m)
        refs = corrupted_refs(data["frames"][i * batch:(i + 1) * batch], cor)
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in (cor, refs, m, cl)))
    return out


def _grads(model, batch):
    """(loss, {name: gradient}, {statistic: value}) of one training forward
    and backward of ``model`` (moved in place)."""
    loss = recovery_loss(model, *batch)
    model.zero_grad(set_to_none=True)
    loss.backward()
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
    stats = {k: b.detach().double().cpu() for k, b in model.named_buffers()}
    return loss.item(), grads, stats


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    nb = b.norm().item()
    return (a - b).norm().item() / nb if nb else (a - b).abs().max().item()


def step_against_cpu(dev, base: int = BASE, batch: int = BATCH, size: int = SIZE) -> dict:
    """One train step's loss, gradients and statistics on ``dev`` against the
    CPU's (see the module doc)."""
    model = recovery_model(torch.device("cpu"), base)
    b = recovery_batches(torch.device("cpu"), 1, batch, size)[0]
    cpu = _grads(copy.deepcopy(model), b)
    card = _grads(copy.deepcopy(model).to(dev), tuple(t.to(dev) for t in b))
    truth = _grads(float64_copy(model).to(dev), tuple(t.to(dev).double() for t in b))
    grads = {k: {"rel_l2": _rel_l2(card[1][k], g), "card_vs_f64": _rel_l2(card[1][k], truth[1][k]),
                 "cpu_vs_f64": _rel_l2(g, truth[1][k])} for k, g in cpu[1].items()}
    stats = {k: (card[2][k] - s).abs().max().item() / max(s.abs().max().item(), 1e-30)
             for k, s in cpu[2].items()}
    worst = max(grads, key=lambda k: grads[k]["rel_l2"])
    return {"loss_card": card[0], "loss_cpu": cpu[0],
            "loss_rel": abs(card[0] - cpu[0]) / abs(cpu[0]),
            "grads": grads, "worst_grad": worst, "stats_rel": max(stats.values()),
            "worst_stat": max(stats, key=stats.get)}


def step_timing(dev, base: int = BASE, batch: int = BATCH, size: int = SIZE,
                steps: int = 20) -> dict:
    """Losses of ``steps`` AdamW steps over fresh batches, then the step's
    ms, device ms, peak memory and launches (see the module doc)."""
    model = recovery_model(dev, base, seed=1)
    batches = recovery_batches(dev, steps, batch, size, seed=1)
    state = create_recovery_state(model, 1e-3, steps)
    step = make_recovery_train_step(model)
    losses, launches = [], []
    for b in batches:
        dispatch.reset_launches()
        losses.append(step(state, *b)[1]["loss"].item())
        launches.append(sum(dispatch.launches.values()))
    times = []
    for i in range(13):
        diag_train._sync(dev)
        t0 = time.perf_counter()
        step(state, *batches[i % steps])
        diag_train._sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"losses": losses, "launches_per_step": max(launches),
           "ms_per_step": statistics.median(times[3:]), "ms_min": min(times[3:]),
           "ms_max": max(times[3:])}
    if dev.type == "cuda":
        cor, refs, mask, clean = batches[0]
        dev_ms = profiling.timed_chain(
            lambda c: step(state, c, refs, mask, clean)[1]["loss"], cor, iters=10)
        torch.cuda.reset_peak_memory_stats(dev)
        step(state, *batches[0])
        torch.cuda.synchronize(dev)
        out.update(event_ms_per_step=dev_ms["ms_per_call"],
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
    return out


PARTS = ("recovery.forward", "recovery.backward", "recovery.optimizer")


def profile_step(dev, out_dir: Path, steps: int = 2, base: int = BASE, batch: int = BATCH,
                 size: int = SIZE) -> dict:
    """Device ms per step by part and by kernel (see the module doc), over
    ``steps`` profiled steps after 3 untimed."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    out_dir.mkdir(parents=True, exist_ok=True)
    model = recovery_model(dev, base, seed=1)
    b = recovery_batches(dev, 1, batch, size, seed=1)[0]
    state = create_recovery_state(model, 1e-3, 100)
    step = make_recovery_train_step(model)
    for _ in range(3):
        step(state, *b)
    torch.cuda.synchronize(dev)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, *b)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3 / steps
    trace = out_dir / "trace_recovery_step.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ranges = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in PARTS]
    main_tids = {tid for tid, *_ in ranges}
    parts: Dict[str, float] = {}
    names: Dict[str, float] = {}
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        part = "other"
        if launch is not None:
            part = next((n for tid, a, z, n in ranges
                         if tid == launch["tid"] and a <= launch["ts"] <= z), None) or (
                "recovery.backward" if launch["tid"] not in main_tids else "other")
        parts[part] = parts.get(part, 0.0) + k["dur"] / 1e3 / steps
        names[k["name"][:60]] = names.get(k["name"][:60], 0.0) + k["dur"] / 1e3 / steps
    busy = diag_train.busy_us(kernels) / 1e3 / steps
    top = dict(sorted(names.items(), key=lambda kv: -kv[1])[:8])
    result = {"ms_per_step": parts, "top_kernels_ms": top, "busy_ms_per_step": busy,
              "wall_ms_per_step": wall, "idle_share": 1 - busy / wall,
              "kernels_per_step": len(kernels) / steps,
              "host_ops_per_step": sum(e.get("cat") == "cpu_op" for e in events) / steps}
    print("profile recovery step (device ms/step): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(parts.items(), key=lambda kv: -kv[1]))
        + f"; busy {busy:.3f} of wall {wall:.3f}, idle share {result['idle_share']:.3f}; "
        f"{result['kernels_per_step']:g} kernels and {result['host_ops_per_step']:g} profiled "
        "host ops a step; top kernels " + ", ".join(f"{k} {v:.3f}" for k, v in top.items()),
        flush=True)
    return result


# --------------------------------------------------------------------------- #
# BatchNorm gradients against float64
# --------------------------------------------------------------------------- #
def _bn_grads(model, loss_fn, batch) -> Dict[str, torch.Tensor]:
    loss = loss_fn(model, *batch)
    model.zero_grad(set_to_none=True)
    loss.backward()
    return {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()
            if "BatchNorm" in k}


def _three_ways(model, loss_fn, batch) -> dict:
    kernel = _bn_grads(copy.deepcopy(model), loss_fn, batch)
    with plain_route():
        plain = _bn_grads(copy.deepcopy(model), loss_fn, batch)
        truth = _bn_grads(float64_copy(model), loss_fn, tuple(t.double() for t in batch))

    def errors(got):
        rel = {k: _rel_l2(got[k], t) for k, t in truth.items()}
        mx = {k: (got[k] - t).abs().max().item() / t.abs().max().item()
              for k, t in truth.items()}
        return {"rel_l2": max(rel.values()), "rel_l2_at": max(rel, key=rel.get),
                "max_abs_rel": max(mx.values()), "max_abs_rel_at": max(mx, key=mx.get)}

    k, p = errors(kernel), errors(plain)
    return {"tensors": len(truth), "kernel": k, "plain": p,
            "within_2x": (k["rel_l2"] <= 2 * p["rel_l2"]
                          and k["max_abs_rel"] <= 2 * p["max_abs_rel"])}


def bn_grads_vs_float64(dev, small: bool = False) -> dict:
    """{"flagship bf16", "lightweight float32"}: see the module doc."""
    def sr_loss(model, lr, hr):
        return pixel_loss(model.train()(lr), hr)

    def light_loss(model, lr, hr):
        return mse(model.train()(lr), hr)

    dims = dict(features=16, blocks=2) if small else {}
    flagship = diag_train.train_model(dev, 0, **dims)
    fb = diag_train.train_batches(dev, 1, **(dict(lr_size=16, batch=2) if small else {}))[0]
    light = diag_fed.fed_model(dev)
    lb = diag_fed.client_batch(dev, 16 if small else 64)
    return {"flagship bf16": _three_ways(flagship, sr_loss, fb),
            "lightweight float32": _three_ways(light, light_loss, lb)}


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR", help="also profile two train steps into DIR")
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    size = SMALL if args.small else dict(base=BASE, batch=BATCH, size=SIZE)
    result = {"step_against_cpu": step_against_cpu(dev, **size),
              "step_timing": step_timing(dev, **size, steps=4 if args.small else 20),
              "bn_grads_vs_float64": bn_grads_vs_float64(dev, args.small)}
    result["step_against_cpu"].pop("grads")
    if args.profile:
        if dev.type != "cuda":
            raise SystemExit("--profile traces the card: run it with --device cuda")
        result["profile"] = profile_step(dev, Path(args.profile), **size)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
