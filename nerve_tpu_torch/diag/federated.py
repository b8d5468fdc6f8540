"""The federated path through the port on the card:
``python -m nerve_tpu_torch.diag.federated [--profile DIR]``, or on the CPU
``--device cpu --small``.

* ``step_launches``: the kernels one local step launches, forward and
  backward apart, for the client's train step (live BatchNorm) and for the
  simulation's step (the eval forward on the tape, statistics held).
* ``compare_routes``: both steps on the kernel route and on the plain route
  (``plain_route``: the training forwards' kernel ops replaced by their
  plain versions): the output, every gradient and every new running statistic,
  max|Δ| and max|plain|.
* ``client_steps`` / ``round_run``: local AdamW steps of a client, and one
  FedAvg round, from the same start on either route.
* ``timing``: ms per simulation round at the CLI's defaults (8 clients × 5
  local steps, 32 samples at LR 16² → 32², float32) and the launches of one
  round; ms per client ``fit`` (1 epoch, batch 8, 32 samples) at LR 16² and
  at LR 64² → 128², with the peak device memory of the 64² fit (host clock
  to a synchronise, median of 3 after 1 untimed).
* ``float32_layers``: the float32 route of the conv chain's kernels, one
  ``ops.conv_chain_apply(x, [layer])`` call per case: the float32 dense
  layer (``csrc/conv_f32.cuh``) at the lightweight head (3 → 32) and tail
  (32 → 12) and at a 64-wide flagship site (64 → 64), ``dw3`` at 32
  channels, at the client fit's shape (8 × 64 × 64) and at 1080p; beside
  each the plain version's time, cuDNN's (``F.conv2d``, channels_last,
  TF32 off) and the bound (the multiply-adds at the 67 TFLOP/s float32
  peak, or the input, weights and output once at 3.35 TB/s), median of
  ``--reps`` CUDA-event timings, the wrapper's host work included; the
  kernel's max|err| against the plain version, also relative to
  max|plain|, and its launches.
* ``profile_round`` (``--profile DIR``): the device time of one round by
  part (the hand-written kernels, the backward's recompute of the plain
  versions, the rest), busy time and idle share.

The last line is one JSON object of every number.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from nerve_tpu_torch import ops
from nerve_tpu_torch.continual.params import detached
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.diag import conv as diag_conv
from nerve_tpu_torch.diag import train as diag_train
from nerve_tpu_torch.diag.conv import HBM_BYTES_PER_S, seed_all
from nerve_tpu_torch.federated import MeshFederatedSimulation, VideoEnhancementClient
from nerve_tpu_torch.federated.privacy import PrivacyConfig
from nerve_tpu_torch.federated.simulation import client_deltas
from nerve_tpu_torch.models import LightweightSuperResolution
from nerve_tpu_torch.ops import conv_chain, correlation, dispatch, rdb
from nerve_tpu_torch.training import global_norm
from nerve_tpu_torch.train_federated import (
    LR_SIZE,
    client_dataset,
    frozen_stats_loss,
    make_model,
    stacked_client_data,
)
from nerve_tpu_torch.utils import data as data_lib
from nerve_tpu_torch.utils.metrics import mse

CLIENTS, LOCAL_STEPS, SAMPLES, BATCH, SEED = 8, 5, 32, 8, 42
FIT_LR_SIZES = (LR_SIZE, 64)
SMALL = dict(clients=2, local_steps=2, samples=8, fit_lr_sizes=(8,))
KINDS = ("train", "frozen_stats")


# The kernel ops of the training forwards and their plain versions (the
# lightweight model's training runs only the first).
PLAIN_OPS = {"conv_chain_apply": conv_chain.conv_chain_plain,
             "rdb_chain_apply": rdb.rdb_chain_plain,
             "correlation_volume": correlation.correlation_plain}


@contextlib.contextmanager
def plain_route():
    """The models' training kernel ops (``PLAIN_OPS``) through their plain
    versions."""
    saved = {k: getattr(ops, k) for k in PLAIN_OPS}
    for k, fn in PLAIN_OPS.items():
        setattr(ops, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


def fed_model(dev, seed: int = 0) -> LightweightSuperResolution:
    """The lightweight model in float32, every parameter and BatchNorm
    statistic seeded (the tail is not zero)."""
    return seed_all(LightweightSuperResolution(device=dev), seed)


def client_batch(dev, lr_size: int = LR_SIZE, batch: int = BATCH, client: int = 0):
    """(lr (B, h, w, 3), hr (B, 2h, 2w, 3)): client ``client``'s data."""
    d = client_dataset(client, batch, SEED, lr_size)
    return torch.from_numpy(d["lr"]).to(dev), torch.from_numpy(d["hr"]).to(dev)


def _launched() -> Dict[str, int]:
    return {k: v for k, v in dispatch.launches.items() if v}


def _step(model, kind: str, lr, hr):
    """One local step's forward on a copy of ``model``: (copy, output, loss)."""
    m = copy.deepcopy(model).train(kind == "train")
    out = m(lr, differentiable=True)
    return m, out, mse(out, hr)


def step_launches(model, lr, hr) -> Dict[str, Dict[str, Dict[str, int]]]:
    """{kind: {"forward": launches, "backward": launches}}."""
    out = {}
    for kind in KINDS:
        dispatch.reset_launches()
        _m, _out, loss = _step(model, kind, lr, hr)
        fwd = _launched()
        dispatch.reset_launches()
        loss.backward()
        out[kind] = {"forward": fwd, "backward": _launched()}
    return out


def _step_tensors(model, kind: str, lr, hr) -> Dict[str, torch.Tensor]:
    m, out, loss = _step(model, kind, lr, hr)
    loss.backward()
    tensors = {"loss": loss.detach(), "output": out.detach()}
    tensors.update({f"grad {k}": p.grad for k, p in m.named_parameters()})
    tensors.update({f"stat {k}": b for k, b in m.named_buffers()})
    return tensors


def compare_routes(model, lr, hr) -> Dict[str, Dict[str, dict]]:
    """{kind: {tensor: {"max_abs", "mean_abs", "scale", "sq_diff",
    "sq_plain"}}}, kernel vs plain: max and mean |Δ|, max|plain|, Σ Δ² and
    Σ plain²."""
    out = {}
    for kind in KINDS:
        kern = _step_tensors(model, kind, lr, hr)
        with plain_route():
            plain = _step_tensors(model, kind, lr, hr)
        out[kind] = {}
        for k, b in plain.items():
            d = (kern[k].float() - b.float()).abs()
            out[kind][k] = {"max_abs": d.max().item(), "mean_abs": d.mean().item(),
                            "scale": b.float().abs().max().item(),
                            "sq_diff": (d.double() ** 2).sum().item(),
                            "sq_plain": (b.double() ** 2).sum().item()}
    return out


def grads_rel_l2(tensors: Dict[str, dict]) -> float:
    """‖Δ‖ / ‖plain‖ over every gradient of a ``compare_routes`` kind."""
    grads = [v for k, v in tensors.items() if k.startswith("grad ")]
    return (sum(v["sq_diff"] for v in grads) / max(sum(v["sq_plain"] for v in grads),
                                                   1e-300)) ** 0.5


def client_steps(model, data, steps: int, plain: bool = False):
    """(parameters after, losses): ``steps`` AdamW steps of a
    ``VideoEnhancementClient`` on ``data``'s shuffled batches of 8."""
    client = VideoEnhancementClient(model, data, num_frames=1, batch_size=BATCH, seed=0)
    rng = np.random.default_rng(0)
    batches: List[dict] = []
    while len(batches) < steps:
        batches += list(data_lib.batches(data, client.batch_size, rng=rng))
    losses = []
    with plain_route() if plain else contextlib.nullcontext():
        for b in batches[:steps]:
            losses.append(client.train_step(*client.device_batch(b)).item())
    return detached(client.params), losses


def _simulation(model, client_data, local_steps: int,
                privacy: Optional[PrivacyConfig] = None) -> MeshFederatedSimulation:
    """The CLI's simulation (local rate 1e-3) from ``model``'s parameters,
    its statistics held (``model`` in eval mode)."""
    return MeshFederatedSimulation(frozen_stats_loss(model),
                                   detached(dict(model.named_parameters())), client_data,
                                   local_steps=local_steps, local_lr=1e-3, privacy=privacy,
                                   seed=SEED)


def round_run(model, client_data, local_steps: int = LOCAL_STEPS, plain: bool = False,
              privacy: Optional[PrivacyConfig] = None):
    """(parameters after, metrics, launches) of one FedAvg round from the
    model's parameters, its BatchNorm statistics held."""
    sim = _simulation(copy.deepcopy(model).eval(), client_data, local_steps, privacy)
    dispatch.reset_launches()
    with plain_route() if plain else contextlib.nullcontext():
        metrics = sim.run_round()
    return sim.params, metrics, _launched()


def delta_norms(model, client_data, local_steps: int, privacy: Optional[PrivacyConfig]):
    """Each client's delta norm (clipped under ``privacy``)."""
    model = copy.deepcopy(model).eval()
    deltas = client_deltas(frozen_stats_loss(model), detached(dict(model.named_parameters())),
                           client_data, local_steps, 1e-3, privacy)
    return [global_norm(list(d.values())).item() for d in deltas]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_ms(fn, dev, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def timing(dev, clients: int = CLIENTS, local_steps: int = LOCAL_STEPS, samples: int = SAMPLES,
           fit_lr_sizes=FIT_LR_SIZES) -> dict:
    """ms per round and per fit, launches per round, peak memory (see the
    module doc)."""
    model = make_model(SEED, dev).eval()
    data = stacked_client_data(clients, samples, SEED, dev)
    sim = _simulation(model, data, local_steps)
    out = {"round_ms": _median_ms(sim.run_round, dev)}
    dispatch.reset_launches()
    sim.run_round()
    out["round_launches"] = _launched()
    for lr_size in fit_lr_sizes:
        client = VideoEnhancementClient(make_model(SEED, dev), client_dataset(0, samples, SEED,
                                                                              lr_size),
                                        num_frames=1, batch_size=BATCH, seed=0)
        start = client.get_parameters()
        out[f"fit_ms_{lr_size}"] = _median_ms(lambda: client.fit(start, {"local_epochs": 1}),
                                              dev)
        if dev.type == "cuda":
            _sync(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            client.fit(start, {"local_epochs": 1})
            out[f"fit_peak_bytes_{lr_size}"] = torch.cuda.max_memory_allocated(dev)
    return out


FP32_PEAK_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
FP32_CASES = {  # name -> (input shape, kernel shape)
    "head 3->32 fit": ((8, 64, 64, 3), (3, 3, 3, 32)),
    "tail 32->12 fit": ((8, 64, 64, 32), (3, 3, 32, 12)),
    "dw3 32 fit": ((8, 64, 64, 32), (3, 3, 32)),
    "head 3->32 1080p": ((1, 1080, 1920, 3), (3, 3, 3, 32)),
    "tail 32->12 1080p": ((1, 1080, 1920, 32), (3, 3, 32, 12)),
    "dw3 32 1080p": ((1, 1080, 1920, 32), (3, 3, 32)),
    "flagship 64->64 1080p": ((1, 1080, 1920, 64), (3, 3, 64, 64)),
}


def float32_layers(dev, reps: int = 25, small: bool = False) -> Dict[str, dict]:
    """{case: kernel / plain / cuDNN / bound ms, what bounds it, max|err|}
    (see the module doc); ``small`` divides every spatial size by 8."""
    g = torch.Generator().manual_seed(11)
    gd = torch.Generator(device=dev).manual_seed(11)  # the frames, made on the device
    out = {}
    for name, (xs, ws) in FP32_CASES.items():
        if small:
            xs = (xs[0], max(2, xs[1] // 8), max(2, xs[2] // 8), xs[3])
        x = torch.rand(xs, generator=gd, device=dev)
        w = (torch.randn(ws, generator=g) * math.prod(ws[:-1]) ** -0.5).to(dev)
        layer = [(w, (0.1 * torch.randn(ws[-1], generator=g)).to(dev), "relu")]
        kern = _common.median_ms(lambda: ops.conv_chain_apply(x, layer), dev, reps)
        plain = _common.median_ms(lambda: conv_chain.conv_chain_plain(x, layer), dev, reps)
        cudnn = diag_conv.cudnn_chain(layer, torch.float32)
        lib = _common.median_ms(lambda: cudnn(x), dev, reps)
        npix = math.prod(xs[:3])
        flops = 2 * math.prod(ws) * npix  # a depthwise (3, 3, C) kernel: 18·C a pixel
        cout = ws[-1]
        nbytes = 4 * (x.numel() + w.numel() + cout + npix * cout)
        t_ops, t_bytes = flops / FP32_PEAK_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        dispatch.reset_launches()
        y = ops.conv_chain_apply(x, layer)
        launched = {k: v for k, v in dispatch.launches.items() if v}
        ref = conv_chain.conv_chain_plain(x, layer)
        err = _common.max_abs(y, ref)
        out[name] = {"kernel_ms": kern, "plain_ms": plain, "cudnn_ms": lib,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops > t_bytes else "bytes",
                     "flops": flops, "bytes": nbytes, "max_abs_err": err,
                     "rel_err": err / max(ref.abs().max().item(), 1e-30), "launches": launched}
        del y, ref
        print(f"float32 {name} {tuple(xs)}: kernel {kern:.4f} ms, plain {plain:.4f}, cuDNN "
              f"{lib:.4f}, bound {max(t_ops, t_bytes):.4f} ({out[name]['bound_by']}); max|err| "
              f"{err:.3e}", flush=True)
    return out


def profile_round(dev, out_dir: Path, clients: int = CLIENTS,
                  local_steps: int = LOCAL_STEPS) -> dict:
    """Device ms of one round at the CLI's defaults under ``torch.profiler``
    (after one untimed round), by part: the hand-written kernels, the
    backward's recompute of the plain versions (range ``nt.recompute``) and
    the rest; busy time, idle share, kernels and host operations a round."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    out_dir.mkdir(parents=True, exist_ok=True)
    model = make_model(SEED, dev).eval()
    data = stacked_client_data(clients, SAMPLES, SEED, dev)
    sim = _simulation(model, data, local_steps)
    sim.run_round()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    trace = out_dir / "trace_fedavg_round.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    recompute: Dict[int, list] = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == dispatch.RECOMPUTE_RANGE:
            recompute.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
    split: Dict[str, float] = {}
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        if any(w in k["name"] for w in diag_train.KERNEL_WORDS):
            part = "hand-written kernels"
        elif launch is not None and any(a <= launch["ts"] <= b
                                        for a, b in recompute.get(launch["tid"], ())):
            part = "recompute"
        else:
            part = "other"
        split[part] = split.get(part, 0.0) + k["dur"] / 1e3
    busy = diag_train.busy_us(kernels) / 1e3
    result = {"ms_per_round": split, "busy_ms_per_round": busy, "wall_ms_per_round": wall,
              "idle_share": 1 - busy / wall, "kernels_per_round": len(kernels),
              "host_ops_per_round": sum(e.get("cat") == "cpu_op" for e in events)}
    print("profile FedAvg round (device ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f"; busy {busy:.3f} of wall {wall:.3f}, idle share {result['idle_share']:.3f}; "
        f"{len(kernels)} kernels and {result['host_ops_per_round']} profiled host ops",
        flush=True)
    return result


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR", help="also profile one round into DIR")
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    size = SMALL if args.small else dict(clients=CLIENTS, local_steps=LOCAL_STEPS,
                                         samples=SAMPLES, fit_lr_sizes=FIT_LR_SIZES)
    model = fed_model(dev)
    lr, hr = client_batch(dev, FIT_LR_SIZES[0] if not args.small else 8)
    fp32 = float32_layers(dev, max(args.reps, 25 if dev.type == "cuda" else 1), args.small)
    routes = compare_routes(model, lr, hr)
    worst = {kind: max(v["max_abs"] / max(v["scale"], 1e-30) for v in r.values())
             for kind, r in routes.items()}
    result = {"step_launches": step_launches(model, lr, hr),
              "kernel_vs_plain_worst_rel": worst, "float32_layers": fp32,
              "timing": timing(dev, **size)}
    print(f"timing: {json.dumps(result['timing'])}", flush=True)
    if args.profile:
        if dev.type != "cuda":
            raise SystemExit("--profile traces the card: run it with --device cuda")
        result["profile"] = profile_round(dev, Path(args.profile), size["clients"],
                                          size["local_steps"])
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
