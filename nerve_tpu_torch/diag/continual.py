"""Continual learning through the port on the card:
``python -m nerve_tpu_torch.diag.continual [--profile DIR]``, or on the CPU
``--device cpu --small``.

* ``compare_hvp``: a kernel op's Hessian-vector product
  ∂/∂(inputs, g) ⟨∂⟨op(inputs), g⟩/∂inputs, v⟩ (``create_graph=True``) as the
  model calls the op (an autograd Function: the kernels forward, the
  recompute of the plain version backward) and through its plain version,
  on ``diag.train.grad_cases``' inputs: max and mean |Δ| and max|plain|
  per input and for ``g``, and whether the op's route lacks a second
  derivative that the plain version has.
* ``library_run``: one pass of each continual rule over the flagship's
  eval forward under autograd (``train_continual.sr_loss``: BatchNorm held,
  float32): ``EWC.register_task`` with the batch Fisher over 2 batches and
  with the per-sample Fisher over one batch, and a penalised Adam step; an SI step and its importances; a replay
  step; a second-order ``MAML`` step and a ``FOMAML`` step over 2 tasks ×
  1 inner step; a Reptile step; ``ContinualDistillation.compute_loss``. It
  returns every loss, Fisher, importance, meta-gradient and parameter dict
  it made, and the kernels launched by the second-order meta step.
* ``library_timing``: ms per second- and first-order meta step, per batch
  and per-sample Fisher pass (host clock to a synchronise, median of 3
  after one untimed), and the peak device memory of the second-order step.
* ``float32_rows``: the float32 route at the meta step's shapes (window 3,
  batch 4, 64²): the float32 dense layer (``csrc/conv_f32.cuh``) at the
  head (12 × 64² × 3 → 64) and at 64 → 64 (4 × 64² × 64), one RDB block
  (5 dense layers + the float32 fusion) at 4 × 64² × 64, the fusion alone
  (224 → 64) at 4 × 64² and at 1 × 1080 × 1920, and the correlation (d =
  4) on the 8 neighbour pairs of 64² × 64: kernel, plain, bound (67
  TFLOP/s float32, 3.35 TB/s) and library ms (cuDNN ``F.conv2d`` with TF32
  off; for the RDB its five convolutions and ``torch.matmul``, products
  only, for the fusion; ``torch.matmul`` for the fusion alone; none for the
  correlation), CUDA events, the wrapper's host work included (a single
  call finds the card idle, so its time is the host's work and then the
  kernel's); beside it the host clock a call over 50 calls without a
  synchronise (``_host_ms``: the wrapper's host work); ``--small`` at 16²
  (the fusion's second row at 64²).
* ``profile_meta_step`` (``--profile DIR``): the device time of a
  second-order meta step by part (the hand-written kernels, the inner
  gradients' recompute of the plain versions, the rest), busy time, idle
  share, kernels and host operations a step.

The default size is the flagship's (64 features, 8 RDBs, window 3, LR 64²,
batch 4); ``--small`` 16 features, 2 RDBs at 16², batch 2. The last line is
one JSON object of every number.
"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path
from typing import Dict

import torch
import torch.nn.functional as F

from nerve_tpu_torch import continual, ops
from nerve_tpu_torch.continual.params import detached
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.diag import conv as diag_conv
from nerve_tpu_torch.diag import train as diag_train
from nerve_tpu_torch.diag.conv import HBM_BYTES_PER_S, seed_all
from nerve_tpu_torch.models import SuperResolutionNet
from nerve_tpu_torch.ops import conv_chain, correlation, dispatch, rdb
from nerve_tpu_torch.train_continual import sr_loss
from nerve_tpu_torch.utils import data as data_lib

FEATURES, BLOCKS, LR_SIZE, BATCH = 64, 8, 64, 4
SMALL = (16, 2, 16, 2)  # features, blocks, LR size, batch
INNER_LR, OUTER_LR = 0.01, 1e-3
FP32_PEAK_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores


def hvp(fn, leaves, g, vs):
    """The second derivatives of ⟨∂⟨fn(leaves), g⟩/∂leaves, vs⟩ in the
    leaves and ``g`` (None where there is none)."""
    gl = g.detach().clone().requires_grad_(True)
    first = torch.autograd.grad(fn(*leaves), leaves, gl, create_graph=True, allow_unused=True)
    s = sum((d.float() * v.float()).sum() for d, v in zip(first, vs) if d is not None)
    second = torch.autograd.grad(s, list(leaves) + [gl], allow_unused=True)
    return [None if d is None else d.detach() for d in second]


def compare_hvp(kernel, plain, leaves, g, seed: int = 0) -> list:
    """Per input and for ``g``: max and mean |Δ| of the two routes' second
    derivatives, max|plain|, and ``mismatch`` where the plain version has a
    nonzero one and the op's route none, or the other way round."""
    gen = torch.Generator().manual_seed(seed)
    vs = [torch.randn(t.shape, generator=gen).to(t.device, t.dtype) for t in leaves]
    out = []
    for a, b in zip(hvp(kernel, leaves, g, vs), hvp(plain, leaves, g, vs)):
        if b is None:
            out.append({"max_abs": 0.0, "mean_abs": 0.0, "scale": 0.0, "mismatch": a is not None})
            continue
        scale = b.float().abs().max().item()
        mismatch = a is None or (scale > 0 and not a.any().item())
        d = (b.float() if a is None else (a.float() - b.float())).abs()
        out.append({"max_abs": d.max().item(), "mean_abs": d.mean().item(), "scale": scale,
                    "mismatch": mismatch})
    return out


def continual_model(dev, features: int = FEATURES, blocks: int = BLOCKS,
                    seed: int = 0) -> SuperResolutionNet:
    """The flagship in float32, eval mode, every parameter and BatchNorm
    statistic seeded (``diag.conv.seed_all``: the flow is not zero)."""
    model = SuperResolutionNet(scale_factor=2, num_features=features, num_residual_blocks=blocks,
                               temporal_window=1, device=dev)
    return seed_all(model, seed).eval()


def continual_batches(dev, n: int = 4, lr_size: int = LR_SIZE, batch: int = BATCH,
                      seed: int = 0):
    """``n`` (lr (B, h, w, 3), hr (B, 2h, 2w, 3)) batches of one task."""
    d = data_lib.make_task_sequence(seed, 1, n * batch, lr_size)[0][1]
    return [(torch.from_numpy(d["lr"][i * batch:(i + 1) * batch]).to(dev),
             torch.from_numpy(d["hr"][i * batch:(i + 1) * batch]).to(dev)) for i in range(n)]


def _tasks(batches):
    """(support, query) over 2 tasks from 4 batches."""
    return tuple(tuple(torch.stack([batches[i][k], batches[i + 1][k]]) for k in (0, 1))
                 for i in (0, 2))


def _perturbed(params, seed: int, std: float = 1e-3):
    g = torch.Generator().manual_seed(seed)
    return {k: v + std * torch.randn(v.shape, generator=g).to(v.device) for k, v in params.items()}


def _adam_step(params, loss_fn, batch, lr: float = OUTER_LR):
    """One Adam step from ``params``: (loss, gradients, parameters after)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr)
    loss = loss_fn(leaves, batch)
    loss.backward()
    grads = {k: v.grad.detach().clone() for k, v in leaves.items()}
    opt.step()
    return loss.detach(), grads, detached(leaves)


def library_run(model, batches) -> Dict[str, object]:
    """One pass of each continual rule (see the module doc) from the
    model's parameters; ``batches``: 4 batches."""
    loss_fn = sr_loss(model, model.num_frames)
    p0 = detached(dict(model.named_parameters()))
    p1 = _perturbed(p0, 1)
    out: Dict[str, object] = {}
    ewc = continual.EWC(loss_fn)
    ewc.register_task(0, p0, batches[:2])
    out["ewc fisher"] = ewc.state_dict()["fisher"]
    per_sample = continual.EWC(loss_fn, per_sample_fisher=True)
    per_sample.register_task(0, p0, batches[:1])
    out["per-sample fisher"] = per_sample.state_dict()["fisher"]
    out["ewc penalty"] = ewc.penalty(p1)
    out["ewc step loss"], _g, out["ewc step params"] = _adam_step(
        p1, lambda p, b: loss_fn(p, b) + ewc.penalty(p), batches[2])
    si = continual.SynapticIntelligence()
    si.start_task(p0)
    out["si step loss"], grads, new = _adam_step(p0, lambda p, b: loss_fn(p, b) + si.penalty(p),
                                                 batches[3])
    si.update_importance(p0, new, grads)
    si.register_task(new)
    out["si importance"] = si._omega
    memory = continual.EpisodicMemory(capacity=8, strategy="stratified")
    for i in range(batches[1][0].shape[0]):
        memory.store(batches[1][0][i].cpu().numpy(), batches[1][1][i].cpu().numpy(),
                     {"content_type": "sports"})
    replay = memory.sample(2)
    dev = batches[0][0].device
    mixed = tuple(torch.cat([batches[0][k], torch.from_numpy(replay[name]).to(dev)])
                  for k, name in ((0, "lr"), (1, "hr")))
    out["replay step loss"], _g, out["replay step params"] = _adam_step(p0, loss_fn, mixed)
    support, query = _tasks(batches)
    for name, cls in (("maml", continual.MAML), ("fomaml", continual.FOMAML)):
        meta = cls(loss_fn, p0, inner_lr=INNER_LR, outer_lr=OUTER_LR, inner_steps=1)
        dispatch.reset_launches()
        out[f"{name} loss"] = torch.tensor(meta.train_step(support, query))
        if cls is continual.MAML:
            out["maml launches"] = {k: v for k, v in dispatch.launches.items() if v}
        out[f"{name} meta-gradient"] = {k: v.grad.detach().clone() for k, v in meta.params.items()}
        out[f"{name} params"] = detached(meta.params)
    reptile = continual.Reptile(loss_fn, p0, inner_lr=INNER_LR, outer_lr=0.3, inner_steps=1)
    reptile.train_step(support)
    out["reptile params"] = reptile.params
    cd = continual.ContinualDistillation(
        lambda p, x: torch.func.functional_call(model, dict(p), (x,), {"differentiable": True}))
    cd.register_task(p0)
    window = data_lib.expand_temporal(batches[2][0], model.num_frames)
    out["distillation"] = {k: v.detach() for k, v in
                           cd.compute_loss(p1, window, batches[2][1]).items()}
    out["p0"] = p0
    return out


def flat(x) -> torch.Tensor:
    """A tensor or a dict of tensors as one float32 vector."""
    if isinstance(x, dict):
        return torch.cat([flat(v) for v in x.values()]) if x else torch.zeros(0)
    return x.detach().float().reshape(-1)


def rel_l2(a, b) -> float:
    """‖a − b‖ / ‖b‖ over a tensor or a dict of tensors."""
    fa, fb = flat(a), flat(b).to(flat(a).device)
    return ((fa - fb).norm() / fb.norm().clamp_min(1e-30)).item()


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


def library_timing(model, batches) -> dict:
    """ms per meta step (second and first order, 2 tasks × 1 inner step),
    per Fisher pass over one batch (batch and per-sample) and the peak
    device memory of a second-order step."""
    dev = batches[0][0].device
    loss_fn = sr_loss(model, model.num_frames)
    p0 = detached(dict(model.named_parameters()))
    support, query = _tasks(batches)
    out = {}
    for name, first_order in (("maml_ms", False), ("fomaml_ms", True)):
        meta = continual.MAML(loss_fn, p0, inner_lr=INNER_LR, outer_lr=OUTER_LR, inner_steps=1,
                              first_order=first_order)
        out[name] = _median_ms(lambda: meta.train_step(support, query), dev)
    for name, per_sample in (("fisher_ms", False), ("per_sample_fisher_ms", True)):
        out[name] = _median_ms(lambda: continual.ewc.compute_fisher(
            loss_fn, p0, batches[:1], per_sample=per_sample), dev)
    if dev.type == "cuda":
        meta = continual.MAML(loss_fn, p0, inner_lr=INNER_LR, outer_lr=OUTER_LR, inner_steps=1)
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        meta.train_step(support, query)
        out["maml_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def profile_meta_step(model, batches, out_dir: Path, steps: int = 2) -> dict:
    """Device ms per second-order meta step under ``torch.profiler`` (after
    one untimed step), by part: the hand-written kernels, the first-order
    backward's recompute of the plain versions (range ``nt.recompute``,
    which the inner gradients run) and the rest (the plain ATen forward
    work and the backward of the backward); busy time, idle share, kernels
    and profiled host operations a step, and the kernels that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    out_dir.mkdir(parents=True, exist_ok=True)
    loss_fn = sr_loss(model, model.num_frames)
    meta = continual.MAML(loss_fn, detached(dict(model.named_parameters())),
                          inner_lr=INNER_LR, outer_lr=OUTER_LR, inner_steps=1)
    support, query = _tasks(batches)
    meta.train_step(support, query)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            meta.train_step(support, query)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    trace = out_dir / "trace_maml_step.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    recompute = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == dispatch.RECOMPUTE_RANGE:
            recompute.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
    split, by_name = {}, {}
    for k in kernels:
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"] / 1e3 / steps
        launch = launches.get(k.get("args", {}).get("correlation"))
        if any(w in k["name"] for w in diag_train.KERNEL_WORDS):
            part = "hand-written kernels"
        elif launch is not None and any(a <= launch["ts"] <= b
                                        for a, b in recompute.get(launch["tid"], ())):
            part = "recompute"
        else:
            part = "other"
        split[part] = split.get(part, 0.0) + k["dur"] / 1e3 / steps
    busy = diag_train.busy_us(kernels) / 1e3 / steps
    result = {"ms_per_step": split, "busy_ms_per_step": busy, "wall_ms_per_step": wall,
              "idle_share": 1 - busy / wall, "kernels_per_step": len(kernels) / steps,
              "host_ops_per_step": sum(e.get("cat") == "cpu_op" for e in events) / steps,
              "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])}
    print("profile second-order meta step (device ms/step): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f"; busy {busy:.3f} of wall {wall:.3f}, idle share {result['idle_share']:.3f}; "
        f"{result['kernels_per_step']:g} kernels and {result['host_ops_per_step']:g} "
        "profiled host ops a step; top kernels (ms/step): " + "; ".join(
            f"{name[:80]} {ms:.3f}" for name, ms in result["top_kernels_ms"].items()), flush=True)
    return result


# --------------------------------------------------------------------------- #
# The float32 route of the kernels at the meta step's shapes
# --------------------------------------------------------------------------- #
def _bound(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / FP32_PEAK_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def _host_ms(fn, dev, n: int = 50) -> float:
    """Host clock a call of ``fn`` over ``n`` calls without a synchronise
    (the card's queue runs behind): the wrapper's host work a call."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    _sync(dev)
    return ms


def float32_rows(dev, reps: int = 25, small: bool = False) -> Dict[str, dict]:
    """{case: kernel / plain / bound / library ms, max|err|} (module doc)."""
    g = torch.Generator().manual_seed(12)
    hw = 16 if small else 64
    out = {}

    def row(name, kern, plain, lib, flops, nbytes):
        dispatch.reset_launches()
        y = kern()
        launched = {k: v for k, v in dispatch.launches.items() if v}
        ref = plain().float()
        err = (y.float() - ref).abs().max().item()
        bound, by = _bound(flops, nbytes)
        out[name] = {"kernel_ms": _common.median_ms(kern, dev, reps),
                     "host_ms": _host_ms(kern, dev),
                     "plain_ms": _common.median_ms(plain, dev, reps),
                     "library_ms": None if lib is None else _common.median_ms(lib, dev, reps),
                     "bound_ms": bound, "bound_by": by, "flops": flops, "bytes": nbytes,
                     "max_abs_err": err, "rel_err": err / ref.abs().max().item(),
                     "launches": launched}
        r = out[name]
        lib_txt = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"float32 {name}: kernel {r['kernel_ms']:.4f} ms ({launched}; the wrapper's host "
              f"work {r['host_ms']:.4f} ms a call), plain {r['plain_ms']:.4f}, library {lib_txt}, "
              f"bound {bound:.4f} ({by}); max|err| {err:.3e}", flush=True)

    for name, (n, cin) in {"conv head 3->64": (12, 3), "conv 64->64": (4, 64)}.items():
        x = torch.rand((n, hw, hw, cin), generator=g).to(dev)
        w = (torch.randn((3, 3, cin, 64), generator=g) * (9 * cin) ** -0.5).to(dev)
        layer = [(w, (0.1 * torch.randn(64, generator=g)).to(dev), "relu")]
        cudnn = diag_conv.cudnn_chain(layer, torch.float32)
        npix = n * hw * hw
        row(f"{name} ({n}x{hw}x{hw})", lambda: ops.conv_chain_apply(x, layer),
            lambda: conv_chain.conv_chain_plain(x, layer), lambda: cudnn(x),
            2 * 9 * cin * 64 * npix, 4 * (x.numel() + w.numel() + 64 + npix * 64))

    x = torch.rand((4, hw, hw, 64), generator=g).to(dev)
    params = _common.rdb_params(g, 64, dev)
    npix = 4 * hw * hw
    dense = [(params[2 * i], params[2 * i + 1]) for i in range(5)]
    lw, lb = params[10], params[11]
    cudnn_w = [(w.permute(3, 2, 0, 1).contiguous(), b) for w, b in dense]

    def library_block():
        cat = x.permute(0, 3, 1, 2)
        for w, b in cudnn_w:
            cat = torch.cat([cat, torch.relu(F.conv2d(cat, w, b, padding=1))], 1)
        flat = cat.permute(0, 2, 3, 1).reshape(-1, cat.shape[1])
        return torch.matmul(flat, lw).reshape(4, hw, hw, 64) * 0.2 + x

    flops = sum(2 * 9 * w.shape[2] * 32 * npix for w, _b in dense) + 2 * lw.numel() * npix
    nbytes = 4 * (2 * x.numel() + sum(p.numel() for p in params))
    row(f"rdb block ({4}x{hw}x{hw}x64)", lambda: ops.rdb_chain_apply(x, [params]),
        lambda: rdb.rdb_chain_plain(x, [params]), library_block, flops, nbytes)

    gd = torch.Generator(device=dev).manual_seed(12)  # the concatenations, made on the device
    for n, h, w in ((4, hw, hw), (1, 64, 64) if small else (1, 1080, 1920)):
        name = f"fusion 224->64 ({n}x{h}x{w})"
        cat = torch.rand((n, h, w, 224), generator=gd, device=dev)
        fw, fb = params[10], params[11]
        npix = n * h * w
        flat = cat.reshape(npix, 224)
        fusion = rdb.lff_launch if dispatch.use_kernel(cat) else rdb.lff_plain  # CPU: plain
        row(name, lambda cat=cat, fusion=fusion: fusion(cat, fw, fb),
            lambda cat=cat: rdb.lff_plain(cat, fw, fb), lambda flat=flat: torch.matmul(flat, fw),
            2 * fw.numel() * npix, 4 * (cat.numel() + fw.numel() + 64 + npix * 64))
        del cat, flat

    f1 = torch.randn((8, hw, hw, 64), generator=g).to(dev)
    f2 = torch.randn((8, hw, hw, 64), generator=g).to(dev)
    npix = 8 * hw * hw
    row(f"correlation d=4 ({8}x{hw}x{hw}x64)", lambda: ops.correlation_volume(f1, f2, 4),
        lambda: correlation.correlation_plain(f1, f2, 4), None, 2 * 81 * 64 * npix,
        4 * (f1.numel() + f2.numel() + 81 * npix))
    return out


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR",
                   help="also profile two second-order meta steps into DIR")
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    features, blocks, lr_size, batch = SMALL if args.small else (FEATURES, BLOCKS, LR_SIZE,
                                                                 BATCH)
    model = continual_model(dev, features, blocks)
    batches = continual_batches(dev, 4, lr_size, batch)
    run = library_run(model, batches)
    result = {"maml_launches": run["maml launches"],
              "maml_vs_fomaml_rel_l2": rel_l2(run["fomaml meta-gradient"],
                                              run["maml meta-gradient"]),
              "timing": library_timing(model, batches),
              "float32_rows": float32_rows(dev, max(args.reps, 25 if dev.type == "cuda" else 1),
                                           args.small)}
    print(f"timing: {json.dumps(result['timing'])}", flush=True)
    if args.profile:
        if dev.type != "cuda":
            raise SystemExit("--profile traces the card: run it with --device cuda")
        result["profile"] = profile_meta_step(model, batches, Path(args.profile))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
