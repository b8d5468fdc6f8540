"""Run the multi-device paths in N spawned ranks.

``spawn(fn, world, backend, device, args)`` starts ``world`` processes, each
of which joins a process group (``init_method="file://…"`` in a fresh
directory, so concurrent runs never share a port), sets one CPU thread and
calls ``fn(rank_device, *args)``. ``fn`` must be importable by name in a fresh
interpreter: the functions here and in ``parallel.dryrun``.

``run_cases(spec_dir)`` is the rank program the CPU parity tests and
``chip_smoke.py`` drive. ``spec_dir`` holds ``spec.json`` and
``arrays.npz``: the models (``{"models": {name: {"kind": "sr" |
"lightweight", "config": {...}, "dtype": "float32" | "bfloat16"}}}``, their
weights as ``w/<model>/<state_dict key>``), the inputs (``x/<name>`` in
the npz, or ``"rand": {name: [seed, shape]}``: ``torch.rand`` of a seeded
CPU generator, the same on every rank) and the cases, each run on every
rank on a mesh of its own::

    {"name": ..., "fn": "sr" | "sr_grad" | "stream" | "light" | "train",
     "model": ..., "mesh": [data, client, model], "input": ..., "halo": ...,
     "data_axis": null | "data", "layout": ..., "target": ..., "reps": 0}

``sr``, ``stream`` and ``light`` run ``spatial_sr_apply``,
``spatial_streaming_apply`` and ``spatial_lightweight_apply`` on the rank's
part of the input (``shard_batch`` over ``data_axis``, then
``shard_rows``); ``sr_grad`` the loss ``mean((out - target)²)`` over the
global output through ``spatial_sr_apply(..., differentiable=True)`` and
its gradients summed over every rank; ``train`` ``steps`` data-parallel
train steps (``training.make_sr_train_step(..., mesh=)``) from the weights
on the global batches ``x/<input>_<i>`` and ``x/<target>_<i>``. Rank 0
writes ``result.pt``: per case the gathered output (or the loss and
gradients; or each step's global metrics, the first step's averaged
gradients before the clip, the final weights and whether every rank holds
them to the bit), every rank's kernel launches in the checked call, and
with ``reps`` > 0 the ms of one call (median of ``reps``, the ranks in
step).
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nerve_tpu_torch.ops import dispatch
from nerve_tpu_torch.parallel import collectives, spatial
from nerve_tpu_torch.parallel.mesh import (
    gather_batch,
    init_distributed,
    make_mesh,
    shard_batch,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rank_main(rank, fn, world, backend, device, init_file, args):
    torch.set_num_threads(1)
    dev = init_distributed(backend, f"file://{init_file}", world, rank, device)
    try:
        fn(dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str = "gloo", device: str = "cpu", args=(),
          timeout: float = 600.0) -> None:
    """``fn(rank_device, *args)`` in ``world`` ranks of a fresh process
    group; raises if a rank fails or the ranks outlast ``timeout`` seconds (all then stopped)."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, nprocs=world, join=False, start_method="spawn",
                                 args=(fn, world, backend, device, os.path.join(tmp, "init"),
                                       tuple(args)))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} outlasted {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()


def write_spec(spec_dir, spec: dict, arrays: dict) -> Path:
    """Write ``spec.json`` and ``arrays.npz`` (numpy arrays by key)."""
    spec_dir = Path(spec_dir)
    spec_dir.mkdir(parents=True, exist_ok=True)
    (spec_dir / "spec.json").write_text(json.dumps(spec))
    np.savez(spec_dir / "arrays.npz", **{k: np.asarray(v) for k, v in arrays.items()})
    return spec_dir


def state_arrays(name: str, model: torch.nn.Module) -> dict:
    """``model``'s state dict as float32 numpy arrays under ``w/<name>/``."""
    return {f"w/{name}/{k}": v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def build_model(entry: dict, arrays, name: str, device):
    """The model ``entry`` describes, its weights from ``arrays``."""
    from nerve_tpu_torch.models import LightweightSuperResolution, SuperResolutionNet

    cls = {"sr": SuperResolutionNet, "lightweight": LightweightSuperResolution}[entry["kind"]]
    model = cls(**entry["config"], dtype=DTYPES[entry["dtype"]], device=device)
    prefix = f"w/{name}/"
    state = {k[len(prefix):]: torch.from_numpy(arrays[k]) for k in arrays.files
             if k.startswith(prefix)}
    model.load_state_dict({k: v.to(model.state_dict()[k].dtype) for k, v in state.items()})
    return model.eval()


def _input(spec, arrays, name):
    if f"x/{name}" in arrays.files:
        return torch.from_numpy(arrays[f"x/{name}"])
    seed, shape = spec["rand"][name]
    return torch.rand(tuple(shape), generator=torch.Generator().manual_seed(seed))


def _part(x, mesh, case):
    if case.get("data_axis"):
        x = shard_batch(x, mesh, case["data_axis"])
    return spatial.shard_rows(x, mesh)


def _gather(y, mesh, case, dim=-3):
    y = spatial.gather_rows(y, mesh, dim=dim)
    return gather_batch(y, mesh, case["data_axis"]) if case.get("data_axis") else y


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, reps: int, dev) -> float:
    times = []
    for _ in range(reps):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _run_case(case, models, spec, arrays, mesh) -> dict:
    dev = mesh.device
    fn, model = case["fn"], models.get(case.get("model", "sr"))
    halo, data_axis = case.get("halo", 0), case.get("data_axis")
    res = {}
    if fn == "train":
        return _train_case(case, spec, arrays, mesh)
    x = _part(_input(spec, arrays, case["input"]), mesh, case)
    if fn == "sr":
        call = lambda: spatial.spatial_sr_apply(model, x, mesh, halo=halo, data_axis=data_axis)
    elif fn == "stream":
        call = lambda: spatial.spatial_streaming_apply(model, x, mesh, halo=halo,
                                                       data_axis=data_axis)
    elif fn == "light":
        call = lambda: spatial.spatial_lightweight_apply(
            model, x, mesh, halo=halo, data_axis=data_axis, output_layout=case["layout"])
    elif fn == "sr_grad":
        target = _part(_input(spec, arrays, case["target"]), mesh, case).float()
        total = _input(spec, arrays, case["target"]).numel()
        model.zero_grad(set_to_none=True)

        def call():
            out = spatial.spatial_sr_apply(model, x, mesh, halo=halo, data_axis=data_axis,
                                           differentiable=True)
            loss = torch.sum((out.float() - target) ** 2) / total
            loss.backward()
            return loss.detach()
    else:
        raise ValueError(f"unknown case fn {fn!r}")
    dispatch.reset_launches()
    out = call()
    _sync(dev)
    res["launches"] = {k: v for k, v in dispatch.launches.items() if v}
    if fn == "sr_grad":
        world = dist.group.WORLD
        res["loss"] = collectives.all_reduce_(out.clone(), world).cpu()
        res["grads"] = {k: collectives.all_reduce_(p.grad.clone(), world).cpu()
                        for k, p in model.named_parameters() if p.grad is not None}
    else:
        dim = spatial.ROW_AXIS[case["layout"]] if fn == "light" else -3
        res["out"] = _gather(out, mesh, case, dim).cpu()
    if case.get("reps", 0) > 0:
        res["ms"] = _timed(call, case["reps"], dev)
    return res


def _train_case(case, spec, arrays, mesh) -> dict:
    from nerve_tpu_torch import training
    from nerve_tpu_torch.config.schema import TrainingConfig

    dev = mesh.device
    name = case.get("model", "sr")
    model = build_model(spec["models"][name], arrays, name, dev).train()
    cfg = TrainingConfig(**case.get("cfg", {}))
    state = training.create_sr_state(model, cfg, case.get("steps_per_epoch", 100))
    step = training.make_sr_train_step(model, case.get("loss_kind", "mse"), mesh)
    names = {p: k for k, p in model.named_parameters()}
    apply, grads0 = state.optimizer.apply, {}

    def recording_apply(count):  # the first step's averaged gradients, before the clip
        if not grads0:
            grads0.update({names[p]: p.grad.detach().cpu().clone()
                           for p in state.optimizer.params() if p.grad is not None})
        apply(count)

    state.optimizer.apply = recording_apply
    metrics, launches = [], []
    for i in range(case["steps"]):
        lr = shard_batch(_input(spec, arrays, f"{case['input']}_{i}"), mesh)
        hr = shard_batch(_input(spec, arrays, f"{case['target']}_{i}"), mesh)
        dispatch.reset_launches()
        _s, m = step(state, lr, hr)
        _sync(dev)
        launches.append({k: v for k, v in dispatch.launches.items() if v})
        metrics.append({k: float(v) for k, v in m.items()})
    flat = torch.cat([p.detach().flatten() for p in model.parameters()])
    every = collectives.all_gather(flat, dist.group.WORLD)
    res = {"metrics": metrics, "launches": launches, "grads0": grads0,
           "ranks_equal": all(torch.equal(every[0], f) for f in every[1:]),
           "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    if case.get("reps", 0) > 0:
        lr = shard_batch(_input(spec, arrays, f"{case['input']}_0"), mesh)
        hr = shard_batch(_input(spec, arrays, f"{case['target']}_0"), mesh)
        res["ms"] = _timed(lambda: step(state, lr, hr), case["reps"], dev)
    return res


def run_cases(dev, spec_dir) -> None:
    """The rank program of the module doc on this rank's device ``dev``;
    rank 0 writes ``result.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec_dir = Path(spec_dir)
    spec = json.loads((spec_dir / "spec.json").read_text())
    arrays = np.load(spec_dir / "arrays.npz")
    models = {name: build_model(entry, arrays, name, dev)
              for name, entry in spec["models"].items()}
    results, meshes = {}, {}
    for case in spec["cases"]:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device=dev.type)
        results[case["name"]] = _run_case(case, models, spec, arrays, meshes[shape])
        results[case["name"]]["launches"] = _every_rank(results[case["name"]]["launches"])
    if dist.get_rank() == 0:
        torch.save(results, spec_dir / "result.pt")


def _every_rank(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
