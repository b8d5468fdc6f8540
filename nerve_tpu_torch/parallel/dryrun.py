"""The multi-device dry run: the twin of ``__graft_entry__.dryrun_multichip``.

    python -m nerve_tpu_torch.parallel.dryrun --world 4 --backend gloo --device cpu
    python -m nerve_tpu_torch.parallel.dryrun --world 4 --backend nccl --device cuda
    python -m nerve_tpu_torch.parallel.dryrun --world 2 --backend gloo --device cuda

``--world`` ranks (``parallel.launch.spawn``; on the card the kernels are
built once before the ranks start) run, in float32 on tiny shapes:

1. a data-parallel SR train step over ('data',): a finite loss, the ranks'
   parameters equal to the bit;
2. FedAvg over ('client',): waits for the federated slice, printed so;
3. height-sharded SR inference over ('model',) with the halo exchange and
   the CBAM pool's sum: the gathered frame's shape, finite values;
4. data × model (an even world of at least 4): a loss through the sharded
   forward and its gradient, summed over the ranks, finite and non-zero;
   4b. with at least 4 ranks, the full model (64 features, 8 RDBs, flow at
   half resolution, every weight seeded: the flow is not zero) over slabs
   of 68 rows with halo 64 against the one-device forward on the interior
   rows (2·70 from each edge), within 5e-5; the width is sized to
   ``--budget`` seconds from a timed one-device forward at 16 columns (at
   most 256, the JAX case's);
5. height-sharded lightweight serving, planar output: shape, finite values.

Rank 0 prints one line ending in OK; a failed case raises in its rank and
the run exits non-zero.
"""

from __future__ import annotations

import argparse
import math
import time

import torch
import torch.distributed as dist

from nerve_tpu_torch.parallel import collectives, launch
from nerve_tpu_torch.parallel.mesh import make_mesh, shard_batch
from nerve_tpu_torch.parallel.spatial import (
    gather_rows,
    shard_rows,
    spatial_lightweight_apply,
    spatial_sr_apply,
)

ROWS_4B, HALO_4B, INTERIOR_4B, LIMIT_4B = 68, 64, 2 * 70, 5e-5


def _rand(shape, seed, dev):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed)).to(dev)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _equal_on_every_rank(flat) -> bool:
    every = collectives.all_gather(flat, dist.group.WORLD)
    return all(torch.equal(every[0], f) for f in every[1:])


def case_data_parallel(n, dev) -> float:
    from nerve_tpu_torch import training
    from nerve_tpu_torch.config.schema import TrainingConfig
    from nerve_tpu_torch.models import SuperResolutionNet
    from nerve_tpu_torch.utils import data as data_lib

    mesh = make_mesh(data=n, device=dev.type)
    model = SuperResolutionNet(num_features=8, num_residual_blocks=1, device=dev,
                               generator=torch.Generator().manual_seed(0))
    data = data_lib.make_sr_dataset(torch.Generator().manual_seed(0), 2 * n, lr_size=16)
    lr_win = data_lib.expand_temporal(torch.from_numpy(data["lr"]), 3)
    state = training.create_sr_state(model, TrainingConfig(epochs=1), 1)
    step = training.make_sr_train_step(model, mesh=mesh)
    state, metrics = step(state, shard_batch(lr_win, mesh), shard_batch(data["hr"], mesh))
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if not _equal_on_every_rank(torch.cat([p.detach().flatten() for p in model.parameters()])):
        raise AssertionError("the ranks' parameters differ after the step")
    return loss


def _sr(dev, seed, **config):
    """The flagship with every weight seeded (``diag.conv.seed_all``: the
    zero-initialised flow and upsampler layers would make the output the
    bicubic base, exact under any sharding)."""
    from nerve_tpu_torch.diag.conv import seed_all
    from nerve_tpu_torch.models import SuperResolutionNet

    return seed_all(SuperResolutionNet(scale_factor=2, device=dev, **config).eval(), seed)


def case_spatial(n, dev) -> None:
    mesh = make_mesh(data=1, model=n, device=dev.type)
    model = _sr(dev, 0, num_features=8, num_residual_blocks=1)
    frames = _rand((1, 3, 8 * n, 16, 3), 1, dev)
    out = gather_rows(spatial_sr_apply(model, shard_rows(frames, mesh), mesh, halo=4), mesh)
    if tuple(out.shape) != (1, 16 * n, 32, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"sharded SR output {tuple(out.shape)} or not finite")


def case_data_model(n, dev) -> str:
    if n < 4 or n % 2:
        return "skipped (needs an even world of at least 4)"
    nm = n // 2
    mesh = make_mesh(data=2, model=nm, device=dev.type)
    model = _sr(dev, 0, num_features=8, num_residual_blocks=1)
    frames = _rand((2, 3, 8 * nm, 16, 3), 2, dev)
    target = _rand((2, 16 * nm, 32, 3), 3, dev)

    def part(x):
        return shard_rows(shard_batch(x, mesh), mesh)

    out = spatial_sr_apply(model, part(frames), mesh, halo=4, data_axis="data",
                           differentiable=True)
    local = torch.sum((out.float() - part(target)) ** 2) / target.numel()
    local.backward()
    world = dist.group.WORLD
    loss = float(collectives.all_reduce_(local.detach().clone(), world))
    gnorm = float(sum(collectives.all_reduce_(p.grad.clone(), world).square().sum()
                      for p in model.parameters() if p.grad is not None))
    if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0.0):
        raise AssertionError(f"data x model loss {loss}, |grad|^2 {gnorm}")
    return f"loss={loss:.5f} |grad|²={gnorm:.3e}"


def _width_4b(n, dev, model, budget: float) -> int:
    """The widest multiple of 16 columns (16 to 256) whose case fits
    ``budget`` seconds, from rank 0's one-device forward at 16 columns."""
    widths = [16]
    if dist.get_rank() == 0:
        frames = _rand((1, 3, ROWS_4B * n, 16, 3), 4, dev)
        model(frames)  # the first call builds and warms up
        _sync(dev)
        t0 = time.perf_counter()
        model(frames)
        _sync(dev)
        per_column = (time.perf_counter() - t0) / 16
        # One sharded forward of an extended slab on every rank, then the
        # one-device forward on rank 0.
        cost = per_column * (1 + (ROWS_4B + 2 * HALO_4B) / (ROWS_4B * n))
        widths[0] = int(min(256, max(16, budget / cost // 16 * 16)))
    dist.broadcast_object_list(widths, src=0)
    return widths[0]


def case_full_model(n, dev, budget: float) -> str:
    if n < 4:
        return "skipped (needs at least 4 ranks)"
    mesh = make_mesh(data=1, model=n, device=dev.type)
    model = _sr(dev, 5, num_features=64, num_residual_blocks=8, temporal_window=1,
                flow_downsample=2)
    w = _width_4b(n, dev, model, budget)
    frames = _rand((1, 3, ROWS_4B * n, w, 3), 6, dev)
    got = gather_rows(spatial_sr_apply(model, shard_rows(frames, mesh), mesh, halo=HALO_4B),
                      mesh)
    err = torch.zeros((), device=dev)
    if dist.get_rank() == 0:
        want = model(frames)
        r = INTERIOR_4B
        if got.shape != want.shape:
            raise AssertionError(f"shapes {tuple(got.shape)} vs {tuple(want.shape)}")
        err = (got[:, r:-r] - want[:, r:-r]).abs().max()
    err = float(collectives.broadcast_(err, dist.group.WORLD))
    if not err < LIMIT_4B:
        raise AssertionError(f"{ROWS_4B * n}-row spatial interior mismatch: {err}")
    return f"max|d| {err:.2e} at {ROWS_4B * n}x{w}"


def case_lightweight(n, dev) -> None:
    from nerve_tpu_torch.diag.conv import seed_all
    from nerve_tpu_torch.models import LightweightSuperResolution

    mesh = make_mesh(data=1, model=n, device=dev.type)
    model = seed_all(LightweightSuperResolution(scale_factor=2, device=dev).eval(), 0,
                     small=("tail",))
    frame = _rand((1, 8 * n, 16, 3), 7, dev)
    out = spatial_lightweight_apply(model, shard_rows(frame, mesh), mesh, halo=8,
                                    output_layout="planar")
    out = gather_rows(out, mesh, dim=2)
    if tuple(out.shape) != (1, 3, 16 * n, 32) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"sharded lightweight output {tuple(out.shape)} or not finite")


def run_cases(dev, n: int, budget: float, backend: str) -> None:
    """Every case on this rank's device ``dev``; rank 0 prints the result
    line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loss = case_data_parallel(n, dev)
    case_spatial(n, dev)
    combined = case_data_model(n, dev)
    full = case_full_model(n, dev, budget)
    case_lightweight(n, dev)
    if dist.get_rank() == 0:
        print(f"nerve_tpu_torch dryrun({n}, {backend}, {dev.type}) OK: dp loss={loss:.5f}, "
              f"fedavg waits for the federated slice, spatial halo-sharded fwd OK, "
              f"data×model grad {combined}, full-model spatial exactness {full}, "
              f"lightweight spatial planar OK", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="nerve_tpu_torch multi-device dry run")
    p.add_argument("--world", type=int, default=4, help="ranks to spawn")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="nccl")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--budget", type=float, default=60.0,
                   help="seconds for case 4b, which sets its width")
    p.add_argument("--timeout", type=float, default=1200.0)
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("dryrun: no CUDA device; pass --device cpu --backend gloo")
        from nerve_tpu_torch.ops import _build

        _build.build()
    launch.spawn(run_cases, args.world, args.backend, args.device,
                 args=(args.world, args.budget, args.backend), timeout=args.timeout)


if __name__ == "__main__":
    main()
