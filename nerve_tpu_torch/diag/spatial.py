"""Where the multi-device paths spend their time, on one rank:
``python -m nerve_tpu_torch.diag.spatial [--device cpu --small]``.

It joins a process group of one rank (NCCL on the card, gloo on the CPU)
and times, each the median of ``--reps`` after one warm-up (CUDA events on
the card):

* ``split_sr``: the flagship's one-device forward beside
  ``spatial_sr_apply`` on the same frames, and the sharded call's parts:
  the halo exchange alone, the model on the extended slab (the CBAM pool's
  all-reduce included), and that all-reduce alone at the pool's size;
* ``split_step``: the flagship's one-device train step beside the
  data-parallel step (``make_sr_train_step(..., mesh=)``), and its parts:
  the all-reduce of the flattened gradients alone, and the BatchNorm
  statistics' all-reduces a step (counted).

At one rank the exchange moves nothing and the all-reduces sum one term, so
this is the cost the multi-device code adds on one card; it attributes time
and moves no metric. The last line is one JSON object of every number.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch
import torch.distributed as dist

from nerve_tpu_torch import training
from nerve_tpu_torch.config.schema import TrainingConfig
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.diag.conv import seed_all
from nerve_tpu_torch.models import SuperResolutionNet
from nerve_tpu_torch.models import layers
from nerve_tpu_torch.parallel import collectives, init_distributed, make_mesh
from nerve_tpu_torch.parallel.spatial import spatial_sr_apply


def split_sr(model, frames, mesh, halo: int, reps: int) -> dict:
    """ms of the one-device forward, the sharded call and its parts."""
    dev = frames.device
    group = mesh.group("model")
    ext = collectives.exchange_halo(frames, halo, group)
    channels = model.temporal_aggregator.refine.ChannelAttention_0.Dense_0.kernel.shape[0]
    pool = torch.zeros(frames.shape[0] * channels + 1, device=dev)

    def ext_forward():
        with model.spatial(group, halo):
            return model(ext)

    return {
        "one_device_ms": _common.median_ms(lambda: model(frames), dev, reps),
        "sharded_ms": _common.median_ms(
            lambda: spatial_sr_apply(model, frames, mesh, halo=halo), dev, reps),
        "exchange_ms": _common.median_ms(
            lambda: collectives.exchange_halo(frames, halo, group), dev, reps),
        "extended_forward_ms": _common.median_ms(ext_forward, dev, reps),
        "pool_all_reduce_ms": _common.median_ms(
            lambda: collectives.all_reduce_sum(pool, group), dev, reps),
        "rows": frames.shape[-3], "extended_rows": ext.shape[-3], "halo": halo,
    }


def split_step(make_model, batch, mesh, reps: int) -> dict:
    """ms of the one-device train step, the data-parallel step and its
    gradient all-reduce; the statistics' all-reduces a step."""
    dev = batch[0].device
    out = {}
    for name, m in (("one_device_step_ms", None), ("data_parallel_step_ms", mesh)):
        model = make_model()
        state = training.create_sr_state(model, TrainingConfig(epochs=1, warmup_epochs=0), 100)
        step = training.make_sr_train_step(model, mesh=m)
        out[name] = _common.median_ms(lambda: step(state, *batch), dev, reps)
    grads = torch.cat([p.detach().flatten() for p in model.parameters()])
    group = mesh.group("data")
    out["grad_all_reduce_ms"] = _common.median_ms(
        lambda: collectives.all_reduce_(grads, group), dev, reps)
    out["grad_elements"] = grads.numel()
    calls = []
    saved = layers.all_reduce_sum
    layers.all_reduce_sum = lambda x, g: calls.append(x.numel()) or saved(x, g)
    try:
        step(state, *batch)
    finally:
        layers.all_reduce_sum = saved
    out["stat_all_reduces_per_step"] = len(calls)
    return out


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    small = args.small
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("nccl" if dev.type == "cuda" else "gloo",
                         f"file://{os.path.join(tmp, 'init')}", 1, 0, dev.type)
        try:
            mesh = make_mesh(device=dev.type)
            feats, blocks = (8, 1) if small else (64, 8)
            dt = torch.float32 if small else torch.bfloat16

            def sr(flow):
                return seed_all(SuperResolutionNet(
                    scale_factor=2, num_features=feats, num_residual_blocks=blocks,
                    temporal_window=1, flow_downsample=flow, dtype=dt, device=dev), 0)

            h, w = (32, 24) if small else (1080, 1920)
            g = torch.Generator().manual_seed(1)
            frames = torch.rand((1, 3, h, w, 3), generator=g).to(dev)
            res = {"sr": split_sr(sr(2).eval(), frames, mesh, 8 if small else 64, args.reps)}
            bsz, lr = (2, 16) if small else (16, 64)
            lr_win = torch.rand((bsz, 3, lr, lr, 3), generator=g).to(dev)
            hr = torch.rand((bsz, 2 * lr, 2 * lr, 3), generator=g).to(dev)
            res["step"] = split_step(lambda: sr(1).train(), (lr_win, hr), mesh, args.reps)
        finally:
            dist.destroy_process_group()
    res["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
