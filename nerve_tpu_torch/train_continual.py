"""Continual learning across a sequence of content-type tasks.

Counterpart of ``experiments/train_continual.py``, with its flags and its
last line, ``{"final_psnr_per_task": {...}}``::

    python -m nerve_tpu_torch.train_continual --strategy ewc
    python -m nerve_tpu_torch.train_continual --device cpu --strategy maml --num-tasks 2 \\
        --epochs-per-task 1 --samples-per-task 8 --batch-size 4

Strategies: ``ewc`` and ``si`` (penalised sequential training), ``replay``
(an episodic memory mixed into each batch), ``maml`` (first-order, as in
the JAX script) and ``reptile`` (meta-training over all tasks). The model is
``SuperResolutionNet`` (16 features, 2 RDBs, window of 3 frames, float32)
at LR 32², its BatchNorm statistics held at their initial values: the loss
is its eval forward under autograd (``differentiable=True``) over a dict of
parameters (``torch.func.functional_call``), so the Fisher, the SI path
integral and the inner loops run the model's kernels on the card. Tasks
come from ``utils.data.make_task_sequence`` seeded by ``--seed``. It runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from nerve_tpu_torch.continual import EWC, MAML, EpisodicMemory, Reptile, SynapticIntelligence
from nerve_tpu_torch.continual.params import detached
from nerve_tpu_torch.models import SuperResolutionNet
from nerve_tpu_torch.utils import data as data_lib


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="nerve_tpu_torch continual training")
    p.add_argument("--strategy", choices=["ewc", "replay", "si", "maml", "reptile"],
                   default="ewc")
    p.add_argument("--num-tasks", type=int, default=5)
    p.add_argument("--epochs-per-task", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ewc-lambda", type=float, default=5000.0)
    p.add_argument("--memory-capacity", type=int, default=1000)
    p.add_argument("--replay-batch", type=int, default=8)
    p.add_argument("--samples-per-task", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def sr_loss(model: SuperResolutionNet, num_frames: int):
    """``loss_fn(params, (lr, hr))``: the mean squared error of the model's
    eval forward, under autograd, with ``params`` in place of its
    parameters; ``lr`` (B, h, w, 3) repeated into a window of ``num_frames``."""

    def loss_fn(params, batch):
        lr, hr = batch
        out = torch.func.functional_call(
            model, dict(params), (data_lib.expand_temporal(lr, num_frames),),
            {"differentiable": True})
        return torch.mean((out.float() - hr.float()) ** 2)

    return loss_fn


def make_model_and_loss(num_frames: int = 3, seed: int = 0, device="cuda"):
    """(model in eval mode, loss_fn, initial parameters): the 16-feature,
    2-RDB flagship in float32 from ``seed``. The BatchNorm statistics stay
    at their initial values, so the continual state is one parameter dict."""
    model = SuperResolutionNet(num_features=16, num_residual_blocks=2,
                               temporal_window=num_frames // 2, device=device,
                               generator=torch.Generator().manual_seed(seed)).eval()
    return model, sr_loss(model, num_frames), detached(dict(model.named_parameters()))


def _device_batch(b, dev):
    return torch.from_numpy(b["lr"]).to(dev), torch.from_numpy(b["hr"]).to(dev)


@torch.no_grad()
def eval_all_tasks(loss_fn, params, tasks, dev):
    """PSNR on every task given: the forgetting measurement."""
    out = {}
    for name, data in tasks:
        mse = float(loss_fn(params, _device_batch(data, dev)))
        out[name] = 10.0 * np.log10(1.0 / max(mse, 1e-12))
    return out


def _adam(params, lr):
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    return leaves, torch.optim.Adam(list(leaves.values()), lr=lr)


def _step(params, opt, loss_fn, batch):
    """One Adam step on ``loss_fn``; returns (loss, gradients)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(params, batch)
    loss.backward()
    opt.step()
    return loss.detach(), {k: v.grad.detach().clone() for k, v in params.items()}


def train_with_penalty(loss_fn, init_params, tasks, args, kind: str, dev):
    """EWC or SI regularised sequential training."""
    params, opt = _adam(init_params, args.lr)
    ewc = EWC(loss_fn, lam=args.ewc_lambda) if kind == "ewc" else None
    si = SynapticIntelligence(lam=1.0) if kind == "si" else None
    rng = np.random.default_rng(args.seed)

    def total_loss(p, batch):
        loss = loss_fn(p, batch)
        if ewc is not None:
            loss = loss + ewc.penalty(p)
        if si is not None:
            loss = loss + si.penalty(p)
        return loss

    for task_id, (name, data) in enumerate(tasks):
        if si is not None:
            si.start_task(params)
        for _ in range(args.epochs_per_task):
            for b in data_lib.batches(data, args.batch_size, rng=rng):
                old = detached(params)
                _loss, grads = _step(params, opt, total_loss, _device_batch(b, dev))
                if si is not None:
                    si.update_importance(old, params, grads)
        batches = [_device_batch(b, dev) for b in data_lib.batches(data, args.batch_size)]
        if ewc is not None:
            ewc.register_task(task_id, params, batches)
        if si is not None:
            si.register_task(params)
        scores = eval_all_tasks(loss_fn, params, tasks[: task_id + 1], dev)
        print(f"[{kind}] task {task_id} ({name}) done; PSNR per seen task: "
              + ", ".join(f"{k}={v:.2f}" for k, v in scores.items()), flush=True)
    return params, eval_all_tasks(loss_fn, params, tasks, dev)


def train_with_replay(loss_fn, init_params, tasks, args, dev):
    """Episodic-replay training: each batch joined by a stratified sample of
    the memory, which keeps up to 50 samples of each finished task."""
    params, opt = _adam(init_params, args.lr)
    memory = EpisodicMemory(capacity=args.memory_capacity, strategy="stratified")
    rng = np.random.default_rng(args.seed)
    for task_id, (name, data) in enumerate(tasks):
        for _ in range(args.epochs_per_task):
            for b in data_lib.batches(data, args.batch_size, rng=rng):
                replay = memory.sample(args.replay_batch)
                if replay is not None:
                    b = {k: np.concatenate([b[k], replay[k]]) for k in ("lr", "hr")}
                _step(params, opt, loss_fn, _device_batch(b, dev))
        for i in range(min(50, len(data["lr"]))):
            memory.store(data["lr"][i], data["hr"][i], {"content_type": name})
        scores = eval_all_tasks(loss_fn, params, tasks[: task_id + 1], dev)
        print(f"[replay] task {task_id} ({name}); PSNR: "
              + ", ".join(f"{k}={v:.2f}" for k, v in scores.items()), flush=True)
    return params, eval_all_tasks(loss_fn, params, tasks, dev)


def task_batches(tasks, dev, part: slice):
    """(lr, hr) stacked over the tasks: (tasks, n, ...) on ``dev``."""
    return tuple(torch.stack([torch.from_numpy(d[k][part]) for _, d in tasks]).to(dev)
                 for k in ("lr", "hr"))


def train_with_meta(loss_fn, init_params, tasks, args, kind: str, dev):
    """MAML (first-order) or Reptile meta-training over the task
    distribution: the first half of each task's samples is its support
    batch, the second its query batch."""
    half = args.samples_per_task // 2
    support = task_batches(tasks, dev, slice(None, half))
    iters = args.epochs_per_task * len(tasks)
    if kind == "maml":
        query = task_batches(tasks, dev, slice(half, None))
        meta = MAML(loss_fn, init_params, inner_lr=args.lr, outer_lr=args.lr,
                    inner_steps=3, first_order=True)
        for it in range(iters):
            loss = meta.train_step(support, query)
            if it % 5 == 0:
                print(f"[maml] iter {it}: meta-loss {loss:.5f}", flush=True)
    else:
        meta = Reptile(loss_fn, init_params, inner_lr=args.lr, outer_lr=0.3, inner_steps=3)
        for _ in range(iters):
            meta.train_step(support)
    params = detached(meta.params)
    return params, eval_all_tasks(loss_fn, params, tasks, dev)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    tasks = data_lib.make_task_sequence(args.seed, args.num_tasks, args.samples_per_task,
                                        lr_size=32)
    model, loss_fn, init_params = make_model_and_loss(seed=args.seed, device=args.device)
    dev = next(model.parameters()).device
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)
    if args.strategy in ("ewc", "si"):
        _, scores = train_with_penalty(loss_fn, init_params, tasks, args, args.strategy, dev)
    elif args.strategy == "replay":
        _, scores = train_with_replay(loss_fn, init_params, tasks, args, dev)
    else:
        _, scores = train_with_meta(loss_fn, init_params, tasks, args, args.strategy, dev)
    print(json.dumps({"final_psnr_per_task": scores}))
    return scores


if __name__ == "__main__":
    main()
