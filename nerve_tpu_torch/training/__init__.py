"""Training of the SR network (counterpart of ``nerve_tpu/training``).

The JAX package's step is one jitted forward-backward-update program over
flax params and an optax transformation. Here the model's parameters (float32
masters; the forward computes in the model's dtype) and BatchNorm buffers
live in the ``nn.Module``, the optimiser is a ``torch.optim`` one driven by
the optax schedule and clipping rule (``create_optimizer``), and a step is
the model's training-mode forward under autograd (the kernel ops as
``torch.autograd.Function``s, ``ops.dispatch``), ``loss.backward()`` and the
update. ``fit_sr`` is the baseline loop with checkpoint and resume. The
multi-device mesh of the JAX loop is not ported.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from nerve_tpu_torch.config.schema import TrainingConfig
from nerve_tpu_torch.models.layers import batch_stats
from nerve_tpu_torch.utils import data as data_lib
from nerve_tpu_torch.utils.metrics import msssim_levels_for, psnr, vmaf_proxy

F32 = np.float32


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1) as a function of
    the 0-based update count, in float32 in optax's order of operations: a
    linear ramp from ``init_value`` to ``peak_value`` over ``warmup_steps``,
    then a cosine from ``peak_value`` to ``end_value`` ending at
    ``decay_steps`` (which counts the warm-up), constant after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"the cosine needs positive decay steps, got "
                         f"{decay_steps - warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def warmup(count: int) -> F32:
        if warmup_steps <= 0:
            return F32(init_value)
        frac = F32(1) - F32(min(max(count, 0), warmup_steps)) / F32(warmup_steps)
        return F32(init_value - peak_value) * frac + F32(peak_value)

    def cosine(count: int) -> F32:
        c = F32(min(count, cos_steps))
        # cos in float64 rounded once (numpy's float32 cos is off by an ulp).
        decay = F32(0.5) * (F32(1) + F32(math.cos(F32(math.pi) * c / F32(cos_steps))))
        return F32(peak_value) * (F32(1 - alpha) * decay + F32(alpha))

    def schedule(count: int) -> float:
        return float(warmup(count) if count < warmup_steps else cosine(count - warmup_steps))

    return schedule


def lr_schedule(cfg: TrainingConfig, steps_per_epoch: int = 100) -> Callable[[int], float]:
    """The learning rate at each update count: cosine with linear warm-up
    (init 0 where there is a warm-up, so the first update's rate is 0; end
    ``0.01 · lr``; ``decay_steps = epochs · steps_per_epoch``), or constant."""
    total_steps = max(1, cfg.epochs * steps_per_epoch)
    warmup_steps = min(cfg.warmup_epochs * steps_per_epoch, total_steps - 1)
    if cfg.scheduler != "cosine":
        return lambda count: cfg.learning_rate
    return warmup_cosine_decay(0.0 if warmup_steps else cfg.learning_rate, cfg.learning_rate,
                               warmup_steps, total_steps, cfg.learning_rate * 0.01)


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the elements of ``tensors``."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: where the global norm of ``grads`` is
    at least ``max_norm``, scale them by ``max_norm / norm`` in place.
    Returns the norm (on the device, no host sync)."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


@dataclasses.dataclass
class Optimizer:
    """A ``torch.optim`` optimiser over one parameter group, the rate of
    ``schedule(count)`` at each update, gradients clipped to ``clip_norm``
    (0: off) first."""

    torch_opt: torch.optim.Optimizer
    schedule: Callable[[int], float]
    clip_norm: float = 0.0

    def params(self):
        return [p for group in self.torch_opt.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.torch_opt.zero_grad(set_to_none=True)

    def apply(self, count: int) -> None:
        """The update number ``count`` (0-based) from the gradients."""
        if self.clip_norm > 0:
            clip_by_global_norm_([p.grad for p in self.params() if p.grad is not None],
                                 self.clip_norm)
        lr = self.schedule(count)
        for group in self.torch_opt.param_groups:
            group["lr"] = lr
        self.torch_opt.step()

    def state_dict(self) -> dict:
        return self.torch_opt.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.torch_opt.load_state_dict(state)


def create_optimizer(cfg: TrainingConfig, params, steps_per_epoch: int = 100) -> Optimizer:
    """AdamW, Adam or SGD (momentum 0.9) over ``params`` with ``lr_schedule``.
    AdamW decays every parameter (biases and BatchNorm scales too), as
    ``optax.adamw`` does."""
    params = list(params)
    if cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.learning_rate)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.learning_rate, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return Optimizer(opt, lr_schedule(cfg, steps_per_epoch), float(cfg.grad_clip_norm or 0.0))


def pixel_loss(pred: torch.Tensor, target: torch.Tensor, kind: str = "mse") -> torch.Tensor:
    """The pixel loss in float32."""
    d = pred.float() - target.float()
    if kind == "mse":
        return torch.mean(d**2)
    if kind == "l1":
        return torch.mean(torch.abs(d))
    if kind == "charbonnier":
        return torch.mean(torch.sqrt(d**2 + 1e-6))
    raise ValueError(f"unknown pixel loss {kind!r}")


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimiser and
    the number of updates taken."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        """{"params", "opt_state", "batch_stats", "step"} (tensors shared)."""
        return {"params": {k: p.detach() for k, p in self.model.named_parameters()},
                "opt_state": self.optimizer.state_dict(),
                "batch_stats": {k: b.detach() for k, b in batch_stats(self.model).items()},
                "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        params = dict(self.model.named_parameters())
        stats = batch_stats(self.model)
        if set(state["params"]) != set(params) or set(state["batch_stats"]) != set(stats):
            raise KeyError("the train state's parameters or statistics do not match the model")
        for k, v in state["params"].items():
            params[k].copy_(v)
        for k, v in state["batch_stats"].items():
            stats[k].copy_(v)
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])


def create_sr_state(model: nn.Module, cfg: TrainingConfig,
                    steps_per_epoch: int = 100) -> TrainState:
    """A train state at step 0 over ``model``'s current weights."""
    return TrainState(model, create_optimizer(cfg, model.parameters(), steps_per_epoch))


def make_sr_train_step(model: nn.Module, loss_kind: str = "mse",
                       extra_loss: Optional[Callable] = None) -> Callable:
    """The SR train step: (state, lr_frames, hr) → (state, metrics).

    The model's training-mode forward (BatchNorm statistics live and
    updated), the float32 pixel loss plus ``extra_loss(params)`` where given
    (a dict of the named parameters; the continual-learning penalties hook in
    here), backward, update. ``metrics`` holds the loss and the PSNR as
    tensors on the device (no host sync). Profiler ranges ``train.forward``,
    ``train.backward`` and ``train.optimizer`` mark the parts."""
    record = torch.profiler.record_function

    def step(state: TrainState, lr_frames: torch.Tensor, hr: torch.Tensor):
        model.train()
        with record("train.forward"):
            out = model(lr_frames)
            loss = pixel_loss(out, hr, loss_kind)
            if extra_loss is not None:
                loss = loss + extra_loss(dict(model.named_parameters()))
        state.optimizer.zero_grad()
        with record("train.backward"):
            loss.backward()
        with record("train.optimizer"):
            state.optimizer.apply(state.step)
        state.step += 1
        with torch.no_grad():
            metrics = {"loss": loss.detach(), "psnr": psnr(out.detach(), hr)}
        return state, metrics

    return step


def make_sr_eval_step(model: nn.Module) -> Callable:
    """The SR eval step: (state, lr_frames, hr) → {"mse", "psnr", "vmaf"}
    (tensors), the model in eval mode under ``torch.inference_mode``."""

    def evaluate(state: TrainState, lr_frames: torch.Tensor, hr: torch.Tensor):
        model.eval()
        with torch.inference_mode():
            out = model(lr_frames)
            levels = msssim_levels_for(hr.shape[1], hr.shape[2])
            return {"mse": torch.mean((out.float() - hr.float()) ** 2),
                    "psnr": psnr(out, hr), "vmaf": vmaf_proxy(out, hr, levels=levels)}

    return evaluate


def _mean(values) -> float:
    return float(torch.stack(values).float().mean()) if values else float("nan")


def fit_sr(model: nn.Module, train_data: Dict[str, np.ndarray],
           val_data: Dict[str, np.ndarray], cfg: TrainingConfig, num_frames: int,
           seed: int = 0, log_fn: Callable[[str], None] = print, ckpt_manager=None,
           ckpt_every: int = 1) -> Tuple[TrainState, Dict[str, Any]]:
    """The baseline SR training loop on ``model``'s device and weights.

    Datasets with ``"lr_win"`` (N, T, h, w, C) are used as they are, plain
    ``"lr"`` ones repeated over T (``expand_temporal``). With
    ``ckpt_manager`` (``utils.checkpoint.CheckpointManager``) the full state
    (params, optimiser state, BN statistics, step, ``best_psnr``) is saved
    every ``ckpt_every`` epochs, and a run with the same manager resumes
    from the latest epoch; a checkpoint that already covers ``cfg.epochs``
    gives one eval pass. Each epoch shuffles with
    ``np.random.default_rng(seed + start_epoch)``'s stream. The history has
    ``best_psnr``, ``final_psnr``, ``final_vmaf``, ``final_loss`` and
    ``losses``, this run's loss at every step."""
    device = next(model.parameters()).device

    def window(batch):
        if "lr_win" in batch:
            return torch.from_numpy(batch["lr_win"]).to(device)
        return data_lib.expand_temporal(torch.from_numpy(batch["lr"]).to(device), num_frames)

    def evaluate_all():
        val = [eval_step(state, window(b), torch.from_numpy(b["hr"]).to(device))
               for b in data_lib.batches(val_data, cfg.batch_size)]
        return _mean([m["psnr"] for m in val]), _mean([m["vmaf"] for m in val])

    n_train = len(train_data["lr_win" if "lr_win" in train_data else "lr"])
    steps_per_epoch = max(1, n_train // cfg.batch_size)
    state = create_sr_state(model, cfg, steps_per_epoch)
    train_step = make_sr_train_step(model, cfg.losses.pixel_loss_type)
    eval_step = make_sr_eval_step(model)

    start_epoch, best_psnr = 0, -1.0
    if ckpt_manager is not None and ckpt_manager.latest_step() is not None:
        start_epoch = int(ckpt_manager.latest_step())
        template = {**state.state_dict(), "best_psnr": best_psnr}
        try:
            restored = ckpt_manager.restore(template)
        except ValueError:
            del template["best_psnr"]
            restored = {**ckpt_manager.restore(template), "best_psnr": best_psnr}
        state.load_state_dict(restored)
        best_psnr = float(restored["best_psnr"])
        log_fn(f"resumed from checkpoint at epoch {start_epoch} (best_psnr={best_psnr:.2f})")

    rng = np.random.default_rng(seed + start_epoch)
    history: Dict[str, Any] = {"losses": []}
    train_loss = val_psnr = val_vmaf = float("nan")
    if start_epoch >= cfg.epochs:
        log_fn(f"checkpoint epoch {start_epoch} >= cfg.epochs {cfg.epochs}; eval only")
        val_psnr, val_vmaf = evaluate_all()
        best_psnr = max(best_psnr, val_psnr)
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        losses = [train_step(state, window(b), torch.from_numpy(b["hr"]).to(device))[1]["loss"]
                  for b in data_lib.batches(train_data, cfg.batch_size, rng=rng)]
        val_psnr, val_vmaf = evaluate_all()
        history["losses"] += [float(v) for v in losses]
        train_loss = _mean(losses)
        best_psnr = max(best_psnr, val_psnr)
        log_fn(f"epoch {epoch + 1}/{cfg.epochs}: loss={train_loss:.5f} "
               f"val_psnr={val_psnr:.2f}dB ({time.perf_counter() - t0:.1f}s)")
        if ckpt_manager is not None and (epoch + 1) % ckpt_every == 0:
            ckpt_manager.save(epoch + 1, {**state.state_dict(), "best_psnr": best_psnr})
    history.update(best_psnr=best_psnr, final_psnr=val_psnr, final_vmaf=val_vmaf,
                   final_loss=train_loss)
    return state, history
