"""Training of the frame-recovery network.

Counterpart of the only trainer of this net in the JAX package,
``train_ours_jax`` in ``scripts/recovery_protocol.py``: AdamW at weight
decay 1e-5 on every parameter (as ``optax.adamw`` decays, not only the
kernels), the rate ``warmup_cosine_decay(lr, lr, 0, total_steps,
0.01 · lr)``, and the full-frame MSE of the blended output
``frame · (1 - mask) + recovered · mask`` against the clean frame, which
confines the loss to the masked pixels by construction. The model runs in
training mode (live BatchNorm), so its running statistics move at every
step and carry to the next, as the JAX step threads ``batch_stats``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from nerve_tpu_torch.training import Optimizer, TrainState, warmup_cosine_decay

WEIGHT_DECAY = 1e-5


def create_recovery_optimizer(model: nn.Module, lr: float, total_steps: int) -> Optimizer:
    """AdamW over every parameter of ``model`` (decay ``WEIGHT_DECAY``) at
    the cosine rate from ``lr`` to ``0.01 · lr`` over ``total_steps``."""
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=WEIGHT_DECAY)
    return Optimizer(opt, warmup_cosine_decay(lr, lr, 0, total_steps, lr * 0.01))


def create_recovery_state(model: nn.Module, lr: float, total_steps: int) -> TrainState:
    """A train state at step 0 over ``model``'s current weights."""
    return TrainState(model, create_recovery_optimizer(model, lr, total_steps))


def recovery_loss(model: nn.Module, corrupted: torch.Tensor, refs: torch.Tensor,
                  mask: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The training-mode forward's float32 MSE against ``target`` (moves the
    BatchNorm running statistics)."""
    model.train()
    out = model(corrupted, refs, mask)
    return torch.mean((out - target.float()) ** 2)


def make_recovery_train_step(model: nn.Module) -> Callable:
    """(state, corrupted (B, H, W, C), refs (B, T, H, W, C), mask (B, H, W,
    1), target (B, H, W, C)) → (state, {"loss"}): forward, backward, one
    AdamW update. The loss stays on the device (no host sync)."""
    record = torch.profiler.record_function

    def step(state: TrainState, corrupted, refs, mask, target):
        with record("recovery.forward"):
            loss = recovery_loss(model, corrupted, refs, mask, target)
        state.optimizer.zero_grad()
        with record("recovery.backward"):
            loss.backward()
        with record("recovery.optimizer"):
            state.optimizer.apply(state.step)
        state.step += 1
        metrics: Dict[str, torch.Tensor] = {"loss": loss.detach()}
        return state, metrics

    return step
