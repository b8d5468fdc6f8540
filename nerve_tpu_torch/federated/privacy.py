"""Differential privacy for federated training (counterpart of
``nerve_tpu/federated/privacy.py``).

DP-SGD in two modes, as in the JAX package:

* ``dp_gradient_transform`` / ``make_private``: one clip of the global norm
  of all gradients to ``max_grad_norm``, then Gaussian noise of std
  σ·C/B on each, applied to the raw gradients before the optimiser's
  moments see them (the order of ``optax.chain(dp, adamw)``). The noise
  comes from an explicit ``torch.Generator`` seeded by ``seed`` on the
  host (the same draws on the CPU and on the card); it is not
  ``jax.random``'s, so the two packages agree in law, not bit for bit.
* ``make_private_loss_grad``: per-sample clipping, the mean of each
  sample's clipped gradient. The JAX package ``vmap``s the per-sample
  gradients; ``torch.func.vmap`` cannot pass through the kernel ops'
  autograd Functions, so here it is a loop of one-sample gradients (as
  ``continual.ewc``'s per-sample Fisher).

Noise calibration and ε accounting keep the reference's simplified formulas.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from nerve_tpu_torch.continual.params import LossFn, Params, batch_len, index, value_and_grad
from nerve_tpu_torch.training import clip_by_global_norm_


@dataclasses.dataclass(frozen=True)
class PrivacyConfig:
    """Parity: nerve_cl/federated/privacy.py:14-20."""

    epsilon: float = 8.0
    delta: float = 1e-5
    max_grad_norm: float = 1.0
    noise_multiplier: float = 1.0


DPConfig = PrivacyConfig  # alias


def compute_noise_multiplier(epsilon: float, delta: float, num_steps: int,
                             batch_size: int = 1, dataset_size: int = 1) -> float:
    """σ = √(2·ln(1.25/δ)) · √steps / ε."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) * math.sqrt(num_steps) / epsilon


def get_privacy_spent(num_steps: int, batch_size: int, dataset_size: int,
                      noise_multiplier: float) -> float:
    """Simplified RDP-style ε = steps · q² / (2σ²), q = B / N."""
    q = batch_size / max(dataset_size, 1)
    if noise_multiplier <= 0:
        return float("inf")
    return num_steps * q**2 / (2.0 * noise_multiplier**2)


def gaussian_like(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """N(0, std²) of ``t``'s shape, drawn on the host from ``generator``,
    on ``t``'s device in its dtype."""
    return (std * torch.randn(t.shape, generator=generator)).to(t.device, t.dtype)


class DPGradientTransform:
    """Global-norm clip + Gaussian noise σ·C/B on a list of gradients, in
    place; ``steps`` counts the calls. The noise std matches the
    reference's σ·C/batch scaling."""

    def __init__(self, max_grad_norm: float = 1.0, noise_multiplier: float = 1.0,
                 batch_size: int = 1, seed: int = 0):
        self.max_grad_norm = max_grad_norm
        self.std = noise_multiplier * max_grad_norm / batch_size
        self.generator = torch.Generator().manual_seed(seed)
        self.steps = 0

    @torch.no_grad()
    def __call__(self, grads: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        clip_by_global_norm_(grads, self.max_grad_norm)
        for g in grads:
            g.add_(gaussian_like(g, self.std, self.generator))
        self.steps += 1
        return grads


def dp_gradient_transform(max_grad_norm: float = 1.0, noise_multiplier: float = 1.0,
                          batch_size: int = 1, seed: int = 0) -> DPGradientTransform:
    """The DP transformation; ``make_private`` applies it before an optimiser."""
    return DPGradientTransform(max_grad_norm, noise_multiplier, batch_size, seed)


class PrivateOptimizer:
    """A ``torch.optim`` optimiser whose ``step`` first runs ``transform``
    on the gradients of all its parameters, in place (a parameter without a
    gradient counts as a zero gradient, as JAX differentiates every leaf)."""

    def __init__(self, optimizer: torch.optim.Optimizer, transform: DPGradientTransform):
        self.optimizer = optimizer
        self.transform = transform

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.transform([p.grad for p in params])
        self.optimizer.step()


def make_private(optimizer: torch.optim.Optimizer, config: Optional[PrivacyConfig] = None,
                 batch_size: int = 1, seed: int = 0) -> PrivateOptimizer:
    """``optimizer`` with DP clip and noise before each step."""
    cfg = config or PrivacyConfig()
    return PrivateOptimizer(optimizer, dp_gradient_transform(
        cfg.max_grad_norm, cfg.noise_multiplier, batch_size, seed))


def make_private_loss_grad(loss_fn: LossFn, max_grad_norm: float = 1.0
                           ) -> Callable[[Params, Any], Tuple[torch.Tensor, Params]]:
    """Per-sample-clipped gradient of a batch loss (true DP-SGD clipping).

    ``loss_fn(params, batch)`` reduces over the batch's leading axis. The
    returned function gives (mean loss, the mean over samples of each
    sample's gradient clipped to global norm ``max_grad_norm``)."""

    def loss_and_clipped_grad(params: Params, batch: Any) -> Tuple[torch.Tensor, Params]:
        n = batch_len(batch)
        losses, acc = [], None
        for i in range(n):
            loss, g = value_and_grad(loss_fn, params, index(batch, slice(i, i + 1)))
            clip_by_global_norm_(list(g.values()), max_grad_norm)
            acc = g if acc is None else {k: acc[k] + v for k, v in g.items()}
            losses.append(loss.detach())
        grads: Dict[str, torch.Tensor] = {k: v / n for k, v in acc.items()}
        return torch.stack(losses).mean(), grads

    return loss_and_clipped_grad
