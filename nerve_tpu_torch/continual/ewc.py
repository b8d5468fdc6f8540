"""Elastic Weight Consolidation and Synaptic Intelligence (counterpart of
``nerve_tpu/continual/ewc.py``).

Fisher, optimal parameters and path-integral importances are dicts of the
parameters' names (``continual.params``), detached snapshots held beside
the training state. The Fisher is computed through any
``loss_fn(params, batch)``, so it runs the model's real temporal forward
(on the card, its kernels). ``per_sample=True`` is the per-example
empirical Fisher.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional

import torch

from nerve_tpu_torch.continual.params import (
    LossFn,
    Params,
    batch_len,
    detached,
    index,
    value_and_grad,
    zeros_like,
)


def _sq_grads(loss_fn: LossFn, params: Params, batch: Any) -> Params:
    _loss, g = value_and_grad(loss_fn, params, batch)
    return {k: v.detach() * v.detach() for k, v in g.items()}


def _per_sample_sq_grads(loss_fn: LossFn, params: Params, batch: Any) -> Params:
    # E[g²] over the batch's samples, each a batch of one. The JAX package
    # takes vmap(grad); torch.func.vmap and torch.func.grad cannot pass
    # through the kernel ops' autograd.Functions (no setup_context, and a
    # forward that launches a kernel through ctypes has no vmap rule), so
    # the same quantity is a loop of one-sample gradients.
    n = batch_len(batch)
    acc = zeros_like(params)
    for i in range(n):
        for k, v in _sq_grads(loss_fn, params, index(batch, slice(i, i + 1))).items():
            acc[k] += v
    return {k: v / n for k, v in acc.items()}


def compute_fisher(loss_fn: LossFn, params: Mapping[str, torch.Tensor],
                   batches: Iterable[Any], per_sample: bool = False) -> Params:
    """Diagonal empirical Fisher: the mean over ``batches`` of the squared
    gradient of ``loss_fn`` at ``params``. ``per_sample``: each batch's term
    is the mean of its samples' squared gradients (``loss_fn`` must then
    take a batch of one sample)."""
    params = detached(params)
    fisher = zeros_like(params)
    n = 0
    for batch in batches:
        sq = (_per_sample_sq_grads if per_sample else _sq_grads)(loss_fn, params, batch)
        for k, v in sq.items():
            fisher[k] += v
        n += 1
    if n == 0:
        return fisher
    return {k: v / n for k, v in fisher.items()}


def ewc_quadratic(params: Mapping[str, torch.Tensor], fisher: Mapping[str, torch.Tensor],
                  optimal: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Σ F · (θ − θ*)², differentiable in ``params``."""
    terms = [torch.sum(fisher[k] * (p - optimal[k]) ** 2) for k, p in params.items()]
    return torch.stack(terms).sum()


def _zero(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return next(iter(params.values())).new_zeros(())


class EWC:
    """Elastic Weight Consolidation.

    Modes: 'online' (default) keeps one Fisher and optimum, the Fisher
    merged as ``decay · old + new`` at each task; 'separate' keeps each
    task's pair and sums their penalties.
    """

    def __init__(self, loss_fn: LossFn, lam: float = 5000.0, mode: str = "online",
                 decay: float = 0.999, per_sample_fisher: bool = False):
        if mode not in ("online", "separate"):
            raise ValueError(f"mode must be online|separate, got {mode!r}")
        self.loss_fn = loss_fn
        self.lam = lam
        self.mode = mode
        self.decay = decay
        self.per_sample_fisher = per_sample_fisher
        self.num_tasks = 0
        self._fisher: Optional[Params] = None
        self._optimal: Optional[Params] = None
        self._task_fisher: Dict[int, Params] = {}
        self._task_optimal: Dict[int, Params] = {}

    def register_task(self, task_id: int, params: Mapping[str, torch.Tensor],
                      batches: Iterable[Any]) -> None:
        """Consolidate after a task: its Fisher at ``params`` and ``params``
        as the optimum."""
        fisher = compute_fisher(self.loss_fn, params, batches, self.per_sample_fisher)
        if self.mode == "online":
            if self._fisher is None:
                self._fisher = fisher
            else:
                self._fisher = {k: self.decay * old + fisher[k]
                                for k, old in self._fisher.items()}
            self._optimal = detached(params)
        else:
            self._task_fisher[task_id] = fisher
            self._task_optimal[task_id] = detached(params)
        self.num_tasks += 1

    def penalty(self, params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """λ/2 · Σ F (θ − θ*)²; 0 before any registration."""
        if self.num_tasks == 0:
            return _zero(params)
        if self.mode == "online":
            return self.lam / 2.0 * ewc_quadratic(params, self._fisher, self._optimal)
        total = _zero(params)
        for tid in self._task_fisher:
            total = total + ewc_quadratic(params, self._task_fisher[tid],
                                          self._task_optimal[tid])
        return self.lam / 2.0 * total

    def get_importance_stats(self) -> Dict[str, float]:
        """Mean and max of the current Fisher, and the task count."""
        if self._fisher is None and not self._task_fisher:
            return {"mean": 0.0, "max": 0.0, "num_tasks": 0}
        fisher = (self._fisher if self._fisher is not None
                  else next(iter(self._task_fisher.values())))
        flat = torch.cat([v.reshape(-1) for v in fisher.values()])
        return {"mean": float(flat.mean()), "max": float(flat.max()),
                "num_tasks": self.num_tasks}

    def state_dict(self) -> Dict[str, Any]:
        return {"num_tasks": self.num_tasks, "mode": self.mode, "fisher": self._fisher,
                "optimal": self._optimal, "task_fisher": self._task_fisher,
                "task_optimal": self._task_optimal}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.num_tasks = sd["num_tasks"]
        self._fisher = sd["fisher"]
        self._optimal = sd["optimal"]
        self._task_fisher = sd.get("task_fisher", {})
        self._task_optimal = sd.get("task_optimal", {})


class OnlineEWC(EWC):
    """``EWC`` in mode 'online'."""

    def __init__(self, loss_fn: LossFn, lam: float = 5000.0, decay: float = 0.999, **kw):
        super().__init__(loss_fn, lam, mode="online", decay=decay, **kw)


class SynapticIntelligence:
    """Path-integral importance.

    Call :meth:`update_importance` after every optimiser step with the
    parameters before and after it and the gradients it used: it
    accumulates ``w ← w − g · Δθ``. :meth:`register_task` turns the path
    integral into importances ``ω += max(w, 0) / (Δθ_task² + damping)`` and
    takes the parameters as the anchor.
    """

    def __init__(self, lam: float = 1.0, damping: float = 0.1):
        self.lam = lam
        self.damping = damping
        self._w: Optional[Params] = None
        self._omega: Optional[Params] = None
        self._anchor: Optional[Params] = None
        self._task_start: Optional[Params] = None
        self.num_tasks = 0

    def start_task(self, params: Mapping[str, torch.Tensor]) -> None:
        self._task_start = detached(params)
        self._w = zeros_like(params)

    @torch.no_grad()
    def update_importance(self, old_params: Mapping[str, torch.Tensor],
                          new_params: Mapping[str, torch.Tensor],
                          grads: Mapping[str, torch.Tensor]) -> None:
        """Accumulate one step's path integral."""
        if self._w is None:
            self._w = zeros_like(old_params)
        self._w = {k: w + (-grads[k]) * (new_params[k] - old_params[k])
                   for k, w in self._w.items()}

    @torch.no_grad()
    def register_task(self, params: Mapping[str, torch.Tensor]) -> None:
        """Add this task's importances; ``params`` become the anchor."""
        if self._task_start is None:
            self._task_start = detached(params)
        new_omega = {k: torch.clamp(w, min=0.0)
                     / ((params[k] - self._task_start[k]) ** 2 + self.damping)
                     for k, w in self._w.items()}
        if self._omega is None:
            self._omega = new_omega
        else:
            self._omega = {k: v + new_omega[k] for k, v in self._omega.items()}
        self._anchor = detached(params)
        self._task_start = detached(params)
        self._w = zeros_like(params)
        self.num_tasks += 1

    def penalty(self, params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """λ · Σ ω (θ − θ_anchor)²; 0 before any registration."""
        if self._omega is None:
            return _zero(params)
        return self.lam * ewc_quadratic(params, self._omega, self._anchor)
