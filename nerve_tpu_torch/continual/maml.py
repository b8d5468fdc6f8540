"""Meta-learning: MAML, FOMAML, Reptile and ContentAdaptiveMAML (counterpart
of ``nerve_tpu/continual/maml.py``).

The inner loop is SGD on a dict of parameters (``continual.params``), each
step's gradient taken by ``torch.autograd.grad``. Second-order MAML keeps
the graph of those gradients (``create_graph=True``), so the meta-gradient
differentiates through them, as ``jax.grad`` does through the JAX package's
unrolled inner loop; through the kernel ops that is the plain versions'
second derivative (``ops.dispatch.recompute_vjp``). ``first_order=True``
takes the inner gradients without a graph, as ``stop_gradient`` does: the
meta-gradient is then the query gradient at the adapted parameters.

Where the JAX package maps a step over the task axis with ``vmap``, a loop
over the tasks runs here: MAML backpropagates each task's share of the mean
query loss in turn (the gradient of the mean), so one task's graph is alive
at a time. The outer optimiser is ``torch.optim.Adam`` (``optax.adam``'s
defaults). After ``MAML.train_step`` each parameter's ``.grad`` holds the
meta-gradient of that step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch

from nerve_tpu_torch.continual.params import (
    LossFn,
    Params,
    batch_len,
    detached,
    index,
    value_and_grad,
)


def make_inner_sgd(loss_fn: LossFn, inner_lr: float, inner_steps: int,
                   first_order: bool = False) -> Callable[..., Params]:
    """``adapt(params, batch, lr=inner_lr)``: ``inner_steps`` SGD steps on
    ``batch`` from ``params``, differentiable in ``params`` and ``lr`` (a
    float or a tensor); with ``first_order`` the inner gradients carry no
    graph."""

    def adapt(params: Mapping[str, torch.Tensor], batch: Any, lr=inner_lr) -> Params:
        p = dict(params)
        with torch.enable_grad():
            for _ in range(inner_steps):
                _loss, g = value_and_grad(loss_fn, p, batch, create_graph=not first_order)
                p = {k: v - lr * g[k] for k, v in p.items()}
        return p

    return adapt


def _trainable(params: Mapping[str, torch.Tensor]) -> Params:
    return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}


class MAML:
    """Model-Agnostic Meta-Learning.

    ``train_step(support, query)``: batches whose leaves have a leading task
    axis; the meta-loss is the mean over tasks of the query loss at the
    parameters adapted on the task's support batch.
    """

    def __init__(self, loss_fn: LossFn, params: Mapping[str, torch.Tensor],
                 inner_lr: float = 0.01, outer_lr: float = 1e-3, inner_steps: int = 5,
                 first_order: bool = False):
        self.loss_fn = loss_fn
        self.params = _trainable(params)
        self.inner_lr = inner_lr
        self.outer_lr = outer_lr
        self.inner_steps = inner_steps
        self.first_order = first_order
        self.opt = torch.optim.Adam(list(self.params.values()), lr=outer_lr)
        self._adapt = make_inner_sgd(loss_fn, inner_lr, inner_steps, first_order)

    def adapt(self, batch: Any, params: Optional[Mapping[str, torch.Tensor]] = None) -> Params:
        """Fast adaptation on ``batch``: new parameters (detached)."""
        return detached(self._adapt(detached(self.params if params is None else params), batch))

    def train_step(self, support_batches: Any, query_batches: Any) -> float:
        """One meta-update over the tasks; returns the mean query loss."""
        n = batch_len(support_batches)
        self.opt.zero_grad(set_to_none=True)
        total = 0.0
        for t in range(n):
            adapted = self._adapt(self.params, index(support_batches, t))
            loss = self.loss_fn(adapted, index(query_batches, t)) / n
            loss.backward()
            total += float(loss.detach())
        self.opt.step()
        return total

    def state_dict(self) -> Dict[str, Any]:
        return {"params": detached(self.params), "opt_state": self.opt.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        with torch.no_grad():
            for k, v in sd["params"].items():
                self.params[k].copy_(v)
        self.opt.load_state_dict(sd["opt_state"])


class FOMAML(MAML):
    """First-order MAML."""

    def __init__(self, loss_fn, params, inner_lr=0.01, outer_lr=1e-3, inner_steps=5):
        super().__init__(loss_fn, params, inner_lr, outer_lr, inner_steps, first_order=True)


class Reptile:
    """Reptile: θ ← θ + outer_lr · (mean over tasks of θ'_task − θ), θ'_task
    the first-order inner SGD on the task's batch."""

    def __init__(self, loss_fn: LossFn, params: Mapping[str, torch.Tensor],
                 inner_lr: float = 0.01, outer_lr: float = 0.1, inner_steps: int = 5):
        self.loss_fn = loss_fn
        self.params = detached(params)
        self.inner_lr = inner_lr
        self.outer_lr = outer_lr
        self.inner_steps = inner_steps
        self._adapt = make_inner_sgd(loss_fn, inner_lr, inner_steps, first_order=True)

    def train_step(self, task_batches: Any) -> None:
        """One meta-update over the tasks (leading task axis)."""
        n = batch_len(task_batches)
        adapted = [self.adapt(index(task_batches, t)) for t in range(n)]
        self.params = {k: p + self.outer_lr * (torch.stack([a[k] for a in adapted]).mean(0) - p)
                       for k, p in self.params.items()}

    def adapt(self, batch: Any, params: Optional[Mapping[str, torch.Tensor]] = None) -> Params:
        return detached(self._adapt(self.params if params is None else params, batch))

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self.params}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.params = detached(sd["params"])


class ContentAdaptiveMAML(MAML):
    """MAML with a learned inner learning rate per content type.

    Each content type keeps a log-rate (float32, ``log(inner_lr)`` at the
    start); adaptation to a content type runs the inner SGD at its rate, and
    ``meta_update_content_lr`` descends the query loss after adaptation in
    the log-rate, differentiating through the inner loop.
    """

    def __init__(self, loss_fn: LossFn, params: Mapping[str, torch.Tensor],
                 content_types: Sequence[str] = ("sports", "animation", "movie", "news",
                                                 "gaming"),
                 inner_lr: float = 0.01, outer_lr: float = 1e-3, inner_steps: int = 5,
                 first_order: bool = False):
        super().__init__(loss_fn, params, inner_lr, outer_lr, inner_steps, first_order)
        self.content_types = tuple(content_types)
        dev = next(iter(self.params.values())).device
        self.log_inner_lrs = {ct: self._log_lr(dev) for ct in self.content_types}

    def _log_lr(self, dev) -> torch.Tensor:
        return torch.log(torch.tensor(self.inner_lr, dtype=torch.float32, device=dev))

    def adapt_to_content(self, batch: Any, content_type: str) -> Params:
        """Fast adaptation at the content type's rate (detached)."""
        log_lr = self.log_inner_lrs.get(content_type)
        if log_lr is None:
            log_lr = self._log_lr(next(iter(self.params.values())).device)
        return detached(self._adapt(detached(self.params), batch, lr=torch.exp(log_lr)))

    def meta_update_content_lr(self, content_type: str, support: Any, query: Any) -> float:
        """One descent step of the content type's log-rate on the query loss
        after adaptation on ``support``; returns that loss."""
        log_lr = self.log_inner_lrs[content_type].detach().requires_grad_(True)
        with torch.enable_grad():
            adapted = self._adapt(detached(self.params), support, lr=torch.exp(log_lr))
            loss = self.loss_fn(adapted, query)
            (g,) = torch.autograd.grad(loss, [log_lr])
        self.log_inner_lrs[content_type] = (log_lr - self.outer_lr * g).detach()
        return float(loss.detach())

