"""Parameter dicts and batches of the continual-learning rules.

The JAX package's rules map over parameter pytrees; here parameters are a
dict of tensors by ``named_parameters`` name (``Params``) and a loss is
``loss_fn(params, batch) → scalar``, for a module through
``torch.func.functional_call``. A batch is a tensor or a tuple, list or
dict of tensors sharing a leading axis: the sample axis, or in MAML and
Reptile the task axis.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import torch

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Any], torch.Tensor]


def detached(params: Mapping[str, torch.Tensor]) -> Params:
    """A snapshot: each tensor detached and copied."""
    return {k: v.detach().clone() for k, v in params.items()}


def zeros_like(params: Mapping[str, torch.Tensor]) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def batch_len(batch: Any) -> int:
    """The length of the batch's leading axis."""
    if isinstance(batch, torch.Tensor):
        return batch.shape[0]
    if isinstance(batch, Mapping):
        return batch_len(next(iter(batch.values())))
    return batch_len(batch[0])


def index(batch: Any, i) -> Any:
    """The batch at ``i`` (an int or a slice) along its leading axis."""
    if isinstance(batch, torch.Tensor):
        return batch[i]
    if isinstance(batch, Mapping):
        return {k: index(v, i) for k, v in batch.items()}
    return type(batch)(index(v, i) for v in batch)


def value_and_grad(loss_fn: LossFn, params: Mapping[str, torch.Tensor], batch: Any,
                   create_graph: bool = False) -> Tuple[torch.Tensor, Params]:
    """(loss, d loss / d params) at ``params``. A tensor that requires no
    gradient is differentiated as a new leaf; one that does keeps its graph,
    which ``create_graph`` extends through the gradients (a gradient of a
    gradient). A parameter the loss does not reach gets zeros."""
    with torch.enable_grad():
        leaves = {k: v if v.requires_grad else v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                    create_graph=create_graph)
    return loss, {k: torch.zeros_like(v) if g is None else g
                  for (k, v), g in zip(leaves.items(), grads)}

