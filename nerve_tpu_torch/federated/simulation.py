"""One-device federated simulation: a FedAvg round over stacked client data
(counterpart of ``nerve_tpu/federated/simulation.py``).

The JAX package lays the client population on a ('client',) mesh axis and
runs a round as one ``shard_map`` program: each shard ``vmap``s local SGD
over its clients and FedAvg is a weighted ``psum``. Here one device holds
every client, so a round is a loop over the clients (``torch.func.vmap``
cannot pass the kernel ops' autograd Functions): each runs ``local_steps``
full-batch SGD steps from the global parameters, its delta is clipped to
``max_grad_norm`` when ``privacy`` is set (DP-FedAvg), and the
sample-weighted sum of the deltas over the total weight is the update
(``fedavg_reduce``, the one cross-client reduction, which a multi-process
version would make an ``all_reduce``), with N(0, (σ·C/total_w)²) noise
added under ``privacy``. The noise comes from a ``torch.Generator`` seeded
by ``seed`` on the host, not from ``jax.random``.

Parameters are a dict of tensors by ``named_parameters`` name and a loss
is ``loss_fn(params, client_batch)`` (``continual.params``); ``client_data``
is a tensor or a tuple, list or dict of tensors whose leading axis is the
client.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nerve_tpu_torch.continual.params import (
    LossFn,
    Params,
    batch_len,
    detached,
    index,
    value_and_grad,
)
from nerve_tpu_torch.federated.privacy import PrivacyConfig, gaussian_like
from nerve_tpu_torch.training import clip_by_global_norm_, global_norm


def _local_sgd(loss_fn: LossFn, params: Params, data: Any, steps: int, lr: float) -> Params:
    """Client-local adaptation: ``steps`` full-batch SGD steps."""
    for _ in range(steps):
        _loss, g = value_and_grad(loss_fn, params, data)
        params = {k: (p - lr * g[k]).detach() for k, p in params.items()}
    return params


def client_deltas(loss_fn: LossFn, params: Params, client_data: Any, local_steps: int,
                  local_lr: float, privacy: Optional[PrivacyConfig] = None) -> List[Params]:
    """Each client's model delta after its local SGD, clipped to global
    norm ``privacy.max_grad_norm`` when ``privacy`` is set."""
    deltas: List[Params] = []
    for c in range(batch_len(client_data)):
        adapted = _local_sgd(loss_fn, params, index(client_data, c), local_steps, local_lr)
        delta = {k: adapted[k] - params[k] for k in params}
        if privacy is not None:
            clip_by_global_norm_(list(delta.values()), privacy.max_grad_norm)
        deltas.append(delta)
    return deltas


def fedavg_reduce(deltas: Sequence[Params], weights: torch.Tensor
                  ) -> Tuple[Params, torch.Tensor]:
    """(Σ_c w_c · δ_c / Σ_c w_c, Σ_c w_c): the sample-weighted FedAvg of the
    clients' deltas, in float32."""
    total_w = weights.sum()
    agg = {k: sum(w * d[k] for w, d in zip(weights, deltas)) / total_w for k in deltas[0]}
    return agg, total_w


def build_fedavg_round(loss_fn: LossFn, local_steps: int = 5, local_lr: float = 1e-3,
                       privacy: Optional[PrivacyConfig] = None):
    """One federated round as a function.

    Returns ``round_fn(params, client_data, weights, generator) →
    (new_params, {"update_norm", "total_weight"})``: ``weights`` is the
    (num_clients,) float32 sample counts on the parameters' device,
    ``generator`` draws the DP noise."""

    def round_fn(params: Params, client_data: Any, weights: torch.Tensor,
                 generator: torch.Generator) -> Tuple[Params, Dict[str, torch.Tensor]]:
        deltas = client_deltas(loss_fn, params, client_data, local_steps, local_lr, privacy)
        agg, total_w = fedavg_reduce(deltas, weights)
        if privacy is not None:
            std = privacy.noise_multiplier * privacy.max_grad_norm / float(total_w)
            agg = {k: v + gaussian_like(v, std, generator) for k, v in agg.items()}
        new_params = {k: params[k] + agg[k] for k in params}
        return new_params, {"update_norm": global_norm(list(agg.values())),
                            "total_weight": total_w}

    return round_fn


class MeshFederatedSimulation:
    """Stateful wrapper: non-IID client datasets on one device, round loop.

    Args:
        loss_fn: (params, client_data) → scalar.
        params: initial global parameters (a dict of tensors).
        client_data: a batch whose leading axis is the client.
        weights: per-client sample counts (defaults to uniform).
        mesh: the JAX package's client mesh; one device has none, so only
            ``None`` is taken.
        local_steps / local_lr: each client's full-batch SGD.
        privacy: if set, client deltas are clipped to ``max_grad_norm`` and
            the aggregate gets N(0, (σ·C/total_w)²) noise (DP-FedAvg).
    """

    def __init__(self, loss_fn: LossFn, params: Params, client_data: Any,
                 weights: Optional[np.ndarray] = None, mesh=None, local_steps: int = 5,
                 local_lr: float = 1e-3, privacy: Optional[PrivacyConfig] = None,
                 seed: int = 0):
        if mesh is not None:
            raise ValueError("the one-device simulation takes no mesh")
        num_clients = batch_len(client_data)
        self.params = detached(params)
        dev = next(iter(self.params.values())).device
        self.client_data = client_data
        self.weights = torch.as_tensor(
            weights if weights is not None else np.ones(num_clients), dtype=torch.float32,
            device=dev)
        if self.weights.shape != (num_clients,):
            raise ValueError(f"{tuple(self.weights.shape)} weights for {num_clients} clients")
        self.generator = torch.Generator().manual_seed(seed)
        self._round = build_fedavg_round(loss_fn, local_steps, local_lr, privacy)
        self.history: List[Dict[str, float]] = []

    def run_round(self) -> Dict[str, float]:
        self.params, metrics = self._round(self.params, self.client_data, self.weights,
                                           self.generator)
        metrics = {k: float(v) for k, v in metrics.items()}
        self.history.append(metrics)
        return metrics

    def run(self, num_rounds: int) -> List[Dict[str, float]]:
        for _ in range(num_rounds):
            self.run_round()
        return self.history


def dryrun_fedavg(device="cuda") -> Dict[str, float]:
    """A tiny DP FedAvg round of a linear model, 2 clients, on ``device``
    (the one-device counterpart of ``dryrun_fedavg_mesh``)."""
    dev = torch.device(device)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((4, 4), generator=g).to(dev), "b": torch.zeros(4, device=dev)}

    def loss_fn(p, batch):
        x, y = batch
        return torch.mean((x @ p["w"] + p["b"] - y) ** 2)

    data = tuple(torch.randn((2, 8, 4), generator=g).to(dev) for _ in range(2))
    sim = MeshFederatedSimulation(loss_fn, params, data, local_steps=2, local_lr=0.05,
                                  privacy=PrivacyConfig(noise_multiplier=0.01))
    m = sim.run_round()
    if not np.isfinite(m["update_norm"]):
        raise AssertionError(f"dry-run FedAvg round: {m}")
    return m
