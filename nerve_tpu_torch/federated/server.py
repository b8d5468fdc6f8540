"""Federated server: FedAvg strategy, in-process trainer, external-client loop.

The port's own copy of ``nerve_tpu/federated/server.py`` (numpy only; it
imports nothing of the JAX package). The reference's design
(nerve_cl/federated/server.py:18-193):

  * :class:`VideoEnhancementStrategy` — sample-count-weighted FedAvg with
    model-version retention (keep last 5, server.py:66-69), per-round fit
    config with adaptive local epochs (5 → 3 after round 50, :77-85), and
    ``max(frac·available, min_fit)`` client sampling (:86-96). Optional
    FedProx: the proximal term is applied client-side via the strategy config.
  * :class:`FederatedTrainer` — in-process multi-client training. The
    reference's equivalent is a stub that never trains or aggregates
    (server.py:166-193, verified); this one runs real local fits and
    aggregation each round. For the one-device FedAvg round over stacked
    client data see :mod:`nerve_tpu_torch.federated.simulation`.
  * :func:`start_server` — synchronous round loop over the socket transport
    for external clients (replacing Flower's gRPC, :113-138).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from nerve_tpu_torch.federated.transport import FLServerTransport

Arrays = List[np.ndarray]


def weighted_average(metrics: Sequence[Tuple[int, Dict[str, float]]]) -> Dict[str, float]:
    """Sample-count-weighted metric aggregation (parity: server.py:99-110)."""
    total = sum(n for n, _ in metrics)
    if total == 0:
        return {}
    keys = set().union(*(m.keys() for _, m in metrics))
    return {
        k: sum(n * m.get(k, 0.0) for n, m in metrics) / total for k in sorted(keys)
    }


class VideoEnhancementStrategy:
    """FedAvg with video-specific round policies (parity: server.py:18-96)."""

    def __init__(
        self,
        fraction_fit: float = 0.1,
        min_fit_clients: int = 2,
        keep_last_versions: int = 5,
        base_local_epochs: int = 5,
        reduced_local_epochs: int = 3,
        epoch_reduction_round: int = 50,
        fedprox_mu: float = 0.0,
        seed: int = 0,
    ):
        self.fraction_fit = fraction_fit
        self.min_fit_clients = min_fit_clients
        self.keep_last_versions = keep_last_versions
        self.base_local_epochs = base_local_epochs
        self.reduced_local_epochs = reduced_local_epochs
        self.epoch_reduction_round = epoch_reduction_round
        self.fedprox_mu = fedprox_mu
        self.model_versions: List[Arrays] = []
        self._rng = random.Random(seed)

    def configure_fit(self, server_round: int,
                      available: Sequence[str]) -> Tuple[List[str], Dict[str, Any]]:
        """Pick clients + per-round config (parity: server.py:73-96)."""
        n = max(int(self.fraction_fit * len(available)), self.min_fit_clients)
        n = min(n, len(available))
        selected = self._rng.sample(list(available), n)
        epochs = (
            self.base_local_epochs
            if server_round <= self.epoch_reduction_round
            else self.reduced_local_epochs
        )
        config = {
            "server_round": server_round,
            "local_epochs": epochs,
            "fedprox_mu": self.fedprox_mu,
        }
        return selected, config

    def aggregate_fit(
        self, server_round: int, results: Sequence[Tuple[Arrays, int, Dict[str, float]]]
    ) -> Tuple[Optional[Arrays], Dict[str, float]]:
        """Sample-count-weighted parameter average (parity: server.py:53-71)."""
        if not results:
            return None, {}
        total = sum(n for _, n, _ in results)
        agg = [np.zeros_like(a, dtype=np.float64) for a in results[0][0]]
        for arrays, n, _ in results:
            w = n / total
            for acc, a in zip(agg, arrays):
                acc += w * np.asarray(a, np.float64)
        aggregated = [
            acc.astype(orig.dtype) for acc, orig in zip(agg, results[0][0])
        ]
        self.model_versions.append(aggregated)
        if len(self.model_versions) > self.keep_last_versions:
            self.model_versions.pop(0)
        metrics = weighted_average([(n, m) for _, n, m in results])
        return aggregated, metrics


class FederatedTrainer:
    """In-process multi-client federated training (REAL, unlike the reference
    stub at server.py:141-193: each round runs actual local fits and FedAvg).
    """

    def __init__(
        self,
        clients: Sequence[Any],
        initial_parameters: Arrays,
        strategy: Optional[VideoEnhancementStrategy] = None,
    ):
        self.clients = list(clients)
        self.parameters = [np.asarray(a) for a in initial_parameters]
        self.strategy = strategy or VideoEnhancementStrategy()
        self.round = 0
        self.history: List[Dict[str, float]] = []

    def train_round(self) -> Dict[str, float]:
        self.round += 1
        ids = list(range(len(self.clients)))
        selected, config = self.strategy.configure_fit(self.round, ids)
        results = []
        for cid in selected:
            arrays, n, metrics = self.clients[cid].fit(self.parameters, config)
            results.append((arrays, n, metrics))
        aggregated, metrics = self.strategy.aggregate_fit(self.round, results)
        if aggregated is not None:
            self.parameters = aggregated
        metrics["num_clients"] = float(len(selected))
        self.history.append(metrics)
        return metrics

    def evaluate_round(self) -> Dict[str, float]:
        results = []
        for client in self.clients:
            loss, n, metrics = client.evaluate(self.parameters, {})
            results.append((n, {"loss": loss, **metrics}))
        return weighted_average(results)

    def run(self, num_rounds: int) -> List[Dict[str, float]]:
        for _ in range(num_rounds):
            self.train_round()
        return self.history


def start_server(
    initial_parameters: Arrays,
    num_rounds: int = 10,
    address: str = "[::]:8080",
    strategy: Optional[VideoEnhancementStrategy] = None,
    min_clients: int = 2,
    wait_timeout: float = 120.0,
) -> Arrays:
    """Run a synchronous federated round loop for external socket clients
    (parity with the reference's Flower server entry, server.py:113-138)."""
    strategy = strategy or VideoEnhancementStrategy(min_fit_clients=min_clients)
    transport = FLServerTransport(address)
    params = [np.asarray(a) for a in initial_parameters]
    try:
        transport.wait_for_clients(min_clients, wait_timeout)
        for rnd in range(1, num_rounds + 1):
            available = transport.available_clients()
            if not available:
                break
            selected, config = strategy.configure_fit(rnd, available)
            results = []
            for cid in selected:
                meta, arrays = transport.request(cid, "fit", config, params)
                results.append((arrays, int(meta["num_samples"]), meta.get("metrics", {})))
            aggregated, metrics = strategy.aggregate_fit(rnd, results)
            if aggregated is not None:
                params = aggregated
            print(f"round {rnd}: {metrics}")
    finally:
        transport.close()
    return params
