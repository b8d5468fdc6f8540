"""Flower interoperability adapter (the port's own copy of
``nerve_tpu/federated/flower_compat.py``).

The native transport is the framed-numpy TCP server
(``nerve_tpu_torch.federated.transport``); clients that already speak
Flower drive :class:`nerve_tpu_torch.federated.server.VideoEnhancementStrategy`
through Flower's ``Strategy`` interface::

    import flwr as fl
    from nerve_tpu_torch.federated.flower_compat import make_flower_strategy

    strategy = make_flower_strategy(initial_parameters=get_parameters(params))
    fl.server.start_server(server_address="0.0.0.0:8080", strategy=strategy)

``flwr`` is imported when ``make_flower_strategy`` is called, never when
this module is imported, and its absence raises a clear ImportError then.
Client sampling, adaptive epochs, weighted FedAvg and version retention are
all the strategy's, so both transports share one policy and its tests.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nerve_tpu_torch.federated.server import VideoEnhancementStrategy, weighted_average


def _flwr():
    try:
        import flwr  # noqa: F401
        import flwr.common as common
        import flwr.server.strategy as strategy_mod
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise ImportError(
            "flwr is not installed. The port's own transport "
            "(nerve_tpu_torch.federated.transport + start_server) covers "
            "in-framework federation; install flwr only for interop with "
            "external Flower clients."
        ) from e
    return common, strategy_mod


def make_flower_strategy(
    initial_parameters: Optional[List[np.ndarray]] = None,
    **strategy_kwargs,
):
    """Build a Flower ``Strategy`` backed by VideoEnhancementStrategy.

    ``strategy_kwargs`` are forwarded to
    :class:`~nerve_tpu_torch.federated.server.VideoEnhancementStrategy`
    (fraction_fit, min_fit_clients, keep_last_versions, epoch policies,
    fedprox_mu, ...).
    """
    common, strategy_mod = _flwr()
    inner = VideoEnhancementStrategy(**strategy_kwargs)

    class NerveTorchFlowerStrategy(strategy_mod.Strategy):
        """Flower Strategy façade over the port's FedAvg policy."""

        def __init__(self):
            super().__init__()
            self.inner = inner
            self._initial = initial_parameters

        # -- fit ---------------------------------------------------------- #
        def initialize_parameters(self, client_manager):
            if self._initial is None:
                return None
            return common.ndarrays_to_parameters(self._initial)

        def configure_fit(self, server_round, parameters, client_manager):
            clients = list(client_manager.all().values())
            ids = [getattr(c, "cid", str(i)) for i, c in enumerate(clients)]
            selected, config = self.inner.configure_fit(server_round, ids)
            fit_ins = common.FitIns(parameters, config)
            by_id = dict(zip(ids, clients))
            return [(by_id[cid], fit_ins) for cid in selected]

        def aggregate_fit(self, server_round, results, failures):
            converted = [
                (
                    common.parameters_to_ndarrays(fit_res.parameters),
                    fit_res.num_examples,
                    dict(fit_res.metrics or {}),
                )
                for _, fit_res in results
            ]
            arrays, metrics = self.inner.aggregate_fit(server_round, converted)
            if arrays is None:
                return None, metrics
            return common.ndarrays_to_parameters(arrays), metrics

        # -- evaluate ------------------------------------------------------ #
        def configure_evaluate(self, server_round, parameters, client_manager):
            clients = list(client_manager.all().values())
            ev_ins = common.EvaluateIns(parameters, {"server_round": server_round})
            return [(c, ev_ins) for c in clients]

        def aggregate_evaluate(self, server_round, results, failures):
            if not results:
                return None, {}
            pairs: Sequence[Tuple[int, Dict[str, float]]] = [
                (r.num_examples, {**dict(r.metrics or {}), "loss": r.loss})
                for _, r in results
            ]
            metrics = weighted_average(pairs)
            return metrics.get("loss"), metrics

        def evaluate(self, server_round, parameters):
            return None  # no centralized evaluation (parity: reference has none)

    return NerveTorchFlowerStrategy()
