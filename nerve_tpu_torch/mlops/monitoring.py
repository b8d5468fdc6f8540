"""Metrics export and structured training logs (the port's own copy of
``nerve_tpu/mlops/monitoring.py``):

  * :class:`MetricsExporter` — gauges/counters served on ``/metrics`` via
    ``prometheus_client`` when available, with a no-op in-memory fallback so
    training never depends on the exporter.
  * :class:`TrainingLogger` — JSONL experiment tracking (step, metrics,
    wall-time).

The default namespace is ``nerve_tpu_torch``, so this exporter and the JAX
package's can register the same metric names in one process.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

try:
    from prometheus_client import Counter, Gauge, start_http_server

    _PROM = True
except Exception:
    _PROM = False


class MetricsExporter:
    """Prometheus gauge/counter registry with an in-memory fallback."""

    def __init__(self, port: Optional[int] = None, namespace: str = "nerve_tpu_torch"):
        self.namespace = namespace
        self._gauges: Dict[str, object] = {}
        self._counters: Dict[str, object] = {}
        self._values: Dict[str, float] = {}
        self._prom = _PROM
        if self._prom and port is not None:
            start_http_server(port)

    def gauge(self, name: str, value: float, help_text: str = "") -> None:
        self._values[name] = float(value)
        if self._prom:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name, help_text or name, namespace=self.namespace)
            self._gauges[name].set(value)

    def counter_inc(self, name: str, amount: float = 1.0, help_text: str = "") -> None:
        self._values[name] = self._values.get(name, 0.0) + amount
        if self._prom:
            if name not in self._counters:
                self._counters[name] = Counter(name, help_text or name, namespace=self.namespace)
            self._counters[name].inc(amount)

    def snapshot(self) -> Dict[str, float]:
        return dict(self._values)


class TrainingLogger:
    """Append-only JSONL run log: one line per logged step."""

    def __init__(self, log_dir: str = "logs", experiment: str = "nerve-tpu"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{experiment}.jsonl")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], **extra) -> None:
        record = {
            "step": int(step),
            "time": round(time.time() - self._t0, 3),
            **{k: float(v) for k, v in metrics.items()},
            **extra,
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
