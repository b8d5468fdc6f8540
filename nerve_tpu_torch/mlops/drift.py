"""Data / model drift detection (counterpart of ``nerve_tpu/mlops/drift.py``).

  * MMD with an RBF kernel (median-heuristic bandwidth, subsampled to 500
    points): the kernel matrices are computed in float32 on the detector's
    device (the card unless ``device="cpu"``);
  * per-feature two-sample Kolmogorov–Smirnov with Bonferroni correction
    (scipy, on the host);
  * Population Stability Index over decile bins (threshold 0.2; numpy, on
    the host);
  * :class:`ModelDriftMonitor`: rolling-mean metric degradation >10% versus
    a baseline triggers a retraining recommendation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from nerve_tpu_torch.models.super_resolution import resolve_device


@dataclasses.dataclass
class DriftResult:
    is_drift: bool
    score: float
    threshold: float
    method: str
    details: Optional[Dict] = None


def median(values: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: the mean of the two middle values
    of an even count, ``(lo + hi) · 0.5`` in the tensor's dtype
    (``torch.median`` returns the lower one)."""
    v = torch.sort(values).values
    n = v.shape[0]
    return (v[(n - 1) // 2] + v[n // 2]) * 0.5


class DriftDetector:
    """Reference-vs-window distribution drift tests (mmd | ks | psi)."""

    def __init__(self, method: str = "mmd", threshold: float = 0.05, window_size: int = 1000,
                 seed: int = 0, device="cuda"):
        if method not in ("mmd", "ks", "psi"):
            raise ValueError(f"unknown method {method!r}")
        self.device = resolve_device(device)
        self.method = method
        self.threshold = threshold
        self.window_size = window_size
        self.reference_data: Optional[np.ndarray] = None
        self.current_window: List[np.ndarray] = []
        self._rng = np.random.default_rng(seed)

    def set_reference(self, data: np.ndarray) -> None:
        self.reference_data = np.asarray(data, np.float64)

    def update(self, sample: np.ndarray) -> Optional[DriftResult]:
        """Add one sample; returns a DriftResult when the window fills."""
        self.current_window.append(np.asarray(sample))
        if len(self.current_window) >= self.window_size:
            window = np.stack(self.current_window)
            self.current_window = []
            return self.detect(window)
        return None

    def detect(self, current: np.ndarray) -> DriftResult:
        if self.reference_data is None:
            raise ValueError("reference data not set")
        current = np.asarray(current, np.float64).reshape(len(current), -1)
        ref = self.reference_data.reshape(len(self.reference_data), -1)
        return {"mmd": self._mmd, "ks": self._ks, "psi": self._psi}[self.method](ref, current)

    # ------------------------------------------------------------------ #
    def _mmd(self, ref: np.ndarray, cur: np.ndarray, max_points: int = 500) -> DriftResult:
        if len(ref) > max_points:
            ref = ref[self._rng.choice(len(ref), max_points, replace=False)]
        if len(cur) > max_points:
            cur = cur[self._rng.choice(len(cur), max_points, replace=False)]
        x = torch.as_tensor(ref, dtype=torch.float32).to(self.device)
        y = torch.as_tensor(cur, dtype=torch.float32).to(self.device)

        def sqdist(a, b):
            return (
                torch.sum(a**2, 1)[:, None] + torch.sum(b**2, 1)[None] - 2 * a @ b.T
            )

        xy = torch.cat([x, y])
        dxy = sqdist(xy, xy)
        # Median heuristic bandwidth.
        med = median(dxy[dxy > 0])
        gamma = 1.0 / torch.clamp_min(med, 1e-8)

        def k(a, b):
            return torch.exp(-gamma * sqdist(a, b))

        mmd2 = torch.mean(k(x, x)) + torch.mean(k(y, y)) - 2 * torch.mean(k(x, y))
        score = float(torch.clamp_min(mmd2, 0.0))
        return DriftResult(score > self.threshold, score, self.threshold, "mmd")

    def _ks(self, ref: np.ndarray, cur: np.ndarray) -> DriftResult:
        from scipy import stats

        n_features = ref.shape[1]
        corrected = self.threshold / n_features  # Bonferroni
        pvals = []
        for f in range(n_features):
            _, p = stats.ks_2samp(ref[:, f], cur[:, f])
            pvals.append(p)
        n_drifted = int(np.sum(np.asarray(pvals) < corrected))
        score = 1.0 - float(np.min(pvals))
        return DriftResult(
            n_drifted > 0,
            score,
            self.threshold,
            "ks",
            {"drifted_features": n_drifted, "min_pvalue": float(np.min(pvals))},
        )

    def _psi(self, ref: np.ndarray, cur: np.ndarray, psi_threshold: float = 0.2) -> DriftResult:
        # Mean PSI over features with decile bins from the reference.
        psis = []
        for f in range(ref.shape[1]):
            edges = np.quantile(ref[:, f], np.linspace(0, 1, 11))
            edges[0], edges[-1] = -np.inf, np.inf
            edges = np.unique(edges)
            if len(edges) < 3:
                psis.append(0.0)
                continue
            p = np.histogram(ref[:, f], edges)[0] / len(ref)
            q = np.histogram(cur[:, f], edges)[0] / len(cur)
            p = np.clip(p, 1e-6, None)
            q = np.clip(q, 1e-6, None)
            psis.append(float(np.sum((p - q) * np.log(p / q))))
        score = float(np.mean(psis))
        return DriftResult(score > psi_threshold, score, psi_threshold, "psi",
                           {"per_feature": psis})


class ModelDriftMonitor:
    """Performance-degradation watchdog.

    Tracks a rolling window of a quality metric; if the rolling mean degrades
    more than ``degradation_threshold`` relative to the baseline, recommends
    retraining.
    """

    def __init__(self, baseline_metric: float, window: int = 100,
                 degradation_threshold: float = 0.10, higher_is_better: bool = True):
        self.baseline = baseline_metric
        self.window = window
        self.degradation_threshold = degradation_threshold
        self.higher_is_better = higher_is_better
        self._values: List[float] = []

    def record(self, value: float) -> Dict[str, object]:
        self._values.append(float(value))
        if len(self._values) > self.window:
            self._values.pop(0)
        rolling = float(np.mean(self._values))
        if self.higher_is_better:
            degradation = (self.baseline - rolling) / abs(self.baseline)
        else:
            degradation = (rolling - self.baseline) / abs(self.baseline)
        should_retrain = degradation > self.degradation_threshold
        return {
            "rolling_mean": rolling,
            "degradation": degradation,
            "should_retrain": should_retrain,
        }
