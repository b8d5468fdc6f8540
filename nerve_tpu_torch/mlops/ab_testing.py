"""A/B testing for model deployments (the port's own copy of
``nerve_tpu/mlops/ab_testing.py``, host-side numpy and scipy): deterministic
hash-based variant assignment, per-variant metric recording, Welch's t-test + Cohen's d
+ 95% confidence intervals, and winner promotion on the primary quality
metric.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ExperimentConfig:
    name: str
    control_model: str
    treatment_model: str
    traffic_split: float = 0.5  # fraction routed to treatment
    primary_metric: str = "vmaf"
    min_samples: int = 30


class ABTestManager:
    """Runs hash-assigned A/B experiments over model variants."""

    def __init__(self):
        self.experiments: Dict[str, ExperimentConfig] = {}
        self.metrics: Dict[str, Dict[str, Dict[str, List[float]]]] = {}
        self.conclusions: Dict[str, Dict] = {}

    def create_experiment(self, config: ExperimentConfig) -> None:
        self.experiments[config.name] = config
        self.metrics[config.name] = {"control": {}, "treatment": {}}

    def assign_variant(self, experiment: str, user_id: str) -> str:
        """Deterministic md5-bucketed assignment."""
        cfg = self.experiments[experiment]
        digest = hashlib.md5(f"{experiment}:{user_id}".encode()).hexdigest()
        bucket = int(digest[:8], 16) / 0xFFFFFFFF
        return "treatment" if bucket < cfg.traffic_split else "control"

    def record_metric(
        self, experiment: str, variant: str, metric: str, value: float
    ) -> None:
        self.metrics[experiment][variant].setdefault(metric, []).append(float(value))

    def analyze(self, experiment: str, metric: Optional[str] = None) -> Dict:
        """Welch's t-test + Cohen's d + 95% CI."""
        cfg = self.experiments[experiment]
        metric = metric or cfg.primary_metric
        a = np.asarray(self.metrics[experiment]["control"].get(metric, []), np.float64)
        b = np.asarray(self.metrics[experiment]["treatment"].get(metric, []), np.float64)
        if len(a) < 2 or len(b) < 2:
            return {"status": "insufficient_data", "n_control": len(a), "n_treatment": len(b)}

        ma, mb = a.mean(), b.mean()
        va, vb = a.var(ddof=1), b.var(ddof=1)
        na, nb = len(a), len(b)

        se = math.sqrt(va / na + vb / nb)
        t_stat = (mb - ma) / max(se, 1e-12)
        # Welch–Satterthwaite degrees of freedom.
        dof = (va / na + vb / nb) ** 2 / max(
            (va / na) ** 2 / (na - 1) + (vb / nb) ** 2 / (nb - 1), 1e-12
        )
        from scipy import stats

        p_value = 2 * (1 - stats.t.cdf(abs(t_stat), dof))

        pooled_std = math.sqrt(((na - 1) * va + (nb - 1) * vb) / (na + nb - 2))
        cohens_d = (mb - ma) / max(pooled_std, 1e-12)

        ci_half = 1.96 * se
        diff = mb - ma
        return {
            "status": "ok",
            "metric": metric,
            "control_mean": ma,
            "treatment_mean": mb,
            "diff": diff,
            "t_stat": t_stat,
            "p_value": float(p_value),
            "cohens_d": cohens_d,
            "ci_95": (diff - ci_half, diff + ci_half),
            "significant": bool(p_value < 0.05),
            "n_control": na,
            "n_treatment": nb,
        }

    def conclude_experiment(self, experiment: str) -> Dict:
        """Promote the winner on the primary metric."""
        cfg = self.experiments[experiment]
        analysis = self.analyze(experiment)
        if analysis.get("status") != "ok":
            conclusion = {"winner": None, "reason": "insufficient_data", **analysis}
        elif analysis["significant"] and analysis["diff"] > 0:
            conclusion = {"winner": cfg.treatment_model, "reason": "treatment_better", **analysis}
        elif analysis["significant"]:
            conclusion = {"winner": cfg.control_model, "reason": "control_better", **analysis}
        else:
            conclusion = {"winner": cfg.control_model, "reason": "no_significant_difference", **analysis}
        self.conclusions[experiment] = conclusion
        return conclusion
