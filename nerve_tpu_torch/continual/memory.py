"""Episodic replay memory for continual learning (counterpart of
``nerve_tpu/continual/memory.py``).

Capacity-bounded storage with reservoir / stratified / importance /
diversity / FIFO eviction, stratified and recency-biased sampling,
save/load and stats. Samples live on the host in numpy with their metadata
(content type, importance, access count); ``sample`` returns stacked
fixed-shape arrays, which the caller moves to the device beside its batch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MemorySample:
    """One replay sample."""

    frame_lr: np.ndarray
    frame_hr: np.ndarray
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    importance: float = 1.0
    access_count: int = 0


_STRATEGIES = ("reservoir", "stratified", "importance", "diversity", "fifo")


class EpisodicMemory:
    """Capacity-bounded replay buffer with pluggable eviction.

    Args:
        capacity: max samples (default 1000).
        strategy: one of reservoir | stratified | importance | diversity | fifo.
        seed: RNG seed for reservoir/eviction randomness.
    """

    def __init__(self, capacity: int = 1000, strategy: str = "reservoir", seed: int = 0):
        if strategy not in _STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; use one of {_STRATEGIES}")
        self.capacity = capacity
        self.strategy = strategy
        self._rng = np.random.default_rng(seed)
        self._samples: List[MemorySample] = []
        self.total_seen = 0
        # Where the most recent kept store landed: ("append",), ("replace", i)
        # or ("fifo",) — lets subclasses keep parallel metadata (timestamps)
        # aligned with the sample list across arbitrary-index evictions.
        self._last_store_op: Optional[Tuple] = None

    def __len__(self) -> int:
        return len(self._samples)

    # ------------------------------------------------------------------ #
    # Storage / eviction
    # ------------------------------------------------------------------ #
    def store(
        self,
        frame_lr: np.ndarray,
        frame_hr: np.ndarray,
        metadata: Optional[Dict[str, Any]] = None,
        importance: float = 1.0,
    ) -> bool:
        """Store one sample; returns True if it was kept."""
        sample = MemorySample(
            np.asarray(frame_lr), np.asarray(frame_hr), dict(metadata or {}), importance
        )
        self.total_seen += 1
        self._last_store_op = None

        if len(self._samples) < self.capacity:
            if self.strategy == "diversity" and not self._is_diverse(sample):
                return False
            self._samples.append(sample)
            self._last_store_op = ("append",)
            return True

        return {
            "reservoir": self._evict_reservoir,
            "stratified": self._evict_stratified,
            "importance": self._evict_importance,
            "diversity": self._evict_diversity,
            "fifo": self._evict_fifo,
        }[self.strategy](sample)

    def _replace(self, idx: int, sample: MemorySample) -> None:
        self._samples[idx] = sample
        self._last_store_op = ("replace", int(idx))

    def _evict_reservoir(self, sample: MemorySample) -> bool:
        # Keep-probability capacity/total_seen.
        if self._rng.random() < self.capacity / self.total_seen:
            self._replace(self._rng.integers(0, self.capacity), sample)
            return True
        return False

    def _content_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for s in self._samples:
            ct = s.metadata.get("content_type", "unknown")
            counts[ct] = counts.get(ct, 0) + 1
        return counts

    def _evict_stratified(self, sample: MemorySample) -> bool:
        # Evict from the most-represented content type.
        counts = self._content_counts()
        largest = max(counts, key=counts.get)
        candidates = [
            i
            for i, s in enumerate(self._samples)
            if s.metadata.get("content_type", "unknown") == largest
        ]
        self._replace(self._rng.choice(candidates), sample)
        return True

    def _evict_importance(self, sample: MemorySample) -> bool:
        # Replace the least-important if the new one beats it.
        imps = np.array([s.importance for s in self._samples])
        idx = int(np.argmin(imps))
        if sample.importance > imps[idx]:
            self._replace(idx, sample)
            return True
        return False

    def _feature(self, sample: MemorySample) -> np.ndarray:
        # Mean-colour feature: the per-channel means.
        lr = np.asarray(sample.frame_lr, np.float32)
        return lr.reshape(-1, lr.shape[-1]).mean(0)

    def _is_diverse(self, sample: MemorySample, threshold: float = 0.1) -> bool:
        if not self._samples:
            return True
        f = self._feature(sample)
        feats = np.stack([self._feature(s) for s in self._samples])
        return bool(np.min(np.linalg.norm(feats - f, axis=1)) > threshold)

    def _evict_diversity(self, sample: MemorySample) -> bool:
        if not self._is_diverse(sample):
            return False
        self._replace(self._rng.integers(0, self.capacity), sample)
        return True

    def _evict_fifo(self, sample: MemorySample) -> bool:
        self._samples.pop(0)
        self._samples.append(sample)
        self._last_store_op = ("fifo",)
        return True

    # ------------------------------------------------------------------ #
    # Retrieval
    # ------------------------------------------------------------------ #
    def sample(
        self, batch_size: int, content_type: Optional[str] = None
    ) -> Optional[Dict[str, np.ndarray]]:
        """Sample a replay batch as stacked arrays {'lr', 'hr'}.

        Default: stratified across content types; with ``content_type``:
        filtered sampling. Returns None when empty. Samples WITH replacement
        when the buffer is smaller than batch_size, so the batch shape stays
        fixed.
        """
        if not self._samples:
            return None
        if content_type is not None:
            pool = [
                i
                for i, s in enumerate(self._samples)
                if s.metadata.get("content_type", "unknown") == content_type
            ]
            if not pool:
                return None
            idx = self._rng.choice(pool, size=batch_size, replace=True)
        else:
            idx = self._stratified_indices(batch_size)
        for i in idx:
            self._samples[i].access_count += 1
        lr = np.stack([self._samples[i].frame_lr for i in idx])
        hr = np.stack([self._samples[i].frame_hr for i in idx])
        return {"lr": lr, "hr": hr, "indices": np.asarray(idx)}

    def _stratified_indices(self, batch_size: int) -> np.ndarray:
        by_type: Dict[str, List[int]] = {}
        for i, s in enumerate(self._samples):
            by_type.setdefault(s.metadata.get("content_type", "unknown"), []).append(i)
        types = list(by_type)
        per_type = max(1, batch_size // len(types))
        chosen: List[int] = []
        for t in types:
            k = min(per_type, batch_size - len(chosen))
            if k <= 0:
                break
            chosen.extend(self._rng.choice(by_type[t], size=k, replace=True))
        while len(chosen) < batch_size:
            chosen.append(int(self._rng.integers(0, len(self._samples))))
        return np.asarray(chosen[:batch_size])

    # ------------------------------------------------------------------ #
    # Bookkeeping
    # ------------------------------------------------------------------ #
    def get_stats(self) -> Dict[str, Any]:
        """Parity: memory.py:305-316."""
        return {
            "size": len(self._samples),
            "capacity": self.capacity,
            "total_seen": self.total_seen,
            "strategy": self.strategy,
            "content_distribution": self._content_counts(),
            "mean_importance": float(
                np.mean([s.importance for s in self._samples]) if self._samples else 0.0
            ),
        }

    def clear(self) -> None:
        self._samples = []
        self.total_seen = 0

    def save(self, path: str) -> None:
        """Persist buffer + metadata."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path,
            lr=np.stack([s.frame_lr for s in self._samples]) if self._samples else np.zeros(0),
            hr=np.stack([s.frame_hr for s in self._samples]) if self._samples else np.zeros(0),
            importance=np.array([s.importance for s in self._samples]),
            access_count=np.array([s.access_count for s in self._samples]),
            content_type=np.array(
                [s.metadata.get("content_type", "unknown") for s in self._samples]
            ),
            total_seen=np.array(self.total_seen),
        )

    def load(self, path: str) -> None:
        z = np.load(path, allow_pickle=False)
        self._samples = [
            MemorySample(
                z["lr"][i],
                z["hr"][i],
                {"content_type": str(z["content_type"][i])},
                float(z["importance"][i]),
                int(z["access_count"][i]),
            )
            for i in range(len(z["importance"]))
        ]
        self.total_seen = int(z["total_seen"])


class StreamingEpisodicMemory(EpisodicMemory):
    """Replay memory with recency-biased sampling.

    Weight = (1-rw)·importance + rw·1/(1+age), sampled without replacement
    when possible.
    """

    def __init__(
        self,
        capacity: int = 1000,
        strategy: str = "reservoir",
        recency_weight: float = 0.3,
        seed: int = 0,
    ):
        super().__init__(capacity, strategy, seed)
        self.recency_weight = recency_weight
        self._timestamps: List[int] = []
        self._clock = 0

    def store(self, frame_lr, frame_hr, metadata=None, importance: float = 1.0) -> bool:
        self._clock += 1
        kept = super().store(frame_lr, frame_hr, metadata, importance)
        # Mirror the base class's store operation on the timestamp list so
        # each slot's timestamp tracks the sample actually living there —
        # replacement evictions land at arbitrary indices, not the end
        # (else recency weights would attach to the wrong samples).
        if kept:
            op = self._last_store_op
            if op[0] == "append":
                self._timestamps.append(self._clock)
            elif op[0] == "replace":
                self._timestamps[op[1]] = self._clock
            else:  # fifo: samples shifted down by one, new sample at the end
                self._timestamps.pop(0)
                self._timestamps.append(self._clock)
        return kept

    def clear(self) -> None:
        super().clear()
        self._timestamps = []
        self._clock = 0

    def sample(self, batch_size: int, content_type: Optional[str] = None):
        if not self._samples:
            return None
        ages = self._clock - np.asarray(self._timestamps[: len(self._samples)])
        importance = np.array([s.importance for s in self._samples])
        w = (1 - self.recency_weight) * importance + self.recency_weight / (1.0 + ages)
        if content_type is not None:
            mask = np.array(
                [s.metadata.get("content_type", "unknown") == content_type for s in self._samples]
            )
            if not mask.any():
                return None
            w = w * mask
        p = w / w.sum()
        replace = len(self._samples) < batch_size
        idx = self._rng.choice(len(self._samples), size=batch_size, replace=replace, p=p)
        lr = np.stack([self._samples[i].frame_lr for i in idx])
        hr = np.stack([self._samples[i].frame_hr for i in idx])
        return {"lr": lr, "hr": hr, "indices": idx}
