"""User clustering for personalised federated aggregation.

The port's own copy of ``nerve_tpu/federated/clustering.py`` (numpy only).
Re-design of nerve_cl/federated/clustering.py:13-137. Same feature
engineering — 8-dim profiles from content preferences (5 types), quality
preference, network pattern, device tier — clustered with k-means (k=8).
The reference depends on scikit-learn's KMeans; here k-means++ and Lloyd
iterations are ~40 lines of vectorised NumPy, keeping the subsystem
dependency-free.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

CONTENT_TYPES = ("sports", "animation", "movie", "news", "gaming")
NETWORK_PATTERNS = ("wifi", "5g", "4g", "3g")
DEVICE_TIERS = ("low", "mid", "high")


@dataclasses.dataclass
class UserProfile:
    """Parity: clustering.py:13-21."""

    user_id: str
    content_preferences: Dict[str, float] = dataclasses.field(default_factory=dict)
    quality_preference: float = 0.5
    network_pattern: str = "wifi"
    device_tier: str = "mid"
    update_vector: Optional[np.ndarray] = None


def _kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0):
    """k-means++ init + Lloyd iterations; returns (centroids, labels)."""
    rng = np.random.default_rng(seed)
    n = len(x)
    k = min(k, n)
    # k-means++ seeding
    centroids = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((x[:, None, :] - np.stack(centroids)[None]) ** 2).sum(-1), axis=1
        )
        probs = d2 / max(d2.sum(), 1e-12)
        centroids.append(x[rng.choice(n, p=probs)])
    c = np.stack(centroids)
    labels = np.zeros(n, np.int64)
    for _ in range(iters):
        d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        new_labels = d2.argmin(1)
        if (new_labels == labels).all() and _ > 0:
            break
        labels = new_labels
        for j in range(k):
            members = x[labels == j]
            if len(members):
                c[j] = members.mean(0)
    return c, labels


class UserClustering:
    """K-means clustering over user profiles (parity: clustering.py:24-137)."""

    def __init__(self, num_clusters: int = 8, seed: int = 0):
        self.num_clusters = num_clusters
        self.seed = seed
        self.profiles: Dict[str, UserProfile] = {}
        self.centroids: Optional[np.ndarray] = None
        self.labels: Dict[str, int] = {}

    # ------------------------------------------------------------------ #
    def _extract_features(self, profile: UserProfile) -> np.ndarray:
        """8-dim feature vector (parity: clustering.py:64-84)."""
        content = np.array(
            [profile.content_preferences.get(ct, 0.0) for ct in CONTENT_TYPES],
            np.float32,
        )
        network = NETWORK_PATTERNS.index(profile.network_pattern) / (
            len(NETWORK_PATTERNS) - 1
        )
        tier = DEVICE_TIERS.index(profile.device_tier) / (len(DEVICE_TIERS) - 1)
        return np.concatenate(
            [content, [profile.quality_preference, network, tier]]
        ).astype(np.float32)

    def register_user(self, profile: UserProfile) -> int:
        """Register/refresh a user; returns its cluster (parity: :49-62)."""
        self.profiles[profile.user_id] = profile
        if self.centroids is None:
            self.labels[profile.user_id] = 0
            return 0
        return self.predict(profile)

    def predict(self, profile: UserProfile) -> int:
        if self.centroids is None:
            return 0
        f = self._extract_features(profile)
        label = int(((self.centroids - f) ** 2).sum(-1).argmin())
        self.labels[profile.user_id] = label
        return label

    def update_clusters(self) -> None:
        """Refit k-means over all registered users (parity: :86-104)."""
        if not self.profiles:
            return
        ids = list(self.profiles)
        feats = np.stack([self._extract_features(self.profiles[u]) for u in ids])
        self.centroids, labels = _kmeans(
            feats, self.num_clusters, seed=self.seed
        )
        self.labels = {u: int(l) for u, l in zip(ids, labels)}

    def get_cluster_members(self, cluster: int) -> List[str]:
        return [u for u, l in self.labels.items() if l == cluster]

    def get_cluster_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-cluster aggregate stats (parity: :113-137)."""
        stats: Dict[int, Dict[str, float]] = {}
        for cluster in sorted(set(self.labels.values())):
            members = [self.profiles[u] for u in self.get_cluster_members(cluster)]
            if not members:
                continue
            stats[cluster] = {
                "size": float(len(members)),
                "mean_quality_preference": float(
                    np.mean([m.quality_preference for m in members])
                ),
            }
            for ct in CONTENT_TYPES:
                stats[cluster][f"pref_{ct}"] = float(
                    np.mean([m.content_preferences.get(ct, 0.0) for m in members])
                )
        return stats
