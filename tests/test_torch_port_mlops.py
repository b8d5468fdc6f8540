"""The port's MLOps layer (``nerve_tpu_torch.mlops``) against the JAX
package's, on the CPU, on the same data and seeds.

``DriftDetector``: the MMD score (float32 kernel matrices, the port's on a
torch device, JAX's through XLA) within ``MMD_REL`` of max(score, 0.05)
with the same decision. The two differ by summation order in the
distances, which also moves a few near-zero diagonal entries across the
``> 0`` mask of the median heuristic and so the median by a neighbouring
order statistic (measured up to 3.5e-5 of the score at 350 points, 6e-6 at
1000). Scores are held so also where the subsample of 500 points is
drawn (the same ``default_rng`` calls in the same order) and through the
windowed ``update``; the median heuristic bit for bit ``jnp.median`` (the mean of the
two middle values of an even count); KS and PSI (host numpy / scipy, the same
code) equal. ``ModelDriftMonitor``, ``ABTestManager`` (assignments,
analysis, conclusions), ``MetricsExporter`` and ``TrainingLogger`` (round
trips through their files; the wall time aside) equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu import mlops as jmlops
from nerve_tpu_torch import mlops
from nerve_tpu_torch.mlops.drift import median

torch.set_num_threads(2)

MMD_REL = 1e-4


def _mmd_close(a, b):
    return abs(a - b) <= MMD_REL * max(b, 0.05)


def _data(seed, n, d, shift):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, d)), rng.normal(0, 1, (n, d)) + shift


@pytest.mark.parametrize("n", [2, 7, 1000, 99_999, 100_000])
def test_median_is_jnp_median(n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = median(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.item() == float(jnp.median(jnp.asarray(x)))
    if n % 2 == 0:  # torch.median would return the lower middle value
        assert got.item() != torch.median(torch.from_numpy(x)).item()


@pytest.mark.parametrize("method,n,d,shift", [
    *((m, *c) for m in ("ks", "psi") for c in ((400, 5, 0.0), (400, 5, 3.0), (1200, 16, 0.5))),
    ("mmd", 400, 5, 0.0), ("mmd", 400, 5, 3.0), ("mmd", 1200, 16, 0.5),  # 1200: subsampled
])
def test_drift_detector_against_jax(method, n, d, shift):
    ref, cur = _data(n + d, n, d, shift)
    ours = mlops.DriftDetector(method, seed=3, device="cpu")
    theirs = jmlops.DriftDetector(method, seed=3)
    ours.set_reference(ref)
    theirs.set_reference(ref)
    for _ in range(2):  # the second call draws the next subsample
        got, want = ours.detect(cur), theirs.detect(cur)
        assert (got.is_drift, got.threshold, got.method) == (want.is_drift, want.threshold,
                                                             want.method)
        if method == "mmd":
            assert _mmd_close(got.score, want.score), (got.score, want.score)
        else:
            assert (got.score, got.details) == (want.score, want.details)
    if shift == 3.0:
        assert got.is_drift


def test_drift_detector_window_and_errors():
    ref, _ = _data(0, 300, 4, 0.0)
    rng = np.random.default_rng(1)
    ours = mlops.DriftDetector("mmd", window_size=50, device="cpu")
    theirs = jmlops.DriftDetector("mmd", window_size=50)
    ours.set_reference(ref)
    theirs.set_reference(ref)
    outs = []
    for i in range(100):
        s = rng.normal(0, 1, 4) + (2.0 if i >= 50 else 0.0)
        outs.append((ours.update(s), theirs.update(s)))
    done = [(a, b) for a, b in outs if b is not None]
    assert len(done) == 2 and all(a is not None for a, _ in done)
    for a, b in done:
        assert a.is_drift == b.is_drift and _mmd_close(a.score, b.score)
    assert [a.is_drift for a, _ in done] == [False, True]
    with pytest.raises(ValueError):
        mlops.DriftDetector(device="cpu").detect(np.zeros((10, 3)))
    with pytest.raises(ValueError):
        mlops.DriftDetector("nope", device="cpu")


def test_model_drift_monitor_against_jax():
    rng = np.random.default_rng(2)
    for higher in (True, False):
        ours = mlops.ModelDriftMonitor(80.0, window=10, higher_is_better=higher)
        theirs = jmlops.ModelDriftMonitor(80.0, window=10, higher_is_better=higher)
        for v in np.concatenate([rng.normal(80, 1, 15), rng.normal(60, 1, 15)]):
            assert ours.record(v) == theirs.record(v)


def test_ab_testing_against_jax():
    ours, theirs = mlops.ABTestManager(), jmlops.ABTestManager()
    for mgr, cls in ((ours, mlops.ExperimentConfig), (theirs, jmlops.ExperimentConfig)):
        mgr.create_experiment(cls("exp", "model_a", "model_b", traffic_split=0.3))
        mgr.create_experiment(cls("small", "a", "b"))
    users = [f"user{i}" for i in range(1000)]
    assert [ours.assign_variant("exp", u) for u in users] == \
        [theirs.assign_variant("exp", u) for u in users]
    rng = np.random.default_rng(3)
    for variant, mean in (("control", 70.0), ("treatment", 72.0)):
        for v in rng.normal(mean, 3.0, 60):
            for mgr in (ours, theirs):
                mgr.record_metric("exp", variant, "vmaf", v)
                mgr.record_metric("exp", variant, "latency", -v)
    mlops_small = ours.analyze("small")
    assert mlops_small == theirs.analyze("small")
    assert mlops_small["status"] == "insufficient_data"
    for metric in ("vmaf", "latency"):
        assert ours.analyze("exp", metric) == theirs.analyze("exp", metric)
    assert ours.conclude_experiment("exp") == theirs.conclude_experiment("exp")
    assert ours.conclusions["exp"]["winner"] == "model_b"
    assert ours.conclude_experiment("small") == theirs.conclude_experiment("small")


def test_metrics_exporter_and_training_logger_against_jax(tmp_path):
    ours = mlops.MetricsExporter()
    theirs = jmlops.MetricsExporter(namespace="nerve_tpu_port_parity")
    for mgr in (ours, theirs):
        mgr.gauge("abr_parity_return", 41.5, "mean return")
        mgr.gauge("abr_parity_return", 42.25)
        mgr.counter_inc("abr_parity_updates")
        mgr.counter_inc("abr_parity_updates", 2.5)
    assert ours.snapshot() == theirs.snapshot() == {"abr_parity_return": 42.25,
                                                    "abr_parity_updates": 3.5}
    logs = []
    for pkg, sub in ((mlops, "port"), (jmlops, "jax")):
        log = pkg.TrainingLogger(str(tmp_path / sub), experiment="abr")
        log.log(0, {"loss": np.float32(1.5), "entropy": 3}, mode="vectorized")
        log.log(7, {"loss": 0.25})
        logs.append([{k: v for k, v in r.items() if k != "time"} for r in log.read()])
        assert all("time" in r for r in log.read())
    assert logs[0] == logs[1] == [{"step": 0, "loss": 1.5, "entropy": 3.0, "mode": "vectorized"},
                                  {"step": 7, "loss": 0.25}]
    assert mlops.TrainingLogger(str(tmp_path / "empty")).read() == []
