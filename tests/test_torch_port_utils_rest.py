"""The rest of the port's ``utils/`` and ``rdb_chain_quantized_apply``
against the JAX package's, on the CPU.

* ``utils.metrics``: ``mae`` and ``temporal_of`` within 1e-5 relative of
  ``nerve_tpu.utils.metrics``'; ``lucas_kanade_flow`` within 1e-4 of
  max|ref| on panning frames of ``make_video_sr_dataset`` (one level at
  32², three at 128²: the pyramid's resize and the box filter's zero edges
  decide the flow at the borders); ``tof`` and ``tlp`` within 1e-5
  relative (``tof`` 1e-4, it averages flows).
* ``utils.profiling``: ``Timer`` sums sections, ``trace`` writes a Chrome
  trace on the CPU, ``timed_chain`` refuses a CPU tensor (CUDA events time
  only the card).
* ``ops.rdb_int8.rdb_chain_quantized_apply``: calibrated scales, the chain
  quantised and applied, against the JAX function (its XLA formulation on
  the CPU) at ``test_torch_port_int8.py``'s chain limit, 4 × the largest
  activation scale; with both quantisations equal, the measured difference
  is 0.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu.ops import rdb_int8 as jr8
from nerve_tpu.utils import metrics as jmetrics
from nerve_tpu_torch.ops import rdb_int8 as r8
from nerve_tpu_torch.utils import data as data_lib
from nerve_tpu_torch.utils import metrics, profiling
from test_torch_port_int8 import _rdb_block


def _video(n, size, seed, frames=3):
    d = data_lib.make_video_sr_dataset(torch.Generator().manual_seed(seed), n, lr_size=size,
                                       scale=1, num_frames=frames, max_shift=2)
    return d["lr_win"]


def _rel(got, ref, rel, what=""):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= rel * abs(ref), (what, got, ref)


@pytest.fixture(scope="module")
def videos():
    pred = _video(2, 32, 0)
    target = np.clip(pred + np.random.default_rng(1).normal(0, 0.03, pred.shape), 0, 1)
    return pred.astype(np.float32), target.astype(np.float32)


def test_mae_and_temporal_of_match_jax(videos):
    pred, target = videos
    _rel(metrics.mae(torch.from_numpy(pred), torch.from_numpy(target)),
         jmetrics.mae(jnp.asarray(pred), jnp.asarray(target)), 1e-5, "mae")
    _rel(metrics.temporal_of(torch.from_numpy(pred), torch.from_numpy(target)),
         jmetrics.temporal_of(jnp.asarray(pred), jnp.asarray(target)), 1e-5, "temporal_of")


@pytest.mark.parametrize("size", [32, 128])
def test_lucas_kanade_flow_matches_jax(size):
    v = _video(1, size, 2)
    f1, f2 = v[:, 0], v[:, 1]
    ref = np.asarray(jax.jit(jmetrics.lucas_kanade_flow)(jnp.asarray(f1), jnp.asarray(f2)))
    got = metrics.lucas_kanade_flow(torch.from_numpy(f1), torch.from_numpy(f2)).numpy()
    assert got.shape == ref.shape == (1, size, size, 2)
    assert np.abs(ref).max() > 0.5  # the pan moves the frames
    d = np.abs(got - ref).max()
    assert d <= 1e-4 * np.abs(ref).max(), (d, np.abs(ref).max())


def test_tof_and_tlp_match_jax(videos):
    pred, target = videos
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    _rel(metrics.tof(tp, tt), jax.jit(jmetrics.tof)(jnp.asarray(pred), jnp.asarray(target)),
         1e-4, "tof")
    _rel(metrics.tlp(tp, tt), jax.jit(jmetrics.tlp)(jnp.asarray(pred), jnp.asarray(target)),
         1e-5, "tlp")
    assert float(metrics.tof(tt, tt)) == 0.0 and float(metrics.tlp(tt, tt)) == 0.0


def test_profiling_timer_and_trace(tmp_path):
    timer = profiling.Timer()
    for _ in range(2):
        with timer.section("a"):
            torch.ones(4).sum()
    with timer.section("b"):
        pass
    assert set(timer.sections) == {"a", "b"} and timer.sections["a"] > 0
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert prof.key_averages()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with pytest.raises(ValueError, match="CUDA tensor"):
        profiling.timed_chain(lambda x: x * 2, torch.ones(4))


@pytest.mark.parametrize("geometry", [(16, 5, 32), (12, 3, 8)])
def test_rdb_chain_quantized_apply_matches_jax(geometry):
    c, layers, growth = geometry
    rng = np.random.default_rng(c + 1)
    plist = [_rdb_block(rng, c, layers, growth) for _ in range(2)]
    x = (rng.standard_normal((1, 9, 13, c)) * 0.5).astype(np.float32)
    jp = [[jnp.asarray(p) for p in ps] for ps in plist]
    tp = [[torch.from_numpy(p) for p in ps] for ps in plist]
    jscales = jax.jit(jr8.calibrate_rdb_chain)(jnp.asarray(x), jp)
    ref = np.asarray(jax.jit(jr8.rdb_chain_quantized_apply, static_argnames="use_pallas")(
        jnp.asarray(x), jp, jscales, use_pallas=False))
    got = r8.rdb_chain_quantized_apply(torch.from_numpy(x), tp,
                                       torch.from_numpy(np.asarray(jscales)))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 4 * float(jnp.max(jscales))
    assert np.abs(got.numpy() - x).max() > 1e-3  # the chain ran
