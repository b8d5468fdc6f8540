"""The port's streaming SR slice against the JAX package, end to end.

A narrow SuperResolutionNet (16 features, 2 RDBs, temporal window 1, flow
at half resolution) with every parameter and BatchNorm statistic set to
seeded non-zero values: the zero-initialised flow3 and upsampler layers
would otherwise make the flow 0, the warp the identity and the output the
plain bicubic. Outputs are in [0, 1]; tolerance atol 1e-4 (float32, the
two differ in summation order only). The port's model is built with
``device="cpu"`` (its default is the card). Also: neither the package nor
``chip_smoke.py`` imports JAX, and nothing builds at import.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu.models import streaming as jstream
from nerve_tpu.models.super_resolution import SuperResolutionNet as JaxSR
from nerve_tpu_torch.models import (
    enhance_video_streaming,
    sr_from_flax,
    streaming_prime,
    streaming_step,
)
from test_torch_port_models import randomize

REPO = Path(__file__).resolve().parents[1]
CFG = dict(scale_factor=2, num_features=16, num_residual_blocks=2,
           temporal_window=1, flow_downsample=2)
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    video = np.random.default_rng(0).random((1, 5, 16, 24, 3)).astype(np.float32)
    jmodel = JaxSR(**CFG)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(video[:, :3]))
    variables = randomize(init, seed=1)
    return jmodel, variables, sr_from_flax(variables, device="cpu", **CFG), video


def _np(t):
    return t.float().numpy()


def test_flow_is_not_zero(models):
    _jm, _v, tmodel, video = models
    x = torch.from_numpy(video[:, :2].reshape(2, 16, 24, 3))
    with torch.inference_mode():
        feats = tmodel.extract_features(x)
        flow = tmodel.motion_estimator(feats[:1], feats[1:])
    assert float(flow.abs().max()) > 1e-2


def test_enhance_video_streaming_matches_jax(models):
    jmodel, variables, tmodel, video = models
    ref = np.asarray(jstream.enhance_video_streaming(jmodel, variables, jnp.asarray(video)))
    got = _np(enhance_video_streaming(tmodel, torch.from_numpy(video)))
    assert got.shape == ref.shape == (1, 5, 32, 48, 3)
    assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_streaming_step_packed_matches_jax(models):
    jmodel, variables, tmodel, video = models
    jstep = jax.jit(lambda c, x: jstream.streaming_step(jmodel, variables, c, x, "packed"))
    jcarry = jstream.streaming_prime(jmodel, variables, jnp.asarray(video[:, 0]))
    tcarry = streaming_prime(tmodel, torch.from_numpy(video[:, 0]))
    for t in (1, 2):
        jcarry, ref = jstep(jcarry, jnp.asarray(video[:, t]))
        tcarry, got = streaming_step(tmodel, tcarry, torch.from_numpy(video[:, t]), "packed")
    assert tuple(got.shape) == (1, 32, 48 * 3)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("layout", ["nhwc", "planar"])
def test_batched_forward_matches_jax(models, layout):
    jmodel, variables, tmodel, video = models
    window = video[:, 1:4]
    # SuperResolutionNet.__call__ step by step, to reach its output layouts.
    feats = jmodel.apply(variables, jnp.asarray(window.reshape(3, 16, 24, 3)),
                         method="extract_features")
    nb = jnp.concatenate([feats[0:1], feats[2:3]], axis=0)
    ctr = jnp.concatenate([feats[1:2]] * 2, axis=0)
    warped = jmodel.apply(variables, nb, ctr, method="align_to_center")
    ref = jmodel.apply(variables, [warped[0:1], feats[1:2], warped[1:2]], feats[1:2],
                       jnp.asarray(window[:, 1]), False, layout, method="fuse_from_features")
    got = tmodel(torch.from_numpy(window), output_layout=layout)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=ATOL)


def _run(code: str, env_extra=None) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO), **(env_extra or {})}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


# The serving path's modules, which the walk above must reach and import.
SERVING_MODULES = (
    "nerve_tpu_torch.enhance", "nerve_tpu_torch.models.api",
    "nerve_tpu_torch.models.enhancement_engine", "nerve_tpu_torch.models.frame_recovery",
    "nerve_tpu_torch.models.streaming", "nerve_tpu_torch.models.quantize",
    "nerve_tpu_torch.ops.pool", "nerve_tpu_torch.ops.resize",
    "nerve_tpu_torch.federated", "nerve_tpu_torch.federated.client",
    "nerve_tpu_torch.federated.clustering", "nerve_tpu_torch.federated.common",
    "nerve_tpu_torch.federated.flower_compat", "nerve_tpu_torch.federated.privacy",
    "nerve_tpu_torch.federated.server", "nerve_tpu_torch.federated.simulation",
    "nerve_tpu_torch.federated.transport", "nerve_tpu_torch.train_federated",
    "nerve_tpu_torch.diag.federated",
    "nerve_tpu_torch.parallel", "nerve_tpu_torch.parallel.collectives",
    "nerve_tpu_torch.parallel.dryrun", "nerve_tpu_torch.parallel.launch",
    "nerve_tpu_torch.parallel.mesh", "nerve_tpu_torch.parallel.spatial",
    "nerve_tpu_torch.diag.spatial",
)


def test_port_imports_no_jax():
    code = (
        "import importlib, importlib.util, pkgutil, sys, nerve_tpu_torch\n"
        "for m in pkgutil.walk_packages(nerve_tpu_torch.__path__, 'nerve_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'nerve_tpu', 'flwr'))\n"
        "assert not bad, bad\n"
        f"missing = sorted(set({SERVING_MODULES!r}) - set(sys.modules))\n"
        "assert not missing, missing\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def test_every_module_imports_without_nvcc_or_gpu():
    code = (
        "import importlib, pkgutil, nerve_tpu_torch\n"
        "from nerve_tpu_torch.ops import _build\n"
        "mods = [m.name for m in pkgutil.walk_packages(nerve_tpu_torch.__path__, 'nerve_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert _build._lib is None\n"
        "assert len(mods) >= 19, mods\n"
    )
    proc = _run(code, {"PATH": "/nonexistent", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
