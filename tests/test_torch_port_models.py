"""nerve_tpu_torch.models layers against their flax modules.

Each test initialises the flax module, overwrites every parameter and
BatchNorm statistic with seeded non-zero values (the zero-initialised flow
and upsampler layers would otherwise hide errors), loads the same tree into
the port's module through ``models.bridge``, and compares the two forwards
in float32 at 1e-5 of max|ref|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu.models import layers as jlayers
from nerve_tpu.models import super_resolution as jsr
from nerve_tpu_torch.models import layers, super_resolution
from nerve_tpu_torch.models.bridge import load_flax_variables

REL = 1e-5


def randomize(variables, seed):
    """Every leaf replaced by seeded values of its shape (numpy tree)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        shape = np.shape(x)
        if name.endswith("['var']"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("['mean']"):
            v = rng.standard_normal(shape) * 0.1
        elif name.endswith("['scale']"):
            v = 1.0 + rng.standard_normal(shape) * 0.1
        elif len(shape) == 1:
            v = rng.standard_normal(shape) * 0.05
        else:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            if "upsampler" in name:
                v = v * 0.1  # keep the SR residual inside [0, 1] mostly
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, variables))


def _close(got, ref, rel=REL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.max(np.abs(ref))))


def _pair(flax_mod, port_mod, *inputs, seed=0, **apply_kw):
    """(flax output, port output) on the same randomised variables."""
    j_in = [[jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
            for x in inputs]
    t_in = [[torch.from_numpy(a) for a in x] if isinstance(x, list) else torch.from_numpy(x)
            for x in inputs]
    init = jax.jit(functools.partial(flax_mod.init, **apply_kw))
    variables = randomize(init(jax.random.PRNGKey(0), *j_in), seed)
    ref = jax.jit(functools.partial(flax_mod.apply, **apply_kw))(variables, *j_in)
    load_flax_variables(port_mod, variables)
    with torch.inference_mode():
        got = port_mod.eval()(*t_in)
    return got, ref


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_depthwise_separable_eval_bn():
    rng = np.random.default_rng(1)
    got, ref = _pair(jlayers.DepthwiseSeparableConv(12), layers.DepthwiseSeparableConv(12, 12),
                     _x(rng, 2, 7, 9, 12), train=False)
    _close(got, ref)


def test_cbam():
    rng = np.random.default_rng(2)
    got, ref = _pair(jlayers.CBAM(), layers.CBAM(32), _x(rng, 2, 8, 11, 32))
    _close(got, ref)


def test_temporal_aggregator():
    rng = np.random.default_rng(3)
    frames = [_x(rng, 1, 9, 10, 16) for _ in range(3)]
    got, ref = _pair(jsr.TemporalAggregator(16, 3), super_resolution.TemporalAggregator(16, 3),
                     frames)
    _close(got, ref)


@pytest.mark.parametrize("ds,hw", [(1, (10, 12)), (2, (12, 16)), (2, (11, 14))])
def test_motion_estimator(ds, hw):
    rng = np.random.default_rng(4)
    f1, f2 = _x(rng, 2, *hw, 16), _x(rng, 2, *hw, 16)
    got, ref = _pair(jsr.MotionEstimator(downsample=ds),
                     super_resolution.MotionEstimator(downsample=ds), f1, f2)
    assert float(np.max(np.abs(np.asarray(ref)))) > 1e-2  # the flow is not zero
    _close(got, ref)


def test_rdb_stack():
    rng = np.random.default_rng(5)
    got, ref = _pair(jsr.RDBStack(16, 2), super_resolution.RDBStack(16, 2),
                     _x(rng, 1, 8, 9, 16))
    _close(got, ref)


def test_feature_extractor():
    rng = np.random.default_rng(6)
    got, ref = _pair(jsr.FeatureExtractor(16), super_resolution.FeatureExtractor(3, 16),
                     rng.random((2, 8, 10, 3)).astype(np.float32))
    _close(got, ref)


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_bridge_is_strict(fault):
    mod = jlayers.DepthwiseSeparableConv(8)
    variables = randomize(mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 8))), 0)
    variables = {k: dict(v) for k, v in variables.items()}
    if fault == "missing":
        del variables["params"]["pointwise"]
    elif fault == "unused":
        variables["params"]["extra"] = {"kernel": np.zeros((1,), np.float32)}
    else:
        variables["params"]["pointwise"] = {"kernel": np.zeros((1, 1, 8, 9), np.float32)}
    err = ValueError if fault == "shape" else KeyError
    with pytest.raises(err, match="pointwise" if fault != "unused" else "extra"):
        load_flax_variables(layers.DepthwiseSeparableConv(8, 8), variables)
