"""The port's recovery network and its parts against the JAX package's.

Each case builds the flax variables' shapes (``jax.eval_shape``, no init
run), fills every parameter and BatchNorm statistic with seeded non-zero
values (``test_torch_port_models.randomize``), loads them into the port's
module through ``models.bridge`` (strictly) and runs both forwards on the
same seeded numpy inputs, the port's on the CPU. JAX compiles bf16 with
excess precision off, so that it rounds where its source says, as the port
does.

Limits: the ops (pools, ``resize_bicubic``) in float32 within 1e-5 of
max|ref|; modules in float32 within 1e-4 of max|ref|; in bf16 max|Δ| ≤
3.2e-2 and mean|Δ| ≤ 1e-3 (a one-ulp bf16 flip of an O(1) activation,
carried on). The recovery net's pixels outside the mask equal the input's
exactly in both dtypes. Sizes: recovery base 8 channels; frames 32 × 32
and 36 × 52 (whose decoder gives 48 × 64, so the bilinear resize back
runs); the decoder also at an odd input size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu import ops as jops
from nerve_tpu.models import frame_recovery as jfr
from nerve_tpu.models import layers as jlayers
from nerve_tpu_torch import ops
from nerve_tpu_torch.models import frame_recovery, layers
from nerve_tpu_torch.models.bridge import load_flax_variables, recovery_from_flax
from test_torch_port_models import randomize

OP_REL, F32_REL = 1e-5, 1e-4
BF16_MAX, BF16_MEAN = 3.2e-2, 1e-3
# bf16 rounded where the source says; compiled without backend optimisation,
# which costs less time and computes the same numbers.
EXACT = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def seeded_variables(module, *args, seed=0, **kw):
    """The module's variable tree, every leaf seeded (numpy), without
    running its init."""
    shapes = jax.eval_shape(functools.partial(module.init, **kw), jax.random.PRNGKey(0), *args)
    return randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)


def jax_apply(module, variables, *args, **kw):
    fn = jax.jit(functools.partial(module.apply, **kw), compiler_options=EXACT)
    return np.asarray(fn(variables, *args), np.float32)


def check(got, ref, dtype: str, rel=F32_REL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    if dtype == "float32":
        assert d.max() <= rel * np.abs(ref).max(), (d.max(), np.abs(ref).max())
    else:
        assert d.max() <= BF16_MAX and d.mean() <= BF16_MEAN, (d.max(), d.mean())


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# Ops
# --------------------------------------------------------------------------- #
POOLS = {
    "max_pool2d even": (lambda m, x: m.max_pool2d(x, 3, 2, 1), (2, 8, 10, 5)),
    "max_pool2d odd": (lambda m, x: m.max_pool2d(x, 3, 2, 1), (1, 7, 9, 3)),
    "max_pool3d_spatial odd": (lambda m, x: m.max_pool3d_spatial(x), (2, 3, 7, 9, 4)),
    "adaptive_avg_pool2d even": (lambda m, x: m.adaptive_avg_pool2d(x, 8), (2, 16, 24, 3)),
    "adaptive_avg_pool2d uneven": (lambda m, x: m.adaptive_avg_pool2d(x, 8), (1, 13, 21, 3)),
    "resize_bicubic integer 2x": (lambda m, x: m.resize_bicubic(x, (16, 20)), (2, 8, 10, 3)),
    "resize_bicubic non-integer": (lambda m, x: m.resize_bicubic(x, (13, 17)), (1, 8, 10, 3)),
    "resize_bicubic down, uneven": (lambda m, x: m.resize_bicubic(x, (9, 7)), (1, 16, 20, 2)),
}


@pytest.mark.parametrize("case", list(POOLS))
def test_pool_and_resize_match_jax(case):
    fn, shape = POOLS[case]
    x = _x(np.random.default_rng(1), *shape)
    ref = np.asarray(jax.jit(functools.partial(fn, jops))(jnp.asarray(x)))
    got = fn(ops, torch.from_numpy(x))
    check(got, ref, "float32", OP_REL)


def test_max_pools_pad_with_minus_inf():
    """All-negative input: a zero padding would show at the border."""
    x = -1.0 - np.abs(_x(np.random.default_rng(2), 1, 5, 7, 2))
    got = ops.max_pool2d(torch.from_numpy(x), 3, 2, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.max_pool2d(jnp.asarray(x), 3, 2, 1)))
    assert got.max() < 0


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("efficient", [True, False])
def test_residual_block_matches_jax(efficient, dtype):
    jdt, tdt = DTYPES[dtype]
    x = _x(np.random.default_rng(3), 2, 9, 11, 16)
    jmod = jlayers.ResidualBlock(use_efficient=efficient, dtype=jdt)
    variables = seeded_variables(jmod, jnp.asarray(x))
    ref = jax_apply(jmod, variables, jnp.asarray(x).astype(jdt))
    mod = load_flax_variables(layers.ResidualBlock(16, efficient, tdt), variables).eval()
    with torch.inference_mode():
        check(mod(torch.from_numpy(x).to(tdt)), ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_temporal_conv3d_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _x(np.random.default_rng(4), 1, 4, 9, 7, 3)
    jmod = jlayers.TemporalConv3D(16, dtype=jdt)
    variables = seeded_variables(jmod, jnp.asarray(x))
    assert variables["params"]["spatial"]["kernel"].shape == (1, 3, 3, 3, 17)
    ref = jax_apply(jmod, variables, jnp.asarray(x))
    mod = load_flax_variables(layers.TemporalConv3D(3, 16, dtype=tdt), variables).eval()
    with torch.inference_mode():
        check(mod(torch.from_numpy(x)), ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decoder_matches_jax_at_an_odd_size(dtype):
    """Four transposed 4×4/2 convolutions from 3 × 5: flax's kernel laid out
    for ``F.conv_transpose2d`` (flipped, (in, out, k, k)), 48 × 80 out."""
    jdt, tdt = DTYPES[dtype]
    x = _x(np.random.default_rng(5), 2, 3, 5, 32)
    jmod = jfr.Decoder(3, 8, dtype=jdt)
    variables = seeded_variables(jmod, jnp.asarray(x))
    ref = jax_apply(jmod, variables, jnp.asarray(x))
    mod = load_flax_variables(frame_recovery.Decoder(32, 3, 8, tdt), variables).eval()
    with torch.inference_mode():
        got = mod(torch.from_numpy(x))
    assert got.shape == (2, 48, 80, 3)
    check(got, ref, dtype)


# --------------------------------------------------------------------------- #
# The network
# --------------------------------------------------------------------------- #
def _recovery_inputs(h, w, seed=6):
    rng = np.random.default_rng(seed)
    frame = rng.random((2, h, w, 3), np.float32)
    refs = rng.random((2, 4, h, w, 3), np.float32)
    mask = np.zeros((2, h, w, 1), np.float32)
    mask[0, h // 4:h // 2, w // 3:w - 3] = 1.0
    mask[1, 3:h - 5, 2:9] = 1.0
    return frame, refs, mask


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw", [(32, 32), (36, 52)])
def test_frame_recovery_matches_jax(hw, dtype):
    jdt, tdt = DTYPES[dtype]
    frame, refs, mask = _recovery_inputs(*hw)
    jmod = jfr.FrameRecoveryNet(base_channels=8, dtype=jdt)
    jargs = [jnp.asarray(a) for a in (frame, refs, mask)]
    variables = seeded_variables(jmod, *jargs)
    ref = jax_apply(jmod, variables, *jargs)
    model = recovery_from_flax(variables, device="cpu", base_channels=8, dtype=tdt)
    got = model(*(torch.from_numpy(a) for a in (frame, refs, mask)))
    assert got.dtype == torch.float32
    check(got, ref, dtype)
    outside = mask[..., 0] == 0
    np.testing.assert_array_equal(got.numpy()[outside], frame[outside])
    assert np.abs(got.numpy() - frame)[~outside].max() > 1e-2  # recovery ran


def test_frame_recovery_without_mask_is_the_frame_and_inference_only():
    frame, refs, _mask = _recovery_inputs(32, 32)
    model = frame_recovery.FrameRecoveryNet(base_channels=8, device="cpu",
                                            generator=torch.Generator().manual_seed(0)).eval()
    got = model(torch.from_numpy(frame), torch.from_numpy(refs))
    np.testing.assert_array_equal(got.numpy(), frame)
    # In training mode (live BatchNorm) too: a zero mask keeps every pixel.
    trained = model.train()(torch.from_numpy(frame), torch.from_numpy(refs))
    np.testing.assert_array_equal(trained.detach().numpy(), frame)
