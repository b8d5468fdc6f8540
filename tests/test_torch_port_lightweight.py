"""The port's lightweight SR path against the JAX package.

The conv chain with depthwise layers, the planar chain, the fused
depthwise-separable block and ``LightweightSuperResolution`` (in all three
output layouts), each on the same numpy-seeded inputs and weights as its
JAX counterpart. The models' variables are randomised, tail and BatchNorm
statistics included: the zero-initialised tail would otherwise make the
output the plain bicubic. Tolerances: float32 at 1e-5 of max|ref| (the two
differ in summation order only); the bfloat16 chains bit-exact (both round
each sum and each layer's output once to bfloat16, and these shapes leave
no float32 sum near a rounding boundary); the whole bfloat16 model within
2⁻⁸. The JAX references are compiled with ``xla_allow_excess_precision``
off: by default XLA on the CPU may keep a bfloat16 intermediate in float32
where the source rounds it, which the port (and the un-jitted JAX code)
does not do. The Pallas kernels run in interpret mode at the tolerances of
their own tests (``tests/test_conv_chain.py``, ``tests/test_planar_chain.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nerve_tpu import ops as jops
from nerve_tpu.models import layers as jlayers
from nerve_tpu.models import super_resolution as jsr
from nerve_tpu.ops import conv_chain as jcc
from nerve_tpu.ops import planar_chain as jpc
from nerve_tpu_torch import ops
from nerve_tpu_torch.models import LightweightSuperResolution, lightweight_from_flax, layers
from nerve_tpu_torch.models.bridge import load_flax_variables
from nerve_tpu_torch.ops import dispatch
from test_torch_port_models import randomize

REL = 1e-5
exact_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _body(rng, c=8, cin=3, cout=12, blocks=2):
    """A lightweight-shaped chain: head 3×3, (dw3, 1×1) blocks, tail 3×3."""
    p = [(rng.standard_normal((3, 3, cin, c)) / np.sqrt(9 * cin), rng.standard_normal(c) * 0.1,
          "relu")]
    for _ in range(blocks):
        p.append((rng.standard_normal((3, 3, c)) / 3, rng.standard_normal(c) * 0.1, "none"))
        p.append((rng.standard_normal((1, 1, c, c)) / np.sqrt(c), rng.standard_normal(c) * 0.1,
                  "relu"))
    p.append((rng.standard_normal((3, 3, c, cout)) / np.sqrt(9 * c),
              rng.standard_normal(cout) * 0.1, "none"))
    return [(w.astype(np.float32), b.astype(np.float32), a) for w, b, a in p]


def _jax_args(params):
    return ([jnp.asarray(w) for w, _, _ in params], [jnp.asarray(b) for _, b, _ in params],
            tuple(a for *_, a in params))


def _torch_params(params):
    return [(torch.from_numpy(w), torch.from_numpy(b), a) for w, b, a in params]


def _exact_or_close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=REL * float(np.abs(ref).max()))


class TestDepthwiseChain:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_xla(self, dtype):
        rng = np.random.default_rng(20)
        params = _body(rng)
        x = rng.random((1, 12, 20, 3)).astype(np.float32)
        jdt, tdt = DTYPES[dtype]
        ref = exact_jit(jcc._chain_xla, static_argnums=3)(jnp.asarray(x, jdt), *_jax_args(params))
        _exact_or_close(ops.conv_chain_apply(torch.from_numpy(x).to(tdt), _torch_params(params)),
                        ref, dtype)

    def test_plain_matches_pallas_interpret(self):
        rng = np.random.default_rng(21)
        params = _body(rng)
        x = rng.random((1, 12, 20, 3)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ref = jcc._chain_pallas(jnp.asarray(x), *_jax_args(params), th=8, tw=16)
        got = ops.conv_chain_apply(torch.from_numpy(x), _torch_params(params))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)

    def test_cpu_counts_no_launch(self):
        rng = np.random.default_rng(22)
        dispatch.reset_launches()
        ops.conv_chain_apply(torch.zeros(1, 4, 5, 3), _torch_params(_body(rng)))
        ops.planar_chain_apply(torch.zeros(1, 3, 4, 5), _torch_params(_body(rng)))
        assert not any(dispatch.launches.values())


class TestPlanarChain:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_planar_xla(self, dtype):
        rng = np.random.default_rng(23)
        params = _body(rng)
        x = rng.random((2, 3, 9, 14)).astype(np.float32)
        jdt, tdt = DTYPES[dtype]
        ref = exact_jit(jpc._planar_xla, static_argnums=3)(jnp.asarray(x, jdt), *_jax_args(params))
        got = ops.planar_chain_apply(torch.from_numpy(x).to(tdt), _torch_params(params))
        assert got.is_contiguous()
        _exact_or_close(got, ref, dtype)

    def test_plain_matches_pallas_interpret(self):
        rng = np.random.default_rng(24)
        params = _body(rng)
        x = rng.random((1, 3, 12, 130)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ref = jpc._planar_pallas(jnp.asarray(x), *_jax_args(params), th=8, tw=128,
                                     fit_vmem=False)
        got = ops.planar_chain_apply(torch.from_numpy(x), _torch_params(params))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-6)

    def test_rejects_nhwc_input(self):
        rng = np.random.default_rng(25)
        with pytest.raises(ValueError, match="axis 1"):
            ops.planar_chain_apply(torch.zeros(1, 4, 5, 3), _torch_params(_body(rng)))

    def test_weight_pack_layout(self):
        rng = np.random.default_rng(26)
        params = _torch_params(_body(rng, c=20))
        wpack, table = ops.planar_chain.pack_planar_chain(params, torch.bfloat16, "cpu")
        table = table.reshape(-1, 6).tolist()
        # The bfloat16 head (3 input channels) has its taps folded into K (kind 3).
        assert [row[:4] for row in table] == [[3, 3, 20, 1], [2, 20, 20, 0], [1, 20, 20, 1],
                                              [2, 20, 20, 0], [1, 20, 20, 1], [0, 20, 12, 0]]
        assert all(off % 16 == 0 for row in table for off in row[4:])
        # The head: bfloat16 [32][32 + 8], column c * 9 + tap; tap 4, in channel 2, out 5.
        head = wpack[:32 * 40 * 2].view(torch.bfloat16).reshape(32, 40)
        assert head[5, 2 * 9 + 4] == params[0][0][1, 1, 2, 5].bfloat16()
        assert not head[20:].any() and not head[:, 27:].any()
        assert torch.equal(head[:20, :27], params[0][0].bfloat16().permute(3, 2, 0, 1).reshape(20, 27))
        # float32 keeps the per-tap layout [tap][32][16 + 8].
        wpack32, table32 = ops.planar_chain.pack_planar_chain(params, torch.float32, "cpu")
        assert table32.reshape(-1, 6)[0, 0] == 0
        head32 = wpack32[:9 * 32 * 24 * 4].view(torch.float32).reshape(9, 32, 24)
        assert head32[4, 5, 2] == params[0][0][1, 1, 2, 5]
        assert not head32[:, 20:].any() and not head32[:, :, 3:].any()
        dw = wpack[table[1][4]:table[1][5]].view(torch.float32).reshape(9, 32)
        assert torch.equal(dw[:, :20], params[1][0].bfloat16().float().reshape(9, 20))
        assert not dw[:, 20:].any()


def _pair(flax_mod, port_mod, x, seed, **apply_kw):
    variables = randomize(jax.jit(flax_mod.init)(jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    ref = exact_jit(lambda v, a: flax_mod.apply(v, a, **apply_kw))(variables, jnp.asarray(x))
    return variables, ref, load_flax_variables(port_mod, variables).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_separable_fused(dtype):
    rng = np.random.default_rng(27)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((2, 7, 9, 12)).astype(np.float32)
    _v, ref, mod = _pair(jlayers.DepthwiseSeparableConv(12, use_fused=True, dtype=jdt),
                         layers.DepthwiseSeparableConv(12, 12, use_fused=True, dtype=tdt), x, 3)
    with torch.inference_mode():
        got = mod(torch.from_numpy(x))
    assert got.dtype == tdt
    _exact_or_close(got, ref, dtype)


@pytest.fixture(scope="module")
def lightweight():
    """Randomised flax variables, the JAX outputs in every layout and dtype,
    and the frame (1, 10, 14, 3)."""
    x = np.random.default_rng(28).random((1, 10, 14, 3)).astype(np.float32)
    variables = randomize(jax.jit(jsr.LightweightSuperResolution().init)(
        jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    assert np.abs(variables["params"]["tail"]["kernel"]).max() > 0
    assert np.abs(variables["batch_stats"]["body0"]["BatchNorm_0"]["mean"]).max() > 0
    refs = {}
    for dtype, (jdt, _tdt) in DTYPES.items():
        model = jsr.LightweightSuperResolution(dtype=jdt)
        for layout in ("nhwc", "planar", "packed"):
            refs[dtype, layout] = np.asarray(exact_jit(
                lambda v, a, m=model, lo=layout: m.apply(v, a, False, lo))(
                    variables, jnp.asarray(x)).astype(jnp.float32))
    return variables, refs, x


@pytest.mark.parametrize("layout", ["nhwc", "planar", "packed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lightweight_matches_jax(lightweight, dtype, layout):
    variables, refs, x = lightweight
    model = lightweight_from_flax(variables, device="cpu", dtype=DTYPES[dtype][1])
    got = model(torch.from_numpy(x), output_layout=layout)
    ref = refs[dtype, layout]
    assert tuple(got.shape) == ref.shape and got.dtype == DTYPES[dtype][1]
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    tol = 2.0**-8 if dtype == "bfloat16" else REL * float(np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_untrained_output_is_clipped_bicubic(dtype):
    x = np.random.default_rng(29).random((2, 9, 11, 3)).astype(np.float32) * 1.2 - 0.1
    model = LightweightSuperResolution(device="cpu", dtype=DTYPES[dtype][1],
                                       generator=torch.Generator().manual_seed(0))
    assert not model.tail.kernel.any() and model.head.kernel.any()
    got = model.eval()(torch.from_numpy(x))
    bicubic = ops.pixel_shuffle(ops.upsample_bicubic_channels(torch.from_numpy(x), 2), 2)
    assert torch.equal(got, bicubic.clamp(0, 1).to(DTYPES[dtype][1]))
    ref = jops.pixel_shuffle(jops.upsample_bicubic_channels(jnp.asarray(x), 2), 2)
    ref = np.asarray(jnp.clip(ref, 0.0, 1.0).astype(DTYPES[dtype][0]).astype(jnp.float32))
    assert 0 < (ref == 0).sum() and 0 < (ref == 1).sum()  # the clip is exercised
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=1e-6)


def test_training_mode_raises_and_names_match_flax(lightweight):
    variables, _refs, x = lightweight
    model = LightweightSuperResolution(device="cpu")
    with pytest.raises(RuntimeError, match="eval"):
        model(torch.from_numpy(x))
    with pytest.raises(ValueError, match="layout"):
        model.eval()(torch.from_numpy(x), output_layout="nchw")
    with pytest.raises(KeyError, match="BatchNorm_0.mean"):
        lightweight_from_flax({**variables, "batch_stats": {}}, device="cpu")
