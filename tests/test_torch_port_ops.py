"""nerve_tpu_torch.ops against nerve_tpu.ops on the same inputs.

Every op's plain PyTorch version (what a CPU tensor runs) is held against
the JAX package's XLA formulation in float32, at 1e-5 of max|ref| unless
stated: the two differ only in summation order. One test runs the Pallas
correlation kernel in interpret mode, one the Pallas depth-to-space kernel
in interpret mode. The bfloat16 correlation is held bit-exact against the
XLA formulation and both Pallas kernels in interpret mode, compiled with
``xla_allow_excess_precision`` off so that XLA rounds each product to
bfloat16 as their source says (by default it may keep them in float32). The CUDA kernels themselves are held against these
plain versions on the GPU (``tests/test_torch_port_cuda.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from nerve_tpu import ops as jops
from nerve_tpu.ops import conv_chain as jcc
from nerve_tpu.ops import correlation as jcorr
from nerve_tpu.ops import rdb as jrdb
from nerve_tpu_torch import ops
from nerve_tpu_torch.ops import conv_chain, correlation, dispatch, rdb

# The package exports the function pixel_shuffle under the module's name.
pixel_shuffle = importlib.import_module("nerve_tpu_torch.ops.pixel_shuffle")

REL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _close(got, ref, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def _chain_params(rng, widths, kinds=None):
    params = []
    kinds = kinds or ["3x3"] * (len(widths) - 1)
    for i, kind in enumerate(kinds):
        cin, cout = widths[i], widths[i + 1]
        if kind == "dw3":
            w = rng.standard_normal((3, 3, cin)) / 3.0
        else:
            k = 3 if kind == "3x3" else 1
            w = rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)
        b = rng.standard_normal((cout,)) * 0.1
        act = "relu" if i < len(kinds) - 1 else "none"
        params.append((w.astype(np.float32), b.astype(np.float32), act))
    return params


def _rdb_params(rng, c, layers=5, growth=32):
    params, cin = [], c
    for _ in range(layers):
        params.append(rng.standard_normal((3, 3, cin, growth)) / np.sqrt(9 * cin))
        params.append(rng.standard_normal((growth,)) * 0.1)
        cin += growth
    params.append(rng.standard_normal((cin, c)) / np.sqrt(cin))
    params.append(rng.standard_normal((c,)) * 0.1)
    return [p.astype(np.float32) for p in params]


class TestCorrelation:
    @pytest.mark.parametrize("d,shape", [(2, (2, 11, 13, 8)), (4, (1, 9, 14, 16))])
    def test_plain_matches_xla(self, d, shape):
        rng = np.random.default_rng(1)
        f1, f2 = rng.standard_normal(shape), rng.standard_normal(shape)
        ref = jcorr._correlation_xla(jnp.asarray(f1, jnp.float32), jnp.asarray(f2, jnp.float32), d)
        _close(ops.correlation_volume(_t(f1), _t(f2), d), ref)

    def test_plain_matches_pallas_planar_interpret(self):
        from jax.experimental.pallas import tpu as pltpu

        rng = np.random.default_rng(2)
        shape = (2, 11, 40, 8)
        f1, f2 = rng.standard_normal(shape), rng.standard_normal(shape)
        with pltpu.force_tpu_interpret_mode():
            ref = jcorr._correlation_pallas_planar(
                jnp.asarray(f1, jnp.float32), jnp.asarray(f2, jnp.float32), 2, th=8, tw=16)
        _close(correlation.correlation_plain(_t(f1), _t(f2), 2), ref)


    @pytest.mark.parametrize("kernel", ["xla", "pallas_planar", "pallas_nhwc"])
    def test_bf16_bit_exact(self, kernel):
        from jax.experimental.pallas import tpu as pltpu

        rng = np.random.default_rng(12)
        # C a power of two: the XLA formulation divides the rounded sum by C.
        f1, f2 = (jnp.asarray(rng.standard_normal((1, 10, 20, 16)) * 0.5, jnp.bfloat16)
                  for _ in range(2))
        fn = {"xla": lambda a, b: jcorr._correlation_xla(a, b, 2),
              "pallas_planar": lambda a, b: jcorr._correlation_pallas_planar(a, b, 2, 8, 16),
              "pallas_nhwc": lambda a, b: jcorr._correlation_pallas(a, b, 2, 8, 16)}[kernel]
        with pltpu.force_tpu_interpret_mode():
            ref = jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})(f1, f2)
        got = ops.correlation_volume(*(_t(np.array(f, np.float32)).bfloat16() for f in (f1, f2)),
                                     2, planar=None if kernel == "xla" else kernel == "pallas_planar")
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


class TestConvChain:
    @pytest.mark.parametrize("case", ["3x3", "1x1", "dw_body", "flow_head", "list3"])
    def test_plain_matches_xla(self, case):
        rng = np.random.default_rng(3)
        shape = (2, 7, 9)
        if case == "3x3":
            params, cin = _chain_params(rng, [5, 6]), 5
        elif case == "1x1":
            params, cin = _chain_params(rng, [6, 4, 3], ["1x1", "3x3"]), 6
        elif case == "dw_body":
            params, cin = _chain_params(rng, [8, 8, 8, 8, 8], ["dw3", "1x1", "dw3", "1x1"]), 8
        elif case == "flow_head":
            params, cin = _chain_params(rng, [81, 128, 64, 32, 2]), 81
        else:
            params, cin = _chain_params(rng, [12, 4, 4, 3]), 12
        if case == "list3":
            xs = [rng.standard_normal((*shape, 4)).astype(np.float32) for _ in range(3)]
            x_j, x_t = [jnp.asarray(a) for a in xs], [_t(a) for a in xs]
        else:
            x = rng.standard_normal((*shape, cin)).astype(np.float32)
            x_j, x_t = jnp.asarray(x), _t(x)
        ref = jcc._chain_xla(x_j, [jnp.asarray(w) for w, _, _ in params],
                             [jnp.asarray(b) for _, b, _ in params], [a for *_, a in params])
        got = ops.conv_chain_apply(x_t, [(_t(w), _t(b), a) for w, b, a in params])
        _close(got, ref)

    def test_rejects_bad_chains(self):
        x = torch.zeros(1, 4, 4, 3)
        with pytest.raises(ValueError, match="mismatch"):
            ops.conv_chain_apply(x, [(torch.zeros(3, 3, 3, 4), torch.zeros(4), "relu"),
                                     (torch.zeros(3, 3, 5, 2), torch.zeros(2), "none")])
        with pytest.raises(ValueError, match="activation"):
            ops.conv_chain_apply(x, [(torch.zeros(3, 3, 3, 4), torch.zeros(4), "gelu")])
        with pytest.raises(ValueError, match="4 channels, the first layer takes 3"):
            ops.conv_chain_apply([x, x[..., :1]],
                                 [(torch.zeros(3, 3, 3, 4), torch.zeros(4), "relu")])


class TestRDB:
    def test_block_matches_xla(self):
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 9, 11, 16)).astype(np.float32)
        params = _rdb_params(rng, 16)
        ref = jrdb._rdb_xla(jnp.asarray(x), [jnp.asarray(p) for p in params])
        _close(rdb.rdb_apply(_t(x), [_t(p) for p in params]), ref)

    def test_chain_of_two_matches_xla(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((1, 8, 10, 16)).astype(np.float32)
        plist = [_rdb_params(rng, 16) for _ in range(2)]
        ref = jrdb._rdb_chain_xla(jnp.asarray(x), [[jnp.asarray(p) for p in ps] for ps in plist])
        _close(ops.rdb_chain_apply(_t(x), [[_t(p) for p in ps] for ps in plist]), ref)


class TestPixelShuffle:
    @pytest.mark.parametrize("scale", [2, 3])
    def test_packed_bit_exact_vs_pallas_interpret(self, scale):
        from nerve_tpu.ops.pixel_shuffle import _TW

        rng = np.random.default_rng(6)
        x = rng.standard_normal((1, 16, _TW, 3 * scale * scale)).astype(np.float32)
        ref = jops.depth_to_space_packed(jnp.asarray(x), scale, use_pallas=True, interpret=True)
        got = ops.depth_to_space_packed(_t(x), scale)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("fn", ["pixel_shuffle", "pixel_shuffle_planar"])
    def test_layouts_match(self, fn):
        rng = np.random.default_rng(7)
        x = rng.standard_normal((2, 5, 7, 12)).astype(np.float32)
        ref = getattr(jops, fn)(jnp.asarray(x), 2)
        np.testing.assert_array_equal(getattr(pixel_shuffle, fn)(_t(x), 2).numpy(),
                                      np.asarray(ref))


class TestResize:
    @pytest.mark.parametrize("fn,scale", [("upsample_bicubic_channels", 2),
                                          ("upsample_bicubic_channels", 3),
                                          ("upsample_bilinear_channels", 2)])
    def test_phase_channels(self, fn, scale):
        rng = np.random.default_rng(8)
        x = rng.random((2, 6, 9, 3)).astype(np.float32)
        _close(getattr(ops, fn)(_t(x), scale), getattr(jops, fn)(jnp.asarray(x), scale))

    @pytest.mark.parametrize("src,dst", [((6, 8), (12, 16)), ((5, 7), (11, 14)),
                                         ((9, 11), (4, 5))])
    def test_resize_bilinear(self, src, dst):
        rng = np.random.default_rng(9)
        x = rng.standard_normal((2, *src, 2)).astype(np.float32)
        _close(ops.resize_bilinear(_t(x), dst), jops.resize_bilinear(jnp.asarray(x), dst))


class TestWarpAndPool:
    def test_flow_warp_partly_out_of_frame(self):
        rng = np.random.default_rng(10)
        feat = rng.standard_normal((2, 9, 13, 5)).astype(np.float32)
        flow = (rng.standard_normal((2, 9, 13, 2)) * 5).astype(np.float32)
        ref = jops.flow_warp(jnp.asarray(feat), jnp.asarray(flow))
        # Some samples leave the frame entirely, some straddle its edge.
        assert np.any(np.abs(flow) > 9)
        _close(ops.flow_warp(_t(feat), _t(flow)), ref)

    def test_flow_warp_serving_width(self):
        """A 1920-pixel row, where a sampler that normalises the coordinates
        to [-1, 1] and back moves each sample by ~1e-4 px (6.8e-5 of
        max|ref|). The tent sampler in pixel coordinates measured 0 here."""
        rng = np.random.default_rng(13)
        feat = rng.standard_normal((1, 4, 1920, 4)).astype(np.float32)
        flow = (rng.standard_normal((1, 4, 1920, 2)) * 3).astype(np.float32)
        assert np.any(np.abs(flow[..., 1]) > 4)  # some rows leave the frame
        _close(ops.flow_warp(_t(feat), _t(flow)),
               jops.flow_warp(jnp.asarray(feat), jnp.asarray(flow)))

    @pytest.mark.parametrize("shape", [(2, 9, 13, 5), (1, 4, 1920, 4)])
    def test_flow_warp_bf16_contract(self, shape):
        """bfloat16 features and flow against the reference's unchunked
        sampler (``chunk_rows=0``: the chunked path rounds the row offset in
        the flow's dtype), compiled with ``xla_allow_excess_precision`` off.
        Required: ≥ 99.9 % of elements bit-equal and max|Δ| ≤ 2⁻⁸·max|ref|;
        measured 100 % and 0 at both shapes."""
        rng = np.random.default_rng(14)
        feat = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        flow = jnp.asarray(rng.standard_normal((*shape[:3], 2)) * 3, jnp.bfloat16)
        ref = jax.jit(lambda f, fl: jops.flow_warp(f, fl, chunk_rows=0),
                      compiler_options={"xla_allow_excess_precision": False})(feat, flow)
        ref = np.asarray(ref.astype(jnp.float32))
        got = ops.flow_warp(*(_t(np.array(a.astype(jnp.float32))).bfloat16()
                              for a in (feat, flow)))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        assert got.shape == ref.shape
        assert np.mean(got == ref) >= 0.999
        assert np.abs(got - ref).max() <= 2.0**-8 * np.abs(ref).max()

    def test_pools(self):
        rng = np.random.default_rng(11)
        x = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
        _close(ops.avg_pool2d(_t(x), 2), fnn.avg_pool(jnp.asarray(x), (2, 2), strides=(2, 2)))
        _close(ops.global_avg_pool(_t(x)), jops.global_avg_pool(jnp.asarray(x)))


class TestDispatch:
    def test_cpu_takes_plain_and_counts_nothing(self):
        dispatch.reset_launches()
        ops.depth_to_space_packed(torch.zeros(1, 2, 2, 4), 2)
        assert not dispatch.use_kernel(torch.zeros(1))
        assert all(v == 0 for v in dispatch.launches.values())

    def test_other_device_raises(self):
        with pytest.raises(ValueError, match="meta"):
            ops.correlation_volume(torch.zeros(1, 4, 4, 2, device="meta"),
                                   torch.zeros(1, 4, 4, 2, device="meta"), 1)
