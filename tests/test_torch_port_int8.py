"""nerve_tpu_torch int8 ops against the JAX package's, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both.

* Calibration: scales agree with JAX to rtol 1e-6 (both are max-abs / 127
  of float32 activations; the sums differ in order only).
* Quantisation: int8 weights are equal; dequant factors and meta agree to
  rtol 1e-6 (one float32 product or quotient of the same scales).
* The plain versions against the JAX XLA mirrors, which the JAX tests hold
  against the Pallas kernels: an RDB block with float32 output at atol 1e-4
  and a chain of blocks within 4 x the largest activation scale
  (``tests/test_rdb_int8.py``); a conv chain within 2 x the largest scale
  (``tests/test_conv_chain_int8.py``). A requantised intermediate one ulp
  from a rounding boundary may flip one int8 step; no case here does, so
  the measured difference is 0.
* One Pallas interpret-mode case per int8 kernel at a tiny shape.
* The input quantisation (``quantize_into``, the plain version of
  ``csrc/quantize_i8.cu``): bit-equal to the JAX package's in-graph
  expression (``conv_chain_int8.py:284-290``), ties to even, clipping at
  ±127, list parts in their channel slots, pad channels zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nerve_tpu.ops import conv_chain_int8 as jcc8
from nerve_tpu.ops import rdb_int8 as jr8
from nerve_tpu_torch import ops
from nerve_tpu_torch.ops import conv_chain_int8 as cc8
from nerve_tpu_torch.ops import dispatch
from nerve_tpu_torch.ops import rdb_int8 as r8

RTOL = 1e-6
# The JAX references run jitted: one compiled program per case costs less
# CPU time than compiling each of their many small operations eagerly.
j_cal_rdb = jax.jit(jr8.calibrate_rdb_chain)
j_quant_rdb = jax.jit(jr8.quantize_rdb_chain)
j_rdb_xla = jax.jit(jr8.rdb_chain_int8_xla, static_argnames="out_dtype")


def _chain(rng, widths, kinds, acts=None):
    out = []
    for i, k in enumerate(kinds):
        cin, cout = widths[i], widths[i + 1]
        w = rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)
        act = acts[i] if acts else ("relu" if i < len(kinds) - 1 else "none")
        out.append((w.astype(np.float32), (rng.standard_normal(cout) * 0.1).astype(np.float32),
                    act))
    return out


def _rdb_block(rng, c, layers, growth):
    ps, cin = [], c
    for _ in range(layers):
        ps += [rng.standard_normal((3, 3, cin, growth)) * 0.08, rng.standard_normal(growth) * 0.02]
        cin += growth
    ps += [rng.standard_normal((cin, c)) * 0.08, rng.standard_normal(c) * 0.02]
    return [p.astype(np.float32) for p in ps]


def _j(params):
    return [(jnp.asarray(w), jnp.asarray(b), a) for w, b, a in params]


def _t(params):
    return [(torch.from_numpy(w), torch.from_numpy(b), a) for w, b, a in params]


def _close(got, ref, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=0)


# The five serving sites, narrowed: head, flow head, attention (a list of
# three frames), gff, upsampler; and a chain with a 1x1 layer.
SITES = {
    "head": ([3], [3, 16], [3], ["relu"]),
    "flow": ([18], [18, 16, 8, 4, 2], [3, 3, 3, 3], None),
    "attention": ([8, 8, 8], [24, 8, 8, 3], [3, 3, 3], None),
    "gff": ([16], [16, 16], [3], ["relu"]),
    "upsampler": ([16], [16, 12], [3], ["none"]),
    "with_1x1": ([12], [12, 20, 24, 5], [3, 1, 3], None),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_conv_chain_int8_matches_jax(site):
    ins, widths, kinds, acts = SITES[site]
    rng = np.random.default_rng(sorted(SITES).index(site))
    params = _chain(rng, widths, kinds, acts)
    xs = [rng.standard_normal((2, 9, 13, c)).astype(np.float32) for c in ins]
    jx = [jnp.asarray(x) for x in xs] if len(xs) > 1 else jnp.asarray(xs[0])
    tx = [torch.from_numpy(x) for x in xs] if len(xs) > 1 else torch.from_numpy(xs[0])

    acts = tuple(a for *_, a in params)
    ws, bs = [jnp.asarray(w) for w, *_ in params], [jnp.asarray(b) for _, b, _ in params]
    jscales = jax.jit(lambda x, ws, bs: jcc8.calibrate_conv_chain(x, list(zip(ws, bs, acts))))(
        jx, ws, bs)
    tscales = cc8.calibrate_conv_chain(tx, _t(params))
    _close(tscales, jscales)
    # Quantise both at JAX's scales, so that the weights compare exactly.
    jq = jcc8.quantize_conv_chain(_j(params), jscales)
    tq = cc8.quantize_conv_chain(_t(params), torch.from_numpy(np.array(jscales)))
    assert tq[2] == jq[2] and float(tq[1]) == float(jq[1])
    for (jw, jm), (tw, tm) in zip(jq[0], tq[0]):
        assert tw.dtype == torch.int8 and np.array_equal(tw.numpy(), np.asarray(jw))
        _close(tm, jm)

    ref = jax.jit(lambda x, ql, s_in: jcc8.conv_chain_int8_xla(
        x, ql, s_in, acts, widths[-1], jnp.float32))(jx, jq[0], jq[1])
    got = ops.conv_chain_int8_apply(tx, tq, widths[-1], out_dtype=torch.float32)
    err = np.abs(got.numpy() - np.asarray(ref)).max()
    assert got.shape == ref.shape and err <= 2 * float(jnp.max(jscales)), err


def test_conv_chain_int8_list_quantised_at_one_scale():
    """A list input is quantised at the one s_in, as its concatenation."""
    rng = np.random.default_rng(10)
    params = _t(_chain(rng, [8, 8, 3], [3, 3]))
    xs = [torch.from_numpy(rng.standard_normal((1, 6, 7, 4)).astype(np.float32)) for _ in range(2)]
    q = cc8.quantize_conv_chain(params, cc8.calibrate_conv_chain(xs, params))
    assert torch.equal(ops.conv_chain_int8_apply(xs, q, 3),
                       ops.conv_chain_int8_apply(torch.cat(xs, -1), q, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.25, 0.3])
def test_quantize_into_matches_jax(dtype, scale):
    """Three parts of 3, 8 and 5 channels into a 32-channel int8 buffer, of
    which the leading 24 are written (16 data, 8 zero) and the rest kept.
    The values hold (k + 0.5)·s for k of both parities and both signs, and
    values past ±127·s. At s = 0.25 these are exact ties; at s = 0.3 they
    and their float32 neighbours fall on both sides of .5, and some of them
    round otherwise under x · (1 / s) than under the reference's x / s."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(21)
    s = np.float32(scale)
    near = ((np.arange(-140, 140) + 0.5) * scale).astype(np.float32)
    near = np.concatenate([near, np.nextafter(near, np.float32(np.inf)),
                           np.nextafter(near, np.float32(-np.inf))])
    near = np.array(jnp.asarray(near, jdt).astype(jnp.float32))
    by_reciprocal = np.rint(near * (np.float32(1) / s)) != np.rint(near / s)
    near = np.concatenate([near[by_reciprocal], rng.permutation(near[~by_reciprocal])])
    v = rng.standard_normal(2 * 4 * 5 * 16) * 40 * s
    v[:min(near.size, v.size)] = near[:v.size]
    v = np.array(jnp.asarray(rng.permutation(v).reshape(2, 4, 5, 16), jdt).astype(jnp.float32))
    parts = [v[..., :3], v[..., 3:11], v[..., 11:]]
    # The reference's quantisation (nerve_tpu/ops/conv_chain_int8.py:284-290).
    ref = [np.asarray(jnp.clip(jnp.round(jnp.asarray(p, jdt).astype(jnp.float32) / s),
                               -127.0, 127.0).astype(jnp.int8)) for p in parts]
    ref = np.concatenate(ref, axis=-1)
    assert np.any(np.abs(ref) == 127) and np.any(ref % 2 == 0)
    if scale != 0.25:
        assert np.any(np.clip(np.rint(v * (np.float32(1) / s)), -127, 127) != ref)
    out = torch.full((2, 4, 5, 32), 7, dtype=torch.int8)
    got = cc8.quantize_into([torch.from_numpy(np.ascontiguousarray(p)).to(tdt) for p in parts],
                            torch.tensor(s), out, 24)
    assert got is out
    np.testing.assert_array_equal(out[..., :16].numpy(), ref)
    assert not out[..., 16:24].any() and bool((out[..., 24:] == 7).all())
    with pytest.raises(ValueError):
        cc8.quantize_into([torch.zeros(2, 4, 5, 20)], torch.tensor(s), out, 16)


@pytest.mark.parametrize("geometry", [(16, 5, 32), (12, 3, 8)])
def test_rdb_int8_matches_jax(geometry):
    c, layers, growth = geometry
    rng = np.random.default_rng(c)
    plist = [_rdb_block(rng, c, layers, growth) for _ in range(2)]
    x = (rng.standard_normal((1, 9, 13, c)) * 0.5).astype(np.float32)
    jp = [[jnp.asarray(p) for p in ps] for ps in plist]
    tp = [[torch.from_numpy(p) for p in ps] for ps in plist]

    jscales = j_cal_rdb(jnp.asarray(x), jp)
    _close(r8.calibrate_rdb_chain(torch.from_numpy(x), tp), jscales)
    np.testing.assert_array_equal(
        r8._owner_scales(c, 8 + c + 2 * growth, torch.arange(layers + 1.0), growth).numpy(),
        np.asarray(jr8._owner_scales(c, 8 + c + 2 * growth, jnp.arange(layers + 1.0), growth)))
    jq = j_quant_rdb(jp, jscales)
    tq = r8.quantize_rdb_chain(tp, torch.from_numpy(np.array(jscales)))
    assert r8.chain_geometry(tq) == jr8.chain_geometry(jq) == (layers, growth)
    for (jw, jd, jm), (tw, td, tm) in zip(jq, tq):
        assert len(tw) == layers + 1
        for a, b in zip(jw, tw):
            assert b.dtype == torch.int8 and np.array_equal(b.numpy(), np.asarray(a))
        _close(td, jd)
        _close(tm, jm)

    tx = torch.from_numpy(x)
    for jblk, tblk in zip(jq, tq):  # each block alone, float32 out
        ref = j_rdb_xla(jnp.asarray(x), (jblk,), out_dtype=jnp.float32)
        got = ops.rdb_chain_int8_apply(tx, (tblk,), out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    ref = j_rdb_xla(jnp.asarray(x), jq)
    got = ops.rdb_chain_int8_apply(tx, tq)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 4 * float(jnp.max(jscales))


def test_int8_cpu_runs_plain_and_counts_nothing():
    rng = np.random.default_rng(3)
    plist = [[torch.from_numpy(p) for p in _rdb_block(rng, 16, 5, 32)]]
    x = torch.from_numpy((rng.standard_normal((1, 5, 6, 16)) * 0.5).astype(np.float32))
    q = r8.quantize_rdb_chain(plist, r8.calibrate_rdb_chain(x, plist))
    before = dict(dispatch.launches)
    assert torch.equal(ops.rdb_chain_int8_apply(x, q), r8.rdb_chain_int8_plain(x, q))
    assert dispatch.launches == before


def test_int8_rejects_depthwise_and_misshapen_state():
    dw = [(torch.zeros(3, 3, 8), torch.zeros(8), "none")]
    with pytest.raises(ValueError, match="dense"):
        cc8.calibrate_conv_chain(torch.zeros(1, 4, 4, 8), dw)
    with pytest.raises(ValueError, match="dense"):
        cc8.quantize_conv_chain(dw, torch.ones(2))
    rng = np.random.default_rng(4)
    plist = [[torch.from_numpy(p) for p in _rdb_block(rng, 16, 5, 32)]]
    wq, dq, meta = r8.quantize_rdb_chain(plist, torch.ones(1, 6))[0]
    with pytest.raises(ValueError, match="do not fit"):
        ops.rdb_chain_int8_apply(torch.zeros(1, 4, 4, 16), ((wq, dq, meta[:, :-1]),))


def test_pallas_interpret_conv_chain_int8():
    """The TPU kernel in interpret mode against the port's plain version."""
    rng = np.random.default_rng(5)
    params = _chain(rng, [8, 16, 12], [3, 3])
    x = rng.standard_normal((1, 8, 16, 8)).astype(np.float32)
    scales = jcc8.calibrate_conv_chain(jnp.asarray(x), _j(params))
    jq = jcc8.quantize_conv_chain(_j(params), scales)
    with pltpu.force_tpu_interpret_mode():
        ref = jcc8.conv_chain_int8_pallas(jnp.asarray(x), jq, 12, out_dtype=jnp.float32,
                                          th=8, tw=8)
    tq = cc8.quantize_conv_chain(_t(params), torch.from_numpy(np.array(scales)))
    got = cc8.conv_chain_int8_plain(torch.from_numpy(x), *tq, 12, torch.float32)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 2 * float(jnp.max(scales))


def test_pallas_interpret_rdb_int8():
    rng = np.random.default_rng(6)
    plist = [_rdb_block(rng, 16, 5, 32)]
    x = (rng.standard_normal((1, 8, 16, 16)) * 0.5).astype(np.float32)
    jp = [[jnp.asarray(p) for p in ps] for ps in plist]
    jq = j_quant_rdb(jp, j_cal_rdb(jnp.asarray(x), jp))
    with pltpu.force_tpu_interpret_mode():
        ref = jr8.rdb_chain_int8_pallas(jnp.asarray(x), jq, out_dtype=jnp.float32,
                                        th=8, tw=8)
    tq = tuple(([torch.from_numpy(np.array(w)) for w in wq], torch.from_numpy(np.array(dq)),
                torch.from_numpy(np.array(m))) for wq, dq, m in jq)
    got = r8.rdb_chain_int8_plain(torch.from_numpy(x), tq, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
