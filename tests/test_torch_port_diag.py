"""The port's diagnostic paths against the JAX package's, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both.

* int8 RDB: per-channel quantisation equals ``quantize_rdb_block(...,
  per_channel=True)`` (int8 weights equal, factors at rtol 1e-6); the plain
  versions of ``int32_taps`` (dy or dx outer) and of the per-column
  dx-major order against ``rdb_chain_int8_xla`` and against the Pallas
  kernel in interpret mode, at the JAX tests' levels: a block with float32
  output at atol 1e-4, a chain within 4 × its largest activation scale.
* The RDB's rounding contracts (``ops.rdb_taps``): each plain version
  against the ``scripts/diag_rdb.py`` mode that defines it, run as the
  script's ``call`` builds it (interpret mode), and the ``s2d`` contract
  against ``scripts/diag_rdb_s2d.py`` ``rdb_s2d``, each on one tile (the
  script writes the bias channel only at its first grid step, which later
  tiles lose). float32 within 1e-5 · max|ref|; bf16 within 1.56e-2 ·
  max|ref| and a mean|Δ| at most ¼ of the least mean|Δ| of any other
  contract's plain version against the same mode (``pallas_dy`` and
  ``pallas_dx``, which differ only in float32 add order, count as one):
  that shows the contract implemented is the one claimed. JAX runs with
  ``xla_allow_excess_precision`` off, so its bf16 roundings happen.
* The planar d2s and the packed d2s bit-exact against the script's
  ``d2s_packed_planar`` and ``d2s_packed_mxu`` (interpret mode).
* A quantised RDB stack with ``PER_CHANNEL_INT8`` set in both packages
  against flax at atol 1e-4.
* Every ``nerve_tpu_torch.diag`` entry point runs on the CPU at its small
  shapes (``test_port_imports_no_jax`` in ``test_torch_port_slice.py``
  imports each of them, with every other module of the package, in a
  process that must load no JAX).
"""

import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nerve_tpu.models.super_resolution import RDBStack as JaxRDBStack
from nerve_tpu.ops import rdb as jrdb
from nerve_tpu.ops import rdb_int8 as jr8
from nerve_tpu_torch import ops
from nerve_tpu_torch.models.bridge import load_flax_variables
from nerve_tpu_torch.models.super_resolution import RDBStack
from nerve_tpu_torch.ops import rdb_int8 as r8
from nerve_tpu_torch.ops import rdb_taps

REPO = Path(__file__).resolve().parents[1]
ps = importlib.import_module("nerve_tpu_torch.ops.pixel_shuffle")
# JAX compiles with bf16 roundings kept and, to spend less time compiling
# the interpret-mode kernels, without backend optimisation (the same numbers).
EXACT = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}
RTOL = 1e-6


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_diag_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def diag_rdb():
    return _script("diag_rdb")


def _rdb_block(rng, c, layers=5, growth=32):
    ps_, cin = [], c
    for _ in range(layers):
        ps_ += [rng.standard_normal((3, 3, cin, growth)) / np.sqrt(9 * cin),
                rng.standard_normal(growth) * 0.1]
        cin += growth
    ps_ += [rng.standard_normal((cin, c)) / np.sqrt(cin), rng.standard_normal(c) * 0.1]
    return [p.astype(np.float32) for p in ps_]


# --------------------------------------------------------------------------- #
# int8: per-channel scales, int32 taps, dx-major order
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def int8_case():
    rng = np.random.default_rng(0)
    plist = [_rdb_block(rng, 16) for _ in range(2)]
    x = (rng.standard_normal((1, 8, 16, 16)) * 0.5).astype(np.float32)
    jp = [[jnp.asarray(p) for p in ps_] for ps_ in plist]
    tp = [[torch.from_numpy(p) for p in ps_] for ps_ in plist]
    # Calibration parity is test_torch_port_int8.py's; both take these scales.
    scales = r8.calibrate_rdb_chain(torch.from_numpy(x), tp).numpy()
    quant = jax.jit(jr8.quantize_rdb_chain, static_argnames="per_channel",
                    compiler_options=EXACT)
    jq = {pc: quant(jp, jnp.asarray(scales), per_channel=pc) for pc in (False, True)}
    tq = {pc: r8.quantize_rdb_chain(tp, torch.from_numpy(scales), per_channel=pc)
          for pc in (False, True)}
    return dict(x=x, scales=scales, jq=jq, tq=tq)


def test_per_channel_quantisation_matches_jax(int8_case):
    jq, tq = int8_case["jq"][True], int8_case["tq"][True]
    for (jw, jd, jm), (tw, td, tm) in zip(jq, tq):
        for a, b in zip(jw, tw):
            assert b.dtype == torch.int8 and np.array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=0)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL, atol=0)
        # One factor per output channel, tiled over the nine taps.
        assert torch.equal(td, td[:, :32].repeat(1, 9))
    # Per-channel factors are the largest of their nine per-column ones.
    col = int8_case["tq"][False][0][1]
    assert torch.equal(tq[0][1][:, :32], col.reshape(-1, 9, 32).amax(dim=1))


def test_int32_taps_matches_jax_xla(int8_case):
    """Both tap orders (the same int32 sums) against ``int32_taps=True``: the
    chain of two blocks in float32, each block's output within 1e-4 (the
    first block's output is the second's input, requantised)."""
    x, tq = int8_case["x"], int8_case["tq"][True]
    ref = jax.jit(lambda x, q: jr8.rdb_chain_int8_xla(x, q, jnp.float32, int32_taps=True),
                  compiler_options=EXACT)(jnp.asarray(x), int8_case["jq"][True])
    for dx_major in (False, True):
        got = ops.rdb_chain_int8_apply(torch.from_numpy(x), tq, torch.float32, True, dx_major)
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= 4 * int8_case["scales"].max()


@pytest.mark.parametrize("int32_taps,dx_major", [(True, False), (True, True), (False, True)])
def test_int8_schemes_match_pallas_interpret(int8_case, int32_taps, dx_major):
    x = int8_case["x"]
    jq, tq = int8_case["jq"][int32_taps], int8_case["tq"][int32_taps]
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda x, q: jr8.rdb_chain_int8_pallas(
            x, q, out_dtype=jnp.float32, th=8, tw=16, dx_major=dx_major, int32_taps=int32_taps),
            compiler_options=EXACT)(jnp.asarray(x), jq[:1])
    got = r8.rdb_chain_int8_plain(torch.from_numpy(x), tq[:1], torch.float32, int32_taps,
                                  dx_major)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_int8_schemes_default_to_the_switches(int8_case, monkeypatch):
    x, tq = torch.from_numpy(int8_case["x"]), int8_case["tq"][True]
    monkeypatch.setattr(r8, "PER_CHANNEL_INT8", True)
    monkeypatch.setattr(r8, "DX_MAJOR_INT8", True)
    assert torch.equal(ops.rdb_chain_int8_apply(x, tq),
                       r8.rdb_chain_int8_plain(x, tq, None, True, True))


def test_int32_taps_refuses_a_per_column_chain(int8_case):
    """The wire format does not record the scheme: a per-column chain served
    with ``int32_taps`` would dequantise every tap by the (0, 0) tap's factors."""
    x, tq = torch.from_numpy(int8_case["x"]), int8_case["tq"][False]
    for fn in (ops.rdb_chain_int8_apply, r8.rdb_chain_int8_plain):
        with pytest.raises(ValueError, match="per channel"):
            fn(x, tq, None, True)


# --------------------------------------------------------------------------- #
# The RDB's rounding contracts
# --------------------------------------------------------------------------- #
def _diag_rdb_call(mod, x, params, mode, th, tw):
    """``scripts/diag_rdb.py`` ``run_variant``'s ``call``, in interpret mode."""
    b, h, w, c = x.shape
    nh, nw = -(-h // th), -(-w // tw)
    pad_h, pad_w = (nh + 1) * th - (h + mod.HALO), (nw + 1) * tw - (w + mod.HALO)
    packed = (mod._pack_weights_dx if "dx" in mode else mod._pack_weights)(params, c)
    hh, ww = th + 2 * mod.HALO, tw + 2 * mod.HALO
    ph, pw = hh + 2, ww + 2 + ((-(ww + 2)) % 8)
    quad = lambda sh, sw: pl.BlockSpec(  # noqa: E731
        (1, th, tw, c), lambda bi, hi, wi, sh=sh, sw=sw: (bi, hi + sh, wi + sw, 0),
        memory_space=pltpu.VMEM)
    full = lambda arr: pl.BlockSpec(  # noqa: E731
        arr.shape, lambda bi, hi, wi: (0,) * arr.ndim, memory_space=pltpu.VMEM)

    def call(xx, pk):
        xp = jnp.pad(xx, ((0, 0), (mod.HALO, pad_h), (mod.HALO, pad_w), (0, 0)))
        return pl.pallas_call(
            mod.make_kernel(th, tw, c, mode, img_h=h, img_w=w),
            out_shape=jax.ShapeDtypeStruct((b, nh * th, nw * tw, c), xx.dtype),
            grid=(b, nh, nw),
            in_specs=[quad(0, 0), quad(0, 1), quad(1, 0), quad(1, 1)] + [full(p) for p in pk],
            out_specs=pl.BlockSpec((1, th, tw, c), lambda bi, hi, wi: (bi, hi, wi, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((ph, pw, mod.KPAD), xx.dtype),
                            pltpu.VMEM((ph, pw, 9 * mod.GROWTH), xx.dtype)],
            interpret=True,
        )(xp, xp, xp, xp, *pk)[:, :h, :w, :]
    return jax.jit(call, compiler_options=EXACT)(x, packed)


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    params = _rdb_block(rng, shape[-1])
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return (jnp.asarray(x).astype(jdt), [jnp.asarray(p).astype(jdt) for p in params],
            torch.from_numpy(x).to(dtype), [torch.from_numpy(p).to(dtype) for p in params])


def _judge(ref, tx, tparams, contract, dtype):
    """The contract's plain version within the limits of the module
    docstring, against ``ref`` and against every other contract."""
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    scale = ref.abs().max().item()
    got = rdb_taps.rdb_taps_plain(tx, tparams, contract).float()
    err = (got - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * scale, err
        return
    assert err <= 1.56e-2 * scale, err
    mine, least_other = rdb_taps.contract_margin(ref, tx, tparams, contract)
    assert mine <= 0.25 * least_other, (contract, mine, least_other)


@pytest.mark.parametrize("mode", ["flat_strips", "flat_dx_strips", "flat_dx_strips_f32y",
                                  "flat_dx_strips_accbf16"])
def test_contract_matches_diag_rdb_mode(diag_rdb, mode):
    """bf16, on one 24×40 tile holding the (20, 36) frame."""
    jx, jparams, tx, tparams = _inputs((1, 20, 36, 16), torch.bfloat16, 1)
    ref = _diag_rdb_call(diag_rdb, jx, jparams, mode, th=24, tw=40)
    _judge(ref, tx, tparams, rdb_taps.TPU_MODES[mode], torch.bfloat16)


def test_pallas_dx_matches_rdb_kernel_float32():
    """float32 against the production ``_rdb_kernel`` (``DX_MAJOR``), which
    rounds at the scratch's dtype; the harness's modes round the taps to
    bf16 whatever the input's dtype. A 2×2 grid of 12×24 tiles: the
    production kernel re-writes the bias channel on every tile."""
    jx, jparams, tx, tparams = _inputs((1, 20, 36, 16), torch.float32, 1)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda x, p: jrdb._rdb_pallas_nhwc(x, p, th=12, tw=24, dx_major=True),
                      compiler_options=EXACT)(jx, jparams)
    _judge(ref, tx, tparams, "pallas_dx", torch.float32)


def test_s2d_contract_matches_rdb_s2d():
    """bf16, ``rdb_s2d`` on one tile (th2=12, tw=32) holding the (24, 30) frame."""
    mod = _script("diag_rdb_s2d")
    jx, jparams, tx, tparams = _inputs((1, 24, 30, 16), torch.bfloat16, 2)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda x, p: mod.rdb_s2d(x, p, th2=12, tw=32),
                      compiler_options=EXACT)(jx, jparams)
    _judge(ref, tx, tparams, "s2d", torch.bfloat16)


def test_nolff_returns_the_input_and_tables_cover_every_tap():
    _jx, _jp, tx, tparams = _inputs((1, 7, 9, 16), torch.float32, 3)
    assert torch.equal(ops.rdb_taps_apply(tx, tparams, "nolff"), tx)
    for mode in rdb_taps.MODES:
        table, _flags = rdb_taps.launch_table(mode)
        assert sorted(table[:9]) == sorted(table[9:18]) == list(range(9))
    with pytest.raises(ValueError, match="plain"):
        rdb_taps.rdb_taps_plain(tx, tparams, "matonly")


# --------------------------------------------------------------------------- #
# d2s
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def diag_d2s():
    return _script("diag_d2s")


def test_d2s_planar_matches_diag_d2s(diag_d2s):
    x = np.random.default_rng(4).random((1, 12, 16, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda x: diag_d2s.d2s_packed_planar(x, th=8),
                      compiler_options=EXACT)(jnp.asarray(x))
    got = ops.depth_to_space_packed_planar(torch.from_numpy(x), 2)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_d2s_packed_covers_d2s_packed_mxu(diag_d2s):
    """The script's NHWC candidate computes row 5's function on row 5's layout."""
    x = np.random.default_rng(5).random((1, 8, 128, 12)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(diag_d2s.d2s_packed_mxu, compiler_options=EXACT)(jnp.asarray(x))
    got = ps.depth_to_space_packed_plain(torch.from_numpy(x), 2)
    assert np.array_equal(got.numpy(), np.asarray(ref))


# --------------------------------------------------------------------------- #
# The model under PER_CHANNEL_INT8
# --------------------------------------------------------------------------- #
def test_per_channel_rdb_stack_matches_flax(monkeypatch):
    monkeypatch.setattr(jr8, "PER_CHANNEL_INT8", True)
    monkeypatch.setattr(r8, "PER_CHANNEL_INT8", True)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((1, 9, 13, 16)) * 0.5).astype(np.float32)
    cfg = dict(num_features=16, num_blocks=2, use_pallas=False)
    params = {}
    for b, block in enumerate(_rdb_block(rng, 16) for _ in range(2)):
        names = [f"rdb{b}_dense{i}_{k}" for i in range(5) for k in ("kernel", "bias")]
        params.update(zip(names + [f"rdb{b}_lff_kernel", f"rdb{b}_lff_bias"], block))
    # The calibration forward creates the "quant" collection and fills it.
    _, cal = jax.jit(lambda v, x: JaxRDBStack(**cfg, quantized=True, quant_calibrate=True).apply(
        v, x, mutable=["quant"]), compiler_options=EXACT)({"params": params}, x)
    qvars = jax.tree_util.tree_map(np.array, {"params": params, "quant": cal["quant"]})
    ref = jax.jit(JaxRDBStack(**cfg, quantized=True).apply, compiler_options=EXACT)(qvars, x)
    tstack = load_flax_variables(RDBStack(16, 2, quantized=True, device="cpu").eval(), qvars)
    got = tstack(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    qchain = tstack.qchain.value()
    assert torch.equal(qchain[0][1], qchain[0][1][:, :32].repeat(1, 9))  # per-channel
    # The port's own calibration quantises per channel too, to the same state.
    tstack.quant_calibrate = True
    tstack(torch.from_numpy(x))
    tstack.quant_calibrate = False
    for (jw, jd, _jm), (tw, td, _tm) in zip(qvars["quant"]["qchain"], tstack.qchain.value()):
        np.testing.assert_allclose(td.numpy(), jd, rtol=5e-6, atol=0)


# --------------------------------------------------------------------------- #
# The entry points
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["probe", "rdb_int8", "rdb", "rdb_s2d", "d2s", "warp", "planar",
                                  "correlation", "depthwise"])
def test_diag_entry_point_runs_on_cpu(name, capsys):
    mod = importlib.import_module(f"nerve_tpu_torch.diag.{name}")
    mod.main(["--device", "cpu"] + ([] if name == "probe" else ["--small", "--reps", "1"]))
    out = capsys.readouterr().out
    assert ("probe ok" in out) if name == "probe" else ("time " in out or "rdb " in out)
