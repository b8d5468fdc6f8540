"""The port's enhancement engine, facade, CLI and pair step against the JAX
package's.

A narrow engine (recovery base 8 channels; SR 16 features, 2 RDBs, window
1) over a seeded uint8 window of 5 frames at 32 × 32 (frames = uint8 / 255,
as both facades ingest them), a mask covering a block of the centre frame.
Each configuration's flax variables are built by shape (``jax.eval_shape``,
no init run), every leaf seeded (``test_torch_port_models.randomize``), the
strength set to 0.75 (a seeded ~0 would hide the SR frame), and bridged
into the port strictly; each JAX function compiles once per module
(fixtures), bf16 with excess precision off.

Limits on ``enhanced`` / ``recovered`` / ``super_resolved``: float32 within
1e-4 of max|ref|; bf16 max|Δ| ≤ 3.2e-2, mean|Δ| ≤ 1e-3; ``recovered``
equals the input outside the mask exactly in both dtypes. The int8 engine:
JAX calibrates with ``quantize_engine_variables``, the port serves that
state within the int8 SR slice's limits (``test_torch_port_int8_slice``),
and the port's own calibration (``quantize_engine``) rebuilds the JAX wire
format: the same entries, shapes and dtypes, the chains' int8 weights
equal, the RDB's within one step at a rounding boundary, scales to rtol
5e-6.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu.models import api as japi
from nerve_tpu.models import enhancement_engine as jeng
from nerve_tpu.models import streaming as jstream
from nerve_tpu.models import super_resolution as jsr
from nerve_tpu.models.quantize import quantize_engine_variables
from nerve_tpu_torch import enhance
from nerve_tpu_torch.models import (
    SuperResolutionNet,
    adaptive_engine_from_flax,
    api,
    engine_from_flax,
    estimate_sr_flops,
    quantize_engine,
    select_mode_for_budget,
    sr_from_flax,
    streaming_prime,
    streaming_step,
    streaming_step_pair,
)
from nerve_tpu_torch.models.bridge import _flatten
from nerve_tpu_torch.models.enhancement_engine import EngineConfig
from test_torch_port_models import randomize

JCFG = jeng.EngineConfig(recovery_base_channels=8, sr_num_features=16, sr_num_residual_blocks=2)
TCFG = EngineConfig(recovery_base_channels=8, sr_num_features=16, sr_num_residual_blocks=2)
F32_REL, BF16_MAX, BF16_MEAN = 1e-4, 3.2e-2, 1e-3
INT8_MAX, INT8_MEAN = 1e-4, 1e-6
# bf16 rounded where the source says; compiled without backend optimisation,
# which costs less time and computes the same numbers.
EXACT = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}
H = W = 32
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _seeded(module, *args, seed=0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    v = randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)
    params = v["params"].get("engine", v["params"])
    params["enhancement_strength"] = np.full((1,), 0.75, np.float32)
    return v


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    video_u8 = rng.integers(0, 256, (1, 5, H, W, 3), dtype=np.uint8)
    mask = np.zeros((1, H, W, 1), np.float32)
    mask[0, 6:20, 9:27] = 1.0
    frames = video_u8.astype(np.float32) / 255.0
    full = jeng.EnhancementEngine(JCFG)
    light = jeng.EnhancementEngine(JCFG.with_mode("lightweight"))
    return dict(video_u8=video_u8, frames=frames, mask=mask,
                vars=_seeded(full, jnp.asarray(frames), None, jnp.asarray(mask)),
                light_vars=_seeded(light, jnp.asarray(frames)), cache={})


def _subset(variables, mode):
    """The full engine's variables a mode's engine holds."""
    keep = {"full": ("frame_recovery", "super_resolution"),
            "sr_only": ("super_resolution",), "recovery_only": ("frame_recovery",)}[mode]
    return {c: {k: v for k, v in tree.items() if k in keep or k == "enhancement_strength"}
            for c, tree in variables.items()}


def jax_engine(data, mode, dtype="float32", masked=True):
    """The JAX engine's output dict (numpy float32), compiled once."""
    key = (mode, dtype, masked)
    if key not in data["cache"]:
        module = jeng.EnhancementEngine(JCFG.with_mode(mode), DTYPES[dtype][0])
        v = data["light_vars"] if mode == "lightweight" else _subset(data["vars"], mode)
        mask = jnp.asarray(data["mask"]) if masked else None
        fn = jax.jit(lambda v, x, m: module.apply(v, x, None, m), compiler_options=EXACT)
        data["cache"][key] = (v, _np(fn(v, jnp.asarray(data["frames"]), mask)))
    return data["cache"][key]


def port_engine(v, mode, dtype="float32"):
    return engine_from_flax(v, TCFG.with_mode(mode), device="cpu", dtype=DTYPES[dtype][1])


def check(got, ref, dtype="float32", rel=F32_REL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    if dtype == "float32":
        assert d.max() <= rel * np.abs(ref).max(), (d.max(), np.abs(ref).max())
    else:
        assert d.max() <= BF16_MAX and d.mean() <= BF16_MEAN, (d.max(), d.mean())


def check_outputs(got, ref, data, dtype="float32"):
    assert sorted(got) == sorted(ref)
    for k in ref:
        check(got[k], ref[k], dtype)
    if "recovered" in ref:
        outside = data["mask"][..., 0] == 0
        centre = data["frames"][:, 2]
        np.testing.assert_array_equal(got["recovered"].numpy()[outside], centre[outside])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("mode", ["full", "sr_only", "recovery_only", "lightweight"])
def test_engine_modes_match_jax(data, mode, masked):
    """Every mode with and without a mask, float32. sr_only and lightweight
    have no recovery stage, so the JAX engine ignores a mask there: the
    port's masked output must equal its unmasked one, which is held
    against JAX's."""
    jax_masked = masked and mode in ("full", "recovery_only")
    v, ref = jax_engine(data, mode, masked=jax_masked)
    eng = port_engine(v, mode)
    x = torch.from_numpy(data["frames"])
    got = eng(x, None, torch.from_numpy(data["mask"]) if masked else None)
    check_outputs(got, ref, data)
    if masked and not jax_masked:
        plain = eng(x)
        assert all(torch.equal(got[k], plain[k]) for k in plain)
    if mode != "recovery_only":
        assert got["enhanced"].shape == (1, 2 * H, 2 * W, 3)


def test_engine_bf16_matches_jax(data):
    v, ref = jax_engine(data, "full", "bfloat16")
    eng = port_engine(v, "full", "bfloat16")
    got = eng(torch.from_numpy(data["frames"]), None, torch.from_numpy(data["mask"]))
    assert got["super_resolved"].dtype == torch.bfloat16 and got["enhanced"].dtype == torch.float32
    check_outputs(got, ref, data, "bfloat16")


def test_enhance_video_with_masks_matches_jax(data):
    """Three frames, each the centre of its clamped 5-frame window, each with
    its own mask (frame 1's empty)."""
    video = data["frames"][:, :3]
    masks = np.stack([data["mask"], np.zeros_like(data["mask"]), data["mask"][:, ::-1]], 1)
    module = jeng.EnhancementEngine(JCFG)
    ref = jax.jit(functools.partial(module.apply, method="enhance_video"),
                  compiler_options=EXACT)(
        data["vars"], jnp.asarray(video), jnp.asarray(masks))
    eng = port_engine(data["vars"], "full")
    got = eng.enhance_video(torch.from_numpy(video), torch.from_numpy(masks))
    assert got.shape == (1, 3, 2 * H, 2 * W, 3)
    check(got, np.asarray(ref))


def test_adaptive_engine_matches_jax(data):
    """The adaptive engine at budget 0.8, preference 0.7 (mode full, run
    mask-free as the reference's adaptive forward is): complexity, strength
    and every output; then the budgets' modes, and the facade switching to
    them."""
    module = jeng.AdaptiveEnhancementEngine(JCFG)
    frames = jnp.asarray(data["frames"])
    v = _seeded(module, frames, seed=3)
    ref = _np(jax.jit(lambda v, x: module.apply(v, x, 0.8, 0.7), compiler_options=EXACT)(
        v, frames))
    eng = adaptive_engine_from_flax(v, TCFG, device="cpu")
    got = eng(torch.from_numpy(data["frames"]), 0.8, 0.7)
    assert sorted(got) == sorted(ref)
    for k in ref:
        check(got[k], ref[k])
    assert 0.3 <= float(got["enhancement_strength"]) <= 1.0
    assert 0.0 <= float(got["complexity"].min()) and float(got["complexity"].max()) <= 1.0
    budgets = {0.1: "lightweight", 0.29: "lightweight", 0.3: "sr_only", 0.59: "sr_only",
               0.6: "full", 1.0: "full"}
    for b, mode in budgets.items():
        assert select_mode_for_budget(b) == jeng.select_mode_for_budget(b) == mode
    facade = api.AdaptiveEnhancementEngine(TCFG, device="cpu")
    for b in (0.2, 0.5, 0.9):
        out = facade(np.moveaxis(data["video_u8"], -1, 2), b, 0.5)
        assert facade.config == TCFG.with_mode(select_mode_for_budget(b))
        assert out["enhanced"].shape == (1, 3, 2 * H, 2 * W)


def test_facade_channel_first_and_uint8(data):
    """uint8 (B, T, C, H, W) frames are scaled by 1/255 on the device, a
    uint8 0/1 mask is not; outputs come channel-first; ``to_uint8`` rounds
    half to even and clips; ``enhance_video`` takes (T, C, H, W) and
    ``as_uint8``."""
    v, ref = jax_engine(data, "full")
    eng = api.EnhancementEngine(TCFG, device="cpu")
    eng.load_variables(v)
    video = np.moveaxis(data["video_u8"], -1, 2)
    mask_u8 = np.moveaxis(data["mask"], -1, 1).astype(np.uint8)
    got = eng(video, corruption_mask=mask_u8)
    for k in ref:
        check(got[k].movedim(-3, -1), ref[k])
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(api.from_uint8(torch.from_numpy(every)).numpy(),
                                  every.astype(np.float32) / 255.0)
    assert torch.equal(api.to_uint8(torch.tensor([-0.2, 0.5 / 255, 1.5 / 255, 0.999, 1.7])),
                       torch.tensor([0, 0, 2, 255, 255], dtype=torch.uint8))
    assert np.array_equal(api.to_uint8(got["enhanced"]).numpy(),
                          np.asarray(japi.to_uint8(got["enhanced"].numpy())))
    out = eng.enhance_video(video[0], as_uint8=True)
    assert out.shape == (5, 3, 2 * H, 2 * W) and out.dtype == torch.uint8
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.EnhancementEngine(TCFG)


def test_model_info_flops_and_modes(data):
    """``get_model_info`` counts as the JAX facade does (its params tree);
    ``get_flops`` is ``estimate_sr_flops``; a mode switch keeps the weights
    the modes share."""
    eng = api.EnhancementEngine(TCFG, device="cpu")
    eng.load_variables(data["vars"])
    params = data["vars"]["params"]

    def count(tree):
        return int(sum(np.size(x) for x in jax.tree_util.tree_leaves(tree)))

    info = eng.get_model_info()
    assert info["parameters"] == {"total": count(params), "trainable": count(params),
                                  "frame_recovery": count(params["frame_recovery"]),
                                  "super_resolution": count(params["super_resolution"])}
    assert eng.get_num_parameters() == count(params)
    sr_before = eng.engine.super_resolution.rdbs.rdb0_lff_kernel.clone()
    eng.set_enhancement_mode("sr_only")
    assert not hasattr(eng.engine, "frame_recovery")
    assert torch.equal(eng.engine.super_resolution.rdbs.rdb0_lff_kernel, sr_before)
    assert eng.get_model_info()["config"]["frame_recovery_enabled"] is False
    sr = api.SuperResolutionNet(num_features=16, num_residual_blocks=2, device="cpu")
    for size in ((128, 128), (36, 52)):
        assert sr.get_flops(size) == jsr.estimate_sr_flops(size) == estimate_sr_flops(size)
    assert sr.forward_single(np.moveaxis(data["frames"][:, 0], -1, 1)).shape == (1, 3, 64, 64)


SR_CFG = dict(scale_factor=2, num_features=16, num_residual_blocks=2, temporal_window=1)


@pytest.fixture(scope="module")
def sr(data):
    module = jsr.SuperResolutionNet(**SR_CFG)
    x = jnp.asarray(data["frames"][:, :3])
    v = _seeded_sr(module, x)
    return module, v, sr_from_flax(v, device="cpu", **SR_CFG)


def _seeded_sr(module, x):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 5)


def test_return_intermediate_matches_jax(data, sr):
    module, v, model = sr
    x = data["frames"][:, :3]
    out, inter = jax.jit(functools.partial(module.apply, return_intermediate=True),
                         compiler_options=EXACT)(v, jnp.asarray(x))
    got, ginter = model(torch.from_numpy(x), return_intermediate=True)
    check(got, out)
    assert sorted(ginter) == sorted(inter) == ["aggregated", "aligned", "features"]
    for k in inter:
        check(ginter[k], inter[k])
    assert ginter["features"].shape == (1, 3, H, W, 16)


def test_streaming_step_pair_matches_jax(data, sr):
    """Two frames fed at once: equal to JAX's pair step and to two single
    steps of the port."""
    module, v, model = sr
    video = [data["frames"][:, i] for i in range(4)]

    @functools.partial(jax.jit, compiler_options=EXACT)
    def jax_pair(f0, f1, f2, f3):
        carry = jstream.streaming_prime(module, v, f0)
        carry = jstream.streaming_step(module, v, carry, f1)[0]
        return jstream.streaming_step_pair(module, v, carry, f2, f3)[1]

    ra, rb = jax_pair(*(jnp.asarray(f) for f in video))
    t = [torch.from_numpy(f) for f in video]
    tc = streaming_step(model, streaming_prime(model, t[0]), t[1])[0]
    c2, (ga, gb) = streaming_step_pair(model, tc, t[2], t[3])
    check(ga, ra)
    check(gb, rb)
    c1, sa = streaming_step(model, tc, t[2])
    c1, sb = streaming_step(model, c1, t[3])
    check(ga, sa.numpy())
    check(gb, sb.numpy())
    assert len(c2) == len(c1) and all(torch.equal(a, b) for a, b in zip(c2, c1))


def test_int8_engine_matches_jax(data):
    """JAX's ``quantize_engine_variables`` over the masked window (recovery
    first, its frame in the SR window's centre): the port serves that state
    as JAX does, and ``quantize_engine`` rebuilds it."""
    qcfg = dict(sr_quantized=True, sr_quantized_chains=True)
    jmodule = jeng.EnhancementEngine(dataclasses.replace(JCFG, **qcfg))
    frames, mask = jnp.asarray(data["frames"]), jnp.asarray(data["mask"])
    qvars = jax.tree_util.tree_map(np.array, quantize_engine_variables(
        jmodule, data["vars"], frames, mask))
    ref = _np(jax.jit(lambda v, x, m: jmodule.apply(v, x, None, m), compiler_options=EXACT)(
        qvars, frames, mask))
    tcfg = dataclasses.replace(TCFG, **qcfg)
    eng = engine_from_flax(qvars, tcfg, device="cpu")
    got = eng(torch.from_numpy(data["frames"]), None, torch.from_numpy(data["mask"]))
    for k in ref:
        d = np.abs(got[k].numpy() - ref[k])
        assert d.max() <= INT8_MAX and d.mean() <= INT8_MEAN, (k, d.max(), d.mean())
    # The port's own calibration of the float weights.
    state = eng.state_dict()
    want = _flatten(qvars["quant"])
    with torch.no_grad():
        for k in want:
            state[k].zero_()
    quantize_engine(eng, torch.from_numpy(data["frames"]), torch.from_numpy(data["mask"]),
                    device="cpu")
    flips = total = 0
    for k, ref_q in want.items():
        got_q = state[k].numpy()
        assert got_q.shape == ref_q.shape and got_q.dtype == ref_q.dtype, k
        if ref_q.dtype != np.int8:
            np.testing.assert_allclose(got_q, ref_q, rtol=5e-6, atol=0, err_msg=k)
        elif ".rdbs." in k:
            assert np.abs(got_q.astype(int) - ref_q).max() <= 1, k
            flips += int((got_q != ref_q).sum())
            total += ref_q.size
        else:
            assert np.array_equal(got_q, ref_q), k
    assert flips <= 1e-4 * total, (flips, total)
    # The facade calibrates through quantize_engine with a zero mask.
    facade = api.EnhancementEngine(TCFG, device="cpu")
    facade.load_variables(data["vars"])
    facade.quantize_int8(np.moveaxis(data["video_u8"], -1, 2), chains=True)
    quantize_engine(eng, torch.from_numpy(data["frames"]), torch.zeros(1, H, W, 1),
                    device="cpu")
    fstate = facade.module.state_dict()
    assert all(torch.equal(fstate[k], state[k]) for k in want)
    with pytest.raises(ValueError, match="no quantised site"):
        quantize_engine(port_engine(data["vars"], "full"), torch.from_numpy(data["frames"]),
                        device="cpu")


def test_engine_bridge_is_strict_and_inference_only(data):
    v = _subset(data["vars"], "full")
    bad = {c: dict(t) for c, t in v.items()}
    bad["params"]["frame_recovery"] = dict(bad["params"]["frame_recovery"])
    del bad["params"]["frame_recovery"]["decoder"]
    with pytest.raises(KeyError, match="missing"):
        engine_from_flax(bad, TCFG, device="cpu")
    # Training mode (``test_torch_port_recovery_train.py`` holds it against
    # JAX): the call runs under autograd and moves the running statistics;
    # eval mode serves under inference mode.
    eng = port_engine(v, "full").train()
    stats0 = {k: b.clone() for k, b in eng.state_dict().items() if k.endswith((".mean", ".var"))}
    out = eng(torch.from_numpy(data["frames"]), None, torch.from_numpy(data["mask"]))
    assert out["enhanced"].requires_grad
    assert any(not torch.equal(b, eng.state_dict()[k]) for k, b in stats0.items())
    assert eng.eval()(torch.from_numpy(data["frames"]))["enhanced"].is_inference()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SuperResolutionNet(num_features=16, num_residual_blocks=1)


def test_enhance_cli_on_the_cpu(tmp_path, capsys):
    """``python -m nerve_tpu_torch.enhance``: a (T, H, W, C) uint8 .npy and
    masks from ``--masks``, uint8 out, one JSON line."""
    rng = np.random.default_rng(7)
    src, masks, dst = tmp_path / "in.npy", tmp_path / "m.npy", tmp_path / "out.npy"
    np.save(src, rng.integers(0, 256, (3, 16, 24, 3), dtype=np.uint8))
    m = np.zeros((3, 1, 16, 24), np.float32)
    m[1, :, 4:9, 5:14] = 1
    np.save(masks, m)
    rc = enhance.main([str(src), "-o", str(dst), "--masks", str(masks), "--device", "cpu",
                       "--sr-features", "16", "--sr-blocks", "1", "--strength", "0.5"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = np.load(dst)
    assert rc == 0 and out.shape == (3, 3, 32, 48) and out.dtype == np.uint8
    assert summary["output_shape"] == [3, 3, 32, 48] and summary["backend"] == "cpu"
    assert summary["mode"] == "full" and summary["int8"] == "off"
