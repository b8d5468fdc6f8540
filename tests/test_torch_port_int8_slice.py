"""The port's int8 serving of the SR network against the JAX package's.

A narrow SuperResolutionNet (16 features, 2 RDBs, temporal window 1, flow
at half resolution) with ``quantized`` (the int8 RDB stack) and
``quantized_chains`` (int8 feature head, flow head, attention logits, gff
and upsampler), every parameter and BatchNorm statistic seeded non-zero.
JAX calibrates it with ``quantize_sr_variables``; the bridge carries the
``"quant"`` collection into the port's buffers, and both serve 16×24
frames on the CPU (the port's model with ``device="cpu"``).

Limits on the [0, 1] output, int8 port vs int8 JAX: max|Δ| ≤ 1e-4 and
mean|Δ| ≤ 1e-6. Both run the same int8 arithmetic on the same int8 state;
the float32 parts around it (the depthwise body, warp, softmax, CBAM) sum
in other orders, which is float32 rounding on the output. Measured max|Δ|
2.4e-7 and mean|Δ| 2.5e-8 in every case here: no requantised value lands
on the other side of a rounding boundary. The limits are the float32
slice's level (``test_torch_port_slice.py``) for the maximum and 40× the
measured mean. int8 against the float32 model of the same weights
measured 63.1 dB PSNR.
"""

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu.models import streaming as jstream
from nerve_tpu.models.layers import QuantizableConv as JaxQuantizableConv
from nerve_tpu.models.quantize import quantize_sr_variables
from nerve_tpu.models.super_resolution import RDBStack as JaxRDBStack
from nerve_tpu.models.super_resolution import SuperResolutionNet as JaxSR
from nerve_tpu.ops import rdb_int8 as jrdb_int8
from nerve_tpu_torch.models import (
    SuperResolutionNet,
    calibrate_sr_scales,
    load_flax_variables,
    quantize_sr,
    sr_from_flax,
    streaming_prime,
    streaming_step,
)
from nerve_tpu_torch.models.bridge import _flatten
from nerve_tpu_torch.ops import dispatch
from test_torch_port_models import randomize

CFG = dict(scale_factor=2, num_features=16, num_residual_blocks=2,
           temporal_window=1, flow_downsample=2)
QCFG = dict(CFG, quantized=True, quantized_chains=True)
MAX_ABS, MEAN_ABS = 1e-4, 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def setup():
    video = np.random.default_rng(0).random((1, 5, 16, 24, 3)).astype(np.float32)
    calib = np.concatenate([video[:, 0:3], video[:, 2:5]], axis=0)
    init = jax.jit(JaxSR(**CFG).init)(jax.random.PRNGKey(0), jnp.asarray(video[:, :3]))
    fvars = randomize(init, seed=1)
    jmodel = JaxSR(**QCFG)
    qvars = _np_tree(quantize_sr_variables(jmodel, fvars, calib))
    return dict(video=video, calib=calib, jmodel=jmodel, fvars=fvars, qvars=qvars,
                tmodel=sr_from_flax(qvars, device="cpu", **QCFG))


def _check(got, ref):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert 0.0 <= got.min() and got.max() <= 1.0
    d = np.abs(got - ref)
    assert d.max() <= MAX_ABS and d.mean() <= MEAN_ABS, (d.max(), d.mean())


def test_int8_streaming_step_packed_matches_jax(setup):
    s = setup
    jm, v, video = s["jmodel"], s["qvars"], s["video"]
    jcarry = jstream.streaming_prime(jm, v, jnp.asarray(video[:, 0]))
    tcarry = streaming_prime(s["tmodel"], torch.from_numpy(video[:, 0]))
    jstep = jax.jit(lambda c, x: jstream.streaming_step(jm, v, c, x, "packed"))
    for t in (1, 2):
        jcarry, ref = jstep(jcarry, jnp.asarray(video[:, t]))
        tcarry, got = streaming_step(s["tmodel"], tcarry, torch.from_numpy(video[:, t]),
                                     "packed")
    assert tuple(got.shape) == (1, 32, 48 * 3)
    _check(got, ref)


def test_int8_states_are_packed_once(setup):
    """Each int8 state (five chain sites, the RDB stack) packs its weights
    for the kernels once, at its first serving call, and keeps them: loading
    the variables drops the packs, the first step packs all six, later steps
    none."""
    model = copy.deepcopy(setup["tmodel"])
    load_flax_variables(model, setup["qvars"])
    frames = [torch.from_numpy(f) for f in setup["video"][0, :4, None]]
    dispatch.reset_launches()
    carry = streaming_prime(model, frames[0])
    carry, _ = streaming_step(model, carry, frames[1], "packed")
    assert dispatch.packs["int8"] == 6
    dispatch.reset_launches()
    for frame in frames[2:]:
        carry, _ = streaming_step(model, carry, frame, "packed")
    assert dispatch.packs["int8"] == 0


def test_int8_batched_forward_matches_jax(setup):
    s = setup
    ref = jax.jit(s["jmodel"].apply)(s["qvars"], jnp.asarray(s["calib"]))
    _check(s["tmodel"](torch.from_numpy(s["calib"])), ref)


@pytest.mark.parametrize("flag,sites", [("quantized", ["rdbs"]), (
    "quantized_chains", ["feature_extractor", "motion_estimator", "temporal_aggregator", "gff",
                         "upsampler"])])
def test_int8_flag_alone_matches_jax(setup, flag, sites):
    """Each flag alone: the int8 RDB stack only, or the int8 chains only.
    Their quant entries are those of the full calibration, since every site
    calibrates on the exact (unquantised) activations."""
    s = setup
    cfg = dict(CFG, **{flag: True})
    qvars = {**s["fvars"], "quant": {k: s["qvars"]["quant"][k] for k in sites}}
    tmodel = sr_from_flax(qvars, device="cpu", **cfg)
    window = s["video"][:, 1:4]
    ref = jax.jit(JaxSR(**cfg).apply)(qvars, jnp.asarray(window))
    _check(tmodel(torch.from_numpy(window)), ref)


def test_quantize_sr_reproduces_jax_quant(setup):
    """The port's calibration refills the buffers the bridge filled from JAX.

    Its activations come through float32 layers that sum in another order
    (1e-5 of max|ref| in ``test_torch_port_models.py``), so scales agree to rtol 5e-6
    (measured 7.4e-7). The chains' int8 weights do not depend on the scales
    and are equal; the RDB's are folded with them before rounding, so an
    entry at a rounding boundary may move one step (measured 6 of 3e5).
    """
    s = setup
    model = copy.deepcopy(s["tmodel"])
    want = _flatten(s["qvars"]["quant"])
    state = model.state_dict()
    with torch.no_grad():
        for k in want:
            state[k].zero_()
    quantize_sr(model, torch.from_numpy(s["calib"]), device="cpu")
    flips = total = 0
    for k, ref in want.items():
        got = state[k].numpy()
        if ref.dtype != np.int8:
            np.testing.assert_allclose(got, ref, rtol=5e-6, atol=0, err_msg=k)
        elif k.startswith("rdbs."):
            assert got.dtype == np.int8 and np.abs(got.astype(int) - ref).max() <= 1, k
            flips += int((got != ref).sum())
            total += ref.size
        else:
            assert got.dtype == np.int8 and np.array_equal(got, ref), k
    assert flips <= 1e-4 * total, (flips, total)


def test_calibrate_sr_scales_matches_jax_quant(setup):
    """The RDB stack's activation scales, read back from the JAX wire
    format: s_in is meta row 2, each dense layer's 1/s is meta row 3."""
    s = setup
    scales = calibrate_sr_scales(s["tmodel"], torch.from_numpy(s["calib"])).numpy()
    growth = 32
    for b, (_wq, _dq, meta) in enumerate(s["qvars"]["quant"]["rdbs"]["qchain"]):
        np.testing.assert_allclose(scales[b, 0], meta[2, 0], rtol=5e-6)
        np.testing.assert_allclose(1.0 / scales[b, 1:], meta[3, :5 * growth:growth], rtol=5e-6)


def test_int8_tracks_float32(setup):
    """int8 serving against the float32 model of the same weights: > 30 dB
    PSNR on the [0, 1] output (the JAX package's own level)."""
    s = setup
    window = torch.from_numpy(s["calib"])
    ref = sr_from_flax(s["fvars"], device="cpu", **CFG)(window)
    got = s["tmodel"](window)
    psnr = -10 * np.log10(float(((got - ref) ** 2).mean()) + 1e-12)
    assert psnr > 30, psnr


@pytest.mark.parametrize("fault", ["missing", "unused", "shape", "dtype"])
def test_bridge_is_strict_about_quant(setup, fault):
    quant = jax.tree_util.tree_map(lambda a: a, setup["qvars"]["quant"])
    quant = {k: dict(v) for k, v in quant.items()}
    (wq, meta), = quant["gff"]["qconv"][0]
    if fault == "missing":
        del quant["upsampler"]
        err, match = KeyError, "upsampler.qconv"
    elif fault == "unused":
        quant["gff"]["qextra"] = np.zeros(1, np.float32)
        err, match = KeyError, "gff.qextra"
    elif fault == "shape":
        quant["gff"]["qconv"] = (((wq, meta[:, 1:]),), quant["gff"]["qconv"][1])
        err, match = ValueError, "gff.qconv.0.0.1"
    else:  # int8 weights handed over as float32
        quant["gff"]["qconv"] = (((wq.astype(np.float32), meta),), quant["gff"]["qconv"][1])
        err, match = TypeError, "gff.qconv.0.0.0"
    model = SuperResolutionNet(device="cpu", **QCFG)
    with pytest.raises(err, match=match):
        load_flax_variables(model, {**setup["fvars"], "quant": quant})


def test_int8_is_inference_only(setup):
    """Only serving is int8 throughout: in training mode the int8 model
    trains its chain sites in float and keeps its RDB stack int8 without a
    gradient (``test_train_mode_of_the_int8_sites``), and back in eval mode
    it serves its int8 state unchanged."""
    model = copy.deepcopy(setup["tmodel"])
    x = torch.from_numpy(setup["calib"])
    served = model(x)
    out = model.train()(x)
    assert out.requires_grad and torch.isfinite(out).all()
    out.square().mean().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is None for k, g in grads.items() if k.startswith("rdbs."))
    assert grads["gff.kernel"].abs().max() > 0 and grads["upsampler.conv.kernel"].abs().max() > 0
    model.load_state_dict(setup["tmodel"].state_dict())  # the statistics moved in training
    assert torch.equal(model.eval()(x), served)


def test_entry_points_default_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default places the model there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SuperResolutionNet(**QCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sr_from_flax(setup["qvars"], **QCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_sr(setup["tmodel"], torch.from_numpy(setup["calib"]))


def _jax_grads(fn, variables, x, g):
    """jax.grad of ⟨fn(variables, x), g⟩ in the params and in x."""
    def inner(params, x):
        return jnp.sum(fn({**variables, "params": params}, x) * g)

    gp, gx = jax.jit(jax.grad(inner, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    return _np_tree(gp), np.asarray(gx)


def _port_grads(mod, x, g):
    """(output, {param name: gradient}, input gradient), None as zeros."""
    tx = torch.from_numpy(x).requires_grad_()
    out = mod(tx)
    if out.requires_grad:
        (out * torch.from_numpy(g)).sum().backward()
    zeros = torch.zeros_like
    return (out.detach(), {k: (p.grad if p.grad is not None else zeros(p)).numpy()
                           for k, p in mod.named_parameters()},
            (tx.grad if tx.grad is not None else zeros(tx)).numpy())


def _close_rel(got, ref, rel, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max(), what


def test_train_mode_of_the_int8_sites(setup):
    """Training mode at the int8 sites (ROADMAP Queue 3, item 3). The JAX
    package splits under ``train=True``: its int8 chains run in float (each
    chain site passes "off" when training), while its int8 RDB stack stays
    int8, since ``RDBStack.__call__`` takes no ``train`` and
    ``SuperResolutionNet`` passes it none. The port does the same, and its
    gradients are ``jax.grad``'s: through the int8 stack none (its weights
    are the "quant" collection, not parameters, and ``jnp.round`` passes no
    gradient to its input), through a chain site its float layer's. Forward
    within 1e-6 of max|ref|, gradients within 1e-5 of max|ref| (all zero
    where JAX's are)."""
    s = setup
    x = np.random.default_rng(5).random((1, 8, 12, 16)).astype(np.float32)
    g = np.random.default_rng(6).standard_normal((1, 8, 12, 16)).astype(np.float32)
    # JAX: the RDB stack has no train to turn int8 off; it gives the int8 result.
    assert "train" not in inspect.signature(JaxRDBStack.__call__).parameters
    stack = {"params": s["qvars"]["params"]["rdbs"], "quant": s["qvars"]["quant"]["rdbs"]}
    jstack = JaxRDBStack(16, 2, quantized=True)
    got = jax.jit(jstack.apply)(stack, x)
    int8 = jrdb_int8.rdb_chain_int8_apply(jnp.asarray(x), stack["quant"]["qchain"],
                                          out_dtype=jnp.float32)
    exact = jax.jit(JaxRDBStack(16, 2).apply)({"params": stack["params"]}, x)
    # Jitted and eager float32 epilogues differ by an ulp; int8 moves by ~1e-2.
    np.testing.assert_allclose(np.asarray(got), np.asarray(int8), rtol=0, atol=1e-6)
    assert np.abs(np.asarray(got) - np.asarray(exact)).max() > 1e-3
    jgp, jgx = _jax_grads(jstack.apply, stack, x, g)
    assert not np.abs(jgx).any() and not any(np.abs(v).any() for v in jgp.values())
    # The port's stack in training mode: int8, and no gradient.
    model = copy.deepcopy(s["tmodel"]).train()
    out, grads, gx = _port_grads(model.rdbs, x, g)
    np.testing.assert_allclose(out.numpy(), np.asarray(got), rtol=0, atol=1e-6)
    assert not out.requires_grad and not gx.any()
    assert set(grads) == set(jgp) and not any(v.any() for v in grads.values())
    # JAX: a chain site in training runs its float layer, in eval its int8 state.
    gff = {"params": s["qvars"]["params"]["gff"], "quant": s["qvars"]["quant"]["gff"]}
    conv = JaxQuantizableConv(16, 16, act="relu", chain_quant="serve")
    trained = np.asarray(conv.apply(gff, x, train=True))
    np.testing.assert_allclose(trained, np.asarray(JaxQuantizableConv(16, 16, act="relu").apply(
        {"params": gff["params"]}, x)), rtol=0, atol=1e-6)
    assert np.abs(trained - np.asarray(conv.apply(gff, x))).max() > 1e-3
    jgp, jgx = _jax_grads(lambda v, x: conv.apply(v, x, train=True), gff, x, g)
    # The port's site in training mode: the float layer, its gradients JAX's.
    out, grads, gx = _port_grads(model.gff, x, g)
    _close_rel(out.numpy(), trained, 1e-6, "gff forward")
    _close_rel(gx, jgx, 1e-5, "gff d/dx")
    for k, v in _flatten(jgp).items():
        _close_rel(grads[k], v, 1e-5, f"gff d/d{k}")
    model.eval()
    eval_out = model.gff(torch.from_numpy(x))
    assert np.abs(eval_out.numpy() - trained).max() > 1e-3  # int8 again in eval
