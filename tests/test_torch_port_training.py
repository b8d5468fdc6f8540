"""The port's training path against the JAX package's, on the CPU.

(1) Each kernel op's gradient (``torch.autograd.Function``: the forward by
dispatch, here the plain version; the backward the vjp of the plain version
recomputed) against ``jax.vjp`` of the JAX op, which on the CPU is the vjp
of its XLA formulation, the same one its ``custom_vjp`` backward takes: the
conv chain on a list input, a 2-block RDB stack, the correlation, and the
warp at random flows, at a zero flow and at integer flows (where
``jnp.abs``' gradient of 1 at 0 and ``jnp.maximum``'s ½ at a tie decide),
and at a flow that pushes every sample off the image. float32, within 1e-5
of max|ref| per gradient. Measured ≤ 6e-7.

(2) One train step of a small ``SuperResolutionNet`` (8 features, 1 RDB,
window 1, 16 × 16 LR, batch 2) in float32: every weight seeded, the last
flow layer zero, so the flow is 0 and the warp's gradient takes the tie
rules. The loss, every gradient by flax path and the updated BatchNorm
statistics against ``make_sr_train_step``'s (its raw gradients recorded by
an identity transformation chained before the optimiser); then the
parameters after 3 steps of AdamW at the default learning rate with one
epoch of warm-up (the first rate 0), the cosine and global-norm clipping
(which scales these gradients), through ``models.bridge.flax_variables``.
Within 1e-4 of max|ref| per tensor; measured ≤ 3e-6.

(3) The same step in bfloat16 (JAX with excess precision off): the loss
within 1e-4 relative (measured 3.3e-6); all gradients together within 1e-2
in relative L2 norm (measured 2.9e-3), each tensor within 0.5 (measured
0.24 at most: the feature body's BatchNorm scales and biases, whose
gradients are sums over the batch that cancel, rounded to bfloat16 at
different sums in the two frameworks; a missing or wrong-signed gradient is
1 or more).

Also ``fit_sr``'s resume (2 epochs straight equal 1 epoch plus a resumed
one) and ``python -m nerve_tpu_torch.train_baseline --device cpu``.
"""

import copy
import json
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerve_tpu import training as jtraining
from nerve_tpu.config.schema import TrainingConfig as JaxTrainingConfig
from nerve_tpu.models.super_resolution import SuperResolutionNet as JaxSR
from nerve_tpu.ops import conv_chain as jcc
from nerve_tpu.ops import correlation as jcorr
from nerve_tpu.ops import rdb as jrdb
from nerve_tpu.ops import warp as jwarp
from nerve_tpu_torch import ops, training
from nerve_tpu_torch.config.schema import TrainingConfig
from nerve_tpu_torch.models import SuperResolutionNet, flax_variables, load_flax_variables
from nerve_tpu_torch.utils import data as data_lib
from nerve_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_port_models import randomize

# XLA rounds each bfloat16 intermediate where its source does; LLVM's
# optimisations off compile the reference in less time.
XLA_OPTS = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
OP_REL = 1e-5
STEP_REL = 1e-4
BF16_LOSS_REL, BF16_GRADS_L2, BF16_TENSOR_L2 = 1e-4, 1e-2, 0.5
CFG = dict(scale_factor=2, num_features=8, num_residual_blocks=1, temporal_window=1)
TRAIN = dict(epochs=4, warmup_epochs=1, grad_clip_norm=0.05)  # steps_per_epoch 1


def _r(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _assert_rel(got, ref, rel, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    scale = float(np.max(np.abs(ref)))
    err = float(np.max(np.abs(got - ref)))
    assert err <= rel * scale, f"{what}: max|d| {err:.3e} > {rel} * {scale:.3e}"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees(got, ref, rel, what):
    got, ref = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, ref))
    assert set(got) == set(ref), f"{what}: paths differ {set(got) ^ set(ref)}"
    for k in ref:
        _assert_rel(got[k], ref[k], rel, f"{what} {k}")


def _jax_vjp(fn, g, *args):
    """(fn(*args), its vjp at ``g``), one compiled program."""
    def both(g, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(g)

    return jax.jit(both, compiler_options=XLA_OPTS)(jnp.asarray(g), *args)


def test_conv_chain_vjp_list_input():
    rng = np.random.default_rng(0)
    xs = [_r(rng, 2, 9, 11, 8) for _ in range(3)]
    ws = [_r(rng, 3, 3, 24, 16, std=0.2), _r(rng, 1, 1, 16, 16, std=0.3),
          _r(rng, 3, 3, 16, 5, std=0.2)]
    bs = [_r(rng, 16, std=0.1), _r(rng, 16, std=0.1), _r(rng, 5, std=0.1)]
    acts = ("relu", "relu", "none")
    g = _r(rng, 2, 9, 11, 5)
    out, ref = _jax_vjp(lambda x, w, b: jcc.conv_chain_apply(list(x), list(zip(w, b, acts))),
                        g, xs, ws, bs)
    txs, tws, tbs = ([_leaf(a) for a in group] for group in (xs, ws, bs))
    y = ops.conv_chain_apply(txs, list(zip(tws, tbs, acts)))
    assert y.grad_fn is not None and "ConvChain" in type(y.grad_fn).__name__
    _assert_rel(y, out, OP_REL, "forward")
    y.backward(torch.from_numpy(g))
    for got, want, name in ((txs, ref[0], "x"), (tws, ref[1], "w"), (tbs, ref[2], "b")):
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_rel(a.grad, b, OP_REL, f"d{name}{i}")


def _rdb_block(rng, c, g, layers):
    params, cin = [], c
    for _ in range(layers):
        params += [_r(rng, 3, 3, cin, g, std=0.3), _r(rng, g, std=0.1)]
        cin += g
    return params + [_r(rng, cin, c, std=0.3), _r(rng, c, std=0.1)]


def test_rdb_chain_vjp_two_blocks():
    rng = np.random.default_rng(1)
    plist = [_rdb_block(rng, 8, 4, 3) for _ in range(2)]
    x, g = _r(rng, 2, 7, 9, 8), _r(rng, 2, 7, 9, 8)
    out, (dx, dp) = _jax_vjp(lambda a, p: jrdb.rdb_chain_apply(a, p), g, x, plist)
    tx = _leaf(x)
    tp = [[_leaf(a) for a in block] for block in plist]
    y = ops.rdb_chain_apply(tx, tp)
    assert "RDBChain" in type(y.grad_fn).__name__
    _assert_rel(y, out, OP_REL, "forward")
    y.backward(torch.from_numpy(g))
    _assert_rel(tx.grad, dx, OP_REL, "dx")
    for b, (got, want) in enumerate(zip(tp, dp)):
        for i, (a, w) in enumerate(zip(got, want)):
            _assert_rel(a.grad, w, OP_REL, f"block {b} param {i}")


def test_correlation_vjp():
    rng = np.random.default_rng(2)
    f1, f2, g = _r(rng, 2, 7, 9, 6), _r(rng, 2, 7, 9, 6), _r(rng, 2, 7, 9, 25)
    out, (d1, d2) = _jax_vjp(lambda a, b: jcorr.correlation_volume(a, b, 2), g, f1, f2)
    t1, t2 = _leaf(f1), _leaf(f2)
    y = ops.correlation_volume(t1, t2, 2)
    assert "Correlation" in type(y.grad_fn).__name__
    _assert_rel(y, out, OP_REL, "forward")
    y.backward(torch.from_numpy(g))
    _assert_rel(t1.grad, d1, OP_REL, "df1")
    _assert_rel(t2.grad, d2, OP_REL, "df2")


WARP_FLOWS = ("random", "zero", "integer", "off_image")


@pytest.fixture(scope="module")
def jax_warp_vjp():
    return jax.jit(lambda f, fl, g: jax.vjp(lambda a, b: jwarp.flow_warp(a, b, chunk_rows=0),
                                            f, fl)[1](g), compiler_options=XLA_OPTS)


@pytest.mark.parametrize("kind", WARP_FLOWS)
def test_warp_vjp(jax_warp_vjp, kind):
    rng = np.random.default_rng(3)
    shape = (2, 8, 10, 2)
    flow = {"random": _r(rng, *shape, std=2.0), "zero": np.zeros(shape, np.float32),
            "integer": np.round(_r(rng, *shape, std=2.0)),
            "off_image": _r(rng, *shape, std=0.5) + np.float32(12.5)}[kind]
    feat, g = _r(rng, 2, 8, 10, 5), _r(rng, 2, 8, 10, 5)
    dfeat, dflow = jax_warp_vjp(feat, flow, g)
    tf, tfl = _leaf(feat), _leaf(flow)
    y = ops.flow_warp(tf, tfl)
    assert "FlowWarp" in type(y.grad_fn).__name__
    y.backward(torch.from_numpy(g))
    _assert_rel(tf.grad, dfeat, OP_REL, "dfeatures")
    if kind == "off_image":  # no tap inside the image: no gradient anywhere
        assert not tf.grad.any() and not tfl.grad.any()
        assert not np.asarray(dflow).any()
    else:
        _assert_rel(tfl.grad, dflow, OP_REL, "dflow")
    if kind == "zero":
        # At integer coordinates the tie rules decide: the tent of
        # torch.abs and torch.clamp gives another flow gradient.
        def torch_rules_tent(coord, start):
            return (torch.clamp(1.0 - (coord - start).abs(), min=0.0),
                    torch.clamp(1.0 - (coord - (start + 1.0)).abs(), min=0.0))

        tfl = _leaf(flow)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops.warp, "_tent", torch_rules_tent)
            ops.flow_warp(torch.from_numpy(feat), tfl).backward(torch.from_numpy(g))
        assert np.abs(tfl.grad.numpy() - np.asarray(dflow)).max() > 0.1 * np.abs(dflow).max()


def test_serving_calls_stay_off_the_tape():
    """Without a gradient to record, each op is the serving call."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_r(rng, 1, 6, 7, 8))
    entry = [(torch.from_numpy(_r(rng, 3, 3, 8, 4)), torch.zeros(4), "relu")]
    assert ops.conv_chain_apply(x, entry).grad_fn is None
    w = torch.nn.Parameter(entry[0][0].clone())
    with torch.no_grad():
        assert ops.conv_chain_apply(x, [(w, entry[0][1], "relu")]).grad_fn is None
    with torch.inference_mode():
        assert ops.correlation_volume(x, x, 2).grad_fn is None


def _record_grads():
    """An optax transformation that passes the updates on and keeps them in
    its state: chained first, it holds the step's raw gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_run(dtype, variables, lr, hr, steps):
    """make_sr_train_step over ``steps`` steps: (loss, raw gradients and BN
    statistics of step 1, the params and BN statistics after the last)."""
    jmodel = JaxSR(**CFG, dtype=dtype)
    tx = optax.chain(_record_grads(), jtraining.create_optimizer(JaxTrainingConfig(**TRAIN), 1))
    state = jtraining.TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                        tx=tx, batch_stats=variables["batch_stats"])
    step = jax.jit(jtraining.make_sr_train_step(jmodel).__wrapped__, compiler_options=XLA_OPTS)
    first = None
    for _ in range(steps):
        state, metrics = step(state, jnp.asarray(lr), jnp.asarray(hr))
        if first is None:
            first = (float(metrics["loss"]), state.opt_state[0], state.batch_stats)
    return first, state


@pytest.fixture(scope="module")
def step_setup():
    rng = np.random.default_rng(5)
    lr = rng.random((2, 3, 16, 16, 3)).astype(np.float32)
    hr = rng.random((2, 32, 32, 3)).astype(np.float32)
    # The flax tree of the model, from the port's module (the bridge's names).
    variables = randomize(flax_variables(SuperResolutionNet(**CFG, device="cpu")), seed=6)
    flow3 = variables["params"]["motion_estimator"]["flow3"]
    flow3["kernel"] = np.zeros_like(flow3["kernel"])
    flow3["bias"] = np.zeros_like(flow3["bias"])
    return variables, lr, hr


def _port_model(variables, dtype):
    model = SuperResolutionNet(**CFG, dtype=dtype, device="cpu")
    return load_flax_variables(model, variables).train()


def _port_grads(model, lr, hr):
    """Loss and raw gradients of one training forward on a copy of ``model``
    (whose BN statistics it updates)."""
    m = copy.deepcopy(model)
    loss = training.pixel_loss(m(torch.from_numpy(lr)), torch.from_numpy(hr))
    loss.backward()
    grads = {k: p.grad for k, p in m.named_parameters()}
    return float(loss.detach()), {"params": grads}, m


def _nested(named):
    out = {}
    for k, v in named.items():
        *parents, leaf = k.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().float().numpy()
    return out


def test_flow_is_zero_at_the_step(step_setup):
    variables, lr, _hr = step_setup
    model = _port_model(variables, torch.float32)
    with torch.no_grad():
        f = model.extract_features(torch.from_numpy(lr[:, 0]))
        assert not model.motion_estimator(f, f).any()


def test_train_step_matches_jax_float32(step_setup):
    variables, lr, hr = step_setup
    (jloss, jgrads, jstats), jstate = _jax_run(jnp.float32, variables, lr, hr, 3)
    model = _port_model(variables, torch.float32)
    loss, grads, stepped = _port_grads(model, lr, hr)
    assert abs(loss - jloss) <= STEP_REL * abs(jloss)
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads["params"].values()])))
    assert norm > TRAIN["grad_clip_norm"]  # the clipping scales these gradients
    _assert_trees(_nested(grads["params"]), jgrads, STEP_REL, "gradient")
    _assert_trees(flax_variables(stepped)["batch_stats"], jstats, STEP_REL, "BN statistics")
    state = training.create_sr_state(model, TrainingConfig(**TRAIN), 1)
    step = training.make_sr_train_step(model)
    lrs = []
    for _ in range(3):
        lrs.append(state.optimizer.schedule(state.step))
        state, metrics = step(state, torch.from_numpy(lr), torch.from_numpy(hr))
    assert lrs[0] == 0.0 and lrs[1] == float(np.float32(TrainingConfig().learning_rate))
    assert lrs[1] > lrs[2] > 0
    assert state.step == 3 and np.isfinite(float(metrics["loss"]))
    got = flax_variables(model)
    _assert_trees(got["params"], jstate.params, STEP_REL, "params after 3 steps")
    _assert_trees(got["batch_stats"], jstate.batch_stats, STEP_REL, "BN statistics after 3")


def test_train_step_matches_jax_bfloat16(step_setup):
    variables, lr, hr = step_setup
    (jloss, jgrads, _jstats), _ = _jax_run(jnp.bfloat16, variables, lr, hr, 1)
    loss, grads, _m = _port_grads(_port_model(variables, torch.bfloat16), lr, hr)
    assert abs(loss - jloss) <= BF16_LOSS_REL * abs(jloss)
    got = _flat(_nested(grads["params"]))
    ref = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(got) == set(ref)
    for k in ref:
        assert np.linalg.norm(got[k] - ref[k]) <= BF16_TENSOR_L2 * np.linalg.norm(ref[k]), k
    diff = np.concatenate([(got[k] - ref[k]).ravel() for k in ref])
    assert np.linalg.norm(diff) <= BF16_GRADS_L2 * np.linalg.norm(
        np.concatenate([ref[k].ravel() for k in ref]))


TINY = dict(scale_factor=2, num_features=8, num_residual_blocks=1, temporal_window=1)


def _tiny_fit(epochs, mgr, data, seed=0):
    train_data, val_data = data
    model = SuperResolutionNet(**TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    cfg = TrainingConfig(epochs=epochs, batch_size=4, learning_rate=1e-3, warmup_epochs=0,
                         scheduler="constant")
    logs = []
    state, history = training.fit_sr(model, train_data, val_data, cfg, 3, seed=seed,
                                     log_fn=logs.append, ckpt_manager=mgr)
    return state, history, logs


def test_fit_sr_checkpoint_resume(tmp_path):
    """2 epochs straight against 1 epoch, then a run of 2 that resumes at
    epoch 1 (one batch an epoch: the resumed shuffle only reorders it), then
    a run the checkpoint already covers (one eval pass, best_psnr kept)."""
    g = torch.Generator().manual_seed(0)
    data = (data_lib.make_sr_dataset(g, 4, lr_size=8), data_lib.make_sr_dataset(g, 4, lr_size=8))
    straight, hist_straight, _ = _tiny_fit(2, None, data)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_n=2)
    first, _h, _ = _tiny_fit(1, mgr, data)
    assert mgr.latest_step() == 1 and first.step == 1
    resumed, hist, logs = _tiny_fit(2, mgr, data)
    assert any("resumed from checkpoint at epoch 1" in s for s in logs)
    assert resumed.step == straight.step == 2 and mgr.latest_step() == 2
    assert mgr.steps() == [1, 2]
    got = _flat(flax_variables(resumed.model)["params"])
    ref = _flat(flax_variables(straight.model)["params"])
    _assert_rel(np.concatenate([got[k].ravel() for k in ref]),
                np.concatenate([ref[k].ravel() for k in ref]), 1e-5, "resumed params")
    assert len(hist["losses"]) == 1 and len(hist_straight["losses"]) == 2
    np.testing.assert_allclose(hist["losses"][0], hist_straight["losses"][1], rtol=1e-5)
    again, hist3, logs3 = _tiny_fit(2, mgr, data)
    assert any("eval only" in s for s in logs3) and again.step == 2
    assert np.isfinite(hist3["final_psnr"]) and hist3["best_psnr"] >= hist["best_psnr"]
    raw = mgr.restore_raw()
    assert set(raw) == {"params", "opt_state", "batch_stats", "step", "best_psnr"}
    with pytest.raises(ValueError, match="lacks"):
        mgr.restore({**raw, "extra": 0})


def test_train_baseline_cli_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``python -m nerve_tpu_torch.train_baseline --device cpu`` at a tiny size."""
    monkeypatch.setattr(sys, "argv", [
        "train_baseline", "--device", "cpu", "--epochs", "1", "--batch-size", "2",
        "--train-samples", "2", "--val-samples", "2", "--lr-size", "8",
        "--num-features", "8", "--num-blocks", "1", "--checkpoint-dir", str(tmp_path / "ck")])
    monkeypatch.delitem(sys.modules, "nerve_tpu_torch.train_baseline", raising=False)
    runpy.run_module("nerve_tpu_torch.train_baseline", run_name="__main__")
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"best_psnr", "final_psnr"} and np.isfinite(last["final_psnr"])
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 1
