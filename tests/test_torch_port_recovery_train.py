"""The recovery network's training through the port against the JAX package's.

(1) Training mode, float32: ``ResidualBlock`` (both forms),
``TemporalConv3D`` (its BatchNorms over B, T, H, W), ``FrameRecoveryNet``
(base 8, 32 × 32, batch 2) and the engine (recovery base 8, SR 16 features,
2 RDBs, with a mask), each against the flax module applied with
``train=True, mutable=["batch_stats"]``: the blocks' outputs and every new
running statistic within 1e-5 of max|ref|. The whole net's and the
engine's outputs are held at 1e-4 of max|ref| (the eval-mode recovery
tests' module level): live BatchNorm divides by batch deviations of a few
dozen values at the 2 × 2 bottom of the encoder, which magnifies float32
rounding, and there the JAX output itself lies 4.5e-5 from a float64 run
of the same weights (the port's 2.1e-5; measured on this test's net, port
vs JAX 4.6e-5). So the net's test also holds the port's error against the
port in float64 to at most JAX's. Every parameter and statistic is seeded
non-zero (``test_torch_port_recovery.seeded_variables``).

(2) The recovery train step against the JAX step of
``scripts/recovery_protocol.py`` (``train_ours_jax``'s ``step``: the blended
output's MSE, ``jax.value_and_grad``, ``optax.adamw`` at decay 1e-5 on the
warm-up-free cosine): the loss within 1e-6 relative, the new statistics
within 1e-5 of max|ref|, and each gradient within 1e-4 in relative L2 norm
of the port's own float64 run and within 1e-4 of JAX's, or else nearer the
float64 gradient than JAX's. JAX's temporal encoder gradients lie up to
2.2e-3 from the float64 ones here (the port's 2.3e-5): the first check holds
the port, the second that it is JAX's computation. Then three AdamW steps
from the same weights and batches, the parameters held by the training
tests' rule (the L2 norm of the difference within 0.05 of the change's,
since Adam moves a weight by about ±lr whatever its gradient), the running
statistics by the same rule, the losses within 2e-2.
Both sides get the same numpy arrays: the JAX package's PRNG bits are not
reproduced.

(3) ``utils.data.add_corruption``: the rectangle law and the blend, exactly
(its draws come from a torch generator, so its bits are not JAX's); the
protocol's ``make_masks`` and ``masked_psnr`` bit-identical to the script's
for a seed; ``python -m nerve_tpu_torch.recovery_protocol --device cpu`` at
a tiny size.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerve_tpu.models import enhancement_engine as jeng
from nerve_tpu.models import frame_recovery as jfr
from nerve_tpu.models import layers as jlayers
from nerve_tpu_torch import recovery_protocol
from nerve_tpu_torch.models import EngineConfig, flax_variables, load_flax_variables
from nerve_tpu_torch.models import enhancement_engine, frame_recovery, layers
from nerve_tpu_torch.diag.recovery import float64_copy
from nerve_tpu_torch.training import recovery as trecovery
from nerve_tpu_torch.utils import data as data_lib
from test_torch_port_recovery import seeded_variables

REL = 1e-5
NET_REL = 1e-4
LOSS_REL, GRAD_L2 = 1e-6, 1e-4
PARAM_L2 = 0.05
LOSSES_REL = 2e-2  # the losses of the three steps (phase 9's kernel-vs-plain level)
H = W = 32
BASE = 8
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _script():
    """``scripts/recovery_protocol.py`` as a module (its JAX imports are
    inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "jax_recovery_protocol", ROOT / "scripts" / "recovery_protocol.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_rel(got, ref, rel, what=""):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"{what}: max|d| {err:.3e} > {rel} * {scale:.3e}"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _assert_trees(got, ref, rel, what):
    got, ref = _flat(got), _flat(ref)
    assert set(got) == set(ref), f"{what}: paths differ {set(got) ^ set(ref)}"
    for k in ref:
        _assert_rel(got[k], ref[k], rel, f"{what} {k}")


def jax_train_apply(module, variables, *args):
    """(output, new batch_stats) of ``module.apply(..., train=True)``."""
    def run(v, *a):
        out, mut = module.apply(v, *a, train=True, mutable=["batch_stats"])
        return out, mut["batch_stats"]

    out, stats = jax.jit(run)(variables, *args)
    return jax.tree_util.tree_map(np.asarray, out), jax.tree_util.tree_map(np.asarray, stats)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# (1) Modules in training mode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("efficient", [True, False])
def test_residual_block_train_matches_jax(efficient):
    x = _x(np.random.default_rng(3), 2, 9, 11, 16)
    jmod = jlayers.ResidualBlock(use_efficient=efficient)
    variables = seeded_variables(jmod, jnp.asarray(x))
    ref, stats = jax_train_apply(jmod, variables, jnp.asarray(x))
    mod = load_flax_variables(layers.ResidualBlock(16, efficient), variables).train()
    tx = torch.from_numpy(x).requires_grad_()
    got = mod(tx)
    _assert_rel(got, ref, REL, "output")
    _assert_trees(flax_variables(mod)["batch_stats"], stats, REL, "statistics")
    got.sum().backward()
    assert tx.grad is not None and tx.grad.abs().max() > 0


def test_temporal_conv3d_train_matches_jax():
    x = _x(np.random.default_rng(4), 2, 4, 9, 7, 3)
    jmod = jlayers.TemporalConv3D(16)
    variables = seeded_variables(jmod, jnp.asarray(x))
    ref, stats = jax_train_apply(jmod, variables, jnp.asarray(x))
    mod = load_flax_variables(layers.TemporalConv3D(3, 16), variables).train()
    _assert_rel(mod(torch.from_numpy(x)), ref, REL, "output")
    _assert_trees(flax_variables(mod)["batch_stats"], stats, REL, "statistics")


def _batch(rng, n=2, h=H, w=W):
    """(corrupted, refs with the corrupted centre, mask, clean) for the net."""
    proto = _script()
    clean = rng.random((n, h, w, 3), np.float32)
    frames = rng.random((n, 5, h, w, 3), np.float32)
    mask = proto.make_masks(rng, n, h, w, rng.uniform(0.1, 0.4, n))
    corrupted = clean * (1.0 - mask)
    return corrupted, recovery_protocol.corrupted_refs(frames, corrupted), mask, clean


@pytest.fixture(scope="module")
def net():
    rng = np.random.default_rng(6)
    batches = [_batch(rng) for _ in range(3)]
    jmod = jfr.FrameRecoveryNet(base_channels=BASE, temporal_window=2)
    variables = seeded_variables(jmod, *(jnp.asarray(a) for a in batches[0][:3]), seed=2)
    return dict(jmod=jmod, variables=variables, batches=batches)


def _port_net(variables):
    model = frame_recovery.FrameRecoveryNet(base_channels=BASE, temporal_window=2,
                                            device="cpu")
    return load_flax_variables(model, variables).train()


def test_frame_recovery_train_matches_jax(net):
    cor, refs, mask, _clean = net["batches"][0]
    ref, stats = jax_train_apply(net["jmod"], net["variables"],
                                 *(jnp.asarray(a) for a in (cor, refs, mask)))
    model = _port_net(net["variables"])
    truth = float64_copy(model)(*(torch.from_numpy(a).double() for a in (cor, refs, mask)))
    got = model(*(torch.from_numpy(a) for a in (cor, refs, mask)))
    assert got.requires_grad
    _assert_rel(got, ref, NET_REL, "output")
    truth = truth.detach().numpy()
    assert np.abs(got.detach().numpy() - truth).max() <= np.abs(ref - truth).max()
    _assert_trees(flax_variables(model)["batch_stats"], stats, REL, "statistics")
    outside = mask[..., 0] == 0
    np.testing.assert_array_equal(got.detach().numpy()[outside], cor[outside])


def test_engine_train_matches_jax():
    """The engine in ``.train()`` (``train=True``): recovery on live
    BatchNorm, the SR net's training forward, the strength blend."""
    cfg = dict(recovery_base_channels=BASE, sr_num_features=16, sr_num_residual_blocks=2)
    rng = np.random.default_rng(8)
    frames = rng.random((1, 5, H, W, 3), np.float32)
    mask = np.zeros((1, H, W, 1), np.float32)
    mask[0, 6:20, 9:27] = 1.0
    jmod = jeng.EnhancementEngine(jeng.EngineConfig(**cfg))
    args = (jnp.asarray(frames), None, jnp.asarray(mask))
    variables = seeded_variables(jmod, *args, seed=4)
    ref, stats = jax_train_apply(jmod, variables, *args)
    eng = enhancement_engine.EnhancementEngine(EngineConfig(**cfg), device="cpu")
    eng = load_flax_variables(eng, variables).train()
    got = eng(torch.from_numpy(frames), None, torch.from_numpy(mask))
    assert sorted(got) == sorted(ref) and got["enhanced"].requires_grad
    for k in ref:
        _assert_rel(got[k], ref[k], NET_REL, k)
    _assert_trees(flax_variables(eng)["batch_stats"], stats, REL, "statistics")


# --------------------------------------------------------------------------- #
# (2) The train step
# --------------------------------------------------------------------------- #
def jax_steps(jmod, variables, batches, lr, total):
    """The script's step over ``batches``: [(loss, grads, batch_stats)] and
    the final params (its ``tx``: adamw on the cosine, decay 1e-5)."""
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(lr, lr, 0, total, lr * 0.01),
                     weight_decay=1e-5)

    @jax.jit
    def step(params, batch_stats, opt_state, corrupted, refs, mask, target):
        def loss_fn(p):
            out, mut = jmod.apply({"params": p, "batch_stats": batch_stats},
                                  corrupted, refs, mask, True, mutable=["batch_stats"])
            return jnp.mean((out - target) ** 2), mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss, grads

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    record = []
    for cor, refs, mask, clean in batches:
        params, stats, opt_state, loss, grads = step(
            params, stats, opt_state, *(jnp.asarray(a) for a in (cor, refs, mask, clean)))
        record.append((float(loss), jax.tree_util.tree_map(np.asarray, grads),
                       jax.tree_util.tree_map(np.asarray, stats)))
    return record, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def stepped(net):
    lr = 1e-3
    record, params = jax_steps(net["jmod"], net["variables"], net["batches"], lr, 3)
    return dict(lr=lr, record=record, params=params)


def _port_step(model, lr, total=3):
    return trecovery.create_recovery_state(model, lr, total), \
        trecovery.make_recovery_train_step(model)


def _rel_l2(a, b):
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / nb if nb else float(np.abs(a).max())


def _step_grads(model, batch):
    loss = trecovery.recovery_loss(model, *batch)
    model.zero_grad()
    loss.backward()
    return loss.item(), {k: p.grad.double().numpy() for k, p in model.named_parameters()}


def test_recovery_train_step_matches_jax(net, stepped):
    model = _port_net(net["variables"])
    loss, grads = _step_grads(model, [torch.from_numpy(a) for a in net["batches"][0]])
    jloss, jgrads, jstats = stepped["record"][0]
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss), (loss, jloss)
    got = _flat(flax_variables(model)["batch_stats"])
    for k, v in _flat(jstats).items():
        _assert_rel(got[k], v, REL, f"statistics {k}")
    _l64, truth = _step_grads(float64_copy(_port_net(net["variables"])),
                              [torch.from_numpy(a).double() for a in net["batches"][0]])
    ref = _flat(jgrads)
    assert set(grads) == set(ref)
    for k, g in ref.items():
        port_err = _rel_l2(grads[k], truth[k])
        assert port_err <= GRAD_L2, (k, port_err)
        assert _rel_l2(grads[k], g) <= GRAD_L2 or port_err <= _rel_l2(g, truth[k]), k


def test_recovery_three_adamw_steps_match_jax(net, stepped):
    model = _port_net(net["variables"])
    p0 = {k: v.copy() for k, v in _flat(flax_variables(model)["params"]).items()}
    state, step = _port_step(model, stepped["lr"])
    losses = []
    for b in net["batches"]:
        _s, metrics = step(state, *(torch.from_numpy(a) for a in b))
        losses.append(float(metrics["loss"]))
    assert state.step == 3
    np.testing.assert_allclose(losses, [r[0] for r in stepped["record"]], rtol=LOSSES_REL)
    got = _flat(flax_variables(model)["params"])
    ref = _flat(stepped["params"])
    s0 = _flat(net["variables"]["batch_stats"])
    for what, got, ref, start in (
            ("params", got, ref, p0),
            ("statistics", _flat(flax_variables(model)["batch_stats"]),
             _flat(stepped["record"][-1][2]), s0)):
        diff = np.concatenate([(got[k] - ref[k]).ravel() for k in ref])
        change = np.concatenate([(ref[k] - start[k]).ravel() for k in ref])
        assert np.linalg.norm(diff) <= PARAM_L2 * np.linalg.norm(change), (
            what, np.linalg.norm(diff), np.linalg.norm(change))


# --------------------------------------------------------------------------- #
# (3) Data, masks, the protocol CLI
# --------------------------------------------------------------------------- #
def test_add_corruption_rectangle_law():
    frames = torch.rand((64, 40, 24, 3), generator=torch.Generator().manual_seed(0))
    corrupted, mask = data_lib.add_corruption(torch.Generator().manual_seed(1), frames, 0.4)
    assert mask.shape == (64, 40, 24, 1) and mask.dtype == torch.float32
    assert set(torch.unique(mask).tolist()) <= {0.0, 1.0}
    torch.testing.assert_close(corrupted, frames * (1.0 - mask), rtol=0, atol=0)
    for m in mask[..., 0]:
        rows = torch.nonzero(m.any(dim=1)).flatten()
        cols = torch.nonzero(m.any(dim=0)).flatten()
        assert len(rows) and len(cols)
        y0, y1, x0, x1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
        assert m[y0:y1, x0:x1].all() and m.sum() == (y1 - y0) * (x1 - x0)  # one rectangle
        # Heights in [h/8, 0.4·h) = [5, 16), widths [3, 9), unless clipped by the frame.
        assert 1 <= y1 - y0 < 16 and (y1 - y0 >= 5 or y1 == 40)
        assert 1 <= x1 - x0 < 9 and (x1 - x0 >= 3 or x1 == 24)
    # Origins anywhere, so some rectangles are cut by the bottom or right edge.
    assert (mask[:, -1].any(dim=(1, 2)) | mask[:, :, -1].any(dim=(1, 2))).any()


def test_make_masks_and_masked_psnr_are_the_scripts():
    proto = _script()
    for seed, frac in ((0, 0.25), (5, np.random.default_rng(9).uniform(0.1, 0.4, 6))):
        a = proto.make_masks(np.random.default_rng(seed), 6, 32, 40, frac)
        b = recovery_protocol.make_masks(np.random.default_rng(seed), 6, 32, 40, frac)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rng = np.random.default_rng(3)
    clean = rng.random((6, 32, 40, 3), np.float32)
    pred = clean + rng.standard_normal(clean.shape).astype(np.float32) * 0.1
    assert proto.masked_psnr(pred, clean, a) == recovery_protocol.masked_psnr(pred, clean, a)


def test_recovery_protocol_cli_on_the_cpu(capsys):
    recovery_protocol.main(["--device", "cpu", "--epochs", "1", "--train-samples", "8",
                            "--eval-samples", "4", "--size", "32", "--batch-size", "2",
                            "--base-channels", str(BASE), "--seed", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    fracs = ["10%", "20%", "30%", "40%"]
    assert list(out["zero_fill_baseline"]) == fracs and list(out["nerve_tpu_torch"]) == fracs
    assert all(np.isfinite(v) for v in out["nerve_tpu_torch"].values())
    assert np.isfinite(out["final_loss"]) and out["device"] == "cpu"
    assert "corrupted centre frame" in out["protocol"]["refs"]
    assert "not run" in out["protocol"]["reference_side"]


def test_recovery_protocol_dataset_and_refs():
    d = recovery_protocol.make_dataset(1, 3, 16)
    assert d["frames"].shape == (3, 5, 16, 16, 3) and d["clean"].shape == (3, 16, 16, 3)
    np.testing.assert_array_equal(d["frames"][:, 2], d["clean"])  # scale 1: centre = clean
    cor = np.zeros_like(d["clean"])
    refs = recovery_protocol.corrupted_refs(d["frames"], cor)
    assert not refs[:, 2].any() and np.array_equal(refs[:, [0, 1, 3, 4]],
                                                   d["frames"][:, [0, 1, 3, 4]])
