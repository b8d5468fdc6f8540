"""The port's data-parallel train step against the JAX package's, on the CPU.

Four gloo ranks (``nerve_tpu_torch.parallel.launch.run_cases``, spawned
once for the module), each with a quarter of the batch, run two train steps
of a tiny flagship (8 features, 1 RDB, window 1; float32; live BatchNorm;
every weight seeded) through ``training.make_sr_train_step(..., mesh=)``;
the JAX side is ``nerve_tpu.training.make_sr_train_step(mesh=make_mesh(data
=4))``'s program on four virtual CPU devices (its step, shardings and
donation, compiled with LLVM's optimisations off), its raw gradients kept
by an identity transformation chained before the optimiser. AdamW at the
default rate with one epoch of warm-up (the first rate 0) and global-norm
clipping at 0.05, which scales these gradients.

Held: each step's loss and PSNR (the global batch's) within 1e-5
relative; the first step's gradients, averaged over the ranks, and the
parameters and BatchNorm statistics after two steps within 1e-4 of max|ref|
per tensor (``test_torch_port_training.py``'s limit for the one-device
step); the four ranks' parameters equal to the bit; and the four-rank step
against the port's one-device step on the whole batch at the same limits.
Statistics per rank would fail the last check (shown on a quarter batch),
and summed gradients the gradient check.
"""

import copy
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerve_tpu import training as jtraining
from nerve_tpu.config.schema import TrainingConfig as JaxTrainingConfig
from nerve_tpu.models.super_resolution import SuperResolutionNet as JaxSR
from nerve_tpu.parallel.mesh import batch_sharding, make_mesh, replicated_sharding
from nerve_tpu_torch import training
from nerve_tpu_torch.config.schema import TrainingConfig
from nerve_tpu_torch.models import SuperResolutionNet, flax_variables, load_flax_variables
from nerve_tpu_torch.models.bridge import params_to_flax
from nerve_tpu_torch.parallel import launch
from test_torch_port_models import randomize

XLA_OPTS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
CFG = dict(scale_factor=2, num_features=8, num_residual_blocks=1, temporal_window=1)
TRAIN = dict(epochs=4, warmup_epochs=1, grad_clip_norm=0.05)  # steps_per_epoch 1
RANKS, BATCH, STEPS = 4, 8, 2
METRIC_REL, STEP_REL = 1e-5, 1e-4


def _record_grads():
    """An identity transformation that keeps the updates in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_run(variables, batches):
    jmodel = JaxSR(**CFG)
    tx = optax.chain(_record_grads(), jtraining.create_optimizer(JaxTrainingConfig(**TRAIN), 1))
    state = jtraining.TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                        tx=tx, batch_stats=variables["batch_stats"])
    mesh = make_mesh(data=RANKS)
    jitted = jtraining.make_sr_train_step(jmodel, mesh=mesh)
    repl, bsh = replicated_sharding(mesh), batch_sharding(mesh)
    step = jax.jit(jitted.__wrapped__, donate_argnums=(0,), in_shardings=(repl, bsh, bsh),
                   out_shardings=(repl, repl), compiler_options=XLA_OPTS)
    metrics, grads0 = [], None
    for lr, hr in batches:
        state, m = step(state, jnp.asarray(lr), jnp.asarray(hr))
        metrics.append({k: float(v) for k, v in m.items()})
        if grads0 is None:
            grads0 = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
    return metrics, grads0, jax.tree_util.tree_map(np.asarray, state.params), \
        jax.tree_util.tree_map(np.asarray, state.batch_stats)


def _port_one_device(variables, batches):
    """The port's step on one device: (metrics, first step's raw gradients,
    model after the steps)."""
    model = load_flax_variables(SuperResolutionNet(**CFG, device="cpu"), variables).train()
    state = training.create_sr_state(model, TrainingConfig(**TRAIN), 1)
    names = {p: k for k, p in model.named_parameters()}
    apply, grads0 = state.optimizer.apply, {}

    def recording_apply(count):
        if not grads0:
            grads0.update({names[p]: p.grad.clone() for p in state.optimizer.params()})
        apply(count)

    state.optimizer.apply = recording_apply
    step = training.make_sr_train_step(model)
    metrics = []
    for lr, hr in batches:
        _s, m = step(state, torch.from_numpy(lr), torch.from_numpy(hr))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, grads0, model


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(7)
    batches = [(rng.random((BATCH, 3, 16, 16, 3)).astype(np.float32),
                rng.random((BATCH, 32, 32, 3)).astype(np.float32)) for _ in range(STEPS)]
    variables = randomize(flax_variables(SuperResolutionNet(**CFG, device="cpu")), seed=8)
    port = load_flax_variables(SuperResolutionNet(**CFG, device="cpu"), copy.deepcopy(variables))
    arrays = {**launch.state_arrays("sr", port),
              **{f"x/lr_{i}": lr for i, (lr, _) in enumerate(batches)},
              **{f"x/hr_{i}": hr for i, (_, hr) in enumerate(batches)}}
    spec = {"models": {"sr": {"kind": "sr", "config": CFG, "dtype": "float32"}},
            "cases": [{"name": "dp", "fn": "train", "mesh": [RANKS, 1, 1], "input": "lr",
                       "target": "hr", "steps": STEPS, "cfg": TRAIN, "steps_per_epoch": 1}]}
    spec_dir = launch.write_spec(tmp_path_factory.mktemp("dp"), spec, arrays)
    launch.spawn(launch.run_cases, RANKS, "gloo", "cpu", args=(str(spec_dir),), timeout=300)
    dp = torch.load(spec_dir / "result.pt")["dp"]
    trained = load_flax_variables(SuperResolutionNet(**CFG, device="cpu"),
                                  copy.deepcopy(variables))
    trained.load_state_dict(dp["state"])
    return types.SimpleNamespace(variables=variables, batches=batches, dp=dp,
                                 dp_vars=flax_variables(trained))


@pytest.fixture(scope="module")
def jax_ref(run):
    return _jax_run(copy.deepcopy(run.variables), run.batches)


@pytest.fixture(scope="module")
def one_device(run):
    return _port_one_device(copy.deepcopy(run.variables), run.batches)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _assert_trees(got, ref, rel, what):
    got, ref = _flat(got), _flat(ref)
    assert set(got) == set(ref), f"{what}: paths differ {set(got) ^ set(ref)}"
    for k in ref:
        err = float(np.max(np.abs(got[k] - ref[k])))
        scale = float(np.max(np.abs(ref[k])))
        assert err <= rel * scale, f"{what} {k}: max|d| {err:.3e} > {rel} * {scale:.3e}"


def _assert_metrics(got, ref):
    assert len(got) == len(ref) == STEPS
    for g, r in zip(got, ref):
        for k in ("loss", "psnr"):
            assert abs(g[k] - r[k]) <= METRIC_REL * abs(r[k]), (k, g[k], r[k])


def test_ranks_hold_equal_parameters(run):
    assert run.dp["ranks_equal"]


def test_loss_and_psnr_match_jax(run, jax_ref):
    _assert_metrics(run.dp["metrics"], jax_ref[0])


def test_averaged_gradients_match_jax(run, jax_ref):
    grads = params_to_flax(run.dp["grads0"])
    norm = np.sqrt(sum(float(np.sum(g ** 2)) for g in _flat(grads).values()))
    assert norm > TRAIN["grad_clip_norm"]  # the clip scales these gradients
    _assert_trees(grads, jax_ref[1], STEP_REL, "gradient")


def test_parameters_and_statistics_match_jax(run, jax_ref):
    _assert_trees(run.dp_vars["params"], jax_ref[2], STEP_REL, "params after 2 steps")
    _assert_trees(run.dp_vars["batch_stats"], jax_ref[3], STEP_REL, "BN statistics after 2")


def test_four_ranks_equal_one_device_step(run, one_device):
    metrics, grads0, model = one_device
    _assert_metrics(run.dp["metrics"], metrics)
    _assert_trees(params_to_flax(run.dp["grads0"]), params_to_flax(grads0), STEP_REL,
                  "gradient")
    ref = flax_variables(model)
    _assert_trees(run.dp_vars["params"], ref["params"], STEP_REL, "params")
    _assert_trees(run.dp_vars["batch_stats"], ref["batch_stats"], STEP_REL, "BN statistics")


def test_statistics_per_rank_would_differ(run, one_device):
    """One rank's quarter of the batch alone moves the BatchNorm statistics
    farther than the limit: the checks above see statistics left per rank."""
    quarter = [(lr[:BATCH // RANKS], hr[:BATCH // RANKS]) for lr, hr in run.batches[:1]]
    _m, _g, model = _port_one_device(copy.deepcopy(run.variables), quarter)
    _m, _g, whole = _port_one_device(copy.deepcopy(run.variables), run.batches[:1])
    got, ref = (_flat(flax_variables(m)["batch_stats"]) for m in (model, whole))
    worst = max(float(np.max(np.abs(got[k] - ref[k]))) / float(np.max(np.abs(ref[k])))
                for k in ref)
    assert worst > 10 * STEP_REL


def test_train_baseline_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m nerve_tpu_torch.train_baseline``: two
    gloo ranks train data parallel; only rank 0 prints the last line, whose
    PSNR equals the one-process run's on the same data."""
    flags = ["--device", "cpu", "--epochs", "1", "--train-samples", "8", "--val-samples", "4",
             "--lr-size", "16", "--num-features", "8", "--num-blocks", "1", "--batch-size", "4"]
    runs, outs = {}, {}
    for name, launcher in (("dp", [sys.executable, "-m", "torch.distributed.run",
                                   "--standalone", "--nproc-per-node", "2"]),
                           ("one", [sys.executable])):
        proc = subprocess.run([*launcher, "-m", "nerve_tpu_torch.train_baseline", *flags,
                               "--checkpoint-dir", str(tmp_path / name)],
                              capture_output=True, text=True, timeout=240,
                              cwd=str(Path(__file__).resolve().parents[1]))
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines = proc.stdout.strip().splitlines()
        assert sum(line.startswith("{") for line in lines) == 1, lines
        runs[name], outs[name] = json.loads(lines[-1]), proc.stdout
        assert (tmp_path / name / "step_1.pt").exists()
    assert "2 ranks (data 2)" in outs["dp"]
    for k in ("best_psnr", "final_psnr"):
        assert abs(runs["dp"][k] - runs["one"][k]) <= METRIC_REL * abs(runs["one"][k]), runs
