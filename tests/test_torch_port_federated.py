"""The port's federated pillar against the JAX package's, on the CPU.

(1) ``LightweightSuperResolution`` trains: in ``train()`` (live BatchNorm)
and with ``differentiable=True`` (the eval forward on the tape, the
statistics held, as ``experiments/train_federated.py``'s simulation
differentiates it), the output, the loss, every gradient by flax path and
the new BatchNorm statistics against ``jax.grad`` of ``model.apply`` with
the same variables (every leaf seeded, the tail included). Outputs within
1e-5 of max|ref|, gradients and statistics within 1e-4 (``STEP_REL``).

(2) The wire format: the port's ``tree_to_arrays`` of the model's
parameters is bit for bit the JAX package's of the bridged flax tree, in
order, shape and dtype. (3) Privacy: the formulas; the clip before AdamW
(noise 0) against ``make_private(optax.adamw)`` within 1e-6; per-sample
clipping against ``make_private_loss_grad``; the noise's std within 6
standard errors of σ·C/B (per step) and σ·C/Σw (per round). (4) A client's
``fit`` and ``evaluate`` against the JAX client on the same numpy data and
shuffles (1 epoch of 2 batches; with and without the DP clip), the returned
arrays within 1e-4 of max|ref| per tensor; the batch clamps. (5) One FedAvg
round of the lightweight model (2 clients, 2 local steps) against the JAX
package's on a 2-device CPU mesh, rtol 1e-4 and atol 1e-5, and the linear
model's hand-computed FedAvg. (6) The strategy, the trainer (over numpy
clients) and the clustering against the JAX package's on the same inputs.
(7) A port client answering the JAX package's ``FLServerTransport``; the
port's ``start_server`` with two port clients. (8) ``python -m
nerve_tpu_torch.train_federated`` in the simulation and trainer modes.
"""

import json
import socket
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerve_tpu import federated as jfed
from nerve_tpu.federated import privacy as jprivacy
from nerve_tpu.federated import transport as jtransport
from nerve_tpu.federated.simulation import MeshFederatedSimulation as JaxSimulation
from nerve_tpu.models.super_resolution import LightweightSuperResolution as JaxLightweight
from nerve_tpu.parallel import make_mesh
from nerve_tpu_torch import federated, train_federated
from nerve_tpu_torch.continual.params import detached
from nerve_tpu_torch.federated import privacy, simulation, transport
from nerve_tpu_torch.models import (
    LightweightSuperResolution,
    flax_variables,
    lightweight_from_flax,
    load_flax_variables,
)
from nerve_tpu_torch.models.bridge import params_to_flax
from test_torch_port_models import randomize
from test_torch_port_training import XLA_OPTS, _assert_rel, _assert_trees

OUT_REL = 1e-5
STEP_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: these small ops run slower on more threads
    when the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jit(fn):
    return jax.jit(fn, compiler_options=XLA_OPTS)


@pytest.fixture(scope="module")
def lw():
    """Seeded flax variables of the lightweight model (numpy), an LR batch
    and its HR target."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 8, 8, 3)).astype(np.float32)
    hr = rng.random((2, 16, 16, 3)).astype(np.float32)
    v = _jit(JaxLightweight(scale_factor=2).init)(jax.random.PRNGKey(0), x)
    return jax.tree_util.tree_map(np.asarray, randomize(v, 1)), x, hr


def _port_model(variables):
    return load_flax_variables(LightweightSuperResolution(device="cpu"), variables)


# --------------------------------------------------------------------------- #
# (1) The lightweight model's training and differentiable eval forward
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["train", "frozen_stats"])
def test_lightweight_gradients_match_jax(lw, mode):
    variables, x, hr = lw
    jm = JaxLightweight(scale_factor=2)
    train = mode == "train"

    def loss(p, stats):
        v = {"params": p, "batch_stats": stats}
        if train:
            out, mut = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
            stats = mut["batch_stats"]
        else:
            out = jm.apply(v, jnp.asarray(x))
        return jnp.mean((out - hr) ** 2), (out, stats)

    (jl, (jout, jstats)), jg = _jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], variables["batch_stats"])
    model = _port_model(variables).train(train)
    out = model(torch.from_numpy(x), differentiable=not train)
    assert out.requires_grad
    tl = torch.mean((out - torch.from_numpy(hr)) ** 2)
    tl.backward()
    _assert_rel(out, jout, OUT_REL, "output")
    assert abs(tl.item() - float(jl)) <= OUT_REL * float(jl)
    _assert_trees(params_to_flax({k: p.grad for k, p in model.named_parameters()}), jg,
                  STEP_REL, "grad")
    _assert_trees(flax_variables(model)["batch_stats"], jstats, STEP_REL, "batch_stats")
    if not train:  # the statistics held
        _assert_trees(flax_variables(model)["batch_stats"], variables["batch_stats"], 0.0,
                      "held batch_stats")
    served = model.eval()(torch.from_numpy(x))
    assert not served.requires_grad and served.is_inference()
    ref = jm.apply({"params": variables["params"], "batch_stats": jstats}, jnp.asarray(x))
    _assert_rel(served, ref, OUT_REL, "serving")


# --------------------------------------------------------------------------- #
# (2) The wire format
# --------------------------------------------------------------------------- #
def test_wire_format_is_the_jax_packages(lw):
    model = _port_model(lw[0])
    # The bridge both ways: flax variables → model → the same flax tree.
    _assert_trees(flax_variables(model), lw[0], 0.0, "bridged variables")
    again = lightweight_from_flax(flax_variables(model), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                  model.state_dict().values()))
    got = federated.tree_to_arrays(dict(model.named_parameters()))
    ref = jfed.tree_to_arrays(flax_variables(model)["params"])
    assert len(got) == len(ref) == 4 * 4 + 4
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a, b)
    assert federated.get_parameters(dict(model.named_parameters()))[0].tobytes() == \
        ref[0].tobytes()
    # A round trip into tensors; the arrays are copies, not views.
    template = dict(model.named_parameters())
    back = federated.tree_from_arrays(template, [a * 2 for a in got])
    assert list(back) == list(template)
    for (k, t), a in zip(sorted(back.items(), key=lambda kv: kv[0].split(".")), got):
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a * 2), k
    got[0][...] = 0
    assert template["body0.BatchNorm_0.bias"].abs().sum() > 0
    tree = {"a": np.ones((2, 3)), "b": {"c": np.arange(4, dtype=np.int32)}}
    back = federated.set_parameters(tree, federated.tree_to_arrays(tree))
    assert back["b"]["c"].dtype == np.int32 and np.array_equal(back["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError, match="expected 20 arrays"):
        federated.tree_from_arrays(template, got[:-1])


# --------------------------------------------------------------------------- #
# (3) Privacy
# --------------------------------------------------------------------------- #
def test_privacy_formulas_match():
    for args in ((8.0, 1e-5, 100), (1.0, 1e-6, 7, 4, 64)):
        assert privacy.compute_noise_multiplier(*args) == jprivacy.compute_noise_multiplier(*args)
    for args in ((10, 8, 100, 1.0), (100, 8, 100, 0.5), (10, 8, 0, 2.0), (10, 8, 100, 0.0)):
        assert privacy.get_privacy_spent(*args) == jprivacy.get_privacy_spent(*args)
    assert privacy.DPConfig is privacy.PrivacyConfig
    assert privacy.PrivacyConfig() == privacy.PrivacyConfig(8.0, 1e-5, 1.0, 1.0)


def test_clip_before_adamw_matches_optax():
    """Three steps of make_private(adamw) at noise 0, the clip active."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in p0.items()}
             for s in (3.0, 0.1, 1.0)]
    cfg = jprivacy.PrivacyConfig(max_grad_norm=0.5, noise_multiplier=0.0)
    tx = jprivacy.make_private(optax.adamw(1e-2), cfg, batch_size=4)

    def steps(p, gs):
        state = tx.init(p)
        for g in gs:
            upd, state = tx.update(g, state, p)
            p = optax.apply_updates(p, upd)
        return p

    jp = _jit(steps)(p0, grads)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p0.items()}
    opt = privacy.make_private(
        torch.optim.AdamW(list(tp.values()), lr=1e-2, weight_decay=1e-4),
        privacy.PrivacyConfig(max_grad_norm=0.5, noise_multiplier=0.0), batch_size=4)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in p0:
        _assert_rel(tp[k], jp[k], 1e-6, k)
    assert opt.transform.steps == 3
    # The transformation alone: one global-norm clip.
    clipped = privacy.dp_gradient_transform(0.5, 0.0, 4)(
        [torch.from_numpy(v.copy()) for v in grads[0].values()])
    jtx = jprivacy.dp_gradient_transform(0.5, 0.0, 4)
    ref, _ = _jit(jtx.update)(grads[0], jtx.init(p0))
    for got, k in zip(clipped, grads[0]):
        _assert_rel(got, ref[k], 1e-6, k)


def test_per_sample_clipping_matches_jax():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    x = np.concatenate([np.ones((1, 4)) * 100, rng.standard_normal((5, 4))]).astype(np.float32)
    y = rng.standard_normal((6, 2)).astype(np.float32)
    jl, jg = _jit(jprivacy.make_private_loss_grad(
        lambda p, b: jnp.mean((b[0] @ p["w"] - b[1]) ** 2), 1.0))({"w": w}, (x, y))
    tl, tg = privacy.make_private_loss_grad(
        lambda p, b: torch.mean((b[0] @ p["w"] - b[1]) ** 2), 1.0)(
        {"w": torch.from_numpy(w)}, (torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(tl.item() - float(jl)) <= 1e-6 * float(jl)
    _assert_rel(tg["w"], jg["w"], 1e-6, "clipped mean gradient")
    assert float(np.linalg.norm(np.asarray(jg["w"]))) <= 1.0 + 1e-5


def _std_within(noise: torch.Tensor, std: float) -> None:
    """The sample std within 6 standard errors (std / √(2n)) of ``std``."""
    n = noise.numel()
    s = noise.double().std().item()
    assert abs(s - std) <= 6 * std / np.sqrt(2 * n), (s, std)
    assert abs(noise.double().mean().item()) <= 6 * std / np.sqrt(n)


def test_noise_std_within_its_sampling_bound():
    # Per step: σ·C/B on zero gradients (no clip).
    tf = privacy.dp_gradient_transform(max_grad_norm=2.0, noise_multiplier=1.5, batch_size=4,
                                       seed=1)
    noised = tf([torch.zeros(200, 300), torch.zeros(1000)])
    _std_within(torch.cat([t.flatten() for t in noised]), 1.5 * 2.0 / 4)
    again = privacy.dp_gradient_transform(2.0, 1.5, 4, seed=1)([torch.zeros(200, 300)])[0]
    assert torch.equal(again, noised[0])  # seeded
    # Per round: σ·C/Σw on a zero aggregate.
    params = {"w": torch.zeros(300, 200)}
    sim = simulation.MeshFederatedSimulation(
        lambda p, b: (p["w"] * 0).sum() + b.sum() * 0, params, torch.zeros(2, 3),
        weights=np.array([1.0, 3.0]), local_steps=1, local_lr=0.1,
        privacy=privacy.PrivacyConfig(max_grad_norm=0.8, noise_multiplier=2.0), seed=2)
    m = sim.run_round()
    assert m["total_weight"] == 4.0
    _std_within(sim.params["w"], 2.0 * 0.8 / 4.0)
    assert m["update_norm"] == pytest.approx(sim.params["w"].norm().item(), rel=1e-5)


# --------------------------------------------------------------------------- #
# (4) The client
# --------------------------------------------------------------------------- #
def _client_data(seed, n, lr=8):
    rng = np.random.default_rng(seed)
    hr = rng.random((n, 2 * lr, 2 * lr, 3)).astype(np.float32)
    return {"lr": hr.reshape(n, lr, 2, lr, 2, 3).mean((2, 4)).astype(np.float32), "hr": hr}


@pytest.mark.parametrize("dp", [False, True], ids=["adamw", "dp_clip"])
def test_client_fit_and_evaluate_match_jax(lw, dp):
    variables = lw[0]
    data = _client_data(5, 8)
    jp = jprivacy.PrivacyConfig(max_grad_norm=0.02, noise_multiplier=0.0) if dp else None
    tp = privacy.PrivacyConfig(max_grad_norm=0.02, noise_multiplier=0.0) if dp else None
    kw = dict(num_frames=1, local_epochs=1, batch_size=4, seed=3)
    jc = jfed.VideoEnhancementClient(JaxLightweight(scale_factor=2), data, privacy=jp, **kw)
    jc.batch_stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    start = jfed.tree_to_arrays(variables["params"])
    tc = federated.VideoEnhancementClient(_port_model(variables), data, privacy=tp, **kw)
    jarr, jn, jm = jc.fit(start, {})
    tarr, tn, tm = tc.fit(start, {})
    assert tn == jn == 8 and len(tarr) == len(jarr)
    for i, (a, b) in enumerate(zip(tarr, jarr)):
        assert a.dtype == b.dtype and a.shape == b.shape
        _assert_rel(a, b, STEP_REL, f"array {i}")
        assert np.abs(a - start[i]).max() > 0  # it trained
    assert tm["train_loss"] == pytest.approx(jm["train_loss"], rel=1e-5)
    _assert_trees(params_to_flax(tc.batch_stats), jc.batch_stats, STEP_REL, "client batch_stats")
    jl, jn, _ = jc.evaluate(jarr)
    tl, tn, tmet = tc.evaluate(jarr)
    assert tn == jn and tl == pytest.approx(jl, rel=1e-5) and tmet == {"mse": tl}


def test_client_batch_clamps():
    model = LightweightSuperResolution(device="cpu", generator=torch.Generator().manual_seed(0))
    c = federated.VideoEnhancementClient(model, _client_data(0, 16), _client_data(1, 2),
                                         num_frames=1, local_epochs=1, batch_size=8)
    assert c.batch_size == 8 and c.eval_batch_size == 2
    _, n, fit_metrics = c.fit(c.get_parameters(), {})
    loss, _, _ = c.evaluate(c.get_parameters(), {})
    assert n == 16 and np.isfinite(fit_metrics["train_loss"]) and np.isfinite(loss)
    # DP noise scales with the clamped batch; the client trains a copy.
    d = federated.create_client(model, *_client_data(0, 4).values(), num_frames=1,
                                local_epochs=1, batch_size=32,
                                privacy=privacy.PrivacyConfig(max_grad_norm=1.0))
    assert d.batch_size == 4 and d.optimizer.transform.std == 1.0 / 4
    before = [p.detach().clone() for p in model.parameters()]
    _, _, metrics = d.fit(d.get_parameters(), {})
    assert np.isfinite(metrics["train_loss"])
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


# --------------------------------------------------------------------------- #
# (5) The FedAvg round
# --------------------------------------------------------------------------- #
def test_fedavg_round_matches_jax_mesh(lw):
    variables = lw[0]
    rng = np.random.default_rng(6)
    lrs = rng.random((2, 3, 8, 8, 3)).astype(np.float32)
    hrs = rng.random((2, 3, 16, 16, 3)).astype(np.float32)
    jm = JaxLightweight(scale_factor=2)

    def jloss(p, batch):
        out = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, batch[0])
        return jnp.mean((out - batch[1]) ** 2)

    mesh = make_mesh(data=1, client=2, devices=jax.devices()[:2])
    weights = np.array([1.0, 3.0], np.float32)
    jsim = JaxSimulation(jloss, jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                         (lrs, hrs), weights=weights, mesh=mesh, local_steps=2, local_lr=0.2)
    jmet = jsim.run_round()
    model = _port_model(variables).eval()
    tsim = simulation.MeshFederatedSimulation(
        train_federated.frozen_stats_loss(model), detached(dict(model.named_parameters())),
        (torch.from_numpy(lrs), torch.from_numpy(hrs)), weights=weights, local_steps=2,
        local_lr=0.2)
    tmet = tsim.run_round()
    assert tmet["total_weight"] == jmet["total_weight"] == 4.0
    assert tmet["update_norm"] == pytest.approx(jmet["update_norm"], rel=1e-4)
    got = jax.tree_util.tree_leaves(params_to_flax(tsim.params))
    for a, b in zip(got, jax.tree_util.tree_leaves(jsim.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    # The model's own parameters are untouched by the simulation; its loss
    # needs the eval forward.
    assert torch.equal(model.tail.kernel, torch.from_numpy(variables["params"]["tail"]["kernel"]))
    with pytest.raises(ValueError, match="eval"):
        train_federated.frozen_stats_loss(model.train())(tsim.params, (tsim.client_data[0][0],
                                                                      tsim.client_data[1][0]))


def test_fedavg_matches_manual_average():
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((4, 2), generator=g)}
    xs, ys = torch.randn((5, 16, 4), generator=g), torch.randn((5, 16, 2), generator=g)
    weights = np.arange(1, 6, dtype=np.float32)

    def loss_fn(p, batch):
        return torch.mean((batch[0] @ p["w"] - batch[1]) ** 2)

    sim = simulation.MeshFederatedSimulation(loss_fn, params, (xs, ys), weights=weights,
                                             local_steps=3, local_lr=0.1)
    m = sim.run_round()
    w0 = params["w"].double()
    deltas = []
    for c in range(5):
        w = w0.clone()
        for _ in range(3):  # the gradient of the mean squared error, by hand
            w = w - 0.1 * 2 * xs[c].double().T @ (xs[c].double() @ w - ys[c].double()) / (16 * 2)
        deltas.append(w - w0)
    agg = sum(float(wt) * d for wt, d in zip(weights, deltas)) / weights.sum()
    np.testing.assert_allclose(sim.params["w"].numpy(), (w0 + agg).numpy(), rtol=1e-4,
                               atol=1e-5)
    assert m["update_norm"] == pytest.approx(agg.norm().item(), rel=1e-4)
    assert len(sim.run(2)) == 3
    with pytest.raises(ValueError, match="mesh"):
        simulation.MeshFederatedSimulation(loss_fn, params, (xs, ys), mesh=object())
    assert np.isfinite(simulation.dryrun_fedavg("cpu")["update_norm"])


def test_dp_round_clips_each_client_delta():
    """With the noise at 0, each client's delta is clipped to C: the update
    is the weighted mean of deltas of norm ≤ C."""
    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn((4, 2), generator=g)}
    xs, ys = torch.randn((3, 8, 4), generator=g) * 5, torch.randn((3, 8, 2), generator=g)
    cfg = privacy.PrivacyConfig(max_grad_norm=0.05, noise_multiplier=0.0)
    sim = simulation.MeshFederatedSimulation(
        lambda p, b: torch.mean((b[0] @ p["w"] - b[1]) ** 2), params, (xs, ys),
        local_steps=2, local_lr=0.1, privacy=cfg)
    assert sim.run_round()["update_norm"] <= 0.05 + 1e-6


# --------------------------------------------------------------------------- #
# (6) Strategy, trainer, clustering
# --------------------------------------------------------------------------- #
def test_strategy_matches_jax():
    kw = dict(fraction_fit=0.3, min_fit_clients=2, keep_last_versions=2,
              epoch_reduction_round=3, seed=7)
    ts, js = federated.VideoEnhancementStrategy(**kw), jfed.VideoEnhancementStrategy(**kw)
    ids = [f"c{i}" for i in range(10)]
    for rnd in (1, 3, 4):
        assert ts.configure_fit(rnd, ids) == js.configure_fit(rnd, ids)
    rng = np.random.default_rng(8)
    for rnd in range(4):
        results = [([rng.standard_normal((2, 3)).astype(np.float32),
                     rng.standard_normal(4).astype(np.float16)], int(n), {"m": float(n)})
                   for n in rng.integers(1, 9, size=3)]
        (ta, tm), (ja, jm) = ts.aggregate_fit(rnd, results), js.aggregate_fit(rnd, results)
        assert tm == jm and all(a.dtype == b.dtype and np.array_equal(a, b)
                                for a, b in zip(ta, ja))
    assert len(ts.model_versions) == len(js.model_versions) == 2
    assert ts.aggregate_fit(5, []) == js.aggregate_fit(5, []) == (None, {})
    pairs = [(1, {"loss": 1.0}), (3, {"loss": 5.0, "psnr": 2.0})]
    assert federated.weighted_average(pairs) == jfed.weighted_average(pairs)
    assert federated.weighted_average([(0, {"a": 1.0})]) == {}


class _NumpyClient:
    """A deterministic client: fit moves each array toward its target."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.target = [rng.standard_normal((3, 2)).astype(np.float32),
                       rng.standard_normal(4).astype(np.float32)]
        self.n = int(rng.integers(2, 9))

    def fit(self, arrays, config):
        out = [a + 0.1 * config["local_epochs"] * (t - a) for a, t in zip(arrays, self.target)]
        loss = float(sum(np.sum((t - a) ** 2) for a, t in zip(arrays, self.target)))
        return out, self.n, {"train_loss": loss}

    def evaluate(self, arrays, config):
        loss = float(sum(np.sum((t - a) ** 2) for a, t in zip(arrays, self.target)))
        return loss, self.n, {"mse": loss}


def test_trainer_matches_jax():
    init = [np.zeros((3, 2), np.float32), np.zeros(4, np.float32)]
    runs = []
    for pkg in (federated, jfed):
        clients = [_NumpyClient(s) for s in range(6)]
        trainer = pkg.FederatedTrainer(clients, init, pkg.VideoEnhancementStrategy(
            fraction_fit=0.5, min_fit_clients=2, seed=4))
        runs.append((trainer.run(4), trainer.parameters, trainer.evaluate_round()))
    (th, tp, te), (jh, jp, je) = runs
    assert th == jh and te == je and th[-1]["num_clients"] == 3.0
    assert all(np.array_equal(a, b) for a, b in zip(tp, jp))


def _profiles(n=20):
    rng = np.random.default_rng(0)
    return [dict(user_id=f"u{i}",
                 content_preferences={"sports": float(i < n // 2), "movie": float(i >= n // 2),
                                      "news": float(rng.random())},
                 quality_preference=float(rng.random()),
                 network_pattern=("wifi", "5g", "4g", "3g")[i % 4],
                 device_tier=("low", "mid", "high")[i % 3]) for i in range(n)]


def test_clustering_matches_jax():
    out = []
    for pkg in (federated, jfed):
        uc = pkg.UserClustering(num_clusters=3, seed=1)
        first = [uc.register_user(pkg.UserProfile(**p)) for p in _profiles()]
        uc.update_clusters()
        late = uc.register_user(pkg.UserProfile(**_profiles(21)[-1]))
        out.append(dict(first=first, labels=uc.labels, centroids=uc.centroids.tolist(),
                        stats=uc.get_cluster_stats(), late=late,
                        members=uc.get_cluster_members(0)))
    assert out[0] == out[1]
    assert len(set(out[0]["labels"].values())) == 3


# --------------------------------------------------------------------------- #
# (7) Sockets, (8) the CLI
# --------------------------------------------------------------------------- #
def test_port_client_answers_the_jax_server(lw):
    """A port client fits and evaluates through the JAX package's server
    transport: the wire format interoperates."""
    variables = lw[0]
    start = jfed.tree_to_arrays(variables["params"])
    client = federated.VideoEnhancementClient(_port_model(variables), _client_data(9, 4),
                                              num_frames=1, local_epochs=1, batch_size=4)
    server = jtransport.FLServerTransport("127.0.0.1:0")
    try:
        t = threading.Thread(target=transport.run_client,
                             args=(client, f"127.0.0.1:{server.port}", "port-0"), daemon=True)
        t.start()
        assert server.wait_for_clients(1, timeout=10) == ["port-0"]
        strat = jfed.VideoEnhancementStrategy(fraction_fit=1.0, min_fit_clients=1)
        selected, cfg = strat.configure_fit(1, ["port-0"])
        meta, arrays = server.request("port-0", "fit", {**cfg, "local_epochs": 1}, start)
        assert meta["num_samples"] == 4 and np.isfinite(meta["metrics"]["train_loss"])
        assert [(a.dtype, a.shape) for a in arrays] == [(a.dtype, a.shape) for a in start]
        agg, metrics = strat.aggregate_fit(1, [(arrays, meta["num_samples"], meta["metrics"])])
        assert "train_loss" in metrics
        emeta, _ = server.request("port-0", "evaluate", {}, agg)
        assert emeta["num_samples"] == 4 and emeta["loss"] == emeta["metrics"]["mse"]
    finally:
        server.close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_port_server_round_with_port_clients(lw, capsys):
    variables = lw[0]
    start = jfed.tree_to_arrays(variables["params"])
    with socket.socket() as probe:  # a free port
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    clients = [federated.VideoEnhancementClient(_port_model(variables), _client_data(s, 4),
                                                num_frames=1, batch_size=4, seed=s)
               for s in range(2)]
    threads = [threading.Thread(target=transport.run_client,
                                args=(c, f"127.0.0.1:{port}", f"c{i}"), daemon=True)
               for i, c in enumerate(clients)]
    for t in threads:  # the clients start first: they retry until the server listens
        t.start()
    strategy = federated.VideoEnhancementStrategy(min_fit_clients=2, base_local_epochs=1)
    final = federated.start_server(start, num_rounds=1, address=f"127.0.0.1:{port}",
                                   strategy=strategy, wait_timeout=20)
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert "round 1:" in capsys.readouterr().out
    assert [a.shape for a in final] == [a.shape for a in start]
    assert not all(np.array_equal(a, b) for a, b in zip(final, start))


@pytest.mark.parametrize("mode", ["simulation", "trainer"])
def test_train_federated_cli_on_the_cpu(mode, capsys):
    out = train_federated.main(["--mode", mode, "--device", "cpu", "--num-clients", "2",
                                "--num-rounds", "2", "--local-steps", "1",
                                "--samples-per-client", "8", "--local-epochs", "1"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == out and last["rounds"] == 2 and np.isfinite(last["final_loss"])


def test_flower_adapter_imports_without_flwr():
    from nerve_tpu_torch.federated import flower_compat

    assert "flwr" not in sys.modules
    with pytest.raises(ImportError, match="flwr"):
        flower_compat.make_flower_strategy()
