"""The port's continual-learning pillar against the JAX package's, on the CPU.

(1) Gradients of gradients through each kernel op's autograd Function (the
conv chain on a list input, a 2-block RDB stack, the correlation, the warp):
a Hessian-vector product ∂/∂(inputs, g) ⟨∂⟨op(inputs), g⟩/∂inputs, v⟩ against
the same through the op's plain version and against JAX's ``jax.grad`` of a
``jax.vjp`` (the vjp of the XLA formulation, and for the warp of its
``custom_vjp`` backward). Every input and the upstream gradient ``g`` get a
second derivative where the plain version has one. float32, within 1e-5 of
max|ref| per tensor.

(2) The flagship's eval forward under autograd (``differentiable=True``, a
small model: 8 features, 1 RDB, window 1, 8 × 8 LR, every weight and
BatchNorm statistic seeded, so the flow is not zero): the loss and every
parameter's gradient by flax path against ``jax.grad`` of
``model.apply(..., train=False)``, within 1e-4 of max|ref| per tensor
(``STEP_REL``); the BatchNorm statistics do not move; serving stays under
``inference_mode``.

(3) The continual rules over a small model made of the four kernel ops
(``mini_loss``: a conv head on three frames, the correlation and a flow
chain, the warp, an attention chain on the three aligned frames, an RDB and
an output conv, with the same parameter dict on both sides): the batch
and the per-sample Fisher against ``nerve_tpu.continual.compute_fisher``,
EWC in both modes after two registrations (Fisher, penalty, importance
stats) and SI after two SGD steps (importances, penalty), within
``STEP_REL``; ``DistillationLoss`` and ``ContinualDistillation``;
the replay memory step for step against the JAX package's (the same numpy
generator); ``train_continual.main`` once per strategy on the CPU at 8 × 8
LR (``tests/test_torch_port_maml.py`` holds the meta-learners). Each JAX
sequence runs as one program compiled with ``XLA_OPTS`` (the JAX classes'
own jits inline into it).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerve_tpu import continual as jcontinual
from nerve_tpu.continual import ewc as jewc
from nerve_tpu.models.super_resolution import SuperResolutionNet as JaxSR
from nerve_tpu.ops import conv_chain as jcc
from nerve_tpu.ops import correlation as jcorr
from nerve_tpu.ops import rdb as jrdb
from nerve_tpu.ops import warp as jwarp
from nerve_tpu.utils.data import expand_temporal as jexpand
from nerve_tpu_torch import continual, ops, train_continual
from nerve_tpu_torch.continual import ewc
from nerve_tpu_torch.continual.params import value_and_grad
from nerve_tpu_torch.models import SuperResolutionNet, flax_variables, load_flax_variables
from nerve_tpu_torch.models.bridge import params_to_flax
from nerve_tpu_torch.ops import conv_chain, correlation, rdb, warp
from nerve_tpu_torch.utils import data as data_lib
from test_torch_port_models import randomize
from test_torch_port_training import XLA_OPTS, _assert_rel, _assert_trees, _r

HVP_REL = 1e-5
STEP_REL = 1e-4
SR_CFG = dict(scale_factor=2, num_features=8, num_residual_blocks=1, temporal_window=1)


def _jit(fn):
    return jax.jit(fn, compiler_options=XLA_OPTS)



@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: these small ops run slower on more threads
    when the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# --------------------------------------------------------------------------- #
# (1) Gradients of gradients through the kernel ops
# --------------------------------------------------------------------------- #


def _hvp_torch(fn, arrays, g, vs):
    """(∂S/∂inputs…, ∂S/∂g), S = ⟨∂⟨fn(inputs), g⟩/∂inputs, v⟩, and the
    first-order gradients (which must carry a graph)."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    gl = torch.from_numpy(g).requires_grad_(True)
    first = torch.autograd.grad(fn(*leaves), leaves, gl, create_graph=True)
    assert all(d.grad_fn is not None for d in first), "first-order gradients without a graph"
    s = sum((d * torch.from_numpy(v)).sum() for d, v in zip(first, vs))
    return torch.autograd.grad(s, leaves + [gl], allow_unused=True)


def _hvp_jax(fn, arrays, g, vs):
    def s(args, g):
        _out, vjp = jax.vjp(fn, *args)
        return sum(jnp.vdot(d, v) for d, v in zip(vjp(g), vs))

    return _jit(jax.grad(s, argnums=(0, 1)))([jnp.asarray(a) for a in arrays], jnp.asarray(g))


def _chain_case(rng):
    xs = [_r(rng, 2, 9, 11, 8) for _ in range(3)]
    wb = [_r(rng, 3, 3, 24, 16, std=0.2), _r(rng, 1, 1, 16, 16, std=0.3),
          _r(rng, 3, 3, 16, 5, std=0.2), _r(rng, 16, std=0.1), _r(rng, 16, std=0.1),
          _r(rng, 5, std=0.1)]
    acts = ("relu", "relu", "none")

    def entries(t):
        return list(zip(t[:3], t[3:], acts))

    return (lambda *t: ops.conv_chain_apply(list(t[:3]), entries(t[3:])),
            lambda *t: conv_chain.conv_chain_plain(list(t[:3]), entries(t[3:])),
            lambda *t: jcc.conv_chain_apply(list(t[:3]), entries(t[3:])),
            xs + wb, _r(rng, 2, 9, 11, 5))


def _rdb_block(rng, c, g, layers):
    params, cin = [], c
    for _ in range(layers):
        params += [_r(rng, 3, 3, cin, g, std=0.3), _r(rng, g, std=0.1)]
        cin += g
    return params + [_r(rng, cin, c, std=0.3), _r(rng, c, std=0.1)]


def _rdb_case(rng):
    blocks = [_rdb_block(rng, 8, 4, 3) for _ in range(2)]
    sizes = [len(b) for b in blocks]
    return (lambda x, *p: ops.rdb_chain_apply(x, rdb._blocks(p, sizes)),
            lambda x, *p: rdb.rdb_chain_plain(x, rdb._blocks(p, sizes)),
            lambda x, *p: jrdb.rdb_chain_apply(x, rdb._blocks(p, sizes)),
            [_r(rng, 2, 7, 9, 8)] + [p for b in blocks for p in b], _r(rng, 2, 7, 9, 8))


def _corr_case(rng):
    return (lambda a, b: ops.correlation_volume(a, b, 2),
            lambda a, b: correlation.correlation_plain(a, b, 2),
            lambda a, b: jcorr.correlation_volume(a, b, 2),
            [_r(rng, 2, 7, 9, 6), _r(rng, 2, 7, 9, 6)], _r(rng, 2, 7, 9, 25))


def _warp_case(rng):
    return (ops.flow_warp, warp._warp, lambda f, fl: jwarp.flow_warp(f, fl, chunk_rows=0),
            [_r(rng, 2, 8, 10, 5), _r(rng, 2, 8, 10, 2, std=2.0)], _r(rng, 2, 8, 10, 5))


HVP_CASES = {"conv_chain": _chain_case, "rdb": _rdb_case, "correlation": _corr_case,
             "warp": _warp_case}


@pytest.mark.parametrize("name", list(HVP_CASES))
def test_double_backward_through_kernel_ops(name):
    """The Function's second derivative is its plain version's and JAX's."""
    rng = np.random.default_rng(10)
    fn, plain, jfn, arrays, g = HVP_CASES[name](rng)
    vs = [_r(rng, *a.shape) for a in arrays]
    got = _hvp_torch(fn, arrays, g, vs)
    want = _hvp_torch(plain, arrays, g, vs)
    jargs, jg = _hvp_jax(jfn, arrays, g, vs)
    for i, (a, b, j) in enumerate(zip(got, want, list(jargs) + [jg])):
        if b is None:  # linear in this input: no second derivative anywhere
            assert a is None and not np.asarray(j).any(), f"input {i}"
            continue
        assert a is not None and b.abs().max() > 0, f"input {i}: no second derivative"
        _assert_rel(a, b.detach().numpy(), HVP_REL, f"{name} input {i} vs plain")
        _assert_rel(a, j, HVP_REL, f"{name} input {i} vs JAX")


def test_first_order_backward_keeps_no_graph():
    """Without ``create_graph`` the recompute's gradients carry no graph."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_r(rng, 2, 7, 9, 6)).requires_grad_(True)
    y = torch.from_numpy(_r(rng, 2, 7, 9, 6)).requires_grad_(True)
    (dx,) = torch.autograd.grad(ops.correlation_volume(x, y, 2).sum(), [x])
    assert dx.grad_fn is None and not dx.requires_grad


# --------------------------------------------------------------------------- #
# (2) The flagship's eval forward under autograd, and its Fisher
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def sr_setup():
    """The small flagship on both sides, a batch, and JAX's loss and
    gradient."""
    variables = randomize(flax_variables(SuperResolutionNet(**SR_CFG, device="cpu")), seed=7)
    model = load_flax_variables(SuperResolutionNet(**SR_CFG, device="cpu"), variables).eval()
    rng = np.random.default_rng(12)
    batch = (rng.random((2, 8, 8, 3)).astype(np.float32),
             rng.random((2, 16, 16, 3)).astype(np.float32))
    jmodel = JaxSR(**SR_CFG)

    def jloss(p, b):
        out = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                           jexpand(b[0], 3), train=False)
        return jnp.mean((out.astype(jnp.float32) - b[1]) ** 2)

    return model, to_torch(batch), _jit(jax.value_and_grad(jloss))(variables["params"], batch)


def test_eval_forward_gradients_match_jax(sr_setup):
    model, (lr, hr), (jl, jg) = sr_setup
    stats = {k: b.clone() for k, b in model.named_buffers()}
    with torch.no_grad():
        f = model.extract_features(lr)
        assert model.motion_estimator(f, f.flip(0)).abs().max() > 0.1  # the flow is not 0
    loss, grads = value_and_grad(train_continual.sr_loss(model, 3),
                                 dict(model.named_parameters()), (lr, hr))
    assert abs(loss.item() - float(jl)) <= STEP_REL * abs(float(jl))
    assert all(g.abs().max() > 0 for g in grads.values())
    _assert_trees(params_to_flax(grads), jg, STEP_REL, "gradient")
    for k, b in model.named_buffers():
        assert torch.equal(b, stats[k]), f"{k} moved"
    out = model(data_lib.expand_temporal(lr, 3))
    assert out.is_inference() and out.grad_fn is None


# --------------------------------------------------------------------------- #
# (3) The rules over a small model of the four kernel ops
# --------------------------------------------------------------------------- #

MINI_C, MINI_D = 8, 2
MINI_ACTS = {"head": ("relu",), "flow": ("relu", "none"), "attn": ("relu",), "out": ("none",)}


def mini_params(seed):
    """The small model's parameters as a dict of float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    c, nd = MINI_C, (2 * MINI_D + 1) ** 2
    p = {"head_w": _r(rng, 3, 3, 3, c, std=0.4), "head_b": _r(rng, c, std=0.05),
         "flow0_w": _r(rng, 3, 3, nd, 8, std=0.2), "flow0_b": _r(rng, 8, std=0.05),
         "flow1_w": _r(rng, 3, 3, 8, 2, std=0.3), "flow1_b": _r(rng, 2, std=0.3),
         "attn_w": _r(rng, 3, 3, 3 * c, c, std=0.15), "attn_b": _r(rng, c, std=0.05),
         "out_w": _r(rng, 3, 3, c, 3, std=0.15), "out_b": _r(rng, 3, std=0.05)}
    for i, a in enumerate(_rdb_block(rng, c, 4, 2)):
        p[f"rdb_{i:02d}"] = a * np.float32(0.5)
    return p


def _mini_forward(p, lr, chain, corr, warp_fn, rdb_fn, cat):
    """(B, 3, H, W, 3) → (B, H, W, 3) in the ops of one framework."""
    b, t, h, w, _ = lr.shape

    def entries(name, ws):
        return [(p[f"{n}_w"], p[f"{n}_b"], a) for n, a in zip(ws, MINI_ACTS[name])]

    feats = chain(lr.reshape(b * t, h, w, 3), entries("head", ["head"])).reshape(b, t, h, w, -1)
    ctr = feats[:, 1]
    nb = cat([feats[:, 0], feats[:, 2]])
    flow = chain(corr(nb, cat([ctr, ctr]), MINI_D), entries("flow", ["flow0", "flow1"]))
    warped = warp_fn(nb, flow)
    agg = chain([warped[:b], ctr, warped[b:]], entries("attn", ["attn"]))
    block = [p[k] for k in sorted(p) if k.startswith("rdb_")]
    return chain(rdb_fn(agg, [block]), entries("out", ["out"]))


def mini_apply(p, lr):
    return _mini_forward(p, lr, ops.conv_chain_apply, ops.correlation_volume, ops.flow_warp,
                         ops.rdb_chain_apply, lambda xs: torch.cat(xs, 0))


def mini_apply_jax(p, lr):
    return _mini_forward(p, lr, jcc.conv_chain_apply, jcorr.correlation_volume,
                         lambda f, fl: jwarp.flow_warp(f, fl, chunk_rows=0),
                         jrdb.rdb_chain_apply, lambda xs: jnp.concatenate(xs, 0))


def mini_loss(p, batch):
    return torch.mean((mini_apply(p, batch[0]) - batch[1]) ** 2)


def mini_loss_jax(p, batch):
    return jnp.mean((mini_apply_jax(p, batch[0]) - batch[1]) ** 2)


def mini_batch(seed, n=2, h=7, w=9):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3, h, w, 3)).astype(np.float32),
            rng.random((n, h, w, 3)).astype(np.float32))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return tuple(torch.from_numpy(np.array(v)) for v in tree)


def assert_dicts(got, ref, rel, what):
    assert set(got) == set(ref), what
    for k in ref:
        _assert_rel(got[k], np.asarray(ref[k]), rel, f"{what} {k}")


def test_mini_model_runs_every_kernel_op():
    p = {k: v.requires_grad_(True) for k, v in to_torch(mini_params(0)).items()}
    loss = mini_loss(p, to_torch(mini_batch(1)))
    names, node, seen = set(), [loss.grad_fn], set()
    while node:
        n = node.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        names.add(type(n).__name__)
        node.extend(f for f, _ in n.next_functions)
    for fn in ("_ConvChainBackward", "_RDBChainBackward", "_CorrelationBackward",
               "_FlowWarpBackward"):
        assert fn in names, fn


@pytest.fixture(scope="module")
def fisher_ref():
    """JAX's batch and per-sample Fisher of the small model over two
    batches, one compiled program."""
    p, batches = mini_params(0), [mini_batch(1), mini_batch(2)]
    ref = _jit(lambda p, bs: {ps: jewc.compute_fisher(mini_loss_jax, p, bs, per_sample=ps)
                              for ps in (False, True)})(p, batches)
    return p, batches, ref


@pytest.mark.parametrize("per_sample", [False, True], ids=["batch", "per_sample"])
def test_fisher_matches_jax(fisher_ref, per_sample):
    p, batches, ref = fisher_ref
    got = ewc.compute_fisher(mini_loss, to_torch(p), [to_torch(b) for b in batches],
                             per_sample=per_sample)
    assert_dicts(got, ref[per_sample], STEP_REL, "Fisher")


def _perturbed(p, seed, std=0.05):
    rng = np.random.default_rng(seed)
    return {k: v + _r(rng, *v.shape, std=std) for k, v in p.items()}


EWC_MODES = ("online", "separate")


@pytest.fixture(scope="module")
def ewc_ref():
    """JAX's EWC in both modes: two registrations (the second at other
    parameters and on one batch), the penalty at a third point and the
    state, one compiled program."""
    p0 = mini_params(0)
    p1, p2 = _perturbed(p0, 3), _perturbed(p0, 4)
    b = [mini_batch(5), mini_batch(6)]

    def jax_run(p0, p1, p2, b):
        out = {}
        for mode in EWC_MODES:
            ref = jcontinual.EWC(mini_loss_jax, lam=10.0, mode=mode, decay=0.5)
            ref.register_task(0, p0, b)
            ref.register_task(1, p1, b[:1])
            sd = ref.state_dict()
            out[mode] = ref.penalty(p2), {k: sd[k] for k in ("fisher", "optimal",
                                                              "task_fisher", "task_optimal")}
        return out

    return (p0, p1, p2, b), _jit(jax_run)(p0, p1, p2, b)


@pytest.mark.parametrize("mode", EWC_MODES)
def test_ewc_matches_jax(ewc_ref, mode):
    """The penalty, the Fisher and its stats, the optima, and a state round
    trip against JAX's ``EWC``."""
    (p0, p1, p2, b), refs = ewc_ref
    jpen, jsd = refs[mode]
    jsd = {**jsd, "num_tasks": 2}
    ref = jcontinual.EWC(mini_loss_jax, mode=mode)
    ref.load_state_dict(jsd)
    port = continual.EWC(mini_loss, lam=10.0, mode=mode, decay=0.5)
    assert float(port.penalty(to_torch(p0))) == 0.0
    port.register_task(0, to_torch(p0), [to_torch(x) for x in b])
    port.register_task(1, to_torch(p1), [to_torch(b[0])])
    pen = port.penalty(to_torch(p2))
    assert abs(float(pen) - float(jpen)) <= STEP_REL * abs(float(jpen)) and float(pen) > 0
    sd = port.state_dict()
    if mode == "online":
        assert_dicts(sd["fisher"], jsd["fisher"], STEP_REL, "Fisher")
        assert_dicts(sd["optimal"], p1, 0.0, "optimum")
    else:
        for tid, p in ((0, p0), (1, p1)):
            assert_dicts(sd["task_fisher"][tid], jsd["task_fisher"][tid], STEP_REL,
                         f"Fisher {tid}")
            assert_dicts(sd["task_optimal"][tid], p, 0.0, f"optimum {tid}")
    stats, jstats = port.get_importance_stats(), ref.get_importance_stats()
    assert stats["num_tasks"] == jstats["num_tasks"] == 2
    for k in ("mean", "max"):
        assert abs(stats[k] - jstats[k]) <= STEP_REL * abs(jstats[k])
    fresh = continual.EWC(mini_loss, lam=10.0, mode=mode)
    fresh.load_state_dict(sd)
    assert torch.equal(fresh.penalty(to_torch(p2)), pen)
    # The penalty is differentiable in the parameters.
    leaves = {k: v.requires_grad_(True) for k, v in to_torch(p2).items()}
    (g,) = torch.autograd.grad(port.penalty(leaves), [leaves["head_w"]])
    assert g.abs().max() > 0


def test_synaptic_intelligence_matches_jax():
    """Two SGD steps (each framework's own gradients), then the importances
    and the penalty; a second task adds to the importances."""
    p0, q = mini_params(0), _perturbed(mini_params(0), 9)
    batches = [mini_batch(7), mini_batch(8)]

    def jax_run(p, q, batches):
        ref = jcontinual.SynapticIntelligence(lam=2.0)
        ref.start_task(p)
        for batch in batches:
            g = jax.grad(mini_loss_jax)(p, batch)
            new = jax.tree_util.tree_map(lambda a, b: a - 0.05 * b, p, g)
            ref.update_importance(p, new, g)
            p = new
        ref.register_task(p)
        return ref._omega, ref.penalty(q)

    jomega, jpen = _jit(jax_run)(p0, q, batches)
    port = continual.SynapticIntelligence(lam=2.0)
    tp = to_torch(p0)
    port.start_task(tp)
    for batch in batches:
        _l, g = value_and_grad(mini_loss, tp, to_torch(batch))
        new = {k: v - 0.05 * g[k] for k, v in tp.items()}
        port.update_importance(tp, new, g)
        tp = new
    port.register_task(tp)
    assert_dicts(port._omega, jomega, STEP_REL, "SI importance")
    pen = float(port.penalty(to_torch(q)))
    assert abs(pen - float(jpen)) <= STEP_REL * abs(float(jpen)) and pen > 0
    omega = {k: v.clone() for k, v in port._omega.items()}
    port.start_task(tp)
    port.update_importance(tp, {k: v + 0.01 for k, v in tp.items()},
                           {k: -torch.ones_like(v) for k, v in tp.items()})
    port.register_task({k: v + 0.01 for k, v in tp.items()})
    assert all((port._omega[k] > omega[k]).all() for k in omega) and port.num_tasks == 2


def test_distillation_matches_jax():
    rng = np.random.default_rng(13)
    s, t, y = (_r(rng, 2, 6, 6, 3) for _ in range(3))
    loss = continual.DistillationLoss(alpha=0.3)
    jloss = jcontinual.DistillationLoss(alpha=0.3)
    for args in ((s, t), (s, t, y)):
        want = float(jloss(*args))
        assert abs(float(loss(*(torch.from_numpy(a) for a in args))) - want) <= 1e-6 * want
    p, student_np = mini_params(0), _perturbed(mini_params(0), 14)
    lr, hr = mini_batch(15)

    def jax_run(p, student, lr, hr):
        jcd = jcontinual.ContinualDistillation(mini_apply_jax, alpha=0.4)
        jcd.register_task(p)
        return jcd.compute_loss(student, lr, hr)

    ref = _jit(jax_run)(p, student_np, lr, hr)
    student = {k: v.requires_grad_(True) for k, v in to_torch(student_np).items()}
    cd = continual.ContinualDistillation(mini_apply, alpha=0.4)
    first = cd.compute_loss(student, torch.from_numpy(lr), torch.from_numpy(hr))
    assert float(first["distill"]) == 0.0 and first["total"] is first["task"]
    cd.register_task(to_torch(p))
    got = cd.compute_loss(student, torch.from_numpy(lr), torch.from_numpy(hr))
    for k in ("task", "distill", "total"):
        assert abs(got[k].item() - float(ref[k])) <= STEP_REL * abs(float(ref[k])), k
    (g,) = torch.autograd.grad(got["total"], [student["out_w"]])
    assert g.abs().max() > 0 and all(not v.requires_grad for v in cd.teacher_params.values())


# --------------------------------------------------------------------------- #
# Replay memory, data, and the CLI
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("strategy", ["reservoir", "stratified", "importance", "diversity",
                                      "fifo"])
@pytest.mark.parametrize("streaming", [False, True], ids=["episodic", "streaming"])
def test_memory_matches_jax(strategy, streaming, tmp_path):
    """The same stores and samples give the same buffer and batches."""
    def make(mod):
        if streaming:
            return mod.StreamingEpisodicMemory(capacity=8, strategy=strategy,
                                               recency_weight=0.9, seed=3)
        return mod.EpisodicMemory(capacity=8, strategy=strategy, seed=3)

    port, ref = make(continual), make(jcontinual)
    rng = np.random.default_rng(0)
    for i in range(40):
        lr, hr = rng.random((4, 4, 3)).astype(np.float32), rng.random((8, 8, 3)).astype(np.float32)
        meta = {"content_type": "abc"[i % 3]}
        assert port.store(lr, hr, meta, importance=float(i)) == ref.store(lr, hr, meta,
                                                                          importance=float(i))
    assert len(port) == len(ref) <= 8
    assert port.get_stats() == ref.get_stats()
    for n, ct in ((5, None), (2, "a"), (2, "missing")):
        got, want = port.sample(n, content_type=ct), ref.sample(n, content_type=ct)
        assert (got is None) == (want is None)
        if want is not None:
            for k in ("lr", "hr", "indices"):
                np.testing.assert_array_equal(got[k], want[k])
    path = str(tmp_path / "mem.npz")
    port.save(path)
    again = continual.EpisodicMemory(capacity=8)
    again.load(path)
    assert len(again) == len(port)
    np.testing.assert_array_equal(again._samples[0].frame_hr, port._samples[0].frame_hr)


def test_task_sequence():
    tasks = data_lib.make_task_sequence(1, num_tasks=3, samples_per_task=2, lr_size=4)
    assert [n for n, _ in tasks] == ["sports", "animation", "movie"]
    for _n, d in tasks:
        assert d["lr"].shape == (2, 4, 4, 3) and d["hr"].shape == (2, 8, 8, 3)
        assert d["hr"].min() >= 0 and d["hr"].max() <= 1
    # Offsets (i − n/2)/n shift the intensities: the first task darker.
    assert tasks[0][1]["hr"].mean() < tasks[2][1]["hr"].mean()
    again = data_lib.make_task_sequence(1, num_tasks=3, samples_per_task=2, lr_size=4)
    np.testing.assert_array_equal(again[1][1]["lr"], tasks[1][1]["lr"])


@pytest.mark.parametrize("strategy", ["ewc", "si", "replay", "maml", "reptile"])
def test_train_continual_cli_on_the_cpu(strategy, monkeypatch, capsys):
    """``train_continual.main`` per strategy: 2 tasks of 2 samples, at 8 × 8
    LR (the task sequence patched smaller than the script's 32 × 32)."""
    make = data_lib.make_task_sequence
    monkeypatch.setattr(data_lib, "make_task_sequence",
                        lambda seed, n, s, lr_size: make(seed, n, s, lr_size=8))
    scores = train_continual.main([
        "--device", "cpu", "--strategy", strategy, "--num-tasks", "2", "--epochs-per-task",
        "1", "--samples-per-task", "2", "--batch-size", "2", "--replay-batch", "2"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"final_psnr_per_task": scores}
    assert list(scores) == ["sports", "animation"]
    assert all(np.isfinite(v) and v > 5 for v in scores.values())
