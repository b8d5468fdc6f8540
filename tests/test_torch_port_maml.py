"""The port's meta-learners against the JAX package's, on the CPU.

(1) Over the small model of the four kernel ops
(``test_torch_port_continual.mini_loss``: conv chains, the correlation, the
warp, an RDB; the same parameter dict on both sides), 2 tasks × 1 inner
step: one second-order ``MAML.train_step`` and one first-order (``FOMAML``)
against ``nerve_tpu.continual.MAML``'s jitted step — the mean query loss,
the meta-gradient (JAX's recorded by an identity transformation chained
before Adam) and the parameters after Adam — one ``Reptile.train_step``
(2 inner steps) and one ``ContentAdaptiveMAML.meta_update_content_lr``
(the loss and the log-rate's gradient through the inner step), within
1e-4 of max|ref| per tensor. The second-order meta-gradient differs from the first-order one:
the second derivatives through the kernel ops are not dropped.

(2) The small flagship (8 features, 1 RDB, window 1, 8 × 8 LR, seeded):
a second-order MAML meta-gradient through its eval forward under autograd,
the kernel ops as autograd Functions, against the same with the four ops
replaced by their plain versions (plain autograd end to end), within 1e-4.
JAX is not asked here: XLA's CPU compile of the flagship's second
derivative takes minutes (the CBAM's 7 × 7 spatial attention is 49
unrolled shifted slices), so the second derivative is held against JAX op
by op (``tests/test_torch_port_continual.py``) and through the small model
above.
"""

import numpy as np
import optax
import pytest
import torch

import jax

from nerve_tpu import continual as jcontinual
from nerve_tpu_torch import continual, ops, train_continual
from nerve_tpu_torch.models import SuperResolutionNet, flax_variables, load_flax_variables
from nerve_tpu_torch.ops import conv_chain, correlation, rdb, warp
from test_torch_port_continual import (  # noqa: F401 (few_threads: the autouse fixture)
    _jit,
    assert_dicts,
    few_threads,
    mini_batch,
    mini_loss,
    mini_loss_jax,
    mini_params,
    to_torch,
)
from test_torch_port_models import randomize
from test_torch_port_training import _assert_rel, _record_grads

STEP_REL = 1e-4
INNER_LR, OUTER_LR = 0.05, 1e-5  # Adam's first step is ±lr where |g| ≫ eps



def _tasks(seed, n_tasks=2):
    """(support, query): (lr, hr) stacked over a leading task axis."""
    def stack(k):
        batches = [mini_batch(seed + 2 * t + k) for t in range(n_tasks)]
        return tuple(np.stack([b[i] for b in batches]) for i in range(2))

    return stack(0), stack(1)


@pytest.fixture(scope="module")
def maml_ref():
    """JAX's MAML step, second and first order, Reptile's step and the
    content-rate update (the body of ``meta_update_content_lr``, whose
    ``float`` of the loss stops it from being compiled whole): one compiled
    program."""
    p = mini_params(0)
    support, query = _tasks(20)
    makers = {}
    for first_order in (False, True):
        m = jcontinual.MAML(mini_loss_jax, p, inner_lr=INNER_LR, outer_lr=OUTER_LR,
                            inner_steps=1, first_order=first_order)
        m.tx = optax.chain(_record_grads(), optax.adam(OUTER_LR))
        m.opt_state = m.tx.init(p)
        makers["first_order" if first_order else "second_order"] = m
    rep = jcontinual.Reptile(mini_loss_jax, p, inner_lr=INNER_LR, outer_lr=0.3, inner_steps=2)
    caml = jcontinual.ContentAdaptiveMAML(mini_loss_jax, p, inner_lr=INNER_LR, outer_lr=1.0,
                                          inner_steps=1)

    def run(p, support, query):
        out = {}
        for name, m in makers.items():
            new, opt_state, loss = m._meta_step(p, m.opt_state, support, query)
            out[name] = (loss, opt_state[0], new)
        out["reptile"] = rep._reptile_step(p, support)
        first = [tuple(a[0] for a in b) for b in (support, query)]
        out["content_lr"] = jax.value_and_grad(
            lambda ll: caml.loss_fn(caml._adapt_with_lr(p, first[0], ll), first[1]))(
                caml.log_inner_lrs["news"])
        return out

    return p, support, query, _jit(run)(p, support, query)


@pytest.mark.parametrize("first_order", [False, True], ids=["second_order", "first_order"])
def test_maml_step_matches_jax(maml_ref, first_order):
    p, support, query, ref = maml_ref
    jloss, jgrads, jparams = ref["first_order" if first_order else "second_order"]
    cls = continual.FOMAML if first_order else continual.MAML
    kw = {} if first_order else {"first_order": False}
    meta = cls(mini_loss, to_torch(p), inner_lr=INNER_LR, outer_lr=OUTER_LR, inner_steps=1,
               **kw)
    loss = meta.train_step(to_torch(support), to_torch(query))
    assert abs(loss - float(jloss)) <= STEP_REL * abs(float(jloss))
    assert_dicts({k: v.grad for k, v in meta.params.items()}, jgrads, STEP_REL, "meta-gradient")
    assert_dicts(meta.params, jparams, STEP_REL, "parameters after the step")
    if not first_order:
        # The inner step's second derivatives move the meta-gradient.
        _l, fo_grads, _p = ref["first_order"]
        diff = sum(float(np.sum((np.asarray(jgrads[k]) - np.asarray(fo_grads[k])) ** 2))
                   for k in p)
        norm = sum(float(np.sum(np.asarray(jgrads[k]) ** 2)) for k in p)
        assert diff > 1e-4 * norm
    adapted = meta.adapt(tuple(t[0] for t in to_torch(support)))
    assert set(adapted) == set(p) and not any(v.requires_grad for v in adapted.values())
    again = cls(mini_loss, to_torch(p), inner_lr=INNER_LR, outer_lr=OUTER_LR, inner_steps=1,
                **kw)
    again.load_state_dict(meta.state_dict())
    assert all(torch.equal(again.params[k], meta.params[k]) for k in p)


def test_reptile_step_matches_jax(maml_ref):
    p, support, _query, ref = maml_ref
    meta = continual.Reptile(mini_loss, to_torch(p), inner_lr=INNER_LR, outer_lr=0.3,
                             inner_steps=2)
    meta.train_step(to_torch(support))
    assert_dicts(meta.params, ref["reptile"], STEP_REL, "parameters after the step")
    moved = sum(float((meta.params[k] - torch.from_numpy(p[k])).abs().sum()) for k in p)
    assert moved > 0


def test_content_lr_update_matches_jax(maml_ref):
    """``meta_update_content_lr`` at outer rate 1 on the first task: the
    loss, and the change of the log-rate (minus its gradient through the
    inner step)."""
    p, support, query, ref = maml_ref
    jl, jg = ref["content_lr"]
    port = continual.ContentAdaptiveMAML(mini_loss, to_torch(p), inner_lr=INNER_LR,
                                         outer_lr=1.0, inner_steps=1)
    log0 = port.log_inner_lrs["news"].clone()
    first = [tuple(t[0] for t in to_torch(b)) for b in (support, query)]
    loss = port.meta_update_content_lr("news", *first)
    step = float(port.log_inner_lrs["news"] - log0)
    assert abs(loss - float(jl)) <= STEP_REL * abs(float(jl))
    assert abs(step + float(jg)) <= STEP_REL * abs(float(jg)) and step != 0
    assert torch.equal(port.log_inner_lrs["sports"], log0)
    assert set(port.adapt_to_content(first[0], "news")) == set(p)


# --------------------------------------------------------------------------- #
# (2) Second-order MAML through the flagship
# --------------------------------------------------------------------------- #

SR_CFG = dict(scale_factor=2, num_features=8, num_residual_blocks=1, temporal_window=1)
PLAIN = {"conv_chain_apply": conv_chain.conv_chain_plain,
         "rdb_chain_apply": rdb.rdb_chain_plain,
         "correlation_volume": lambda a, b, d=4, planar=None: correlation.correlation_plain(
             a, b, d),
         "flow_warp": warp._warp}


def _sr_meta_grads(model, support, query, monkeypatch=None):
    if monkeypatch is not None:
        for name, fn in PLAIN.items():
            monkeypatch.setattr(ops, name, fn)
    meta = continual.MAML(train_continual.sr_loss(model, 3), dict(model.named_parameters()),
                          inner_lr=0.5, outer_lr=1e-5, inner_steps=1)
    loss = meta.train_step(support, query)
    return loss, {k: v.grad for k, v in meta.params.items()}


def test_second_order_maml_through_the_flagship(monkeypatch):
    variables = randomize(flax_variables(SuperResolutionNet(**SR_CFG, device="cpu")), seed=8)
    model = load_flax_variables(SuperResolutionNet(**SR_CFG, device="cpu"), variables).eval()
    rng = np.random.default_rng(31)
    support = (torch.from_numpy(rng.random((2, 2, 8, 8, 3), np.float32)),
               torch.from_numpy(rng.random((2, 2, 16, 16, 3), np.float32)))
    query = (torch.from_numpy(rng.random((2, 2, 8, 8, 3), np.float32)),
             torch.from_numpy(rng.random((2, 2, 16, 16, 3), np.float32)))
    loss, grads = _sr_meta_grads(model, support, query)
    with monkeypatch.context() as mp:
        ploss, pgrads = _sr_meta_grads(model, support, query, mp)
    assert abs(loss - ploss) <= 1e-6 * abs(ploss)
    for k, g in pgrads.items():
        assert g.abs().max() > 0, k
        _assert_rel(grads[k], g.numpy(), STEP_REL, f"meta-gradient {k}")
