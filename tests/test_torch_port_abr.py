"""The port's ABR pillar (``nerve_tpu_torch.abr``, ``train_abr``) against
the JAX package's, on the CPU.

JAX's threefry draws cannot be made by torch, so the tests replay them: they
redo the key splits of ``JaxStreamingEnv``, ``PPOAgent._act`` and
``PPOAgent.rollout_jax`` with ``jax.random.uniform`` / ``jax.random.gumbel``
and pass the draws through the port's seams (``TorchStreamingEnv.step``'s
uniforms, ``act(..., gumbel_noise=)``, ``rollout(..., draws=)``); that the
replayed actions equal JAX's proves the replay right.

(a) ``StreamingEnv`` (numpy) bit for bit, also through battery truncation
and ``max_steps`` termination. (b) ``TorchStreamingEnv`` ``reset``,
``step`` and ``auto_reset_step`` against ``JaxStreamingEnv`` under ``vmap``
(N = 8, 120 steps with resets) within ``ENV_TOL`` (rtol and atol), flags
equal. (c) ``ActorCritic`` through ``abr_from_flax``: logits and value
within ``NET_TOL``, ``dist_stats`` within ``NET_TOL``, greedy and sampled
actions equal. (d) One PPO update (2 epochs, 64 transitions, hidden 32 ×
32) from the same parameters and a fresh Adam state against JAX's
``_update``: once with an episode end inside the buffer and the clip idle,
once with the clip acting; each parameter's change within
``UPDATE_CHANGE_L2`` in relative L2 (Adam moves a weight by about lr
whatever its gradient's size, so a near-zero gradient's element may move
either way: elementwise comparisons are not stable), the moments within
``MOMENT_L2``, the count equal, the metrics within ``METRIC_REL`` of
max(|JAX's|, 1) (the policy loss is a mean of terms of size ~1 that
normalised advantages make cancel). The GAE
chains the buffer as given, across streams of a t-major flatten. (e) The
vectorised rollout against ``rollout_jax`` (N = 4, T = 10): actions and
``done`` equal, the rest within ``ENV_TOL``. (f) Checkpoints both ways in
the JAX package's npz layout, leaf for leaf. (g) ``python -m
nerve_tpu_torch.train_abr`` on the CPU (sequential and ``--vectorized``),
then ``--mode eval``, against ``experiments/train_abr.py``'s ``evaluate``
on the same checkpoint within 1e-6. (h) Without a card the entry points
raise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments import train_abr as jax_cli
from nerve_tpu import abr as jabr
from nerve_tpu.abr import agent as jagent_mod
from nerve_tpu_torch import train_abr
from nerve_tpu_torch.abr import (
    ABRConfig,
    PPOAgent,
    QualityLevel,
    StreamingEnv,
    TorchStreamingEnv,
    make_env,
)
from nerve_tpu_torch.abr import agent as agent_mod
from nerve_tpu_torch.abr.agent import RolloutDraws, dist_stats, gae, greedy
from nerve_tpu_torch.abr.environment import StepDraws
from nerve_tpu_torch.mlops import DriftDetector
from nerve_tpu_torch.models import abr_from_flax
from nerve_tpu_torch.training import clip_by_global_norm_

torch.set_num_threads(2)

ENV_TOL = 1e-6
NET_TOL = 1e-5
UPDATE_CHANGE_L2 = 1e-4
MOMENT_L2 = 1e-5
METRIC_REL = 1e-5
SMALL = dict(hidden_dims=(32, 32), update_epochs=2, buffer_capacity=64)
F32 = jnp.float32


def _np(x):
    return np.asarray(x)


# --------------------------------------------------------------------------- #
# JAX's draws, replayed
# --------------------------------------------------------------------------- #
def _reset_draws(key):
    """``JaxStreamingEnv.reset``'s draws for one key."""
    k_bw, k_obs = jax.random.split(key)
    return (jax.random.uniform(k_bw, (), F32, 2.0, 15.0),
            jax.random.uniform(k_obs, (), F32, 0.3, 0.8))


def _step_draws(key):
    """``JaxStreamingEnv.step``'s draws for one key."""
    k_bw, k_obs = jax.random.split(key)
    return (jax.random.uniform(k_bw, (), F32, 0.8, 1.2),
            jax.random.uniform(k_obs, (), F32, 0.3, 0.8))


def _auto_reset_draws(key):
    """``auto_reset_step``'s draws for one key, in ``StepDraws`` order."""
    k_step, k_reset = jax.random.split(key)
    return (*_step_draws(k_step), *_reset_draws(k_reset))


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_close(got, want, tol=ENV_TOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _assert_state(tstate, jstate):
    for name, t, j in zip(tstate._fields, tstate, jstate):
        if t.dtype == torch.int32:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
        else:
            _assert_close(t, j, what=name)


# --------------------------------------------------------------------------- #
# (a) the numpy env
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,max_steps,max_enh,expect", [
    (0, 100, 5, "truncated"),   # enhancement up to 4: the battery runs out
    (1, 40, 2, "terminated"),   # enhancement up to 1: max_steps ends it
    (2, 100, 5, "truncated"),
])
def test_streaming_env_bit_equal(seed, max_steps, max_enh, expect):
    rng = np.random.default_rng(100 + seed)
    ours, ref = StreamingEnv(max_steps=max_steps), jabr.StreamingEnv(max_steps=max_steps)
    o1, _ = ours.reset(seed=seed)
    o2, _ = ref.reset(seed=seed)
    np.testing.assert_array_equal(o1, o2)
    seen = {"terminated": 0, "truncated": 0}
    for _ in range(120):
        a = np.array([rng.integers(0, 5), rng.integers(0, max_enh)])
        o1, r1, te1, tr1, i1 = ours.step(a)
        o2, r2, te2, tr2, i2 = ref.step(a)
        assert o1.dtype == o2.dtype == np.float32
        np.testing.assert_array_equal(o1, o2)
        assert (r1, te1, tr1, i1) == (r2, te2, tr2, i2)
        assert ours.total_rebuffer == ref.total_rebuffer
        seen["terminated"] += te1
        seen["truncated"] += tr1
        if te1 or tr1:
            o1, _ = ours.reset()
            o2, _ = ref.reset()
            np.testing.assert_array_equal(o1, o2)
    assert seen[expect] > 0, seen


def test_make_env_and_custom_ladder():
    ladder = [QualityLevel(360, 365), QualityLevel(720, 1500)]
    env = make_env(quality_ladder=ladder)
    assert env.num_qualities == 2
    tenv = TorchStreamingEnv(quality_ladder=ladder, device="cpu")
    assert tenv.action_dims == (2, 5)


# --------------------------------------------------------------------------- #
# (b) the batched env
# --------------------------------------------------------------------------- #
def test_torch_env_against_jax_vmap():
    n, steps = 8, 120
    jenv, tenv = jabr.JaxStreamingEnv(), TorchStreamingEnv(device="cpu")
    reset = jax.jit(jax.vmap(jenv.reset))
    step = jax.jit(jax.vmap(jenv.step))
    auto = jax.jit(jax.vmap(jenv.auto_reset_step))
    reset_draws = jax.jit(jax.vmap(_reset_draws))
    step_draws = jax.jit(jax.vmap(_step_draws))
    auto_draws = jax.jit(jax.vmap(_auto_reset_draws))
    key = jax.random.PRNGKey(0)
    key, k0 = jax.random.split(key)
    keys = jax.random.split(k0, n)
    jstate, jobs = reset(keys)
    tstate, tobs = tenv.reset(*_torch(*reset_draws(keys)))
    _assert_state(tstate, jstate)
    _assert_close(tobs, jobs, what="reset obs")
    rng = np.random.default_rng(0)
    dones = 0
    for t in range(steps):
        key, kt = jax.random.split(key)
        keys = jax.random.split(kt, n)
        actions = rng.integers(0, 5, (n, 2)).astype(np.int32)
        # step alone, on the keys auto_reset_step gives it
        k_step = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
        js, jo, jr, jte, jtr, ji = step(jstate, actions, k_step)
        ts, to, tr, tte, ttr, ti = tenv.step(tstate, torch.from_numpy(actions),
                                             *_torch(*step_draws(k_step)))
        _assert_state(ts, js)
        _assert_close(to, jo, what=f"step {t} obs")
        _assert_close(tr, jr, what=f"step {t} reward")
        np.testing.assert_array_equal(tte.numpy(), _np(jte))
        np.testing.assert_array_equal(ttr.numpy(), _np(jtr))
        for k in ji:
            _assert_close(ti[k], ji[k], what=k)
        # auto_reset_step
        jstate, jobs, jr, jdone, _ = auto(jstate, actions, keys)
        tstate, tobs, tr, tdone, _ = tenv.auto_reset_step(
            tstate, torch.from_numpy(actions), StepDraws(*_torch(*auto_draws(keys))))
        _assert_state(tstate, jstate)
        _assert_close(tobs, jobs, what=f"auto step {t} obs")
        _assert_close(tr, jr, what=f"auto step {t} reward")
        np.testing.assert_array_equal(tdone.numpy(), _np(jdone))
        dones += int(tdone.sum())
    assert dones >= n, dones  # streams ended and restarted


def test_torch_env_draws_from_generator():
    tenv = TorchStreamingEnv(device="cpu")
    g = torch.Generator().manual_seed(0)
    bw, noise = tenv.reset_draws((1000,), g)
    d = tenv.step_draws((3, 1000), g)
    for x, (lo, hi) in ((bw, (2, 15)), (noise, (0.3, 0.8)), (d.bw_factor, (0.8, 1.2)),
                        (d.obs_noise, (0.3, 0.8)), (d.reset_bandwidth, (2, 15))):
        assert x.dtype == torch.float32 and lo <= x.min() and x.max() < hi
    assert d.bw_factor.shape == (3, 1000)


# --------------------------------------------------------------------------- #
# (c) the network, its statistics and its sampling
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_agent():
    return jabr.PPOAgent(config=jabr.ABRConfig(**SMALL), seed=0)


def _flax_tree(params):
    return {"params": jax.tree_util.tree_map(np.asarray, params)}


def _port_agent(params, seed=0, **cfg):
    agent = PPOAgent(config=ABRConfig(**{**SMALL, **cfg}), seed=seed, device="cpu")
    agent.network.load_state_dict(abr_from_flax(_flax_tree(params), device="cpu").state_dict())
    return agent


def test_actor_critic_against_flax(jax_agent):
    rng = np.random.default_rng(1)
    net = jax_agent.network
    port = abr_from_flax(_flax_tree(jax_agent.params), device="cpu")
    assert [n for n, _ in port.named_children()] == ["trunk0", "trunk1", "policy0", "policy1",
                                                    "value"]
    obs = rng.random((16, 7)).astype(np.float32)
    jl, jv = net.apply({"params": jax_agent.params}, obs)
    tl, tv = port(torch.from_numpy(obs))
    for a, b in zip(tl, jl):
        _assert_close(a.detach(), b, NET_TOL, "logits")
    _assert_close(tv.detach(), jv, NET_TOL, "value")
    actions = rng.integers(0, 5, (16, 2)).astype(np.int32)
    jlogp, jent = jagent_mod._dist_stats(jl, actions)
    tlogp, tent = dist_stats(tl, torch.from_numpy(actions))
    _assert_close(tlogp.detach(), jlogp, NET_TOL, "logp")
    _assert_close(tent.detach(), jent, NET_TOL, "entropy")
    np.testing.assert_array_equal(greedy(tl).numpy(), np.stack([np.argmax(_np(x), -1)
                                                               for x in jl], -1))


def test_act_sampling_replays_jax(jax_agent):
    """``PPOAgent._act`` splits its key into one per dimension and draws
    ``categorical(k_i, logits_i)``: the port fed the same Gumbel noise acts
    the same."""
    rng = np.random.default_rng(2)
    port = _port_agent(jax_agent.params)
    n_diff = 0
    for i in range(24):
        obs = rng.random(7).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        acts = []
        for det in (False, True):
            ja, jlogp, jv = jax_agent._act(jax_agent.params, key, jnp.asarray(obs), det)
            noise = [torch.from_numpy(np.array(jax.random.gumbel(k, (d,), F32)))
                     for k, d in zip(jax.random.split(key, 2), (5, 5))]
            ta, tlogp, tv = port.act(torch.from_numpy(obs), det, gumbel_noise=noise)
            np.testing.assert_array_equal(ta.numpy(), _np(ja))
            _assert_close(tlogp, jlogp, NET_TOL, "logp")
            _assert_close(tv, jv, NET_TOL, "value")
            acts.append(ta)
        n_diff += bool((acts[0] != acts[1]).any())
    assert n_diff > 0  # sampling is not greedy


def test_select_action_and_buffer():
    agent = PPOAgent(config=ABRConfig(**{**SMALL, "buffer_capacity": 4}), device="cpu")
    obs = np.random.default_rng(0).random(7).astype(np.float32)
    for _ in range(6):
        a = agent.select_action(obs)
        assert a.shape == (2,) and a.dtype == np.int32 and (0 <= a).all() and (a < 5).all()
        agent.store_transition(1.0, False)
    assert agent.buffer_size == 4  # writes past the capacity are ignored
    np.testing.assert_array_equal(agent.select_action(obs, True), agent.select_action(obs, True))
    metrics = agent.update()
    assert agent.buffer_size == 0 and set(metrics) == set(agent_mod.METRICS)
    assert agent.update() == {}


# --------------------------------------------------------------------------- #
# (d) the PPO update
# --------------------------------------------------------------------------- #
def _batch(jax_agent, rng, reward_scale, done_at):
    """64 transitions with the network's own log-probabilities and values."""
    obs = rng.random((64, 7)).astype(np.float32)
    actions = rng.integers(0, 5, (64, 2)).astype(np.int32)
    logits, value = jax_agent.network.apply({"params": jax_agent.params}, obs)
    logp, _ = jagent_mod._dist_stats(logits, actions)
    done = np.zeros(64, np.float32)
    done[done_at] = 1.0
    return {"obs": obs, "actions": actions,
            "logp": _np(logp) + rng.normal(0, 0.05, 64).astype(np.float32),
            "value": np.array(value), "reward": (rng.normal(0, 1, 64) * reward_scale).astype(np.float32),
            "done": done}


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30))


def _npz(path):
    z = np.load(path)
    return [z[k] for k in sorted(z.files, key=lambda s: int(s.split("_")[1]))]


@pytest.mark.parametrize("case", ["episode_end_clip_idle", "clip_acts"])
def test_update_against_jax(case, tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    max_norm = 100.0 if case == "episode_end_clip_idle" else 0.5
    jagent = jabr.PPOAgent(config=jabr.ABRConfig(**SMALL, max_grad_norm=max_norm), seed=0)
    batch = _batch(jagent, rng, 0.05 if case == "episode_end_clip_idle" else 30.0,
                   [29] if case == "episode_end_clip_idle" else [40, 63])
    port = _port_agent(jagent.params, max_grad_norm=max_norm)
    norms = []

    def clip(grads, max_norm):
        norms.append(float(clip_by_global_norm_(grads, max_norm)))

    monkeypatch.setattr(agent_mod, "clip_by_global_norm_", clip)
    jagent.save(str(tmp_path / "before.npz"))
    jp, jo, jm = jagent._update(jagent.params, jagent.opt_state,
                                {k: jnp.asarray(v) for k, v in batch.items()})
    jagent.params, jagent.opt_state = jp, jo
    tm = agent_mod.ppo_update(port.network, port.adam,
                              {k: torch.from_numpy(v) for k, v in batch.items()}, port.config)
    if case == "episode_end_clip_idle":
        assert max(norms) < max_norm, norms
    else:
        assert min(norms) > 10 * max_norm, norms
    for k in agent_mod.METRICS:
        assert abs(tm[k] - float(jm[k])) <= METRIC_REL * max(abs(float(jm[k])), 1.0), k
    jagent.save(str(tmp_path / "jax.npz"))
    port.save(str(tmp_path / "port.npz"))
    before, want, got = (_npz(tmp_path / f"{n}.npz") for n in ("before", "jax", "port"))
    n = 10
    assert len(want) == len(got) == 3 * n + 1
    for i in range(n):
        assert got[i].shape == want[i].shape
        change = _rel_l2(got[i] - before[i], want[i] - before[i])
        assert change <= UPDATE_CHANGE_L2, (i, change)
    assert got[n].dtype == want[n].dtype == np.int32 and int(got[n]) == int(want[n]) == 2
    for i in range(n + 1, 3 * n + 1):
        assert _rel_l2(got[i], want[i]) <= MOMENT_L2, i


def test_gae_chains_the_buffer_as_given():
    """A (T, N) rollout flattened t-major: the GAE runs one chain over the
    flat buffer (step t of stream n feeds step t of stream n - 1), as the
    JAX package's reverse scan does; not one chain per stream."""
    rng = np.random.default_rng(4)
    t_, n_ = 16, 4
    r, v = rng.normal(size=(2, t_ * n_))
    d = (rng.random(t_ * n_) < 0.1).astype(np.float64)
    want, adv, v_next = np.zeros(t_ * n_), 0.0, 0.0
    for t in reversed(range(t_ * n_)):
        nt = 1.0 - d[t]
        adv = r[t] + 0.99 * v_next * nt - v[t] + 0.99 * 0.95 * nt * adv
        v_next = v[t]
        want[t] = adv
    got = gae(*(torch.from_numpy(x.astype(np.float32)) for x in (r, v, d)), 0.99, 0.95)
    _assert_close(got, want, 1e-5)
    per_stream = torch.stack([gae(*(torch.from_numpy(x.reshape(t_, n_)[:, i].astype(np.float32))
                                    for x in (r, v, d)), 0.99, 0.95) for i in range(n_)], 1)
    assert (per_stream.reshape(-1) - got).abs().max() > 1e-2


# --------------------------------------------------------------------------- #
# (e) the vectorised rollout
# --------------------------------------------------------------------------- #
def _rollout_draws(key, n, t, action_dims):
    """Every draw of ``rollout_jax(env, n, t, key)``, in the port's layout."""
    reset = jax.vmap(_reset_draws)(jax.random.split(key, n))
    gumbel = [[] for _ in action_dims]
    steps = []
    for sk in jax.random.split(key, t):
        ks = jax.random.split(sk, n * (len(action_dims) + 1)).reshape(n, len(action_dims) + 1, 2)
        for i, d in enumerate(action_dims):
            gumbel[i].append(jax.vmap(lambda k, d=d: jax.random.gumbel(k, (d,), F32))(ks[:, i]))
        steps.append(jax.vmap(_auto_reset_draws)(ks[:, -1]))
    steps = [np.stack([_np(s[j]) for s in steps]) for j in range(4)]
    return RolloutDraws(*_torch(*reset), tuple(torch.from_numpy(np.stack([_np(x) for x in g]))
                                              for g in gumbel), StepDraws(*_torch(*steps)))


def test_rollout_against_jax(jax_agent):
    n, t = 4, 10
    key = jax.random.PRNGKey(5)
    jenv = jabr.JaxStreamingEnv(max_steps=4)  # episodes end inside the rollout
    want = jax_agent.rollout_jax(jenv, n, t, key)
    port = _port_agent(jax_agent.params)
    got = port.rollout(TorchStreamingEnv(max_steps=4, device="cpu"), n, t,
                       draws=_rollout_draws(key, n, t, (5, 5)))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if k in ("actions", "done"):
            np.testing.assert_array_equal(got[k].numpy(), _np(want[k]), err_msg=k)
        else:
            _assert_close(got[k], want[k], what=k)
    assert got["done"].sum() > 0


# --------------------------------------------------------------------------- #
# (f) checkpoints both ways
# --------------------------------------------------------------------------- #
def test_checkpoints_both_ways(tmp_path):
    rng = np.random.default_rng(6)
    obs = rng.random((10, 7)).astype(np.float32)
    jagent = jabr.PPOAgent(config=jabr.ABRConfig(**SMALL), seed=0)
    batch = _batch(jagent, rng, 1.0, [30])
    jagent.params, jagent.opt_state, _ = jagent._update(
        jagent.params, jagent.opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
    jagent.save(str(tmp_path / "jax.npz"))
    port = PPOAgent(config=ABRConfig(**SMALL), seed=9, device="cpu")
    port.load(str(tmp_path / "jax.npz"))
    for o in obs:
        np.testing.assert_array_equal(port.select_action(o, True), jagent.select_action(o, True))
    port.save(str(tmp_path / "again.npz"))
    for a, b in zip(_npz(tmp_path / "again.npz"), _npz(tmp_path / "jax.npz"), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the port's own update, then JAX loads it
    port.fill_buffer({k: torch.from_numpy(v) for k, v in batch.items()})
    port.update()
    port.save(str(tmp_path / "port.npz"))
    jagent2 = jabr.PPOAgent(config=jabr.ABRConfig(**SMALL), seed=4)
    jagent2.load(str(tmp_path / "port.npz"))
    for o in obs:
        np.testing.assert_array_equal(jagent2.select_action(o, True), port.select_action(o, True))
    jagent2.save(str(tmp_path / "jax2.npz"))
    for a, b in zip(_npz(tmp_path / "jax2.npz"), _npz(tmp_path / "port.npz"), strict=True):
        np.testing.assert_array_equal(a, b)
    assert int(_npz(tmp_path / "port.npz")[10]) == 2 * SMALL["update_epochs"]


# --------------------------------------------------------------------------- #
# (g) the CLI
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("flags", [["--num-steps", "150"],
                                   ["--vectorized", "--num-envs", "64", "--num-steps", "100"]],
                         ids=["sequential", "vectorized"])
def test_train_abr_cli_against_jax_evaluate(flags, tmp_path, capsys):
    ck = str(tmp_path / "abr.npz")
    out = train_abr.main(["--device", "cpu", "--checkpoint", ck, *flags])
    if "--vectorized" in flags:
        assert out["iters"] == 1 and np.isfinite(out["losses"]).all()
        assert len(out["rollout_ms"]) == len(out["update_ms"]) == 1
    else:
        assert out["episodes"] >= 1
    ev = train_abr.main(["--device", "cpu", "--mode", "eval", "--checkpoint", ck])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ev
    jagent = jabr.PPOAgent(config=jabr.ABRConfig(), seed=42)
    jagent.load(ck)
    want = jax_cli.evaluate(jagent, jax_cli.build_argparser().parse_args(["--checkpoint", ck]))
    assert set(ev) == set(want) == {"mean_return", "mean_vmaf", "mean_rebuffer"}
    for k in want:
        assert abs(ev[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), k


# --------------------------------------------------------------------------- #
# (h) the card is the default
# --------------------------------------------------------------------------- #
def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (PPOAgent, TorchStreamingEnv, DriftDetector,
                 lambda: train_abr.main(["--num-steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
