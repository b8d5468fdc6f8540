"""The ABR pillar and the MLOps drift detector on a device against the CPU,
with their times: ``python -m nerve_tpu_torch.diag.abr``, or on the CPU
``--device cpu --small``.

* ``env_against_cpu``: ``TorchStreamingEnv`` over N streams for T steps
  with auto-resets, the draws and actions made once on the CPU and fed to
  both devices: every step's observations and rewards and the final state
  (max|Δ| of max|CPU| per field), ``done`` equal; ms per step on the device
  (CUDA events around the whole run, median of 3 after 1, the draws
  already there).
* ``update_against_cpu``: one PPO update (``agent.ppo_update``) at
  ``ABRConfig()`` defaults on a batch from a CPU rollout of 16 streams
  flattened t-major, from the same parameters and a fresh Adam state on
  both devices: each parameter's change (relative L2 of the CPU's), the
  moments (relative L2), the count, the four metrics (of max(|CPU|, 1));
  ms per update on the device (median of 5 after 1).
* ``sequential_timing``: the sequential training loop (``StreamingEnv`` in
  numpy, ``select_action`` / ``store_transition``, an update at an
  episode's end once the buffer holds 64) for ``steps`` steps: ms per
  ``select_action`` (host clock; each call ends with its device-to-host
  copy) and per update, and the updates' losses.
* ``drift_against_cpu``: ``DriftDetector("mmd")`` on the device and on the
  CPU with the same seed on an (n, d) reference and window, once unshifted
  and once shifted by 1 in every feature: |Δscore| and the decisions; ms
  per ``detect`` on the device (median of 5 after 1).

TF32 is off on the card (``_common.device_of``). ``env_ok``,
``update_ok`` and ``drift_ok`` hold a result to the limits below. The last
line is one JSON object of every number.
"""

from __future__ import annotations

import json
import math
import statistics
import time
from typing import Dict

import numpy as np
import torch

from nerve_tpu_torch.abr import ABRConfig, PPOAgent, StreamingEnv, TorchStreamingEnv
from nerve_tpu_torch.abr.agent import ppo_update
from nerve_tpu_torch.abr.environment import StepDraws
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.diag.continual import rel_l2
from nerve_tpu_torch.mlops import DriftDetector

CPU = torch.device("cpu")

# The batched env, device vs CPU, max|Δ| of max|CPU| per field: its
# operations (+, −, ×, ÷ by device tensors, min, max, where) round alike
# everywhere, so any difference is a fault; the limit leaves one float32 ulp.
ENV_LIMIT = 1e-6
# One PPO update, device vs CPU: each parameter's change in relative L2 of
# the CPU's change, Adam's moments in relative L2, the metrics of
# max(|CPU|, 1). The two differ by summation order (the 2048-row products
# and means), which Adam carries through 10 epochs; Adam moves a weight by
# about lr whatever its gradient's size, so a weight whose gradient is near
# 0 may move either way. A wrong term moves the change by O(1).
UPDATE_CHANGE_L2 = 1e-2
MOMENT_L2 = 1e-3
METRIC_REL = 1e-4
# The MMD score, device vs CPU, of max(score, 0.05): the distances' sums
# round differently, which also moves near-zero diagonal entries across the
# median heuristic's ``> 0`` mask (the same limit holds the port to JAX on
# the CPU, ``tests/test_torch_port_mlops.py``).
DRIFT_REL = 1e-4


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def env_run(env: TorchStreamingEnv, reset, draws: StepDraws, actions: torch.Tensor):
    """The streams from ``reset`` (bandwidths, noise) through ``actions``
    (T, N, 2) with ``draws`` ((T, N) each): the final state and every
    step's ``obs``, ``reward`` and ``done`` stacked."""
    state, obs = env.reset(*reset)
    out = {"obs": [], "reward": [], "done": []}
    for t in range(actions.shape[0]):
        state, obs, reward, done, _ = env.auto_reset_step(
            state, actions[t], StepDraws(*(d[t] for d in draws)))
        out["obs"].append(obs)
        out["reward"].append(reward)
        out["done"].append(done)
    return state, {k: torch.stack(v) for k, v in out.items()}


def env_against_cpu(dev, n: int = 4096, steps: int = 128, seed: int = 0, reps: int = 3) -> dict:
    g = torch.Generator().manual_seed(seed)
    cpu_env, env = TorchStreamingEnv(device=CPU), TorchStreamingEnv(device=dev)
    reset = cpu_env.reset_draws((n,), g)
    draws = cpu_env.step_draws((steps, n), g)
    actions = torch.stack([torch.randint(0, 5, (steps, n), generator=g) for _ in range(2)],
                          -1).to(torch.int32)
    want_state, want = env_run(cpu_env, reset, draws, actions)
    on = [[t.to(dev) for t in reset], StepDraws(*(d.to(dev) for d in draws)), actions.to(dev)]
    state, got = env_run(env, *on)
    ms = _common.median_ms(lambda: env_run(env, *on), dev, reps)
    errs = {f"state.{k}": _max_rel(a, b) for k, a, b in zip(want_state._fields, state, want_state)}
    errs.update({k: _max_rel(got[k], want[k]) for k in ("obs", "reward")})
    return {"n": n, "steps": steps, "max_rel": errs, "worst": max(errs, key=errs.get),
            "done_equal": bool(torch.equal(got["done"].cpu(), want["done"])),
            "ends": int(want["done"].sum()), "ms_per_step": ms / steps, "device": str(dev)}


def training_batch(cfg: ABRConfig, num_envs: int = 16, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A buffer of ``cfg.buffer_capacity`` transitions: a CPU rollout of
    ``num_envs`` streams by a seeded agent, flattened t-major."""
    agent = PPOAgent(config=cfg, seed=seed + 1, device=CPU)
    traj = agent.rollout(TorchStreamingEnv(device=CPU), num_envs,
                         cfg.buffer_capacity // num_envs, torch.Generator().manual_seed(seed))
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in traj.items()}


def update_against_cpu(dev, cfg: ABRConfig = ABRConfig(), seed: int = 0, reps: int = 5) -> dict:
    batch = training_batch(cfg, seed=seed)
    cpu, card = PPOAgent(config=cfg, seed=seed, device=CPU), PPOAgent(config=cfg, seed=seed,
                                                                      device=dev)
    before = [p.detach().clone() for p in cpu.network.parameters()]
    want = ppo_update(cpu.network, cpu.adam, batch, cfg)
    dev_batch = {k: v.to(dev) for k, v in batch.items()}
    got = ppo_update(card.network, card.adam, dev_batch, cfg)
    names = [n for n, _ in cpu.network.named_parameters()]
    change = {n: rel_l2(c.cpu() - b, w - b) for n, c, w, b in zip(
        names, card.network.parameters(), cpu.network.parameters(), before)}
    moments = {f"{m}.{n}": rel_l2(a, b) for m in ("mu", "nu")
               for n, a, b in zip(names, getattr(card.adam, m), getattr(cpu.adam, m))}
    metrics = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1.0) for k in want}
    count = [int(card.adam.count), int(cpu.adam.count)]
    ms = _common.median_ms(lambda: ppo_update(card.network, card.adam, dev_batch, cfg), dev,
                           reps)
    return {"transitions": int(batch["obs"].shape[0]), "epochs": cfg.update_epochs,
            "hidden": list(cfg.hidden_dims), "change_rel_l2": change,
            "worst_change": max(change.values()), "moments_rel_l2": moments,
            "worst_moment": max(moments.values()),
            "count": count, "metrics": got,
            "metrics_cpu": want, "metrics_rel": metrics, "worst_metric": max(metrics.values()),
            "ms_per_update": ms, "device": str(dev)}


def sequential_timing(dev, steps: int = 256, seed: int = 0) -> dict:
    agent = PPOAgent(seed=seed, device=dev)
    env = StreamingEnv()
    obs, _ = env.reset(seed=seed)
    agent.select_action(obs)  # warm-up
    act_ms, update_ms, losses, episodes = [], [], [], 0
    for _ in range(steps):
        t0 = time.perf_counter()
        action = agent.select_action(obs)
        act_ms.append((time.perf_counter() - t0) * 1e3)
        obs, reward, term, trunc, _ = env.step(action)
        agent.store_transition(reward, term or trunc)
        if term or trunc:
            episodes += 1
            if agent.buffer_size >= 64:
                t0 = time.perf_counter()
                losses.append(agent.update()["loss"])
                update_ms.append((time.perf_counter() - t0) * 1e3)
            obs, _ = env.reset()
    return {"steps": steps, "episodes": episodes, "ms_per_select_action":
            statistics.median(act_ms), "ms_select_action_mean": statistics.fmean(act_ms),
            "ms_select_action_max": max(act_ms), "losses": losses,
            "ms_per_update": update_ms, "device": str(dev)}


def drift_against_cpu(dev, n: int = 1000, d: int = 64, seed: int = 0, reps: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    ref = rng.normal(0, 1, (n, d))
    windows = {"none": rng.normal(0, 1, (n, d)), "strong": rng.normal(0, 1, (n, d)) + 1.0}
    out = {"n": n, "d": d, "device": str(dev)}
    for name, cur in windows.items():
        res = {}
        for key, where in (("cpu", CPU), ("device", dev)):
            det = DriftDetector("mmd", seed=seed, device=where)
            det.set_reference(ref)
            res[key] = det.detect(cur)
        out[name] = {"score": res["device"].score, "score_cpu": res["cpu"].score,
                     "abs_diff": abs(res["device"].score - res["cpu"].score),
                     "drift": res["device"].is_drift, "drift_cpu": res["cpu"].is_drift}
    det = DriftDetector("mmd", seed=seed, device=dev)
    det.set_reference(ref)
    out["ms_per_detect"] = _common.median_ms(lambda: det.detect(windows["strong"]), dev, reps)
    return out


def env_ok(r: dict) -> bool:
    return max(r["max_rel"].values()) <= ENV_LIMIT and r["done_equal"]


def update_ok(r: dict) -> bool:
    return (r["worst_change"] <= UPDATE_CHANGE_L2 and r["worst_moment"] <= MOMENT_L2
            and r["worst_metric"] <= METRIC_REL and r["count"][0] == r["count"][1]
            and all(math.isfinite(v) for v in r["metrics"].values()))


def drift_ok(r: dict) -> bool:
    return all(r[k]["abs_diff"] <= DRIFT_REL * max(r[k]["score_cpu"], 0.05)
               and r[k]["drift"] == r[k]["drift_cpu"] for k in ("none", "strong")) \
        and not r["none"]["drift"] and r["strong"]["drift"]


def main(argv=None) -> dict:
    p = _common.parser(__doc__.splitlines()[0])
    args = p.parse_args(argv)
    dev = _common.device_of(args)
    small = args.small
    cfg = ABRConfig(hidden_dims=(32, 32), update_epochs=2, buffer_capacity=256) if small \
        else ABRConfig()
    result = {"env": env_against_cpu(dev, *((64, 16) if small else (4096, 128)), reps=args.reps),
              "update": update_against_cpu(dev, cfg, reps=args.reps),
              "sequential": sequential_timing(dev, 64 if small else 256),
              "drift": drift_against_cpu(dev, *((200, 8) if small else (1000, 64)),
                                         reps=args.reps)}
    result["ok"] = {"env": env_ok(result["env"]), "update": update_ok(result["update"]),
                    "drift": drift_ok(result["drift"])}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
