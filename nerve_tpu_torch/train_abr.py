"""PPO training of the ABR streaming agent.

Counterpart of ``experiments/train_abr.py``, with its flags and defaults
(and ``--device``)::

    python -m nerve_tpu_torch.train_abr                      # sequential, 5000 steps
    python -m nerve_tpu_torch.train_abr --vectorized         # 16 streams on the card
    python -m nerve_tpu_torch.train_abr --mode eval          # 10 greedy episodes
    python -m nerve_tpu_torch.train_abr --device cpu --num-steps 200

Sequential: one ``StreamingEnv`` (numpy) stepped by ``select_action``
(one host-to-device and one device-to-host copy a step), an update at each
episode's end once the buffer holds at least 64 transitions. Vectorised:
each iteration one rollout of ``--num-envs`` streams of
``TorchStreamingEnv`` for ``buffer_capacity // num_envs`` steps on the
device, flattened t-major (step t of stream n, then of stream n + 1) into
the buffer, then one PPO update; the lines print each iteration's rollout
and update time (host clock to a synchronise) beside its metrics. Training
saves the agent to ``--checkpoint`` in the JAX package's npz layout and
prints a JSON line; ``--mode eval`` loads it and prints ``{"mean_return",
"mean_vmaf", "mean_rebuffer"}`` over 10 greedy episodes at seeds ``seed +
ep``. It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from nerve_tpu_torch.abr import ABRConfig, PPOAgent, StreamingEnv, TorchStreamingEnv


def build_argparser():
    p = argparse.ArgumentParser(description="nerve_tpu_torch ABR PPO training")
    p.add_argument("--mode", choices=["train", "eval"], default="train")
    p.add_argument("--num-steps", type=int, default=5000)
    p.add_argument("--vectorized", action="store_true")
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--checkpoint", default="checkpoints/abr_ppo.npz")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def train_sequential(agent: PPOAgent, args) -> dict:
    env = StreamingEnv()
    obs, _ = env.reset(seed=args.seed)
    episode_reward, episode_rewards = 0.0, []
    for step in range(args.num_steps):
        action = agent.select_action(obs)
        obs, reward, term, trunc, info = env.step(action)
        agent.store_transition(reward, term or trunc)
        episode_reward += reward
        if term or trunc:
            episode_rewards.append(episode_reward)
            episode_reward = 0.0
            if agent.buffer_size >= 64:
                metrics = agent.update()
                print(
                    f"step {step}: episodes={len(episode_rewards)} "
                    f"mean_return={np.mean(episode_rewards[-10:]):.2f} "
                    f"loss={metrics.get('loss', float('nan')):.4f}"
                )
            obs, _ = env.reset()
    return {"episodes": len(episode_rewards),
            "mean_return_last10": float(np.mean(episode_rewards[-10:]))}


def train_vectorized(agent: PPOAgent, args) -> dict:
    """N streams on the device; each iteration one rollout, then one PPO
    update over it. Besides the JAX script's keys the result holds each
    iteration's ``losses``, ``rollout_ms`` and ``update_ms``."""
    env = TorchStreamingEnv(device=agent.device)
    generator = torch.Generator(device=agent.device).manual_seed(args.seed)
    steps_per_iter = agent.config.buffer_capacity // args.num_envs
    iters = max(1, args.num_steps // (steps_per_iter * args.num_envs))
    mean_reward = float("nan")
    losses, rollout_ms, update_ms = [], [], []
    for it in range(iters):
        t0 = time.perf_counter()
        traj = agent.rollout(env, args.num_envs, steps_per_iter, generator)
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in traj.items()}
        mean_reward = float(flat["reward"].mean())
        t1 = time.perf_counter()
        agent.fill_buffer(flat)
        metrics = agent.update()
        t2 = time.perf_counter()
        losses.append(metrics["loss"])
        rollout_ms.append((t1 - t0) * 1e3)
        update_ms.append((t2 - t1) * 1e3)
        print(f"iter {it}: mean_step_reward={mean_reward:.3f} "
              f"loss={metrics['loss']:.4f} entropy={metrics['entropy']:.3f} "
              f"rollout_ms={rollout_ms[-1]:.1f} update_ms={update_ms[-1]:.1f}")
    return {"iters": iters, "mean_step_reward": mean_reward, "losses": losses,
            "rollout_ms": rollout_ms, "update_ms": update_ms}


def evaluate(agent: PPOAgent, args, episodes: int = 10) -> dict:
    env = StreamingEnv()
    returns, vmafs, rebuffers = [], [], []
    for ep in range(episodes):
        obs, _ = env.reset(seed=args.seed + ep)
        total, done = 0.0, False
        while not done:
            action = agent.select_action(obs, deterministic=True)
            obs, reward, term, trunc, info = env.step(action)
            total += reward
            vmafs.append(info["vmaf"])
            done = term or trunc
        rebuffers.append(env.total_rebuffer)
        returns.append(total)
    out = {
        "mean_return": float(np.mean(returns)),
        "mean_vmaf": float(np.mean(vmafs)),
        "mean_rebuffer": float(np.mean(rebuffers)),
    }
    print(json.dumps(out))
    return out


def main(argv=None):
    args = build_argparser().parse_args(argv)
    agent = PPOAgent(config=ABRConfig(), seed=args.seed, device=args.device)
    if args.mode == "train":
        out = (train_vectorized if args.vectorized else train_sequential)(agent, args)
        os.makedirs(os.path.dirname(args.checkpoint) or ".", exist_ok=True)
        agent.save(args.checkpoint)
        print(json.dumps(out))
        return out
    try:
        agent.load(args.checkpoint)
    except FileNotFoundError:
        print("no checkpoint found; evaluating untrained agent")
    return evaluate(agent, args)


if __name__ == "__main__":
    main()
