"""PPO agent for adaptive bitrate control (counterpart of
``nerve_tpu/abr/agent.py``).

  * :class:`ActorCritic`: a tanh MLP trunk, one categorical head per
    action dimension (quality, enhancement) and a scalar value head;
    log-probabilities and entropies summed across the dimensions
    (:func:`dist_stats`). Its submodules carry the flax names (``trunk0``,
    ``policy0``, ``value``, …); ``models.bridge.abr_from_flax`` loads the
    JAX package's parameters.
  * :func:`ppo_update`: GAE(γ, λ) with a zero bootstrap over the batch in
    the order it is given (one chain: an episode ends only where ``done``
    says so), advantages normalised by their population std, then
    ``update_epochs`` full-batch epochs of the clipped surrogate plus the
    value MSE minus the entropy bonus, each one backward, one global-norm
    clip (``optax.clip_by_global_norm``) and one Adam step
    (``optax.adam``: :func:`adam_step_`).
  * :class:`PPOAgent`: the host API (``select_action``,
    ``store_transition`` into a preallocated buffer, ``update``), the
    vectorised rollout of N streams of :class:`TorchStreamingEnv` on the
    device (:meth:`PPOAgent.rollout`), and checkpoints in the JAX package's
    npz layout.

Sampling is Gumbel-max, ``argmax(logits + g)``, as ``jax.random.categorical``
draws; the noise ``g`` comes from the agent's ``torch.Generator`` or from
the caller (``act(..., gumbel_noise=)``, ``rollout(..., draws=)``), which is how a
test replays another source's draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from nerve_tpu_torch.abr.environment import StepDraws, TorchStreamingEnv
from nerve_tpu_torch.models.super_resolution import resolve_device
from nerve_tpu_torch.training import clip_by_global_norm_

# The standard deviation of a unit normal truncated to [-2, 2]: flax's
# ``lecun_normal`` divides its scale by it.
TRUNC_STD = 0.87962566103423978
METRICS = ("loss", "policy_loss", "value_loss", "entropy")


@dataclasses.dataclass(frozen=True)
class ABRConfig:
    hidden_dims: Tuple[int, ...] = (256, 256)
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_ratio: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    update_epochs: int = 10
    max_grad_norm: float = 0.5
    buffer_capacity: int = 2048


def _dense(in_features: int, out_features: int, g: torch.Generator, device) -> nn.Linear:
    """An ``nn.Linear`` initialised as flax's ``nn.Dense``: ``lecun_normal``
    (a normal of variance 1/fan_in truncated at ±2 std) and zero bias,
    drawn on the CPU from ``g``."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features)
    std = math.sqrt(1.0 / in_features) / TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
        lin.bias.zero_()
    return lin.to(device)


class ActorCritic(nn.Module):
    """Shared trunk → per-dimension categorical policy heads + value head."""

    def __init__(self, action_dims: Sequence[int] = (5, 5),
                 hidden_dims: Sequence[int] = (256, 256), obs_dim: int = 7, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.action_dims = tuple(action_dims)
        self.hidden_dims = tuple(hidden_dims)
        width = obs_dim
        for i, h in enumerate(self.hidden_dims):
            setattr(self, f"trunk{i}", _dense(width, h, g, dev))
            width = h
        for i, d in enumerate(self.action_dims):
            setattr(self, f"policy{i}", _dense(width, d, g, dev))
        self.value = _dense(width, 1, g, dev)

    def forward(self, obs: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        x = obs
        for i in range(len(self.hidden_dims)):
            x = torch.tanh(getattr(self, f"trunk{i}")(x))
        logits = [getattr(self, f"policy{i}")(x) for i in range(len(self.action_dims))]
        return logits, self.value(x)[..., 0]


def dist_stats(logits: Sequence[torch.Tensor], actions: torch.Tensor):
    """Sum over the action dimensions of the log-probabilities of
    ``actions`` and of the entropies."""
    logp = torch.zeros(actions.shape[:-1], device=actions.device)
    entropy = torch.zeros(actions.shape[:-1], device=actions.device)
    for i, lg in enumerate(logits):
        log_probs = torch.log_softmax(lg, dim=-1)
        logp = logp + torch.gather(log_probs, -1, actions[..., i:i + 1].long())[..., 0]
        probs = torch.exp(log_probs)
        entropy = entropy - torch.sum(probs * log_probs, dim=-1)
    return logp, entropy


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample(logits: Sequence[torch.Tensor], noise: Sequence[torch.Tensor]) -> torch.Tensor:
    """Gumbel-max: one int32 action per dimension, ``argmax(logits + g)``."""
    return torch.stack([torch.argmax(lg + g, dim=-1) for lg, g in zip(logits, noise)],
                       dim=-1).to(torch.int32)


def greedy(logits: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.argmax(lg, dim=-1) for lg in logits], dim=-1).to(torch.int32)


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor, gamma: float,
        lam: float) -> torch.Tensor:
    """Generalised advantage estimates with a zero bootstrap value over the
    batch as given: ``adv_t = δ_t + γλ(1 − d_t)·adv_{t+1}``, ``δ_t = r_t +
    γ·v_{t+1}(1 − d_t) − v_t``, ``adv`` and ``v`` zero past the end. The
    reverse recurrence is evaluated by doubling (log2 n rounds of
    composing each step's affine map with the one s steps later), which
    gives the same chain as a sequential reverse pass up to float32
    rounding."""
    nonterminal = 1.0 - dones
    v_next = torch.cat([values[1:], values.new_zeros(1)])
    x = rewards + gamma * v_next * nonterminal - values
    a = gamma * lam * nonterminal
    n, s = x.shape[0], 1
    while s < n:
        x = torch.cat([x[:-s] + a[:-s] * x[s:], x[-s:]])
        a = torch.cat([a[:-s] * a[s:], a[-s:]])
        s *= 2
    return x


@dataclasses.dataclass
class AdamState:
    """``optax.adam``'s state: the update count (int32) and the first and
    second moments, one per parameter in ``named_parameters`` order."""

    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]

    @classmethod
    def zeros(cls, params: Sequence[torch.Tensor]) -> "AdamState":
        params = list(params)
        return cls(torch.zeros((), dtype=torch.int32, device=params[0].device),
                   [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])


@torch.no_grad()
def adam_step_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: AdamState,
               lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One ``optax.adam(lr, b1, b2, eps, eps_root=0)`` update in place, in
    optax's order of operations: moments ``(1 − b)·g^k + b·m``, bias
    corrections ``1 − b^count`` in float32, ``p + (−lr)·m̂ / (√v̂ + eps)``."""
    params, grads = list(params), list(grads)
    torch._foreach_mul_(state.mu, b1)
    torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
    g2 = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(g2, 1 - b2)
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_add_(state.nu, g2)
    state.count.add_(1)
    count = state.count.float()
    one = torch.ones((), device=count.device)
    bc1 = 1 - torch.pow(one * b1, count)
    bc2 = 1 - torch.pow(one * b2, count)
    den = torch._foreach_sqrt(torch._foreach_div(state.nu, bc2))
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(torch._foreach_div(state.mu, bc1), den)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)


def ppo_update(network: ActorCritic, adam: AdamState, batch: Dict[str, torch.Tensor],
               cfg: ABRConfig) -> Dict[str, float]:
    """The PPO update over ``batch`` (``obs``, ``actions``, ``logp``,
    ``value``, ``reward``, ``done`` along one leading axis), in place on
    ``network`` and ``adam``. Returns the last epoch's metrics (one host
    synchronise)."""
    values = batch["value"]
    advantages = gae(batch["reward"], values, batch["done"], cfg.gamma, cfg.gae_lambda)
    returns = advantages + values
    advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
    obs, actions, old_logp = batch["obs"], batch["actions"], batch["logp"]
    params = list(network.parameters())
    last = None
    for _ in range(cfg.update_epochs):
        logits, value = network(obs)
        logp, entropy = dist_stats(logits, actions)
        ratio = torch.exp(logp - old_logp)
        clipped = torch.clamp(ratio, 1 - cfg.clip_ratio, 1 + cfg.clip_ratio)
        policy_loss = -torch.mean(torch.minimum(ratio * advantages, clipped * advantages))
        value_loss = torch.mean((value - returns) ** 2)
        ent = torch.mean(entropy)
        total = policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * ent
        grads = torch.autograd.grad(total, params)
        clip_by_global_norm_(grads, cfg.max_grad_norm)
        adam_step_(params, grads, adam, cfg.learning_rate)
        last = torch.stack([total, policy_loss, value_loss, ent]).detach()
    return dict(zip(METRICS, last.tolist()))


class RolloutDraws(NamedTuple):
    """Every draw of a rollout of T steps over N streams: the streams'
    first bandwidths and observation noise (N,), the Gumbel noise of each
    action dimension (T, N, A_i), and the env's step draws ((T, N) each)."""

    reset_bandwidth: torch.Tensor
    reset_noise: torch.Tensor
    gumbel: Tuple[torch.Tensor, ...]
    steps: StepDraws


class PPOAgent:
    """PPO over MultiDiscrete actions on ``device`` (the card unless
    ``device="cpu"``)."""

    def __init__(
        self,
        obs_dim: int = 7,
        action_dims: Tuple[int, ...] = (5, 5),
        config: Optional[ABRConfig] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or ABRConfig()
        self.obs_dim = obs_dim
        self.action_dims = tuple(action_dims)
        self.network = ActorCritic(self.action_dims, self.config.hidden_dims, obs_dim,
                                   seed=seed, device=self.device)
        self.adam = AdamState.zeros(self.network.parameters())
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

        cap = self.config.buffer_capacity
        self._buf = {
            "obs": np.zeros((cap, obs_dim), np.float32),
            "actions": np.zeros((cap, len(action_dims)), np.int32),
            "logp": np.zeros((cap,), np.float32),
            "value": np.zeros((cap,), np.float32),
            "reward": np.zeros((cap,), np.float32),
            "done": np.zeros((cap,), np.float32),
        }
        self._size = 0
        self._rollout: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------------ #
    # Acting / experience
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def act(self, obs: torch.Tensor, deterministic: bool = False,
            gumbel_noise: Optional[Sequence[torch.Tensor]] = None):
        """(action (A,) int32, logp, value) for one observation (7,): greedy,
        or sampled with ``gumbel_noise`` (one (A_i,) tensor per dimension,
        drawn from the agent's generator when not given)."""
        logits, value = self.network(obs[None])
        logits = [lg[0] for lg in logits]
        if deterministic:
            action = greedy(logits)
        else:
            if gumbel_noise is None:
                gumbel_noise = [gumbel((d,), self.generator, self.device)
                                for d in self.action_dims]
            action = sample(logits, [g.to(self.device) for g in gumbel_noise])
        logp, _ = dist_stats(logits, action)
        return action, logp, value[0]

    def select_action(self, obs: np.ndarray, deterministic: bool = False) -> np.ndarray:
        """Sample (or argmax) an action; keeps its transition pending when
        stochastic. One host-to-device and one device-to-host copy."""
        obs = np.asarray(obs, np.float32)
        action, logp, value = self.act(torch.from_numpy(obs).to(self.device), deterministic)
        out = torch.cat([action.float(), logp[None], value[None]]).cpu().numpy()
        k = len(self.action_dims)
        action = out[:k].astype(np.int32)
        if not deterministic:
            self._pending = (obs, action, float(out[k]), float(out[k + 1]))
        return action

    def store_transition(self, reward: float, done: bool) -> None:
        """Append the last stochastic action's transition; a full buffer
        ignores it."""
        if self._size >= self.config.buffer_capacity:
            return
        obs, action, logp, value = self._pending
        i = self._size
        self._buf["obs"][i] = obs
        self._buf["actions"][i] = action
        self._buf["logp"][i] = logp
        self._buf["value"][i] = value
        self._buf["reward"][i] = reward
        self._buf["done"][i] = float(done)
        self._size += 1

    def fill_buffer(self, batch: Dict[str, torch.Tensor]) -> None:
        """Make ``batch`` (a flattened rollout, tensors left where they are)
        the buffer's content; the next ``update`` runs over it."""
        self._rollout = batch
        self._size = int(batch["obs"].shape[0])

    @property
    def buffer_size(self) -> int:
        return self._size

    def update(self) -> Dict[str, float]:
        """Run the PPO update over the buffer, then clear it."""
        if self._size == 0:
            return {}
        if self._rollout is not None:
            batch = {k: v.to(self.device) for k, v in self._rollout.items()}
        else:
            batch = {k: torch.from_numpy(v[: self._size]).to(self.device)
                     for k, v in self._buf.items()}
        metrics = ppo_update(self.network, self.adam, batch, self.config)
        self._size = 0
        self._rollout = None
        return metrics

    # ------------------------------------------------------------------ #
    # Vectorised rollout on the device
    # ------------------------------------------------------------------ #
    def rollout_draws(self, env: TorchStreamingEnv, num_envs: int, num_steps: int,
                      generator: torch.Generator) -> RolloutDraws:
        """Every draw of a rollout, made at once from ``generator``."""
        bw, noise = env.reset_draws((num_envs,), generator)
        g = tuple(gumbel((num_steps, num_envs, d), generator, env.device)
                  for d in self.action_dims)
        return RolloutDraws(bw, noise, g, env.step_draws((num_steps, num_envs), generator))

    @torch.no_grad()
    def rollout(self, env: TorchStreamingEnv, num_envs: int, num_steps: int,
                generator: Optional[torch.Generator] = None,
                draws: Optional[RolloutDraws] = None) -> Dict[str, torch.Tensor]:
        """Collect (num_steps, num_envs) experience with the current policy:
        N fresh streams, then each step the policy's sampled actions and
        ``env.auto_reset_step``. The draws come from ``generator`` (on the
        env's device; the agent's own by default) or are given. Returns ``obs``, ``actions``, ``logp``,
        ``value``, ``reward`` and ``done`` (float32) shaped (T, N, ...), on
        the env's device."""
        if draws is None:
            draws = self.rollout_draws(env, num_envs, num_steps, generator or self.generator)
        state, obs = env.reset(draws.reset_bandwidth, draws.reset_noise)
        out = {k: [] for k in ("obs", "actions", "logp", "value", "reward", "done")}
        for t in range(num_steps):
            logits, values = self.network(obs)
            actions = sample(logits, [g[t].to(env.device) for g in draws.gumbel])
            logp, _ = dist_stats(logits, actions)
            step = StepDraws(*(d[t] for d in draws.steps))
            new_state, new_obs, rewards, dones, _ = env.auto_reset_step(state, actions, step)
            for k, v in (("obs", obs), ("actions", actions), ("logp", logp),
                         ("value", values), ("reward", rewards), ("done", dones.float())):
                out[k].append(v)
            state, obs = new_state, new_obs
        return {k: torch.stack(v) for k, v in out.items()}

    # ------------------------------------------------------------------ #
    # Checkpoints in the JAX package's npz layout
    # ------------------------------------------------------------------ #
    def _flax_order(self) -> List[Tuple[int, bool]]:
        """(index into ``named_parameters``, is a weight) in the order of
        ``jax.tree_util.tree_leaves`` of the flax params: modules by sorted
        name, bias before kernel."""
        index = {n: i for i, (n, _) in enumerate(self.network.named_parameters())}
        mods = sorted(n for n, _ in self.network.named_children())
        return [(index[f"{m}.{leaf}"], leaf == "weight") for m in mods
                for leaf in ("bias", "weight")]

    def save(self, path: str) -> None:
        """``arr_0, arr_1, …``: the parameters (kernels (in, out)), then
        Adam's count, first and second moments, each set in the flax order."""
        order = self._flax_order()
        params = list(self.network.parameters())

        def flax_leaves(tensors):
            return [(tensors[i].T if w else tensors[i]).detach().cpu().numpy()
                    for i, w in order]

        leaves = (flax_leaves(params) + [self.adam.count.cpu().numpy()]
                  + flax_leaves(self.adam.mu) + flax_leaves(self.adam.nu))
        np.savez(path, *leaves)

    @torch.no_grad()
    def load(self, path: str) -> None:
        z = np.load(path)
        arrays = [z[k] for k in sorted(z.files, key=lambda s: int(s.split("_")[1]))]
        order = self._flax_order()
        n = len(order)
        if len(arrays) != 3 * n + 1:
            raise ValueError(f"{path}: {len(arrays)} arrays, the agent has {3 * n + 1} leaves")
        params = list(self.network.parameters())

        def put(tensors, leaves):
            for (i, w), a in zip(order, leaves):
                t = torch.as_tensor(np.asarray(a, np.float32))
                t = t.T if w else t
                if tuple(t.shape) != tuple(tensors[i].shape):
                    raise ValueError(f"{path}: shape {tuple(a.shape)} for a parameter of "
                                     f"shape {tuple(tensors[i].shape)}")
                tensors[i].copy_(t)

        put(params, arrays[:n])
        self.adam.count.fill_(int(arrays[n]))
        put(self.adam.mu, arrays[n + 1:2 * n + 1])
        put(self.adam.nu, arrays[2 * n + 1:])
