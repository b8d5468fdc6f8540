"""Video-streaming simulator for ABR decision making (counterpart of
``nerve_tpu/abr/environment.py``).

The dynamics, one 4-second segment a step:

  * obs (7,): [buffer/30, min(bw/20,1), battery, last_q/num_q, vmaf/100,
    content complexity ~ U(0.3,0.8) drawn fresh per observation, progress].
  * action MultiDiscrete([num_qualities, 5 enhancement levels]).
  * step: download_time = bitrate·4s / (bw·1000); rebuffer = max(0, −buffer);
    buffer ← min(max(buffer,0)+4, 30); VMAF = 50 + idx/num_q·40 + enh·10
    (cap 100); battery −= 0.01 + 0.02·enh; reward = vmaf/100 − 10·rebuffer −
    0.1·|Δq| + 0.1·battery; bandwidth ← clip(bw·U(0.8,1.2), 0.5, 50);
    terminated at max_steps, truncated at battery 0.

Two implementations:

  * :class:`StreamingEnv`: the Gymnasium-API numpy env, one stream, in
    float64 (a subclass of ``gymnasium.Env`` where gymnasium is installed;
    nothing here needs it).
  * :class:`TorchStreamingEnv`: N streams at once as (N,) float32 / int32
    tensors on one device. Its ``reset``, ``step`` and ``auto_reset_step``
    are pure: state and the step's uniform draws in, state out. The draws
    come from ``reset_draws`` / ``step_draws`` on an explicit
    ``torch.Generator``, or from a caller that replays another source's
    draws; they are the only randomness the env sees.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerve_tpu_torch.models.super_resolution import resolve_device

try:  # gymnasium API when available
    import gymnasium as gym
    from gymnasium import spaces

    _GYM_BASE = gym.Env
except Exception:
    gym = None
    spaces = None
    _GYM_BASE = object


@dataclasses.dataclass
class QualityLevel:
    """(resolution, bitrate kbps)."""

    resolution: int
    bitrate: float


DEFAULT_LADDER: Tuple[QualityLevel, ...] = (
    QualityLevel(360, 365),
    QualityLevel(480, 750),
    QualityLevel(720, 1500),
    QualityLevel(1080, 3000),
    QualityLevel(1440, 6000),
)

# The ranges of the uniform draws: the first bandwidth, the observation's
# content-complexity entry, the bandwidth's multiplicative step.
RESET_BANDWIDTH = (2.0, 15.0)
OBS_NOISE = (0.3, 0.8)
BANDWIDTH_STEP = (0.8, 1.2)


class StreamingEnv(_GYM_BASE):
    """Gymnasium-compatible ABR environment (numpy, single stream)."""

    metadata = {"render_modes": ["human"]}

    def __init__(
        self,
        quality_ladder: Optional[List[QualityLevel]] = None,
        segment_duration: float = 4.0,
        buffer_size: float = 30.0,
        max_steps: int = 100,
    ):
        self.quality_ladder = list(quality_ladder or DEFAULT_LADDER)
        self.segment_duration = segment_duration
        self.buffer_size = buffer_size
        self.max_steps = max_steps
        self.num_qualities = len(self.quality_ladder)
        self.enhancement_levels = 5

        if spaces is not None:
            self.action_space = spaces.MultiDiscrete(
                [self.num_qualities, self.enhancement_levels]
            )
            self.observation_space = spaces.Box(0.0, 1.0, shape=(7,), dtype=np.float32)

        self._np_random = np.random.default_rng()
        self.reset()

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._np_random = np.random.default_rng(seed)
        self.buffer_level = 10.0
        self.bandwidth = float(self._np_random.uniform(2, 15))
        self.battery = 1.0
        self.last_quality = 2
        self.last_vmaf = 70.0
        self.step_count = 0
        self.total_rebuffer = 0.0
        return self._get_obs(), {}

    def _get_obs(self) -> np.ndarray:
        return np.array(
            [
                self.buffer_level / self.buffer_size,
                min(self.bandwidth / 20.0, 1.0),
                self.battery,
                self.last_quality / self.num_qualities,
                self.last_vmaf / 100.0,
                self._np_random.uniform(0.3, 0.8),  # fresh noise per observation
                self.step_count / self.max_steps,
            ],
            dtype=np.float32,
        )

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        quality_idx = int(action[0])
        enhancement = float(action[1]) / (self.enhancement_levels - 1)
        quality = self.quality_ladder[quality_idx]

        chunk_kbits = quality.bitrate * self.segment_duration
        download_time = chunk_kbits / (self.bandwidth * 1000.0)

        self.buffer_level -= download_time
        rebuffer = max(0.0, -self.buffer_level)
        self.total_rebuffer += rebuffer
        self.buffer_level = min(
            max(self.buffer_level, 0.0) + self.segment_duration, self.buffer_size
        )

        base_vmaf = 50.0 + (quality_idx / self.num_qualities) * 40.0
        self.last_vmaf = min(base_vmaf + enhancement * 10.0, 100.0)

        self.battery = max(0.0, self.battery - (0.01 + enhancement * 0.02))

        reward = (
            self.last_vmaf / 100.0
            - rebuffer * 10.0
            - abs(quality_idx - self.last_quality) * 0.1
            + self.battery * 0.1
        )

        self.last_quality = quality_idx
        self.step_count += 1
        self.bandwidth = float(
            np.clip(self.bandwidth * self._np_random.uniform(0.8, 1.2), 0.5, 50.0)
        )

        terminated = self.step_count >= self.max_steps
        truncated = self.battery <= 0.0
        info = {
            "vmaf": self.last_vmaf,
            "rebuffer": rebuffer,
            "bandwidth": self.bandwidth,
            "buffer": self.buffer_level,
        }
        return self._get_obs(), float(reward), terminated, truncated, info


def make_env(env_id: str = "Streaming-v0", **kwargs) -> StreamingEnv:
    """Factory: a :class:`StreamingEnv` (``env_id`` is ignored)."""
    return StreamingEnv(**kwargs)


# --------------------------------------------------------------------------- #
# Batched environment on a torch device
# --------------------------------------------------------------------------- #


class StreamState(NamedTuple):
    """N streams' state: (N,) float32 tensors, ``last_quality`` and
    ``step_count`` int32."""

    buffer_level: torch.Tensor
    bandwidth: torch.Tensor
    battery: torch.Tensor
    last_quality: torch.Tensor
    last_vmaf: torch.Tensor
    step_count: torch.Tensor
    total_rebuffer: torch.Tensor


class StepDraws(NamedTuple):
    """The uniform draws of one ``auto_reset_step`` (any common shape, (N,)
    for a step): the bandwidth's step factor in [0.8, 1.2), the next
    observation's noise in [0.3, 0.8), and a fresh stream's first bandwidth
    in [2, 15) and first observation noise in [0.3, 0.8) (used where the
    stream ends)."""

    bw_factor: torch.Tensor
    obs_noise: torch.Tensor
    reset_bandwidth: torch.Tensor
    reset_noise: torch.Tensor


def _uniform(shape, lo: float, hi: float, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo


class TorchStreamingEnv:
    """N streams of :class:`StreamingEnv`'s dynamics advanced together on
    ``device`` (the card unless ``device="cpu"``), in float32 and int32 as
    the JAX package's batched env computes them. Divisions are by tensors
    on the device, so the card divides as the CPU does (a CUDA tensor divided
    by a Python number is multiplied by its float32 reciprocal)."""

    def __init__(
        self,
        quality_ladder: Optional[List[QualityLevel]] = None,
        segment_duration: float = 4.0,
        buffer_size: float = 30.0,
        max_steps: int = 100,
        device="cuda",
    ):
        self.device = resolve_device(device)
        ladder = list(quality_ladder or DEFAULT_LADDER)
        self.bitrates = torch.tensor([q.bitrate for q in ladder], dtype=torch.float32,
                                     device=self.device)
        self.num_qualities = len(ladder)
        self.enhancement_levels = 5
        self.segment_duration = segment_duration
        self.buffer_size = buffer_size
        self.max_steps = max_steps
        self.obs_dim = 7
        self.action_dims = (self.num_qualities, self.enhancement_levels)

        def c(v):
            return torch.tensor(v, dtype=torch.float32, device=self.device)

        self._div = {"buffer": c(buffer_size), "bw": c(20.0), "q": c(self.num_qualities),
                     "vmaf": c(100.0), "steps": c(max_steps), "enh": c(self.enhancement_levels - 1)}

    # ------------------------------------------------------------------ #
    # Draws
    # ------------------------------------------------------------------ #
    def reset_draws(self, shape, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """(first bandwidth, first observation noise) shaped ``shape``."""
        return (_uniform(shape, *RESET_BANDWIDTH, generator, self.device),
                _uniform(shape, *OBS_NOISE, generator, self.device))

    def step_draws(self, shape, generator: torch.Generator) -> StepDraws:
        """The draws of ``auto_reset_step`` shaped ``shape`` ((N,) for one
        step, (T, N) for T steps)."""
        return StepDraws(_uniform(shape, *BANDWIDTH_STEP, generator, self.device),
                         _uniform(shape, *OBS_NOISE, generator, self.device),
                         *self.reset_draws(shape, generator))

    # ------------------------------------------------------------------ #
    # Dynamics
    # ------------------------------------------------------------------ #
    def reset(self, bandwidth: torch.Tensor, obs_noise: torch.Tensor
              ) -> Tuple[StreamState, torch.Tensor]:
        """Fresh streams with first bandwidths ``bandwidth`` and first
        observation noise ``obs_noise`` ((N,) each)."""
        n = bandwidth.shape
        dev = self.device
        state = StreamState(
            buffer_level=torch.full(n, 10.0, device=dev),
            bandwidth=bandwidth.to(dev, torch.float32),
            battery=torch.ones(n, device=dev),
            last_quality=torch.full(n, 2, dtype=torch.int32, device=dev),
            last_vmaf=torch.full(n, 70.0, device=dev),
            step_count=torch.zeros(n, dtype=torch.int32, device=dev),
            total_rebuffer=torch.zeros(n, device=dev),
        )
        return state, self._obs(state, obs_noise)

    def _obs(self, s: StreamState, noise: torch.Tensor) -> torch.Tensor:
        d = self._div
        return torch.stack(
            [
                s.buffer_level / d["buffer"],
                torch.clamp_max(s.bandwidth / d["bw"], 1.0),
                s.battery,
                s.last_quality.float() / d["q"],
                s.last_vmaf / d["vmaf"],
                noise.to(self.device, torch.float32),
                s.step_count.float() / d["steps"],
            ],
            dim=-1,
        )

    def step(self, state: StreamState, action: torch.Tensor, bw_factor: torch.Tensor,
             obs_noise: torch.Tensor):
        """One segment for every stream: ``action`` (N, 2) integer, the
        bandwidth's step factors and the next observations' noise (N,).
        Returns (state, obs, reward, terminated, truncated, info)."""
        d = self._div
        q_idx = action[..., 0].to(torch.int32)
        enh = action[..., 1].float() / d["enh"]

        chunk_kbits = self.bitrates[q_idx.long()] * self.segment_duration
        download_time = chunk_kbits / (state.bandwidth * 1000.0)

        buf = state.buffer_level - download_time
        rebuffer = torch.clamp_min(-buf, 0.0)
        buf = torch.clamp_max(torch.clamp_min(buf, 0.0) + self.segment_duration,
                              self.buffer_size)

        vmaf = torch.clamp_max(
            50.0 + (q_idx.float() / d["q"]) * 40.0 + enh * 10.0, 100.0)
        battery = torch.clamp_min(state.battery - (0.01 + enh * 0.02), 0.0)

        reward = (
            vmaf / d["vmaf"]
            - rebuffer * 10.0
            - torch.abs(q_idx - state.last_quality).float() * 0.1
            + battery * 0.1
        )

        bandwidth = torch.clamp(state.bandwidth * bw_factor.to(self.device, torch.float32),
                                0.5, 50.0)
        new_state = StreamState(
            buffer_level=buf,
            bandwidth=bandwidth,
            battery=battery,
            last_quality=q_idx,
            last_vmaf=vmaf,
            step_count=state.step_count + 1,
            total_rebuffer=state.total_rebuffer + rebuffer,
        )
        terminated = new_state.step_count >= self.max_steps
        truncated = battery <= 0.0
        info = {"vmaf": vmaf, "rebuffer": rebuffer, "bandwidth": bandwidth, "buffer": buf}
        return new_state, self._obs(new_state, obs_noise), reward, terminated, truncated, info

    def auto_reset_step(self, state: StreamState, action: torch.Tensor, draws: StepDraws):
        """``step``, then every stream that ended starts afresh from the
        draws' reset entries. Returns (state, obs, reward, done, info)."""
        new_state, obs, reward, term, trunc, info = self.step(
            state, action, draws.bw_factor, draws.obs_noise)
        done = torch.logical_or(term, trunc)
        reset_state, reset_obs = self.reset(draws.reset_bandwidth, draws.reset_noise)
        merged = StreamState(*(torch.where(done, a, b) for a, b in zip(reset_state, new_state)))
        obs = torch.where(done[..., None], reset_obs, obs)
        return merged, obs, reward, done, info
