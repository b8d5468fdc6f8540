"""Adaptive-bitrate (ABR) reinforcement learning (counterpart of
``nerve_tpu/abr``): the streaming simulator (``StreamingEnv`` in numpy, one
stream; ``TorchStreamingEnv``, N streams on a torch device) and the PPO agent
(``PPOAgent``, ``ActorCritic``, ``ABRConfig``)."""

from nerve_tpu_torch.abr.environment import (  # noqa: F401
    QualityLevel,
    StreamingEnv,
    TorchStreamingEnv,
    make_env,
)
from nerve_tpu_torch.abr.agent import ABRConfig, ActorCritic, PPOAgent  # noqa: F401
