"""Continual learning through the port (counterpart of ``nerve_tpu.continual``).

Episodic replay memory, EWC / Online-EWC / Synaptic Intelligence, MAML /
FOMAML / Reptile / ContentAdaptiveMAML and knowledge distillation, over
parameter dicts by ``named_parameters`` name and losses
``loss_fn(params, batch)`` (``continual.params``). Through
``SuperResolutionNet`` the losses run its eval forward under autograd
(``differentiable=True``) and so its kernel ops as autograd Functions,
second-order MAML included (``ops.dispatch.recompute_vjp``).
"""

from nerve_tpu_torch.continual.memory import (  # noqa: F401
    EpisodicMemory,
    MemorySample,
    StreamingEpisodicMemory,
)
from nerve_tpu_torch.continual.ewc import EWC, OnlineEWC, SynapticIntelligence  # noqa: F401
from nerve_tpu_torch.continual.maml import (  # noqa: F401
    ContentAdaptiveMAML,
    FOMAML,
    MAML,
    Reptile,
)
from nerve_tpu_torch.continual.distillation import (  # noqa: F401
    ContinualDistillation,
    DistillationLoss,
)
