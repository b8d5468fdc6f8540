"""Federated learning through the port (counterpart of ``nerve_tpu.federated``).

Client, server and strategy, privacy, clustering and the one-device FedAvg
simulation; the wire format is the JAX package's (``common``), so either
package's clients and servers interoperate over the socket transport
(``transport``). The framework-free modules (``transport``, ``server``,
``clustering``, ``flower_compat``) are the port's own copies: the port
imports nothing of the JAX package. The multi-process rounds (the JAX
package's ``dcn``) are not ported yet.
"""

from nerve_tpu_torch.federated.common import (  # noqa: F401
    get_parameters,
    set_parameters,
    tree_from_arrays,
    tree_to_arrays,
)
from nerve_tpu_torch.federated.privacy import (  # noqa: F401
    DPConfig,
    PrivacyConfig,
    compute_noise_multiplier,
    dp_gradient_transform,
    get_privacy_spent,
    make_private,
    make_private_loss_grad,
)
from nerve_tpu_torch.federated.client import VideoEnhancementClient, create_client  # noqa: F401
from nerve_tpu_torch.federated.server import (  # noqa: F401
    FederatedTrainer,
    VideoEnhancementStrategy,
    start_server,
    weighted_average,
)
from nerve_tpu_torch.federated.clustering import UserClustering, UserProfile  # noqa: F401
from nerve_tpu_torch.federated.simulation import MeshFederatedSimulation  # noqa: F401
