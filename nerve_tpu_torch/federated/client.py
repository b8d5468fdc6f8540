"""Federated client: local training and evaluation on private data
(counterpart of ``nerve_tpu/federated/client.py``).

The contract of the reference's Flower ``NumPyClient``: ``fit(parameters,
config) → (parameters, num_samples, metrics)`` and ``evaluate(parameters,
config) → (loss, num_samples, metrics)`` over the numpy wire format
(``federated.common``). Local training is AdamW on the mean squared error
with the model in training mode (the lightweight model's live BatchNorm,
``LightweightSuperResolution.train_body``), optionally with DP clipping and
noise on the gradients before AdamW (``privacy.make_private``).

AdamW is ``optax.adamw(learning_rate)``'s: b1 0.9, b2 0.999, eps 1e-8 and a
weight decay of 1e-4 on every parameter, BatchNorm's scale and bias
included (``torch.optim.AdamW``'s own default decay is 1e-2). Batches come
from ``utils.data.batches`` with a ``np.random.default_rng(seed)`` shuffle,
the JAX client's, so both packages see the same batches.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from nerve_tpu_torch.federated.common import tree_from_arrays, tree_to_arrays
from nerve_tpu_torch.federated.privacy import PrivacyConfig, make_private
from nerve_tpu_torch.models.layers import batch_stats
from nerve_tpu_torch.utils import data as data_lib
from nerve_tpu_torch.utils.metrics import mse

WEIGHT_DECAY = 1e-4  # optax.adamw's default


class VideoEnhancementClient:
    """A federated participant training an SR model on local videos.

    Args:
        model: an SR module of the port (``LightweightSuperResolution``, or
            ``SuperResolutionNet`` with ``num_frames`` > 1); the client
            trains its own copy (parameters, BatchNorm statistics, AdamW
            state), on the module's device.
        train_data / val_data: {'lr': (N, H, W, C), 'hr': ...} numpy arrays.
        num_frames: temporal window the model expects (1: single frame).
        local_epochs: default local epochs per round.
        learning_rate: AdamW's rate.
        privacy: optional DP config → clipped and noised gradients.
    """

    def __init__(self, model: nn.Module, train_data: Dict[str, np.ndarray],
                 val_data: Optional[Dict[str, np.ndarray]] = None, num_frames: int = 3,
                 local_epochs: int = 5, batch_size: int = 8, learning_rate: float = 1e-4,
                 privacy: Optional[PrivacyConfig] = None, seed: int = 0):
        self.model = copy.deepcopy(model)
        self.device = next(self.model.parameters()).device
        self.train_data = train_data
        self.val_data = val_data if val_data is not None else train_data
        self.num_frames = num_frames
        self.local_epochs = local_epochs
        # Each loop is clamped to its own split: batches() drops partial
        # batches, so a split smaller than the batch would give no batch
        # (and nan metrics); a tiny validation split must not shrink the
        # training batches (nor the DP noise's batch size).
        self.batch_size = max(1, min(batch_size, len(train_data["lr"])))
        self.eval_batch_size = max(1, min(batch_size, len(self.val_data["lr"])))
        self._rng = np.random.default_rng(seed)
        self.params = dict(self.model.named_parameters())
        opt = torch.optim.AdamW(list(self.params.values()), lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY)
        if privacy is not None:
            # The clamped batch: the noise scales with the batch a step uses.
            opt = make_private(opt, privacy, batch_size=self.batch_size, seed=seed)
        self.optimizer = opt

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The client's BatchNorm running statistics (they stay local)."""
        return batch_stats(self.model)

    def device_batch(self, batch: Dict[str, np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lr window, hr) of a numpy batch on the client's device."""
        lr = torch.from_numpy(np.ascontiguousarray(batch["lr"])).to(self.device)
        if self.num_frames > 1:
            lr = data_lib.expand_temporal(lr, self.num_frames)
        return lr, torch.from_numpy(np.ascontiguousarray(batch["hr"])).to(self.device)

    # ------------------------------------------------------------------ #
    # Wire-format API
    # ------------------------------------------------------------------ #
    def get_parameters(self) -> List[np.ndarray]:
        return tree_to_arrays(self.params)

    def set_parameters(self, arrays: Sequence[np.ndarray]) -> None:
        """Copy ``arrays`` into the parameters in place (AdamW keeps its state)."""
        new = tree_from_arrays(self.params, arrays)
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(new[k])

    def train_step(self, lr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        """One AdamW step on one batch; returns the batch's loss."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = mse(self.model(lr), hr)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def fit(self, parameters: Sequence[np.ndarray], config: Optional[Dict[str, Any]] = None
            ) -> Tuple[List[np.ndarray], int, Dict[str, float]]:
        """Local training round → (new parameters, num samples, metrics)."""
        config = config or {}
        self.set_parameters(parameters)
        epochs = int(config.get("local_epochs", self.local_epochs))
        losses = []
        for _ in range(epochs):
            for batch in data_lib.batches(self.train_data, self.batch_size, rng=self._rng):
                losses.append(self.train_step(*self.device_batch(batch)))
        n = len(self.train_data["lr"])
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        return self.get_parameters(), n, {"train_loss": train_loss}

    def evaluate(self, parameters: Sequence[np.ndarray],
                 config: Optional[Dict[str, Any]] = None) -> Tuple[float, int, Dict[str, float]]:
        """Validation MSE on local data → (loss, num samples, metrics)."""
        self.set_parameters(parameters)
        self.model.eval()
        batches = data_lib.batches(self.val_data, self.eval_batch_size)
        losses = [mse(self.model(lr), hr) for lr, hr in map(self.device_batch, batches)]
        n = len(self.val_data["lr"])
        loss = float(torch.stack(losses).mean()) if losses else float("nan")
        return loss, n, {"mse": loss}


def create_client(model: nn.Module, train_lr: np.ndarray, train_hr: np.ndarray,
                  val_lr: Optional[np.ndarray] = None, val_hr: Optional[np.ndarray] = None,
                  **kwargs) -> VideoEnhancementClient:
    """A client from raw arrays (parity: nerve_cl/federated/client.py:137-160)."""
    train = {"lr": np.asarray(train_lr), "hr": np.asarray(train_hr)}
    val = {"lr": np.asarray(val_lr), "hr": np.asarray(val_hr)} if val_lr is not None else None
    return VideoEnhancementClient(model, train, val, **kwargs)
