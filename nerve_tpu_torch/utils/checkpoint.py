"""Checkpoint and resume (counterpart of ``nerve_tpu/utils/checkpoint.py``).

A train state (nested dicts of tensors and numbers: parameters, optimiser
state, BatchNorm statistics, step, extras) is saved per step with
``torch.save`` into ``<directory>/step_<N>.pt``, written to a temporary
file and renamed, so that a checkpoint on disk is whole; the last
``keep_last_n`` are kept. No orbax.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Mapping, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _missing(template: Any, tree: Any, prefix: str = "") -> List[str]:
    """Paths of ``template``'s mapping keys that ``tree`` lacks."""
    if not isinstance(template, Mapping):
        return []
    if not isinstance(tree, Mapping):
        return [prefix or "<root>"]
    out = []
    for k, v in template.items():
        if k not in tree:
            out.append(f"{prefix}{k}")
        else:
            out += _missing(v, tree[k], f"{prefix}{k}.")
    return out


class CheckpointManager:
    """Save / restore per-step checkpoints with keep-last-N retention."""

    def __init__(self, directory: str, keep_last_n: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep_last_n = keep_last_n
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        """The steps on disk, oldest first."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write ``state`` as step ``step``; False where that step exists and
        ``force`` is off."""
        path = self._path(step)
        if os.path.exists(path) and not force:
            return False
        tmp = f"{path}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        if self.keep_last_n > 0:
            for old in self.steps()[:-self.keep_last_n]:
                os.remove(self._path(old))
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_raw(self, step: Optional[int] = None) -> Any:
        """The saved tree as it was written, its tensors on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The saved tree, checked against ``template``'s structure: a key of
        the template missing on disk raises ``ValueError``."""
        tree = self.restore_raw(step)
        missing = _missing(template, tree)
        if missing:
            raise ValueError(f"checkpoint lacks {missing}")
        return tree

    def close(self) -> None:
        """Nothing is held open; kept for the JAX manager's interface."""
