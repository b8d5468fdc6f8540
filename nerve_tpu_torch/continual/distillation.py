"""Knowledge distillation for continual learning (counterpart of
``nerve_tpu/continual/distillation.py``).

The teacher is a detached snapshot of the student's parameters, and the
combined loss is a function of the student's parameters only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch

from nerve_tpu_torch.continual.params import Params, detached

ApplyFn = Callable[[Params, Any], torch.Tensor]


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


class DistillationLoss:
    """MSE distillation, blended with the task loss where a target is given:
    ``α · MSE(student, teacher) + (1 − α) · MSE(student, target)``, the
    teacher's output detached. ``temperature`` is kept for the API; the MSE
    form does not use it."""

    def __init__(self, temperature: float = 4.0, alpha: float = 0.5):
        self.temperature = temperature
        self.alpha = alpha

    def __call__(self, student_out: torch.Tensor, teacher_out: torch.Tensor,
                 target: Optional[torch.Tensor] = None) -> torch.Tensor:
        distill = _mse(student_out, teacher_out.detach())
        if target is None:
            return distill
        return self.alpha * distill + (1.0 - self.alpha) * _mse(student_out, target)


class ContinualDistillation:
    """Distillation from a snapshot of the student taken at each task."""

    def __init__(self, apply_fn: ApplyFn, temperature: float = 4.0, alpha: float = 0.5):
        self.apply_fn = apply_fn
        self.loss = DistillationLoss(temperature, alpha)
        self.teacher_params: Optional[Params] = None
        self.num_tasks = 0

    def register_task(self, student_params: Mapping[str, torch.Tensor]) -> None:
        """Snapshot the student as the frozen teacher."""
        self.teacher_params = detached(student_params)
        self.num_tasks += 1

    def compute_loss(self, student_params: Mapping[str, torch.Tensor], inputs: Any,
                     target: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{'task', 'distill', 'total'}; before any task, distill is 0."""
        student_out = self.apply_fn(student_params, inputs)
        task = _mse(student_out, target)
        if self.teacher_params is None:
            return {"task": task, "distill": task.new_zeros(()), "total": task}
        with torch.no_grad():
            teacher_out = self.apply_fn(self.teacher_params, inputs)
        distill = self.loss(student_out, teacher_out)
        total = self.loss.alpha * distill + (1.0 - self.loss.alpha) * task
        return {"task": task, "distill": distill, "total": total}
