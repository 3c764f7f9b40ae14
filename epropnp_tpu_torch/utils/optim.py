"""What the port's optimizers share (PyTorch): the global norm of a set of
tensors, their finiteness, and the base of an optimizer that updates as an
optax chain does: ``optax.clip_by_global_norm`` over all groups (without
the 1e-6 that ``torch.nn.utils.clip_grad_norm_`` adds to the norm), then a
per-group update at a learning rate with the step decay of
``optax.piecewise_constant_schedule``."""

from __future__ import annotations

from typing import Optional

import torch


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


def all_finite(tensors) -> torch.Tensor:
    """True where every element of every tensor is finite (per element, not
    by the norm, whose sum of squares can overflow): g * 0 is 0 for a
    finite g and NaN otherwise."""
    return torch.isfinite(torch.stack(torch._foreach_norm(
        torch._foreach_mul(list(tensors), 0.0)))).all()


class OptaxOptimizer(torch.optim.Optimizer):
    """Each group holds ``lr``, ``lr_boundaries``, ``lr_factor`` and its
    update ``count``; a step that is not taken (the non-finite skip)
    leaves every state, the count included, unchanged."""

    def __init__(self, param_groups, defaults: dict,
                 clip_grad_norm: Optional[float] = None):
        super().__init__(param_groups, dict(defaults, count=0))
        self.clip_grad_norm = clip_grad_norm

    @staticmethod
    def learning_rate(group) -> float:
        """The group's ``lr`` times every ``lr_factor`` whose boundary is
        <= its update count."""
        lr = group['lr']
        for boundary in sorted(group['lr_boundaries']):
            if group['count'] >= boundary:
                lr = lr * group['lr_factor']
        return lr

    def clipped_grads(self):
        """Every parameter's gradient (zeros where it has none), group by
        group, scaled by ``clip / norm`` where the global norm reaches the
        clip."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for g in self.param_groups for p in g['params']]
        if self.clip_grad_norm is not None:
            norm = global_norm(grads)
            scale = torch.where(norm < self.clip_grad_norm,
                                torch.ones_like(norm),
                                self.clip_grad_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        return grads
