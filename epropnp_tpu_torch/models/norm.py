"""BatchNorm with flax's running-statistics update (PyTorch), and the
rematerialisation that keeps that update single.

``torch.nn.BatchNorm2d`` folds the *unbiased* batch variance (n / (n - 1))
into ``running_var``; ``flax.linen.BatchNorm``, the JAX package's layer,
folds the biased one. Both normalise a training batch by its biased
variance. :class:`BatchNorm2d` keeps torch's layer (names, state dict,
eval path) and replaces only the running update in training mode, so a
training step moves the statistics as the JAX package does:
``running = (1 - momentum) running + momentum batch`` with flax momentum
0.9 = torch momentum 0.1 (``momentum=None``: the cumulative average). The
batch statistics of a bf16 input are taken in f32, as flax takes them.

:func:`checkpoint` is ``torch.utils.checkpoint`` for the JAX package's
``jax.checkpoint``: the forward runs again in the backward, and that
second run leaves the running statistics (and ``num_batches_tracked``)
alone, so a rematerialised step moves them once, as the functional JAX
step does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


@contextlib.contextmanager
def _frozen_statistics(model: nn.Module):
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def checkpoint(model: nn.Module, fn, *args):
    """``fn(*args)`` (a forward of ``model``) under non-reentrant
    ``torch.utils.checkpoint``: its activations are not kept but computed
    again in the backward, where ``model``'s :class:`BatchNorm2d` layers
    normalise by the same batch statistics and move no running
    statistic."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _frozen_statistics(model)))


class BatchNorm2d(nn.BatchNorm2d):

    recomputing = False  # set by :func:`checkpoint` while it recomputes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # torch normalises a bf16 input with f32 parameters only: f64
        # parameters (a model in f64 with a bf16 backbone) are cast to f32
        cast = (x.dtype == torch.bfloat16
                and self.weight.dtype != torch.float32)
        f32 = (lambda t: t.float()) if cast else (lambda t: t)  # noqa: E731
        if not (self.training and self.track_running_stats):
            if not cast:
                return super().forward(x)
            return F.batch_norm(x, f32(self.running_mean),
                                f32(self.running_var), f32(self.weight),
                                f32(self.bias), False, 0.0, self.eps)
        out = F.batch_norm(x, None, None, f32(self.weight), f32(self.bias),
                           True, 0.0, self.eps)
        if self.recomputing:
            return out
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            factor = (1.0 / float(self.num_batches_tracked)
                      if self.momentum is None else self.momentum)
            var, mean = torch.var_mean(
                x.to(torch.promote_types(x.dtype, torch.float32)),
                dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), factor)
            self.running_var.lerp_(var.to(self.running_var.dtype), factor)
        return out
