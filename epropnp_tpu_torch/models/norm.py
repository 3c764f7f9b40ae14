"""BatchNorm with flax's running-statistics update (PyTorch).

``torch.nn.BatchNorm2d`` folds the *unbiased* batch variance (n / (n - 1))
into ``running_var``; ``flax.linen.BatchNorm``, the JAX package's layer,
folds the biased one. Both normalise a training batch by its biased
variance. :class:`BatchNorm2d` keeps torch's layer (names, state dict,
eval path) and replaces only the running update in training mode, so a
training step moves the statistics as the JAX package does:
``running = (1 - momentum) running + momentum batch`` with flax momentum
0.9 = torch momentum 0.1 (``momentum=None``: the cumulative average).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            factor = (1.0 / float(self.num_batches_tracked)
                      if self.momentum is None else self.momentum)
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), factor)
            self.running_var.lerp_(var.to(self.running_var.dtype), factor)
        return out
