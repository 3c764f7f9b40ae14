"""Det-suite training helpers used by serving (PyTorch). The training step
of ``epropnp_tpu/det/train.py`` is not ported yet."""

from __future__ import annotations

import torch


def avg_pool_stride(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(n, h, w, c) -> (n, h / stride, w / stride, c) block means."""
    n, h, w, c = x.shape
    return x.reshape(n, h // stride, stride, w // stride, stride, c).mean(
        (2, 4))
