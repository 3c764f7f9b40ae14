"""Target coders of the Det suite (PyTorch), counterpart of
``epropnp_tpu/core/bbox_3d/coders.py``: ``DistDimProjErrorCoder`` scales
reprojection errors by ``distance / (mean_dim * focal * std)``;
``MultiClassLogDimCoder`` normalises dimensions per class in log space
with the nuScenes statistics."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# nuScenes 10-class dimension statistics (l, h, w), reference defaults
NUSCENES_DIM_MEANS = (
    (4.62, 1.73, 1.96), (6.94, 2.84, 2.52), (12.56, 3.89, 2.94),
    (11.22, 3.50, 2.95), (6.68, 3.21, 2.85), (1.70, 1.29, 0.61),
    (2.11, 1.46, 0.78), (0.73, 1.77, 0.67), (0.41, 1.08, 0.41),
    (0.50, 0.99, 2.52))
NUSCENES_DIM_STDS = (
    (0.46, 0.24, 0.16), (2.11, 0.84, 0.45), (4.50, 0.77, 0.54),
    (2.06, 0.49, 0.33), (3.23, 0.93, 1.07), (0.26, 0.35, 0.16),
    (0.33, 0.29, 0.17), (0.19, 0.19, 0.14), (0.14, 0.27, 0.13),
    (0.17, 0.15, 0.62))


@dataclasses.dataclass(frozen=True)
class DistDimProjErrorCoder:
    target_std: float = 0.2
    distance_min: float = 0.1

    def _scale(self, distance, dimensions, focal):
        denom = dimensions.mean(-1, keepdim=True) * focal * self.target_std
        return torch.clamp(distance, min=self.distance_min), denom

    def encode(self, x2d_diff, distance, dimensions, focal):
        distance, denom = self._scale(distance, dimensions, focal)
        return x2d_diff * (distance / denom)[..., None, :]

    def decode(self, proj_error, distance, dimensions, focal):
        distance, denom = self._scale(distance, dimensions, focal)
        return proj_error * (denom / distance)[..., None, :]


@dataclasses.dataclass(frozen=True)
class MultiClassLogDimCoder:
    target_means: Tuple[Tuple[float, float, float], ...] = NUSCENES_DIM_MEANS
    target_stds: Tuple[Tuple[float, float, float], ...] = NUSCENES_DIM_STDS

    def _stats(self, like: torch.Tensor):
        m = np.asarray(self.target_means, np.float32)
        s = np.asarray(self.target_stds, np.float32)
        t = lambda a: torch.as_tensor(a, device=like.device)  # noqa: E731
        return t(np.log(m)), t(s / m)

    def encode(self, dimensions, labels):
        log_means, log_stds = self._stats(dimensions)
        return (torch.log(dimensions) - log_means[labels]) / log_stds[labels]

    def decode(self, dim_enc, labels):
        log_means, log_stds = self._stats(dim_enc)
        return torch.exp(dim_enc * log_stds[labels] + log_means[labels])
