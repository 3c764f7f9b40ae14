"""EPro-PnP (PyTorch): the deterministic forward.

Counterpart of ``epropnp_tpu/ops/pnp/epropnp.py:37-60``: ``EProPnPBase``
holds the Monte Carlo settings and a solver, and its ``forward`` is the
deterministic solve of that solver. The AMIS ``monte_carlo_forward`` and
the pose distributions it samples from come with the training slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .levenberg_marquardt import LMSolver


@dataclass(frozen=True)
class EProPnPBase:
    mc_samples: int = 512
    num_iter: int = 4
    normalize: bool = False
    eps: float = 1e-5
    solver: Optional[LMSolver] = None

    def __post_init__(self):
        assert self.num_iter > 0
        assert self.mc_samples % self.num_iter == 0

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        """Deterministic solve: ``(pose_opt, pose_cov, cost, pose_plus)``."""
        return self.solver(*args, **kwargs)


@dataclass(frozen=True)
class EProPnP4DoF(EProPnPBase):
    """4DoF poses ``[x, y, z, yaw]`` (the Det suite)."""
