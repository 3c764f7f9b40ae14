"""Monte Carlo KL pose loss with an EMA normalisation factor (PyTorch).

Counterpart of ``epropnp_tpu/models/losses/monte_carlo_pose_loss.py``:
``loss = (cost_target + logsumexp(pose_sample_logweights)) / norm_factor``,
where ``norm_factor`` is an exponential moving average of a scale that the
caller supplies, averaged over the data-parallel replicas
(``parallel.mesh.replica_mean``, JAX's ``lax.pmean``). The 6DoF variant
is the default; ``weight`` and ``avg_factor`` give the Det variant's
mmdet-style weighting.

The EMA is explicit state (``MonteCarloPoseLossState``); a trainer keeps
its value as a buffer and checkpoints it with the parameters, as the
reference's registered buffer.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ...parallel.mesh import replica_mean


@dataclass(frozen=True)
class MonteCarloPoseLossState:
    norm_factor: torch.Tensor  # scalar EMA buffer

    @classmethod
    def create(cls, init_norm_factor: float = 1.0, dtype=torch.float32,
               device=None):
        return cls(norm_factor=torch.tensor(init_norm_factor, dtype=dtype,
                                            device=device))


def monte_carlo_pose_loss(
    pose_sample_logweights: torch.Tensor,  # (mc_samples, num_obj)
    cost_target: torch.Tensor,             # (num_obj,)
    norm_factor: torch.Tensor,             # scalar, the current batch's scale
    state: MonteCarloPoseLossState,
    momentum: float = 0.01,
    training: bool = True,
    data_parallel: bool = False,
    weight: Optional[torch.Tensor] = None,
    avg_factor: Optional[torch.Tensor] = None,
    loss_weight: float = 1.0,
):
    """Returns ``(loss, new_state)``; ``norm_factor`` enters the EMA
    without gradient, averaged over the replicas with ``data_parallel``
    (the reference's ``reduce_mean``)."""
    if training:
        nf = norm_factor.detach()
        if data_parallel:
            nf = replica_mean(nf)
        new_state = replace(state, norm_factor=state.norm_factor
                            * (1.0 - momentum) + momentum * nf)
    else:
        new_state = state
    loss_pose = cost_target + torch.logsumexp(pose_sample_logweights, 0)
    loss_pose = torch.where(torch.isnan(loss_pose),
                            torch.zeros_like(loss_pose), loss_pose)
    if weight is not None:
        loss_pose = loss_pose * weight
    if avg_factor is not None:
        loss = loss_pose.sum() / avg_factor
    else:
        loss = loss_pose.mean()
    return loss * loss_weight / new_state.norm_factor, new_state
