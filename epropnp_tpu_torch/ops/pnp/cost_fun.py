"""Robust Huber reprojection cost with IRLS-style rescaling (PyTorch).

Counterpart of ``epropnp_tpu/ops/pnp/cost_fun.py``: the residual is the
weighted reprojection error, robustified per point by the Huber kernel; the
residual and Jacobian are rescaled by sqrt(rho'(s)) so that a Gauss-Newton
step on the rescaled problem is an IRLS step on the robust problem.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


def huber_kernel(s_sqrt, delta):
    """0.5*s^2 below delta, linear above."""
    return torch.where(s_sqrt <= delta, 0.5 * s_sqrt.square(),
                       delta * s_sqrt - 0.5 * delta.square())


def huber_d_kernel(s_sqrt, delta, eps: float = 1e-10):
    """sqrt of the Huber derivative rho'(s)."""
    return torch.sqrt(torch.clamp(delta / torch.clamp(s_sqrt, min=eps), max=1.0))


@dataclasses.dataclass(frozen=True)
class HuberPnPCost:
    """Huber robust cost with a fixed (scalar or per-object) delta."""

    delta: Union[float, torch.Tensor] = 1.0
    eps: float = 1e-10

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    def set_param(self, *args, **kwargs):
        return self

    def delta_per_object(self, num_obj: int, like: torch.Tensor):
        """Delta as a (num_obj,) tensor of ``like``'s dtype and device."""
        return torch.as_tensor(self.delta, dtype=like.dtype,
                               device=like.device).expand(num_obj).contiguous()

    def compute(self, x2d_proj, x2d, w2d, jac_cam=None,
                out_residual: bool = False, out_cost: bool = False,
                out_jacobian: bool = False):
        """Compute (residual (*, n*2), cost (*,), jacobian (*, n*2, dof))."""
        bs = x2d_proj.shape[:-2]
        pn = x2d_proj.shape[-2]
        delta = torch.as_tensor(self.delta, dtype=x2d.dtype,
                                device=x2d.device)[..., None]  # (*, 1)

        residual = (x2d_proj - x2d) * w2d  # (*, n, 2)
        ss = residual.square().sum(-1)
        s_sqrt = torch.sqrt(torch.clamp(ss, min=1e-24))  # (*, n)

        cost = None
        if out_cost:
            cost = huber_kernel(s_sqrt, delta).sum(-1)

        residual_out = jacobian = None
        if out_residual or out_jacobian:
            rho_d_sqrt = huber_d_kernel(s_sqrt, delta, eps=self.eps)
            if out_residual:
                residual_out = (residual * rho_d_sqrt[..., None]).reshape(
                    bs + (pn * 2,))
            if out_jacobian:
                assert jac_cam is not None
                dof = jac_cam.shape[-1]
                jacobian = (jac_cam * (w2d * rho_d_sqrt[..., None])[..., None]
                            ).reshape(bs + (pn * 2, dof))
        return residual_out, cost, jacobian

    # -- batch-shape helpers --

    def tile(self, reps: int):
        if isinstance(self.delta, torch.Tensor) and self.delta.ndim > 0:
            return self.replace(delta=self.delta.repeat(
                (reps,) + (1,) * (self.delta.ndim - 1)))
        return self

    def broadcast_to_batch(self, batch_shape):
        if isinstance(self.delta, torch.Tensor) and self.delta.ndim > 0:
            return self.replace(delta=self.delta.expand(tuple(batch_shape)))
        return self


@dataclasses.dataclass(frozen=True)
class AdaptiveHuberPnPCost(HuberPnPCost):
    """Huber cost whose delta adapts to the correspondence statistics.

    ``set_param`` returns a new instance with per-object
    ``delta = mean(w2d) * std(x2d) * relative_delta``.
    """

    delta: Optional[Union[float, torch.Tensor]] = None
    relative_delta: float = 0.5

    def set_param(self, x2d, w2d):
        # unbiased variance, as torch.var's default and the JAX ddof=1
        x2d_std = torch.sqrt(torch.var(x2d, dim=-2).sum(-1))  # (num_obj,)
        delta = w2d.mean(dim=(-2, -1)) * x2d_std * self.relative_delta
        return self.replace(delta=delta)
