"""End-to-End Probabilistic Perspective-n-Points (EPro-PnP), PyTorch.

Counterpart of ``epropnp_tpu/ops/pnp/epropnp.py``. The pose is a random
variable ``p(y|X) ~ exp(-cost(y; X))``; the normalising integral is
approximated with Adaptive Multiple Importance Sampling (AMIS). Gradients
flow only through the costs evaluated at the target pose and at the
samples; the proposal fits and the deterministic solve run under
``torch.no_grad()`` (JAX's ``stop_gradient``).

The AMIS loop is a plain Python loop over ``num_iter``. Iteration ``i``
draws ``mc_samples / num_iter`` samples from proposal ``i`` and evaluates
each proposal ``j <= i`` on the samples ``k <= i``; the mixture of the
proposals fitted so far weights the samples and fits proposal ``i + 1``
(the reference's triangular ``logprobs[i, :i+1]``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from .common import evaluate_pnp, pnp_denormalize, pnp_normalize
from .distributions import (
    AngularCentralGaussian,
    MultivariateStudentT,
    VonMisesUniformMix,
    cholesky_wrapper,
)
from .levenberg_marquardt import LMSolver, _generator
from .linalg import det_small, inv_spd_small


def draw_pose_samples(trans_distr, rot_distr, num: int,
                      gen: torch.Generator) -> torch.Tensor:
    """``num`` poses (num, num_obj, pose_dim) from one proposal."""
    return torch.cat([trans_distr.sample(gen, (num,)),
                      rot_distr.sample(gen, (num,))], -1)


def _flatten2(x):
    """Drop the trailing singleton event dim of the 4DoF yaw log_prob (the
    6DoF ACG log_prob is already one value per sample)."""
    return x[..., 0] if x.ndim >= 1 and x.shape[-1] == 1 else x


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

    @property
    def iter_samples(self) -> int:
        return self.mc_samples // self.num_iter

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        """Deterministic solve: ``(pose_opt, pose_cov, cost, pose_plus)``."""
        return self.solver(*args, **kwargs)

    def _log_prob(self, params, samples):
        """log q_params(samples): proposals stacked on dim 0 of every
        parameter (p, num_obj, ...), samples (s, num_obj, pose_dim) ->
        (p, s, num_obj)."""
        trans, rot = self.gen_stacked_distr(params)
        return trans.log_prob(samples[..., :3]) \
            + _flatten2(rot.log_prob(samples[..., 3:]))

    def monte_carlo_forward(self, x3d, x2d, w2d, camera, cost_fun, rng=None,
                            pose_init=None, force_init_solve=True, **kwargs):
        """Monte Carlo PnP forward (AMIS).

        Args:
            x3d/x2d/w2d: (num_obj, num_points, {3, 2, 2}).
            rng: ``torch.Generator`` for the init solver and the AMIS
                proposals (None: a fresh one seeded 0).
            pose_init: optional (num_obj, 4 or 7) target pose.

        Returns:
            (pose_opt, cost, pose_opt_plus,
             pose_samples (mc_samples, num_obj, 4|7),
             pose_sample_logweights (mc_samples, num_obj), cost_init)
        """
        gen = _generator(rng, x3d.device)
        if self.normalize:
            transform, x3d, pose_init = pnp_normalize(
                x3d, pose_init, detach_transformation=True)
        assert x3d.ndim == x2d.ndim == w2d.ndim == 3
        num_obj = x3d.shape[0]
        s, t = self.iter_samples, self.num_iter

        def eval_cost(pose):
            return evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                                out_cost=True).cost

        cost_init = eval_cost(pose_init) if pose_init is not None else None
        pose_opt, pose_cov, cost, pose_opt_plus = self.solver(
            x3d, x2d, w2d, camera, cost_fun, rng=gen, pose_init=pose_init,
            cost_init=cost_init, with_pose_cov=True,
            force_init_solve=force_init_solve, normalize_override=False,
            **kwargs)

        with torch.no_grad():
            params = [tuple(p.to(x3d.dtype) for p in self.initial_fit(
                pose_opt, pose_cov, camera))]
            # logprobs[j, k]: proposal j on the samples of iteration k
            logprobs = x3d.new_zeros((t, t, s, num_obj))
        samples, costs = [], []
        for i in range(t):
            with torch.no_grad():
                samples.append(draw_pose_samples(
                    *self.gen_new_distr(params[i]), s, gen))
            costs.append(eval_cost(samples[i]))  # differentiable
            with torch.no_grad():
                stacked = tuple(torch.stack(ps) for ps in zip(*params))
                # proposals j <= i on the new samples, the new proposal on
                # the older samples k < i
                logprobs[:i + 1, i] = self._log_prob(stacked, samples[i])
                if i:
                    logprobs[i, :i] = self._log_prob(
                        tuple(p[i:] for p in stacked), torch.cat(samples[:i])
                    ).reshape(i, s, num_obj)
                if i + 1 < t:
                    mix = torch.logsumexp(logprobs[:i + 1, :i + 1], 0) \
                        - math.log(i + 1.0)
                    logweights = -torch.stack(costs) - mix
                    params.append(tuple(p.to(x3d.dtype) for p in
                                        self.estimate_params(
                        torch.cat(samples), logweights.reshape(-1, num_obj))))

        mix_logprobs = torch.logsumexp(logprobs, 0) - math.log(t)
        pose_sample_logweights = (-torch.stack(costs) - mix_logprobs
                                  ).reshape(self.mc_samples, num_obj)
        pose_samples = torch.cat(samples)

        if self.normalize:
            pose_opt = pnp_denormalize(transform, pose_opt)
            pose_samples = pnp_denormalize(transform, pose_samples)
            if pose_opt_plus is not None:
                pose_opt_plus = pnp_denormalize(transform, pose_opt_plus)
        return (pose_opt, cost, pose_opt_plus, pose_samples,
                pose_sample_logweights, cost_init)


def _weighted_translation(w, pose_samples, default_diag=None):
    """Weighted mean and covariance Cholesky of the translations."""
    trans_mode = (w[..., None] * pose_samples[..., :3]).sum(0)
    dev = pose_samples[..., :3] - trans_mode
    trans_cov = (w[..., None, None] * dev[..., :, None]
                 * dev[..., None, :]).sum(0)
    return trans_mode, cholesky_wrapper(trans_cov, default_diag)


@dataclass(frozen=True)
class EProPnP4DoF(EProPnPBase):
    """4DoF poses ``[x, y, z, yaw]``: a t-distributed translation and a
    von Mises + uniform yaw (the Det suite)."""

    def initial_fit(self, pose_opt, pose_cov, camera):
        trans_mode = pose_opt[..., :3]
        rot_mode = pose_opt[..., 3:]
        trans_cov_tril = cholesky_wrapper(pose_cov[..., :3, :3],
                                          [1.0, 1.0, 4.0])
        rot_kappa = 0.33 / torch.clamp(pose_cov[..., 3:, 3], min=self.eps)
        return trans_mode, trans_cov_tril, rot_mode, rot_kappa

    @staticmethod
    def gen_new_distr(params):
        trans_mode, trans_cov_tril, rot_mode, rot_kappa = params
        return (MultivariateStudentT(3.0, trans_mode, trans_cov_tril),
                VonMisesUniformMix(rot_mode, rot_kappa))

    @staticmethod
    def gen_stacked_distr(params):
        """Distributions over stacked (p, num_obj, ...) parameters."""
        trans_mode, trans_cov_tril, rot_mode, rot_kappa = (
            p[:, None] for p in params)
        return (MultivariateStudentT(3.0, trans_mode, trans_cov_tril),
                VonMisesUniformMix(rot_mode, rot_kappa))

    def estimate_params(self, pose_samples, pose_sample_logweights):
        """Weighted translation moments and circular yaw statistics."""
        w = torch.softmax(pose_sample_logweights, 0)  # (c, num_obj)
        trans_mode, trans_cov_tril = _weighted_translation(
            w, pose_samples, [1.0, 1.0, 4.0])
        sin_mean = (w[..., None] * torch.sin(pose_samples[..., 3:])).sum(0)
        cos_mean = (w[..., None] * torch.cos(pose_samples[..., 3:])).sum(0)
        rot_mode = torch.atan2(sin_mean, cos_mean)
        r_sq = sin_mean.square() + cos_mean.square()
        rot_kappa = 0.33 * torch.clamp(torch.sqrt(r_sq), min=self.eps) \
            * (2.0 - r_sq) / torch.clamp(1.0 - r_sq, min=self.eps)
        return trans_mode, trans_cov_tril, rot_mode, rot_kappa


@dataclass(frozen=True)
class EProPnP6DoF(EProPnPBase):
    """6DoF poses ``[x, y, z, w, i, j, k]``: a t-distributed translation and
    an angular central Gaussian rotation."""

    acg_mle_iter: int = 3
    acg_dispersion: float = 0.001

    def _acg_tril(self, rot_cov):
        eye4 = torch.eye(4, dtype=rot_cov.dtype, device=rot_cov.device)
        return cholesky_wrapper(
            rot_cov + det_small(rot_cov)[..., None, None] ** 0.25
            * (self.acg_dispersion * eye4))

    def initial_fit(self, pose_opt, pose_cov, camera):
        trans_mode = pose_opt[..., :3]
        rot_mode = pose_opt[..., 3:]
        trans_cov_tril = cholesky_wrapper(pose_cov[..., :3, :3])
        eye4 = torch.eye(4, dtype=pose_opt.dtype, device=pose_opt.device)
        tf = camera.get_quaternion_transfrom_mat(rot_mode)  # (num_obj, 4, 3)
        rot_cov = inv_spd_small(
            tf @ inv_spd_small(pose_cov[..., 3:, 3:]) @ tf.transpose(-1, -2)
            + eye4)
        rot_cov = rot_cov / torch.diagonal(
            rot_cov, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        return trans_mode, trans_cov_tril, self._acg_tril(rot_cov)

    @staticmethod
    def gen_new_distr(params):
        trans_mode, trans_cov_tril, rot_cov_tril = params
        return (MultivariateStudentT(3.0, trans_mode, trans_cov_tril),
                AngularCentralGaussian(rot_cov_tril))

    @staticmethod
    def gen_stacked_distr(params):
        """Distributions over stacked (p, num_obj, ...) parameters."""
        trans_mode, trans_cov_tril, rot_cov_tril = (
            p[:, None] for p in params)
        return (MultivariateStudentT(3.0, trans_mode, trans_cov_tril),
                AngularCentralGaussian(rot_cov_tril))

    def estimate_params(self, pose_samples, pose_sample_logweights):
        """Weighted moments and the fixed-point ACG maximum likelihood."""
        w = torch.softmax(pose_sample_logweights, 0)  # (c, num_obj)
        trans_mode, trans_cov_tril = _weighted_translation(w, pose_samples)
        eye4 = torch.eye(4, dtype=pose_samples.dtype,
                         device=pose_samples.device)
        rot = pose_samples[..., 3:]                        # (c, num_obj, 4)
        r_r_t = rot[..., :, None] * rot[..., None, :]      # (c, num_obj, 4, 4)
        rot_cov = eye4.expand(pose_samples.shape[1], 4, 4)
        for _ in range(self.acg_mle_iter):
            m = torch.einsum('cbi,bij,cbj->cb', rot, inv_spd_small(rot_cov),
                             rot)
            inv_m_w = w / torch.clamp(m, min=self.eps)     # (c, num_obj)
            inv_m_wn = inv_m_w / inv_m_w.sum(0)
            rot_cov = (inv_m_wn[..., None, None] * r_r_t).sum(0) \
                + eye4 * self.eps
        return trans_mode, trans_cov_tril, self._acg_tril(rot_cov)
