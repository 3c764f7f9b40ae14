"""Batched Levenberg-Marquardt / Gauss-Newton PnP solvers (PyTorch).

Counterpart of ``epropnp_tpu/ops/pnp/levenberg_marquardt.py``: a fixed
iteration count LM with a Ceres-style trust region, a Gauss-Newton
``fast_mode``, a differentiable single GN step, and the random-sample
(RANSAC-like) initialisation solver.

The solve runs under ``torch.no_grad()``; only ``gn_step`` is
differentiable. ``torch.Generator`` objects take the place of PRNG keys.
With ``use_pallas`` (the JAX API's name for "use the fused kernels") the
solve goes through K1 (``lm_kernel.lm_solve``) and, where the same gate as
in the JAX package lets it, the init through K2 (``rslm_kernel.rslm_init``):
hand-written CUDA on CUDA tensors, their plain torch twins on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .common import evaluate_pnp, pnp_denormalize, pnp_normalize
from .linalg import inv_spd_small, solve_3x3, solve_spd_small


def _generator(rng: Optional[torch.Generator], device) -> torch.Generator:
    """The caller's generator, or a fresh one seeded 0 (the JAX PRNGKey(0))."""
    if rng is not None:
        return rng
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return gen


def _rand(shape, gen, like, normal=False):
    """Uniform [0, 1) or standard normal draws from ``gen``, moved to
    ``like``'s device and dtype."""
    draw = torch.randn if normal else torch.rand
    out = draw(shape, generator=gen, device=gen.device, dtype=like.dtype)
    return out.to(like.device)


def _diagonal(mat):
    return torch.diagonal(mat, dim1=-2, dim2=-1)


def _add_diagonal(mat, diag_delta):
    n = mat.shape[-1]
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device)
    return mat + eye * diag_delta[..., None, :]


def _jtj_damped_const(jac, eps):
    jtj = jac.transpose(-1, -2) @ jac
    return _add_diagonal(jtj, torch.full_like(_diagonal(jtj), eps))


def _kernel_camera(camera, num_obj, like):
    """The camera as the kernels take it: (num_obj, 4) ``[fx, fy, cx, cy]``
    and (num_obj, 4) ``[lb_u, lb_v, ub_u, ub_v]`` bounds or None."""
    from .lm_kernel import camera_to_fxfycxcy
    cam4 = camera_to_fxfycxcy(camera.cam_mats).expand(num_obj, 4).contiguous()
    if not camera.has_bounds:
        return cam4, None
    bound = lambda b: torch.as_tensor(  # noqa: E731
        b, dtype=like.dtype, device=like.device).expand(num_obj, 2)
    return cam4, torch.cat([bound(camera.lb), bound(camera.ub)],
                           -1).contiguous()


@dataclasses.dataclass(frozen=True)
class LMSolver:
    """Levenberg-Marquardt solver with a fixed number of iterations.

    Pose layouts: 4DoF ``[x, y, z, yaw]``; 6DoF ``[x, y, z, w, i, j, k]``
    with a unit quaternion.
    """

    dof: int = 4
    num_iter: int = 10
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    min_relative_decrease: float = 1e-3
    initial_trust_region_radius: float = 30.0
    max_trust_region_radius: float = 1e16
    eps: float = 1e-5
    normalize: bool = False
    init_solver: Optional['RSLMSolver'] = None
    # Route the solve through the fused LM kernel K1 (lm_kernel.py): the
    # CUDA kernel on CUDA tensors, its torch twin on CPU tensors. Valid for
    # zero-skew pinhole cameras with a per-object Huber delta.
    use_pallas: bool = False

    @property
    def pose_dim(self) -> int:
        return 4 if self.dof == 4 else 7

    def _lm_params(self):
        return dict(eps=self.eps, min_lm_diagonal=self.min_lm_diagonal,
                    max_lm_diagonal=self.max_lm_diagonal,
                    min_relative_decrease=self.min_relative_decrease,
                    initial_trust_region_radius=(
                        self.initial_trust_region_radius),
                    max_trust_region_radius=self.max_trust_region_radius)

    # ------------------------------------------------------------------ API

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, x3d, x2d, w2d, camera, cost_fun, rng=None,
                with_pose_opt_plus=False, pose_init=None,
                normalize_override=None, **kwargs):
        """Solve, optionally followed by one differentiable GN plus-step.

        Returns ``(pose_opt, pose_cov, cost, pose_opt_plus)``.
        """
        normalize = normalize_override if isinstance(normalize_override, bool) \
            else self.normalize
        if normalize:
            transform, x3d, pose_init = pnp_normalize(
                x3d, pose_init, detach_transformation=True)

        pose_opt, pose_cov, cost = self.solve(
            x3d, x2d, w2d, camera, cost_fun, rng=rng, pose_init=pose_init,
            **kwargs)
        pose_opt_plus = None
        if with_pose_opt_plus:
            step = self.gn_step(x3d, x2d, w2d, pose_opt, camera, cost_fun)
            pose_opt_plus = self.pose_add(pose_opt, step, camera)

        if normalize:
            pose_opt = pnp_denormalize(transform, pose_opt)
            if pose_cov is not None:
                raise NotImplementedError(
                    'pose covariance cannot be requested together with '
                    'point normalization — solve with normalize=False')
            if pose_opt_plus is not None:
                pose_opt_plus = pnp_denormalize(transform, pose_opt_plus)
        return pose_opt, pose_cov, cost, pose_opt_plus

    @torch.no_grad()
    def solve(self, x3d, x2d, w2d, camera, cost_fun, rng=None, pose_init=None,
              cost_init=None, with_pose_cov=False, with_cost=False,
              force_init_solve=False, fast_mode=False):
        """Non-differentiable batched solve.

        Args:
            x3d/x2d/w2d: (num_obj, num_pts, {3,2,2}).
            rng: ``torch.Generator`` for the init solver (optional).
            pose_init: (num_obj, 4 or 7) or None.

        Returns:
            (pose_opt, pose_cov | None, cost | None).
        """
        pose_opt = self._initial_pose(
            x3d, x2d, w2d, camera, cost_fun, rng, pose_init, cost_init,
            force_init_solve, fast_mode)
        if self.use_pallas:
            return self._solve_kernel(x3d, x2d, w2d, camera, cost_fun,
                                      pose_opt, with_pose_cov, with_cost,
                                      fast_mode)

        def evaluate_fun(pose, out_jacobian=False, out_residual=False,
                         out_cost=False):
            return evaluate_pnp(
                x3d, x2d, w2d, pose, camera, cost_fun,
                out_jacobian=out_jacobian, out_residual=out_residual,
                out_cost=out_cost, clip_jac=not fast_mode)

        num_obj = x2d.shape[0]
        if fast_mode:
            # Pure Gauss-Newton, no trust region. The JtJ/cost after the
            # loop are those evaluated at the pose BEFORE the final update.
            pose = pose_opt.to(x3d.dtype)
            jtj = x3d.new_zeros((num_obj, self.dof, self.dof))
            cost = x3d.new_zeros((num_obj,))
            for _ in range(self.num_iter):
                ev = evaluate_fun(pose, out_jacobian=True, out_residual=True,
                                  out_cost=True)
                jtj = _jtj_damped_const(ev.jacobian, self.eps)
                gradient = torch.einsum('...ji,...j->...i', ev.jacobian,
                                        ev.residual)
                step = -solve_spd_small(jtj, gradient)
                pose = self.pose_add(pose, step, camera)
                cost = ev.cost
            pose_cov = inv_spd_small(jtj) if with_pose_cov else None
            return pose, pose_cov, (cost if with_cost else None)

        # ---- full LM with trust region ----
        ev = evaluate_fun(pose_opt, out_jacobian=True, out_residual=True,
                          out_cost=True)
        pose, jac, residual, cost = (pose_opt.to(ev.cost.dtype), ev.jacobian,
                                     ev.residual, ev.cost)
        radius = torch.full_like(cost, self.initial_trust_region_radius)
        decrease_factor = torch.full_like(cost, 2.0)
        for _ in range(self.num_iter):
            jac_t = jac.transpose(-1, -2)
            jtj = jac_t @ jac
            # LM damping: diag += clamp(diag)/radius + eps
            diag = _diagonal(jtj)
            jtj_lm = _add_diagonal(jtj, torch.clamp(
                diag, self.min_lm_diagonal, self.max_lm_diagonal
            ) / radius[..., None] + self.eps)
            gradient = torch.einsum('...ij,...j->...i', jac_t, residual)
            step = -solve_spd_small(jtj_lm, gradient)

            pose_new = self.pose_add(pose, step, camera)
            ev = evaluate_fun(pose_new, out_jacobian=True, out_residual=True,
                              out_cost=True)

            model_cost_change = -torch.einsum(
                '...i,...i->...', step,
                torch.einsum('...ij,...j->...i', jtj, step) / 2 + gradient)
            relative_decrease = (cost - ev.cost) / model_cost_change
            success = (relative_decrease >= self.min_relative_decrease) \
                & (model_cost_change > 0.0)

            # accept/reject, in the reference's update order
            pose = torch.where(success[..., None], pose_new, pose)
            jac = torch.where(success[..., None, None], ev.jacobian, jac)
            residual = torch.where(success[..., None], ev.residual, residual)
            cost = torch.where(success, ev.cost, cost)
            radius_success = radius / torch.clamp(
                1.0 - (2.0 * relative_decrease - 1.0) ** 3, min=1.0 / 3.0)
            radius = torch.where(success, radius_success, radius)
            radius = torch.clamp(radius, self.eps,
                                 self.max_trust_region_radius)
            radius = torch.where(success, radius, radius / decrease_factor)
            decrease_factor = torch.where(
                success, torch.full_like(decrease_factor, 2.0),
                decrease_factor * 2.0)

        pose_cov = None
        if with_pose_cov:
            pose_cov = inv_spd_small(_jtj_damped_const(jac, self.eps))
        return pose, pose_cov, (cost if with_cost else None)

    def _initial_pose(self, x3d, x2d, w2d, camera, cost_fun, rng, pose_init,
                      cost_init, force_init_solve, fast_mode):
        """``pose_init``, the init solver's pose, or the better of the two."""
        if pose_init is not None and not force_init_solve:
            return pose_init
        assert self.init_solver is not None
        rng = _generator(rng, x3d.device)
        if pose_init is None:
            pose_opt, _, _ = self.init_solver.solve(
                x3d, x2d, w2d, camera, cost_fun, rng=rng, fast_mode=fast_mode)
            return pose_opt
        if cost_init is None:
            cost_init = evaluate_pnp(x3d, x2d, w2d, pose_init, camera,
                                     cost_fun, out_cost=True).cost
        pose_init_solve, _, cost_init_solve = self.init_solver.solve(
            x3d, x2d, w2d, camera, cost_fun, rng=rng, with_cost=True,
            fast_mode=fast_mode)
        use_init = cost_init < cost_init_solve
        return torch.where(use_init[..., None], pose_init, pose_init_solve)

    def _solve_kernel(self, x3d, x2d, w2d, camera, cost_fun, pose_opt,
                      with_pose_cov, with_cost, fast_mode):
        """Fused-kernel path (K1; see lm_kernel.py for its scope)."""
        from .lm_kernel import lm_solve
        num_obj = x2d.shape[0]
        cam4, bounds = _kernel_camera(camera, num_obj, x2d)
        out = lm_solve(
            x3d.contiguous(), x2d.contiguous(), w2d.contiguous(), cam4,
            cost_fun.delta_per_object(num_obj, x2d),
            pose_opt.to(x2d.dtype).contiguous(), bounds=bounds, dof=self.dof,
            num_iter=self.num_iter, fast_mode=fast_mode, z_min=camera.z_min,
            with_jtj=with_pose_cov, **self._lm_params())
        pose, cost = out[0], out[1]
        pose_cov = None
        if with_pose_cov:
            pose_cov = inv_spd_small(_add_diagonal(
                out[2], torch.full_like(_diagonal(out[2]), self.eps)))
        return pose, pose_cov, (cost if with_cost else None)

    def gn_step(self, x3d, x2d, w2d, pose, camera, cost_fun):
        """One differentiable Gauss-Newton step at ``pose`` (full f32
        matmuls and an LU solve, as in the JAX package)."""
        ev = evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                          out_jacobian=True, out_residual=True)
        jac_t = ev.jacobian.transpose(-1, -2)
        jtj = jac_t @ ev.jacobian + torch.eye(
            self.dof, dtype=x2d.dtype, device=x2d.device) * self.eps
        gradient = torch.einsum('...ij,...j->...i', jac_t, ev.residual)
        return -torch.linalg.solve(jtj, gradient[..., None])[..., 0]

    def pose_add(self, pose_opt, step, camera):
        """Tangent-space pose update."""
        if self.dof == 4:
            return pose_opt + step
        t_new = pose_opt[..., :3] + step[..., :3]
        q = pose_opt[..., 3:]
        q_delta = torch.einsum(
            '...ij,...j->...i',
            camera.get_quaternion_transfrom_mat(q), step[..., 3:])
        q_new = q + q_delta
        # F.normalize semantics: x / max(||x||, 1e-12)
        q_new = q_new / torch.clamp(
            torch.linalg.vector_norm(q_new, dim=-1, keepdim=True), min=1e-12)
        return torch.cat([t_new, q_new], -1)


@dataclasses.dataclass(frozen=True)
class RSLMSolver(LMSolver):
    """Random Sample LM solver (RANSAC generalisation) for initialisation.

    Draws ``num_proposals`` weighted subsets of ``num_points``
    correspondences, solves each with a short LM run from a randomised pose,
    and keeps the per-object proposal with minimal cost.
    """

    num_points: int = 16
    num_proposals: int = 64
    num_iter: int = 3
    # Inverse-CDF sampling WITH replacement instead of the reference's
    # multinomial without replacement (Gumbel top-k). It is also the
    # sampler of the fused init kernel K2.
    fast_sampling: bool = False
    # Fused-kernel only: rank proposals on a strided subsample of this many
    # points (multiple of 128) instead of the full set. When the caller asks
    # for the init cost (with_cost=True), the winner is re-evaluated on the
    # FULL set. None = full-set ranking.
    score_points: Optional[int] = 128

    def center_based_init(self, x2d, x3d, camera, eps: float = 1e-6):
        """Translation init matching the 2D/3D point spreads."""
        x2dh = torch.cat([x2d, torch.ones_like(x2d[..., :1])], -1)
        x2dc = solve_3x3(camera.cam_mats, x2dh.transpose(-1, -2)
                         ).transpose(-1, -2)
        x2dc = x2dc[..., :2] / torch.clamp(x2dc[..., 2:], min=eps)
        x2dc_mean = x2dc.mean(-2)
        x2dc_std = x2dc.std(-2)      # unbiased, as jnp.std(ddof=1)
        x3d_std = x3d.std(-2)
        if self.dof == 4:
            scale = x3d_std[..., 1] / torch.clamp(x2dc_std[..., 1], min=eps)
        else:
            scale = math.sqrt(2 / 3) * torch.linalg.vector_norm(x3d_std, dim=-1) \
                / torch.clamp(torch.linalg.vector_norm(x2dc_std, dim=-1),
                              min=eps)
        x2dch = torch.cat([x2dc_mean, torch.ones_like(x2dc_mean[..., :1])], -1)
        return x2dch * scale[..., None]

    def kernel_applies(self, num_obj: int, num_pts: int) -> bool:
        """The fused-init gate of the JAX package, kept exactly.

        ``128 % num_points == 0`` and ``N % 128 == 0`` are the TPU packed
        layout's rules; B * proposals >= 512 is a crossover measured on
        the TPU. Keeping them keeps the sampler semantics (with or without
        replacement) identical in both packages for the same inputs.
        """
        packed_ok = (self.num_points <= 128
                     and 128 % self.num_points == 0
                     and num_pts % 128 == 0)
        big_enough = num_obj * self.num_proposals >= 512
        return (self.use_pallas and self.fast_sampling and big_enough
                and packed_ok)

    @torch.no_grad()
    def solve(self, x3d, x2d, w2d, camera, cost_fun, rng=None, **kwargs):
        gen = _generator(rng, x3d.device)
        bs, pn, _ = x2d.shape
        if self.kernel_applies(bs, pn):
            return self._solve_kernel_init(x3d, x2d, w2d, camera, cost_fun,
                                           gen, kwargs.get('with_cost'))
        p = self.num_proposals

        mean_weight = w2d.mean(-1)  # (bs, pn)
        if self.fast_sampling:
            # inverse-CDF sampling (with replacement)
            cdf = torch.cumsum(mean_weight, -1)
            u = _rand((bs, p * self.num_points), gen, x2d) * cdf[:, -1:]
            inds = torch.searchsorted(cdf, u).clamp(max=pn - 1)
            inds = inds.reshape(bs, p, self.num_points).transpose(0, 1)
        else:
            # weighted subset sampling without replacement (Gumbel top-k)
            logits = torch.log(torch.clamp(mean_weight, min=1e-30))
            uni = _rand((p, bs, pn), gen, x2d)
            tiny = torch.finfo(x2d.dtype).tiny
            gumbel = -torch.log(-torch.log(torch.clamp(uni, min=tiny)))
            inds = torch.topk(logits[None] + gumbel, self.num_points,
                              dim=-1).indices
        # (p, bs, num_points, c) gathers, without broadcasting the source
        b_inds = torch.arange(bs, device=x2d.device)[None, :, None]
        x2d_samples = x2d[b_inds, inds]
        x3d_samples = x3d[b_inds, inds]
        w2d_samples = w2d[b_inds, inds]

        t_init = self.center_based_init(x2d, x3d, camera).expand(p, bs, 3)
        if self.dof == 4:
            yaw = _rand((p, bs, 1), gen, x2d) * (2 * math.pi)
            pose_init = torch.cat([t_init, yaw], -1)
        else:
            quat = _rand((p, bs, 4), gen, x2d, normal=True)
            q_norm = torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
            ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=x2d.dtype,
                                 device=x2d.device)
            quat = torch.where(q_norm < self.eps, ident,
                               quat / torch.clamp(q_norm, min=1e-30))
            pose_init = torch.cat([t_init, quat], -1)

        camera_expand = camera.broadcast_to_batch((bs,)).tile(p)
        cost_fun_expand = cost_fun.broadcast_to_batch((bs,)).tile(p)
        pose, _, _ = LMSolver.solve(
            self,
            x3d_samples.reshape(p * bs, self.num_points, 3),
            x2d_samples.reshape(p * bs, self.num_points, 2),
            w2d_samples.reshape(p * bs, self.num_points, 2),
            camera_expand, cost_fun_expand,
            pose_init=pose_init.reshape(p * bs, pose_init.shape[-1]),
            **kwargs)
        pose = pose.reshape(p, bs, pose.shape[-1])

        # score all proposals on the full point set; keep the best
        cost = evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                            out_cost=True).cost
        min_cost, min_cost_ind = torch.min(cost, 0)
        pose = torch.take_along_dim(pose, min_cost_ind[None, :, None], 0)[0]
        return pose, None, min_cost

    def _solve_kernel_init(self, x3d, x2d, w2d, camera, cost_fun, gen,
                           with_cost):
        """Fully fused init (K2): sampling + proposal LM + scoring."""
        from .rslm_kernel import rslm_init
        bs = x2d.shape[0]
        seeds = torch.randint(0, 2 ** 31 - 1, (bs,), generator=gen,
                              device=gen.device, dtype=torch.int32
                              ).to(x2d.device)
        cam4, bounds = _kernel_camera(camera, bs, x2d)
        pose, min_cost = rslm_init(
            x3d.contiguous(), x2d.contiguous(), w2d.contiguous(), cam4,
            cost_fun.delta_per_object(bs, x2d), seeds, bounds=bounds,
            dof=self.dof, num_points=self.num_points,
            num_proposals=self.num_proposals, num_iter=self.num_iter,
            z_min=camera.z_min, score_points=self.score_points,
            **self._lm_params())
        subsampled = (self.score_points is not None
                      and self.score_points < x2d.shape[1])
        if with_cost and subsampled:
            # the kernel ranked on a subsample; callers compare this cost
            # against full-set costs, so re-evaluate the winner
            min_cost = evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                                    out_cost=True).cost
        return pose, None, min_cost
