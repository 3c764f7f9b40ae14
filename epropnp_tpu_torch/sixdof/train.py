"""6DoF batch layout, correspondence construction and the training step
(PyTorch).

Counterpart of ``epropnp_tpu/sixdof/train.py``: CDPN forward ->
correspondences (x3d = noc * dim, x2d on the crop grid, legacy-softmax
w2d) -> AMIS Monte Carlo PnP -> the five losses -> RMSprop with the
non-finite-gradient skip. With ``cfg.pnp.use_pallas`` the PnP solves run
through K1 (the init's proposals and the main solve, both trust region
with the crop's projection bounds, the main solve with its JtJ). With
``network.bf16_backbone`` the CDPN's ResNet computes in bf16 (f32
parameters, no loss scaling); with ``network.remat`` its forward runs
again in the backward (``models.norm.checkpoint``).

The optimizer is :class:`RMSprop`, the update of ``optax.rmsprop`` that the
JAX package uses (eps inside the square root, ``nu`` starting at 0), not
``torch.optim.RMSprop``. Data-parallel training
(``make_train_step(data_parallel=True)``) averages over the replicas what
JAX's ``shard_map`` step averages with ``pmean``: the gradients, the
BatchNorm statistics and the Monte Carlo loss's ``norm_factor``
(``parallel.mesh``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..models.cdpn import CDPN
from ..models.losses.monte_carlo_pose_loss import (
    MonteCarloPoseLossState,
    monte_carlo_pose_loss,
)
from ..models.norm import checkpoint
from ..ops.pnp import (
    AdaptiveHuberPnPCost,
    EProPnP6DoF,
    LMSolver,
    PerspectiveCamera,
    RSLMSolver,
)
from ..ops.rotation_conversions import matrix_to_quaternion
from ..parallel.mesh import mean_buffers, mean_gradients
from ..utils.optim import OptaxOptimizer, all_finite, global_norm
from .config import SixDoFConfig


class Batch(NamedTuple):
    """One batch (tensors on one device, NHWC images)."""
    inp: torch.Tensor          # (bs, 256, 256, 3) normalized rgb crop
    target_coor: torch.Tensor  # (bs, 64, 64, 3) GT noc maps
    loss_msk: torch.Tensor     # (bs, 64, 64, 3) coord-loss mask
    trans_local: torch.Tensor  # (bs, 3) trans-head target [cx_delta, cy_delta, d]
    pose: torch.Tensor         # (bs, 3, 4) GT [R|t]
    c_box: torch.Tensor        # (bs, 2) crop center
    s_box: torch.Tensor        # (bs,) crop scale
    dim: torch.Tensor          # (bs, 3) per-class |min extents|


def build_correspondences(noc, w2d, scale, batch: Batch, cam_intrinsic,
                          out_res: int, sample_inds=None):
    """Dense maps -> (x3d, x2d, w2d) point sets + camera bounds.

    ``noc`` (bs, h, w, 3) and ``w2d`` (bs, h, w, 2) are NHWC;
    ``sample_inds`` (bs, k) selects a point subset (None keeps all
    out_res^2 points, the test path). Returns ``(x3d (bs, n, 3),
    x2d (bs, n, 2), w2d (bs, n, 2), camera)``.
    """
    bs = noc.shape[0]
    if noc.shape[1] != out_res or noc.shape[2] != out_res:
        raise ValueError(
            f'dense map resolution {tuple(noc.shape[1:3])} != cfg '
            f'out_res={out_res}; check DataIterConfig.inp_res/out_res '
            'against the batch images')
    x3d = noc * batch.dim[:, None, None, :]                    # (bs, h, w, 3)

    s = torch.floor(batch.s_box)  # the reference casts to int64
    wh_begin = batch.c_box - s[:, None] / 2.0                  # (bs, 2)
    wh_unit = s / out_res                                      # (bs,)

    wh_arange = torch.arange(out_res, dtype=noc.dtype, device=noc.device)
    y, x = torch.meshgrid(wh_arange, wh_arange, indexing='ij')
    x2d = torch.stack(
        [wh_begin[:, 0, None, None] + x * wh_unit[:, None, None],
         wh_begin[:, 1, None, None] + y * wh_unit[:, None, None]],
        -1)                                                    # (bs, h, w, 2)

    n = out_res * out_res
    x3d = x3d.reshape(bs, n, 3)
    x2d = x2d.reshape(bs, n, 2)
    w2d = w2d.reshape(bs, n, 2)
    if sample_inds is not None:
        take = lambda a: torch.take_along_dim(  # noqa: E731
            a, sample_inds[..., None], 1)
        x3d, x2d, w2d = take(x3d), take(x2d), take(w2d)
        n = sample_inds.shape[1]

    # legacy softmax: exp(w2d - mean - log N) * scale
    w2d = torch.exp(w2d - w2d.mean(1, keepdim=True) - math.log(n)) \
        * scale[:, None, :]

    allowed_border = 30.0 * wh_unit
    camera = PerspectiveCamera(
        cam_mats=torch.as_tensor(cam_intrinsic, dtype=noc.dtype,
                                 device=noc.device).expand(bs, 3, 3),
        z_min=0.01,
        lb=wh_begin - allowed_border[:, None],
        ub=wh_begin + (out_res - 1) * wh_unit[:, None]
        + allowed_border[:, None])
    return x3d, x2d, w2d, camera


def build_epropnp(cfg: SixDoFConfig) -> EProPnP6DoF:
    """The training PnP stack (reference lib/train.py:47-57)."""
    p = cfg.pnp
    return EProPnP6DoF(
        mc_samples=p.mc_samples, num_iter=p.num_iter,
        solver=LMSolver(
            dof=6, num_iter=p.lm_num_iter, use_pallas=p.use_pallas,
            init_solver=RSLMSolver(
                dof=6, num_points=p.rs_num_points,
                num_proposals=p.rs_num_proposals, num_iter=p.rs_num_iter,
                use_pallas=p.use_pallas, fast_sampling=p.use_pallas)))


# --------------------------------------------------------------- optimizer

class RMSprop(OptaxOptimizer):
    """``optax.inject_hyperparams(optax.rmsprop)`` per parameter group,
    optionally after ``optax.clip_by_global_norm`` over all groups.

    Per element: ``nu = decay nu + (1 - decay) g^2`` (``nu`` starts at 0),
    ``u = -lr(count) g / sqrt(nu + eps)``, then the momentum trace
    ``t = u + momentum t`` (identity at momentum 0), with the step decay of
    :meth:`OptaxOptimizer.learning_rate`.
    """

    def __init__(self, param_groups, decay: float = 0.99, eps: float = 1e-8,
                 momentum: float = 0.0, lr_boundaries=(),
                 lr_factor: float = 0.1,
                 clip_grad_norm: Optional[float] = None):
        super().__init__(param_groups, dict(
            lr=1e-4, decay=decay, eps=eps, momentum=momentum,
            lr_boundaries=tuple(lr_boundaries), lr_factor=lr_factor),
            clip_grad_norm)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError('RMSprop.step takes no closure')
        it = iter(self.clipped_grads())
        for group in self.param_groups:
            lr, decay = self.learning_rate(group), group['decay']
            for p in group['params']:
                g = next(it)
                state = self.state[p]
                if not state:
                    state['nu'] = torch.zeros_like(p)
                    if group['momentum']:
                        state['trace'] = torch.zeros_like(p)
                nu = state['nu']
                nu.mul_(decay).add_(g.square(), alpha=1.0 - decay)
                update = g * torch.rsqrt(nu + group['eps']) * (-lr)
                if group['momentum']:
                    update = state['trace'].mul_(group['momentum']).add_(
                        update)
                p.add_(update)
            group['count'] += 1


def make_optimizer(cfg: SixDoFConfig, model: CDPN,
                   steps_per_epoch: int = 1) -> RMSprop:
    """RMSprop with one learning rate per branch (backbone, rot head, trans
    head) and the step decay at ``lr_epoch_step`` epochs (reference
    lib/model.py:35-105 and tools/main.py)."""
    t = cfg.train
    groups = [dict(params=list(module.parameters()), lr=lr)
              for module, lr in ((model.backbone, t.lr_backbone),
                                 (model.rot_head_net, t.lr_rot_head),
                                 (model.trans_head_net, t.lr_trans_head))]
    return RMSprop(groups, decay=t.alpha, eps=t.epsilon, momentum=t.momentum,
                   lr_boundaries=[e * steps_per_epoch
                                  for e in t.lr_epoch_step],
                   lr_factor=t.lr_factor, clip_grad_norm=t.clip_grad_norm)


# ------------------------------------------------------------ train state

class TrainState(nn.Module):
    """The model (parameters and BatchNorm statistics), the Monte Carlo
    loss's ``norm_factor`` and the step count as buffers, and the
    optimizer. ``state_dict()`` covers the first three; a checkpoint adds
    ``tx.state_dict()``."""

    def __init__(self, model: CDPN, tx: RMSprop):
        super().__init__()
        self.model = model
        self.tx = tx
        like = next(model.parameters())
        self.register_buffer('norm_factor', like.new_ones(()))
        self.register_buffer('step', torch.zeros((), dtype=torch.int64,
                                                 device=like.device))

    @property
    def mc_state(self) -> MonteCarloPoseLossState:
        return MonteCarloPoseLossState(norm_factor=self.norm_factor)


def pose_gt_from_batch(batch: Batch) -> torch.Tensor:
    """(bs, 3, 4) [R|t] -> (bs, 7) [t, q]."""
    return torch.cat([batch.pose[:, :, 3],
                      matrix_to_quaternion(batch.pose[:, :, :3])], -1)


def sample_point_indices(bs: int, n_dense: int, num: int,
                         gen: torch.Generator, device) -> torch.Tensor:
    """(bs, num) indices into the dense map, each row drawn without
    replacement (a random permutation's first ``num`` entries)."""
    u = torch.rand((bs, n_dense), generator=gen, device=gen.device)
    return torch.argsort(u, -1)[:, :num].to(device)


class LossOutputs(NamedTuple):
    loss: torch.Tensor
    loss_rot: torch.Tensor
    loss_trans: torch.Tensor
    loss_mc: torch.Tensor
    loss_t: torch.Tensor
    loss_r: torch.Tensor
    norm_factor: torch.Tensor


def compute_losses(model: CDPN, epropnp: EProPnP6DoF, cfg: SixDoFConfig,
                   batch: Batch, cam_intrinsic, gen: torch.Generator,
                   mc_state: MonteCarloPoseLossState,
                   data_parallel: bool = False):
    """Forward + all 6DoF losses (reference lib/train.py:136-204) with the
    model in its current mode; with ``data_parallel`` (JAX's
    ``axis_name``) the Monte Carlo loss's ``norm_factor`` is averaged over
    the replicas. Returns ``(loss, aux, new_mc_state)``."""
    # recompute the CDPN activations in the backward (NetworkConfig.remat,
    # JAX sixdof/train.py:206-208)
    outs = checkpoint(model, model, batch.inp) if cfg.network.remat \
        else model(batch.inp)
    bs = batch.inp.shape[0]
    out_res = cfg.dataiter.out_res
    # random 1/8 point subsample (lib/train.py:157-162)
    sample_inds = sample_point_indices(bs, out_res * out_res,
                                       cfg.dataiter.sample_points, gen,
                                       batch.inp.device)
    scale = outs.scale
    if cfg.train.w2d_scale_max is not None:
        # soft cap keeps the gradient alive (see config.w2d_scale_max)
        scale = torch.clamp(scale, max=cfg.train.w2d_scale_max)
    x3d, x2d, w2d, camera = build_correspondences(
        outs.noc, outs.w2d, scale, batch, cam_intrinsic, out_res,
        sample_inds)
    pose_gt = pose_gt_from_batch(batch)

    cost_fun = AdaptiveHuberPnPCost(
        relative_delta=cfg.pnp.relative_delta).set_param(x2d, w2d)
    _, _, pose_opt_plus, _, pose_sample_logweights, cost_tgt = \
        epropnp.monte_carlo_forward(
            x3d, x2d, w2d, camera, cost_fun, rng=gen, pose_init=pose_gt,
            force_init_solve=True, with_pose_opt_plus=True)

    # Monte Carlo loss (lib/train.py:182-183); norm_factor = mean scale
    loss_mc, new_mc_state = monte_carlo_pose_loss(
        pose_sample_logweights, cost_tgt, scale.detach().mean(), mc_state,
        momentum=0.01, training=True, data_parallel=data_parallel)

    # derivative regularization (lib/train.py:185-193)
    dist_t = torch.linalg.vector_norm(pose_opt_plus[:, :3] - pose_gt[:, :3],
                                      dim=-1)
    beta = 0.05
    loss_t = torch.where(dist_t < beta, 0.5 * dist_t.square() / beta,
                         dist_t - 0.5 * beta).mean()
    dot_quat = (pose_opt_plus[:, 3:] * pose_gt[:, 3:]).sum(-1)
    loss_r = ((1.0 - dot_quat.square()) * 2.0).mean()

    # masked L1 coordinate regression (lib/train.py:195-196)
    loss_rot = torch.abs(batch.loss_msk * outs.noc
                         - batch.loss_msk * batch.target_coor).mean()
    # trans head L2 (lib/train.py:203-204; MSELoss = mean square)
    loss_trans = (outs.trans - batch.trans_local).square().mean()

    w = cfg.loss
    loss = (w.rot_loss_weight * loss_rot + w.trans_loss_weight * loss_trans
            + w.mc_loss_weight * loss_mc + w.t_loss_weight * loss_t
            + w.r_loss_weight * loss_r)
    aux = LossOutputs(loss, loss_rot, loss_trans, loss_mc, loss_t, loss_r,
                      new_mc_state.norm_factor)
    return loss, aux, new_mc_state


def make_train_step(epropnp: EProPnP6DoF, cfg: SixDoFConfig, cam_intrinsic,
                    data_parallel: bool = False):
    """The train step ``step(state, batch, gen) -> metrics``.

    It updates ``state`` in place: the BatchNorm statistics, the Monte
    Carlo ``norm_factor`` and the step count always; the parameters and
    the optimizer state only when every gradient is finite (the
    reference's NaN skip, lib/train.py:232-243; per-leaf finiteness, not
    that of the norm, whose sum of squares can overflow). ``metrics``
    holds the loss components, ``grad_norm`` and ``skipped`` (0 or 1) as
    tensors.

    With ``data_parallel`` (a ``torch.distributed`` group is up) ``batch``
    is this replica's rows; after the backward the gradients and the
    BatchNorm statistics are averaged over the replicas before the
    finiteness check (JAX ``sixdof/train.py:286-288``), so every replica
    takes the same decision and the same update. The metrics are this
    replica's.
    """

    def train_step(state: TrainState, batch: Batch, gen: torch.Generator):
        state.model.train()
        state.tx.zero_grad(set_to_none=True)
        loss, aux, new_mc_state = compute_losses(
            state.model, epropnp, cfg, batch, cam_intrinsic, gen,
            state.mc_state, data_parallel)
        loss.backward()
        if data_parallel:
            mean_gradients(state.model.parameters())
            mean_buffers(state.model)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in state.model.parameters()]
        ok = bool(all_finite(grads))  # one host sync per step
        if ok:
            state.tx.step()
        with torch.no_grad():
            state.norm_factor.copy_(new_mc_state.norm_factor)
            state.step.add_(1)
        metrics = {k: v.detach() for k, v in aux._asdict().items()}
        metrics['grad_norm'] = global_norm(grads).detach()
        metrics['skipped'] = torch.tensor(0 if ok else 1)
        return metrics

    return train_step

