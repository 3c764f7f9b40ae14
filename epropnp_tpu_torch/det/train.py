"""The Det-suite training step (PyTorch), counterpart of
``epropnp_tpu/det/train.py``.

One step runs the backbone, FPN and FCOS forward, the VolumeCenter targets
and the FCOS losses, importance object sampling, the deformable
correspondence subheads, the Monte Carlo pose loss (AMIS), the 3D-score
and derivative-regularisation losses of a deterministic solve, the
auxiliary dense RoI reprojection and coordinate-regression losses, the
velocity and attribute losses, and the AdamW update with the gradient
clip and the non-finite-gradient skip.

With ``cfg.pnp.use_pallas`` on CUDA tensors the solves run through K2
(the RSLM inits of the Monte Carlo forward and of the score solve, with
the camera's projection bounds) and K1 (the trust-region solves with
bounds, the first with its JtJ), and every DCN through K3 with its
backward (``ops.dcn_kernel.DCNFunction``). The model's options train as
the JAX package trains them: a bf16 backbone and dense stage with f32
parameters and no loss scaling, the level-packed towers, and
``remat_dense``, which recomputes the dense forward in the backward
(``models.norm.checkpoint``). Data-parallel training
(``make_train_step(data_parallel=True)``, ``parallel.mesh``) averages
what JAX's ``shard_map`` step averages with ``pmean``. The optimizer is
:class:`AdamW`, the update of the JAX package's optax chain.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.bbox_3d.center_target import VolumeCenter
from ..core.bbox_3d.coders import DistDimProjErrorCoder, MultiClassLogDimCoder
from ..core.bbox_3d.misc import project_to_image
from ..models.dense_heads.deform_pnp_head import HeadEMAState, obj_sampler
from ..models.losses.det_losses import (
    cosine_angle_loss,
    mvd_gaussian_mixture_nll_loss,
    smooth_l1_loss_mod,
    weight_reduce_loss,
)
from ..models.losses.monte_carlo_pose_loss import (
    MonteCarloPoseLossState,
    monte_carlo_pose_loss,
)
from ..models.norm import checkpoint
from ..ops.inter_roi_ops import logsoftmax_across_rois
from ..ops.pnp import (
    AdaptiveHuberPnPCost,
    EProPnP4DoF,
    LMSolver,
    PerspectiveCamera,
    RSLMSolver,
)
from ..parallel.mesh import mean_buffers, mean_gradients, replica_mean
from ..utils.optim import OptaxOptimizer, all_finite, global_norm
from .config import DetConfig


class DetBatch(NamedTuple):
    """Fixed-shape training batch (G = max GT per image, P = lidar points),
    NHWC images."""
    img: torch.Tensor                 # (n, H, W, 3)
    cam_intrinsic: torch.Tensor       # (n, 3, 3)
    img_shapes: torch.Tensor          # (n, 2) augmented [h, w]
    ori_shapes: torch.Tensor          # (n, 2)
    img_flips: torch.Tensor           # (n,) bool
    img_dense_x2d: torch.Tensor       # (n, H, W, 2)
    img_dense_x2d_mask: torch.Tensor  # (n, H, W, 1)
    gt_bboxes: torch.Tensor           # (n, G, 4)
    gt_bboxes_3d: torch.Tensor        # (n, G, 7) [l, h, w, x, y, z, ry]
    gt_labels: torch.Tensor           # (n, G) int
    gt_mask: torch.Tensor             # (n, G) bool
    gt_velo: torch.Tensor             # (n, G, 2)
    gt_attr: torch.Tensor             # (n, G) int
    gt_x3d: Optional[torch.Tensor] = None       # (n, G, P, 3)
    gt_x2d: Optional[torch.Tensor] = None       # (n, G, P, 2)
    gt_pts_mask: Optional[torch.Tensor] = None  # (n, G, P) bool


def build_pnp(cfg: DetConfig) -> EProPnP4DoF:
    p = cfg.pnp
    return EProPnP4DoF(
        mc_samples=p.mc_samples, num_iter=p.num_iter, normalize=p.normalize,
        solver=LMSolver(
            dof=4, num_iter=p.lm_num_iter, normalize=p.normalize,
            use_pallas=p.use_pallas,
            init_solver=RSLMSolver(
                dof=4, num_points=p.rs_num_points,
                num_proposals=p.rs_num_proposals, num_iter=p.rs_num_iter,
                use_pallas=p.use_pallas, fast_sampling=p.use_pallas)))


def avg_pool_stride(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(n, h, w, c) -> (n, h / stride, w / stride, c) block means."""
    n, h, w, c = x.shape
    return x.reshape(n, h // stride, stride, w // stride, stride, c).mean(
        (2, 4))


def compute_losses(model, cfg: DetConfig, batch: DetBatch,
                   ema: HeadEMAState, gen: torch.Generator,
                   data_parallel: bool = False):
    """Forward and every loss of a step, with ``model`` in its current mode
    (training mode moves the BatchNorm statistics). ``gen`` draws the
    object samples, the RSLM seeds and the AMIS proposals, in that order.
    With ``data_parallel`` (JAX's ``axis_name``) ``batch`` is this
    replica's rows, and every loss normaliser and EMA statistic is averaged
    over the replicas (``parallel.mesh.replica_mean``, differentiable as
    JAX's ``pmean``) where JAX averages it. Returns ``(total, losses,
    new_ema)``; ``losses`` holds every ``loss_*`` term, ``ate`` and the
    last stage's ``norm_factor``."""
    n_img, gmax = batch.gt_labels.shape
    g_total = n_img * gmax
    s_total = cfg.train.num_obj_samples_per_img * n_img
    dt, dev = batch.img.dtype, batch.img.device
    pnp = build_pnp(cfg)
    x2d_small = avg_pool_stride(batch.img_dense_x2d, cfg.output_stride)
    x2d_mask_small = avg_pool_stride(batch.img_dense_x2d_mask,
                                     cfg.output_stride)

    # ---- GT flattened over images, centre targets ----
    def flat(a):
        return a.reshape((g_total,) + a.shape[2:])

    gt_boxes_f = flat(batch.gt_bboxes)
    gt_b3d_f = flat(batch.gt_bboxes_3d)
    gt_labels_f = flat(batch.gt_labels).long()
    gt_img_inds = torch.arange(n_img, device=dev).repeat_interleave(gmax)
    gt_flips_f = batch.img_flips[gt_img_inds]
    ct = VolumeCenter(output_stride=cfg.output_stride).get_centers_2d(
        gt_boxes_f, gt_b3d_f, gt_img_inds, x2d_small, x2d_mask_small,
        batch.cam_intrinsic, obj_mask=flat(batch.gt_mask))
    centers2d_f, gt_valid_f = ct.centers_2d, ct.valid_mask
    # padded or invalid GT slots: zero-size boxes and zero dimensions would
    # give inf in ratios downstream, which survive masking as inf * 0
    gt_b3d_f = torch.where(gt_valid_f[:, None], gt_b3d_f, gt_b3d_f.new_tensor(
        [1., 1., 1., 0., 0., 10., 0.]))
    gt_boxes_f = torch.where(gt_valid_f[:, None], gt_boxes_f,
                             gt_boxes_f.new_tensor([0., 0., 8., 8.]))

    # ---- dense forward, FCOS targets and losses ----
    img_shape = (batch.img.shape[1], batch.img.shape[2])
    if cfg.remat_dense:
        # recompute the dense activations in the backward instead of
        # keeping them (JAX det/train.py:132-136; DetConfig.remat_dense)
        det_outs, key, value = checkpoint(model, model.det_dense,
                                          batch.img, img_shape)
    else:
        det_outs, key, value = model.det_dense(batch.img, img_shape)
    detector = model.bbox_head.detector
    labels, ctr_targets, gt_inds_local = detector.get_targets(
        [o.points for o in det_outs], batch.gt_bboxes, batch.gt_labels.long(),
        batch.gt_mask & gt_valid_f.reshape(n_img, gmax),
        centers2d_f.reshape(n_img, gmax, 2))

    def flat_map(per_lvl):
        return torch.cat([m.reshape(n_img, -1, m.shape[-1])
                          for m in per_lvl], 1).reshape(
                              -1, per_lvl[0].shape[-1])

    flat_cls = flat_map([o.cls_score for o in det_outs])
    flat_center = flat_map([o.center for o in det_outs])
    flat_ctr = flat_map([o.centerness for o in det_outs])[:, 0]
    flat_emb = flat_map([o.obj_emb for o in det_outs])
    flat_strides = torch.cat([
        torch.full((o.points.shape[0],), s, dtype=dt, device=dev)
        for o, s in zip(det_outs, detector.strides)]).repeat(n_img)
    flat_labels = labels.reshape(-1)
    flat_ctr_t = ctr_targets.reshape(-1)
    flat_gt_inds = (gt_inds_local + torch.arange(n_img, device=dev)[:, None]
                    * gmax).reshape(-1)
    losses = detector.loss(flat_cls, flat_center, flat_ctr, flat_labels,
                           flat_gt_inds, flat_ctr_t, centers2d_f, gt_boxes_f,
                           data_parallel=data_parallel)

    # ---- object sampling, subheads ----
    pt_inds, s_gt_inds, s_weights, s_uweights, s_valid = obj_sampler(
        gen, s_total, flat_labels < cfg.num_classes, flat_ctr_t,
        flat_gt_inds, g_total, uniform_mix_ratio=cfg.train.uniform_mix_ratio)
    s_img_inds = gt_img_inds[s_gt_inds]
    s_labels = gt_labels_f[s_gt_inds]
    s_b3d = gt_b3d_f[s_gt_inds]                                 # (S, 7)
    sub = model.subheads(
        flat_center[pt_inds], flat_emb[pt_inds], key, value, x2d_small,
        x2d_mask_small, flat_strides[pt_inds], s_img_inds, s_labels,
        batch.img_flips, batch.img_shapes)

    losses['loss_dim'] = smooth_l1_loss_mod(
        sub.dim_enc, MultiClassLogDimCoder().encode(s_b3d[:, :3], s_labels),
        beta=1.0, weight=s_weights[:, None], reduction='sum') \
        / (s_total * 3) * cfg.loss.dim

    # ---- Monte Carlo pose loss per stage ----
    camera = PerspectiveCamera.from_img_shape(
        batch.cam_intrinsic[s_img_inds], batch.ori_shapes[s_img_inds],
        z_min=0.1, allowed_border=200.0)
    norm_factor = (sub.scale * s_weights[:, None]).sum() \
        / max(sub.scale.shape[0] * 2, 1)
    pose_tgt = s_b3d[:, 3:]                                     # (S, 4)
    new_mc_states = []
    for stage_id, (noc, w2d) in enumerate(zip(sub.noc_list, sub.w2d_list)):
        w2d_scaled = w2d * sub.scale[:, None, :]
        cost_fun = AdaptiveHuberPnPCost(
            relative_delta=cfg.pnp.relative_delta).set_param(
            sub.x2d.detach(), w2d_scaled)
        _, _, _, _, logweights, cost_tgt = pnp.monte_carlo_forward(
            noc * sub.dim_dec[:, None], sub.x2d, w2d_scaled, camera,
            cost_fun, rng=gen, pose_init=pose_tgt, force_init_solve=True)
        loss_pose, new_mc = monte_carlo_pose_loss(
            logweights, cost_tgt, norm_factor, ema.pose_norm_factor[stage_id],
            momentum=0.01, training=True, data_parallel=data_parallel,
            weight=s_weights, avg_factor=float(s_total))
        new_mc_states.append(new_mc)
        losses[f'loss_pose_{stage_id}'] = loss_pose * cfg.loss.pose

    # ---- 3D score and derivative regularisation ----
    noc, w2d = sub.noc_list[-1], sub.w2d_list[-1]
    w2d_det = w2d * sub.scale.detach()[:, None, :]
    cost_fun_det = AdaptiveHuberPnPCost(
        relative_delta=cfg.pnp.relative_delta).set_param(
        sub.x2d.detach(), w2d_det)
    cost_fun_det = cost_fun_det.replace(delta=cost_fun_det.delta.detach())
    pose_opt, _, _, pose_opt_plus = pnp(
        noc * sub.dim_dec.detach()[:, None], sub.x2d, w2d_det, camera,
        cost_fun_det, rng=gen, with_pose_opt_plus=True)
    te = torch.linalg.vector_norm(pose_opt[:, [0, 2]] - s_b3d[:, [3, 5]],
                                  dim=1)
    losses['ate'] = (te * s_weights).sum() / torch.clamp(
        s_valid.sum(), min=1)
    score_targets = torch.clamp(
        (-torch.log2(torch.clamp(te, min=1e-12)) + 2.5) / 4.0, 0.0,
        1.0).detach()
    bce = (F.softplus(-sub.score_pred) * score_targets
           + F.softplus(sub.score_pred) * (1.0 - score_targets))
    losses['loss_score'] = weight_reduce_loss(
        bce, s_uweights, 'sum') / s_total * cfg.loss.score
    losses['loss_reg_pos'] = smooth_l1_loss_mod(
        torch.linalg.vector_norm(pose_opt_plus[:, :3] - s_b3d[:, 3:6],
                                 dim=-1), -1,
        beta=cfg.loss.reg_pos_beta, weight=s_weights, reduction='sum') \
        / s_total * cfg.loss.reg_pos
    losses['loss_reg_orient'] = cosine_angle_loss(
        pose_opt_plus[:, 3], s_b3d[:, 6], weight=s_weights,
        reduction='sum') / s_total * cfg.loss.reg_orient

    # ---- auxiliary dense losses over the GT RoIs ----
    new_proj_ema = ema.proj_mean_inv_std
    rh, rw = cfg.train.roi_shape
    # active: GT slots that a valid sample refers to
    act_onehot = (s_gt_inds[:, None] == torch.arange(
        g_total, device=dev)[None, :]) & s_valid[:, None]        # (S, G)
    act_mask = act_onehot.any(0) & gt_valid_f
    num_act = act_mask.to(dt).sum()
    s2a = (act_onehot * s_weights[:, None]).T                  # (G, S)
    s2a = s2a / torch.clamp(s2a.sum(-1, keepdim=True), min=1e-12)

    x2d_roi, key_roi, value_roi = model.extract_rois(
        gt_img_inds, gt_boxes_f, batch.img_dense_x2d, key, value, (rh, rw))
    noc_roi, logstd_roi = model.roi_regr(value_roi, gt_flips_f)
    heads = noc_roi.shape[1]
    x3d_roi = noc_roi * (s2a @ sub.dim_dec).detach()[:, None, None, :]
    k_img = batch.cam_intrinsic[gt_img_inds]
    x2d_proj = project_to_image(
        x3d_roi.reshape(g_total, heads * rh * rw, 3), gt_b3d_f[:, 3:], k_img,
        batch.ori_shapes[gt_img_inds], z_min=0.5, allowed_border=200.0
    ).reshape(g_total, heads, rh * rw, 2)
    proj_error = DistDimProjErrorCoder().encode(
        x2d_proj - x2d_roi.reshape(g_total, 1, rh * rw, 2),
        gt_b3d_f[:, None, 5:6], gt_b3d_f[:, None, :3],
        k_img[:, 0, 0, None, None]).reshape(g_total, heads, rh, rw, 2)

    head_dim = cfg.embed_dims // heads
    query_act = (s2a @ sub.query.reshape(s_total, -1)).reshape(
        g_total, heads, 1, head_dim)
    attn = (query_act @ key_roi.reshape(
        g_total, rh * rw, heads, head_dim).permute(0, 2, 3, 1)).reshape(
        g_total, heads, rh, rw) / math.sqrt(head_dim)
    # inactive RoIs get ids of their own, so they never mix into the
    # active mixtures
    roi_ids_eff = torch.where(act_mask, gt_img_inds,
                              n_img + torch.arange(g_total, device=dev))
    attn_ls = logsoftmax_across_rois(                      # (G, heads, rh, rw)
        attn.movedim(1, -1), gt_boxes_f, roi_ids_eff,
        extra_axis=-1).movedim(-1, 1)

    if cfg.loss.proj > 0:
        loss_proj_raw, new_proj_ema = mvd_gaussian_mixture_nll_loss(
            proj_error, 0,
            logstd=logstd_roi.reshape(g_total, heads, rh, rw, 2),
            logmixweight=attn_ls, mean_inv_std=ema.proj_mean_inv_std,
            roi_boxes=gt_boxes_f, roi_img_ids=roi_ids_eff,
            data_parallel=data_parallel,
            weight=act_mask[:, None, None].to(dt), reduction='sum')
        if data_parallel:
            num_act = replica_mean(num_act)
        losses['loss_proj'] = loss_proj_raw / (
            torch.clamp(num_act, min=1.0) * rh * rw) * cfg.loss.proj

    if cfg.with_loss_regr and batch.gt_x3d is not None:
        gt_x3d_f, gt_x2d_f = flat(batch.gt_x3d), flat(batch.gt_x2d)
        pts_mask_f = flat(batch.gt_pts_mask).to(dt)            # (G, P)
        # lidar points into RoI bins
        x2d_start = x2d_roi[:, 0, 0, :]
        x2d_range = x2d_roi[:, -1, -1, :] - x2d_start
        rel = torch.clamp((gt_x2d_f - x2d_start[:, None]) / torch.clamp(
            x2d_range[:, None], min=1e-6), 0.0, 1.0)
        bins = torch.round(rel * (rel.new_tensor([rw, rh]) - 1)).long()
        bin_idx = bins[..., 1] * rw + bins[..., 0]             # (G, P)
        onehot_bins = F.one_hot(bin_idx, rh * rw).to(dt) \
            * pts_mask_f[..., None]
        x3d_sum = torch.einsum('gpc,gpb->gbc', gt_x3d_f, onehot_bins)
        cnt = onehot_bins.sum(1)                               # (G, rh*rw)
        x3d_tgt = x3d_sum / torch.clamp(cnt, min=1.0)[..., None]
        max_dim = gt_b3d_f[:, :3].amax(-1)
        # a safe norm: the difference is exactly 0 on inactive slots, where
        # the norm's 0/0 gradient would poison the backward pass
        diff_sq = (x3d_roi - x3d_tgt[:, None]).square().sum(-1)
        regr_err = torch.sqrt(torch.clamp(diff_sq, min=1e-24)) \
            / torch.clamp(max_dim[:, None, None], min=1e-6)
        x3d_w = torch.softmax(attn.reshape(g_total, heads, rh * rw), 1) \
            * torch.clamp(cnt, max=1.0)[:, None, :] * act_mask[:, None, None]
        # not detached, as in JAX: the gradient flows through the mean
        w_sum = x3d_w.sum()
        if data_parallel:
            w_sum = replica_mean(w_sum)
        losses['loss_regr'] = smooth_l1_loss_mod(
            regr_err, -1, beta=cfg.loss.regr_beta, weight=x3d_w,
            reduction='sum') / torch.clamp(w_sum, min=1e-4) * cfg.loss.regr

    # ---- velocity and attribute losses ----
    if cfg.pred_velo:
        velo_t = flat(batch.gt_velo)[s_gt_inds]
        nan_mask = torch.isnan(velo_t)
        velo_t = torch.where(nan_mask, 0.0, velo_t)
        velo_w = s_weights[:, None] * (~nan_mask)
        vw_sum = torch.clamp(velo_w.sum(), min=1.0)
        if data_parallel:
            vw_sum = replica_mean(vw_sum)
        losses['loss_velo'] = smooth_l1_loss_mod(
            sub.velo, velo_t, beta=1.0, weight=velo_w, reduction='sum') \
            / vw_sum * cfg.loss.velo
    if cfg.pred_attr:
        attr_t = flat(batch.gt_attr).long()[s_gt_inds]
        ce = -torch.log_softmax(sub.attr, -1).gather(-1, attr_t[:, None])[:, 0]
        losses['loss_attr'] = weight_reduce_loss(
            ce, s_weights, 'sum') / s_total * cfg.loss.attr

    new_ema = HeadEMAState(pose_norm_factor=tuple(new_mc_states),
                           proj_mean_inv_std=new_proj_ema)
    total = sum(v for k, v in losses.items() if k.startswith('loss_'))
    losses['norm_factor'] = new_mc_states[-1].norm_factor
    return total, losses, new_ema


# --------------------------------------------------------------- optimizer

class AdamW(OptaxOptimizer):
    """The JAX package's optax chain: ``clip_by_global_norm`` over all
    groups, ``adamw`` with a step-decay schedule, then a per-group
    ``lr_mult`` (``optax.masked(optax.scale)``, which scales the Adam step
    and the decoupled weight decay alike).

    Per element: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
    ``u = mu_hat / (sqrt(nu_hat) + eps) + weight_decay p`` with the bias
    corrections at the update count ``t`` (from 1), and
    ``p -= lr(t - 1) lr_mult u`` with the step decay of
    :meth:`OptaxOptimizer.learning_rate`.
    """

    def __init__(self, param_groups, lr: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, lr_boundaries=(),
                 lr_factor: float = 0.1,
                 clip_grad_norm: Optional[float] = None):
        super().__init__(param_groups, dict(
            lr=lr, lr_mult=1.0, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, lr_boundaries=tuple(lr_boundaries),
            lr_factor=lr_factor), clip_grad_norm)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError('AdamW.step takes no closure')
        grads = self.clipped_grads()
        start = 0
        for group in self.param_groups:
            params = group['params']
            gs = grads[start:start + len(params)]
            start += len(params)
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]['mu'] = torch.zeros_like(p)
                    self.state[p]['nu'] = torch.zeros_like(p)
            mu = [self.state[p]['mu'] for p in params]
            nu = [self.state[p]['nu'] for p in params]
            b1, b2 = group['b1'], group['b2']
            lr = self.learning_rate(group) * group['lr_mult']
            t = group['count'] + 1
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, gs, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, gs, gs, value=1.0 - b2)
            denom = torch._foreach_div(nu, 1.0 - b2 ** t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group['eps'])
            update = torch._foreach_div(mu, 1.0 - b1 ** t)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(update, params, alpha=group['weight_decay'])
            torch._foreach_add_(params, update, alpha=-lr)
            group['count'] = t


def make_optimizer(cfg: DetConfig, model: nn.Module,
                   steps_per_epoch: int = 0) -> AdamW:
    """AdamW at ``cfg.train.lr`` and ``weight_decay``; the parameters under
    a ``sampling_offsets`` module at ``sampling_offsets_lr_mult``; the
    global-norm clip at ``grad_clip``; the step decay by ``lr_gamma`` at
    the epochs ``lr_steps`` when ``steps_per_epoch`` > 0 (0: a constant
    learning rate). Reference: configs/epropnp_det_basic.py:226-241."""
    t = cfg.train
    named = list(model.named_parameters())
    offsets = [p for n, p in named if 'sampling_offsets' in n.split('.')]
    rest = [p for n, p in named if 'sampling_offsets' not in n.split('.')]
    boundaries = ([int(e) * steps_per_epoch for e in t.lr_steps]
                  if steps_per_epoch > 0 else [])
    return AdamW([dict(params=rest),
                  dict(params=offsets, lr_mult=t.sampling_offsets_lr_mult)],
                 lr=t.lr, weight_decay=t.weight_decay,
                 lr_boundaries=boundaries, lr_factor=t.lr_gamma,
                 clip_grad_norm=t.grad_clip)


# ------------------------------------------------------------ train state

class DetTrainState(nn.Module):
    """The model (parameters, BatchNorm statistics), the EMA loss
    normalisers and the step count as buffers, and the optimizer.
    ``state_dict()`` covers the first three; a checkpoint adds
    ``tx.state_dict()``."""

    def __init__(self, model: nn.Module, tx: AdamW, num_stages: int = 1):
        super().__init__()
        self.model = model
        self.tx = tx
        like = next(model.parameters())
        self.register_buffer('ema_pose_norm_factor',
                             like.new_ones((num_stages,)))
        self.register_buffer('ema_proj_mean_inv_std', like.new_ones(()))
        self.register_buffer('step', torch.zeros((), dtype=torch.int64,
                                                 device=like.device))

    @property
    def ema(self) -> HeadEMAState:
        return HeadEMAState(
            pose_norm_factor=tuple(MonteCarloPoseLossState(norm_factor=v)
                                   for v in self.ema_pose_norm_factor),
            proj_mean_inv_std=self.ema_proj_mean_inv_std)

    @torch.no_grad()
    def set_ema(self, ema: HeadEMAState) -> None:
        self.ema_pose_norm_factor.copy_(torch.stack(
            [s.norm_factor for s in ema.pose_norm_factor]))
        self.ema_proj_mean_inv_std.copy_(ema.proj_mean_inv_std)


def make_train_step(cfg: DetConfig, data_parallel: bool = False):
    """The train step ``step(state, batch, gen) -> metrics``.

    It updates ``state`` in place: the BatchNorm statistics, the EMA
    normalisers and the step count always; the parameters and the
    optimizer state only when every gradient is finite (the JAX step's
    skip, ``det/train.py:449-470``). ``metrics`` holds every loss term,
    ``ate``, ``norm_factor``, ``grad_norm`` and ``skipped`` (0 or 1), as
    tensors.

    With ``data_parallel`` (JAX's ``axis_name``; a ``torch.distributed``
    group is up) ``batch`` is this replica's rows, the losses average
    their normalisers over the replicas, and after the backward the
    gradients and the BatchNorm statistics are averaged
    (``parallel.mesh.mean_gradients`` / ``mean_buffers``) before the
    finiteness check, so every replica takes the same skip decision and
    the same update. The metrics are this replica's.
    """

    def train_step(state: DetTrainState, batch: DetBatch,
                   gen: torch.Generator):
        state.model.train()
        state.tx.zero_grad(set_to_none=True)
        total, losses, new_ema = compute_losses(
            state.model, cfg, batch, state.ema, gen,
            data_parallel=data_parallel)
        total.backward()
        if data_parallel:
            mean_gradients(state.model.parameters())
            mean_buffers(state.model)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in state.model.parameters()]
        ok = bool(all_finite(grads))  # one host sync per step
        if ok:
            state.tx.step()
        state.set_ema(new_ema)
        with torch.no_grad():
            state.step.add_(1)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics['grad_norm'] = global_norm(grads).detach()
        metrics['skipped'] = torch.tensor(0 if ok else 1)
        return metrics

    return train_step
