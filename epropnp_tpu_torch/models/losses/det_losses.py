"""Losses of the Det suite (PyTorch), counterpart of
``epropnp_tpu/models/losses/det_losses.py``:

- ``weight_reduce_loss``: mmdet's elementwise weight, then mean, sum or
  none;
- ``smooth_l1_loss_mod``: smooth L1 that also takes the integer targets 0
  (``|pred|`` is the difference) and -1 (``pred`` is);
- ``cosine_angle_loss``: ``1 - cos(pred - target)``;
- ``sigmoid_focal_loss``: mmdet's FocalLoss (the FCOS class loss);
- ``mvd_gaussian_mixture_nll_loss``: the Gaussian-mixture NLL of
  reprojection deviations over attention heads (log-std and log-mixture
  weights), with the optional cross-RoI normalisation of the mixture and
  an adaptive weight dividing by an EMA of the mean inverse std, returned
  as explicit state, whose batch statistic is averaged over the
  data-parallel replicas (``parallel.mesh.replica_mean``) on request.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...parallel.mesh import replica_mean


def weight_reduce_loss(loss, weight=None, reduction: str = 'mean',
                       avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if reduction == 'none':
        return loss
    if reduction == 'sum':
        return loss.sum()
    if avg_factor is not None:
        return loss.sum() / torch.clamp(torch.as_tensor(
            avg_factor, dtype=loss.dtype, device=loss.device), min=1e-12)
    return loss.mean()


def _diff(pred, target):
    if isinstance(target, int):
        return pred.abs() if target == 0 else pred
    return (pred - target).abs()


def smooth_l1_loss_mod(pred, target, beta: float = 1.0, weight=None,
                       reduction: str = 'mean', avg_factor=None):
    assert beta > 0
    diff = _diff(pred, target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def cosine_angle_loss(pred, target, weight=None, reduction: str = 'mean',
                      avg_factor=None):
    return weight_reduce_loss(1.0 - torch.cos(pred - target), weight,
                              reduction, avg_factor)


def sigmoid_focal_loss(logits, targets_onehot, gamma: float = 2.0,
                       alpha: float = 0.25, weight=None,
                       reduction: str = 'mean', avg_factor=None):
    """targets_onehot: the shape of ``logits``."""
    p = torch.sigmoid(logits)
    t = targets_onehot
    ce = F.softplus(-logits) * t + F.softplus(logits) * (1.0 - t)
    p_t = p * t + (1.0 - p) * (1.0 - t)
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    loss = alpha_t * (1.0 - p_t) ** gamma * ce
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def mvd_gaussian_mixture_nll_loss(
        pred, target, logstd, logmixweight, mean_inv_std,
        roi_boxes=None, roi_img_ids=None, adaptive_weight: bool = True,
        momentum: float = 0.1, mix_axis: int = 1, eps: float = 1e-4,
        training: bool = True, data_parallel: bool = False, weight=None,
        reduction: str = 'mean', avg_factor=None):
    """pred/target (n, num_mix, h, w, 2) (or an integer target 0/-1);
    logstd (n, num_mix, h, w, 2); logmixweight (n, num_mix, h, w);
    mean_inv_std the scalar EMA. ``roi_boxes``/``roi_img_ids`` turn on the
    cross-RoI logsumexp. With ``data_parallel`` the EMA's batch statistic
    is averaged over the replicas (its numerator and denominator apart, as
    JAX's ``pmean``). Returns ``(loss, new_mean_inv_std)``."""
    diff = _diff(pred, target)
    inverse_std = torch.clamp(torch.exp(-logstd), max=1.0 / eps)
    dw_sq = (diff * inverse_std).square().sum(-1)
    loss_comp = -0.5 * dw_sq + logmixweight - logstd.sum(-1)
    if roi_boxes is None:
        loss = -torch.logsumexp(loss_comp, mix_axis)
    else:
        from ...ops.inter_roi_ops import logsumexp_across_rois
        lse = torch.logsumexp(loss_comp, mix_axis, keepdim=True)
        # (n, 1, h, w) -> NHWC for the RoI op -> back
        lse = logsumexp_across_rois(lse.movedim(1, -1), roi_boxes,
                                    roi_img_ids)
        loss = -lse.movedim(-1, 1)[:, 0]

    new_mean_inv_std = mean_inv_std
    if adaptive_weight:
        if training:
            inv_std = inverse_std.detach()
            mixweight = torch.exp(logmixweight.detach())[..., None]
            num = (inv_std * mixweight).sum()
            den = mixweight.sum() * 2.0
            if data_parallel:
                num, den = replica_mean(num), replica_mean(den)
            batch_mean_inv_std = num / torch.clamp(den, min=eps)
            new_mean_inv_std = mean_inv_std * (1.0 - momentum) \
                + momentum * batch_mean_inv_std
        loss = loss / torch.clamp(new_mean_inv_std, min=eps)
    return weight_reduce_loss(loss, weight, reduction, avg_factor), \
        new_mean_inv_std
