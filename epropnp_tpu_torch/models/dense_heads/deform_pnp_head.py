"""DeformPnPHead (PyTorch), counterpart of
``epropnp_tpu/models/dense_heads/deform_pnp_head.py``: the forward
(``forward_det_dense``, ``forward_correspondence``, ``forward_subheads``),
the RoI features (``extract_rois``) and regressor (``dense_corr_regr``),
and for training the importance object sampler (``obj_sampler``) and the
EMA loss normalisers (``HeadEMAState``).

Submodules carry the reference checkpoint's names: ``detector``,
``convs.{i}.conv``, ``conv_upsampled.{conv,gn}``, ``k_proj``, ``v_proj``,
``query_scale.scale``, ``query_proj``, ``pred_fc.{2i}``, the
``dim/score/scale/velo/attr`` branches, ``cls_emb``,
``attention_sampler``, ``obj_query_scale.{i}.scale``, ``pts_trans.{i}``,
``x2d_pos_enc`` and ``corr_regs.{i}``. Maps are NHWC. ``dense_dtype``
(bf16 for serving and training) runs the dense convs, ``conv_upsampled`` with its GN,
the posenc and ``k_proj``/``v_proj`` in that dtype; key and value come
back in the input's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox_3d.coders import MultiClassLogDimCoder
from ...ops.deform_conv import Conv2d, conv_nhwc
from ...ops.deformable_attention import DeformableAttentionSampler
from ...ops.group_linear import GroupLinear
from ...ops.positional_encoding import dense_posenc, points_to_enc
from ...ops.roi_align import roi_align
from ..losses.monte_carlo_pose_loss import MonteCarloPoseLossState
from ..necks.fpn import conv_module
from .fcos_emb_head import FCOSEmbHead, group_norm_nhwc
from .pts_transformer import PtsTransformerLayer


@dataclasses.dataclass(frozen=True)
class HeadEMAState:
    """EMA loss normalisers of a training step: the Monte Carlo pose loss's
    ``norm_factor`` per stage and the reprojection loss's
    ``proj_mean_inv_std``."""
    pose_norm_factor: Tuple[MonteCarloPoseLossState, ...]
    proj_mean_inv_std: torch.Tensor

    @classmethod
    def create(cls, num_stages: int = 1, dtype=torch.float32, device=None):
        return cls(
            pose_norm_factor=tuple(
                MonteCarloPoseLossState.create(dtype=dtype, device=device)
                for _ in range(num_stages)),
            proj_mean_inv_std=torch.ones((), dtype=dtype, device=device))


def draw_object_samples(gen: torch.Generator, fg_mask: torch.Tensor,
                        prob: torch.Tensor, n_uniform: int,
                        n_replace: int) -> torch.Tensor:
    """The random part of :func:`obj_sampler`: ``n_uniform`` foreground
    points without replacement (Gumbel top-k over the foreground), then
    ``n_replace`` points with replacement from ``prob`` (clamped at 1e-30,
    as JAX's categorical over ``log(max(prob, 1e-30))``). Returns the
    (n_uniform + n_replace,) point indices."""
    u = torch.rand(fg_mask.shape, generator=gen, device=gen.device,
                   dtype=prob.dtype).to(prob.device)
    tiny = torch.finfo(prob.dtype).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    inds_uniform = torch.topk(
        torch.where(fg_mask, gumbel, -torch.inf), n_uniform).indices
    inds_replace = torch.multinomial(
        torch.clamp(prob, min=1e-30).to(gen.device), n_replace,
        replacement=True, generator=gen).to(prob.device)
    return torch.cat([inds_uniform, inds_replace])


def obj_sampler(gen: torch.Generator, num_obj_samples: int,
                fg_mask: torch.Tensor, centerness_targets: torch.Tensor,
                gt_inds: torch.Tensor, num_gt: int,
                uniform_mix_ratio: float = 0.5, eps: float = 1e-5):
    """Importance-sample foreground points (a fixed number of samples):
    half uniformly over the foreground, half by centerness, each weighted
    back to a per-GT mean of 1. Returns (point_inds, gt_inds, weights,
    uniform_weights, valid), each (num_obj_samples,)."""
    dtype = centerness_targets.dtype
    fg = fg_mask.to(dtype)
    n_uniform = int(round(num_obj_samples * uniform_mix_ratio))
    n_replace = num_obj_samples - n_uniform

    prob = centerness_targets * fg
    prob = prob / torch.clamp(prob.sum(), min=eps)
    prob_uniform = fg / torch.clamp(fg.sum(), min=1.0)
    prob_mix = prob_uniform * uniform_mix_ratio \
        + prob * (1.0 - uniform_mix_ratio)

    point_inds = draw_object_samples(gen, fg_mask, prob, n_uniform,
                                     n_replace)
    sample_valid = fg_mask[point_inds]
    sample_gt_inds = gt_inds[point_inds]
    w_prob = prob[point_inds] / torch.clamp(prob_mix[point_inds], min=eps)
    w_prob = torch.where(sample_valid, w_prob, 0.0)
    onehot = (sample_gt_inds[:, None] == torch.arange(
        num_gt, device=gt_inds.device)[None, :]) & sample_valid[:, None]
    gt_prob_sum = (w_prob[:, None] * onehot).sum(0)
    gt_w = 1.0 / torch.clamp(gt_prob_sum, min=eps)
    sample_weights = w_prob * gt_w[sample_gt_inds] * sample_valid
    sample_weights = sample_weights / torch.clamp(sample_weights.mean(),
                                                  min=eps)
    gt_uw = 1.0 / torch.clamp(onehot.to(dtype).sum(0), min=1.0)
    uniform_weights = gt_uw[sample_gt_inds] * sample_valid
    uniform_weights = uniform_weights / torch.clamp(uniform_weights.mean(),
                                                    min=eps)
    return (point_inds, sample_gt_inds, sample_weights, uniform_weights,
            sample_valid)


class Scale(nn.Module):
    """mmcv ``Scale``: one learnable scalar ``scale``."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(scale))


class SubheadOutputs(NamedTuple):
    query: torch.Tensor       # (num_obj, heads, 1, head_dim)
    scale: torch.Tensor       # (num_obj, 2)
    score_pred: torch.Tensor  # (num_obj,)
    dim_enc: torch.Tensor     # (num_obj, 3)
    dim_dec: torch.Tensor     # (num_obj, 3)
    velo: Optional[torch.Tensor]
    attr: Optional[torch.Tensor]
    noc_list: Tuple[torch.Tensor, ...]   # each (num_obj, HP, 3)
    w2d_list: Tuple[torch.Tensor, ...]   # each (num_obj, HP, 2)
    x2d: torch.Tensor                    # (num_obj, HP, 2)


def _take_label(x, labels, width):
    """(num_obj, num_classes * width) -> the (num_obj, width) of ``labels``."""
    x = x.reshape(x.shape[0], -1, width)
    return torch.take_along_dim(
        x, labels.long()[:, None, None].expand(-1, 1, width), 1)[:, 0]


class DeformPnPHead(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 256,
                 lvl_feat_channels: Sequence[int] = (256, 128, 128),
                 strides: Sequence[int] = (4, 8, 16, 32, 64, 128),
                 output_stride: int = 4,
                 dense_lvl_range: Tuple[int, int] = (0, 4),
                 det_lvl_range: Tuple[int, int] = (1, 6),
                 dense_channels: int = 256, embed_dims: int = 256,
                 num_heads: int = 8, num_points: int = 32,
                 num_pred_fcs: int = 2, num_pts_trans_layers: int = 1,
                 posenc_num_feats: int = 0, use_cls_emb: bool = False,
                 dim_cls_agnostic: bool = False, pred_velo: bool = True,
                 pred_attr: bool = True, num_attrs: int = 9,
                 dcn_on_last_conv: bool = True,
                 dcn_modulation_scale: float = 2.0,
                 dcn_bias: bool = False,
                 dcn_int8_gather: bool = False,
                 dense_dtype: Optional[torch.dtype] = None,
                 detector_cfg=None):
        super().__init__()
        self.dense_dtype = dense_dtype
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.output_stride = output_stride
        self.dense_lvl_range = tuple(dense_lvl_range)
        self.det_lvl_range = tuple(det_lvl_range)
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_points = num_points
        self.posenc_feats = posenc_num_feats or embed_dims // 2
        self.use_cls_emb = use_cls_emb
        self.dim_cls_agnostic = dim_cls_agnostic
        head_dim = embed_dims // num_heads

        det_kwargs = dict(num_classes=num_classes, in_channels=in_channels,
                          strides=self.strides[det_lvl_range[0]:
                                               det_lvl_range[1]],
                          emb_channels=embed_dims,
                          dcn_on_last_conv=dcn_on_last_conv,
                          dcn_modulation_scale=dcn_modulation_scale,
                          dcn_bias=dcn_bias,
                          dcn_int8_gather=dcn_int8_gather,
                          dense_dtype=dense_dtype)
        det_kwargs.update(detector_cfg or {})
        self.detector = FCOSEmbHead(**det_kwargs)

        chans = [in_channels] + list(lvl_feat_channels)
        self.convs = nn.ModuleList([
            conv_module(Conv2d(chans[i], chans[i + 1], 3, 1, 1,
                               bias=False))
            for i in range(len(lvl_feat_channels))])
        n_dense = dense_lvl_range[1] - dense_lvl_range[0]
        self.conv_upsampled = conv_module(
            Conv2d(n_dense * chans[-1], dense_channels, 1, bias=False),
            nn.GroupNorm(32, dense_channels, eps=1e-5))
        self.k_proj = Conv2d(dense_channels + 2 * self.posenc_feats,
                             embed_dims, 1)
        self.v_proj = Conv2d(dense_channels, embed_dims, 1)
        self.query_scale = Scale(0.1)
        self.query_proj = nn.Linear(embed_dims, embed_dims)
        fcs = []
        for _ in range(num_pred_fcs):
            fcs += [nn.Linear(embed_dims, embed_dims), nn.ReLU()]
        self.pred_fc = nn.Sequential(*fcs)
        self.dim_branch = nn.Linear(
            embed_dims, 3 if dim_cls_agnostic else num_classes * 3)
        self.score_branch = nn.Linear(embed_dims, 1)
        self.scale_branch = nn.Linear(embed_dims, 2)
        self.cls_emb = (nn.Parameter(torch.zeros(num_classes, embed_dims))
                        if use_cls_emb else None)
        self.velo_branch = nn.Linear(embed_dims, 2) if pred_velo else None
        self.attr_branch = (nn.Linear(embed_dims, num_attrs) if pred_attr
                            else None)
        self.attention_sampler = DeformableAttentionSampler(
            embed_dims=embed_dims, num_heads=num_heads,
            num_points=num_points, stride=output_stride)
        self.obj_query_scale = nn.ModuleList(
            [Scale(0.1) for _ in range(num_pts_trans_layers)])
        self.pts_trans = nn.ModuleList(
            [PtsTransformerLayer(embed_dims=head_dim)
             for _ in range(num_pts_trans_layers)])
        self.x2d_pos_enc = nn.Linear(2, head_dim)
        self.corr_regs = nn.ModuleList(
            [GroupLinear(embed_dims, num_heads * 5, num_heads)
             for _ in range(num_pts_trans_layers + 1)])

    # -------------------------------------------------------- dense stage

    def forward_det_dense(self, mlvl_feats, img_shape):
        """FCOS outputs and the dense key/value maps (NHWC)."""
        lo, hi = self.det_lvl_range
        det_outs = self.detector(mlvl_feats[lo:hi])
        in_dt = mlvl_feats[0].dtype
        dense_feats = []
        for x in mlvl_feats[self.dense_lvl_range[0]:self.dense_lvl_range[1]]:
            x = x.to(self.dense_dtype or in_dt)
            for mod in self.convs:
                x = torch.relu(conv_nhwc(mod.conv, x))
            dense_feats.append(x)
        h0, w0 = dense_feats[0].shape[1:3]
        ups = [dense_feats[0]] + [
            F.interpolate(f.permute(0, 3, 1, 2), size=(h0, w0),
                          mode='bilinear', align_corners=False
                          ).permute(0, 2, 3, 1)
            for f in dense_feats[1:]]
        concat = torch.relu(group_norm_nhwc(
            self.conv_upsampled.gn,
            conv_nhwc(self.conv_upsampled.conv, torch.cat(ups, -1))))
        posenc = dense_posenc(h0, w0, img_shape[0], img_shape[1],
                              num_feats=self.posenc_feats,
                              stride=self.output_stride, dtype=concat.dtype,
                              device=concat.device)
        posenc = posenc.expand(concat.shape[:3] + posenc.shape[-1:])
        key = conv_nhwc(self.k_proj, torch.cat([concat, posenc], -1))
        value = conv_nhwc(self.v_proj, concat)
        return det_outs, key.to(in_dt), value.to(in_dt)

    # --------------------------------------------------- correspondences

    def forward_correspondence(self, v_samples, x2d_samples, mask_samples,
                               obj_query, sample_flips):
        """Per-point transformer -> per-head (noc, w2d)."""
        num_obj = v_samples.shape[0]
        nh, npt = self.num_heads, self.num_points
        hp, d = nh * npt, self.embed_dims // nh
        v = v_samples.transpose(-1, -2).reshape(num_obj, hp, d)
        x2d = x2d_samples.transpose(-1, -2).reshape(num_obj, hp, 2)
        mask = mask_samples.transpose(-1, -2)  # (n, heads, pts, 1)

        flip = torch.tensor([-1.0, 1.0], dtype=x2d.dtype, device=x2d.device)
        x2d_flip = x2d.detach()  # the posenc passes no gradient (JAX's)
        x2d_flip = torch.where(sample_flips[:, None, None], x2d_flip * flip,
                               x2d_flip)
        mean = x2d_flip.mean(1, keepdim=True)
        std = x2d_flip.std(1, unbiased=False, keepdim=True)
        pos_enc = self.x2d_pos_enc((x2d_flip - mean) / std.clamp(min=1.0))
        query = obj_query.expand(num_obj, nh, npt, d).reshape(num_obj, hp, d)

        noc_flip = torch.tensor([1.0, 1.0, -1.0], dtype=x2d.dtype,
                                device=x2d.device)
        noc_list, w2d_list = [], []
        for i, (pts_trans, scale) in enumerate(
                zip(self.pts_trans, self.obj_query_scale)):
            v = pts_trans(v + scale.scale * query, pos_enc)
            v_pts = v.reshape(num_obj, nh, npt, d).transpose(1, 2).reshape(
                num_obj, npt, self.embed_dims)
            regr = self.corr_regs[i + 1](v_pts).reshape(
                num_obj, npt, nh, 5).transpose(1, 2)  # (n, heads, pts, 5)
            noc, w2d = regr[..., :3], regr[..., 3:]
            noc = torch.where(sample_flips[:, None, None, None],
                              noc * noc_flip, noc)
            w2d = torch.softmax(w2d.reshape(num_obj, hp, 2), 1).reshape(
                num_obj, nh, npt, 2) * mask
            noc_list.append(noc.reshape(num_obj, hp, 3))
            w2d_list.append(w2d.reshape(num_obj, hp, 2))
        return tuple(noc_list), tuple(w2d_list), x2d

    # ---------------------------------------------------------- subheads

    def forward_subheads(self, obj_center, obj_emb, key, value,
                         img_dense_x2d_small, img_dense_x2d_mask_small,
                         obj_strides, obj_img_inds, obj_labels, img_flips,
                         img_shapes) -> SubheadOutputs:
        num_obj = obj_img_inds.shape[0]
        d = self.embed_dims // self.num_heads
        obj_flips = img_flips[obj_img_inds]
        if self.use_cls_emb:
            obj_emb = obj_emb + self.cls_emb[obj_labels]
        if obj_center.shape[-1] > 2:  # offset_cls_agnostic=False
            obj_center = _take_label(obj_center, obj_labels, 2)
        posenc = points_to_enc(obj_center, img_shapes[obj_img_inds],
                               num_feats=self.posenc_feats)
        query = self.query_proj(
            self.query_scale.scale * obj_emb + posenc
        ).reshape(num_obj, self.num_heads, 1, d)
        samp = self.attention_sampler(
            query, obj_emb, key, value, img_dense_x2d_small,
            img_dense_x2d_mask_small, obj_center, obj_strides, obj_img_inds)

        scale = torch.exp(self.scale_branch(samp.output))
        score_pred = self.score_branch(samp.output)[..., 0]
        out = self.pred_fc(samp.output)
        dim_enc = self.dim_branch(out)
        if not self.dim_cls_agnostic:
            dim_enc = _take_label(dim_enc, obj_labels, 3)
        dim_dec = MultiClassLogDimCoder().decode(dim_enc, obj_labels)
        velo = attr = None
        if self.velo_branch is not None:
            velo = self.velo_branch(out)
            flip = torch.tensor([-1.0, 1.0], dtype=velo.dtype,
                                device=velo.device)
            velo = torch.where(obj_flips[:, None], velo * flip, velo)
        if self.attr_branch is not None:
            attr = self.attr_branch(out)
        noc_list, w2d_list, x2d = self.forward_correspondence(
            samp.v_samples, samp.x2d_samples, samp.mask_samples, query,
            obj_flips)
        return SubheadOutputs(query, scale, score_pred, dim_enc, dim_dec,
                              velo, attr, noc_list, w2d_list, x2d)

    def extract_rois(self, roi_img_inds, roi_boxes, img_dense_x2d, key,
                     value, roi_shape=(28, 28)):
        """RoI-aligned x2d (image pixels), key and value (maps at
        ``output_stride``), each (n, rh, rw, c)."""
        x2d_roi = roi_align(img_dense_x2d, roi_img_inds, roi_boxes,
                            roi_shape, 1.0)
        key_roi = roi_align(key, roi_img_inds, roi_boxes, roi_shape,
                            1.0 / self.output_stride)
        value_roi = roi_align(value, roi_img_inds, roi_boxes, roi_shape,
                              1.0 / self.output_stride)
        return x2d_roi, key_roi, value_roi

    def dense_corr_regr(self, value_roi, gt_flips):
        """corr_regs[0] over RoI features (n, rh, rw, embed) -> (noc,
        logstd), each (n, heads, rh * rw, 3 | 2)."""
        n, rh, rw, _ = value_roi.shape
        regr = self.corr_regs[0](value_roi.reshape(n, rh * rw, -1)).reshape(
            n, rh * rw, self.num_heads, 5).transpose(1, 2)
        noc, logstd = regr[..., :3], regr[..., 3:]
        flip = torch.tensor([1.0, 1.0, -1.0], dtype=noc.dtype,
                            device=noc.device)
        noc = torch.where(gt_flips[:, None, None, None], noc * flip, noc)
        return noc, logstd
