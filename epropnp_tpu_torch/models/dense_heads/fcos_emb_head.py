"""FCOS-style detection head with projected-3D-centre offsets and object
embeddings (PyTorch, NHWC), counterpart of
``epropnp_tpu/models/dense_heads/fcos_emb_head.py``: the per-level and the
level-packed forward, ``get_preds``, and the training targets and losses
(``get_targets``, ``loss``).

Submodules carry mmdet's names: the ``cls_convs``/``reg_convs`` towers
(``.{i}.conv`` and ``.{i}.gn``; with ``dcn_on_last_conv`` the last conv is
a DCNv2, bias-free as mmcv's unless ``dcn_bias``), the branches
``conv_{cls,centerness,offset,emb}_prev``, the 1x1 predictors
``conv_cls``, ``conv_centerness``, ``conv_offset`` and the GN-wrapped
``conv_emb``.

Options (serving and training, but the int8 one): ``dense_dtype`` (bf16)
runs the towers in that dtype and casts their outputs back to the input's
before the branches; ``level_packed`` packs the levels into one canvas
(``ops.level_pack``), so every tower and branch conv runs once and each
tower DCN is one K3 launch, with GroupNorm per level; ``dcn_int8_gather``
quantizes the tower DCNs' sampling to int8 (serving only).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

import torch.nn.functional as F

from ...ops.deform_conv import Conv2d, DeformConv, conv_nhwc
from ...parallel.mesh import replica_mean
from ...ops.level_pack import (
    map_levels, pack_levels, plan_level_packing, unpack_levels)
from ..losses.det_losses import sigmoid_focal_loss, smooth_l1_loss_mod
from ..necks.fpn import conv_module

INF = 1e8


def gn_groups(channels: int, preferred: int = 32) -> int:
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


def group_norm_nhwc(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``gn`` (a torch GroupNorm) on an NHWC tensor: the same statistics as
    flax's GroupNorm, over the spatial axes and each group's channels. A
    bf16 input is normalised in f32 and the result rounded to bf16, as
    flax does."""
    n, h, w, c = x.shape
    g = gn.num_groups
    xg = x.reshape(n, h * w, g, c // g).to(torch.promote_types(
        x.dtype, torch.float32))
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + gn.eps)).reshape(n, h, w, c)
    return (y * gn.weight + gn.bias).to(x.dtype)


def conv_gn_relu(mod: nn.Module, x: torch.Tensor,
                 layout=None) -> torch.Tensor:
    """An mmcv ConvModule (conv -> GN -> ReLU) on NHWC; on a canvas of
    levels (``layout``) the GroupNorm runs per level and the gaps come out
    zero."""
    if isinstance(mod.conv, DeformConv):
        y = mod.conv(x, layout=layout)
    else:
        y = conv_nhwc(mod.conv, x)

    def norm(t):
        return torch.relu(group_norm_nhwc(mod.gn, t))
    return norm(y) if layout is None else map_levels(y, layout, norm)


class FCOSLevelOutputs(NamedTuple):
    cls_score: torch.Tensor   # (n, h, w, num_classes)
    center: torch.Tensor      # (n, h, w, 2) or (n, h, w, num_classes*2)
    centerness: torch.Tensor  # (n, h, w, 1)
    obj_emb: torch.Tensor     # (n, h, w, emb_channels)
    points: torch.Tensor      # (h*w, 2) image-pixel point centres


def level_points(h: int, w: int, stride: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    ys = torch.arange(h, dtype=dtype, device=device) * stride
    xs = torch.arange(w, dtype=dtype, device=device) * stride
    yy, xx = torch.meshgrid(ys, xs, indexing='ij')
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], -1) + stride // 2


class FCOSEmbHead(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 2,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges: Sequence[Tuple[float, float]] = (
                     (-1, 48), (48, 96), (96, 192), (192, 384), (384, INF)),
                 emb_channels: int = 256, centerness_alpha: float = 2.5,
                 center_sample_radius: float = 1.5,
                 center_error_scale: float = 0.2,
                 min_ref_length: float = 4.0,
                 offset_cls_agnostic: bool = True,
                 dcn_on_last_conv: bool = True,
                 dcn_modulation_scale: float = 2.0,
                 dcn_bias: bool = False,
                 dcn_int8_gather: bool = False,
                 cls_branch: Sequence[int] = (256,),
                 centerness_branch: Sequence[int] = (64,),
                 offset_branch: Sequence[int] = (256,),
                 emb_branch: Sequence[int] = (256,),
                 dense_dtype: Optional[torch.dtype] = None,
                 level_packed: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.regress_ranges = tuple(tuple(r) for r in regress_ranges)
        self.centerness_alpha = centerness_alpha
        self.center_sample_radius = center_sample_radius
        self.center_error_scale = center_error_scale
        self.min_ref_length = min_ref_length
        self.offset_cls_agnostic = offset_cls_agnostic
        self.dense_dtype = dense_dtype
        self.level_packed = level_packed

        def tower():
            mods = []
            for i in range(stacked_convs):
                cin = in_channels if i == 0 else feat_channels
                if dcn_on_last_conv and i == stacked_convs - 1:
                    conv = DeformConv(cin, feat_channels, bias=dcn_bias,
                                      modulation_scale=dcn_modulation_scale,
                                      int8_gather=dcn_int8_gather)
                else:
                    conv = Conv2d(cin, feat_channels, 3, 1, 1, bias=False)
                mods.append(conv_module(conv, nn.GroupNorm(
                    gn_groups(feat_channels), feat_channels, eps=1e-5)))
            return nn.ModuleList(mods)

        def branch(chans):
            mods, cin = [], feat_channels
            for ch in chans:
                mods.append(conv_module(
                    nn.Conv2d(cin, ch, 3, 1, 1, bias=False),
                    nn.GroupNorm(gn_groups(ch), ch, eps=1e-5)))
                cin = ch
            return nn.ModuleList(mods), cin

        self.cls_convs, self.reg_convs = tower(), tower()
        self.conv_cls_prev, c_cls = branch(cls_branch)
        self.conv_centerness_prev, c_ctr = branch(centerness_branch)
        self.conv_offset_prev, c_off = branch(offset_branch)
        self.conv_emb_prev, c_emb = branch(emb_branch)
        self.conv_cls = nn.Conv2d(c_cls, num_classes, 1)
        nn.init.constant_(self.conv_cls.bias, -4.59)  # prior prob 0.01
        self.conv_centerness = nn.Conv2d(c_ctr, 1, 1)
        off_ch = 2 if offset_cls_agnostic else num_classes * 2
        self.conv_offset = nn.Conv2d(c_off, off_ch, 1)
        self.conv_emb = conv_module(
            nn.Conv2d(c_emb, emb_channels, 1, bias=False),
            nn.GroupNorm(gn_groups(emb_channels), emb_channels, eps=1e-5))

    @staticmethod
    def _run(mods, x, layout=None):
        for mod in mods:
            x = conv_gn_relu(mod, x, layout)
        return x

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[FCOSLevelOutputs, ...]:
        """Per-level forward (the modules shared across levels), or one
        pass over the canvas of all levels with ``level_packed``; outputs
        in the input's dtype."""
        in_dt = feats[0].dtype
        ddt = self.dense_dtype or in_dt
        layout = None
        if self.level_packed and len(feats) > 1:
            layout = plan_level_packing([(x.shape[1], x.shape[2])
                                         for x in feats])
            inputs = [pack_levels([x.to(ddt) for x in feats], layout)]
        else:
            inputs = [x.to(ddt) for x in feats]
        maps = []
        for x in inputs:
            cls_feat = self._run(self.cls_convs, x, layout).to(in_dt)
            reg_feat = self._run(self.reg_convs, x, layout).to(in_dt)
            maps.append((
                conv_nhwc(self.conv_cls,
                          self._run(self.conv_cls_prev, cls_feat, layout)),
                conv_nhwc(self.conv_centerness, self._run(
                    self.conv_centerness_prev, reg_feat, layout)),
                conv_nhwc(self.conv_offset, self._run(
                    self.conv_offset_prev, reg_feat, layout)),
                conv_gn_relu(self.conv_emb, self._run(
                    self.conv_emb_prev, reg_feat, layout), layout)))
        if layout is not None:
            maps = list(zip(*(unpack_levels(m, layout) for m in maps[0])))
        outs = []
        for (cls_score, centerness, offset, obj_emb), x, stride in zip(
                maps, feats, self.strides):
            offset = offset * stride
            n, h, w, _ = x.shape
            pts = level_points(h, w, stride, in_dt, x.device)
            pts_map = pts.reshape(h, w, 2)
            if self.offset_cls_agnostic:
                center = offset + pts_map
            else:
                center = (offset.reshape(n, h, w, self.num_classes, 2)
                          + pts_map[:, :, None, :]).reshape(n, h, w, -1)
            outs.append(FCOSLevelOutputs(cls_score, center, centerness,
                                         obj_emb, pts))
        return tuple(outs)

    def get_preds(self, level_outputs: Sequence[FCOSLevelOutputs],
                  extra_maps: Sequence[Sequence[torch.Tensor]] = (),
                  max_obj_per_img: int = 256,
                  min_fcos_score: float = 0.04):
        """Thresholded fixed-size top-k detections per image.

        Returns a dict of (K,) ``img_inds, point_inds, score, labels,
        strides, valid``, ``points`` (K, 2) and ``gathered``, one (K, C)
        tensor per entry of ``extra_maps``; K = bs * max_obj_per_img,
        image i in the slice [i * max_obj_per_img, (i + 1) * ...). Ties
        pick the lowest candidate index first, as ``jax.lax.top_k`` (a
        stable descending sort).
        """
        bs = level_outputs[0].cls_score.shape[0]
        kpi = max_obj_per_img

        def flat(maps):
            return torch.cat([m.reshape(bs, -1, m.shape[-1]) for m in maps],
                             1)

        cls = torch.sigmoid(flat([o.cls_score for o in level_outputs]))
        ctr = torch.sigmoid(flat([o.centerness for o in level_outputs]))
        fcos_score = cls * ctr                        # (bs, P, C)
        strides = torch.cat([
            torch.full((o.cls_score.shape[1] * o.cls_score.shape[2],), s,
                       dtype=cls.dtype, device=cls.device)
            for o, s in zip(level_outputs, self.strides)])
        c = self.num_classes
        score_img = fcos_score.reshape(bs, -1)
        masked = torch.where(score_img >= min_fcos_score, score_img, -1.0)
        top_scores, top_idx = torch.sort(masked, dim=-1, descending=True,
                                          stable=True)
        top_scores, top_idx = top_scores[:, :kpi], top_idx[:, :kpi]
        valid = (top_scores > 0.0).reshape(-1)
        img_inds = torch.arange(bs, device=cls.device).repeat_interleave(kpi)
        top_idx = top_idx.reshape(-1)
        point_inds = top_idx // c
        labels = top_idx % c
        pts = torch.cat([o.points for o in level_outputs], 0)
        return dict(
            img_inds=img_inds, point_inds=point_inds,
            score=cls[img_inds, point_inds, labels], labels=labels,
            strides=strides[point_inds], valid=valid,
            gathered=[flat(maps)[img_inds, point_inds]
                      for maps in extra_maps],
            points=pts[point_inds])

    # ------------------------------------------------------------ training

    def get_targets(self, points_per_lvl, gt_bboxes, gt_labels, gt_mask,
                    centers2d):
        """Fixed-shape FCOS target assignment.

        points_per_lvl: (p_l, 2) per level; gt_bboxes (num_img, max_gt, 4),
        gt_labels and gt_mask (num_img, max_gt), centers2d (num_img,
        max_gt, 2) the projected 3D centres. Each point takes the nearest
        centre among the GT boxes that contain it, whose centre lies within
        ``center_sample_radius`` strides and whose largest side distance is
        in the level's regression range. Returns (labels, centerness
        targets, gt_inds), each (num_img, P); labels == num_classes marks
        background (gt_inds then meaningless).
        """
        dtype, dev = gt_bboxes.dtype, gt_bboxes.device
        pts = torch.cat(list(points_per_lvl), 0)[None]          # (1, P, 2)
        rr = torch.cat([torch.tensor(r, dtype=dtype, device=dev).expand(
            p.shape[0], 2) for p, r in zip(points_per_lvl,
                                           self.regress_ranges)])
        strides = torch.cat([
            torch.full((p.shape[0],), s, dtype=dtype, device=dev)
            for p, s in zip(points_per_lvl, self.strides)])
        # (num_img, P, max_gt)
        dx = pts[..., 0, None] - centers2d[:, None, :, 0]
        dy = pts[..., 1, None] - centers2d[:, None, :, 1]
        dists = torch.sqrt(dx * dx + dy * dy)
        radius = strides[:, None] * self.center_sample_radius
        inside_center = (dx.abs() < radius) & (dy.abs() < radius)
        left = pts[..., 0, None] - gt_bboxes[:, None, :, 0]
        top = pts[..., 1, None] - gt_bboxes[:, None, :, 1]
        right = gt_bboxes[:, None, :, 2] - pts[..., 0, None]
        bottom = gt_bboxes[:, None, :, 3] - pts[..., 1, None]
        inside_box = torch.minimum(torch.minimum(left, right),
                                   torch.minimum(top, bottom)) > 0
        max_reg = torch.maximum(torch.maximum(left, right),
                                torch.maximum(top, bottom))
        in_range = (max_reg >= rr[:, None, 0]) & (max_reg <= rr[:, None, 1])
        valid = inside_center & inside_box & in_range & gt_mask[:, None, :]
        dists = torch.where(valid, dists, INF)
        gt_ind = torch.argmin(dists, -1)  # the first minimum, as jnp
        min_dist = torch.gather(dists, -1, gt_ind[..., None])[..., 0]
        labels = torch.where(min_dist < INF,
                             torch.gather(gt_labels, 1, gt_ind),
                             self.num_classes)
        ctr = torch.exp(-self.centerness_alpha * min_dist / (1.414 * strides))
        return labels, ctr, gt_ind

    def loss(self, flat_cls, flat_center, flat_centerness, labels, gt_inds,
             centerness_targets, centers2d, gt_bboxes,
             data_parallel: bool = False):
        """Masked FCOS losses over the points of all images.

        flat_cls (N, num_classes); flat_center (N, 2) or (N, C * 2);
        flat_centerness (N,); labels, gt_inds, centerness_targets (N,);
        centers2d (G, 2) and gt_bboxes (G, 4), the GT of all images that
        gt_inds indexes. Returns ``loss_cls`` (focal), ``loss_rp`` (the
        centre offset, smooth L1 weighted by centerness) and
        ``loss_centerness`` (BCE on the positives). With ``data_parallel``
        the positives' count and the centerness weights' sum are averaged
        over the replicas (JAX ``fcos_emb_head.py:332-333, 353-354``).
        """
        pos = labels < self.num_classes
        num_pos = pos.to(flat_cls.dtype).sum()
        if data_parallel:
            num_pos = replica_mean(num_pos)
        num_pos = torch.clamp(num_pos, min=1.0)
        onehot = F.one_hot(labels, self.num_classes + 1)[
            :, :self.num_classes].to(flat_cls.dtype)
        loss_cls = sigmoid_focal_loss(flat_cls, onehot,
                                      reduction='sum') / num_pos
        if not self.offset_cls_agnostic:
            lbl = torch.clamp(labels, max=self.num_classes - 1)
            flat_center = torch.take_along_dim(
                flat_center.reshape(-1, self.num_classes, 2),
                lbl[:, None, None].expand(-1, 1, 2), 1)[:, 0]
        center_gt = centers2d[gt_inds]
        box_gt = gt_bboxes[gt_inds]
        ref_len = box_gt[:, 2:] - box_gt[:, :2]
        rel_err = (flat_center - center_gt) / (
            self.center_error_scale * (ref_len + self.min_ref_length))
        ctr_w = torch.where(pos, centerness_targets, 0.0)
        ctr_sum = ctr_w.sum()
        if data_parallel:
            ctr_sum = replica_mean(ctr_sum)
        loss_rp = smooth_l1_loss_mod(
            rel_err, 0, beta=1.0, weight=ctr_w[:, None], reduction='sum') \
            / (torch.clamp(ctr_sum, min=1e-6) * 2.0)
        bce = (F.softplus(-flat_centerness) * centerness_targets
               + F.softplus(flat_centerness) * (1.0 - centerness_targets))
        loss_centerness = torch.where(pos, bce, 0.0).sum() / num_pos
        return dict(loss_cls=loss_cls, loss_rp=loss_rp,
                    loss_centerness=loss_centerness)
