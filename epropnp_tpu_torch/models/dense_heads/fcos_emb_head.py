"""FCOS-style detection head with projected-3D-centre offsets and object
embeddings (PyTorch, NHWC), counterpart of
``epropnp_tpu/models/dense_heads/fcos_emb_head.py`` (the per-level and the
level-packed forward, and ``get_preds``; targets and losses come with Det
training).

Submodules carry mmdet's names: the ``cls_convs``/``reg_convs`` towers
(``.{i}.conv`` and ``.{i}.gn``; with ``dcn_on_last_conv`` the last conv is
a bias-free DCNv2), the branches ``conv_{cls,centerness,offset,emb}_prev``,
the 1x1 predictors ``conv_cls``, ``conv_centerness``, ``conv_offset`` and
the GN-wrapped ``conv_emb``.

Serving options: ``dense_dtype`` (bf16) runs the towers in that dtype and
casts their outputs back to the input's before the branches;
``level_packed`` packs the levels into one canvas (``ops.level_pack``), so
every tower and branch conv runs once and each tower DCN is one K3 launch,
with GroupNorm per level; ``dcn_int8_gather`` quantizes the tower DCNs'
sampling to int8.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.deform_conv import Conv2d, DeformConv, conv_nhwc
from ...ops.level_pack import (
    map_levels, pack_levels, plan_level_packing, unpack_levels)
from ..necks.fpn import conv_module


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
                 emb_channels: int = 256, offset_cls_agnostic: bool = True,
                 dcn_on_last_conv: bool = True,
                 dcn_modulation_scale: float = 2.0,
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
        self.offset_cls_agnostic = offset_cls_agnostic
        self.dense_dtype = dense_dtype
        self.level_packed = level_packed

        def tower():
            mods = []
            for i in range(stacked_convs):
                cin = in_channels if i == 0 else feat_channels
                if dcn_on_last_conv and i == stacked_convs - 1:
                    conv = DeformConv(cin, feat_channels, bias=False,
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
