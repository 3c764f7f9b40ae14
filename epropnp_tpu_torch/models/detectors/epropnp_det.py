"""EProPnPDet (PyTorch): backbone + FPN + DeformPnPHead, counterpart of
``epropnp_tpu/models/detectors/epropnp_det.py``.

Submodules are ``backbone``, ``neck`` and ``bbox_head``, the top-level
names of a released mmdet checkpoint. ``extract_feat`` and ``det_dense``
take NHWC images (in training mode the BatchNorms use the batch and move
their statistics by flax's rule); ``subheads`` runs the per-object stage;
``extract_rois`` and ``roi_regr`` the dense auxiliary stage of training.

Options (``DetConfig.v1b_serving``; all but the int8 one train too):
``backbone_dtype`` computes the backbone and FPN in bf16 (parameters f32,
the pyramid cast back to the image's dtype), ``dense_dtype`` the head's
dense stage, ``dcn_int8_gather`` quantizes every DCN's sampling to int8
(serving only) and ``level_packed_towers`` runs the FCOS towers on one
canvas of all levels. ``det_dense`` is the dense forward as one callable,
the part ``DetConfig.remat_dense`` recomputes in the backward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..backbones.resnet import ResNetBackbone
from ..dense_heads.deform_pnp_head import DeformPnPHead
from ..necks.fpn import FPN


class EProPnPDet(nn.Module):
    def __init__(self, num_classes: int = 10, backbone_depth: int = 101,
                 backbone_dcn_stages: Sequence[int] = (3, 4),
                 embed_dims: int = 256, num_heads: int = 8,
                 num_points: int = 32,
                 strides: Sequence[int] = (4, 8, 16, 32, 64, 128),
                 output_stride: int = 4, use_cls_emb: bool = False,
                 dim_cls_agnostic: bool = False,
                 offset_cls_agnostic: bool = True, pred_velo: bool = True,
                 pred_attr: bool = True, num_attrs: int = 9,
                 dcn_on_last_conv: bool = True,
                 dcn_modulation_scale: float = 2.0,
                 dcn_bias: bool = False,
                 dcn_int8_gather: bool = False,
                 level_packed_towers: bool = False,
                 backbone_dtype: Optional[torch.dtype] = None,
                 dense_dtype: Optional[torch.dtype] = None,
                 detector_cfg=None):
        super().__init__()
        strides = tuple(strides)
        # the pyramid is rooted at the finest stride: C2.. for strides from
        # 4 (v1 family), C3.. for strides from 8 (v1b family)
        if strides[0] not in (4, 8) or 8 not in strides or 32 not in strides:
            raise ValueError(
                'strides must start at 4 or 8 and contain 8 and 32; got '
                f'{strides}')
        first_stage = {4: 1, 8: 2}[strides[0]]
        self.backbone = ResNetBackbone(
            backbone_depth, out_indices=tuple(range(first_stage, 5)),
            dcn_stages=backbone_dcn_stages,
            dcn_modulation_scale=dcn_modulation_scale, dcn_bias=dcn_bias,
            dcn_int8_gather=dcn_int8_gather, dtype=backbone_dtype)
        in_ch = self.backbone.feat_channels[first_stage - 1:]
        self.neck = FPN(in_channels=in_ch, out_channels=embed_dims,
                        num_outs=len(strides), dtype=backbone_dtype)
        self.bbox_head = DeformPnPHead(
            num_classes=num_classes, in_channels=embed_dims, strides=strides,
            output_stride=output_stride,
            dense_lvl_range=(0, strides.index(32) + 1),
            det_lvl_range=(strides.index(8), len(strides)),
            embed_dims=embed_dims, num_heads=num_heads,
            num_points=num_points, use_cls_emb=use_cls_emb,
            dim_cls_agnostic=dim_cls_agnostic, pred_velo=pred_velo,
            pred_attr=pred_attr, num_attrs=num_attrs,
            dcn_on_last_conv=dcn_on_last_conv,
            dcn_modulation_scale=dcn_modulation_scale, dcn_bias=dcn_bias,
            dcn_int8_gather=dcn_int8_gather, dense_dtype=dense_dtype,
            detector_cfg=dict(offset_cls_agnostic=offset_cls_agnostic,
                              level_packed=level_packed_towers,
                              **(detector_cfg or {})))

    def extract_feat(self, img: torch.Tensor):
        """Images (n, h, w, 3) -> the FPN pyramid (NHWC, the images'
        dtype)."""
        return tuple(f.to(img.dtype) for f in self.neck(self.backbone(img)))

    def det_dense(self, img: torch.Tensor, img_shape):
        """-> (FCOS level outputs, key, value)."""
        return self.bbox_head.forward_det_dense(self.extract_feat(img),
                                                img_shape)

    def subheads(self, *args, **kwargs):
        return self.bbox_head.forward_subheads(*args, **kwargs)

    def extract_rois(self, *args, **kwargs):
        return self.bbox_head.extract_rois(*args, **kwargs)

    def roi_regr(self, value_roi, gt_flips):
        return self.bbox_head.dense_corr_regr(value_roi, gt_flips)
