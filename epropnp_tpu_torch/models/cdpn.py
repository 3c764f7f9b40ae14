"""CDPN: the 6DoF dense-correspondence pose model (PyTorch).

Counterpart of ``epropnp_tpu/models/cdpn.py``:
``backbone(img[bs, 256, 256, 3]) -> feat[bs, 8, 8, 512]``;
``rot_head_net -> (noc[bs, 64, 64, 3], w2d[bs, 64, 64, 2], scale[bs, 2])``;
``trans_head_net -> trans[bs, 3]``. The submodule names are those of the
reference state dict (``backbone.``, ``rot_head_net.``,
``trans_head_net.``); ``utils/convert.py`` maps the JAX package's
parameters onto them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from .backbones.resnet import ResNetBackbone
from .heads.rot_head import RotHead
from .heads.trans_head import TransHead


class CDPNOutputs(NamedTuple):
    noc: torch.Tensor     # (bs, 64, 64, 3)
    w2d: torch.Tensor     # (bs, 64, 64, 2)
    scale: torch.Tensor   # (bs, 2)
    trans: torch.Tensor   # (bs, 3)


class CDPN(nn.Module):
    """``feat_hw`` is the backbone feature size (input size / 32), which
    fixes the trans head's flattened width.

    ``backbone_dtype`` (bf16: the JAX package's mixed-precision recipe,
    ``NetworkConfig.bf16_backbone``) computes the ResNet in that dtype with
    f32 parameters; its feature map is cast back to the image's dtype, in
    which the heads (and the PnP downstream) compute. None computes all of
    it in the image's dtype."""

    def __init__(self, depth: int = 34, rot_filters: int = 256,
                 trans_filters: int = 256, trans_hidden: int = 4096,
                 feat_hw=(8, 8), backbone_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone = ResNetBackbone(depth, out_indices=(4,),
                                       dtype=backbone_dtype)
        feat_c = self.backbone.feat_channels[-1]
        self.rot_head_net = RotHead(feat_c, num_filters=rot_filters)
        self.trans_head_net = TransHead(feat_c, num_filters=trans_filters,
                                        hidden_dim=trans_hidden,
                                        feat_hw=feat_hw)

    def forward(self, img: torch.Tensor) -> CDPNOutputs:
        """img: (bs, H, W, 3) NHWC. Call ``eval()`` for inference (BatchNorm
        running statistics, the JAX ``train=False``)."""
        feat, = self.backbone(img)
        feat = feat.to(img.dtype)
        noc, w2d, scale = self.rot_head_net(feat)
        trans = self.trans_head_net(feat)
        return CDPNOutputs(noc=noc, w2d=w2d, scale=scale, trans=trans)
