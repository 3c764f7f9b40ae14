"""Feature Pyramid Network neck (PyTorch, NHWC), counterpart of
``epropnp_tpu/models/necks/fpn.py``: lateral 1x1 convs, nearest x2
top-down upsampling, 3x3 output convs, extra levels from stride-2 convs on
the last output. Submodules carry mmdet's names: ``lateral_convs.{i}.conv``
and ``fpn_convs.{i}.conv``, the extra convs appended to ``fpn_convs``.
``dtype`` (bf16 for serving and training) is the compute dtype; the parameters stay
f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import Conv2d, conv_nhwc


def conv_module(conv: nn.Module, norm: nn.Module = None) -> nn.Module:
    """mmcv ``ConvModule`` naming: ``.conv`` and, with a norm, ``.gn``."""
    mod = nn.Module()
    mod.conv = conv
    if norm is not None:
        mod.gn = norm
    return mod


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.lateral_convs = nn.ModuleList(
            [conv_module(Conv2d(c, out_channels, 1)) for c in in_channels])
        convs = [conv_module(Conv2d(out_channels, out_channels, 3, 1, 1))
                 for _ in in_channels]
        convs += [conv_module(Conv2d(out_channels, out_channels, 3, 2, 1))
                  for _ in range(num_outs - len(in_channels))]
        self.fpn_convs = nn.ModuleList(convs)
        self.num_laterals = len(in_channels)

    def forward(self, inputs: Tuple[torch.Tensor, ...]
                ) -> Tuple[torch.Tensor, ...]:
        """NHWC stage features -> NHWC pyramid (num_outs levels), in the
        compute dtype (None: the inputs' dtype)."""
        if self.dtype is not None:
            inputs = [x.to(self.dtype) for x in inputs]
        laterals = [conv_nhwc(m.conv, x)
                    for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            up = F.interpolate(laterals[i].permute(0, 3, 1, 2),
                               scale_factor=2, mode='nearest')
            laterals[i - 1] = laterals[i - 1] + up.permute(0, 2, 3, 1)
        outs = [conv_nhwc(self.fpn_convs[i].conv, lat)
                for i, lat in enumerate(laterals)]
        for m in self.fpn_convs[self.num_laterals:]:
            outs.append(conv_nhwc(m.conv, outs[-1]))
        return tuple(outs)
