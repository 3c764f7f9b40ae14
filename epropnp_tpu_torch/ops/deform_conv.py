"""Deformable convolution v2 (PyTorch), counterpart of
``epropnp_tpu/ops/deform_conv.py`` (the per-level path).

Parameters keep mmcv's ``ModulatedDeformConv2dPack`` layout, so a released
mmdet checkpoint loads as it is: ``weight`` (cout, c, 3, 3), an optional
``bias``, and ``conv_offset``, a 3x3 conv with the layer's stride whose 27
output channels are (dy, dx) for each tap, then the 9 mask logits. The
flax module stores the offsets as (dx, dy) pairs;
``utils.convert.det_state_dict`` swaps them. Inputs and outputs are NHWC.

The sampling contraction is K3 (``ops.dcn_kernel.dcn_forward``): the CUDA
kernel on CUDA tensors, its torch twin on CPU tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from .dcn_kernel import TAPS, dcn_forward, kernel_weight


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv module to an NHWC tensor (a channels-last view:
    no copy when the weights are channels-last too)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DeformConv(nn.Module):
    """3x3 modulated deformable conv (DCNv2), NHWC in and out.

    ``stride`` > 1 samples at the strided output grid: output (i, j) is
    centred at input (i * stride, j * stride), as torch ``padding=1``.
    ``modulation_scale`` multiplies the sigmoid mask: 2.0 (the JAX
    package's from-scratch default) or 1.0 (mmcv, converted checkpoints).
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 bias: bool = True, modulation_scale: float = 2.0):
        super().__init__()
        self.stride = stride
        self.modulation_scale = modulation_scale
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3,
                                               3))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.conv_offset = nn.Conv2d(in_channels, 3 * TAPS, 3, stride, 1)
        nn.init.kaiming_normal_(self.weight, nonlinearity='relu')
        nn.init.zeros_(self.conv_offset.weight)  # identity-like start
        nn.init.zeros_(self.conv_offset.bias)
        self._weight3 = None  # (key, kernel-layout weight) cache

    def _kernel_weight(self) -> torch.Tensor:
        """The weight in K3's (9, c, cout) layout, re-laid once per change
        of the parameter (its version counter, storage and device)."""
        key = (self.weight._version, self.weight.data_ptr(),
               self.weight.device)
        if self._weight3 is None or self._weight3[0] != key:
            self._weight3 = (key, kernel_weight(self.weight.detach()))
        return self._weight3[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        offset_mask = conv_nhwc(self.conv_offset, x)
        weight3 = self._kernel_weight() if x.is_cuda else None
        return dcn_forward(x, offset_mask, self.weight, self.bias,
                           self.stride, self.modulation_scale,
                           weight3=weight3)
