"""Deformable convolution v2 (PyTorch), counterpart of
``epropnp_tpu/ops/deform_conv.py``: the per-level path and the
level-packed path.

Parameters keep mmcv's ``ModulatedDeformConv2dPack`` layout, so a released
mmdet checkpoint loads as it is: ``weight`` (cout, c, 3, 3), an optional
``bias``, and ``conv_offset``, a 3x3 conv with the layer's stride whose 27
output channels are (dy, dx) for each tap, then the 9 mask logits. The
flax module stores the offsets as (dx, dy) pairs;
``utils.convert.det_state_dict`` swaps them. Inputs and outputs are NHWC.

The sampling contraction is K3 (``ops.dcn_kernel.dcn_forward``): the CUDA
kernel on CUDA tensors, its torch twin on CPU tensors; in training, with
the backward of ``ops.dcn_kernel.DCNFunction``, in f32 or bf16, per level
or on a canvas of levels (the offset conv, K3's level table and the copy
of each level's rows into the output canvas all carry the gradient back).
"""

from __future__ import annotations

import torch
from torch import nn

from .dcn_kernel import TAPS, dcn_forward, kernel_weight, quantize_nhwc


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype: a bf16 input runs
    a bf16 convolution with the (f32) parameters cast on the fly."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv module to an NHWC tensor (a channels-last view:
    no copy when the weights are channels-last too)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DeformConv(nn.Module):
    """3x3 modulated deformable conv (DCNv2), NHWC in and out, computing
    in its input's dtype (f32, or bf16 with the parameters cast).

    ``stride`` > 1 samples at the strided output grid: output (i, j) is
    centred at input (i * stride, j * stride), as torch ``padding=1``.
    ``modulation_scale`` multiplies the sigmoid mask: 2.0 (the JAX
    package's from-scratch default) or 1.0 (mmcv, converted checkpoints).
    ``int8_gather`` (serving only) quantizes the map per channel to int8
    before the sampling (``quantize_nhwc``), the scales folded into the
    weight, as the JAX package's int8 gather table.

    Sampling positions and corner weights are computed in f32 from the
    offset conv's output (mmcv semantics), also in bf16: there the JAX
    package adds grid, tap and offset in bf16, which at map widths of 64
    and more spaces positions 0.5 px apart, and 1 px apart from 128 (an
    XLA fusion may keep them in f32 instead). The port does not repeat
    that rounding.
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 bias: bool = True, modulation_scale: float = 2.0,
                 int8_gather: bool = False):
        super().__init__()
        self.stride = stride
        self.modulation_scale = modulation_scale
        self.int8_gather = int8_gather
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3,
                                               3))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.conv_offset = Conv2d(in_channels, 3 * TAPS, 3, stride, 1)
        nn.init.kaiming_normal_(self.weight, nonlinearity='relu')
        nn.init.zeros_(self.conv_offset.weight)  # identity-like start
        nn.init.zeros_(self.conv_offset.bias)
        self._weight3 = None  # (key, kernel-layout weight) cache

    def _kernel_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight in K3's (9, c, cout) layout and ``dtype``. Where
        autograd records (training), it is re-laid at every call in the
        parameter's dtype (K3's ``DCNFunction`` casts it to the map's and
        returns its gradient unrounded, as JAX's f32 kernel gradient) and
        carries the gradient back to ``weight``; otherwise it is re-laid
        once per change of the parameter (its version counter, storage,
        device) or of the dtype."""
        if torch.is_grad_enabled() and self.weight.requires_grad:
            return kernel_weight(self.weight)
        key = (self.weight._version, self.weight.data_ptr(),
               self.weight.device, dtype)
        if self._weight3 is None or self._weight3[0] != key:
            self._weight3 = (key, kernel_weight(self.weight.detach()).to(
                dtype))
        return self._weight3[1]

    def _sample(self, x, offset_mask, levels=None):
        weight3 = self._kernel_weight(x.dtype)
        if self.int8_gather:
            x, weight3 = quantize_nhwc(x, weight3)
        return dcn_forward(x, offset_mask, weight3, self.bias, self.stride,
                           self.modulation_scale, levels=levels)

    def forward(self, x: torch.Tensor, layout=None) -> torch.Tensor:
        """x (n, h, w, c) -> (n, ho, wo, cout); with a ``LevelLayout``
        (``ops.level_pack``), x is a canvas of pyramid levels with zero
        gaps and so is the output."""
        if layout is not None:
            return self._forward_packed(x, layout)
        return self._sample(x, conv_nhwc(self.conv_offset, x))

    def _forward_packed(self, x: torch.Tensor, layout) -> torch.Tensor:
        """The offset conv runs once on the canvas (its zero gaps give each
        level 'same' padding); every level samples its own region only;
        all levels contract in one K3 launch. The output holds the bias
        inside the regions and zeros in the gaps."""
        if self.stride != 1:
            raise ValueError('level-packed DeformConv is stride-1 only')
        regions = layout.regions()
        flat = self._sample(x, conv_nhwc(self.conv_offset, x), regions)
        n = x.shape[0]
        out = flat.new_zeros((n,) + layout.canvas_hw + (flat.shape[-1],))
        start = 0
        for y, x0, h, w in regions:
            out[:, y:y + h, x0:x0 + w] = flat[start:start + n * h * w].reshape(
                n, h, w, -1)
            start += n * h * w
        return out
