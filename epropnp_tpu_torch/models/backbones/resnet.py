"""ResNet backbone family (PyTorch), counterpart of
``epropnp_tpu/models/backbones/resnet.py``.

Submodules carry torchvision's names (``conv1``, ``bn1``,
``layer{s}.{i}.conv{j}``, ``layer{s}.{i}.downsample.{0,1}``), so a
torchvision-style state dict loads as it is. The public layout is the JAX
package's: NHWC in, a tuple of NHWC stage features out; the convolutions
run in NCHW inside (a channels-last model keeps them in NHWC memory with no
copy). Bottleneck blocks of the ``dcn_stages`` use a deformable 3x3
``conv2`` (DCNv2, mmcv's bias-free ``ModulatedDeformConv2dPack`` layout),
the strided first block included, as the Det backbone (R101-DCN).
``dtype`` (bf16 for serving and training) is the compute dtype of the stem, the blocks
(BatchNorms included: f32 statistics, bf16 output) and the DCNs; the
parameters stay f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.deform_conv import Conv2d, DeformConv
from ..norm import BatchNorm2d

# depth -> (block, stage_sizes, stage_channels(last = feat dim))
resnet_spec = {
    18: ('basic', (2, 2, 2, 2), (64, 128, 256, 512)),
    34: ('basic', (3, 4, 6, 3), (64, 128, 256, 512)),
    50: ('bottleneck', (3, 4, 6, 3), (64, 128, 256, 512)),
    101: ('bottleneck', (3, 4, 23, 3), (64, 128, 256, 512)),
    152: ('bottleneck', (3, 8, 36, 3), (64, 128, 256, 512)),
}


def _bn(channels: int) -> BatchNorm2d:
    # eps 1e-5 and flax momentum 0.9 (= torch momentum 0.1)
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _downsample(inplanes: int, planes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(inplanes, planes, 1, stride, bias=False), _bn(planes))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_dcn: bool = False, dcn_modulation_scale: float = 2.0,
                 dcn_bias: bool = False, dcn_int8_gather: bool = False):
        super().__init__()
        self.use_dcn = use_dcn
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        if use_dcn:
            self.conv2 = DeformConv(planes, planes, stride, bias=dcn_bias,
                                    modulation_scale=dcn_modulation_scale,
                                    int8_gather=dcn_int8_gather)
        else:
            self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = (_downsample(inplanes, planes * 4, stride)
                           if stride != 1 or inplanes != planes * 4 else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        if self.use_dcn:  # NHWC views in and out of the deformable conv
            out = self.conv2(out.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        else:
            out = self.conv2(out)
        out = torch.relu(self.bn2(out))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNetBackbone(nn.Module):
    """ResNet without the classification head.

    Args:
        depth: 18/34/50/101/152.
        out_indices: which stage outputs (1-based: stage 1 is stride 4,
            stage 4 is stride 32) to return.
        dcn_stages: 1-based stages whose bottlenecks use DCNv2.
        dcn_modulation_scale: 2.0 (from-scratch default) or 1.0 (mmcv).
        dcn_bias: a bias on the DCNs (the flax layout; mmcv has none).
        dcn_int8_gather: int8 DCN sampling (serving only).
        dtype: compute dtype; None computes in the input's dtype.
    """

    def __init__(self, depth: int = 34, out_indices: Sequence[int] = (4,),
                 dcn_stages: Sequence[int] = (),
                 dcn_modulation_scale: float = 2.0,
                 dcn_bias: bool = False,
                 dcn_int8_gather: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        block_name, stage_sizes, stage_channels = resnet_spec[depth]
        block = BasicBlock if block_name == 'basic' else Bottleneck
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, (n_blocks, channels) in enumerate(
                zip(stage_sizes, stage_channels), start=1):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if stage > 1 and i == 0 else 1
                kwargs = {}
                if block is Bottleneck and stage in dcn_stages:
                    kwargs = dict(use_dcn=True,
                                  dcn_modulation_scale=dcn_modulation_scale,
                                  dcn_bias=dcn_bias,
                                  dcn_int8_gather=dcn_int8_gather)
                blocks.append(block(inplanes, channels, stride, **kwargs))
                inplanes = channels * block.expansion
            self.add_module(f'layer{stage}', nn.Sequential(*blocks))
        self.feat_channels = tuple(c * block.expansion for c in stage_channels)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x: (bs, H, W, 3) NHWC -> tuple of (bs, h, w, C) features, in
        the compute dtype."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        outs = []
        for stage in range(1, 5):
            x = getattr(self, f'layer{stage}')(x)
            if stage in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
