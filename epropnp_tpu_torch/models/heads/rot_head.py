"""Rotation (dense correspondence) head of the CDPN model (PyTorch).

Counterpart of ``epropnp_tpu/models/heads/rot_head.py``: three
transpose-conv upsampling stages, each followed by two 3x3 convs, then a
5-channel map (3 noc + 2 w2d) and a global 2-vector weight scale from a
pooled linear branch. Submodule names follow the reference state dict:
``features.{9i}`` ConvTranspose, ``features.{9i+1,9i+4,9i+7}`` BatchNorm,
``features.{9i+3,9i+6}`` Conv, ``out_layer``, ``scale_branch``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..norm import BatchNorm2d


class RotHead(nn.Module):

    def __init__(self, in_channels: int = 512, num_layers: int = 3,
                 num_filters: int = 256, output_dim: int = 5):
        super().__init__()
        layers = []
        for i in range(num_layers):
            cin = in_channels if i == 0 else num_filters
            # == flax ConvTranspose(k3, s2, padding ((1, 2), (1, 2))): a
            # reference-exact 2x upsample
            layers += [
                nn.ConvTranspose2d(cin, num_filters, 3, 2, padding=1,
                                   output_padding=1, bias=False),
                BatchNorm2d(num_filters, eps=1e-5), nn.ReLU(inplace=True)]
            for _ in range(2):
                layers += [
                    nn.Conv2d(num_filters, num_filters, 3, 1, 1, bias=False),
                    BatchNorm2d(num_filters, eps=1e-5),
                    nn.ReLU(inplace=True)]
        self.features = nn.Sequential(*layers)
        self.out_layer = nn.Conv2d(num_filters, output_dim, 1, bias=True)
        self.scale_branch = nn.Linear(num_filters, 2)

    def forward(self, x: torch.Tensor):
        """x: (bs, h, w, C) NHWC -> (noc (bs, 8h, 8w, 3), w2d (bs, 8h, 8w, 2),
        scale (bs, 2))."""
        x = self.features(x.permute(0, 3, 1, 2))
        out = self.out_layer(x).permute(0, 2, 3, 1)
        noc, w2d = out[..., :3], out[..., 3:]
        scale = torch.exp(self.scale_branch(x.mean(dim=(2, 3))))
        return noc, w2d, scale
