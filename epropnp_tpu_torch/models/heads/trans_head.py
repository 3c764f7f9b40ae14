"""Direct translation regression head of the CDPN model (PyTorch).

Counterpart of ``epropnp_tpu/models/heads/trans_head.py``: three 3x3
conv+BN+ReLU stages, then an MLP over the flattened feature
(C*8*8 -> 4096 -> 4096 -> 3). Submodule names follow the reference state
dict (``features.{3i}`` Conv, ``features.{3i+1}`` BatchNorm,
``linears.{0,2,4}``); the flatten is NCHW (C major), as in the reference,
so the first Linear's columns are in the reference's order.
"""

from __future__ import annotations

import torch
from torch import nn

from ..norm import BatchNorm2d


class TransHead(nn.Module):

    def __init__(self, in_channels: int = 512, num_layers: int = 3,
                 num_filters: int = 256, output_dim: int = 3,
                 hidden_dim: int = 4096, feat_hw=(8, 8)):
        super().__init__()
        layers = []
        for i in range(num_layers):
            cin = in_channels if i == 0 else num_filters
            layers += [nn.Conv2d(cin, num_filters, 3, 1, 1, bias=False),
                       BatchNorm2d(num_filters, eps=1e-5),
                       nn.ReLU(inplace=True)]
        self.features = nn.Sequential(*layers)
        flat = num_filters * feat_hw[0] * feat_hw[1]
        self.linears = nn.Sequential(
            nn.Linear(flat, hidden_dim), nn.ReLU(inplace=True),
            nn.Linear(hidden_dim, hidden_dim), nn.ReLU(inplace=True),
            nn.Linear(hidden_dim, output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (bs, h, w, C) NHWC -> (bs, 3)."""
        x = self.features(x.permute(0, 3, 1, 2))
        return self.linears(x.flatten(1))
