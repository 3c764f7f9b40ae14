"""Grouped linear layer (PyTorch), counterpart of
``epropnp_tpu/ops/group_linear.py``; parameters ``weight`` (g, dout, din)
and ``bias`` (g, dout) as the reference's ``GroupLinear``."""

from __future__ import annotations

import math

import torch
from torch import nn


class GroupLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, groups: int):
        super().__init__()
        self.groups = groups
        self.in_features, self.out_features = in_features, out_features
        din, dout = in_features // groups, out_features // groups
        bound = 1.0 / math.sqrt(din)
        self.weight = nn.Parameter(torch.empty(groups, dout, din).uniform_(
            -bound, bound))
        self.bias = nn.Parameter(torch.zeros(groups, dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch = x.shape[:-1]
        xg = x.reshape(batch + (self.groups, -1))
        out = torch.einsum('...gi,goi->...go', xg, self.weight) + self.bias
        return out.reshape(batch + (self.out_features,))
