"""Sine positional encodings (PyTorch), counterpart of
``epropnp_tpu/ops/positional_encoding.py``."""

from __future__ import annotations

import math

import torch


def points_to_enc(points: torch.Tensor, img_sizes: torch.Tensor,
                  num_feats: int = 128, temperature: float = 10000.0,
                  normalize: bool = True,
                  scale: float = 2.0 * math.pi) -> torch.Tensor:
    """Encode continuous 2D points (*, 2) in [x, y] pixels, with image
    sizes (*, 2) in [h, w]. Returns (*, num_feats * 2), [y-enc | x-enc]."""
    if normalize:
        points = points / img_sizes.flip(-1) * scale
    dim_t = torch.arange(num_feats, dtype=points.dtype, device=points.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)
    pos = points[..., None] / dim_t  # (*, 2, num_feats)
    pos = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])],
                      -1).reshape(points.shape[:-1] + (2, num_feats))
    return torch.cat([pos[..., 1, :], pos[..., 0, :]], -1)


def dense_posenc(h: int, w: int, img_h: float, img_w: float,
                 num_feats: int = 128, temperature: float = 10000.0,
                 stride: float = 1.0, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Dense (h, w, num_feats * 2) encoding of feature-pixel centres."""
    ys = (torch.arange(h, dtype=dtype, device=device) + 0.5) * stride
    xs = (torch.arange(w, dtype=dtype, device=device) + 0.5) * stride
    yy, xx = torch.meshgrid(ys, xs, indexing='ij')
    pts = torch.stack([xx, yy], -1)
    sizes = torch.tensor([img_h, img_w], dtype=dtype, device=device)
    return points_to_enc(pts, sizes.expand(pts.shape), num_feats=num_feats,
                         temperature=temperature)
