"""Bilinear sampling of NHWC feature maps at continuous locations (PyTorch).

Counterpart of ``epropnp_tpu/ops/bilinear_sample.py``. Semantics match
``F.grid_sample(align_corners=False)``: a location in feature pixels
addresses pixel centres at integer + 0.5, so callers pass
``x_img / stride - 0.5``. ``padding_mode`` 'border' clamps out-of-range
coordinates; 'zeros' zeroes the contributions of corners outside the map
(the corner rule of ``corner_rows_and_weights``, which K3 follows too).
"""

from __future__ import annotations

import torch


def _combine(gather, x, y, h, w, padding_mode):
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]

    def corner(yi, xi):
        vals = gather(yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long())
        if padding_mode == 'zeros':
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            vals = torch.where(inside[..., None], vals, 0.0)
        return vals

    v00, v01 = corner(y0, x0), corner(y0, x0 + 1)
    v10, v11 = corner(y0 + 1, x0), corner(y0 + 1, x0 + 1)
    return ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
            + (v10 * (1 - wx) + v11 * wx) * wy)


def bilinear_sample(feat: torch.Tensor, coords: torch.Tensor,
                    padding_mode: str = 'border') -> torch.Tensor:
    """Sample ``feat`` (h, w, c) at ``coords`` (*, 2) in [x, y] pixels ->
    (*, c)."""
    h, w = feat.shape[:2]
    return _combine(lambda yi, xi: feat[yi, xi], coords[..., 0],
                    coords[..., 1], h, w, padding_mode)


def batched_bilinear_sample(feats: torch.Tensor, img_inds: torch.Tensor,
                            coords: torch.Tensor,
                            padding_mode: str = 'border') -> torch.Tensor:
    """Per-object sampling from a stack of maps.

    feats (num_img, h, w, c); img_inds (num_obj,); coords (num_obj, *, 2)
    in [x, y] feature pixels. Returns (num_obj, *, c).
    """
    h, w = feats.shape[1:3]
    b = img_inds.reshape((-1,) + (1,) * (coords.ndim - 2))
    return _combine(lambda yi, xi: feats[b, yi, xi], coords[..., 0],
                    coords[..., 1], h, w, padding_mode)
