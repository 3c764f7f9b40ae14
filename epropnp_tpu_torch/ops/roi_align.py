"""RoI Align on NHWC maps (aligned=True, average pooling), PyTorch
counterpart of ``epropnp_tpu/ops/roi_align.py``.

Each output bin averages a fixed 2x2 grid of bilinear samples (the JAX
package's static form of mmcv's ``sampling_ratio=0``), clamped at the
border.
"""

from __future__ import annotations

import torch

from .bilinear_sample import batched_bilinear_sample


def roi_align(feats: torch.Tensor, roi_img_inds: torch.Tensor,
              roi_boxes: torch.Tensor, output_size, spatial_scale: float = 1.0,
              samples_per_bin: int = 2) -> torch.Tensor:
    """feats (num_img, h, w, c); roi_img_inds (n,); roi_boxes (n, 4)
    [x1, y1, x2, y2] in input coordinates; output_size (rh, rw).
    Returns (n, rh, rw, c)."""
    rh, rw = output_size
    s = samples_per_bin
    boxes = roi_boxes * spatial_scale
    x1, y1 = boxes[:, 0], boxes[:, 1]
    bw = (boxes[:, 2] - boxes[:, 0]) / rw
    bh = (boxes[:, 3] - boxes[:, 1]) / rh
    dt, dev = roi_boxes.dtype, roi_boxes.device
    jx = (torch.arange(rw * s, dtype=dt, device=dev) + 0.5) / s
    jy = (torch.arange(rh * s, dtype=dt, device=dev) + 0.5) / s
    # pixel coordinates of the samples; aligned=True shifts by -0.5
    xs = x1[:, None] + jx[None, :] * bw[:, None] - 0.5       # (n, rw*s)
    ys = y1[:, None] + jy[None, :] * bh[:, None] - 0.5       # (n, rh*s)
    n = boxes.shape[0]
    coords = torch.stack([xs[:, None, :].expand(n, rh * s, rw * s),
                          ys[:, :, None].expand(n, rh * s, rw * s)], -1)
    sampled = batched_bilinear_sample(feats, roi_img_inds, coords, 'border')
    c = sampled.shape[-1]
    return sampled.reshape(n, rh, s, rw, s, c).mean((2, 4))
