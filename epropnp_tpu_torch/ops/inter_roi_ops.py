"""Cross-RoI logsumexp/softmax for overlapping regions of interest
(PyTorch), counterpart of ``epropnp_tpu/ops/inter_roi_ops.py``.

Per-RoI maps are normalised across every other RoI of the same image that
overlaps them: each other RoI's map is resampled into the current RoI's
frame and combined by logsumexp, so mixture weights compete across
objects. All pairs are resampled at once with validity masks (a pair that
does not overlap contributes -inf everywhere).

Layout: NHWC maps (bn, rh, rw, chn), boxes (bn, 4) [x1, y1, x2, y2] and
image ids (bn,).
"""

from __future__ import annotations

import math

import torch

from .bilinear_sample import batched_bilinear_sample


def logsumexp_across_rois(roi_inputs: torch.Tensor, roi_boxes: torch.Tensor,
                          roi_img_ids: torch.Tensor) -> torch.Tensor:
    """(bn, rh, rw, chn) -> (bn, rh, rw, chn)."""
    bn, rh, rw, chn = roi_inputs.shape
    if bn == 0:
        return roi_inputs
    dt, dev = roi_inputs.dtype, roi_inputs.device
    wh = roi_boxes[:, 2:] - roi_boxes[:, :2]                  # (bn, 2)
    # pixel-centre image coordinates of each RoI's grid: (bn, rh, rw, 2)
    gy = (torch.arange(rh, dtype=dt, device=dev) + 0.5) / rh
    gx = (torch.arange(rw, dtype=dt, device=dev) + 0.5) / rw
    yy, xx = torch.meshgrid(gy, gx, indexing='ij')
    unit = torch.stack([xx, yy], -1)
    img_xy = roi_boxes[:, None, None, :2] + unit * wh[:, None, None, :]
    # frame i's grid inside RoI j (align_corners=False): (i, j, rh, rw, 2)
    rel = (img_xy[:, None] - roi_boxes[None, :, None, None, :2]) \
        / wh[None, :, None, None, :]
    scale = torch.tensor([rw, rh], dtype=dt, device=dev)
    coords = (rel * scale - 0.5).transpose(0, 1).reshape(bn, bn * rh, rw, 2)
    vals = batched_bilinear_sample(
        roi_inputs, torch.arange(bn, device=dev), coords, 'border'
    ).reshape(bn, bn, rh, rw, chn).transpose(0, 1)           # (i, j, ...)
    inside = ((rel > 0.0) & (rel < 1.0)).all(-1)             # (i, j, rh, rw)
    pair = (roi_img_ids[:, None] == roi_img_ids[None, :]) \
        & ~torch.eye(bn, dtype=torch.bool, device=dev)
    valid = inside & pair[:, :, None, None]
    others = torch.where(valid[..., None], vals, -math.inf)
    stacked = torch.cat([others, roi_inputs[:, None]], 1)
    return torch.logsumexp(stacked, 1)


def logsoftmax_across_rois(roi_inputs, roi_boxes, roi_img_ids,
                           extra_axis=None):
    lse = logsumexp_across_rois(roi_inputs, roi_boxes, roi_img_ids)
    if extra_axis is not None:
        lse = torch.logsumexp(lse, extra_axis, keepdim=True)
    return roi_inputs - lse


def softmax_across_rois(roi_inputs, roi_boxes, roi_img_ids, extra_axis=None):
    return torch.exp(logsoftmax_across_rois(roi_inputs, roi_boxes,
                                            roi_img_ids, extra_axis))
