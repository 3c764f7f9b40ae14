"""Fixed-shape non-maximum suppression (PyTorch), counterpart of
``epropnp_tpu/core/bbox_3d/nms.py``.

The IoU matrix is taken in score order (stable: equal scores keep their
index order, as ``jnp.argsort``), and the greedy keep mask is the fixed
point of ``keep = valid & ~(keep @ suppress)``: entries whose suppression
chain is k deep are final after k passes, so the loop ends at the longest
chain (n passes at most) with the sequential greedy scan's answer. Every
function takes a leading batch of independent problems (one per image).
"""

from __future__ import annotations

import torch

from .rotate_iou import rotated_iou_matrix


def _greedy_suppress(iou_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                     thresh: float) -> torch.Tensor:
    """(*, n, n) IoU and (*, n) validity, both in score order -> keep."""
    n = iou_sorted.shape[-1]
    idx = torch.arange(n, device=iou_sorted.device)
    sup = ((iou_sorted > thresh) & (idx[None, :] > idx[:, None])).to(
        iou_sorted.dtype)
    keep = valid_sorted
    for _ in range(n):
        killed = (keep.to(sup.dtype)[..., None, :] @ sup)[..., 0, :] > 0.5
        new = valid_sorted & ~killed
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _nms_sorted(boxes, scores, thresh, valid_mask, iou_fn):
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    b = torch.take_along_dim(boxes, order[..., None], -2)
    valid = torch.take_along_dim(valid_mask, order, -1)
    keep_sorted = _greedy_suppress(iou_fn(b), valid, thresh)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def _axis_aligned_iou(b):
    x1 = torch.maximum(b[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(b[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(b[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(b[..., :, None, 3], b[..., None, :, 3])
    inter = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area[..., :, None] + area[..., None, :]
                               - inter, min=1e-8)


def nms_rotated(boxes, scores, thresh: float, valid_mask=None):
    """Rotated NMS: boxes (*, n, 5) [cx, cy, w, h, a] -> (*, n) keep."""
    if valid_mask is None:
        valid_mask = torch.ones_like(scores, dtype=torch.bool)
    return _nms_sorted(boxes, scores, thresh, valid_mask,
                       lambda b: rotated_iou_matrix(b, b))


def nms_axis_aligned(boxes, scores, thresh: float, valid_mask=None):
    """Axis-aligned NMS: boxes (*, n, 4) [x1, y1, x2, y2] -> (*, n) keep."""
    if valid_mask is None:
        valid_mask = torch.ones_like(scores, dtype=torch.bool)
    return _nms_sorted(boxes, scores, thresh, valid_mask, _axis_aligned_iou)


def nms_axis_aligned_per_image(boxes, scores, thresh: float, n_img: int,
                               valid_mask):
    """Axis-aligned NMS over image-contiguous blocks: boxes (n_img * k, 4)
    with image i in [i k, (i + 1) k) (the ``get_preds`` layout)."""
    k = boxes.shape[0] // n_img
    return nms_axis_aligned(boxes.reshape(n_img, k, 4),
                            scores.reshape(n_img, k), thresh,
                            valid_mask.reshape(n_img, k)).reshape(-1)
