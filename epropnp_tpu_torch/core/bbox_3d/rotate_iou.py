"""Rotated (BEV) box IoU (PyTorch, fixed shapes), counterpart of
``epropnp_tpu/core/bbox_3d/rotate_iou.py``.

The intersection polygon of two rectangles is assembled from a fixed set
of 24 candidates (4 + 4 contained vertices, 16 edge intersections),
sorted by angle about their centroid (invalid ones last, ties by index:
the JAX package's rank-and-permute is a stable sort written for the TPU)
and measured with the shoelace formula; invalid candidates collapse onto
the first valid vertex and add no area. Box layout ``[cx, cy, w, h, a]``.
"""

from __future__ import annotations

import torch


def rect_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(*, 5) xywhr -> (*, 4, 2) corners (counterclockwise)."""
    cx, cy, w, h, a = boxes.unbind(-1)
    dx = torch.stack([w, w, -w, -w], -1) * 0.5
    dy = torch.stack([h, -h, -h, h], -1) * 0.5
    cos, sin = torch.cos(a)[..., None], torch.sin(a)[..., None]
    x = cx[..., None] + dx * cos - dy * sin
    y = cy[..., None] + dx * sin + dy * cos
    return torch.stack([x, y], -1)


def _points_in_rect(pts, box, eps=1e-6):
    """pts (*, n, 2) inside rect (*, 5) -> (*, n) bool."""
    c = box[..., None, :2]
    a = box[..., 4]
    cos, sin = torch.cos(a)[..., None], torch.sin(a)[..., None]
    d = pts - c
    u = d[..., 0] * cos + d[..., 1] * sin
    v = -d[..., 0] * sin + d[..., 1] * cos
    return ((u.abs() <= box[..., None, 2] * 0.5 + eps)
            & (v.abs() <= box[..., None, 3] * 0.5 + eps))


def _segment_intersections(c1, c2, eps=1e-12):
    """All 16 edge-pair intersections of quads (*, 4, 2) x (*, 4, 2) ->
    (*, 16, 2) points and (*, 16) validity."""
    p, q = c1, c2
    r = torch.roll(c1, -1, -2) - c1
    s = torch.roll(c2, -1, -2) - c2
    pq = q[..., None, :, :] - p[..., :, None, :]        # (*, 4, 4, 2)
    rxs = (r[..., :, None, 0] * s[..., None, :, 1]
           - r[..., :, None, 1] * s[..., None, :, 0])
    den = torch.where(rxs.abs() < eps, torch.ones_like(rxs), rxs)
    t = (pq[..., 0] * s[..., None, :, 1] - pq[..., 1] * s[..., None, :, 0]) \
        / den
    u = (pq[..., 0] * r[..., :, None, 1] - pq[..., 1] * r[..., :, None, 0]) \
        / den
    valid = (rxs.abs() >= eps) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = p[..., :, None, :] + t[..., None] * r[..., :, None, :]
    batch = pts.shape[:-3]
    return pts.reshape(batch + (16, 2)), valid.reshape(batch + (16,))


def rect_intersection_area(box1: torch.Tensor, box2: torch.Tensor):
    """Intersection area of (*, 5) x (*, 5) rectangles -> (*)."""
    box1, box2 = torch.broadcast_tensors(box1, box2)
    c1, c2 = rect_corners(box1), rect_corners(box2)
    in12 = _points_in_rect(c1, box2)
    in21 = _points_in_rect(c2, box1)
    ipts, ivalid = _segment_intersections(c1, c2)
    pts = torch.cat([c1, c2, ipts], -2)                  # (*, 24, 2)
    valid = torch.cat([in12, in21, ivalid], -1)          # (*, 24)
    num_valid = valid.sum(-1)
    centroid = torch.where(valid[..., None], pts, 0.0).sum(-2) \
        / num_valid.clamp(min=1)[..., None]
    ang = torch.atan2(pts[..., 1] - centroid[..., None, 1],
                      pts[..., 0] - centroid[..., None, 0])
    ang = torch.where(valid, ang, torch.inf)
    order = torch.sort(ang, dim=-1, stable=True).indices
    pts_s = torch.take_along_dim(pts, order[..., None], -2)
    valid_s = torch.take_along_dim(valid, order, -1)
    pts_s = torch.where(valid_s[..., None], pts_s, pts_s[..., :1, :])
    d = pts_s - centroid[..., None, :]
    d_next = torch.roll(d, -1, -2)
    cross = d[..., 0] * d_next[..., 1] - d[..., 1] * d_next[..., 0]
    area = 0.5 * cross.sum(-1).abs()
    return torch.where(num_valid >= 3, area, 0.0)


def rotated_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """Aligned IoU of (n, 5) vs (n, 5) rotated boxes -> (n,)."""
    inter = rect_intersection_area(boxes1, boxes2)
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    return inter / torch.clamp(a1 + a2 - inter, min=eps)


def rotated_iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor,
                       eps: float = 1e-8, criterion: str = 'iou'
                       ) -> torch.Tensor:
    """All-pairs IoU of (*, n, 5) x (*, m, 5) rotated boxes -> (*, n, m).
    ``criterion``: 'iou' (union), 'iof1' (area of boxes1) or 'inter' (the
    intersection area)."""
    inter = rect_intersection_area(boxes1[..., :, None, :],
                                   boxes2[..., None, :, :])
    if criterion == 'inter':
        return inter
    a1 = (boxes1[..., 2] * boxes1[..., 3])[..., :, None]
    a2 = (boxes2[..., 2] * boxes2[..., 3])[..., None, :]
    denom = a1 if criterion == 'iof1' else a1 + a2 - inter
    return inter / torch.clamp(denom, min=eps)


def _bev(b: torch.Tensor) -> torch.Tensor:
    """Camera-frame boxes [l, h, w, x, y, z, ry] -> BEV [x, z, l, w, ry]."""
    return torch.stack([b[..., 3], b[..., 5], b[..., 0], b[..., 2],
                        b[..., 6]], -1)


def box3d_overlap_camera(boxes1: torch.Tensor, boxes2: torch.Tensor,
                         eps: float = 1e-8, aligned: bool = True
                         ) -> torch.Tensor:
    """3D IoU of camera-frame boxes [l, h, w, x, y, z, ry]: the BEV
    footprint on the x-z plane times the vertical (y, downward) overlap.
    ``aligned``: (n, 7) x (n, 7) -> (n,); else all pairs -> (n, m)."""
    if aligned:
        inter_bev = rect_intersection_area(_bev(boxes1), _bev(boxes2))
        y1_bot, y2_bot = boxes1[:, 4], boxes2[:, 4]
        y1_top, y2_top = y1_bot - boxes1[:, 1], y2_bot - boxes2[:, 1]
        v1 = boxes1[:, 0] * boxes1[:, 1] * boxes1[:, 2]
        v2 = boxes2[:, 0] * boxes2[:, 1] * boxes2[:, 2]
    else:
        inter_bev = rotated_iou_matrix(_bev(boxes1), _bev(boxes2),
                                       criterion='inter')
        y1_bot, y2_bot = boxes1[:, 4][:, None], boxes2[:, 4][None, :]
        y1_top = (boxes1[:, 4] - boxes1[:, 1])[:, None]
        y2_top = (boxes2[:, 4] - boxes2[:, 1])[None, :]
        v1 = (boxes1[:, 0] * boxes1[:, 1] * boxes1[:, 2])[:, None]
        v2 = (boxes2[:, 0] * boxes2[:, 1] * boxes2[:, 2])[None, :]
    inter_h = torch.clamp(torch.minimum(y1_bot, y2_bot)
                          - torch.maximum(y1_top, y2_top), min=0.0)
    inter = inter_bev * inter_h
    return inter / torch.clamp(v1 + v2 - inter, min=eps)
