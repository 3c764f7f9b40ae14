"""3D box geometry of the Det suite (PyTorch), counterpart of
``epropnp_tpu/core/bbox_3d/misc.py``: unit NOC directions, projection with
border clamping, box corners, clipping of box edges against a plane,
3D-to-2D boxes and the per-image BEV NMS glue. Box layout
``bbox_3d = [l, h, w, x, y, z, ry]`` (camera frame, y down).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.pnp.common import yaw_to_rot_mat
from .nms import nms_rotated

def gen_unit_noc(num_pts: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Fibonacci-sphere unit directions (num_pts, 3)."""
    indices = torch.arange(num_pts, dtype=dtype, device=device) + 0.5
    phi = torch.arccos(1.0 - 2.0 * indices / num_pts)
    theta = math.pi * (1.0 + 5.0 ** 0.5) * indices
    return torch.stack([torch.cos(theta) * torch.sin(phi),
                        torch.sin(theta) * torch.sin(phi),
                        torch.cos(phi)], -1)


def project_to_image_r_mat(x3d, r_mat, t_vec, cam_intrinsic, img_shapes,
                           z_min: float = 0.5, allowed_border: float = 200,
                           return_z: bool = False,
                           return_clip_mask: bool = False):
    """Project (*, n, 3) points by [R|t] and the intrinsics, depth clamped
    at ``z_min`` and the result clamped to the image (``img_shapes`` (*, 2)
    [h, w]) widened by ``allowed_border``. Returns x2d (*, n, 2), then z
    (*, n, 1) and the clip mask (*, n) where asked for."""
    proj_r = cam_intrinsic @ r_mat
    proj_t = torch.einsum('...ij,...j->...i', cam_intrinsic, t_vec)
    xyz = torch.einsum('...ij,...nj->...ni', proj_r, x3d) \
        + proj_t[..., None, :]
    z = xyz[..., 2:]
    z_clip_mask = z < z_min
    z = torch.clamp(z, min=z_min)
    x2d = xyz[..., :2] / z
    x2d_min = -allowed_border - 0.5
    x2d_max = img_shapes.flip(-1)[..., None, :] + (allowed_border - 0.5)
    if return_clip_mask:
        oob = (x2d < x2d_min) | (x2d > x2d_max)
        clip_mask = z_clip_mask[..., 0] | oob.any(-1)
    x2d = torch.minimum(torch.clamp(x2d, min=x2d_min), x2d_max)
    outs = (x2d,)
    if return_z:
        outs = outs + (z,)
    if return_clip_mask:
        outs = outs + (clip_mask,)
    return outs[0] if len(outs) == 1 else outs


def project_to_image(x3d, pose, cam_intrinsic, img_shapes, z_min: float = 0.5,
                     allowed_border: float = 200, return_z: bool = False,
                     return_clip_mask: bool = False):
    """:func:`project_to_image_r_mat` for 4DoF poses [x, y, z, yaw]."""
    return project_to_image_r_mat(
        x3d, yaw_to_rot_mat(pose[..., 3]), pose[..., :3], cam_intrinsic,
        img_shapes, z_min, allowed_border, return_z, return_clip_mask)


# corner layout and edges of a camera-frame box
EDGE_CORNER_IDX = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
     [0, 4], [1, 5], [2, 6], [3, 7]])
_UNIT_CORNERS = np.array(
    [[0.5, 0.5, 0.5], [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5], [-0.5, 0.5, 0.5],
     [0.5, -0.5, 0.5], [0.5, -0.5, -0.5], [-0.5, -0.5, -0.5],
     [-0.5, -0.5, 0.5]], dtype=np.float32)


def compute_box_3d(bbox_3d: torch.Tensor) -> torch.Tensor:
    """(*, 7) [l, h, w, x, y, z, ry] -> corners (*, 8, 3)."""
    rot = yaw_to_rot_mat(bbox_3d[..., 6])
    corners = torch.as_tensor(_UNIT_CORNERS, dtype=bbox_3d.dtype,
                              device=bbox_3d.device) * bbox_3d[..., None, :3]
    return torch.einsum('...ij,...nj->...ni', rot, corners) \
        + bbox_3d[..., None, 3:6]


def edge_intersection(corners, clip_axis: int, clip_val, greater: bool,
                      edge_valid_mask=None):
    """Clip the 12 box edges against ``coord > clip_val`` (or ``<``).

    All candidate intersections are computed from the entry state and
    written in edge order (later edges win on a shared corner), as the
    reference's nonzero scatter. corners (bs, 8, d); clip_val (bs,).
    Returns (new_corners, new_inside (bs, 8), edge_valid_mask (bs, 12)).
    """
    cmp = torch.gt if greater else torch.lt
    bs = corners.shape[0]
    e0 = torch.as_tensor(EDGE_CORNER_IDX[:, 0], device=corners.device)
    e1 = torch.as_tensor(EDGE_CORNER_IDX[:, 1], device=corners.device)
    if edge_valid_mask is None:
        edge_valid_mask = torch.ones((bs, 12), dtype=torch.bool,
                                     device=corners.device)
    inside = cmp(corners[..., clip_axis], clip_val[:, None])     # (bs, 8)
    clipped = (inside[:, e0] ^ inside[:, e1]) & edge_valid_mask  # (bs, 12)
    p0, p1 = corners[:, e0, :], corners[:, e1, :]
    a0, a1 = p0[..., clip_axis], p1[..., clip_axis]
    w0 = a1 - clip_val[:, None]
    w1 = clip_val[:, None] - a0
    den = torch.where(a1 == a0, torch.full_like(a1, 1e-12), a1 - a0)
    inv = torch.clamp(1.0 / den, -1e6, 1e6)
    inter = (p0 * w0[..., None] + p1 * w1[..., None]) * inv[..., None]
    clip_idx = torch.where(cmp(a0, clip_val[:, None]), e1.expand(bs, 12),
                           e0.expand(bs, 12))
    new_corners, new_inside = corners, inside
    slots = torch.arange(corners.shape[1], device=corners.device)
    for e in range(12):
        write = (clip_idx[:, e:e + 1] == slots) & clipped[:, e:e + 1]
        new_corners = torch.where(write[..., None], inter[:, e:e + 1, :],
                                  new_corners)
        new_inside = new_inside | write
    edge_valid_mask = edge_valid_mask & new_inside[:, e0] & new_inside[:, e1]
    return new_corners, new_inside, edge_valid_mask


def rot_mat_to_yaw(rot_mat: torch.Tensor) -> torch.Tensor:
    """(*, 3, 3) rotation matrices -> (*) yaw about the camera's y axis."""
    return torch.atan2(rot_mat[..., 0, 2] - rot_mat[..., 2, 0],
                       rot_mat[..., 0, 0] + rot_mat[..., 2, 2])


def bboxes_3d_to_2d(bbox_3d, cam_intrinsic, imsize, z_clip: float = 0.1,
                    min_size: float = 4.0, clip: bool = False):
    """(bs, 7) boxes -> (bs, 4) image boxes and (bs,) validity (a box of
    at least ``min_size`` pixels on each side); imsize (bs, 2) [h, w].
    ``clip`` also clips the projected edges to the image before taking
    the extent, so that corners off the canvas do not count."""
    bs = bbox_3d.shape[0]
    if bs == 0:
        return (bbox_3d.new_zeros((0, 4)),
                torch.zeros((0,), dtype=torch.bool, device=bbox_3d.device))
    corners = compute_box_3d(bbox_3d)
    zc = torch.full((bs,), z_clip, dtype=bbox_3d.dtype, device=bbox_3d.device)
    corners, in_front, valid = edge_intersection(corners, 2, zc, True)
    pts = torch.einsum('...ni,...ji->...nj', corners, cam_intrinsic)
    pts_2d = pts[..., :2] / torch.clamp(pts[..., 2:], min=z_clip) + 0.5
    in_canvas = in_front
    if clip:
        zero = torch.zeros((bs,), dtype=bbox_3d.dtype, device=bbox_3d.device)
        pts_2d, cx0, valid = edge_intersection(pts_2d, 0, zero, True, valid)
        pts_2d, cy0, valid = edge_intersection(pts_2d, 1, zero, True, valid)
        pts_2d, cx1, valid = edge_intersection(pts_2d, 0, imsize[:, 1],
                                               False, valid)
        pts_2d, cy1, valid = edge_intersection(pts_2d, 1, imsize[:, 0],
                                               False, valid)
        in_canvas = in_canvas & cx0 & cx1 & cy0 & cy1
    wh = imsize.flip(-1)
    big = torch.where(in_canvas[..., None], pts_2d,
                      wh[:, None, :].expand_as(pts_2d))
    x0y0 = torch.clamp(big.min(1).values, min=0.0)
    small = torch.where(in_canvas[..., None], pts_2d, 0.0)
    x1y1 = torch.minimum(small.max(1).values, wh)
    bbox = torch.cat([x0y0, x1y1], 1)
    return bbox, (x1y1 - x0y0).min(1).values >= min_size


def xywhr2xyxyr(boxes_xywhr: torch.Tensor) -> torch.Tensor:
    """(n, 5) rotated boxes [cx, cy, w, h, r] -> [x1, y1, x2, y2, r]."""
    half_w = boxes_xywhr[:, 2] / 2
    half_h = boxes_xywhr[:, 3] / 2
    return torch.stack([
        boxes_xywhr[:, 0] - half_w, boxes_xywhr[:, 1] - half_h,
        boxes_xywhr[:, 0] + half_w, boxes_xywhr[:, 1] + half_h,
        boxes_xywhr[:, 4]], -1)


def batched_bev_nms(bbox_3d: torch.Tensor, batch_inds: torch.Tensor,
                    nms_thr: float = 0.25) -> torch.Tensor:
    """BEV NMS with groups (classes, images) kept apart by the
    coordinate-offset trick. bbox_3d (n, 8+) [l, h, w, x, y, z, ry, score,
    ...], batch_inds (n,) the group ids -> (n,) keep mask."""
    return batched_bev_nms_per_image(bbox_3d, batch_inds, 1, nms_thr)


def batched_bev_nms_per_image(bbox_3d: torch.Tensor,
                              class_inds: torch.Tensor, n_img: int,
                              nms_thr: float = 0.25) -> torch.Tensor:
    """BEV NMS over image-contiguous blocks, classes kept apart by the
    coordinate-offset trick within each image. bbox_3d (n_img * k, 8+)
    [l, h, w, x, y, z, ry, score, ...] -> (n_img * k,) keep."""
    k = bbox_3d.shape[0] // n_img
    b = bbox_3d.reshape(n_img, k, bbox_3d.shape[-1])
    groups = class_inds.reshape(n_img, k)
    if k <= 1:
        return torch.ones(n_img * k, dtype=torch.bool, device=b.device)
    bev = torch.stack([b[..., 3], b[..., 5], b[..., 0], b[..., 2], b[..., 6]],
                      -1)
    span = ((bev[..., :2] + bev[..., 2:4]).amax((1, 2))
            - (bev[..., :2] - bev[..., 2:4]).amin((1, 2)))
    offset = (span * 2.0)[:, None] * groups.to(bev.dtype)
    bev = torch.cat([bev[..., :2] + offset[..., None], bev[..., 2:]], -1)
    return nms_rotated(bev, b[..., 7], nms_thr).reshape(-1)
