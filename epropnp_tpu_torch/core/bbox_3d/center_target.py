"""Projected-3D-centre targets by analytic ray-box thickness (PyTorch),
counterpart of ``epropnp_tpu/core/bbox_3d/center_target.py``.

The reference renders each GT box with a mesh rasterizer to get the
per-pixel z-thickness of the box volume and takes the thickness-weighted
pixel centroid as the "projected 3D centre" target. A camera ray through a
box has a closed-form entry and exit (the slab test), so the thickness is
computed per (object, output pixel) directly. Rays go through the dense
``img_dense_x2d`` map (original-image coordinates of each output cell, flip
and crop aware); centroids are taken on the augmented-image grid.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ...ops.pnp.common import yaw_to_rot_mat
from ...ops.pnp.linalg import inv_3x3


class CenterTargets(NamedTuple):
    centers_2d: torch.Tensor  # (num_obj, 2)
    bboxes_2d: torch.Tensor   # (num_obj, 4) rendered boxes (or input boxes)
    valid_mask: torch.Tensor  # (num_obj,)


def ray_box_thickness(ray_dirs, bboxes_3d, z_min: float = 1e-2):
    """Z-thickness of boxes along camera rays.

    ray_dirs (num_obj, h, w, 3) with unit z (the ray parameter is the
    camera depth); bboxes_3d (num_obj, 7) [l, h, w, x, y, z, ry].
    Returns (thickness, z_near), each (num_obj, h, w).
    """
    rot = yaw_to_rot_mat(bboxes_3d[:, 6])                   # (n, 3, 3)
    t = bboxes_3d[:, 3:6]
    half = bboxes_3d[:, :3] * 0.5
    # into the box frame: o_b = -R^T t, d_b = R^T d
    o_b = -torch.einsum('nji,nj->ni', rot, t)
    d_b = torch.einsum('nji,nhwj->nhwi', rot, ray_dirs)
    safe_d = torch.where(d_b.abs() < 1e-9,
                         torch.where(d_b < 0, -1e-9, 1e-9).to(d_b.dtype),
                         d_b)
    t1 = (-half[:, None, None] - o_b[:, None, None]) / safe_d
    t2 = (half[:, None, None] - o_b[:, None, None]) / safe_d
    t_near = torch.minimum(t1, t2).amax(-1)
    t_far = torch.maximum(t1, t2).amin(-1)
    t_near = torch.clamp(t_near, min=z_min)  # z-clip like the rasterizer
    return torch.clamp(t_far - t_near, min=0.0), t_near


@dataclasses.dataclass(frozen=True)
class VolumeCenter:
    output_stride: int = 4
    occlusion_factor: float = 0.0
    get_bbox_2d: bool = False
    min_box_size: float = 4.0
    mask_threshold: float = 0.5

    def get_centers_2d(self, bboxes_2d, bboxes_3d, obj_img_inds,
                       img_dense_x2d_small, img_dense_x2d_mask_small,
                       cam_intrinsic, obj_mask=None) -> CenterTargets:
        """bboxes_2d (num_obj, 4); bboxes_3d (num_obj, 7); obj_img_inds
        (num_obj,); img_dense_x2d_small (num_img, h_out, w_out, 2) and its
        mask (num_img, h_out, w_out, 1); cam_intrinsic (num_img, 3, 3);
        obj_mask (num_obj,) marks the live slots of a padded GT set."""
        num_obj = bboxes_3d.shape[0]
        h_out, w_out = img_dense_x2d_small.shape[1:3]
        dtype, dev = bboxes_3d.dtype, bboxes_3d.device
        x2d = img_dense_x2d_small[obj_img_inds]            # (n, h, w, 2)
        k_inv = inv_3x3(cam_intrinsic)[obj_img_inds]
        homo = torch.cat([x2d, torch.ones_like(x2d[..., :1])], -1)
        rays = torch.einsum('nij,nhwj->nhwi', k_inv, homo)
        rays = rays / rays[..., 2:]                        # unit z

        thickness, z_near = ray_box_thickness(rays, bboxes_3d)
        thickness = thickness * img_dense_x2d_mask_small[obj_img_inds, ..., 0]
        if self.occlusion_factor > 0:
            # occlusion: total thickness of same-image boxes closer in z
            same = obj_img_inds[:, None] == obj_img_inds[None, :]
            closer = z_near[None] < z_near[:, None]        # j before i
            not_self = ~torch.eye(num_obj, dtype=torch.bool,
                                  device=dev)[..., None, None]
            occ = torch.where(same[..., None, None] & closer & not_self,
                              thickness[None], 0.0).sum(1)
            thickness = thickness * torch.exp(-self.occlusion_factor * occ)

        # centroid over the augmented-image point grid (stride centres)
        s = self.output_stride
        ys = torch.arange(h_out, dtype=dtype, device=dev) * s + s / 2
        xs = torch.arange(w_out, dtype=dtype, device=dev) * s + s / 2
        yy, xx = torch.meshgrid(ys, xs, indexing='ij')
        points = torch.stack([xx, yy], -1)                 # (h, w, 2)
        w_sum = thickness.sum((1, 2))
        centers = (thickness[..., None] * points).sum((1, 2)) \
            / torch.clamp(w_sum, min=1e-12)[..., None]
        valid = w_sum >= 1e-6

        if self.get_bbox_2d:
            hit = thickness > 0
            x1 = torch.where(hit.any(1), xs - s / 2,
                             torch.tensor(float(w_out * s), dtype=dtype,
                                          device=dev)).amin(-1)
            x2 = torch.where(hit.any(1), xs + s / 2, 0.0).amax(-1)
            y1 = torch.where(hit.any(2), ys - s / 2,
                             torch.tensor(float(h_out * s), dtype=dtype,
                                          device=dev)).amin(-1)
            y2 = torch.where(hit.any(2), ys + s / 2, 0.0).amax(-1)
            bboxes_2d = torch.stack([x1, y1, x2, y2], -1)
        valid = valid & (bboxes_2d[:, 2:] - bboxes_2d[:, :2]
                         >= self.min_box_size).all(-1)
        if obj_mask is not None:
            valid = valid & obj_mask
        return CenterTargets(centers, bboxes_2d, valid)
