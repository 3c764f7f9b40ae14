"""Batched pinhole camera with analytic pose-tangent Jacobian (PyTorch).

Counterpart of ``epropnp_tpu/ops/pnp/camera.py``: projection with z
clamping, optional image-bound clamping, the analytic Jacobian of the
projected points w.r.t. the local pose tangent, and zeroing of Jacobian
rows where a clamp is active. The camera is an immutable dataclass; the
batch helpers return new instances.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .common import pose_to_rot_mat, skew


def _bound_rows(b):
    """Broadcast a bound (scalar or (*, 2)) over the point axis."""
    if isinstance(b, torch.Tensor) and b.ndim > 0:
        return b[..., None, :]
    return b


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    """Batched pinhole camera.

    Attributes:
        cam_mats: (*, 3, 3) intrinsic matrices.
        lb: None | scalar | (*, 2) lower projection bound in [x, y].
        ub: None | scalar | (*, 2) upper projection bound in [x, y].
        z_min: depth clamp.
    """

    cam_mats: torch.Tensor
    lb: Optional[Union[float, torch.Tensor]] = None
    ub: Optional[Union[float, torch.Tensor]] = None
    z_min: float = 0.1

    @classmethod
    def from_img_shape(cls, cam_mats, img_shape, z_min: float = 0.1,
                       allowed_border: float = 200.0) -> 'PerspectiveCamera':
        """Bounds from an image shape (*, 2) in [h, w]: ``lb = -0.5 -
        border`` (a scalar), ``ub = [w, h] - 0.5 + border``."""
        img_shape = torch.as_tensor(img_shape, device=cam_mats.device)
        ub = img_shape.flip(-1) + (-0.5 + allowed_border)
        return cls(cam_mats=cam_mats, lb=-0.5 - allowed_border, ub=ub,
                   z_min=z_min)

    def replace(self, **kwargs) -> 'PerspectiveCamera':
        return dataclasses.replace(self, **kwargs)

    @property
    def has_bounds(self) -> bool:
        return self.lb is not None and self.ub is not None

    def project(self, x3d, pose, out_jac: bool = False, clip_jac: bool = True):
        """Project points and (optionally) the analytic pose Jacobian.

        Args:
            x3d: (*, n, 3)
            pose: (*, 4) or (*, 7)

        Returns:
            (x2d_proj (*, n, 2), jac (*, n, 2, dof) | None)
        """
        rot = pose_to_rot_mat(pose)
        x3d_rot = torch.einsum('...ni,...ji->...nj', x3d, rot)
        x2dh = torch.einsum('...ni,...ji->...nj',
                            x3d_rot + pose[..., None, :3], self.cam_mats)
        zcam = torch.clamp(x2dh[..., 2:3], min=self.z_min)
        x2d_proj = x2dh[..., :2] / zcam

        if self.has_bounds:
            lb_b, ub_b = _bound_rows(self.lb), _bound_rows(self.ub)
            x2d_proj = torch.minimum(torch.maximum(
                x2d_proj, torch.as_tensor(lb_b, dtype=x2d_proj.dtype,
                                          device=x2d_proj.device)),
                torch.as_tensor(ub_b, dtype=x2d_proj.dtype,
                                device=x2d_proj.device))

        if not out_jac:
            return x2d_proj, None

        dof = 4 if pose.shape[-1] == 4 else 6
        zc = zcam[..., None]  # (*, n, 1, 1)
        d_xy = self.cam_mats[..., None, :2, :2] / zc
        d_z = (self.cam_mats[..., None, :2, 2:3] - x2d_proj[..., None]) / zc
        d_x2d_d_x3dcam = torch.cat([d_xy, d_z], -1)  # (*, n, 2, 3)
        if dof == 4:
            d_xzcam_d_yaw = torch.stack(
                [x3d_rot[..., 2], -x3d_rot[..., 0]], -1)[..., None]
            rot_cols = d_x2d_d_x3dcam[..., ::2] @ d_xzcam_d_yaw
        else:
            rot_cols = d_x2d_d_x3dcam @ skew(x3d_rot * 2)
        jac = torch.cat([d_x2d_d_x3dcam, rot_cols], -1)

        if clip_jac:
            clip_mask = zcam == self.z_min
            if self.has_bounds:
                clip_mask = (clip_mask | (x2d_proj == lb_b)
                             | (x2d_proj == ub_b))
            jac = torch.where(clip_mask[..., None], torch.zeros_like(jac), jac)
        return x2d_proj, jac

    @staticmethod
    def get_quaternion_transfrom_mat(quaternions):
        """Map a 3D rotation tangent delta into quaternion 4-space.

        (*, 4) -> (*, 4, 3). The name keeps the reference's spelling.
        """
        w, i, j, k = quaternions.unbind(-1)
        mat = torch.stack([i, j, k, -w, -k, j, k, -w, -i, -j, i, -w], -1)
        return mat.reshape(quaternions.shape[:-1] + (4, 3))

    get_quaternion_transform_mat = get_quaternion_transfrom_mat

    # -- batch-shape helpers --

    def _map_batched(self, fn):
        def bound(b):
            if isinstance(b, torch.Tensor) and b.ndim > 0:
                return fn(b, 1)
            return b
        return self.replace(cam_mats=fn(self.cam_mats, 2),
                            lb=bound(self.lb), ub=bound(self.ub))

    def tile(self, reps: int) -> 'PerspectiveCamera':
        """Tile the leading batch dim ``reps`` times (torch ``repeat``)."""
        return self._map_batched(
            lambda x, ev: x.repeat((reps,) + (1,) * (x.ndim - 1)))

    def broadcast_to_batch(self, batch_shape) -> 'PerspectiveCamera':
        return self._map_batched(
            lambda x, ev: x.expand(tuple(batch_shape) + x.shape[x.ndim - ev:]))
