"""Math primitives for the PnP layer (PyTorch).

Counterpart of ``epropnp_tpu/ops/pnp/common.py``: skew matrices,
quaternion/yaw rotations, the residual/cost/Jacobian evaluation entry point
and the centroid normalisation helpers. Poses keep the JAX layouts:
``[x, y, z, yaw]`` (4DoF) and ``[x, y, z, w, i, j, k]`` (6DoF).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def skew(x: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrices. x: (*, 3) -> (*, 3, 3)."""
    x0, x1, x2 = x.unbind(-1)
    zeros = torch.zeros_like(x0)
    return torch.stack([
        torch.stack([zeros, -x2, x1], -1),
        torch.stack([x2, zeros, -x0], -1),
        torch.stack([-x1, x0, zeros], -1),
    ], -2)


def quaternion_to_rot_mat(quaternions: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w, i, j, k] -> rotation matrix. (*, 4) -> (*, 3, 3)."""
    w, i, j, k = quaternions.unbind(-1)
    rot = torch.stack([
        1 - 2 * (j * j + k * k), 2 * (i * j - k * w), 2 * (i * k + j * w),
        2 * (i * j + k * w), 1 - 2 * (i * i + k * k), 2 * (j * k - i * w),
        2 * (i * k - j * w), 2 * (j * k + i * w), 1 - 2 * (i * i + j * j),
    ], -1)
    return rot.reshape(quaternions.shape[:-1] + (3, 3))


def yaw_to_rot_mat(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation around the Y axis. (*) -> (*, 3, 3)."""
    s, c = torch.sin(yaw), torch.cos(yaw)
    zeros, ones = torch.zeros_like(yaw), torch.ones_like(yaw)
    rot = torch.stack([c, zeros, s, zeros, ones, zeros, -s, zeros, c], -1)
    return rot.reshape(yaw.shape + (3, 3))


def pose_to_rot_mat(pose: torch.Tensor) -> torch.Tensor:
    """Pose (*, 4) = [x,y,z,yaw] or (*, 7) = [x,y,z,w,i,j,k] -> (*, 3, 3)."""
    if pose.shape[-1] == 4:
        return yaw_to_rot_mat(pose[..., 3])
    return quaternion_to_rot_mat(pose[..., 3:])


class PnPEval(NamedTuple):
    """Result of a PnP evaluation at one pose (see :func:`evaluate_pnp`)."""

    residual: Optional[torch.Tensor]  # (*, n*2)
    cost: Optional[torch.Tensor]      # (*,)
    jacobian: Optional[torch.Tensor]  # (*, n*2, dof)


def evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                 out_jacobian: bool = False, out_residual: bool = False,
                 out_cost: bool = False, clip_jac: bool = True) -> PnPEval:
    """Weighted reprojection residual/cost/Jacobian at ``pose``.

    Args:
        x3d: (*, n, 3) object-space points.
        x2d: (*, n, 2) target image points.
        w2d: (*, n, 2) anisotropic correspondence weights.
        pose: (*, 4) or (*, 7).
        camera: :class:`PerspectiveCamera` broadcastable to batch (*,).
        cost_fun: Huber cost object broadcastable to batch (*,).
    """
    x2d_proj, jac_cam = camera.project(
        x3d, pose, out_jac=out_jacobian, clip_jac=clip_jac)
    residual, cost, jacobian = cost_fun.compute(
        x2d_proj, x2d, w2d, jac_cam=jac_cam, out_residual=out_residual,
        out_cost=out_cost, out_jacobian=out_jacobian)
    return PnPEval(residual, cost, jacobian)


def pnp_normalize(x3d, pose=None, detach_transformation=True):
    """Subtract the x3d centroid and fold it into the pose translation.

    Returns (offset (*, 3), x3d_norm, pose_norm).
    """
    offset = torch.mean(x3d.detach() if detach_transformation else x3d, -2)
    x3d_norm = x3d - offset[..., None, :]
    pose_norm = None
    if pose is not None:
        rot = pose_to_rot_mat(pose)
        t_norm = pose[..., :3] + torch.einsum('...ij,...j->...i', rot, offset)
        pose_norm = torch.cat([t_norm, pose[..., 3:]], -1)
    return offset, x3d_norm, pose_norm


def pnp_denormalize(offset, pose_norm):
    """Inverse of :func:`pnp_normalize` on the pose."""
    rot = pose_to_rot_mat(pose_norm)
    t = pose_norm[..., :3] - torch.einsum('...ij,...j->...i', rot, offset)
    return torch.cat([t, pose_norm[..., 3:]], -1)
