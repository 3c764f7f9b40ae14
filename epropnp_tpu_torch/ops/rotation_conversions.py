"""Rotation representation conversions (PyTorch).

Counterpart of ``epropnp_tpu/ops/rotation_conversions.py``: conversions
among quaternions ([w, x, y, z], scalar-first), rotation matrices, Euler
angles, axis-angle and the 6D continuous representation, quaternion
algebra and random rotation sampling. Every function is batched over
leading dims and differentiable. Random sampling takes a
``torch.Generator``.

Conventions: right-handed frames, rotation matrices act on column vectors,
quaternions with a non-negative real part are the standard representatives.
"""

from __future__ import annotations

from typing import Optional

import torch


# ---------------------------------------------------------------- quaternion

def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """(*, 4) [w,x,y,z] -> (*, 3, 3)."""
    q = quaternions / torch.linalg.vector_norm(quaternions, dim=-1,
                                               keepdim=True)
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], -1)
    return m.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at negative inputs."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(*, 3, 3) -> (*, 4) [w,x,y,z], by the four-candidate construction:
    every candidate is computed and the best-conditioned one is kept."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs = torch.stack([
        _sqrt_positive_part(1.0 + m00 + m11 + m22),
        _sqrt_positive_part(1.0 + m00 - m11 - m22),
        _sqrt_positive_part(1.0 - m00 + m11 - m22),
        _sqrt_positive_part(1.0 - m00 - m11 + m22),
    ], -1)

    # candidate quaternions scaled by 2 * q_abs[i]
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], -2)  # (*, 4, 4)
    quat_candidates = quat_by_rijk / (
        2.0 * torch.clamp(q_abs[..., None], min=0.1))

    best = torch.argmax(q_abs, -1)
    quat = torch.take_along_dim(
        quat_candidates, best[..., None, None].expand(
            best.shape + (1, 4)), -2)[..., 0, :]
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    return standardize_quaternion(quat)


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """The representative with a non-negative real part."""
    return torch.where(quaternions[..., :1] < 0, -quaternions, quaternions)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product without standardization."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, standardized."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(quaternion: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    return quaternion * quaternion.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_apply(quaternion: torch.Tensor,
                     point: torch.Tensor) -> torch.Tensor:
    """Rotate points (*, 3) by unit quaternions (*, 4)."""
    point_q = torch.cat([torch.zeros_like(point[..., :1]), point], -1)
    out = quaternion_raw_multiply(
        quaternion_raw_multiply(quaternion, point_q),
        quaternion_invert(quaternion))
    return out[..., 1:]


# -------------------------------------------------------------- euler angles

def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == 'X':
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == 'Y':
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == 'Z':
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(f'invalid axis {axis}')
    return torch.stack(flat, -1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(c not in 'XYZ' for c in convention):
        raise ValueError(f'invalid convention {convention}')


def euler_angles_to_matrix(euler_angles: torch.Tensor,
                           convention: str) -> torch.Tensor:
    """(*, 3) angles (rad) -> (*, 3, 3)."""
    _check_convention(convention)
    matrices = [_axis_angle_rotation(c, euler_angles[..., i])
                for i, c in enumerate(convention)]
    return matrices[0] @ matrices[1] @ matrices[2]


def _angle_from_tan(axis, other_axis, data, horizontal, tait_bryan):
    i1, i2 = {'X': (2, 1), 'Y': (0, 2), 'Z': (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ('XY', 'YZ', 'ZX')
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor,
                           convention: str) -> torch.Tensor:
    """(*, 3, 3) -> (*, 3)."""
    _check_convention(convention)
    i0 = 'XYZ'.index(convention[0])
    i2 = 'XYZ'.index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        central = torch.asin(torch.clamp(
            matrix[..., i0, i2] * (-1.0 if i0 - i2 in [-1, 2] else 1.0),
            -1.0, 1.0))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0, 1.0))
    o0 = _angle_from_tan(
        convention[0], convention[1], matrix[..., i2], False, tait_bryan)
    o2 = _angle_from_tan(
        convention[2], convention[1], matrix[..., i0, :], True, tait_bryan)
    return torch.stack([o0, central, o2], -1)


# ---------------------------------------------------------------- axis angle

def _safe_norm(x: torch.Tensor, tiny: float = 1e-30) -> torch.Tensor:
    """Norm over the last axis with a finite gradient at zero."""
    return torch.sqrt(torch.clamp(x.square().sum(-1, keepdim=True), min=tiny))


def _sin_half_over_angle(angles, half, eps):
    # Taylor expansion of sin(x/2)/x near 0 keeps gradients finite
    small = torch.abs(angles) < eps
    return torch.where(small, 0.5 - angles * angles / 48.0,
                       torch.sin(half) / torch.where(small, 1.0, angles))


def axis_angle_to_quaternion(axis_angle: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """(*, 3) rotation vector -> (*, 4)."""
    angles = _safe_norm(axis_angle)
    half = angles * 0.5
    return torch.cat([torch.cos(half),
                      axis_angle * _sin_half_over_angle(angles, half, eps)],
                     -1)


def quaternion_to_axis_angle(quaternions: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """(*, 4) -> (*, 3)."""
    norms = _safe_norm(quaternions[..., 1:])
    half_angles = torch.atan2(norms, quaternions[..., :1])
    angles = 2.0 * half_angles
    return quaternions[..., 1:] / _sin_half_over_angle(angles, half_angles,
                                                       eps)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """(*, 3) -> (*, 3, 3)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """(*, 3, 3) -> (*, 3)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


# ------------------------------------------------------------------ rot6d

def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(*, 6) continuous representation -> (*, 3, 3) by Gram-Schmidt
    (Zhou et al., CVPR 2019)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1, keepdim=True),
                          min=1e-12)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.vector_norm(a2p, dim=-1,
                                                    keepdim=True), min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], -2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """(*, 3, 3) -> (*, 6): the first two rows."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


# ------------------------------------------------------------------ sampling

def random_quaternions(n: int, generator: Optional[torch.Generator] = None,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform unit quaternions with a non-negative real part, drawn from
    ``generator`` (on its device unless ``device`` is given)."""
    gen_device = generator.device if generator is not None else device
    q = torch.randn((n, 4), generator=generator, dtype=dtype,
                    device=gen_device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return standardize_quaternion(q).to(device or q.device)


def random_rotations(n: int, generator: Optional[torch.Generator] = None,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform random rotation matrices (n, 3, 3)."""
    return quaternion_to_matrix(random_quaternions(n, generator, dtype,
                                                   device))


def random_rotation(generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """A single uniform random rotation matrix."""
    return random_rotations(1, generator, dtype, device)[0]
