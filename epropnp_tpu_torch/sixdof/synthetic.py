"""Synthetic LineMOD-format scene generator (host-side numpy), a copy of
``epropnp_tpu/sixdof/synthetic.py`` whose OpenCV calls are
``utils.image_ops``': the same tree, which either package's
``LineMODDataset`` reads.

Renders a colored cuboid with a z-buffered point splat and writes frames
in the directory layout ``LineMODDataset`` expects
(``real_train/<cls>/{rgb,mask,coord,pose,box}``), so the WHOLE 6DoF stack
— dataset indexing, DZI cropping, coordinate-map targets, training,
EPnP/GN inference, ADD evaluation — can be exercised end-to-end without
the (license-gated) LineMOD download. The reference has no such
self-contained fixture; its quality assurance is benchmark-only
(SURVEY.md §4).

The cuboid's RGB directly encodes its normalized object coordinates
(R,G,B = NOC * 0.5 + 0.5), so a coordinate-regression network can learn
the task from few frames; distinct face colors break the symmetry a
plain cube would have.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.image_ops import box_blur3, morph_close3, write_png
from . import ref_constants as ref


def cuboid_surface(extents: np.ndarray, pts_per_face: int = 96):
    """Uniform grid points on the surface of an axis-aligned cuboid.

    Args:
        extents: (3,) half-extents (the object spans +-extents).
    Returns (N, 3) float32 points, N = 6 * pts_per_face**2.
    """
    g = np.linspace(-1.0, 1.0, pts_per_face, dtype=np.float32)
    uu, vv = np.meshgrid(g, g)
    uu, vv = uu.ravel(), vv.ravel()
    ones = np.ones_like(uu)
    faces = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            pt = np.empty((uu.size, 3), np.float32)
            other = [a for a in range(3) if a != axis]
            pt[:, axis] = sign
            pt[:, other[0]] = uu
            pt[:, other[1]] = vv
            faces.append(pt)
    return np.concatenate(faces, axis=0) * extents[None, :].astype(
        np.float32)


def render_frame(points: np.ndarray, extents: np.ndarray, rot: np.ndarray,
                 trans: np.ndarray, cam_k: Optional[np.ndarray] = None,
                 im_hw: Tuple[int, int] = (ref.IM_H, ref.IM_W),
                 rng: Optional[np.random.Generator] = None,
                 noise: float = 0.02):
    """Z-buffer point-splat of the cuboid into a full image.

    Returns dict with ``rgb`` (H, W, 3) uint8, ``mask`` (H, W) uint8,
    ``coord`` (H, W, 3) float32 object coordinates (reference coord-map
    convention: raw model coordinates, zero outside the object —
    lm.py coord pkls), ``box`` xywh, ``pose`` (3, 4).
    """
    h, w = im_hw
    cam_k = ref.CAMERA_MATRIX if cam_k is None else cam_k
    rng = rng or np.random.default_rng()
    cam = points @ rot.T + trans[None]
    uvw = cam @ np.asarray(cam_k, np.float32).T
    uv = uvw[:, :2] / uvw[:, 2:]
    z = cam[:, 2]
    px = np.round(uv).astype(np.int64)
    ok = ((px[:, 0] >= 0) & (px[:, 0] < w) & (px[:, 1] >= 0)
          & (px[:, 1] < h) & (z > 1e-3))
    px, zo, pts = px[ok], z[ok], points[ok]
    flat = px[:, 1] * w + px[:, 0]
    # nearest-z wins: sort far-to-near, later writes overwrite
    order = np.argsort(-zo)
    flat, pts = flat[order], pts[order]
    coord = np.zeros((h * w, 3), np.float32)
    coord[flat] = pts
    mask = np.zeros((h * w,), np.uint8)
    mask[flat] = 255
    coord = coord.reshape(h, w, 3)
    mask = mask.reshape(h, w)
    # close pin-holes from the point splat (keeps edges sharp enough)
    mask_closed = morph_close3(mask)
    holes = (mask_closed > 0) & (mask == 0)
    if holes.any():
        blur = box_blur3(coord)
        cnt = box_blur3((mask > 0).astype(np.float32))
        coord[holes] = blur[holes] / np.maximum(cnt[holes, None], 1e-6)
        mask = mask_closed
    noc = coord / np.abs(extents)[None, None]
    rgb = ((noc * 0.5 + 0.5) * 255.0)
    rgb[mask == 0] = 0
    if noise:
        rgb = rgb + rng.normal(0, noise * 255, rgb.shape)
    rgb = rgb.clip(0, 255).astype(np.uint8)
    ys, xs = np.nonzero(mask)
    box = np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                    ys.max() - ys.min() + 1], np.float32)
    pose = np.concatenate([rot, trans[:, None]], axis=1).astype(np.float32)
    return dict(rgb=rgb, mask=mask, coord=coord, box=box, pose=pose)


def random_pose(rng: np.random.Generator,
                cam_k: Optional[np.ndarray] = None,
                z_range=(0.6, 1.2), uv_margin: float = 0.25,
                max_angle: Optional[float] = None):
    """Random rotation + translation whose projection lands in-image.

    ``max_angle`` (radians) bounds the rotation away from a canonical
    view — real LineMOD covers roughly a viewing hemisphere, not all of
    SO(3), so a bounded range reproduces its viewpoint density for a
    given frame budget; None = uniform over SO(3).
    """
    cam_k = ref.CAMERA_MATRIX if cam_k is None else cam_k
    if max_angle is not None:
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        half = 0.5 * max_angle * rng.uniform()
        q = np.concatenate([[np.cos(half)], np.sin(half) * axis])
    else:
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
    wq, xq, yq, zq = q
    rot = np.array([
        [1 - 2 * (yq * yq + zq * zq), 2 * (xq * yq - zq * wq),
         2 * (xq * zq + yq * wq)],
        [2 * (xq * yq + zq * wq), 1 - 2 * (xq * xq + zq * zq),
         2 * (yq * zq - xq * wq)],
        [2 * (xq * zq - yq * wq), 2 * (yq * zq + xq * wq),
         1 - 2 * (xq * xq + yq * yq)]], np.float32)
    z = rng.uniform(*z_range)
    u = rng.uniform(ref.IM_W * uv_margin, ref.IM_W * (1 - uv_margin))
    v = rng.uniform(ref.IM_H * uv_margin, ref.IM_H * (1 - uv_margin))
    k = np.asarray(cam_k, np.float64)
    x = (u - k[0, 2]) / k[0, 0] * z
    y = (v - k[1, 2]) / k[1, 1] * z
    return rot, np.array([x, y, z], np.float32)


def generate_dataset(root: str, cls: str = 'ape',
                     n_train: int = 160, n_test: int = 40,
                     extents=(0.038, 0.039, 0.046),
                     pts_per_face: int = 96, seed: int = 0,
                     max_angle: Optional[float] = None
                     ) -> Dict[str, Dict[str, float]]:
    """Write a synthetic LineMOD-format dataset under ``root``.

    Returns a ``model_info`` dict ({cls: {min_x..., diameter}}) matching
    the models_info.yml convention the eval path consumes.
    """
    assert cls in ref.OBJ2IDX, cls
    extents = np.asarray(extents, np.float32)
    rng = np.random.default_rng(seed)
    points = cuboid_surface(extents, pts_per_face)
    for split, count in (('real_train', n_train), ('real_test', n_test)):
        base = os.path.join(root, split, cls)
        for sub in ('rgb', 'mask', 'coord', 'pose', 'box'):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for i in range(count):
            rot, trans = random_pose(rng, max_angle=max_angle)
            fr = render_frame(points, extents, rot, trans, rng=rng)
            stem = f'{i:06d}'
            write_png(os.path.join(base, 'rgb', stem + '.png'), fr['rgb'])
            write_png(os.path.join(base, 'mask', stem + '.png'), fr['mask'])
            np.save(os.path.join(base, 'coord', stem + '.npy'), fr['coord'])
            np.savetxt(os.path.join(base, 'pose', stem + '.txt'), fr['pose'])
            np.savetxt(os.path.join(base, 'box', stem + '.txt'), fr['box'])
    diameter = float(2.0 * np.linalg.norm(extents))
    info = {cls: dict(min_x=-float(extents[0]), min_y=-float(extents[1]),
                      min_z=-float(extents[2]), size_x=2 * float(extents[0]),
                      size_y=2 * float(extents[1]),
                      size_z=2 * float(extents[2]), diameter=diameter)}
    return info
