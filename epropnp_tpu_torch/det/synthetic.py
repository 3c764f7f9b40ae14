"""Synthetic multi-object 3D-detection scenes (host-side numpy).

Renders scenes of floating cuboids with a z-buffered point splat, where
each object's RGB directly encodes its normalized object coordinates
(NOC * 0.5 + 0.5, modulated by a per-class tint) — the same trick as
``sixdof/synthetic.py`` — so the Det suite's dense-correspondence head
has a learnable appearance->geometry mapping. This gives the FULL Det
stack (FCOS targets from VolumeCenter, deformable attention,
correspondence transformer, AMIS Monte Carlo pose loss, PnP inference,
rotated-IoU matching) an end-to-end fixture without the license-gated
nuScenes download. The reference has no such self-contained fixture; its
quality assurance is benchmark-only (SURVEY.md §4).

Pose convention matches the Det suite: ``bbox_3d = [l, h, w, x, y, z, ry]``
with yaw about the camera Y axis (core/bbox_3d/misc.py:87-95; reference
EPro-PnP-Det/epropnp_det/core/bbox_3d/misc.py:87-130). Camera: x right,
y down, z forward.

The PyTorch port keeps this copy of ``epropnp_tpu/det/synthetic.py``
(the same code; it imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class SyntheticDetScene(NamedTuple):
    """One rendered scene and its ground truth (fixed G-object padding)."""
    img: np.ndarray           # (H, W, 3) float32 in [0, 1]
    gt_bboxes: np.ndarray     # (G, 4) [x1, y1, x2, y2]
    gt_bboxes_3d: np.ndarray  # (G, 7) [l, h, w, x, y, z, ry]
    gt_labels: np.ndarray     # (G,) int
    gt_mask: np.ndarray       # (G,) bool
    gt_velo: np.ndarray       # (G, 2)
    gt_attr: np.ndarray       # (G,) int
    gt_x3d: np.ndarray        # (G, P, 3) object-frame surface points
    gt_x2d: np.ndarray        # (G, P, 2) their projections
    gt_pts_mask: np.ndarray   # (G, P) bool


# per-class base dimensions [l, h, w] (meters) and RGB tints; tints keep
# channels strictly positive so NOC information survives modulation
CLASS_DIMS = np.array([[1.8, 1.6, 1.8], [2.6, 1.4, 1.4], [1.2, 2.2, 1.2]],
                      np.float32)
CLASS_TINTS = np.array([[1.0, 0.75, 0.55], [0.55, 1.0, 0.75],
                        [0.75, 0.55, 1.0]], np.float32)


def _yaw_rot(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _cuboid_surface(pts_per_face: int = 48) -> np.ndarray:
    """Unit-cuboid surface grid: (6 * pts_per_face**2, 3) in [-0.5, 0.5]."""
    g = np.linspace(-0.5, 0.5, pts_per_face, dtype=np.float32)
    uu, vv = np.meshgrid(g, g)
    uu, vv = uu.ravel(), vv.ravel()
    faces = []
    for axis in range(3):
        for sign in (-0.5, 0.5):
            pt = np.empty((uu.size, 3), np.float32)
            other = [a for a in range(3) if a != axis]
            pt[:, axis] = sign
            pt[:, other[0]] = uu
            pt[:, other[1]] = vv
            faces.append(pt)
    return np.concatenate(faces, axis=0)


class SyntheticDetSceneGenerator:
    """Generates fixed-shape Det scenes; one call = one scene."""

    def __init__(self, im_hw: Tuple[int, int] = (128, 224),
                 num_classes: int = 3, max_gt: int = 4,
                 num_obj_range: Tuple[int, int] = (2, 4),
                 lidar_points: int = 16, focal: float = 160.0,
                 depth_range: Tuple[float, float] = (6.0, 14.0),
                 pts_per_face: int = 48, noise_std: float = 0.02):
        assert num_classes <= CLASS_DIMS.shape[0]
        self.im_hw = im_hw
        self.num_classes = num_classes
        self.max_gt = max_gt
        self.num_obj_range = num_obj_range
        self.lidar_points = lidar_points
        self.depth_range = depth_range
        self.noise_std = noise_std
        h, w = im_hw
        self.cam_k = np.array(
            [[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]],
            np.float32)
        self._surf = _cuboid_surface(pts_per_face)

    def sample_scene(self, rng: np.random.Generator) -> SyntheticDetScene:
        h, w = self.im_hw
        g_max, p_max = self.max_gt, self.lidar_points
        img = np.full((h, w, 3), 0.08, np.float32)
        zbuf = np.full((h, w), np.inf, np.float32)

        n_obj = int(rng.integers(self.num_obj_range[0],
                                 self.num_obj_range[1] + 1))
        n_obj = min(n_obj, g_max)
        g3d = np.zeros((g_max, 7), np.float32)
        g2d = np.zeros((g_max, 4), np.float32)
        labels = np.zeros((g_max,), np.int32)
        mask = np.zeros((g_max,), bool)
        velo = np.zeros((g_max, 2), np.float32)
        attr = np.zeros((g_max,), np.int32)
        x3dp = np.zeros((g_max, p_max, 3), np.float32)
        x2dp = np.zeros((g_max, p_max, 2), np.float32)
        pmask = np.zeros((g_max, p_max), bool)

        fx = self.cam_k[0, 0]
        # far-to-near order so nearer objects overwrite in the z-buffer
        depths = np.sort(rng.uniform(*self.depth_range, n_obj))[::-1]
        for g, z in enumerate(depths):
            cls = int(rng.integers(0, self.num_classes))
            dims = CLASS_DIMS[cls] * rng.uniform(0.85, 1.15, 3).astype(
                np.float32)
            yaw = float(rng.uniform(-np.pi, np.pi))
            # keep the projected center well inside the canvas
            margin = fx * float(dims.max()) / z * 0.7
            cx = rng.uniform(margin, w - margin) if w > 2 * margin else w / 2
            cy = rng.uniform(margin * 0.7, h - margin * 0.7) \
                if h > 1.4 * margin else h / 2
            t = np.array([(cx - self.cam_k[0, 2]) * z / fx,
                          (cy - self.cam_k[1, 2]) * z / self.cam_k[1, 1], z],
                         np.float32)

            rot = _yaw_rot(yaw)
            local = self._surf * dims[None, :]          # object frame
            cam = local @ rot.T + t[None, :]
            uvw = cam @ self.cam_k.T
            uv = uvw[:, :2] / uvw[:, 2:]
            iu = np.round(uv[:, 0]).astype(np.int64)
            iv = np.round(uv[:, 1]).astype(np.int64)
            ok = (iu >= 0) & (iu < w) & (iv >= 0) & (iv < h) & (cam[:, 2] > 0)
            if not np.any(ok):
                continue
            iu, iv, zc = iu[ok], iv[ok], cam[ok, 2]
            noc = local[ok] / dims[None, :]             # in [-0.5, 0.5]
            color = (noc + 0.5) * CLASS_TINTS[cls][None, :]
            # z-buffered splat (last write wins among equal pixels; process
            # in far-to-near point order for determinism)
            order = np.argsort(-zc)
            iu, iv, zc, color = iu[order], iv[order], zc[order], color[order]
            closer = zc < zbuf[iv, iu]
            iu, iv, zc, color = (iu[closer], iv[closer], zc[closer],
                                 color[closer])
            zbuf[iv, iu] = zc
            img[iv, iu] = color

            g3d[g] = [*dims, *t, yaw]
            g2d[g] = [uv[ok, 0].min(), uv[ok, 1].min(),
                      uv[ok, 0].max(), uv[ok, 1].max()]
            g2d[g, 0::2] = g2d[g, 0::2].clip(0, w - 1)
            g2d[g, 1::2] = g2d[g, 1::2].clip(0, h - 1)
            labels[g] = cls
            mask[g] = True
            attr[g] = cls % 2
            # "lidar" supervision: random visible surface points
            sel = rng.choice(np.flatnonzero(ok), size=p_max,
                             replace=ok.sum() < p_max)
            x3dp[g] = local[sel]
            pw = (local[sel] @ rot.T + t[None, :]) @ self.cam_k.T
            x2dp[g] = pw[:, :2] / pw[:, 2:]
            pmask[g] = True

        if self.noise_std > 0:
            img = np.clip(
                img + rng.normal(0, self.noise_std, img.shape), 0, 1
            ).astype(np.float32)
        return SyntheticDetScene(img, g2d, g3d, labels, mask, velo, attr,
                                 x3dp, x2dp, pmask)

    def sample_batch(self, rng: np.random.Generator, n_img: int):
        """Stack n_img scenes into arrays ready for ``DetBatch``."""
        scenes = [self.sample_scene(rng) for _ in range(n_img)]
        stacked = SyntheticDetScene(
            *[np.stack([getattr(s, f) for s in scenes])
              for f in SyntheticDetScene._fields])
        return stacked

    def dense_x2d(self, n_img: int) -> np.ndarray:
        h, w = self.im_hw
        ys, xs = np.meshgrid(np.arange(h, dtype=np.float32) + 0.5,
                             np.arange(w, dtype=np.float32) + 0.5,
                             indexing='ij')
        return np.tile(np.stack([xs, ys], -1)[None], (n_img, 1, 1, 1))
