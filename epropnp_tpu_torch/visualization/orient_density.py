"""Orientation-density rendering (a copy of
``epropnp_tpu/visualization/orient_density.py``; cv2 is imported where a
render needs it).

Two variants covering the reference visualizations:
  * ``draw_orient_density(yaw_logprob)`` — polar plot of the 4DoF yaw
    density grid produced at test time
    (deform_pnp_head.py test_post :540-551).
  * ``draw_so3_density(quats, weights)`` — the 6DoF sample-cloud sphere
    render (EPro-PnP-6DoF/lib/utils/draw_orient_density.py:10-60): RGB
    axis points rotated by the sampled quaternions are scatter-splatted
    onto front/back hemisphere images weighted by the sample weights.
"""

from __future__ import annotations

import numpy as np


def draw_orient_density(orient_logprob: np.ndarray, size: int = 256
                        ) -> np.ndarray:
    """(bins,) yaw log-density -> polar plot image (BGR uint8)."""
    import cv2
    bins = orient_logprob.shape[-1]
    density = np.exp(orient_logprob - orient_logprob.max())
    density = density / density.max()
    img = np.full((size, size, 3), 255, np.uint8)
    c = size // 2
    r_base = size * 0.15
    r_max = size * 0.45
    pts = []
    for i in range(bins):
        ang = 2 * np.pi * i / bins
        r = r_base + density[i] * (r_max - r_base)
        pts.append([c + r * np.sin(ang), c - r * np.cos(ang)])
    pts = np.asarray(pts, np.int32)
    cv2.circle(img, (c, c), int(r_base), (220, 220, 220), 1, cv2.LINE_AA)
    cv2.polylines(img, [pts.reshape(-1, 1, 2)], True, (200, 80, 40), 2,
                  cv2.LINE_AA)
    return img


def _quat_rotate(quats: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Rotate (p, 3) points by (n, 4) [w,x,y,z] -> (n, p, 3)."""
    w, x, y, z = quats.T
    rot = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3)
    return np.einsum('nij,pj->npi', rot, pts)


def draw_so3_density(quats: np.ndarray, weights: np.ndarray,
                     size: int = 256, blur: int = 5) -> np.ndarray:
    """SO(3) sample cloud -> side-by-side front/back sphere images.

    The X/Y/Z axis tips (colored R/G/B) are rotated by every sampled
    quaternion and splatted with the normalized sample weights; exponential
    tone mapping and a blur give the reference's density-cloud look.
    """
    weights = np.asarray(weights, np.float64)
    weights = weights / max(weights.max(), 1e-12)
    axes = np.eye(3)
    rotated = _quat_rotate(np.asarray(quats, np.float64), axes)  # (n, 3, 3)
    colors = np.eye(3)[::-1]  # BGR for R, G, B axis tips

    half = size // 2
    acc = np.zeros((2, size, size, 3), np.float64)
    for a in range(3):
        p = rotated[:, a]  # (n, 3)
        front = p[:, 2] >= 0
        u = ((p[:, 0] * 0.95 + 1) * half).astype(int).clip(0, size - 1)
        v = ((-p[:, 1] * 0.95 + 1) * half).astype(int).clip(0, size - 1)
        for hemi, mask in ((0, front), (1, ~front)):
            np.add.at(acc[hemi], (v[mask], u[mask]),
                      weights[mask, None] * colors[a])
    imgs = []
    for hemi in range(2):
        img = acc[hemi]
        if blur > 1:
            import cv2
            img = cv2.GaussianBlur(img, (blur | 1, blur | 1), 0)
        img = 1.0 - np.exp(-img * 8.0)
        imgs.append((img * 255).astype(np.uint8))
    return np.concatenate(imgs, axis=1)
