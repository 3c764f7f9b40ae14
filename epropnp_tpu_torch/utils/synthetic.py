"""Synthetic PnP problems for the port's tests and smoke run (numpy only).

:func:`make_pnp_problem` is ``bench.make_problem`` at any size, with the
same draw order (so ``make_pnp_problem(1024, 512, seed)`` gives the bench's
points for that seed), plus a perturbed ground-truth pose as a solver init.
"""

from __future__ import annotations

import numpy as np


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(b, 4) unit [w, x, y, z] quaternions -> (b, 3, 3) rotations."""
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3)


# The bench problem's size and solver settings (bench.py).
BENCH_B, BENCH_N = 1024, 512
BENCH_LM_ITER = 10
BENCH_RS_POINTS, BENCH_RS_PROPOSALS, BENCH_RS_ITER = 16, 64, 3


def make_problem(seed: int = 0):
    """``bench.make_problem``: B=1024 objects, N=512 noisy correspondences.

    Returns float32 ``(x3d, x2d, w2d, cam, pose)``, with ``pose`` the
    ground truth (B, 7) ``[t, q]``.
    """
    p = make_pnp_problem(BENCH_B, BENCH_N, seed)
    return (p['x3d'].astype(np.float32), p['x2d'].astype(np.float32),
            p['w2d'].astype(np.float32), p['cams'].astype(np.float32),
            p['pose'].astype(np.float32))


def make_pnp_problem(b: int, n: int, seed: int, dof: int = 6,
                     init_noise=(0.05, 0.1), px_noise: float = 0.5,
                     focal=(500.0, 500.0), depth=(2.0, 6.0)) -> dict:
    """``b`` objects with ``n`` noisy weighted 2D-3D correspondences each.

    Rotations are uniform (dof 6) or a yaw about the y axis (dof 4);
    translations put the objects ``depth`` metres in front of a pinhole
    camera with focal lengths ``focal`` and centre (320, 240); the 3D points
    fill a unit cube; the projections get Gaussian noise of ``px_noise``
    pixels; weights are uniform in [0.5, 1.5] / n.

    Returns float64 arrays: ``x3d`` (b, n, 3), ``x2d`` and ``w2d``
    (b, n, 2), ``cams`` (b, 3, 3), the ground truth ``pose`` and ``pose0``,
    the ground truth with Gaussian noise of ``init_noise`` = (translation,
    rotation) added, both (b, 7) ``[t, q]`` or (b, 4) ``[t, yaw]``.
    """
    r = np.random.default_rng(seed)
    if dof == 4:
        yaw = r.uniform(-np.pi, np.pi, b)
        q = np.stack([np.cos(yaw / 2), 0 * yaw, np.sin(yaw / 2), 0 * yaw], -1)
        rot_p = yaw[:, None]
    else:
        q = r.normal(size=(b, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        rot_p = q
    t = np.concatenate([r.uniform(-0.2, 0.2, (b, 2)),
                        r.uniform(depth[0], depth[1], (b, 1))], axis=-1)
    x3d = r.uniform(-0.5, 0.5, (b, n, 3))
    k = np.array([[focal[0], 0., 320.], [0., focal[1], 240.], [0., 0., 1.]])
    xc = np.einsum('bij,bnj->bni', _quat_to_rot(q), x3d) + t[:, None]
    xh = np.einsum('ij,bnj->bni', k, xc)
    x2d = xh[..., :2] / xh[..., 2:] + r.normal(scale=px_noise, size=(b, n, 2))
    w2d = r.uniform(0.5, 1.5, (b, n, 2)) / n
    pose = np.concatenate([t, rot_p], -1)
    pose0 = np.concatenate([t + r.normal(0, init_noise[0], (b, 3)),
                            rot_p + r.normal(0, init_noise[1], rot_p.shape)],
                           -1)
    if dof == 6:
        pose0[:, 3:] /= np.linalg.norm(pose0[:, 3:], axis=-1, keepdims=True)
    return dict(x3d=x3d, x2d=x2d, w2d=w2d,
                cams=np.broadcast_to(k, (b, 3, 3)).copy(), pose=pose,
                pose0=pose0)
