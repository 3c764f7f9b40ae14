"""Synthetic PnP problems and training batches for the port's tests and
smoke run (numpy only).

:func:`make_pnp_problem` is ``bench.make_problem`` at any size, with the
same draw order (so ``make_pnp_problem(1024, 512, seed)`` gives the bench's
points for that seed), plus a perturbed ground-truth pose as a solver init.
:func:`make_det_batch` is the Det training batch of
``tests/test_det_train.py::make_batch`` at any size.
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


def make_sixdof_batch(seed: int, bs: int = 32, inp_res: int = 256,
                      out_res: int = 64) -> dict:
    """One seeded synthetic 6DoF training batch of float32 numpy arrays,
    the fields of ``sixdof.train.Batch``: normal images, uniform noc
    targets in [-0.5, 0.5], a full loss mask, normal trans-head targets,
    uniformly random rotations with translations 0.5-1 m in front of the
    camera, crops centred at 200-400 px of scale 100-200 px, and object
    extents 0.05-0.15 m (``tests/test_sixdof_train.py::make_batch`` at any
    size, from numpy alone)."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(bs, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.where(q[:, :1] < 0, -1.0, 1.0)
    t = r.uniform([-.1, -.1, .5], [.1, .1, 1.0], (bs, 3))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        inp=f32(r.normal(size=(bs, inp_res, inp_res, 3))),
        target_coor=f32(r.uniform(-.5, .5, (bs, out_res, out_res, 3))),
        loss_msk=np.ones((bs, out_res, out_res, 3), np.float32),
        trans_local=f32(r.normal(size=(bs, 3))),
        pose=f32(np.concatenate([_quat_to_rot(q), t[..., None]], -1)),
        c_box=f32(r.uniform(200, 400, (bs, 2))),
        s_box=f32(r.uniform(100, 200, (bs,))),
        dim=f32(r.uniform(.05, .15, (bs, 3))))


class SyntheticSixDoFDataset:
    """``n`` seeded synthetic samples (:func:`make_sixdof_batch`), made in
    bulk at construction; ``batches`` yields tuples of numpy arrays in the
    field order of ``sixdof.train.Batch``."""

    FIELDS = ('inp', 'target_coor', 'loss_msk', 'trans_local', 'pose',
              'c_box', 's_box', 'dim')

    def __init__(self, n: int, inp_res: int = 256, out_res: int = 64,
                 seed: int = 0):
        self.data = make_sixdof_batch(seed, n, inp_res, out_res)
        self.n = n

    def __len__(self) -> int:
        return self.n

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                rows: slice = slice(None)):
        """Global batches of ``batch_size`` (the ragged tail dropped), cut
        to ``rows`` (a data-parallel rank's block)."""
        order = (np.random.default_rng(seed).permutation(self.n) if shuffle
                 else np.arange(self.n))
        for start in range(0, self.n - batch_size + 1, batch_size):
            idx = order[start:start + batch_size][rows]
            yield tuple(self.data[k][idx] for k in self.FIELDS)


def make_bounded_pnp_problem(b: int, n: int, seed: int, dof: int = 6,
                             init_noise=(0.05, 0.1)) -> dict:
    """:func:`make_pnp_problem` with per-object projection bounds (B, 4)
    ``[lb_u, lb_v, ub_u, ub_v]`` that clamp part of the points, and the
    adaptive Huber delta of the training recipe (``relative_delta`` 0.1).

    dof 6 (the 6DoF training crops): the LineMOD focal length, and each
    object's box spans the 5%-95% quantiles of its own projections, so
    about a fifth of the points lie past a bound. dof 4 (the Det solve):
    a nuScenes-like focal length at 4-20 m, principal points shifted per
    object across a 1600x672 image, whose box (200 px of border) clamps
    the objects that reach past it. Float64 arrays.
    """
    if dof == 6:
        p = make_pnp_problem(b, n, seed, init_noise=init_noise,
                             focal=(572.4, 573.6), depth=(2.0, 6.0))
        lo = np.quantile(p['x2d'], 0.05, axis=1)
        hi = np.quantile(p['x2d'], 0.95, axis=1)
    else:
        p = make_pnp_problem(b, n, seed, dof=4, init_noise=init_noise,
                             focal=(1266.4, 1266.4), depth=(4.0, 20.0))
        shift = np.random.default_rng(seed + 1).uniform(
            [-150.0, -150.0], [1750.0, 820.0], (b, 2))
        p['x2d'] = p['x2d'] + shift[:, None]
        p['cams'][:, :2, 2] += shift
        lo = np.broadcast_to([-200.5, -200.5], (b, 2))
        hi = np.broadcast_to([1799.5, 871.5], (b, 2))
    p['bounds'] = np.ascontiguousarray(np.concatenate([lo, hi], -1))
    x2d_std = np.sqrt(p['x2d'].var(axis=1, ddof=1).sum(-1))
    p['delta'] = p['w2d'].mean(axis=(1, 2)) * x2d_std * 0.1
    return p


DET_BATCH_FIELDS = (
    'img', 'cam_intrinsic', 'img_shapes', 'ori_shapes', 'img_flips',
    'img_dense_x2d', 'img_dense_x2d_mask', 'gt_bboxes', 'gt_bboxes_3d',
    'gt_labels', 'gt_mask', 'gt_velo', 'gt_attr', 'gt_x3d', 'gt_x2d',
    'gt_pts_mask')


def make_det_batch(seed: int, n_img: int = 2, h: int = 64, w: int = 64,
                   gmax: int = 4, pmax: int = 16, n_valid: int = 2,
                   cam=None, x_range=(-1.0, 1.0), depth=(5.0, 9.0),
                   num_classes: int = 3, num_attrs: int = 4) -> dict:
    """A Det training batch (the fields of ``det.train.DetBatch``, numpy):
    ``n_valid`` GT boxes per image (of ``gmax`` slots) in front of the
    camera, at lateral offset ``x_range`` and depth ``depth`` (m), with
    ``pmax`` lidar points each, random images and an identity dense x2d
    map; odd images are flagged flipped. With the defaults it is
    ``tests/test_det_train.py::make_batch`` draw for draw (``cam`` None:
    focal 60 at the image centre)."""
    r = np.random.default_rng(seed)
    k = (np.array([[60., 0., w / 2], [0., 60., h / 2], [0., 0., 1.]])
         if cam is None else np.asarray(cam, np.float64))
    xs, ys = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    dense = np.stack([xs, ys], -1)[None].repeat(n_img, 0)
    g3d = np.zeros((n_img, gmax, 7), np.float32)
    g2d = np.zeros((n_img, gmax, 4), np.float32)
    mask = np.zeros((n_img, gmax), bool)
    velo = r.normal(0, 1, (n_img, gmax, 2)).astype(np.float32)
    x3dp = np.zeros((n_img, gmax, pmax, 3), np.float32)
    x2dp = np.zeros((n_img, gmax, pmax, 2), np.float32)
    pmask = np.zeros((n_img, gmax, pmax), bool)
    for i in range(n_img):
        for g in range(n_valid):
            t = np.array([r.uniform(*x_range), r.uniform(-0.3, 0.3),
                          r.uniform(*depth)])
            dims = r.uniform(1.0, 2.5, 3)
            g3d[i, g] = [*dims, *t, r.uniform(-np.pi, np.pi)]
            uv = k @ t
            c = uv[:2] / uv[2]
            half = k[0, 0] * dims[[0, 1]].max() / t[2] / 2
            g2d[i, g] = [c[0] - half, c[1] - half, c[0] + half, c[1] + half]
            g2d[i, g, 0::2] = g2d[i, g, 0::2].clip(0, w - 1)
            g2d[i, g, 1::2] = g2d[i, g, 1::2].clip(0, h - 1)
            mask[i, g] = True
            pts = r.uniform(-0.5, 0.5, (pmax, 3)) * dims
            x3dp[i, g] = pts
            uvp = (pts + t) @ k.T
            x2dp[i, g] = uvp[:, :2] / uvp[:, 2:]
            pmask[i, g] = True
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        img=f32(r.normal(size=(n_img, h, w, 3))),
        cam_intrinsic=f32(np.tile(k, (n_img, 1, 1))),
        img_shapes=np.tile(f32([h, w]), (n_img, 1)),
        ori_shapes=np.tile(f32([h, w]), (n_img, 1)),
        img_flips=np.array([i % 2 == 1 for i in range(n_img)]),
        img_dense_x2d=f32(dense),
        img_dense_x2d_mask=np.ones((n_img, h, w, 1), np.float32),
        gt_bboxes=g2d, gt_bboxes_3d=g3d,
        gt_labels=r.integers(0, num_classes, (n_img, gmax)),
        gt_mask=mask, gt_velo=velo,
        gt_attr=r.integers(0, num_attrs, (n_img, gmax)),
        gt_x3d=x3dp, gt_x2d=x2dp, gt_pts_mask=pmask)
