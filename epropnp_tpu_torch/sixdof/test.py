"""6DoF test-time pose inference (PyTorch), the port's serving path.

Counterpart of ``epropnp_tpu/sixdof/test.py``: dense correspondence maps
-> legacy-softmax weights -> a pose init -> batched fast-mode Gauss-Newton
refinement -> translation-head pose decode. Three inits:

- ``'epnp'`` (the default, as in the reference's eval recipe,
  EPro-PnP-6DoF/lib/test.py:176-194): ``cv2.solvePnP`` EPnP on the
  top-20%-confidence points, on the host;
- ``'epnp_device'``: a batched EPnP in torch ops on the outputs' device
  (eigh, solve, SVD: library calls, as in the JAX package, which computes
  them outside any Pallas kernel);
- ``'rslm'``: the random-sample LM init on the device.

With ``cfg.pnp.use_pallas`` the refinement (and the RSLM proposals' solve)
runs through the fused LM kernel K1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.pnp import (
    AdaptiveHuberPnPCost,
    LMSolver,
    PerspectiveCamera,
    RSLMSolver,
)
from ..ops.pnp.common import quaternion_to_rot_mat
from ..ops.rotation_conversions import (axis_angle_to_quaternion,
                                        matrix_to_quaternion)
from .config import SixDoFConfig
from .train import Batch, build_correspondences, build_epropnp

INITS = ('epnp', 'epnp_device', 'rslm')


def build_test_solver(cfg: SixDoFConfig, with_init_solver: bool = False):
    """GN refiner (fast mode), optionally with the RSLM init solver."""
    init_solver = None
    if with_init_solver:
        init_solver = RSLMSolver(
            dof=6, num_points=cfg.pnp.rs_num_points,
            num_proposals=64, num_iter=cfg.pnp.rs_num_iter,
            use_pallas=cfg.pnp.use_pallas)
    return LMSolver(dof=6, num_iter=cfg.pnp.test_lm_num_iter,
                    use_pallas=cfg.pnp.use_pallas,
                    init_solver=init_solver)


def epnp_init_host(x3d: np.ndarray, x2d: np.ndarray, conf: np.ndarray,
                   cam_k: np.ndarray, quantile: float = 0.8) -> np.ndarray:
    """EPnP on the top-confidence mask, one ``cv2.solvePnP`` an object on
    the host (the reference's lib/test.py:176-194). Returns (bs, 7)
    [t, q] float64 poses; an object cv2 fails on gets the identity
    rotation 1 m in front of the camera."""
    try:
        import cv2
    except ImportError as err:
        raise ImportError(
            "init='epnp' needs OpenCV (cv2), which is not installed; use "
            "init='epnp_device' (the batched EPnP on the device) or "
            "init='rslm'") from err
    bs = x3d.shape[0]
    dist_coeffs = np.zeros((4, 1), np.float32)
    thresh = np.quantile(conf.reshape(bs, -1), quantile, axis=1)
    poses = np.zeros((bs, 7), np.float64)
    for i in range(bs):
        mask = conf[i] >= thresh[i]
        ok, rvec, tvec = cv2.solvePnP(
            x3d[i][mask].astype(np.float64), x2d[i][mask].astype(np.float64),
            cam_k.astype(np.float64), dist_coeffs, flags=cv2.SOLVEPNP_EPNP)
        if not ok:
            rvec = np.zeros(3)
            tvec = np.array([0.0, 0.0, 1.0])
        poses[i, :3] = tvec.reshape(3)
        poses[i, 3:] = axis_angle_to_quaternion(
            torch.from_numpy(np.asarray(rvec, np.float64).reshape(3))
        ).numpy()
    return poses


def epnp_init_device(x3d: torch.Tensor, x2d: torch.Tensor,
                     conf: torch.Tensor, cam_k: torch.Tensor,
                     quantile: float = 0.8) -> torch.Tensor:
    """Batched EPnP (nullspace formulation) in torch ops on the inputs'
    device, the JAX package's replacement of the per-object host loop:

      1. control points: the weighted centroid and the principal axes of
         x3d (scaled by their standard deviations), each axis' largest
         component positive;
      2. barycentric coordinates by a batched 4x4 solve;
      3. the 2n x 12 projection system, accumulated as its 12x12 Gram
         matrix over the top-``quantile`` confidence mask;
      4. its smallest eigenvector -> camera-frame control points up to
         scale and sign, fixed by the pairwise-distance ratio and a
         positive mean depth;
      5. weighted Kabsch / Procrustes -> (R, t).

    The arithmetic runs in the inputs' dtype promoted with float32 (f64
    inputs stay f64); the result is float32, as in the JAX package.

    On noisy points the pose depends on the control points, so on the
    sign of each principal axis. The JAX package takes the signs its
    LAPACK's eigh returns; here each axis is turned so that its largest
    component is positive, which gives the same control points on the
    card and on the CPU.

    Args:
        x3d: (bs, n, 3); x2d: (bs, n, 2); conf: (bs, n), whose top
            (1 - quantile) share is used; cam_k: (3, 3).

    Returns (bs, 7) [t, q] poses.
    """
    dtype = torch.promote_types(x3d.dtype, torch.float32)
    x3d, x2d = x3d.to(dtype), x2d.to(dtype)
    bs, n, _ = x3d.shape
    eps = 1e-9
    thresh = torch.quantile(conf, quantile, dim=1, keepdim=True)
    w = (conf >= thresh).to(dtype)                         # (bs, n) mask
    w_sum = w.sum(-1, keepdim=True) + eps

    # 1. control points: centroid + scaled principal axes
    cent = (w[..., None] * x3d).sum(1) / w_sum             # (bs, 3)
    xc = x3d - cent[:, None]
    cov = torch.einsum('bn,bni,bnj->bij', w, xc, xc) / w_sum[..., None]
    eye3 = torch.eye(3, dtype=dtype, device=x3d.device)
    eval_, evec = torch.linalg.eigh(cov + eps * eye3)
    evec = _canonical_signs(evec)
    axes = evec * torch.sqrt(torch.clamp(eval_, min=eps))[:, None, :]
    ctl_w = torch.cat([cent[:, None], cent[:, None] + axes.transpose(1, 2)],
                      1)                                   # (bs, 4, 3)

    # 2. barycentric coordinates: [x; 1] = A alpha, A = [[ctl^T], [1]]
    a_mat = torch.cat([ctl_w.transpose(1, 2),
                       x3d.new_ones((bs, 1, 4))], 1)       # (bs, 4, 4)
    rhs = torch.cat([x3d, x3d.new_ones((bs, n, 1))], -1)   # (bs, n, 4)
    alpha = torch.linalg.solve(a_mat[:, None], rhs[..., None])[..., 0]

    # 3. normalized-coordinate projection system, Gram-accumulated
    cam_k = cam_k.to(dtype)
    u = (x2d[..., 0] - cam_k[0, 2]) / cam_k[0, 0]
    v = (x2d[..., 1] - cam_k[1, 2]) / cam_k[1, 1]
    zero = torch.zeros_like(alpha)
    row_x = torch.stack([alpha, zero, -alpha * u[..., None]], -1
                        ).reshape(bs, n, 12)
    row_y = torch.stack([zero, alpha, -alpha * v[..., None]], -1
                        ).reshape(bs, n, 12)
    mtm = (torch.einsum('bn,bni,bnj->bij', w, row_x, row_x)
           + torch.einsum('bn,bni,bnj->bij', w, row_y, row_y))

    # 4. nullspace vector -> camera-frame control points
    _, vecs = torch.linalg.eigh(mtm)
    ctl_c = vecs[..., 0].reshape(bs, 4, 3)
    ii, jj = torch.triu_indices(4, 4, offset=1, device=x3d.device)
    d_w = torch.linalg.vector_norm(ctl_w[:, ii] - ctl_w[:, jj], dim=-1)
    d_c = torch.linalg.vector_norm(ctl_c[:, ii] - ctl_c[:, jj], dim=-1)
    beta = d_w.sum(-1) / (d_c.sum(-1) + eps)               # (bs,)
    ctl_c = ctl_c * beta[:, None, None]
    # sign: the reconstructed points lie in front of the camera
    pts_c = torch.einsum('bnj,bjk->bnk', alpha, ctl_c)     # (bs, n, 3)
    z_mean = (w * pts_c[..., 2]).sum(-1) / w_sum[..., 0]
    sign = torch.where(z_mean < 0, -1.0, 1.0).to(dtype)
    pts_c = pts_c * sign[:, None, None]

    # 5. weighted Kabsch: R maps the object frame to the camera frame
    cent_c = (w[..., None] * pts_c).sum(1) / w_sum
    pc = pts_c - cent_c[:, None]
    h = torch.einsum('bn,bni,bnj->bij', w, pc, xc)         # (bs, 3, 3)
    uu, _, vt = torch.linalg.svd(h)
    det = torch.linalg.det(uu @ vt)
    d_fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det],
                        -1)
    rot = torch.einsum('bij,bj,bjk->bik', uu, d_fix, vt)   # (bs, 3, 3)
    t = cent_c - torch.einsum('bij,bj->bi', rot, cent)
    quat = matrix_to_quaternion(rot)
    return torch.cat([t, quat], -1).to(torch.float32)


def _canonical_signs(vecs: torch.Tensor) -> torch.Tensor:
    """Eigenvectors (columns of ``vecs``) turned so that each one's entry
    of largest magnitude is positive (the first such entry on a tie)."""
    idx = vecs.abs().argmax(-2, keepdim=True)
    sign = torch.where(torch.gather(vecs, -2, idx) < 0, -1.0, 1.0)
    return vecs * sign.to(vecs.dtype)


class TestOutputs(NamedTuple):
    pose_est: torch.Tensor        # (bs, 3, 4) rot-head pose [R|t]
    pose_est_trans: torch.Tensor  # (bs, 3, 4) trans-head pose [I|t]


def decode_trans_head(pred_trans, batch: Batch, box_wh, cam_intrinsic,
                      out_res: int):
    """Translation head decode to a camera-frame translation.

    ``pred_trans = [cx_ratio_delta, cy_ratio_delta, depth_ratio]``.
    """
    ratio_delta_c = pred_trans[:, :2]
    ratio_depth = pred_trans[:, 2]
    pred_depth = ratio_depth * (out_res / batch.s_box)
    pred_c = ratio_delta_c * box_wh + batch.c_box
    fx, fy = cam_intrinsic[0, 0], cam_intrinsic[1, 1]
    cx, cy = cam_intrinsic[0, 2], cam_intrinsic[1, 2]
    pred_x = (pred_c[:, 0] - cx) * pred_depth / fx
    pred_y = (pred_c[:, 1] - cy) * pred_depth / fy
    return torch.stack([pred_x, pred_y, pred_depth], -1)


def quat_to_rt(pose_7: torch.Tensor) -> torch.Tensor:
    """(bs, 7) [t, q] -> (bs, 3, 4) [R|t]."""
    rot = quaternion_to_rot_mat(pose_7[:, 3:])
    return torch.cat([rot, pose_7[:, :3, None]], -1)


def _serving_camera_and_cost(cfg, cam_intrinsic, x2d, w2d):
    bs = x2d.shape[0]
    camera = PerspectiveCamera(
        cam_mats=torch.as_tensor(cam_intrinsic, dtype=x2d.dtype,
                                 device=x2d.device).expand(bs, 3, 3),
        z_min=0.01)
    cost_fun = AdaptiveHuberPnPCost(
        relative_delta=cfg.pnp.relative_delta).set_param(x2d, w2d)
    return camera, cost_fun


def orient_density_images(outs, batch: Batch, cam_intrinsic,
                          cfg: SixDoFConfig,
                          rng: Optional[torch.Generator] = None):
    """Per-sample SO(3) orientation-density renders of one test batch (the
    reference's eval visualisation, EPro-PnP-6DoF/lib/test.py:218-225):
    ``monte_carlo_forward`` on the predicted correspondences, its
    posterior quaternion samples splatted onto the density sphere.
    Returns bs BGR uint8 images (cv2 renders them)."""
    from ..visualization.orient_density import draw_so3_density
    out_res = cfg.dataiter.out_res
    x3d, x2d, w2d, _ = build_correspondences(
        outs.noc, outs.w2d, outs.scale, batch, cam_intrinsic, out_res)
    camera, cost_fun = _serving_camera_and_cost(cfg, cam_intrinsic, x2d, w2d)
    with torch.no_grad():
        _, _, _, pose_samples, logweights, _ = build_epropnp(
            cfg).monte_carlo_forward(x3d, x2d, w2d, camera, cost_fun,
                                     rng=rng, force_init_solve=True)
    quats = pose_samples[..., 3:].double().cpu().numpy()  # (mc, bs, 4)
    lw = logweights.double().cpu().numpy()                # (mc, bs)
    weights = np.exp(lw - lw.max(axis=0, keepdims=True))
    weights /= weights.sum(axis=0, keepdims=True) + 1e-12
    return [draw_so3_density(quats[:, k], weights[:, k])
            for k in range(x3d.shape[0])]


def make_refine_fn(cfg: SixDoFConfig, cam_intrinsic):
    """Batched GN refinement from a given ``pose_init``."""
    solver = build_test_solver(cfg)

    def refine(x3d, x2d, w2d, pose_init):
        camera, cost_fun = _serving_camera_and_cost(cfg, cam_intrinsic, x2d,
                                                    w2d)
        pose_opt, _, _, _ = solver(x3d, x2d, w2d, camera, cost_fun,
                                   pose_init=pose_init, fast_mode=True)
        return pose_opt

    return refine


@torch.no_grad()
def infer_poses(outs, batch: Batch, box_wh, cam_intrinsic,
                cfg: SixDoFConfig, refine_fn=None, init: str = 'epnp',
                rng: Optional[torch.Generator] = None):
    """Full test-time pose inference for one batch.

    Args:
        outs: ``CDPNOutputs`` from the model (dense noc/w2d/scale + trans).
        cam_intrinsic: (3, 3) tensor on the outputs' device.
        refine_fn: the refinement of the EPnP inits (``make_refine_fn``;
            None builds one).
        init: ``'epnp'`` (host cv2, the reference's recipe),
            ``'epnp_device'`` (batched EPnP on the device) or ``'rslm'``
            (random-sample LM init on the device).
        rng: ``torch.Generator`` for the RSLM init (None = seed 0).

    Returns TestOutputs with [R|t] estimates from the rot and trans heads.
    """
    if init not in INITS:
        raise ValueError(f'init={init!r}; expected one of {INITS}')
    out_res = cfg.dataiter.out_res
    x3d, x2d, w2d, _ = build_correspondences(
        outs.noc, outs.w2d, outs.scale, batch, cam_intrinsic, out_res)

    if init == 'rslm':
        solver = build_test_solver(cfg, with_init_solver=True)
        camera, cost_fun = _serving_camera_and_cost(cfg, cam_intrinsic, x2d,
                                                    w2d)
        pose_opt, _, _, _ = solver(x3d, x2d, w2d, camera, cost_fun, rng=rng,
                                   fast_mode=True)
    else:
        conf = w2d.mean(-1)
        if init == 'epnp':
            pose_init = torch.as_tensor(epnp_init_host(
                x3d.cpu().numpy(), x2d.cpu().numpy(), conf.cpu().numpy(),
                torch.as_tensor(cam_intrinsic).cpu().numpy()),
                dtype=x3d.dtype).to(x3d.device)
        else:
            pose_init = epnp_init_device(x3d, x2d, conf,
                                         torch.as_tensor(cam_intrinsic))
        if refine_fn is None:
            refine_fn = make_refine_fn(cfg, cam_intrinsic)
        pose_opt = refine_fn(x3d, x2d, w2d, pose_init)

    pose_est = quat_to_rt(pose_opt)
    t_vec = decode_trans_head(outs.trans, batch, box_wh, cam_intrinsic,
                              out_res)
    eye = torch.eye(3, dtype=t_vec.dtype, device=t_vec.device
                    ).expand(t_vec.shape[0], 3, 3)
    pose_est_trans = torch.cat([eye, t_vec[..., None]], -1)
    return TestOutputs(pose_est=pose_est, pose_est_trans=pose_est_trans)
