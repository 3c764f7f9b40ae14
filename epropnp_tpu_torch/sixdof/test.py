"""6DoF test-time pose inference (PyTorch), the port's serving path.

Counterpart of ``epropnp_tpu/sixdof/test.py`` for ``init='rslm'``: dense
correspondence maps -> legacy-softmax weights -> the random-sample LM init
on the device -> batched fast-mode Gauss-Newton refinement -> translation-
head pose decode. With ``cfg.pnp.use_pallas`` the proposal solves and the
refinement run through the fused LM kernel K1.

The ``'epnp'`` init (host ``cv2.solvePnP``) and the batched on-device EPnP
(``'epnp_device'``) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.pnp import (
    AdaptiveHuberPnPCost,
    LMSolver,
    PerspectiveCamera,
    RSLMSolver,
)
from ..ops.pnp.common import quaternion_to_rot_mat
from .config import SixDoFConfig
from .train import Batch, build_correspondences


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
                cfg: SixDoFConfig, refine_fn=None, init: str = 'rslm',
                rng: Optional[torch.Generator] = None):
    """Full test-time pose inference for one batch.

    Args:
        outs: ``CDPNOutputs`` from the model (dense noc/w2d/scale + trans).
        cam_intrinsic: (3, 3) tensor on the outputs' device.
        init: ``'rslm'`` (random-sample LM init on the device); the EPnP
            inits are not ported yet and raise.
        rng: ``torch.Generator`` for the init solver (None = seed 0).

    Returns TestOutputs with [R|t] estimates from the rot and trans heads.
    """
    if init != 'rslm':
        raise NotImplementedError(
            f"init={init!r} is not ported yet; use init='rslm'")
    out_res = cfg.dataiter.out_res
    x3d, x2d, w2d, _ = build_correspondences(
        outs.noc, outs.w2d, outs.scale, batch, cam_intrinsic, out_res)

    solver = build_test_solver(cfg, with_init_solver=True)
    camera, cost_fun = _serving_camera_and_cost(cfg, cam_intrinsic, x2d, w2d)
    pose_opt, _, _, _ = solver(x3d, x2d, w2d, camera, cost_fun, rng=rng,
                               fast_mode=True)

    pose_est = quat_to_rt(pose_opt)
    t_vec = decode_trans_head(outs.trans, batch, box_wh, cam_intrinsic,
                              out_res)
    eye = torch.eye(3, dtype=t_vec.dtype, device=t_vec.device
                    ).expand(t_vec.shape[0], 3, 3)
    pose_est_trans = torch.cat([eye, t_vec[..., None]], -1)
    return TestOutputs(pose_est=pose_est, pose_est_trans=pose_est_trans)
