"""LineMOD pose evaluation metrics: ADD(-S), n-deg n-cm, 2D reprojection.

A copy of ``epropnp_tpu/sixdof/eval_metrics.py`` (numpy and scipy only).
Numpy/scipy reimplementation of the reference's ``Evaluation`` suite
(EPro-PnP-6DoF/lib/utils/eval.py:34-360, helpers :530-660), vectorized over
all poses of a class at once instead of the reference's per-sample Python
loop (identical numbers). Evaluation runs on the host.

Metric definitions:
  * ADD  — mean distance between model points transformed by the estimated
    and GT poses (Hinterstoisser ACCV'12).
  * ADD-S (``adi``) — mean nearest-neighbor distance, for symmetric objects
    (eggbox/glue/bowl/cup in LineMOD).
  * n-deg n-cm — rotation geodesic error and translation error thresholds
    over a 1..10 deg x 1..10 cm grid; eggbox evaluated up to the 180-deg
    z-flip symmetry (reference :59-62).
  * ARP-2D — mean reprojection distance of model points in pixels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
from scipy import spatial

# LineMOD symmetric classes (reference lib/utils/eval.py:150)
SYMMETRIC_CLASSES = ('eggbox', 'glue', 'bowl', 'cup')

RT_Z_FLIP = np.array([[-1., 0., 0., 0.],
                      [0., -1., 0., 0.],
                      [0., 0., 1., 0.]])


def se3_mul(rt1: np.ndarray, rt2: np.ndarray) -> np.ndarray:
    """Compose two (3, 4) [R|t] transforms. Reference: eval.py:530."""
    r = rt1[:, :3] @ rt2[:, :3]
    t = rt1[:, :3] @ rt2[:, 3] + rt1[:, 3]
    return np.concatenate([r, t[:, None]], axis=1)


def transform_pts(pts: np.ndarray, rot: np.ndarray, t: np.ndarray):
    """pts (n, 3) by batched rot (..., 3, 3), t (..., 3) -> (..., n, 3)."""
    return np.einsum('...ij,nj->...ni', rot, pts) + t[..., None, :]


def project_pts(pts_cam: np.ndarray, k_mat: np.ndarray) -> np.ndarray:
    uvw = np.einsum('ij,...nj->...ni', k_mat, pts_cam)
    return uvw[..., :2] / uvw[..., 2:]


def add_err(rot_est, t_est, rot_gt, t_gt, pts) -> np.ndarray:
    """Batched ADD. Reference: eval.py:603-617."""
    pe = transform_pts(pts, rot_est, t_est)
    pg = transform_pts(pts, rot_gt, t_gt)
    return np.linalg.norm(pe - pg, axis=-1).mean(axis=-1)


def adi_err(rot_est, t_est, rot_gt, t_gt, pts) -> np.ndarray:
    """Batched ADD-S via nearest neighbors. Reference: eval.py:620-639."""
    pe = transform_pts(pts, rot_est, t_est)
    pg = transform_pts(pts, rot_gt, t_gt)
    if pe.ndim == 2:
        return np.asarray(
            spatial.cKDTree(pe).query(pg, k=1)[0].mean())
    return np.array([
        spatial.cKDTree(e).query(g, k=1)[0].mean() for e, g in zip(pe, pg)])


def arp_2d_err(rot_est, t_est, rot_gt, t_gt, pts, k_mat) -> np.ndarray:
    """Batched mean 2D reprojection error (px). Reference: eval.py:585-600."""
    pe = project_pts(transform_pts(pts, rot_est, t_est), k_mat)
    pg = project_pts(transform_pts(pts, rot_gt, t_gt), k_mat)
    return np.linalg.norm(pe - pg, axis=-1).mean(axis=-1)


def rot_err_deg(rot_est: np.ndarray, rot_gt: np.ndarray) -> np.ndarray:
    """Geodesic rotation error in degrees (batched).

    Reference ``calc_rt_dist_m`` uses the acos-of-trace formula
    (eval.py:642-652 re_old semantics).
    """
    cos = 0.5 * (np.einsum('...ii->...', np.einsum(
        '...ij,...kj->...ik', rot_est, rot_gt)) - 1.0)
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def calc_rt_dist_m(pose_src: np.ndarray, pose_tgt: np.ndarray):
    """(r_deg, t_m) between two (3, 4) poses (batched over leading dims)."""
    r = rot_err_deg(pose_src[..., :3], pose_tgt[..., :3])
    t = np.linalg.norm(pose_src[..., 3] - pose_tgt[..., 3], axis=-1)
    return r, t


def auc_at(errors: np.ndarray, max_threshold: float, steps: int = 100):
    """Area under the accuracy-vs-threshold curve on [0, max_threshold]."""
    thresholds = np.linspace(0.0, max_threshold, steps + 1)[1:]
    acc = (errors[None, :] < thresholds[:, None]).mean(axis=1)
    return float(acc.mean()), thresholds, acc


@dataclasses.dataclass
class ClassResult:
    add_acc: Dict[str, float]          # keys '0.02' '0.05' '0.10'
    add_auc: float                     # area under curve to 0.10 diameter
    rot_acc: np.ndarray                # (10,) over 1..10 deg
    trans_acc: np.ndarray              # (10,) over 1..10 cm
    space_acc: np.ndarray              # (10,) joint
    arp_acc: Dict[str, float]          # keys '2px' '5px' '10px'
    count: int


class PoseEvaluator:
    """Accumulates per-class (3, 4) pose estimates/GT and computes metrics.

    Mirrors the reference ``Evaluation`` class API surface
    (eval.py:20-360): feed pose pairs with ``update``, then call
    ``evaluate_pose`` / ``evaluate_pose_add`` / ``evaluate_pose_arp_2d``.

    Args:
        models: {class_name: (n, 3) model points}.
        diameters: {class_name: model diameter (m)}.
        cam_k: (3, 3) camera intrinsics (for ARP-2D).
    """

    def __init__(self, classes: Sequence[str],
                 models: Dict[str, np.ndarray],
                 diameters: Dict[str, float],
                 cam_k: Optional[np.ndarray] = None):
        self.classes = list(classes)
        self.models = models
        self.diameters = diameters
        self.cam_k = cam_k
        self.pose_est: Dict[str, List[np.ndarray]] = {c: [] for c in classes}
        self.pose_gt: Dict[str, List[np.ndarray]] = {c: [] for c in classes}

    def update(self, cls_name: str, pose_est: np.ndarray,
               pose_gt: np.ndarray):
        self.pose_est[cls_name].append(np.asarray(pose_est, np.float64))
        self.pose_gt[cls_name].append(np.asarray(pose_gt, np.float64))

    def extend(self, cls_name: str, poses_est: Iterable[np.ndarray],
               poses_gt: Iterable[np.ndarray]):
        for pe, pg in zip(poses_est, poses_gt):
            self.update(cls_name, pe, pg)

    def _stacked(self, cls_name):
        if not self.pose_gt[cls_name]:
            return None, None
        return (np.stack(self.pose_est[cls_name]),
                np.stack(self.pose_gt[cls_name]))

    def evaluate_pose(self) -> Dict[str, Dict[str, np.ndarray]]:
        """n-deg n-cm accuracy grids per class. Reference: eval.py:34-109."""
        rot_thresh = np.arange(1, 11, 1, dtype=np.float64)
        trans_thresh = np.arange(0.01, 0.11, 0.01)
        out = {}
        for cls_name in self.classes:
            est, gt = self._stacked(cls_name)
            if est is None:
                continue
            r_err, t_err = calc_rt_dist_m(est, gt)
            if cls_name == 'eggbox':
                # z-flip symmetry: retry flipped where rotation error > 90
                flip = r_err > 90.0
                if np.any(flip):
                    est_flip = np.stack(
                        [se3_mul(p, RT_Z_FLIP) for p in est[flip]])
                    rf, tf = calc_rt_dist_m(est_flip, gt[flip])
                    r_err[flip], t_err[flip] = rf, tf
            out[cls_name] = {
                'rot_acc': (r_err[None] < rot_thresh[:, None]).mean(1),
                'trans_acc': (t_err[None] < trans_thresh[:, None]).mean(1),
                'space_acc': ((r_err[None] < rot_thresh[:, None])
                              & (t_err[None] < trans_thresh[:, None])).mean(1),
            }
        if out:
            out['mean'] = {
                k: np.mean([v[k] for v in out.values()], axis=0)
                for k in ('rot_acc', 'trans_acc', 'space_acc')}
        return out

    def evaluate_pose_add(self) -> Dict[str, Dict[str, float]]:
        """ADD(-S) accuracies at 0.02/0.05/0.10 diameter + AUC.

        Reference: eval.py:112-231 (symmetric classes use ``adi``).
        """
        out = {}
        for cls_name in self.classes:
            est, gt = self._stacked(cls_name)
            if est is None:
                continue
            pts = self.models[cls_name]
            fn = adi_err if cls_name in SYMMETRIC_CLASSES else add_err
            err = np.atleast_1d(
                fn(est[..., :3], est[..., 3], gt[..., :3], gt[..., 3], pts))
            dia = self.diameters[cls_name]
            auc, _, _ = auc_at(err, 0.10 * dia)
            out[cls_name] = {
                '0.02': float((err < 0.02 * dia).mean() * 100),
                '0.05': float((err < 0.05 * dia).mean() * 100),
                '0.10': float((err < 0.10 * dia).mean() * 100),
                'auc': auc * 100,
            }
        if out:
            out['mean'] = {
                k: float(np.mean([v[k] for v in out.values()]))
                for k in ('0.02', '0.05', '0.10', 'auc')}
        return out

    def evaluate_pose_arp_2d(self) -> Dict[str, Dict[str, float]]:
        """2D reprojection accuracy at 2/5/10 px. Reference: eval.py:233-360."""
        assert self.cam_k is not None, 'ARP-2D needs camera intrinsics'
        out = {}
        for cls_name in self.classes:
            est, gt = self._stacked(cls_name)
            if est is None:
                continue
            pts = self.models[cls_name]
            err = np.atleast_1d(arp_2d_err(
                est[..., :3], est[..., 3], gt[..., :3], gt[..., 3], pts,
                self.cam_k))
            if cls_name == 'eggbox':
                r_err = rot_err_deg(est[..., :3], gt[..., :3])
                flip = r_err > 90.0
                if np.any(flip):
                    est_flip = np.stack(
                        [se3_mul(p, RT_Z_FLIP) for p in est[flip]])
                    err[flip] = np.atleast_1d(arp_2d_err(
                        est_flip[..., :3], est_flip[..., 3],
                        gt[flip][..., :3], gt[flip][..., 3], pts, self.cam_k))
            out[cls_name] = {
                '2px': float((err < 2.0).mean() * 100),
                '5px': float((err < 5.0).mean() * 100),
                '10px': float((err < 10.0).mean() * 100),
            }
        if out:
            out['mean'] = {
                k: float(np.mean([v[k] for v in out.values()]))
                for k in ('2px', '5px', '10px')}
        return out
