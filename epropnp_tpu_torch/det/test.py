"""Det-suite inference (PyTorch): from images to 3D detections.

Counterpart of ``epropnp_tpu/det/test.py`` (``build_test_pnp``,
``make_inference_fn``, ``results_to_numpy``): FCOS top-k candidates,
deformable-correspondence subheads, the fast-mode Gauss-Newton 4DoF PnP
solve (RSLM init), 3D-to-2D boxes, per-(image, class) 2D NMS, then BEV
NMS. Shapes are fixed: detections come back as a (K,)-padded structure
with a validity mask; ``results_to_numpy`` makes the ragged per-image,
per-class lists. With ``cfg.pnp.use_pallas`` both solves (the proposals'
and the refinement) run through K1. Flip TTA and Monte Carlo scoring are
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.bbox_3d.misc import batched_bev_nms_per_image, bboxes_3d_to_2d
from ..core.bbox_3d.nms import nms_axis_aligned_per_image
from ..ops.pnp import (
    AdaptiveHuberPnPCost,
    EProPnP4DoF,
    LMSolver,
    PerspectiveCamera,
    RSLMSolver,
)
from .config import DetConfig
from .train import avg_pool_stride


class DetResults(NamedTuple):
    """Fixed-size (K,) detection set; ``valid`` marks live entries."""
    bbox_3d: torch.Tensor    # (K, 7) [l, h, w, x, y, z, ry]
    bbox_2d: torch.Tensor    # (K, 4)
    scores: torch.Tensor     # (K,) 2d score
    scores_3d: torch.Tensor  # (K,) combined 3d score
    labels: torch.Tensor     # (K,)
    img_inds: torch.Tensor   # (K,)
    velo: Optional[torch.Tensor]  # (K, 2)
    attr: Optional[torch.Tensor]  # (K, num_attrs) logits
    valid: torch.Tensor      # (K,) bool


def build_test_pnp(cfg: DetConfig) -> EProPnP4DoF:
    """Test-time solver: LM iterations 10 -> 5 (basic.py:153)."""
    p = cfg.pnp
    return EProPnP4DoF(
        mc_samples=p.mc_samples, num_iter=p.num_iter, normalize=p.normalize,
        solver=LMSolver(
            dof=4, num_iter=p.test_lm_num_iter, normalize=p.normalize,
            use_pallas=p.use_pallas,
            init_solver=RSLMSolver(
                dof=4, num_points=p.rs_num_points,
                num_proposals=p.rs_num_proposals, num_iter=p.rs_num_iter,
                use_pallas=p.use_pallas)))


class DetInference:
    """``infer(img, cam_intrinsic, img_shapes, ori_shapes, img_flips,
    img_dense_x2d, img_dense_x2d_mask, rng)`` -> :class:`DetResults`.

    The call is ``post(dense(img), ...)``: ``dense`` is the network's dense
    stage (backbone, FPN, FCOS towers, key/value), ``post`` everything
    after it, so a caller can run the two stages apart; ``pnp_problem`` is
    the part of ``post`` before the solve.
    """

    def __init__(self, model, cfg: DetConfig, max_obj_per_img: int = 256,
                 min_fcos_score: float = 0.04, nms_iou2d: float = 0.8,
                 nms_ioubev: float = 0.25):
        self.model, self.cfg = model, cfg
        self.max_obj_per_img = max_obj_per_img
        self.min_fcos_score = min_fcos_score
        self.nms_iou2d, self.nms_ioubev = nms_iou2d, nms_ioubev
        self.pnp = build_test_pnp(cfg)

    @torch.no_grad()
    def __call__(self, img, *args, **kwargs) -> DetResults:
        return self.post(self.dense(img), *args, **kwargs)

    @torch.no_grad()
    def dense(self, img):
        """(n, h, w, 3) -> (FCOS level outputs, key, value)."""
        return self.model.det_dense(img, (img.shape[1], img.shape[2]))

    @torch.no_grad()
    def pnp_problem(self, dense, cam_intrinsic, img_shapes, ori_shapes,
                    img_flips, img_dense_x2d, img_dense_x2d_mask):
        """Candidates, subheads and the 4DoF PnP problem of each object:
        ``(preds, sub, x3d, x2d, w2d, camera, cost_fun)``."""
        det_outs, key, value = dense
        cfg = self.cfg
        head = self.model.bbox_head
        preds = head.detector.get_preds(
            det_outs, extra_maps=[[o.obj_emb for o in det_outs],
                                  [o.center for o in det_outs]],
            max_obj_per_img=self.max_obj_per_img,
            min_fcos_score=self.min_fcos_score)
        img_inds = preds['img_inds']
        obj_emb, center = preds['gathered']
        sub = head.forward_subheads(
            center, obj_emb, key, value,
            avg_pool_stride(img_dense_x2d, cfg.output_stride),
            avg_pool_stride(img_dense_x2d_mask, cfg.output_stride),
            preds['strides'], img_inds, preds['labels'], img_flips,
            img_shapes)
        w2d = sub.w2d_list[-1] * sub.scale[:, None, :]
        x3d = sub.noc_list[-1] * sub.dim_dec[:, None]
        camera = PerspectiveCamera.from_img_shape(
            cam_intrinsic[img_inds], ori_shapes[img_inds], z_min=0.1,
            allowed_border=200.0)
        cost_fun = AdaptiveHuberPnPCost(
            relative_delta=cfg.pnp.relative_delta).set_param(sub.x2d, w2d)
        return preds, sub, x3d, sub.x2d, w2d, camera, cost_fun

    @torch.no_grad()
    def post(self, dense, cam_intrinsic, img_shapes, ori_shapes, img_flips,
             img_dense_x2d, img_dense_x2d_mask,
             rng: Optional[torch.Generator] = None) -> DetResults:
        preds, sub, x3d, x2d, w2d, camera, cost_fun = self.pnp_problem(
            dense, cam_intrinsic, img_shapes, ori_shapes, img_flips,
            img_dense_x2d, img_dense_x2d_mask)
        n_img = dense[1].shape[0]
        img_inds, labels, valid = (preds['img_inds'], preds['labels'],
                                   preds['valid'])
        pose_opt, _, _, _ = self.pnp(x3d, x2d, w2d, camera, cost_fun,
                                     rng=rng, fast_mode=True)
        score_3d = torch.sigmoid(sub.score_pred)

        bbox_3d = torch.cat([sub.dim_dec, pose_opt], -1)  # (K, 7)
        bbox_2d, bbox_2d_mask = bboxes_3d_to_2d(
            bbox_3d, cam_intrinsic[img_inds], ori_shapes[img_inds])
        score = preds['score']
        combined = score * score_3d
        alive = valid & bbox_2d_mask
        # per-(image, class) 2D NMS: images as batch blocks, classes by
        # the coordinate-offset trick
        span = bbox_2d.max() + 1.0
        boxes_off = bbox_2d + (labels.to(bbox_2d.dtype) * span)[:, None]
        alive = alive & nms_axis_aligned_per_image(
            boxes_off, combined, self.nms_iou2d, n_img, valid_mask=alive)
        bev_in = torch.cat([bbox_3d, combined[:, None]], -1)
        dead = torch.tensor([1, 1, 1, 1e6, 0, 1e6, 0, -1.0],
                            dtype=bev_in.dtype, device=bev_in.device)
        alive = alive & batched_bev_nms_per_image(
            torch.where(alive[:, None], bev_in, dead), labels, n_img,
            nms_thr=self.nms_ioubev)
        return DetResults(bbox_3d=bbox_3d, bbox_2d=bbox_2d, scores=score,
                          scores_3d=combined, labels=labels,
                          img_inds=img_inds, velo=sub.velo, attr=sub.attr,
                          valid=alive)


def make_inference_fn(model, cfg: DetConfig, max_obj_per_img: int = 256,
                      min_fcos_score: float = 0.04, nms_iou2d: float = 0.8,
                      nms_ioubev: float = 0.25) -> DetInference:
    return DetInference(model, cfg, max_obj_per_img, min_fcos_score,
                        nms_iou2d, nms_ioubev)


def results_to_numpy(results: DetResults, num_img: int, num_classes: int):
    """Fixed-size results -> per-image per-class ragged numpy lists:
    ``bbox_3d_results[img][cls]`` = (m, 9+) arrays [l, h, w, x, y, z, ry,
    score, velo_x, velo_y, attr_id] and the 2D boxes with their score."""
    r = type(results)(*(None if t is None else t.detach().cpu().numpy()
                        for t in results))
    out_2d, out_3d = [], []
    for i in range(num_img):
        per_img_2d, per_img_3d = [], []
        for c in range(num_classes):
            m = r.valid & (r.img_inds == i) & (r.labels == c)
            per_img_2d.append(np.concatenate(
                [r.bbox_2d[m], r.scores[m][:, None]], axis=-1))
            cols = [r.bbox_3d[m], r.scores_3d[m][:, None]]
            if r.velo is not None:
                cols.append(r.velo[m])
            if r.attr is not None:
                cols.append(np.argmax(r.attr[m], axis=-1)[:, None].astype(
                    np.float64))
            per_img_3d.append(np.concatenate(cols, axis=-1))
        out_2d.append(per_img_2d)
        out_3d.append(per_img_3d)
    return out_2d, out_3d
