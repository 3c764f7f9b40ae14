"""Det-suite inference (PyTorch): from images to 3D detections.

Counterpart of ``epropnp_tpu/det/test.py`` (``build_test_pnp``,
``make_inference_fn``, ``make_tta_inference_fn``,
``mc_score_and_orient_density``, ``results_to_numpy``): FCOS top-k
candidates, deformable-correspondence subheads, the fast-mode Gauss-Newton
4DoF PnP solve (RSLM init), 3D-to-2D boxes, per-(image, class) 2D NMS,
then BEV NMS. Shapes are fixed: detections come back as a (K,)-padded
structure with a validity mask; ``results_to_numpy`` makes the ragged
per-image, per-class lists. With ``cfg.pnp.use_pallas`` both solves (the
proposals' and the refinement) run through K1.
"""

from __future__ import annotations

import math
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
from ..ops.pnp.common import evaluate_pnp
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
        pose_opt, _, _, _ = self.pnp(x3d, x2d, w2d, camera, cost_fun,
                                     rng=rng, fast_mode=True)
        return self.detections(
            preds, sub.dim_dec, pose_opt, torch.sigmoid(sub.score_pred),
            sub.velo, sub.attr, cam_intrinsic, ori_shapes, n_img)

    def detections(self, preds, dim_dec, pose_opt, score_3d, velo, attr,
                   cam_intrinsic, ori_shapes, n_img) -> DetResults:
        """Boxes from the solved poses, then the 2D and BEV NMS."""
        img_inds, labels, valid = (preds['img_inds'], preds['labels'],
                                   preds['valid'])
        bbox_3d = torch.cat([dim_dec, pose_opt], -1)  # (K, 7)
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
                          img_inds=img_inds, velo=velo, attr=attr,
                          valid=alive)


def _flip_w(x: torch.Tensor) -> torch.Tensor:
    """Flip an NHWC map along its width (the JAX ``[:, :, ::-1]``)."""
    return torch.flip(x, [2])


class DetTTAInference(DetInference):
    """Horizontal-flip test-time augmentation (the reference's aug_test
    :661-717), the counterpart of JAX's ``make_tta_inference_fn``:
    ``infer(img, img_flip, cam_intrinsic, img_shapes, ori_shapes,
    img_dense_x2d, img_dense_x2d_flip, img_dense_x2d_mask, rng)``.

    The dense stage runs on the images and on their flips; the
    flip-corrected score maps are averaged and the candidates selected
    once; each candidate's correspondences come from both passes
    (concatenated along the points, weights halved); dimensions, 3D
    scores, velocities and attributes are averaged before one solve.
    """

    @torch.no_grad()
    def __call__(self, img, img_flip, cam_intrinsic, img_shapes, ori_shapes,
                 img_dense_x2d, img_dense_x2d_flip, img_dense_x2d_mask,
                 rng: Optional[torch.Generator] = None) -> DetResults:
        return self.post(self.dense(img), self.dense(img_flip),
                         cam_intrinsic, img_shapes, ori_shapes,
                         img_dense_x2d, img_dense_x2d_flip,
                         img_dense_x2d_mask, rng=rng)

    @torch.no_grad()
    def pnp_problem(self, dense, dense_flip, cam_intrinsic, img_shapes,
                    ori_shapes, img_dense_x2d, img_dense_x2d_flip,
                    img_dense_x2d_mask):
        """``(preds, (dim_dec, score_3d, velo, attr), x3d, x2d, w2d,
        camera, cost_fun)`` of the two passes."""
        (outs0, key0, value0), (outs1, key1, value1) = dense, dense_flip
        cfg, head = self.cfg, self.model.bbox_head
        n_img = key0.shape[0]
        avg_outs = [o0._replace(
            cls_score=(o0.cls_score + _flip_w(o1.cls_score)) / 2,
            centerness=(o0.centerness + _flip_w(o1.centerness)) / 2)
            for o0, o1 in zip(outs0, outs1)]
        preds = head.detector.get_preds(
            avg_outs,
            extra_maps=[[o.obj_emb for o in outs0],
                        [_flip_w(o.obj_emb) for o in outs1],
                        [o.center for o in outs0],
                        [_flip_w(o.center) for o in outs1]],
            max_obj_per_img=self.max_obj_per_img,
            min_fcos_score=self.min_fcos_score)
        img_inds, labels = preds['img_inds'], preds['labels']
        emb0, emb1, center0, center1 = preds['gathered']
        mask_small = avg_pool_stride(img_dense_x2d_mask, cfg.output_stride)
        flips = torch.zeros((n_img,), dtype=torch.bool, device=key0.device)
        # the flipped branch's centre values are already in flipped pixel
        # space (its maps were only flipped for the gather), so they
        # address the flipped key/value maps unchanged (reference
        # :683-699)
        subs = [head.forward_subheads(
            center, emb, key, value,
            avg_pool_stride(x2d, cfg.output_stride), mask_small,
            preds['strides'], img_inds, labels, flip, img_shapes)
            for center, emb, key, value, x2d, flip in (
                (center0, emb0, key0, value0, img_dense_x2d, flips),
                (center1, emb1, key1, value1, img_dense_x2d_flip, ~flips))]
        sub0, sub1 = subs
        dim_dec = (sub0.dim_dec + sub1.dim_dec) / 2
        score_3d = (torch.sigmoid(sub0.score_pred)
                    + torch.sigmoid(sub1.score_pred)) / 2
        noc = torch.cat([sub0.noc_list[-1], sub1.noc_list[-1]], 1)
        x2d = torch.cat([sub0.x2d, sub1.x2d], 1)
        w2d = torch.cat([s.w2d_list[-1] * s.scale[:, None, :]
                         for s in subs], 1) / 2
        x3d = noc * dim_dec[:, None]
        velo = None if sub0.velo is None else (sub0.velo + sub1.velo) / 2
        attr = None if sub0.attr is None else (sub0.attr + sub1.attr) / 2
        camera = PerspectiveCamera.from_img_shape(
            cam_intrinsic[img_inds], ori_shapes[img_inds], z_min=0.1,
            allowed_border=200.0)
        cost_fun = AdaptiveHuberPnPCost(
            relative_delta=cfg.pnp.relative_delta).set_param(x2d, w2d)
        return (preds, (dim_dec, score_3d, velo, attr), x3d, x2d, w2d,
                camera, cost_fun)

    @torch.no_grad()
    def post(self, dense, dense_flip, cam_intrinsic, img_shapes, ori_shapes,
             img_dense_x2d, img_dense_x2d_flip, img_dense_x2d_mask,
             rng: Optional[torch.Generator] = None) -> DetResults:
        preds, (dim_dec, score_3d, velo, attr), x3d, x2d, w2d, camera, \
            cost_fun = self.pnp_problem(
                dense, dense_flip, cam_intrinsic, img_shapes, ori_shapes,
                img_dense_x2d, img_dense_x2d_flip, img_dense_x2d_mask)
        pose_opt, _, _, _ = self.pnp(x3d, x2d, w2d, camera, cost_fun,
                                     rng=rng, fast_mode=True)
        return self.detections(preds, dim_dec, pose_opt, score_3d, velo,
                               attr, cam_intrinsic, ori_shapes,
                               dense[1].shape[0])


def make_inference_fn(model, cfg: DetConfig, max_obj_per_img: int = 256,
                      min_fcos_score: float = 0.04, nms_iou2d: float = 0.8,
                      nms_ioubev: float = 0.25) -> DetInference:
    return DetInference(model, cfg, max_obj_per_img, min_fcos_score,
                        nms_iou2d, nms_ioubev)


def make_tta_inference_fn(model, cfg: DetConfig, max_obj_per_img: int = 256,
                          min_fcos_score: float = 0.04,
                          nms_iou2d: float = 0.8, nms_ioubev: float = 0.25
                          ) -> DetTTAInference:
    return DetTTAInference(model, cfg, max_obj_per_img, min_fcos_score,
                           nms_iou2d, nms_ioubev)


@torch.no_grad()
def mc_score_and_orient_density(cfg: DetConfig, x3d, x2d, w2d, camera,
                                cost_fun, pose_opt,
                                rng: Optional[torch.Generator] = None,
                                mc_scoring_ratio: float = 0.0,
                                orient_bins: int = 128, score_3d=None):
    """Optional Monte Carlo rescoring and the yaw-density grid (the
    reference's test_post :518-551).

    With ``mc_scoring_ratio`` > 0 the AMIS forward (``monte_carlo_forward``
    in fast mode, its init solve drawn from ``rng``) scores each object by
    the expected translation error of its pose samples, mixed into
    ``score_3d`` at that ratio. With ``orient_bins`` > 0 the cost over a
    uniform yaw grid at ``pose_opt``'s translation, log-softmax normalised,
    is a circular log-density (``orient_logprob``, (K, bins)).
    """
    pnp = build_test_pnp(cfg)
    out = {}
    if mc_scoring_ratio > 0:
        _, _, _, pose_samples, logweights, _ = pnp.monte_carlo_forward(
            x3d, x2d, w2d, camera, cost_fun, rng=rng, fast_mode=True)
        weights = torch.softmax(logweights, 0)
        dev = torch.linalg.vector_norm(
            pose_samples[..., [0, 2]] - pose_opt[None, :, [0, 2]], dim=-1)
        score_mc = torch.clamp(
            (-torch.log2(torch.clamp(dev, min=1e-12)) + 2.5) / 4.0, 0.0, 1.0)
        score_mc = (score_mc * weights).sum(0)
        out['pose_samples'] = pose_samples
        out['pose_sample_weights'] = weights
        out['score_3d'] = score_mc if score_3d is None else (
            score_3d ** (1 - mc_scoring_ratio)
            * score_mc ** mc_scoring_ratio)
    if orient_bins > 0:
        grid = torch.linspace(0.0, 2 * math.pi * (orient_bins - 1)
                              / orient_bins, orient_bins,
                              dtype=pose_opt.dtype, device=pose_opt.device)
        pose_grid = pose_opt[None].repeat(orient_bins, 1, 1)
        pose_grid[..., 3] = grid[:, None]
        cost = evaluate_pnp(x3d, x2d, w2d, pose_grid, camera, cost_fun,
                            out_cost=True).cost
        out['orient_logprob'] = (torch.log_softmax(-cost, 0) + math.log(
            orient_bins / (2 * math.pi))).transpose(0, 1)
    return out


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
