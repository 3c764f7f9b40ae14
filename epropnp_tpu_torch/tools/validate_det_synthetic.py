"""End-to-end Det-suite validation on synthetic multi-object scenes
(PyTorch), the counterpart of ``tools/validate_det_synthetic.py``.

Trains the full Det stack (backbone, FPN, FCOSEmbHead, deformable
attention, correspondence transformer, the AMIS Monte Carlo pose loss and
every auxiliary loss) from scratch on synthetic NOC-coloured cuboid
scenes (``det/synthetic.py``), then serves held-out scenes (FCOS top-k,
subheads, the fast-mode PnP, 2D and BEV NMS) and scores them against the
ground truth: recall, precision, mATE, mASE and mAOE at a BEV IoU match
threshold (the exact rotated IoU), and the devkit-free nuScenes NDS/mAP.

Usage:
  python -m epropnp_tpu_torch.tools.validate_det_synthetic [--steps 600]
      [--bs 4] [--eval-scenes 16] [--eval-every 100] [--seed 0]
      [--pallas] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.bbox_3d.rotate_iou import rotated_iou_matrix
from ..det import train as dtrain
from ..det.config import (DetConfig, DetLossWeights, DetPnPConfig,
                          DetTrainConfig)
from ..det.synthetic import SyntheticDetSceneGenerator
from ..det.test import make_inference_fn, results_to_numpy
from ..models.detectors.epropnp_det import EProPnPDet
from ..utils import cuda_setup

IM_HW = (128, 224)
NCLS = 3
GMAX = 4
PTS = 16


def small_cfg(use_pallas: bool = False) -> DetConfig:
    """A reduced-but-real Det config sized for fast synthetic convergence."""
    return DetConfig(
        num_classes=NCLS, backbone_depth=18, embed_dims=64, num_heads=4,
        num_points=8, strides=(4, 8, 16, 32), output_stride=4,
        with_loss_regr=True, num_attrs=2,
        pnp=DetPnPConfig(mc_samples=64, num_iter=4, lm_num_iter=4,
                         rs_num_points=8, rs_num_proposals=16, rs_num_iter=2,
                         use_pallas=use_pallas),
        train=DetTrainConfig(num_obj_samples_per_img=8, roi_shape=(12, 12),
                             max_gt_per_img=GMAX, lr=3e-4))


def v1b_small_cfg(use_pallas: bool = False) -> DetConfig:
    """The v1b family's traits (strides from 8, class embeddings,
    class-specific dimensions and offsets, pose weight 0.5, RoI 14x14)
    at study scale."""
    return DetConfig(
        num_classes=NCLS, backbone_depth=18, embed_dims=64, num_heads=4,
        num_points=8, strides=(8, 16, 32, 64, 128), output_stride=8,
        use_cls_emb=True, dim_cls_agnostic=False, offset_cls_agnostic=False,
        with_loss_regr=True, num_attrs=2,
        loss=DetLossWeights(pose=0.5),
        pnp=DetPnPConfig(mc_samples=64, num_iter=4, lm_num_iter=4,
                         rs_num_points=8, rs_num_proposals=16, rs_num_iter=2,
                         use_pallas=use_pallas),
        train=DetTrainConfig(num_obj_samples_per_img=8, roi_shape=(14, 14),
                             max_gt_per_img=GMAX, lr=3e-4))


PRESETS = {'small': small_cfg, 'v1b_small': v1b_small_cfg}


def build_model(cfg: DetConfig, dcn: bool = False,
                int8_gather: bool = False,
                level_packed: bool = False) -> EProPnPDet:
    """The study's detector: no backbone DCN, 64-wide FCOS branches, one
    regress range per FCOS level (24 px doubling from stride 8)."""
    n_fcos = len(cfg.strides) - cfg.strides.index(8)
    bounds = [-1.0] + [24.0 * 2 ** i for i in range(n_fcos - 1)] + [1e8]
    ranges = tuple(zip(bounds[:-1], bounds[1:]))
    return EProPnPDet(
        num_classes=cfg.num_classes, backbone_depth=cfg.backbone_depth,
        backbone_dcn_stages=(), embed_dims=cfg.embed_dims,
        num_heads=cfg.num_heads, num_points=cfg.num_points,
        strides=cfg.strides, output_stride=cfg.output_stride,
        num_attrs=cfg.num_attrs, dcn_on_last_conv=dcn,
        dcn_int8_gather=int8_gather, level_packed_towers=level_packed,
        use_cls_emb=cfg.use_cls_emb, dim_cls_agnostic=cfg.dim_cls_agnostic,
        offset_cls_agnostic=cfg.offset_cls_agnostic,
        detector_cfg=dict(
            feat_channels=64, emb_channels=cfg.embed_dims, cls_branch=(64,),
            centerness_branch=(32,), offset_branch=(64,), emb_branch=(64,),
            regress_ranges=ranges))


def scenes_to_batch(gen: SyntheticDetSceneGenerator, stacked,
                    device=None) -> dtrain.DetBatch:
    """Stacked scenes -> a ``DetBatch`` of tensors on ``device`` (the CUDA
    card unless given): labels and attributes int64, flips and masks
    bool, the rest float32; the dense x2d map holds pixel centres."""
    device = torch.device('cuda' if device is None else device)
    n = stacked.img.shape[0]
    h, w = gen.im_hw

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(device, dtype)
    return dtrain.DetBatch(
        img=t(stacked.img),
        cam_intrinsic=t(np.tile(gen.cam_k, (n, 1, 1))),
        img_shapes=t(np.tile([float(h), float(w)], (n, 1))),
        ori_shapes=t(np.tile([float(h), float(w)], (n, 1))),
        img_flips=t(np.zeros((n,), bool), torch.bool),
        img_dense_x2d=t(gen.dense_x2d(n)),
        img_dense_x2d_mask=t(np.ones((n, h, w, 1))),
        gt_bboxes=t(stacked.gt_bboxes),
        gt_bboxes_3d=t(stacked.gt_bboxes_3d),
        gt_labels=t(stacked.gt_labels, torch.int64),
        gt_mask=t(stacked.gt_mask, torch.bool),
        gt_velo=t(stacked.gt_velo),
        gt_attr=t(stacked.gt_attr, torch.int64),
        gt_x3d=t(stacked.gt_x3d),
        gt_x2d=t(stacked.gt_x2d),
        gt_pts_mask=t(stacked.gt_pts_mask, torch.bool))


def evaluate(results_3d, gt_scenes, iou_thr: float = 0.25,
             score_thr: float = 0.1):
    """Greedy per-class BEV-IoU matching -> TP metrics.

    ``results_3d[img][cls]`` rows are [l, h, w, x, y, z, ry, score, ...].
    """
    n_gt = n_det = n_tp = 0
    ate, ase, aoe = [], [], []
    for i in range(gt_scenes.img.shape[0]):
        for c in range(NCLS):
            gsel = gt_scenes.gt_mask[i] & (gt_scenes.gt_labels[i] == c)
            gt = gt_scenes.gt_bboxes_3d[i][gsel]            # (g, 7)
            det = results_3d[i][c]
            det = det[det[:, 7] >= score_thr] if det.size else det
            n_gt += len(gt)
            n_det += len(det)
            if not len(gt) or not len(det):
                continue
            det = det[np.argsort(-det[:, 7])]
            # BEV boxes [cx, cz, l, w, ry]
            gt_bev = np.stack([gt[:, 3], gt[:, 5], gt[:, 0], gt[:, 2],
                               gt[:, 6]], -1)
            dt_bev = np.stack([det[:, 3], det[:, 5], det[:, 0], det[:, 2],
                               det[:, 6]], -1)
            iou = rotated_iou_matrix(
                torch.as_tensor(dt_bev, dtype=torch.float32),
                torch.as_tensor(gt_bev, dtype=torch.float32)).numpy()
            taken = np.zeros(len(gt), bool)
            for d in range(len(det)):
                j = int(np.argmax(np.where(taken, -1.0, iou[d])))
                if iou[d, j] >= iou_thr and not taken[j]:
                    taken[j] = True
                    n_tp += 1
                    ate.append(float(np.linalg.norm(
                        det[d, 3:6] - gt[j, 3:6])))
                    mn = np.minimum(det[d, :3], gt[j, :3])
                    mx = np.maximum(det[d, :3], gt[j, :3])
                    ase.append(1.0 - float(np.prod(mn) / np.prod(mx)))
                    dyaw = abs(det[d, 6] - gt[j, 6]) % (2 * np.pi)
                    aoe.append(float(min(dyaw, 2 * np.pi - dyaw)))
    return dict(
        recall=n_tp / max(n_gt, 1), precision=n_tp / max(n_det, 1),
        n_gt=n_gt, n_det=n_det, n_tp=n_tp,
        mate=float(np.mean(ate)) if ate else float('nan'),
        mase=float(np.mean(ase)) if ase else float('nan'),
        maoe=float(np.mean(aoe)) if aoe else float('nan'))


SYN_CLASSES = tuple(f'c{i}' for i in range(NCLS))


def _box_dict(l, h, w, x, y, z, ry, cls_id, score=None):
    """Camera-frame box -> devkit-style dict (pseudo-global frame:
    ground plane = camera (x, z), up = -y; yaw about the up axis)."""
    d = dict(
        translation=(float(x), float(z), float(-y)),
        size=(float(w), float(l), float(h)),
        rotation=(float(np.cos(ry / 2)), 0.0, 0.0, float(np.sin(ry / 2))),
        velocity=(0.0, 0.0),
        # constant attribute: the synthetic scenes model none, so AAE is
        # pinned at 0 rather than the all-NaN -> 1.0 devkit convention
        attribute_name='syn.static',
        detection_name=SYN_CLASSES[int(cls_id)])
    if score is not None:
        d['detection_score'] = float(score)
    return d


def evaluate_nds(results_3d, gt_scenes, score_thr: float = 0.05):
    """Score the synthetic eval set with the devkit-free nuScenes metrics
    (``det.nuscenes_eval``): centre-distance mAP over {0.5, 1, 2, 4} m and
    the TP errors -> NDS."""
    from ..det.nuscenes_eval import evaluate_detection

    gt_frames, pred_frames = {}, {}
    for i in range(gt_scenes.img.shape[0]):
        token = f'img{i}'
        gts = []
        for g in np.flatnonzero(gt_scenes.gt_mask[i]):
            gts.append(_box_dict(*gt_scenes.gt_bboxes_3d[i][g],
                                 cls_id=gt_scenes.gt_labels[i][g]))
        preds = []
        for c in range(NCLS):
            det = results_3d[i][c]
            if not det.size:
                continue
            for row in det[det[:, 7] >= score_thr]:
                preds.append(_box_dict(*row[:7], cls_id=c, score=row[7]))
        gt_frames[token] = gts
        pred_frames[token] = preds
    return evaluate_detection(pred_frames, gt_frames, classes=SYN_CLASSES)


def run_study(steps=600, bs=4, pool=64, eval_scenes=16, eval_every=100,
              seed=0, iou_thr=0.25, pallas=False, log=print,
              preset='small', dcn=False, eval_variants=False, device=None):
    """Train the small-but-real Det stack on ``pool * bs`` synthetic
    scenes and score held-out scenes with the devkit-free nuScenes
    metrics after every ``eval_every`` steps, on ``device`` (the CUDA card
    unless given).

    Returns ``{'curve': [(step, metrics), ...], 'best_step', 'ms_per_step',
    **best_metrics}``."""
    device = torch.device('cuda' if device is None else device)
    cfg = PRESETS[preset](pallas)
    torch.manual_seed(seed)
    model = build_model(cfg, dcn=dcn).to(device,
                                         memory_format=torch.channels_last)
    gen = SyntheticDetSceneGenerator(im_hw=IM_HW, num_classes=NCLS,
                                     max_gt=GMAX, lidar_points=PTS)
    rng_np = np.random.default_rng(seed)

    log(f'device={device}')
    t0 = time.time()
    # a training pool resident on the device and a held-out eval set
    # from a disjoint stream
    pool_batches = [scenes_to_batch(gen, gen.sample_batch(rng_np, bs),
                                    device) for _ in range(pool)]
    eval_rng = np.random.default_rng(seed + 10_000)
    eval_sc = gen.sample_batch(eval_rng, eval_scenes)
    eval_batch = scenes_to_batch(gen, eval_sc, device)
    log(f'scene generation: {time.time() - t0:.1f}s '
        f'({pool}x{bs} train + {eval_scenes} eval)')

    state = dtrain.DetTrainState(model, dtrain.make_optimizer(cfg, model))
    step = dtrain.make_train_step(cfg)
    infer = make_inference_fn(model, cfg, max_obj_per_img=64,
                              min_fcos_score=0.04)

    def run_eval(eval_model, infer_fn):
        eval_model.eval()
        with torch.no_grad():
            res = infer_fn(
                eval_batch.img, eval_batch.cam_intrinsic,
                eval_batch.img_shapes, eval_batch.ori_shapes,
                eval_batch.img_flips, eval_batch.img_dense_x2d,
                eval_batch.img_dense_x2d_mask,
                rng=torch.Generator(device).manual_seed(123))
        eval_model.train()
        _, res3d = results_to_numpy(res, eval_scenes, NCLS)
        m = evaluate(res3d, eval_sc, iou_thr=iou_thr)
        nds = evaluate_nds(res3d, eval_sc)
        m['nds'] = float(nds['nd_score'])
        m['map'] = float(nds['mean_ap'])
        return m

    gen_t = torch.Generator(device).manual_seed(seed + 1)
    t0 = time.time()
    best, curve, t_base = None, [], 0
    for i in range(steps):
        losses = step(state, pool_batches[i % pool], gen_t)
        if i == 0:
            float(losses['loss_cls'])
            log(f'first step: {time.time() - t0:.1f}s')
            t0, t_base = time.time(), 1
        if (i + 1) % eval_every == 0 or i + 1 == steps:
            m = run_eval(model, infer)
            log(f'step {i + 1:5d}  loss_cls={float(losses["loss_cls"]):.3f} '
                f'loss_pose_0={float(losses["loss_pose_0"]):.3f} '
                f'ate={float(losses["ate"]):.2f} | eval '
                f'recall={m["recall"]:.3f} prec={m["precision"]:.3f} '
                f'mATE={m["mate"]:.3f} mASE={m["mase"]:.3f} '
                f'mAOE={m["maoe"]:.3f} NDS={m["nds"]:.3f} '
                f'mAP={m["map"]:.3f}')
            curve.append((i + 1, m))
            if best is None or m['nds'] > best[0]:
                best = (m['nds'], i + 1, m)
    dt = time.time() - t0
    steps_timed = steps - t_base
    ms_per_step = dt / max(steps_timed, 1) * 1e3
    log(f'train: {dt:.1f}s for {steps_timed} steps '
        f'({ms_per_step:.1f} ms/step)')
    _, best_step, m = best
    log(f'BEST @ step {best_step}: NDS={m["nds"]:.3f} mAP={m["map"]:.3f} '
        f'recall={m["recall"]:.3f} '
        f'precision={m["precision"]:.3f} mATE={m["mate"]:.3f} '
        f'mASE={m["mase"]:.3f} mAOE={m["maoe"]:.3f} '
        f'({m["n_tp"]}/{m["n_gt"]} GT matched @ IoU {iou_thr})')
    out = dict(best_step=best_step, ms_per_step=ms_per_step,
               curve=curve, **m)
    if eval_variants:
        # the final weights under the serving variants (the same
        # parameters; only the execution path changes): the int8-gather
        # and level-packed quality deltas through NMS and NDS
        variants = {'packed': dict(dcn=dcn, level_packed=True)}
        if dcn:
            variants['int8'] = dict(dcn=True, int8_gather=True)
            variants['packed_int8'] = dict(dcn=True, int8_gather=True,
                                           level_packed=True)
        out['variants'] = {}
        for name, kw in variants.items():
            vm = build_model(cfg, **kw).to(device,
                                           memory_format=torch.channels_last)
            vm.load_state_dict(model.state_dict())
            mv = run_eval(vm, make_inference_fn(vm, cfg, max_obj_per_img=64,
                                                min_fcos_score=0.04))
            log(f'variant {name}: NDS={mv["nds"]:.3f} mAP={mv["map"]:.3f} '
                f'(float final: NDS={curve[-1][1]["nds"]:.3f})')
            out['variants'][name] = dict(nds=mv['nds'], map=mv['map'],
                                         mate=mv['mate'], maoe=mv['maoe'])
    return out


def main(argv=None):
    cuda_setup.configure_cuda()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=600)
    ap.add_argument('--bs', type=int, default=4)
    ap.add_argument('--pool', type=int, default=64,
                    help='device-resident scene-pool size (batches)')
    ap.add_argument('--eval-scenes', type=int, default=16)
    ap.add_argument('--eval-every', type=int, default=100)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--iou-thr', type=float, default=0.25)
    ap.add_argument('--pallas', action='store_true',
                    help='the fused LM kernel (K1) in the solves')
    ap.add_argument('--preset', type=str, default='small',
                    choices=sorted(PRESETS))
    ap.add_argument('--dcn', action='store_true',
                    help='deformable last tower convs (the int8 and packed '
                         'variants need a DCN to exercise)')
    ap.add_argument('--eval-variants', action='store_true',
                    help='re-score the final state under the serving '
                         'variants (level-packed, int8 gather)')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--json-out', type=str, default='')
    args = ap.parse_args(argv)

    out = run_study(steps=args.steps, bs=args.bs, pool=args.pool,
                    eval_scenes=args.eval_scenes,
                    eval_every=args.eval_every, seed=args.seed,
                    iou_thr=args.iou_thr, pallas=args.pallas,
                    preset=args.preset, dcn=args.dcn,
                    eval_variants=args.eval_variants, device=args.device,
                    log=lambda *a: print(*a, flush=True))
    if args.json_out:
        with open(args.json_out, 'w') as f:
            json.dump(out, f)


if __name__ == '__main__':
    main()
