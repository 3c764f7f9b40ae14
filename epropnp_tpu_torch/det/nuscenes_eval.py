"""Self-contained (devkit-free) nuScenes detection metrics.

Implements the official ``detection_cvpr_2019`` protocol in plain numpy:
center-distance matching at thresholds {0.5, 1, 2, 4} m, 101-point
interpolated AP with the (0.1 recall, 0.1 precision) operating-point
floor, the five TP error metrics (ATE/ASE/AOE/AVE/AAE) accumulated over
the 2.0 m matching sweep, and the NDS composite
``(5·mAP + Σ max(0, 1 − mTP)) / 10``.

The reference delegates this to the external nuscenes devkit
(EPro-PnP-Det/epropnp_det/datasets/nuscenes3d_dataset.py:240-280,
``NuScenesEval``); this module reproduces the devkit's algorithm
(nuscenes.eval.detection.algo ``accumulate``/``calc_ap``/``calc_tp``)
so NDS/mAP are measurable without the devkit or network access.

Box format (both predictions and GT) — the submission-JSON dict per box:
``translation`` (3, global frame), ``size`` (3, wlh), ``rotation``
(4, wxyz quaternion, global), ``velocity`` (2,), ``detection_name``,
``detection_score`` (predictions only), ``attribute_name``. GT boxes may
additionally carry ``num_pts`` (lidar+radar point count; 0 ⇒ filtered
out, matching the devkit) and ``ego_translation`` for range filtering.

Bike-rack filtering (devkit ``filter_eval_boxes``, loaders.py): the
devkit removes bicycle/motorcycle boxes — predictions AND GT — whose
center lies inside any ``static_object.bicycle_rack`` annotation box of
the same sample. Supported here via the optional ``bikerack_frames``
input (sample_token -> list of rack box dicts with translation/size/
rotation); callers without rack annotations omit it and keep the plain
range-filtered behavior.

The PyTorch port keeps this copy of ``epropnp_tpu/det/nuscenes_eval.py``
(the same code; it imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TP_METRICS = ('trans_err', 'scale_err', 'orient_err', 'vel_err', 'attr_err')
TP_METRIC_NAMES = {
    'trans_err': 'mATE', 'scale_err': 'mASE', 'orient_err': 'mAOE',
    'vel_err': 'mAVE', 'attr_err': 'mAAE'}
DIST_THS = (0.5, 1.0, 2.0, 4.0)
TP_DIST_TH = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MEAN_AP_WEIGHT = 5
N_REC = 101

# per-class metric exclusions (devkit detection config)
_EXCLUDED = {
    'traffic_cone': ('attr_err', 'vel_err', 'orient_err'),
    'barrier': ('attr_err', 'vel_err'),
}

DEFAULT_CLASS_RANGE = {
    'car': 50, 'truck': 50, 'bus': 50, 'trailer': 50,
    'construction_vehicle': 50, 'pedestrian': 40, 'motorcycle': 40,
    'bicycle': 40, 'traffic_cone': 30, 'barrier': 30,
}


# ------------------------------------------------------------ box helpers

def quaternion_yaw(q: Sequence[float]) -> float:
    """Yaw of a global-frame box quaternion (devkit ``quaternion_yaw``):
    the heading of the rotated x-axis projected to the ground plane."""
    w, x, y, z = q
    # v = R @ [1, 0, 0]
    vx = 1 - 2 * (y * y + z * z)
    vy = 2 * (x * y + z * w)
    return float(np.arctan2(vy, vx))


def center_distance(gt: Dict, pred: Dict) -> float:
    return float(np.linalg.norm(
        np.asarray(pred['translation'][:2]) -
        np.asarray(gt['translation'][:2])))


def scale_iou(gt: Dict, pred: Dict) -> float:
    """IoU of the two boxes after aligning translation and yaw."""
    sa = np.maximum(np.asarray(gt['size'], np.float64), 0.0)
    sr = np.maximum(np.asarray(pred['size'], np.float64), 0.0)
    inter = float(np.prod(np.minimum(sa, sr)))
    union = float(np.prod(sa) + np.prod(sr) - inter)
    return inter / union if union > 0 else 0.0


def yaw_diff(gt: Dict, pred: Dict, period: float = 2 * np.pi) -> float:
    diff = quaternion_yaw(gt['rotation']) - quaternion_yaw(pred['rotation'])
    diff = (diff + period / 2) % period - period / 2
    if diff > np.pi:
        diff -= 2 * np.pi
    return abs(float(diff))


def velocity_l2(gt: Dict, pred: Dict) -> float:
    gv = np.asarray(gt.get('velocity', (np.nan, np.nan))[:2], np.float64)
    pv = np.asarray(pred.get('velocity', (0.0, 0.0))[:2], np.float64)
    return float(np.linalg.norm(pv - gv))


def attr_acc(gt: Dict, pred: Dict) -> float:
    if gt.get('attribute_name', '') == '':
        return np.nan
    return float(gt['attribute_name'] == pred.get('attribute_name', ''))


def cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaNs (devkit ``cummean``)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(np.float64))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals,
                     out=np.zeros_like(sum_vals), where=count_vals > 0)


def filter_boxes_by_range(
        frames: Dict[str, List[Dict]],
        ego_centers: Dict[str, Sequence[float]],
        class_range: Optional[Dict[str, float]] = None,
        is_gt: bool = False) -> Dict[str, List[Dict]]:
    """Devkit ``filter_eval_boxes``: range filter (+ GT num_pts > 0)."""
    class_range = class_range or DEFAULT_CLASS_RANGE
    out = {}
    for token, boxes in frames.items():
        ego = np.asarray(ego_centers[token][:2], np.float64)
        kept = []
        for b in boxes:
            dist = float(np.linalg.norm(
                np.asarray(b['translation'][:2]) - ego))
            if dist > class_range.get(b['detection_name'], 50):
                continue
            if is_gt and b.get('num_pts', 1) == 0:
                continue
            kept.append(b)
        out[token] = kept
    return out


def point_in_box(point: Sequence[float], box: Dict) -> bool:
    """Devkit ``points_in_box`` for a single point: is ``point`` inside
    the oriented 3D box (translation, size=(w,l,h), rotation=wxyz)?

    The box frame has x along length, y along width, z along height
    (devkit Box.corners convention)."""
    t = np.asarray(box['translation'], np.float64)
    w, l, h = np.asarray(box['size'], np.float64)
    qw, qx, qy, qz = np.asarray(box['rotation'], np.float64)
    # rotate (point - t) into the box frame with R^T
    r = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)]])
    local = r.T @ (np.asarray(point, np.float64) - t)
    return bool(abs(local[0]) <= l / 2 and abs(local[1]) <= w / 2
                and abs(local[2]) <= h / 2)


_BIKERACK_CLASSES = ('bicycle', 'motorcycle')


def filter_bike_racks(frames: Dict[str, List[Dict]],
                      bikerack_frames: Dict[str, List[Dict]]
                      ) -> Dict[str, List[Dict]]:
    """Devkit bike-rack filtering (``filter_eval_boxes``): drop bicycle/
    motorcycle boxes whose center is inside any bike-rack box of the
    same sample. Applied by the devkit to predictions and GT alike."""
    out = {}
    for token, boxes in frames.items():
        racks = bikerack_frames.get(token, ())
        if not racks:
            out[token] = list(boxes)
            continue
        kept = []
        for b in boxes:
            if (b['detection_name'] in _BIKERACK_CLASSES
                    and any(point_in_box(b['translation'], rack)
                            for rack in racks)):
                continue
            kept.append(b)
        out[token] = kept
    return out


# ----------------------------------------------------------- accumulation

class MetricData:
    """Per (class, dist_th) curves on the 101-point recall grid."""

    def __init__(self, recall, precision, confidence, tp_errors):
        self.recall = recall
        self.precision = precision
        self.confidence = confidence
        self.tp_errors = tp_errors  # dict metric -> (101,) array

    @property
    def max_recall_ind(self) -> int:
        non_zero = np.nonzero(self.confidence)[0]
        return int(non_zero[-1]) if len(non_zero) else -1

    @classmethod
    def no_predictions(cls):
        return cls(recall=np.linspace(0, 1, N_REC),
                   precision=np.zeros(N_REC),
                   confidence=np.zeros(N_REC),
                   tp_errors={m: np.ones(N_REC) for m in TP_METRICS})


def accumulate(gt_frames: Dict[str, List[Dict]],
               pred_frames: Dict[str, List[Dict]],
               class_name: str, dist_th: float) -> MetricData:
    """Devkit ``accumulate``: global greedy center-distance matching.

    Predictions of ``class_name`` over ALL samples are sorted by score
    descending; each greedily claims the closest unclaimed same-class GT
    in its sample if within ``dist_th`` meters (BEV center distance).
    """
    npos = sum(1 for boxes in gt_frames.values() for b in boxes
               if b['detection_name'] == class_name)
    if npos == 0:
        return MetricData.no_predictions()

    preds = [(b, token) for token, boxes in pred_frames.items()
             for b in boxes if b['detection_name'] == class_name]
    preds.sort(key=lambda p: -p[0]['detection_score'])

    tp, fp, conf = [], [], []
    match_data = {m: [] for m in TP_METRICS}
    match_conf = []
    taken = set()
    for pred, token in preds:
        gt_boxes = gt_frames.get(token, ())
        min_dist, match_idx = np.inf, None
        for gt_idx, gt in enumerate(gt_boxes):
            if (gt['detection_name'] == class_name
                    and (token, gt_idx) not in taken):
                d = center_distance(gt, pred)
                if d < min_dist:
                    min_dist, match_idx = d, gt_idx
        score = float(pred['detection_score'])
        if min_dist < dist_th:
            taken.add((token, match_idx))
            gt = gt_boxes[match_idx]
            tp.append(1)
            fp.append(0)
            conf.append(score)
            period = np.pi if class_name == 'barrier' else 2 * np.pi
            match_data['trans_err'].append(center_distance(gt, pred))
            match_data['scale_err'].append(1.0 - scale_iou(gt, pred))
            match_data['orient_err'].append(yaw_diff(gt, pred, period))
            match_data['vel_err'].append(velocity_l2(gt, pred))
            acc = attr_acc(gt, pred)
            match_data['attr_err'].append(
                np.nan if np.isnan(acc) else 1.0 - acc)
            match_conf.append(score)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(score)

    if len(match_conf) == 0:
        return MetricData.no_predictions()

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    prec = tp / (tp + fp)
    rec = tp / float(npos)

    rec_interp = np.linspace(0, 1, N_REC)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)

    tp_errors = {}
    mconf = np.asarray(match_conf, np.float64)
    for key in TP_METRICS:
        tmp = cummean(np.asarray(match_data[key], np.float64))
        # map the cumulative error curve from confidence space onto the
        # recall grid (devkit uses the interpolated confidence as x)
        tp_errors[key] = np.interp(conf_i[::-1], mconf[::-1],
                                   tmp[::-1])[::-1]
    return MetricData(rec_interp, prec_i, conf_i, tp_errors)


def calc_ap(md: MetricData, min_recall: float = MIN_RECALL,
            min_precision: float = MIN_PRECISION) -> float:
    """Normalized AP above the (min_recall, min_precision) floor."""
    prec = np.copy(md.precision)
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md: MetricData, metric_name: str,
            min_recall: float = MIN_RECALL) -> float:
    """Mean TP error over achieved recalls above min_recall."""
    first_ind = round(100 * min_recall) + 1
    last_ind = md.max_recall_ind
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(md.tp_errors[metric_name][first_ind:last_ind + 1]))


# -------------------------------------------------------------- top level

def evaluate_detection(
        pred_frames: Dict[str, List[Dict]],
        gt_frames: Dict[str, List[Dict]],
        classes: Optional[Sequence[str]] = None,
        dist_ths: Sequence[float] = DIST_THS,
        tp_dist_th: float = TP_DIST_TH,
        ego_centers: Optional[Dict[str, Sequence[float]]] = None,
        class_range: Optional[Dict[str, float]] = None,
        bikerack_frames: Optional[Dict[str, List[Dict]]] = None) -> Dict:
    """Full detection_cvpr_2019 evaluation without the devkit.

    Args:
      pred_frames: sample_token -> list of prediction box dicts (the
        submission JSON ``results`` value).
      gt_frames: sample_token -> list of GT box dicts (same format,
        no score; optional num_pts). Tokens must cover pred_frames.
      ego_centers: optional sample_token -> ego (x, y) for devkit-style
        range filtering of BOTH sets; when None, boxes are assumed
        pre-filtered.
      bikerack_frames: optional sample_token -> bike-rack annotation
        boxes (translation/size/rotation dicts). When given, bicycle/
        motorcycle boxes centered inside a rack are dropped from BOTH
        sets (devkit ``filter_eval_boxes`` bike-rack step); when None,
        no rack filtering happens (documented deviation for callers
        without rack annotations).

    Returns a metrics_summary-style dict: mean_ap, nd_score, tp_errors
    (mATE/mASE/mAOE/mAVE/mAAE), label_aps, label_tp_errors.
    """
    if classes is None:
        from .nuscenes_dataset import CLASSES
        classes = CLASSES
    if ego_centers is not None:
        gt_frames = filter_boxes_by_range(gt_frames, ego_centers,
                                          class_range, is_gt=True)
        pred_frames = filter_boxes_by_range(pred_frames, ego_centers,
                                            class_range, is_gt=False)
    if bikerack_frames is not None:
        gt_frames = filter_bike_racks(gt_frames, bikerack_frames)
        pred_frames = filter_bike_racks(pred_frames, bikerack_frames)
    # every GT sample must be scored, even with zero predictions there
    pred_frames = {t: pred_frames.get(t, []) for t in gt_frames}

    label_aps: Dict[str, Dict[float, float]] = {}
    label_tp: Dict[str, Dict[str, float]] = {}
    for cls in classes:
        mds = {d: accumulate(gt_frames, pred_frames, cls, d)
               for d in dist_ths}
        label_aps[cls] = {d: calc_ap(mds[d]) for d in dist_ths}
        md_tp = mds[tp_dist_th]
        tps = {}
        for metric in TP_METRICS:
            if metric in _EXCLUDED.get(cls, ()):
                tps[metric] = np.nan
            else:
                tps[metric] = calc_tp(md_tp, metric)
        label_tp[cls] = tps

    mean_ap = float(np.mean([label_aps[c][d]
                             for c in classes for d in dist_ths]))
    tp_errors = {}
    for m in TP_METRICS:
        vals = np.asarray([label_tp[c][m] for c in classes])
        # all-NaN happens only for class subsets where every class
        # excludes the metric (e.g. barrier-only); worst-case it
        tp_errors[m] = (1.0 if np.all(np.isnan(vals))
                        else float(np.nanmean(vals)))
    tp_scores = {m: max(0.0, 1.0 - v) for m, v in tp_errors.items()}
    nd_score = ((MEAN_AP_WEIGHT * mean_ap + sum(tp_scores.values()))
                / (MEAN_AP_WEIGHT + len(TP_METRICS)))

    mean_dist_aps = {c: float(np.mean(list(label_aps[c].values())))
                     for c in classes}
    return dict(
        mean_ap=mean_ap,
        nd_score=float(nd_score),
        tp_errors={TP_METRIC_NAMES[m]: v for m, v in tp_errors.items()},
        tp_scores={TP_METRIC_NAMES[m]: v for m, v in tp_scores.items()},
        label_aps={c: {str(d): v for d, v in label_aps[c].items()}
                   for c in classes},
        label_tp_errors=label_tp,
        mean_dist_aps=mean_dist_aps,
    )
