"""nuScenes monocular-3D dataset: annotations, multicam fusion, submission.

Reference: EPro-PnP-Det/epropnp_det/datasets/nuscenes3d_dataset.py. The
dataset treats each of the 6 cameras as a monocular sample; at evaluation
per-camera detections are lifted to the global frame (sensor -> ego ->
global), distance-filtered per class, fused with cross-camera rotated BEV
NMS (the native C++ op), and written as a standard nuScenes submission
JSON. ``evaluate()`` uses the official nuscenes devkit for NDS/mAP when
it is installed and falls back to the self-contained protocol port in
``det/nuscenes_eval.py`` otherwise; everything else — parsing, geometry,
fusion, formatting — is self-contained numpy.

Camera-frame box layout: ``[l, h, w, x, y, z, ry]`` (KITTI-style, y down).

The PyTorch port keeps this copy of ``epropnp_tpu/det/nuscenes_dataset.py``
(the same code; it imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.iou3d import nms_rotated

CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
           'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone', 'barrier')
CAMS = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT', 'CAM_BACK',
        'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')
NUM_CAMS = len(CAMS)
KITTI2NUS_ROT = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
ATTRIBUTES = ('cycle.with_rider', 'cycle.without_rider',
              'pedestrian.moving', 'pedestrian.standing',
              'pedestrian.sitting_lying_down', 'vehicle.moving',
              'vehicle.parked', 'vehicle.stopped', '')
CLS_ORIENTATION = (True, True, True, True, True, True, True, True, False,
                   False)
CLS2ATTR = {
    'car': ('vehicle.moving', 'vehicle.parked', 'vehicle.stopped'),
    'truck': ('vehicle.moving', 'vehicle.parked', 'vehicle.stopped'),
    'trailer': ('vehicle.moving', 'vehicle.parked', 'vehicle.stopped'),
    'bus': ('vehicle.moving', 'vehicle.parked', 'vehicle.stopped'),
    'construction_vehicle': ('vehicle.moving', 'vehicle.parked',
                             'vehicle.stopped'),
    'bicycle': ('cycle.with_rider', 'cycle.without_rider'),
    'motorcycle': ('cycle.with_rider', 'cycle.without_rider'),
    'pedestrian': ('pedestrian.moving', 'pedestrian.standing',
                   'pedestrian.sitting_lying_down'),
    'traffic_cone': ('',),
    'barrier': ('',),
}
# official nuScenes detection range per class (meters)
CLASS_RANGE = {
    'car': 50, 'truck': 50, 'bus': 50, 'trailer': 50,
    'construction_vehicle': 50, 'pedestrian': 40, 'motorcycle': 40,
    'bicycle': 40, 'traffic_cone': 30, 'barrier': 30,
}


# ------------------------------------------------------- quaternion helpers

def quat_multiply(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def quat_to_mat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def mat_to_quat(m):
    # robust four-candidate construction
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = np.argmax(np.diag(m))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def quat_about_axis(axis, radians):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    half = radians / 2.0
    return np.concatenate([[np.cos(half)], axis * np.sin(half)])


@dataclasses.dataclass
class NusBox:
    """Minimal stand-in for the nuscenes devkit ``Box``."""
    center: np.ndarray       # (3,)
    wlh: np.ndarray          # (3,) [w, l, h]
    quat: np.ndarray         # (4,) [w, x, y, z]
    label: int
    score: float
    velocity: np.ndarray     # (3,)
    attr_name: str

    def rotate(self, q):
        m = quat_to_mat(q)
        self.center = m @ self.center
        self.velocity = m @ self.velocity
        self.quat = quat_multiply(q, self.quat)

    def translate(self, t):
        self.center = self.center + np.asarray(t)

    @property
    def rotation_matrix(self):
        return quat_to_mat(self.quat)


def bbox_3d_to_box_nus(bbox_3d: np.ndarray, label: int,
                       num_attrs: int = 9) -> NusBox:
    """Camera-frame detection row -> nuScenes Box.

    Row layout (det.test results): [l, h, w, x, y, z, ry, score,
    velo_x, velo_z, attr_logits...]. Reference: nuscenes3d_dataset.py:365-381.
    """
    center = np.asarray(bbox_3d[3:6], np.float64)
    size = np.asarray(bbox_3d[[2, 0, 1]], np.float64)  # wlh
    quat = quat_multiply(
        quat_about_axis([0.0, 1.0, 0.0], float(bbox_3d[6])),
        mat_to_quat(KITTI2NUS_ROT.T.astype(np.float64)))
    score = float(bbox_3d[7])
    velocity = np.array([bbox_3d[8], 0.0, bbox_3d[9]]) \
        if len(bbox_3d) > 9 else np.zeros(3)

    cls_name = CLASSES[label]
    attr_scope = CLS2ATTR[cls_name]
    if len(bbox_3d) > 10 + num_attrs - 1:
        attr_logits = np.asarray(bbox_3d[10:10 + num_attrs])
        scope_ids = [ATTRIBUTES.index(a) for a in attr_scope]
        attr_name = ATTRIBUTES[scope_ids[int(
            np.argmax(attr_logits[scope_ids]))]]
    else:
        attr_name = attr_scope[0]
    return NusBox(center, size, quat, label, score, velocity, attr_name)


def boxes_nus_to_xywhr(boxes: Sequence[NusBox]) -> np.ndarray:
    out = np.empty((len(boxes), 5), np.float32)
    for i, b in enumerate(boxes):
        out[i, :2] = b.center[:2]
        out[i, 2:4] = b.wlh[[1, 0]]
        m = b.rotation_matrix
        out[i, 4] = np.arctan2(m[0, 1] - m[1, 0], m[0, 0] + m[1, 1])
    return out


def multiclass_nms(boxes_multicls: List[List[NusBox]],
                   nms_thr: float = 0.25) -> List[NusBox]:
    """Cross-camera BEV NMS per class (offset trick + native rotated NMS).

    Reference: nuscenes3d_dataset.py:383-403.
    """
    flat = [b for cls_boxes in boxes_multicls for b in cls_boxes]
    if not flat:
        return []
    xywhr = boxes_nus_to_xywhr(flat)
    labels = np.concatenate([
        np.full(len(cls_boxes), i)
        for i, cls_boxes in enumerate(boxes_multicls)])
    span = (xywhr[:, :2].max() + xywhr[:, 2:4].max()
            - xywhr[:, :2].min()) * 2.0
    offs = xywhr.copy()
    offs[:, :2] += (span * labels)[:, None]
    scores = np.array([b.score for b in flat], np.float32)
    keep = nms_rotated(offs, scores, nms_thr)
    return [b for b, k in zip(flat, keep) if k]


def multicam_fusion(cam_results: List[Dict], nms_thr: float = 0.25,
                    max_boxes: int = 500) -> List[NusBox]:
    """Fuse per-camera detections of one frame into the global frame.

    Each ``cam_results[i]`` carries ``bbox_3d_results`` (per-class arrays)
    plus calibration: sensor2ego_rotation/translation (quat wxyz / vec),
    ego2global_rotation/translation. Reference: nuscenes3d_dataset.py:
    332-363.
    """
    boxes_multicls: List[List[NusBox]] = [[] for _ in CLASSES]
    for cam in cam_results:
        s2e_q = np.asarray(cam['sensor2ego_rotation'], np.float64)
        s2e_t = np.asarray(cam['sensor2ego_translation'], np.float64)
        e2g_q = np.asarray(cam['ego2global_rotation'], np.float64)
        e2g_t = np.asarray(cam['ego2global_translation'], np.float64)
        for label, bboxes in enumerate(cam['bbox_3d_results']):
            for row in np.asarray(bboxes):
                box = bbox_3d_to_box_nus(row, label)
                box.rotate(s2e_q)
                box.translate(s2e_t)
                if np.linalg.norm(box.center[:2]) > CLASS_RANGE[
                        CLASSES[label]]:
                    continue
                box.rotate(e2g_q)
                box.translate(e2g_t)
                boxes_multicls[label].append(box)
    boxes = multiclass_nms(boxes_multicls, nms_thr)
    if len(boxes) > max_boxes:
        boxes.sort(reverse=True, key=lambda b: b.score)
        boxes = boxes[:max_boxes]
    return boxes


def format_submission(frame_results: List[Dict], out_path: str,
                      modality: Optional[Dict] = None) -> str:
    """Write the nuScenes submission JSON.

    ``frame_results``: list of {'boxes': [NusBox], 'sample_token': str}.
    Reference: nuscenes3d_dataset.py:304-330.
    """
    modality = modality or dict(
        use_camera=True, use_lidar=False, use_radar=False, use_map=False,
        use_external=False)
    annos = {}
    for det in frame_results:
        sample = []
        for b in det['boxes']:
            sample.append(dict(
                sample_token=det['sample_token'],
                translation=[float(v) for v in b.center],
                size=[float(v) for v in b.wlh],
                rotation=[float(v) for v in b.quat],
                velocity=[float(v) for v in b.velocity[:2]],
                detection_name=CLASSES[b.label],
                detection_score=float(b.score),
                attribute_name=b.attr_name))
        annos[det['sample_token']] = sample
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, 'w') as f:
        json.dump({'meta': modality, 'results': annos}, f)
    return out_path


class NuScenes3DDataset:
    """Annotation-file-backed dataset yielding per-camera samples.

    The annotation file is the converter's pickle (see
    ``tools/nuscenes_converter.py``): a list of per-camera info dicts with
    image path, calibration, and parsed GT. Reference:
    nuscenes3d_dataset.py:60-225.
    """

    def __init__(self, ann_file, img_prefix: str = '',
                 trunc_ignore_thres: float = 0.8, min_box_size: float = 4.0,
                 min_visibility: int = 2, nms_thr: float = 0.25):
        self.img_prefix = img_prefix
        self.trunc_ignore_thres = trunc_ignore_thres
        self.min_box_size = min_box_size
        self.min_visibility = min_visibility
        self.nms_thr = nms_thr
        # one pickle or a list of pickles (the reference trainval configs
        # pass [train, val] — coord_regr_trainval.py:206-207)
        files = [ann_file] if isinstance(ann_file, (str, bytes)) \
            else list(ann_file)
        self.data_infos = []
        for path in files:
            with open(path, 'rb') as f:
                self.data_infos.extend(pickle.load(f))

    def __len__(self):
        return len(self.data_infos)

    def parse_ann_info(self, info: Dict) -> Dict:
        """Filter + convert raw annotations. Reference: :154-225.

        Velocity is the converter's camera-frame (vx, vz) — the training
        target (reference ``_parse_ann_info`` feeds it directly). When the
        converter cached lidar object coordinates (``oc_path``), the kept
        annotations gain ``x3d``/``x2d`` lists (reference
        LoadAnnotations3D, pipelines/loading.py:17-78) for ``loss_regr``.
        """
        gt = dict(bboxes=[], labels=[], attrs=[], velos=[], bboxes_3d=[],
                  truncation=[], bboxes_ignore=[])
        oc = None
        if info.get('oc_path') and os.path.exists(info['oc_path']):
            with open(info['oc_path'], 'rb') as f:
                oc = pickle.load(f)
            gt['x3d'], gt['x2d'] = [], []
        for idx, ann in enumerate(info.get('annotations', [])):
            name = ann['category']
            if name not in CLASSES:
                continue
            w, h = (ann['bbox'][2] - ann['bbox'][0],
                    ann['bbox'][3] - ann['bbox'][1])
            keep = (ann.get('visibility', 4) >= self.min_visibility
                    and ann.get('truncation', 0.0) <= self.trunc_ignore_thres
                    and min(w, h) >= self.min_box_size)
            if not keep:
                gt['bboxes_ignore'].append(ann['bbox'])
                continue
            gt['bboxes'].append(ann['bbox'])
            gt['labels'].append(CLASSES.index(name))
            gt['attrs'].append(ATTRIBUTES.index(ann.get('attribute', '')))
            gt['velos'].append(ann.get('velocity', [np.nan, np.nan]))
            gt['truncation'].append(float(ann.get('truncation', 0.0)))
            if oc is not None:
                gt['x3d'].append(oc['oc_list'][idx])
                gt['x2d'].append(oc['uv_list'][idx])
            # nuScenes box (center, wlh, quat in camera frame) -> KITTI row
            rot = quat_to_mat(np.asarray(ann['rotation'], np.float64)) \
                @ KITTI2NUS_ROT
            yaw = np.arctan2(rot[0, 2] - rot[2, 0], rot[0, 0] + rot[2, 2])
            wlh = np.asarray(ann['size'], np.float64)
            lhw = wlh[[1, 2, 0]]
            gt['bboxes_3d'].append(
                np.concatenate([lhw, ann['translation'], [yaw]]))
        for k in ('bboxes', 'labels', 'attrs', 'velos', 'bboxes_3d',
                  'truncation'):
            gt[k] = (np.stack(gt[k]) if gt[k]
                     else np.zeros((0,) + {'bboxes': (4,), 'labels': (),
                                           'attrs': (), 'velos': (2,),
                                           'truncation': (),
                                           'bboxes_3d': (7,)}[k]))
        return gt

    def build_global_gt(self):
        """Global-frame GT frames for the self-contained evaluator.

        Lifts each camera-frame annotation (converter pickles store
        nuScenes-native center/wlh/quaternion per camera) through
        sensor->ego->global, dedups objects seen by multiple cameras
        (by ``ann_token`` when the converter recorded it, else by
        same-class nearest-neighbor distance < 0.5 m), and returns
        ``(gt_frames, ego_centers)`` for ``nuscenes_eval``.

        Deviation vs the devkit GT (documented): objects visible in NO
        camera (fully occluded / outside all frusta) are absent; the
        devkit draws GT from the lidar sample annotations directly.
        """
        gt_frames: Dict[str, List[Dict]] = {}
        ego_centers: Dict[str, List[float]] = {}
        seen_tokens: Dict[str, set] = {}
        # NN-dedup fallback when ann_token is absent (pre-ann_token
        # pickles): same-class objects within 0.5 m of an already-seen
        # global center are duplicates (cross-camera calibration noise is
        # centimeter-scale; distinct nuScenes objects are never that close)
        seen_centers: Dict[str, Dict[str, List[np.ndarray]]] = {}
        for info in self.data_infos:
            token = info['sample_token']
            s2e_q = np.asarray(info['sensor2ego_rotation'], np.float64)
            s2e_t = np.asarray(info['sensor2ego_translation'], np.float64)
            e2g_q = np.asarray(info['ego2global_rotation'], np.float64)
            e2g_t = np.asarray(info['ego2global_translation'], np.float64)
            s2e_m, e2g_m = quat_to_mat(s2e_q), quat_to_mat(e2g_q)
            gt_frames.setdefault(token, [])
            ego_centers.setdefault(token, [float(e2g_t[0]),
                                           float(e2g_t[1])])
            seen_tokens.setdefault(token, set())
            seen_centers.setdefault(token, {})
            for ann in info.get('annotations', []):
                name = ann['category']
                if name not in CLASSES:
                    continue
                center = np.asarray(ann['translation'], np.float64)
                quat = np.asarray(ann['rotation'], np.float64)
                # velocity: converter camera-frame (vx, vz) -> global
                # (inverse of reference nuscenes_converter.py:364-370)
                velo_c = np.asarray(ann.get('velocity', (np.nan, np.nan)),
                                    np.float64)
                velo_g = e2g_m @ (s2e_m
                                  @ np.array([velo_c[0], 0.0, velo_c[1]]))
                # camera -> ego -> global
                center = s2e_m @ center + s2e_t
                quat = quat_multiply(s2e_q, quat)
                center = e2g_m @ center + e2g_t
                quat = quat_multiply(e2g_q, quat)
                ann_token = ann.get('ann_token')
                if ann_token:
                    if ann_token in seen_tokens[token]:
                        continue
                    seen_tokens[token].add(ann_token)
                else:
                    peers = seen_centers[token].setdefault(name, [])
                    if any(np.hypot(c[0] - center[0], c[1] - center[1])
                           < 0.5 for c in peers):
                        continue
                    peers.append(center)
                gt_frames[token].append(dict(
                    translation=[float(v) for v in center],
                    size=[float(v) for v in ann['size']],
                    rotation=[float(v) for v in quat],
                    velocity=[float(v) for v in velo_g[:2]],
                    detection_name=name,
                    attribute_name=ann.get('attribute', ''),
                    num_pts=int(ann.get('num_pts', 1))))
        return gt_frames, ego_centers

    def build_bikerack_frames(self) -> Optional[Dict[str, List[Dict]]]:
        """Global-frame bike-rack boxes per sample for the devkit's
        bicycle/motorcycle-in-rack eval filter, when the converter
        recorded them (``bike_racks`` info key); None otherwise."""
        if not any('bike_racks' in info for info in self.data_infos):
            return None
        racks: Dict[str, List[Dict]] = {}
        for info in self.data_infos:
            token = info['sample_token']
            if token not in racks:
                racks[token] = list(info.get('bike_racks', []))
        return racks

    def evaluate(self, results: List[Dict], out_dir: str,
                 eval_version: str = 'detection_cvpr_2019'):
        """Fusion + submission + NDS/mAP.

        Uses the official devkit when installed (reference behavior,
        nuscenes3d_dataset.py:240-280); otherwise falls back to the
        self-contained ``nuscenes_eval`` implementation of the same
        detection_cvpr_2019 protocol.
        """
        assert len(results) % NUM_CAMS == 0
        frames = []
        for f_start in range(0, len(results), NUM_CAMS):
            cam_results = []
            for i in range(f_start, f_start + NUM_CAMS):
                r = dict(results[i])
                info = self.data_infos[i]
                r.update(info.get('calib', {}))
                # converter pickles keep calibration at the top level
                for k in ('sensor2ego_rotation', 'sensor2ego_translation',
                          'ego2global_rotation', 'ego2global_translation'):
                    if k in info:
                        r.setdefault(k, info[k])
                r.setdefault('sample_token', info.get('sample_token'))
                cam_results.append(r)
            frames.append(dict(
                boxes=multicam_fusion(cam_results, self.nms_thr),
                sample_token=cam_results[0]['sample_token']))
        res_path = format_submission(
            frames, os.path.join(out_dir, 'results_nusc.json'))
        try:
            from nuscenes import NuScenes  # noqa: F401
        except ImportError:
            return self._self_contained_eval(res_path)
        return self._official_eval(res_path, out_dir, eval_version)

    def _self_contained_eval(self, res_path: str) -> Dict:
        """Devkit-free NDS/mAP on the written submission JSON."""
        from .nuscenes_eval import evaluate_detection
        with open(res_path) as f:
            pred_frames = json.load(f)['results']
        gt_frames, ego_centers = self.build_global_gt()
        metrics = evaluate_detection(pred_frames, gt_frames,
                                     classes=CLASSES,
                                     ego_centers=ego_centers,
                                     bikerack_frames=self.build_bikerack_frames())
        metrics['result_path'] = res_path
        metrics['note'] = ('self-contained detection_cvpr_2019 metrics '
                           '(nuscenes devkit unavailable)')
        return metrics

    def _official_eval(self, res_path, out_dir, eval_version):
        from nuscenes import NuScenes
        from nuscenes.eval.detection.config import config_factory
        from nuscenes.eval.detection.evaluate import NuScenesEval
        nusc = NuScenes(version=self.data_infos[0].get('version',
                                                       'v1.0-trainval'),
                        dataroot=self.img_prefix, verbose=False)
        nusc_eval = NuScenesEval(
            nusc, config=config_factory(eval_version),
            result_path=res_path,
            eval_set=self.data_infos[0].get('eval_set', 'val'),
            output_dir=out_dir, verbose=False)
        nusc_eval.main(render_curves=False)
        with open(os.path.join(out_dir, 'metrics_summary.json')) as f:
            return json.load(f)
