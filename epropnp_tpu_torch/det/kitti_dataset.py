"""KITTI 3D dataset (label-file-backed) + car-only variant.

Counterpart of the reference's (config-unused) KITTI datasets
(EPro-PnP-Det/epropnp_det/datasets/kitti3d_dataset.py, kitti3dcar_dataset.py):
parses the standard KITTI label/calib text format and evaluates with the
numpy AP suite (``det.kitti_eval``).

The PyTorch port keeps this copy of ``epropnp_tpu/det/kitti_dataset.py``
(the same code; it imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .kitti_eval import kitti_eval

KITTI_CLASSES = ('Car', 'Pedestrian', 'Cyclist')


def parse_label_file(path: str, with_score: bool = False) -> Dict:
    """KITTI label txt -> annotation dict (see kitti_eval format)."""
    names, trunc, occ, bbox, dims, loc, ry, score = ([] for _ in range(8))
    alpha = []
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                v = line.split()
                if not v:
                    continue
                names.append(v[0])
                trunc.append(float(v[1]))
                occ.append(float(v[2]))
                alpha.append(float(v[3]))
                bbox.append([float(x) for x in v[4:8]])
                # label order h, w, l -> store (l, h, w)
                h, w, l = (float(x) for x in v[8:11])
                dims.append([l, h, w])
                loc.append([float(x) for x in v[11:14]])
                ry.append(float(v[14]))
                if with_score:
                    score.append(float(v[15]) if len(v) > 15 else 1.0)
    out = dict(
        name=np.asarray(names),
        truncated=np.asarray(trunc, np.float32),
        occluded=np.asarray(occ, np.float32),
        alpha=np.asarray(alpha, np.float32),
        bbox=np.asarray(bbox, np.float32).reshape(-1, 4),
        dimensions=np.asarray(dims, np.float32).reshape(-1, 3),
        location=np.asarray(loc, np.float32).reshape(-1, 3),
        rotation_y=np.asarray(ry, np.float32),
    )
    if with_score:
        out['score'] = np.asarray(score, np.float32)
    return out


def parse_calib_file(path: str) -> np.ndarray:
    """Return the P2 camera intrinsics (3, 3) from a KITTI calib file."""
    with open(path) as f:
        for line in f:
            if line.startswith('P2:'):
                p2 = np.asarray([float(v) for v in line.split()[1:]],
                                np.float64).reshape(3, 4)
                return p2[:, :3]
    raise ValueError(f'no P2 entry in {path}')


class KITTI3DDataset:
    """Directory-backed KITTI dataset (label_2/calib/image_2 layout)."""

    CLASSES: Sequence[str] = KITTI_CLASSES

    def __init__(self, root: str, split_file: Optional[str] = None):
        self.root = root
        label_dir = os.path.join(root, 'label_2')
        if split_file:
            with open(split_file) as f:
                self.ids = [ln.strip() for ln in f if ln.strip()]
        elif os.path.isdir(label_dir):
            self.ids = sorted(os.path.splitext(f)[0]
                              for f in os.listdir(label_dir))
        else:
            self.ids = []

    def __len__(self):
        return len(self.ids)

    def get_ann(self, idx: int) -> Dict:
        return parse_label_file(
            os.path.join(self.root, 'label_2', self.ids[idx] + '.txt'))

    def get_calib(self, idx: int) -> np.ndarray:
        return parse_calib_file(
            os.path.join(self.root, 'calib', self.ids[idx] + '.txt'))

    def image_path(self, idx: int) -> str:
        return os.path.join(self.root, 'image_2', self.ids[idx] + '.png')

    def evaluate(self, dt_annos: List[Dict],
                 classes: Sequence[str] = None,
                 coco_style: bool = False) -> Dict:
        gt_annos = [self.get_ann(i) for i in range(len(self))]
        out = kitti_eval(gt_annos, dt_annos,
                         classes=classes or self.CLASSES)
        if coco_style:
            from .kitti_eval import kitti_eval_coco_style
            out.update(kitti_eval_coco_style(
                gt_annos, dt_annos, classes=classes or self.CLASSES))
        return out


class KITTI3DCarDataset(KITTI3DDataset):
    """Car-only variant (reference kitti3dcar_dataset.py)."""

    CLASSES = ('Car',)
