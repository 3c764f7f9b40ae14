"""Host-side inference pipeline of the Det suite (numpy only), the
``training=False`` stages of ``epropnp_tpu/det/pipelines.py``: image
loading with the dense original-coordinate map ``img_dense_x2d``, the
fixed sky-band crop, normalisation and padding to a stride multiple. The
training stages (resize, flip, random crops, collation) come with Det
training. Coordinate VALUES are never changed: the dense x2d map keeps the
original pixel coordinates, and the head corrects geometry through it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)

# the released configs' sky-band crop: 1600x900 -> 1600x672
# (configs/epropnp_det_basic.py:173,190)
REFERENCE_CROP_BOX = (0, 228, 1600, 900)


def gen_img_dense_x2d(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 2) original pixel coordinates + all-ones mask."""
    x2d = np.empty((h, w, 2), np.float32)
    x2d[..., 0] = np.arange(w, dtype=np.float32)
    x2d[..., 1] = np.arange(h, dtype=np.float32)[:, None]
    return x2d, np.ones((h, w, 1), np.float32)


def load_image_3d(sample: Dict) -> Dict:
    """Populate img_shape / ori_shape / flip / the dense x2d map."""
    h, w = sample['img'].shape[:2]
    x2d, mask = gen_img_dense_x2d(h, w)
    sample.update(img_shape=(h, w), ori_shape=(h, w), flip=False,
                  img_dense_x2d=x2d, img_dense_x2d_mask=mask)
    return sample


def crop_3d(sample: Dict, crop_box) -> Dict:
    """Fixed-window crop of the image and the dense fields (an inference
    sample carries no ground truth)."""
    x1, y1, x2, y2 = (int(v) for v in crop_box)
    sample['img'] = sample['img'][y1:y2, x1:x2]
    sample['img_shape'] = sample['img'].shape[:2]
    for key in ('img_dense_x2d', 'img_dense_x2d_mask'):
        sample[key] = sample[key][y1:y2, x1:x2]
    return sample


def normalize_img(sample: Dict, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> Dict:
    img = np.subtract(sample['img'], mean, dtype=np.float32)
    sample['img'] = np.divide(img, std, out=img)
    return sample


def pad_3d(sample: Dict, size_divisor: int = 32) -> Dict:
    """Zero-pad image + dense fields to a stride multiple; mask the pad."""
    h, w = sample['img_shape']
    ph = int(np.ceil(h / size_divisor)) * size_divisor
    pw = int(np.ceil(w / size_divisor)) * size_divisor
    sample['pad_shape'] = (ph, pw)
    if (ph, pw) == (h, w):  # nothing to pad
        return sample
    for k in ('img', 'img_dense_x2d', 'img_dense_x2d_mask'):
        a = sample[k]
        out = np.zeros((ph, pw) + a.shape[2:], a.dtype)
        out[:h, :w] = a
        sample[k] = out
    return sample


def default_pipeline(sample: Dict,
                     crop_box: Optional[Tuple[int, ...]] = None,
                     size_divisor: int = 32) -> Dict:
    """The reference's test stage order: load -> [crop] -> normalize ->
    pad (``epropnp_tpu/det/pipelines.py::default_pipeline`` with
    ``training=False`` and ``scale=1``)."""
    sample = load_image_3d(sample)
    if crop_box is not None:
        sample = crop_3d(sample, crop_box)
    return pad_3d(normalize_img(sample), size_divisor)
