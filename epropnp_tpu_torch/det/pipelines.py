"""Host-side data pipeline of the Det suite (numpy), counterpart of
``epropnp_tpu/det/pipelines.py``: image loading with the dense
original-coordinate map ``img_dense_x2d``, resize, horizontal flip, the
fixed and random crops with their ground truth, normalisation, padding to
a stride multiple, and collation into the port's ``det.train.DetBatch``.
Coordinate VALUES are never changed: the dense x2d map keeps the original
pixel coordinates, and the head corrects geometry through it and the flip
flag. The stages draw from a ``numpy.random.Generator`` in JAX's order, so
one seed gives JAX's samples.

cv2 is imported only where it is needed (``resize_3d`` and :func:`imread`
of an encoded image): the GPU machine has none, and its frames are
``.npy`` arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

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
    """Populate img_shape / ori_shape / flip / the dense x2d map. A sample
    without ``img`` but with ``img_shape`` is a frame left unread: the
    stages then make their draws and move the annotations only (a
    data-parallel rank's view of another rank's rows)."""
    if 'img' in sample:
        h, w = sample['img'].shape[:2]
        x2d, mask = gen_img_dense_x2d(h, w)
        sample.update(img_dense_x2d=x2d, img_dense_x2d_mask=mask)
    else:
        h, w = sample['img_shape']
    sample.update(img_shape=(h, w), ori_shape=(h, w), flip=False)
    return sample


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            'cv2 is not installed: decode the frames to .npy arrays (RGB, '
            'uint8) and read them with np.load, or install opencv') from e
    return cv2


def imread(path: str) -> np.ndarray:
    """An RGB frame (h, w, 3): a ``.npy`` array by ``np.load``, anything
    else decoded by cv2 (imported here; BGR turned to RGB as the JAX
    CLIs do). Without cv2 only ``.npy`` frames can be read."""
    if path.endswith('.npy'):
        return np.load(path)
    img = _cv2().imread(path)
    if img is None:
        raise FileNotFoundError(f'cannot read image {path}')
    return img[..., ::-1]


def resize_3d(sample: Dict, scale: float) -> Dict:
    """Resize the image and the dense fields (values untouched) by
    ``scale``, and the 2D boxes with them (cv2, bilinear)."""
    h, w = sample['img'].shape[:2] if 'img' in sample \
        else sample['img_shape']
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if 'img' in sample:
        cv2 = _cv2()
        sample['img'] = cv2.resize(sample['img'], (nw, nh),
                                   interpolation=cv2.INTER_LINEAR)
        sample['img_dense_x2d'] = cv2.resize(
            sample['img_dense_x2d'], (nw, nh),
            interpolation=cv2.INTER_LINEAR)
        sample['img_dense_x2d_mask'] = cv2.resize(
            sample['img_dense_x2d_mask'], (nw, nh),
            interpolation=cv2.INTER_LINEAR)[..., None]
    sample['img_shape'] = (nh, nw)
    sample['scale_factor'] = scale
    if 'gt_bboxes' in sample and len(sample['gt_bboxes']):
        sample['gt_bboxes'] = sample['gt_bboxes'] * scale
    return sample


_DENSE_FIELDS = ('img_dense_x2d', 'img_dense_x2d_mask')


def random_flip_3d(sample: Dict, rng: np.random.Generator,
                   prob: float = 0.5) -> Dict:
    """Horizontal flip with probability ``prob`` (one draw): the pixels
    and 2D boxes move, the coordinate values stay; the head corrects the
    geometry through the flip flag."""
    if rng.random() >= prob:
        return sample
    for key in ('img',) + _DENSE_FIELDS:
        if key in sample:
            sample[key] = sample[key][:, ::-1].copy()
    sample['flip'] = True
    if 'gt_bboxes' in sample and len(sample['gt_bboxes']):
        w = sample['img_shape'][1]
        b = sample['gt_bboxes'].copy()
        b[:, [0, 2]] = w - sample['gt_bboxes'][:, [2, 0]]
        sample['gt_bboxes'] = b
    return sample


# per-object fields aligned with the gt_bboxes rows, filtered together on
# every crop
_ALIGNED_GT_FIELDS = ('gt_labels', 'gt_bboxes_3d', 'gt_velo', 'gt_attr',
                      'truncation', 'gt_x3d', 'gt_x2d')


def _filter_aligned(sample: Dict, valid: np.ndarray):
    for key in _ALIGNED_GT_FIELDS:
        if key in sample:
            v = sample[key]
            if isinstance(v, list):
                sample[key] = [v[i] for i in np.flatnonzero(valid)]
            elif len(v):
                sample[key] = v[valid]


def crop_3d(sample: Dict, crop_box, trunc_ignore_thres: float = -1.0,
            allow_negative_crop: bool = False) -> Optional[Dict]:
    """Fixed-window crop of the image, the dense fields and the 2D boxes
    (clipped to the window; a box left empty drops its object from every
    aligned field). With ``trunc_ignore_thres`` > 0, an object whose
    visible area falls below ``1 - thres`` of its un-truncated area (the
    stored ``truncation`` un-discounts the pre-crop area) moves to
    ``gt_bboxes_ignore``. Returns None when no object is left and
    ``allow_negative_crop`` is False (the reference skips such samples).
    The released configs crop the sky band, ``REFERENCE_CROP_BOX``, in
    training and test."""
    x1, y1, x2, y2 = (int(v) for v in crop_box)
    h0, w0 = sample['img'].shape[:2] if 'img' in sample \
        else sample['img_shape']
    h, w = len(range(h0)[y1:y2]), len(range(w0)[x1:x2])
    sample['img_shape'] = (h, w)
    for key in ('img',) + _DENSE_FIELDS:
        if key in sample:
            sample[key] = sample[key][y1:y2, x1:x2]

    offset = np.array([x1, y1, x1, y1], np.float32)
    if 'gt_bboxes_ignore' in sample and len(sample['gt_bboxes_ignore']):
        big = np.asarray(sample['gt_bboxes_ignore'], np.float32) - offset
        big[:, 0::2] = np.clip(big[:, 0::2], 0, w)
        big[:, 1::2] = np.clip(big[:, 1::2], 0, h)
        sample['gt_bboxes_ignore'] = big[
            (big[:, 2] > big[:, 0]) & (big[:, 3] > big[:, 1])]

    if 'gt_bboxes' not in sample:
        return sample
    bboxes_ori = np.asarray(sample['gt_bboxes'], np.float32) - offset
    if len(bboxes_ori) == 0:
        return sample if allow_negative_crop else None
    bboxes = bboxes_ori.copy()
    bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, w)
    bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, h)
    valid = (bboxes[:, 2] > bboxes[:, 0]) & (bboxes[:, 3] > bboxes[:, 1])
    if not valid.any() and not allow_negative_crop:
        return None
    if trunc_ignore_thres > 0:
        area_ori = np.prod(bboxes_ori[:, 2:] - bboxes_ori[:, :2], axis=1)
        if 'truncation' in sample and len(sample['truncation']):
            trunc = np.asarray(sample['truncation'], np.float32)
            area_ori = area_ori / np.clip(1.0 - trunc, 1e-4, None)
        area_new = np.prod(bboxes[:, 2:] - bboxes[:, :2], axis=1)
        ignore = valid & (area_new < (1.0 - trunc_ignore_thres) * area_ori)
        valid = valid & ~ignore
        if ignore.any():
            extra = bboxes[ignore]
            prev = sample.get('gt_bboxes_ignore')
            sample['gt_bboxes_ignore'] = (
                np.concatenate([np.asarray(prev, np.float32).reshape(-1, 4),
                                extra]) if prev is not None and len(prev)
                else extra)
    sample['gt_bboxes'] = bboxes[valid]
    _filter_aligned(sample, valid)
    return sample


def random_crop_3d(sample: Dict, rng: np.random.Generator,
                   crop_size: Tuple[int, int],
                   trunc_ignore_thres: float = -1.0,
                   allow_negative_crop: bool = False) -> Optional[Dict]:
    """Random fixed-size crop (the reference's RandomCrop3D): a uniform
    offset within the margins (y drawn first, then x), then
    :func:`crop_3d`."""
    h, w = sample['img'].shape[:2]
    ch, cw = crop_size
    oy = int(rng.integers(0, max(h - ch, 0) + 1))
    ox = int(rng.integers(0, max(w - cw, 0) + 1))
    return crop_3d(sample, (ox, oy, ox + cw, oy + ch),
                   trunc_ignore_thres, allow_negative_crop)


def min_iou_random_crop_3d(sample: Dict, rng: np.random.Generator,
                           min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
                           min_crop_size: float = 0.3,
                           max_tries: int = 50) -> Dict:
    """Min-IoU random crop (the reference's MinIoURandomCrop3D): a random
    mode from (1, *min_ious), 1 meaning no crop; else patches are drawn
    until every object overlaps the patch by at least the mode's IoU; the
    objects whose centre lies in the patch are kept, clipped to it. As in
    the JAX package, every aligned field is filtered with the boxes (the
    reference leaves ``gt_bboxes_3d``, velocity and attributes
    unfiltered; no released config uses this stage)."""
    if 'gt_bboxes' not in sample or len(sample['gt_bboxes']) == 0:
        return sample
    h, w = sample['img'].shape[:2]
    mode = rng.choice(np.array((1.0,) + tuple(min_ious)))
    if mode == 1.0:
        return sample
    boxes = np.asarray(sample['gt_bboxes'], np.float32)
    for _ in range(max_tries):
        nw = rng.uniform(min_crop_size * w, w)
        nh = rng.uniform(min_crop_size * h, h)
        if nh / nw < 0.5 or nh / nw > 2:
            continue
        left, top = rng.uniform(0, w - nw), rng.uniform(0, h - nh)
        patch = np.array([int(left), int(top),
                          int(left + nw), int(top + nh)])
        if patch[2] == patch[0] or patch[3] == patch[1]:
            continue
        ix1 = np.maximum(boxes[:, 0], patch[0])
        iy1 = np.maximum(boxes[:, 1], patch[1])
        ix2 = np.minimum(boxes[:, 2], patch[2])
        iy2 = np.minimum(boxes[:, 3], patch[3])
        inter = (np.clip(ix2 - ix1, 0, None)
                 * np.clip(iy2 - iy1, 0, None))
        union = (np.prod(boxes[:, 2:] - boxes[:, :2], axis=1)
                 + (patch[2] - patch[0]) * (patch[3] - patch[1]) - inter)
        if len(inter) and (inter / np.maximum(union, 1e-9)).min() < mode:
            continue
        centers = (boxes[:, :2] + boxes[:, 2:]) / 2
        center_in = ((centers[:, 0] > patch[0]) & (centers[:, 1] > patch[1])
                     & (centers[:, 0] < patch[2])
                     & (centers[:, 1] < patch[3]))
        if not center_in.any():
            continue
        kept = boxes[center_in].copy()
        kept[:, 2:] = np.minimum(kept[:, 2:], patch[2:])
        kept[:, :2] = np.maximum(kept[:, :2], patch[:2])
        kept -= np.tile(patch[:2], 2).astype(np.float32)
        sample['gt_bboxes'] = kept
        _filter_aligned(sample, center_in)
        if 'gt_bboxes_ignore' in sample and len(sample['gt_bboxes_ignore']):
            big = np.asarray(sample['gt_bboxes_ignore'], np.float32)
            bc = (big[:, :2] + big[:, 2:]) / 2
            bin_ = ((bc[:, 0] > patch[0]) & (bc[:, 1] > patch[1])
                    & (bc[:, 0] < patch[2]) & (bc[:, 1] < patch[3]))
            big = big[bin_].copy()
            big[:, 2:] = np.minimum(big[:, 2:], patch[2:])
            big[:, :2] = np.maximum(big[:, :2], patch[:2])
            sample['gt_bboxes_ignore'] = big - np.tile(
                patch[:2], 2).astype(np.float32)
        sample['img'] = sample['img'][patch[1]:patch[3],
                                      patch[0]:patch[2]]
        sample['img_shape'] = sample['img'].shape[:2]
        for key in _DENSE_FIELDS:
            if key in sample:
                sample[key] = sample[key][patch[1]:patch[3],
                                          patch[0]:patch[2]]
        return sample
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


def default_pipeline(sample: Dict, rng: Optional[np.random.Generator] = None,
                     scale: float = 1.0, flip_prob: float = 0.5,
                     size_divisor: int = 32, training: bool = True,
                     crop_box=None, trunc_ignore_thres: float = 0.8,
                     scale_jitter: Optional[Tuple[float, float]] = None,
                     ) -> Optional[Dict]:
    """The reference's stage order: load -> [resize] -> [flip] -> [crop]
    -> normalize -> pad, with JAX's signature and draws (the resize ratio
    from ``scale_jitter``, then the flip). Real-data callers pass
    ``crop_box=REFERENCE_CROP_BOX`` (the released configs crop training
    and test frames to 1600x672); it is scaled and rounded with the
    image. ``training=False`` is the inference pipeline: no jitter, no
    flip, no truncation relabel, and a crop that keeps a sample without
    objects. Returns None when a training crop leaves no object."""
    sample = load_image_3d(sample)
    rng = rng or np.random.default_rng()
    if scale_jitter is not None and training:
        scale = scale * float(rng.uniform(*scale_jitter))
    if scale != 1.0:
        sample = resize_3d(sample, scale)
    if training and flip_prob > 0:
        sample = random_flip_3d(sample, rng, flip_prob)
    if crop_box is not None:
        box = np.asarray(crop_box, np.float64)
        if scale != 1.0:
            box = box * scale
        sample = crop_3d(sample, box.round().astype(int),
                         trunc_ignore_thres if training else -1.0,
                         allow_negative_crop=not training)
        if sample is None:
            return None
    if 'img' not in sample:  # an unread frame: the draws are made
        return sample
    sample = normalize_img(sample)
    return pad_3d(sample, size_divisor)


def collate_det_batch(samples: List[Dict], max_gt: int, max_pts: int = 0,
                      device=None):
    """Stack pipeline outputs into a fixed-shape ``det.train.DetBatch`` of
    tensors on ``device`` (the CUDA card unless given): ``max_gt`` object
    slots an image (``gt_mask`` marks the filled ones; an empty slot has
    the attribute ``len(attributes) - 1`` and a NaN velocity) and, when
    ``max_pts`` > 0 and the samples carry object points, ``max_pts``
    points an object. The values are JAX's ``collate_det_batch``'s; labels
    and attributes are int64, flips and masks bool, the rest float32."""
    from .train import DetBatch
    device = torch.device('cuda' if device is None else device)
    n = len(samples)
    g2d = np.zeros((n, max_gt, 4), np.float32)
    g3d = np.zeros((n, max_gt, 7), np.float32)
    glab = np.zeros((n, max_gt), np.int64)
    gmask = np.zeros((n, max_gt), bool)
    gvelo = np.full((n, max_gt, 2), np.nan, np.float32)
    gattr = np.full((n, max_gt), len(
        samples[0].get('attributes', range(9))) - 1, np.int64)
    with_pts = max_pts > 0 and 'gt_x3d' in samples[0]
    if with_pts:
        x3dp = np.zeros((n, max_gt, max_pts, 3), np.float32)
        x2dp = np.zeros((n, max_gt, max_pts, 2), np.float32)
        pmask = np.zeros((n, max_gt, max_pts), bool)
    for i, s in enumerate(samples):
        k = min(len(s.get('gt_bboxes', [])), max_gt)
        if k:
            g2d[i, :k] = s['gt_bboxes'][:k]
            g3d[i, :k] = s['gt_bboxes_3d'][:k]
            glab[i, :k] = s['gt_labels'][:k]
            gmask[i, :k] = True
            if 'gt_velo' in s:
                gvelo[i, :k] = s['gt_velo'][:k]
            if 'gt_attr' in s:
                gattr[i, :k] = s['gt_attr'][:k]
            if with_pts:
                for g in range(k):
                    p = min(len(s['gt_x3d'][g]), max_pts)
                    if p:
                        x3dp[i, g, :p] = s['gt_x3d'][g][:p]
                        x2dp[i, g, :p] = s['gt_x2d'][g][:p]
                        pmask[i, g, :p] = True

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype)).to(device)
    stack = lambda key: np.stack([s[key] for s in samples])  # noqa: E731
    return DetBatch(
        img=t(stack('img'), np.float32),
        cam_intrinsic=t(stack('cam_intrinsic'), np.float32),
        img_shapes=t([s['img_shape'] for s in samples], np.float32),
        ori_shapes=t([s['ori_shape'] for s in samples], np.float32),
        img_flips=t([s['flip'] for s in samples], bool),
        img_dense_x2d=t(stack('img_dense_x2d')),
        img_dense_x2d_mask=t(stack('img_dense_x2d_mask')),
        gt_bboxes=t(g2d), gt_bboxes_3d=t(g3d), gt_labels=t(glab),
        gt_mask=t(gmask), gt_velo=t(gvelo), gt_attr=t(gattr),
        gt_x3d=t(x3dp) if with_pts else None,
        gt_x2d=t(x2dp) if with_pts else None,
        gt_pts_mask=t(pmask) if with_pts else None)
