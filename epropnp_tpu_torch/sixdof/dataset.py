"""LineMOD data pipeline (host-side numpy) for the 6DoF suite, a copy
of ``epropnp_tpu/sixdof/dataset.py`` whose ``collate`` builds torch
tensors on a given device.

Produces ``train.Batch`` records: normalized RGB crops, GT coordinate
maps, loss masks, local-translation targets, poses and crop parameters.
Preprocessing (dynamic-zoom-in cropping, background substitution,
coordinate denoising) stays on the host as in the reference
(EPro-PnP-6DoF/lib/datasets/lm.py:154-346). The OpenCV calls of the JAX
pipeline are ``utils.image_ops``' (the same pixels, bit for bit); cv2 is
imported only to decode a background image that is neither a PNG nor a
``.npy`` array (PASCAL VOC's JPEGs).

Layout expected under ``root``:
  ``real_train/<cls>/{rgb/*.png, mask/*.png, coord/*.pkl|npy, pose/*.txt,
  box/*.txt}`` (and ``real_test`` / ``imgn`` alike). Per-class annotation
  lists are cached as .npy like the reference (lm.py:34-100).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.image_ops import (canny, median_blur3, read_png,
                               resize_linear, resize_nearest, rgb_to_gray)
from . import ref_constants as ref
from .config import SixDoFConfig


# ------------------------------------------------------------- transforms

def zoom_in(im: np.ndarray, c, s, res: int, channel: int = 3,
            interpolate=resize_linear):
    """Crop a square of size ``s`` centered at ``c`` and resize to ``res``
    with ``interpolate`` (``image_ops.resize_linear`` or
    ``resize_nearest``).

    Integer-window semantics as the reference (lib/utils/img.py:164-207):
    window = [c - s/2 + 0.5, c + s/2) cast to ints, zero-padded outside the
    image. Returns (patch, c_h, c_w, s) with the int-cast center/size
    actually used.
    """
    c_w, c_h = int(c[0]), int(c[1])
    s, res = int(s), int(res)
    squeeze = False
    if channel == 1 and im.ndim == 2:
        im = im[..., None]
        squeeze = True
    h, w = im.shape[:2]
    u = int(c_h - 0.5 * s + 0.5)
    l = int(c_w - 0.5 * s + 0.5)
    b, r = u + s, l + s
    patch = np.zeros((s, s, im.shape[2]), dtype=im.dtype)
    if not (u >= h or l >= w or b <= 0 or r <= 0):
        su, sl = max(u, 0), max(l, 0)
        sb, sr = min(b, h), min(r, w)
        patch[su - u:sb - u, sl - l:sr - l] = im[su:sb, sl:sr]
    out = interpolate(patch, (res, res))
    if squeeze:
        out = out[..., 0]
    return out, c_h, c_w, s


def xywh_to_cs(xywh, s_ratio: float, s_max: Optional[float] = None):
    """Box -> (center, scale). Reference: lm.py:246-253."""
    x, y, w, h = xywh
    c = np.array([x + 0.5 * w, y + 0.5 * h])
    s = max(w, h) * s_ratio
    if s_max is not None:
        s = min(s, s_max)
    return c, s


def xywh_to_cs_dzi(xywh, s_ratio: float, s_max: Optional[float] = None,
                   shift_ratio: float = 0.25, scale_ratio: float = 0.25,
                   rng: Optional[np.random.Generator] = None):
    """Dynamic-zoom-in augmented box -> (center, scale).

    Uniform shift of the center by +-shift_ratio x (w, h) and scale jitter
    by +-scale_ratio. Reference: lm.py:229-244.
    """
    rng = rng or np.random.default_rng()
    x, y, w, h = xywh
    scale = 1.0 + scale_ratio * (2.0 * rng.random() - 1.0)
    shift = shift_ratio * (2.0 * rng.random(2) - 1.0)
    c = np.array([x + w * (0.5 + shift[1]), y + h * (0.5 + shift[0])])
    s = max(w, h) * s_ratio * scale
    if s_max is not None:
        s = min(s, s_max)
    return c, s


def denoise_coor(coor: np.ndarray) -> np.ndarray:
    """Median-blur coordinate maps along their edges. Reference: lm.py:255-262.

    The edges are found in the box of the map's nonzero pixels widened by 2
    (clipped to the image), the same edges as on the whole map: Canny's
    gradient there reads only pixels of the box or zeros, and every pixel
    beyond it has a zero gradient, as Canny takes the outside of the image
    to have. The median is taken at the edge pixels only (the rest of the
    blur is never read).
    """
    coor = np.asarray(coor, np.float32)
    out = coor.copy()
    h, w = coor.shape[:2]
    flat = coor.reshape(h, -1)
    ys = np.flatnonzero(flat.any(axis=1))
    if not ys.size:
        return out
    y0, y1 = max(ys[0] - 2, 0), min(ys[-1] + 3, h)
    xs = np.flatnonzero(flat[ys[0]:ys[-1] + 1].any(axis=0).reshape(w, -1)
                        .any(axis=1))
    x0, x1 = max(xs[0] - 2, 0), min(xs[-1] + 3, w)
    box = coor[y0:y1, x0:x1]
    gray = rgb_to_gray((np.abs(box) * 255).clip(0, 255).astype(np.uint8))
    ey, ex = np.nonzero(canny(gray, 20, 100))
    edges = (ey + y0, ex + x0)
    out[edges] = median_blur3(coor, edges)
    return out


def norm_coor(coor: np.ndarray, min_extents: Sequence[float]) -> np.ndarray:
    """Normalize object coordinates by per-class |min extents|.

    Reference: lm.py:264-272.
    """
    return coor / np.abs(np.asarray(min_extents))


def c_rel_delta(c_obj, c_box, wh_box):
    """Relative center offset. Reference: lm.py:277-283."""
    return (np.asarray(c_obj) - np.asarray(c_box)) / np.asarray(wh_box)


def d_scaled(depth: float, s_box: float, res: int) -> float:
    """Scale-invariant depth encoding. Reference: lm.py:285-291."""
    return depth * s_box / float(res)


def project_center(trans: np.ndarray, cam_k: np.ndarray):
    uvw = cam_k @ trans
    return uvw[:2] / uvw[2]


def change_bg(rgb: np.ndarray, msk: np.ndarray,
              bg_img: np.ndarray) -> np.ndarray:
    """Substitute the background with ``bg_img``. Reference: lm.py:154-189.

    The background is cropped to the frame's aspect ratio before the
    resize (reference ``load_bg_im``), so it is never anisotropically
    stretched.
    """
    h, w = rgb.shape[:2]
    bg_h, bg_w = bg_img.shape[:2]
    if h / w <= bg_h / bg_w:
        crop_w, crop_h = bg_w, int(bg_w * h / w)
    else:
        crop_h, crop_w = bg_h, int(bg_h * w / h)
    bg = resize_linear(np.ascontiguousarray(bg_img[:crop_h, :crop_w]),
                       (w, h))
    msk3 = (msk > 0)[..., None]
    return np.where(msk3, rgb, bg)


# ------------------------------------------------------------------ sample

@dataclasses.dataclass
class Sample:
    obj: str
    obj_id: int
    inp: np.ndarray          # (res, res, 3) float32 in [0, 1]
    target_coor: np.ndarray  # (out, out, 3) normalized coords
    mask: np.ndarray         # (out, out)
    loss_msk: np.ndarray     # (out, out, 3)
    trans_local: np.ndarray  # (3,)
    pose: np.ndarray         # (3, 4)
    c_box: np.ndarray        # (2,)
    s_box: float
    box: np.ndarray          # (4,) xywh


def build_sample(cfg: SixDoFConfig, obj: str, rgb, coor, msk, pose, box,
                 min_extents, cam_k=None, split: str = 'train',
                 rng: Optional[np.random.Generator] = None,
                 bg_img: Optional[np.ndarray] = None,
                 denoise: bool = True) -> Sample:
    """Raw arrays -> one training/test sample (reference __getitem__)."""
    cam_k = ref.CAMERA_MATRIX if cam_k is None else cam_k
    rng = rng or np.random.default_rng()
    pad_ratio = 1.5
    s_max = max(ref.IM_W, ref.IM_H)

    if bg_img is not None:
        rgb = change_bg(rgb, msk, bg_img)

    if split == 'train':
        c, s = xywh_to_cs_dzi(box, pad_ratio, s_max=s_max, rng=rng)
    else:
        c, s = xywh_to_cs(box, pad_ratio, s_max=s_max)

    if denoise and coor is not None:
        coor = denoise_coor(coor)

    inp_res, out_res = cfg.dataiter.inp_res, cfg.dataiter.out_res
    rgb_crop, c_h, c_w, s_int = zoom_in(rgb, c, s, inp_res)
    inp = rgb_crop.astype(np.float32) / 255.0
    c_used = np.array([c_w, c_h], np.float32)

    if coor is not None:
        coor_crop, *_ = zoom_in(coor, c, s, out_res,
                                interpolate=resize_nearest)
        target_coor = norm_coor(coor_crop, min_extents).astype(np.float32)
    else:
        target_coor = np.zeros((out_res, out_res, 3), np.float32)
    if msk is not None:
        msk_crop, *_ = zoom_in((msk > 0).astype(np.float32), c, s, out_res,
                               channel=1)
    else:
        msk_crop = np.zeros((out_res, out_res), np.float32)
    loss_msk = np.repeat(msk_crop[..., None], 3, axis=-1)

    trans = pose[:, 3]
    c_obj = project_center(trans, cam_k)
    delta = c_rel_delta(c_obj, c_used, box[2:])
    d_local = d_scaled(trans[2], float(s_int), out_res)
    trans_local = np.append(delta, d_local).astype(np.float32)

    return Sample(obj=obj, obj_id=ref.OBJ2IDX[obj], inp=inp,
                  target_coor=target_coor, mask=msk_crop, loss_msk=loss_msk,
                  trans_local=trans_local, pose=pose.astype(np.float32),
                  c_box=c_used, s_box=float(s_int),
                  box=np.asarray(box, np.float32))


def collate(samples: List[Sample], min_extents: Dict[str, np.ndarray],
            device=None):
    """Stack samples into a ``train.Batch`` of float32 tensors on
    ``device`` (the CPU if None)."""
    from .train import Batch
    dims = np.stack([np.abs(min_extents[s.obj]) for s in samples])

    def t(arrays):
        return torch.as_tensor(np.stack(arrays), dtype=torch.float32
                               ).to(device)
    return Batch(
        inp=t([s.inp for s in samples]),
        target_coor=t([s.target_coor for s in samples]),
        loss_msk=t([s.loss_msk for s in samples]),
        trans_local=t([s.trans_local for s in samples]),
        pose=t([s.pose for s in samples]),
        c_box=t([s.c_box for s in samples]),
        s_box=t([np.float32(s.s_box) for s in samples]),
        dim=t(list(dims)),
    )


# ------------------------------------------------------------------ dataset

def read_background(path: str) -> np.ndarray:
    """A background image as (H, W, 3) RGB uint8: a PNG by
    ``image_ops.read_png``, a ``.npy`` array by numpy, any other format
    (PASCAL VOC's JPEGs) by cv2, which must then be importable."""
    if path.endswith('.npy'):
        return np.load(path)
    with open(path, 'rb') as f:
        is_png = f.read(8) == b'\x89PNG\r\n\x1a\n'
    if is_png:
        return read_png(path)
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f'background {path}: neither a PNG nor a .npy array, and cv2, '
            'which would decode it, is not installed') from e
    img = cv2.imread(path)
    if img is None:
        raise RuntimeError(f'background {path}: cv2 cannot read it')
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class LineMODDataset:
    """Directory-backed LineMOD dataset with per-class annotation caching.

    Reference behavior: lm.py:34-100 (caching), :289-346 (__getitem__).
    Any of rgb/mask/coord may be absent per frame; missing pieces yield
    zero tensors so the pipeline stays total.
    """

    def __init__(self, cfg: SixDoFConfig, root: str, split: str = 'train',
                 classes: Optional[Sequence[str]] = None,
                 model_info: Optional[Dict[str, Dict[str, float]]] = None,
                 bg_dir: Optional[str] = None, change_bg_ratio: float = 0.5,
                 seed: int = 0):
        self.cfg = cfg
        self.root = root
        self.split = split
        self.classes = list(classes or ref.LM_OBJECTS)
        self.model_info = model_info or {}
        self.bg_dir = bg_dir
        self.change_bg_ratio = change_bg_ratio
        self.rng = np.random.default_rng(seed)
        self.annot = self._index()
        self._bg_files = self._index_bg(bg_dir)

    @staticmethod
    def _index_bg(bg_dir):
        """Background image paths: VOC2012 layout or a flat directory.

        The reference substitutes backgrounds from PASCAL VOC using the
        ``diningtable_trainval.txt`` image list, keeping only stems
        labeled ``1`` (lm.py:154-161: ``VOC2012/ImageSets/Main/...`` ->
        ``VOC2012/JPEGImages/<stem>.jpg``). A plain directory of images
        works too.
        """
        if not bg_dir or not os.path.isdir(bg_dir):
            return []
        voc = os.path.join(bg_dir, 'VOC2012')
        lst = os.path.join(voc, 'ImageSets', 'Main',
                           'diningtable_trainval.txt')
        if os.path.isfile(lst):
            with open(lst) as f:
                stems = [ln.split()[0] for ln in f
                         if len(ln.split()) >= 2 and ln.split()[1] == '1']
            return [os.path.join(voc, 'JPEGImages', s + '.jpg')
                    for s in stems]
        return [os.path.join(bg_dir, fn)
                for fn in sorted(os.listdir(bg_dir))]

    def _split_dir(self):
        return os.path.join(
            self.root, 'real_train' if self.split == 'train' else 'real_test')

    def _index(self):
        annot = []
        base = self._split_dir()
        if not os.path.isdir(base):
            return annot
        for cls in self.classes:
            cls_dir = os.path.join(base, cls)
            rgb_dir = os.path.join(cls_dir, 'rgb')
            if not os.path.isdir(rgb_dir):
                continue
            for fn in sorted(os.listdir(rgb_dir)):
                stem = os.path.splitext(fn)[0]
                annot.append({'cls': cls, 'dir': cls_dir, 'stem': stem})
        return annot

    def __len__(self):
        return len(self.annot)

    def _load(self, rec):
        d, stem = rec['dir'], rec['stem']
        rgb = read_png(os.path.join(d, 'rgb', stem + '.png'))
        msk_path = os.path.join(d, 'mask', stem + '.png')
        msk = read_png(msk_path, gray=True) if os.path.isfile(msk_path) \
            else None
        coor = None
        for ext in ('.npy', '.pkl'):
            p = os.path.join(d, 'coord', stem + ext)
            if os.path.isfile(p):
                coor = (np.load(p) if ext == '.npy'
                        else np.load(p, allow_pickle=True))
                break
        pose = np.loadtxt(os.path.join(d, 'pose', stem + '.txt')).reshape(3, 4)
        box = np.loadtxt(os.path.join(d, 'box', stem + '.txt')).reshape(4)
        return rgb, coor, msk, pose, box

    def min_extents(self, cls):
        info = self.model_info.get(cls)
        if info is None:
            return np.ones(3, np.float32)
        return np.array([abs(info['min_x']), abs(info['min_y']),
                         abs(info['min_z'])], np.float32)

    def draw(self, idx):
        """The random draws of sample ``idx``, taken from ``self.rng`` in
        the order :meth:`__getitem__` takes them, without reading a frame:
        ``(background path or None, the generator's state for the crop's
        draws)``. :meth:`make` builds the sample from them."""
        rec = self.annot[idx]
        bg = None
        if (self.split == 'train' and self._bg_files
                and os.path.isfile(os.path.join(rec['dir'], 'mask',
                                                rec['stem'] + '.png'))
                and self.rng.random() < self.change_bg_ratio):
            bg = self._bg_files[self.rng.integers(len(self._bg_files))]
        state = self.rng.bit_generator.state
        if self.split == 'train':  # advance past the DZI's draws
            xywh_to_cs_dzi(np.ones(4), 1.0, rng=self.rng)
        return bg, state

    def make(self, idx, draws) -> Sample:
        """Sample ``idx`` from the frame on disk and its :meth:`draw`."""
        bg, state = draws
        rec = self.annot[idx]
        rgb, coor, msk, pose, box = self._load(rec)
        rng = np.random.Generator(type(self.rng.bit_generator)())
        rng.bit_generator.state = state
        return build_sample(
            self.cfg, rec['cls'], rgb, coor, msk, pose, box,
            self.min_extents(rec['cls']), split=self.split, rng=rng,
            bg_img=None if bg is None else read_background(bg),
            denoise=coor is not None)

    def __getitem__(self, idx) -> Sample:
        return self.make(idx, self.draw(idx))

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                rows: slice = slice(None)):
        """Yield ``Batch`` records of CPU tensors (drops the ragged tail).

        ``rows`` cuts each global batch to a data-parallel rank's block:
        the draws of the whole batch are taken in order (cheap), and only
        the rank's frames are read and built, so its batch is its rows of
        the global batch bit for bit."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        extents = {c: self.min_extents(c) for c in self.classes}
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            draws = [self.draw(j) for j in idx]
            samples = [self.make(j, d) for j, d in
                       zip(idx[rows], draws[rows])]
            yield collate(samples, extents)
