"""Native rotated IoU and NMS on the host (C++ through ctypes), the
counterpart of ``epropnp_tpu/ops/iou3d``.

These serve the host-side evaluation (KITTI AP) and the nuScenes
multi-camera fusion NMS, where numpy arrays, not device tensors, are in
play. The library is compiled from the package's own ``src/iou3d.cpp``
with ``g++`` at first use, into ``build/`` beside the package; the file
name carries a hash of the source and the flags, so an edited source is
rebuilt. A missing compiler or a failed build raises: there is no
fallback. The torch functions of ``core.bbox_3d`` compute the same
quantities and are this library's plain references in the tests.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ...kernels import BUILD_DIR, build_host_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'src',
                    'iou3d.cpp')
_CRITERIA = {'iou': 0, 'iof1': 1, 'inter': 2}
_FP = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with typed entries."""
    lib = ctypes.CDLL(build_host_library(_SRC, BUILD_DIR))
    lib.rotated_iou_matrix.argtypes = [_FP, ctypes.c_int, _FP, ctypes.c_int,
                                       ctypes.c_int, _FP]
    lib.nms_rotated.argtypes = [_FP, _FP, ctypes.c_int, ctypes.c_float,
                                ctypes.POINTER(ctypes.c_uint8)]
    lib.boxes_iou_3d.argtypes = [_FP, ctypes.c_int, _FP, ctypes.c_int, _FP]
    for fn in (lib.rotated_iou_matrix, lib.nms_rotated, lib.boxes_iou_3d):
        fn.restype = None
    return lib


def _f32(a, width: int) -> np.ndarray:
    """A contiguous float32 (n, width) copy or view of ``a``; another
    shape raises before any pointer reaches the library."""
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f'expected an (n, {width}) array, got {a.shape}')
    return a


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def rotated_iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray,
                       criterion: str = 'iou') -> np.ndarray:
    """All-pairs rotated IoU of (n, 5) x (m, 5) boxes [cx, cy, w, h, ang]
    -> (n, m) float32; ``criterion`` 'iou' (union), 'iof1' (area of
    boxes1) or 'inter' (the intersection area)."""
    lib = load_library()
    boxes1, boxes2 = _f32(boxes1, 5), _f32(boxes2, 5)
    out = np.empty((len(boxes1), len(boxes2)), np.float32)
    lib.rotated_iou_matrix(_fptr(boxes1), len(boxes1), _fptr(boxes2),
                           len(boxes2), _CRITERIA[criterion], _fptr(out))
    return out


def nms_rotated(boxes: np.ndarray, scores: np.ndarray,
                thresh: float) -> np.ndarray:
    """Greedy rotated NMS -> (n,) bool keep mask in the input order."""
    lib = load_library()
    boxes = _f32(boxes, 5)
    scores = np.ascontiguousarray(scores, np.float32)
    if scores.shape != (len(boxes),):
        raise ValueError(f'{len(boxes)} boxes but scores of shape '
                         f'{scores.shape}')
    keep = np.empty((len(boxes),), np.uint8)
    lib.nms_rotated(_fptr(boxes), _fptr(scores), len(boxes),
                    ctypes.c_float(thresh),
                    keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.astype(bool)


def boxes_iou_3d(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """All-pairs 3D IoU of camera-frame boxes [l, h, w, x, y, z, ry]:
    the BEV (x-z) overlap times the vertical (y) overlap."""
    lib = load_library()
    boxes1, boxes2 = _f32(boxes1, 7), _f32(boxes2, 7)
    out = np.empty((len(boxes1), len(boxes2)), np.float32)
    lib.boxes_iou_3d(_fptr(boxes1), len(boxes1), _fptr(boxes2),
                     len(boxes2), _fptr(out))
    return out
