"""The image operations of the 6DoF data path, in numpy, and a PNG codec in
pure Python with ``zlib``: the port's own counterparts of the OpenCV calls
that ``epropnp_tpu/sixdof/{dataset,synthetic}.py`` make, so the port reads,
crops, denoises and writes LineMOD-format frames without OpenCV.

Each function gives OpenCV's result bit for bit (``box_blur3`` within
f32 rounding), on the inputs the data path gives it:

- ``resize_linear``: ``cv2.resize(..., INTER_LINEAR)`` on uint8 (OpenCV's
  11-bit fixed-point coefficients and the rounding of its vector path)
  and float32 (its fused multiply-adds; on 3-channel images cv2 rounds
  the edge columns of a large upscale otherwise, by 1 ulp: the data path
  resizes 1-channel float32 masks only);
- ``resize_nearest``: ``INTER_NEAREST``;
- ``median_blur3``: ``cv2.medianBlur(float32, 3)``;
- ``rgb_to_gray``: ``cv2.cvtColor(uint8, COLOR_RGB2GRAY)``;
- ``morph_close3``: ``cv2.morphologyEx(uint8, MORPH_CLOSE, ones(3, 3))``;
- ``box_blur3``: ``cv2.blur(float32, (3, 3))``;
- ``canny``: ``cv2.Canny(gray, low, high)`` (aperture 3, L1 gradient);
- ``read_png`` / ``write_png``: ``cv2.imread`` (colour as RGB, or
  ``IMREAD_GRAYSCALE``) and ``cv2.imwrite`` of 8-bit PNGs. The row
  filters, whose Average and Paeth types run byte by byte, are C++
  (``src/png_filter.cpp``, built with ``g++`` at first use by
  ``kernels.build_host_library``; no fallback); ``zlib`` inflates and
  deflates.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

from ..kernels import build_host_library

# OpenCV's fixed point for INTER_LINEAR on 8-bit images
# (INTER_RESIZE_COEF_BITS = 11)
_COEF_ONE = 2048
# cv2's RGB -> gray weights in 15-bit fixed point (0.299, 0.587, 0.114)
_GRAY_R, _GRAY_G, _GRAY_B, _GRAY_SHIFT = 9798, 19235, 3735, 15
# libpng's RGB -> gray weights (0.299, 0.587 in 1e-5 fixed point, scaled
# to 2**15 and truncated; blue takes the rest), which cv2's PNG decoder
# applies for IMREAD_GRAYSCALE, with no rounding term
_PNG_GRAY_R, _PNG_GRAY_G = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_PNG_GRAY_B = 32768 - _PNG_GRAY_R - _PNG_GRAY_G
# Canny's tan(22.5 deg) in 15-bit fixed point
_CANNY_SHIFT = 15
_TG22 = int(0.4142135623730950488016887242097 * (1 << _CANNY_SHIFT) + 0.5)


# ----------------------------------------------------------------- resize

def _linear_taps(dst: int, src: int, frac_in_f32: bool
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Source indices (clamped) and the f32 fraction of each output pixel
    along one axis: ``fx = (x + 0.5) * src / dst - 0.5``, ``sx =
    floor(fx)``, ``fx -= sx``; the fraction is not clamped at the edges,
    only the indices are. OpenCV's 8-bit path rounds ``fx`` to f32 before
    the floor, its float path only the fraction."""
    fx = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    if frac_in_f32:
        fx = fx.astype(np.float32)
    sx = np.floor(fx)
    fx = (fx - sx).astype(np.float32)
    sx = sx.astype(np.int64)
    return (np.clip(sx, 0, src - 1), np.clip(sx + 1, 0, src - 1), fx)


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_LINEAR)`` for an (H, W)
    or (H, W, C) uint8 or float32 image; ``size`` is (width, height) as
    cv2 takes it."""
    w, h = size
    u8 = img.dtype == np.uint8
    x0, x1, fx = _linear_taps(w, img.shape[1], u8)
    y0, y1, fy = _linear_taps(h, img.shape[0], u8)
    if u8:
        ax0 = np.rint((np.float32(1) - fx) * np.float32(_COEF_ONE)
                      ).astype(np.int32)
        ay0 = np.rint((np.float32(1) - fy) * np.float32(_COEF_ONE)
                      ).astype(np.int32)
        ax1, ay1 = _COEF_ONE - ax0, _COEF_ONE - ay0
        s = img.astype(np.int32)
        ex = (slice(None),) + (None,) * (img.ndim - 2)
        rows = s[:, x0] * ax0[ex] + s[:, x1] * ax1[ex]        # (H, w, C)
        ey = (slice(None),) + (None,) * (img.ndim - 1)
        # OpenCV's vector path: each term pre-shifted by 4, then by 16
        out = (((ay0[ey] * (rows[y0] >> 4)) >> 16)
               + ((ay1[ey] * (rows[y1] >> 4)) >> 16) + 2) >> 2
        return out.astype(np.uint8)
    if img.dtype != np.float32:
        raise TypeError(f'resize_linear: uint8 or float32, not {img.dtype}')
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    ey = (slice(None),) + (None,) * (img.ndim - 1)
    # OpenCV's float path: a + (b - a) * f, with one rounding (an FMA)
    rows = _fma32(img[:, x1] - img[:, x0], fx[ex], img[:, x0])
    return _fma32(rows[y1] - rows[y0], fy[ey], rows[y0])


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` of float32 arrays rounded once to float32, as a fused
    multiply-add rounds it. The product is exact in float64; the sum's
    float64 rounding error ``e`` (TwoSum) decides the float32 rounding
    where the float64 sum lies halfway between two float32 values."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = np.broadcast_to(c, p.shape).astype(np.float64)
    s = p + c
    t = s - p
    e = (p - (s - t)) + (c - t)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > r64, np.inf, -np.inf)
                         .astype(np.float32))
    tie = (s != r64) & (2 * s == r64 + other.astype(np.float64)) & (e != 0)
    # at a tie the exact value lies beyond the midpoint on e's side
    up = np.maximum(r, other)
    down = np.minimum(r, other)
    return np.where(tie, np.where(e > 0, up, down), r)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_NEAREST)``: output pixel
    ``i`` takes source pixel ``floor(i * src / dst)`` (no half-pixel
    offset)."""
    w, h = size

    def idx(dst, src):
        return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))
                                   ).astype(np.int64), src - 1)
    return img[idx(h, img.shape[0])][:, idx(w, img.shape[1])]


# ---------------------------------------------------------------- filters

def median_blur3(img: np.ndarray,
                 at: Optional[Tuple[np.ndarray, np.ndarray]] = None
                 ) -> np.ndarray:
    """``cv2.medianBlur(img, 3)`` on float32: the median of each pixel's
    3 x 3 neighbourhood, edges replicated. With ``at = (rows, cols)`` only
    those pixels' medians, in that order."""
    h, w = img.shape[:2]
    ys, xs = np.indices((h, w)) if at is None else at
    taps = [img[np.clip(ys + dy, 0, h - 1), np.clip(xs + dx, 0, w - 1)]
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return np.sort(np.stack(taps), axis=0)[4]


def box_blur3(img: np.ndarray) -> np.ndarray:
    """``cv2.blur(img, (3, 3))`` on float32: the mean of each pixel's 3 x 3
    neighbourhood, borders reflected without repeating the edge
    (``BORDER_REFLECT_101``)."""
    pad = ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2)
    p = np.pad(img.astype(np.float32), pad, mode='reflect')
    h, w = img.shape[:2]
    rows = p[:, 0:w] + p[:, 1:w + 1] + p[:, 2:w + 2]
    return ((rows[0:h] + rows[1:h + 1] + rows[2:h + 2])
            * np.float32(1.0 / 9.0)).astype(np.float32)


def morph_close3(mask: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(mask, MORPH_CLOSE, np.ones((3, 3), np.uint8))`` on
    uint8: a 3 x 3 dilation, then a 3 x 3 erosion; outside the image the
    dilation sees 0 and the erosion 255, so the border changes nothing."""
    dil = np.pad(mask, 1, constant_values=0)
    h, w = mask.shape
    dil = np.max([dil[dy:dy + h, dx:dx + w]
                  for dy in range(3) for dx in range(3)], axis=0)
    ero = np.pad(dil, 1, constant_values=255)
    return np.min([ero[dy:dy + h, dx:dx + w]
                   for dy in range(3) for dx in range(3)], axis=0)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, COLOR_RGB2GRAY)`` on uint8:
    ``(9798 R + 19235 G + 3735 B + 2**14) >> 15``."""
    c = rgb.astype(np.int32)
    return ((_GRAY_R * c[..., 0] + _GRAY_G * c[..., 1] + _GRAY_B * c[..., 2]
             + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)


# ------------------------------------------------------------------ Canny

def canny(gray: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(gray, low, high)`` with aperture 3 and the L1 gradient
    on a uint8 (H, W) image: 255 on edges, else 0.

    3 x 3 Sobel with replicated borders; magnitude ``|dx| + |dy|``; a pixel
    with magnitude above ``floor(low)`` survives non-maximum suppression
    along its gradient's sector (horizontal: greater than the left
    neighbour, at least the right one; vertical: the same with up and
    down; diagonal: greater than both, the diagonal chosen by the sign of
    ``dx * dy``; magnitudes outside the image are 0); it is strong above
    ``floor(high)``; the edges are the survivors 8-connected to a strong
    one (hysteresis).
    """
    g = np.pad(gray.astype(np.int32), 1, mode='edge')
    h, w = gray.shape

    def at(dy, dx):
        return g[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    dx = (at(-1, 1) + 2 * at(0, 1) + at(1, 1)
          - at(-1, -1) - 2 * at(0, -1) - at(1, -1))
    dy = (at(1, -1) + 2 * at(1, 0) + at(1, 1)
          - at(-1, -1) - 2 * at(-1, 0) - at(-1, 1))
    mag = np.abs(dx) + np.abs(dy)
    m = np.pad(mag, 1)

    def nb(oy, ox):
        return m[1 + oy:1 + oy + h, 1 + ox:1 + ox + w]
    ax = np.abs(dx).astype(np.int64)
    ay = np.abs(dy).astype(np.int64) << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << (_CANNY_SHIFT + 1))
    horiz = ay < tg22x
    vert = ay > tg67x
    # the diagonal through up-left and down-right where dx and dy share a
    # sign, else through up-right and down-left
    same = (dx ^ dy) >= 0
    keep = np.where(
        horiz, (mag > nb(0, -1)) & (mag >= nb(0, 1)),
        np.where(vert, (mag > nb(-1, 0)) & (mag >= nb(1, 0)),
                 np.where(same, (mag > nb(-1, -1)) & (mag > nb(1, 1)),
                          (mag > nb(-1, 1)) & (mag > nb(1, -1)))))
    cand = keep & (mag > int(np.floor(low)))
    strong = cand & (mag > int(np.floor(high)))
    labels, n = ndimage.label(cand, structure=np.ones((3, 3), bool))
    hit = np.zeros(n + 1, bool)
    hit[labels[strong]] = True
    hit[0] = False
    return np.where(hit[labels], np.uint8(255), np.uint8(0))


# -------------------------------------------------------------------- PNG

_PNG_SIG = b'\x89PNG\r\n\x1a\n'
# colour type -> channels of an 8-bit image (3, palette, is refused)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))


_PNG_FILTER_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               'src', 'png_filter.cpp')
_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def _png_filters() -> ctypes.CDLL:
    """Build (if needed) and load ``src/png_filter.cpp``."""
    lib = ctypes.CDLL(build_host_library(_PNG_FILTER_SRC))
    lib.png_unfilter.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, _U8P]
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_filter_adaptive.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, _U8P]
    lib.png_filter_adaptive.restype = None
    return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an 8-bit gray (H, W) or RGB (H, W, 3) PNG, each row with the
    filter that libpng's default heuristic picks (the least sum of the
    filtered bytes read as signed), deflated at cv2's default level, 1.
    The pixels are RGB in memory and on disk: ``cv2.imwrite`` of the same
    image takes BGR."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f'write_png: (H, W) or (H, W, 3) uint8, not '
                         f'{img.shape} {img.dtype}')
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    raw = np.empty((h, w * bpp + 1), np.uint8)
    _png_filters().png_filter_adaptive(_u8p(img), h, w * bpp, bpp, _u8p(raw))
    ihdr = struct.pack('>IIBBBBB', w, h, 8, 0 if img.ndim == 2 else 2,
                       0, 0, 0)
    with open(path, 'wb') as f:
        f.write(_PNG_SIG + _chunk(b'IHDR', ihdr)
                + _chunk(b'IDAT', zlib.compress(raw.tobytes(), 1))
                + _chunk(b'IEND', b''))


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of an 8-bit image: (h, w * bpp)."""
    stride = w * bpp
    raw = np.frombuffer(data, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f'PNG: {raw.size} bytes of image data, expected '
                         f'{h * (stride + 1)}')
    out = np.empty((h, stride), np.uint8)
    bad = _png_filters().png_unfilter(_u8p(raw), h, stride, bpp, _u8p(out))
    if bad:
        raise ValueError(f'PNG: filter type {bad}')
    return out


def read_png(path: str, gray: bool = False) -> np.ndarray:
    """Read an 8-bit, non-interlaced gray, gray + alpha, RGB or RGBA PNG as
    ``cv2.imread`` does, with the channels in RGB order: (H, W, 3) uint8
    (gray expanded to 3 channels, alpha dropped), or with ``gray`` (H, W)
    (colour converted as ``IMREAD_GRAYSCALE`` does it, by libpng's
    ``(9797 R + 19234 G + 3737 B) >> 15``, which is not
    :func:`rgb_to_gray`). A palette, 16-bit or interlaced PNG raises
    ``ValueError``."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f'{path}: not a PNG file')
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError(f'{path}: PNG without an IHDR chunk')
    w, h, depth, ctype, _, _, interlace = header
    if ctype == 3:
        raise ValueError(f'{path}: palette PNGs are not supported')
    if depth != 8:
        raise ValueError(f'{path}: {depth}-bit PNGs are not supported '
                         '(8-bit only)')
    if interlace:
        raise ValueError(f'{path}: interlaced (Adam7) PNGs are not '
                         'supported')
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f'{path}: PNG colour type {ctype}')
    c = _PNG_CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b''.join(idat)), h, w, c).reshape(h, w, c)
    if c in (1, 2):
        g = img[..., 0]
        return g if gray else np.repeat(g[..., None], 3, axis=-1)
    if not gray:
        return np.ascontiguousarray(img[..., :3])
    c = img.astype(np.int32)
    return ((_PNG_GRAY_R * c[..., 0] + _PNG_GRAY_G * c[..., 1]
             + _PNG_GRAY_B * c[..., 2]) >> 15).astype(np.uint8)
