"""The port's image operations and PNG codec (``epropnp_tpu_torch.utils.
image_ops``) against OpenCV, on seeded arrays: every function bit for bit
(``box_blur3`` within 1e-6 absolute: f32 sums in another order), the PNG
round trips both ways, and the refusal of the PNG formats the codec does
not read.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from epropnp_tpu_torch.sixdof import synthetic
from epropnp_tpu_torch.utils import image_ops

cv2 = pytest.importorskip('cv2')


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _coord_gray(coor):
    """The gray map ``denoise_coor`` runs Canny on, by cv2."""
    return cv2.cvtColor((np.abs(coor) * 255).clip(0, 255).astype(np.uint8),
                        cv2.COLOR_RGB2GRAY)


def _frame(seed, pts_per_face=96):
    ext = np.array([0.038, 0.039, 0.046], np.float32)
    r = np.random.default_rng(seed)
    rot, trans = synthetic.random_pose(r)
    return synthetic.render_frame(synthetic.cuboid_surface(ext, pts_per_face),
                                  ext, rot, trans, rng=r), ext


# ----------------------------------------------------------------- resize

@pytest.mark.parametrize('dst', [64, 256])
@pytest.mark.parametrize('n', [16, 37, 100, 181, 255, 333, 480, 517, 700])
def test_resize_linear_uint8_square_crops(n, dst):
    img = _rng(n, dst).integers(0, 256, (n, n, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        image_ops.resize_linear(img, (dst, dst)),
        cv2.resize(img, (dst, dst), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize('channels', [1, 3])
@pytest.mark.parametrize('hw', [(181, 195), (200, 300), (375, 500),
                                (480, 640), (600, 800)])
def test_resize_linear_uint8_non_square(hw, channels):
    """To a 640x480 frame (``change_bg``'s case) and to 256x256."""
    shape = hw + ((3,) if channels == 3 else ())
    img = _rng(*hw, channels).integers(0, 256, shape).astype(np.uint8)
    for size in ((640, 480), (256, 256)):
        np.testing.assert_array_equal(
            image_ops.resize_linear(img, size),
            cv2.resize(img, size, interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize('dst', [16, 64])
@pytest.mark.parametrize('n', [16, 57, 181, 300, 700])
def test_resize_linear_float32(n, dst):
    """The mask crop's case (0/1 maps) and normal-distributed maps."""
    r = _rng(n, dst)
    for img in ((r.uniform(size=(n, n)) > 0.5).astype(np.float32),
                r.normal(size=(n, n, 3)).astype(np.float32)):
        np.testing.assert_array_equal(
            image_ops.resize_linear(img, (dst, dst)),
            cv2.resize(img, (dst, dst), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize('dst', [16, 64, 256])
@pytest.mark.parametrize('n', [16, 57, 181, 300, 700])
def test_resize_nearest(n, dst):
    img = _rng(n, dst).normal(size=(n, n, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        image_ops.resize_nearest(img, (dst, dst)),
        cv2.resize(img, (dst, dst), interpolation=cv2.INTER_NEAREST))


# ---------------------------------------------------------------- filters

@pytest.mark.parametrize('shape', [(480, 640, 3), (31, 47, 3), (64, 48)])
def test_median_blur3(shape):
    r = _rng(len(shape), shape[0])
    img = r.normal(size=shape).astype(np.float32)
    want = cv2.medianBlur(img, 3)
    np.testing.assert_array_equal(image_ops.median_blur3(img), want)
    ys = np.concatenate([[0, shape[0] - 1], r.integers(0, shape[0], 40)])
    xs = np.concatenate([[shape[1] - 1, 0], r.integers(0, shape[1], 40)])
    np.testing.assert_array_equal(image_ops.median_blur3(img, (ys, xs)),
                                  want[ys, xs])


def test_rgb_to_gray():
    img = _rng(3).integers(0, 256, (480, 640, 3)).astype(np.uint8)
    np.testing.assert_array_equal(image_ops.rgb_to_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_morph_close3(seed):
    """Random masks (touching every border) and a splat mask."""
    r = _rng(seed)
    masks = [((r.uniform(size=(120, 160)) > p) * 255).astype(np.uint8)
             for p in (0.3, 0.7)]
    masks.append(_frame(seed, pts_per_face=24)[0]['mask'])
    kernel = np.ones((3, 3), np.uint8)
    for m in masks:
        np.testing.assert_array_equal(
            image_ops.morph_close3(m),
            cv2.morphologyEx(m, cv2.MORPH_CLOSE, kernel))


@pytest.mark.parametrize('shape', [(480, 640, 3), (480, 640), (5, 7, 3)])
def test_box_blur3(shape):
    img = _rng(4, len(shape)).normal(size=shape).astype(np.float32)
    got = image_ops.box_blur3(img)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_allclose(got, cv2.blur(img, (3, 3)), rtol=0, atol=1e-6)


def _canny_inputs(seed):
    """Gray maps from seeded coordinate maps (``build_sample``'s test
    input and scaled copies that saturate), from a synthetic frame's rgb
    and coordinates, smooth and noisy images, and constant ones."""
    r = _rng(seed)
    coor = r.uniform(-.05, .05, (480, 640, 3)).astype(np.float32)
    fr, ext = _frame(seed)
    yield _coord_gray(coor)
    yield _coord_gray(coor * 20.0)
    yield _coord_gray(fr['coord'] / ext)
    yield _coord_gray(fr['coord'])
    yield cv2.cvtColor(fr['rgb'], cv2.COLOR_RGB2GRAY)
    yield cv2.GaussianBlur(r.integers(0, 256, (240, 320)).astype(np.uint8),
                           (0, 0), 3)
    yield r.integers(0, 256, (37, 53)).astype(np.uint8)
    yield np.full((16, 24), 200, np.uint8)


@pytest.mark.parametrize('seed', range(4))
def test_canny(seed):
    for i, gray in enumerate(_canny_inputs(seed)):
        np.testing.assert_array_equal(image_ops.canny(gray, 20, 100),
                                      cv2.Canny(gray, 20, 100),
                                      err_msg=f'input {i}')


# -------------------------------------------------------------------- PNG

def _png_filter_kinds(path):
    """The filter type of each row of an 8-bit PNG written by this codec
    or by cv2 (one IDAT stream)."""
    with open(path, 'rb') as f:
        data = f.read()
    w, h, _, ctype = struct.unpack('>IIBB', data[16:26])
    idat, pos = b'', 8
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        idat += data[pos + 8:pos + 8 + n] if kind == b'IDAT' else b''
        pos += 12 + n
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)[:, 0]


@pytest.mark.parametrize('image', ['gray', 'rgb', 'rgb_640x480', 'frame'])
def test_write_png_reads_back_in_cv2(tmp_path, image):
    """Random arrays, and a rendered synthetic frame (smooth shading, on
    which the adaptive choice takes several filter types)."""
    if image == 'frame':
        img = _frame(7)[0]['rgb']
    else:
        shape = {'gray': (48, 64), 'rgb': (48, 64, 3),
                 'rgb_640x480': (480, 640, 3)}[image]
        img = _rng(5, len(shape)).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / 'a.png')
    image_ops.write_png(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got if img.ndim == 2 else got[..., ::-1],
                                  img)
    np.testing.assert_array_equal(image_ops.read_png(path, gray=img.ndim == 2),
                                  img)
    if image == 'frame':
        assert len(set(_png_filter_kinds(path).tolist())) >= 3


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(img, kinds):
    """The PNG image data of ``img`` (H, W, C) uint8, row y filtered with
    ``kinds[y]``: numpy's vectorised encoder, this test's reference."""
    h = img.shape[0]
    bpp = img.shape[2]
    x = img.reshape(h, -1).astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, bpp:] = x[:-1, :-bpp]
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1,
                      _paeth(left, up, ul)])
    rows = (x - preds[kinds, np.arange(h)]) & 0xff
    return np.concatenate([kinds[:, None], rows], 1).astype(np.uint8)


@pytest.mark.parametrize('kind', [0, 1, 2, 3, 4, 'mixed'])
@pytest.mark.parametrize('channels', [1, 3, 4])
def test_read_png_of_every_filter(tmp_path, kind, channels):
    """PNGs whose rows all take one filter type, or cycle through the
    five, read as ``cv2.imread`` reads them, whatever filters cv2's own
    writer picks; a filter type above 4 raises."""
    img = _rng(8, channels).integers(0, 256, (21, 37, channels)
                                     ).astype(np.uint8)
    img[:5] = 99
    kinds = (np.arange(21) % 5 if kind == 'mixed'
             else np.full(21, kind)).astype(np.int64)
    path = str(tmp_path / 'f.png')
    with open(path, 'wb') as f:
        f.write(_png_bytes(37, 21, 8, {1: 0, 3: 2, 4: 6}[channels], 0,
                           _filter_rows(img, kinds).tobytes()))
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = want if channels == 1 else want[..., [2, 1, 0]]
    np.testing.assert_array_equal(image_ops.read_png(path, gray=channels == 1),
                                  want)
    np.testing.assert_array_equal(image_ops.read_png(path, gray=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    bad = _filter_rows(img, kinds)
    bad[3, 0] = 5
    with open(path, 'wb') as f:
        f.write(_png_bytes(37, 21, 8, {1: 0, 3: 2, 4: 6}[channels], 0,
                           bad.tobytes()))
    with pytest.raises(ValueError, match='filter type 5'):
        image_ops.read_png(path)


@pytest.mark.parametrize('level', [0, 3, 9])
@pytest.mark.parametrize('shape', [(40, 56), (40, 56, 3), (40, 56, 4)])
def test_read_png_of_cv2(tmp_path, shape, level):
    """cv2's gray, BGR and BGRA PNGs (every filter type: cv2 picks them
    adaptively; a flat band and a gradient make each one pay) read as
    ``cv2.imread`` reads them, in colour and as ``IMREAD_GRAYSCALE``."""
    r = _rng(6, len(shape), level)
    img = r.integers(0, 256, shape).astype(np.uint8)
    img[:8] = 17
    img[8:16] = np.arange(shape[1], dtype=np.uint8).reshape(
        (-1,) + (1,) * (img.ndim - 2))
    path = str(tmp_path / 'b.png')
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(image_ops.read_png(path),
                                  cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(image_ops.read_png(path, gray=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def _png_bytes(w, h, depth, ctype, interlace, raw=b''):
    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype, 0,
                                         0, interlace))
            + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    sixteen = str(tmp_path / '16.png')
    assert cv2.imwrite(sixteen, np.arange(48, dtype=np.uint16
                                          ).reshape(6, 8) * 1000)
    palette = str(tmp_path / 'palette.png')
    with open(palette, 'wb') as f:
        f.write(_png_bytes(2, 2, 8, 3, 0, b'\0\0\0' * 2))
    interlaced = str(tmp_path / 'adam7.png')
    with open(interlaced, 'wb') as f:
        f.write(_png_bytes(2, 2, 8, 0, 1, b'\0\0\0' * 2))
    for path, word in ((sixteen, '16-bit'), (palette, 'palette'),
                       (interlaced, 'interlaced')):
        with pytest.raises(ValueError, match=word):
            image_ops.read_png(path)
    jpeg = str(tmp_path / 'a.jpg')
    assert cv2.imwrite(jpeg, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match='not a PNG'):
        image_ops.read_png(jpeg)
    with pytest.raises(ValueError, match='uint8'):
        image_ops.write_png(str(tmp_path / 'f.png'),
                            np.zeros((4, 4), np.float32))
    assert not os.path.exists(str(tmp_path / 'f.png'))
