"""The port's Det data modules against the JAX package, on the CPU: the
native rotated IoU (``ops.iou3d``), the rest of ``core.bbox_3d``, the
training stages of ``det.pipelines`` and their collation, the synthetic
scene generator, the frame reader and the CLIs' refusals.

Inputs are seeded numpy arrays fed to both packages. Numpy code must agree
bit for bit; float code holds the tolerance stated at each assertion (the
JAX tests' own). No JAX function here is jitted.
"""

import copy
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.core import bbox_3d as jbbox
from epropnp_tpu.det import pipelines as jpipe
from epropnp_tpu.det import synthetic as jsyn
from epropnp_tpu.det import kitti_dataset as jkitti
from epropnp_tpu.ops import iou3d as jnative
from epropnp_tpu_torch.core.bbox_3d import misc as tmisc
from epropnp_tpu_torch.core.bbox_3d import nms as tnms
from epropnp_tpu_torch.core.bbox_3d import rotate_iou as triou
from epropnp_tpu_torch.det import kitti_dataset as tkitti
from epropnp_tpu_torch.det import pipelines as tpipe
from epropnp_tpu_torch.det import synthetic as tsyn
from epropnp_tpu_torch.det.train import DetBatch
from epropnp_tpu_torch.ops import iou3d as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def assert_same(a, b, where='root'):
    """Nested dicts, lists, tuples and arrays equal exactly (NaN equal to
    NaN); tuples and lists, numpy and Python scalars are interchangeable."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)) and not (
            len(a) and isinstance(a[0], (int, float, np.number))):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{where}[{i}]')
    elif isinstance(a, str) or a is None:
        assert a == b, where
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


# ------------------------------------------------------------ native iou3d

def rand_boxes(seed, n):
    """``tests/test_iou3d_native.py::rand_boxes``."""
    r = np.random.default_rng(seed)
    return np.stack([
        r.uniform(-2, 2, n), r.uniform(-2, 2, n),
        r.uniform(0.5, 3, n), r.uniform(0.5, 3, n),
        r.uniform(-np.pi, np.pi, n)], axis=-1).astype(np.float32)


def rand_boxes_3d(seed, n=16):
    r = np.random.default_rng(seed)
    return np.concatenate([r.uniform(0.5, 3, (n, 3)), r.uniform(-3, 3, (n, 2)),
                           r.uniform(4, 10, (n, 1)),
                           r.uniform(-np.pi, np.pi, (n, 1))],
                          axis=-1).astype(np.float32)


NATIVE_CASES = ('iou', 'iof1', 'inter', 'nms', 'iou3d')


def _native(mod, case):
    b1, b2 = rand_boxes(0, 32), rand_boxes(1, 24)
    if case == 'nms':
        scores = np.random.default_rng(3).random(64).astype(np.float32)
        return mod.nms_rotated(rand_boxes(2, 64), scores, 0.3)
    if case == 'iou3d':
        b = rand_boxes_3d(4)
        return mod.boxes_iou_3d(b, b[::-1])
    return mod.rotated_iou_matrix(b1, b2, criterion=case)


@pytest.mark.parametrize('case', NATIVE_CASES)
def test_native_iou3d_matches_jax_native(case):
    """The port's build of its copy of ``iou3d.cpp`` gives the JAX
    package's native library's results bit for bit (the same source)."""
    if not jnative.native_available():
        pytest.skip('the JAX native library did not build')
    got, want = _native(tnative, case), _native(jnative, case)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('case', NATIVE_CASES)
def test_native_iou3d_matches_torch_reference(case):
    """The native library against the port's torch functions of
    ``core.bbox_3d`` on f32 tensors, at ``tests/test_iou3d_native.py``'s
    tolerances: the IoU matrices within 2e-5, the NMS keep masks equal,
    a box against itself IoU 1 within 1e-5."""
    got = _native(tnative, case)
    b1, b2 = (torch.from_numpy(rand_boxes(0, 32)),
              torch.from_numpy(rand_boxes(1, 24)))
    if case == 'nms':
        scores = torch.from_numpy(
            np.random.default_rng(3).random(64).astype(np.float32))
        want = tnms.nms_rotated(torch.from_numpy(rand_boxes(2, 64)), scores,
                                0.3)
        np.testing.assert_array_equal(got, want.numpy())
        return
    if case == 'iou3d':
        b = torch.from_numpy(rand_boxes_3d(4))
        want = triou.box3d_overlap_camera(b, b.flip(0), aligned=False)
        same = tnative.boxes_iou_3d(b.numpy(), b.numpy())
        np.testing.assert_allclose(np.diag(same), 1.0, atol=1e-5)
    else:
        want = triou.rotated_iou_matrix(b1, b2, criterion=case)
    np.testing.assert_allclose(got, want.numpy(), atol=2e-5)


def test_native_iou3d_build_refuses_without_compiler(monkeypatch, tmp_path):
    """No g++: the build raises and names the compiler; nothing falls back
    to another implementation."""
    monkeypatch.setattr(tnative, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    tnative.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
            tnative.rotated_iou_matrix(rand_boxes(0, 2), rand_boxes(1, 2))
    finally:
        tnative.load_library.cache_clear()
    assert os.listdir(tmp_path) == []


# --------------------------------------------------------------- bbox_3d

def _yaw_mats(seed, n=8):
    r = np.random.default_rng(seed)
    yaw = r.uniform(-np.pi, np.pi, n)
    c, s = np.cos(yaw), np.sin(yaw)
    z, o = np.zeros(n), np.ones(n)
    return np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                     np.stack([-s, z, c], -1)], -2)


def _camera_boxes(seed, n=12):
    """Camera-frame boxes, some behind the camera or off the image."""
    r = np.random.default_rng(seed)
    return np.concatenate([r.uniform(1, 4, (n, 3)), r.uniform(-8, 8, (n, 1)),
                           r.uniform(-1, 2, (n, 1)), r.uniform(-2, 25, (n, 1)),
                           r.uniform(-np.pi, np.pi, (n, 1))], -1)


def _bbox_case(name):
    """(JAX result, port result) of one function on seeded f64 inputs."""
    t = torch.from_numpy
    b1 = rand_boxes(5, 10).astype(np.float64)
    b2 = rand_boxes(6, 10).astype(np.float64)
    c1, c2 = _camera_boxes(7), _camera_boxes(8)
    if name == 'rot_mat_to_yaw':
        m = _yaw_mats(9)
        return jbbox.rot_mat_to_yaw(jnp.asarray(m)), tmisc.rot_mat_to_yaw(t(m))
    if name == 'xywhr2xyxyr':
        return jbbox.xywhr2xyxyr(jnp.asarray(b1)), tmisc.xywhr2xyxyr(t(b1))
    if name == 'rotated_iou_pairwise':
        return (jbbox.rotated_iou_pairwise(jnp.asarray(b1), jnp.asarray(b2)),
                triou.rotated_iou_pairwise(t(b1), t(b2)))
    if name.startswith('matrix_'):
        crit = name[len('matrix_'):]
        return (jbbox.rotated_iou_matrix(jnp.asarray(b1), jnp.asarray(b2),
                                         criterion=crit),
                triou.rotated_iou_matrix(t(b1), t(b2), criterion=crit))
    if name.startswith('overlap_'):
        aligned = name == 'overlap_aligned'
        return (jbbox.box3d_overlap_camera(jnp.asarray(c1), jnp.asarray(c2),
                                           aligned=aligned),
                triou.box3d_overlap_camera(t(c1), t(c2), aligned=aligned))
    if name.startswith('to_2d'):
        clip = name == 'to_2d_clip'
        k = np.array([[500., 0., 320.], [0., 500., 180.], [0., 0., 1.]])
        ks = np.broadcast_to(k, (len(c1), 3, 3)).copy()
        hw = np.tile([360., 640.], (len(c1), 1))
        j = jbbox.bboxes_3d_to_2d(jnp.asarray(c1), jnp.asarray(ks),
                                  jnp.asarray(hw), clip=clip)
        p = tmisc.bboxes_3d_to_2d(t(c1), t(ks), t(hw), clip=clip)
        return j, p
    if name == 'batched_bev_nms':
        r = np.random.default_rng(10)
        rows = np.concatenate([_camera_boxes(11, 24)[:, :7],
                               r.random((24, 1))], -1)
        rows[:, 5] = r.uniform(4, 8, 24)  # crowd them so that NMS acts
        rows[:, 3] = r.uniform(-2, 2, 24)
        groups = r.integers(0, 3, 24)
        return (jbbox.batched_bev_nms(jnp.asarray(rows), jnp.asarray(groups),
                                      0.25),
                tmisc.batched_bev_nms(t(rows), t(groups), 0.25))
    raise KeyError(name)


BBOX_CASES = ('rot_mat_to_yaw', 'xywhr2xyxyr', 'rotated_iou_pairwise',
              'matrix_iou', 'matrix_iof1', 'matrix_inter', 'overlap_aligned',
              'overlap_pairs', 'to_2d', 'to_2d_clip', 'batched_bev_nms')


@pytest.mark.parametrize('name', BBOX_CASES)
def test_bbox_3d_additions_match_jax_in_f64(name):
    """The port's additions to ``core.bbox_3d`` against JAX's in f64:
    values within 1e-12, masks equal."""
    j, p = _bbox_case(name)
    j = j if isinstance(j, tuple) else (j,)
    p = p if isinstance(p, tuple) else (p,)
    for a, b in zip(j, p):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a)
            assert 0 < a.sum() < a.size or name != 'batched_bev_nms'
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


# -------------------------------------------------------------- pipelines

def _sample(seed, h=90, w=160, n=6, pts=True):
    """A frame with ``n`` objects, some crossing the image border, ignore
    boxes, truncation and object points."""
    r = np.random.default_rng(seed)
    x1 = r.uniform(-30, w - 10, n)
    y1 = r.uniform(-20, h - 10, n)
    s = dict(img=r.integers(0, 256, (h, w, 3)).astype(np.uint8),
             cam_intrinsic=np.array([[100., 0, w / 2], [0, 100., h / 2],
                                     [0, 0, 1]]),
             gt_bboxes=np.stack([x1, y1, x1 + r.uniform(4, 70, n),
                                 y1 + r.uniform(4, 50, n)], -1),
             gt_labels=r.integers(0, 10, n),
             gt_bboxes_3d=r.normal(size=(n, 7)),
             gt_velo=r.normal(size=(n, 2)), gt_attr=r.integers(0, 9, n),
             gt_bboxes_ignore=np.array([[5., 5., 40., 30.],
                                        [w - 20., 0., w + 10., 15.]]),
             truncation=r.uniform(0, 0.9, n))
    if pts:
        k = r.integers(0, 20, n)
        s['gt_x3d'] = [r.normal(size=(m, 3)) for m in k]
        s['gt_x2d'] = [r.normal(size=(m, 2)) for m in k]
    return s


def _both(fn_name, seed, *args, sample_seed=None, **kw):
    """One stage of both packages on copies of one sample, each with
    ``default_rng(seed)``."""
    s = _sample(seed if sample_seed is None else sample_seed)
    if fn_name not in ('crop_3d', 'resize_3d'):
        args = (np.random.default_rng(seed),) + args
    j = getattr(jpipe, fn_name)(copy.deepcopy(s), *args, **kw)
    if fn_name not in ('crop_3d', 'resize_3d'):
        args = (np.random.default_rng(seed),) + args[1:]
    t = getattr(tpipe, fn_name)(copy.deepcopy(s), *args, **kw)
    return j, t


PIPELINE_CASES = [
    dict(crop_box=(0, 22, 160, 90)),
    dict(crop_box=(0, 22, 160, 90), trunc_ignore_thres=-1.0),
    dict(crop_box=None),
    dict(crop_box=(0, 22, 160, 90), training=False),
    dict(crop_box=(0, 22, 160, 90), scale=0.5),
    dict(crop_box=(0, 22, 160, 90), scale_jitter=(0.8, 1.2)),
]


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('case', range(len(PIPELINE_CASES)))
def test_default_pipeline_matches_jax(case, seed):
    """``default_pipeline`` (training unless the case says otherwise:
    jitter, flip, crop with the truncation relabel, normalisation,
    padding) gives JAX's sample bit for bit from the same seed, or None
    where JAX gives None. The resize cases run through cv2, as JAX's."""
    kw = PIPELINE_CASES[case]
    if ('scale' in kw or 'scale_jitter' in kw):
        pytest.importorskip('cv2')
    s = _sample(seed)
    j = jpipe.default_pipeline(copy.deepcopy(s), np.random.default_rng(seed),
                               **kw)
    t = tpipe.default_pipeline(copy.deepcopy(s), np.random.default_rng(seed),
                               **kw)
    assert_same(t, j)


@pytest.mark.parametrize('allow_negative', [False, True])
@pytest.mark.parametrize('seed', [0, 3, 4])
def test_crop_3d_matches_jax(seed, allow_negative):
    """``crop_3d`` with the truncation relabel (0.8) and with or without
    ``allow_negative_crop``, on a window that some objects leave: JAX's
    sample bit for bit (or None for both)."""
    j, t = _both('crop_3d', seed, (20, 30, 120, 90), 0.8, allow_negative)
    assert_same(t, j)


def test_crop_3d_drops_a_sample_without_objects():
    """A training crop that leaves no object returns None in both
    packages; allowed, it returns the empty sample."""
    for allow in (False, True):
        j, t = _both('crop_3d', 0, (0, 0, 2, 2), 0.8, allow)
        assert (j is None) == (t is None) == (not allow)


@pytest.mark.parametrize('seed', [0, 1, 2, 5])
def test_random_crops_match_jax(seed):
    """``random_crop_3d`` (a 64x100 window) and ``min_iou_random_crop_3d``
    (JAX's modes and patch draws) give JAX's samples bit for bit."""
    j, t = _both('random_crop_3d', seed, (64, 100), 0.8, False)
    assert_same(t, j)
    for k in range(3):
        j, t = _both('min_iou_random_crop_3d', seed * 10 + k,
                     sample_seed=seed)
        assert_same(t, j)


@pytest.mark.parametrize('scale', [0.5, 1.3])
def test_resize_3d_matches_jax(scale):
    """``resize_3d`` through cv2 (where cv2 is installed) gives JAX's
    arrays bit for bit."""
    pytest.importorskip('cv2')
    s = jpipe.load_image_3d(_sample(1))
    j = jpipe.resize_3d(copy.deepcopy(s), scale)
    t = tpipe.resize_3d(copy.deepcopy(s), scale)
    assert_same(t, j)


@pytest.mark.parametrize('max_pts', [0, 8])
def test_collate_det_batch_matches_jax(max_pts):
    """``collate_det_batch`` on three pipeline outputs (one with more
    objects than slots, one with none): the port's tensors equal JAX's
    ``DetBatch`` arrays; labels and attributes int64, flips and masks
    bool, the rest float32, on the device asked for."""
    samples = []
    for seed in range(3):
        s = tpipe.default_pipeline(_sample(seed), np.random.default_rng(seed),
                                   crop_box=None)
        samples.append(s)
    samples[2]['gt_bboxes'] = samples[2]['gt_bboxes'][:0]
    j = jpipe.collate_det_batch(copy.deepcopy(samples), 4, max_pts)
    t = tpipe.collate_det_batch(copy.deepcopy(samples), 4, max_pts,
                                device='cpu')
    assert isinstance(t, DetBatch)
    for name in DetBatch._fields:
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert b.device.type == 'cpu'
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        want = {'gt_labels': torch.int64, 'gt_attr': torch.int64}.get(
            name, torch.bool if np.asarray(a).dtype == bool else
            torch.float32)
        assert b.dtype == want, name
    assert (max_pts > 0) == (t.gt_x3d is not None)
    assert t.gt_mask.sum() == 4 + min(len(samples[1]['gt_bboxes']), 4)


# ------------------------------------------------------------ synthetic

@pytest.mark.parametrize('seed', [0, 7])
def test_synthetic_scenes_match_jax(seed):
    """``SyntheticDetSceneGenerator``: the same seed gives JAX's scenes
    bit for bit, and the same dense x2d map."""
    kw = dict(im_hw=(96, 160), max_gt=4, lidar_points=8)
    jg, tg = jsyn.SyntheticDetSceneGenerator(**kw), \
        tsyn.SyntheticDetSceneGenerator(**kw)
    j = jg.sample_batch(np.random.default_rng(seed), 3)
    t = tg.sample_batch(np.random.default_rng(seed), 3)
    for name in jsyn.SyntheticDetScene._fields:
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    np.testing.assert_array_equal(tg.dense_x2d(2), jg.dense_x2d(2))
    np.testing.assert_array_equal(tg.cam_k, jg.cam_k)


# ----------------------------------------------------------------- KITTI

def _write_kitti(root, n=3, seed=0):
    r = np.random.default_rng(seed)
    for d in ('label_2', 'calib'):
        os.makedirs(os.path.join(root, d))
    for i in range(n):
        with open(os.path.join(root, 'label_2', f'{i:06d}.txt'), 'w') as f:
            for k in range(4):
                name = ('Car', 'Pedestrian', 'Cyclist', 'Van')[k]
                x1, y1 = r.uniform(0, 500), r.uniform(0, 200)
                f.write(f'{name} {r.uniform(0, .4):.2f} {k % 3} '
                        f'{r.uniform(-3, 3):.2f} {x1:.2f} {y1:.2f} '
                        f'{x1 + r.uniform(20, 80):.2f} '
                        f'{y1 + r.uniform(20, 80):.2f} '
                        f'{r.uniform(1, 2):.2f} {r.uniform(1, 2):.2f} '
                        f'{r.uniform(2, 5):.2f} {r.uniform(-5, 5):.2f} '
                        f'{r.uniform(1, 2):.2f} {r.uniform(5, 40):.2f} '
                        f'{r.uniform(-3, 3):.2f}\n')
        with open(os.path.join(root, 'calib', f'{i:06d}.txt'), 'w') as f:
            f.write('P0: ' + ' '.join(['1.0'] * 12) + '\n')
            f.write('P2: ' + ' '.join(f'{v:.4f}' for v in
                                      r.uniform(0, 700, 12)) + '\n')


def test_kitti_dataset_matches_jax(tmp_path):
    """``parse_label_file`` / ``parse_calib_file`` on a written KITTI tree
    and ``KITTI3DDataset`` / ``KITTI3DCarDataset.evaluate`` (with the
    coco-style table) of jittered detections: identical dicts."""
    root = str(tmp_path)
    _write_kitti(root)
    for j_cls, t_cls in ((jkitti.KITTI3DDataset, tkitti.KITTI3DDataset),
                         (jkitti.KITTI3DCarDataset,
                          tkitti.KITTI3DCarDataset)):
        jd, td = j_cls(root), t_cls(root)
        assert td.ids == jd.ids and len(td) == 3
        dts = []
        for i in range(len(td)):
            assert_same(td.get_ann(i), jd.get_ann(i))
            np.testing.assert_array_equal(td.get_calib(i), jd.get_calib(i))
            a = td.get_ann(i)
            r = np.random.default_rng(i)
            dts.append(dict(a, location=a['location'] + r.normal(
                0, 0.3, a['location'].shape).astype(np.float32),
                score=r.random(len(a['name'])).astype(np.float32)))
        assert_same(td.evaluate(dts, coco_style=True),
                    jd.evaluate(dts, coco_style=True))
    path = os.path.join(root, 'label_2', '000000.txt')
    assert_same(tkitti.parse_label_file(path, with_score=True),
                jkitti.parse_label_file(path, with_score=True))


# ------------------------------------------------- reader and refusals

def test_imread_reads_npy_and_decodes_like_jax(tmp_path):
    """A ``.npy`` frame comes back as written; a ``.png`` is decoded by cv2
    as the JAX CLIs decode it (BGR to RGB)."""
    img = np.random.default_rng(0).integers(0, 256, (12, 20, 3)).astype(
        np.uint8)
    np.save(tmp_path / 'f.npy', img)
    np.testing.assert_array_equal(tpipe.imread(str(tmp_path / 'f.npy')), img)
    cv2 = pytest.importorskip('cv2')
    cv2.imwrite(str(tmp_path / 'f.png'), img)
    np.testing.assert_array_equal(tpipe.imread(str(tmp_path / 'f.png')),
                                  cv2.imread(str(tmp_path / 'f.png'))[..., ::-1])


def test_imread_without_cv2_names_npy_frames(tmp_path, monkeypatch):
    """Without cv2 a ``.png`` raises an ImportError that names ``.npy``
    frames; ``resize_3d`` raises the same; a ``.npy`` frame still reads."""
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match=r'\.npy'):
        tpipe.imread(str(tmp_path / 'f.png'))
    with pytest.raises(ImportError, match=r'\.npy'):
        tpipe.resize_3d(tpipe.load_image_3d(_sample(0)), 0.5)
    np.save(tmp_path / 'f.npy', np.zeros((2, 2, 3), np.uint8))
    assert tpipe.imread(str(tmp_path / 'f.npy')).shape == (2, 2, 3)


@pytest.mark.parametrize('tool', ['train_det', 'test_det'])
def test_cli_refuses_data_parallel(tool):
    """``--data-parallel`` runs (it was refused before the port had it),
    but refuses a global batch that does not divide over the ranks (6
    over a WORLD_SIZE of 4) with a usage error (exit code 2), before any
    process group, data or model is touched."""
    out = subprocess.run(
        [sys.executable, '-m', f'epropnp_tpu_torch.tools.{tool}',
         '--ann', 'missing.pkl', '--checkpoint', 'missing.pt',
         '--data-parallel', '--batch-size', '6'] if tool == 'test_det' else
        [sys.executable, '-m', f'epropnp_tpu_torch.tools.{tool}',
         '--ann', 'missing.pkl', '--data-parallel', '--batch-size', '6'],
        capture_output=True, text=True, timeout=120, cwd=REPO, check=False,
        env=dict(os.environ, WORLD_SIZE='4'))
    assert out.returncode == 2, out.stderr
    assert 'must divide' in out.stderr and 'data-parallel' in out.stderr
