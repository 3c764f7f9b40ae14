"""The port's Det evaluation path against the JAX package, on the CPU: the
KITTI and nuScenes metrics, ``NuScenes3DDataset`` on a converted tree, the
synthetic study's NDS, and the slice as a whole on that tree: the training
CLI's batches, ``tools.test_det.evaluate_dataset`` and the round trip from
``det.main.train_loop``'s ``latest.pt`` through ``det.api.init_detector``.

The tree is built as ``tests/test_data_drop_drill.py`` builds it: the
nuScenes devkit double of ``tests/fake_nuscenes.py`` feeds the real
converter (``tools/nuscenes_converter.py``). Numpy code must agree bit for
bit; float code holds the tolerance stated at each assertion. One JAX jit:
the f64 inference function of the slice test.
"""

import copy
import dataclasses
import itertools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.det import api as japi
from epropnp_tpu.det import config as jconfig
from epropnp_tpu.det import kitti_eval as jke
from epropnp_tpu.det import nuscenes_dataset as jnus
from epropnp_tpu.det import nuscenes_eval as jne
from epropnp_tpu.det import pipelines as jpipe
from epropnp_tpu.det import test as jtest
from epropnp_tpu.det.synthetic import SyntheticDetSceneGenerator
from epropnp_tpu.ops.pnp import levenberg_marquardt as jlm
from epropnp_tpu_torch.det import api as tapi
from epropnp_tpu_torch.det import config as tconfig
from epropnp_tpu_torch.det import kitti_eval as tke
from epropnp_tpu_torch.det import main as tmain
from epropnp_tpu_torch.det import nuscenes_dataset as tnus
from epropnp_tpu_torch.det import nuscenes_eval as tne
from epropnp_tpu_torch.ops.pnp import levenberg_marquardt as tlm
from epropnp_tpu_torch.tools import test_det as ttest_det
from epropnp_tpu_torch.tools import train_det as ttrain_det
from epropnp_tpu_torch.tools import validate_det_synthetic as tvds
from epropnp_tpu_torch.utils.convert import det_state_dict
from test_torch_det_data import assert_same
from test_torch_det_serving import _jax_rslm_stand_in, _torch_rslm_stand_in

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def assert_close(a, b, atol, where='root'):
    """Nested dicts and numbers within ``atol`` (NaN equal to NaN), other
    leaves equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            assert_close(a[k], b[k], atol, f'{where}.{k}')
    elif isinstance(a, (float, int, np.floating)) and not isinstance(a, bool):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=where)
    else:
        assert a == b, where


# ------------------------------------------------------------------ KITTI

def _kitti_annos(seed, n_img=6, det=False):
    """Seeded KITTI annos: three classes, near and far, occluded and
    truncated; detections jitter the ground truth of the same seed, drop
    some objects and add false positives."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n_img):
        n = int(r.integers(2, 7))
        names = r.choice(['Car', 'Pedestrian', 'Cyclist', 'Van'], n)
        dims = r.uniform(0.8, 4.5, (n, 3)).astype(np.float32)
        loc = np.stack([r.uniform(-8, 8, n), r.uniform(1, 2, n),
                        r.uniform(5, 45, n)], -1).astype(np.float32)
        ry = r.uniform(-np.pi, np.pi, n).astype(np.float32)
        x1, y1 = r.uniform(0, 1100, n), r.uniform(0, 300, n)
        bbox = np.stack([x1, y1, x1 + r.uniform(10, 150, n),
                         y1 + r.uniform(15, 120, n)], -1).astype(np.float32)
        anno = dict(name=names, dimensions=dims, location=loc,
                    rotation_y=ry, bbox=bbox,
                    alpha=(ry - np.arctan2(loc[:, 0], loc[:, 2])).astype(
                        np.float32),
                    occluded=r.integers(0, 3, n).astype(np.float32),
                    truncated=r.uniform(0, 0.6, n).astype(np.float32))
        if det:
            d = np.random.default_rng(1000 + seed * 10 + i)
            keep = d.random(n) > 0.2
            anno = {k: v[keep] for k, v in anno.items()}
            m = int(keep.sum())
            anno['location'] = anno['location'] + d.normal(
                0, 0.3, (m, 3)).astype(np.float32)
            anno['bbox'] = anno['bbox'] + d.normal(0, 4, (m, 4)).astype(
                np.float32)
            anno['rotation_y'] = anno['rotation_y'] + d.normal(
                0, 0.2, m).astype(np.float32)
            anno['score'] = d.random(m).astype(np.float32)
        out.append(anno)
    return out


@pytest.mark.parametrize('seed', [0, 1])
def test_kitti_eval_matches_jax(seed):
    """``kitti_eval`` (AP and AOS, three classes, bbox/BEV/3D) and
    ``kitti_eval_coco_style`` on seeded annos: identical dicts (the same
    numpy code over the same native IoU source)."""
    gt, dt = _kitti_annos(seed), _kitti_annos(seed, det=True)
    t = tke.kitti_eval(gt, dt)
    assert_same(t, jke.kitti_eval(gt, dt))
    assert any(0 < v < 100 for v in t.values())
    assert_same(tke.kitti_eval_coco_style(gt, dt),
                jke.kitti_eval_coco_style(gt, dt))


def test_kitti_eval_class_matches_jax():
    """``eval_class`` at one difficulty and overlap: identical dicts."""
    gt, dt = _kitti_annos(2), _kitti_annos(2, det=True)
    for metric in ('bbox', 'bev', '3d'):
        assert_same(tke.eval_class(gt, dt, 'Car', 1, metric, 0.5,
                                   compute_aos=True),
                    jke.eval_class(gt, dt, 'Car', 1, metric, 0.5,
                                   compute_aos=True))


# --------------------------------------------------------- nuScenes metrics

def _nus_frames(seed, n_frames=4):
    """Seeded global-frame GT and predictions (jittered GT, misses, false
    positives), ego centres and bike racks."""
    r = np.random.default_rng(seed)
    gt, pred, ego, racks = {}, {}, {}, {}
    for f in range(n_frames):
        token = f's{f}'
        ego[token] = [float(v) for v in r.uniform(-50, 50, 2)]
        gts, preds = [], []
        for k in range(int(r.integers(5, 15))):
            name = tnus.CLASSES[int(r.integers(0, 10))]
            yaw = r.uniform(-np.pi, np.pi)
            box = dict(
                translation=[float(ego[token][0] + r.uniform(-45, 45)),
                             float(ego[token][1] + r.uniform(-45, 45)),
                             float(r.uniform(0, 2))],
                size=[float(v) for v in r.uniform(0.5, 5, 3)],
                rotation=[float(np.cos(yaw / 2)), 0.0, 0.0,
                          float(np.sin(yaw / 2))],
                velocity=[float(v) for v in r.normal(0, 2, 2)],
                detection_name=name,
                attribute_name=tnus.CLS2ATTR[name][
                    int(r.integers(len(tnus.CLS2ATTR[name])))],
                num_pts=int(r.integers(0, 5)))
            gts.append(box)
            if r.random() < 0.8:
                p = copy.deepcopy(box)
                p['translation'] = [v + float(r.normal(0, 0.8))
                                    for v in p['translation']]
                p['detection_score'] = float(r.random())
                p.pop('num_pts')
                preds.append(p)
        gt[token], pred[token] = gts, preds
        racks[token] = [dict(translation=gts[0]['translation'],
                             size=[3.0, 3.0, 2.0], rotation=[1., 0., 0., 0.])]
    return gt, pred, ego, racks


@pytest.mark.parametrize('filters', [False, True])
def test_evaluate_detection_matches_jax(filters):
    """``nuscenes_eval.evaluate_detection`` on seeded frames, with and
    without the range and bike-rack filters: identical dicts."""
    gt, pred, ego, racks = _nus_frames(3)
    kw = dict(ego_centers=ego, bikerack_frames=racks) if filters else {}
    t = tne.evaluate_detection(pred, gt, **kw)
    assert_same(t, jne.evaluate_detection(pred, gt, **kw))
    assert 0 < t['mean_ap'] < 1


# ------------------------------------------------------- the converted tree

@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """The drill's tree: one train and one val scene of two keyframes,
    six cameras each (256x128 PNG frames), OC caches and bike racks."""
    import fake_nuscenes
    root = str(tmp_path_factory.mktemp('nusc'))
    prefix = os.path.join(root, 'infos')
    with pytest.MonkeyPatch.context() as mp:
        fake_nuscenes.install(mp)
        sys.path.insert(0, os.path.join(REPO, 'tools'))
        try:
            from nuscenes_converter import convert
            convert(root, 'v1.0-trainval', prefix, with_obj_points=True)
        finally:
            sys.path.pop(0)
    assert 'nuscenes' not in sys.modules  # the devkit double is gone
    return dict(root=root, train=prefix + '_train.pkl',
                val=prefix + '_val.pkl')


def _datasets(tree, split):
    return (jnus.NuScenes3DDataset(tree[split], img_prefix=tree['root']),
            tnus.NuScenes3DDataset(tree[split], img_prefix=tree['root']))


@pytest.mark.parametrize('split', ['train', 'val'])
def test_parse_ann_info_matches_jax(tree, split):
    """``parse_ann_info`` of every camera sample (with the object points
    of the OC caches): identical."""
    jd, td = _datasets(tree, split)
    assert len(td) == len(jd) == 12
    for info in td.data_infos:
        t = td.parse_ann_info(info)
        assert_same(t, jd.parse_ann_info(info))
    assert any(len(td.parse_ann_info(i)['labels']) for i in td.data_infos)
    assert 'x3d' in t


def test_global_gt_and_bike_racks_match_jax(tree):
    """``build_global_gt`` and ``build_bikerack_frames``: identical."""
    jd, td = _datasets(tree, 'val')
    assert_same(td.build_global_gt(), jd.build_global_gt())
    assert_same(td.build_bikerack_frames(), jd.build_bikerack_frames())


def _random_results(dataset, seed, rows_per_class=(0, 3)):
    """Per camera sample, per class, seeded detection rows [l, h, w, x, y,
    z, ry, score, vx, vz, attr logits...] in front of the camera."""
    r = np.random.default_rng(seed)
    out = []
    for _ in dataset.data_infos:
        per_cls = []
        for _ in tnus.CLASSES:
            m = int(r.integers(*rows_per_class))
            per_cls.append(np.concatenate([
                r.uniform(0.5, 5, (m, 3)), r.uniform(-5, 5, (m, 1)),
                r.uniform(-1, 2, (m, 1)), r.uniform(4, 25, (m, 1)),
                r.uniform(-np.pi, np.pi, (m, 1)), r.random((m, 1)),
                r.normal(0, 1, (m, 2)), r.normal(0, 1, (m, 9))], 1))
        out.append(dict(bbox_3d_results=per_cls))
    return out


def test_multicam_fusion_and_submission_match_jax(tree, tmp_path):
    """``multicam_fusion`` of each keyframe's six cameras (seeded rows
    with attribute logits, cross-camera NMS) and ``format_submission``:
    the same boxes in the same order, the same JSON file."""
    jd, td = _datasets(tree, 'val')
    res = _random_results(td, 0, (1, 6))
    frames = {'j': [], 't': []}
    for start in range(0, len(td), tnus.NUM_CAMS):
        cams = []
        for i in range(start, start + tnus.NUM_CAMS):
            r = dict(res[i])
            r.update({k: td.data_infos[i][k] for k in (
                'sensor2ego_rotation', 'sensor2ego_translation',
                'ego2global_rotation', 'ego2global_translation')})
            cams.append(r)
        token = td.data_infos[start]['sample_token']
        tb, jb = tnus.multicam_fusion(cams), jnus.multicam_fusion(cams)
        assert len(tb) == len(jb) > 0
        for a, b in zip(tb, jb):
            for f in dataclasses.fields(a):
                assert_same(getattr(a, f.name), getattr(b, f.name), f.name)
        frames['t'].append(dict(boxes=tb, sample_token=token))
        frames['j'].append(dict(boxes=jb, sample_token=token))
    pt = tnus.format_submission(frames['t'], str(tmp_path / 't.json'))
    pj = jnus.format_submission(frames['j'], str(tmp_path / 'j.json'))
    with open(pt) as f, open(pj) as g:
        assert f.read() == g.read()


def _without_path(metrics):
    return {k: v for k, v in metrics.items() if k != 'result_path'}


def test_dataset_evaluate_matches_jax(tree, tmp_path):
    """``NuScenes3DDataset.evaluate`` of seeded detections (fusion,
    submission, the self-contained metrics): identical metrics and
    submission files."""
    jd, td = _datasets(tree, 'val')
    res = _random_results(td, 1)
    t = td.evaluate(res, str(tmp_path / 't'))
    j = jd.evaluate(res, str(tmp_path / 'j'))
    assert_same(_without_path(t), _without_path(j))
    assert 'self-contained' in t['note']
    with open(t['result_path']) as f, open(j['result_path']) as g:
        assert f.read() == g.read()


def test_ground_truth_as_detections_on_the_converted_tree(tree, tmp_path):
    """The val ground truth fed back as detections of score 1
    (``tools.test_det.ground_truth_results``): every class present in the
    tree (car, truck, pedestrian) scores AP 1 at every distance, so mAP
    over the ten classes is 3/10 (measured on the CPU: 0.3000000000000001);
    the absent classes score 0 as in the devkit."""
    _, td = _datasets(tree, 'val')
    m = td.evaluate(ttest_det.ground_truth_results(td), str(tmp_path))
    present = {a['category'] for i in td.data_infos for a in i['annotations']}
    assert present == {'car', 'truck', 'pedestrian'}
    for c in tnus.CLASSES:
        want = 1.0 if c in present else 0.0
        np.testing.assert_allclose(list(m['label_aps'][c].values()), want,
                                   atol=1e-12, err_msg=c)
    np.testing.assert_allclose(m['mean_ap'], 0.3, atol=1e-12)


def test_ground_truth_as_detections_on_the_smoke_tree(tmp_path):
    """``chip_smoke.py`` path q's check at a small size (its tree writer at
    225x400, focal 316.6, a quarter of 1600x900's): the ground truth as
    detections scores mAP 1 (measured on the CPU: 1.0000000000000004;
    the card must reach at least ``GT_MAP_FLOOR`` = 0.95) and KITTI AP 100
    in every column through the native IoU."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    paths = chip_smoke.write_det_tree(str(tmp_path), im_hw=(225, 400),
                                      focal=316.6)
    ds = tnus.NuScenes3DDataset(paths['val'], img_prefix=str(tmp_path))
    assert len(ds) == 6 * chip_smoke.DATASET_KEYFRAMES['val']
    assert {a['category'] for i in ds.data_infos
            for a in i['annotations']} == set(tnus.CLASSES)
    m = ds.evaluate(ttest_det.ground_truth_results(ds),
                    str(tmp_path / 'gt'))
    np.testing.assert_allclose(m['mean_ap'], 1.0, atol=1e-12)
    assert m['mean_ap'] >= chip_smoke.GT_MAP_FLOOR
    gt, dt = chip_smoke.kitti_annos(ds)
    kitti = tke.kitti_eval(gt, dt, classes=('Car',))
    assert min(kitti.values()) == 100.0


# ------------------------------------------------ synthetic study metrics

def test_evaluate_nds_matches_jax():
    """``evaluate_nds`` and the IoU-matched ``evaluate`` on JAX's
    ``test_evaluate_nds_wiring`` cases (perfect, a 0.6 m offset, a class
    dropped): identical metrics; perfect scores NDS and mAP above 0.95."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        import validate_det_synthetic as jvds
    finally:
        sys.path.pop(0)
    gen = SyntheticDetSceneGenerator(im_hw=(96, 160), num_classes=tvds.NCLS,
                                     max_gt=tvds.GMAX, lidar_points=tvds.PTS)
    scenes = gen.sample_batch(np.random.default_rng(3), 6)

    def results_from_gt(jitter_t=0.0, drop_cls=None):
        res = []
        for i in range(scenes.img.shape[0]):
            per_cls = []
            for c in range(tvds.NCLS):
                rows = []
                for g in np.flatnonzero(scenes.gt_mask[i]):
                    if scenes.gt_labels[i][g] != c or c == drop_cls:
                        continue
                    b = scenes.gt_bboxes_3d[i][g].astype(np.float64).copy()
                    b[3:6] += jitter_t
                    rows.append(np.concatenate([b, [0.9]]))
                per_cls.append(np.asarray(rows).reshape(-1, 8))
            res.append(per_cls)
        return res

    for kw in (dict(), dict(jitter_t=0.6), dict(drop_cls=0)):
        res = results_from_gt(**kw)
        t = tvds.evaluate_nds(res, scenes)
        assert_same(t, jvds.evaluate_nds(res, scenes))
        assert_close(jvds.evaluate(res, scenes), tvds.evaluate(res, scenes),
                     1e-6)
        if not kw:
            assert t['nd_score'] > 0.95 and t['mean_ap'] > 0.95


# ------------------------------------------------------- the slice, whole

def _jax_batches(dataset, cfg, root, epoch):
    """``tools/train_det.py``'s ``load_sample`` and ``batch_iter`` (lines
    76-115) with the JAX package's stages, ``--no-crop``."""
    import cv2
    bs = cfg.train.batch_size
    steps = max(len(dataset) // bs, 1)

    def load_sample(j, rng):
        info = dataset.data_infos[j]
        img = cv2.imread(os.path.join(root, info['img_path']))[..., ::-1]
        gt = dataset.parse_ann_info(info)
        s = dict(img=img, cam_intrinsic=np.asarray(info['cam_intrinsic']),
                 gt_bboxes=gt['bboxes'], gt_labels=gt['labels'],
                 gt_bboxes_3d=gt['bboxes_3d'], gt_velo=gt['velos'],
                 gt_attr=gt['attrs'], gt_bboxes_ignore=gt['bboxes_ignore'],
                 truncation=gt['truncation'])
        if 'x3d' in gt:
            s.update(gt_x3d=gt['x3d'], gt_x2d=gt['x2d'])
        return jpipe.default_pipeline(s, rng, training=True, crop_box=None)

    rng = np.random.default_rng(epoch)
    order = iter(rng.permutation(len(dataset)))
    for _ in range(steps):
        samples = []
        while len(samples) < bs:
            j = next(order, None)
            if j is None:
                j = int(rng.integers(len(dataset)))
            s = load_sample(j, rng)
            if s is not None:
                samples.append(s)
        yield jpipe.collate_det_batch(
            samples, cfg.train.max_gt_per_img,
            max_pts=128 if cfg.with_loss_regr else 0)


@pytest.mark.parametrize('with_loss_regr', [False, True])
def test_make_batch_iter_gives_jax_batches(tree, with_loss_regr):
    """``tools.train_det.make_batch_iter`` on the converted tree (the smoke
    config, batches of 3, no crop; with the object points of the OC caches
    when ``with_loss_regr``) gives the JAX CLI's batches bit for bit over
    two epochs: the same permutation, flips and backfill."""
    pytest.importorskip('cv2')

    def cfg(mod):
        c = mod.DetConfig.smoke()
        return dataclasses.replace(
            c, with_loss_regr=with_loss_regr,
            train=dataclasses.replace(c.train, batch_size=3))
    jd, td = _datasets(tree, 'train')
    it = ttrain_det.make_batch_iter(td, cfg(tconfig), tree['root'],
                                    crop=False)
    assert ttrain_det.steps_per_epoch(td, cfg(tconfig)) == 4
    flips = 0
    for epoch in (0, 1):
        got = list(it(epoch))
        want = list(_jax_batches(jd, cfg(jconfig), tree['root'], epoch))
        assert len(got) == len(want) == 4
        for t, j in zip(got, want):
            for name in t._fields:
                a, b = getattr(j, name), getattr(t, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                                  err_msg=name)
            flips += int(t.img_flips.sum())
    assert 0 < flips < 24
    assert (got[0].gt_x3d is not None) == with_loss_regr


SLICE_HW = (128, 256)


def _smoke_variables(jmodel, seed):
    """Seeded f64 flax variables of the smoke model (shapes by
    ``jax.eval_shape``): kernels N(0, 1/fan_in), BatchNorm statistics
    drawn, biases 0, DCN offset convs 0 (plain convolutions, so that JAX's
    bf16 sampling positions are exact)."""
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, SLICE_HW),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1,) + SLICE_HW + (3,)))
    r = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [str(getattr(p, 'key', '')) for p in path]
        if 'conv_offset' in keys or keys[-1] == 'bias':
            return np.zeros(s.shape)
        if keys[-1] == 'kernel':
            return r.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        if keys[-1] == 'mean':
            return r.normal(0, 0.1, s.shape)
        if keys[-1] in ('var', 'scale'):
            return r.uniform(0.5, 1.5, s.shape)
        return r.normal(0, 0.05, s.shape)
    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _jax_request(variables, cfg, imgs, cams, infer):
    """JAX's ``det.api.inference_detector`` (the pipeline without a crop,
    the stacking, one call, ``results_to_numpy``) with the intrinsics kept
    in f64: the JAX API rounds them to f32, and the f32 inverse of a
    160-pixel focal moves an f64 solve's poses by ~1e-7 relative."""
    samples = [jpipe.default_pipeline(dict(img=img, cam_intrinsic=k),
                                      training=False)
               for img, k in zip(imgs, cams)]
    stack = lambda key: jnp.asarray(np.stack([s[key] for s in samples]))  # noqa: E731,E501
    shapes = jnp.asarray([s['img_shape'] for s in samples], jnp.float32)
    res = infer(variables, stack('img'), stack('cam_intrinsic'), shapes,
                shapes, jnp.asarray([s['flip'] for s in samples]),
                stack('img_dense_x2d'), stack('img_dense_x2d_mask'),
                jax.random.PRNGKey(0))
    return jtest.results_to_numpy(res, len(samples), cfg.num_classes)[1]


def test_evaluate_dataset_matches_jax_in_f64(tree, tmp_path, monkeypatch):
    """``tools.test_det.evaluate_dataset`` on the converted tree's 12 val
    frames (batches of 6) against the JAX CLI's loop (``inference_detector``
    with one jitted inference function, then ``dataset.evaluate``; see
    :func:`_jax_request` for the intrinsics), f64 on
    both sides, the smoke model on the same seeded weights (carried across
    by ``utils.convert.det_state_dict``), the RSLM init replaced on both
    sides by one deterministic stand-in. The submissions have the same
    tokens, classes and attributes, their boxes agree at 1e-4 relative
    (the serving tests' rule; in f64 far closer), and the metrics within
    1e-9."""
    cv2 = pytest.importorskip('cv2')
    jcfg, tcfg = jconfig.DetConfig.smoke(), tconfig.DetConfig.smoke()
    jmodel = japi.build_detector(jcfg, dtype=jnp.float64)
    v64 = _smoke_variables(jmodel, 0)
    jd, td = _datasets(tree, 'val')

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlm.RSLMSolver, 'solve', _jax_rslm_stand_in)
        infer = jax.jit(jtest.make_inference_fn(jmodel, jcfg))
        results = []
        for i in range(0, len(jd), 6):
            infos = jd.data_infos[i:i + 6]
            imgs = [cv2.imread(os.path.join(tree['root'], info['img_path']))[
                ..., ::-1] for info in infos]
            cams = [np.asarray(info['cam_intrinsic']) for info in infos]
            results.extend(dict(bbox_3d_results=p) for p in _jax_request(
                v64, jcfg, imgs, cams, infer))
    jm = jd.evaluate(results, str(tmp_path / 'jax'))

    tmodel = tapi.build_detector(tcfg).double().eval()
    tmodel.load_state_dict(det_state_dict(v64, tcfg), strict=True)
    monkeypatch.setattr(tlm.RSLMSolver, 'solve', _torch_rslm_stand_in)
    batches = []
    tm = ttest_det.evaluate_dataset(tmodel, tcfg, td, tree['root'],
                                    str(tmp_path / 'port'), batch_size=6,
                                    on_batch=batches.append)
    assert batches == [0, 1]

    with open(jm['result_path']) as f, open(tm['result_path']) as g:
        js, ts = json.load(f)['results'], json.load(g)['results']
    assert set(ts) == set(js) and len(ts) == 2
    n_boxes = 0
    for token in js:
        assert len(ts[token]) == len(js[token]), token
        for a, b in zip(ts[token], js[token]):
            for key in ('sample_token', 'detection_name', 'attribute_name'):
                assert a[key] == b[key], key
            for key in ('translation', 'size', 'rotation', 'velocity',
                        'detection_score'):
                np.testing.assert_allclose(a[key], b[key], rtol=1e-4,
                                           atol=1e-8, err_msg=key)
            n_boxes += 1
    assert n_boxes > 0
    assert_close(_without_path(jm), _without_path(tm), 1e-9)


def test_train_loop_checkpoint_loads_into_init_detector(tree, tmp_path):
    """The fault this slice repairs: ``det.main.train_loop`` writes
    ``latest.pt`` as ``{'state': ..., 'optimizer': ...}``, which the
    torch-file loader alone refuses (no backbone/neck/head keys at the top
    level). ``init_detector`` now recognises it by its ``state`` entry and
    loads the model strictly: one request through the loaded model gives
    the trained model's results bit for bit. One training step of the
    smoke config from the converted tree."""
    cfg = tconfig.DetConfig.smoke()
    td = tnus.NuScenes3DDataset(tree['train'], img_prefix=tree['root'])
    it = ttrain_det.make_batch_iter(td, cfg, tree['root'], crop=False)
    save = str(tmp_path / 'run')
    state = tmain.train_loop(cfg, lambda e: itertools.islice(it(e), 1), 1,
                             save, device='cpu', log_interval=1)
    assert int(state.step) == 1
    path = os.path.join(save, 'latest.pt')
    with pytest.raises(ValueError, match='no recognizable'):
        tapi.load_torch_weights(tapi.build_detector(cfg), cfg, path)
    loaded = tapi.init_detector(cfg, checkpoint=path, device='cpu')
    trained = state.model.eval()
    for k, v in trained.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    info = td.data_infos[0]
    img = ttrain_det.read_frame(os.path.join(tree['root'], info['img_path']))
    outs = []
    for m in (trained, loaded):
        infer = tapi.dtest.make_inference_fn(m, cfg, min_fcos_score=0.0)
        outs.append(tapi.inference_detector(
            m, cfg, [img, img[:, ::-1]], [info['cam_intrinsic']] * 2,
            infer_fn=infer, rng=torch.Generator().manual_seed(0))[1])
    n = 0
    for a_img, b_img in zip(*outs):
        for a, b in zip(a_img, b_img):
            np.testing.assert_array_equal(a, b)
            n += len(a)
    assert n > 0
    with open(path, 'rb') as f:
        assert 'state' in torch.load(f, map_location='cpu',
                                     weights_only=True)
