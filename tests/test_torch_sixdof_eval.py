"""The port's 6DoF evaluation path against the JAX package, on the CPU:
the EPnP inits (``sixdof.test.epnp_init_device`` / ``epnp_init_host``),
``infer_poses``' init choice, the host data pieces (``dataset.build_sample``
and ``collate``), checkpoint loading (``main.load_cdpn``) and
``main.test_loop`` with ``PoseEvaluator``'s metrics and its prediction
cache. Every tolerance is stated at its assertion.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.sixdof import dataset as jdataset
from epropnp_tpu.sixdof import main as jmain
from epropnp_tpu.sixdof import test as jtest
from epropnp_tpu.utils.checkpoint import save_checkpoint
from epropnp_tpu_torch.sixdof import config as tconfig
from epropnp_tpu_torch.sixdof import dataset as tdataset
from epropnp_tpu_torch.sixdof import main as tmain
from epropnp_tpu_torch.sixdof import test as ttest
from epropnp_tpu_torch.sixdof import train as ttrain
from epropnp_tpu_torch.utils.convert import cdpn_state_dict
from test_core_parity import make_problem
from test_sixdof_test_loop import StubTestDataset
from test_sixdof_train import tiny_cfg

torch.set_num_threads(1)


def _epnp_problem(noise, n, corrupt=False, seed=3):
    """``tests/test_epnp_device.py``'s problems, in f64: 6 objects seen
    from 4-8 m, pixel noise, and optionally the 30% lowest-confidence
    points moved by 500 px."""
    rng = np.random.default_rng(seed)
    p = make_problem(rng, bs=6, n=n, dof=6, noise=noise, outliers=0.0,
                     bounded=False)
    conf = np.ones((6, n))
    x2d = p['x2d'].copy()
    if corrupt:
        conf = np.random.default_rng(7).uniform(0.5, 1.0, (6, n))
        x2d[conf < np.quantile(conf, 0.3, axis=1, keepdims=True)] += 500.0
    return p['x3d'], x2d, conf, p['cam_mats'][0], p['pose']


def _eigh_with_canonical_signs(eigh):
    """``jnp.linalg.eigh`` whose eigenvectors are turned as the port turns
    the principal axes (largest entry positive)."""
    def wrapped(a, *args, **kwargs):
        w, v = eigh(a, *args, **kwargs)
        idx = jnp.argmax(jnp.abs(v), axis=-2, keepdims=True)
        pivot = jnp.take_along_axis(v, idx, axis=-2)
        return w, v * jnp.where(pivot < 0, -1.0, 1.0).astype(v.dtype)
    return wrapped


@pytest.mark.parametrize('noise,n,corrupt', [(0.0, 64, False),
                                             (0.5, 64, False),
                                             (0.0, 128, True)])
def test_epnp_init_device_matches_jax(noise, n, corrupt, monkeypatch):
    """f64 inputs on both sides (the arithmetic stays f64; the pose comes
    back as f32, as in JAX): the poses within 1e-8, compared as poses.
    The port fixes the sign of each principal axis of the control points
    (largest entry positive) where JAX keeps its LAPACK's; on noisy points
    the pose depends on that sign, so JAX's eigh is given the same rule
    (the 12x12 nullspace vector's sign is fixed by the mean depth either
    way). Noiseless and corrupted-but-masked problems recover the
    pose."""
    x3d, x2d, conf, cam, pose_gt = _epnp_problem(noise, n, corrupt)
    monkeypatch.setattr(jnp.linalg, 'eigh',
                        _eigh_with_canonical_signs(jnp.linalg.eigh))
    jpose = np.asarray(jtest.epnp_init_device(
        jnp.asarray(x3d), jnp.asarray(x2d), jnp.asarray(conf),
        jnp.asarray(cam)))
    t = torch.from_numpy
    tpose = ttest.epnp_init_device(t(x3d), t(x2d), t(conf), t(cam)).numpy()
    assert tpose.dtype == np.float32 and tpose.shape == (6, 7)
    np.testing.assert_allclose(tpose, jpose, rtol=0, atol=1e-8)
    if noise == 0.0:
        np.testing.assert_allclose(tpose[:, :3], pose_gt[:, :3], atol=0.05)
        dot = np.abs(np.sum(tpose[:, 3:] * pose_gt[:, 3:], -1))
        assert np.all(dot > np.cos(0.01))


def test_epnp_init_device_refined_matches_unpatched_jax():
    """The noisy problem against the JAX package as it is (its LAPACK's
    axis signs): the inits differ (by up to 7.7e-3 on 5 of the 6 objects,
    CPU), and the test-time Gauss-Newton refine (``make_refine_fn``, 3
    fast-mode iterations, f64 on both sides) brings each side's init to
    the same pose: within 1e-9 (3.7e-11 measured)."""
    x3d, x2d, conf, cam, _ = _epnp_problem(0.5, 64)
    w2d = np.repeat(conf[..., None], 2, -1)
    jinit = jtest.epnp_init_device(jnp.asarray(x3d), jnp.asarray(x2d),
                                   jnp.asarray(conf), jnp.asarray(cam))
    jpose = np.asarray(jtest.make_refine_fn(tiny_cfg(), jnp.asarray(cam))(
        jnp.asarray(x3d), jnp.asarray(x2d), jnp.asarray(w2d),
        jinit.astype(jnp.float64)))
    t = torch.from_numpy
    tinit = ttest.epnp_init_device(t(x3d), t(x2d), t(conf), t(cam))
    tcfg = tconfig.SixDoFConfig()
    assert tcfg.pnp.test_lm_num_iter == tiny_cfg().pnp.test_lm_num_iter
    tpose = ttest.make_refine_fn(tcfg, t(cam))(
        t(x3d), t(x2d), t(w2d), tinit.double()).numpy()
    np.testing.assert_allclose(tpose, jpose, rtol=0, atol=1e-9)


def test_epnp_init_device_keeps_f32_inputs_f32():
    """f32 inputs compute in f32 (``promote_types(f32, f32)``), as JAX's:
    both recover the noiseless pose to 1e-3."""
    x3d, x2d, conf, cam, pose_gt = _epnp_problem(0.0, 64)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    tpose = ttest.epnp_init_device(f32(x3d), f32(x2d), f32(conf),
                                   f32(cam)).numpy()
    jpose = np.asarray(jtest.epnp_init_device(
        *(jnp.asarray(a, jnp.float32) for a in (x3d, x2d, conf, cam))))
    for pose in (tpose, jpose):
        np.testing.assert_allclose(pose[:, :3], pose_gt[:, :3], atol=1e-3)


def test_epnp_init_host_matches_jax():
    """The host init (``cv2.solvePnP`` EPnP on the top-20% mask) gives
    JAX's poses; the only arithmetic of its own is the rotation vector's
    quaternion, f64 on both sides: within 1e-12."""
    pytest.importorskip('cv2')
    x3d, x2d, conf, cam, _ = _epnp_problem(0.5, 64, seed=4)
    conf = np.random.default_rng(2).uniform(0.2, 1.0, conf.shape)
    jpose = jtest.epnp_init_host(x3d, x2d, conf, cam)
    tpose = ttest.epnp_init_host(x3d, x2d, conf, cam)
    np.testing.assert_allclose(tpose, jpose, rtol=0, atol=1e-12)


def test_infer_poses_init_choice(monkeypatch):
    """An unknown init is refused; without cv2 the host init raises an
    ImportError that names ``init='epnp_device'`` (no silent switch)."""
    with pytest.raises(ValueError, match='epnp_device'):
        ttest.infer_poses(None, None, None, None, None, init='ransac')
    monkeypatch.setitem(sys.modules, 'cv2', None)
    x3d, x2d, conf, cam, _ = _epnp_problem(0.0, 16)
    with pytest.raises(ImportError, match="init='epnp_device'"):
        ttest.epnp_init_host(x3d, x2d, conf, cam)


def test_build_sample_and_collate_match_jax():
    """``dataset.build_sample`` (crop, coordinate normalisation, the
    translation targets) gives the JAX package's sample, array for array;
    ``collate`` stacks the same batch as float32 tensors."""
    pytest.importorskip('cv2')
    r = np.random.default_rng(0)
    rgb = r.integers(0, 255, (480, 640, 3)).astype(np.uint8)
    coor = r.uniform(-.05, .05, (480, 640, 3)).astype(np.float32)
    msk = (r.uniform(size=(480, 640)) > 0.5).astype(np.uint8) * 255
    pose = np.concatenate([np.eye(3), [[0.02], [-0.01], [0.7]]], 1)
    box = np.array([250.0, 180.0, 90.0, 110.0])
    ext = np.array([0.04, 0.05, 0.03], np.float32)
    kw = dict(split='test', denoise=True)
    jcfg, tcfg = tiny_cfg(), tconfig.SixDoFConfig(
        dataiter=tconfig.DataIterConfig(inp_res=64, out_res=16))
    js = jdataset.build_sample(jcfg, 'ape', rgb, coor, msk, pose, box, ext,
                               **kw)
    ts = tdataset.build_sample(tcfg, 'ape', rgb, coor, msk, pose, box, ext,
                               **kw)
    for f in ('inp', 'target_coor', 'mask', 'loss_msk', 'trans_local',
              'pose', 'c_box', 'box'):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                      err_msg=f)
    assert (ts.obj, ts.obj_id, ts.s_box) == (js.obj, js.obj_id, js.s_box)
    jb = jdataset.collate([js, js], {'ape': ext})
    tb = tdataset.collate([ts, ts], {'ape': ext})
    for f in ttrain.Batch._fields:
        assert getattr(tb, f).dtype == torch.float32
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


# -------------------------------------------------------------- test_loop

def _randomized(state, seed):
    """The JAX state with non-trivial BatchNorm statistics and affine
    parameters (default statistics give a near-constant noc map)."""
    r = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        x = np.asarray(x, np.float32)
        if name == 'var':
            return r.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == 'mean':
            return r.normal(0, 0.1, x.shape).astype(np.float32)
        if name == 'scale' and x.ndim == 1:
            return r.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x
    return state.replace(
        params=jax.tree_util.tree_map_with_path(leaf, state.params),
        batch_stats=jax.tree_util.tree_map_with_path(leaf,
                                                     state.batch_stats))


def _port_cfg():
    return tconfig.SixDoFConfig(
        dataiter=tconfig.DataIterConfig(inp_res=64, out_res=16,
                                        sample_points=32),
        pnp=tconfig.PnPConfig(mc_samples=32, num_iter=2, lm_num_iter=2,
                              rs_num_points=8, rs_num_proposals=2,
                              rs_num_iter=1))


def _models_and_diameters(ds):
    pts = np.random.default_rng(1).uniform(-.05, .05, (50, 3))
    return {c: pts for c in ds.classes}, {c: 0.1 for c in ds.classes}


@pytest.fixture(scope='module')
def jax_eval(tmp_path_factory):
    """JAX's ``test_loop`` with ``init='epnp_device'`` on the stub dataset
    of ``tests/test_sixdof_test_loop.py``, with JAX's eigh giving the
    port's axis signs; its state, also written as a msgpack train-state
    file. The random-weight model's correspondences are far from a rigid
    object, so the EPnP init there depends on the signs, and 3
    Gauss-Newton steps do not bring the two signs' inits together: with
    JAX's eigh unpatched, its poses lie up to 0.54 (rotation entries) from
    the port's (CPU)."""
    cfg = tiny_cfg()
    model, _, tx, _ = jmain.build_all(cfg)
    state = _randomized(jmain.init_state(cfg, model, tx), 0)
    ds = StubTestDataset()
    models, diameters = _models_and_diameters(ds)
    d = tmp_path_factory.mktemp('jax_eval')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp.linalg, 'eigh',
                   _eigh_with_canonical_signs(jnp.linalg.eigh))
        metrics = jmain.test_loop(cfg, ds, state, models, diameters,
                                  init='epnp_device', batch_size=4,
                                  cache_file=str(d / 'jax.npz'))
    path = save_checkpoint(str(d / 'state.msgpack'), state)
    return metrics, path, np.load(str(d / 'jax.npz')), state


def _assert_metrics_close(got, want, atol):
    assert set(got) == set(want) == {'pose', 'add', 'arp_2d'}
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for cls in want[name]:
            for key, value in want[name][cls].items():
                np.testing.assert_allclose(
                    np.asarray(got[name][cls][key], np.float64),
                    np.asarray(value, np.float64), rtol=0, atol=atol,
                    err_msg=f'{name}/{cls}/{key}')


def test_test_loop_matches_jax_and_caches(jax_eval, tmp_path):
    """The port's ``test_loop`` (``init='epnp_device'``) on the JAX state
    loaded from its msgpack file, on the same stub dataset, against the
    fixture's JAX run. The poses (f32 on both sides): rotation entries
    within 1e-3, translations within 2e-5 (3.4e-4 and 4e-6 measured; the
    model outputs agree to 6e-7, and the ill-posed problems of a
    random-weight model magnify f32 rounding: in f64 on the same outputs
    the two agree to 1e-10, ``test_infer_poses_epnp_device_matches_jax``).
    The metric dicts within 1e-6 (shares of thresholded errors). Then the
    prediction cache: a second run loads the ``.npz`` without touching
    the dataset and gives the same metrics; the orientation-density hook
    writes one image a sample."""
    jmetrics, path, jcache, _ = jax_eval
    cfg = _port_cfg()
    ds = StubTestDataset()
    models, diameters = _models_and_diameters(ds)
    cache = str(tmp_path / 'port.npz')
    metrics = tmain.test_loop(cfg, ds, path, models, diameters,
                              init='epnp_device', batch_size=4,
                              cache_file=cache, device='cpu')
    tcache = np.load(cache)
    np.testing.assert_array_equal(tcache['obj'], jcache['obj'])
    np.testing.assert_array_equal(tcache['pose_gt'], jcache['pose_gt'])
    assert tcache['pose_est'].shape == jcache['pose_est'].shape == (4, 3, 4)
    np.testing.assert_allclose(tcache['pose_est'][..., :3],
                               jcache['pose_est'][..., :3], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(tcache['pose_est'][..., 3],
                               jcache['pose_est'][..., 3], rtol=0, atol=2e-5)
    _assert_metrics_close(metrics, jmetrics, 1e-6)

    class Exploding(StubTestDataset):
        def __getitem__(self, i):
            raise AssertionError('a cache hit must skip inference')

    again = tmain.test_loop(cfg, Exploding(), path, models, diameters,
                            init='epnp_device', cache_file=cache,
                            device='cpu')
    _assert_metrics_close(again, metrics, 0.0)

    pytest.importorskip('cv2')
    dens = tmp_path / 'density'
    tmain.test_loop(cfg, ds, path, models, diameters, init='rslm',
                    batch_size=4, orient_density_dir=str(dens),
                    device='cpu', rng=torch.Generator().manual_seed(0))
    assert len(list(dens.glob('*.png'))) == len(ds)


def test_load_cdpn_from_jax_and_port_checkpoints(jax_eval, tmp_path):
    """``load_cdpn`` takes a JAX train-state file (through
    ``load_jax_variables`` and ``cdpn_state_dict``) and the port's own
    checkpoint (``save_checkpoint`` of a ``TrainState``): both give the
    same weights, bit for bit."""
    from epropnp_tpu_torch.utils.checkpoint import (load_jax_variables,
                                                    save_checkpoint as tsave)
    _, path, _, _ = jax_eval
    cfg = _port_cfg()
    from_jax = tmain.load_cdpn(cfg, path, device='cpu')
    want = cdpn_state_dict(load_jax_variables(path), 34, feat_hw=(2, 2))
    got = from_jax.state_dict()
    assert set(got) == set(want) and not from_jax.training
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    state = ttrain.TrainState(from_jax, ttrain.make_optimizer(
        cfg, from_jax, 1))
    pt = tsave(str(tmp_path / 'port.pt'), state)
    back = tmain.load_cdpn(cfg, pt, device='cpu').state_dict()
    for k, v in got.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_infer_poses_epnp_device_matches_jax(jax_eval, monkeypatch):
    """``infer_poses(init='epnp_device')`` (the EPnP init, the refine, the
    [R|t] decode and the translation head) on the JAX model's outputs of
    the stub batch, cast to f64 on both sides, JAX's eigh with the port's
    axis signs: the same rot- and trans-head poses within 1e-10."""
    from epropnp_tpu.models.cdpn import CDPN as JCDPN
    from epropnp_tpu_torch.models.cdpn import CDPNOutputs
    from epropnp_tpu_torch.sixdof import ref_constants as ref
    _, _, _, state = jax_eval
    monkeypatch.setattr(jnp.linalg, 'eigh',
                        _eigh_with_canonical_signs(jnp.linalg.eigh))
    cfg = tiny_cfg()
    ds = StubTestDataset()
    samples = [ds[i] for i in range(len(ds))]
    extents = {c: ds.min_extents(c) for c in ds.classes}
    jb = jdataset.collate(samples, extents)
    jouts = JCDPN(depth=cfg.network.back_layers_num).apply(
        {'params': state.params, 'batch_stats': state.batch_stats}, jb.inp,
        train=False)
    f64 = lambda a: np.array(a, np.float64)  # noqa: E731
    jouts = type(jouts)(*(jnp.asarray(f64(a)) for a in jouts))
    jb = type(jb)(*(jnp.asarray(f64(a)) for a in jb))
    box = np.stack([s.box[2:] for s in samples]).astype(np.float64)
    cam = np.asarray(ref.CAMERA_MATRIX, np.float64)
    jres = jtest.infer_poses(jouts, jb, jnp.asarray(box), jnp.asarray(cam),
                             cfg, init='epnp_device')
    t = lambda a: torch.from_numpy(f64(a))  # noqa: E731
    tres = ttest.infer_poses(
        CDPNOutputs(*(t(a) for a in jouts)),
        ttrain.Batch(*(t(a) for a in jb)),
        t(box), t(cam), _port_cfg(), init='epnp_device')
    assert tres.pose_est.dtype == torch.float64
    for got, want in ((tres.pose_est, jres.pose_est),
                      (tres.pose_est_trans, jres.pose_est_trans)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10)
