"""The port's 6DoF data path against the JAX package, on the CPU: the
synthetic LineMOD generator (``sixdof.synthetic``), ``LineMODDataset``'s
batches on one tree (DZI, background substitution, coordinate denoising:
equal array for array), the pipeline with cv2 blocked, the host prefetch
(``parallel.prefetch``; ``train_loop(prefetch=2)`` equals ``prefetch=0``
bit for bit), the config overrides, and the 6DoF CLIs end to end on a
4-frame tree. Every tolerance is stated at its assertion.

The CLI and training-loop cases write CDPN checkpoints (~0.3 GB each at
64x64 crops) and remove them when they end.
"""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from epropnp_tpu.sixdof import config as jconfig
from epropnp_tpu.sixdof import dataset as jdataset
from epropnp_tpu.sixdof import synthetic as jsynthetic
from epropnp_tpu.utils import config_override as joverride
from epropnp_tpu_torch.parallel.prefetch import (BackgroundIterator,
                                                 prefetch_to_device)
from epropnp_tpu_torch.sixdof import config as tconfig
from epropnp_tpu_torch.sixdof import dataset as tdataset
from epropnp_tpu_torch.sixdof import main as tmain
from epropnp_tpu_torch.sixdof import synthetic as tsynthetic
from epropnp_tpu_torch.sixdof import train as ttrain
from epropnp_tpu_torch.tools import test_6dof, train_6dof
from epropnp_tpu_torch.tools import validate_6dof_synthetic
from epropnp_tpu_torch.utils import config_override as toverride
from epropnp_tpu_torch.utils import image_ops

cv2 = pytest.importorskip('cv2')
torch.set_num_threads(1)


def _tiny_cfg(pkg, **pnp):
    return pkg.SixDoFConfig(
        dataiter=pkg.DataIterConfig(inp_res=64, out_res=16,
                                    sample_points=32),
        network=pkg.NetworkConfig(back_layers_num=18),
        pnp=pkg.PnPConfig(mc_samples=16, num_iter=2, lm_num_iter=2,
                          rs_num_points=8, rs_num_proposals=2, rs_num_iter=1,
                          **pnp),
        train=pkg.TrainConfig(lr_epoch_step=(), end_epoch=1,
                              train_batch_size=2))


@pytest.fixture(scope='module')
def jax_tree(tmp_path_factory):
    """A tree from JAX's generator (cv2's PNGs): 6 train, 4 test frames."""
    root = str(tmp_path_factory.mktemp('jax_tree'))
    info = jsynthetic.generate_dataset(root, n_train=6, n_test=4,
                                       pts_per_face=48, seed=5)
    return root, info


def _backgrounds(root):
    """A flat background directory: two cv2 PNGs of other sizes."""
    bg = os.path.join(root, 'bg')
    os.makedirs(bg, exist_ok=True)
    r = np.random.default_rng(9)
    for i, hw in enumerate(((120, 160), (375, 500))):
        cv2.imwrite(os.path.join(bg, f'{i}.png'),
                    r.integers(0, 256, hw + (3,)).astype(np.uint8))
    return bg


# ---------------------------------------------------------- the generator

def test_generate_dataset_matches_jax(tmp_path):
    """The same seed gives the same tree: masks, poses and boxes equal,
    rgb equal but for the pixels filled by the hole fill (at most 1 level:
    the fill's f32 box blur sums in another order), coordinates within 1e-6
    absolute."""
    jroot, troot = str(tmp_path / 'j'), str(tmp_path / 't')
    kw = dict(n_train=3, n_test=2, pts_per_face=32, seed=2)
    assert jsynthetic.generate_dataset(jroot, **kw) == \
        tsynthetic.generate_dataset(troot, **kw)
    for split, n in (('real_train', 3), ('real_test', 2)):
        for i in range(n):
            def load(root, sub, ext):
                return os.path.join(root, split, 'ape', sub, f'{i:06d}{ext}')
            jm = cv2.imread(load(jroot, 'mask', '.png'), cv2.IMREAD_GRAYSCALE)
            np.testing.assert_array_equal(
                image_ops.read_png(load(troot, 'mask', '.png'), gray=True), jm)
            jc = np.load(load(jroot, 'coord', '.npy'))
            tc = np.load(load(troot, 'coord', '.npy'))
            np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
            jr = cv2.imread(load(jroot, 'rgb', '.png'))[..., ::-1]
            tr = image_ops.read_png(load(troot, 'rgb', '.png'))
            diff = np.abs(tr.astype(int) - jr).max(-1)
            # rgb is a function of the coordinates (and the same noise):
            # where they are equal (every pixel but the filled holes) so is
            # the rgb
            assert diff.max() <= 1 and not diff[(tc == jc).all(-1)].any()
            for sub in ('pose', 'box'):
                np.testing.assert_array_equal(
                    np.loadtxt(load(troot, sub, '.txt')),
                    np.loadtxt(load(jroot, sub, '.txt')))


def test_render_frame_fills_holes_as_jax(monkeypatch):
    """One splat with pin-holes (24 points a face): the closed mask and the
    filled coordinates equal JAX's (coordinates within 1e-6 absolute, rgb
    within 1 level)."""
    ext = np.array([0.038, 0.039, 0.046], np.float32)
    pts = tsynthetic.cuboid_surface(ext, 24)
    rot, trans = tsynthetic.random_pose(np.random.default_rng(4))
    blurs = []
    monkeypatch.setattr(tsynthetic, 'box_blur3',
                        lambda a: blurs.append(a) or image_ops.box_blur3(a))
    fj = jsynthetic.render_frame(pts, ext, rot, trans,
                                 rng=np.random.default_rng(1))
    ft = tsynthetic.render_frame(pts, ext, rot, trans,
                                 rng=np.random.default_rng(1))
    assert len(blurs) == 2  # the hole fill ran
    np.testing.assert_array_equal(ft['mask'], fj['mask'])
    np.testing.assert_allclose(ft['coord'], fj['coord'], rtol=0, atol=1e-6)
    assert np.abs(ft['rgb'].astype(int) - fj['rgb']).max() <= 1
    for k in ('box', 'pose'):
        np.testing.assert_array_equal(ft[k], fj[k])


# --------------------------------------------------------------- datasets

@pytest.mark.parametrize('split', ['train', 'test'])
def test_linemod_batches_match_jax(jax_tree, split, monkeypatch):
    """``LineMODDataset.batches`` of both packages on one tree with the same
    seeds, equal array for array: the train split with DZI, background
    substitution (PNG backgrounds, ratio 0.5) and denoising; the test
    split with the box crop."""
    root, info = jax_tree
    kw = dict(split=split, classes=['ape'], model_info=info, seed=3)
    if split == 'train':
        kw.update(bg_dir=_backgrounds(root), change_bg_ratio=0.5)
    read = []
    monkeypatch.setattr(tdataset, 'read_background',
                        lambda p: read.append(p) or image_ops.read_png(p))
    jd = jdataset.LineMODDataset(_tiny_cfg(jconfig), root, **kw)
    td = tdataset.LineMODDataset(_tiny_cfg(tconfig), root, **kw)
    assert len(td) == len(jd) and td._bg_files == jd._bg_files
    n = 0
    for jb, tb in zip(jd.batches(2, seed=7), td.batches(2, seed=7)):
        for f in ttrain.Batch._fields:
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)),
                                          err_msg=f'{split} {f}')
        n += 1
    assert n == len(jd) // 2
    assert bool(read) == (split == 'train')  # backgrounds were substituted


def test_pipeline_without_cv2(tmp_path, monkeypatch):
    """With cv2 blocked, the port writes a tree, indexes it, builds
    batches (PNG backgrounds included) and runs a ``train_loop`` step on
    the CPU; a JPEG background raises an error naming the file and cv2."""
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    root = str(tmp_path / 'lm')
    info = tsynthetic.generate_dataset(root, n_train=2, n_test=1,
                                       pts_per_face=24, seed=1)
    bg = os.path.join(root, 'bg')
    os.makedirs(bg)
    image_ops.write_png(os.path.join(bg, 'a.png'),
                        np.full((60, 80, 3), 90, np.uint8))
    cfg = _tiny_cfg(tconfig, use_pallas=True)
    ds = tdataset.LineMODDataset(cfg, root, classes=['ape'], model_info=info,
                                 bg_dir=bg, change_bg_ratio=1.0)
    batch = next(ds.batches(2))
    assert batch.inp.shape == (2, 64, 64, 3)
    assert all(torch.isfinite(a).all() for a in batch)
    steps = []
    tmain.train_loop(cfg, ds, str(tmp_path / 'run'), device='cpu',
                     on_step=lambda e, i, m: steps.append(m))
    shutil.rmtree(tmp_path / 'run')
    assert len(steps) == 1 and torch.isfinite(steps[0]['loss'])
    with open(os.path.join(bg, 'b.jpg'), 'wb') as f:
        f.write(b'\xff\xd8\xff\xe0 not decoded')
    with pytest.raises(RuntimeError, match=r'b\.jpg.*cv2'):
        tdataset.read_background(os.path.join(bg, 'b.jpg'))


def test_read_background_formats(tmp_path):
    """A PNG by the port's reader, a ``.npy`` array by numpy and a JPEG by
    cv2: each as ``cv2.imread`` + ``COLOR_BGR2RGB`` gives it."""
    img = np.random.default_rng(2).integers(0, 256, (30, 40, 3)).astype(
        np.uint8)
    for name in ('a.png', 'a.jpg'):
        path = str(tmp_path / name)
        cv2.imwrite(path, img)
        np.testing.assert_array_equal(tdataset.read_background(path),
                                      cv2.imread(path)[..., ::-1])
    np.save(str(tmp_path / 'a.npy'), img)
    np.testing.assert_array_equal(
        tdataset.read_background(str(tmp_path / 'a.npy')), img)


# ---------------------------------------------------------------- prefetch

def test_background_iterator_order_and_errors():
    assert list(BackgroundIterator(iter(range(50)), maxsize=2)) == \
        list(range(50))

    def failing():
        yield 1
        yield 2
        raise KeyError('producer failed')
    it = BackgroundIterator(failing(), maxsize=1)
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(KeyError, match='producer failed'):
        next(it)


def test_prefetch_to_device_on_the_cpu():
    """Batches of numpy arrays or tensors, plain or named tuples, come out
    in order as tensors with the same values and types."""
    r = np.random.default_rng(0)
    src = [ttrain.Batch(*(r.normal(size=(2, 3)).astype(np.float32)
                          for _ in ttrain.Batch._fields)) for _ in range(5)]
    src.append(tuple(torch.arange(4.0) + k for k in range(3)))
    out = list(prefetch_to_device(iter(src), depth=2, device='cpu'))
    assert len(out) == len(src)
    for a, b in zip(src, out):
        assert type(b) is type(a)
        for x, y in zip(a, b):
            assert isinstance(y, torch.Tensor) and y.device.type == 'cpu'
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    with pytest.raises(ValueError):
        next(prefetch_to_device(iter(src), depth=0, device='cpu'))


def test_train_loop_prefetch_equals_synchronous(tmp_path):
    """``train_loop(prefetch=2)`` and ``prefetch=0`` on a 4-frame tree: the
    same steps, bit for bit (losses, parameters, optimizer state)."""
    root = str(tmp_path / 'lm')
    info = tsynthetic.generate_dataset(root, n_train=4, n_test=1,
                                       pts_per_face=24, seed=3)
    cfg = _tiny_cfg(tconfig, use_pallas=True)
    runs = []
    for prefetch in (2, 0):
        ds = tdataset.LineMODDataset(cfg, root, classes=['ape'],
                                     model_info=info, seed=4)
        seen = []
        save = str(tmp_path / f'run{prefetch}')
        state = tmain.train_loop(cfg, ds, save, device='cpu', seed=1,
                                 prefetch=prefetch,
                                 on_step=lambda e, i, m: seen.append(
                                     {k: v.clone() for k, v in m.items()}))
        shutil.rmtree(save)
        runs.append((seen, state.state_dict()))
    (m2, s2), (m0, s0) = runs
    assert len(m2) == len(m0) == 2
    for a, b in zip(m2, m0):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k

    def flat(tree, prefix=''):
        if isinstance(tree, torch.Tensor):
            yield prefix, tree
        elif isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f'{prefix}/{k}')
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from flat(v, f'{prefix}/{i}')
    f2, f0 = dict(flat(s2)), dict(flat(s0))
    assert f2.keys() == f0.keys() and len(f2) > 100
    for k in f2:
        assert torch.equal(f2[k], f0[k]), k


# ----------------------------------------------------------------- configs

def test_config_overrides_match_jax():
    updates = {'pnp.lm_num_iter': 7, 'train.train_batch_size': 8,
               'dataiter.out_res': 32, 'exp_id': 'x'}
    for name in ('epropnp_basic', 'epropnp_reg_loss'):
        j = joverride.override(getattr(jconfig.SixDoFConfig, name)(),
                               updates)
        t = toverride.override(getattr(tconfig.SixDoFConfig, name)(),
                               updates)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    schedule = [(5, {'pnp.num_iter': 2}), (1, {'loss.mc_loss_weight': 0.5})]
    js, ts = (joverride.ScheduledOverrides(schedule),
              toverride.ScheduledOverrides(schedule))
    jc, tc = jconfig.SixDoFConfig(), tconfig.SixDoFConfig()
    for step in (0, 1, 3, 5, 9):
        jc, jchanged = js.maybe_apply(jc, step)
        tc, tchanged = ts.maybe_apply(tc, step)
        assert tchanged == jchanged
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


# -------------------------------------------------------------------- CLIs

@dataclasses.dataclass(frozen=True)
class _SmallCrops(tconfig.SixDoFConfig):
    """The tools' configs at 64x64 crops (16x16 maps): the CLI path as
    ``--smoke`` runs it, with a 4x smaller translation head to write."""
    dataiter: tconfig.DataIterConfig = dataclasses.field(
        default_factory=lambda: tconfig.DataIterConfig(inp_res=64,
                                                       out_res=16))


def _models_dir(root, info):
    """``models/models_info.txt`` and ``obj_01.ply`` (mm), as the JAX
    drill writes them."""
    i = info['ape']
    os.makedirs(os.path.join(root, 'models'))
    with open(os.path.join(root, 'models', 'models_info.txt'), 'w') as f:
        f.write('1: ' + ', '.join(f'{k}: {i[k] * 1e3:.2f}' for k in (
            'diameter', 'min_x', 'min_y', 'min_z')) + '\n')
    pts = tsynthetic.cuboid_surface(
        np.abs([i['min_x'], i['min_y'], i['min_z']]).astype(np.float32),
        6) * 1e3
    with open(os.path.join(root, 'models', 'obj_01.ply'), 'w') as f:
        f.write(f'ply\nformat ascii 1.0\nelement vertex {len(pts)}\n'
                'property float x\nproperty float y\nproperty float z\n'
                'end_header\n')
        f.writelines(f'{p[0]:.3f} {p[1]:.3f} {p[2]:.3f}\n' for p in pts)


def _finite(metrics):
    return all(np.isfinite(np.asarray(v, np.float64)).all()
               for m in metrics.values() for per_cls in m.values()
               for v in per_cls.values())


def test_train_then_test_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``train_6dof --smoke --device cpu`` on a 4-frame tree writes
    ``latest.pt``; ``test_6dof --smoke`` evaluates it with
    ``--init epnp_device`` and ``rslm``: finite metrics and the JSON of
    their means printed."""
    monkeypatch.setattr(train_6dof, 'SixDoFConfig', _SmallCrops)
    monkeypatch.setattr(test_6dof, 'SixDoFConfig', _SmallCrops)
    root = str(tmp_path / 'lm')
    info = tsynthetic.generate_dataset(root, n_train=4, n_test=4,
                                       pts_per_face=24, seed=0)
    _models_dir(root, info)
    save = str(tmp_path / 'run')
    try:
        state = train_6dof.main(['--data', root, '--save', save, '--smoke',
                                 '--batch-size', '2', '--epochs', '1',
                                 '--device', 'cpu'])
        assert int(state.step) == 2
        ckpt = os.path.join(save, 'latest.pt')
        assert os.path.isfile(ckpt)
        for init in ('epnp_device', 'rslm'):
            capsys.readouterr()
            metrics = test_6dof.main(['--data', root, '--checkpoint', ckpt,
                                      '--smoke', '--init', init,
                                      '--batch-size', '2', '--device',
                                      'cpu'])
            assert set(metrics) == {'pose', 'add', 'arp_2d'}
            assert _finite(metrics), init
            printed = json.loads(capsys.readouterr().out)
            assert set(printed['add']['mean']) == {'0.02', '0.05', '0.10',
                                                   'auc'}
    finally:
        shutil.rmtree(save, ignore_errors=True)


def test_validate_cli_on_the_cpu(tmp_path, capsys):
    """``validate_6dof_synthetic`` at 64x64 on 4 + 2 frames, one epoch,
    ``--init epnp_device``, the set kept as tensors: its JSON line with
    finite ADD accuracies."""
    save = str(tmp_path / 'run')
    try:
        out = validate_6dof_synthetic.main([
            '--root', str(tmp_path / 'lm'), '--save-dir', save,
            '--frames', '4', '--test-frames', '2', '--epochs', '1', '--bs',
            '2', '--inp-res', '64', '--init', 'epnp_device',
            '--device', 'cpu'])
    finally:
        shutil.rmtree(save, ignore_errors=True)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert out['best_ckpt'] == 'checkpoint_000.pt'
    assert np.isfinite([*out['add_untrained'].values(),
                        *out['add_best'].values()]).all()


def test_data_parallel_is_refused(capsys, monkeypatch):
    """``--data-parallel`` runs, but a global batch that does not divide
    over the ranks (32 over a WORLD_SIZE of 3) is refused before any data
    is read."""
    monkeypatch.setenv('WORLD_SIZE', '3')
    with pytest.raises(SystemExit):
        train_6dof.main(['--data', '/nonexistent', '--data-parallel'])
    assert 'must divide' in capsys.readouterr().err
