"""The port's Det serving from trained weights against the JAX package, on
the CPU: checkpoint loading (a JAX msgpack file, a torchvision backbone, a
full mmdet file), flip TTA, and the Monte Carlo scoring with the
orientation density.

The tiny EProPnPDet of ``tests/test_torch_det.py`` serves the msgpack and
TTA comparisons; the torch-file loaders are held against JAX's
``load_torch_variables`` on a ResNet-50-DCN with the tiny head (the JAX
converter takes bottleneck DCN backbones only), whose flax tree comes from
``jax.eval_shape``. Random draws are replayed: both packages' RSLM init is
replaced by one deterministic stand-in, and the port's AMIS draws are the
JAX run's samples. Every tolerance is stated at its assertion.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.det import api as japi
from epropnp_tpu.det import config as jconfig
from epropnp_tpu.det import test as jtest
from epropnp_tpu.ops import pnp as jpnp
from epropnp_tpu.ops.pnp import levenberg_marquardt as jlm
from epropnp_tpu.utils.checkpoint import save_checkpoint
from epropnp_tpu_torch.det import api as tapi
from epropnp_tpu_torch.det import config as tconfig
from epropnp_tpu_torch.det import test as ttest
from epropnp_tpu_torch.ops import pnp as tpnp
from epropnp_tpu_torch.ops.deform_conv import DeformConv
from epropnp_tpu_torch.ops.pnp import epropnp as tep
from epropnp_tpu_torch.ops.pnp import levenberg_marquardt as tlm
from epropnp_tpu_torch.ops.pnp import lm_kernel
from epropnp_tpu_torch.utils.convert import det_state_dict
from test_torch_det import (CAM_K, KPI, N_IMG, H, W, _cfgs,
                            _dense_matches_flax, _inputs, _overrides,
                            _randomize, _with_dcn_biases)

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def models():
    """The tiny flax model with randomised variables (f32) and its config
    pair."""
    jcfg, tcfg = _cfgs()
    jmodel = japi.build_detector(jcfg, **_overrides())
    variables = jax.jit(lambda k, x: jmodel.init(k, x, (H, W)))(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    return jmodel, _randomize(dict(variables), 1), tcfg


@pytest.mark.parametrize('dcn_bias', [False, True])
def test_init_detector_loads_jax_msgpack(models, tmp_path, dcn_bias):
    """A JAX-written msgpack file (the variables; with non-zero DCN biases
    the port switches ``dcn_bias`` on) loads through ``init_detector`` and
    gives the JAX model's dense outputs at 1e-4 of each output's largest
    entry (f32, the rule of ``test_det_dense_matches_flax``)."""
    jmodel, variables, tcfg = models
    if dcn_bias:
        variables = _with_dcn_biases(variables, 3)
    path = save_checkpoint(str(tmp_path / 'det.msgpack'),
                           {'params': variables['params'],
                            'batch_stats': variables['batch_stats']})
    assert not tcfg.dcn_bias
    tmodel = tapi.init_detector(tcfg, checkpoint=path, device='cpu',
                                **_overrides())
    dcns = [m for m in tmodel.modules() if isinstance(m, DeformConv)]
    assert dcns and all((m.bias is not None) == dcn_bias for m in dcns)
    _dense_matches_flax(jmodel, variables, tmodel)


# ------------------------------------------------------------ torch files

R50_OVERRIDES = dict(dcn_on_last_conv=True, detector_cfg=dict(
    feat_channels=32, emb_channels=32, cls_branch=(32,),
    centerness_branch=(16,), offset_branch=(32,), emb_branch=(32,)))


def _r50_cfgs(scale):
    def make(mod):
        return dataclasses.replace(_cfgs()[0 if mod is jconfig else 1],
                                   backbone_depth=50,
                                   dcn_modulation_scale=scale)
    return make(jconfig), make(tconfig)


def _jax_r50_variables(jcfg):
    """Flax variables of the ResNet-50-DCN model, shapes by eval_shape,
    values seeded (a DCN bias zero: mmcv's DCNs have none)."""
    jmodel = japi.build_detector(jcfg, **R50_OVERRIDES)
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, (H, W)),
                            jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    r = np.random.default_rng(11)

    def leaf(path, s):
        keys = [str(getattr(p, 'key', '')) for p in path]
        if keys[-1] == 'bias' and ('DeformConv_0' in keys or any(
                '_dcn' in k for k in keys)):
            return np.zeros(s.shape, np.float32)
        return r.normal(size=s.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _seeded_state(model, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) if v.is_floating_point()
                else v.clone()) for k, v in model.state_dict().items()}


@pytest.fixture(scope='module')
def r50_file(tmp_path_factory):
    """A full mmdet-named EProPnPDet checkpoint (``state_dict`` wrapper,
    ``module.`` prefixes) of the ResNet-50-DCN model, seeded."""
    _, tcfg = _r50_cfgs(1.0)
    sd = _seeded_state(tapi.build_detector(tcfg, **R50_OVERRIDES), 4)
    path = tmp_path_factory.mktemp('r50') / 'epropnp_det.pth'
    torch.save({'meta': {}, 'state_dict': {f'module.{k}': v
                                           for k, v in sd.items()}}, path)
    return str(path), sd


def test_full_mmdet_file_loads_as_jax_loads_it(r50_file):
    """``init_detector`` on the full file switches the modulation scale to
    1.0 (the file has mmcv offsets), loads every entry by name, and gives
    the state that JAX's ``load_torch_variables`` gives on the same file,
    mapped back by ``det_state_dict``: bit for bit."""
    path, sd = r50_file
    jcfg, tcfg = _r50_cfgs(2.0)
    assert tapi.torch_checkpoint_has_dcn_offsets(path)
    tmodel = tapi.init_detector(tcfg, checkpoint=path, device='cpu',
                                **R50_OVERRIDES)
    assert all(m.modulation_scale == 1.0 for m in tmodel.modules()
               if isinstance(m, DeformConv))
    got = tmodel.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)

    jcfg1, tcfg1 = _r50_cfgs(1.0)
    merged = japi.load_torch_variables(jcfg1, _jax_r50_variables(jcfg1),
                                       path, head_overrides=R50_OVERRIDES)
    back = det_state_dict(jax.tree_util.tree_map(np.asarray, merged), tcfg1)
    assert set(back) == set(got)
    for k, v in back.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_mmdet_backbone_and_neck_file_loads_as_jax_loads_it(r50_file,
                                                           tmp_path):
    """An mmdet backbone and neck checkpoint (``backbone.`` / ``neck.``
    entries only): those load by name, the head keeps its fresh values,
    and the loaded backbone and neck equal JAX's ``load_torch_variables``
    on the same file, mapped back by ``det_state_dict``: bit for bit."""
    _, sd = r50_file
    part = {k: v for k, v in sd.items()
            if k.startswith(('backbone.', 'neck.'))}
    path = str(tmp_path / 'backbone_neck.pth')
    torch.save({'state_dict': part}, path)
    jcfg, tcfg = _r50_cfgs(1.0)
    torch.manual_seed(1)
    model = tapi.build_detector(tcfg, **R50_OVERRIDES)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    tapi.load_torch_weights(model, tcfg, path)
    got = model.state_dict()
    for k, v in got.items():
        want = part[k] if k in part else fresh[k]
        np.testing.assert_array_equal(v.numpy(), want.numpy(), err_msg=k)
    merged = japi.load_torch_variables(jcfg, _jax_r50_variables(jcfg), path,
                                       head_overrides=R50_OVERRIDES)
    back = det_state_dict(jax.tree_util.tree_map(np.asarray, merged), tcfg)
    for k in part:
        if not k.endswith('num_batches_tracked'):
            np.testing.assert_array_equal(got[k].numpy(), back[k].numpy(),
                                          err_msg=k)


def test_torchvision_backbone_grafts_into_dcns(tmp_path):
    """A torchvision-named ResNet-50 file (top-level ``conv1.weight``,
    plain 3x3 convs, ``fc``): the backbone loads, the DCN stages' 3x3
    kernels become the DCN weights with a zero ``conv_offset``, the head
    keeps its values; the backbone equals JAX's graft of the same file."""
    _, tcfg = _r50_cfgs(2.0)
    zoo = {k[len('backbone.'):]: v for k, v in _seeded_state(
        tapi.build_detector(tcfg, **R50_OVERRIDES), 5).items()
        if k.startswith('backbone.') and 'conv_offset' not in k}
    zoo['fc.weight'] = torch.zeros(1000, 2048)
    zoo['fc.bias'] = torch.zeros(1000)
    path = str(tmp_path / 'resnet50.pth')
    torch.save(zoo, path)
    assert not tapi.torch_checkpoint_has_dcn_offsets(path)

    torch.manual_seed(0)
    model = tapi.build_detector(tcfg, **R50_OVERRIDES)
    with torch.no_grad():  # non-zero offsets, so the graft must zero them
        for m in model.modules():
            if isinstance(m, DeformConv):
                m.conv_offset.weight.normal_()
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    tapi.load_torch_weights(model, tcfg, path)
    got = model.state_dict()
    n_dcn = 0
    for name, m in model.named_modules():
        if isinstance(m, DeformConv) and name.startswith('backbone.'):
            n_dcn += 1
            np.testing.assert_array_equal(
                m.weight.detach().numpy(),
                zoo[name[len('backbone.'):] + '.weight'].numpy())
            assert not m.conv_offset.weight.any()
            assert not m.conv_offset.bias.any()
    assert n_dcn == 6 + 3  # every block of ResNet-50's stages 3 and 4
    for k in got:
        if k.startswith(('neck.', 'bbox_head.')):
            np.testing.assert_array_equal(got[k].numpy(), fresh[k].numpy())

    jcfg, tcfg_j = _r50_cfgs(2.0)
    merged = japi.load_torch_variables(jcfg, _jax_r50_variables(jcfg), path)
    back = det_state_dict(jax.tree_util.tree_map(np.asarray, merged), tcfg_j)
    for k, v in back.items():
        if k.startswith('backbone.'):
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=k)


def test_modulation_scale_guard_and_refusals(r50_file, tmp_path):
    """A file with mmcv offsets into a model at modulation scale 2.0 raises
    JAX's ``ValueError``, word for word; a file without recognisable keys
    and a shape mismatch raise too."""
    path, sd = r50_file
    jcfg, tcfg = _r50_cfgs(2.0)
    model = tapi.build_detector(tcfg, **R50_OVERRIDES)
    with pytest.raises(ValueError) as jerr:
        japi.load_torch_variables(jcfg, _jax_r50_variables(jcfg), path)
    with pytest.raises(ValueError) as terr:
        tapi.load_torch_weights(model, tcfg, path)
    assert str(terr.value) == str(jerr.value)
    assert 'dcn_modulation_scale=1.0' in str(terr.value)

    other = str(tmp_path / 'other.pth')
    torch.save({'encoder.weight': torch.zeros(3)}, other)
    with pytest.raises(ValueError, match='no recognizable'):
        tapi.load_torch_weights(model, tcfg, other)
    bad = str(tmp_path / 'bad.pth')
    torch.save({'backbone.conv1.weight': torch.zeros(64, 3, 3, 3)}, bad)
    with pytest.raises(ValueError, match='shape mismatch'):
        tapi.load_torch_weights(model, tcfg, bad)


# ------------------------------------------------------------------- TTA

def _jax_rslm_stand_in(self, x3d, x2d, w2d, camera, cost_fun, rng=None,
                       **kwargs):
    """The deterministic init of both packages: the center-based
    translation, yaw 0.3 (the 4DoF layout)."""
    t = self.center_based_init(x2d, x3d, camera)
    pose = jnp.concatenate([t, jnp.full(t.shape[:-1] + (1,), 0.3, t.dtype)],
                           -1)
    cost = jpnp.evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                             out_cost=True).cost
    return pose, None, cost


def _torch_rslm_stand_in(self, x3d, x2d, w2d, camera, cost_fun, rng=None,
                         **kwargs):
    t = self.center_based_init(x2d, x3d, camera)
    pose = torch.cat([t, torch.full(t.shape[:-1] + (1,), 0.3,
                                    dtype=t.dtype)], -1)
    cost = tpnp.evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                             out_cost=True).cost
    return pose, None, cost


def _tta_inputs():
    inp = _inputs(4)
    f64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
           for k, v in inp.items()}
    f64['img_flip'] = f64['img'][:, :, ::-1].copy()
    f64['x2d_flip'] = f64['x2d'][:, :, ::-1].copy()
    return f64


@pytest.fixture(scope='module')
def jax_tta(models):
    """JAX's TTA inference in f64 (the heads built with ``dtype=float64``;
    their default computes in f32) on ``_inputs(4)``, the RSLM init
    replaced by the stand-in."""
    _, variables, _ = models
    jmodel = japi.build_detector(_cfgs()[0], dtype=jnp.float64,
                                 **_overrides())
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                 variables)
    inp = _tta_inputs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlm.RSLMSolver, 'solve', _jax_rslm_stand_in)
        infer = jax.jit(jtest.make_tta_inference_fn(
            jmodel, _cfgs()[0], max_obj_per_img=KPI, min_fcos_score=0.0))
        res = infer(v64, *(jnp.asarray(inp[k]) for k in (
            'img', 'img_flip', 'cam', 'shapes', 'shapes', 'x2d', 'x2d_flip',
            'mask')), jax.random.PRNGKey(0))
        res = jax.tree_util.tree_map(np.asarray, res)
    return v64, res


@pytest.mark.parametrize('use_pallas', [False, True])
def test_tta_matches_jax_in_f64(models, jax_tta, use_pallas, monkeypatch):
    """The port's flip TTA against JAX's ``make_tta_inference_fn`` in f64
    on the same weights and inputs, with one deterministic RSLM init on
    both sides. ``use_pallas`` runs the solve through K1's twin. The
    validity, labels and image indices are equal; the boxes and the 3D
    scores agree at 1e-4 relative (the rule of the plain request's
    dimensions in ``test_inference_fn_end_to_end``; in f64 they agree far
    closer)."""
    _, variables, tcfg = models
    v64, jres = jax_tta
    tcfg = dataclasses.replace(tcfg, pnp=dataclasses.replace(
        tcfg.pnp, use_pallas=use_pallas))
    tmodel = tapi.build_detector(tcfg, **_overrides()).double().eval()
    tmodel.load_state_dict(det_state_dict(v64, tcfg), strict=True)
    monkeypatch.setattr(tlm.RSLMSolver, 'solve', _torch_rslm_stand_in)
    inp = _tta_inputs()
    t = torch.from_numpy
    infer = ttest.make_tta_inference_fn(tmodel, tcfg, max_obj_per_img=KPI,
                                        min_fcos_score=0.0)
    before = lm_kernel.launches
    tres = infer(t(inp['img']), t(inp['img_flip']), t(inp['cam']),
                 t(inp['shapes']), t(inp['shapes']), t(inp['x2d']),
                 t(inp['x2d_flip']), t(inp['mask']))
    assert lm_kernel.launches == before  # K1's twin on the CPU
    assert tres.bbox_3d.shape == (N_IMG * KPI, 7)
    for name in ('valid', 'labels', 'img_inds'):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      getattr(jres, name), err_msg=name)
    assert 0 < tres.valid.sum() < len(tres.valid)
    for name in ('bbox_3d', 'scores_3d', 'velo', 'attr'):
        np.testing.assert_allclose(getattr(tres, name).numpy(),
                                   getattr(jres, name), rtol=1e-4,
                                   atol=1e-8, err_msg=name)


def test_inference_detector_tta_flips_width(models):
    """``inference_detector(tta=True)`` hands the TTA function the images
    and x2d maps flipped along their width (NHWC axis 2), as the JAX API
    builds them."""
    seen = {}

    def spy(img, img_flip, cam, shapes, ori, x2d, x2d_flip, mask, rng=None):
        seen.update(img=img, img_flip=img_flip, x2d=x2d, x2d_flip=x2d_flip)
        k = 3
        z = torch.zeros(k)
        return ttest.DetResults(torch.zeros(k, 7), torch.zeros(k, 4), z, z,
                                z.long(), z.long(), None, None, z.bool())
    img = np.random.default_rng(0).uniform(0, 255, (48, 80, 3))
    out2d, out3d = tapi.inference_detector(_Dummy(),
                                           models[2], [img], [CAM_K],
                                           infer_fn=spy, tta=True)
    assert torch.equal(seen['img_flip'], torch.flip(seen['img'], [2]))
    assert torch.equal(seen['x2d_flip'], torch.flip(seen['x2d'], [2]))
    assert not torch.equal(seen['img'], seen['img_flip'])
    assert len(out3d) == 1 and all(len(a) == 0 for a in out3d[0])


class _Dummy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))


# ------------------------------------------------ MC scoring and density

def _mc_problem():
    """The problem of ``tests/test_det_extras.py``: 4 objects of 16 points
    seen from 5-9 m, in f64."""
    r = np.random.default_rng(0)
    n, pts = 4, 16
    x3d = r.uniform(-.5, .5, (n, pts, 3))
    pose = np.concatenate([r.uniform(-1, 1, (n, 2)), r.uniform(5, 9, (n, 1)),
                           r.uniform(-3, 3, (n, 1))], -1)
    return x3d, pose, np.broadcast_to(CAM_K, (n, 3, 3)).copy()


def test_mc_score_and_orient_density_matches_jax(models, monkeypatch):
    """``mc_score_and_orient_density`` in f64 against JAX's, the RSLM init
    replaced by the stand-in on both sides and the port's AMIS draws the
    JAX run's samples: the orientation log-density within 1e-10, the
    Monte Carlo 3D score within 1e-6 (the AMIS rule of
    ``tests/test_torch_epropnp.py``); the density integrates to 1."""
    tcfg = models[2]
    jcfg = _cfgs()[0]
    x3d, pose, cams = _mc_problem()
    score_3d = np.array([0.2, 0.5, 0.7, 0.9])
    kw = dict(mc_scoring_ratio=0.5, orient_bins=32)

    def jax_run():
        camera = jpnp.PerspectiveCamera(cam_mats=jnp.asarray(cams))
        x2d, _ = camera.project(jnp.asarray(x3d), jnp.asarray(pose))
        w2d = jnp.full(x2d.shape, 1.0 / x3d.shape[1])
        cost_fun = jpnp.AdaptiveHuberPnPCost(relative_delta=0.5).set_param(
            x2d, w2d)
        out = jtest.mc_score_and_orient_density(
            jcfg, jnp.asarray(x3d), x2d, w2d, camera, cost_fun,
            jnp.asarray(pose), jax.random.PRNGKey(0),
            score_3d=jnp.asarray(score_3d), **kw)
        return np.asarray(x2d), {k: np.asarray(v) for k, v in out.items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlm.RSLMSolver, 'solve', _jax_rslm_stand_in)
        x2d, jout = jax_run()

    monkeypatch.setattr(tlm.RSLMSolver, 'solve', _torch_rslm_stand_in)
    pnp = ttest.build_test_pnp(tcfg)
    assert pnp.normalize  # the draws are made around the centred points
    _, _, jsamples = tpnp.common.pnp_normalize(
        torch.from_numpy(x3d), torch.from_numpy(jout['pose_samples'].copy()))
    jsamples = jsamples.reshape(pnp.num_iter, -1, *jsamples.shape[1:])
    calls = []

    def replay(trans_distr, rot_distr, num, gen):
        calls.append(num)
        return jsamples[len(calls) - 1].clone()

    monkeypatch.setattr(tep, 'draw_pose_samples', replay)
    t = torch.from_numpy
    camera = tpnp.PerspectiveCamera(cam_mats=t(cams))
    w2d = torch.full(x2d.shape, 1.0 / x3d.shape[1], dtype=torch.float64)
    cost_fun = tpnp.AdaptiveHuberPnPCost(relative_delta=0.5).set_param(
        t(x2d), w2d)
    out = ttest.mc_score_and_orient_density(
        tcfg, t(x3d), t(x2d), w2d, camera, cost_fun, t(pose),
        torch.Generator().manual_seed(0), score_3d=t(score_3d), **kw)
    assert calls == [pnp.mc_samples // pnp.num_iter] * pnp.num_iter
    np.testing.assert_allclose(out['orient_logprob'].numpy(),
                               jout['orient_logprob'], rtol=0, atol=1e-10)
    np.testing.assert_allclose(out['score_3d'].numpy(), jout['score_3d'],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out['pose_sample_weights'].numpy(),
                               jout['pose_sample_weights'], rtol=0,
                               atol=1e-6)
    integral = np.exp(out['orient_logprob'].numpy()).sum(1) * (
        2 * np.pi / 32)
    np.testing.assert_allclose(integral, 1.0, rtol=1e-3)
