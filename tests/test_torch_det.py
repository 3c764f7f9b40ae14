"""The port's Det serving slice against the JAX package, on the CPU.

A tiny EProPnPDet (ResNet-18, DCN in the FCOS towers, 32-wide head, 64x64
input, the v1b head options) runs in float32 in both packages with the
same weights, moved from the flax variables by
``utils.convert.det_state_dict``. Pieces are compared on the same inputs
(numpy ``default_rng``): the dense outputs, ``get_preds`` (ties included),
the subheads, the 4DoF solve from a fixed init, the NMS keep masks, and
the whole inference function. Every tolerance is stated at its assertion.
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.core.bbox_3d import misc as jmisc
from epropnp_tpu.core.bbox_3d import nms as jnms
from epropnp_tpu.det import config as jconfig
from epropnp_tpu.det import pipelines as jpipelines
from epropnp_tpu.det import test as jtest
from epropnp_tpu.det.api import build_detector as jbuild_detector
from epropnp_tpu.models.dense_heads.fcos_emb_head import (
    FCOSLevelOutputs as JLevel)
from epropnp_tpu.ops import pnp as jpnp
from epropnp_tpu.utils.torch_convert import det_model_variables
from epropnp_tpu_torch.core.bbox_3d import misc as tmisc
from epropnp_tpu_torch.core.bbox_3d import nms as tnms
from epropnp_tpu_torch.det import api as tapi
from epropnp_tpu_torch.det import config as tconfig
from epropnp_tpu_torch.det import pipelines as tpipelines
from epropnp_tpu_torch.det import test as ttest
from epropnp_tpu_torch.models.dense_heads.fcos_emb_head import (
    FCOSLevelOutputs as TLevel)
from epropnp_tpu_torch.ops import pnp as tpnp
from epropnp_tpu_torch.ops.pnp import lm_kernel
from epropnp_tpu_torch.utils.convert import (
    det_state_dict, det_variables, flax_tree_has_dcn_bias)
from epropnp_tpu_torch.utils.synthetic import make_pnp_problem

torch.set_num_threads(1)
H = W = 64
N_IMG = 2
KPI = 24  # objects per image (the 64x64 pyramid has 85 points x 3 classes)
CAM_K = np.array([[60., 0., W / 2], [0., 60., H / 2], [0., 0., 1.]])


def _overrides():
    return dict(backbone_dcn_stages=(), dcn_on_last_conv=True,
                detector_cfg=dict(
                    feat_channels=32, emb_channels=32, cls_branch=(32,),
                    centerness_branch=(16,), offset_branch=(32,),
                    emb_branch=(32,)))


def _cfgs(use_pallas=False):
    def make(mod):
        return mod.DetConfig(
            num_classes=3, backbone_depth=18, embed_dims=32, num_heads=4,
            num_points=4, strides=(8, 16, 32, 64), output_stride=8,
            use_cls_emb=True, offset_cls_agnostic=False, num_attrs=4,
            pnp=mod.DetPnPConfig(rs_num_points=4, rs_num_proposals=8,
                                 use_pallas=use_pallas))
    return make(jconfig), make(tconfig)


def _randomize(variables, seed):
    """BatchNorm statistics and affine parameters, the DCN offset convs
    (offsets of a pixel or so) and the class embeddings are drawn anew; a
    DCN bias stays 0 (mmcv's DCN has none; :func:`_with_dcn_biases` draws
    them for a model built with ``dcn_bias``). Leaves come out f32, except
    that a bf16 leaf (the DCN kernel of a bf16 module) stays bf16: as f32
    it would turn the JAX model's bf16 DCN into an f32 one."""
    r = np.random.default_rng(seed)

    def leaf(path, x):
        keys = [str(getattr(p, 'key', '')) for p in path]
        dtype = x.dtype if x.dtype == jnp.bfloat16 else np.float32
        x = np.asarray(x, np.float32)
        if keys[-1] == 'var':
            x = r.uniform(0.5, 1.5, x.shape)
        elif keys[-1] == 'mean':
            x = r.normal(0, 0.1, x.shape)
        elif keys[-1] == 'scale' and x.ndim == 1:
            x = r.uniform(0.5, 1.5, x.shape)
        elif 'conv_offset' in keys or keys[-1] == 'cls_emb':
            x = r.normal(0, 0.05, x.shape)
        return np.asarray(jnp.asarray(x, np.float32).astype(dtype))
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _is_dcn_bias(path):
    keys = [str(getattr(p, 'key', '')) for p in path]
    return keys[-1] == 'bias' and ('DeformConv_0' == keys[-2]
                                   or '_dcn' in keys[-2])


def _with_dcn_biases(variables, seed, scale=0.05):
    """``variables`` with every DCN bias drawn from N(0, scale), in the
    leaf's dtype; every other leaf as it was."""
    r = np.random.default_rng(seed)

    def leaf(path, x):
        if not _is_dcn_bias(path):
            return x
        return np.asarray(jnp.asarray(r.normal(0, scale, x.shape),
                                      np.float32).astype(x.dtype))
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope='module')
def models():
    jcfg, tcfg = _cfgs()
    jmodel = jbuild_detector(jcfg, **_overrides())
    variables = jax.jit(lambda k, x: jmodel.init(k, x, (H, W)))(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    variables = _randomize(dict(variables), 1)
    tmodel = tapi.init_detector(tcfg, device='cpu', **_overrides())
    tmodel.load_state_dict(det_state_dict(variables, tcfg), strict=True)
    return jmodel, variables, tmodel


def _inputs(seed):
    r = np.random.default_rng(seed)
    img = r.normal(size=(N_IMG, H, W, 3)).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    x2d = np.stack([xs, ys], -1)[None].repeat(N_IMG, 0)
    return dict(img=img, cam=np.broadcast_to(CAM_K, (N_IMG, 3, 3)).astype(
                    np.float32),
                shapes=np.full((N_IMG, 2), H, np.float32),
                flips=np.array([False, True]), x2d=x2d,
                mask=np.ones((N_IMG, H, W, 1), np.float32))


def _apply_dense(jmodel, variables, img):
    return jmodel.apply(variables, img, (H, W), train=False,
                        method=jmodel.det_dense)


# one jit per flax module (kept alive here, so its id stays its own): a
# model compiles once per dtype of its variables, whatever their values
_DENSE_JITS = {}


def _jax_dense(jmodel, variables, img):
    if id(jmodel) not in _DENSE_JITS:
        _DENSE_JITS[id(jmodel)] = (jmodel, jax.jit(
            lambda v, x: _apply_dense(jmodel, v, x)))
    return _DENSE_JITS[id(jmodel)][1](variables, jnp.asarray(img))


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _close_to_max(a, b, rtol):
    """max|a - b| <= rtol * max|b| (f32 sums in another order)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * np.abs(b).max() + 1e-30


def _dense_matches_flax(jmodel, variables, tmodel):
    img = _inputs(2)['img']
    jouts, jkey, jvalue = _jax_dense(jmodel, variables, img)
    with torch.no_grad():
        touts, tkey, tvalue = tmodel.det_dense(torch.from_numpy(img), (H, W))
    # f32 through ~40 layers of random weights on both sides: 1e-4 of
    # each tensor's largest entry
    for jo, to in zip(jouts, touts):
        for name in JLevel._fields:
            _close_to_max(getattr(to, name).numpy(), getattr(jo, name), 1e-4)
    _close_to_max(tkey.numpy(), jkey, 1e-4)
    _close_to_max(tvalue.numpy(), jvalue, 1e-4)


def test_det_dense_matches_flax(models):
    _dense_matches_flax(*models)


@pytest.fixture(scope='module')
def biased_models(models):
    """``models``' flax tree with non-zero DCN biases (the FCOS towers'),
    and the port built with ``dcn_bias=True`` from it."""
    jmodel, variables, _ = models
    variables = _with_dcn_biases(variables, 3)
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, dcn_bias=True)
    tmodel = tapi.init_detector(tcfg, device='cpu', **_overrides())
    tmodel.load_state_dict(det_state_dict(variables, tcfg), strict=True)
    return jmodel, variables, tmodel


def test_det_dense_matches_flax_with_dcn_bias(models, biased_models):
    """A flax tree whose DCNs have a bias (as a JAX-trained one) loads
    into the port built with ``dcn_bias=True`` and gives flax's dense
    outputs at the same 1e-4 rule."""
    jmodel, variables, tmodel = biased_models
    assert flax_tree_has_dcn_bias(variables)
    assert not flax_tree_has_dcn_bias(models[1])
    biases = [m.bias for m in tmodel.modules()
              if type(m).__name__ == 'DeformConv']
    assert biases and all(b is not None and b.abs().max() > 0.01
                          for b in biases)
    _dense_matches_flax(jmodel, variables, tmodel)


def test_det_state_dict_refuses_dcn_bias_without_flag(biased_models):
    """Without ``dcn_bias`` (mmcv's layout) a non-zero flax DCN bias has
    nowhere to go: the converter refuses it and names the field."""
    _, variables, _ = biased_models
    _, tcfg = _cfgs()
    assert not tcfg.dcn_bias
    with pytest.raises(ValueError, match='dcn_bias'):
        det_state_dict(variables, tcfg)


def _jax_preds(jmodel, variables, outs, kpi=KPI):
    def run(v, o):
        det = jmodel.bind(v).head.detector
        return det.get_preds(o, extra_maps=[[x.obj_emb for x in o],
                                            [x.center for x in o]],
                             max_obj_per_img=kpi, min_fcos_score=0.0)
    return jax.jit(run)(variables, outs)


def _torch_preds(tmodel, outs, kpi=KPI):
    return tmodel.bbox_head.detector.get_preds(
        outs, extra_maps=[[x.obj_emb for x in outs], [x.center for x in outs]],
        max_obj_per_img=kpi, min_fcos_score=0.0)


def test_get_preds_and_subheads_match_flax(models):
    """Both packages select from the same dense outputs (JAX's), so the
    top-k picks the same objects; the subheads then see identical
    inputs."""
    jmodel, variables, tmodel = models
    inp = _inputs(3)
    jouts, jkey, jvalue = _jax_dense(jmodel, variables, inp['img'])
    jp = _jax_preds(jmodel, variables, jouts)
    touts = tuple(TLevel(*_to_torch(tuple(o))) for o in jouts)
    with torch.no_grad():
        tp = _torch_preds(tmodel, touts)
    for name in ('img_inds', 'point_inds', 'labels', 'valid'):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    # the same sigmoid products of the same logits: f32 rounding only
    for name in ('score', 'strides', 'points'):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   rtol=1e-6, atol=1e-7)
    for a, b in zip(tp['gathered'], jp['gathered']):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    args = (jp['gathered'][1], jp['gathered'][0], jkey, jvalue,
            jtest.avg_pool_stride(jnp.asarray(inp['x2d']), 8),
            jtest.avg_pool_stride(jnp.asarray(inp['mask']), 8),
            jp['strides'], jp['img_inds'], jp['labels'],
            jnp.asarray(inp['flips']), jnp.asarray(inp['shapes']))
    jsub = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method=jmodel.subheads))(variables, *args)
    with torch.no_grad():
        tsub = tmodel.subheads(*_to_torch(args))
    # f32, a few small dense layers and softmaxes: 1e-4 of the largest
    # entry of each output
    for name in ('query', 'scale', 'score_pred', 'dim_enc', 'dim_dec',
                 'velo', 'attr', 'x2d'):
        _close_to_max(getattr(tsub, name).numpy(), getattr(jsub, name), 1e-4)
    for a, b in zip(tsub.noc_list + tsub.w2d_list,
                    jsub.noc_list + jsub.w2d_list):
        _close_to_max(a.numpy(), b, 1e-4)


def test_get_preds_breaks_ties_as_jax(models):
    """All scores tied: ``jax.lax.top_k`` takes the lowest indices first;
    the port's stable descending sort must pick the same objects."""
    jmodel, variables, tmodel = models
    shapes = [(8, 8), (4, 4), (2, 2), (1, 1)]
    outs = []
    for (h, w), s in zip(shapes, (8, 16, 32, 64)):
        z = np.zeros((N_IMG, h, w, 1), np.float32)
        cls = np.zeros((N_IMG, h, w, 3), np.float32)
        cls[1, 0, 0, 2] = 1.0  # one distinct score in image 1
        pts = np.stack(np.meshgrid(np.arange(w) * s, np.arange(h) * s),
                       -1).reshape(-1, 2).astype(np.float32)
        outs.append((cls, np.zeros((N_IMG, h, w, 6), np.float32), z,
                     np.zeros((N_IMG, h, w, 32), np.float32), pts))
    jp = _jax_preds(jmodel, variables, tuple(JLevel(*map(jnp.asarray, o))
                                             for o in outs))
    with torch.no_grad():
        tp = _torch_preds(tmodel, tuple(TLevel(*map(torch.from_numpy, o))
                                        for o in outs))
    for name in ('point_inds', 'labels'):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    assert tp['point_inds'][KPI] == 0 and tp['labels'][KPI] == 2


@pytest.mark.parametrize('use_pallas', [False, True])
def test_4dof_solve_from_fixed_init_matches_jax(use_pallas):
    """EProPnP4DoF's deterministic solve (normalised points, image-shape
    bounds, 5 fast Gauss-Newton steps) from a fixed ``pose_init``; the
    port runs the plain path or the K1 twin, JAX the jnp solver."""
    p = make_pnp_problem(16, 32, 8, dof=4, init_noise=(0.05, 0.1),
                         focal=(600.0, 600.0))
    f = {k: v.astype(np.float32) for k, v in p.items()}
    ori = np.tile([[480., 640.]], (16, 1)).astype(np.float32)
    kw = dict(mc_samples=64, num_iter=4, normalize=True)

    def run(mod, cast, solver_kw):
        pnp = mod.EProPnP4DoF(solver=mod.LMSolver(
            dof=4, num_iter=5, normalize=True, **solver_kw), **kw)
        camera = mod.PerspectiveCamera.from_img_shape(
            cast(f['cams']), cast(ori), z_min=0.1, allowed_border=20.0)
        cost = mod.AdaptiveHuberPnPCost(relative_delta=0.5).set_param(
            cast(f['x2d']), cast(f['w2d']))
        return pnp(cast(f['x3d']), cast(f['x2d']), cast(f['w2d']), camera,
                   cost, pose_init=cast(f['pose0']), fast_mode=True)[0]

    jpose = np.asarray(run(jpnp, jnp.asarray, {}))
    before = lm_kernel.launches
    tpose = run(tpnp, torch.from_numpy, dict(use_pallas=use_pallas)).numpy()
    assert lm_kernel.launches == before
    # f32; the JAX kernel tests' tolerances (tests/test_pallas_lm.py)
    np.testing.assert_allclose(tpose[:, :3], jpose[:, :3], rtol=0, atol=5e-4)
    np.testing.assert_allclose(tpose[:, 3], jpose[:, 3], rtol=0, atol=2e-4)


def _random_boxes(seed, n_img=3, k=20):
    r = np.random.default_rng(seed)
    xy = r.uniform(0, 100, (n_img * k, 2))
    wh = r.uniform(5, 40, (n_img * k, 2))
    boxes2d = np.concatenate([xy, xy + wh], -1)
    b3d = np.concatenate([r.uniform(1, 5, (n_img * k, 3)),
                          r.uniform(-10, 10, (n_img * k, 1)),
                          r.uniform(-1, 1, (n_img * k, 1)),
                          r.uniform(5, 30, (n_img * k, 1)),
                          r.uniform(-np.pi, np.pi, (n_img * k, 1)),
                          r.uniform(0, 1, (n_img * k, 1))], -1)
    return (boxes2d, r.uniform(0, 1, n_img * k), r.uniform(size=n_img * k)
            > 0.2, b3d, r.integers(0, 3, n_img * k))


@pytest.mark.parametrize('seed', [0, 1])
def test_nms_keep_masks_match_jax(seed):
    """f64 on both sides: the keep masks are equal."""
    boxes2d, scores, valid, b3d, labels = _random_boxes(seed)
    t = torch.from_numpy
    jk = jax.jit(lambda b, s, v: jnms.nms_axis_aligned_per_image(
        b, s, 0.3, 3, valid_mask=v))(jnp.asarray(boxes2d),
                                     jnp.asarray(scores), jnp.asarray(valid))
    tk = tnms.nms_axis_aligned_per_image(t(boxes2d), t(scores), 0.3, 3,
                                         valid_mask=t(valid))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jb = jax.jit(lambda b, g: jmisc.batched_bev_nms_per_image(
        b, g, 3, nms_thr=0.1))(jnp.asarray(b3d), jnp.asarray(labels))
    tb = tmisc.batched_bev_nms_per_image(t(b3d), t(labels), 3, nms_thr=0.1)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert 0 < tb.sum() < len(tb) and 0 < tk.sum() < valid.sum()
    jbox, jmask = jax.jit(jmisc.bboxes_3d_to_2d)(
        jnp.asarray(b3d[:, :7]), jnp.asarray(np.broadcast_to(CAM_K, (60, 3,
                                                                     3))),
        jnp.full((60, 2), 64.0))
    tbox, tmask = tmisc.bboxes_3d_to_2d(
        t(b3d[:, :7]), t(np.broadcast_to(CAM_K, (60, 3, 3)).copy()),
        torch.full((60, 2), 64.0, dtype=torch.float64))
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


@pytest.fixture(scope='module')
def jax_results(models):
    """JAX's inference function (the jnp solver) on ``_inputs(4)``."""
    jmodel, variables, _ = models
    inp = _inputs(4)
    return jax.jit(lambda v, *a: jtest.make_inference_fn(
        jmodel, _cfgs()[0], max_obj_per_img=KPI, min_fcos_score=0.0)(
        v, *a))(
        variables, jnp.asarray(inp['img']), jnp.asarray(inp['cam']),
        jnp.asarray(inp['shapes']), jnp.asarray(inp['shapes']),
        jnp.asarray(inp['flips']), jnp.asarray(inp['x2d']),
        jnp.asarray(inp['mask']), jax.random.PRNGKey(0))


@pytest.mark.parametrize('use_pallas', [False, True])
def test_inference_fn_end_to_end(models, jax_results, use_pallas):
    """The whole inference function in both packages: the same shapes, the
    same objects and dimensions, finite boxes for the live objects. Poses
    are not compared: the RSLM draws of the two frameworks differ."""
    _, _, tmodel = models
    tcfg = _cfgs(use_pallas)[1]
    inp = _inputs(4)
    jres = jax_results
    infer = ttest.make_inference_fn(tmodel, tcfg, max_obj_per_img=KPI,
                                    min_fcos_score=0.0)
    t = torch.from_numpy
    tres = infer(t(inp['img']), t(inp['cam']), t(inp['shapes']),
                 t(inp['shapes']), t(inp['flips']), t(inp['x2d']),
                 t(inp['mask']), rng=torch.Generator().manual_seed(0))
    for name in ttest.DetResults._fields:
        assert tuple(getattr(tres, name).shape) == tuple(
            getattr(jres, name).shape), name
    np.testing.assert_array_equal(tres.labels.numpy(), np.asarray(jres.labels))
    np.testing.assert_array_equal(tres.img_inds.numpy(),
                                  np.asarray(jres.img_inds))
    # dim_dec = exp of a small head's output: 1e-4 relative
    np.testing.assert_allclose(tres.bbox_3d[:, :3].numpy(),
                               np.asarray(jres.bbox_3d)[:, :3], rtol=1e-4)
    live = tres.valid.numpy()
    assert live.any()
    assert np.isfinite(tres.bbox_3d.numpy()[live]).all()
    assert np.isfinite(tres.bbox_2d.numpy()[live]).all()
    out2d, out3d = ttest.results_to_numpy(tres, N_IMG, 3)
    assert sum(len(c) for im in out3d for c in im) == live.sum()


def _round_trip_v1b(dcn_bias):
    """The v1b structure at full width (ResNet-101 with DCN in stages 3-4,
    FPN 256, 8 heads x 16 points): flax tree (shapes from eval_shape,
    seeded values; the DCN biases zero, or drawn where the port is built
    with ``dcn_bias``) -> ``det_state_dict`` -> ``load_state_dict(strict)``
    -> ``det_model_variables`` and the port's ``det_variables`` -> the
    same leaves, bit for bit."""
    jcfg = jconfig.DetConfig.v1b()
    tcfg = dataclasses.replace(tconfig.DetConfig.v1b(), dcn_bias=dcn_bias)
    jmodel = jbuild_detector(jcfg)
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, (64, 64)),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    r = np.random.default_rng(5)

    def leaf(path, s):
        if _is_dcn_bias(path) and not dcn_bias:  # mmcv's DCNs have none
            return np.zeros(s.shape, np.float32)
        return r.normal(size=s.shape).astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
    assert flax_tree_has_dcn_bias(variables) == dcn_bias
    tmodel = tapi.build_detector(tcfg)
    tmodel.load_state_dict(det_state_dict(variables, tcfg), strict=True)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    assert sum(k.endswith('conv2.bias') for k in sd) == (26 if dcn_bias
                                                          else 0)
    flat_b = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    for back in (det_model_variables(sd, depth=101, dcn_stages=(3, 4),
                                     num_fpn_laterals=3, num_fpn_extra=2),
                 det_variables(sd, tcfg)):
        flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
        assert len(flat_a) == len(flat_b)
        for path, value in flat_a:
            np.testing.assert_array_equal(np.asarray(value), flat_b[path],
                                          err_msg=str(path))


def test_det_state_dict_round_trips_at_v1b():
    _round_trip_v1b(dcn_bias=False)


def test_det_state_dict_round_trips_at_v1b_with_dcn_bias():
    _round_trip_v1b(dcn_bias=True)


def test_api_refuses_what_is_not_ported():
    """Built with every serving option of ``v1b_serving`` mapped (no
    option refused); what stays unported is refused: the int8 DCN
    (forward only) under autograd. (Checkpoint loading and flip TTA are
    ported: ``tests/test_torch_det_serving.py`` holds them against JAX.)"""
    _, tcfg = _cfgs()
    serving = dataclasses.replace(
        tcfg, bf16_backbone=True, bf16_dense=True, int8_dcn_gather=True,
        level_packed_towers=True)
    model = tapi.build_detector(serving, **_overrides())
    assert model.backbone.dtype == torch.bfloat16
    assert model.neck.dtype == torch.bfloat16
    det = model.bbox_head.detector
    assert det.level_packed and det.dense_dtype == torch.bfloat16
    assert model.bbox_head.dense_dtype == torch.bfloat16
    assert det.cls_convs[-1].conv.int8_gather
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(NotImplementedError, match='forward only'):
        model.det_dense(torch.zeros(1, H, W, 3), (H, W))


@pytest.mark.parametrize('hw,crop_box', [((90, 160), (0, 22, 160, 90)),
                                         ((45, 70), None)])
def test_inference_pipeline_matches_jax(hw, crop_box):
    """The host pipeline's inference stages give the JAX pipeline's arrays
    exactly (a sky-band crop to a stride multiple, and a padded frame)."""
    img = np.random.default_rng(9).uniform(0, 255, hw + (3,)).astype(
        np.float32)
    k = np.eye(3)
    j = jpipelines.default_pipeline(dict(img=img.copy(), cam_intrinsic=k),
                                    training=False, crop_box=crop_box)
    t = tpipelines.default_pipeline(dict(img=img.copy(), cam_intrinsic=k),
                                    training=False, crop_box=crop_box)
    for key in ('img', 'img_dense_x2d', 'img_dense_x2d_mask'):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    for key in ('img_shape', 'ori_shape', 'flip', 'pad_shape'):
        assert tuple(np.atleast_1d(t[key])) == tuple(np.atleast_1d(j[key]))


SERVING_FLAGS = dict(bf16_backbone=True, bf16_dense=True,
                     level_packed_towers=True, int8_dcn_gather=True)


@pytest.fixture(scope='module')
def serving_models():
    """The tiny model with the four serving options on, in both packages,
    and JAX's f32 model, all on one set of weights: the serving tree keeps
    its bf16 DCN leaves, the f32 tree is that tree cast to f32 (exact)."""
    jcfg, tcfg = _cfgs()
    jcfg_s = dataclasses.replace(jcfg, **SERVING_FLAGS)
    tcfg_s = dataclasses.replace(tcfg, pnp=dataclasses.replace(
        tcfg.pnp, use_pallas=True), **SERVING_FLAGS)
    jmodel_s = jbuild_detector(jcfg_s, **_overrides())
    variables = jax.jit(lambda k, x: jmodel_s.init(k, x, (H, W)))(
        jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)))
    variables = _randomize(dict(variables), 2)
    assert any(a.dtype == jnp.bfloat16
               for a in jax.tree_util.tree_leaves(variables))
    variables32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                         variables)
    tmodel = tapi.init_detector(tcfg_s, device='cpu', **_overrides())
    tmodel.load_state_dict(det_state_dict(variables, tcfg_s), strict=True)
    return (jbuild_detector(jcfg, **_overrides()), variables32, jmodel_s,
            variables, tmodel, tcfg_s)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _serving_rule(port, ref32, jax_serving, name):
    """The port's serving path against JAX's f32 model: an RMS distance of
    at most 1.5x that of JAX's own bf16 + level-packed model, plus the
    int8 budget, 1e-2 of the output's largest entry (JAX drops the int8
    gather on the CPU, ``deform_conv.py:102-104``, while the port's twin
    quantizes). RMS, not the largest entry: two bf16 paths that round at
    other places land 0.5-2x apart in max|d| on a single output of this
    tiny model, and their RMS distances agree far better."""
    port, ref32, jax_serving = (np.asarray(a, np.float32)
                                for a in (port, ref32, jax_serving))
    assert port.shape == ref32.shape, name
    limit = 1.5 * _rms(jax_serving - ref32) + 1e-2 * np.abs(ref32).max()
    assert _rms(port - ref32) <= limit, (name, _rms(port - ref32), limit)


def test_serving_dense_matches_flax(serving_models):
    """The dense outputs (FCOS levels, key, value) of the serving path:
    bf16 backbone, FPN and dense stage, int8 DCN sampling, level-packed
    towers."""
    jmodel, variables32, jmodel_s, variables, tmodel, _ = serving_models
    img = _inputs(2)['img']
    ref = _jax_dense(jmodel, variables32, img)
    jser = _jax_dense(jmodel_s, variables, img)
    with torch.no_grad():
        got = tmodel.det_dense(torch.from_numpy(img), (H, W))
    flat = lambda d: [a for o in d[0] for a in o] + list(d[1:])  # noqa: E731
    for i, (p, r, j) in enumerate(zip(flat(got), flat(ref), flat(jser))):
        assert p.dtype == torch.float32
        _serving_rule(p.numpy(), r, j, i)


def test_serving_detections_match_flax(serving_models):
    """The whole inference function of the serving model (K1's twin on
    the CPU) against JAX's f32 model and JAX's serving model. bf16 swaps
    near-tied candidates inside each image's top-k (JAX's own serving
    model moves ~30% of the labels by position), so the candidates are
    compared per image as sets: the same count of each class, and the
    sorted scores, 3D scores and box dimensions under the serving rule.
    Poses are not compared: the RSLM draws differ."""
    jmodel, variables32, jmodel_s, variables, tmodel, tcfg_s = serving_models
    inp = _inputs(4)
    args = [jnp.asarray(inp[k]) for k in ('img', 'cam', 'shapes', 'shapes',
                                          'flips', 'x2d', 'mask')]

    def run_jax(model, v):
        return jax.jit(lambda v, *a: jtest.make_inference_fn(
            model, _cfgs()[0], max_obj_per_img=KPI, min_fcos_score=0.0)(
            v, *a))(v, *args, jax.random.PRNGKey(0))
    ref, jser = run_jax(jmodel, variables32), run_jax(jmodel_s, variables)
    infer = ttest.make_inference_fn(tmodel, tcfg_s, max_obj_per_img=KPI,
                                    min_fcos_score=0.0)
    t = torch.from_numpy
    before = lm_kernel.launches
    got = infer(t(inp['img']), t(inp['cam']), t(inp['shapes']),
                t(inp['shapes']), t(inp['flips']), t(inp['x2d']),
                t(inp['mask']), rng=torch.Generator().manual_seed(0))
    assert lm_kernel.launches == before  # K1's twin on the CPU
    np.testing.assert_array_equal(got.img_inds.numpy(),
                                  np.asarray(ref.img_inds))

    def per_image(a):
        return np.asarray(a).reshape((N_IMG, KPI) + np.shape(a)[1:])
    hist = lambda lab: [np.bincount(x, minlength=3)  # noqa: E731
                        for x in per_image(lab)]
    np.testing.assert_array_equal(hist(got.labels.numpy()), hist(ref.labels))
    srt = lambda a: np.sort(per_image(a), 1)  # noqa: E731
    for name in ('scores', 'scores_3d'):
        _serving_rule(srt(getattr(got, name).numpy()),
                      srt(getattr(ref, name)), srt(getattr(jser, name)),
                      name)
    _serving_rule(srt(got.bbox_3d[:, :3].numpy()),
                  srt(np.asarray(ref.bbox_3d)[:, :3]),
                  srt(np.asarray(jser.bbox_3d)[:, :3]), 'dims')
    live = got.valid.numpy()
    assert live.any() and np.isfinite(got.bbox_3d.numpy()[live]).all()


def test_det_state_dict_takes_v1b_serving_tree():
    """A ``v1b_serving`` flax tree at full width holds bf16 DCN kernels
    (``deform_conv.py:96-100``): ``det_state_dict`` casts them to f32
    (exact), the strict load takes them, and ``det_model_variables`` of
    the port's state dict gives every leaf back (bf16 leaves as their f32
    values)."""
    jcfg = jconfig.DetConfig.v1b_serving()
    tcfg = tconfig.DetConfig.v1b_serving()
    jmodel = jbuild_detector(jcfg)
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, (64, 64)),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    r = np.random.default_rng(6)

    def leaf(path, s):
        keys = [str(getattr(p, 'key', '')) for p in path]
        if ('DeformConv_0' in keys[-2:] or '_dcn' in keys[-2]) \
                and keys[-1] == 'bias':
            return np.zeros(s.shape, s.dtype)  # mmcv's DCNs have no bias
        return np.asarray(jnp.asarray(r.normal(size=s.shape), s.dtype))
    variables = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
    n_bf16 = sum(a.dtype == jnp.bfloat16
                 for a in jax.tree_util.tree_leaves(variables))
    assert n_bf16 >= 2 * (26 + 2)  # kernel and bias of every DCN
    tmodel = tapi.build_detector(tcfg)
    tmodel.load_state_dict(det_state_dict(variables, tcfg), strict=True)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    back = det_model_variables(sd, depth=101, dcn_stages=(3, 4),
                               num_fpn_laterals=3, num_fpn_extra=2)
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert len(flat_a) == len(flat_b)
    for path, value in flat_a:
        np.testing.assert_array_equal(
            np.asarray(value), np.asarray(flat_b[path], np.float32),
            err_msg=str(path))
