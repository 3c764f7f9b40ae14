"""The pieces of the port's Det training step against the JAX package, on
the CPU in float64, on seeded numpy inputs: the VolumeCenter targets, the
FCOS targets and losses, the object sampler with replayed draws, RoI Align,
the cross-RoI ops, each Det loss, the projection helpers and the
reprojection-error coder. Values at rtol 1e-12 (the same f64 arithmetic in
another order); gradients of the RoI ops and the mixture NLL at 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.core.bbox_3d import center_target as jct
from epropnp_tpu.core.bbox_3d import coders as jcoders
from epropnp_tpu.core.bbox_3d import misc as jmisc
from epropnp_tpu.models.dense_heads import deform_pnp_head as jhead
from epropnp_tpu.models.dense_heads.fcos_emb_head import (
    FCOSEmbHead as JFCOS, level_points as jlevel_points)
from epropnp_tpu.models.losses import det_losses as jl
from epropnp_tpu.ops import inter_roi_ops as jroi_ops
from epropnp_tpu.ops.roi_align import roi_align as jroi_align
from epropnp_tpu_torch.core.bbox_3d import center_target as tct
from epropnp_tpu_torch.core.bbox_3d import coders as tcoders
from epropnp_tpu_torch.core.bbox_3d import misc as tmisc
from epropnp_tpu_torch.models.dense_heads import deform_pnp_head as thead
from epropnp_tpu_torch.models.dense_heads.fcos_emb_head import (
    FCOSEmbHead as TFCOS)
from epropnp_tpu_torch.models.losses import det_losses as tl
from epropnp_tpu_torch.ops import inter_roi_ops as troi_ops
from epropnp_tpu_torch.ops.roi_align import roi_align as troi_align
from epropnp_tpu_torch.utils.synthetic import make_det_batch

torch.set_num_threads(1)
RTOL = 1e-12


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(port.detach() if isinstance(
        port, torch.Tensor) else port), np.asarray(ref), rtol=rtol,
        atol=atol)


def _batch(seed=0, n_img=2, h=64, w=64):
    b = make_det_batch(seed, n_img, h, w, gmax=6, n_valid=4)
    return {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in b.items()}


def test_volume_center_matches_jax():
    b = _batch(1)
    n_img, gmax = b['gt_labels'].shape
    g = n_img * gmax
    b3d = b['gt_bboxes_3d'].reshape(g, 7)
    b3d[~b['gt_mask'].reshape(-1)] = [1., 1., 1., 0., 0., 10., 0.]
    args = (b['gt_bboxes'].reshape(g, 4), b3d,
            np.repeat(np.arange(n_img), gmax),
            b['img_dense_x2d'][:, 2::4, 2::4], b['img_dense_x2d_mask'][:, ::4,
                                                                      ::4],
            b['cam_intrinsic'])
    mask = b['gt_mask'].reshape(-1)
    for kw in (dict(), dict(occlusion_factor=0.5, get_bbox_2d=True)):
        ref = jct.VolumeCenter(output_stride=4, **kw).get_centers_2d(
            *(jnp.asarray(a) for a in args), obj_mask=jnp.asarray(mask))
        out = tct.VolumeCenter(output_stride=4, **kw).get_centers_2d(
            *(_t(a) for a in args), obj_mask=_t(mask))
        assert np.asarray(ref.valid_mask).sum() >= 4
        np.testing.assert_array_equal(out.valid_mask.numpy(),
                                      np.asarray(ref.valid_mask))
        _close(out.centers_2d, ref.centers_2d)
        _close(out.bboxes_2d, ref.bboxes_2d)


def _fcos_pair(offset_cls_agnostic):
    kw = dict(num_classes=3, strides=(8, 16, 32),
              regress_ranges=((-1, 16), (16, 32), (32, 1e8)),
              offset_cls_agnostic=offset_cls_agnostic)
    return JFCOS(**kw), TFCOS(in_channels=8, feat_channels=8,
                              emb_channels=8, cls_branch=(8,),
                              centerness_branch=(8,), offset_branch=(8,),
                              emb_branch=(8,), **kw)


@pytest.mark.parametrize('offset_cls_agnostic', [True, False])
def test_fcos_targets_and_loss_match_jax(offset_cls_agnostic):
    b = _batch(2)
    jdet, tdet = _fcos_pair(offset_cls_agnostic)
    pts = [np.asarray(jlevel_points(64 // s, 64 // s, s, jnp.float64))
           for s in (8, 16, 32)]
    r = np.random.default_rng(3)
    centers = b['gt_bboxes'][..., :2] + r.uniform(0, 8, (2, 6, 2))
    args = (b['gt_bboxes'], b['gt_labels'], b['gt_mask'], centers)
    ref = jdet.get_targets([jnp.asarray(p) for p in pts],
                           *(jnp.asarray(a) for a in args))
    out = tdet.get_targets([_t(p) for p in pts], *(_t(a) for a in args))
    for o, rf in zip(out, ref):
        _close(o, rf)
    labels = np.asarray(ref[0]).reshape(-1)
    assert (labels < 3).sum() >= 4, 'some points must be foreground'
    n = labels.shape[0]
    c2 = 2 if offset_cls_agnostic else 6
    flat = (r.normal(size=(n, 3)), r.normal(size=(n, c2)) * 8 + 32,
            r.normal(size=(n,)))
    gt_inds = (np.asarray(ref[2]) + np.arange(2)[:, None] * 6).reshape(-1)
    rest = (labels, gt_inds, np.asarray(ref[1]).reshape(-1),
            centers.reshape(-1, 2), b['gt_bboxes'].reshape(-1, 4))
    jloss = jdet.loss(*(jnp.asarray(a) for a in flat + rest))
    tloss = tdet.loss(*(_t(a) for a in flat + rest))
    assert jloss.keys() == tloss.keys()
    for k in jloss:
        _close(tloss[k], jloss[k])


def test_obj_sampler_with_replayed_draws_matches_jax(monkeypatch):
    r = np.random.default_rng(4)
    n, num_gt, s = 200, 6, 16
    fg = r.uniform(size=n) < 0.4
    ctr = r.uniform(size=n)
    gt_inds = r.integers(0, num_gt, n)
    ref = jhead.obj_sampler(jax.random.PRNGKey(0), s, jnp.asarray(fg),
                            jnp.asarray(ctr), jnp.asarray(gt_inds), num_gt)
    inds = np.asarray(ref[0])
    monkeypatch.setattr(thead, 'draw_object_samples',
                        lambda gen, fg_mask, prob, a, b: _t(inds))
    out = thead.obj_sampler(None, s, _t(fg), _t(ctr), _t(gt_inds), num_gt)
    for o, rf in zip(out, ref):
        _close(o, rf)


def test_obj_sampler_draws():
    """The draws themselves: the uniform half without replacement from the
    foreground, the other half from the centerness distribution."""
    r = np.random.default_rng(5)
    n = 500
    fg = torch.from_numpy(r.uniform(size=n) < 0.3)
    ctr = torch.from_numpy(r.uniform(size=n))
    gen = torch.Generator().manual_seed(0)
    inds, _, w, uw, valid = thead.obj_sampler(
        gen, 64, fg, ctr, torch.from_numpy(r.integers(0, 5, n)), 5)
    assert valid.all() and len(set(inds[:32].tolist())) == 32
    assert fg[inds].all()
    assert float(w.mean()) == pytest.approx(1.0)
    assert float(uw.mean()) == pytest.approx(1.0)


def test_roi_align_matches_jax_with_gradients():
    r = np.random.default_rng(6)
    feats = r.normal(size=(2, 9, 11, 5))
    boxes = np.array([[0.5, 1.0, 7.0, 6.5], [-2.0, 3.0, 12.0, 10.0],
                      [4.0, 4.0, 5.0, 5.5]])
    inds = np.array([0, 1, 1])
    for scale in (1.0, 0.5):
        ref, vjp = jax.vjp(lambda f, b: jroi_align(f, jnp.asarray(inds), b,
                                                   (4, 3), scale),
                           jnp.asarray(feats), jnp.asarray(boxes))
        ft, bt = _t(feats).requires_grad_(), _t(boxes).requires_grad_()
        out = troi_align(ft, _t(inds), bt, (4, 3), scale)
        _close(out, ref)
        ct = r.normal(size=out.shape)
        out.backward(_t(ct))
        gf, gb = vjp(jnp.asarray(ct))
        _close(ft.grad, gf, rtol=1e-10)
        _close(bt.grad, gb, rtol=1e-10)


@pytest.mark.parametrize('op', ['logsumexp', 'logsoftmax', 'softmax'])
def test_inter_roi_ops_match_jax(op):
    r = np.random.default_rng(7)
    x = r.normal(size=(5, 4, 3, 2))
    boxes = np.array([[0., 0., 8., 8.], [4., 2., 12., 9.],
                      [20., 20., 24., 30.], [1., 1., 9., 9.],
                      [3., 3., 6., 6.]])
    ids = np.array([0, 0, 0, 1, 0])
    jfn = {'logsumexp': jroi_ops.logsumexp_across_rois,
           'logsoftmax': lambda *a: jroi_ops.logsoftmax_across_rois(
               *a, extra_axis=-1),
           'softmax': jroi_ops.softmax_across_rois}[op]
    tfn = {'logsumexp': troi_ops.logsumexp_across_rois,
           'logsoftmax': lambda *a: troi_ops.logsoftmax_across_rois(
               *a, extra_axis=-1),
           'softmax': troi_ops.softmax_across_rois}[op]
    ref, vjp = jax.vjp(lambda v: jfn(v, jnp.asarray(boxes), jnp.asarray(ids)),
                       jnp.asarray(x))
    xt = _t(x).requires_grad_()
    out = tfn(xt, _t(boxes), _t(ids))
    _close(out, ref)
    # overlapping same-image RoIs mix: not the identity
    assert np.abs(np.asarray(ref) - (x if op == 'logsumexp' else 0)).max() \
        > 1e-3
    ct = r.normal(size=x.shape)
    out.backward(_t(ct))
    _close(xt.grad, vjp(jnp.asarray(ct))[0], rtol=1e-10)


@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none', 'avg'])
def test_elementwise_losses_match_jax(reduction):
    r = np.random.default_rng(8)
    pred, target = r.normal(size=(6, 3)), r.normal(size=(6, 3))
    weight = r.uniform(size=(6, 3))
    kw = dict(weight=weight, reduction='mean' if reduction == 'avg'
              else reduction, avg_factor=7.0 if reduction == 'avg' else None)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    for jf, tf, args in (
            (jl.smooth_l1_loss_mod, tl.smooth_l1_loss_mod, (pred, target)),
            (lambda p, **k: jl.smooth_l1_loss_mod(p, 0, beta=0.3, **k),
             lambda p, **k: tl.smooth_l1_loss_mod(p, 0, beta=0.3, **k),
             (pred,)),
            (lambda p, **k: jl.smooth_l1_loss_mod(p, -1, **k),
             lambda p, **k: tl.smooth_l1_loss_mod(p, -1, **k), (pred,)),
            (jl.cosine_angle_loss, tl.cosine_angle_loss, (pred, target)),
            (jl.sigmoid_focal_loss, tl.sigmoid_focal_loss,
             (pred, (target > 0).astype(np.float64))),
            (jl.weight_reduce_loss, tl.weight_reduce_loss, (pred,))):
        _close(tf(*(_t(a) for a in args), **tkw),
               jf(*(jnp.asarray(a) for a in args), **jkw))


@pytest.mark.parametrize('with_rois', [False, True])
def test_mvd_gaussian_mixture_nll_matches_jax(with_rois):
    r = np.random.default_rng(9)
    n, mix, h, w = 4, 3, 5, 4
    pred = r.normal(size=(n, mix, h, w, 2))
    logstd = r.normal(size=(n, mix, h, w, 2)) * 0.3
    logmix = r.normal(size=(n, mix, h, w))
    weight = r.uniform(size=(n, 1, 1))
    extra = {}
    if with_rois:
        extra = dict(roi_boxes=np.array([[0., 0., 8., 8.], [2., 2., 9., 9.],
                                         [20., 0., 30., 5.],
                                         [1., 0., 6., 7.]]),
                     roi_img_ids=np.array([0, 0, 0, 1]))

    def jfn(p, s, m):
        return jl.mvd_gaussian_mixture_nll_loss(
            p, 0, s, m, jnp.asarray(1.3), weight=jnp.asarray(weight),
            reduction='sum', **{k: jnp.asarray(v) for k, v in extra.items()})

    (ref, ref_ema), vjp = jax.vjp(jfn, *(jnp.asarray(a)
                                         for a in (pred, logstd, logmix)))
    ts = [_t(a).requires_grad_() for a in (pred, logstd, logmix)]
    out, ema = tl.mvd_gaussian_mixture_nll_loss(
        ts[0], 0, ts[1], ts[2], torch.tensor(1.3, dtype=torch.float64),
        weight=_t(weight), reduction='sum',
        **{k: _t(v) for k, v in extra.items()})
    _close(out, ref)
    _close(ema, ref_ema)
    out.backward()
    for t, g in zip(ts, vjp((jnp.asarray(1.0), jnp.asarray(0.0)))):
        _close(t.grad, g, rtol=1e-10)


def test_projection_helpers_and_coder_match_jax():
    r = np.random.default_rng(10)
    _close(tmisc.gen_unit_noc(13, torch.float64),
           jmisc.gen_unit_noc(13, jnp.float64))
    x3d = r.normal(size=(3, 7, 3))
    pose = np.concatenate([r.normal(size=(3, 3)) + [0, 0, 4],
                           r.uniform(-3, 3, (3, 1))], -1)
    pose[0, 2] = 0.2  # behind z_min: clamped
    k = np.tile(np.array([[300., 0., 40.], [0., 300., 30.], [0., 0., 1.]]),
                (3, 1, 1))
    shapes = np.array([[60., 80.]] * 3)
    ref = jmisc.project_to_image(*(jnp.asarray(a)
                                   for a in (x3d, pose, k, shapes)),
                                 z_min=0.5, allowed_border=20.0,
                                 return_z=True, return_clip_mask=True)
    out = tmisc.project_to_image(*(_t(a) for a in (x3d, pose, k, shapes)),
                                 z_min=0.5, allowed_border=20.0,
                                 return_z=True, return_clip_mask=True)
    for o, rf in zip(out, ref):
        _close(o, rf)
    assert np.asarray(ref[2]).any() and not np.asarray(ref[2]).all()
    diff = r.normal(size=(3, 2, 5, 2))
    args = (diff, r.uniform(0.05, 9, (3, 1, 1)), r.uniform(1, 3, (3, 1, 3)),
            np.full((3, 1, 1), 300.))
    coder_j, coder_t = jcoders.DistDimProjErrorCoder(), \
        tcoders.DistDimProjErrorCoder()
    enc = coder_t.encode(*(_t(a) for a in args))
    _close(enc, coder_j.encode(*(jnp.asarray(a) for a in args)))
    _close(coder_t.decode(enc, *(_t(a) for a in args[1:])), diff)
