"""PyTorch port of the Det training step against the JAX package.

The tiny detector of ``tests/test_det_train.py`` (ResNet-18, 32-wide head,
64x64 images, 2 images a batch), with DCNv2 as the last conv of each FCOS
tower, takes a training step in float64 in both packages from the same
weights
(moved by ``utils.convert.det_state_dict``) on the same seeded batch
(``utils.synthetic.make_det_batch``). The draws cannot match JAX's PRNG,
so the test replays them: the object sampler's point indices and the AMIS
samples are JAX's (taken from the jitted JAX step), and the random
initialisation solver is replaced on both sides by the same deterministic
stand-in. The port runs its solves through the K1 twin (``use_pallas``)
and its DCNs through K3's twin with ``dcn_backward``. After each step the
test compares every loss term, the gradient of every parameter, the
update (against optax's on the same gradients), the new parameters, the
EMA normalisers (rtol 1e-6) and the BatchNorm statistics (1e-9), under the
flax names (``utils.convert.det_variables``). One step:
from the second on, the random-weight detector's Monte Carlo loss is
ill-conditioned (the proposal covariance inverts a near-singular JtJ for
objects whose points lie past the bounds), and a 1e-11 difference of the
updated weights moves it by 1e-3 even with both packages on the plain LM
path. The optimizer's later steps are held to optax below.

The flax ``DeformConv`` has a bias that mmcv's DCN, and so the port,
lacks. In the towers here each GroupNorm group is one channel, which
normalises that bias away: its JAX gradient is 0 to rounding (checked), so
the two steps agree without it.

Cheaper cases follow: the AdamW recipe against optax, the non-finite
gradient skip, the checkpoint round trip, ``det_variables`` against
``det_state_dict``, ``make_det_batch`` against the JAX test's batch, and
``train_loop``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from epropnp_tpu.det import config as jconfig
from epropnp_tpu.det import train as jtrain
from epropnp_tpu.det.api import build_detector as jbuild_detector
from epropnp_tpu.models.dense_heads import deform_pnp_head as jhead
from epropnp_tpu.models.losses.monte_carlo_pose_loss import (
    MonteCarloPoseLossState as JMCState)
from epropnp_tpu.ops import pnp as jpnp
from epropnp_tpu.ops.pnp import epropnp as jep
from epropnp_tpu.ops.pnp import levenberg_marquardt as jlm
from epropnp_tpu_torch.det import api as tapi
from epropnp_tpu_torch.det import config as tconfig
from epropnp_tpu_torch.det import main as tmain
from epropnp_tpu_torch.det import train as ttrain
from epropnp_tpu_torch.models.dense_heads import deform_pnp_head as thead
from epropnp_tpu_torch.ops import pnp as tpnp
from epropnp_tpu_torch.ops.pnp import epropnp as tep
from epropnp_tpu_torch.ops.pnp import levenberg_marquardt as tlm
from epropnp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from epropnp_tpu_torch.utils.convert import det_state_dict, det_variables
from epropnp_tpu_torch.utils.synthetic import DET_BATCH_FIELDS, make_det_batch

torch.set_num_threads(1)
H = W = 64
N_IMG, STEPS = 2, 1


def tiny_cfg(pkg, use_pallas=False, **train):
    """``tests/test_det_train.py::tiny_cfg`` in either package."""
    return pkg.DetConfig(
        num_classes=3, backbone_depth=18, embed_dims=32, num_heads=4,
        num_points=4, strides=(4, 8, 16, 32), output_stride=4,
        with_loss_regr=True, num_attrs=4,
        pnp=pkg.DetPnPConfig(mc_samples=16, num_iter=2, lm_num_iter=2,
                             rs_num_points=8, rs_num_proposals=4,
                             rs_num_iter=1, use_pallas=use_pallas),
        train=pkg.DetTrainConfig(**dict(dict(
            num_obj_samples_per_img=4, roi_shape=(8, 8), max_gt_per_img=4),
            **train)))


# ``tests/test_det_train.py::tiny_model``, with DCNv2 in the FCOS towers
OVERRIDES = dict(
    backbone_dcn_stages=(), dcn_on_last_conv=True,
    detector_cfg=dict(
        feat_channels=32, emb_channels=32, cls_branch=(32,),
        centerness_branch=(16,), offset_branch=(32,), emb_branch=(32,),
        regress_ranges=((-1, 16), (16, 32), (32, 1e8))))


def _batch(step):
    b = make_det_batch(10 + step, N_IMG, H, W)
    return {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in b.items()}


def _identity_init(evaluate_pnp, cat, zero):
    """The deterministic stand-in of ``RSLMSolver.solve`` at dof 4: the
    centre-based translation and yaw 0, with its cost."""
    def solve(self, x3d, x2d, w2d, camera, cost_fun, rng=None, **kwargs):
        t = self.center_based_init(x2d, x3d, camera)
        pose = cat([t, zero(t)], -1)
        cost = evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                            out_cost=True).cost
        return pose, None, cost
    return solve


JAX_INIT = _identity_init(jpnp.evaluate_pnp, jnp.concatenate,
                          lambda t: jnp.zeros_like(t[..., :1]))
TORCH_INIT = _identity_init(tpnp.evaluate_pnp, torch.cat,
                            lambda t: torch.zeros_like(t[..., :1]))


def _flax_variables(seed=0):
    """f64 flax variables; the DCN offset convs and class embeddings drawn
    anew (offsets of a pixel or so: the DCN samples off the grid)."""
    model = jbuild_detector(tiny_cfg(jconfig), dtype=jnp.float64,
                            **OVERRIDES)
    variables = jax.jit(lambda k, x: model.init(k, x, (H, W)))(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)))
    r = np.random.default_rng(seed + 1)

    def leaf(path, x):
        keys = [str(getattr(p, 'key', '')) for p in path]
        x = np.asarray(x, np.float64)
        if 'conv_offset' in keys or keys[-1] == 'cls_emb':
            x = r.normal(0, 0.05, x.shape)
        return x
    return model, jax.tree_util.tree_map_with_path(leaf, dict(variables))


def _is_dcn_bias(path):
    keys = [str(getattr(p, 'key', '')) for p in path]
    return keys[-1] == 'bias' and ('_dcn' in keys[-2]
                                   or keys[-2] == 'DeformConv_0')


def _jax_reference(model, variables, cfg, steps=STEPS, fresh=False):
    """JAX's steps (one jitted program): per step the new state, the
    metrics, the gradients, the sampler's point indices, the AMIS samples
    in the solver's normalised frame. ``fresh``: every step starts from
    the initial state (one step on each of ``steps`` batches)."""
    tx = jtrain.make_optimizer(cfg)
    stash = {}
    real_sampler = jtrain.obj_sampler
    real_mc = jep.EProPnPBase.monte_carlo_forward
    real_norm = optax.global_norm

    def sampler(*args, **kwargs):
        out = real_sampler(*args, **kwargs)
        stash['point_inds'] = out[0]
        return out

    def mc(self, x3d, *args, **kwargs):
        out = real_mc(self, x3d, *args, **kwargs)
        offset = jnp.mean(x3d, -2)
        samples = out[3]
        rot = jpnp.pose_to_rot_mat(samples)
        stash['samples'] = jnp.concatenate([
            samples[..., :3] + jnp.einsum('...ij,...j->...i', rot, offset),
            samples[..., 3:]], -1)
        return out

    def compute_losses(*args, **kwargs):
        # the draws leave the gradient's trace as auxiliary outputs
        total, (losses, bs, ema) = real_losses(*args, **kwargs)
        return total, (dict(losses, _point_inds=stash.pop('point_inds'),
                            _samples=stash.pop('samples')), bs, ema)

    def global_norm(tree):
        stash.setdefault('grads', tree)
        return real_norm(tree)

    real_losses = jtrain.compute_losses
    train_step = jtrain.make_train_step(model, cfg, tx)

    def ref_step(state, batch, rng):
        stash.clear()
        new_state, metrics = train_step(state, batch, rng)
        return (new_state, metrics, stash['grads'],
                metrics.pop('_point_inds'), metrics.pop('_samples'))

    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, 'compute_losses', compute_losses)
    mp.setattr(jtrain, 'obj_sampler', sampler)
    mp.setattr(jep.EProPnPBase, 'monte_carlo_forward', mc)
    mp.setattr(optax, 'global_norm', global_norm)
    mp.setattr(jlm.RSLMSolver, 'solve', JAX_INIT)
    try:
        # the EMA normalisers in f64, as the port's buffers (the JAX state
        # creates them in f32, whose 0.99 and 0.9 moved the EMAs by 1e-8)
        state = jtrain.DetTrainState.create(variables, tx)
        state = state.replace(ema=jhead.HeadEMAState(
            pose_norm_factor=(JMCState.create(dtype=jnp.float64),),
            proj_mean_inv_std=jnp.asarray(1.0, jnp.float64)))
        step = jax.jit(ref_step)
        out, state0 = [], state
        for i in range(steps):
            batch = jtrain.DetBatch(**{k: jnp.asarray(v)
                                       for k, v in _batch(i).items()})
            state, metrics, grads, inds, samples = step(
                state0 if fresh else state, batch,
                jax.random.PRNGKey(100 + i))
            out.append(jax.tree_util.tree_map(np.asarray, dict(
                params=state.params, batch_stats=state.batch_stats,
                ema=state.ema, metrics=metrics, grads=grads,
                point_inds=inds, samples=samples)))
    finally:
        mp.undo()
    return out


@pytest.fixture(scope='module')
def reference():
    model, variables = _flax_variables()
    return variables, _jax_reference(model, variables, tiny_cfg(jconfig))


def _port_state(variables, cfg):
    model = tapi.build_detector(cfg, **OVERRIDES).double()
    model.load_state_dict({k: v.double() if v.is_floating_point() else v
                           for k, v in det_state_dict(variables,
                                                      cfg).items()})
    return ttrain.DetTrainState(model, ttrain.make_optimizer(cfg, model))


def _leafwise(port, ref, rel, what, floor=0.0, skip=lambda path: False):
    """Every leaf within ``rel`` of the leaf's largest magnitude, or of
    ``floor`` times the largest magnitude of any leaf where that is more."""
    flat_p = dict(jax.tree_util.tree_leaves_with_path(port))
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert flat_p.keys() == flat_r.keys(), what
    top = max(np.abs(r).max() for r in flat_r.values())
    for path, r in flat_r.items():
        if skip(path):
            continue
        p = np.asarray(flat_p[path])
        scale = max(np.abs(r).max(), floor * top, 1e-30)
        err = np.abs(p - r).max() / scale
        assert err <= rel, (what, jax.tree_util.keystr(path), err)


def test_train_steps_match_jax(reference, monkeypatch):
    variables, ref_steps = reference
    cfg = tiny_cfg(tconfig, use_pallas=True)
    state = _port_state(variables, cfg)
    step_fn = ttrain.make_train_step(cfg)
    monkeypatch.setattr(tlm.RSLMSolver, 'solve', TORCH_INIT)
    draws = {}
    monkeypatch.setattr(
        thead, 'draw_object_samples',
        lambda gen, fg_mask, prob, n_u, n_r: torch.from_numpy(
            draws['point_inds'].astype(np.int64)))
    monkeypatch.setattr(
        tep, 'draw_pose_samples',
        lambda trans, rot, num, gen: draws['samples'].pop(0).clone())
    gen = torch.Generator().manual_seed(0)
    old = det_variables({k: v.numpy().copy() for k, v in
                         state.model.state_dict().items()}, cfg)
    for i, ref in enumerate(ref_steps):
        draws['point_inds'] = ref['point_inds']
        draws['samples'] = list(torch.from_numpy(
            ref['samples'].copy()).reshape(
            cfg.pnp.num_iter, -1, *ref['samples'].shape[1:]))
        batch = tmain.to_device(tuple(_batch(i)[k] for k in DET_BATCH_FIELDS),
                                'cpu', torch.float64)
        metrics = step_fn(state, batch, gen)
        assert not draws['samples'], 'both AMIS draws replayed'
        assert int(metrics['skipped']) == 0

        # float64 on both sides with the same draws; the port's solves run
        # through the K1 twin, which reduces in another order (1e-7
        # relative on the solve, tests/test_torch_pnp.py): 1e-6 relative
        # on the losses, the gradients, the updates and the EMA
        assert set(ref['metrics']) == set(metrics) - {'skipped'}
        for name, value in ref['metrics'].items():
            np.testing.assert_allclose(float(metrics[name]), value,
                                       rtol=1e-6, atol=1e-12, err_msg=name)
        sd = {k: v.numpy().copy()
              for k, v in state.model.state_dict().items()}
        grads = det_variables(dict(sd, **{
            n: p.grad.numpy() for n, p in state.model.named_parameters()}),
            cfg)['params']
        for path, g in jax.tree_util.tree_leaves_with_path(ref['grads']):
            if _is_dcn_bias(path):  # normalised away (module docstring)
                assert np.abs(g).max() <= 1e-12, jax.tree_util.keystr(path)
        # a gradient that is 0 but for rounding (the DCN biases; the key
        # bias of the point transformer, which the softmax over the points
        # cancels) is held to 1e-9 of the largest gradient instead of its
        # own noise
        _leafwise(grads, ref['grads'], 1e-6, f'step {i} gradients',
                  floor=1e-9)
        # the update: AdamW against optax's chain on the same gradients
        # (the port's). Against JAX's own update it would be ill-posed:
        # below eps Adam is linear in g, and with the clip (5 / 5237 here)
        # an update moves by lr * clip / eps ~ 1e5 times a gradient's
        # absolute error, so the ~1e-11 (of the largest entry) at which the
        # two f64 backward passes agree moves JAX's updates by ~1e-6 of lr
        new = det_variables(sd, cfg)
        delta = jax.tree_util.tree_map(np.subtract, new['params'],
                                       old['params'])
        tx = jtrain.make_optimizer(tiny_cfg(jconfig))
        optax_delta, _ = tx.update(grads, tx.init(old['params']),
                                   old['params'])
        _leafwise(delta, jax.tree_util.tree_map(np.asarray, optax_delta),
                  1e-6, f'step {i} updates')
        # and the new parameters against JAX's, but for its DCN biases,
        # which its Adam moved by lr * |g| / eps on their rounding-level
        # gradients (the port has none to move); the point transformer's
        # key bias, 0 and with a 0 gradient, moves by rounding only: the
        # floor
        _leafwise(new['params'], ref['params'], 1e-6, f'step {i} params',
                  floor=1e-9, skip=_is_dcn_bias)
        _leafwise(new['batch_stats'], ref['batch_stats'], 1e-9,
                  f'step {i} BatchNorm statistics')
        ema = state.ema
        np.testing.assert_allclose(
            float(ema.pose_norm_factor[0].norm_factor),
            ref['ema'].pose_norm_factor[0].norm_factor, rtol=1e-6)
        np.testing.assert_allclose(float(ema.proj_mean_inv_std),
                                   ref['ema'].proj_mean_inv_std, rtol=1e-6)
        old = new
    assert int(state.step) == STEPS


@pytest.mark.parametrize('clip', [False, True])
def test_adamw_matches_optax(clip):
    """The optimizer recipe against optax (``make_optimizer`` of both
    packages, float64): the sampling_offsets group at lr_mult 0.1, the
    global-norm clip (without torch's +1e-6), the step decay at epochs 10
    and 11 (2 steps an epoch: counts 20 and 22)."""
    scale = 10.0 if clip else 1e-3
    cfg = tiny_cfg(jconfig)
    r = np.random.default_rng(1)
    shapes = {'sampling_offsets': (3, 4), 'linear': (5,), 'norm': (2, 2)}
    params = {'head': {k: {'kernel': r.normal(size=s)}
                       for k, s in shapes.items()}}
    tx = jtrain.make_optimizer(cfg, steps_per_epoch=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for name in shapes:
                mod = torch.nn.Module()
                mod.kernel = torch.nn.Parameter(torch.from_numpy(
                    params['head'][name]['kernel'].copy()))
                setattr(self, name, mod)

    model = torch.nn.Module()
    model.head = Head()
    opt = ttrain.make_optimizer(tiny_cfg(tconfig), model, steps_per_epoch=2)
    assert [len(g['params']) for g in opt.param_groups] == [2, 1]
    for step in range(25):
        g = {k: r.normal(size=s) * scale for k, s in shapes.items()}
        upd, opt_state = tx.update(
            {'head': {k: {'kernel': jnp.asarray(v)} for k, v in g.items()}},
            opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k in shapes:
            getattr(model.head, k).kernel.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(
                getattr(model.head, k).kernel.detach().numpy(),
                np.asarray(jparams['head'][k]['kernel']), rtol=1e-12,
                atol=1e-15, err_msg=f'{step} {k}')
    assert opt.learning_rate(opt.param_groups[0]) == pytest.approx(1e-6)


def _tiny_port_state():
    cfg = tiny_cfg(tconfig, use_pallas=True)
    model = tapi.build_detector(cfg, **OVERRIDES).double()
    return cfg, tmain.init_state(cfg, model), ttrain.make_train_step(cfg)


def _batch_t(i):
    return tmain.to_device(tuple(_batch(i)[k] for k in DET_BATCH_FIELDS),
                           'cpu', torch.float64)


def test_nan_gradient_skips_the_update(monkeypatch):
    """A non-finite gradient leaves the parameters and the optimizer state
    (its count included) as they were; the BatchNorm statistics, the EMA
    normalisers and the step count still move, as in the JAX step."""
    cfg, state, step_fn = _tiny_port_state()
    gen = torch.Generator().manual_seed(0)
    step_fn(state, _batch_t(0), gen)
    before = {k: v.clone() for k, v in state.state_dict().items()}
    mu = [v['mu'].clone() for v in state.tx.state.values()]
    real = ttrain.compute_losses

    def poisoned(*args, **kwargs):
        total, losses, ema = real(*args, **kwargs)
        return total * float('nan'), losses, ema

    monkeypatch.setattr(ttrain, 'compute_losses', poisoned)
    metrics = step_fn(state, _batch_t(1), gen)
    assert int(metrics['skipped']) == 1
    after = state.state_dict()
    for name, _ in state.named_parameters():
        assert torch.equal(after[name], before[name]), name
    assert [g['count'] for g in state.tx.param_groups] == [1, 1]
    for a, b in zip(mu, state.tx.state.values()):
        assert torch.equal(a, b['mu'])
    assert any(not torch.equal(after[k], before[k]) for k in before
               if k.endswith('running_var'))
    assert not torch.equal(after['ema_pose_norm_factor'],
                           before['ema_pose_norm_factor'])
    assert int(after['step']) == 2


def test_checkpoint_round_trip(tmp_path):
    """A checkpoint restores the parameters, BatchNorm statistics, EMA
    normalisers, step and optimizer state; the resumed state then takes
    the same step as the original."""
    cfg, state, step_fn = _tiny_port_state()
    step_fn(state, _batch_t(0), torch.Generator().manual_seed(0))
    path = save_checkpoint(os.path.join(tmp_path, 'ck.pt'), state)
    _, other, _ = _tiny_port_state()
    load_checkpoint(path, other)
    for (k, a), b in zip(state.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), k
    assert [g['count'] for g in other.tx.param_groups] == [1, 1]
    outs = [step_fn(st, _batch_t(1), torch.Generator().manual_seed(5))
            for st in (state, other)]
    for (k, a), b in zip(state.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), k
    assert float(outs[0]['loss_cls']) == float(outs[1]['loss_cls'])
    # filtered restore: the EMA normalisers only
    _, third, _ = _tiny_port_state()
    fresh = {k: v.clone() for k, v in third.state_dict().items()}
    load_checkpoint(path, third, filter_fn=lambda k: k == 'ema')
    saved = torch.load(path, weights_only=True)['state']
    for k, v in third.state_dict().items():
        assert torch.equal(v, saved[k] if k.startswith('ema_') else fresh[k])
    assert int(third.step) == 0 and not third.tx.state


def test_det_variables_inverts_det_state_dict():
    """``det_variables(det_state_dict(v)) == v`` leaf for leaf at the v1b
    structure (ResNet-101 with DCN in stages 3-4, FPN, 8 heads x 16
    points), with the DCN biases zero as mmcv's."""
    cfg = jconfig.DetConfig.v1b()
    model = jbuild_detector(cfg)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, (64, 64)),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    r = np.random.default_rng(7)

    def leaf(path, s):
        if _is_dcn_bias(path):
            return np.zeros(s.shape, np.float32)
        return r.normal(size=s.shape).astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
    sd = {k: v.numpy() for k, v in
          det_state_dict(variables, tconfig.DetConfig.v1b()).items()}
    back = det_variables(sd, tconfig.DetConfig.v1b())
    flat_a = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert flat_a.keys() == flat_b.keys()
    for path, value in flat_b.items():
        np.testing.assert_array_equal(flat_a[path], value,
                                      err_msg=str(path))


def test_make_det_batch_is_the_jax_tests_batch():
    """``make_det_batch`` at its defaults draws
    ``tests/test_det_train.py::make_batch`` value for value."""
    from test_det_train import make_batch
    ref = make_batch(seed=4)
    port = make_det_batch(4)
    assert tuple(port) == DET_BATCH_FIELDS == jtrain.DetBatch._fields
    for name in DET_BATCH_FIELDS:
        np.testing.assert_array_equal(port[name],
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_train_loop_checkpoints_resumes_and_evaluates(tmp_path):
    """``train_loop`` on the CPU (when the caller asks for it) over 2 epochs
    of one batch each: finite metrics, a checkpoint per epoch, the eval
    hook after each epoch's checkpoint, and resume from ``latest.pt``."""
    cfg = dataclasses.replace(tiny_cfg(tconfig, use_pallas=True),
                              train=dataclasses.replace(
                                  tiny_cfg(tconfig).train, epochs=2))
    calls, seen = [], []

    def factory(epoch):
        b = make_det_batch(20 + epoch, N_IMG, H, W)
        return iter([tuple(b[k] for k in DET_BATCH_FIELDS)])

    def eval_fn(state, epoch):
        calls.append((int(state.step), epoch))
        return {'NDS': 0.5}

    state = tmain.train_loop(cfg, factory, steps_per_epoch=1,
                             save_dir=str(tmp_path), device='cpu',
                             log_interval=1, eval_fn=eval_fn,
                             on_step=lambda e, i, m: seen.append(m))
    assert calls == [(1, 0), (2, 1)] and int(state.step) == 2
    assert all(torch.isfinite(v).all() for m in seen for v in m.values())
    for name in ('checkpoint_000.pt', 'checkpoint_001.pt', 'latest.pt'):
        assert (tmp_path / name).exists()
    resumed = tmain.train_loop(
        dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                           epochs=1)),
        factory, 1, str(tmp_path / 'again'), device='cpu',
        resume_from=str(tmp_path / 'latest.pt'))
    assert int(resumed.step) == 3
    # the int8 DCN contraction has no gradient, in either package
    with pytest.raises(NotImplementedError, match='serving only'):
        tmain.build_all(dataclasses.replace(cfg, int8_dcn_gather=True),
                        'cpu')


def test_train_loop_grafts_a_torch_checkpoint(tmp_path):
    """``train_loop(load_torch=...)``: a full mmdet-named checkpoint
    (``state_dict`` wrapper) is grafted onto the fresh weights before the
    first step, as JAX's ``train_loop`` grafts it; with no step to take the
    trained state holds the file's weights bit for bit. A file with mmcv
    DCN offsets into a model at modulation scale 2.0 raises JAX's guard."""
    cfg = dataclasses.replace(tiny_cfg(tconfig), dcn_modulation_scale=1.0,
                              train=dataclasses.replace(
                                  tiny_cfg(tconfig).train, epochs=1))
    torch.manual_seed(3)
    sd = tapi.build_detector(cfg).state_dict()
    path = str(tmp_path / 'det.pth')
    torch.save({'state_dict': sd}, path)
    state = tmain.train_loop(cfg, lambda epoch: iter([]), 1,
                             str(tmp_path / 'run'), device='cpu',
                             load_torch=path)
    got = state.model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert tapi.torch_checkpoint_has_dcn_offsets(path)
    with pytest.raises(ValueError, match='dcn_modulation_scale=1.0'):
        tmain.train_loop(dataclasses.replace(cfg, dcn_modulation_scale=2.0),
                         lambda epoch: iter([]), 1, str(tmp_path / 'bad'),
                         device='cpu', load_torch=path)
