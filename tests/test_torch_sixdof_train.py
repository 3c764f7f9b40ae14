"""PyTorch port of the 6DoF training step against the JAX package.

A tiny CDPN (ResNet-18, 32-filter heads, 64x64 crops, 16x16 dense maps, 2
crops a batch) trains for 3 steps in float64 in both packages from the same
weights (moved by ``utils.convert.cdpn_state_dict``) on the same seeded
batches. The draws cannot match JAX's PRNG, so the test replays them: the
point subsample of each step is JAX's (recomputed from its key), the AMIS
samples are JAX's (from the same forward with its key), and the random
initialisation solver is replaced on both sides by the same deterministic
stand-in. The port runs its solves through the K1 twin (``use_pallas``),
the arithmetic of the CUDA kernel. After each step the test compares every
loss component, the gradient of every parameter, the parameters, the
BatchNorm statistics and the Monte Carlo ``norm_factor`` (all under the
flax names, via ``utils.convert.cdpn_variables``).

Cheaper cases follow: the RMSprop update against optax at small gradients
(with momentum, clipping and a learning-rate boundary), the non-finite
gradient skip, and the checkpoint round trip.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from epropnp_tpu.models.cdpn import CDPN as FlaxCDPN
from epropnp_tpu.models.losses.monte_carlo_pose_loss import (
    MonteCarloPoseLossState as JMCState)
from epropnp_tpu.ops import pnp as jpnp
from epropnp_tpu.ops.pnp import levenberg_marquardt as jlm
from epropnp_tpu.sixdof import config as jconfig
from epropnp_tpu.sixdof import train as jtrain
from epropnp_tpu_torch.models.cdpn import CDPN
from epropnp_tpu_torch.ops import pnp as tpnp
from epropnp_tpu_torch.ops.pnp import epropnp as tep
from epropnp_tpu_torch.ops.pnp import levenberg_marquardt as tlm
from epropnp_tpu_torch.sixdof import config as tconfig
from epropnp_tpu_torch.sixdof import main as tmain
from epropnp_tpu_torch.sixdof import train as ttrain
from epropnp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from epropnp_tpu_torch.utils.convert import cdpn_state_dict, cdpn_variables
from epropnp_tpu_torch.utils.synthetic import (SyntheticSixDoFDataset,
                                               make_sixdof_batch)

torch.set_num_threads(1)

INP, OUT, BS, STEPS = 64, 16, 2, 3
CAM_K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]])
FIELDS = SyntheticSixDoFDataset.FIELDS


def tiny_cfg(pkg, use_pallas=False, **train):
    """``tests/test_sixdof_train.py::tiny_cfg`` in either package."""
    return pkg.SixDoFConfig(
        dataiter=pkg.DataIterConfig(inp_res=INP, out_res=OUT,
                                    sample_points=32),
        pnp=pkg.PnPConfig(mc_samples=32, num_iter=2, lm_num_iter=2,
                          rs_num_points=8, rs_num_proposals=2, rs_num_iter=1,
                          use_pallas=use_pallas),
        train=pkg.TrainConfig(**dict(dict(lr_epoch_step=()), **train)))


def _batch(step):
    return {k: v.astype(np.float64)
            for k, v in make_sixdof_batch(step, BS, INP, OUT).items()}


def _identity_init(evaluate_pnp, cat, ident):
    """The deterministic stand-in of ``RSLMSolver.solve``: the
    centre-based translation and the identity rotation, with its cost."""
    def solve(self, x3d, x2d, w2d, camera, cost_fun, rng=None, **kwargs):
        t = self.center_based_init(x2d, x3d, camera)
        pose = cat([t, ident(t)], -1)
        cost = evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                            out_cost=True).cost
        return pose, None, cost
    return solve


JAX_INIT = _identity_init(
    jpnp.evaluate_pnp, jnp.concatenate,
    lambda t: jnp.broadcast_to(jnp.asarray([1.0, 0, 0, 0], t.dtype),
                               t.shape[:-1] + (4,)))
TORCH_INIT = _identity_init(
    tpnp.evaluate_pnp, torch.cat,
    lambda t: t.new_tensor([1.0, 0, 0, 0]).expand(t.shape[:-1] + (4,)))


def _flax_variables(seed=0):
    model = FlaxCDPN(depth=18, rot_filters=32, trans_filters=32,
                     dtype=jnp.float64)
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, INP, INP, 3)))
    return model, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), dict(variables))


def _port_state(variables, cfg):
    feat = INP // 32
    model = CDPN(depth=18, rot_filters=32, trans_filters=32,
                 feat_hw=(feat, feat)).double()
    model.load_state_dict({k: v.double() if v.is_floating_point() else v
                           for k, v in cdpn_state_dict(variables,
                                                       depth=18).items()})
    return ttrain.TrainState(model, ttrain.make_optimizer(cfg, model))


def _jax_reference(model, variables, cfg, steps=STEPS, fresh=False):
    """JAX's 3 steps: per step the point subsample, the AMIS samples, the
    gradients, the new state and the metrics (one jitted program).
    ``fresh``: every step starts from the initial state (one step on each
    of ``steps`` batches)."""
    epropnp = jtrain.build_epropnp(cfg)
    tx = jtrain.make_optimizer(cfg)
    cam = jnp.asarray(CAM_K)
    train_step = jtrain.make_train_step(model, epropnp, cfg, tx, cam)
    out_res, sp = cfg.dataiter.out_res, cfg.dataiter.sample_points

    def ref_step(state, batch, rng):
        k_sample, k_mc = jax.random.split(rng)
        inds = jax.vmap(lambda k: jax.random.choice(
            k, out_res * out_res, (sp,), replace=False))(
            jax.random.split(k_sample, BS))
        outs, _ = model.apply({'params': state.params,
                               'batch_stats': state.batch_stats}, batch.inp,
                              train=True, mutable=['batch_stats'])
        x3d, x2d, w2d, camera = jtrain.build_correspondences(
            outs.noc, outs.w2d, outs.scale, batch, cam, out_res, inds)
        cost_fun = jpnp.AdaptiveHuberPnPCost(
            relative_delta=cfg.pnp.relative_delta).set_param(x2d, w2d)
        samples = epropnp.monte_carlo_forward(
            x3d, x2d, w2d, camera, cost_fun, rng=k_mc,
            pose_init=jtrain.pose_gt_from_batch(batch),
            force_init_solve=True, with_pose_opt_plus=True)[3]
        grads = jax.grad(lambda p: jtrain.compute_losses(
            model, epropnp, cfg, p, state.batch_stats, batch, cam, rng,
            state.mc_state)[0])(state.params)
        new_state, metrics = train_step(state, batch, rng)
        return inds, samples, grads, new_state, metrics

    state = jtrain.TrainState.create(variables, tx)
    state = state.replace(mc_state=JMCState.create(dtype=jnp.float64))
    step = jax.jit(ref_step)
    out, state0 = [], state
    for i in range(steps):
        batch = jtrain.Batch(*(jnp.asarray(_batch(i)[k]) for k in FIELDS))
        inds, samples, grads, state, metrics = step(
            state0 if fresh else state, batch, jax.random.PRNGKey(100 + i))
        out.append(jax.tree_util.tree_map(np.asarray, dict(
            inds=inds, samples=samples, grads=grads, params=state.params,
            batch_stats=state.batch_stats,
            norm_factor=state.mc_state.norm_factor, metrics=metrics)))
    return out


@pytest.fixture(scope='module')
def reference():
    mp = pytest.MonkeyPatch()
    mp.setattr(jlm.RSLMSolver, 'solve', JAX_INIT)
    try:
        model, variables = _flax_variables()
        steps = _jax_reference(model, variables, tiny_cfg(jconfig))
    finally:
        mp.undo()
    return variables, steps


def _leafwise(port, ref, rel, what):
    """Every leaf within ``rel`` of the leaf's largest magnitude."""
    flat_p = dict(jax.tree_util.tree_leaves_with_path(port))
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert flat_p.keys() == flat_r.keys(), what
    for path, r in flat_r.items():
        p = flat_p[path]
        scale = max(np.abs(r).max(), 1e-30)
        err = np.abs(p - r).max() / scale
        assert err <= rel, (what, jax.tree_util.keystr(path), err)


def test_train_steps_match_jax(reference, monkeypatch):
    variables, ref_steps = reference
    cfg = tiny_cfg(tconfig, use_pallas=True)
    state = _port_state(variables, cfg)
    step_fn = ttrain.make_train_step(ttrain.build_epropnp(cfg), cfg,
                                     torch.from_numpy(CAM_K))
    monkeypatch.setattr(tlm.RSLMSolver, 'solve', TORCH_INIT)
    draws = {}
    monkeypatch.setattr(ttrain, 'sample_point_indices',
                        lambda bs, n, num, gen, device: torch.from_numpy(
                            draws['inds'].astype(np.int64)))
    monkeypatch.setattr(
        tep, 'draw_pose_samples',
        lambda trans, rot, num, gen: draws['samples'].pop(0).clone())
    gen = torch.Generator().manual_seed(0)
    old = cdpn_variables({k: v.numpy().copy() for k, v in
                          state.model.state_dict().items()}, depth=18)
    for i, ref in enumerate(ref_steps):
        draws['inds'] = ref['inds']
        draws['samples'] = list(torch.from_numpy(np.array(
            ref['samples'])).reshape(2, -1, BS, 7))
        batch = ttrain.Batch(*(torch.from_numpy(_batch(i)[k])
                               for k in FIELDS))
        metrics = step_fn(state, batch, gen)
        assert not draws['samples'], 'both AMIS draws replayed'
        assert int(metrics['skipped']) == 0

        # float64 on both sides with the same draws. The port's solves run
        # through the K1 twin, which reduces in another order and
        # renormalises the quaternion inside its evaluation (1e-7 relative
        # on the solve, tests/test_torch_pnp.py): 1e-6 relative on the
        # losses, the gradients and the updates
        for name, value in ref['metrics'].items():
            np.testing.assert_allclose(float(metrics[name]), value,
                                       rtol=1e-6, atol=1e-12, err_msg=name)
        sd = {k: v.numpy().copy()
              for k, v in state.model.state_dict().items()}
        grads = cdpn_variables(dict(sd, **{
            n: p.grad.numpy() for n, p in state.model.named_parameters()}),
            depth=18)['params']
        _leafwise(grads, ref['grads'], 1e-6, f'step {i} gradients')
        new = cdpn_variables(sd, depth=18)
        delta = jax.tree_util.tree_map(np.subtract, new['params'],
                                       old['params'])
        ref_delta = jax.tree_util.tree_map(
            np.subtract, ref['params'],
            variables['params'] if i == 0 else ref_steps[i - 1]['params'])
        _leafwise(delta, ref_delta, 1e-6, f'step {i} updates')
        # a zero-initialised bias is its update after one step
        _leafwise(new['params'], ref['params'], 1e-6, f'step {i} params')
        # flax folds the biased batch variance into the running average
        # (torch's own BatchNorm the unbiased one: 8/7 at the 2x2 maps)
        _leafwise(new['batch_stats'], ref['batch_stats'], 1e-9,
                  f'step {i} BatchNorm statistics')
        np.testing.assert_allclose(state.norm_factor.item(),
                                   ref['norm_factor'], rtol=1e-9)
        old = new
    assert int(state.step) == STEPS


@pytest.mark.parametrize('momentum,clip', [(0.0, None), (0.9, 0.5)])
def test_rmsprop_matches_optax_at_small_gradients(momentum, clip):
    """Several steps with gradients of 1e-4..1e-6: optax puts eps inside the
    square root (torch.optim.RMSprop outside it, which differs ~10x after
    one step here). The learning rate drops by lr_factor once the update
    count reaches the boundary (2 epochs of 3 steps = count 6)."""
    cfg = dataclasses.replace(tiny_cfg(jconfig), train=jconfig.TrainConfig(
        lr_epoch_step=(2,), lr_factor=0.1, momentum=momentum,
        clip_grad_norm=clip, lr_backbone=1e-3, lr_rot_head=2e-4,
        lr_trans_head=5e-4))
    tcfg = dataclasses.replace(tiny_cfg(tconfig), train=tconfig.TrainConfig(
        **dataclasses.asdict(cfg.train)))
    r = np.random.default_rng(0)
    shapes = {'backbone': (3, 4), 'rot_head': (5,), 'trans_head': (2, 2)}
    params = {k: r.normal(size=s) for k, s in shapes.items()}
    tx = jtrain.make_optimizer(cfg, steps_per_epoch=3)
    opt_state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    class Three(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for name, a in (('backbone', 'backbone'),
                            ('rot_head_net', 'rot_head'),
                            ('trans_head_net', 'trans_head')):
                mod = torch.nn.Module()
                mod.w = torch.nn.Parameter(torch.from_numpy(params[a]))
                setattr(self, name, mod)

    model = Three()
    opt = ttrain.make_optimizer(tcfg, model, steps_per_epoch=3)
    for step in range(9):
        scale = 10.0 ** -(4 + step % 3)
        g = {k: r.normal(size=s) * scale for k, s in shapes.items()}
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for mod, key in ((model.backbone, 'backbone'),
                         (model.rot_head_net, 'rot_head'),
                         (model.trans_head_net, 'trans_head')):
            mod.w.grad = torch.from_numpy(g[key])
        lrs = [ttrain.RMSprop.learning_rate(gr) for gr in opt.param_groups]
        opt.step()
        # the learning rate each branch used at this update count
        inner = opt_state.inner_states if clip is None else \
            opt_state[1].inner_states
        for gr, lr, key in zip(opt.param_groups, lrs,
                               ('backbone', 'rot_head', 'trans_head')):
            base = {'backbone': 1e-3, 'rot_head': 2e-4,
                    'trans_head': 5e-4}[key]
            assert lr == pytest.approx(base * (0.1 if step >= 6 else 1.0))
            # optax keeps the hyperparameters its last update used
            hp = inner[key].inner_state.hyperparams['learning_rate']
            np.testing.assert_allclose(float(hp), lr, rtol=1e-12)
            assert gr['count'] == step + 1
        # float64: the same arithmetic in both packages
        for mod, key in ((model.backbone, 'backbone'),
                         (model.rot_head_net, 'rot_head'),
                         (model.trans_head_net, 'trans_head')):
            np.testing.assert_allclose(mod.w.detach().numpy(),
                                       np.asarray(jparams[key]), rtol=1e-12,
                                       atol=1e-15, err_msg=f'{step} {key}')
    # torch.optim.RMSprop's update is not this one at such gradients
    w = torch.nn.Parameter(torch.zeros(1, dtype=torch.float64))
    w.grad = torch.full_like(w, 1e-4)
    torch.optim.RMSprop([w], lr=1.0, alpha=0.99, eps=1e-8).step()
    ours = 1e-4 / np.sqrt(0.01 * 1e-8 + 1e-8)
    assert abs(abs(w.item()) - ours) > 2 * ours


def _tiny_port_state(seed=0):
    cfg = tiny_cfg(tconfig, use_pallas=True)
    model, _, step_fn = tmain.build_all(cfg, cam_intrinsic=CAM_K,
                                        device='cpu')
    state = tmain.init_state(cfg, model.double(), seed=seed)
    return cfg, state, step_fn


def _batch_t(i):
    return ttrain.Batch(*(torch.from_numpy(_batch(i)[k]) for k in FIELDS))


def test_nan_gradient_skips_the_update(monkeypatch):
    """A non-finite gradient leaves the parameters and the optimizer state
    (its count included) as they were; the BatchNorm statistics and the
    Monte Carlo norm factor still move, as in the JAX step."""
    cfg, state, step_fn = _tiny_port_state()
    gen = torch.Generator().manual_seed(0)
    step_fn(state, _batch_t(0), gen)
    before = {k: v.clone() for k, v in state.state_dict().items()}
    opt_before = [(v['nu'].clone()) for v in state.tx.state.values()]
    count = [g['count'] for g in state.tx.param_groups]
    real = ttrain.compute_losses

    def poisoned(*args, **kwargs):
        loss, aux, mc = real(*args, **kwargs)
        return loss * float('nan'), aux, mc

    monkeypatch.setattr(ttrain, 'compute_losses', poisoned)
    metrics = step_fn(state, _batch_t(1), gen)
    assert int(metrics['skipped']) == 1
    after = state.state_dict()
    for name, _ in state.named_parameters():
        assert torch.equal(after[name], before[name]), name
    assert [g['count'] for g in state.tx.param_groups] == count
    for a, b in zip(opt_before, state.tx.state.values()):
        assert torch.equal(a, b['nu'])
    moved = [k for k in before if k.endswith('running_var')
             and not torch.equal(after[k], before[k])]
    assert moved and not torch.equal(after['norm_factor'],
                                     before['norm_factor'])
    assert int(after['step']) == 2


def test_checkpoint_round_trip(tmp_path):
    """A checkpoint restores the parameters, BatchNorm statistics, norm
    factor, step and optimizer state; a resumed state then takes the same
    step as the original."""
    cfg, state, step_fn = _tiny_port_state()
    gen = torch.Generator().manual_seed(0)
    step_fn(state, _batch_t(0), gen)
    path = save_checkpoint(os.path.join(tmp_path, 'ck.pt'), state)
    _, other, _ = _tiny_port_state(seed=1)
    load_checkpoint(path, other)
    for (k, a), b in zip(state.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), k
    assert [g['count'] for g in other.tx.param_groups] == [1, 1, 1]
    outs = []
    for st in (state, other):
        g = torch.Generator().manual_seed(5)
        outs.append(step_fn(st, _batch_t(1), g))
    for (k, a), b in zip(state.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), k
    assert float(outs[0]['loss']) == float(outs[1]['loss'])
    # filtered restore: the parameters only
    _, third, _ = _tiny_port_state(seed=2)
    load_checkpoint(path, third, filter_fn=lambda k: k == 'params')
    assert int(third.step) == 0 and not third.tx.state


def test_train_loop_runs_on_the_synthetic_dataset(tmp_path):
    """``train_loop`` over the synthetic dataset on the CPU (when the caller
    asks for it): finite losses, a checkpoint per epoch, and resume."""
    cfg = dataclasses.replace(
        tiny_cfg(tconfig, use_pallas=True),
        network=tconfig.NetworkConfig(back_layers_num=18),
        train=tconfig.TrainConfig(lr_epoch_step=(), end_epoch=1,
                                  train_batch_size=2))
    data = SyntheticSixDoFDataset(6, INP, OUT, seed=3)
    seen = []
    state = tmain.train_loop(cfg, data, str(tmp_path), device='cpu',
                             on_step=lambda e, i, m: seen.append(m))
    assert len(seen) == 3 and int(state.step) == 3
    for m in seen:
        assert all(torch.isfinite(v).all() for v in m.values())
    latest = os.path.join(tmp_path, 'latest.pt')
    assert os.path.exists(latest)
    resumed = tmain.train_loop(
        dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, begin_epoch=1, end_epoch=2)), data, str(tmp_path),
        resume_from=latest, device='cpu')
    assert int(resumed.step) == 6
