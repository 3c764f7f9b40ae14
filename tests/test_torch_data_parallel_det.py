"""The port's data-parallel Det training step against the JAX package's
``make_sharded_step``, on the CPU.

JAX: ``det.main.make_sharded_step`` over 2 of the 8 virtual CPU devices
(``tests/conftest.py``), the tiny detector of
``tests/test_torch_det_train.py`` (DCNv2 in the FCOS towers) in float64, a
global batch of 4 images whose two halves differ. The port: 2 processes of
a gloo group (``tests/test_torch_dp_worker.py``), each running
``det.train.make_train_step(data_parallel=True)`` on its rows from the
same weights. The draws are replayed as in the single-device test (each
replica's object samples and AMIS samples come out of the sharded JAX
step, gathered over the mesh axis; the RSLM init is the same stand-in on
both sides). After one step the test holds each replica's loss terms, the
averaged gradients, the update (against optax on the same gradients), the
parameters, the averaged BatchNorm statistics and the EMA normalisers to
JAX at the single-device test's tolerances, and the ranks to each other
bit for bit.

Planted faults: the step's own normalisers left rank-local fail the
rules. JAX's coordinate-regression normaliser ``w_sum`` is not under
``stop_gradient``, so its ``pmean``'s transpose sums the cotangents of the
replicas; but ``w_sum`` is a constant of the parameters (a softmax over
the heads sums to 1), so a plain, non-differentiable ``all_reduce`` for it
passes here, and the gradient of ``replica_mean`` is held in
``tests/test_torch_parallel.py`` instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from epropnp_tpu.det import config as jconfig
from epropnp_tpu.det import main as jmain
from epropnp_tpu.det import train as jtrain
from epropnp_tpu.models.dense_heads import deform_pnp_head as jhead
from epropnp_tpu.models.losses.monte_carlo_pose_loss import (
    MonteCarloPoseLossState as JMCState)
from epropnp_tpu.ops import pnp as jpnp
from epropnp_tpu.ops.pnp import epropnp as jep
from epropnp_tpu.ops.pnp import levenberg_marquardt as jlm
from epropnp_tpu_torch.det import config as tconfig
from epropnp_tpu_torch.utils.convert import det_state_dict, det_variables
from epropnp_tpu_torch.utils.synthetic import make_det_batch
from test_torch_det_train import (JAX_INIT, _flax_variables, _is_dcn_bias,
                                  _leafwise)
import test_torch_dp_worker as worker

torch.set_num_threads(1)
GLOBAL_IMG, REPLICAS = 4, 2


def _global_batch():
    """4 seeded images (float64 where float32): 0-1 for replica 0, 2-3
    for 1."""
    b = make_det_batch(31, GLOBAL_IMG, worker.DET_HW, worker.DET_HW)
    return {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in b.items()}


def _jax_reference(model, variables, cfg, batch):
    """One step of ``make_sharded_step`` over 2 devices; out of the same
    program each replica's object samples, AMIS samples (in the solver's
    normalised frame) and losses gathered over the mesh axis, and the
    averaged gradients (the tree ``optax.global_norm`` receives after the
    step's ``pmean``)."""
    tx = jtrain.make_optimizer(cfg)
    stash = {}
    real_sampler = jtrain.obj_sampler
    real_mc = jep.EProPnPBase.monte_carlo_forward
    real_norm = optax.global_norm
    real_losses = jtrain.compute_losses
    real_mc_loss = jtrain.monte_carlo_pose_loss

    def mc_loss(logweights, cost_target, *args, **kwargs):
        stash['pose_terms'] = cost_target + jax.scipy.special.logsumexp(
            logweights, axis=0)
        return real_mc_loss(logweights, cost_target, *args, **kwargs)

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
        total, (losses, bs, ema) = real_losses(*args, **kwargs)
        return total, (dict(losses, _point_inds=stash.pop('point_inds'),
                            _samples=stash.pop('samples'),
                            _pose_terms=stash.pop('pose_terms')), bs, ema)

    def global_norm(tree):
        stash.setdefault('grads', tree)
        return real_norm(tree)

    train_step = jtrain.make_train_step(model, cfg, tx, axis_name='data')

    def ref_step(state, batch, rng):
        stash.clear()
        new_state, metrics = train_step(state, batch, rng)
        gather = lambda x: jax.lax.all_gather(x, 'data')  # noqa: E731
        inds, samples = metrics.pop('_point_inds'), metrics.pop('_samples')
        terms = metrics.pop('_pose_terms')
        return new_state, dict(
            grads=stash['grads'], point_inds=gather(inds),
            samples=gather(samples), pose_terms=gather(terms),
            metrics=jax.tree_util.tree_map(gather, metrics))

    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, 'compute_losses', compute_losses)
    mp.setattr(jtrain, 'obj_sampler', sampler)
    mp.setattr(jtrain, 'monte_carlo_pose_loss', mc_loss)
    mp.setattr(jep.EProPnPBase, 'monte_carlo_forward', mc)
    mp.setattr(optax, 'global_norm', global_norm)
    mp.setattr(jlm.RSLMSolver, 'solve', JAX_INIT)
    try:
        step, _ = jmain.make_sharded_step(ref_step, n_devices=REPLICAS)
        # the EMA normalisers in f64, as the port's buffers
        state = jtrain.DetTrainState.create(variables, tx)
        state = state.replace(ema=jhead.HeadEMAState(
            pose_norm_factor=(JMCState.create(dtype=jnp.float64),),
            proj_mean_inv_std=jnp.asarray(1.0, jnp.float64)))
        new_state, out = step(state, jtrain.DetBatch(**{
            k: jnp.asarray(v) for k, v in batch.items()}),
            jax.random.PRNGKey(11))
    finally:
        mp.undo()
    return jax.tree_util.tree_map(np.asarray, dict(
        out, params=new_state.params, batch_stats=new_state.batch_stats,
        ema=new_state.ema))


@pytest.fixture(scope='module')
def reference():
    model, variables = _flax_variables()
    batch = _global_batch()
    return variables, batch, _jax_reference(
        model, variables, worker.det_cfg(jconfig), batch)


def _port_step(reference, workdir, *extra):
    """The port's 2-rank step on the reference's inputs: both ranks'
    outputs."""
    variables, batch, ref = reference
    cfg = worker.det_cfg(tconfig)
    torch.save({k: v.double() if v.is_floating_point() else v
                for k, v in det_state_dict(variables, cfg).items()},
               workdir / 'det_init.pt')
    np.savez(workdir / 'det_in.npz', point_inds=ref['point_inds'],
             samples=ref['samples'], **batch)
    worker.spawn('det', str(workdir), 2, *extra)
    return [torch.load(workdir / f'det_out_{r}.pt', weights_only=False)
            for r in range(REPLICAS)]


def _gradients(out):
    return det_variables(dict(out['state'], **out['grads']),
                         worker.det_cfg(tconfig))['params']


def _check_losses(out, ref, r, skip=()):
    """Replica ``r``'s loss terms against JAX's: float64, the same draws;
    the K1 twin reduces in another order, so 1e-6 relative, as the
    single-device test.

    The Monte Carlo pose loss is held object by object: an object whose
    term moves by more than 1e-9 of itself when the port's own forward
    runs on images scaled by 1 + 1e-12 is ill-conditioned (its proposal's
    covariance inverts a near-singular JtJ: ``tests/test_torch_det_train.py``
    keeps to one step for it), and no implementation can agree on it to
    1e-6; it is left out, and there may be one such object in eight. Every
    other object's term is held to 1e-6, and the loss itself too when no
    object is left out."""
    terms, jterms = out['pose_terms'], ref['pose_terms'][r]
    unstable = np.abs(out['pose_terms_perturbed'] - terms) \
        > 1e-9 * np.abs(terms)
    assert unstable.sum() <= len(terms) // 8, (r, unstable)
    np.testing.assert_allclose(terms[~unstable], jterms[~unstable],
                               rtol=1e-6, atol=1e-12,
                               err_msg=f'replica {r} pose terms')
    for name, value in ref['metrics'].items():
        if name in skip or (name == 'loss_pose_0' and unstable.any()):
            continue
        np.testing.assert_allclose(out['metrics'][name], value[r],
                                   rtol=1e-6, atol=1e-12,
                                   err_msg=f'replica {r} {name}')


def _check_gradients(out, ref):
    """The averaged gradients against JAX's: the single-device test's rule
    (1e-6 of each leaf, or 1e-9 of the largest gradient for a leaf that is
    0 but for rounding; the DCN biases, which the port lacks, are 0)."""
    for path, g in jax.tree_util.tree_leaves_with_path(ref['grads']):
        if _is_dcn_bias(path):
            assert np.abs(g).max() <= 1e-12, jax.tree_util.keystr(path)
    _leafwise(_gradients(out), ref['grads'], 1e-6, 'averaged gradients',
              floor=1e-9)


def test_data_parallel_step_matches_jax(reference, tmp_path):
    variables, batch, ref = reference
    assert not np.array_equal(batch['img'][:2], batch['img'][2:])
    assert not np.array_equal(ref['point_inds'][0], ref['point_inds'][1])
    outs = _port_step(reference, tmp_path)
    for k, v in outs[0]['state'].items():
        np.testing.assert_array_equal(outs[1]['state'][k], v, err_msg=k)
    assert outs[0]['ema'] == outs[1]['ema']
    for r, out in enumerate(outs):
        assert set(out['metrics']) - {'skipped'} == set(ref['metrics'])
        assert out['metrics']['skipped'] == 0
        _check_losses(out, ref, r)
    _check_gradients(outs[0], ref)
    cfg = worker.det_cfg(tconfig)
    new = det_variables(outs[0]['state'], cfg)
    old = jax.tree_util.tree_map(np.asarray, variables)
    delta = jax.tree_util.tree_map(np.subtract, new['params'],
                                   old['params'])
    # the update against optax's chain on the same (averaged) gradients
    # (tests/test_torch_det_train.py says why not against JAX's update)
    tx = jtrain.make_optimizer(worker.det_cfg(jconfig))
    optax_delta, _ = tx.update(_gradients(outs[0]), tx.init(old['params']),
                               old['params'])
    _leafwise(delta, jax.tree_util.tree_map(np.asarray, optax_delta), 1e-6,
              'updates')
    # the parameters against JAX's where Adam's first update is not
    # ill-conditioned: after the clip (5 / |g|) its step is lr g / (|g| +
    # eps), whose derivative lr eps / (|g| + eps)^2 turns the gradients'
    # 1e-6 into an error ~1e3 times larger where |g| ~ eps. Where the
    # clipped gradient is at least 1e3 eps the update's error is below
    # 1e-6 of lr, and the parameters are held to 1e-6 there
    clip = min(1.0, cfg.train.grad_clip
               / float(ref['metrics']['grad_norm'][0]))
    well_posed = jax.tree_util.tree_map(
        lambda g: np.abs(g) * clip >= 1e3 * 1e-8, ref['grads'])
    _leafwise(jax.tree_util.tree_map(lambda p, m: np.where(m, p, 0.0),
                                     new['params'], well_posed),
              jax.tree_util.tree_map(lambda p, m: np.where(m, p, 0.0),
                                     ref['params'], well_posed),
              1e-6, 'params', floor=1e-9, skip=_is_dcn_bias)
    held = sum(int(m.sum()) for m in jax.tree_util.tree_leaves(well_posed))
    total = sum(m.size for m in jax.tree_util.tree_leaves(well_posed))
    assert held > 0.9 * total, (held, total)
    _leafwise(new['batch_stats'], ref['batch_stats'], 1e-9,
              'averaged BatchNorm statistics')
    np.testing.assert_allclose(outs[0]['ema']['pose_norm_factor'],
                               ref['ema'].pose_norm_factor[0].norm_factor,
                               rtol=1e-6)
    np.testing.assert_allclose(outs[0]['ema']['proj_mean_inv_std'],
                               ref['ema'].proj_mean_inv_std, rtol=1e-6)


@pytest.mark.parametrize('plant', ['plain', 'local'])
def test_planted_faults_in_the_normalisers(reference, tmp_path, plant):
    """Planted faults in the step's own normalisers.

    ``local``: ``num_act``, ``w_sum`` and ``velo_w``'s sum left rank-local
    (no mean over the replicas): the losses and the gradients miss JAX's.

    ``plain``: ``w_sum`` averaged by an in-place, non-differentiable
    ``all_reduce``, the trap of a plain collective. JAX's gradient through
    its ``pmean`` is 0 here all the same: ``x3d_w`` is a softmax over the
    heads times weights that do not depend on the parameters, so its sum
    is a constant of them, and the planted step passes the rules. What
    ``replica_mean``'s gradient must be is held where it is not 0, in
    ``tests/test_torch_parallel.py::test_mesh_collectives_on_two_ranks``
    (whose planted in-place mean fails)."""
    _, _, ref = reference
    outs = _port_step(reference, tmp_path, plant)
    if plant == 'plain':
        for r, out in enumerate(outs):
            _check_losses(out, ref, r)
        _check_gradients(outs[0], ref)
        return
    with pytest.raises(AssertionError, match='replica 0'):
        _check_losses(outs[0], ref, 0, skip=('grad_norm',))
    with pytest.raises(AssertionError, match='averaged gradients'):
        _check_gradients(outs[0], ref)
