"""The port's data-parallel 6DoF training step against the JAX package's
``make_sharded_step``, on the CPU.

JAX: ``sixdof.main.make_sharded_step`` over 2 of the 8 virtual CPU devices
(``tests/conftest.py``), the tiny CDPN of ``tests/test_torch_sixdof_train.py``
in float64, a global batch of 4 crops whose two halves differ. The port: 2
processes of a gloo group (``tests/test_torch_dp_worker.py``), each
running ``sixdof.train.make_train_step(data_parallel=True)`` on its rows
from the same weights. The draws are replayed as in the single-device
test: each replica's point subsample and AMIS samples come out of the
sharded JAX step (gathered over the mesh axis), and the RSLM init is the
same deterministic stand-in on both sides. After one step the test holds
every loss term of each replica, the averaged gradients, the updates, the
parameters, the averaged BatchNorm statistics and the ``norm_factor``
EMA (averaged over the replicas) to JAX at the single-device test's
tolerances, and the two ranks' states to each other bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from epropnp_tpu.models.losses.monte_carlo_pose_loss import (
    MonteCarloPoseLossState as JMCState)
from epropnp_tpu.ops import pnp as jpnp
from epropnp_tpu.ops.pnp import levenberg_marquardt as jlm
from epropnp_tpu.sixdof import config as jconfig
from epropnp_tpu.sixdof import main as jmain
from epropnp_tpu.sixdof import train as jtrain
from epropnp_tpu_torch.utils.convert import cdpn_state_dict, cdpn_variables
from epropnp_tpu_torch.utils.synthetic import make_sixdof_batch
from test_torch_sixdof_train import JAX_INIT, _flax_variables, _leafwise
import test_torch_dp_worker as worker

torch.set_num_threads(1)
GLOBAL_BS, REPLICAS = 4, 2


def _global_batch():
    """4 seeded crops (float64): rows 0-1 for replica 0, 2-3 for 1."""
    return {k: v.astype(np.float64) for k, v in make_sixdof_batch(
        21, GLOBAL_BS, worker.INP, worker.OUT).items()}


def _jax_reference(model, variables, cfg, batch):
    """One step of ``make_sharded_step`` over 2 devices; out of the same
    sharded program, each replica's point subsample, AMIS samples and
    metrics gathered over the mesh axis, and the averaged gradients (the
    tree ``optax.global_norm`` receives after the step's ``pmean``)."""
    epropnp = jtrain.build_epropnp(cfg)
    tx = jtrain.make_optimizer(cfg)
    cam = jnp.asarray(worker.CAM_K)
    step_fn = jtrain.make_train_step(model, epropnp, cfg, tx, cam,
                                     axis_name='data')
    out_res, sp = cfg.dataiter.out_res, cfg.dataiter.sample_points
    local_bs = GLOBAL_BS // REPLICAS
    stash = {}
    real_norm = optax.global_norm

    def global_norm(tree):
        stash.setdefault('grads', tree)
        return real_norm(tree)

    def ref_step(state, batch, rng):
        stash.clear()
        k_sample, k_mc = jax.random.split(rng)
        inds = jax.vmap(lambda k: jax.random.choice(
            k, out_res * out_res, (sp,), replace=False))(
            jax.random.split(k_sample, local_bs))
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
        new_state, metrics = step_fn(state, batch, rng)
        gather = lambda x: jax.lax.all_gather(x, 'data')  # noqa: E731
        return new_state, dict(
            grads=stash['grads'], inds=gather(inds),
            samples=gather(samples),
            metrics=jax.tree_util.tree_map(gather, metrics))

    mp = pytest.MonkeyPatch()
    mp.setattr(jlm.RSLMSolver, 'solve', JAX_INIT)
    mp.setattr(optax, 'global_norm', global_norm)
    try:
        step, _ = jmain.make_sharded_step(ref_step, n_devices=REPLICAS)
        state = jtrain.TrainState.create(variables, tx)
        state = state.replace(mc_state=JMCState.create(dtype=jnp.float64))
        new_state, out = step(state, jtrain.Batch(*(
            jnp.asarray(batch[k]) for k in worker.SIXDOF_FIELDS)),
            jax.random.PRNGKey(7))
    finally:
        mp.undo()
    return jax.tree_util.tree_map(np.asarray, dict(
        out, params=new_state.params, batch_stats=new_state.batch_stats,
        norm_factor=new_state.mc_state.norm_factor))


@pytest.fixture(scope='module')
def reference():
    model, variables = _flax_variables()
    batch = _global_batch()
    return variables, batch, _jax_reference(
        model, variables, worker.sixdof_cfg(jconfig), batch)


def test_data_parallel_step_matches_jax(reference, tmp_path):
    variables, batch, ref = reference
    # the replicas see different data, and JAX replayed different draws
    assert not np.array_equal(batch['inp'][:2], batch['inp'][2:])
    assert not np.array_equal(ref['samples'][0], ref['samples'][1])
    torch.save({k: v.double() if v.is_floating_point() else v
                for k, v in cdpn_state_dict(variables, depth=18).items()},
               tmp_path / 'sixdof_init.pt')
    np.savez(tmp_path / 'sixdof_in.npz', inds=ref['inds'],
             samples=ref['samples'], **batch)
    worker.spawn('sixdof', str(tmp_path))
    outs = [torch.load(tmp_path / f'sixdof_out_{r}.pt', weights_only=False)
            for r in range(REPLICAS)]

    # the replicas end bit-identical: parameters, statistics, EMA
    for k, v in outs[0]['state'].items():
        np.testing.assert_array_equal(outs[1]['state'][k], v, err_msg=k)
    assert outs[0]['norm_factor'] == outs[1]['norm_factor']
    for r, out in enumerate(outs):
        # each replica's own losses on its rows (float64 on both sides with
        # the same draws; the K1 twin reduces in another order: 1e-6
        # relative, as the single-device test)
        assert set(out['metrics']) - {'skipped'} == set(ref['metrics'])
        assert out['metrics']['skipped'] == 0
        for name, value in ref['metrics'].items():
            np.testing.assert_allclose(out['metrics'][name], value[r],
                                       rtol=1e-6, atol=1e-12,
                                       err_msg=f'replica {r} {name}')
    sd = outs[0]['state']
    grads = cdpn_variables(dict(sd, **outs[0]['grads']),
                           depth=18)['params']
    _leafwise(grads, ref['grads'], 1e-6, 'averaged gradients')
    new = cdpn_variables(sd, depth=18)
    delta = jax.tree_util.tree_map(np.subtract, new['params'],
                                   variables['params'])
    ref_delta = jax.tree_util.tree_map(np.subtract, ref['params'],
                                       variables['params'])
    _leafwise(delta, ref_delta, 1e-6, 'updates')
    _leafwise(new['params'], ref['params'], 1e-6, 'params')
    _leafwise(new['batch_stats'], ref['batch_stats'], 1e-9,
              'averaged BatchNorm statistics')
    np.testing.assert_allclose(outs[0]['norm_factor'], ref['norm_factor'],
                               rtol=1e-9)


def test_world_of_one_step_equals_the_plain_step(tmp_path):
    """In a group of one, the data-parallel step (every collective over one
    rank) leaves the same state, bit for bit, as the plain step of the
    same seed on the same batch, with the K1 twin and the real draws."""
    import subprocess
    import sys
    code = '''
import sys, torch, numpy as np
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
import test_torch_dp_worker as worker
from epropnp_tpu_torch.parallel import mesh
from epropnp_tpu_torch.sixdof import config, main, train
from epropnp_tpu_torch.utils.synthetic import make_sixdof_batch
torch.set_num_threads(1)
cfg = worker.sixdof_cfg(config, use_pallas=True)
b = make_sixdof_batch(3, 2, worker.INP, worker.OUT)
batch = train.Batch(*(torch.from_numpy(b[k]) for k in worker.SIXDOF_FIELDS))
states = []
for dp in (False, True):
    if dp:
        assert mesh.init_data_parallel('cpu').world == 1
    model, _, step = main.build_all(cfg, worker.CAM_K, 'cpu', dp)
    state = main.init_state(cfg, model, seed=0)
    for i in range(2):
        step(state, batch, torch.Generator().manual_seed(i))
    states.append(state.state_dict())
for k, v in states[0].items():
    assert torch.equal(v, states[1][k]), k
torch.distributed.destroy_process_group()
print('same')
'''.format(repo=worker.REPO, tests=os.path.dirname(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')}
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0 and 'same' in out.stdout, out.stderr
