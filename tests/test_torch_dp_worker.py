"""A rank of the port's data-parallel CPU tests: one process of a gloo
group of ``torch.distributed``, which imports neither jax nor
``epropnp_tpu`` (the port's own rule).

  python tests/test_torch_dp_worker.py MODE RANK WORLD PORT WORKDIR [PLANT]

The rank joins the group through ``parallel.mesh.init_data_parallel``
from the ``torchrun`` environment that :func:`spawn` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), runs
MODE on the CPU and writes its outputs under WORKDIR with ``torch.save``:

* ``mesh``: ``replica_mean`` (value and gradient), ``mean_gradients``,
  ``mean_buffers``, ``broadcast_state``, ``gather_to_main`` and
  ``HostShardSampler``'s defaults on distinct per-rank data; PLANT
  ``plain`` takes the mean by a plain in-place ``all_reduce`` instead;
* ``sixdof`` / ``det``: one data-parallel training step of the tiny CDPN
  / detector (``tests/test_torch_sixdof_train.py``,
  ``tests/test_torch_det_train.py``) in float64 on this rank's rows of the
  global batch in ``WORKDIR/<mode>_in.npz``, from the weights in
  ``WORKDIR/<mode>_init.pt``, with the draws of the JAX reference replayed
  (this rank's point subsample or object samples, and AMIS samples) and
  the RSLM init replaced by the tests' deterministic stand-in. For
  ``det``, PLANT ``plain`` takes the mean of the coordinate-regression
  normaliser (``w_sum``, the one normaliser with a gradient path) by a
  plain in-place ``all_reduce``, and ``local`` leaves the step's own
  normalisers (``num_act``, ``w_sum``, ``velo_w``'s sum) rank-local;
* ``det_eval``: ``tools.test_det.evaluate_dataset(data_parallel=True)``
  of the smoke detector on the tree under ``WORKDIR/tree``;
* ``cli``: the three CLIs with ``--data-parallel`` on the CPU:
  ``train_6dof --smoke`` (64x64 crops) on ``WORKDIR/lm``, ``train_det
  --config smoke --no-crop`` on ``WORKDIR/tree``'s ``infos_train4.pkl``
  and ``test_det`` on its ``latest.pt`` over ``infos_val.pkl``.

This module holds no test; the parent tests import its helpers.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the 6DoF step's tiny CDPN (tests/test_torch_sixdof_train.py)
INP, OUT = 64, 16
CAM_K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]])
SIXDOF_FIELDS = ('inp', 'target_coor', 'loss_msk', 'trans_local', 'pose',
                 'c_box', 's_box', 'dim')
# the Det step's tiny detector (tests/test_torch_det_train.py)
DET_HW = 64
DET_OVERRIDES = dict(
    backbone_dcn_stages=(), dcn_on_last_conv=True,
    detector_cfg=dict(
        feat_channels=32, emb_channels=32, cls_branch=(32,),
        centerness_branch=(16,), offset_branch=(32,), emb_branch=(32,),
        regress_ranges=((-1, 16), (16, 32), (32, 1e8))))
# the Det evaluation case: the smoke config on a small tree
EVAL_HW, EVAL_BATCH, EVAL_SEED = (225, 400), 6, 3


def sixdof_cfg(pkg, use_pallas=False):
    """``tests/test_torch_sixdof_train.py::tiny_cfg`` in either package."""
    return pkg.SixDoFConfig(
        dataiter=pkg.DataIterConfig(inp_res=INP, out_res=OUT,
                                    sample_points=32),
        pnp=pkg.PnPConfig(mc_samples=32, num_iter=2, lm_num_iter=2,
                          rs_num_points=8, rs_num_proposals=2, rs_num_iter=1,
                          use_pallas=use_pallas),
        train=pkg.TrainConfig(lr_epoch_step=()))


def det_cfg(pkg, use_pallas=False):
    """``tests/test_torch_det_train.py::tiny_cfg`` in either package."""
    return pkg.DetConfig(
        num_classes=3, backbone_depth=18, embed_dims=32, num_heads=4,
        num_points=4, strides=(4, 8, 16, 32), output_stride=4,
        with_loss_regr=True, num_attrs=4,
        pnp=pkg.DetPnPConfig(mc_samples=16, num_iter=2, lm_num_iter=2,
                             rs_num_points=8, rs_num_proposals=4,
                             rs_num_iter=1, use_pallas=use_pallas),
        train=pkg.DetTrainConfig(num_obj_samples_per_img=4,
                                 roi_shape=(8, 8), max_gt_per_img=4))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def spawn(mode: str, workdir: str, world: int = 2, *extra: str,
          timeout: float = 600.0):
    """Run MODE on ``world`` ranks of a gloo group (one process each, the
    ``torchrun`` environment set) and return their outputs; fails with
    every rank's output if one fails."""
    port = str(free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR='localhost', MASTER_PORT=port,
                   OMP_NUM_THREADS='1')
        env.pop('PYTEST_CURRENT_TEST', None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(r),
             str(world), port, workdir, *extra], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, '\n'.join(
        f'--- rank {r} (exit {c}):\n{o}' for r, (c, o) in
        enumerate(zip(codes, outs)))
    return outs


def identity_init(evaluate_pnp, cat, rot0):
    """The tests' deterministic stand-in of ``RSLMSolver.solve``: the
    centre-based translation and the identity rotation (``rot0``), with
    its cost."""
    def solve(self, x3d, x2d, w2d, camera, cost_fun, rng=None, **kwargs):
        t = self.center_based_init(x2d, x3d, camera)
        pose = cat([t, rot0(t)], -1)
        cost = evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                            out_cost=True).cost
        return pose, None, cost
    return solve


# ----------------------------------------------------------------- ranks

def plain_mean(x):
    """The mean over the ranks by an in-place ``all_reduce`` of a detached
    copy: the right value, no gradient (the trap ``replica_mean``
    avoids)."""
    import torch.distributed as dist
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / dist.get_world_size()


def _run_mesh(rep, workdir, plant):
    import torch
    from torch import nn
    from epropnp_tpu_torch.parallel import mesh
    from epropnp_tpu_torch.parallel.sampler import HostShardSampler
    r = rep.rank
    torch.manual_seed(100 + r)  # distinct data on every rank
    x = torch.randn(5, dtype=torch.float64, requires_grad=True)
    w = torch.randn(5, dtype=torch.float64)
    # loss_r = (w . x) / pmean(sum x^2): the mean's gradient sums over ranks
    m = (plain_mean if plant == 'plain' else mesh.replica_mean)(
        x.square().sum())
    loss = (w * x).sum() / m
    loss.backward()
    lin = nn.Linear(3, 2).double()
    bn = nn.BatchNorm1d(2).double()
    lin(torch.randn(4, 3, dtype=torch.float64)).sum().backward()
    bn.train()
    bn(torch.randn(6, 2, dtype=torch.float64))
    before = {'running_mean': bn.running_mean.clone(),
              'running_var': bn.running_var.clone()}
    lin.bias.grad = None  # an unused parameter: zeros in the mean
    local = [lin.weight.grad.clone(), torch.zeros(2, dtype=torch.float64)]
    mesh.mean_gradients(lin.parameters())
    mesh.mean_buffers(bn)
    other = nn.Linear(2, 2)
    mesh.broadcast_state(other)
    gathered = mesh.gather_to_main({'rank': r, 'x': x.detach()})
    torch.save(dict(
        rank=r, x=x.detach(), w=w, m=m.detach(), x_grad=x.grad,
        local_grads=local, mean_grads=[p.grad for p in lin.parameters()],
        bn_before=before, bn_after={'running_mean': bn.running_mean,
                                    'running_var': bn.running_var},
        broadcast=[p.detach() for p in other.parameters()],
        gathered=gathered, rows=mesh.rank_rows(8),
        sampler=HostShardSampler(num_samples=10, seed=4).epoch_indices(0)),
        os.path.join(workdir, f'mesh_out_{r}.pt'))


def _replay(monkeypatch_pairs):
    for obj, name, value in monkeypatch_pairs:
        setattr(obj, name, value)


def _run_sixdof(rep, workdir):
    import torch
    from epropnp_tpu_torch.models.cdpn import CDPN
    from epropnp_tpu_torch.ops import pnp as tpnp
    from epropnp_tpu_torch.ops.pnp import epropnp as tep
    from epropnp_tpu_torch.ops.pnp import levenberg_marquardt as tlm
    from epropnp_tpu_torch.parallel import mesh
    from epropnp_tpu_torch.sixdof import config as tconfig
    from epropnp_tpu_torch.sixdof import train as ttrain
    cfg = sixdof_cfg(tconfig, use_pallas=True)
    data = np.load(os.path.join(workdir, 'sixdof_in.npz'))
    feat = INP // 32
    model = CDPN(depth=18, rot_filters=32, trans_filters=32,
                 feat_hw=(feat, feat)).double()
    model.load_state_dict(torch.load(os.path.join(workdir,
                                                  'sixdof_init.pt')))
    state = ttrain.TrainState(model, ttrain.make_optimizer(cfg, model))
    step = ttrain.make_train_step(ttrain.build_epropnp(cfg), cfg,
                                  torch.from_numpy(CAM_K),
                                  data_parallel=True)
    r = rep.rank
    samples = list(torch.from_numpy(data['samples'][r]).reshape(
        cfg.pnp.num_iter, -1, *data['samples'].shape[2:]))
    _replay([
        (tlm.RSLMSolver, 'solve', identity_init(
            tpnp.evaluate_pnp, torch.cat,
            lambda t: t.new_tensor([1.0, 0, 0, 0]).expand(
                t.shape[:-1] + (4,)))),
        (ttrain, 'sample_point_indices',
         lambda bs, n, num, gen, device: torch.from_numpy(
             data['inds'][r].astype(np.int64))),
        (tep, 'draw_pose_samples',
         lambda trans, rot, num, gen: samples.pop(0).clone())])
    rows = mesh.rank_rows(len(data['inp']))
    batch = ttrain.Batch(*(torch.from_numpy(data[k][rows])
                           for k in SIXDOF_FIELDS))
    metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert not samples, 'both AMIS draws replayed'
    torch.save(dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: p.grad.numpy() for n, p in model.named_parameters()},
        state={k: v.numpy() for k, v in model.state_dict().items()},
        norm_factor=float(state.norm_factor)),
        os.path.join(workdir, f'sixdof_out_{r}.pt'))


def _run_det(rep, workdir, plant):
    import torch
    from epropnp_tpu_torch.det import api as tapi
    from epropnp_tpu_torch.det import config as tconfig
    from epropnp_tpu_torch.det import main as tmain
    from epropnp_tpu_torch.det import train as ttrain
    from epropnp_tpu_torch.models.dense_heads import deform_pnp_head as thead
    from epropnp_tpu_torch.ops import pnp as tpnp
    from epropnp_tpu_torch.ops.pnp import epropnp as tep
    from epropnp_tpu_torch.ops.pnp import levenberg_marquardt as tlm
    from epropnp_tpu_torch.parallel import mesh
    from epropnp_tpu_torch.utils.synthetic import DET_BATCH_FIELDS
    import copy
    cfg = det_cfg(tconfig, use_pallas=True)
    data = np.load(os.path.join(workdir, 'det_in.npz'))
    model = tapi.build_detector(cfg, **DET_OVERRIDES).double()
    model.load_state_dict(torch.load(os.path.join(workdir, 'det_init.pt')))
    state = ttrain.DetTrainState(model, ttrain.make_optimizer(cfg, model))
    step = ttrain.make_train_step(cfg, data_parallel=True)
    r = rep.rank

    def replayed():
        return list(torch.from_numpy(data['samples'][r].copy()).reshape(
            cfg.pnp.num_iter, -1, *data['samples'].shape[2:]))
    samples = replayed()
    # each object's Monte Carlo pose term, cost_target + logsumexp
    pose_terms = []
    real_mc_loss = ttrain.monte_carlo_pose_loss

    def mc_loss(logweights, cost_target, *args, **kwargs):
        pose_terms.append((cost_target + torch.logsumexp(logweights, 0))
                          .detach().numpy().copy())
        return real_mc_loss(logweights, cost_target, *args, **kwargs)
    _replay([(ttrain, 'monte_carlo_pose_loss', mc_loss),
        (tlm.RSLMSolver, 'solve', identity_init(
            tpnp.evaluate_pnp, torch.cat,
            lambda t: torch.zeros_like(t[..., :1]))),
        (thead, 'draw_object_samples',
         lambda gen, fg_mask, prob, n_u, n_r: torch.from_numpy(
             data['point_inds'][r].astype(np.int64))),
        (tep, 'draw_pose_samples',
         lambda trans, rot, num, gen: samples.pop(0).clone())])
    planted = []
    real = ttrain.replica_mean

    def planted_mean(x):
        if plant == 'local' or (plant == 'plain' and x.requires_grad):
            planted.append(x.detach().clone())
            return x if plant == 'local' else plain_mean(x)
        return real(x)
    ttrain.replica_mean = planted_mean
    rows = mesh.rank_rows(len(data['img']))
    batch = tmain.to_device(tuple(
        data[k][rows] if k in data else None for k in DET_BATCH_FIELDS),
        'cpu', torch.float64)
    # the same forward on images scaled by 1 + 1e-12 (a copy of the
    # model): the pose terms that move by more than 1e-9 of themselves are
    # ill-conditioned in the port itself
    with torch.no_grad():
        ttrain.compute_losses(
            copy.deepcopy(model).train(), cfg,
            batch._replace(img=batch.img * (1 + 1e-12)), state.ema,
            torch.Generator().manual_seed(0), data_parallel=True)
    perturbed = pose_terms.pop()
    assert not samples and not pose_terms
    samples.extend(replayed())
    planted.clear()
    metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert not samples, 'both AMIS draws replayed'
    assert len(planted) == {'plain': 1, 'local': 3}.get(plant, 0), planted
    ema = state.ema
    torch.save(dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: p.grad.numpy() for n, p in model.named_parameters()},
        state={k: v.numpy() for k, v in model.state_dict().items()},
        ema=dict(pose_norm_factor=float(ema.pose_norm_factor[0].norm_factor),
                 proj_mean_inv_std=float(ema.proj_mean_inv_std)),
        pose_terms=pose_terms[0], pose_terms_perturbed=perturbed),
        os.path.join(workdir, f'det_out_{r}.pt'))


def eval_model(device='cpu'):
    """The smoke detector from a seed (``det.main.build_all``) in eval
    mode, and its config."""
    from epropnp_tpu_torch.det import main as tmain
    from epropnp_tpu_torch.det.config import DetConfig
    cfg = DetConfig.smoke()
    model, _ = tmain.build_all(cfg, device, seed=EVAL_SEED)
    return model.eval(), cfg


def _run_det_eval(rep, workdir):
    import torch
    from epropnp_tpu_torch.det.nuscenes_dataset import NuScenes3DDataset
    from epropnp_tpu_torch.tools import test_det
    model, cfg = eval_model()
    tree = os.path.join(workdir, 'tree')
    dataset = NuScenes3DDataset(os.path.join(tree, 'infos_val.pkl'),
                                img_prefix=tree)
    with torch.no_grad():
        metrics = test_det.evaluate_dataset(
            model, cfg, dataset, tree, os.path.join(workdir, 'dp_eval'),
            batch_size=EVAL_BATCH, rng=torch.Generator().manual_seed(0),
            data_parallel=True)
    torch.save(dict(metrics=metrics), os.path.join(
        workdir, f'det_eval_out_{rep.rank}.pt'))


def _run_cli(rep, workdir):
    import dataclasses
    import torch
    from epropnp_tpu_torch.sixdof import config as sconfig
    from epropnp_tpu_torch.tools import test_det, train_6dof, train_det

    @dataclasses.dataclass(frozen=True)
    class SmallCrops(sconfig.SixDoFConfig):
        dataiter: sconfig.DataIterConfig = dataclasses.field(
            default_factory=lambda: sconfig.DataIterConfig(inp_res=64,
                                                           out_res=16))
    train_6dof.SixDoFConfig = SmallCrops
    tree = os.path.join(workdir, 'tree')
    out = {}
    state = train_6dof.main([
        '--data', os.path.join(workdir, 'lm'), '--save',
        os.path.join(workdir, 'run6d'), '--smoke', '--batch-size', '4',
        '--epochs', '1', '--device', 'cpu', '--data-parallel'])
    out['sixdof_step'] = int(state.step)
    state = train_det.main([
        '--config', 'smoke', '--ann', os.path.join(tree, 'infos_train4.pkl'),
        '--data', tree, '--save', os.path.join(workdir, 'rundet'),
        '--no-crop', '--device', 'cpu', '--data-parallel'])
    out['det_step'] = int(state.step)
    with torch.no_grad():
        metrics = test_det.main([
            '--config', 'smoke', '--checkpoint',
            os.path.join(workdir, 'rundet', 'latest.pt'), '--ann',
            os.path.join(tree, 'infos_val.pkl'), '--data', tree, '--out',
            os.path.join(workdir, 'eval'), '--device', 'cpu',
            '--data-parallel'])
    out['metrics'] = None if metrics is None else {
        k: metrics[k] for k in ('nd_score', 'mean_ap')}
    torch.save(out, os.path.join(workdir, f'cli_out_{rep.rank}.pt'))


def main():
    mode, workdir = sys.argv[1], sys.argv[5]
    plant = sys.argv[6] if len(sys.argv) > 6 else None
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    from epropnp_tpu_torch.parallel import mesh
    rep = mesh.init_data_parallel('cpu')
    assert rep.backend == 'gloo' and rep.rank == int(sys.argv[2]) \
        and rep.world == int(sys.argv[3])
    try:
        if mode == 'mesh':
            _run_mesh(rep, workdir, plant)
        elif mode == 'sixdof':
            _run_sixdof(rep, workdir)
        elif mode == 'det':
            _run_det(rep, workdir, plant)
        elif mode == 'det_eval':
            _run_det_eval(rep, workdir)
        elif mode == 'cli':
            _run_cli(rep, workdir)
        else:
            raise ValueError(mode)
        mesh.barrier()
    finally:
        torch.distributed.destroy_process_group()
    assert 'jax' not in sys.modules and 'epropnp_tpu' not in sys.modules


if __name__ == '__main__':
    main()
