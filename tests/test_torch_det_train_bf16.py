"""The port's Det training with the JAX package's training options
(``bf16_backbone``, ``bf16_dense``, ``level_packed_towers``,
``remat_dense``) against the JAX package, remat against the plain step,
and the training loop's prefetch.

The tiny detector of ``tests/test_torch_det_train.py`` (ResNet-18, 32-wide
head with DCNv2 in the FCOS towers, 64x64 images), whose helpers this file
shares: the f64 flax variables, JAX's step with the sampler's and the
AMIS draws taken out (jitted once here, for the model with the options
on), the RSLM stand-in on both sides. The models compute in f64 but for
the bf16 backbone, FPN and dense stage, in both packages.

Forward (the JAX package's ``tests/test_mixed_precision.py`` Det tests):
the dense outputs with a bf16 backbone or a bf16 dense stage, f64 and
finite, under the serving rule (``tests/test_torch_mixed_precision.py``)
against JAX's full-precision and bf16 models.

The bf16 step: rounding dominates a random detector's bf16 gradients in
either package (they lie 0.6-1.1 of their norm from the f64 step's; the
Monte Carlo pose loss and the regularisation of the solve's pose move by
up to 0.3 of their value), so the step is held to JAX's by the f64 yardstick
of ``tests/test_torch_mixed_precision.py`` (``GradYardstick``,
``_loss_rule``): over BATCHES batches, the port's bf16 step no further
from the f64 step than 1.5x JAX's bf16 step, with the terms that follow a
solve's pose named, and its gradients' cosine to the f64 step's within
0.2 of JAX's in each group of leaves, K3's own leaves a group.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_det_train as T  # noqa: E402
from test_torch_mixed_precision import (  # noqa: E402
    GradYardstick, _loss_rule, _serving_rule, check_with_faults,
    planted_faults)

from epropnp_tpu.det import config as jconfig  # noqa: E402
from epropnp_tpu.det.api import build_detector as jbuild  # noqa: E402
from epropnp_tpu_torch.det import config as tconfig  # noqa: E402
from epropnp_tpu_torch.det import main as tmain  # noqa: E402
from epropnp_tpu_torch.det import train as ttrain  # noqa: E402
from epropnp_tpu_torch.models.dense_heads import (  # noqa: E402
    deform_pnp_head as thead)
from epropnp_tpu_torch.models.norm import BatchNorm2d  # noqa: E402
from epropnp_tpu_torch.ops import dcn_kernel  # noqa: E402
from epropnp_tpu_torch.ops.pnp import epropnp as tep  # noqa: E402
from epropnp_tpu_torch.ops.pnp import levenberg_marquardt as tlm  # noqa: E402
from epropnp_tpu_torch.utils.convert import det_variables  # noqa: E402
from epropnp_tpu_torch.utils.synthetic import (  # noqa: E402
    DET_BATCH_FIELDS, make_det_batch)

torch.set_num_threads(1)
OPTIONS = dict(bf16_backbone=True, bf16_dense=True, level_packed_towers=True,
               remat_dense=True)
BATCHES = 4
# The Monte Carlo pose loss (AMIS proposals around the solve's pose) and
# the derivative regularisation of the solve's yaw: over these batches the
# port's bf16 step moves them by up to 0.14 and 0.27 of their RMS value
# (RMS 0.088 and 0.14), JAX's by up to 0.07 and 0.13 (RMS 0.039 and 0.081):
# beyond 1.5x JAX's + 2e-2 in the port. The other pose terms (ate,
# loss_reg_pos, loss_velo, loss_score) meet the rule.
CHAOTIC_DET = ('loss_pose_0', 'loss_reg_orient')


def _dense_flat(out):
    det_outs, key, value = out
    return [a for o in det_outs for a in tuple(o)[:4]] + [key, value]


@pytest.fixture(scope='module')
def variables():
    return T._flax_variables()[1]


@pytest.mark.parametrize('option', ['bf16_backbone', 'bf16_dense'])
def test_det_bf16_forward_matches_jax(variables, option):
    """The dense forward (eval mode) with a bf16 backbone and FPN, or a bf16
    dense stage (towers and key/value) on the level-packed canvas: the
    outputs come back in the model's dtype, finite, under the serving rule
    against JAX's full-precision and bf16 models (the JAX package's
    ``tests/test_mixed_precision.py`` Det tests, with JAX as the
    reference)."""
    opts = {option: True, 'level_packed_towers': option == 'bf16_dense'}
    img = T._batch(0)['img']

    def jax_dense(o):
        cfg = dataclasses.replace(T.tiny_cfg(jconfig), **o)
        m = jbuild(cfg, dtype=jnp.float64, **T.OVERRIDES)
        out = m.apply(variables, jnp.asarray(img), (T.H, T.W), train=False,
                      method=m.det_dense)
        return [np.asarray(a, np.float64) for a in _dense_flat(out)]
    ref, jbf = jax_dense({}), jax_dense(opts)
    cfg = dataclasses.replace(T.tiny_cfg(tconfig), **opts)
    state = T._port_state(variables, cfg)
    with torch.no_grad():
        got = _dense_flat(state.model.eval().det_dense(
            torch.from_numpy(img), (T.H, T.W)))
    assert len(got) == len(ref) == 14
    for i, (p, r, j) in enumerate(zip(got, ref, jbf)):
        assert p.dtype == torch.float64 and torch.isfinite(p).all(), i
        _serving_rule(p.numpy(), r, j, i)


@pytest.fixture(scope='module')
def bf16_reference(variables):
    """JAX's step with OPTIONS on each of BATCHES batches from the same
    state (one jit)."""
    cfg = dataclasses.replace(T.tiny_cfg(jconfig), **OPTIONS)
    model = jbuild(cfg, dtype=jnp.float64, **T.OVERRIDES)
    return T._jax_reference(model, variables, cfg, steps=BATCHES, fresh=True)


def _port_step(variables, options, ref, i, monkeypatch):
    cfg = dataclasses.replace(T.tiny_cfg(tconfig, use_pallas=True),
                              **options)
    state = T._port_state(variables, cfg)
    monkeypatch.setattr(tlm.RSLMSolver, 'solve', T.TORCH_INIT)
    monkeypatch.setattr(thead, 'draw_object_samples',
                        lambda gen, fg, prob, n_u, n_r: torch.from_numpy(
                            ref['point_inds'].astype(np.int64)))
    samples = list(torch.from_numpy(ref['samples'].copy()).reshape(
        cfg.pnp.num_iter, -1, *ref['samples'].shape[1:]))
    monkeypatch.setattr(tep, 'draw_pose_samples',
                        lambda trans, rot, num, gen: samples.pop(0).clone())
    batch = tmain.to_device(tuple(T._batch(i)[k] for k in DET_BATCH_FIELDS),
                            'cpu', torch.float64)
    metrics = ttrain.make_train_step(cfg)(state, batch,
                                          torch.Generator().manual_seed(0))
    assert not samples and int(metrics['skipped']) == 0
    sd = {k: v.numpy().copy() for k, v in state.model.state_dict().items()}
    grads = det_variables(dict(sd, **{
        n: p.grad.numpy() for n, p in state.model.named_parameters()}),
        cfg)['params']
    return {k: float(v) for k, v in metrics.items()}, grads


def _det_group(path):
    """The yardstick's groups: the backbone, the FPN, the FCOS towers and
    branches, the DCN layers in them (K3's own leaves: the kernels and
    their offset convs), the rest of the head."""
    if any('dcn' in k for k in path):
        return 'dcn'
    if path[0] == 'head':
        return 'head/detector' if path[1] == 'detector' else 'head'
    return path[0]


def test_det_bf16_step_against_jax(variables, bf16_reference, monkeypatch):
    """One step with every JAX training option on (bf16 backbone and dense
    stage, packed towers: K3's twin with a bf16 map and a level table under
    autograd; remat) on each of BATCHES batches, held to JAX's by the f64
    yardstick (the port's f64 step without the options, which
    ``tests/test_torch_det_train.py`` holds to JAX's at 1e-6;
    ``GradYardstick`` by :func:`_det_group`, ``_loss_rule``), CHAOTIC_DET
    named; a zeroed gradient of K3's leaves, a negated gradient and another
    batch's gradient fail the rule. The flax DCN bias, which the port
    lacks, is left out of the gradients (its JAX gradient is rounding: that
    file's docstring)."""
    ys = GradYardstick(_det_group)
    losses = {'port': {}, 'jax': {}, 'f64': {}}

    def strip(tree):
        return jax.tree_util.tree_map_with_path(
            lambda path, a: np.zeros_like(a) if T._is_dcn_bias(path)
            else a, tree)
    previous = None
    for i, ref in enumerate(bf16_reference):
        before = dcn_kernel.launches_bf16
        pm, pg = _port_step(variables, OPTIONS, ref, i, monkeypatch)
        assert dcn_kernel.launches_bf16 == before  # the twin on the CPU
        fm, fg = _port_step(variables, {}, ref, i, monkeypatch)
        pg, fg = strip(pg), strip(fg)
        ys.add('port', pg, fg)
        ys.add('jax', strip(ref['grads']), fg)
        planted_faults(ys, pg, fg, previous, 'dcn')
        previous = pg
        for who, m in (('port', pm), ('f64', fm), ('jax', {
                k: float(v) for k, v in ref['metrics'].items()})):
            for k, v in m.items():
                if k.startswith('loss') or k == 'ate':
                    losses[who].setdefault(k, []).append(v)
    check_with_faults(ys)
    _loss_rule(losses, CHAOTIC_DET)


def _bn_stat_names(model):
    return {n + '.' + b for n, mod in model.named_modules()
            if isinstance(mod, BatchNorm2d)
            for b in ('running_mean', 'running_var', 'num_batches_tracked')}


@pytest.mark.parametrize('bf16', [False, True])
def test_det_remat_step_equals_plain(bf16):
    """``remat_dense`` (the dense forward recomputed in the backward)
    against the plain step, f32 and with the bf16 options on, the same
    weights and draws: ``tests/test_det_train.py``'s rule (losses rtol
    1e-5, ``grad_norm`` 1e-2; parameters rtol 1e-3 / atol 1e-5) and the
    BatchNorm statistics rtol 1e-6, each count at 1: the recompute moves
    them once."""
    opts = dict(bf16_backbone=True, bf16_dense=True,
                level_packed_towers=True) if bf16 else {}
    b = make_det_batch(10, T.N_IMG, T.H, T.W)
    batch = tmain.to_device(tuple(b[k] for k in DET_BATCH_FIELDS), 'cpu')
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(T.tiny_cfg(tconfig, use_pallas=True),
                                  remat_dense=remat, **opts)
        model, step = tmain.build_all(cfg, 'cpu', seed=2)
        state = tmain.init_state(cfg, model)
        metrics = step(state, batch, torch.Generator().manual_seed(0))
        runs[remat] = ({k: float(v) for k, v in metrics.items()},
                       {k: v.clone() for k, v in model.state_dict().items()})
    (m0, s0), (m1, s1) = runs[False], runs[True]
    assert m0['skipped'] == 0
    for k, v in m0.items():
        np.testing.assert_allclose(m1[k], v, rtol=1e-2 if k == 'grad_norm'
                                   else 1e-5, atol=1e-6, err_msg=k)
    stats = _bn_stat_names(tmain.build_all(T.tiny_cfg(tconfig), 'cpu')[0])
    assert len(stats) > 40
    for k, v in s0.items():
        if k in stats:
            np.testing.assert_allclose(s1[k].double().numpy(),
                                       v.double().numpy(), rtol=1e-6,
                                       atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(s1[k].numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)
    assert all(int(s1[k]) == 1 for k in stats
               if k.endswith('num_batches_tracked'))


def test_det_train_loop_prefetch_equals_synchronous(tmp_path):
    """``det.main.train_loop(prefetch=2)`` (the factory on a background
    thread, batches ahead on the device) against ``prefetch=0``, 2 epochs
    of 2 steps with an absent field (no lidar points): the same steps bit
    for bit (every metric, parameter, statistic and optimizer state)."""
    cfg = dataclasses.replace(T.tiny_cfg(tconfig), with_loss_regr=False,
                              train=dataclasses.replace(
                                  T.tiny_cfg(tconfig).train, epochs=2))

    def factory(epoch):
        for i in range(2):
            b = make_det_batch(30 + 2 * epoch + i, T.N_IMG, T.H, T.W)
            yield ttrain.DetBatch(*(b[k] for k in DET_BATCH_FIELDS[:13]))

    runs = []
    for prefetch in (2, 0):
        seen = []
        state = tmain.train_loop(
            cfg, factory, 2, str(tmp_path / f'run{prefetch}'), device='cpu',
            prefetch=prefetch, on_step=lambda e, i, m: seen.append(
                {k: v.clone() for k, v in m.items()}))
        runs.append((seen, state.state_dict(), state.tx.state_dict()))
    (m2, s2, o2), (m0, s0, o0) = runs
    assert len(m2) == len(m0) == 4
    for a, b in zip(m2, m0):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert s2.keys() == s0.keys()
    for k in s2:
        assert torch.equal(s2[k], s0[k]), k
    for p2, p0 in zip(o2['state'].values(), o0['state'].values()):
        for k in p2:
            assert torch.equal(p2[k], p0[k]), k
