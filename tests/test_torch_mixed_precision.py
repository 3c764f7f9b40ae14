"""The port's 6DoF mixed precision against the JAX package's, and the
small pieces of its bf16 training: remat, the CLIs' CUDA settings, the
checkpoint cleaner.

The JAX recipe (``tests/test_mixed_precision.py``): f32 parameters, the
backbone computing in bf16, the heads and the PnP in the model's dtype, no
loss scaling. The port's ``CDPN(backbone_dtype=torch.bfloat16)`` and
``sixdof.main.build_cdpn`` / ``load_cdpn`` with ``network.bf16_backbone``
do the same; the weights move by ``utils.convert``.

Forward: the port's bf16 CDPN lies within 0.15 of the f32 outputs (the
JAX test's rule) and, like ``tests/test_torch_det.py::_serving_rule``, no
further from JAX's f32 model than 1.5x JAX's own bf16 model plus 1e-2 of
the largest entry (RMS distances: two bf16 paths that round at other
places land apart in the largest entry of a single output).

Training: a bf16 backbone's gradients are dominated by rounding (the
batch statistics' backward cancels: a random ResNet-18's bf16 gradients
lie ~0.4 of their norm from f64 in either package), so the bf16 step is
held to JAX's by a yardstick, the f64 step of the same weights with the
option off (the port's, which ``tests/test_torch_sixdof_train.py`` holds
to JAX's at 1e-6): over several batches, the port's bf16 step lies no
further from it than 1.5x JAX's bf16 step (the serving rule's factor),
in the losses and in the gradients, and its gradients point no further
from it than JAX's (cosine, by group of leaves, within 0.2 of JAX's).
A leaf-by-leaf rule cannot hold: JAX's own bf16 gradients lie 0.2-0.8 of
their norm from f64 in every group, the heads' included (their BatchNorm
in training mode cancels as the backbone's does). Planted wrong
backwards (a zeroed group, a negated or another batch's gradient) fail
the rule in every run. The draws are JAX's, replayed as in
``tests/test_torch_sixdof_train.py``, whose helpers this file shares (its
JAX reference, jitted once here for the bf16 model).
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
import test_torch_sixdof_train as S  # noqa: E402

from epropnp_tpu.models.cdpn import CDPN as FlaxCDPN  # noqa: E402
from epropnp_tpu.ops.pnp import levenberg_marquardt as jlm  # noqa: E402
from epropnp_tpu.sixdof import config as jconfig  # noqa: E402
from epropnp_tpu.utils.checkpoint import (  # noqa: E402
    save_checkpoint as jsave_checkpoint)
from epropnp_tpu_torch.models.cdpn import CDPN  # noqa: E402
from epropnp_tpu_torch.models.norm import BatchNorm2d  # noqa: E402
from epropnp_tpu_torch.ops.pnp import epropnp as tep  # noqa: E402
from epropnp_tpu_torch.ops.pnp import levenberg_marquardt as tlm  # noqa: E402
from epropnp_tpu_torch.sixdof import config as tconfig  # noqa: E402
from epropnp_tpu_torch.sixdof import main as tmain  # noqa: E402
from epropnp_tpu_torch.sixdof import train as ttrain  # noqa: E402
from epropnp_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint)
from epropnp_tpu_torch.utils.convert import (  # noqa: E402
    cdpn_state_dict, cdpn_variables)

torch.set_num_threads(1)
# the serving rule's factor on JAX's own bf16 distance
FACTOR = 1.5
# the bf16 step's direction rule: per group of leaves, the port's cosine
# to the f64 step's gradient at least JAX's less this (GradYardstick)
COS_MARGIN = 0.2
BATCHES = 8


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _serving_rule(port, ref32, jax_bf16, name):
    """``tests/test_torch_det.py::_serving_rule`` without the int8 term."""
    port, ref32, jax_bf16 = (np.asarray(a, np.float64)
                             for a in (port, ref32, jax_bf16))
    limit = FACTOR * _rms(jax_bf16 - ref32) + 1e-2 * np.abs(ref32).max()
    assert _rms(port - ref32) <= limit, (name, _rms(port - ref32), limit)


def _jax_cdpn_outputs(variables, img, backbone_dtype=None):
    model = FlaxCDPN(depth=18, backbone_dtype=backbone_dtype)
    return [np.asarray(o) for o in model.apply(variables, jnp.asarray(img),
                                               train=False)]


@pytest.fixture(scope='module')
def cdpn18():
    """f32 flax variables of a CDPN-18 (the JAX test's model) at 64x64
    crops, BatchNorm statistics drawn away from their defaults."""
    img = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    variables = FlaxCDPN(depth=18).init(jax.random.PRNGKey(0),
                                        jnp.asarray(img), train=False)
    r = np.random.default_rng(2)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == 'var':
            return r.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == 'mean':
            return r.normal(scale=0.1, size=x.shape).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, dict(variables)), img


def test_cdpn_bf16_backbone_matches_jax(cdpn18):
    """``CDPN(backbone_dtype=bf16)`` (f32 parameters) against the flax
    CDPN with ``backbone_dtype=jnp.bfloat16``: the heads' outputs are f32
    and finite, within 0.15 of the f32 model's largest entry, and under
    the serving rule against JAX's f32 and bf16 models."""
    variables, img = cdpn18
    ref32 = _jax_cdpn_outputs(variables, img)
    jbf = _jax_cdpn_outputs(variables, img, jnp.bfloat16)
    model = CDPN(depth=18, feat_hw=(2, 2), backbone_dtype=torch.bfloat16)
    model.load_state_dict(cdpn_state_dict(variables, 18, feat_hw=(2, 2)))
    assert model.backbone.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        outs = model.eval()(torch.from_numpy(img))
    for name, p, r, j in zip(outs._fields, outs, ref32, jbf):
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), name
        err = np.abs(p.numpy() - r).max() / (np.abs(r).max() + 1e-6)
        assert err < 0.15, (name, err)
        _serving_rule(p.numpy(), r, j, name)


def test_load_cdpn_honours_bf16_backbone(cdpn18, tmp_path):
    """``sixdof.main.load_cdpn`` builds the CDPN of the config: with
    ``network.bf16_backbone`` a JAX checkpoint's weights evaluate with a
    bf16 backbone, as JAX's ``test_loop`` builds its model, and a port
    checkpoint of it (``latest.pt`` layout) loads the same way."""
    variables, img = cdpn18
    path = jsave_checkpoint(str(tmp_path / 'vars.msgpack'),
                            jax.tree_util.tree_map(np.asarray, variables))
    base = tconfig.SixDoFConfig(
        network=tconfig.NetworkConfig(back_layers_num=18),
        dataiter=tconfig.DataIterConfig(inp_res=64, out_res=16))
    cfg = dataclasses.replace(base, network=dataclasses.replace(
        base.network, bf16_backbone=True))
    outs = {}
    for name, c in (('f32', base), ('bf16', cfg)):
        model = tmain.load_cdpn(c, path, device='cpu')
        assert model.backbone.dtype == (torch.bfloat16 if name == 'bf16'
                                        else None)
        with torch.no_grad():
            outs[name] = [o.numpy() for o in model(torch.from_numpy(img))]
    ref32 = _jax_cdpn_outputs(variables, img)
    jbf = _jax_cdpn_outputs(variables, img, jnp.bfloat16)
    for i, (p, r, j) in enumerate(zip(outs['bf16'], ref32, jbf)):
        _serving_rule(p, r, j, i)
        np.testing.assert_allclose(outs['f32'][i], r, rtol=1e-4, atol=1e-4)
    assert any(not np.array_equal(a, b)
               for a, b in zip(outs['bf16'], outs['f32']))
    # the port's own checkpoint of the bf16 model
    model = tmain.load_cdpn(cfg, path, device='cpu')
    state = ttrain.TrainState(model, ttrain.make_optimizer(cfg, model))
    pt = save_checkpoint(str(tmp_path / 'latest.pt'), state)
    again = tmain.load_cdpn(cfg, pt, device='cpu')
    assert again.backbone.dtype == torch.bfloat16
    with torch.no_grad():
        for a, b in zip(again(torch.from_numpy(img)), outs['bf16']):
            np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------------------- the bf16 step


@pytest.fixture(scope='module')
def bf16_reference():
    """JAX's bf16-backbone step (f64 model, bf16 ResNet) on BATCHES
    batches from the same initial state, with the RSLM stand-in."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jlm.RSLMSolver, 'solve', S.JAX_INIT)
    try:
        _, variables = S._flax_variables()
        model = FlaxCDPN(depth=18, rot_filters=32, trans_filters=32,
                         dtype=jnp.float64, backbone_dtype=jnp.bfloat16)
        steps = S._jax_reference(model, variables, S.tiny_cfg(jconfig),
                                 steps=BATCHES, fresh=True)
    finally:
        mp.undo()
    return variables, steps


def _port_step(variables, cfg, backbone_dtype, ref, i, monkeypatch):
    """One port step in f64 (the backbone in ``backbone_dtype``) from the
    flax variables, JAX's draws of ``ref`` replayed; -> (metrics,
    gradients under the flax names)."""
    feat = S.INP // 32
    model = CDPN(depth=18, rot_filters=32, trans_filters=32,
                 feat_hw=(feat, feat), backbone_dtype=backbone_dtype)
    model.load_state_dict(cdpn_state_dict(variables, depth=18))
    model = model.double()
    state = ttrain.TrainState(model, ttrain.make_optimizer(cfg, model))
    step_fn = ttrain.make_train_step(ttrain.build_epropnp(cfg), cfg,
                                     torch.from_numpy(S.CAM_K))
    monkeypatch.setattr(tlm.RSLMSolver, 'solve', S.TORCH_INIT)
    monkeypatch.setattr(ttrain, 'sample_point_indices',
                        lambda bs, n, num, gen, device: torch.from_numpy(
                            ref['inds'].astype(np.int64)))
    samples = list(torch.from_numpy(np.array(ref['samples'])).reshape(
        2, -1, S.BS, 7))
    monkeypatch.setattr(tep, 'draw_pose_samples',
                        lambda trans, rot, num, gen: samples.pop(0).clone())
    batch = ttrain.Batch(*(torch.from_numpy(S._batch(i)[k])
                           for k in S.FIELDS))
    metrics = step_fn(state, batch, torch.Generator().manual_seed(0))
    assert not samples and int(metrics['skipped']) == 0
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    grads = cdpn_variables(dict(sd, **{
        n: p.grad.numpy() for n, p in model.named_parameters()}),
        depth=18)['params']
    return {k: float(v) for k, v in metrics.items()}, grads


def _flat(tree):
    """(path keys, float64 leaf) of every leaf, in path order."""
    return [(tuple(str(getattr(k, 'key', k)) for k in path),
             np.asarray(v, np.float64)) for path, v in sorted(
        jax.tree_util.tree_leaves_with_path(tree),
        key=lambda kv: jax.tree_util.keystr(kv[0]))]


class GradYardstick:
    """The gradients of several runs (``who``) against the f64 step's,
    pooled over the batches, per group of leaves (``group(path keys)``):
    squared distance, dot product and squared norms. ``check(who)`` holds
    a run to JAX's bf16 run in two ways:

    - distance: the relative L2 distance to the f64 step over all leaves
      at most FACTOR x JAX's (+1e-3);
    - direction: in each group, the cosine to the f64 step at least
      JAX's less COS_MARGIN.

    The distance alone cannot see a wrong backward here: JAX's bf16
    gradients lie 0.67 (6DoF) and 0.94 (Det) of their norm from f64, so
    a zero gradient (distance 1) passes it. The direction can: JAX's
    cosines are 0.51-0.98 a group, and a zero, negated or unrelated
    gradient has a cosine of 0 or below. The groups are coarse (the
    backbone, each head, K3's own leaves), as finer ones are noisier
    (one layer's cosine moves by 0.2 between the two packages)."""

    def __init__(self, group):
        self.group = group
        self.acc = {}

    def add(self, who, grads, f64):
        for (path, g), (path_f, f) in zip(_flat(grads), _flat(f64)):
            assert path == path_f, (path, path_f)
            a = self.acc.setdefault((who, self.group(path)), np.zeros(4))
            a += (np.sum((g - f) ** 2), np.sum(g * f), np.sum(g * g),
                  np.sum(f * f))

    def _rows(self, who):
        return {grp: a for (w, grp), a in self.acc.items() if w == who}

    def distance(self, who):
        rows = self._rows(who).values()
        return (sum(a[0] for a in rows) / sum(a[3] for a in rows)) ** 0.5

    def cosines(self, who):
        return {grp: a[1] / max(a[2] * a[3], 1e-300) ** 0.5
                for grp, a in self._rows(who).items()}

    def check(self, who='port'):
        dist = {w: self.distance(w) for w in (who, 'jax')}
        cos = {w: self.cosines(w) for w in (who, 'jax')}
        print(f'gradients ({who}), relative L2 distance to the f64 step:',
              dist, 'cosines:', cos)
        assert dist[who] <= FACTOR * dist['jax'] + 1e-3, (who, dist)
        for grp, c in cos['jax'].items():
            assert cos[who][grp] >= c - COS_MARGIN, (
                who, grp, cos[who][grp], c)


def planted_faults(ys, grads, f64, previous, zeroed_group):
    """Three wrong backwards made from the port's gradients ``grads`` of
    a batch, added to ``ys``: ``zeroed`` (the leaves of ``zeroed_group``
    0), ``negated``, and ``unrelated`` (``previous``, the port's
    gradients of the batch before, if any). Each must fail
    :meth:`GradYardstick.check`."""
    ys.add('zeroed', jax.tree_util.tree_map_with_path(
        lambda path, g: np.zeros_like(g) if ys.group(tuple(
            str(getattr(k, 'key', k)) for k in path)) == zeroed_group
        else g, grads), f64)
    ys.add('negated', jax.tree_util.tree_map(np.negative, grads), f64)
    if previous is not None:
        ys.add('unrelated', previous, f64)


def check_with_faults(ys):
    """The port's gradients meet :meth:`GradYardstick.check`; each of
    :func:`planted_faults` fails it."""
    ys.check('port')
    for fault in ('zeroed', 'negated', 'unrelated'):
        with pytest.raises(AssertionError):
            ys.check(fault)


def _loss_rule(losses, chaotic):
    """Each loss term's RMS distance to the f64 step over the batches at
    most FACTOR x JAX's + 2e-2 of its RMS value; the ``chaotic`` terms
    finite (their per-batch distances are printed)."""
    for k, f64 in losses['f64'].items():
        f64 = np.asarray(f64)
        port, jx = np.asarray(losses['port'][k]), np.asarray(losses['jax'][k])
        print(k, 'relative distances to f64, port', np.abs(port - f64)
              / _rms(f64), 'JAX', np.abs(jx - f64) / _rms(f64))
        assert np.isfinite(port).all(), k
        if k not in chaotic:
            assert _rms(port - f64) <= FACTOR * _rms(jx - f64) \
                + 2e-2 * _rms(f64), (k, _rms(port - f64), _rms(jx - f64))


# The derivative-regularisation terms: the translation and rotation of a
# 2-iteration LM solve's pose_opt_plus, which bf16 rounding of the maps
# moves by up to 0.32 (loss_t) and 0.60 (loss_r) of their RMS value in the
# port (RMS 0.14 and 0.22) and 0.18 / 0.13 in JAX (RMS 0.077 and 0.056)
# over these batches: beyond 1.5x JAX's + 2e-2 in the port. The Monte
# Carlo loss and the total meet the rule.
CHAOTIC_6DOF = ('loss_t', 'loss_r')


def test_sixdof_bf16_step_against_jax(bf16_reference, monkeypatch):
    """One step with ``network.bf16_backbone`` on each of BATCHES batches,
    held to JAX's bf16 step by the f64 yardstick (module docstring,
    :class:`GradYardstick` by backbone and head, :func:`_loss_rule`),
    CHAOTIC_6DOF named; a zeroed backbone gradient, a negated gradient and
    another batch's gradient fail the rule."""
    variables, refs = bf16_reference
    cfg = dataclasses.replace(
        S.tiny_cfg(tconfig, use_pallas=True),
        network=tconfig.NetworkConfig(back_layers_num=18,
                                      bf16_backbone=True))
    ys = GradYardstick(lambda path: path[0])
    losses = {'port': {}, 'jax': {}, 'f64': {}}
    previous = None
    for i, ref in enumerate(refs):
        pm, pg = _port_step(variables, cfg, torch.bfloat16, ref, i,
                            monkeypatch)
        fm, fg = _port_step(variables, cfg, None, ref, i, monkeypatch)
        ys.add('port', pg, fg)
        ys.add('jax', ref['grads'], fg)
        planted_faults(ys, pg, fg, previous, 'backbone')
        previous = pg
        for who, m in (('port', pm), ('f64', fm), ('jax', {
                k: float(v) for k, v in ref['metrics'].items()})):
            for k, v in m.items():
                if k.startswith('loss'):
                    losses[who].setdefault(k, []).append(v)
    check_with_faults(ys)
    _loss_rule(losses, CHAOTIC_6DOF)


def _tiny_state(cfg, seed=0):
    model, _, _ = tmain.build_all(cfg, device='cpu')
    return tmain.init_state(cfg, model, seed=seed)


@pytest.mark.parametrize('bf16', [False, True])
def test_sixdof_remat_step_equals_plain(bf16):
    """``network.remat`` (the CDPN forward recomputed in the backward,
    ``models.norm.checkpoint``) against the plain step, f32 and with the
    bf16 backbone, the same draws: losses rtol 1e-5 (``grad_norm`` 1e-2),
    parameters rtol 1e-3 / atol 1e-5 (``tests/test_det_train.py``'s remat
    rule), the BatchNorm statistics and their count rtol 1e-6: the
    recompute moves them once, as JAX's functional step."""
    base = dataclasses.replace(
        S.tiny_cfg(tconfig, use_pallas=True),
        network=tconfig.NetworkConfig(back_layers_num=18,
                                      bf16_backbone=bf16))
    batch = ttrain.Batch(*(torch.from_numpy(S._batch(0)[k]).float()
                           for k in S.FIELDS))
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, network=dataclasses.replace(
            base.network, remat=remat))
        state = _tiny_state(cfg)
        step = ttrain.make_train_step(ttrain.build_epropnp(cfg), cfg,
                                      torch.from_numpy(S.CAM_K).float())
        metrics = step(state, batch, torch.Generator().manual_seed(3))
        runs[remat] = ({k: float(v) for k, v in metrics.items()},
                       {k: v.clone() for k, v in
                        state.model.state_dict().items()})
    (m0, s0), (m1, s1) = runs[False], runs[True]
    assert m0['skipped'] == 0
    for k, v in m0.items():
        np.testing.assert_allclose(m1[k], v, rtol=1e-2 if k == 'grad_norm'
                                   else 1e-5, atol=1e-6, err_msg=k)
    model = _tiny_state(base).model
    stats = {n + '.' + b for n, mod in model.named_modules()
             if isinstance(mod, BatchNorm2d)
             for b in ('running_mean', 'running_var', 'num_batches_tracked')}
    assert len(stats) > 60
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


CLIS = ['train_det', 'test_det', 'validate_det_synthetic', 'train_6dof',
        'test_6dof', 'validate_6dof_synthetic']


@pytest.mark.parametrize('cli', CLIS)
def test_cli_main_configures_cuda_first(cli, monkeypatch):
    """Every CLI of the port applies ``utils.cuda_setup.configure_cuda``
    first in its ``main`` (before it parses its arguments), so a user of
    the CLIs runs with the settings ``chip_smoke.py`` checks: TF32 off,
    cuDNN's exhaustive search."""
    import importlib
    from epropnp_tpu_torch.utils import cuda_setup

    class Applied(Exception):
        pass

    def configure():
        raise Applied
    monkeypatch.setattr(cuda_setup, 'configure_cuda', configure)
    mod = importlib.import_module(f'epropnp_tpu_torch.tools.{cli}')
    with pytest.raises(Applied):
        mod.main(['--no-such-flag'])


def test_configure_cuda_settings(monkeypatch):
    """The helper sets exactly what ``chip_smoke.py`` ran under."""
    from epropnp_tpu_torch.utils.cuda_setup import configure_cuda
    for name, value in (('allow_tf32', True), ('benchmark', False),
                        ('benchmark_limit', 10)):
        monkeypatch.setattr(torch.backends.cudnn, name, value)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    configure_cuda()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.benchmark is True
    assert torch.backends.cudnn.benchmark_limit == 0


def test_checkpoint_cleaner_strips_the_optimizer(tmp_path, capsys):
    """``tools.checkpoint_cleaner`` keeps ``state`` and drops
    ``optimizer``: the file shrinks, loads through ``load_cdpn`` (weights
    and statistics bit for bit) and through the Det API's
    ``load_train_state_model``, and refuses a resume (no optimizer)."""
    from epropnp_tpu_torch.det.api import load_train_state_model
    from epropnp_tpu_torch.tools import checkpoint_cleaner
    cfg = dataclasses.replace(
        S.tiny_cfg(tconfig), network=tconfig.NetworkConfig(
            back_layers_num=18))
    state = _tiny_state(cfg)
    batch = ttrain.Batch(*(torch.from_numpy(S._batch(0)[k]).float()
                           for k in S.FIELDS))
    ttrain.make_train_step(ttrain.build_epropnp(cfg), cfg, torch.from_numpy(
        S.CAM_K).float())(state, batch, torch.Generator().manual_seed(0))
    src = save_checkpoint(str(tmp_path / 'latest.pt'), state)
    dst = str(tmp_path / 'clean' / 'model.pt')
    checkpoint_cleaner.main([src, dst])
    assert "kept: ['state']" in capsys.readouterr().out
    assert os.path.getsize(dst) < os.path.getsize(src)
    assert set(torch.load(dst, weights_only=True)) == {'state'}
    model = tmain.load_cdpn(cfg, dst, device='cpu')
    want = state.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    own = load_train_state_model(dst)
    assert own.keys() == want.keys()
    with pytest.raises(ValueError, match='no optimizer state'):
        load_checkpoint(dst, _tiny_state(cfg))
