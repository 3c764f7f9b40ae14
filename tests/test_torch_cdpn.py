"""PyTorch port of CDPN and of the 6DoF serving slice against the JAX package.

A small CDPN (ResNet-18, 32-filter heads, 64x64 input, 16x16 dense maps)
runs in float64 in both packages with the same weights, moved from the
flax variables by ``utils.convert.cdpn_state_dict``. The slice as a whole
follows: the same correspondences out of ``build_correspondences``, the
same refined pose from a fixed ``pose_init`` (``make_refine_fn``), and
finite poses with a sane cost from ``infer_poses(init='rslm')``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.models.cdpn import CDPN as FlaxCDPN
from epropnp_tpu.ops.pnp import evaluate_pnp as jax_evaluate_pnp
from epropnp_tpu.ops.rotation_conversions import matrix_to_quaternion
from epropnp_tpu.sixdof import config as jconfig
from epropnp_tpu.sixdof import test as jtest
from epropnp_tpu.sixdof import train as jtrain
from epropnp_tpu.utils.torch_convert import cdpn_variables
from epropnp_tpu_torch.models.cdpn import CDPN
from epropnp_tpu_torch.sixdof import config as tconfig
from epropnp_tpu_torch.sixdof import test as ttest
from epropnp_tpu_torch.sixdof import train as ttrain
from epropnp_tpu_torch.utils.convert import cdpn_state_dict

torch.set_num_threads(1)

INP, OUT, BS = 64, 16, 3
CAM_K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]])


def _randomize(variables, seed):
    """f64 copy of flax variables with non-trivial BatchNorm statistics and
    affine parameters (so a BN mapping error cannot hide)."""
    r = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        x = np.asarray(x, np.float64)
        if name == 'var':
            return r.uniform(0.5, 1.5, x.shape)
        if name == 'mean':
            return r.normal(0, 0.1, x.shape)
        if name == 'scale' and x.ndim == 1:
            return r.uniform(0.5, 1.5, x.shape)
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _flax_model_and_variables(inp_res, seed=0):
    model = FlaxCDPN(depth=18, rot_filters=32, trans_filters=32,
                     dtype=jnp.float64)
    variables = jax.jit(lambda key, x: model.init(key, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, inp_res, inp_res, 3)))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    return model, _randomize(variables, seed)


def _apply(jmodel, variables, img):
    """Eval-mode flax forward, jitted as one program (faster on the CPU than
    dispatching every layer eagerly)."""
    return jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(img))


def _port_model(variables, inp_res):
    feat = inp_res // 32
    model = CDPN(depth=18, rot_filters=32, trans_filters=32,
                 feat_hw=(feat, feat)).double()
    model.load_state_dict(
        {k: v.double() if v.is_floating_point() else v
         for k, v in cdpn_state_dict(variables, depth=18).items()},
        strict=True)
    return model.eval()


def _images(seed, n=BS, res=INP):
    return np.random.default_rng(seed).normal(size=(n, res, res, 3))


def _assert_outputs_close(touts, jouts):
    for name in ('noc', 'w2d', 'scale', 'trans'):
        # float64 convolutions in both frameworks: agreement to ~1e-12 of
        # the output scale; 1e-8 relative leaves room for summation order
        np.testing.assert_allclose(
            getattr(touts, name).detach().numpy(),
            np.asarray(getattr(jouts, name)), rtol=1e-8, atol=1e-10)


@pytest.fixture(scope='module')
def flax_small():
    return _flax_model_and_variables(INP)


@pytest.fixture(scope='module')
def small_models(flax_small):
    """Flax and port CDPN with the same weights; BatchNorm statistics
    calibrated on one seeded batch (random weights with default statistics
    emit a near-constant noc map, i.e. a degenerate PnP problem)."""
    jmodel, variables = flax_small
    tmodel = _port_model(variables, INP)
    for mod in tmodel.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_running_stats()
            mod.momentum = None
    tmodel.train()
    with torch.no_grad():
        tmodel(torch.from_numpy(_images(99, n=8)))
    tmodel.eval()
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    variables = {'params': variables['params'],
                 'batch_stats': cdpn_variables(sd, depth=18)['batch_stats']}
    return jmodel, variables, tmodel


def test_cdpn_outputs_match_flax(flax_small):
    jmodel, variables = flax_small
    tmodel = _port_model(variables, INP)
    img = _images(1)
    jouts = _apply(jmodel, variables, img)
    with torch.no_grad():
        touts = tmodel(torch.from_numpy(img))
    assert touts.noc.shape == (BS, OUT, OUT, 3)
    _assert_outputs_close(touts, jouts)


def test_cdpn_state_dict_round_trips_through_cdpn_variables():
    """flax variables -> port state_dict -> ``cdpn_variables`` -> the same
    flax variables, bit for bit, at the reference 256x256 input (8x8
    feature: the size ``cdpn_variables`` assumes for the trans head)."""
    _, variables = _flax_model_and_variables(256, seed=2)
    tmodel = _port_model(variables, 256)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    back = cdpn_variables(sd, depth=18)
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path],
                                      err_msg=str(path))


def _batches(seed):
    r = np.random.default_rng(seed)
    box = r.uniform(30, 60, (BS, 2))
    arrays = dict(
        inp=_images(seed), target_coor=np.zeros((BS, OUT, OUT, 3)),
        loss_msk=np.zeros((BS, OUT, OUT, 3)), trans_local=np.zeros((BS, 3)),
        pose=np.zeros((BS, 3, 4)),
        c_box=r.uniform([250, 200], [400, 280], (BS, 2)),
        s_box=box.max(-1) * 1.5, dim=r.uniform(0.03, 0.1, (BS, 3)))
    jb = jtrain.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = ttrain.Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    return jb, tb, box


def _cfgs(use_pallas=False):
    def make(cfg_mod):
        return cfg_mod.SixDoFConfig(
            dataiter=cfg_mod.DataIterConfig(inp_res=INP, out_res=OUT),
            pnp=cfg_mod.PnPConfig(use_pallas=use_pallas))
    return make(jconfig), make(tconfig)


def test_slice_correspondences_and_refine_match_jax(small_models):
    jmodel, variables, tmodel = small_models
    jb, tb, _ = _batches(5)
    jouts = _apply(jmodel, variables, jb.inp)
    with torch.no_grad():
        touts = tmodel(tb.inp)
    _assert_outputs_close(touts, jouts)

    jcorr = jtrain.build_correspondences(
        jouts.noc, jouts.w2d, jouts.scale, jb, jnp.asarray(CAM_K), OUT)
    tcorr = ttrain.build_correspondences(
        touts.noc, touts.w2d, touts.scale, tb, torch.from_numpy(CAM_K), OUT)
    for a, b in zip(tcorr[:3], jcorr[:3]):
        # float64, the same elementwise maps of the same model outputs
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-12)
    for a, b in ((tcorr[3].lb, jcorr[3].lb), (tcorr[3].ub, jcorr[3].ub)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    # the point cloud is spread out (not the degenerate constant map)
    assert (tcorr[0].std(1) > 1e-3).all()

    jcfg, tcfg = _cfgs()
    pose_init = np.tile([0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0], (BS, 1))
    jpose = jtest.make_refine_fn(jcfg, jnp.asarray(CAM_K))(
        *jcorr[:3], jnp.asarray(pose_init))
    tpose = ttest.make_refine_fn(tcfg, torch.from_numpy(CAM_K))(
        *tcorr[:3], torch.from_numpy(pose_init))
    # float64, three Gauss-Newton steps of the same algorithm
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize('use_pallas', [False, True])
def test_slice_infer_poses_rslm_is_sane(small_models, use_pallas):
    """``infer_poses(init='rslm')``: finite [R|t] with orthonormal R, and a
    reprojection cost in the JAX pipeline's regime (median within 2x).
    ``use_pallas`` runs the K1 twin on the CPU."""
    jmodel, variables, tmodel = small_models
    jb, tb, box = _batches(6)
    jcfg, tcfg = _cfgs()[0], _cfgs(use_pallas)[1]  # JAX: the jnp solver
    jouts = _apply(jmodel, variables, jb.inp)
    with torch.no_grad():
        touts = tmodel(tb.inp)
    tres = ttest.infer_poses(touts, tb, torch.from_numpy(box),
                             torch.from_numpy(CAM_K), tcfg, init='rslm',
                             rng=torch.Generator().manual_seed(0))
    jres = jax.jit(lambda outs, batch, box_wh, cam, key: jtest.infer_poses(
        outs, batch, box_wh, cam, jcfg, init='rslm', rng=key))(
        jouts, jb, jnp.asarray(box), jnp.asarray(CAM_K),
        jax.random.PRNGKey(0))
    rt = tres.pose_est.numpy()
    assert rt.shape == (BS, 3, 4) and np.isfinite(rt).all()
    assert np.isfinite(tres.pose_est_trans.numpy()).all()
    np.testing.assert_allclose(rt[:, :, :3] @ rt[:, :, :3].transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (BS, 3, 3)),
                               atol=1e-6)
    # the trans-head decode is deterministic: same as JAX
    np.testing.assert_allclose(tres.pose_est_trans.numpy(),
                               np.asarray(jres.pose_est_trans), rtol=1e-8,
                               atol=1e-10)

    x3d, x2d, w2d, _ = jtrain.build_correspondences(
        jouts.noc, jouts.w2d, jouts.scale, jb, jnp.asarray(CAM_K), OUT)
    camera, cost_fun = _jax_serving_camera_and_cost(jcfg, x2d, w2d)

    def cost_of(rt_pose):
        rt_pose = jnp.asarray(rt_pose)
        pose = jnp.concatenate([rt_pose[:, :, 3],
                                matrix_to_quaternion(rt_pose[:, :, :3])], -1)
        return np.asarray(jax_evaluate_pnp(x3d, x2d, w2d, pose, camera,
                                           cost_fun, out_cost=True).cost)
    tc, jc = cost_of(rt), cost_of(jres.pose_est)
    assert np.isfinite(tc).all()
    assert np.median(tc) <= 2.0 * np.median(jc)


def _jax_serving_camera_and_cost(cfg, x2d, w2d):
    from epropnp_tpu.ops.pnp import AdaptiveHuberPnPCost, PerspectiveCamera
    camera = PerspectiveCamera(
        cam_mats=jnp.broadcast_to(jnp.asarray(CAM_K), (BS, 3, 3)), z_min=0.01)
    cost_fun = AdaptiveHuberPnPCost(
        relative_delta=cfg.pnp.relative_delta).set_param(x2d, w2d)
    return camera, cost_fun
