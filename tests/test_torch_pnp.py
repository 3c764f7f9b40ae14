"""PyTorch port of the PnP core against the JAX package, on the CPU.

The same numpy inputs (``np.random.default_rng``) go through the JAX
function and its port counterpart. f64 against f64 where the point is the
algorithm (``tests/conftest.py`` enables x64), f32 against f32 where the
JAX side is the Pallas kernel run in interpret mode. Every tolerance is
stated at its assertion.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.ops import pnp as jpnp
from epropnp_tpu.ops.pnp import linalg as jlinalg
from epropnp_tpu.ops.pnp import pallas_lm
from epropnp_tpu_torch.ops import pnp as tpnp
from epropnp_tpu_torch.ops.pnp import lm_kernel
from epropnp_tpu_torch.ops.pnp import linalg as tlinalg
from epropnp_tpu_torch.utils.synthetic import make_pnp_problem

torch.set_num_threads(1)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_problem(seed, b=8, n=32, dof=6, init_noise=(0.05, 0.05)):
    """Noisy synthetic PnP problem + a perturbed ground-truth init (numpy,
    f64), with fx != fy."""
    return make_pnp_problem(b, n, seed, dof=dof, init_noise=init_noise,
                            px_noise=0.3, focal=(400.0, 420.0),
                            depth=(3.0, 6.0))


def both(p, dtype=np.float64):
    """The problem as JAX arrays and as torch tensors of ``dtype``."""
    j = {k: jnp.asarray(v.astype(dtype)) for k, v in p.items()}
    t = {k: torch.from_numpy(np.ascontiguousarray(v.astype(dtype)))
         for k, v in p.items()}
    return j, t


def tight_bounds(x2d):
    lo = np.quantile(x2d.reshape(-1, 2), 0.05, axis=0)
    hi = np.quantile(x2d.reshape(-1, 2), 0.95, axis=0)
    b = x2d.shape[0]
    return np.broadcast_to(lo, (b, 2)).copy(), np.broadcast_to(hi, (b, 2)).copy()


def cameras(j, t, bounds=None, z_min=0.1):
    if bounds is None:
        return (jpnp.PerspectiveCamera(cam_mats=j['cams'], z_min=z_min),
                tpnp.PerspectiveCamera(cam_mats=t['cams'], z_min=z_min))
    lb, ub = bounds
    return (jpnp.PerspectiveCamera(cam_mats=j['cams'], lb=jnp.asarray(lb),
                                   ub=jnp.asarray(ub), z_min=z_min),
            tpnp.PerspectiveCamera(cam_mats=t['cams'], lb=torch.from_numpy(lb),
                                   ub=torch.from_numpy(ub), z_min=z_min))


def close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize('dof,bounded,clip', [
    (6, False, True), (6, True, True), (6, True, False), (4, True, True)])
def test_evaluate_pnp_matches_jax(dof, bounded, clip):
    p = make_problem(1 + dof + bounded, dof=dof)
    j, t = both(p)
    bnd = tight_bounds(p['x2d']) if bounded else None
    jcam, tcam = cameras(j, t, bnd)
    delta = np.full(8, 0.7)
    jev = jpnp.evaluate_pnp(
        j['x3d'], j['x2d'], j['w2d'], j['pose0'], jcam,
        jpnp.HuberPnPCost(delta=jnp.asarray(delta)), out_jacobian=True,
        out_residual=True, out_cost=True, clip_jac=clip)
    tev = tpnp.evaluate_pnp(
        t['x3d'], t['x2d'], t['w2d'], t['pose0'], tcam,
        tpnp.HuberPnPCost(delta=torch.from_numpy(delta)), out_jacobian=True,
        out_residual=True, out_cost=True, clip_jac=clip)
    # f64 on both sides, same expressions: agreement to rounding
    for a, b in zip(tev, jev):
        close(a, b, rtol=1e-10, atol=1e-12)
    if bounded:  # the clamps were exercised
        proj, _ = tcam.project(t['x3d'], t['pose0'])
        assert (proj == torch.from_numpy(bnd[0])[:, None]).any()


def test_linalg_and_adaptive_huber_match_jax():
    r = np.random.default_rng(0)
    m = r.normal(size=(5, 6, 6))
    spd = m @ m.transpose(0, 2, 1) + 6 * np.eye(6)
    rhs = r.normal(size=(5, 6))
    a3 = r.normal(size=(5, 3, 3)) + 3 * np.eye(3)
    # f64, unrolled elementwise code on both sides: rounding-level agreement
    close(tlinalg.solve_spd_small(torch.from_numpy(spd), torch.from_numpy(rhs)),
          jlinalg.solve_spd_small(jnp.asarray(spd), jnp.asarray(rhs)),
          rtol=1e-10, atol=1e-12)
    close(tlinalg.inv_spd_small(torch.from_numpy(spd)),
          jlinalg.inv_spd_small(jnp.asarray(spd)), rtol=1e-10, atol=1e-12)
    close(tlinalg.solve_3x3(torch.from_numpy(a3), torch.from_numpy(rhs[:, :3])),
          jlinalg.solve_3x3(jnp.asarray(a3), jnp.asarray(rhs[:, :3])),
          rtol=1e-10, atol=1e-12)
    x2d, w2d = r.normal(size=(5, 20, 2)) * 50, r.uniform(size=(5, 20, 2))
    close(tpnp.AdaptiveHuberPnPCost(relative_delta=0.1).set_param(
              torch.from_numpy(x2d), torch.from_numpy(w2d)).delta,
          jpnp.AdaptiveHuberPnPCost(relative_delta=0.1).set_param(
              jnp.asarray(x2d), jnp.asarray(w2d)).delta,
          rtol=1e-12, atol=0)


# ---------------------------------------------------------------- LMSolver


@pytest.mark.parametrize('dof,fast', [(6, True), (6, False), (4, True),
                                      (4, False)])
def test_lm_solver_plain_path_matches_jax(dof, fast):
    p = make_problem(10 + dof + fast, dof=dof, init_noise=(0.2, 0.2))
    j, t = both(p)
    jcam, tcam = cameras(j, t)
    delta = np.full(8, 0.7)
    kw = dict(with_cost=True, with_pose_cov=True, fast_mode=fast)
    jpose, jcov, jc = jpnp.LMSolver(dof=dof, num_iter=5).solve(
        j['x3d'], j['x2d'], j['w2d'], jcam,
        jpnp.HuberPnPCost(delta=jnp.asarray(delta)), pose_init=j['pose0'],
        **kw)
    tpose, tcov, tc = tpnp.LMSolver(dof=dof, num_iter=5).solve(
        t['x3d'], t['x2d'], t['w2d'], tcam,
        tpnp.HuberPnPCost(delta=torch.from_numpy(delta)),
        pose_init=t['pose0'], **kw)
    # f64, the same five iterations: agreement far below the f32 level
    close(tpose, jpose, rtol=1e-7, atol=1e-9)
    close(tc, jc, rtol=1e-7, atol=1e-12)
    scale = np.abs(np.asarray(jcov)).max(axis=(-2, -1), keepdims=True)
    close(tcov.numpy() / scale, np.asarray(jcov) / scale, rtol=0, atol=1e-6)


def test_gn_step_and_pose_add_match_jax():
    p = make_problem(3)
    j, t = both(p)
    jcam, tcam = cameras(j, t)
    delta = np.full(8, 0.7)
    js = jpnp.LMSolver(dof=6)
    ts = tpnp.LMSolver(dof=6)
    jstep = js.gn_step(j['x3d'], j['x2d'], j['w2d'], j['pose0'], jcam,
                       jpnp.HuberPnPCost(delta=jnp.asarray(delta)))
    tstep = ts.gn_step(t['x3d'], t['x2d'], t['w2d'], t['pose0'], tcam,
                       tpnp.HuberPnPCost(delta=torch.from_numpy(delta)))
    # f64 LU solves of the same 6x6 systems
    close(tstep, jstep, rtol=1e-8, atol=1e-10)
    close(ts.pose_add(t['pose0'], tstep, tcam),
          js.pose_add(j['pose0'], jstep, jcam), rtol=1e-10, atol=1e-12)


# ------------------------------------------------------- K1 twin vs Pallas


def _interpret_pallas_lm(monkeypatch):
    orig = pallas_lm.pl.pallas_call
    monkeypatch.setattr(pallas_lm.pl, 'pallas_call',
                        lambda *a, **k: orig(*a, interpret=True, **k))


@pytest.mark.parametrize('dof,fast,bounded', [
    (6, True, False), (6, False, False), (6, False, True), (4, True, True)])
def test_lm_solve_reference_matches_pallas_interpret(dof, fast, bounded,
                                                     monkeypatch):
    p = make_problem(20 + dof + fast + bounded, dof=dof)
    j, t = both(p, np.float32)
    delta = np.full(8, 0.7, np.float32)
    cam4 = pallas_lm.camera_to_fxfycxcy(j['cams'])
    bj = bt = None
    if bounded:
        lb, ub = tight_bounds(p['x2d'])
        bnd = np.concatenate([lb, ub], -1).astype(np.float32)
        bj, bt = jnp.asarray(bnd), torch.from_numpy(bnd)
    _interpret_pallas_lm(monkeypatch)
    jout = pallas_lm.lm_solve_pallas(
        j['x3d'], j['x2d'], j['w2d'], cam4, jnp.asarray(delta), j['pose0'],
        bounds=bj, dof=dof, num_iter=5, fast_mode=fast, z_min=0.1, tile_b=8,
        with_jtj=True)
    tout = lm_kernel.lm_solve_reference(
        t['x3d'], t['x2d'], t['w2d'],
        lm_kernel.camera_to_fxfycxcy(t['cams']).contiguous(),
        torch.from_numpy(delta), t['pose0'], bounds=bt, dof=dof, num_iter=5,
        fast_mode=fast, z_min=0.1, with_jtj=True)
    # f32; the JAX kernel tests' tolerances (tests/test_pallas_lm.py)
    close(tout[1], jout[1], rtol=2e-4, atol=1e-4)
    close(tout[0][:, :3], jout[0][:, :3], rtol=0, atol=5e-4)
    if dof == 6:
        dot = np.abs((tout[0][:, 3:].numpy() * np.asarray(jout[0][:, 3:])
                      ).sum(-1))
        close(dot, 1.0, rtol=0, atol=2e-4)
    else:
        close(tout[0][:, 3], jout[0][:, 3], rtol=0, atol=2e-4)
    jtj_scale = np.abs(np.asarray(jout[2])).max(axis=(-2, -1), keepdims=True)
    close(tout[2].numpy() / jtj_scale, np.asarray(jout[2]) / jtj_scale,
          rtol=0, atol=1e-3)


@pytest.mark.parametrize('fast', [True, False])
def test_lm_solver_kernel_path_on_cpu_runs_the_twin(fast):
    """``use_pallas`` on CPU tensors goes through the K1 twin and agrees
    with the plain solver path (f64 both)."""
    p = make_problem(30 + fast)
    _, t = both(p)
    tcam = tpnp.PerspectiveCamera(cam_mats=t['cams'], z_min=0.1)
    cost_fun = tpnp.HuberPnPCost(delta=torch.full((8,), 0.7,
                                                  dtype=torch.float64))
    before = lm_kernel.launches
    outs = [tpnp.LMSolver(dof=6, num_iter=5, use_pallas=up).solve(
        t['x3d'], t['x2d'], t['w2d'], tcam, cost_fun, pose_init=t['pose0'],
        with_cost=True, with_pose_cov=True, fast_mode=fast)
        for up in (True, False)]
    assert lm_kernel.launches == before  # no kernel launch on CPU
    # f64; the twin renormalises the quaternion inside its evaluation and
    # reduces in another order than the plain path: 1e-7 relative
    for a, b in zip(outs[0], outs[1]):
        close(a, b, rtol=1e-7, atol=1e-10)


def test_wrappers_refuse_what_they_do_not_run():
    p = make_problem(4, b=4, n=8)
    _, t = both(p, np.float32)
    args = (t['x3d'], t['x2d'], t['w2d'],
            lm_kernel.camera_to_fxfycxcy(t['cams']).contiguous(),
            torch.ones(4), t['pose0'])
    with pytest.raises(ValueError, match='CUDA tensors'):
        lm_kernel.lm_solve_cuda(*args)  # no silent CPU run
    meta = [a.to('meta') for a in args]
    with pytest.raises(ValueError, match='unsupported device'):
        lm_kernel.lm_solve(*meta)


@pytest.mark.parametrize('option', [dict(dof=4, fast_mode=False),
                                    dict(bounds=True, fast_mode=False),
                                    dict(with_jtj=True)])
def test_lm_kernel_refuses_options_not_ported(option):
    """The training modes are in the CUDA kernel's scope now: with dof 4 or
    bounds in trust-region mode, or with the JtJ output, the CUDA wrapper
    gets past its scope check and refuses only the CPU tensor (no silent
    CPU run); the CPU wrapper runs the twin. Only a dof other than 4 or 6
    is refused as out of scope."""
    p = make_problem(5, b=4, n=8, dof=option.get('dof', 6))
    _, t = both(p, np.float32)
    kw = dict(option)
    if kw.pop('bounds', False):
        kw['bounds'] = torch.tensor([[0., 0., 640., 480.]] * 4)
    args = (t['x3d'], t['x2d'], t['w2d'],
            lm_kernel.camera_to_fxfycxcy(t['cams']).contiguous(),
            torch.ones(4), t['pose0'])
    with pytest.raises(ValueError, match='CUDA tensors'):
        lm_kernel.lm_solve_cuda(*args, **kw)
    with pytest.raises(NotImplementedError, match='dof 4 and 6'):
        lm_kernel.lm_solve_cuda(*args, **dict(kw, dof=3))
    out = lm_kernel.lm_solve(*args, **kw)  # CPU: the twin runs them
    assert all(torch.isfinite(o).all() for o in out)
    assert len(out) == (3 if kw.get('with_jtj') else 2)


def test_lm_kernel_takes_dof4_with_bounds_in_fast_mode():
    """The Det serving options are in the kernel's scope: the CUDA wrapper
    gets past its scope check (and refuses the CPU tensor), and the CPU
    wrapper runs the twin, which matches the plain fast solver."""
    p = make_problem(6, b=4, n=16, dof=4)
    _, t = both(p, np.float32)
    lb, ub = tight_bounds(p['x2d'])
    bounds = torch.from_numpy(np.concatenate([lb, ub], -1).astype(np.float32))
    args = (t['x3d'], t['x2d'], t['w2d'],
            lm_kernel.camera_to_fxfycxcy(t['cams']).contiguous(),
            torch.full((4,), 0.7), t['pose0'])
    kw = dict(bounds=bounds, dof=4, num_iter=3, fast_mode=True)
    with pytest.raises(ValueError, match='CUDA tensors'):
        lm_kernel.lm_solve_cuda(*args, **kw)
    pose, cost = lm_kernel.lm_solve(*args, **kw)
    assert pose.shape == (4, 4) and torch.isfinite(pose).all()
    tcam = tpnp.PerspectiveCamera(cam_mats=t['cams'], lb=bounds[:, :2],
                                  ub=bounds[:, 2:], z_min=0.1)
    ref, _, ref_cost = tpnp.LMSolver(dof=4, num_iter=3).solve(
        t['x3d'], t['x2d'], t['w2d'], tcam,
        tpnp.HuberPnPCost(delta=torch.full((4,), 0.7)),
        pose_init=t['pose0'], with_cost=True, fast_mode=True)
    # f32, the same three Gauss-Newton steps written two ways
    close(pose, ref, rtol=1e-4, atol=1e-4)
    close(cost, ref_cost, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('b,n,group', [
    (1024, 512, 64),    # the bench solve: 8 points a thread, 2 warps
    (2048, 16, 16),     # CDPN serving proposals: a point a thread
    (32, 4096, 512),    # CDPN serving refine: the largest group
    (98304, 16, 4),     # Det serving proposals: 4 points a thread
    (1536, 128, 32),    # Det refine and training solve: a warp
    (128, 16, 32),      # 6DoF training proposals: a warp, half idle
    (32, 512, 256),     # 6DoF training solve: 2 points a thread
    (1000, 1, 2), (999, 2, 4), (9000, 15, 4), (3001, 16, 16),
    (5001, 17, 8), (257, 129, 64), (5, 100000, 512)])
def test_lm_kernel_group_size(b, n, group):
    """K1's launch shape: a power of two within the block limit; its
    threads cover every point (thread i takes points i, i + G, ...), at
    most 4 points a thread in a group of a warp or less and 8 in a larger
    one where the limit allows, and at most half a group without a point;
    the main path's shapes get the group the design intends."""
    g = lm_kernel.group_size(b, n)
    assert g == group
    assert g & (g - 1) == 0 and 1 <= g <= lm_kernel.MAX_GROUP
    covered = {i for lane in range(g) for i in range(lane, n, g)}
    assert covered == set(range(n))
    assert -(-n // g) <= (4 if g <= 32 else 8) or g == lm_kernel.MAX_GROUP
    assert g <= 2 * n


def test_port_never_loads_jax():
    code = ('import sys, epropnp_tpu_torch, epropnp_tpu_torch.sixdof.test, '
            'epropnp_tpu_torch.utils.convert, '
            'epropnp_tpu_torch.ops.pnp.rslm_kernel, '
            'epropnp_tpu_torch.det.api, epropnp_tpu_torch.det.test, '
            'epropnp_tpu_torch.ops.dcn_kernel, '
            'epropnp_tpu_torch.ops.level_pack, '
            'epropnp_tpu_torch.utils.synthetic, '
            'epropnp_tpu_torch.sixdof.main, '
            'epropnp_tpu_torch.demo.fit_identity, '
            'epropnp_tpu_torch.ops.rotation_conversions, '
            'epropnp_tpu_torch.det.main, epropnp_tpu_torch.utils.optim, '
            'epropnp_tpu_torch.sixdof.eval_metrics, '
            'epropnp_tpu_torch.sixdof.dataset, '
            'epropnp_tpu_torch.sixdof.model_points, '
            'epropnp_tpu_torch.utils.checkpoint, '
            'epropnp_tpu_torch.visualization.orient_density, '
            'epropnp_tpu_torch.ops.iou3d, epropnp_tpu_torch.det.kitti_eval, '
            'epropnp_tpu_torch.det.kitti_dataset, '
            'epropnp_tpu_torch.det.nuscenes_eval, '
            'epropnp_tpu_torch.det.nuscenes_dataset, '
            'epropnp_tpu_torch.det.synthetic, '
            'epropnp_tpu_torch.det.pipelines, epropnp_tpu_torch.utils.timer, '
            'epropnp_tpu_torch.tools.train_det, '
            'epropnp_tpu_torch.tools.test_det, '
            'epropnp_tpu_torch.tools.validate_det_synthetic, '
            'epropnp_tpu_torch.utils.image_ops, '
            'epropnp_tpu_torch.sixdof.synthetic, '
            'epropnp_tpu_torch.parallel.prefetch, '
            'epropnp_tpu_torch.utils.config_override, '
            'epropnp_tpu_torch.tools.train_6dof, '
            'epropnp_tpu_torch.tools.test_6dof, '
            'epropnp_tpu_torch.tools.validate_6dof_synthetic, '
            'epropnp_tpu_torch.tools.checkpoint_cleaner, '
            'epropnp_tpu_torch.tools.bench_dcn_backward, '
            'epropnp_tpu_torch.utils.cuda_setup, '
            'epropnp_tpu_torch.models.norm; '
            'assert "jax" not in sys.modules, "jax loaded"; '
            'assert "bench" not in sys.modules; '
            'assert "flax" not in sys.modules and "msgpack" not in '
            'sys.modules; '
            'assert "cv2" not in sys.modules, "cv2 imported at module level"; '
            'assert "nuscenes" not in sys.modules, "nuscenes imported"; '
            'assert "epropnp_tpu" not in sys.modules; print("ok")')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, check=False, cwd=REPO_ROOT)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr


def test_chip_smoke_imports_no_reference():
    """``chip_smoke.py`` runs where JAX is absent: it imports neither jax,
    the JAX package nor ``bench`` (a file of the JAX side)."""
    import ast
    with open(os.path.join(REPO_ROOT, 'chip_smoke.py')) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split('.')[0])
    assert 'torch' in names or 'epropnp_tpu_torch' in names
    assert not names & {'jax', 'jaxlib', 'flax', 'epropnp_tpu', 'bench'}


@pytest.mark.parametrize('seed', [0, 5])
def test_make_problem_is_bench_make_problem(seed):
    """The port's copy of ``bench.make_problem`` gives the same arrays."""
    import bench
    from epropnp_tpu_torch.utils import synthetic
    ours, ref = synthetic.make_problem(seed), bench.make_problem(seed)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (synthetic.BENCH_LM_ITER, synthetic.BENCH_RS_POINTS,
            synthetic.BENCH_RS_PROPOSALS, synthetic.BENCH_RS_ITER) == (
        bench.LM_ITER, bench.RS_POINTS, bench.RS_PROPOSALS, bench.RS_ITER)
