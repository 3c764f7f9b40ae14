"""PyTorch port of the AMIS Monte Carlo forward against the JAX package.

``monte_carlo_forward`` runs in float64 in both packages on the same numpy
problem, with projection bounds (the 6DoF training camera has them). The
draws cannot match JAX's PRNG, so the test replays them: the random
initialisation solver (``RSLMSolver.solve``) is replaced on both sides by
the same deterministic stand-in, and the port's draw function returns the
JAX run's AMIS samples. Then every step after a draw is compared: the
log-weights, ``pose_opt_plus``, the target cost, the Monte Carlo loss and
its gradients with respect to x3d, x2d and w2d (``jax.grad`` on the JAX
side). The JAX reference is computed once per dof.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.ops import pnp as jpnp
from epropnp_tpu.ops.pnp import levenberg_marquardt as jlm
from epropnp_tpu_torch.ops import pnp as tpnp
from epropnp_tpu_torch.ops.pnp import epropnp as tep
from epropnp_tpu_torch.ops.pnp import levenberg_marquardt as tlm
from epropnp_tpu_torch.utils.synthetic import make_pnp_problem

torch.set_num_threads(1)

B, N, MC, AMIS_ITER = 4, 32, 64, 4


def _problem(dof):
    p = make_pnp_problem(B, N, 40 + dof, dof=dof, init_noise=(0.1, 0.2),
                         px_noise=1.0, focal=(400.0, 420.0), depth=(3.0, 6.0))
    # bounds tight enough that some points are clamped
    lo = np.quantile(p['x2d'].reshape(-1, 2), 0.03, axis=0)
    hi = np.quantile(p['x2d'].reshape(-1, 2), 0.97, axis=0)
    p['lb'] = np.broadcast_to(lo, (B, 2)).copy()
    p['ub'] = np.broadcast_to(hi, (B, 2)).copy()
    # a deterministic init a little off the target pose (the stand-in of
    # the random-sample init solver on both sides)
    p['pose_rs'] = p['pose0'].copy()
    return p


def _jax_stand_in(pose_rs):
    def solve(self, x3d, x2d, w2d, camera, cost_fun, rng=None, **kwargs):
        pose = jnp.asarray(pose_rs)
        cost = jpnp.evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                                 out_cost=True).cost
        return pose, None, cost
    return solve


def _torch_stand_in(pose_rs):
    def solve(self, x3d, x2d, w2d, camera, cost_fun, rng=None, **kwargs):
        pose = torch.from_numpy(pose_rs)
        cost = tpnp.evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun,
                                 out_cost=True).cost
        return pose, None, cost
    return solve


def _solver(pkg, dof, use_pallas=False):
    solver = pkg.LMSolver(dof=dof, num_iter=5, use_pallas=use_pallas,
                          init_solver=pkg.RSLMSolver(
                              dof=dof, num_points=8, num_proposals=4,
                              num_iter=3, use_pallas=use_pallas))
    cls = pkg.EProPnP6DoF if dof == 6 else pkg.EProPnP4DoF
    return cls(mc_samples=MC, num_iter=AMIS_ITER, solver=solver)


def _loss(out, pose_gt, sum_):
    """The Monte Carlo loss plus a term on pose_opt_plus (its gradient
    reaches the inputs through the differentiable GN step)."""
    _, _, plus, _, logw, cost_tgt = out
    lse = jax.scipy.special.logsumexp if sum_ is jnp.sum else (
        lambda a, axis: torch.logsumexp(a, axis))
    loss_mc = (cost_tgt + lse(logw, axis=0)).mean()
    return loss_mc + 0.1 * sum_((plus - pose_gt) ** 2)


@pytest.fixture(scope='module', params=[6, 4])
def jax_reference(request):
    dof = request.param
    p = _problem(dof)
    mp = pytest.MonkeyPatch()
    mp.setattr(jlm.RSLMSolver, 'solve', _jax_stand_in(p['pose_rs']))
    epropnp = _solver(jpnp, dof)
    pose_gt = jnp.asarray(p['pose'])

    def run(x3d, x2d, w2d):
        camera = jpnp.PerspectiveCamera(
            cam_mats=jnp.asarray(p['cams']), z_min=0.1,
            lb=jnp.asarray(p['lb']), ub=jnp.asarray(p['ub']))
        cost_fun = jpnp.AdaptiveHuberPnPCost(relative_delta=0.1).set_param(
            x2d, w2d)
        out = epropnp.monte_carlo_forward(
            x3d, x2d, w2d, camera, cost_fun, rng=jax.random.PRNGKey(3),
            pose_init=pose_gt, force_init_solve=True,
            with_pose_opt_plus=True)
        return _loss(out, pose_gt, jnp.sum), out

    try:
        (loss, out), grads = jax.value_and_grad(
            run, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(p['x3d']), jnp.asarray(p['x2d']),
            jnp.asarray(p['w2d']))
    finally:
        mp.undo()
    as_np = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return dof, p, float(loss), [as_np(o) for o in out], [
        np.asarray(g) for g in grads]


@pytest.mark.parametrize('use_pallas', [False, True])
def test_monte_carlo_forward_matches_jax(jax_reference, use_pallas,
                                         monkeypatch):
    """With ``use_pallas`` the port's solve goes through the K1 twin (the
    kernel's arithmetic on the CPU): the trust region with bounds and the
    JtJ output."""
    dof, p, jloss, jout, jgrads = jax_reference
    monkeypatch.setattr(tlm.RSLMSolver, 'solve',
                        _torch_stand_in(p['pose_rs']))
    jsamples = torch.from_numpy(np.array(jout[3])).reshape(
        AMIS_ITER, -1, B, jout[3].shape[-1])
    calls = []

    def replay(trans_distr, rot_distr, num, gen):
        calls.append(num)
        return jsamples[len(calls) - 1].clone()

    monkeypatch.setattr(tep, 'draw_pose_samples', replay)
    x3d, x2d, w2d = (torch.from_numpy(p[k]).requires_grad_()
                     for k in ('x3d', 'x2d', 'w2d'))
    camera = tpnp.PerspectiveCamera(
        cam_mats=torch.from_numpy(p['cams']), z_min=0.1,
        lb=torch.from_numpy(p['lb']), ub=torch.from_numpy(p['ub']))
    cost_fun = tpnp.AdaptiveHuberPnPCost(relative_delta=0.1).set_param(
        x2d, w2d)
    pose_gt = torch.from_numpy(p['pose'])
    out = _solver(tpnp, dof, use_pallas).monte_carlo_forward(
        x3d, x2d, w2d, camera, cost_fun, rng=torch.Generator().manual_seed(3),
        pose_init=pose_gt, force_init_solve=True, with_pose_opt_plus=True)
    loss = _loss(out, pose_gt, torch.sum)
    loss.backward()
    assert calls == [MC // AMIS_ITER] * AMIS_ITER

    # float64 on both sides with the same samples. The plain solver paths
    # agree to ~1e-12; the K1 twin reduces in another order and
    # renormalises the quaternion inside its evaluation (1e-7 relative on
    # the solve, tests/test_torch_pnp.py), which the proposal fit carries
    # into the log-weights: rtol 1e-6
    tol = dict(rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(out[4].detach().numpy(), jout[4], **tol)
    np.testing.assert_allclose(out[2].detach().numpy(), jout[2], **tol)
    np.testing.assert_allclose(out[5].detach().numpy(), jout[5], **tol)
    np.testing.assert_allclose(out[0].numpy(), jout[0], **tol)
    np.testing.assert_allclose(loss.item(), jloss, **tol)
    for name, t, g in zip(('x3d', 'x2d', 'w2d'), (x3d, x2d, w2d), jgrads):
        scale = np.abs(g).max()
        np.testing.assert_allclose(t.grad.numpy() / scale, g / scale,
                                   rtol=0, atol=1e-6, err_msg=name)


def test_monte_carlo_forward_draws_from_the_generator():
    """Without replay the port draws from its generator: the same seed
    gives the same samples and log-weights, another seed others; the
    log-weights are finite."""
    p = _problem(6)
    t = {k: torch.from_numpy(p[k]) for k in ('x3d', 'x2d', 'w2d', 'cams',
                                              'pose')}
    camera = tpnp.PerspectiveCamera(cam_mats=t['cams'], z_min=0.1)
    cost_fun = tpnp.AdaptiveHuberPnPCost(relative_delta=0.1).set_param(
        t['x2d'], t['w2d'])
    epropnp = _solver(tpnp, 6, use_pallas=True)
    runs = [epropnp.monte_carlo_forward(
        t['x3d'], t['x2d'], t['w2d'], camera, cost_fun,
        rng=torch.Generator().manual_seed(seed), pose_init=t['pose'])
        for seed in (0, 0, 1)]
    assert torch.equal(runs[0][3], runs[1][3])
    assert torch.equal(runs[0][4], runs[1][4])
    assert not torch.equal(runs[0][3], runs[2][3])
    assert runs[0][3].shape == (MC, B, 7)
    assert torch.isfinite(runs[0][4]).all()
