"""PyTorch port of the RSLM init (K2 twin, samplers) against the JAX package.

The random draws cannot match across frameworks (JAX keys vs
``torch.Generator`` vs the kernels' Philox streams), so the comparisons are
distributional, as in ``tests/test_pallas_rslm.py``: finite poses, a median
init cost within 2x of the JAX value, and a returned cost that is the
evaluated cost of the returned pose. Inputs come from
``np.random.default_rng`` and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.ops import pnp as jpnp
from epropnp_tpu.ops.pnp import pallas_rslm
from epropnp_tpu_torch.ops import pnp as tpnp
from epropnp_tpu_torch.ops.pnp import rslm_kernel
from epropnp_tpu_torch.ops.pnp.lm_kernel import camera_to_fxfycxcy
from epropnp_tpu_torch.utils.synthetic import make_pnp_problem

torch.set_num_threads(1)


def make_problem(bs=16, n=256, seed=0, dtype=np.float32):
    """bench.make_problem at a small size (numpy): x3d, x2d, w2d, cams."""
    p = make_pnp_problem(bs, n, seed)
    return [np.ascontiguousarray(p[k], dtype)
            for k in ('x3d', 'x2d', 'w2d', 'cams')]


def _solve_both(arrays, jax_solver, torch_solver, bounded=False):
    """Init solve with_cost in both packages; returns numpy (pose, cost)."""
    x3d, x2d, w2d, cam = arrays
    lb = ub = None
    if bounded:  # crop-style projection bounds around the observed x2d
        lb, ub = x2d.min((0, 1)) - 20.0, x2d.max((0, 1)) + 20.0
    jx = [jnp.asarray(a) for a in arrays]
    jcam = jpnp.PerspectiveCamera(
        cam_mats=jx[3], lb=None if lb is None else jnp.asarray(lb),
        ub=None if ub is None else jnp.asarray(ub))
    jcost = jpnp.AdaptiveHuberPnPCost(relative_delta=0.1).set_param(jx[1],
                                                                     jx[2])
    jpose, _, jc = jax.jit(lambda key: jax_solver.solve(
        jx[0], jx[1], jx[2], jcam, jcost, rng=key, with_cost=True))(
        jax.random.PRNGKey(0))
    tx = [torch.from_numpy(a) for a in arrays]
    tcam = tpnp.PerspectiveCamera(
        cam_mats=tx[3], lb=None if lb is None else torch.from_numpy(lb),
        ub=None if ub is None else torch.from_numpy(ub))
    tcost = tpnp.AdaptiveHuberPnPCost(relative_delta=0.1).set_param(tx[1],
                                                                     tx[2])
    gen = torch.Generator().manual_seed(0)
    tpose, _, tc = torch_solver.solve(tx[0], tx[1], tx[2], tcam, tcost,
                                      rng=gen, with_cost=True)
    # the returned init cost is the full-set cost of the returned pose
    ev = tpnp.evaluate_pnp(tx[0], tx[1], tx[2], tpose, tcam, tcost,
                           out_cost=True).cost
    np.testing.assert_allclose(tc.numpy(), ev.numpy(), rtol=1e-6, atol=0)
    return (np.asarray(jpose), np.asarray(jc)), (tpose.numpy(), tc.numpy())


def _assert_same_regime(jres, tres, ratio=2.0):
    (jpose, jc), (tpose, tc) = jres, tres
    assert np.isfinite(tpose).all() and np.isfinite(tc).all()
    assert np.isfinite(jc).all()
    # init quality: the JAX tests' rule (median init cost within 2x)
    assert np.median(tc) <= ratio * np.median(jc)
    assert np.median(jc) <= ratio * np.median(tc)


@pytest.mark.parametrize('bounded', [False, True])
def test_fused_init_twin_matches_pallas_interpret(bounded, monkeypatch):
    """The K2 twin through ``RSLMSolver`` (gate open: fast_sampling,
    B*proposals >= 512, N % 128 == 0) against the JAX solver running the
    packed Pallas kernel in interpret mode, f32."""
    monkeypatch.setattr(pallas_rslm, 'INTERPRET', True)
    arrays = make_problem(bs=16, n=256, seed=1 + bounded)
    kw = dict(dof=6, num_points=16, num_proposals=64, num_iter=3,
              use_pallas=True, fast_sampling=True)
    tsolver = tpnp.RSLMSolver(**kw)
    assert tsolver.kernel_applies(16, 256)
    calls = []
    orig = rslm_kernel.rslm_init
    monkeypatch.setattr(rslm_kernel, 'rslm_init',
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    jres, tres = _solve_both(arrays, jpnp.RSLMSolver(**kw), tsolver,
                             bounded=bounded)
    assert calls == [1]  # the solver went through the K2 entry
    _assert_same_regime(jres, tres)


def test_rslm_init_reference_cost_is_its_pose_cost():
    """The twin's returned cost is the strided-subsample Huber cost of the
    returned pose (rtol 1e-5: the twin's evaluation renormalises the
    quaternion, ``evaluate_pnp``'s projection does not)."""
    x3d, x2d, w2d, cam = (torch.from_numpy(a)
                          for a in make_problem(bs=8, n=256, seed=3))
    delta = torch.full((8,), 10.0 / 256)
    seeds = torch.arange(8, dtype=torch.int32) * 7919
    pose, cost = rslm_kernel.rslm_init_reference(
        x3d, x2d, w2d, camera_to_fxfycxcy(cam).contiguous(), delta, seeds,
        dof=6, num_points=16, num_proposals=32, num_iter=3, z_min=0.1,
        score_points=128)
    ev = tpnp.evaluate_pnp(
        x3d[:, ::2], x2d[:, ::2], w2d[:, ::2], pose,
        tpnp.PerspectiveCamera(cam_mats=cam, z_min=0.1),
        tpnp.HuberPnPCost(delta=delta), out_cost=True).cost
    np.testing.assert_allclose(cost.numpy(), ev.numpy(), rtol=1e-5, atol=0)
    # same seeds, same draws: the twin is deterministic
    pose2, _ = rslm_kernel.rslm_init_reference(
        x3d, x2d, w2d, camera_to_fxfycxcy(cam).contiguous(), delta, seeds,
        dof=6, num_points=16, num_proposals=32, num_iter=3, z_min=0.1,
        score_points=128)
    assert torch.equal(pose, pose2)


@pytest.mark.parametrize('fast_sampling', [False, True])
def test_plain_rslm_samplers_match_jax_by_distribution(fast_sampling):
    """The jnp-path samplers (Gumbel top-k without replacement, and the
    inverse cdf with replacement) against the JAX ones, f64."""
    arrays = make_problem(bs=16, n=64, seed=4, dtype=np.float64)
    kw = dict(dof=6, num_points=16, num_proposals=32, num_iter=3,
              fast_sampling=fast_sampling)
    jres, tres = _solve_both(arrays, jpnp.RSLMSolver(**kw),
                             tpnp.RSLMSolver(**kw))
    _assert_same_regime(jres, tres)


def test_kernel_gate_is_the_jax_gate():
    rs = dict(dof=6, num_points=16, num_proposals=64)
    on = tpnp.RSLMSolver(use_pallas=True, fast_sampling=True, **rs)
    assert on.kernel_applies(8, 128)            # 8 * 64 = 512
    assert not on.kernel_applies(7, 128)        # below the 512 crossover
    assert not on.kernel_applies(8, 96)         # N % 128 != 0
    assert not tpnp.RSLMSolver(use_pallas=True, fast_sampling=True, dof=6,
                               num_points=24).kernel_applies(64, 128)
    assert not tpnp.RSLMSolver(use_pallas=True, **rs).kernel_applies(64, 128)
    assert not tpnp.RSLMSolver(fast_sampling=True, **rs).kernel_applies(
        64, 128)


def test_philox_matches_known_answer_vectors():
    """Philox4x32-10 (Random123 / curand) on its published test vectors."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff,) * 4, (0xffffffff,) * 2,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for ctr, key, expect in cases:
        out = rslm_kernel.philox4x32_10(*map(t, ctr), *map(t, key))
        assert [int(o) for o in out] == list(expect)
    u = rslm_kernel.philox_uniforms(torch.tensor([0], dtype=torch.int32), 1, 6)
    # draw 0 is word 0 of counter 0 (curand_uniform: x * 2**-32 + 2**-33)
    assert u[0, 0, 0].item() == np.float32(0x6627e8d5 * 2.0 ** -32
                                           + 2.0 ** -33)
    assert ((u > 0) & (u <= 1)).all()


def test_rslm_wrappers_refuse_what_they_do_not_run():
    x3d, x2d, w2d, cam = (torch.from_numpy(a)
                          for a in make_problem(bs=2, n=128))
    args = (x3d, x2d, w2d, camera_to_fxfycxcy(cam).contiguous(),
            torch.ones(2), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match='CUDA tensors'):
        rslm_kernel.rslm_init_cuda(*args)
    with pytest.raises(ValueError, match='unsupported device'):
        rslm_kernel.rslm_init(*[a.to('meta') for a in args])


@pytest.mark.parametrize('option', ['dof4', 'bounds'])
def test_rslm_kernel_refuses_options_not_ported(option):
    """The CUDA kernel runs dof 6 and 4, with or without (B, 4) projection
    bounds: its wrapper takes both as far as the device check, and refuses
    malformed bounds (and bounds at shapes of the legacy layout) before it
    looks at the device; the twin takes the same."""
    x3d, x2d, w2d, cam = (torch.from_numpy(a)
                          for a in make_problem(bs=2, n=128))
    args = (x3d, x2d, w2d, camera_to_fxfycxcy(cam).contiguous(),
            torch.ones(2), torch.zeros(2, dtype=torch.int32))
    kw = (dict(dof=4) if option == 'dof4' else
          dict(bounds=torch.tensor([[0., 0., 640., 480.]] * 2)))
    with pytest.raises(ValueError, match='CUDA tensors'):
        rslm_kernel.rslm_init_cuda(*args, **kw)
    if option == 'bounds':
        for bad in (torch.tensor([[0., 640.]] * 2),
                    torch.tensor([[0., 0., 640., 480.]] * 3),
                    [[0., 0., 640., 480.]] * 2):
            for fn in (rslm_kernel.rslm_init_cuda, rslm_kernel.rslm_init):
                with pytest.raises(ValueError, match='bounds'):
                    fn(*args, bounds=bad)
        with pytest.raises(ValueError, match='packed layout'):
            rslm_kernel.rslm_init_cuda(*args, num_points=24, **kw)
    pose, cost = rslm_kernel.rslm_init(*args, num_proposals=8, **kw)
    assert torch.isfinite(pose).all() and torch.isfinite(cost).all()


def _twin_init(n, dof, num_points, seed, score_points=None, bounds=None,
               b=8):
    p = make_pnp_problem(b, n, seed, dof=dof)
    x3d, x2d, w2d, cam = (torch.tensor(p[k], dtype=torch.float32)
                          for k in ('x3d', 'x2d', 'w2d', 'cams'))
    delta = torch.full((b,), 10.0 / n)
    pose, cost = rslm_kernel.rslm_init(
        x3d, x2d, w2d, camera_to_fxfycxcy(cam).contiguous(), delta,
        torch.arange(b, dtype=torch.int32) * 7919, bounds=bounds, dof=dof,
        num_points=num_points, num_proposals=32, num_iter=3, z_min=0.1,
        score_points=score_points)
    return p, (x3d, x2d, w2d, cam, delta), pose, cost


def _cost_of(arrays, pose, stride=1):
    x3d, x2d, w2d, cam, delta = arrays
    return tpnp.evaluate_pnp(
        x3d[:, ::stride], x2d[:, ::stride], w2d[:, ::stride], pose,
        tpnp.PerspectiveCamera(cam_mats=cam, z_min=0.1),
        tpnp.HuberPnPCost(delta=delta), out_cost=True).cost


@pytest.mark.parametrize('n,num_points,score_points,stride', [
    (384, 24, 128, 1),    # 128 % 24 != 0: legacy layout, full set
    (96, 16, None, 1),    # N % 128 != 0: legacy layout, full set
    (256, 16, 128, 2),    # packed layout: every 2nd point
    (256, 16, None, 1)])  # packed layout, no subsample asked
def test_twin_scores_as_the_jax_entry_dispatches(n, num_points,
                                                 score_points, stride):
    """The twin follows ``rslm_init_pallas``'s layout dispatch
    (``pallas_rslm.py:879-896``): its returned cost is the Huber cost of
    its pose on the points that layout scores (rtol 1e-4: f32 sums of up
    to 384 terms, and the twin's evaluation renormalises the quaternion,
    ``evaluate_pnp`` does not; a subsample's cost differs by tens of
    percent)."""
    _, arrays, pose, cost = _twin_init(n, 6, num_points, 3,
                                       score_points=score_points)
    np.testing.assert_allclose(cost.numpy(),
                               _cost_of(arrays, pose, stride).numpy(),
                               rtol=1e-4, atol=0)
    assert rslm_kernel.packed_layout(n, num_points) == (n % 128 == 0
                                                        and num_points == 16)


def test_legacy_layout_refuses_bounds():
    """Projection bounds need the packed layout, as the JAX entry asserts;
    at a packed shape the twin takes them."""
    bounds = torch.tensor([[-100., -100., 740., 580.]] * 8)
    with pytest.raises(ValueError, match='packed layout'):
        _twin_init(384, 6, 24, 4, bounds=bounds)
    _, _, pose, cost = _twin_init(256, 6, 16, 4, bounds=bounds)
    assert torch.isfinite(pose).all() and torch.isfinite(cost).all()


@pytest.mark.parametrize('dof', [4, 6])
def test_legacy_twin_matches_pallas_legacy_interpret(dof, monkeypatch):
    """The legacy layout (N=96) at dof 4 and 6 against the JAX legacy
    kernel in interpret mode, with the deterministic draws of
    ``tests/test_pallas_rslm_interpret.py`` (the port draws Philox).
    That test's invariants on both: every returned cost is the full-set
    cost of the returned pose, and the init beats the ground-truth pose
    shifted by 1 m; and the JAX tests' distributional rule, the port's
    median init cost under 2x the reference's (one-sided: the stubbed
    low-discrepancy draws are no random sampler, and at dof 6 the JAX
    kernel fed them lands several times above the port)."""
    from jax.experimental.pallas import tpu as pltpu
    from test_pallas_rslm_interpret import _stub_uniform_factory
    orig = pallas_rslm.pl.pallas_call
    monkeypatch.setattr(
        pallas_rslm.pl, 'pallas_call',
        lambda *a, **k: orig(*a, **{**k,
                                    'interpret': pltpu.InterpretParams()}))
    monkeypatch.setattr(pallas_rslm, '_uniform', _stub_uniform_factory())
    p, arrays, pose, cost = _twin_init(96, dof, 16, 5)
    x3d, x2d, w2d, cam, delta = arrays
    jpose, jcost = pallas_rslm.rslm_init_pallas.__wrapped__(
        *(jnp.asarray(a.numpy()) for a in (
            x3d, x2d, w2d, camera_to_fxfycxcy(cam), delta)),
        jnp.arange(8, dtype=jnp.int32), dof=dof, num_points=16,
        num_proposals=32, num_iter=3, tile_obj=4, z_min=0.1)
    jpose, jcost = np.array(jpose), np.array(jcost)
    np.testing.assert_allclose(cost.numpy(), _cost_of(arrays, pose).numpy(),
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(
        jcost, _cost_of(arrays, torch.from_numpy(jpose)).numpy(),
        rtol=2e-3, atol=1e-2)  # the interpret test's tolerance
    bad = torch.tensor(p['pose'], dtype=torch.float32)
    bad[:, 0] += 1.0
    bad_cost = _cost_of(arrays, bad).numpy()
    assert (cost.numpy() < bad_cost).all() and (jcost < bad_cost).all()
    assert np.median(cost.numpy()) <= 2 * np.median(jcost)
