"""The port's CUDA kernels against their torch twins, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips elsewhere.
The module imports torch and numpy only, so that it runs on a machine
without JAX: ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``
(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up).
"""

import numpy as np
import pytest
import torch

from epropnp_tpu_torch.ops import dcn_kernel
from epropnp_tpu_torch.ops import pnp as tpnp
from epropnp_tpu_torch.ops.pnp import lm_kernel, rslm_kernel
from epropnp_tpu_torch.utils.synthetic import make_pnp_problem

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (run on the GPU machine)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


def make_problem(b, n, seed, device, init_noise=0.05):
    """Synthetic 6DoF problem (as bench.make_problem) and a perturbed
    ground-truth init, float32 on ``device``."""
    p = make_pnp_problem(b, n, seed, init_noise=(init_noise, init_noise))
    return [torch.tensor(p[k], dtype=torch.float32, device=device)
            for k in ('x3d', 'x2d', 'w2d', 'cams', 'pose0')]


@pytest.mark.parametrize('b,n,fast', [(2048, 16, True), (32, 4096, True),
                                      (1024, 512, False)])
def test_lm_kernel_matches_twin(cuda_device, b, n, fast):
    """K1 at the serving and bench shapes: 99% of the objects agree with
    the twin on the final cost at rtol 1e-4 (summation order differs, so a
    near-tie accept/reject may flip)."""
    x3d, x2d, w2d, cams, pose0 = make_problem(b, n, 1, cuda_device)
    cam4 = lm_kernel.camera_to_fxfycxcy(cams).contiguous()
    delta = torch.full((b,), 10.0 / n, device=cuda_device)
    kw = dict(dof=6, num_iter=3 if fast else 10, fast_mode=fast)
    pk, ck = lm_kernel.lm_solve_cuda(x3d, x2d, w2d, cam4, delta, pose0, **kw)
    pt, ct = lm_kernel.lm_solve_reference(x3d, x2d, w2d, cam4, delta, pose0,
                                          **kw)
    assert torch.isfinite(pk).all() and torch.isfinite(ck).all()
    ok = torch.isclose(ck, ct, rtol=1e-4, atol=0)
    assert ok.float().mean().item() >= 0.99


def test_rslm_kernel_matches_twin(cuda_device):
    """K2 at the bench shape: finite, median cost within 2x of the twin's,
    and (the twin replays the kernel's Philox stream) 99% of the objects
    on the same cost at rtol 1e-4."""
    x3d, x2d, w2d, cams, _ = make_problem(1024, 512, 2, cuda_device)
    args = (x3d, x2d, w2d, lm_kernel.camera_to_fxfycxcy(cams).contiguous(),
            torch.full((1024,), 10.0 / 512, device=cuda_device),
            torch.arange(1024, dtype=torch.int32, device=cuda_device) * 7919)
    kw = dict(dof=6, num_points=16, num_proposals=64, num_iter=3,
              score_points=128)
    _, ck = rslm_kernel.rslm_init_cuda(*args, **kw)
    _, ct = rslm_kernel.rslm_init_reference(*args, **kw)
    assert torch.isfinite(ck).all()
    assert ck.median() <= 2 * ct.median()
    assert torch.isclose(ck, ct, rtol=1e-4, atol=0).float().mean() >= 0.99


def test_kernel_wrappers_refuse_bad_tensors(cuda_device):
    x3d, x2d, w2d, cams, pose0 = make_problem(4, 32, 3, cuda_device)
    cam4 = lm_kernel.camera_to_fxfycxcy(cams).contiguous()
    delta = torch.ones(4, device=cuda_device)
    with pytest.raises(TypeError, match='float32'):
        lm_kernel.lm_solve(x3d.double(), x2d, w2d, cam4, delta, pose0)
    with pytest.raises(ValueError, match='contiguous'):
        lm_kernel.lm_solve(x3d.transpose(0, 1).contiguous().transpose(0, 1),
                           x2d, w2d, cam4, delta, pose0)
    with pytest.raises(NotImplementedError, match='never JtJ'):
        lm_kernel.lm_solve(x3d, x2d, w2d, cam4, delta, pose0, with_jtj=True)
    with pytest.raises(ValueError, match='seeds'):
        rslm_kernel.rslm_init(x3d, x2d, w2d, cam4, delta,
                              torch.zeros(4, dtype=torch.int64,
                                          device=cuda_device))


def test_solver_on_card_goes_through_both_kernels(cuda_device):
    """``LMSolver`` with ``use_pallas`` on CUDA tensors launches K2 for the
    init (gate open) and K1 for the solve, once each."""
    x3d, x2d, w2d, cams, _ = make_problem(64, 256, 4, cuda_device)
    solver = tpnp.LMSolver(
        dof=6, num_iter=10, use_pallas=True,
        init_solver=tpnp.RSLMSolver(dof=6, num_points=16, num_proposals=64,
                                    num_iter=3, use_pallas=True,
                                    fast_sampling=True))
    camera = tpnp.PerspectiveCamera(cam_mats=cams)
    cost_fun = tpnp.AdaptiveHuberPnPCost(relative_delta=0.1).set_param(x2d,
                                                                       w2d)
    k1, k2 = lm_kernel.launches, rslm_kernel.launches
    pose, _, cost, _ = solver(x3d, x2d, w2d, camera, cost_fun,
                              with_cost=True)
    assert lm_kernel.launches == k1 + 1 and rslm_kernel.launches == k2 + 1
    assert torch.isfinite(pose).all() and torch.isfinite(cost).all()


@pytest.mark.parametrize('b,n,num_iter', [(4096, 16, 3), (256, 128, 5)])
def test_lm_kernel_dof4_bounds_matches_twin(cuda_device, b, n, num_iter):
    """K1 at dof 4 with projection bounds in fast mode (the Det serving
    solve), as chip_smoke.py phase f holds it: the principal points are
    shifted per object so that part of the projections lands outside the
    1600x672 box and is clamped; fast-mode steps keep the Jacobian rows of
    clamped points, so f32 rounding decides a few objects. 99% of the
    objects agree with the twin on the cost at rtol 1e-4, or the kernel
    meets the f64 twin at least as often as the f32 twin does; finiteness
    differs for at most 1% of the objects."""
    p = make_pnp_problem(b, n, 5, dof=4, init_noise=(0.05, 0.1),
                         focal=(1266.0, 1266.0), depth=(4.0, 20.0))
    shift = np.random.default_rng(6).uniform([-150., -150.], [1750., 820.],
                                             (b, 2))
    p['x2d'] = p['x2d'] + shift[:, None]
    p['cams'][:, :2, 2] += shift
    x3d, x2d, w2d, cams, pose0 = (
        torch.tensor(p[k], dtype=torch.float32, device=cuda_device)
        for k in ('x3d', 'x2d', 'w2d', 'cams', 'pose0'))
    bounds = torch.tensor([[-200.5, -200.5, 1799.5, 871.5]] * b,
                          device=cuda_device)
    args = (x3d, x2d, w2d, lm_kernel.camera_to_fxfycxcy(cams).contiguous(),
            torch.full((b,), 10.0 / n, device=cuda_device), pose0)
    kw = dict(bounds=bounds, dof=4, num_iter=num_iter, fast_mode=True)
    pk, ck = lm_kernel.lm_solve_cuda(*args, **kw)
    pt, ct = lm_kernel.lm_solve_reference(*args, **kw)
    _, c64 = lm_kernel.lm_solve_reference(
        *(a.double() for a in args), **dict(kw, bounds=bounds.double()))
    assert pk.shape == (b, 4)
    finite_k, finite_t = torch.isfinite(pk).all(-1), torch.isfinite(pt).all(-1)
    assert (finite_k != finite_t).float().mean() <= 0.01
    frac = lambda a, b_: torch.isclose(  # noqa: E731
        a.double(), b_.double(), rtol=1e-4, atol=0).float().mean()
    assert frac(ck, ct) >= 0.99 or frac(ck, c64) >= frac(ct, c64) - 0.005
@pytest.mark.parametrize('n,h,w,c,cout,stride', [
    (2, 9, 13, 32, 24, 1), (2, 9, 13, 16, 64, 2), (1, 20, 30, 64, 132, 1)])
def test_dcn_kernel_matches_twin(cuda_device, n, h, w, c, cout, stride):
    """K3 against its twin with offsets that reach outside the map, ragged
    L and cout: max|k - t| <= 1e-4 max|t| (f32 sums in another order)."""
    r = np.random.default_rng(n * h + c)
    ho, wo = dcn_kernel.output_hw(h, w, stride)
    t = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                               device=cuda_device)
    x = t(r.normal(size=(n, h, w, c)))
    om = t(r.normal(scale=2.0, size=(n, ho, wo, 27)))
    weight = t(r.normal(size=(cout, c, 3, 3)) / np.sqrt(9 * c))
    bias = t(r.normal(size=cout))
    before = dcn_kernel.launches
    with torch.no_grad():
        out = dcn_kernel.dcn_forward(x, om, weight, bias, stride, 2.0)
        ref = dcn_kernel.dcn_reference(x, om, weight, bias, stride, 2.0)
    assert dcn_kernel.launches == before + 1
    assert out.shape == (n, ho, wo, cout)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
