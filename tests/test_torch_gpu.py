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


@pytest.mark.parametrize('b,n,fast,num_iter', [
    (2048, 16, True, 3), (32, 4096, True, 3), (1024, 512, False, 10),
    # launch shapes (lm_kernel.group_size): groups of 2 (N=1) and 4 (N=2)
    # threads, where a solve is ill-posed (JtJ of rank 2 or 4) and f32
    # rounding decides its steps, so the sums of the one evaluation are
    # held; groups of 4 (N=15), 16 (N=16) and 8 (N=17) threads; B not a
    # multiple of the groups of a block in each; a warp a group (N=128)
    # with B not a multiple of 4; blocks of 64 (N=129), 256 (B=31, N=512)
    # and 512 (N=4096) threads
    (1000, 1, False, 0), (999, 2, False, 0), (9000, 15, True, 3),
    (3001, 16, False, 10), (5001, 17, True, 3), (3001, 128, False, 10),
    (257, 129, False, 10), (31, 512, False, 10), (33, 4096, False, 10)])
def test_lm_kernel_matches_twin(cuda_device, b, n, fast, num_iter):
    """K1 at the serving and bench shapes, and at the edges of its launch
    shapes (``lm_kernel.group_size``): 99% of the objects agree with the
    twin on the final cost at rtol 1e-4 (summation order differs, so a
    near-tie accept/reject may flip)."""
    x3d, x2d, w2d, cams, pose0 = make_problem(b, n, 1, cuda_device)
    cam4 = lm_kernel.camera_to_fxfycxcy(cams).contiguous()
    delta = torch.full((b,), 10.0 / n, device=cuda_device)
    kw = dict(dof=6, num_iter=num_iter, fast_mode=fast)
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
    with pytest.raises(NotImplementedError, match='dof 4 and 6'):
        lm_kernel.lm_solve(x3d, x2d, w2d, cam4, delta, pose0, dof=3)
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


@pytest.mark.parametrize('b,n,num_iter', [
    (4096, 16, 3), (256, 128, 5),
    (9000, 15, 3), (5001, 17, 3), (3001, 128, 3), (33, 4096, 3),
    # the flip-TTA refine (both branches' points) and a ragged neighbour
    (1536, 256, 5), (1535, 257, 5)])
def test_lm_kernel_dof4_bounds_matches_twin(cuda_device, b, n, num_iter):
    """K1 at dof 4 with projection bounds in fast mode (the Det serving
    solve, and at (1536, 256) the flip-TTA refine), as chip_smoke.py phase
    f holds it: the principal points are
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


@pytest.mark.parametrize('b,n', [(1536, 256), (300, 33)])
def test_lm_kernel_fast_jtj_matches_twin(cuda_device, b, n):
    """K1 in fast mode at dof 4 with bounds and the JtJ output: the solve
    of the Det Monte Carlo scoring (``det.test.mc_score_and_orient_density``
    on a flip-TTA problem), counted in ``launches_train``. The cost rule of
    test_lm_kernel_dof4_bounds_matches_twin; where the poses agree, 99% of
    the objects have max|dJtJ| <= 1e-4 max|JtJ|."""
    p = make_pnp_problem(b, n, 8, dof=4, init_noise=(0.05, 0.1),
                         focal=(1266.0, 1266.0), depth=(4.0, 20.0))
    shift = np.random.default_rng(9).uniform([-150., -150.], [1750., 820.],
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
    kw = dict(bounds=bounds, dof=4, num_iter=5, fast_mode=True,
              with_jtj=True)
    before = lm_kernel.launches_train
    out_k = lm_kernel.lm_solve(*args, **kw)
    assert lm_kernel.launches_train == before + 1
    out_t = lm_kernel.lm_solve_reference(*args, **kw)
    _, c64, _ = lm_kernel.lm_solve_reference(
        *(a.double() for a in args), **dict(kw, bounds=bounds.double()))
    frac = lambda a, b_: torch.isclose(  # noqa: E731
        a.double(), b_.double(), rtol=1e-4, atol=0).float().mean()
    assert frac(out_k[1], out_t[1]) >= 0.99 or frac(out_k[1], c64) >= frac(
        out_t[1], c64) - 0.005
    same = ((out_k[0] - out_t[0]).abs() <= 1e-4 * (out_t[0].abs() + 1e-2)
            ).all(-1) & torch.isfinite(out_t[2]).all(-1).all(-1)
    scale = out_t[2].abs().amax((1, 2))
    ok = (out_k[2] - out_t[2]).abs().amax((1, 2)) <= 1e-4 * scale
    assert ok[same].float().mean() >= 0.99


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


def _dcn_case(r, n, shapes, c, cout, stride, device):
    """A map (one level, or a canvas of ``shapes`` levels), a raw offset
    output reaching off the levels, a weight and a bias, f32."""
    t = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                               device=device)
    if len(shapes) == 1:
        (h, w), = shapes
        ho, wo = dcn_kernel.output_hw(h, w, stride)
        x = t(r.normal(size=(n, h, w, c)))
        om = t(r.normal(scale=2.0, size=(n, ho, wo, 27)))
        levels = None
    else:
        from epropnp_tpu_torch.ops.level_pack import (
            pack_levels, plan_level_packing)
        layout = plan_level_packing(shapes)
        x = pack_levels([t(r.normal(size=(n, h, w, c))) for h, w in shapes],
                        layout)
        om = t(r.normal(scale=2.0, size=x.shape[:3] + (27,)))
        levels = layout.regions()
    weight = t(r.normal(size=(cout, c, 3, 3)) / np.sqrt(9 * c))
    return x, om, weight, t(r.normal(size=cout)), levels


@pytest.mark.parametrize('variant', ['int8', 'bf16', 'int8_f32w'])
@pytest.mark.parametrize('n,shapes,c,cout,stride', [
    (2, [(9, 13)], 64, 24, 1), (2, [(9, 13)], 128, 64, 2),
    (2, [(12, 30), (6, 15), (3, 8)], 64, 68, 1)])
def test_dcn_kernel_variants_match_twin(cuda_device, variant, n, shapes, c,
                                        cout, stride):
    """K3's int8 variant (bf16 or f32 weight) and bf16 variant against the
    twin in the same variant, per level and with a 3-level table:
    max|k - t| <= 8e-3 max|t| (about two bf16 ulps of the largest entry:
    the combined corner value is rounded to bf16 on both sides, and a sum
    in another order can round it the other way). The int8 twin is within
    the JAX budget, 1e-2 max|t|, of the f32 twin."""
    r = np.random.default_rng(n * c + cout + stride)
    x, om, weight, bias, levels = _dcn_case(r, n, shapes, c, cout, stride,
                                            cuda_device)
    w3 = dcn_kernel.kernel_weight(weight)
    with torch.no_grad():
        ref32 = dcn_kernel.dcn_reference(x, om, w3, bias, stride, 2.0,
                                         levels)
        if variant == 'bf16':
            xv, w3v = x.to(torch.bfloat16), w3.to(torch.bfloat16)
        else:
            xv, w3v = dcn_kernel.quantize_nhwc(
                x, w3 if variant == 'int8_f32w' else w3.to(torch.bfloat16))
        counter = 'launches_bf16' if variant == 'bf16' else 'launches_int8'
        before = getattr(dcn_kernel, counter)
        out = dcn_kernel.dcn_forward(xv, om, w3v, bias, stride, 2.0, levels)
        ref = dcn_kernel.dcn_reference(xv, om, w3v, bias, stride, 2.0,
                                       levels)
    assert getattr(dcn_kernel, counter) == before + 1
    assert out.dtype == ref.dtype == w3v.dtype
    assert out.shape == ref.shape == ref32.shape
    scale = ref.float().abs().max()
    assert (out.float() - ref.float()).abs().max() <= 8e-3 * scale
    if variant != 'bf16':
        assert (ref.float() - ref32).abs().max() < 1e-2 * ref32.abs().max()
    if levels is not None:  # every level's rows, in table order
        assert out.shape[0] == n * sum(h * w for h, w in shapes)


# Edges of K3's tiling (blocks of 128 positions x 128 outputs; chunks of 16
# f32 or 32 bf16 channels; mma tiles of 8 outputs): L not a multiple of
# 128; cout past a block edge, 520 (a multiple of 8) and 524 (4 mod 8, a
# ragged mma tile); c = cout = 512 (stage 4) on a small map; an 8-level
# table with levels smaller than a block; a stride-2 map.
K3_EDGE_CASES = [  # (n, shapes, c, cout, stride)
    (1, [(11, 13)], 64, 64, 1),
    (1, [(9, 10)], 64, 520, 1),
    (1, [(9, 10)], 64, 524, 1),
    (1, [(7, 9)], 512, 512, 1),
    (2, [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2), (3, 3), (5, 7),
         (1, 1)], 64, 36, 1),
    (1, [(15, 17)], 64, 132, 2),
]


@pytest.mark.parametrize('variant', ['f32', 'int8_f32w', 'bf16', 'int8'])
@pytest.mark.parametrize('n,shapes,c,cout,stride', K3_EDGE_CASES)
def test_dcn_kernel_tiling_edges_match_twin(cuda_device, variant, n, shapes,
                                            c, cout, stride):
    """K3 at the edges of its tiles, every pair of map and weight type,
    against the twin in the same variant: max|k - t| <= 1e-4 max|t| where
    the weight is f32 (f32 sums in another order), 8e-3 where it is bf16
    (phase e+'s rule: the combined value rounds to bf16 on both sides)."""
    r = np.random.default_rng(len(shapes) * 1000 + c + cout + stride)
    x, om, weight, bias, levels = _dcn_case(r, n, shapes, c, cout, stride,
                                            cuda_device)
    w3 = dcn_kernel.kernel_weight(weight)
    if variant == 'f32':
        xv, w3v = x, w3
    elif variant == 'bf16':
        xv, w3v = x.to(torch.bfloat16), w3.to(torch.bfloat16)
    else:
        xv, w3v = dcn_kernel.quantize_nhwc(
            x, w3 if variant == 'int8_f32w' else w3.to(torch.bfloat16))
    counter = {'f32': 'launches', 'bf16': 'launches_bf16'}.get(
        variant, 'launches_int8')
    before = getattr(dcn_kernel, counter)
    with torch.no_grad():
        out = dcn_kernel.dcn_forward(xv, om, w3v, bias, stride, 2.0, levels)
        ref = dcn_kernel.dcn_reference(xv, om, w3v, bias, stride, 2.0,
                                       levels)
    torch.cuda.synchronize()
    assert getattr(dcn_kernel, counter) == before + 1
    assert out.dtype == ref.dtype == w3v.dtype
    assert out.shape == ref.shape
    rule = 1e-4 if w3v.dtype == torch.float32 else 8e-3
    scale = ref.float().abs().max()
    assert (out.float() - ref.float()).abs().max() <= rule * scale


@pytest.mark.parametrize('dof', [4, 6])
@pytest.mark.parametrize('n,num_points,num_proposals', [
    (96, 16, 64), (384, 24, 64), (256, 16, 64),
    # proposals filling half a warp, two warps, and 100 (a ragged warp);
    # N=2 (legacy) and N=512 (packed)
    (2, 16, 16), (96, 16, 100), (512, 16, 16), (512, 16, 100)])
def test_rslm_kernel_dof_and_legacy_match_twin(cuda_device, dof, n,
                                               num_points, num_proposals):
    """K2 at dof 4 and 6, at legacy shapes (full-set scoring) and a
    packed one: 99% of the objects on the twin's cost at rtol 1e-4 (the
    same Philox draws), or, where the f32 twin itself misses its f64 run
    that often (dof 4: 98-99% of the objects agree), the kernel as close
    to the f64 twin as the f32 twin is; and the returned cost is the
    full-set cost of the returned pose at the legacy shapes (rtol 1e-3).
    At two points (N=2) every proposal fits both points to about the f32
    resolution of a projection after its 3 steps, so rounding orders the
    proposal costs and sets the cost of a pose: there the kernel is held
    by the bench shape's distributional rule (median within 2x of the
    twin's) and finiteness."""
    p = make_pnp_problem(512, n, 7, dof=dof)
    x3d, x2d, w2d, cams = (torch.tensor(p[k], dtype=torch.float32,
                                        device=cuda_device)
                           for k in ('x3d', 'x2d', 'w2d', 'cams'))
    delta = torch.full((512,), 10.0 / n, device=cuda_device)
    args = (x3d, x2d, w2d, lm_kernel.camera_to_fxfycxcy(cams).contiguous(),
            delta, torch.arange(512, dtype=torch.int32,
                                device=cuda_device) * 7919)
    kw = dict(dof=dof, num_points=num_points, num_proposals=num_proposals,
              num_iter=3, score_points=128)
    legacy = not rslm_kernel.packed_layout(n, num_points)
    counter = 'launches_legacy' if legacy else 'launches'
    before = getattr(rslm_kernel, counter)
    pk, ck = rslm_kernel.rslm_init(*args, **kw)
    _, ct = rslm_kernel.rslm_init_reference(*args, **kw)
    _, c64 = rslm_kernel.rslm_init_reference(
        *(a.double() for a in args[:5]), args[5], **kw)
    assert getattr(rslm_kernel, counter) == before + 1
    assert pk.shape == (512, 4 if dof == 4 else 7)
    assert torch.isfinite(pk).all() and torch.isfinite(ck).all()
    frac = lambda a, b_: torch.isclose(  # noqa: E731
        a.double(), b_.double(), rtol=1e-4, atol=0).float().mean()
    if n == 2:
        # neither f32 run meets the f64 one for more than a third of the
        # objects here: the argmin is decided by rounding
        assert ck.median() <= 2 * ct.median()
        return
    assert frac(ck, ct) >= 0.99 or frac(ck, c64) >= frac(ct, c64) - 0.005
    if legacy:
        ev = tpnp.evaluate_pnp(
            x3d, x2d, w2d, pk, tpnp.PerspectiveCamera(cam_mats=cams,
                                                      z_min=0.1),
            tpnp.HuberPnPCost(delta=delta), out_cost=True).cost
        assert torch.isclose(ck, ev, rtol=1e-3, atol=0).all()


def _frac_close(a, b_, floor=0.0):
    """Share of rows whose every entry is within 1e-4 * (|b| + floor)."""
    a, b_ = a.double(), b_.double()
    ok = (a - b_).abs() <= 1e-4 * (b_.abs() + floor)
    return ok.reshape(ok.shape[0], -1).all(-1).float().mean().item()


@pytest.mark.parametrize('dof,b,n,num_iter,jtj', [
    (6, 128, 16, 3, False), (6, 32, 512, 5, True), (4, 1536, 128, 10, True),
    # launch shapes (see test_lm_kernel_matches_twin; at N=2 the sums of
    # the one evaluation)
    (4, 999, 2, 0, True), (4, 9000, 15, 5, False),
    (6, 5001, 17, 3, True), (4, 3001, 128, 5, True), (6, 257, 129, 5, True),
    (4, 33, 4096, 3, True)])
def test_lm_kernel_training_modes_match_twin(cuda_device, dof, b, n,
                                             num_iter, jtj):
    """K1 in the trust region with projection bounds (and the JtJ output)
    at the training shapes, as chip_smoke.py phase i holds it: 99% of the
    objects on the twin's cost and pose at rtol 1e-4, or the kernel as
    close to the f64 twin as the f32 twin is (cost within 0.005 of its
    share, pose within 0.02: clamped points leave flat directions in which
    f32 rounding moves the pose, and the f32 twin itself meets its f64
    pose for only 78-97% of the objects here); where the poses agree, 99%
    of the objects have max|dJtJ| <= 1e-4 max|JtJ| (an all-zero JtJ, of an
    object whose points all lie past a bound, agrees with itself)."""
    from epropnp_tpu_torch.utils.synthetic import make_bounded_pnp_problem
    p = make_bounded_pnp_problem(b, n, 11, dof, init_noise=(
        (0.3, 0.5) if n == 16 else (0.05, 0.1)))
    t = {k: torch.tensor(v, dtype=torch.float32, device=cuda_device)
         for k, v in p.items()}
    args = (t['x3d'], t['x2d'], t['w2d'],
            lm_kernel.camera_to_fxfycxcy(t['cams']).contiguous(), t['delta'],
            t['pose0'])
    kw = dict(bounds=t['bounds'], dof=dof, num_iter=num_iter,
              fast_mode=False, z_min=0.1, with_jtj=jtj)
    before = lm_kernel.launches_train
    out_k = lm_kernel.lm_solve(*args, **kw)
    assert lm_kernel.launches_train == before + 1
    out_t = lm_kernel.lm_solve_reference(*args, **kw)
    out_64 = lm_kernel.lm_solve_reference(
        *(a.double() for a in args), **dict(kw, bounds=t['bounds'].double()))
    assert all(torch.isfinite(o).all() for o in out_k)
    cost = _frac_close(out_k[1], out_t[1])
    assert cost >= 0.99 or _frac_close(out_k[1], out_64[1]) >= _frac_close(
        out_t[1], out_64[1]) - 0.005
    pose = _frac_close(out_k[0], out_t[0], 1e-2)
    assert pose >= 0.99 or _frac_close(out_k[0], out_64[0], 1e-2) >= \
        _frac_close(out_t[0], out_64[0], 1e-2) - 0.02
    if jtj:
        same = ((out_k[0] - out_t[0]).abs() <= 1e-4 * (out_t[0].abs() + 1e-2)
                ).all(-1)
        scale = out_t[2].abs().amax((1, 2))
        ok = (out_k[2] - out_t[2]).abs().amax((1, 2)) <= 1e-4 * scale
        assert ok[same].float().mean() >= 0.99


def test_train_step_on_card_launches_k1_twice(cuda_device):
    """One 6DoF training step on the card (tiny CDPN, fused kernels on):
    K1 runs twice in its training modes (the init's proposals and the main
    solve with JtJ) and no time in the serving modes; the losses are
    finite and the parameters move."""
    import dataclasses
    from epropnp_tpu_torch.sixdof import config, main
    from epropnp_tpu_torch.utils.synthetic import make_sixdof_batch
    cfg = config.SixDoFConfig(
        network=config.NetworkConfig(back_layers_num=18),
        dataiter=config.DataIterConfig(inp_res=64, out_res=16,
                                       sample_points=32),
        pnp=dataclasses.replace(config.PnPConfig(), use_pallas=True,
                                mc_samples=64),
        train=config.TrainConfig(lr_epoch_step=()))
    model, _, step_fn = main.build_all(cfg, device=cuda_device)
    state = main.init_state(cfg, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = main.to_device(tuple(make_sixdof_batch(0, 8, 64, 16).values()),
                           cuda_device)
    k1, k1_train = lm_kernel.launches, lm_kernel.launches_train
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    metrics = step_fn(state, batch, gen)
    torch.cuda.synchronize()
    assert lm_kernel.launches_train == k1_train + 2
    assert lm_kernel.launches == k1
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert int(metrics['skipped']) == 0
    assert any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items()
               if k.endswith('weight'))


@pytest.mark.parametrize('b', [288, 1536])
def test_rslm_kernel_bounds_matches_twin(cuda_device, b):
    """K2 with projection bounds at the Det training shape (dof 4, N=128,
    64 proposals x 16 points x 3 iterations; B=288 is one v1b step's
    objects), by chip_smoke.py phase l's rules over as many seeded problems
    as make ~6000 objects: 99% of the objects on the twin's cost at rtol
    1e-4 (the twin replays the Philox stream), or the kernel as close to
    the f64 twin as the f32 twin is (less 0.005); the returned cost is the
    bounded cost of the returned pose; the median within 2x of the twin's.
    Pooled, because which of two near-tied proposals wins is decided by
    f32 rounding: on one problem of 288 objects the kernel's and the f32
    twin's shares of objects on the f64 cost differ by a few percent
    either way, and pooled they meet (chip_smoke.py phase l, PERF.md)."""
    from epropnp_tpu_torch.utils.synthetic import make_bounded_pnp_problem
    costs = []
    for seed in range(21, 21 + -(-6000 // b)):
        p = make_bounded_pnp_problem(b, 128, seed, 4)
        t = {k: torch.tensor(v, dtype=torch.float32, device=cuda_device)
             for k, v in p.items()}
        cam4 = lm_kernel.camera_to_fxfycxcy(t['cams']).contiguous()
        seeds = torch.arange(b, dtype=torch.int32, device=cuda_device) * 7919
        args = (t['x3d'], t['x2d'], t['w2d'], cam4, t['delta'], seeds)
        kw = dict(bounds=t['bounds'], dof=4, num_points=16,
                  num_proposals=64, num_iter=3, z_min=0.1, score_points=128)
        before = rslm_kernel.launches_bounds
        pk, ck = rslm_kernel.rslm_init(*args, **kw)
        assert rslm_kernel.launches_bounds == before + 1
        _, ct = rslm_kernel.rslm_init_reference(*args, **kw)
        _, c64 = rslm_kernel.rslm_init_reference(
            *(a.double() for a in args[:5]), seeds,
            **dict(kw, bounds=t['bounds'].double()))
        assert torch.isfinite(pk).all() and torch.isfinite(ck).all()
        camera = tpnp.PerspectiveCamera(cam_mats=t['cams'], z_min=0.1,
                                        lb=t['bounds'][:, :2],
                                        ub=t['bounds'][:, 2:])
        ev = tpnp.evaluate_pnp(t['x3d'], t['x2d'], t['w2d'], pk, camera,
                               tpnp.HuberPnPCost(delta=t['delta']),
                               out_cost=True).cost
        assert torch.isclose(ck, ev, rtol=1e-3, atol=0).all()
        assert ck.median() <= 2 * ct.median()
        costs.append((ck, ct, c64))
    ck, ct, c64 = (torch.cat(c) for c in zip(*costs))
    assert _frac_close(ck, ct) >= 0.99 or _frac_close(ck, c64) >= \
        _frac_close(ct, c64) - 0.005


@pytest.mark.parametrize('stride', [1, 2])
def test_dcn_backward_on_card_matches_autograd_of_the_twin(cuda_device,
                                                           stride):
    """Gradients through K3's ``autograd.Function`` on the card (the
    kernel's forward, ``dcn_backward``) against torch autograd through
    ``dcn_reference`` (f32): max|d| <= 2.2e-4 max|ref| for the map, the raw
    offsets, the weight and the bias (chip_smoke.py phase m's rule)."""
    r = np.random.default_rng(stride)
    n, h, w, c, cout = 2, 13, 17, 32, 16
    ho, wo = dcn_kernel.output_hw(h, w, stride)
    make = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
        r.normal(size=s) * scale, dtype=torch.float32, device=cuda_device)
    x, om = make(n, h, w, c), make(n, ho, wo, 27, scale=1.5)
    weight, bias = make(cout, c, 3, 3, scale=0.1), make(cout)
    ct = make(n, ho, wo, cout)
    grads = []
    for fn in (dcn_kernel.dcn_forward, dcn_kernel.dcn_reference):
        leaves = [t.clone().requires_grad_() for t in (x, om, weight, bias)]
        before = dcn_kernel.launches
        out = fn(*leaves, stride=stride)
        assert dcn_kernel.launches == before + (
            fn is dcn_kernel.dcn_forward)
        grads.append(torch.autograd.grad(out, leaves, ct))
    for got, ref in zip(*grads):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max() <= 2.2e-4 * ref.abs().max()


def test_deform_conv_with_bias_on_card_matches_cpu(cuda_device):
    """A ``DeformConv`` built with a bias (``DetConfig.dcn_bias``) in f32
    training: K3 adds the bias on the card and ``DCNFunction`` returns its
    gradient. Card against the CPU twin: the forward within 1e-4 of max|t|
    (phase e's rule), the weight and bias gradients within phase m's
    2.2e-4."""
    from epropnp_tpu_torch.ops.deform_conv import DeformConv
    torch.manual_seed(3)
    mod = DeformConv(32, 24, bias=True)
    with torch.no_grad():
        mod.bias.normal_(0, 0.5)
        mod.conv_offset.weight.normal_(0, 0.05)
    card = DeformConv(32, 24, bias=True).to(cuda_device)
    card.load_state_dict(mod.state_dict())
    x = torch.randn(2, 9, 13, 32)
    before = dcn_kernel.launches
    got = card(x.to(cuda_device))
    ref = mod(x)
    assert dcn_kernel.launches == before + 1
    assert (got.detach().cpu() - ref.detach()).abs().max() \
        <= 1e-4 * ref.abs().max()
    ct = torch.randn(ref.shape)
    got.backward(ct.to(cuda_device))
    ref.backward(ct)
    for name in ('weight', 'bias'):
        g, r = getattr(card, name).grad.cpu(), getattr(mod, name).grad
        assert (g - r).abs().max() <= 2.2e-4 * r.abs().max(), name


def test_det_train_step_on_card_launches_its_kernels(cuda_device):
    """One Det training step on the card at a reduced width that still
    meets the fused-init gate (8 heads x 16 points = N 128, 8 objects x 64
    proposals): K2 runs twice with bounds (the Monte Carlo forward's init
    and the score solve), K1 twice in its training modes, K3-f32 once per
    tower DCN and level; finite losses; the parameters move."""
    from epropnp_tpu_torch.det import config, main
    from epropnp_tpu_torch.utils.synthetic import (DET_BATCH_FIELDS,
                                                   make_det_batch)
    cfg = config.DetConfig(
        num_classes=3, backbone_depth=18, embed_dims=64, num_heads=8,
        num_points=16, strides=(8, 16, 32, 64), output_stride=8,
        num_attrs=4,
        pnp=config.DetPnPConfig(mc_samples=16, num_iter=2, use_pallas=True),
        train=config.DetTrainConfig(num_obj_samples_per_img=4,
                                    roi_shape=(8, 8), max_gt_per_img=4))
    model, step_fn = main.build_all(cfg, cuda_device)
    state = main.init_state(cfg, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    b = make_det_batch(0, 2, 128, 128)
    batch = main.to_device(tuple(b[k] for k in DET_BATCH_FIELDS),
                           cuda_device)
    counts = (rslm_kernel.launches_bounds, lm_kernel.launches_train,
              lm_kernel.launches, dcn_kernel.launches)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    metrics = step_fn(state, batch, gen)
    torch.cuda.synchronize()
    assert rslm_kernel.launches_bounds == counts[0] + 2
    assert lm_kernel.launches_train == counts[1] + 2
    assert lm_kernel.launches == counts[2]
    assert dcn_kernel.launches == counts[3] + 2 * 4  # 2 towers x 4 levels
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert int(metrics['skipped']) == 0
    assert any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items()
               if k.endswith('weight'))
