"""Smoke run of the PyTorch/CUDA port (``epropnp_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card (an H100: the kernels are built for ``sm_90a``).

It builds the hand-written kernels from ``epropnp_tpu_torch/csrc`` with
``nvcc`` (K1 fused LM solve, K2 fused RSLM init, K3 DCNv2 sampling
contraction; one compiler per source, all started together) and runs
seven phases; any failure exits non-zero:

a. K1 (fused LM solve) against its torch twin on the card, at the shapes
   of the main path: (2048, 16) and (32, 4096) in fast Gauss-Newton mode,
   (1024, 512) with the full trust region.
b. K2 (fused RSLM init) against its twin at B=1024, N=512: per object
   (the twin replays the kernel's Philox stream), by distribution (median
   init cost within 2x of the twin's) and by the cost consistency of the
   returned pose.
c. Serving: a full-width CDPN-34 on seeded random weights answers 3
   requests of 32 crops at 256x256 through ``sixdof.test.infer_poses``
   (``init='rslm'``, fused kernels on); each request must launch K1 twice
   (the proposals' solve and the refine).
d. The bench problem (``bench.make_problem``: 6DoF, B=1024, N=512, RSLM
   init with 64 proposals, then 10 trust-region LM iterations) through
   ``LMSolver``, kernel path against twin path.
e. K3 against its twin (and an f64 twin) at the Det serving shapes
   (672x1600 x 6 images): a backbone stage-3 layer at stride 1 and its
   stride-2 first block, a stage-4 layer, FCOS level 0.
f. K1 at dof 4 with projection bounds in fast mode (the Det solve) against
   its twin (and an f64 twin) at (98304, 16) x 3 and (1536, 128) x 5.
g. Det serving: EPro-PnP-Det v1b (ResNet-101-DCN, FPN, FCOSEmbHead,
   DeformPnPHead, the 4DoF solve) on seeded random weights answers 3
   requests of 6 camera frames (1600x900, sky-cropped to 1600x672) through
   ``det.api.inference_detector``; each request must launch K3 36 times and
   K1 twice. A 320x800 image runs through the card and through the twins
   on the CPU with the same random draws.

Every launch counter is set to 0 before phases c, d and g (the main path)
and read after them. Earlier lines print each phase's numbers, the card's
``nvidia-smi`` name and power limit, and one JSON object with a row per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# K1 agreement rule: summation order differs between the kernel (warp
# shuffles) and the twin (torch reductions), so a near-tie accept/reject
# or a near-singular step can flip for a few objects; at least 99% of the
# objects must agree on the final cost (rtol 1e-4) and on every pose
# component (|d| <= 1e-4 * (|ref| + 1e-2)).
K1_RTOL, K1_MIN_FRAC = 1e-4, 0.99
# K2: the twin replays the kernel's Philox stream, so both draw the same
# samples; at least 99% of the objects must agree on the init cost at
# rtol 1e-4 (the rest: an argmin flipped by a near-tie of proposal costs
# summed in another order). Beside it the JAX test's distributional rule
# (median init cost within 2x of the twin's) and consistency (returned
# cost == scoring-subsample cost of the returned pose, rtol 1e-3: the
# kernel's pose is renormalised, evaluate_pnp's projection is not).
K2_MEDIAN_RATIO, K2_CONSIST_RTOL = 2.0, 1e-3
# K3: max|kernel - twin| <= 1e-4 * max|twin| (f32 sums of 2304-4608 terms
# in another order; the f64 twin's distance to both is printed beside it).
K3_REL = 1e-4
# Peak rates of one H100 SXM (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3.
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
# f32 operations of one point evaluation in K1/K2 (projection, Huber cost
# and IRLS rescale, Jacobian, JtJ + gradient sums; an FMA counts 2),
# counted from accumulate_point in csrc/pnp_common.cuh; the scoring cost
# of one point (point_cost) is about 40.
K1_POINT_FLOPS = {6: 200, 4: 130}
K2_SCORE_FLOPS = 40
# Det phase: residual-branch scale of the random backbone (see
# build_det_model) and the card-against-CPU rule of the dense outputs,
# max|card - cpu| <= 1e-4 * max|cpu| per output (f32 on both sides).
RESIDUAL_SCALE, DET_DENSE_REL = 0.3, 1e-4
# nuScenes CAM_FRONT-like intrinsics of a 1600x900 frame
NUSCENES_K = [[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5], [0.0, 0.0, 1.0]]
LINEMOD_K = [[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
             [0.0, 0.0, 1.0]]


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def pnp_problem(torch, device, b, n, seed, init_noise):
    """Synthetic 6DoF problem (``bench.make_problem`` at any size) and a
    perturbed ground-truth init: f32 tensors x3d, x2d, w2d, cam4, pose0."""
    from epropnp_tpu_torch.ops.pnp.lm_kernel import camera_to_fxfycxcy
    from epropnp_tpu_torch.utils.synthetic import make_pnp_problem
    p = make_pnp_problem(b, n, seed, init_noise=init_noise)
    t = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in p.items()}
    return (t['x3d'], t['x2d'], t['w2d'],
            camera_to_fxfycxcy(t['cams']).contiguous(), t['pose0'])


def time_ms(torch, fn, warmup=2, iters=10):
    """Mean device time of ``fn`` in ms (CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes):
    """The least time for the work on one H100 (ms) and what bounds it:
    operations at the f32 peak or bytes (each input read once, each output
    written once) at the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def k1_bound(b, n, dof, evals):
    """K1's bound: ``evals`` point evaluations per object, the points,
    camera, delta and pose read once, pose and cost written once."""
    pose = 4 if dof == 4 else 7
    return bound_ms(K1_POINT_FLOPS[dof] * b * n * evals,
                    b * (28 * n + 4 * (4 + 1 + 2 * pose + 1)))


def profile_once(torch, fn, label, top=6):
    """Profile one call of ``fn`` with ``torch.profiler``: print the wall
    time, the summed device time of its kernels and the top kernels.

    An error of ``fn`` (a failed launch) propagates; only the reading of
    the trace, which is instrumentation, reports a failure instead.
    """
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    try:
        events = prof.key_averages()
        dev = lambda e: getattr(e, 'self_device_time_total', None) or getattr(  # noqa: E731,E501
            e, 'self_cuda_time_total', 0)
        # device-side events only: an op's row repeats its kernels' time
        kernels = sorted(
            (e for e in events if dev(e) > 0
             and str(getattr(e, 'device_type', '')).endswith('CUDA')),
            key=dev, reverse=True)
        busy_us = sum(dev(e) for e in kernels)
    except Exception as err:  # noqa: BLE001 - reading the trace only
        print(f'profile {label}: unreadable ({type(err).__name__}: {err})')
        return []
    print(f'profile {label}: wall {wall * 1e3:.3f} ms, device busy '
          f'{busy_us / 1e3:.3f} ms ({len(kernels)} kernel names)')
    for e in kernels[:top]:
        print(f'profile {label}:   {dev(e) / 1e3:9.3f} ms  x{e.count:<5d} '
              f'{e.key[:90]}')
    return [(e.key, dev(e) / 1e3, e.count) for e in kernels]


def agree(a, b, rtol, floor):
    """Per-row: every entry within rtol * (|b| + floor)."""
    ok = np.abs(a - b) <= rtol * (np.abs(b) + floor)
    return ok.reshape(ok.shape[0], -1).all(-1)


def phase_a(torch, device):
    """K1 against its twin at the main path's shapes."""
    from epropnp_tpu_torch.ops.pnp import lm_kernel as k1
    shapes = [  # (B, N, fast_mode, num_iter, what)
        (2048, 16, True, 3, 'serving RSLM proposals'),
        (32, 4096, True, 3, 'serving refine'),
        (1024, 512, False, 10, 'bench trust-region LM'),
    ]
    rows, max_err = [], 0.0
    for i, (b, n, fast, iters, what) in enumerate(shapes):
        noise = (0.05, 0.1) if fast else (0.3, 0.5)
        x3d, x2d, w2d, cam, pose0 = pnp_problem(torch, device, b, n, 10 + i,
                                                noise)
        delta = torch.full((b,), 10.0 / n, device=device)
        kw = dict(dof=6, num_iter=iters, fast_mode=fast, z_min=0.1)
        run_k = lambda: k1.lm_solve_cuda(x3d, x2d, w2d, cam, delta, pose0, **kw)  # noqa: E731,E501
        run_t = lambda: k1.lm_solve_reference(x3d, x2d, w2d, cam, delta, pose0, **kw)  # noqa: E731,E501
        pk, ck = run_k()
        pt, ct = run_t()
        torch.cuda.synchronize()
        pk, ck, pt, ct = (t.cpu().numpy() for t in (pk, ck, pt, ct))
        assert np.isfinite(pk).all() and np.isfinite(ck).all(), 'K1 non-finite'
        frac_c = agree(ck, ct, K1_RTOL, 0.0).mean()
        frac_p = agree(pk, pt, K1_RTOL, 1e-2).mean()
        err = float(max(np.abs(pk - pt).max(), np.abs(ck - ct).max()))
        max_err = max(max_err, err)
        ms = time_ms(torch, run_k, iters=20)
        plain_ms = time_ms(torch, run_t, iters=5)
        row = dict(B=b, N=n, fast_mode=fast, num_iter=iters, what=what,
                   cost_agree=float(frac_c), pose_agree=float(frac_p),
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=k1_bound(b, n, 6, iters + (not fast))[0])
        print('phase a: K1 ' + json.dumps(row))
        assert frac_c >= K1_MIN_FRAC and frac_p >= K1_MIN_FRAC, \
            f'K1 disagrees with its twin at {(b, n, fast)}'
        rows.append(row)
    main = rows[-1]
    bound, by = k1_bound(main['B'], main['N'], 6, main['num_iter'] + 1)
    return dict(name='lm_solve (K1)', route='cuda',
                source='epropnp_tpu_torch/csrc/lm_kernel.cu',
                replaces='epropnp_tpu/ops/pnp/pallas_lm.py:396',
                max_abs_err=max_err, ms=main['ms'], plain_ms=main['plain_ms'],
                bound_ms=bound, bound_by=by, library_ms=None)


def phase_b(torch, device):
    """K2 against its twin at B=1024, N=512."""
    import bench
    from epropnp_tpu_torch.ops.pnp import HuberPnPCost, PerspectiveCamera
    from epropnp_tpu_torch.ops.pnp import evaluate_pnp
    from epropnp_tpu_torch.ops.pnp import rslm_kernel as k2
    from epropnp_tpu_torch.ops.pnp.lm_kernel import camera_to_fxfycxcy
    x3d, x2d, w2d, cam, _ = (torch.from_numpy(np.ascontiguousarray(a)).to(
        device) for a in bench.make_problem(seed=1))
    b, n = x3d.shape[:2]
    cam4 = camera_to_fxfycxcy(cam).contiguous()
    delta = torch.full((b,), 10.0 / n, device=device)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(7)
                          ).to(device)
    kw = dict(dof=6, num_points=16, num_proposals=64, num_iter=3,
              z_min=0.1, score_points=128)
    run_k = lambda: k2.rslm_init_cuda(x3d, x2d, w2d, cam4, delta, seeds, **kw)  # noqa: E731,E501
    run_t = lambda: k2.rslm_init_reference(x3d, x2d, w2d, cam4, delta, seeds, **kw)  # noqa: E731,E501
    pk, ck = run_k()
    pt, ct = run_t()
    torch.cuda.synchronize()
    assert torch.isfinite(pk).all() and torch.isfinite(ck).all(), \
        'K2 non-finite'
    stride = n // 128
    camera = PerspectiveCamera(cam_mats=cam, z_min=0.1)
    ev = evaluate_pnp(x3d[:, ::stride], x2d[:, ::stride], w2d[:, ::stride],
                      pk, camera, HuberPnPCost(delta=delta), out_cost=True)
    ck_n, ct_n, ev_n = (t.cpu().numpy() for t in (ck, ct, ev.cost))
    med_k, med_t = float(np.median(ck_n)), float(np.median(ct_n))
    consist = agree(ck_n, ev_n, K2_CONSIST_RTOL, 0.0).mean()
    replay = agree(ck_n, ct_n, K1_RTOL, 0.0).mean()  # same Philox draws
    err = float(np.abs(ck_n - ct_n).max())
    ms = time_ms(torch, run_k, iters=10)
    plain_ms = time_ms(torch, run_t, iters=3)
    print('phase b: K2 ' + json.dumps(dict(
        B=b, N=n, median_cost=med_k, twin_median_cost=med_t,
        consistency=float(consist), per_object_agree=float(replay),
        max_abs_cost_err=err, ms=ms, plain_ms=plain_ms)))
    assert replay >= K1_MIN_FRAC, 'K2 disagrees with its twin per object'
    assert med_k <= K2_MEDIAN_RATIO * med_t, 'K2 init worse than 2x twin'
    assert consist == 1.0, 'K2 cost is not the cost of its pose'
    props, pts, iters = kw['num_proposals'], kw['num_points'], kw['num_iter']
    flops = b * props * (K1_POINT_FLOPS[6] * pts * (iters + 1)
                         + K2_SCORE_FLOPS * kw['score_points'])
    bound, by = bound_ms(flops, b * (28 * n + 4 * (4 + 1 + 1 + 7 + 1)))
    print(f'phase b: K2 bound {bound:.4f} ms ({by})')
    return dict(name='rslm_init (K2)', route='cuda',
                source='epropnp_tpu_torch/csrc/rslm_kernel.cu',
                replaces='epropnp_tpu/ops/pnp/pallas_rslm.py:817',
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def calibrate_batchnorm(torch, model, inp):
    """Set every BatchNorm's running statistics to those of one batch.

    With random weights and the default statistics (mean 0, var 1) the
    eval-mode activations shrink layer by layer, the dense noc map comes
    out nearly constant and the PnP problem degenerates to a single 3D
    point. Calibrated statistics normalise each layer as training would,
    so the seeded model emits a spread-out point cloud.
    """
    for mod in model.modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            mod.reset_running_stats()
            mod.momentum = None  # cumulative average: one batch = its stats
    model.train()
    with torch.no_grad():
        model(inp)
    model.eval()


def serving_requests(torch, device, num_requests=3, bs=32, depth=34,
                     inp_res=256, out_res=64, rot_filters=256,
                     trans_filters=256, trans_hidden=4096, seed=0):
    """Answer ``num_requests`` requests of ``bs`` crops with a CDPN on
    seeded random weights; returns (latencies in s, poses per request,
    K1 launches per request, the share of crops whose pose from the last
    request's model outputs matches the CPU twin path's)."""
    from epropnp_tpu_torch.models.cdpn import CDPN
    from epropnp_tpu_torch.ops.pnp import lm_kernel
    from epropnp_tpu_torch.sixdof import test as test_lib
    from epropnp_tpu_torch.sixdof.config import (
        DataIterConfig, PnPConfig, SixDoFConfig)
    from epropnp_tpu_torch.sixdof.train import Batch

    torch.manual_seed(seed)
    feat = inp_res // 32
    model = CDPN(depth, rot_filters, trans_filters, trans_hidden,
                 feat_hw=(feat, feat)).to(device).eval()
    cfg = SixDoFConfig(dataiter=DataIterConfig(inp_res=inp_res,
                                               out_res=out_res),
                       pnp=PnPConfig(use_pallas=True))
    cam = torch.tensor(LINEMOD_K, device=device)
    r = np.random.default_rng(seed)
    calibrate_batchnorm(torch, model, torch.tensor(
        r.normal(size=(bs, inp_res, inp_res, 3)), dtype=torch.float32,
        device=device))
    lat, poses, k1_launches = [], [], []

    def request(batch, box, gen):
        with torch.no_grad():
            outs = model(batch.inp)
            return test_lib.infer_poses(outs, batch, t(box), cam, cfg,
                                        init='rslm', rng=gen)

    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731,E501
    for req in range(num_requests + 1):  # request 0 warms up
        box = r.uniform(60, 140, (bs, 2))
        s_box = box.max(-1) * 1.5
        zeros = torch.zeros((bs, out_res, out_res, 3), device=device)
        batch = Batch(
            inp=t(r.normal(size=(bs, inp_res, inp_res, 3))),
            target_coor=zeros, loss_msk=zeros,
            trans_local=torch.zeros((bs, 3), device=device),
            pose=torch.zeros((bs, 3, 4), device=device),
            c_box=t(r.uniform([200, 150], [450, 330], (bs, 2))),
            s_box=t(s_box), dim=t(r.uniform(0.03, 0.1, (bs, 3))))
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + req)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        k1_before = lm_kernel.launches
        t0 = time.perf_counter()
        res = request(batch, box, gen)
        pose = res.pose_est.cpu().numpy()  # waits for the device
        if req:
            lat.append(time.perf_counter() - t0)
            poses.append((pose, res.pose_est_trans.cpu().numpy()))
            k1_launches.append(lm_kernel.launches - k1_before)
    if device.type == 'cuda':
        profile_once(torch, lambda: request(batch, box, gen), 'serving')
    return lat, poses, k1_launches, twin_path_agreement(
        torch, model, batch, box, cam, cfg)


def twin_path_agreement(torch, model, batch, box, cam, cfg, seed=123):
    """``infer_poses`` on the card (kernels) against the same call on CPU
    copies of the model outputs (kernel twins), with the same random draws
    (a CPU generator feeds both). Returns the share of crops whose [R|t]
    agree within 1e-3 * (|ref| + 1): the proposals' argmin may flip on a
    near-tie of costs summed in another order."""
    from epropnp_tpu_torch.sixdof import test as test_lib
    with torch.no_grad():
        outs = model(batch.inp)
        res = []
        for dev in (cam.device, torch.device('cpu')):
            to = lambda x: x.to(dev)  # noqa: E731
            res.append(test_lib.infer_poses(
                type(outs)(*map(to, outs)), type(batch)(*map(to, batch)),
                torch.tensor(box, dtype=torch.float32, device=dev), to(cam),
                cfg, init='rslm', rng=torch.Generator().manual_seed(seed)
            ).pose_est.cpu().numpy())
    return float(agree(res[0], res[1], 1e-3, 1.0).mean())


def phase_c(torch, device):
    lat, poses, k1_launches, twin_agree = serving_requests(torch, device)
    print(f'phase c: share of the 32 crops whose pose from the kernel path '
          f'matches the CPU twin path: {twin_agree:.4f}')
    assert twin_agree >= 0.9, 'serving: kernel path disagrees with twins'
    for i, (lat_s, (pose, pose_t), k1) in enumerate(zip(lat, poses,
                                                         k1_launches)):
        rot = pose[:, :, :3]
        orth = np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max()
        print(f'phase c: request {i}: 32 crops, latency {lat_s * 1e3:.3f} ms,'
              f' K1 launches {k1}, finite={bool(np.isfinite(pose).all())}, '
              f'max|RR^T-I|={orth:.2e}')
        assert k1 == 2, 'serving: K1 not launched for proposals and refine'
        assert pose.shape == (32, 3, 4) and pose_t.shape == (32, 3, 4)
        assert np.isfinite(pose).all() and np.isfinite(pose_t).all(), \
            'non-finite pose'
        assert orth < 1e-4, 'rotation not orthonormal'
    return lat


def bench_twin_solve(torch, x3d, x2d, w2d, cam, cost_fun, seeds, solver):
    """The bench solve of ``LMSolver`` written out with the kernels' torch
    twins (the solver itself always launches the kernels on the card)."""
    from epropnp_tpu_torch.ops.pnp.lm_kernel import (
        camera_to_fxfycxcy, lm_solve_reference)
    from epropnp_tpu_torch.ops.pnp.rslm_kernel import rslm_init_reference
    rs = solver.init_solver
    cam4 = camera_to_fxfycxcy(cam).contiguous()
    delta = cost_fun.delta.contiguous()
    params = solver._lm_params()
    pose0, _ = rslm_init_reference(
        x3d, x2d, w2d, cam4, delta, seeds, dof=6, num_points=rs.num_points,
        num_proposals=rs.num_proposals, num_iter=rs.num_iter, z_min=0.1,
        score_points=rs.score_points, **params)
    return lm_solve_reference(x3d, x2d, w2d, cam4, delta, pose0, dof=6,
                              num_iter=solver.num_iter, z_min=0.1, **params)


def phase_d(torch, device):
    import bench
    from epropnp_tpu_torch.ops.pnp import (
        AdaptiveHuberPnPCost, LMSolver, PerspectiveCamera, RSLMSolver,
        evaluate_pnp)
    x3d, x2d, w2d, cam, pose_gt = (
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in bench.make_problem())
    b = x3d.shape[0]
    solver = LMSolver(
        dof=6, num_iter=bench.LM_ITER, use_pallas=True,
        init_solver=RSLMSolver(dof=6, num_points=bench.RS_POINTS,
                               num_proposals=bench.RS_PROPOSALS,
                               num_iter=bench.RS_ITER, use_pallas=True,
                               fast_sampling=True))
    camera = PerspectiveCamera(cam_mats=cam)
    cost_fun = AdaptiveHuberPnPCost(relative_delta=0.1).set_param(x2d, w2d)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def run_kernel():
        pose, _, cost, _ = solver(x3d, x2d, w2d, camera, cost_fun, rng=gen,
                                  with_cost=True)
        return pose, cost

    seeds = torch.randint(0, 2 ** 31 - 1, (b,), dtype=torch.int32,
                          device=device)

    def run_twin():
        return bench_twin_solve(torch, x3d, x2d, w2d, cam, cost_fun, seeds,
                                solver)

    pose, cost = run_kernel()
    pose_t, cost_t = run_twin()
    gt_cost = evaluate_pnp(x3d, x2d, w2d, pose_gt, camera, cost_fun,
                           out_cost=True).cost
    c, ct, cg = (t.cpu().numpy() for t in (cost, cost_t, gt_cost))
    assert np.isfinite(c).all() and np.isfinite(pose.cpu().numpy()).all(), \
        'bench: non-finite pose or cost'
    at_gt = float((c <= cg * 1.01).mean())
    ms_k = time_ms(torch, run_kernel, warmup=2, iters=10)
    profile_once(torch, run_kernel, 'bench')
    ms_t = time_ms(torch, run_twin, warmup=1, iters=3)
    print('phase d: bench ' + json.dumps(dict(
        B=b, N=x3d.shape[1], median_cost=float(np.median(c)),
        twin_median_cost=float(np.median(ct)),
        gt_pose_median_cost=float(np.median(cg)),
        frac_cost_le_gt_1pct=at_gt,
        kernel_solves_per_s=b / (ms_k / 1e3),
        twin_solves_per_s=b / (ms_t / 1e3), kernel_ms=ms_k, twin_ms=ms_t)))
    assert at_gt >= 0.95, 'bench: fewer than 95% of solves reach the GT cost'
    assert np.isfinite(ct).all()


def dcn_problem(torch, device, n, h, w, c, cout, stride, seed):
    """A DeformConv layer's inputs at one path shape: x (n, h, w, c), the
    raw conv_offset output of seeded non-zero offset weights (offsets of a
    few pixels, some samples off the map) and a weight (cout, c, 3, 3)."""
    from epropnp_tpu_torch.ops.deform_conv import DeformConv, conv_nhwc
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=gen, device=device)
    mod = DeformConv(c, cout, stride, bias=False).to(device)
    with torch.no_grad():
        mod.conv_offset.weight.normal_(0, 1.5 / (9 * c) ** 0.5, generator=gen)
        mod.weight.normal_(0, (2 / (9 * c)) ** 0.5, generator=gen)
        om = conv_nhwc(mod.conv_offset, x).contiguous()
    return x, om, mod.weight.detach()


def phase_e(torch, device):
    """K3 against its twin at the Det serving shapes (672x1600 x 6)."""
    from epropnp_tpu_torch.ops import dcn_kernel as k3
    shapes = [  # (n, h, w, c, cout, stride, what)
        (6, 42, 100, 256, 256, 1, 'backbone stage 3 (x22 per request)'),
        (6, 84, 200, 256, 256, 2, 'backbone stage 3 first block'),
        (6, 21, 50, 512, 512, 1, 'backbone stage 4 (x2 per request)'),
        (6, 84, 200, 256, 256, 1, 'FCOS towers, level 0 (x2 per request)'),
    ]
    rows = []
    for i, (n, h, w, c, cout, stride, what) in enumerate(shapes):
        x, om, weight = dcn_problem(torch, device, n, h, w, c, cout, stride,
                                    40 + i)
        w3 = k3.kernel_weight(weight)
        with torch.no_grad():
            run_k = lambda: k3.dcn_forward_cuda(x, om, w3, None, stride)  # noqa: E731,E501
            run_t = lambda: k3.dcn_reference(x, om, weight, None, stride)  # noqa: E731,E501
            out_k, out_t = run_k(), run_t()
            out_64 = k3.dcn_reference(x.double(), om.double(),
                                      weight.double(), None, stride)
            torch.cuda.synchronize()
            ho, wo = out_k.shape[1:3]
            # samples off the map: share of (position, tap) with a corner
            # outside (the offsets are the raw conv_offset output)
            rows_, w4 = k3.corner_rows_and_weights(om, h, w, stride, 2.0)
            off_map = float(((w4 == 0).any(-1)).float().mean())
            err = float((out_k - out_t).abs().max())
            scale = float(out_t.abs().max())
            err64_k = float((out_k.double() - out_64).abs().max())
            err64_t = float((out_t.double() - out_64).abs().max())
            ms = time_ms(torch, run_k, warmup=2, iters=10)
            plain_ms = time_ms(torch, run_t, warmup=1, iters=3)
            # yardstick of the contraction part only: one product of the
            # pre-sampled (L, 9c) stack (not a port of the kernel)
            sampled = sum(x.reshape(-1, c)[rows_[..., k]] * w4[..., k, None]
                          for k in range(4)).reshape(-1, 9 * c)
            w_flat = w3.reshape(9 * c, cout)
            mm_ms = time_ms(torch, lambda: torch.matmul(sampled, w_flat),
                            warmup=2, iters=10)
            del sampled, rows_, w4
        length = n * ho * wo
        flops = 2 * length * 9 * c * cout + 8 * length * 9 * c
        nbytes = 4 * (n * h * w * c + length * 27 + 9 * c * cout
                      + length * cout)
        bound, by = bound_ms(flops, nbytes)
        row = dict(shape=[n, h, w, c, cout], stride=stride, what=what,
                   L=length, gflop=flops / 1e9, off_map_share=off_map,
                   max_abs_err=err, max_abs_twin=scale,
                   f64_err_kernel=err64_k, f64_err_twin=err64_t, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   matmul_of_sampled_stack_ms=mm_ms,
                   tflops=flops / ms / 1e9)
        print('phase e: K3 ' + json.dumps(row))
        assert err <= K3_REL * scale, f'K3 disagrees with its twin: {what}'
        assert off_map > 0, 'no sample fell off the map'
        rows.append(row)
    main = rows[0]
    return dict(name='dcn_forward (K3)', route='cuda',
                source='epropnp_tpu_torch/csrc/dcn_kernel.cu',
                replaces='epropnp_tpu/ops/pallas_dcn.py:102',
                max_abs_err=max(r['max_abs_err'] for r in rows),
                ms=main['ms'], plain_ms=main['plain_ms'],
                bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                library_ms=None)


def det_pnp_problem(torch, device, b, n, seed):
    """A 4DoF problem seen by a camera at 1600x672: nuScenes-like focal
    length, principal points shifted per object so that part of the
    objects reach past the image-shape bounds and are clamped."""
    from epropnp_tpu_torch.ops.pnp import PerspectiveCamera
    from epropnp_tpu_torch.ops.pnp.lm_kernel import camera_to_fxfycxcy
    from epropnp_tpu_torch.utils.synthetic import make_pnp_problem
    p = make_pnp_problem(b, n, seed, dof=4, init_noise=(0.05, 0.1),
                         focal=(1266.4, 1266.4), depth=(4.0, 20.0))
    shift = np.random.default_rng(seed + 1).uniform(
        [-150.0, -150.0], [1750.0, 820.0], (b, 2))
    p['x2d'] = p['x2d'] + shift[:, None]
    p['cams'][:, :2, 2] += shift
    t = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in p.items()}
    cam = PerspectiveCamera.from_img_shape(
        t['cams'], torch.tensor([672.0, 1600.0], device=device).expand(b, 2),
        allowed_border=200.0)
    bounds = torch.cat([torch.full((b, 2), cam.lb, device=device), cam.ub],
                       -1).contiguous()
    return (t['x3d'], t['x2d'], t['w2d'],
            camera_to_fxfycxcy(t['cams']).contiguous(), bounds, t['pose0'])


def phase_f(torch, device):
    """K1 at dof 4 with bounds in fast mode against its twin."""
    from epropnp_tpu_torch.ops.pnp import lm_kernel as k1
    rows = []
    for b, n, iters, what in ((98304, 16, 3, 'Det RSLM proposals'),
                              (1536, 128, 5, 'Det refine')):
        x3d, x2d, w2d, cam, bounds, pose0 = det_pnp_problem(
            torch, device, b, n, 60 + n)
        delta = torch.full((b,), 10.0 / n, device=device)
        kw = dict(bounds=bounds, dof=4, num_iter=iters, fast_mode=True,
                  z_min=0.1)
        run_k = lambda: k1.lm_solve_cuda(x3d, x2d, w2d, cam, delta, pose0, **kw)  # noqa: E731,E501
        run_t = lambda: k1.lm_solve_reference(x3d, x2d, w2d, cam, delta, pose0, **kw)  # noqa: E731,E501
        pk, ck = run_k()
        pt, ct = run_t()
        f64 = [a.double() for a in (x3d, x2d, w2d, cam, delta, pose0)]
        kw64 = dict(kw, bounds=bounds.double())
        p64, c64 = k1.lm_solve_reference(*f64, **kw64)
        torch.cuda.synchronize()
        pk, ck, pt, ct, p64, c64 = (a.cpu().numpy()
                                    for a in (pk, ck, pt, ct, p64, c64))
        proj = x2d.cpu().numpy()
        lo, hi = bounds[:, None, :2].cpu().numpy(), bounds[:, None, 2:].cpu(
            ).numpy()
        clamped = float(((proj < lo) | (proj > hi)).any(-1).any(-1).mean())
        finite = np.isfinite(ct)
        frac_c = agree(ck, ct, K1_RTOL, 0.0).mean()
        frac_p = agree(pk, pt, K1_RTOL, 1e-2).mean()
        spread_c = agree(ct, c64, K1_RTOL, 0.0).mean()
        spread_p = agree(pt, p64, K1_RTOL, 1e-2).mean()
        ms = time_ms(torch, run_k, iters=20)
        plain_ms = time_ms(torch, run_t, iters=5)
        bound, by = k1_bound(b, n, 4, iters)
        row = dict(B=b, N=n, num_iter=iters, what=what,
                   objects_past_bounds=clamped,
                   twin_finite=float(finite.mean()),
                   cost_agree=float(frac_c), pose_agree=float(frac_p),
                   twin_f32_vs_f64_cost_agree=float(spread_c),
                   twin_f32_vs_f64_pose_agree=float(spread_p),
                   max_abs_cost_err=float(np.nanmax(np.abs(ck - ct))),
                   ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        # the kernel against the f64 twin, beside the f32 twin against it:
        # where the problem itself amplifies f32 rounding (objects whose
        # clamped points keep their Jacobian rows in fast mode), the f32
        # twin misses the f64 answer as often as the kernel does
        row['kernel_vs_f64_cost_agree'] = float(agree(ck, c64, K1_RTOL,
                                                      0.0).mean())
        row['finiteness_differs'] = float(
            (np.isfinite(pk).all(-1) != np.isfinite(pt).all(-1)).mean())
        print('phase f: K1 dof 4 + bounds ' + json.dumps(row))
        assert row['finiteness_differs'] <= 1 - K1_MIN_FRAC, \
            'K1 non-finite where its twin is finite'
        assert (frac_c >= K1_MIN_FRAC and frac_p >= K1_MIN_FRAC) or (
            row['kernel_vs_f64_cost_agree'] >= spread_c - 0.005), \
            f'K1 dof 4 disagrees with its twin at {(b, n)}'
        rows.append(row)
    return rows


def det_frames(seed, num=6, h=900, w=1600):
    """``num`` random camera frames (h, w, 3) in [0, 255] and their
    intrinsics (one nuScenes sample's six cameras, at random)."""
    r = np.random.default_rng(seed)
    imgs = [r.uniform(0, 255, (h, w, 3)).astype(np.float32)
            for _ in range(num)]
    return imgs, [np.array(NUSCENES_K) for _ in range(num)]


def build_det_model(torch, device, seed, img_hw=(672, 1600)):
    """v1b with K1 on the path, seeded random weights, non-zero DCN offset
    weights, BatchNorm statistics calibrated on one seeded batch of 6."""
    import dataclasses
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.det.config import DetConfig
    from epropnp_tpu_torch.ops.deform_conv import DeformConv
    cfg = DetConfig.v1b()
    cfg = dataclasses.replace(cfg, pnp=dataclasses.replace(cfg.pnp,
                                                           use_pallas=True))
    torch.manual_seed(seed)
    model = api.init_detector(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DeformConv):
                c = mod.conv_offset.in_channels
                mod.conv_offset.weight.normal_(0, 0.5 / (9 * c) ** 0.5,
                                               generator=gen)
    inp = torch.randn((6,) + tuple(img_hw) + (3,), generator=gen,
                      device=device)
    calibrate_batchnorm(torch, model.backbone, inp)
    # scale every bottleneck's residual branch (its last BatchNorm) by
    # RESIDUAL_SCALE: at scale 1 this random ResNet-101 is chaotic, and
    # f32 rounding alone moves the head's outputs by O(1) (CPU f32 against
    # f64); at 0.3 they stay within ~1e-5, so card and CPU can be compared
    with torch.no_grad():
        for mod in model.backbone.modules():
            if hasattr(mod, 'bn3'):
                mod.bn3.weight.mul_(RESIDUAL_SCALE)
    return cfg, model


def phase_g(torch, device, num_requests=3):
    """Det serving: 3 requests of 6 frames, each through K3 36 times and
    K1 twice; then a 320x800 image on the card against the CPU twins."""
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.det import test as dtest
    from epropnp_tpu_torch.ops import dcn_kernel
    from epropnp_tpu_torch.ops.pnp import lm_kernel
    t0 = time.perf_counter()
    cfg, model = build_det_model(torch, device, seed=0)
    torch.cuda.synchronize()
    print(f'phase g: model built and calibrated in '
          f'{time.perf_counter() - t0:.1f} s')
    time_dense_conv(torch, model)
    infer = dtest.make_inference_fn(model, cfg, min_fcos_score=0.0)
    lat = []
    for req in range(num_requests + 1):  # request 0 warms up
        imgs, ks = det_frames(100 + req)
        gen = torch.Generator().manual_seed(req)
        torch.cuda.synchronize()
        k3_0, k1_0 = dcn_kernel.launches, lm_kernel.launches
        t0 = time.perf_counter()
        _, out3d = api.inference_detector(model, cfg, imgs, ks,
                                          infer_fn=infer, rng=gen)
        dt = time.perf_counter() - t0
        k3, k1 = dcn_kernel.launches - k3_0, lm_kernel.launches - k1_0
        live = np.concatenate([a for im in out3d for a in im], 0)
        print(f'phase g: request {req}{" (warm-up)" if not req else ""}: 6 '
              f'frames, latency {dt * 1e3:.3f} ms, K3 launches {k3}, K1 '
              f'launches {k1}, live objects {len(live)}, '
              f'finite={bool(np.isfinite(live).all())}')
        assert k3 == 36, 'Det request: K3 not launched 36 times'
        assert k1 == 2, 'Det request: K1 not launched for proposals + refine'
        assert np.isfinite(live).all(), 'non-finite live box'
        if req:
            lat.append(dt)
    print('phase g: latency per 6-frame request (ms): '
          + json.dumps([round(v * 1e3, 3) for v in lat]))
    time_host_pipeline(imgs, ks)
    kernels = profile_once(torch, lambda: api.inference_detector(
        model, cfg, imgs, ks, infer_fn=infer,
        rng=torch.Generator().manual_seed(0)), 'det serving', top=12)
    if kernels:
        total = sum(k[1] for k in kernels)
        share = lambda *keys: sum(  # noqa: E731
            k[1] for k in kernels if any(s in k[0].lower() for s in keys))
        k3_ms = share('dcn_forward')
        conv_ms = share('cudnn', 'conv', 'fprop', 'implicit_gemm')
        pnp_ms = share('lm_solve')
        print('phase g: device time by kind: ' + json.dumps(dict(
            total_ms=total, k3_ms=k3_ms, cudnn_conv_ms=conv_ms,
            k1_ms=pnp_ms, k3_share=k3_ms / total,
            cudnn_conv_share=conv_ms / total, k1_share=pnp_ms / total)))
    rel, rel64, pose_close, pose_agree = reduced_size_agreement(
        torch, model, cfg)
    print(f'phase g: 320x800 card vs CPU twins: dense max rel err {rel:.3e}'
          f' (rule {DET_DENSE_REL:g}; CPU f32 vs f64 {rel64:.3e}), poses '
          f'within 1e-3 {pose_close:.4f}, or of equal cost {pose_agree:.4f}')
    assert rel <= DET_DENSE_REL, 'dense outputs: card and CPU disagree'
    assert pose_agree >= 0.99, 'poses: card and CPU twins disagree'
    return lat


def time_host_pipeline(imgs, ks):
    """The host part of a request alone: the numpy pipeline of its 6
    frames (crop, dense x2d maps, normalisation) and the stacking."""
    from epropnp_tpu_torch.det.pipelines import (
        REFERENCE_CROP_BOX, default_pipeline)
    t0 = time.perf_counter()
    samples = [default_pipeline(dict(img=img, cam_intrinsic=k),
                                crop_box=REFERENCE_CROP_BOX)
               for img, k in zip(imgs, ks)]
    t1 = time.perf_counter()
    for key in ('img', 'img_dense_x2d', 'img_dense_x2d_mask'):
        np.stack([s[key] for s in samples])
    t2 = time.perf_counter()
    print(f'phase g: host pipeline of 6 frames {(t1 - t0) * 1e3:.3f} ms, '
          f'stacking {(t2 - t1) * 1e3:.3f} ms')


def time_dense_conv(torch, model):
    """The head's dense-stage 3x3 conv 256 -> 128 at stride 8 (6 x 84 x
    200) as served (channels-last, cuDNN's exhaustive algorithm search)
    and with cuDNN's default heuristics, which pick FFT tiling there
    (NCHW tensors: a separate entry in PyTorch's algorithm cache)."""
    import torch.nn.functional as F
    conv = model.bbox_head.convs[1].conv
    x = torch.randn((6, conv.in_channels, 84, 200),
                    device=next(model.parameters()).device)
    x_cl = x.to(memory_format=torch.channels_last)
    w = conv.weight.detach().contiguous()
    with torch.no_grad():
        served = time_ms(torch, lambda: conv(x_cl), warmup=1, iters=3)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            heur = time_ms(torch, lambda: F.conv2d(x, w, padding=1),
                           warmup=1, iters=2)
    print(f'phase g: dense conv {conv.in_channels}->{conv.out_channels} at '
          f'6x84x200: {served:.3f} ms as served (exhaustive search), '
          f'{heur:.3f} ms with cuDNN default heuristics')


def reduced_size_agreement(torch, model, cfg, seed=7):
    """One 320x800 image: the dense stage on the card (K3) against a CPU
    copy of the model (K3's twin), then everything after it (subheads,
    RSLM + K1 or its twin, NMS) from the card's dense outputs on both
    devices, with one CPU generator feeding both the same draws.

    Returns (max over dense outputs of max|card - cpu| / max|cpu|, the
    same for the CPU f32 outputs against f64, the share of the objects
    whose 4DoF pose agrees within 1e-3 * (|ref| + 1), and the share that
    agrees or whose two poses cost the same within 1e-4 on the CPU's
    problem: a far object's flat cost valley, where f32 rounding picks
    another point of equal cost)."""
    import copy
    from epropnp_tpu_torch.det import test as dtest
    from epropnp_tpu_torch.det.pipelines import default_pipeline
    from epropnp_tpu_torch.ops.pnp import evaluate_pnp
    device = next(model.parameters()).device
    imgs, ks = det_frames(seed, num=1, h=320, w=800)
    s = default_pipeline(dict(img=imgs[0], cam_intrinsic=ks[0]))
    model_cpu = copy.deepcopy(model).cpu()
    rel = 0.0
    poses = []
    for first, dev, m in ((True, device, model),
                          (False, torch.device('cpu'), model_cpu)):
        t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(a)[None], dtype=dt).to(dev)
        infer = dtest.make_inference_fn(m, cfg, min_fcos_score=0.0)
        dense = infer.dense(t(s['img']))
        if first:
            dense_card = dense
        else:
            flat_cpu = [a for o in dense[0] for a in o] + list(dense[1:])
            flat_card = [a for o in dense_card[0] for a in o] + list(
                dense_card[1:])
            rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                      for a, b in zip(flat_card, flat_cpu))
        moved = ([type(o)(*(a.to(dev) for a in o)) for o in dense_card[0]],
                 dense_card[1].to(dev), dense_card[2].to(dev))
        args = (moved, t(ks[0]), t(s['img_shape']), t(s['ori_shape']),
                t(s['flip'], torch.bool), t(s['img_dense_x2d']),
                t(s['img_dense_x2d_mask']))
        res = infer.post(*args, rng=torch.Generator().manual_seed(seed))
        poses.append(res.bbox_3d[:, 3:].cpu())
    x3d, x2d, w2d, camera, cost_fun = infer.pnp_problem(*args)[2:]
    with torch.no_grad():
        costs = [evaluate_pnp(x3d, x2d, w2d, p, camera, cost_fun,
                              out_cost=True).cost.numpy() for p in poses]
        img64 = torch.as_tensor(s['img'][None], dtype=torch.float64)
        dense64 = dtest.make_inference_fn(model_cpu.double(), cfg).dense(
            img64)
    poses = [p.numpy() for p in poses]
    same_nan = (np.isnan(poses[0]) == np.isnan(poses[1])).all(-1)
    close = agree(np.nan_to_num(poses[0]), np.nan_to_num(poses[1]), 1e-3,
                  1.0) & same_nan
    flat = agree(costs[0], costs[1], 1e-4, 0.0)
    flat64 = [a for o in dense64[0] for a in o] + list(dense64[1:])
    rel64 = max(float((a.double() - b).abs().max() / b.abs().max())
                for a, b in zip(flat_cpu, flat64))
    return rel, rel64, float(close.mean()), float((close | flat).mean())

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; nothing run',
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's exhaustive algorithm search for every convolution, set before
    # the first one (PyTorch caches the algorithm per shape): the default
    # f32 heuristics run several Det convs as FFT tiling (phase g)
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.benchmark_limit = 0
    device = torch.device('cuda', 0)

    from epropnp_tpu_torch import kernels
    from epropnp_tpu_torch.ops import dcn_kernel
    from epropnp_tpu_torch.ops.pnp import lm_kernel, rslm_kernel
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.load_library()
    print(f'build: {os.path.relpath(lib_path, REPO)} in '
          f'{time.perf_counter() - t0:.1f} s')
    with open(lib_path + '.log') as f:
        for line in f:
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print('ptxas: ' + line.strip())
    print(gpu_name_and_limit())

    failed, entries = [], {}
    # the kernels against their twins (phases a, b: K1, K2; e: K3; f: K1
    # in the Det mode); these launches are not the main path's
    for name, phase in (('a', phase_a), ('b', phase_b), ('e', phase_e),
                        ('f', phase_f)):
        try:
            entries[name] = phase(torch, device)
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failed.append(name)

    # the main path: counters from 0, read right after phases c, d and g
    lm_kernel.launches = 0
    rslm_kernel.launches = 0
    dcn_kernel.launches = 0
    for name, phase in (('c', phase_c), ('d', phase_d), ('g', phase_g)):
        try:
            phase(torch, device)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            failed.append(name)
    torch.cuda.synchronize()
    counts = {'a': lm_kernel.launches, 'b': rslm_kernel.launches,
              'e': dcn_kernel.launches}
    print(f'launches on the main path: lm_solve (K1) {counts["a"]}, '
          f'rslm_init (K2) {counts["b"]}, dcn_forward (K3) {counts["e"]}')
    for key in counts:  # phase a checks K1, phase b K2, phase e K3
        if counts[key] == 0:
            failed.append(f'{key}: kernel not launched on the main path')
        if key in entries:
            entries[key]['launches'] = counts[key]

    rows = [entries[k] for k in ('a', 'b', 'e') if k in entries]
    if rows:
        print(json.dumps({'kernels': rows}))
    if failed:
        print(f'chip_smoke: FAILED phases {failed}', file=sys.stderr)
        return 1
    # the run uses one card, whatever the host exposes
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': 1}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
