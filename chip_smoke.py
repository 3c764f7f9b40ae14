"""Smoke run of the PyTorch/CUDA port (``epropnp_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card (an H100: the kernels are built for ``sm_90a``).

It builds the two hand-written PnP kernels from ``epropnp_tpu_torch/csrc``
with ``nvcc`` and runs four phases; any failure exits non-zero:

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

Every launch counter is set to 0 before phases c and d (the main path)
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
        return
    print(f'profile {label}: wall {wall * 1e3:.3f} ms, device busy '
          f'{busy_us / 1e3:.3f} ms ({len(kernels)} kernel names)')
    for e in kernels[:top]:
        print(f'profile {label}:   {dev(e) / 1e3:9.3f} ms  x{e.count:<5d} '
              f'{e.key[:90]}')


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
                   max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print('phase a: K1 ' + json.dumps(row))
        assert frac_c >= K1_MIN_FRAC and frac_p >= K1_MIN_FRAC, \
            f'K1 disagrees with its twin at {(b, n, fast)}'
        rows.append(row)
    main = rows[-1]
    return dict(name='lm_solve (K1)', route='cuda',
                source='epropnp_tpu_torch/csrc/lm_kernel.cu',
                replaces='epropnp_tpu/ops/pnp/pallas_lm.py:308',
                max_abs_err=max_err, ms=main['ms'], plain_ms=main['plain_ms'])


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
    return dict(name='rslm_init (K2)', route='cuda',
                source='epropnp_tpu_torch/csrc/rslm_kernel.cu',
                replaces='epropnp_tpu/ops/pnp/pallas_rslm.py:713',
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; nothing run',
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda', 0)

    from epropnp_tpu_torch import kernels
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
    for name, phase in (('a', phase_a), ('b', phase_b)):
        try:
            entries[name] = phase(torch, device)
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failed.append(name)

    # the main path: counters from 0, read right after phases c and d
    lm_kernel.launches = 0
    rslm_kernel.launches = 0
    for name, phase in (('c', phase_c), ('d', phase_d)):
        try:
            phase(torch, device)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            failed.append(name)
    torch.cuda.synchronize()
    counts = {'a': lm_kernel.launches, 'b': rslm_kernel.launches}
    print(f'launches on the main path: lm_solve (K1) {counts["a"]}, '
          f'rslm_init (K2) {counts["b"]}')
    for key in counts:  # phase a checks K1, phase b K2
        if counts[key] == 0:
            failed.append(f'{key}: kernel not launched on the main path')
        if key in entries:
            entries[key]['launches'] = counts[key]

    if entries:
        print(json.dumps({'kernels': [entries[k] for k in ('a', 'b')
                                      if k in entries]}))
    if failed:
        print(f'chip_smoke: FAILED phases {failed}', file=sys.stderr)
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
