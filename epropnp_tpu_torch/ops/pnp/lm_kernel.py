"""K1: the fused batched LM / Gauss-Newton PnP solve, and its plain twin.

``lm_solve`` is what the solver calls. On a CUDA tensor it launches the
hand-written kernel of ``csrc/lm_kernel.cu`` (a group of
:func:`group_size` threads per object) or raises; on a CPU tensor it runs
:func:`lm_solve_reference`, the same function written with torch ops.
The twin follows the arithmetic of the kernel term by term (``_evaluate``
below mirrors ``pnp_common.cuh``), so the two differ only in summation
order and the kernel's fused multiply-adds.

Scope: zero-skew pinhole cameras given as (B, 4) ``[fx, fy, cx, cy]`` and
per-object Huber deltas. Both the kernel and the twin run fast mode and
the trust region at dof 4 and 6, with or without projection bounds (B, 4)
``[lb_u, lb_v, ub_u, ub_v]``, with or without the final JtJ
(``with_jtj``) that forms the pose covariance: every mode of the Pallas
kernel that a caller reaches (its ``cost_only`` has no caller).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# Launches of the CUDA kernel, counted by :func:`lm_solve_cuda` alone:
# ``launches`` in the serving modes (fast mode; the trust region at dof 6
# without bounds or JtJ), ``launches_train`` in the modes that only the
# training paths run (the trust region with bounds or at dof 4, and any
# launch with the JtJ output).
launches = 0
launches_train = 0

# K1's launch shape (csrc/lm_kernel.cu): the most threads that share one
# object, and the resident threads below which the picker spreads an
# object over more threads (1024 warps, about 8 an SM of an H100's 132).
MAX_GROUP = 512
TARGET_THREADS = 1024 * 32


def group_size(b: int, n: int) -> int:
    """Threads that share one object in the K1 kernel, a power of two.

    Up to a warp, at most 4 points a thread; past a warp (a block whose
    first warp runs the solver's tail behind two barriers an evaluation),
    at most 8 points a thread, up to ``MAX_GROUP`` threads. Then, while
    ``b`` groups leave the card short of ``TARGET_THREADS``, twice as many
    threads: up to a warp while every thread keeps a point (a latency-bound
    solve gains from the warp's short reduce-scatter), past that while
    every thread keeps 2 points. (H100 device times of the main shapes over
    the group sizes: PERF.md.)
    """
    g = 1
    while g < 32 and 4 * g < n:
        g *= 2
    while g < MAX_GROUP and 8 * g < n:
        g *= 2
    while (g < MAX_GROUP and b * g < TARGET_THREADS
           and ((g <= n and 2 * g <= 32) or 4 * g <= n)):
        g *= 2
    return g


def camera_to_fxfycxcy(cam_mats: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) zero-skew intrinsics -> (B, 4) [fx, fy, cx, cy]."""
    return torch.stack([cam_mats[..., 0, 0], cam_mats[..., 1, 1],
                        cam_mats[..., 0, 2], cam_mats[..., 1, 2]], -1)


def _tri(dof):
    return [(a, b) for a in range(dof) for b in range(a + 1)]


def _evaluate(pose, pts, cam, delta, dof, z_min, bounds=None,
              clip_jac=True, need_jac=True):
    """Cost (B, 1) and, with ``need_jac``, the JtJ lower triangle and the
    gradient as lists of (B, 1) columns.

    ``pose``: list of (B, 1) columns; ``pts``: (x, y, z, u, v, wu, wv),
    each (B, n); ``cam``: (fx, fy, cx, cy), each (B, 1).
    """
    x, y, z, u_t, v_t, wu, wv = pts
    fx, fy, cx, cy = cam
    if dof == 4:
        tx, ty, tz, yaw = pose
        c, s = torch.cos(yaw), torch.sin(yaw)
        xr = c * x + s * z
        yr = y
        zr = -s * x + c * z
    else:
        tx, ty, tz, qw, qi, qj, qk = pose
        qn = torch.rsqrt(qw * qw + qi * qi + qj * qj + qk * qk + 1e-24)
        w, i, j, k = qw * qn, qi * qn, qj * qn, qk * qn
        xr = (1 - 2 * (j * j + k * k)) * x + 2 * (i * j - k * w) * y \
            + 2 * (i * k + j * w) * z
        yr = 2 * (i * j + k * w) * x + (1 - 2 * (i * i + k * k)) * y \
            + 2 * (j * k - i * w) * z
        zr = 2 * (i * k - j * w) * x + 2 * (j * k + i * w) * y \
            + (1 - 2 * (i * i + j * j)) * z
    xc, yc, zc_raw = xr + tx, yr + ty, zr + tz
    zc = torch.clamp(zc_raw, min=z_min)
    u = (fx * xc + cx * zc_raw) / zc
    v = (fy * yc + cy * zc_raw) / zc
    if bounds is not None:
        lb_u, lb_v, ub_u, ub_v = bounds
        in_u = ((u > lb_u) & (u < ub_u)).to(u.dtype)
        in_v = ((v > lb_v) & (v < ub_v)).to(v.dtype)
        u = torch.minimum(torch.maximum(u, lb_u), ub_u)
        v = torch.minimum(torch.maximum(v, lb_v), ub_v)

    ru = (u - u_t) * wu
    rv = (v - v_t) * wv
    ss = ru * ru + rv * rv
    s_sqrt = torch.sqrt(torch.clamp(ss, min=1e-24))
    cost = torch.where(s_sqrt <= delta, 0.5 * ss,
                       delta * s_sqrt - 0.5 * delta * delta).sum(1, keepdim=True)
    if not need_jac:
        return cost, None, None
    rho = torch.sqrt(torch.clamp(delta / torch.clamp(s_sqrt, min=1e-10),
                                 max=1.0))
    if clip_jac:
        live = (zc_raw >= z_min).to(u.dtype)
        live_u = live * in_u if bounds is not None else live
        live_v = live * in_v if bounds is not None else live
    else:
        live_u = live_v = 1.0
    du0 = fx / zc * live_u
    du2 = (cx - u) / zc * live_u
    dv1 = fy / zc * live_v
    dv2 = (cy - v) / zc * live_v
    swu = wu * rho
    swv = wv * rho
    zero = torch.zeros_like(ru)
    if dof == 4:
        ju = [du0 * swu, zero, du2 * swu, (du0 * zr - du2 * xr) * swu]
        jv = [zero, dv1 * swv, dv2 * swv, (-dv2 * xr) * swv]
    else:
        w0, w1, w2 = 2 * xr, 2 * yr, 2 * zr
        ju = [du0 * swu, zero, du2 * swu, (-du2 * w1) * swu,
              (-du0 * w2 + du2 * w0) * swu, (du0 * w1) * swu]
        jv = [zero, dv1 * swv, dv2 * swv, (dv1 * w2 - dv2 * w1) * swv,
              (dv2 * w0) * swv, (-dv1 * w0) * swv]
    ru_s = ru * rho
    rv_s = rv * rho
    jtj = [(ju[a] * ju[b] + jv[a] * jv[b]).sum(1, keepdim=True)
           for a, b in _tri(dof)]
    g = [(ju[a] * ru_s + jv[a] * rv_s).sum(1, keepdim=True)
         for a in range(dof)]
    return cost, jtj, g


def _chol_solve(a, g, dof):
    """Solve ``a x = -g``; ``a`` is a lower-triangle list of (B, 1) columns."""
    idx = {t: n for n, t in enumerate(_tri(dof))}
    l = {}
    for i in range(dof):
        for j in range(i + 1):
            s = a[idx[(i, j)]]
            for k in range(j):
                s = s - l[(i, k)] * l[(j, k)]
            l[(i, j)] = torch.sqrt(s) if i == j else s / l[(j, j)]
    y = [None] * dof
    for i in range(dof):
        s = -g[i]
        for k in range(i):
            s = s - l[(i, k)] * y[k]
        y[i] = s / l[(i, i)]
    x = [None] * dof
    for i in reversed(range(dof)):
        s = y[i]
        for k in range(i + 1, dof):
            s = s - l[(k, i)] * x[k]
        x[i] = s / l[(i, i)]
    return x


def _pose_add(pose, step, dof):
    if dof == 4:
        return [p + s for p, s in zip(pose, step)]
    t_new = [pose[i] + step[i] for i in range(3)]
    w, i, j, k = pose[3:]
    d0, d1, d2 = step[3:]
    qw = w + (i * d0 + j * d1 + k * d2)
    qi = i + (-w * d0 - k * d1 + j * d2)
    qj = j + (k * d0 - w * d1 - i * d2)
    qk = k + (-j * d0 + i * d1 - w * d2)
    n = torch.clamp(torch.sqrt(qw * qw + qi * qi + qj * qj + qk * qk),
                    min=1e-12)
    return t_new + [qw / n, qi / n, qj / n, qk / n]


def _lm_trust_region_step(state, ev, dof, eps, min_lm_diagonal,
                          max_lm_diagonal, min_relative_decrease,
                          max_trust_region_radius):
    """One trust-region LM update (pallas_lm.py lm_body); returns the state."""
    pose, cost, jtj, g, radius, decrease = state
    tri = _tri(dof)
    idx = {t: n for n, t in enumerate(tri)}
    damped = list(jtj)
    for a in range(dof):
        d = jtj[idx[(a, a)]]
        damped[idx[(a, a)]] = d + torch.clamp(
            d, min_lm_diagonal, max_lm_diagonal) / radius + eps
    step = _chol_solve(damped, g, dof)
    pose_new = _pose_add(pose, step, dof)
    cost_new, jtj_new, g_new = ev(pose_new)
    mcc = torch.zeros_like(cost)
    for a in range(dof):
        hs = torch.zeros_like(cost)
        for b in range(dof):
            hs = hs + jtj[idx[(a, b) if a >= b else (b, a)]] * step[b]
        mcc = mcc - step[a] * (hs * 0.5 + g[a])
    rel = (cost - cost_new) / mcc
    ok = (rel >= min_relative_decrease) & (mcc > 0)
    sel = lambda n_, o_: torch.where(ok, n_, o_)  # noqa: E731
    pose = [sel(pn, po) for pn, po in zip(pose_new, pose)]
    cost = sel(cost_new, cost)
    jtj = [sel(n_, o_) for n_, o_ in zip(jtj_new, jtj)]
    g = [sel(n_, o_) for n_, o_ in zip(g_new, g)]
    c = 2.0 * rel - 1.0
    r_ok = radius / torch.clamp(1.0 - c * c * c, min=1.0 / 3.0)
    radius = torch.clamp(sel(r_ok, radius), eps, max_trust_region_radius)
    radius = sel(radius, radius / decrease)
    decrease = sel(torch.full_like(decrease, 2.0), decrease * 2.0)
    return pose, cost, jtj, g, radius, decrease


def _split_points(x3d, x2d, w2d):
    return (x3d[..., 0], x3d[..., 1], x3d[..., 2], x2d[..., 0], x2d[..., 1],
            w2d[..., 0], w2d[..., 1])


def _jtj_matrix(tri, dof):
    """Lower triangle (B, dof (dof + 1) / 2), row by row -> symmetric
    (B, dof, dof), in one gather."""
    pos = {t: n for n, t in enumerate(_tri(dof))}
    idx = torch.tensor([pos[(max(a, c), min(a, c))] for a in range(dof)
                        for c in range(dof)], device=tri.device)
    return tri[:, idx].reshape(tri.shape[0], dof, dof)


def lm_solve_reference(x3d, x2d, w2d, cam_fxfycxcy, delta, pose_init,
                       bounds=None, dof: int = 6, num_iter: int = 10,
                       fast_mode: bool = False, z_min: float = 0.1,
                       eps: float = 1e-5, min_lm_diagonal: float = 1e-6,
                       max_lm_diagonal: float = 1e32,
                       min_relative_decrease: float = 1e-3,
                       initial_trust_region_radius: float = 30.0,
                       max_trust_region_radius: float = 1e16,
                       with_jtj: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain torch twin of the K1 kernel (same signature as :func:`lm_solve`).

    Returns ``(pose (B, pose_dim), cost (B,)[, jtj (B, dof, dof)])``.
    In fast mode the cost and JtJ are those at the pose before the last
    update, as in the reference solver.
    """
    pts = _split_points(x3d, x2d, w2d)
    cam = tuple(cam_fxfycxcy[:, i:i + 1] for i in range(4))
    dlt = delta[:, None]
    bnd = None if bounds is None else tuple(
        bounds[:, i:i + 1] for i in range(4))

    def ev(pose):
        return _evaluate(pose, pts, cam, dlt, dof, z_min, bounds=bnd,
                         clip_jac=not fast_mode)

    pose = [pose_init[:, i:i + 1] for i in range(pose_init.shape[1])]
    if fast_mode:
        cost = torch.zeros_like(dlt)
        jtj = [torch.zeros_like(dlt)] * (dof * (dof + 1) // 2)
        diag = {n for n, (a, b) in enumerate(_tri(dof)) if a == b}
        for _ in range(num_iter):
            cost, jtj, g = ev(pose)
            damped = [v + eps if n in diag else v for n, v in enumerate(jtj)]
            pose = _pose_add(pose, _chol_solve(damped, g, dof), dof)
    else:
        cost, jtj, g = ev(pose)
        state = (pose, cost, jtj, g, torch.full_like(cost,
                 initial_trust_region_radius), torch.full_like(cost, 2.0))
        for _ in range(num_iter):
            state = _lm_trust_region_step(
                state, ev, dof, eps, min_lm_diagonal, max_lm_diagonal,
                min_relative_decrease, max_trust_region_radius)
        pose, cost, jtj = state[0], state[1], state[2]
    out = (torch.cat(pose, 1), cost[:, 0])
    if with_jtj:
        out = out + (_jtj_matrix(torch.cat(jtj, 1), dof),)
    return out


def check_kernel_scope(name, dof):
    """Raise on the options the K1 CUDA kernel does not run."""
    if dof not in (4, 6):
        raise NotImplementedError(
            f'{name}: the CUDA kernel runs dof 4 and 6; got dof={dof}')


def is_training_mode(dof, bounds=None, with_jtj=False, fast_mode=True):
    """True for the modes counted in ``launches_train``."""
    return with_jtj or (not fast_mode and (dof != 6 or bounds is not None))


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{name}: expected a tensor, got {type(t).__name__}')
    if t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if t.dtype != torch.float32:
        raise TypeError(f'{name}: dtype {t.dtype}, the kernel takes float32')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected {shape}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: not contiguous')


def lm_solve_cuda(x3d, x2d, w2d, cam_fxfycxcy, delta, pose_init,
                  bounds=None, dof: int = 6, num_iter: int = 10,
                  fast_mode: bool = False, z_min: float = 0.1,
                  eps: float = 1e-5, min_lm_diagonal: float = 1e-6,
                  max_lm_diagonal: float = 1e32,
                  min_relative_decrease: float = 1e-3,
                  initial_trust_region_radius: float = 30.0,
                  max_trust_region_radius: float = 1e16,
                  with_jtj: bool = False) -> Tuple[torch.Tensor, ...]:
    """Launch the K1 kernel on CUDA tensors (f32, contiguous)."""
    global launches, launches_train
    from ...kernels import check_launch, load_library

    check_kernel_scope('lm_solve_cuda', dof)
    b, n, _ = x3d.shape
    device = x3d.device
    if device.type != 'cuda':
        raise ValueError(f'lm_solve_cuda needs CUDA tensors, got {device}')
    pose_dim = 4 if dof == 4 else 7
    for name, t, shape in (('x3d', x3d, (b, n, 3)), ('x2d', x2d, (b, n, 2)),
                           ('w2d', w2d, (b, n, 2)),
                           ('cam_fxfycxcy', cam_fxfycxcy, (b, 4)),
                           ('delta', delta, (b,)),
                           ('pose_init', pose_init, (b, pose_dim))):
        _check(name, t, shape, device)
    if bounds is not None:
        _check('bounds', bounds, (b, 4), device)
    lib = load_library()
    pose = torch.empty((b, pose_dim), dtype=torch.float32, device=device)
    cost = torch.empty((b,), dtype=torch.float32, device=device)
    tri = (torch.empty((b, dof * (dof + 1) // 2), dtype=torch.float32,
                       device=device) if with_jtj else None)
    ptr = lambda t: ctypes.c_void_p(  # noqa: E731
        None if t is None else t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.epropnp_lm_solve(
            ptr(x3d), ptr(x2d), ptr(w2d), ptr(cam_fxfycxcy), ptr(delta),
            ptr(bounds), ptr(pose_init), ptr(pose), ptr(cost), ptr(tri), b,
            n, dof, group_size(b, n), int(fast_mode), num_iter, z_min, eps,
            min_lm_diagonal, max_lm_diagonal, min_relative_decrease,
            initial_trust_region_radius,
            max_trust_region_radius, ctypes.c_void_p(stream))
    check_launch(err, 'epropnp_lm_solve')
    if is_training_mode(dof, bounds, with_jtj, fast_mode):
        launches_train += 1
    else:
        launches += 1
    if not with_jtj:
        return pose, cost
    return pose, cost, _jtj_matrix(tri, dof)


def lm_solve(x3d, *args, **kwargs) -> Tuple[torch.Tensor, ...]:
    """K1 entry: the CUDA kernel for CUDA tensors, the twin for CPU tensors.

    Arguments as :func:`lm_solve_reference`. Any other device raises.
    """
    if x3d.device.type == 'cuda':
        return lm_solve_cuda(x3d, *args, **kwargs)
    if x3d.device.type == 'cpu':
        return lm_solve_reference(x3d, *args, **kwargs)
    raise ValueError(f'lm_solve: unsupported device {x3d.device}')
