"""K2: the fused random-sample LM (RSLM) init, and its plain twin.

``rslm_init`` is what ``RSLMSolver`` calls when the fused-init gate lets
it, and the counterpart of the JAX entry ``rslm_init_pallas``. On a CUDA
tensor it launches the hand-written kernel of ``csrc/rslm_kernel.cu`` (one
block per object, one thread per proposal) or raises; on a CPU tensor it
runs :func:`rslm_init_reference`, the same function written with torch
ops. Both take dof 6 and 4, and (B, 4) projection bounds
``[lb_u, lb_v, ub_u, ub_v]`` at shapes of the packed layout.

The scoring follows the JAX entry's layout dispatch
(``pallas_rslm.py:879-896``): shapes of the packed layout (num_points <=
128 dividing 128, N % 128 == 0) score on the strided subsample that
``score_points`` asks for (else on the full set); every other shape takes
the legacy layout, which scores on the full set and refuses bounds.

Per object: the centre-based translation init, ``num_proposals`` subsets
of ``num_points`` indices drawn WITH replacement by inverse cdf over
``mean(w2d, -1)``, a random unit quaternion (or yaw) per proposal,
``num_iter`` trust-region LM steps on every proposal, each proposal's
Huber cost on the scoring points, and the argmin (on an exact
tie the first proposal wins; a NaN cost never wins unless all are NaN).

Random bits: Philox4x32-10 as curand's ``curandStatePhilox4_32_10_t``
(key = the object's seed, subsequence = the proposal). The twin replays
the same stream (:func:`philox_uniforms`), so on the card the kernel and
the twin draw the same samples and agree per object up to summation
order.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .lm_kernel import _check, _evaluate, _lm_trust_region_step

# Launches of the CUDA kernel, counted by :func:`rslm_init_cuda` alone:
# at shapes of the packed layout without and with projection bounds, and
# at the legacy layout's.
launches = 0
launches_bounds = 0
launches_legacy = 0

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of ``a * b`` for 32-bit ``a``, int64 ``b``,
    without overflowing int64 (``b`` is split into 16-bit halves)."""
    p_hi = a * (b >> 16)                       # < 2**48
    s = a * (b & 0xFFFF) + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 values."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seeds: torch.Tensor, num_streams: int,
                    num_draws: int) -> torch.Tensor:
    """curand_uniform draws (B, num_streams, num_draws), float32 in (0, 1].

    Stream ``s`` of object ``b`` is ``curand_init(seeds[b] as uint32, s,
    0)``: draw ``i`` is word ``i % 4`` of Philox at counter
    ``(i // 4, 0, s, 0)`` under key ``(seed, 0)``, mapped by
    ``x * 2**-32 + 2**-33`` in float32.
    """
    dev = seeds.device
    n_blk = (num_draws + 3) // 4
    key = (seeds.to(torch.int64) & _MASK32)[:, None, None]
    blk = torch.arange(n_blk, device=dev, dtype=torch.int64)[None, None, :]
    stream = torch.arange(num_streams, device=dev,
                          dtype=torch.int64)[None, :, None]
    shape = (seeds.shape[0], num_streams, n_blk)
    zero = torch.zeros(shape, device=dev, dtype=torch.int64)
    words = philox4x32_10(blk.expand(shape), zero, stream.expand(shape), zero,
                          key.expand(shape), zero)
    bits = torch.stack(words, -1).reshape(shape[:2] + (n_blk * 4,))
    bits = bits[..., :num_draws]
    return bits.to(torch.float32) * (2.0 ** -32) + (2.0 ** -33)


def packed_layout(n: int, num_points: int) -> bool:
    """The JAX entry's test for its packed kernel layout."""
    return num_points <= 128 and 128 % num_points == 0 and n % 128 == 0


def _score_layout(n: int, num_points: int, score_points: Optional[int],
                  bounds=None) -> Tuple[int, int]:
    """(stride, count) of the scoring points, as the JAX entry picks them.

    Packed layout: a strided subsample where ``score_points`` is a multiple
    of 128 that divides N and is below N, else the full set. Legacy layout
    (any other shape): the full set, and projection bounds are refused.
    """
    if not packed_layout(n, num_points):
        if bounds is not None:
            raise ValueError(
                'projection bounds need the packed layout (num_points <= 128 '
                f'dividing 128, N % 128 == 0); got N={n}, num_points='
                f'{num_points}')
        return 1, n
    if (score_points is None or score_points % 128 != 0
            or n % score_points != 0 or score_points >= n):
        return 1, n
    return n // score_points, score_points


def _check_bounds(bounds, b: int) -> None:
    """``bounds``: None or a (B, 4) ``[lb_u, lb_v, ub_u, ub_v]`` tensor."""
    if bounds is not None and (not isinstance(bounds, torch.Tensor)
                               or tuple(bounds.shape) != (b, 4)):
        shape = tuple(getattr(bounds, 'shape', ()))
        raise ValueError(f'bounds: expected a ({b}, 4) tensor [lb_u, lb_v, '
                         f'ub_u, ub_v], got {type(bounds).__name__} {shape}')


def _centre_init(x3d, x2d, cam, dof):
    """(B, 3) translation init from the point spreads (kernel arithmetic:
    sums times 1/N, two-pass unbiased variances)."""
    n = x3d.shape[1]
    fx, fy, cx, cy = cam.unbind(-1)
    xc = (x2d[..., 0] - cx[:, None]) / fx[:, None]
    yc = (x2d[..., 1] - cy[:, None]) / fy[:, None]
    cols = torch.stack([xc, yc, x3d[..., 0], x3d[..., 1], x3d[..., 2]], -1)
    mu = cols.sum(1) * (1.0 / n)
    var = ((cols - mu[:, None]) ** 2).sum(1) * (1.0 / (n - 1))
    if dof == 4:
        scale = torch.sqrt(var[:, 3]) / torch.clamp(torch.sqrt(var[:, 1]),
                                                    min=1e-6)
    else:
        norm3 = torch.sqrt(var[:, 2] + var[:, 3] + var[:, 4])
        normc = torch.sqrt(torch.clamp(var[:, 0] + var[:, 1], min=1e-12))
        scale = math.sqrt(2.0 / 3.0) * norm3 / torch.clamp(normc, min=1e-6)
    return torch.stack([mu[:, 0] * scale, mu[:, 1] * scale, scale], -1)


def rslm_init_reference(x3d, x2d, w2d, cam_fxfycxcy, delta, seeds,
                        bounds=None, dof: int = 6, num_points: int = 16,
                        num_proposals: int = 64, num_iter: int = 3,
                        z_min: float = 0.1, eps: float = 1e-5,
                        min_lm_diagonal: float = 1e-6,
                        max_lm_diagonal: float = 1e32,
                        min_relative_decrease: float = 1e-3,
                        initial_trust_region_radius: float = 30.0,
                        max_trust_region_radius: float = 1e16,
                        score_points: Optional[int] = None,
                        tile_obj: int = 4, group_pack: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the K2 kernel (same signature as
    :func:`rslm_init`). Returns ``(pose (B, pose_dim), cost (B,))``; the
    cost is that of the scoring points.

    ``tile_obj`` and ``group_pack`` are the JAX entry's TPU layout knobs
    (objects per grid step, lane blocks per step): accepted and ignored.
    """
    b, n, _ = x3d.shape
    p, k = num_proposals, num_points
    dt = x3d.dtype
    pose_dim = 4 if dof == 4 else 7
    _check_bounds(bounds, b)
    stride, n_sc = _score_layout(n, k, score_points, bounds)

    t0 = _centre_init(x3d, x2d, cam_fxfycxcy, dof)            # (B, 3)
    cdf = torch.cumsum((w2d[..., 0] + w2d[..., 1]) * 0.5, -1)  # (B, N)
    uni = philox_uniforms(seeds, p, k + (1 if dof == 4 else 8)).to(dt)
    u = (uni[..., :k] * cdf[:, -1:, None]).reshape(b, p * k)
    inds = torch.searchsorted(cdf, u).clamp(max=n - 1).reshape(b, p, k)
    b_idx = torch.arange(b, device=x3d.device)[:, None, None]
    pts = torch.cat([x3d, x2d, w2d], -1)[b_idx, inds]          # (B, P, K, 7)
    pts = pts.reshape(b * p, k, 7).unbind(-1)

    if dof == 4:
        rot = [(uni[..., k] * (2.0 * math.pi)).reshape(b * p, 1)]
    else:
        u1 = torch.clamp(uni[..., k:k + 8:2], min=1e-12)
        u2 = uni[..., k + 1:k + 8:2]
        normal = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            2.0 * math.pi * u2)                                # (B, P, 4)
        qn = torch.sqrt((normal * normal).sum(-1, keepdim=True))
        ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dt,
                             device=x3d.device)
        quat = torch.where(qn < eps, ident, normal / torch.clamp(qn, min=1e-30))
        rot = list(quat.reshape(b * p, 4).unbind(-1))
        rot = [c[:, None] for c in rot]
    t_rep = t0.repeat_interleave(p, 0)                          # (B*P, 3)
    pose = [t_rep[:, i:i + 1] for i in range(3)] + rot

    cam_rep = cam_fxfycxcy.repeat_interleave(p, 0)
    cam = tuple(cam_rep[:, i:i + 1] for i in range(4))
    dlt = delta.repeat_interleave(p, 0)[:, None]
    bnd = None
    if bounds is not None:
        b_rep = bounds.repeat_interleave(p, 0)
        bnd = tuple(b_rep[:, i:i + 1] for i in range(4))

    def ev_sub(pose_cols):
        return _evaluate(pose_cols, pts, cam, dlt, dof, z_min, bounds=bnd)

    cost, jtj, g = ev_sub(pose)
    state = (pose, cost, jtj, g,
             torch.full_like(cost, initial_trust_region_radius),
             torch.full_like(cost, 2.0))
    for _ in range(num_iter):
        state = _lm_trust_region_step(
            state, ev_sub, dof, eps, min_lm_diagonal, max_lm_diagonal,
            min_relative_decrease, max_trust_region_radius)
    pose = state[0]

    sub = torch.cat([x3d, x2d, w2d], -1)[:, ::stride][:, :n_sc]  # (B, S, 7)
    sub = sub.repeat_interleave(p, 0).unbind(-1)
    cost_sc, _, _ = _evaluate(pose, sub, cam, dlt, dof, z_min, bounds=bnd,
                              need_jac=False)
    cost_sc = cost_sc.reshape(b, p)
    key = torch.where(torch.isnan(cost_sc), torch.full_like(cost_sc, math.inf),
                      cost_sc)
    best = torch.argmin(key, 1)                                 # first minimum
    pose_all = torch.cat(pose, 1).reshape(b, p, pose_dim)
    rows = torch.arange(b, device=x3d.device)
    return pose_all[rows, best], cost_sc[rows, best]


def rslm_init_cuda(x3d, x2d, w2d, cam_fxfycxcy, delta, seeds,
                   bounds=None, dof: int = 6, num_points: int = 16,
                   num_proposals: int = 64, num_iter: int = 3,
                   z_min: float = 0.1, eps: float = 1e-5,
                   min_lm_diagonal: float = 1e-6,
                   max_lm_diagonal: float = 1e32,
                   min_relative_decrease: float = 1e-3,
                   initial_trust_region_radius: float = 30.0,
                   max_trust_region_radius: float = 1e16,
                   score_points: Optional[int] = None,
                   tile_obj: int = 4, group_pack: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K2 kernel on CUDA tensors (f32, contiguous); ``bounds``
    is None or (B, 4) ``[lb_u, lb_v, ub_u, ub_v]`` (packed layout only).
    ``tile_obj`` and ``group_pack`` are accepted and ignored (TPU knobs)."""
    global launches, launches_bounds, launches_legacy
    from ...kernels import check_launch, load_library

    if dof not in (4, 6):
        raise NotImplementedError(
            f'rslm_init_cuda: the CUDA kernel runs dof 6 or 4; got {dof}')
    b, n, _ = x3d.shape
    _check_bounds(bounds, b)
    stride, n_sc = _score_layout(n, num_points, score_points, bounds)
    device = x3d.device
    if device.type != 'cuda':
        raise ValueError(f'rslm_init_cuda needs CUDA tensors, got {device}')
    if n < 2 or not 1 <= num_proposals <= 1024 or num_points < 1:
        raise ValueError(f'unsupported shape: N={n}, num_proposals='
                         f'{num_proposals}, num_points={num_points}')
    for name, t, shape in (('x3d', x3d, (b, n, 3)), ('x2d', x2d, (b, n, 2)),
                           ('w2d', w2d, (b, n, 2)),
                           ('cam_fxfycxcy', cam_fxfycxcy, (b, 4)),
                           ('delta', delta, (b,))):
        _check(name, t, shape, device)
    if bounds is not None:
        _check('bounds', bounds, (b, 4), device)
    if (seeds.device != device or seeds.dtype != torch.int32
            or tuple(seeds.shape) != (b,) or not seeds.is_contiguous()):
        raise ValueError('seeds: expected a contiguous (B,) int32 tensor on '
                         f'{device}')
    lib = load_library()
    pose = torch.empty((b, 4 if dof == 4 else 7), dtype=torch.float32,
                       device=device)
    cost = torch.empty((b,), dtype=torch.float32, device=device)
    ptr = lambda t: ctypes.c_void_p(  # noqa: E731
        None if t is None else t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.epropnp_rslm_init(
            ptr(seeds), ptr(x3d), ptr(x2d), ptr(w2d), ptr(cam_fxfycxcy),
            ptr(delta), ptr(bounds), ptr(pose), ptr(cost), b, n, dof,
            num_points, num_proposals, num_iter, stride, n_sc, z_min, eps,
            min_lm_diagonal, max_lm_diagonal, min_relative_decrease,
            initial_trust_region_radius, max_trust_region_radius,
            ctypes.c_void_p(stream))
    check_launch(err, 'epropnp_rslm_init')
    if not packed_layout(n, num_points):
        launches_legacy += 1
    elif bounds is not None:
        launches_bounds += 1
    else:
        launches += 1
    return pose, cost


def rslm_init(x3d, *args, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 entry: the CUDA kernel for CUDA tensors, the twin for CPU tensors.

    Arguments as :func:`rslm_init_reference`. Any other device raises.
    """
    if x3d.device.type == 'cuda':
        return rslm_init_cuda(x3d, *args, **kwargs)
    if x3d.device.type == 'cpu':
        return rslm_init_reference(x3d, *args, **kwargs)
    raise ValueError(f'rslm_init: unsupported device {x3d.device}')
