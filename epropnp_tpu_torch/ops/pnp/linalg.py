"""Batched small-matrix linear algebra for the PnP solvers (PyTorch).

The solvers only factorise SPD matrices of size 3/4/6, so the Cholesky
factorisation and the triangular solves are unrolled into elementwise
tensor code over the batch. Unlike ``torch.linalg.cholesky`` this never
raises on a matrix that is not positive definite: NaNs propagate, exactly
as in the JAX package (``epropnp_tpu/ops/pnp/linalg.py``) and in the CUDA
kernels, whose callers detect non-finite entries.
"""

from __future__ import annotations

import torch


def cholesky_small(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``a`` (..., n, n), unrolled over n."""
    n = a.shape[-1]
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = torch.sqrt(s) if i == j else s / l[j][j]
    zero = torch.zeros_like(a[..., 0, 0])
    rows = [torch.stack([l[i][j] if j <= i else zero for j in range(n)], -1)
            for i in range(n)]
    return torch.stack(rows, -2)


def tri_solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``l @ x = b`` for lower-triangular l. b: (..., n) or (..., n, m)."""
    n = l.shape[-1]
    vec = b.ndim == l.ndim - 1
    if vec:
        b = b[..., None]
    x = [None] * n
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - l[..., i, k, None] * x[k]
        x[i] = s / l[..., i, i, None]
    out = torch.stack(x, -2)
    return out[..., 0] if vec else out


def tri_solve_upper_t(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``l.T @ x = b`` for lower-triangular l (back substitution)."""
    n = l.shape[-1]
    vec = b.ndim == l.ndim - 1
    if vec:
        b = b[..., None]
    x = [None] * n
    for i in reversed(range(n)):
        s = b[..., i, :]
        for k in range(i + 1, n):
            s = s - l[..., k, i, None] * x[k]
        x[i] = s / l[..., i, i, None]
    out = torch.stack(x, -2)
    return out[..., 0] if vec else out


def solve_spd_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a @ x = b`` for SPD a via unrolled Cholesky."""
    l = cholesky_small(a)
    return tri_solve_upper_t(l, tri_solve_lower(l, b))


def cho_solve_small(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve given a precomputed lower Cholesky factor."""
    return tri_solve_upper_t(l, tri_solve_lower(l, b))


def inv_spd_small(a: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD ``a`` via Cholesky with identity right-hand side."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(a.shape)
    return solve_spd_small(a, eye)


def inv_3x3(a: torch.Tensor) -> torch.Tensor:
    """General 3x3 inverse via the adjugate (camera intrinsics etc.)."""
    m = lambda i, j: a[..., i, j]  # noqa: E731
    c00 = m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1)
    c01 = m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2)
    c02 = m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)
    det = m(0, 0) * c00 + m(0, 1) * c01 + m(0, 2) * c02
    c10 = m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2)
    c11 = m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0)
    c12 = m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1)
    c20 = m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1)
    c21 = m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2)
    c22 = m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0)
    adj = torch.stack([
        torch.stack([c00, c10, c20], -1),
        torch.stack([c01, c11, c21], -1),
        torch.stack([c02, c12, c22], -1),
    ], -2)
    return adj / det[..., None, None]


def solve_3x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a general 3x3 system; b (..., 3) or (..., 3, m)."""
    inv = inv_3x3(a)
    if b.ndim == a.ndim - 1:
        return torch.einsum('...ij,...j->...i', inv, b)
    return inv @ b


def det_small(a: torch.Tensor) -> torch.Tensor:
    """Determinant of SPD ``a`` via the Cholesky diagonal product."""
    l = cholesky_small(a)
    d = l[..., 0, 0]
    for i in range(1, a.shape[-1]):
        d = d * l[..., i, i]
    return d * d
