"""Proposal distributions for AMIS pose sampling (PyTorch).

Counterpart of ``epropnp_tpu/ops/pnp/distributions.py``:

  * multivariate Student's t (translation proposal),
  * von Mises + uniform mixture on the circle (4DoF yaw proposal), sampled
    on the device by a Best-Fisher rejection sampler,
  * angular central Gaussian on S^3 (6DoF quaternion proposal).

Every ``sample`` draws from an explicit ``torch.Generator`` (on the
generator's device; the draws are moved to the parameters' device).
``torch.distributions`` and ``torch._standard_gamma`` take no generator,
so the Student-t's chi-square is a sum of ``df`` squared normals (the
proposals use df = 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from .linalg import cholesky_small, tri_solve_lower


def _draw(shape, gen: torch.Generator, like: torch.Tensor, normal=True):
    """Standard normal (or uniform [0, 1)) draws from ``gen`` in ``like``'s
    dtype, on ``like``'s device."""
    fn = torch.randn if normal else torch.rand
    return fn(tuple(shape), generator=gen, device=gen.device,
              dtype=like.dtype).to(like.device)


def batch_mahalanobis(scale_tril, diff):
    """Squared Mahalanobis norm ``diff^T (L L^T)^{-1} diff`` with batching.

    scale_tril: (*, d, d); diff: (**, d) broadcast-compatible -> (**,).
    """
    d = diff.shape[-1]
    batch = torch.broadcast_shapes(scale_tril.shape[:-2], diff.shape[:-1])
    sol = tri_solve_lower(scale_tril.expand(batch + (d, d)),
                          diff.expand(batch + (d,)))
    return sol.square().sum(-1)


def half_log_det(scale_tril):
    return torch.log(torch.diagonal(scale_tril, dim1=-2, dim2=-1)).sum(-1)


def cholesky_wrapper(mat, default_diag: Optional[Sequence[float]] = None):
    """Cholesky with a per-matrix fallback to a default diagonal.

    ``cholesky_small`` yields NaNs on a matrix that is not positive
    definite; such matrices get ``diag(default_diag)`` (the identity when
    None), as the JAX package and the reference's caught LAPACK error do.
    """
    n = mat.shape[-1]
    tril = cholesky_small(mat)
    finite = torch.isfinite(tril)
    ok = finite.all(-1, keepdim=True).all(-2, keepdim=True)
    default = torch.diag(mat.new_tensor(
        [1.0] * n if default_diag is None else list(default_diag)))
    return torch.where(ok, torch.where(finite, tril, torch.zeros_like(tril)),
                       default)


# --------------------------------------------------------------------------
# Multivariate Student's t
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MultivariateStudentT:
    """Multivariate t distribution with a scalar ``df``."""

    df: Union[float, int]
    loc: torch.Tensor          # (*, d)
    scale_tril: torch.Tensor   # (*, d, d)

    def log_prob(self, value):
        d = self.loc.shape[-1]
        df = float(self.df)
        m = batch_mahalanobis(self.scale_tril, value - self.loc)
        return (math.lgamma(0.5 * (df + d)) - math.lgamma(0.5 * df)
                - 0.5 * d * math.log(df * math.pi)
                - half_log_det(self.scale_tril)
                - 0.5 * (df + d) * torch.log1p(m / df))

    def sample(self, gen: torch.Generator, sample_shape=()):
        df = float(self.df)
        if df != int(df) or df < 1:
            raise NotImplementedError(
                'MultivariateStudentT.sample draws the chi-square as a sum '
                f'of squared normals and takes an integer df; got {df}')
        d = self.loc.shape[-1]
        shape = tuple(sample_shape) + self.loc.shape[:-1]
        z = _draw(shape + (d,), gen, self.loc)
        chi2 = _draw((int(df),) + shape, gen, self.loc).square().sum(0)
        scaled = torch.einsum('...ij,...j->...i', self.scale_tril, z)
        return self.loc + scaled * torch.sqrt(df / chi2)[..., None]


# --------------------------------------------------------------------------
# Von Mises + uniform mixture on the circle
# --------------------------------------------------------------------------

def _sample_von_mises(gen, loc, concentration, shape, max_rounds: int = 64):
    """Best-Fisher (1979) rejection sampler, a masked loop of at most
    ``max_rounds`` rounds (acceptance >= ~58% for every kappa, so 64 rounds
    leave a < 1e-24 failure probability; unaccepted lanes keep the last
    proposal). The loop stops once every lane has accepted."""
    kappa = torch.clamp(concentration, 1e-6, 1e18)
    s_ = torch.sqrt(1.0 + 4.0 * kappa.square())
    tau = 1.0 + s_
    # cancellation-free form of (tau - sqrt(2 tau)) / (2 kappa): the
    # textbook expression rounds to 0 in f32 below kappa ~ 4e-4, sending
    # r = (1 + rho^2) / (2 rho) to inf and the acceptance ratio to nan
    rho = 2.0 * kappa * tau / ((s_ + 1.0) * (tau + torch.sqrt(2.0 * tau)))
    r = (1.0 + rho.square()) / (2.0 * rho)

    x = torch.zeros(shape, dtype=loc.dtype, device=loc.device)
    done = torch.zeros(shape, dtype=torch.bool, device=loc.device)
    for _ in range(max_rounds):
        u1, u2, u3 = _draw((3,) + tuple(shape), gen, loc, normal=False)
        z = torch.cos(math.pi * u1)
        # guarded division: at large kappa r rounds to 1 in f32 and z can
        # hit -1, making (1 + r z) / (r + z) = 0 / 0; the z -> -r limit of
        # the target density is the point mass at loc, i.e. f -> 1
        denom = r + z
        safe = torch.abs(denom) > 1e-12
        f = torch.where(safe, (1.0 + r * z) / torch.where(
            safe, denom, torch.ones_like(denom)), torch.ones_like(denom))
        c = kappa * (r - f)
        accept = ((c * (2.0 - c) - u2) > 0.0) | (
            (torch.log(torch.clamp(c / torch.clamp(u2, min=1e-30),
                                   min=1e-30)) + 1.0 - c) >= 0.0)
        proposal = torch.sign(u3 - 0.5) * torch.acos(torch.clamp(f, -1.0,
                                                                 1.0))
        x = torch.where(done, x, proposal)
        done = done | accept
        if bool(done.all()):
            break
    # shift by loc and wrap into [-pi, pi] (numpy's vonmises convention)
    out = x + loc
    return out - 2.0 * math.pi * torch.round(out / (2.0 * math.pi))


def von_mises_log_prob(value, loc, concentration):
    return concentration * torch.cos(value - loc) - math.log(2.0 * math.pi) \
        - (torch.log(torch.special.i0e(concentration)) + concentration)


@dataclass(frozen=True)
class VonMisesUniformMix:
    """0.75 von Mises + 0.25 uniform mixture on the circle.

    Sampling draws the first ``round(S * uniform_mix)`` samples from the
    uniform component and the rest from the von Mises component (a
    deterministic split, as in the reference).
    """

    loc: torch.Tensor            # (*, 1)
    concentration: torch.Tensor  # (*, 1)
    uniform_mix: float = 0.25

    def log_prob(self, value):
        vm = von_mises_log_prob(value, self.loc, self.concentration) \
            + math.log(1.0 - self.uniform_mix)
        return torch.logaddexp(vm, torch.full_like(
            vm, math.log(self.uniform_mix / (2.0 * math.pi))))

    def sample(self, gen: torch.Generator, sample_shape=()):
        assert len(sample_shape) == 1
        s = sample_shape[0]
        n_uniform = round(s * self.uniform_mix)
        batch = tuple(self.loc.shape)
        uniform = _draw((n_uniform,) + batch, gen, self.loc, normal=False) \
            * (2.0 * math.pi) - math.pi
        vm = _sample_von_mises(gen, self.loc, self.concentration,
                               (s - n_uniform,) + batch)
        return torch.cat([uniform, vm], 0)


# --------------------------------------------------------------------------
# Angular central Gaussian on S^{q-1}
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AngularCentralGaussian:
    """Antipodally symmetric distribution on the unit sphere S^{q-1}:
    log_prob = -q/2 log(x^T Sigma^{-1} x) - log|L| - log(area(S^{q-1}))."""

    scale_tril: torch.Tensor  # (*, q, q)
    eps: float = 1e-6

    @property
    def q(self):
        return self.scale_tril.shape[-1]

    def log_prob(self, value):
        q = self.q
        area = 2.0 * math.pi ** (0.5 * q) / math.gamma(0.5 * q)
        m = batch_mahalanobis(self.scale_tril, value)
        return torch.log(m) * (-q / 2.0) - half_log_det(self.scale_tril) \
            - math.log(area)

    def sample(self, gen: torch.Generator, sample_shape=()):
        q = self.q
        shape = tuple(sample_shape) + self.scale_tril.shape[:-2] + (q,)
        normal = _draw(shape, gen, self.scale_tril)
        gaussian = torch.einsum('...ij,...j->...i', self.scale_tril, normal)
        norm = torch.linalg.vector_norm(gaussian, dim=-1, keepdim=True)
        unit = torch.zeros(q, dtype=gaussian.dtype, device=gaussian.device)
        unit[0] = 1.0
        return torch.where(norm < self.eps, unit,
                           gaussian / torch.clamp(norm, min=1e-30))
