"""PyTorch port of the AMIS proposal distributions against the JAX package.

The same numpy parameters and values (``np.random.default_rng``) go through
both packages in float64; draws cannot match JAX's PRNG, so sampling is
checked by its moments from a seeded ``torch.Generator``. Every tolerance
is stated at its assertion.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.ops.pnp import distributions as jd
from epropnp_tpu_torch.ops.pnp import distributions as td

torch.set_num_threads(1)


def _spd(r, shape, d, jitter=0.1):
    a = r.normal(size=shape + (d, d))
    return a @ np.swapaxes(a, -1, -2) + jitter * np.eye(d)


def _tril(r, shape, d):
    return np.linalg.cholesky(_spd(r, shape, d))


def _close(a, b, rtol=1e-10, atol=1e-12):
    # float64 on both sides, the same formulas: agreement to ~1e-14
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_student_t_log_prob_matches_jax():
    r = np.random.default_rng(0)
    loc, tril = r.normal(size=(5, 3)), _tril(r, (5,), 3)
    value = r.normal(size=(7, 5, 3)) * 2.0
    ref = jd.MultivariateStudentT(3.0, jnp.asarray(loc), jnp.asarray(tril)
                                  ).log_prob(jnp.asarray(value))
    out = td.MultivariateStudentT(3.0, torch.tensor(loc), torch.tensor(tril)
                                  ).log_prob(torch.tensor(value))
    assert out.shape == (7, 5)
    _close(out, ref)


def test_von_mises_mix_log_prob_matches_jax():
    r = np.random.default_rng(1)
    loc = r.uniform(-math.pi, math.pi, (6, 1))
    kappa = 10.0 ** r.uniform(-3, 3, (6, 1))
    value = r.uniform(-math.pi, math.pi, (9, 6, 1))
    ref = jd.VonMisesUniformMix(jnp.asarray(loc), jnp.asarray(kappa)
                                ).log_prob(jnp.asarray(value))
    out = td.VonMisesUniformMix(torch.tensor(loc), torch.tensor(kappa)
                                ).log_prob(torch.tensor(value))
    _close(out, ref)


def test_acg_log_prob_matches_jax():
    r = np.random.default_rng(2)
    tril = _tril(r, (4,), 4)
    q = r.normal(size=(11, 4, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    ref = jd.AngularCentralGaussian(jnp.asarray(tril)).log_prob(
        jnp.asarray(q))
    out = td.AngularCentralGaussian(torch.tensor(tril)).log_prob(
        torch.tensor(q))
    _close(out, ref)
    # stacked proposals (p, 1, num_obj, 4, 4) on samples (s, num_obj, 4),
    # the AMIS mixture's layout
    tril2 = _tril(r, (3, 1, 4), 4)
    ref2 = jd.AngularCentralGaussian(jnp.asarray(tril2)).log_prob(
        jnp.asarray(q))
    out2 = td.AngularCentralGaussian(torch.tensor(tril2)).log_prob(
        torch.tensor(q))
    assert out2.shape == (3, 11, 4)
    _close(out2, ref2)


@pytest.mark.parametrize('default', [None, [1.0, 1.0, 4.0]])
def test_cholesky_wrapper_fallback_matches_jax(default):
    """A matrix that is not positive definite gets the default diagonal,
    per matrix; the others their Cholesky factor."""
    r = np.random.default_rng(3)
    mats = _spd(r, (4,), 3)
    mats[1] = -np.eye(3)
    mats[3, 0, 0] = -1.0
    ref = jd.cholesky_wrapper(jnp.asarray(mats), default)
    out = td.cholesky_wrapper(torch.tensor(mats), default)
    _close(out, ref)
    diag = np.diag(default or [1.0, 1.0, 1.0])
    _close(out[1], diag, 0, 0)
    _close(out[3], diag, 0, 0)
    _close(out[0], np.linalg.cholesky(mats[0]))


def test_batch_mahalanobis_and_half_log_det_match_jax():
    r = np.random.default_rng(4)
    tril = _tril(r, (2, 5), 4)
    diff = r.normal(size=(3, 1, 5, 4))
    _close(td.batch_mahalanobis(torch.tensor(tril), torch.tensor(diff)),
           jd.batch_mahalanobis(jnp.asarray(tril), jnp.asarray(diff)))
    _close(td.half_log_det(torch.tensor(tril)),
           jd.half_log_det(jnp.asarray(tril)))


def test_sample_moments_from_a_generator():
    """Draws come from the caller's generator (the same seed gives the same
    draws) and have the right moments: 20000 draws, tolerances ~5 standard
    errors."""
    n = 20000
    loc = torch.tensor([[1.0, -2.0, 0.5]], dtype=torch.float64)
    tril = torch.tensor([[[1.0, 0, 0], [0.5, 2.0, 0], [0.2, -0.3, 0.7]]],
                        dtype=torch.float64)
    st = td.MultivariateStudentT(3.0, loc, tril)
    a = st.sample(torch.Generator().manual_seed(5), (n,))
    b = st.sample(torch.Generator().manual_seed(5), (n,))
    assert a.shape == (n, 1, 3) and torch.equal(a, b)
    # t_3: the median is the location; the covariance is df / (df - 2)
    # L L^T but its sample estimate has infinite variance, so check the
    # median and the interquartile range of the standardised first axis
    # (t_3 quartiles +-0.7649)
    med = a[:, 0].median(0).values
    np.testing.assert_allclose(med.numpy(), loc[0].numpy(), atol=0.05)
    z = (a[:, 0, 0] - loc[0, 0]) / tril[0, 0, 0]
    q = torch.quantile(z, torch.tensor([0.25, 0.75], dtype=z.dtype))
    np.testing.assert_allclose(q.numpy(), [-0.7649, 0.7649], atol=0.04)

    # von Mises + uniform: 1/4 uniform draws first, then von Mises around
    # the location with E[cos(x - mu)] = I1/I0(kappa)
    kappa = torch.tensor([[4.0]], dtype=torch.float64)
    vm = td.VonMisesUniformMix(torch.tensor([[0.3]], dtype=torch.float64),
                               kappa)
    x = vm.sample(torch.Generator().manual_seed(6), (n,))
    assert x.shape == (n, 1, 1) and x.abs().max() <= math.pi + 1e-12
    vm_part = x[n // 4:, 0, 0]
    ratio = (torch.special.i1(kappa) / torch.special.i0(kappa)).item()
    np.testing.assert_allclose(torch.cos(vm_part - 0.3).mean().item(),
                               ratio, atol=0.01)
    np.testing.assert_allclose(torch.cos(x[:n // 4, 0, 0]).mean().item(), 0,
                               atol=0.03)

    # ACG: unit quaternions with E[x x^T] of the largest eigenvector where
    # Sigma is dominated by one direction
    acg = td.AngularCentralGaussian(torch.diag(torch.tensor(
        [3.0, 0.1, 0.1, 0.1], dtype=torch.float64))[None])
    q = acg.sample(torch.Generator().manual_seed(7), (n,))
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-12)
    assert (q[..., 0].square().mean() > 0.8).item()


def test_von_mises_f32_regression_over_kappa():
    """The f32 von Mises sampler stays finite and concentrated from
    kappa 1e-6 (near uniform) to 1e8 (near delta), the JAX package's fix
    for the Best-Fisher rho that cancels to 0 in f32 below kappa ~ 4e-4."""
    kappa = torch.tensor([1e-6, 1e-5, 1e-4, 4e-4, 1e-3, 1e-2, 1.0, 1e2,
                          1e4, 1e6, 1e8], dtype=torch.float32)[:, None]
    loc = torch.full_like(kappa, 0.5)
    x = td.VonMisesUniformMix(loc, kappa, uniform_mix=0.0).sample(
        torch.Generator().manual_seed(8), (4000,))
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
    r = torch.cos(x[..., 0] - 0.5).mean(0)
    # near uniform: mean resultant ~0 (5 standard errors of 1/sqrt(2n));
    # concentrated: ~1 - 1/(2 kappa)
    assert (r[:5].abs() < 0.06).all(), r
    assert (r[-3:] > 0.999).all(), r
    lp = td.VonMisesUniformMix(loc, kappa).log_prob(x)
    assert torch.isfinite(lp).all()
