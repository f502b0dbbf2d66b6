"""Distributions of the model's heads (counterpart of
`psvo_tpu/distributions.py`): diagonal and full-covariance Gaussians, the
Poisson count emission and the Dirac delta.

Pure functions over explicit parameter tensors; every function broadcasts
over leading axes. The `_cm` variants take the channel-major particle
layout [..., D, K] of the forward filter (event axis at -2). A full
covariance is given by its lower-triangular Cholesky factor L (Σ = L Lᵀ):
a [D, D] tensor, or, per particle (the "tril_head" heads), packed as the
diagonal [..., D, K] and the strict lower entries [..., D(D−1)/2, K] in
row-major order (`torch.tril_indices(D, D, -1)`).
"""

from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

# Finiteness floor on reduced log-densities: a diverging mean yields an
# astronomically negative but finite log-weight instead of -inf, so one bad
# particle cannot turn the whole estimate into NaN (same value as the
# reference's floor).
_MIN_LOGP = -1e30


def mvn_diag_log_prob(x, mean, scale):
    """Log density of a diagonal-covariance Gaussian, reduced over the last axis."""
    z = (x - mean) / scale
    logp = torch.sum(-0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI, dim=-1)
    return torch.clamp(logp, min=_MIN_LOGP)


def mvn_diag_log_prob_cm(x, mean, scale):
    """`mvn_diag_log_prob` with the event axis at -2: [..., D, K] -> [..., K]."""
    z = (x - mean) / scale
    logp = torch.sum(-0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI, dim=-2)
    return torch.clamp(logp, min=_MIN_LOGP)


def mvn_product(mean_a, scale_a, mean_b, scale_b):
    """Precision-weighted product of two diagonal Gaussians (the `use_2q`
    fusion): var = 1/(1/s_a² + 1/s_b²), mean = var·(m_a/s_a² + m_b/s_b²)."""
    prec_a = 1.0 / (scale_a * scale_a)
    prec_b = 1.0 / (scale_b * scale_b)
    var = 1.0 / (prec_a + prec_b)
    mean = var * (mean_a * prec_a + mean_b * prec_b)
    return mean, torch.sqrt(var)


def mvn_full_sample(generator, mean, chol):
    """x = mean + L·ε with ε ~ N(0, I) drawn from `generator`: mean [..., D],
    chol [..., D, D]."""
    eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + torch.einsum("...ij,...j->...i", chol, eps)


def mvn_full_log_prob(x, mean, chol):
    """Log density with covariance L Lᵀ, reduced over the last axis: x and
    mean [..., D], chol [..., D, D] (broadcast); a triangular solve."""
    d = x.shape[-1]
    diff = x - mean
    batch_shape = torch.broadcast_shapes(diff.shape[:-1], chol.shape[:-2])
    chol_b = chol.expand(*batch_shape, d, d)
    diff_b = diff.expand(*batch_shape, d)
    z = torch.linalg.solve_triangular(chol_b, diff_b[..., None], upper=False)[..., 0]
    log_det = torch.sum(torch.log(torch.diagonal(chol_b, dim1=-2, dim2=-1)), dim=-1)
    logp = -0.5 * torch.sum(z * z, dim=-1) - log_det - d * _HALF_LOG_2PI
    return torch.clamp(logp, min=_MIN_LOGP)


def mvn_full_log_prob_cm(x, mean, chol):
    """Channel-major full-covariance log density with one constant [D, D]
    factor (cov_type="tril"): x, mean [..., D, K] -> [..., K], one
    triangular solve against each row's [D, K] matrix."""
    d = chol.shape[-1]
    diff = x - mean
    z = torch.linalg.solve_triangular(chol.expand(*diff.shape[:-2], d, d), diff, upper=False)
    log_det = torch.sum(torch.log(torch.diagonal(chol)))
    logp = -0.5 * torch.sum(z * z, dim=-2) - log_det - d * _HALF_LOG_2PI
    return torch.clamp(logp, min=_MIN_LOGP)


def mvn_tril_log_prob_cm(x, mean, diag, off):
    """Channel-major full-covariance log density with a packed Cholesky
    factor per particle (cov_type="tril_head"): x, mean, diag [..., D, K],
    off [..., D(D−1)/2, K] -> [..., K]. The forward substitution
    L z = x − mean unrolled over the small D."""
    d = x.shape[-2]
    diff = x - mean
    zs = []
    p = 0
    for i in range(d):
        acc = diff[..., i, :]
        for j in range(i):
            acc = acc - off[..., p, :] * zs[j]
            p += 1
        zs.append(acc / diag[..., i, :])
    maha = sum(z * z for z in zs)
    log_det = torch.sum(torch.log(diag), dim=-2)
    logp = -0.5 * maha - log_det - d * _HALF_LOG_2PI
    return torch.clamp(logp, min=_MIN_LOGP)


def mvn_tril_sample_cm(eps, mean, diag, off):
    """The reparameterised draw x = mean + L·ε with the packed per-particle
    factor, channel-major: x_i = mean_i + diag_i·ε_i + Σ_{j<i} off_ij·ε_j."""
    d = mean.shape[-2]
    rows = []
    p = 0
    for i in range(d):
        acc = diag[..., i, :] * eps[..., i, :]
        for j in range(i):
            acc = acc + off[..., p, :] * eps[..., j, :]
            p += 1
        rows.append(mean[..., i, :] + acc)
    return torch.stack(rows, dim=-2)


def poisson_log_prob(y, log_rate):
    """Σ_d [y_d·log λ_d − λ_d − lgamma(y_d + 1)] over the last axis, log λ
    clamped to ±80 (a diverging rate head gives a large finite penalty)."""
    log_rate = torch.clamp(log_rate, -80.0, 80.0)
    return torch.sum(y * log_rate - torch.exp(log_rate) - torch.lgamma(y + 1.0), dim=-1)


def poisson_log_prob_cm(y, log_rate):
    """`poisson_log_prob` with the event axis at -2."""
    log_rate = torch.clamp(log_rate, -80.0, 80.0)
    return torch.sum(y * log_rate - torch.exp(log_rate) - torch.lgamma(y + 1.0), dim=-2)


def poisson_sample(generator, log_rate):
    """Poisson counts of rate exp(log_rate), float32 (data generation only)."""
    return torch.poisson(torch.exp(log_rate), generator=generator).to(torch.float32)


def dirac_sample(generator, mean):  # noqa: ARG001
    """A Dirac delta's draw is its location."""
    return mean


def dirac_log_prob(x, mean):  # noqa: ARG001
    """A Dirac delta adds 0 to the log-weights (a constant density)."""
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def log_normalize(logw, dim: int = -1):
    """Return (normalized log-weights, logsumexp) along `dim`, max-shifted."""
    m = torch.amax(logw, dim=dim, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logw - m), dim=dim, keepdim=True)) + m
    return logw - lse, lse.squeeze(dim)


def effective_sample_size(logw, dim: int = -1):
    """ESS = 1 / Σ_k W_k² of the normalized weights."""
    logw_norm, _ = log_normalize(logw, dim=dim)
    return torch.exp(-torch.logsumexp(2.0 * logw_norm, dim=dim))
