"""Diagonal-Gaussian primitives of the forward filter (counterpart of
`psvo_tpu/distributions.py`, the subset the FIVO serving path uses).

Pure functions over explicit (mean, scale) tensors; every function
broadcasts over leading axes. The `_cm` variants take the channel-major
particle layout [..., D, K] of the forward filter (event axis at -2).
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


def log_normalize(logw, dim: int = -1):
    """Return (normalized log-weights, logsumexp) along `dim`, max-shifted."""
    m = torch.amax(logw, dim=dim, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logw - m), dim=dim, keepdim=True)) + m
    return logw - lse, lse.squeeze(dim)


def effective_sample_size(logw, dim: int = -1):
    """ESS = 1 / Σ_k W_k² of the normalized weights."""
    logw_norm, _ = log_normalize(logw, dim=dim)
    return torch.exp(-torch.logsumexp(2.0 * logw_norm, dim=dim))
