"""MLP heads (counterpart of `psvo_tpu/networks.py`).

A head is an `nn.Module` holding the same tensors as the reference's params
pytree `{"layers": [(W, b), ...], "mean": (W, b), "raw_scale": s}`, with W
stored [din, dout] so `x @ W + b` reads as in the reference; `psvo_tpu_torch.
bridge` converts between the two exactly. The apply functions are plain
functions of (head, x). The `_cm` variants take the channel-major layout
[..., D, K] (features on axis -2, particles last) of the forward filter.

Only constant diagonal scales (cov_type="const") are ported; the
state-dependent and full-covariance heads wait for the model-mode slice.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
}


def scale_from_raw(raw, sigma_min: float):
    """softplus + floor (the reference's sigma_min clamp). softplus is written
    as logaddexp(raw, 0) to match jax.nn.softplus for every input."""
    return torch.logaddexp(raw, torch.zeros_like(raw)) + sigma_min


class MLPHead(nn.Module):
    """MLP mapping inputs to the (mean, scale) of a diagonal Gaussian."""

    def __init__(self, din: int, dout: int, hidden: Sequence[int]):
        super().__init__()
        sizes = [din, *hidden]
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.zeros(a, b)) for a, b in zip(sizes[:-1], sizes[1:])]
        )
        self.biases = nn.ParameterList(
            [nn.Parameter(torch.zeros(b)) for b in sizes[1:]]
        )
        self.mean_w = nn.Parameter(torch.zeros(sizes[-1], dout))
        self.mean_b = nn.Parameter(torch.zeros(dout))
        self.raw_scale = nn.Parameter(torch.zeros(dout))

    def layers(self):
        return list(zip(self.weights, self.biases))


def _glorot_(w: torch.Tensor, generator) -> None:
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float32)
    w.copy_(u * (2.0 * limit) - limit)


def init_mlp_head(
    generator: torch.Generator,
    din: int,
    dout: int,
    hidden: Sequence[int],
    *,
    cov_type: str = "const",
    sigma_init: float = 1.0,
    sigma_min: float = 1e-3,
) -> MLPHead:
    """The reference's initialisation scheme: Glorot-uniform weights, zero
    biases, raw_scale set so softplus(raw) + sigma_min == sigma_init. The
    draws come from `generator` (a CPU generator), so the bits differ from
    jax.random's."""
    if cov_type != "const":
        raise NotImplementedError(
            f"cov_type={cov_type!r}: only constant diagonal scales are ported"
        )
    head = MLPHead(din, dout, hidden)
    with torch.no_grad():
        for w, b in head.layers():
            _glorot_(w, generator)
            b.zero_()
        _glorot_(head.mean_w, generator)
        head.mean_b.zero_()
        raw = math.log(math.expm1(max(sigma_init - sigma_min, 1e-6)))
        head.raw_scale.fill_(raw)
    return head


def mlp_features(head: MLPHead, x, activation: str = "relu"):
    act = _ACTIVATIONS[activation]
    h = x
    for w, b in head.layers():
        h = act(h @ w + b)
    return h


def mlp_mean_scale(head: MLPHead, x, activation: str = "relu", sigma_min: float = 1e-3):
    """Feature-last (mean, scale): [..., Din] -> 2x [..., Dout]."""
    mean = mlp_features(head, x, activation) @ head.mean_w + head.mean_b
    scale = scale_from_raw(head.raw_scale, sigma_min).expand(mean.shape)
    return mean, scale


def _dense_cm(h, w, b):
    """One dense layer over the channel axis: [..., Din, K] -> [..., Dout, K]."""
    return torch.einsum("de,...dk->...ek", w, h) + b[:, None]


def mlp_mean_cm(head: MLPHead, x, activation: str = "relu"):
    act = _ACTIVATIONS[activation]
    h = x
    for w, b in head.layers():
        h = act(_dense_cm(h, w, b))
    return _dense_cm(h, head.mean_w, head.mean_b)


def mlp_mean_scale_cm(
    head: MLPHead, x, activation: str = "relu", sigma_min: float = 1e-3
):
    """Channel-major (mean, scale): [..., Din, K] -> 2x [..., Dout, K]."""
    mean = mlp_mean_cm(head, x, activation)
    scale = scale_from_raw(head.raw_scale, sigma_min)[:, None].expand(mean.shape)
    return mean, scale
