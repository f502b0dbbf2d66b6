"""MLP heads (counterpart of `psvo_tpu/networks.py`).

A head is an `nn.Module` holding the same tensors as the reference's params
pytree, with W stored [din, dout] so `x @ W + b` reads as in the reference;
`psvo_tpu_torch.bridge` converts between the two exactly. Every head has the
trunk `{"layers": [(W, b), ...]}` and the mean layer `"mean": (W, b)`; its
`cov_type` adds the scale's leaves:

- "const": `raw_scale` [dout], a trainable diagonal scale;
- "head": `scale_head` (W, b), a diagonal scale from a second linear head
  on the trunk;
- "tril": `raw_tril` {diag [dout], off [dout(dout−1)/2]}, a trainable
  constant Cholesky factor (`tril_from_raw`);
- "tril_head": `tril_diag_head` (W, b) and `tril_off_head` (W, b), a packed
  Cholesky factor per input;
- "none": a mean-only head (Poisson log-rates, Dirac locations).

`GRU` is the reference's GRU cell (`init_gru`, `gru_step`), the state of
SVO's backward-proposal RNN (smc.qb_rnn): z, r and h̃ each a dense map on
[x; h], not `torch.nn.GRUCell`'s algebra (which resets the hidden product
W_hn·h + b_hn and keeps separate input and hidden biases).

The apply functions are plain functions of (head, x). The `_cm` variants
take the channel-major layout [..., D, K] (features on axis -2, particles
last) of the forward filter.
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

COV_TYPES = ("const", "head", "tril", "tril_head", "none")


def scale_from_raw(raw, sigma_min: float):
    """softplus + floor (the reference's sigma_min clamp). softplus is written
    as logaddexp(raw, 0) to match jax.nn.softplus for every input."""
    return torch.logaddexp(raw, torch.zeros_like(raw)) + sigma_min


def _tril_rows_cols(d: int):
    """Row and column indices of the strict lower triangle of a [d, d]
    matrix, row-major (numpy's `tril_indices(d, k=-1)` order)."""
    return torch.tril_indices(d, d, -1)


def tril_from_raw(diag_raw, off, sigma_min: float):
    """The [D, D] lower-triangular Cholesky factor of a "tril" head: the
    floored softplus of `diag_raw` on the diagonal, `off` below it."""
    chol = torch.diag(scale_from_raw(diag_raw, sigma_min))
    return _set_off(chol, off) if diag_raw.shape[0] > 1 else chol


class MLPHead(nn.Module):
    """MLP mapping inputs to a mean and, by `cov_type`, a scale."""

    def __init__(self, din: int, dout: int, hidden: Sequence[int], cov_type: str = "const"):
        super().__init__()
        if cov_type not in COV_TYPES:
            raise ValueError(f"unknown cov_type: {cov_type!r}")
        self.cov_type = cov_type
        sizes = [din, *hidden]
        top = sizes[-1]
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.zeros(a, b)) for a, b in zip(sizes[:-1], sizes[1:])]
        )
        self.biases = nn.ParameterList(
            [nn.Parameter(torch.zeros(b)) for b in sizes[1:]]
        )
        self.mean_w = nn.Parameter(torch.zeros(top, dout))
        self.mean_b = nn.Parameter(torch.zeros(dout))
        n_off = dout * (dout - 1) // 2
        if cov_type == "const":
            self.raw_scale = nn.Parameter(torch.zeros(dout))
        elif cov_type == "head":
            self.scale_w = nn.Parameter(torch.zeros(top, dout))
            self.scale_b = nn.Parameter(torch.zeros(dout))
        elif cov_type == "tril":
            self.tril_diag = nn.Parameter(torch.zeros(dout))
            self.tril_off = nn.Parameter(torch.zeros(n_off))
        elif cov_type == "tril_head":
            self.tril_diag_w = nn.Parameter(torch.zeros(top, dout))
            self.tril_diag_b = nn.Parameter(torch.zeros(dout))
            self.tril_off_w = nn.Parameter(torch.zeros(top, n_off))
            self.tril_off_b = nn.Parameter(torch.zeros(n_off))

    def layers(self):
        return list(zip(self.weights, self.biases))

    def chol(self, sigma_min: float):
        """The constant Cholesky factor [dout, dout] of a "tril" head."""
        return tril_from_raw(self.tril_diag, self.tril_off, sigma_min)


class KnownTransition(nn.Module):
    """The learned part of a known-dynamics transition (smc.transition =
    "known"): f's mean is the true stepper, plus u_t·ctrl_w with controls
    (di > 0, zero at init), and its diagonal noise scale is learned."""

    def __init__(self, dx: int, di: int):
        super().__init__()
        self.raw_scale = nn.Parameter(torch.zeros(dx))
        if di:
            self.ctrl_w = nn.Parameter(torch.zeros(di, dx))


class GRU(nn.Module):
    """The reference's GRU cell: the update gate z, the reset gate r and the
    candidate h̃, each a dense map on [x; h] with W [din + dh, dh] and b [dh]
    (`psvo_tpu/networks.py:109-133`)."""

    def __init__(self, din: int, dh: int):
        super().__init__()
        for g in ("z", "r", "h"):
            setattr(self, f"{g}_w", nn.Parameter(torch.zeros(din + dh, dh)))
            setattr(self, f"{g}_b", nn.Parameter(torch.zeros(dh)))

    def gates(self):
        """{"z": (W, b), "r": (W, b), "h": (W, b)}, the reference's layout."""
        return {g: (getattr(self, f"{g}_w"), getattr(self, f"{g}_b")) for g in ("z", "r", "h")}


def init_gru(generator: torch.Generator, din: int, dh: int) -> GRU:
    """The reference's `init_gru`: each gate's weight Glorot-uniform on
    [din + dh, dh], its bias zero (the draws from `generator`, so the bits
    differ from jax.random's)."""
    cell = GRU(din, dh)
    with torch.no_grad():
        for w, b in cell.gates().values():
            _glorot_(w, generator)
            b.zero_()
    return cell


def gru_step(cell: GRU, h, x):
    """One GRU update h' = (1 − z)·h + z·h̃ with z = σ([x; h]·W_z + b_z),
    r = σ([x; h]·W_r + b_r) and h̃ = tanh([x; r·h]·W_h + b_h): h [..., H],
    x [..., Din] -> [..., H] (the reference's `gru_step`)."""
    hx = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(hx @ cell.z_w + cell.z_b)
    r = torch.sigmoid(hx @ cell.r_w + cell.r_b)
    h_cand = torch.tanh(torch.cat([x, r * h], dim=-1) @ cell.h_w + cell.h_b)
    return (1.0 - z) * h + z * h_cand


def _glorot_(w: torch.Tensor, generator) -> None:
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float32)
    w.copy_(u * (2.0 * limit) - limit)


def raw_scale_init(sigma_init: float, sigma_min: float) -> float:
    """raw with softplus(raw) + sigma_min == sigma_init."""
    return math.log(math.expm1(max(sigma_init - sigma_min, 1e-6)))


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
    biases; the scale leaves start at sigma_init (a state-dependent head with
    its weights at 0.01 × Glorot and sigma_init's raw value in its bias; a
    "tril" factor diagonal, its off-diagonal entries 0). The draws come from
    `generator` (a CPU generator), so the bits differ from jax.random's."""
    head = MLPHead(din, dout, hidden, cov_type)
    raw = raw_scale_init(sigma_init, sigma_min)
    with torch.no_grad():
        for w, b in head.layers():
            _glorot_(w, generator)
            b.zero_()
        _glorot_(head.mean_w, generator)
        head.mean_b.zero_()
        if cov_type == "const":
            head.raw_scale.fill_(raw)
        elif cov_type == "head":
            _glorot_(head.scale_w, generator)
            head.scale_w.mul_(0.01)
            head.scale_b.fill_(raw)
        elif cov_type == "tril":
            head.tril_diag.fill_(raw)
            head.tril_off.zero_()
        elif cov_type == "tril_head":
            _glorot_(head.tril_diag_w, generator)
            head.tril_diag_w.mul_(0.01)
            head.tril_diag_b.fill_(raw)
            if head.tril_off_w.numel():
                _glorot_(head.tril_off_w, generator)
                head.tril_off_w.mul_(0.01)
            head.tril_off_b.zero_()
    return head


def mlp_features(head: MLPHead, x, activation: str = "relu"):
    act = _ACTIVATIONS[activation]
    h = x
    for w, b in head.layers():
        h = act(h @ w + b)
    return h


def mlp_mean(head: MLPHead, x, activation: str = "relu"):
    """Feature-last mean: [..., Din] -> [..., Dout]."""
    return mlp_features(head, x, activation) @ head.mean_w + head.mean_b


def _scale(head: MLPHead, h, sigma_min: float, dense):
    """The diagonal scale of a "const" or "head" head on trunk features h."""
    if head.cov_type == "const":
        return scale_from_raw(head.raw_scale, sigma_min)
    if head.cov_type == "head":
        return scale_from_raw(dense(h, head.scale_w, head.scale_b), sigma_min)
    raise ValueError(f"network has no diagonal scale (cov_type={head.cov_type!r})")


def mlp_mean_scale(head: MLPHead, x, activation: str = "relu", sigma_min: float = 1e-3):
    """Feature-last (mean, scale): [..., Din] -> 2x [..., Dout]."""
    h = mlp_features(head, x, activation)
    mean = h @ head.mean_w + head.mean_b
    scale = _scale(head, h, sigma_min, lambda a, w, b: a @ w + b)
    return mean, scale.expand(mean.shape)


def mlp_mean_tril(head: MLPHead, x, activation: str = "relu", sigma_min: float = 1e-3):
    """Feature-last "tril_head": [..., Din] -> (mean [..., D], chol
    [..., D, D]) with the floored-softplus diagonal and the free strict-lower
    entries."""
    h = mlp_features(head, x, activation)
    mean = h @ head.mean_w + head.mean_b
    d = mean.shape[-1]
    diag = scale_from_raw(h @ head.tril_diag_w + head.tril_diag_b, sigma_min)
    chol = torch.diag_embed(diag)
    if d > 1:
        chol = _set_off(chol, h @ head.tril_off_w + head.tril_off_b)
    return mean, chol


def _set_off(chol, off):
    """chol [..., D, D] with its strict lower triangle set to off
    [..., D(D−1)/2] (row-major), out of place."""
    d = chol.shape[-1]
    rows, cols = _tril_rows_cols(d)
    flat = chol.reshape(*chol.shape[:-2], d * d)
    index = (rows * d + cols).to(chol.device)
    flat = flat.index_copy(-1, index, off)
    return flat.reshape(chol.shape)


def _dense_cm(h, w, b):
    """One dense layer over the channel axis: [..., Din, K] -> [..., Dout, K]."""
    return torch.einsum("de,...dk->...ek", w, h) + b[:, None]


def mlp_features_cm(head: MLPHead, x, activation: str = "relu"):
    act = _ACTIVATIONS[activation]
    h = x
    for w, b in head.layers():
        h = act(_dense_cm(h, w, b))
    return h


def mlp_mean_cm(head: MLPHead, x, activation: str = "relu"):
    """Channel-major mean: [..., Din, K] -> [..., Dout, K]."""
    return _dense_cm(mlp_features_cm(head, x, activation), head.mean_w, head.mean_b)


def mlp_mean_scale_cm(
    head: MLPHead, x, activation: str = "relu", sigma_min: float = 1e-3
):
    """Channel-major (mean, scale): [..., Din, K] -> 2x [..., Dout, K]."""
    h = mlp_features_cm(head, x, activation)
    mean = _dense_cm(h, head.mean_w, head.mean_b)
    if head.cov_type == "const":
        scale = scale_from_raw(head.raw_scale, sigma_min)[:, None]
    else:
        scale = _scale(head, h, sigma_min, _dense_cm)
    return mean, scale.expand(mean.shape)


def mlp_mean_tril_cm(head: MLPHead, x, activation: str = "relu", sigma_min: float = 1e-3):
    """Channel-major "tril_head": [..., Din, K] -> (mean [..., D, K], diag
    [..., D, K], off [..., D(D−1)/2, K]); the factor stays packed."""
    h = mlp_features_cm(head, x, activation)
    mean = _dense_cm(h, head.mean_w, head.mean_b)
    diag = scale_from_raw(_dense_cm(h, head.tril_diag_w, head.tril_diag_b), sigma_min)
    off = _dense_cm(h, head.tril_off_w, head.tril_off_b)
    return mean, diag, off
