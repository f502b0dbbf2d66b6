"""The per-step trunk kernel and its plain version (counterpart of
`psvo_tpu/ops/pallas_trunk.py`, forward).

Configurations whose state is too wide for the whole-scan kernel K1 (the
Lorenz-96 preset: Dx = Dy = 40) filter step by step: the resample runs
through the large-K kernels (`ops/resample_gather.py`), then one launch of

- K9 `trunk_forward` (replaces `pallas_trunk._tr_fwd`, `csrc/trunk_forward.cu`):
  the q1 and f trunks on the resampled particles, the fused draw
  x_new = cq·m1 + aq + sq·ε, the g trunk on x_new and
  α = −½Σ(z_f² − ε² + z_g²) + ab floored at −3e30, for one step. Plain
  version: `trunk_forward_reference`, `fused_step._propose_weight` plus the
  floor. The operands are K1's: `fused_step.prepare`'s packed weights and
  `sconst`, and one step's row of `fused_step.pack_coef`.

ε comes as a stream [B, Dx, K] or is drawn in the kernel from a two-word
seed and the step t, with K2's counter layout: `fused_step.stream_noise`
extracts exactly what the kernel drew. The wrapper launches the kernel for
CUDA tensors and runs the plain version for CPU tensors; it counts its
launches (`trunk_forward.launches`), the plain version its calls. The
kernel has no backward yet: on the card it refuses inputs that need a
gradient.
"""

from __future__ import annotations

import torch

from psvo_tpu_torch.ops import _build, fused_step, resample_gather
from psvo_tpu_torch.ops.fused_step import SMEM_LIMIT, _ptr, _require

TRUNK_DIMS = ((40, 40),)  # (Dx, Dy) instantiated: Lorenz-96
HIDDEN_WIDTHS = (16, 32, 64)  # trunk widths instantiated
TILE = 64  # particles per tile of the kernel
_PARTS = 4  # threads summing one particle's α


def _net_floats(din: int, h: int, n_mid: int, dout: int) -> int:
    """One net's floats in fused_step.prepare's buffer, padded to 4."""
    n = din * h + h + n_mid * (h * h + h) + h * dout + dout
    return n + (-n) % 4


def smem_bytes(dx: int, dy: int, h: int, n_mid: int) -> int:
    """Dynamic shared memory of K9 (csrc/trunk_forward.cu::launch_trunk): the
    three nets' weights, the [rows][TILE] tiles (x_res / g's mean, q1's mean
    / x_new, f's mean, ε, two hidden layers, the α partial sums) and one
    row's coefficients."""
    n_w = 2 * _net_floats(dx, h, n_mid, dx) + _net_floats(dx, h, n_mid, dy)
    nc = 3 * dx + dy + 1
    return 4 * (n_w + (max(dx, dy) + 3 * dx + 2 * h + _PARTS) * TILE + nc + (-nc) % 4)


def usable(ssm, cfg) -> bool:
    """Whether (ssm, smc-config) is in the trunk kernels' class: systematic
    resampling at every step, stop-gradient FIVO, relu q1/f/g trunks of one
    uniform instantiated width, an instantiated (Dx, Dy), K that K7 holds
    and K9 tiles, and the weights and tiles in one CTA's shared memory."""
    k = cfg.n_particles
    hidden = ssm.nets["q1"].hidden
    nets = [ssm.nets[n] for n in ("q1", "f", "g")]
    return (
        cfg.resampling == "systematic"
        and cfg.ess_threshold >= 1.0
        and cfg.use_stop_gradient
        and (ssm.dx, ssm.dy) in TRUNK_DIMS
        and k % TILE == 0
        and resample_gather.k_ok(k)
        and len(hidden) >= 1
        and hidden[0] in HIDDEN_WIDTHS
        and all(h == hidden[0] for h in hidden)
        and all(nc.hidden == hidden and nc.activation == "relu" for nc in nets)
        and smem_bytes(ssm.dx, ssm.dy, hidden[0], len(hidden) - 1) <= SMEM_LIMIT
    )


def _split_coef(coef_t, dx: int, dy: int):
    """aq, cq, sq [B, Dx, 1], y [B, Dy, 1] and ab [B, 1] of one pack_coef row."""
    aq, cq, sq = (coef_t[:, i * dx:(i + 1) * dx, None] for i in range(3))
    return aq, cq, sq, coef_t[:, 3 * dx:3 * dx + dy, None], coef_t[:, -1:]


def trunk_forward_reference(x_res, coef_t, consts, eps):
    """Plain version of K9: x_res [B, Dx, K], coef_t [B, 3·Dx + Dy + 1],
    eps [B, Dx, K] -> (x_new [B, Dx, K], α [B, K] floored at −3e30)."""
    trunk_forward_reference.calls += 1
    dx, dy = consts["dx"], consts["dy"]
    q1, f, g = fused_step._unpack_nets(consts)
    sfi = consts["sconst"][:dx, None]
    sgi = consts["sconst"][dx:, None]
    x_new, alpha = fused_step._propose_weight(q1, f, g, x_res, eps, *_split_coef(coef_t, dx, dy),
                                              sfi, sgi)
    return x_new, torch.clamp(alpha, min=-3e30)


trunk_forward_reference.calls = 0


def trunk_forward(x_res, coef_t, consts, *, eps=None, seed=None, t: int = 0):
    """K9: one step of the trunk path after the resample. Noise either as the
    stream eps [B, Dx, K] or drawn in the kernel from `seed` (two uint32
    words) at step t, as K2 extracts it. CPU tensors run the plain version
    (in-kernel RNG replayed through K2's plain version); CUDA tensors launch
    the kernel."""
    if (seed is None) == (eps is None):
        raise ValueError("trunk_forward: pass either eps or seed")
    batch, dx, k = x_res.shape
    if x_res.device.type == "cpu":
        if seed is not None:
            eps = fused_step.stream_noise_reference(seed, 1, batch, dx, k, x_res.device, t0=t)[0][0]
        return trunk_forward_reference(x_res, coef_t, consts, eps)
    if x_res.device.type != "cuda":
        raise ValueError(f"trunk_forward: unsupported device {x_res.device}")
    if torch.is_grad_enabled() and any(
        v.requires_grad for v in (x_res, coef_t, consts["packed"], consts["sconst"])
    ):
        raise RuntimeError("trunk_forward records no gradient (its backward kernel is not "
                           "written yet); call it under torch.no_grad()")
    dy, h, n_mid = consts["dy"], consts["hidden"], consts["n_mid"]
    dev = x_res.device
    if ((dx, dy) not in TRUNK_DIMS or h not in HIDDEN_WIDTHS or k % TILE
            or smem_bytes(dx, dy, h, n_mid) > SMEM_LIMIT):
        raise ValueError(f"trunk_forward: no kernel for Dx={dx}, Dy={dy}, hidden={h}, "
                         f"{n_mid} middle layers, K={k}")
    _require(x_res, (batch, dx, k), "x_res", dev)
    _require(coef_t, (batch, 3 * dx + dy + 1), "coef_t", dev)
    _require(consts["packed"], consts["packed"].shape, "weights", dev)
    _require(consts["sconst"], (dx + dy,), "sconst", dev)
    if seed is None:
        _require(eps, (batch, dx, k), "eps", dev)
    for name, v in (("x_res", x_res), ("eps", eps), ("weights", consts["packed"])):
        if v is not None and v.data_ptr() % 16:
            raise ValueError(f"trunk_forward: {name} is not 16-byte aligned")
    x_new = torch.empty_like(x_res)
    alpha = torch.empty((batch, k), dtype=torch.float32, device=dev)
    seed0, seed1 = (0, 0) if seed is None else seed
    lib = _build.load_library()
    _, off_f, off_g = consts["offsets"]  # q1 sits at offset 0
    err = lib.psvo_trunk_forward(
        x_res.data_ptr(), _ptr(eps), coef_t.data_ptr(), consts["packed"].data_ptr(),
        consts["sconst"].data_ptr(), x_new.data_ptr(), alpha.data_ptr(), seed0, seed1,
        int(seed is not None), t, batch, k, dx, dy, h, n_mid, consts["packed"].numel(), off_f,
        off_g, torch.cuda.current_stream(dev).cuda_stream,
    )
    trunk_forward.launches += 1
    _build.check(lib, err, "trunk_forward")
    return x_new, alpha


trunk_forward.launches = 0
