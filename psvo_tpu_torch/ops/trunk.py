"""The per-step trunk kernel, its VJP and their plain versions (counterpart
of `psvo_tpu/ops/pallas_trunk.py`).

Configurations whose state is too wide for the whole-scan kernel K1 (the
Lorenz-96 preset: Dx = Dy = 40) filter step by step: the resample runs
through the large-K kernels (`ops/resample_gather.py`), then one launch of

- K9 `trunk_forward` (replaces `pallas_trunk._tr_fwd`, `csrc/trunk_forward.cu`):
  the q1 and f trunks on the resampled particles, the fused draw
  x_new = cq·m1 + aq + sq·ε, the g trunk on x_new and
  α = −½Σ(z_f² − ε² + z_g²) + ab floored at −3e30, for one step. Plain
  version: `trunk_forward_reference`, `fused_step._propose_weight` plus the
  floor. The operands are K1's: `fused_step.prepare`'s packed weights and
  `sconst`, and one step's row of `fused_step.pack_coef`. Two designs, with
  the same bits; the paths run "async" (512 threads a CTA: 8 warps run the
  nets, q1 and f layer by layer side by side in 8 x 4 register blocks, while
  the other 8 load the next tile's coefficients and draw its ε; the next
  tile's x_res and streamed ε copied in while the current one computes;
  `k9_plan` leaves out what does not fit); "tile" (256 threads, the previous
  design) stays callable with `design="tile"` as its yardstick.
- K10 `trunk_backward` (replaces `pallas_trunk._tr_bwd`,
  `csrc/trunk_backward.cu`): the VJP of K9 from its inputs and x_new —
  recompute the trunks and α, cut dα where the floor clamped, backprop g, q1
  and f — giving d x_res, the step's d_coef row (zero for y), the packed
  weight gradients and d_sconst. Plain version: `trunk_backward_reference`,
  an autograd replay of the plain forward. Its backward products run on the
  tensor cores in 3xTF32 (`csrc/mma_tf32.cuh`), 512 threads a CTA; the
  previous design, every product on the fp32 cores, stays callable with
  `design="simt"` as its yardstick.

`TrunkForward` joins K9 and K10 as one `torch.autograd.Function`, the
counterpart of `pallas_trunk.trunk_call`'s custom VJP; `trunk_forward` goes
through it when autograd records. Its residuals are x_res and x_new in
float32 (the reference's bf16 residuals were a TPU bandwidth means).

ε comes as a stream [B, Dx, K] or is drawn in the kernel from a two-word
seed and the step t, with K2's counter layout: `fused_step.stream_noise`
extracts exactly what the kernel drew. The wrapper launches the kernel for
CUDA tensors and runs the plain version for CPU tensors; each wrapper
counts its launches (`<wrapper>.launches`, by design `.launches_by_design`),
each plain version its calls.
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


K9_DESIGNS = ("async", "tile")  # K9's designs: the one the paths run, the previous one
K9_PLANS = ((True, True), (True, False), (False, True), (False, False))  # (pair, prefetch)


def k9_smem_bytes(dx: int, dy: int, h: int, n_mid: int, pair: bool = True,
                  prefetch: bool = True) -> int:
    """Dynamic shared memory of K9's async design (csrc/trunk_forward.cu::
    async_smem_floats): the tile design's (`smem_bytes`), plus with `pair`
    f's two hidden layers, plus with `prefetch` a second ε tile, a second
    row of coefficients and, unless f's spare hidden layer is wide enough
    for it (pair, h >= Dy), a tile for g's mean."""
    own_gm = prefetch and not (pair and h >= dy)
    extra = (2 * h if pair else 0) + (dx if prefetch else 0) + (dy if own_gm else 0)
    nc = 3 * dx + dy + 1
    return smem_bytes(dx, dy, h, n_mid) + 4 * (extra * TILE + (nc + (-nc) % 4 if prefetch else 0))


def k9_plan(dx: int, dy: int, h: int, n_mid: int) -> tuple[bool, bool]:
    """(pair, prefetch) of K9's async design: the first of `K9_PLANS` whose
    shared memory fits a CTA. (False, False) is the tile design's layout, so
    every shape in `usable`'s class has a plan."""
    return next((pl for pl in K9_PLANS if k9_smem_bytes(dx, dy, h, n_mid, *pl) <= SMEM_LIMIT),
                (False, False))


DESIGNS = ("tf32x3", "simt")  # K10's designs: the tensor-core one, the previous one


def _net_floats_padded(din: int, h: int, n_mid: int, dout: int) -> int:
    """One net's floats in K10's shared memory (csrc/trunk_backward.cu::
    padded_net): every weight row padded by 4 floats, padded to 4."""
    n = din * (h + 4) + h + n_mid * (h * (h + 4) + h) + h * (dout + 4) + dout
    return n + (-n) % 4


def k10_smem_bytes(dx: int, dy: int, h: int, n_mid: int, design: str = "tf32x3") -> int:
    """Dynamic shared memory of K10 (csrc/trunk_backward.cu::
    launch_trunk_backward): the three nets' weights (rows padded by 4 floats
    in the tf32x3 design), six tiles (x_res, x_new, ε, f's mean, g's mean,
    d x_new) and one net's n_mid + 1 hidden layers at a row stride of 72
    floats (68 in the simt design), the α partial sums, dα and one row's
    coefficients."""
    if design == "tf32x3":
        n_w = 2 * _net_floats_padded(dx, h, n_mid, dx) + _net_floats_padded(dx, h, n_mid, dy)
        stride = TILE + 8
    elif design == "simt":
        n_w = 2 * _net_floats(dx, h, n_mid, dx) + _net_floats(dx, h, n_mid, dy)
        stride = TILE + 4
    else:
        raise ValueError(f"K10 has no design {design!r} (one of {DESIGNS})")
    nc = 3 * dx + dy + 1
    rows = 5 * dx + max(dx, dy) + (n_mid + 1) * h
    return 4 * (n_w + rows * stride + (_PARTS + 1) * TILE + nc + (-nc) % 4)


def k10_ok(dx: int, dy: int, h: int, n_mid: int, k: int, design: str = "tf32x3") -> bool:
    """Whether K10 is instantiated for the shape: K9's dims and widths, K a
    multiple of 64, its shared memory in one CTA."""
    return ((dx, dy) in TRUNK_DIMS and h in HIDDEN_WIDTHS and k % TILE == 0
            and k10_smem_bytes(dx, dy, h, n_mid, design) <= SMEM_LIMIT)


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


def _trunk_math(x_res, coef_t, consts, eps, x_new_value=None):
    """The plain step: (x_new, α floored at −3e30), differentiable; with
    x_new_value the draw takes that value (see fused_step._propose_weight)."""
    dx, dy = consts["dx"], consts["dy"]
    q1, f, g = fused_step._unpack_nets(consts)
    sfi = consts["sconst"][:dx, None]
    sgi = consts["sconst"][dx:, None]
    x_new, alpha = fused_step._propose_weight(q1, f, g, x_res, eps, *_split_coef(coef_t, dx, dy),
                                              sfi, sgi, x_new_value)
    return x_new, torch.clamp(alpha, min=-3e30)


def trunk_forward_reference(x_res, coef_t, consts, eps):
    """Plain version of K9: x_res [B, Dx, K], coef_t [B, 3·Dx + Dy + 1],
    eps [B, Dx, K] -> (x_new [B, Dx, K], α [B, K] floored at −3e30)."""
    trunk_forward_reference.calls += 1
    return _trunk_math(x_res, coef_t, consts, eps)


trunk_forward_reference.calls = 0


def _step_eps(seed, t, batch, dx, k, device):
    """The ε that K9 draws from `seed` at step t, through K2's plain version."""
    return fused_step.stream_noise_reference(seed, 1, batch, dx, k, device, t0=t)[0][0]


def trunk_forward(x_res, coef_t, consts, *, eps=None, seed=None, t: int = 0,
                  design: str = "async"):
    """K9: one step of the trunk path after the resample. Noise either as the
    stream eps [B, Dx, K] or drawn in the kernel from `seed` (two uint32
    words) at step t, as K2 extracts it. CPU tensors run the plain version
    (in-kernel RNG replayed through K2's plain version); CUDA tensors launch
    the kernel of `design` ("async", the default and the only one the paths
    run; "tile", the previous design, kept as its yardstick: the same bits).
    When autograd records, through `TrunkForward` (K10 its backward)."""
    if (seed is None) == (eps is None):
        raise ValueError("trunk_forward: pass either eps or seed")
    if design not in K9_DESIGNS:
        raise ValueError(f"trunk_forward: no design {design!r} (one of {K9_DESIGNS})")
    if torch.is_grad_enabled() and any(
        v.requires_grad for v in (x_res, coef_t, consts["packed"], consts["sconst"])
    ):
        return TrunkForward.apply(x_res, coef_t, consts["packed"], consts["sconst"], consts,
                                  eps, seed, t, design)
    batch, dx, k = x_res.shape
    if x_res.device.type == "cpu":
        if seed is not None:
            eps = _step_eps(seed, t, batch, dx, k, x_res.device)
        return trunk_forward_reference(x_res, coef_t, consts, eps)
    if x_res.device.type != "cuda":
        raise ValueError(f"trunk_forward: unsupported device {x_res.device}")
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
    pair, prefetch = k9_plan(dx, dy, h, n_mid) if design == "async" else (False, False)
    lib = _build.load_library()
    _, off_f, off_g = consts["offsets"]  # q1 sits at offset 0
    err = lib.psvo_trunk_forward(
        x_res.data_ptr(), _ptr(eps), coef_t.data_ptr(), consts["packed"].data_ptr(),
        consts["sconst"].data_ptr(), x_new.data_ptr(), alpha.data_ptr(), seed0, seed1,
        int(seed is not None), t, batch, k, dx, dy, h, n_mid, consts["packed"].numel(), off_f,
        off_g, K9_DESIGNS.index(design), int(pair), int(prefetch),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    trunk_forward.launches += 1
    trunk_forward.launches_by_design[design] += 1
    _build.check(lib, err, "trunk_forward")
    return x_new, alpha


trunk_forward.launches = 0
trunk_forward.launches_by_design = dict.fromkeys(K9_DESIGNS, 0)  # which kernel the launches ran


def trunk_backward_reference(x_res, x_new, coef_t, consts, eps, d_x_new, d_alpha):
    """Plain version of K10: replay the plain forward from x_res under
    autograd, with the draw taking K9's saved x_new as its value, and
    backpropagate the cotangents of x_new and α (the contract of
    `pallas_trunk._tr_bwd`, which reads x_new as a residual): the α cotangent
    is cut where the unfloored α < −3e30 (the gradient of torch.clamp); y
    (coef columns 3·Dx .. 3·Dx + Dy) and ε get none. Returns (d_x_res,
    d_coef_t, d_packed, d_sconst)."""
    trunk_backward_reference.calls += 1
    dx, dy = consts["dx"], consts["dy"]
    with torch.enable_grad():
        leaves = [v.detach().requires_grad_() for v in
                  (x_res, coef_t, consts["packed"], consts["sconst"])]
        x_res_, coef_, packed, sconst = leaves
        y_cols = torch.zeros_like(coef_, dtype=torch.bool)
        y_cols[:, 3 * dx:3 * dx + dy] = True
        coef_ = torch.where(y_cols, coef_.detach(), coef_)  # y is data
        outs = _trunk_math(x_res_, coef_, dict(consts, packed=packed, sconst=sconst), eps,
                           x_new.detach())
        grads = torch.autograd.grad(outs, leaves, (d_x_new, d_alpha), allow_unused=True)
    return tuple(torch.zeros_like(v) if gr is None else gr for gr, v in zip(grads, leaves))


trunk_backward_reference.calls = 0


def trunk_backward(x_res, x_new, coef_t, consts, d_x_new, d_alpha, *, eps=None, seed=None,
                   t: int = 0, design: str = "tf32x3"):
    """K10: the VJP of K9 for one step. Takes K9's inputs (x_res, coef_t,
    consts and the noise: eps [B, Dx, K] or the `seed` and step t it drew
    from), its output x_new and the cotangents d_x_new [B, Dx, K] and d_alpha
    [B, K]. Returns (d_x_res [B, Dx, K], d_coef_t [B, 3·Dx + Dy + 1],
    d_packed [n_w], d_sconst [Dx + Dy]) as `trunk_backward_reference`, which
    CPU tensors run (in-kernel RNG replayed through K2's plain version);
    CUDA tensors launch the kernel of `design` ("tf32x3", the default and
    the only one the main path runs; "simt", the previous design, kept as
    its yardstick), or raise for a shape it is not instantiated for."""
    if (seed is None) == (eps is None):
        raise ValueError("trunk_backward: pass either eps or seed")
    if design not in DESIGNS:
        raise ValueError(f"trunk_backward: no design {design!r} (one of {DESIGNS})")
    batch, dx, k = x_res.shape
    if x_res.device.type == "cpu":
        if seed is not None:
            eps = _step_eps(seed, t, batch, dx, k, x_res.device)
        return trunk_backward_reference(x_res, x_new, coef_t, consts, eps, d_x_new, d_alpha)
    if x_res.device.type != "cuda":
        raise ValueError(f"trunk_backward: unsupported device {x_res.device}")
    dy, h, n_mid = consts["dy"], consts["hidden"], consts["n_mid"]
    dev = x_res.device
    if not k10_ok(dx, dy, h, n_mid, k, design):
        raise ValueError(f"trunk_backward: no {design} kernel for Dx={dx}, Dy={dy}, hidden={h}, "
                         f"{n_mid} middle layers, K={k} "
                         f"({k10_smem_bytes(dx, dy, h, n_mid, design)} B of shared memory, at "
                         f"most {SMEM_LIMIT})")
    packed = consts["packed"]
    n_w = packed.numel()
    _require(x_res, (batch, dx, k), "x_res", dev)
    _require(x_new, (batch, dx, k), "x_new", dev)
    _require(coef_t, (batch, 3 * dx + dy + 1), "coef_t", dev)
    _require(packed, (n_w,), "weights", dev)
    _require(consts["sconst"], (dx + dy,), "sconst", dev)
    _require(d_x_new, (batch, dx, k), "d_x_new", dev)
    _require(d_alpha, (batch, k), "d_alpha", dev)
    if seed is None:
        _require(eps, (batch, dx, k), "eps", dev)
    for name, v in (("x_res", x_res), ("x_new", x_new), ("eps", eps), ("weights", packed)):
        if v is not None and v.data_ptr() % 16:
            raise ValueError(f"trunk_backward: {name} is not 16-byte aligned")
    f32 = dict(dtype=torch.float32, device=dev)
    max_ctas = torch.cuda.get_device_properties(dev).multi_processor_count
    d_x_res = torch.empty((batch, dx, k), **f32)
    d_coef = torch.empty(coef_t.shape, **f32)
    partial = torch.empty((max_ctas, n_w + dx + dy), **f32)
    coef_part = torch.empty((batch * (k // TILE), 3 * dx + 1), **f32)
    grads = torch.empty((n_w + dx + dy,), **f32)
    seed0, seed1 = (0, 0) if seed is None else seed
    lib = _build.load_library()
    _, off_f, off_g = consts["offsets"]
    err = lib.psvo_trunk_backward(
        x_res.data_ptr(), x_new.data_ptr(), _ptr(eps), coef_t.data_ptr(), packed.data_ptr(),
        consts["sconst"].data_ptr(), d_x_new.data_ptr(), d_alpha.data_ptr(), d_x_res.data_ptr(),
        partial.data_ptr(), coef_part.data_ptr(), grads.data_ptr(), d_coef.data_ptr(), seed0,
        seed1, int(seed is not None), t, batch, k, dx, dy, h, n_mid, n_w, off_f, off_g, max_ctas,
        DESIGNS.index(design), torch.cuda.current_stream(dev).cuda_stream,
    )
    trunk_backward.launches += 1
    trunk_backward.launches_by_design[design] += 1
    _build.check(lib, err, "trunk_backward")
    return d_x_res, d_coef, grads[:n_w], grads[n_w:]


trunk_backward.launches = 0
trunk_backward.launches_by_design = dict.fromkeys(DESIGNS, 0)  # which kernel the launches ran


class TrunkForward(torch.autograd.Function):
    """`trunk_forward` with `trunk_backward` as its VJP: the counterpart of
    `pallas_trunk.trunk_call`'s custom VJP.

    apply(x_res, coef_t, packed, sconst, consts, eps, seed, t, design)
    returns (x_new, α), `design` K9's. packed and sconst are
    consts["packed"] / consts["sconst"], passed apart so autograd sees them.
    The forward saves x_res and x_new in float32, coef_t, the weights and
    eps (or the seed and t it drew from); ε gets no gradient.
    """

    @staticmethod
    def forward(ctx, x_res, coef_t, packed, sconst, consts, eps, seed, t, design="async"):
        consts = dict(consts, packed=packed, sconst=sconst)
        batch, dx, k = x_res.shape
        if x_res.is_cuda and not k10_ok(dx, consts["dy"], consts["hidden"], consts["n_mid"], k):
            raise ValueError("TrunkForward: this configuration has no backward kernel "
                             "(trunk.trunk_backward)")
        x_new, alpha = trunk_forward(x_res, coef_t, consts, eps=eps, seed=seed, t=t, design=design)
        ctx.save_for_backward(x_res, x_new, coef_t, packed, sconst, eps)
        ctx.static = {key: v for key, v in consts.items() if not torch.is_tensor(v)}
        ctx.seed, ctx.t = seed, t
        ctx.set_materialize_grads(False)
        return x_new, alpha

    @staticmethod
    def backward(ctx, d_x_new, d_alpha):
        x_res, x_new, coef_t, packed, sconst, eps = ctx.saved_tensors
        consts = dict(ctx.static, packed=packed, sconst=sconst)
        d_x_new = torch.zeros_like(x_new) if d_x_new is None else d_x_new.contiguous()
        d_alpha = (torch.zeros(x_new.shape[0], x_new.shape[-1], dtype=x_new.dtype,
                               device=x_new.device) if d_alpha is None else d_alpha.contiguous())
        noise = {"seed": ctx.seed, "t": ctx.t} if ctx.seed is not None else {"eps": eps}
        d_x_res, d_coef, d_packed, d_sconst = trunk_backward(
            x_res, x_new, coef_t, consts, d_x_new, d_alpha, **noise)
        return d_x_res, d_coef, d_packed, d_sconst, None, None, None, None, None
