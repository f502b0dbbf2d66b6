"""The per-step trunk kernel, its VJP and their plain versions (counterpart
of `psvo_tpu/ops/pallas_trunk.py`).

The trunk class filters step by step: the resample runs through the
large-K kernels (`ops/resample_gather.py`), then one launch of K9. It serves
what the reference's trunk gate takes (`pallas_trunk.usable`): the wide
Lorenz-96 state (Dx = Dy = 40), and at the FHN and Lorenz-63 widths (2, 2)
and (3, 3) what the whole-scan class leaves to it — ESS-adaptive
resampling, no resampling (IWAE), the full FIVO gradient (its score term
taken outside the kernels, from K7's indices) — with or without controls.

- K9 `trunk_forward` (replaces `pallas_trunk._tr_fwd`, `csrc/trunk_forward.cuh`):
  the q1 and f trunks on the resampled particles, the fused draw
  x_new = cq·m1 + aq + sq·ε, the g trunk on x_new and
  α = −½Σ(z_f² − ε² + z_g²) + ab floored at −3e30, for one step. Plain
  version: `trunk_forward_reference`, `fused_step._propose_weight` plus the
  floor. The operands are K1's: `fused_step.prepare`'s packed weights and
  `sconst`, and one step's row of `fused_step.pack_coef`; with controls
  (di > 0) that row also carries u_t's first-layer terms of q1 and f
  (`fused_step.control_term`), which the kernel's control mode adds to
  those layers' bias. Two designs, with the same bits; the paths run
  "async" (512 threads a CTA: 8 warps run the nets, q1 and f layer by layer
  side by side in 8 x 4 register blocks, while the other 8 load the next
  tile's coefficients and draw its ε; the next tile's x_res and streamed ε
  copied in while the current one computes; `k9_plan` leaves out what does
  not fit); "tile" (256 threads, the previous design) stays callable with
  `design="tile"` as its yardstick (uncontrolled only).
- K10 `trunk_backward` (replaces `pallas_trunk._tr_bwd`,
  `csrc/trunk_backward.cuh`): the VJP of K9 from its inputs and x_new —
  recompute the trunks and α, cut dα where the floor clamped, backprop g, q1
  and f — giving d x_res, the step's d_coef row (zero for y; with controls
  the per-row sums of q1's and f's first-layer cotangents in the control
  columns), the packed weight gradients and d_sconst. Plain version:
  `trunk_backward_reference`, an autograd replay of the plain forward. At
  Lorenz-96's width its backward products run on the tensor cores in 3xTF32
  (`csrc/mma_tf32.cuh`), 512 threads a CTA ("tf32x3"); the previous design,
  every product on the fp32 cores ("simt"), stays callable as its yardstick
  and is the design of the small widths, whose first and last layers (2 or
  3 wide) do not tile m16n8k8 (`k10_design`).

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

import functools

import torch

from psvo_tpu_torch.ops import _build, fused_step
from psvo_tpu_torch.ops.fused_step import SMEM_LIMIT, _ptr, _require

TRUNK_DIMS = ((2, 2), (3, 3), (40, 40))  # (Dx, Dy) in the kernels' library: FHN, L63, L96
K10_TF32_DIMS = ((40, 40),)  # (Dx, Dy) of K10's tensor-core design
HIDDEN_WIDTHS = (16, 32, 64)  # trunk widths in the kernels' library
MAX_WIDTH = 64  # the widest trunk of the class (widths 8..64 in steps of 8)
_REF_MAX_ROWS = 55  # max(Dx + Di, Dy) + 1 <= pallas_trunk.MAX_PD = 56 rows
WEIGHT_PLACES = ("smem", "stream")  # where K9 or K10 keeps the nets: shared or device memory
TILE = 64  # particles per tile of the kernel
_PARTS = 4  # threads summing one particle's α


def _net_floats(din: int, h: int, n_mid: int, dout: int) -> int:
    """One net's floats in fused_step.prepare's buffer, padded to 4."""
    n = din * h + h + n_mid * (h * h + h) + h * dout + dout
    return n + (-n) % 4


def smem_bytes(dx: int, dy: int, h: int, n_mid: int, stream: bool = False) -> int:
    """Dynamic shared memory of K9 (csrc/trunk_forward.cuh::launch_trunk): the
    three nets' weights (none with `stream`: they stay in device memory), the
    [rows][TILE] tiles (x_res / g's mean, q1's mean / x_new, f's mean, ε, two
    hidden layers, the α partial sums) and one row's coefficients."""
    n_w = 0 if stream else 2 * _net_floats(dx, h, n_mid, dx) + _net_floats(dx, h, n_mid, dy)
    nc = 3 * dx + dy + 1
    return 4 * (n_w + (max(dx, dy) + 3 * dx + 2 * h + _PARTS) * TILE + nc + (-nc) % 4)


K9_DESIGNS = ("async", "tile")  # K9's designs: the one the paths run, the previous one
K9_PLANS = ((True, True), (True, False), (False, True), (False, False))  # (pair, prefetch)


def k9_smem_bytes(dx: int, dy: int, h: int, n_mid: int, pair: bool = True,
                  prefetch: bool = True, stream: bool = False) -> int:
    """Dynamic shared memory of K9's async design (csrc/trunk_forward.cuh::
    async_smem_floats): the tile design's (`smem_bytes`, its weights left
    out with `stream`), plus with `pair` f's two hidden layers, plus with
    `prefetch` a second ε tile, a second row of coefficients and, unless
    f's spare hidden layer is wide enough for it (pair, h >= Dy), a tile for
    g's mean."""
    own_gm = prefetch and not (pair and h >= dy)
    extra = (2 * h if pair else 0) + (dx if prefetch else 0) + (dy if own_gm else 0)
    nc = 3 * dx + dy + 1
    return (smem_bytes(dx, dy, h, n_mid, stream)
            + 4 * (extra * TILE + (nc + (-nc) % 4 if prefetch else 0)))


@functools.cache
def k9_weights(dx: int, dy: int, h: int, n_mid: int) -> str:
    """Where K9's async design keeps the three nets (`WEIGHT_PLACES`): in
    shared memory where they fit beside the tiles in some plan, else in
    device memory ("stream": L2-resident, the tiles alone in shared memory;
    at (40, 40) with three layers of 64, and at (55, 55) beyond two)."""
    smem = any(k9_smem_bytes(dx, dy, h, n_mid, *pl) <= SMEM_LIMIT for pl in K9_PLANS)
    return "smem" if smem else "stream"


@functools.cache
def k9_plan(dx: int, dy: int, h: int, n_mid: int) -> tuple[bool, bool]:
    """(pair, prefetch) of K9's async design: the first of `K9_PLANS` whose
    shared memory fits a CTA with the weights where `k9_weights` keeps them.
    (False, False) is the tile design's layout (`k9_fits` says whether even
    that fits)."""
    stream = k9_weights(dx, dy, h, n_mid) == "stream"
    return next((pl for pl in K9_PLANS
                 if k9_smem_bytes(dx, dy, h, n_mid, *pl, stream=stream) <= SMEM_LIMIT),
                (False, False))


@functools.cache
def k9_fits(dx: int, dy: int, h: int, n_mid: int) -> bool:
    """Whether K9 has a plan at the shape: its tiles fit a CTA with the
    weights in device memory (the weights' size never refuses a shape)."""
    return k9_smem_bytes(dx, dy, h, n_mid, False, False, stream=True) <= SMEM_LIMIT


DESIGNS = ("tf32x3", "simt")  # K10's designs: the tensor-core one, the previous one


@functools.cache
def k10_design(dx: int, dy: int, h: int | None = None, n_mid: int | None = None) -> str:
    """K10's design on the paths: the tensor-core one at Lorenz-96's width,
    at the library's widths (`HIDDEN_WIDTHS`) where its weights and tiles fit
    a CTA (at the width h and n_mid middle layers, when given: not at three
    layers of 64), the previous one
    everywhere else (the small widths' 2- and 3-wide first and last layers
    do not tile m16n8k8; a wider tensor-core class is a speed lead)."""
    if (dx, dy) not in K10_TF32_DIMS:
        return "simt"
    fits = h is None or (h in HIDDEN_WIDTHS
                         and k10_smem_bytes(dx, dy, h, n_mid, "tf32x3") <= SMEM_LIMIT)
    return "tf32x3" if fits else "simt"


def _net_floats_padded(din: int, h: int, n_mid: int, dout: int) -> int:
    """One net's floats in K10's shared memory (csrc/trunk_backward.cuh::
    padded_net): every weight row padded by 4 floats, padded to 4."""
    n = din * (h + 4) + h + n_mid * (h * (h + 4) + h) + h * (dout + 4) + dout
    return n + (-n) % 4


def k10_smem_bytes(dx: int, dy: int, h: int, n_mid: int, design: str = "tf32x3",
                   stream: bool = False) -> int:
    """Dynamic shared memory of K10 (csrc/trunk_backward.cuh::
    launch_trunk_backward): the three nets' weights (rows padded by 4 floats
    in the tf32x3 design; none in the simt design with `stream`: they stay in
    device memory), six tiles (x_res, x_new, ε, f's mean, g's mean, d x_new)
    and one net's n_mid + 1 hidden layers at a row stride of 72 floats (68
    in the simt design), the α partial sums, dα and one row's
    coefficients."""
    if design == "tf32x3" and not stream:
        n_w = 2 * _net_floats_padded(dx, h, n_mid, dx) + _net_floats_padded(dx, h, n_mid, dy)
        stride = TILE + 8
    elif design == "simt":
        n_w = 0 if stream else 2 * _net_floats(dx, h, n_mid, dx) + _net_floats(dx, h, n_mid, dy)
        stride = TILE + 4
    else:
        raise ValueError(f"K10 has no design {design!r} (one of {DESIGNS})")
    nc = 3 * dx + dy + 1
    rows = 5 * dx + max(dx, dy) + (n_mid + 1) * h
    return 4 * (n_w + rows * stride + (_PARTS + 1) * TILE + nc + (-nc) % 4)


@functools.cache
def k10_weights(dx: int, dy: int, h: int, n_mid: int, design: str | None = None) -> str:
    """Where K10 keeps the three nets (`WEIGHT_PLACES`): in shared memory
    where they fit beside its tiles, else (the simt design only) in device
    memory, L2-resident ("stream": at (48, 48) and (55, 55) with two layers
    of 64, and at 32 and up with three). design None: `k10_design`'s."""
    design = design or k10_design(dx, dy, h, n_mid)
    smem = k10_smem_bytes(dx, dy, h, n_mid, design) <= SMEM_LIMIT
    return "smem" if smem or design == "tf32x3" else "stream"


def width_ok(h: int) -> bool:
    """The trunk class's widths: 8 to 64 in steps of 8."""
    return h % 8 == 0 and 8 <= h <= MAX_WIDTH


@functools.cache
def k10_ok(dx: int, dy: int, h: int, n_mid: int, k: int, design: str | None = None) -> bool:
    """Whether K10 runs the shape: a width of the class, K a multiple of 64,
    its tiles (and, in shared memory, its weights: `k10_weights`) in one
    CTA; the tensor-core design at `K10_TF32_DIMS` alone. design None:
    `k10_design`'s."""
    design = design or k10_design(dx, dy, h, n_mid)
    if design == "tf32x3" and not ((dx, dy) in K10_TF32_DIMS and h in HIDDEN_WIDTHS):
        return False  # the kernels' library alone holds it
    stream = k10_weights(dx, dy, h, n_mid, design) == "stream"
    return (width_ok(h) and k % TILE == 0 and max(dx, dy) <= _REF_MAX_ROWS
            and k10_smem_bytes(dx, dy, h, n_mid, design, stream) <= SMEM_LIMIT)


@functools.cache
def shape_ok(dx: int, dy: int, h: int, n_mid: int) -> bool:
    """Whether K9 and K10 both have a plan at the shape (at any K that K9
    tiles): the width, and their tiles in one CTA. Outside it, a hole:
    widths above 64 and nets deeper than K10's streamed tiles hold (at
    (55, 55) and width 64, more than eight hidden layers)."""
    return (width_ok(h) and max(dx, dy) <= _REF_MAX_ROWS and k9_fits(dx, dy, h, n_mid)
            and k10_ok(dx, dy, h, n_mid, TILE))


def _prebuilt(dx: int, dy: int, h: int) -> bool:
    return (dx, dy) in TRUNK_DIMS and h in HIDDEN_WIDTHS


@functools.cache
def lib_key(dx: int, dy: int, h: int, n_mid: int, backward: bool):
    """None where the kernels' library holds the kernel at this shape (the
    presets' (Dx, Dy) and widths, weights in shared memory), else the trunk
    shape library's key ("trunk", dx, dy, h, K9's weights, K10's weights),
    the places' indices in `WEIGHT_PLACES` (`_build.load_shape_library`)."""
    w9 = WEIGHT_PLACES.index(k9_weights(dx, dy, h, n_mid))
    w10 = WEIGHT_PLACES.index(k10_weights(dx, dy, h, n_mid))
    if _prebuilt(dx, dy, h) and (w10 if backward else w9) == 0:
        return None
    return ("trunk", dx, dy, h, w9, w10)


def _library(key):
    return _build.load_library() if key is None else _build.load_shape_library(key)


def usable(ssm, cfg) -> bool:
    """Whether (ssm, smc-config) is in the trunk kernels' class: what the
    reference's trunk gate takes (`pallas_trunk.usable`) — systematic or
    multinomial resampling at every step or ESS-adaptive (K7 searches any
    sorted position stream, and the ESS test runs outside the kernels), no
    resampling (IWAE), the full FIVO gradient (its score term is taken
    outside the kernels, from K7's indices), controls (di > 0: u_t's
    first-layer terms of q1 and f ride in the coefficient rows, the
    reference's max(Dx + Di, Dy) + 1 <= 56 state rows), relu q1/f/g trunks of
    one uniform width from 8 to 64 in steps of 8, at every (Dx, Dy, Di) with
    max(Dx + Di, Dy) <= 55, K that K9 tiles (a multiple of 64; the
    resample takes any K, `resample_gather.resample_and_gather`), and the
    tiles of K9 and K10 in one CTA (`shape_ok`; the weights in shared memory
    where they fit, else in device memory). The presets' shapes are in the
    kernels' library, every other one is built into a shape library of its
    own at first use (`lib_key`). Not bootstrap mode, as the
    reference's gate: K9 draws from q1/q2 and weights by f, g and q; nor, as
    that gate, known dynamics, Poisson or Dirac emissions or a q1/f/g scale
    other than a constant diagonal (`fused_step.model_in_class`). The
    whole-scan class (`fused_step.usable`) goes first where it also takes a
    configuration."""
    k = cfg.n_particles
    hidden = ssm.nets["q1"].hidden
    nets = [ssm.nets[n] for n in ("q1", "f", "g")]
    return (
        not cfg.use_bootstrap
        and fused_step.model_in_class(ssm)
        and cfg.resampling in ("systematic", "multinomial", "none")
        and max(ssm.dx + ssm.di, ssm.dy) <= _REF_MAX_ROWS
        and k % TILE == 0
        and len(hidden) >= 1
        and all(h == hidden[0] for h in hidden)
        and all(nc.hidden == hidden and nc.activation == "relu" for nc in nets)
        and shape_ok(ssm.dx, ssm.dy, hidden[0], len(hidden) - 1)
    )


def _trunk_math(x_res, coef_t, consts, eps, x_new_value=None):
    """The plain step: (x_new, α floored at −3e30), differentiable; with
    x_new_value the draw takes that value (see fused_step._propose_weight).
    With controls the row's last 2H columns add to q1's and f's first-layer
    bias."""
    dx = consts["dx"]
    q1, f, g = fused_step._unpack_nets(consts)
    sfi = consts["sconst"][:dx, None]
    sgi = consts["sconst"][dx:, None]
    aq, cq, sq, y, ab, cb = fused_step._split_coef(coef_t, consts)
    x_new, alpha = fused_step._propose_weight(q1, f, g, x_res, eps, aq, cq, sq, y, ab, sfi, sgi,
                                              x_new_value, cb=cb)
    return x_new, torch.clamp(alpha, min=-3e30)


def trunk_forward_reference(x_res, coef_t, consts, eps):
    """Plain version of K9: x_res [B, Dx, K], coef_t [B, coef_width] (3·Dx +
    Dy + 1, and 2H more with controls), eps [B, Dx, K] -> (x_new [B, Dx, K],
    α [B, K] floored at −3e30)."""
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
    run; "tile", the previous design, kept as its yardstick: the same bits,
    no control mode), or raise for a shape it is not instantiated for. With
    controls (consts["di"] > 0) coef_t carries their first-layer terms
    (`fused_step.pack_coef`) and the kernel runs its control mode. When
    autograd records, through `TrunkForward` (K10 its backward)."""
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
    ctrl = fused_step._ctrl(consts)
    if (not shape_ok(dx, dy, h, n_mid) or k % TILE or (ctrl and design != "async")
            or (design == "tile" and not (_prebuilt(dx, dy, h)
                                          and k9_weights(dx, dy, h, n_mid) == "smem"))):
        raise ValueError(f"trunk_forward: no {design} kernel for Dx={dx}, Dy={dy}, hidden={h}, "
                         f"{n_mid} middle layers, K={k}, controls {bool(ctrl)}")
    _require(x_res, (batch, dx, k), "x_res", dev)
    _require(coef_t, (batch, fused_step.coef_width(consts)), "coef_t", dev)
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
    wplan = WEIGHT_PLACES.index(k9_weights(dx, dy, h, n_mid))
    lib = _library(lib_key(dx, dy, h, n_mid, False))
    _, off_f, off_g = consts["offsets"]  # q1 sits at offset 0
    err = lib.psvo_trunk_forward(
        x_res.data_ptr(), _ptr(eps), coef_t.data_ptr(), consts["packed"].data_ptr(),
        consts["sconst"].data_ptr(), x_new.data_ptr(), alpha.data_ptr(), seed0, seed1,
        int(seed is not None), t, batch, k, dx, dy, h, n_mid, consts["packed"].numel(), off_f,
        off_g, K9_DESIGNS.index(design), int(pair), int(prefetch), wplan, ctrl,
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
    (coef columns 3·Dx .. 3·Dx + Dy) and ε get none; the controls' columns
    (with controls) get their first-layer terms' gradients. Returns (d_x_res,
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
                   t: int = 0, design: str | None = None):
    """K10: the VJP of K9 for one step. Takes K9's inputs (x_res, coef_t,
    consts and the noise: eps [B, Dx, K] or the `seed` and step t it drew
    from), its output x_new and the cotangents d_x_new [B, Dx, K] and d_alpha
    [B, K]. Returns (d_x_res [B, Dx, K], d_coef_t [B, coef_width], d_packed
    [n_w], d_sconst [Dx + Dy]) as `trunk_backward_reference`, which CPU
    tensors run (in-kernel RNG replayed through K2's plain version); CUDA
    tensors launch the kernel of `design` (None: `k10_design`'s, the only
    one the paths run — "tf32x3" at Lorenz-96's width, "simt" at the small
    widths; "simt" at Lorenz-96's width is the previous design, kept as the
    tensor-core one's yardstick), or raise for a shape it is not
    instantiated for. With controls the kernel runs its control mode."""
    if (seed is None) == (eps is None):
        raise ValueError("trunk_backward: pass either eps or seed")
    design = design or k10_design(x_res.shape[1], consts["dy"], consts["hidden"],
                                  consts["n_mid"])
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
    ctrl = fused_step._ctrl(consts)
    wplan = WEIGHT_PLACES.index(k10_weights(dx, dy, h, n_mid, design))
    if not k10_ok(dx, dy, h, n_mid, k, design) or (
            lib_key(dx, dy, h, n_mid, True) is not None and design != "simt"):
        raise ValueError(f"trunk_backward: no {design} kernel for Dx={dx}, Dy={dy}, hidden={h}, "
                         f"{n_mid} middle layers, K={k} "
                         f"({k10_smem_bytes(dx, dy, h, n_mid, design, bool(wplan))} B of shared "
                         f"memory, at most {SMEM_LIMIT})")
    if ctrl and design != k10_design(dx, dy, h, n_mid):
        raise ValueError(f"trunk_backward: the control mode runs "
                         f"{k10_design(dx, dy, h, n_mid)!r} at Dx={dx}, not {design!r}")
    packed = consts["packed"]
    n_w = packed.numel()
    _require(x_res, (batch, dx, k), "x_res", dev)
    _require(x_new, (batch, dx, k), "x_new", dev)
    _require(coef_t, (batch, fused_step.coef_width(consts)), "coef_t", dev)
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
    coef_part = torch.empty((batch * (k // TILE), 3 * dx + 1 + 2 * h * ctrl), **f32)
    grads = torch.empty((n_w + dx + dy,), **f32)
    seed0, seed1 = (0, 0) if seed is None else seed
    lib = _library(lib_key(dx, dy, h, n_mid, True))
    _, off_f, off_g = consts["offsets"]
    err = lib.psvo_trunk_backward(
        x_res.data_ptr(), x_new.data_ptr(), _ptr(eps), coef_t.data_ptr(), packed.data_ptr(),
        consts["sconst"].data_ptr(), d_x_new.data_ptr(), d_alpha.data_ptr(), d_x_res.data_ptr(),
        partial.data_ptr(), coef_part.data_ptr(), grads.data_ptr(), d_coef.data_ptr(), seed0,
        seed1, int(seed is not None), t, batch, k, dx, dy, h, n_mid, n_w, off_f, off_g, max_ctas,
        DESIGNS.index(design), wplan, ctrl, torch.cuda.current_stream(dev).cuda_stream,
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
