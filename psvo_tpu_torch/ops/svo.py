"""SVO reverse-sweep kernels and their plain versions (counterpart of
`psvo_tpu/ops/pallas_svo.py`).

Two hand-written CUDA kernels (`psvo_tpu_torch/csrc/svo_sweep.cu`, built by
`ops/_build.py`), each behind a wrapper that launches it for CUDA tensors and
runs its plain PyTorch version for CPU tensors — never the plain version on
the card:

- K12 `svo_sweep_forward` (replaces `pallas_svo._scan_fwd`, the whole-sweep
  forward kernel): SVO's backward simulation t = T−2 … 0 in one launch. Per
  step and smoothed path, with x_next = x̃_{t+1}:
    x̃_t  = qb([x_next; y_t]) + s_b·ε_t
    lq  += max(−½·Σ ε_t² + c_b, −1e30)
    lp  += max(−½·Σ z_f² + c_f, −1e30) + max(−½·Σ z_g² + c_g, −1e30)
    z_f  = (x_next − f(x̃_t))·(1/s_f),  z_g = (y_t − g(x̃_t))·(1/s_g)
  Plain version: `svo_sweep_forward_reference`, a loop over t of that body.
  Two designs, with the same bits; the path runs "split"
  (`svo_forward_split_kernel`): only qb and the draw stay on the serial
  chain, each path on its own threads, and f, g and the density terms run
  afterwards over all the (t, path) rows at once, each path's terms then
  added t descending; a CTA takes `k12_plan`'s paths and chunks of steps.
  "chain" (`svo_forward_kernel`, the previous design: the whole step on the
  chain, eight CTA barriers a step) stays callable with `design="chain"` as
  its yardstick.
- K13 `svo_sweep_backward` (replaces `pallas_svo._scan_bwd`, the VJP kernel):
  the VJP of K12 from its saved trajectories. Plain version:
  `svo_sweep_backward_reference`, an autograd replay of the plain forward in
  which every draw takes K12's saved x̃_t as its value. Two designs; the
  path runs "split" (`svo_backward_split_kernel`): everything but one
  Dx-wide linear recurrence is parallel over the (t, path) rows — the
  trunks' recompute, f's and g's VJP, J_t = ∂m_b/∂x̃_{t+1}, qb's VJP and the
  weight sums — and the carry obeys carry_0 = d_x_first, dmb_t = u_t +
  carry_t, carry_{t+1} = dxz_t + J_tᵀ dmb_t (u_t = d_xtilde_t + dfx_t +
  dgx_t, dxz_t the z_f part); a CTA takes `k13_paths` paths and walks t in
  tiles of `k13_tile_rows` rows. "chain" (`svo_backward_kernel`, the
  previous design, the TPU kernel's shape: every path walks t carrying
  d x̃_{t+1} through the whole step's VJP) stays callable with
  `design="chain"` as its yardstick.

`SVOSweep` joins them as one `torch.autograd.Function` with the gradient
contract of `pallas_svo.svo_scan`'s custom VJP: cotangents to x_anchor, to
the packed qb/f/g weights and biases, and to the scale operand sc = (1/s_f,
1/s_g, s_b, c_f, c_g, c_b), through which autograd outside reaches the three
scales (the TPU kernel's sconst operand and d_sm stream); a density term
under its floor passes no cotangent to its constant; zero for ε, none for y.
Each wrapper carries a launch count (`<wrapper>.launches`), raised only where
the kernel is launched (also by design, `.launches_by_design`); each plain
version a call count (`.calls`).

Layout: x_anchor [B, M, Dx]; eps [T−1, B, M, Dx] (ε_t at index t); y
[T−1, B, Dy] (y_t of t = 0 … T−2); packed: qb | f | g in
`fused_step.prepare`'s per-net layout; sc [2·Dx + Dy + 3]. Outputs: x_first
[B, M, Dx] (= x̃_0), lp and lq [B, M] (the in-sweep sums only: the anchor's
terms and the prior are added outside), xtilde [T−1, B, M, Dx] with
xtilde[t] = x̃_t. Not ported: the TPU kernel's lane packing of its small
operands (`sm`, `sconst`), the ones-channel bias folding (`aug_net`) and the
pad of M to 128 lanes.
"""

from __future__ import annotations

import torch

from psvo_tpu_torch.distributions import _HALF_LOG_2PI, _MIN_LOGP
from psvo_tpu_torch.ops import _build
from psvo_tpu_torch.ops.fused_step import (
    HIDDEN_WIDTHS, KERNEL_DIMS, SMEM_LIMIT, _ptr, _require, _unpack_net, pack_heads,
)

MAX_M = 1024  # smoothed paths per row (the flattened B·M paths have no limit of their own)
_NETS = ("qb", "f", "g")
_THREADS = 256  # K12/K13 CTA: 256 / hidden paths, one thread per hidden unit


def n_sc(dx: int, dy: int) -> int:
    """Length of the scale operand sc."""
    return 2 * dx + dy + 3


DESIGNS = ("split", "chain")  # K13's designs: the one the path runs, the previous one
K12_DESIGNS = ("split", "chain")  # K12's designs: the one the path runs, the previous one
_ROW_FLOATS = 56  # per tile row of the split design (csrc/svo_sweep.cu::kRowFloats)


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def _padded_floats(din: int, dout: int, h: int, n_mid: int) -> int:
    """One net in the split designs' shared memory: every row of an h-wide
    matrix padded to h + 4 floats (csrc/svo_sweep.cu::Padded)."""
    ws = h + 4
    return _r4(din * ws + h + n_mid * (h * ws + h) + h * dout + dout)


def k12_max_paths(h: int) -> int:
    """The most paths one CTA of K12's split design holds: its 256 threads,
    h a path (one hidden unit a thread; csrc/svo_sweep.cu::path_sync)."""
    return _THREADS // h


def k12_smem_bytes(dx: int, dy: int, h: int, n_mid: int, paths: int, rows: int,
                   steps: int) -> int:
    """Dynamic shared memory of K12's split design
    (csrc/svo_sweep.cu::fwd_split_smem_floats): qb in the packed layout, f and
    g with every row of an h-wide matrix padded to h + 4 floats, two hidden
    vectors of h floats and x̃ (4 floats) per chain slot (`paths` rounded up
    to whole warps), f's and g's two hidden layers (stride h + 4) and means
    (4 floats) for a tile of `rows` rows, and 18 floats for each of `steps`
    x `paths` chain rows, rounded up to 4 rows."""
    slots = -(-paths * h // 32) * 32 // h
    qb = _r4((dx + dy) * h + h + n_mid * (h * h + h) + h * dx + dx)
    return 4 * (qb + _padded_floats(dx, dx, h, n_mid) + _padded_floats(dx, dy, h, n_mid)
                + slots * (2 * h + 4) + 4 * rows * (h + 4) + 8 * rows + 18 * _r4(steps * paths))


def k12_plan(dx: int, dy: int, h: int, n_mid: int, n_paths: int, n_sms: int,
             t1: int) -> tuple[int, int, int] | None:
    """(paths a CTA, rows a tile of the parallel pass, steps a chunk) of
    K12's split design: the fewest paths a CTA whose CTAs fill the SMs in one
    wave (at most `k12_max_paths`); 4096 / h rows (one 4 x 4 block of a hidden
    layer per thread), halved until one chunk step fits, at least 16; then
    as many steps as fit, at most T − 1. None where even that does not
    fit."""
    paths = max(1, min(k12_max_paths(h), -(-n_paths // n_sms)))
    rows = 4096 // h
    while rows >= 16 and k12_smem_bytes(dx, dy, h, n_mid, paths, rows, 1) > SMEM_LIMIT:
        rows //= 2
    if rows < 16:
        return None
    fixed = k12_smem_bytes(dx, dy, h, n_mid, paths, rows, 0)
    steps = min(t1, (SMEM_LIMIT - fixed) // 72 // 4 * 4 // paths)
    return (paths, rows, steps) if steps >= 1 else None


def k12_ok(dx: int, dy: int, h: int, n_mid: int) -> bool:
    """Whether K12's split design is instantiated for the shape and holds
    its largest CTA (`k12_max_paths` paths, a 16-row tile, one step a chunk)
    in shared memory, so `k12_plan` finds a plan for any B, M and T."""
    return ((dx, dy) in KERNEL_DIMS and h in HIDDEN_WIDTHS
            and k12_smem_bytes(dx, dy, h, n_mid, k12_max_paths(h), 16, 1) <= SMEM_LIMIT)


def k13_smem_bytes(dx: int, dy: int, h: int, n_mid: int, n_weights: int, design: str = "split",
                   rows: int | None = None) -> int:
    """Dynamic shared memory of K13 (csrc/svo_sweep.cu). "split"
    (split_smem_floats): the three nets with every row of an h-wide matrix
    padded to h + 4 floats, the CTA's gradient sums, qb's and f's (then g's)
    n_mid + 1 hidden layers and one scratch layer of `rows` tile rows at a
    stride of h + 4, and 56 floats per row (rows: `k13_tile_rows`'s, or 16
    where none fits). "chain" (launch_backward): the weights, transposed
    copies of the first and middle layers, the CTA's gradient sums and
    256 / h paths' buffers."""
    if design == "chain":
        nt = (dx + dy) * h + 2 * dx * h + 3 * n_mid * h * h
        paths = _THREADS // h * (80 + 6 * (n_mid + 1) * h)
        return 4 * (n_weights + _r4(nt) + _r4(n_weights + n_sc(dx, dy)) + paths)
    if design != "split":
        raise ValueError(f"K13 has no design {design!r} (one of {DESIGNS})")
    if rows is None:
        rows = k13_tile_rows(dx, dy, h, n_mid, n_weights) or 16

    nets = (_padded_floats(dx + dy, dx, h, n_mid) + _padded_floats(dx, dx, h, n_mid)
            + _padded_floats(dx, dy, h, n_mid))
    layers = (2 * (n_mid + 1) + 1) * rows * (h + 4)
    return 4 * (nets + _r4(n_weights + n_sc(dx, dy)) + layers + _ROW_FLOATS * rows)


def k13_tile_rows(dx: int, dy: int, h: int, n_mid: int, n_weights: int) -> int | None:
    """Rows of a tile of K13's split design: 4096 / h (one 4 x 4 block of a
    hidden layer per thread), halved until its shared memory fits a CTA,
    at least 16; None where even 16 do not fit."""
    rows = 4096 // h
    while rows >= 16:
        if k13_smem_bytes(dx, dy, h, n_mid, n_weights, "split", rows) <= SMEM_LIMIT:
            return rows
        rows //= 2
    return None


def k13_paths(n_paths: int, n_sms: int, rows: int) -> int:
    """Paths of a CTA's group in K13's split design: enough that the groups
    fill the card's SMs in one wave, at most a tile's rows (a tile then holds
    rows // paths steps of each path)."""
    return max(1, min(rows, -(-n_paths // n_sms)))


def k13_ok(dx: int, dy: int, h: int, n_mid: int, n_weights: int, design: str = "split") -> bool:
    """Whether K13's `design` is instantiated for the shape: (Dx, Dy) and the
    width instantiated, and its shared memory in one CTA."""
    if design not in DESIGNS:
        raise ValueError(f"K13 has no design {design!r} (one of {DESIGNS})")
    if (dx, dy) not in KERNEL_DIMS or h not in HIDDEN_WIDTHS:
        return False
    if design == "split":
        return k13_tile_rows(dx, dy, h, n_mid, n_weights) is not None
    return k13_smem_bytes(dx, dy, h, n_mid, n_weights, "chain") <= SMEM_LIMIT


def _n_weights(dx: int, dy: int, h: int, n_mid: int) -> int:
    def seg(din, dout):
        n = din * h + h + n_mid * (h * h + h) + h * dout + dout
        return n + (-n) % 4

    return seg(dx + dy, dx) + seg(dx, dx) + seg(dx, dy)


def usable(ssm, m: int) -> bool:
    """Whether SVO's sweep for (ssm, m smoothed paths) is in K12/K13's class:
    qb, f and g constant-diagonal relu MLPs of one uniform hidden width in
    `fused_step.HIDDEN_WIDTHS` whose K13 buffers fit a CTA's shared memory in
    both designs, and K12's split design's (`k12_ok`; both split designs
    fit every shape the chain designs do, so the class is the chain
    designs', as before the splits); (Dx, Dy) in {(2, 2), (3, 3)}; a
    Gaussian emission; no qb GRU, known dynamics or controls; 1 <= m <=
    MAX_M."""
    hidden = ssm.nets["qb"].hidden
    if not (len(hidden) >= 1 and hidden[0] in HIDDEN_WIDTHS
            and all(h == hidden[0] for h in hidden)):
        return False
    h, n_mid = hidden[0], len(hidden) - 1
    return (
        (ssm.dx, ssm.dy) in KERNEL_DIMS
        and 1 <= m <= MAX_M
        and not (ssm.qb_rnn or ssm.transition_known or ssm.di)
        and ssm.emission in ("linear_gaussian", "identity_gaussian")
        and all(ssm.nets[n].hidden == hidden and ssm.nets[n].activation == "relu"
                and ssm.nets[n].cov_type == "const" for n in _NETS)
        and all(k13_ok(ssm.dx, ssm.dy, h, n_mid, _n_weights(ssm.dx, ssm.dy, h, n_mid), d)
                for d in DESIGNS)
        and k12_ok(ssm.dx, ssm.dy, h, n_mid)
    )


def prepare(ssm) -> dict:
    """Per-call constants of K12/K13: the qb, f and g weights and biases
    packed into one float32 buffer (`fused_step.pack_heads`), and sc =
    (1/s_f, 1/s_g, s_b, c_f, c_g, c_b) with c_f = −Σ log s_f − Dx·½log 2π,
    c_g = −Σ log s_g − Dy·½log 2π, c_b = −Σ log s_b − Dx·½log 2π. Both keep
    their autograd history to the model's parameters."""
    hidden = ssm.nets["qb"].hidden
    packed, offsets = pack_heads(ssm, _NETS)
    s_f, s_g, s_b = ssm.scale("f"), ssm.scale("g"), ssm.scale("qb")
    dx, dy = ssm.dx, ssm.dy
    consts = torch.stack([
        -torch.sum(torch.log(s_f)) - dx * _HALF_LOG_2PI,
        -torch.sum(torch.log(s_g)) - dy * _HALF_LOG_2PI,
        -torch.sum(torch.log(s_b)) - dx * _HALF_LOG_2PI,
    ])
    return {
        "packed": packed,
        "offsets": offsets,
        "hidden": hidden[0],
        "n_mid": len(hidden) - 1,
        "dx": dx,
        "dy": dy,
        "sc": torch.cat([1.0 / s_f, 1.0 / s_g, s_b, consts]).contiguous(),
    }


def _nets(consts, packed=None):
    """The (qb, f, g) nets read back out of prepare()'s buffer."""
    dx, dy, h, n_mid = consts["dx"], consts["dy"], consts["hidden"], consts["n_mid"]
    packed = consts["packed"] if packed is None else packed
    off_q, off_f, off_g = consts["offsets"]
    return (_unpack_net(packed, off_q, dx + dy, h, n_mid, dx),
            _unpack_net(packed, off_f, dx, h, n_mid, dx),
            _unpack_net(packed, off_g, dx, h, n_mid, dy))


def _mlp(net, x):
    """relu MLP mean, feature-last: [..., Din] -> [..., Dout]."""
    layers, (w3, b3) = net
    h = x
    for w, b in layers:
        h = torch.relu(h @ w + b)
    return h @ w3 + b3


def _step(nets, sc, dx, dy, x_next, y_t, eps_t, x_value=None):
    """One reverse step from x_next [B, M, Dx] with y_t [B, Dy] and ε_t
    [B, M, Dx]: returns (x̃_t, lp_t, lq_t). With x_value the draw takes that
    value (K12's saved x̃_t) and keeps its gradient to qb, s_b and x_next."""
    qb, f, g = nets
    sfi, sgi, s_b = sc[:dx], sc[dx:dx + dy], sc[dx + dy:2 * dx + dy]
    c_f, c_g, c_b = sc[2 * dx + dy], sc[2 * dx + dy + 1], sc[2 * dx + dy + 2]
    y = y_t[:, None, :].expand(-1, x_next.shape[1], -1)
    x_t = _mlp(qb, torch.cat([x_next, y], dim=-1)) + s_b * eps_t
    if x_value is not None:
        x_t = x_value + (x_t - x_t.detach())
    z_f = (x_next - _mlp(f, x_t)) * sfi
    z_g = (y - _mlp(g, x_t)) * sgi
    lp_t = (torch.clamp(-0.5 * torch.sum(z_f * z_f, dim=-1) + c_f, min=_MIN_LOGP)
            + torch.clamp(-0.5 * torch.sum(z_g * z_g, dim=-1) + c_g, min=_MIN_LOGP))
    lq_t = torch.clamp(-0.5 * torch.sum(eps_t * eps_t, dim=-1) + c_b, min=_MIN_LOGP)
    return x_t, lp_t, lq_t


def _sweep(nets, sc, dx, dy, x_anchor, eps, y, xtilde=None):
    x = x_anchor
    lp = torch.zeros(x_anchor.shape[:2], dtype=x_anchor.dtype, device=x_anchor.device)
    lq = torch.zeros_like(lp)
    xts = [None] * eps.shape[0]
    for t in reversed(range(eps.shape[0])):
        x, lp_t, lq_t = _step(nets, sc, dx, dy, x, y[t], eps[t],
                              None if xtilde is None else xtilde[t])
        lp, lq, xts[t] = lp + lp_t, lq + lq_t, x
    return x, lp, lq, torch.stack(xts)


def _check_sweep(x_anchor, eps, y, consts, what, design=None):
    """Shapes, type, device and contiguity of a sweep's operands, in the
    class of K13's `design` (None: of both and K12's, `usable`'s class, which
    K12 takes); returns (T−1, B, M, Dx, Dy)."""
    if eps.dim() != 4 or x_anchor.dim() != 3:
        raise ValueError(f"{what}: eps must be [T-1, B, M, Dx] and x_anchor [B, M, Dx]")
    t_len, batch, m, dx = eps.shape
    dy, h, n_mid = consts["dy"], consts["hidden"], consts["n_mid"]
    n_w = consts["packed"].numel()
    designs = DESIGNS if design is None else (design,)
    if (not 1 <= m <= MAX_M or t_len < 1 or consts["dx"] != dx
            or not all(k13_ok(dx, dy, h, n_mid, n_w, d) for d in designs)
            or (design is None and not k12_ok(dx, dy, h, n_mid))):
        kind = f"{design} kernel" if design else "kernel"
        raise ValueError(f"{what}: no {kind} for Dx={dx}, Dy={dy}, hidden={h}, {n_mid} "
                         f"middle layers, M={m}, T-1={t_len}")
    dev = x_anchor.device
    _require(x_anchor, (batch, m, dx), "x_anchor", dev)
    _require(eps, (t_len, batch, m, dx), "eps", dev)
    _require(y, (t_len, batch, dy), "y", dev)
    _require(consts["packed"], (n_w,), "weights", dev)
    _require(consts["sc"], (n_sc(dx, dy),), "sc", dev)
    return t_len, batch, m, dx, dy


# ---------------------------------------------------------------------------
# K12: the whole reverse sweep
# ---------------------------------------------------------------------------


def svo_sweep_forward_reference(x_anchor, eps, y, consts):
    """Plain version of K12: the sweep as a loop over t = T−2 … 0. Operands
    and outputs as the module docstring says."""
    svo_sweep_forward_reference.calls += 1
    return _sweep(_nets(consts), consts["sc"], consts["dx"], consts["dy"], x_anchor, eps, y)


svo_sweep_forward_reference.calls = 0


def svo_sweep_forward(x_anchor, eps, y, consts, design: str = "split"):
    """K12: SVO's reverse sweep in one launch. Returns (x_first, lp, lq,
    xtilde). CPU tensors run the plain version; CUDA tensors launch the
    kernel of `design` ("split", the default and the only one the paths run;
    "chain", the previous design, kept as its yardstick: the same bits). It
    takes no gradient itself: differentiate through `SVOSweep`."""
    if design not in K12_DESIGNS:
        raise ValueError(f"svo_sweep_forward: no design {design!r} (one of {K12_DESIGNS})")
    if x_anchor.device.type == "cpu":
        return svo_sweep_forward_reference(x_anchor, eps, y, consts)
    if x_anchor.device.type != "cuda":
        raise ValueError(f"svo_sweep_forward: unsupported device {x_anchor.device}")
    dev = x_anchor.device
    return _launch_forward(x_anchor, eps, y, consts, torch.cuda.current_stream(dev).cuda_stream,
                           design, torch.cuda.get_device_properties(dev).multi_processor_count)


svo_sweep_forward.launches = 0
svo_sweep_forward.launches_by_design = dict.fromkeys(K12_DESIGNS, 0)  # which kernel the launches ran


def _launch_forward(x_anchor, eps, y, consts, stream, design="split", n_sms=132, plan=None):
    """Check K12's operands, allocate its outputs and launch the kernel of
    `design` on `stream`; the split design's (paths, tile rows, steps a
    chunk) from `k12_plan` for `n_sms` SMs unless `plan` gives them."""
    t_len, batch, m, dx, dy = _check_sweep(x_anchor, eps, y, consts, "svo_sweep_forward")
    f32 = dict(dtype=torch.float32, device=x_anchor.device)
    x_first = torch.empty((batch, m, dx), **f32)
    lp = torch.empty((batch, m), **f32)
    lq = torch.empty((batch, m), **f32)
    xtilde = torch.empty((t_len, batch, m, dx), **f32)
    h, n_mid = consts["hidden"], consts["n_mid"]
    if design == "split" and plan is None:
        plan = k12_plan(dx, dy, h, n_mid, batch * m, n_sms, t_len)
    paths, rows, steps = plan if design == "split" else (0, 0, 0)
    lib = _build.load_library()
    _, off_f, off_g = consts["offsets"]
    err = lib.psvo_svo_forward(
        x_anchor.data_ptr(), eps.data_ptr(), y.data_ptr(), consts["packed"].data_ptr(),
        consts["sc"].data_ptr(), x_first.data_ptr(), lp.data_ptr(), lq.data_ptr(),
        xtilde.data_ptr(), batch, m, t_len, dx, dy, h, n_mid, consts["packed"].numel(), off_f,
        off_g, K12_DESIGNS.index(design), paths, rows, steps, stream,
    )
    svo_sweep_forward.launches += 1
    svo_sweep_forward.launches_by_design[design] += 1
    _build.check(lib, err, "svo_sweep_forward")
    return x_first, lp, lq, xtilde


# ---------------------------------------------------------------------------
# K13: its VJP
# ---------------------------------------------------------------------------


def svo_sweep_backward_reference(x_anchor, eps, y, consts, xtilde, d_x_first=None, d_lp=None,
                                 d_lq=None, d_xtilde=None):
    """Plain version of K13: replay the sweep from x_anchor under autograd,
    every draw taking K12's saved x̃_t as its value (the reference's VJP
    reads x̃_t and x̃_{t+1} from its residuals), then backpropagate the given
    cotangents (None: zero). A density term's cotangent is cut where it was
    floored (the gradient of torch.clamp). Returns (d_x_anchor, d_packed,
    d_sc); ε and y get none."""
    svo_sweep_backward_reference.calls += 1
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x_anchor, consts["packed"], consts["sc"])]
        xa, packed, sc = leaves
        outs = _sweep(_nets(consts, packed), sc, consts["dx"], consts["dy"], xa, eps, y, xtilde)
        live = [(o, g) for o, g in zip(outs, (d_x_first, d_lp, d_lq, d_xtilde)) if g is not None]
        grads = [None] * len(leaves)
        if live:
            grads = torch.autograd.grad([o for o, _ in live], leaves, [g for _, g in live],
                                        allow_unused=True)
    return tuple(torch.zeros_like(v) if g is None else g for g, v in zip(grads, leaves))


svo_sweep_backward_reference.calls = 0


def svo_sweep_backward(x_anchor, eps, y, consts, xtilde, d_x_first=None, d_lp=None, d_lq=None,
                       d_xtilde=None, design: str = "split"):
    """K13: the VJP of K12 over the whole sweep in one launch (and the sum of
    its CTAs' gradient rows), from K12's xtilde. Cotangents and outputs as
    `svo_sweep_backward_reference`, which CPU tensors run; CUDA tensors
    launch the kernel of `design` ("split", the default and the only one
    the path runs; "chain", the previous design, kept as its yardstick), or
    raise for a shape it is not instantiated for."""
    if design not in DESIGNS:
        raise ValueError(f"svo_sweep_backward: no design {design!r} (one of {DESIGNS})")
    if x_anchor.device.type == "cpu":
        return svo_sweep_backward_reference(x_anchor, eps, y, consts, xtilde, d_x_first, d_lp,
                                            d_lq, d_xtilde)
    if x_anchor.device.type != "cuda":
        raise ValueError(f"svo_sweep_backward: unsupported device {x_anchor.device}")
    dev = x_anchor.device
    return _launch_backward(x_anchor, eps, y, consts, xtilde, d_x_first, d_lp, d_lq, d_xtilde,
                            torch.cuda.get_device_properties(dev).multi_processor_count,
                            torch.cuda.current_stream(dev).cuda_stream, design)


svo_sweep_backward.launches = 0
svo_sweep_backward.launches_by_design = dict.fromkeys(DESIGNS, 0)  # which kernel the launches ran


def _launch_backward(x_anchor, eps, y, consts, xtilde, d_x_first, d_lp, d_lq, d_xtilde,
                     max_ctas, stream, design="split"):
    """Check K13's operands, allocate its outputs and scratch (max_ctas rows
    of gradient sums) and launch the kernel of `design` on `stream`; the
    split design's tile rows and paths a CTA from `k13_tile_rows` and
    `k13_paths` (max_ctas SMs)."""
    t_len, batch, m, dx, dy = _check_sweep(x_anchor, eps, y, consts, "svo_sweep_backward",
                                           design)
    dev = x_anchor.device
    _require(xtilde, (t_len, batch, m, dx), "xtilde", dev)
    for t, shape, name in ((d_x_first, x_anchor.shape, "d_x_first"), (d_lp, (batch, m), "d_lp"),
                           (d_lq, (batch, m), "d_lq"), (d_xtilde, xtilde.shape, "d_xtilde")):
        if t is not None:
            _require(t, shape, name, dev)
    n_w = consts["packed"].numel()
    n_row = n_w + n_sc(dx, dy)
    f32 = dict(dtype=torch.float32, device=dev)
    d_anchor = torch.empty(x_anchor.shape, **f32)
    partial = torch.empty((max_ctas, n_row), **f32)
    grads = torch.empty((n_row,), **f32)
    h, n_mid = consts["hidden"], consts["n_mid"]
    rows = k13_tile_rows(dx, dy, h, n_mid, n_w) if design == "split" else 0
    paths = k13_paths(batch * m, max_ctas, rows) if design == "split" else 0
    lib = _build.load_library()
    _, off_f, off_g = consts["offsets"]
    err = lib.psvo_svo_backward(
        x_anchor.data_ptr(), eps.data_ptr(), y.data_ptr(), consts["packed"].data_ptr(),
        consts["sc"].data_ptr(), xtilde.data_ptr(), _ptr(d_x_first), _ptr(d_lp), _ptr(d_lq),
        _ptr(d_xtilde), d_anchor.data_ptr(), partial.data_ptr(), grads.data_ptr(), batch, m,
        t_len, dx, dy, h, n_mid, n_w, off_f, off_g, max_ctas, DESIGNS.index(design), rows,
        paths, stream,
    )
    svo_sweep_backward.launches += 1
    svo_sweep_backward.launches_by_design[design] += 1
    _build.check(lib, err, "svo_sweep_backward")
    return d_anchor, grads[:n_w], grads[n_w:]


# ---------------------------------------------------------------------------
# K12 + K13 as one differentiable operation
# ---------------------------------------------------------------------------


class SVOSweep(torch.autograd.Function):
    """`svo_sweep_forward` with `svo_sweep_backward` as its VJP: the
    counterpart of `pallas_svo.svo_scan`'s custom VJP.

    apply(x_anchor, eps, y, packed, sc, consts) returns (x_first, lp, lq,
    xtilde); packed and sc are consts["packed"] / consts["sc"], passed apart
    so autograd sees them. When an input needs a gradient the forward saves
    its operands and xtilde, and the backward runs K13 on them; eps and y get
    none.
    """

    @staticmethod
    def forward(ctx, x_anchor, eps, y, packed, sc, consts):
        consts = dict(consts, packed=packed, sc=sc)
        x_first, lp, lq, xtilde = svo_sweep_forward(x_anchor, eps, y, consts)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x_anchor, eps, y, packed, sc, xtilde)
            ctx.static = {key: v for key, v in consts.items() if not torch.is_tensor(v)}
        ctx.set_materialize_grads(False)
        return x_first, lp, lq, xtilde

    @staticmethod
    def backward(ctx, d_x_first, d_lp, d_lq, d_xtilde):
        x_anchor, eps, y, packed, sc, xtilde = ctx.saved_tensors
        consts = dict(ctx.static, packed=packed, sc=sc)

        def dense(t):
            return None if t is None else t.contiguous()

        d_anchor, d_packed, d_sc = svo_sweep_backward(
            x_anchor, eps, y, consts, xtilde, dense(d_x_first), dense(d_lp), dense(d_lq),
            dense(d_xtilde),
        )
        return d_anchor, None, None, d_packed, d_sc, None


def run_svo_sweep(ssm, ys_tm, eps, x_anchor):
    """The sweep on the model's heads (the counterpart of
    `pallas_svo.run_svo_sweep`): ys_tm [T, B, Dy], eps [T−1, B, M, Dx],
    x_anchor [B, M, Dx]. Returns (x_first [B, M, Dx], lp [B, M], lq [B, M],
    xtilde [T−1, B, M, Dx]); gradients reach x_anchor and the qb, f and g
    heads' weights, biases and scales."""
    consts = prepare(ssm)
    y = ys_tm[:-1].contiguous()
    args = (x_anchor.contiguous(), eps.contiguous(), y)
    if torch.is_grad_enabled():
        return SVOSweep.apply(*args, consts["packed"], consts["sc"], consts)
    return svo_sweep_forward(*args, consts)
