"""Whole-scan and per-step filter kernels and their plain versions
(counterpart of `psvo_tpu/ops/pallas_step.py`).

Six hand-written CUDA kernels (`psvo_tpu_torch/csrc/`, built by
`ops/_build.py`), each behind a wrapper that launches it for CUDA tensors and
runs its plain PyTorch version for CPU tensors — never the plain version on
the card:

- K1 `scan_forward` (replaces `pallas_step._scan_fwd`, the forward whole-scan
  megakernel): resample → q1/f trunks → fused draw → g trunk → α → ℓ and the
  filtered mean, for all T−1 steps in one launch. Plain version:
  `scan_forward_reference`, a loop over t.
- K4 `scan_backward` (replaces `pallas_step._scan_bwd`, the backward
  whole-scan megakernel): the VJP of K1 from its residuals, all T−1 steps in
  reverse in one launch. Plain version: `scan_backward_reference`, an
  autograd replay of the forward on the saved ancestors.
- K2 `stream_noise` (replaces `pallas_step.generate_stream_noise` and
  `pallas_trunk.generate_trunk_noise`): the exact ε / u0 streams K1 and the
  trunk kernel K9 (`ops/trunk.py`) draw in their in-kernel RNG mode, for any
  state width. Plain version:
  `stream_noise_reference`, Philox4x32-10 in int64 torch arithmetic. Two
  designs with the same bits: "pair" (the default, one thread per Philox
  call, `k2_plan`) and "particle" (the previous one, its yardstick).
- K3 `ancestor_indices` (replaces `pallas_resample._two_level_indices` as the
  megakernel inlines it): systematic ancestors through K1's own index code.
  Plain version: `ancestor_indices_reference`.

- K14 `step_forward` (replaces `pallas_step._step_fwd`, the per-step
  megakernel): one step of K1 per launch, x and logw in, x_new, α, the stats
  and the ancestors out. Plain version: `step_forward_reference`, one
  iteration of `scan_forward_reference`'s loop.
- K15 `step_backward` (replaces `pallas_step._step_bwd`): the VJP of one K14
  step, K4's step on that step's residuals. Plain version:
  `step_backward_reference`, the replay of one step.

K1 and K4 run each trajectory row on a thread-block cluster of C CTAs, each
owning K/C particles (`csrc/cluster.cuh`). `cluster_size` picks C from the
card's occupancy (`max_active_clusters`): the largest C in `CLUSTER_SIZES`
whose B clusters are all resident at once. `scan_forward` and
`scan_backward` take `cluster=` to force C and record the C of their last
launch in `.last_cluster`. K1's outputs and K4's d_x0 are bit-equal for
every C.

K14 and K15 run each row on S CTAs that form no cluster
(`csrc/step_slices.cuh`), each owning K/S particles; the row's last CTA to
finish does the row's one exchange through device memory. `step_slices`
picks S from the card's count of resident CTAs (`resident_ctas`): the
largest S in `STEP_SLICES` whose B·S CTAs are all resident at once.
`step_forward` and `step_backward` take `slices=` to force S and record the
S of their last launch in `.last_slices`. K14's outputs and K15's d_x are
bit-equal for every S.

`ScanForward` joins K1 and K4 as one `torch.autograd.Function`, the
counterpart of `pallas_step._scan_call`'s custom VJP; `StepForward` joins
K14 and K15, the counterpart of `pallas_step._step_call`'s. `SCAN_FUSED`
chooses between them, as `pallas_step.SCAN_FUSED` does: when it is False,
`smc._forward_filter_fused` runs T−1 `StepForward` calls on streamed noise.
Each wrapper carries a launch count (`<wrapper>.launches`), raised only
where the kernel is launched; each plain version a call count (`.calls`).

Index semantics (K1, K3 and their plain versions): the count form
a_i = #{j : C_j <= pos_i·C_{K−1}}, clipped to K−1, on the inclusive CDF of
exp(logw − max) accumulated in float64. The reference's plain filter body
(`smc._make_step_body`, via `resampling.maybe_resample`) uses the histogram
form ceil(K·C_j − u0) in float32 instead; the two can differ by one index at
a boundary.

α here is the fused form of the TPU kernel, −½Σ(z_f² − ε² + z_g²) + ab with
every K-independent constant in ab, floored at −3e30; the plain body floors
each density at `_MIN_LOGP` = −1e30. They differ only on diverged particles.

Not ported: the ones-channel bias folding and the PD = 8 / HA = H+8 padding
of `aug_net`/`pack_sm`, which existed for the TPU's matrix unit and Mosaic;
`prepare` hands the kernels plain weights and biases.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from psvo_tpu_torch.ops import _build
from psvo_tpu_torch.ops.resampling import gather_particles

MAX_K = 4096  # shared memory: fp64 CDF + 2x particles + 2x log-weights + weights
HIDDEN_WIDTHS = (16, 32, 64)  # trunk widths the kernel is instantiated for
KERNEL_DIMS = ((2, 2), (3, 3))  # (Dx, Dy) instantiated: FitzHugh-Nagumo, Lorenz-63
_THREADS = 256
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper (227 KB)
SCAN_FUSED = True  # False: the filter runs one K14 launch per step (K15 per step backward)
CLUSTER_SIZES = (1, 2, 4, 8)  # CTAs per row of K1 and K4 (8: the portable cluster limit)
K1_MIN_SLICE = 256  # particles per CTA of K1 at C > 1: one per thread at least
K4_MIN_SLICE = 64  # particles per CTA of K4 at C > 1: one tile at least
_K1, _K4 = 0, 1  # psvo_max_active_clusters' kernel argument
STEP_SLICES = (1, 2, 4, 8)  # CTAs per row of K14 (slices of K1_MIN_SLICE) and K15 (K4_MIN_SLICE)
_K14, _K15 = 0, 1  # psvo_step_max_active's kernel argument


def usable(ssm, cfg) -> bool:
    """Whether (ssm, smc-config) is in the kernel's class."""
    k = cfg.n_particles
    hidden = ssm.nets["q1"].hidden
    nets = [ssm.nets[n] for n in ("q1", "f", "g")]
    return (
        cfg.resampling == "systematic"
        and cfg.ess_threshold >= 1.0
        and cfg.use_stop_gradient
        and (ssm.dx, ssm.dy) in KERNEL_DIMS
        and _k_ok(k)
        and len(hidden) >= 1
        and hidden[0] in HIDDEN_WIDTHS
        and all(h == hidden[0] for h in hidden)
        and all(nc.hidden == hidden and nc.activation == "relu" for nc in nets)
    )


def _k_ok(k: int) -> bool:
    # block scan: K <= threads, or whole chunks of K / threads per thread
    return k % 32 == 0 and 32 <= k <= MAX_K and (k <= _THREADS or k % _THREADS == 0)


# ---------------------------------------------------------------------------
# Glue outside the kernel
# ---------------------------------------------------------------------------


def prepare(ssm) -> dict:
    """Per-call constants of K1: the q1/f/g weights and biases packed into one
    float32 buffer, the inverse f/g scales and the log-scale sums.

    Buffer layout, per net (q1, f, g), each segment padded to a multiple of
    4 floats: W1 [Din, H], b1 [H], then per middle layer Wm [H, H], bm [H],
    then W3 [H, Dout], b3 [Dout] — weights as the reference stores them
    (x @ W + b). `scan_forward_reference` reads the weights back out of this
    buffer, so the layout the kernel reads is the one the CPU tests check.
    """
    hidden = ssm.nets["q1"].hidden
    packed, offsets = pack_heads(ssm, ("q1", "f", "g"))
    s_f, s_g = ssm.scale("f"), ssm.scale("g")
    return {
        "packed": packed,
        "offsets": offsets,
        "hidden": hidden[0],
        "n_mid": len(hidden) - 1,
        "dx": ssm.dx,
        "dy": ssm.dy,
        "sconst": torch.cat([1.0 / s_f, 1.0 / s_g]).contiguous(),
        "s_q1": ssm.scale("q1"),
        "log_sf_sum": torch.sum(torch.log(s_f)),
        "log_sg_sum": torch.sum(torch.log(s_g)),
    }


def pack_heads(ssm, names):
    """The heads `names` packed into one contiguous float32 buffer in
    `prepare`'s per-net layout, each segment padded to a multiple of 4
    floats; returns (packed, the segments' offsets)."""
    segs, offsets, off = [], [], 0
    for name in names:
        head = ssm.heads[name]
        parts = [t.reshape(-1) for w, b in head.layers() for t in (w, b)]
        parts += [head.mean_w.reshape(-1), head.mean_b]
        flat = torch.cat(parts)
        pad = (-flat.numel()) % 4
        segs.append(torch.nn.functional.pad(flat, (0, pad)))
        offsets.append(off)
        off += flat.numel() + pad
    return torch.cat(segs).contiguous(), tuple(offsets)


def fusion_coeffs(ssm, cfg, consts, enc_tm):
    """Per-step proposal-fusion coefficients, all K-independent:
    mean_q = cq·m1 + aq, scale_q = sq, with use_2q the precision-weighted
    product of q1's constant scale and the q2 encoder head evaluated for all
    T at once. Returns (aq, cq, sq) [T, B, Dx] and logsq_sum [T, B]."""
    t_steps, batch = enc_tm.shape[0], enc_tm.shape[1]
    shape = (t_steps, batch, ssm.dx)
    s1 = consts["s_q1"]
    if cfg.use_2q:
        m2, s2 = ssm.q2_mean_scale(enc_tm)
        prec1 = 1.0 / (s1 * s1)
        prec2 = 1.0 / (s2 * s2)
        var = 1.0 / (prec1 + prec2)
        aq = var * m2 * prec2
        cq = (var * prec1).expand(shape)
        sq = torch.sqrt(var).expand(shape)
    else:
        aq = torch.zeros(shape, device=enc_tm.device)
        cq = torch.ones(shape, device=enc_tm.device)
        sq = s1.expand(shape)
    return aq, cq, sq, torch.sum(torch.log(sq), dim=-1)


def pack_coef(aq, cq, sq, y, ab):
    """Per-step small operands of K1 as one [T−1, B, 3·Dx + Dy + 1] tensor:
    aq, cq, sq, y, then the K-independent α bias ab."""
    return torch.cat([aq, cq, sq, y, ab[..., None]], dim=-1).contiguous()


# ---------------------------------------------------------------------------
# K2: counter-based noise (csrc/philox.cuh)
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit halves of a·b for a constant a < 2³² and an int64
    tensor b < 2³², without overflowing int64: b is split into 16-bit halves."""
    p_lo = a * (b & 0xFFFF)  # < 2^48
    p_hi = a * (b >> 16)  # < 2^48
    s = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (s >> 32), s & _MASK


def philox4x32_reference(ctr, key):
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 values.
    ctr: 4 broadcastable tensors; key: 2 ints. Returns 4 tensors."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def _unit24(bits):
    return (bits >> 8).to(torch.float32) * (2.0**-24)


def stream_noise_reference(seed, t_len: int, batch: int, dx: int, k: int, device="cpu",
                           t0: int = 0):
    """Plain version of K2: eps [t_len, B, dx, K], u0 [t_len, B] of steps
    t0 .. t0 + t_len − 1, with the counter layout of csrc/philox.cuh."""
    stream_noise_reference.calls += 1
    i64 = dict(dtype=torch.int64, device=device)
    t = torch.arange(t0, t0 + t_len, **i64)[:, None, None]
    row = torch.arange(batch, **i64)[None, :, None]
    pair = torch.arange(k // 2, **i64)[None, None, :]
    zero = torch.zeros((), **i64)
    u0 = _unit24(philox4x32_reference((zero, t[..., 0], row[..., 0], zero), seed)[0])
    rows = []
    for j in range((dx + 1) // 2):
        words = philox4x32_reference((pair, t, row, zero + 1 + j), seed)
        for m in range(2):
            if 2 * j + m == dx:
                break
            u1 = 1.0 - _unit24(words[2 * m])
            u2 = _unit24(words[2 * m + 1])
            rad = torch.sqrt(-2.0 * torch.log(u1))
            ang = 6.283185307179586 * u2
            rows.append(torch.cat([rad * torch.cos(ang), rad * torch.sin(ang)], dim=-1))
    return torch.stack(rows, dim=2).contiguous(), u0.contiguous()


stream_noise_reference.calls = 0


K2_DESIGNS = ("pair", "particle")  # K2's designs: the one every caller takes, the previous one
K2_THREADS = 256  # pairs a CTA of the pair design serves (csrc/stream_noise.cu::kPairThreads)


def k2_plan(t_len: int, batch: int, dx: int, k: int) -> dict:
    """The pair design's grid (csrc/stream_noise.cu): (t·B + row, group
    j < ceil(dx/2), tile of K2_THREADS pairs), one thread per (t, row, pair
    p < K/2, group j); thread x of CTA (tr, j, z) takes pair z·K2_THREADS + x."""
    groups, tiles = (dx + 1) // 2, -(-(k // 2) // K2_THREADS)
    return dict(grid=(t_len * batch, groups, tiles), ctas=t_len * batch * groups * tiles)


def stream_noise(seed, t_len: int, batch: int, dx: int, k: int, device, design: str = "pair"):
    """K2: the in-kernel-RNG streams of K1 and K9 for `seed` (two uint32
    words), steps 0 .. t_len − 1, any state width dx. CUDA launches the
    kernel of `design` ("pair", the default: one thread per Philox call,
    which writes both halves of each Box-Muller pair; "particle", the
    previous design, one CTA per (t, row), kept as its yardstick); both give
    the plain version's bits."""
    if design not in K2_DESIGNS:
        raise ValueError(f"stream_noise: no design {design!r} (one of {K2_DESIGNS})")
    device = torch.device(device)
    if device.type == "cpu":
        return stream_noise_reference(seed, t_len, batch, dx, k, device)
    if device.type != "cuda":
        raise ValueError(f"stream_noise: unsupported device {device}")
    if dx < 1 or k < 2 or k % 2:
        raise ValueError(f"stream_noise: dx={dx} >= 1 and even K={k} >= 2 required")
    lib = _build.load_library()
    eps = torch.empty((t_len, batch, dx, k), dtype=torch.float32, device=device)
    u0 = torch.empty((t_len, batch), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.psvo_stream_noise(
        eps.data_ptr(), u0.data_ptr(), seed[0], seed[1], t_len, batch, dx, k,
        K2_DESIGNS.index(design), stream
    )
    stream_noise.launches += 1
    stream_noise.launches_by_design[design] += 1
    _build.check(lib, err, f"stream_noise ({design})")
    return eps, u0


stream_noise.launches = 0
stream_noise.launches_by_design = dict.fromkeys(K2_DESIGNS, 0)  # which kernel the launches ran


# ---------------------------------------------------------------------------
# K3: ancestor indices (csrc/resample.cuh)
# ---------------------------------------------------------------------------


def systematic_positions(u0, k: int):
    """[..., K] positions (i + u0)/K from offsets u0 [...], float32."""
    i = torch.arange(k, dtype=torch.float32, device=u0.device)
    return (i + u0[..., None]) / k


def count_form_indices(logw, positions):
    """a_i = #{j : C_j <= pos_i·C_{K−1}}, clipped to K−1, with C the fp64
    inclusive CDF of exp(logw − max): K1's and K3's index semantics.
    logw [N, K], positions [N, K] -> int32 [N, K]."""
    m = torch.amax(logw, dim=-1, keepdim=True)
    cdf = torch.cumsum(torch.exp(logw - m).to(torch.float64), dim=-1)
    target = positions.to(torch.float64) * cdf[:, -1:]
    idx = torch.searchsorted(cdf, target.contiguous(), right=True)
    return torch.clamp(idx, max=logw.shape[-1] - 1).to(torch.int32)


def ancestor_indices_reference(logw, u0):
    """Plain version of K3: systematic ancestors (count form, fp64 CDF)."""
    ancestor_indices_reference.calls += 1
    return count_form_indices(logw, systematic_positions(u0, logw.shape[-1]))


ancestor_indices_reference.calls = 0


def ancestor_indices(logw, u0):
    """K3: logw [B, K] f32, u0 [B] f32 -> ancestor indices int32 [B, K]."""
    if logw.device.type == "cpu":
        return ancestor_indices_reference(logw, u0)
    if logw.device.type != "cuda":
        raise ValueError(f"ancestor_indices: unsupported device {logw.device}")
    batch, k = logw.shape
    _require(logw, (batch, k), "logw", logw.device)
    _require(u0, (batch,), "u0", logw.device)
    if not _k_ok(k):
        raise ValueError(f"ancestor_indices: unsupported K={k}")
    lib = _build.load_library()
    idx = torch.empty((batch, k), dtype=torch.int32, device=logw.device)
    stream = torch.cuda.current_stream(logw.device).cuda_stream
    err = lib.psvo_ancestor_indices(
        logw.data_ptr(), u0.data_ptr(), idx.data_ptr(), batch, k, stream
    )
    ancestor_indices.launches += 1
    _build.check(lib, err, "ancestor_indices")
    return idx


ancestor_indices.launches = 0


# ---------------------------------------------------------------------------
# K1 and K4 on thread-block clusters (csrc/cluster.cuh)
# ---------------------------------------------------------------------------


def cluster_size(batch: int, k: int, min_slice: int, max_active: dict) -> int:
    """C, the CTAs per trajectory row of K1 (min_slice 256) or K4 (64).

    max_active maps C to the number of clusters of C CTAs the card holds at
    once (0: the kernel does not fit at that C). Returns the largest C in
    `CLUSTER_SIZES` with K a multiple of C·min_slice (C = 1 needs nothing)
    whose B clusters all fit in one wave; else the smallest such C that fits
    at all, in several waves; else 1. The count is the card's own, not its
    SM count over C: a cluster needs its C SMs in one GPC, and the GPCs
    differ in size.
    """
    fits = [c for c in CLUSTER_SIZES
            if (c == 1 or k % (c * min_slice) == 0) and max_active.get(c, 0) > 0]
    one_wave = [c for c in fits if batch <= max_active[c]]
    if one_wave:
        return max(one_wave)
    return min(fits) if fits else 1


def k1_smem_bytes(consts, k: int) -> int:
    """Dynamic shared memory of one K1 CTA, any C
    (csrc/scan_forward.cu::fwd_smem_bytes): the fp64 CDF [K], the weights, the
    particles [2][Dx][K], the log-weights [2][K] and the reduction scratch."""
    warps = _THREADS // 32
    return 8 * (k + warps) + 4 * (consts["packed"].numel() + 2 * consts["dx"] * k + 2 * k + warps)


def max_active_clusters(kernel: int, device, consts, k: int) -> dict:
    """{C: clusters of C CTAs of K1 (`kernel` 0) or K4 (1) resident at once}
    on `device` at these constants and K, from the card's occupancy query
    (`psvo_max_active_clusters`); 0 where the CTA's shared memory exceeds
    `SMEM_LIMIT` or C does not divide K. Cached per (device, kernel, shape)."""
    smem = tuple((k1_smem_bytes(consts, k) if kernel == _K1 else k4_smem_bytes(consts, k, c))
                 if k % c == 0 else SMEM_LIMIT + 1 for c in CLUSTER_SIZES)
    return _max_active(kernel, torch.device(device).index, consts["dx"], consts["dy"],
                       consts["hidden"], smem)


@functools.cache
def _max_active(kernel, device_index, dx, dy, hidden, smem):
    lib = _build.load_library()
    out = {}
    for c, nbytes in zip(CLUSTER_SIZES, smem):
        n = ctypes.c_int(0)
        if nbytes <= SMEM_LIMIT:
            err = lib.psvo_max_active_clusters(kernel, dx, dy, hidden, c, nbytes,
                                               ctypes.addressof(n))
            _build.check(lib, err, "max_active_clusters")
        out[c] = n.value
    return out


def _pick_cluster(name: str, kernel: int, x0, consts, cluster) -> int:
    """The C of one K1 or K4 launch: `cluster` if given (checked), else
    cluster_size on the card's occupancy."""
    batch, k = x0.shape[0], x0.shape[-1]
    min_slice = K1_MIN_SLICE if kernel == _K1 else K4_MIN_SLICE
    if cluster is None:
        return cluster_size(batch, k, min_slice, max_active_clusters(kernel, x0.device, consts, k))
    if cluster not in CLUSTER_SIZES or (cluster > 1 and k % (cluster * min_slice)):
        raise ValueError(f"{name}: no cluster of {cluster} CTAs at K={k} (C in {CLUSTER_SIZES}, "
                         f"K a multiple of C·{min_slice})")
    return cluster


# ---------------------------------------------------------------------------
# K1: the whole forward scan
# ---------------------------------------------------------------------------


def _unpack_net(packed, offset: int, din: int, h: int, n_mid: int, dout: int):
    """One net's (layers, (W3, b3)) read out of prepare()'s buffer."""
    pos = offset

    def take(*shape):
        nonlocal pos
        n = math.prod(shape)
        t = packed[pos : pos + n].view(*shape)
        pos += n
        return t

    layers = [(take(din, h), take(h))]
    layers += [(take(h, h), take(h)) for _ in range(n_mid)]
    return layers, (take(h, dout), take(dout))


def _trunk_cm(net, x):
    """relu MLP mean on channel-major x [B, Din, K] -> [B, Dout, K]."""
    layers, (w3, b3) = net
    h = x
    for w, b in layers:
        h = torch.relu(torch.einsum("de,bdk->bek", w, h) + b[:, None])
    return torch.einsum("de,bdk->bek", w3, h) + b3[:, None]


def scan_forward_reference(x0, alpha0, coef, consts, eps, positions, cache: bool = False,
                           save_res: bool = False):
    """Plain version of K1: the same step math as a loop over t (stream mode).

    x0 [B, Dx, K], alpha0 [B, K], coef [T−1, B, 3·Dx + Dy + 1] (pack_coef),
    eps [T−1, B, Dx, K], positions [T−1, B, K]. Returns (x_last, alpha_last,
    stats [T−1, B, 2 + Dx] = (ℓ, ESS, filtered mean), x_all, alpha_all, idx):
    x_all [T−1, B, Dx, K] (x_new per step) is None unless `cache` or
    `save_res`, alpha_all unless `cache`, the int32 ancestors idx
    [T−1, B, K] unless `save_res` (the residuals of the backward).
    """
    scan_forward_reference.calls += 1
    nets = _unpack_nets(consts)
    x, lw = x0, alpha0
    stats, xs, alphas, idxs = [], [], [], []
    for t in range(coef.shape[0]):
        x_new, alpha, st, idx = _filter_step(nets, consts, x, lw, coef[t], eps[t], positions[t])
        stats.append(st)
        if cache or save_res:
            xs.append(x_new)
        if cache:
            alphas.append(alpha)
        if save_res:
            idxs.append(idx)
        x, lw = x_new, alpha
    x_all = torch.stack(xs) if xs else None
    alpha_all = torch.stack(alphas) if cache else None
    idx_all = torch.stack(idxs) if save_res else None
    return x, lw, torch.stack(stats), x_all, alpha_all, idx_all


scan_forward_reference.calls = 0


def _filter_step(nets, consts, x, lw, c, e, pos):
    """One step of the plain versions of K1 and K14: ESS of the incoming
    weights, the ancestors, the draw, α floored at −3e30, ℓ and the filtered
    mean. Returns (x_new, alpha, stats [B, 2 + Dx], idx)."""
    dx, dy = consts["dx"], consts["dy"]
    q1, f, g = nets
    aq, cq, sq = (c[:, i * dx : (i + 1) * dx, None] for i in range(3))
    y = c[:, 3 * dx : 3 * dx + dy, None]
    ab = c[:, -1:]
    # ESS of the incoming weights, then resample
    w = torch.exp(lw - torch.amax(lw, dim=-1, keepdim=True))
    ess = torch.sum(w, -1) ** 2 / torch.clamp(torch.sum(w * w, -1), min=1e-30)
    idx = count_form_indices(lw, pos)
    x_new, alpha = _propose_weight(q1, f, g, gather_particles(x, idx), e, aq, cq, sq, y, ab,
                                   consts["sconst"][:dx, None], consts["sconst"][dx:, None])
    alpha = torch.clamp(alpha, min=-3e30)
    # logZ increment and filtered mean
    amax = torch.amax(alpha, dim=-1, keepdim=True)
    w_new = torch.exp(alpha - amax)
    sw = torch.sum(w_new, dim=-1, keepdim=True)
    ell = torch.log(sw) + amax - math.log(x.shape[-1])
    fm = torch.einsum("bk,bdk->bd", w_new, x_new) / sw
    return x_new, alpha, torch.cat([ell, ess[:, None], fm], dim=-1), idx


def _unpack_nets(consts):
    """The (q1, f, g) nets read back out of prepare()'s buffer."""
    dx, dy, h, n_mid = consts["dx"], consts["dy"], consts["hidden"], consts["n_mid"]
    packed = consts["packed"]
    off_q1, off_f, off_g = consts["offsets"]
    return (_unpack_net(packed, off_q1, dx, h, n_mid, dx),
            _unpack_net(packed, off_f, dx, h, n_mid, dx),
            _unpack_net(packed, off_g, dx, h, n_mid, dy))


def _propose_weight(q1, f, g, x_res, e, aq, cq, sq, y, ab, sfi, sgi, x_new_value=None):
    """One step after the resample: the fused draw and the unfloored α. With
    x_new_value the draw takes that value (a kernel's saved output) and keeps
    its gradient to m1, aq, cq and sq."""
    m1, m_f = _trunk_cm(q1, x_res), _trunk_cm(f, x_res)
    x_new = cq * m1 + aq + sq * e
    if x_new_value is not None:
        x_new = x_new_value + (x_new - x_new.detach())
    z_f = (x_new - m_f) * sfi
    z_g = (y - _trunk_cm(g, x_new)) * sgi
    alpha = -0.5 * (torch.sum(z_f * z_f - e * e, 1) + torch.sum(z_g * z_g, 1)) + ab
    return x_new, alpha


def _require(t, shape, name, device, dtype=torch.float32):
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def scan_forward(x0, alpha0, coef, consts, *, eps=None, positions=None, seed=None,
                 cache: bool = False, save_res: bool = False, cluster=None):
    """K1: the forward filter's steps t = 1..T−1 in one launch.

    Noise either as streams (eps [T−1, B, Dx, K] and sorted positions
    [T−1, B, K]) or drawn in the kernel from `seed` (two uint32 words;
    systematic positions from per-step offsets, K2's streams). `save_res`
    also writes the backward's residuals, x_all and idx. Outputs as
    `scan_forward_reference`. CPU tensors run the plain version (in-kernel
    RNG replayed through K2's plain version); CUDA tensors launch the kernel
    on clusters of `cluster` CTAs per row (None: `cluster_size`'s choice),
    with the same bits for every C. It takes no gradient itself:
    differentiate through `ScanForward`.
    """
    if (seed is None) == (eps is None or positions is None):
        raise ValueError("scan_forward: pass either (eps, positions) or seed")
    t_len, batch = coef.shape[0], coef.shape[1]
    dx, dy, k = consts["dx"], consts["dy"], x0.shape[-1]
    if x0.device.type == "cpu":
        if seed is not None:
            eps, u0 = stream_noise_reference(seed, t_len, batch, dx, k, x0.device)
            positions = systematic_positions(u0, k)
        return scan_forward_reference(x0, alpha0, coef, consts, eps, positions, cache,
                                      save_res)
    if x0.device.type != "cuda":
        raise ValueError(f"scan_forward: unsupported device {x0.device}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x0, alpha0, coef, consts["packed"], consts["sconst"])
    ):
        raise RuntimeError(
            "scan_forward records no gradient: differentiate through ScanForward, "
            "or call it under torch.no_grad()"
        )
    return _launch_scan_forward(x0, alpha0, coef, consts, eps, positions, seed, cache,
                                save_res, cluster, torch.cuda.current_stream(x0.device).cuda_stream)


scan_forward.launches = 0
scan_forward.last_cluster = None


def _launch_scan_forward(x0, alpha0, coef, consts, eps, positions, seed, cache, save_res,
                         cluster, stream):
    """Check K1's operands, pick C, allocate the outputs and launch it on `stream`."""
    t_len, batch = coef.shape[0], coef.shape[1]
    dx, dy, k = consts["dx"], consts["dy"], x0.shape[-1]
    dev = x0.device
    h, n_mid = consts["hidden"], consts["n_mid"]
    if (dx, dy) not in KERNEL_DIMS or h not in HIDDEN_WIDTHS or not _k_ok(k):
        raise ValueError(
            f"scan_forward: no kernel for Dx={dx}, Dy={dy}, hidden={h}, K={k}"
        )
    cluster = _pick_cluster("scan_forward", _K1, x0, consts, cluster)
    _require(x0, (batch, dx, k), "x0", dev)
    _require(alpha0, (batch, k), "alpha0", dev)
    _require(coef, (t_len, batch, 3 * dx + dy + 1), "coef", dev)
    _require(consts["packed"], consts["packed"].shape, "weights", dev)
    _require(consts["sconst"], (dx + dy,), "sconst", dev)
    if seed is None:
        _require(eps, (t_len, batch, dx, k), "eps", dev)
        _require(positions, (t_len, batch, k), "positions", dev)
    f32 = dict(dtype=torch.float32, device=dev)
    x_last = torch.empty((batch, dx, k), **f32)
    alpha_last = torch.empty((batch, k), **f32)
    stats = torch.empty((t_len, batch, 2 + dx), **f32)
    x_all = torch.empty((t_len, batch, dx, k), **f32) if cache or save_res else None
    alpha_all = torch.empty((t_len, batch, k), **f32) if cache else None
    idx = torch.empty((t_len, batch, k), dtype=torch.int32, device=dev) if save_res else None

    seed0, seed1 = (0, 0) if seed is None else seed
    lib = _build.load_library()
    _, off_f, off_g = consts["offsets"]  # q1 sits at offset 0
    err = lib.psvo_scan_forward(
        x0.data_ptr(), alpha0.data_ptr(), coef.data_ptr(), _ptr(eps), _ptr(positions),
        consts["packed"].data_ptr(), consts["sconst"].data_ptr(),
        x_last.data_ptr(), alpha_last.data_ptr(), stats.data_ptr(),
        _ptr(x_all), _ptr(alpha_all), _ptr(idx),
        seed0, seed1, int(seed is not None), batch, k, t_len, dx, dy, h, n_mid,
        consts["packed"].numel(), off_f, off_g, cluster, stream,
    )
    scan_forward.launches += 1
    scan_forward.last_cluster = cluster
    _build.check(lib, err, "scan_forward")
    return x_last, alpha_last, stats, x_all, alpha_all, idx


# ---------------------------------------------------------------------------
# K4: the whole backward scan
# ---------------------------------------------------------------------------


def scan_backward_reference(x0, coef, consts, eps, idx, d_stats, d_x_last=None,
                            d_alpha_last=None, d_x_all=None, d_alpha_all=None):
    """Plain version of K4: replay the forward from x0 under autograd with the
    saved ancestors idx [T−1, B, K] as fixed (teacher-forced, so no ancestor
    can flip), then backpropagate the given cotangents.

    The contract is that of the TPU kernel's custom VJP
    (`pallas_step._scan_bwd`):
    - honoured: the ℓ cotangent (d_stats column 0), d_x_last, d_alpha_last
      and, under cache, d_x_all / d_alpha_all;
    - dropped: the cotangents of ESS and of the filtered mean (d_stats
      columns 1 and up), as `_propose_weight_bwd_core` reads only the ℓ lane;
    - none for α0 (it reaches the scan only through resampling and ESS), for
      ε, the positions and the seed, or for the observations y (coef columns
      3·Dx .. 3·Dx + Dy get zero);
    - the α cotangent is cut where the unfloored α < −3e30 (the gradient of
      torch.clamp).
    Missing cotangents (None) are zero. Returns (d_x0, d_coef [T−1, B,
    3·Dx + Dy + 1], d_packed, d_sconst).
    """
    scan_backward_reference.calls += 1
    return _replay_backward(x0, coef, consts, eps, idx, d_stats, d_x_last, d_alpha_last,
                            d_x_all, d_alpha_all)


scan_backward_reference.calls = 0


def _replay_backward(x0, coef, consts, eps, idx, d_stats, d_x_last=None, d_alpha_last=None,
                     d_x_all=None, d_alpha_all=None):
    """The plain versions of K4 and K15: scan_backward_reference's replay."""
    dx, dy = consts["dx"], consts["dy"]
    k = x0.shape[-1]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  (x0, coef, consts["packed"], consts["sconst"])]
        x0_, coef_, packed, sconst = leaves
        q1, f, g = _unpack_nets(dict(consts, packed=packed))
        sfi, sgi = sconst[:dx, None], sconst[dx:, None]
        x, ells, xs, alphas = x0_, [], [], []
        for t in range(coef.shape[0]):
            c = coef_[t]
            aq, cq, sq = (c[:, i * dx : (i + 1) * dx, None] for i in range(3))
            y = c[:, 3 * dx : 3 * dx + dy, None].detach()
            x_new, alpha = _propose_weight(q1, f, g, gather_particles(x, idx[t]), eps[t],
                                           aq, cq, sq, y, c[:, -1:], sfi, sgi)
            alpha = torch.clamp(alpha, min=-3e30)
            ells.append(torch.logsumexp(alpha, dim=-1) - math.log(k))
            xs.append(x_new)
            alphas.append(alpha)
            x = x_new
        pairs = [(torch.stack(ells), d_stats[..., 0]), (x, d_x_last), (alphas[-1], d_alpha_last),
                 (torch.stack(xs), d_x_all), (torch.stack(alphas), d_alpha_all)]
        outs, cots = zip(*[(o, c) for o, c in pairs if c is not None])
        grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    return tuple(torch.zeros_like(v) if gr is None else gr for gr, v in zip(grads, leaves))


def k4_smem_bytes(consts, k: int, cluster: int = 1) -> int:
    """Dynamic shared memory of one K4 CTA on a cluster of `cluster` CTAs per
    row (csrc/scan_backward.cu::bwd_smem_bytes): weights and their gradient
    sums, four [H][68] activation tiles, the [9·Dx + 2·Dy][68] tile arrays,
    the carry and d x_res of the slice [Dx][K/C] (d x_res twice and the
    slice's 3·Dx + 1 d_coef sums twice at C > 1), the reduction scratch and
    the int32 ancestors of the row [K]."""
    dx, dy, h = consts["dx"], consts["dy"], consts["hidden"]
    n_w = consts["packed"].numel()
    n = k // cluster
    slices = (3 * dx * n + 2 * (3 * dx + 1)) if cluster > 1 else 2 * dx * n
    floats = 2 * n_w + 4 * h * 68 + (9 * dx + 2 * dy) * 68 + slices + _THREADS // 32
    return 4 * floats + 4 * k


def _k4_ok(consts, k: int, cluster: int = 1) -> bool:
    """Whether K4 runs at these constants and K on clusters of `cluster`."""
    return ((consts["dx"], consts["dy"]) in KERNEL_DIMS and consts["hidden"] in HIDDEN_WIDTHS
            and consts["n_mid"] == 1 and _k_ok(k) and cluster in CLUSTER_SIZES
            and (cluster == 1 or k % (cluster * K4_MIN_SLICE) == 0)
            and k4_smem_bytes(consts, k, cluster) <= SMEM_LIMIT)


def scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, d_x_last=None,
                  d_alpha_last=None, d_x_all=None, d_alpha_all=None, *, eps=None, seed=None,
                  cluster=None):
    """K4: the VJP of K1 over all T−1 steps in one launch.

    Takes K1's inputs (x0, coef, consts and the noise: eps [T−1, B, Dx, K] or
    the `seed` it drew from) and its outputs under save_res: x_all, the int32
    ancestors idx, nondecreasing along K, and stats (for ℓ). Cotangents and
    outputs as `scan_backward_reference`, which CPU tensors run (in-kernel
    RNG replayed through K2's plain version); CUDA tensors launch the kernel
    on clusters of `cluster` CTAs per row (None: `cluster_size`'s choice;
    d_x0 has the same bits for every C, the sums agree to float32 rounding).
    The kernel is built for Dx = Dy = 2 and 3, hidden widths 16/32/64 with
    one middle layer, and K as far as its shared memory holds
    (`k4_smem_bytes`: at width 64, K up to 2304 at Dx = 2 and 1536 at 3 at
    C = 1; MAX_K and 3072 at C = 4).
    """
    if (seed is None) == (eps is None):
        raise ValueError("scan_backward: pass either eps or seed")
    t_len, batch = coef.shape[0], coef.shape[1]
    dx, k = consts["dx"], x0.shape[-1]
    if x0.device.type == "cpu":
        if seed is not None:
            eps = stream_noise_reference(seed, t_len, batch, dx, k, x0.device)[0]
        return scan_backward_reference(x0, coef, consts, eps, idx, d_stats, d_x_last,
                                       d_alpha_last, d_x_all, d_alpha_all)
    if x0.device.type != "cuda":
        raise ValueError(f"scan_backward: unsupported device {x0.device}")
    return _launch_scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, d_x_last,
                                 d_alpha_last, d_x_all, d_alpha_all, eps, seed, cluster,
                                 torch.cuda.current_stream(x0.device).cuda_stream)


scan_backward.launches = 0
scan_backward.last_cluster = None


def _k4_class(consts, k: int) -> bool:
    """Whether K4 runs at these constants and K on clusters of some size."""
    return any(_k4_ok(consts, k, c) for c in CLUSTER_SIZES)


def _launch_scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, d_x_last,
                          d_alpha_last, d_x_all, d_alpha_all, eps, seed, cluster, stream):
    """Check K4's operands, pick C, allocate the outputs and launch it on `stream`."""
    t_len, batch = coef.shape[0], coef.shape[1]
    dx, dy, k = consts["dx"], consts["dy"], x0.shape[-1]
    dev = x0.device
    if not _k4_class(consts, k):
        raise ValueError(
            f"scan_backward: no kernel for Dx={dx}, Dy={dy}, hidden={consts['hidden']}, "
            f"{consts['n_mid']} middle layers, K={k} ({k4_smem_bytes(consts, k)} B of shared "
            f"memory at C = 1, at most {SMEM_LIMIT})"
        )
    cluster = _pick_cluster("scan_backward", _K4, x0, consts, cluster)
    if not _k4_ok(consts, k, cluster):
        raise ValueError(f"scan_backward: no kernel at K={k} on clusters of {cluster} "
                         f"({k4_smem_bytes(consts, k, cluster)} B of shared memory, at most "
                         f"{SMEM_LIMIT})")
    _require(x0, (batch, dx, k), "x0", dev)
    _require(x_all, (t_len, batch, dx, k), "x_all", dev)
    _require(idx, (t_len, batch, k), "idx", dev, torch.int32)
    _require(stats, (t_len, batch, 2 + dx), "stats", dev)
    _require(coef, (t_len, batch, 3 * dx + dy + 1), "coef", dev)
    _require(consts["packed"], consts["packed"].shape, "weights", dev)
    _require(consts["sconst"], (dx + dy,), "sconst", dev)
    _require(d_stats, stats.shape, "d_stats", dev)
    for t, shape, name in ((eps, x_all.shape, "eps"), (d_x_last, x0.shape, "d_x_last"),
                           (d_alpha_last, (batch, k), "d_alpha_last"),
                           (d_x_all, x_all.shape, "d_x_all"),
                           (d_alpha_all, (t_len, batch, k), "d_alpha_all")):
        if t is not None:
            _require(t, shape, name, dev)
    n_w = consts["packed"].numel()
    f32 = dict(dtype=torch.float32, device=dev)
    d_x0 = torch.empty((batch, dx, k), **f32)
    d_coef = torch.empty(coef.shape, **f32)
    partial = torch.empty((batch * cluster, n_w + dx + dy), **f32)
    grads = torch.empty((n_w + dx + dy,), **f32)

    seed0, seed1 = (0, 0) if seed is None else seed
    lib = _build.load_library()
    _, off_f, off_g = consts["offsets"]
    err = lib.psvo_scan_backward(
        x0.data_ptr(), x_all.data_ptr(), idx.data_ptr(), stats.data_ptr(), coef.data_ptr(),
        _ptr(eps), consts["packed"].data_ptr(), consts["sconst"].data_ptr(),
        d_stats.data_ptr(), _ptr(d_x_last), _ptr(d_alpha_last), _ptr(d_x_all),
        _ptr(d_alpha_all), d_x0.data_ptr(), d_coef.data_ptr(), partial.data_ptr(),
        grads.data_ptr(), seed0, seed1, int(seed is not None), batch, k, t_len, dx, dy,
        consts["hidden"], consts["n_mid"], n_w, off_f, off_g, cluster, stream,
    )
    scan_backward.launches += 1
    scan_backward.last_cluster = cluster
    _build.check(lib, err, "scan_backward")
    return d_x0, d_coef, grads[:n_w], grads[n_w:]


# ---------------------------------------------------------------------------
# K1 + K4 as one differentiable operation
# ---------------------------------------------------------------------------


class ScanForward(torch.autograd.Function):
    """`scan_forward` with `scan_backward` as its VJP: the counterpart of
    `pallas_step._scan_call`'s custom VJP.

    apply(x0, alpha0, coef, packed, sconst, consts, eps, positions, seed,
    cache) returns (x_last, alpha_last, stats), plus (x_all, alpha_all) under
    cache. packed and sconst are consts["packed"] / consts["sconst"], passed
    apart so autograd sees them. When an input needs a gradient the forward
    saves the residuals (x0, x_all, idx, stats, coef, the weights and eps or
    the seed) and the backward runs K4 on them; alpha0 gets no gradient
    (see `scan_backward_reference`).
    """

    @staticmethod
    def forward(ctx, x0, alpha0, coef, packed, sconst, consts, eps, positions, seed, cache):
        consts = dict(consts, packed=packed, sconst=sconst)
        save = any(ctx.needs_input_grad)
        if save and x0.is_cuda and not _k4_class(consts, x0.shape[-1]):
            raise ValueError("ScanForward: this configuration has no backward kernel "
                             "(fused_step.scan_backward)")
        x_last, alpha_last, stats, x_all, alpha_all, idx = scan_forward(
            x0, alpha0, coef, consts, eps=eps, positions=positions, seed=seed, cache=cache,
            save_res=save,
        )
        if save:
            ctx.save_for_backward(x0, x_all, idx, stats, coef, packed, sconst, eps)
            ctx.static = {key: v for key, v in consts.items() if not torch.is_tensor(v)}
            ctx.seed, ctx.cache = seed, cache
        ctx.set_materialize_grads(False)
        if cache:
            return x_last, alpha_last, stats, x_all, alpha_all
        return x_last, alpha_last, stats

    @staticmethod
    def backward(ctx, d_x_last, d_alpha_last, d_stats, d_x_all=None, d_alpha_all=None):
        x0, x_all, idx, stats, coef, packed, sconst, eps = ctx.saved_tensors
        consts = dict(ctx.static, packed=packed, sconst=sconst)
        if d_stats is None:
            d_stats = torch.zeros_like(stats)

        def dense(t):
            return None if t is None else t.contiguous()

        d_x0, d_coef, d_packed, d_sconst = scan_backward(
            x0, x_all, idx, stats, coef, consts, dense(d_stats), dense(d_x_last),
            dense(d_alpha_last), dense(d_x_all), dense(d_alpha_all), eps=eps, seed=ctx.seed,
        )
        return d_x0, None, d_coef, d_packed, d_sconst, None, None, None, None, None


# ---------------------------------------------------------------------------
# K14 / K15: one filter step per launch (the per-step path, SCAN_FUSED off)
# ---------------------------------------------------------------------------


def step_forward_reference(x, logw, coef, consts, eps, positions):
    """Plain version of K14: one iteration of `scan_forward_reference`'s loop.

    x [B, Dx, K] and logw [B, K] of step t−1, coef [B, 3·Dx + Dy + 1] of step
    t (pack_coef's layout), eps [B, Dx, K], positions [B, K]. Returns (x_new,
    alpha, stats [B, 2 + Dx] = (ℓ, ESS, filtered mean), idx int32 [B, K]).
    """
    step_forward_reference.calls += 1
    return _filter_step(_unpack_nets(consts), consts, x, logw, coef, eps, positions)


step_forward_reference.calls = 0


# ---------------------------------------------------------------------------
# K14 and K15 on S CTAs per row (csrc/step_slices.cuh)
# ---------------------------------------------------------------------------


def step_slices(batch: int, k: int, min_slice: int, resident: int) -> int:
    """S, the CTAs per trajectory row of K14 (min_slice 256) or K15 (64).

    resident is the number of the kernel's CTAs the card holds at once.
    Returns the largest S in `STEP_SLICES` with K a multiple of S·min_slice
    whose B·S CTAs are all resident at once; else 1. The count is the card's
    own occupancy, not a constant.
    """
    fits = [s for s in STEP_SLICES if k % (s * min_slice) == 0 and batch * s <= resident]
    return max(fits, default=1)


def resident_ctas(kernel: int, device, consts, k: int) -> int:
    """CTAs of K14 (`kernel` 0) or K15 (1) resident at once on `device` at
    these constants and K, from the card's occupancy query
    (`psvo_step_max_active`). Cached per (device, kernel, shape)."""
    smem = k1_smem_bytes(consts, k) if kernel == _K14 else k15_smem_bytes(consts)
    return _resident(kernel, torch.device(device).index, consts["dx"], consts["dy"],
                     consts["hidden"], smem)


@functools.cache
def _resident(kernel, device_index, dx, dy, hidden, smem):
    lib = _build.load_library()
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.psvo_step_max_active(kernel, dx, dy, hidden, smem, ctypes.addressof(n))
    _build.check(lib, err, "step_max_active")
    return n.value


def _pick_slices(name: str, kernel: int, x, consts, slices) -> int:
    """The S of one K14 or K15 launch: `slices` if given (checked), else
    step_slices on the card's occupancy."""
    batch, k = x.shape[0], x.shape[-1]
    min_slice = K1_MIN_SLICE if kernel == _K14 else K4_MIN_SLICE
    if slices is None:
        return step_slices(batch, k, min_slice, resident_ctas(kernel, x.device, consts, k))
    if slices not in STEP_SLICES or (slices > 1 and k % (slices * min_slice)):
        raise ValueError(f"{name}: no split into {slices} slices at K={k} (S in {STEP_SLICES}, "
                         f"K a multiple of S·{min_slice})")
    return slices


_COUNTERS = {}


def _arrival_counters(device, stream: int, batch: int):
    """The rows' arrival counters of K14 and K15 on `stream`: int32 zeros,
    at least `batch` of them, which every launch leaves at zero. Allocated
    once per (device, stream), and again only for a larger batch: no launch
    clears them, and two streams never share them."""
    key = (str(device), stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < batch:
        counters = _COUNTERS[key] = torch.zeros(batch, dtype=torch.int32, device=device)
    return counters


def step_forward(x, logw, coef, consts, eps, positions, *, slices=None):
    """K14: one filter step, operands and outputs as `step_forward_reference`.
    CPU tensors run the plain version; CUDA tensors launch the kernel on
    `slices` CTAs per row (None: `step_slices`'s choice), with the same bits
    for every S. It takes no gradient itself: differentiate through
    `StepForward`."""
    if x.device.type == "cpu":
        return step_forward_reference(x, logw, coef, consts, eps, positions)
    if x.device.type != "cuda":
        raise ValueError(f"step_forward: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, logw, coef, consts["packed"], consts["sconst"])
    ):
        raise RuntimeError(
            "step_forward records no gradient: differentiate through StepForward, "
            "or call it under torch.no_grad()"
        )
    return _launch_step_forward(x, logw, coef, consts, eps, positions, slices,
                                torch.cuda.current_stream(x.device).cuda_stream)


step_forward.launches = 0
step_forward.last_slices = None


def _launch_step_forward(x, logw, coef, consts, eps, positions, slices, stream):
    """Check K14's operands, pick S, allocate its outputs and launch it on `stream`."""
    dx, dy, h = consts["dx"], consts["dy"], consts["hidden"]
    batch, k = logw.shape
    dev = x.device
    if (dx, dy) not in KERNEL_DIMS or h not in HIDDEN_WIDTHS or not _k_ok(k):
        raise ValueError(f"step_forward: no kernel for Dx={dx}, Dy={dy}, hidden={h}, K={k}")
    slices = _pick_slices("step_forward", _K14, x, consts, slices)
    _require(x, (batch, dx, k), "x", dev)
    _require(logw, (batch, k), "logw", dev)
    _require(coef, (batch, 3 * dx + dy + 1), "coef", dev)
    _require(eps, (batch, dx, k), "eps", dev)
    _require(positions, (batch, k), "positions", dev)
    _require(consts["packed"], consts["packed"].shape, "weights", dev)
    _require(consts["sconst"], (dx + dy,), "sconst", dev)
    f32 = dict(dtype=torch.float32, device=dev)
    x_new = torch.empty((batch, dx, k), **f32)
    alpha = torch.empty((batch, k), **f32)
    stats = torch.empty((batch, 2 + dx), **f32)
    idx = torch.empty((batch, k), dtype=torch.int32, device=dev)
    counters = _arrival_counters(dev, stream, batch)
    lib = _build.load_library()
    _, off_f, off_g = consts["offsets"]
    err = lib.psvo_step_forward(
        x.data_ptr(), logw.data_ptr(), coef.data_ptr(), eps.data_ptr(), positions.data_ptr(),
        consts["packed"].data_ptr(), consts["sconst"].data_ptr(), x_new.data_ptr(),
        alpha.data_ptr(), stats.data_ptr(), idx.data_ptr(), counters.data_ptr(), batch, k, dx,
        dy, h, consts["n_mid"], consts["packed"].numel(), off_f, off_g, slices, stream,
    )
    step_forward.launches += 1
    step_forward.last_slices = slices
    _build.check(lib, err, "step_forward")
    return x_new, alpha, stats, idx


def step_backward_reference(x, coef, consts, eps, idx, d_stats, d_x_new=None, d_alpha=None):
    """Plain version of K15: the VJP of one K14 step, an autograd replay of
    `step_forward_reference` on the saved ancestors idx [B, K], under
    `scan_backward_reference`'s contract (ℓ's cotangent honoured, those of
    the ESS and the filtered mean dropped, none for logw, the positions or ε,
    zero for y, the α cotangent cut below −3e30). Returns (d_x, d_coef
    [B, 3·Dx + Dy + 1], d_packed, d_sconst)."""
    step_backward_reference.calls += 1
    d_x, d_coef, d_packed, d_sconst = _replay_backward(
        x, coef[None], consts, eps[None], idx[None], d_stats[None], d_x_new, d_alpha)
    return d_x, d_coef[0], d_packed, d_sconst


step_backward_reference.calls = 0


def k15_smem_bytes(consts) -> int:
    """Dynamic shared memory of one K15 CTA, any K and S
    (csrc/scan_backward.cu::bwd_smem_bytes): K4's (`k4_smem_bytes`) without
    the carry, d x_res and the ancestors, which K15 keeps in device memory."""
    return k4_smem_bytes(consts, 0)


def _k15_ok(consts, k: int) -> bool:
    return ((consts["dx"], consts["dy"]) in KERNEL_DIMS and consts["hidden"] in HIDDEN_WIDTHS
            and consts["n_mid"] == 1 and _k_ok(k) and k15_smem_bytes(consts) <= SMEM_LIMIT)


def step_backward(x, x_new, idx, stats, coef, consts, eps, d_stats, d_x_new=None,
                  d_alpha=None, *, slices=None):
    """K15: the VJP of one K14 step from its residuals: its input x and its
    outputs x_new, the int32 ancestors idx (nondecreasing along K) and stats
    (for ℓ), with its coef row and ε. Cotangents and outputs as
    `step_backward_reference`, which CPU tensors run; CUDA tensors launch the
    kernel on `slices` CTAs per row (None: `step_slices`'s choice; d_x has
    the same bits for every S, the sums agree to float32 rounding). It is
    built for Dx = Dy = 2 and 3, hidden widths 16/32/64 with one middle
    layer, and every K up to MAX_K (`k15_smem_bytes` does not depend on K)."""
    if x.device.type == "cpu":
        return step_backward_reference(x, coef, consts, eps, idx, d_stats, d_x_new, d_alpha)
    if x.device.type != "cuda":
        raise ValueError(f"step_backward: unsupported device {x.device}")
    return _launch_step_backward(x, x_new, idx, stats, coef, consts, eps, d_stats, d_x_new,
                                 d_alpha, slices, torch.cuda.current_stream(x.device).cuda_stream)


step_backward.launches = 0
step_backward.last_slices = None


def _launch_step_backward(x, x_new, idx, stats, coef, consts, eps, d_stats, d_x_new, d_alpha,
                          slices, stream):
    """Check K15's operands, pick S, allocate its outputs and scratch and
    launch it on `stream`."""
    dx, dy = consts["dx"], consts["dy"]
    batch, _, k = x.shape
    dev = x.device
    if not _k15_ok(consts, k):
        raise ValueError(
            f"step_backward: no kernel for Dx={dx}, Dy={dy}, hidden={consts['hidden']}, "
            f"{consts['n_mid']} middle layers, K={k} ({k15_smem_bytes(consts)} B of shared "
            f"memory, at most {SMEM_LIMIT})"
        )
    slices = _pick_slices("step_backward", _K15, x, consts, slices)
    _require(x, (batch, dx, k), "x", dev)
    _require(x_new, (batch, dx, k), "x_new", dev)
    _require(idx, (batch, k), "idx", dev, torch.int32)
    _require(stats, (batch, 2 + dx), "stats", dev)
    _require(coef, (batch, 3 * dx + dy + 1), "coef", dev)
    _require(eps, (batch, dx, k), "eps", dev)
    _require(consts["packed"], consts["packed"].shape, "weights", dev)
    _require(consts["sconst"], (dx + dy,), "sconst", dev)
    _require(d_stats, stats.shape, "d_stats", dev)
    if d_x_new is not None:
        _require(d_x_new, x.shape, "d_x_new", dev)
    if d_alpha is not None:
        _require(d_alpha, (batch, k), "d_alpha", dev)
    n_w = consts["packed"].numel()
    f32 = dict(dtype=torch.float32, device=dev)
    d_x = torch.empty((batch, dx, k), **f32)
    d_coef = torch.empty(coef.shape, **f32)
    dxres = torch.empty((batch, dx, k), **f32)
    coef_part = torch.empty((batch, slices, 3 * dx + 1), **f32)
    partial = torch.empty((batch * slices, n_w + dx + dy), **f32)
    grads = torch.empty((n_w + dx + dy,), **f32)
    counters = _arrival_counters(dev, stream, batch)
    lib = _build.load_library()
    _, off_f, off_g = consts["offsets"]
    err = lib.psvo_step_backward(
        x.data_ptr(), x_new.data_ptr(), idx.data_ptr(), stats.data_ptr(), coef.data_ptr(),
        eps.data_ptr(), consts["packed"].data_ptr(), consts["sconst"].data_ptr(),
        d_stats.data_ptr(), _ptr(d_x_new), _ptr(d_alpha), d_x.data_ptr(), d_coef.data_ptr(),
        dxres.data_ptr(), coef_part.data_ptr(), partial.data_ptr(), grads.data_ptr(),
        counters.data_ptr(), batch, k, dx, dy, consts["hidden"], consts["n_mid"], n_w, off_f,
        off_g, slices, stream,
    )
    step_backward.launches += 1
    step_backward.last_slices = slices
    _build.check(lib, err, "step_backward")
    return d_x, d_coef, grads[:n_w], grads[n_w:]


class StepForward(torch.autograd.Function):
    """`step_forward` with `step_backward` as its VJP: the counterpart of
    `pallas_step._step_call`'s custom VJP.

    apply(x, logw, coef, packed, sconst, consts, eps, positions) returns
    (x_new, alpha, stats) of one step. packed and sconst are
    consts["packed"] / consts["sconst"], passed apart so autograd sees them.
    When an input needs a gradient the forward keeps x, x_new, idx, stats,
    coef, the weights and eps (views or outputs the chain holds anyway, plus
    idx and stats), and the backward runs K15 on them; logw, eps and the
    positions get no gradient.
    """

    @staticmethod
    def forward(ctx, x, logw, coef, packed, sconst, consts, eps, positions):
        consts = dict(consts, packed=packed, sconst=sconst)
        save = any(ctx.needs_input_grad)
        if save and x.is_cuda and not _k15_ok(consts, x.shape[-1]):
            raise ValueError("StepForward: this configuration has no backward kernel "
                             "(fused_step.step_backward)")
        x_new, alpha, stats, idx = step_forward(x, logw, coef, consts, eps, positions)
        if save:
            ctx.save_for_backward(x, x_new, idx, stats, coef, packed, sconst, eps)
            ctx.static = {key: v for key, v in consts.items() if not torch.is_tensor(v)}
        ctx.set_materialize_grads(False)
        return x_new, alpha, stats

    @staticmethod
    def backward(ctx, d_x_new, d_alpha, d_stats):
        x, x_new, idx, stats, coef, packed, sconst, eps = ctx.saved_tensors
        consts = dict(ctx.static, packed=packed, sconst=sconst)
        d_stats = torch.zeros_like(stats) if d_stats is None else d_stats.contiguous()
        d_x, d_coef, d_packed, d_sconst = step_backward(
            x, x_new, idx, stats, coef, consts, eps, d_stats,
            None if d_x_new is None else d_x_new.contiguous(),
            None if d_alpha is None else d_alpha.contiguous(),
        )
        return d_x, None, d_coef, d_packed, d_sconst, None, None, None
