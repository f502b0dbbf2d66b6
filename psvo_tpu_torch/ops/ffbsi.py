"""FFBSi reverse-sweep kernels and their plain versions (counterpart of
`psvo_tpu/ops/pallas_ffbsi.py`).

Two hand-written CUDA kernels (`psvo_tpu_torch/csrc/ffbsi.cu`, built by
`ops/_build.py`), each behind a wrapper that launches it for CUDA tensors and
runs its plain PyTorch version for CPU tensors — never the plain version on
the card:

- K5 `ffbsi_forward` (replaces `pallas_ffbsi._scan_fwd`, the whole-sweep
  forward kernel): the FFBSi reverse sweep t = T−2 … 0 in one launch. Per
  step and smoothed path, with q = x̃_{t+1}:
    pair   = max(−½·Σ_d q_d²·r_d + Σ_d q_d·mr_d + c, −1e30)
    logits = pair + lwn;  idx = argmax(logits + gum), first maximum on ties
    logq  += pair[idx] + lwn[idx] − lse(logits);  logp += pair[idx] + lg[idx]
    x̃_t    = xs[:, idx]
  It also returns the selections, which K6 reads instead of recomputing the
  argmax. Plain version: `ffbsi_forward_reference`, a loop over t of the
  body of `objectives._make_ffbsi_body`. Two designs, with the same outputs
  bit for bit; the path runs "staged" (`ffbsi_staged_kernel`): a CTA serves
  `k5_paths` paths of one row from the row's operands, copied into shared
  memory a chunk (`k5_chunk`) ahead of the compute. "path"
  (`ffbsi_forward_kernel`, the previous design: one CTA a path, loading its
  row's operands from L2 every step) stays callable with `design="path"`
  as its yardstick.
- K6 `ffbsi_backward` (replaces `pallas_ffbsi._scan_bwd`, the VJP kernel):
  the VJP of K5 on K5's selections. Plain version: `ffbsi_backward_reference`,
  an autograd replay of the sweep with the selections held fixed. Two
  designs; the path runs "staged": without pair cotangents a persistent
  grid zeroes d_xs row by row and patches the selected particles; with
  them a persistent grid walks the (t, b) rows, each staged in shared
  memory (`k6_smem_bytes`) a row ahead, and evaluates each pair once,
  threads owning K6_PER consecutive particles, K6_GROUP paths at a time
  (rows past K6_CHUNK particles: a CTA per (t, b), in chunks). "row"
  (`ffbsi_backward_kernel`, the previous design: one CTA per (t, b), three
  passes of the pair) stays callable with `design="row"`.

The staged kernels are templates over Dx in {2, 3} (`KERNEL_DX`), and K6's
holds per-path state for at most `MAX_M` paths. At every other shape of the
reference's class (any Dx, M a multiple of 8, K up to `MAX_K`) the staged
design runs the wide kernels (`ffbsi_wide_kernel`, `ffbsi_bwd_wide_kernel`;
`staged_kernel` picks the kernel, the wrapper passes it to the C entry
point), which take Dx as a runtime loop: K5 a CTA of P paths of a row
reading each step's r and mr once for them, K6 a persistent grid of
`k6_wide_ctas` CTAs, each walking (t, b) rows in four passes over its own
row of scratch, the row's pairs (`k6_wide_chunk`). The preset shapes keep
their kernels and bits.

`FFBSiSweep` joins them as one `torch.autograd.Function` with the gradient
contract of `pallas_ffbsi.ffbsi_scan`'s custom VJP: no gradient through the
discrete choice, none for gum, cotangents to x_anchor, xs, r, mr, c, lwn and
lg. Each wrapper carries a launch count (`<wrapper>.launches`), raised only
where the kernel is launched (also by design, `.launches_by_design`);
each plain version a call count (`.calls`).

Layout: x_anchor [B, M, Dx]; xs, r, mr [T−1, B, Dx, K]; c, lwn, lg
[T−1, B, K]; gum [T−1, B, M, K], all float32. Outputs: x_first [B, M, Dx]
(= x̃_0), logp and logq [B, M] (the in-sweep sums only: the anchor's and the
prior's terms are added outside), xtilde [T−1, B, M, Dx] with xtilde[t] =
x̃_t, and the int32 selections sel [T−1, B, M]. The TPU kernel's DP = 8
channel padding is not kept.

The pairwise density is the reference's expanded form, computed from the
same r/mr/c in one fixed order of terms (`pair_logp`) with every product and
sum rounded on its own, in the kernels as in the plain versions: both see the
same logits bit for bit and so pick the same particles.
"""

from __future__ import annotations

import torch

from psvo_tpu_torch.distributions import _MIN_LOGP
from psvo_tpu_torch.ops import _build
from psvo_tpu_torch.ops.fused_step import SMEM_LIMIT, _ptr, _require

KERNEL_DX = (2, 3)  # state widths the staged kernels are instantiated for
MAX_M = 256  # smoothed paths per row of the staged K6 (per-path state in shared memory)
MAX_K = 2048  # the wide kernels' class in K: the reference's (pallas_ffbsi.MAX_K)
DESIGNS = ("staged", "path")  # K5's designs: the one the path runs, the previous one
PATHS_PER_CTA = (1, 2, 4, 8)  # K5 staged: paths of one row a CTA serves
K6_DESIGNS = ("staged", "row")  # K6's designs: the one the path runs, the previous one
K6_PER = 4  # K6 staged: consecutive particles a thread owns
K6_CHUNK = 256 * K6_PER  # K6 staged: particles a pass covers (longer rows go in chunks)
K6_GROUP = 8  # K6 staged: paths whose logits a thread holds at once
K6_WIDE_PER_SM = 2  # K6 wide: CTAs an SM its grid holds (its residency at Lorenz-96's width)
_C_KERNELS = ("staged", "path", "wide")  # K5's kernels by their C design index
_C_K6_KERNELS = ("staged", "row", "wide")  # K6's kernels by their C design index
_THREADS = 256
_STATIC_SMEM = 24576  # K5 staged: bytes kept for its static shared memory (the lse window)


def usable(dx: int, m: int, k: int, f_tril: bool = False) -> bool:
    """Whether a sweep of Dx = dx with m smoothed paths over k particles is
    in K5/K6's class: the staged kernels' (Dx in `KERNEL_DX`,
    1 <= m <= `MAX_M`, any K), or the wide kernels' (the
    reference's class, `pallas_ffbsi.py:51-63`: any Dx up to K6's shared
    memory, `k6_wide_chunk`; m a multiple of 8; K up to `MAX_K`). A model
    with controls too (the support terms r, mr and c take them, so the
    kernels read none), but not, as the reference's gate
    (`pallas_ffbsi.py:58`), a full-covariance transition (`f_tril`: cov_type
    "tril" or "tril_head" on f), whose pairwise density is not the diagonal
    r/mr/c form."""
    if f_tril:
        return False
    if dx in KERNEL_DX and 1 <= m <= MAX_M:
        return True
    return dx >= 1 and k6_wide_chunk(dx) > 0 and m >= 8 and m % 8 == 0 and 1 <= k <= MAX_K


def staged_kernel(dx: int, m: int, backward: bool = False) -> str:
    """Which kernel the staged design (the path's) launches for K5, or with
    `backward` for K6: "staged" at Dx in `KERNEL_DX` (K6: and m <= `MAX_M`),
    else "wide"."""
    return "staged" if dx in KERNEL_DX and (not backward or m <= MAX_M) else "wide"


def k6_wide_chunk(dx: int) -> int:
    """Particles a chunk of K6 wide's per-particle pass covers (its `chunk`
    argument): the widest of 256, 128, 64 and 32 whose [2 Dx][chunk] float
    sums fit a CTA's shared memory; 0 where none does (Dx > 908)."""
    kc = _THREADS
    while kc >= 32 and 8 * dx * kc > SMEM_LIMIT:
        kc //= 2
    return kc if kc >= 32 else 0


def k6_wide_ctas(t_len: int, batch: int, n_sms: int) -> int:
    """CTAs of K6 wide's persistent grid: one a (t, b) row up to
    `K6_WIDE_PER_SM` an SM. Its scratch is [ctas, M, K + 2 + Dx] floats (at
    Lorenz-96, M = 16, K = 1024, on 132 SMs: 18.0 MB), whatever T and B."""
    return max(1, min(t_len * batch, K6_WIDE_PER_SM * n_sms))


def k5_paths(batch: int, m: int, n_sms: int) -> int:
    """Paths of one row a CTA of K5's staged design serves: the fewest in
    PATHS_PER_CTA whose batch * ceil(m / P) CTAs fit the card's SMs in one
    wave, else the most (each CTA then reads its row's operands for more
    paths)."""
    for p in PATHS_PER_CTA:
        if batch * -(-m // p) <= n_sms:
            return p
    return PATHS_PER_CTA[-1]


def _slot_bytes(dx: int, chunk: int, p: int) -> int:
    """One slot of K5's staged design: a chunk's r, mr, xs (Dx rows each), c,
    lwn, lg and p Gumbel rows, each row `chunk` floats rounded up to 4."""
    return 4 * (3 * dx + 3 + p) * ((chunk + 3) // 4 * 4)


def k5_slots(dx: int, k: int, p: int) -> int:
    """Slots of K5's staged ring (csrc/ffbsi.cu::ffbsi_staged_slots): 3 where
    three fit a CTA's shared memory, else 2."""
    chunk = min(k5_chunk(dx, k, p), k)
    return 3 if 3 * _slot_bytes(dx, chunk, p) <= SMEM_LIMIT - _STATIC_SMEM else 2


def k5_smem_bytes(dx: int, k: int, p: int) -> int:
    """Dynamic shared memory of K5's staged design at K = k: `k5_slots`
    slots of a `k5_chunk` chunk; off `KERNEL_DX` the wide kernel's, the P
    paths' queries and their squares."""
    if dx not in KERNEL_DX:
        return 4 * 2 * p * dx
    return k5_slots(dx, k, p) * _slot_bytes(dx, min(k5_chunk(dx, k, p), k), p)


def k5_chunk(dx: int, k: int, p: int) -> int:
    """Particles a stage of K5's staged design copies: the whole row where two
    slots of it fit a CTA's shared memory, else the largest multiple of 256
    that fits (each thread then sees its particles in the same order)."""
    budget = SMEM_LIMIT - _STATIC_SMEM
    if 2 * _slot_bytes(dx, k, p) <= budget:
        return k
    return budget // (2 * _slot_bytes(dx, _THREADS, p)) * _THREADS


def pair_logp(q, r, mr, c):
    """The pairwise log f(q_m | support_j) before the floor: queries q
    [B, M, Dx] against one step's support terms r, mr [B, Dx, K] and c
    [B, K] -> [B, M, K]. Computed as (−½·t1 + t2) + c with
    t1 = Σ_d (q_d·q_d)·r_d and t2 = Σ_d q_d·mr_d, d ascending, each operation
    rounded on its own: the arithmetic of K5 and K6."""
    qq = q * q
    t1 = qq[..., 0, None] * r[:, None, 0]
    t2 = q[..., 0, None] * mr[:, None, 0]
    for d in range(1, q.shape[-1]):
        t1 = t1 + qq[..., d, None] * r[:, None, d]
        t2 = t2 + q[..., d, None] * mr[:, None, d]
    return -0.5 * t1 + t2 + c[:, None]


def _gather_paths(x, idx):
    """x [B, Dx, K], idx [B, M] -> x[b, :, idx[b, m]] as [B, M, Dx]."""
    index = idx[:, None, :].expand(-1, x.shape[1], -1)
    return torch.gather(x, 2, index).transpose(1, 2)


def _pick(v, idx):
    """v [B, K] or [B, M, K], idx [B, M] -> v at idx, [B, M]."""
    if v.dim() == 2:
        return torch.gather(v, 1, idx)
    return torch.gather(v, 2, idx[..., None])[..., 0]


def _sweep_step(x, xs, r, mr, c, lwn, lg, logp, logq, *, idx=None, gum=None):
    """One reverse step from the query x [B, M, Dx] over one step's support
    (xs, r, mr [B, Dx, K]; c, lwn, lg [B, K]); draws idx [B, M] from gum
    [B, M, K] unless it is given. Returns (x̃_t, logp, logq, idx)."""
    pair = torch.clamp(pair_logp(x, r, mr, c), min=_MIN_LOGP)
    logits = pair + lwn[:, None]
    if idx is None:
        idx = torch.argmax(logits + gum, dim=-1)
    pair_sel = _pick(pair, idx)
    logq = logq + pair_sel + _pick(lwn, idx) - torch.logsumexp(logits, dim=-1)
    logp = logp + pair_sel + _pick(lg, idx)
    return _gather_paths(xs, idx), logp, logq, idx


def _check_sweep(x_anchor, xs, r, mr, c, lwn, lg, what, previous=False):
    """Shapes, type, device and contiguity of a sweep's operands, in the
    class of the staged design (its wide kernels included) or, with
    `previous`, of the previous designs; returns (T−1, B, M, Dx, K)."""
    if xs.dim() != 4 or x_anchor.dim() != 3:
        raise ValueError(f"{what}: xs must be [T-1, B, Dx, K] and x_anchor [B, M, Dx]")
    t_len, batch, dx, k = xs.shape
    m = x_anchor.shape[1]
    ok = (dx in KERNEL_DX and m <= MAX_M) if previous else (dx in KERNEL_DX
                                                            or k6_wide_chunk(dx) > 0)
    if not ok or m < 1 or t_len < 1:
        raise ValueError(f"{what}: no kernel for Dx={dx}, M={m}, T-1={t_len} (the staged "
                         f"design: any M >= 1 and Dx up to 908; the previous designs: Dx in "
                         f"{KERNEL_DX}, M <= {MAX_M})")
    dev = x_anchor.device
    _require(x_anchor, (batch, m, dx), "x_anchor", dev)
    for t, name in ((xs, "xs"), (r, "r"), (mr, "mr")):
        _require(t, (t_len, batch, dx, k), name, dev)
    for t, name in ((c, "c"), (lwn, "lwn"), (lg, "lg")):
        _require(t, (t_len, batch, k), name, dev)
    return t_len, batch, m, dx, k


# ---------------------------------------------------------------------------
# K5: the whole reverse sweep
# ---------------------------------------------------------------------------


def ffbsi_forward_reference(x_anchor, xs, r, mr, c, lwn, lg, gum):
    """Plain version of K5: the reverse sweep as a loop over t = T−2 … 0.
    Operands and outputs as the module docstring says."""
    ffbsi_forward_reference.calls += 1
    t_len = c.shape[0]
    x = x_anchor
    logp = torch.zeros(x_anchor.shape[:2], dtype=x_anchor.dtype, device=x_anchor.device)
    logq = torch.zeros_like(logp)
    xts, sels = [None] * t_len, [None] * t_len
    for t in reversed(range(t_len)):
        x, logp, logq, idx = _sweep_step(x, xs[t], r[t], mr[t], c[t], lwn[t], lg[t], logp, logq,
                                         gum=gum[t])
        xts[t], sels[t] = x, idx.to(torch.int32)
    return x.contiguous(), logp, logq, torch.stack(xts), torch.stack(sels)


ffbsi_forward_reference.calls = 0


def ffbsi_forward(x_anchor, xs, r, mr, c, lwn, lg, gum, design: str = "staged"):
    """K5: the FFBSi reverse sweep in one launch. Returns (x_first, logp,
    logq, xtilde, sel). CPU tensors run the plain version; CUDA tensors
    launch the kernel of `design` ("staged", the default and the only one
    the path runs: a CTA serves `k5_paths` paths of a row from operands
    staged a chunk ahead in shared memory, or off `KERNEL_DX` from device
    memory in the wide kernel (`staged_kernel`); "path", the previous design, one
    CTA a path, kept as its yardstick), or raise for a shape outside its
    class. It takes no gradient itself: differentiate through
    `FFBSiSweep`."""
    if design not in DESIGNS:
        raise ValueError(f"ffbsi_forward: no design {design!r} (one of {DESIGNS})")
    if x_anchor.device.type == "cpu":
        return ffbsi_forward_reference(x_anchor, xs, r, mr, c, lwn, lg, gum)
    if x_anchor.device.type != "cuda":
        raise ValueError(f"ffbsi_forward: unsupported device {x_anchor.device}")
    t_len, batch, m, dx, k = _check_sweep(x_anchor, xs, r, mr, c, lwn, lg,
                                          f"ffbsi_forward ({design})", design != "staged")
    dev = x_anchor.device
    _require(gum, (t_len, batch, m, k), "gum", dev)
    p = k5_paths(batch, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    chunk = k5_chunk(dx, k, p)
    kernel = staged_kernel(dx, m) if design == "staged" else design
    f32 = dict(dtype=torch.float32, device=dev)
    x_first = torch.empty((batch, m, dx), **f32)
    logp = torch.empty((batch, m), **f32)
    logq = torch.empty((batch, m), **f32)
    xtilde = torch.empty((t_len, batch, m, dx), **f32)
    sel = torch.empty((t_len, batch, m), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    err = lib.psvo_ffbsi_forward(
        x_anchor.data_ptr(), xs.data_ptr(), r.data_ptr(), mr.data_ptr(), c.data_ptr(),
        lwn.data_ptr(), lg.data_ptr(), gum.data_ptr(), x_first.data_ptr(), logp.data_ptr(),
        logq.data_ptr(), xtilde.data_ptr(), sel.data_ptr(), batch, m, k, t_len, dx,
        _C_KERNELS.index(kernel), p, chunk, torch.cuda.current_stream(dev).cuda_stream,
    )
    ffbsi_forward.launches += 1
    ffbsi_forward.launches_by_design[design] += 1
    _build.check(lib, err, f"ffbsi_forward ({design})")
    return x_first, logp, logq, xtilde, sel


ffbsi_forward.launches = 0
ffbsi_forward.launches_by_design = dict.fromkeys(DESIGNS, 0)  # which kernel the launches ran


# ---------------------------------------------------------------------------
# K6: its VJP
# ---------------------------------------------------------------------------


def ffbsi_backward_reference(x_anchor, xs, r, mr, c, lwn, lg, sel, xtilde=None, d_x_first=None,
                             d_logp=None, d_logq=None, d_xtilde=None, needs=(True,) * 5):
    """Plain version of K6: replay the sweep from x_anchor under autograd
    with the selections sel [T−1, B, M] held fixed, then backpropagate the
    given cotangents (None: zero). xtilde is K6's operand and is not read
    here: the replay regathers it.

    The contract is that of the TPU kernel's custom VJP
    (`pallas_ffbsi._scan_bwd`): no gradient through the selections, none for
    gum; the pair cotangent is cut where the unfloored pair < −1e30 (the
    gradient of torch.clamp). Returns (d_x_anchor, d_xs, d_r, d_mr, d_c,
    d_lwn, d_lg); d_r … d_lg are None where `needs` (flags for r, mr, c, lwn,
    lg) says so.
    """
    ffbsi_backward_reference.calls += 1
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x_anchor, xs, r, mr, c, lwn, lg)]
        x, xs_, r_, mr_, c_, lwn_, lg_ = leaves
        logp = torch.zeros(x_anchor.shape[:2], dtype=x_anchor.dtype, device=x_anchor.device)
        logq = torch.zeros_like(logp)
        xts = [None] * c.shape[0]
        for t in reversed(range(c.shape[0])):
            x, logp, logq, _ = _sweep_step(x, xs_[t], r_[t], mr_[t], c_[t], lwn_[t], lg_[t], logp,
                                           logq, idx=sel[t].long())
            xts[t] = x
        pairs = [(x, d_x_first), (logp, d_logp), (logq, d_logq), (torch.stack(xts), d_xtilde)]
        live = [(o, g) for o, g in pairs if g is not None]
        grads = [None] * len(leaves)
        if live:
            outs, cots = zip(*live)
            grads = list(torch.autograd.grad(outs, leaves, cots, allow_unused=True))
    grads = [torch.zeros_like(v) if g is None else g for g, v in zip(grads, leaves)]
    return (*grads[:2], *(g if need else None for g, need in zip(grads[2:], needs)))


ffbsi_backward_reference.calls = 0


def k6_smem_bytes(dx: int, m: int, k: int) -> int:
    """Dynamic shared memory of K6-staged's all-cotangents kernel
    (csrc/ffbsi.cu::k6_layout). A row buffer: r, mr, c, lwn of K particles
    (at most K6_CHUNK; rows rounded up to 4), the queries, three cotangent
    blocks [M][Dx], d logp, d logq and two rows of selections; two buffers
    for whole rows (K <= K6_CHUNK), one for chunked ones; then the paths'
    sums, d_q, cotangents, the picks' floors and the reduction scratch.
    Where the staged design runs the wide kernel (`staged_kernel`), that
    kernel's [2 Dx][`k6_wide_chunk`] float sums."""
    if staged_kernel(dx, m, backward=True) == "wide":
        return 8 * dx * k6_wide_chunk(dx)

    def up4(n):
        return (n + 3) // 4 * 4

    whole = k <= K6_CHUNK
    buf = (2 * dx + 2) * (up4(k) if whole else K6_CHUNK) + 4 * up4(m * dx) + 4 * up4(m)
    rest = (up4(m * (2 + 2 * dx)) + 2 * up4(m * dx) + up4(m)
            + (2 + 2 * dx) * K6_GROUP * 8)
    return 4 * (buf * (2 if whole else 1) + rest)


def ffbsi_backward(x_anchor, xs, r, mr, c, lwn, lg, sel, xtilde, d_x_first=None, d_logp=None,
                   d_logq=None, d_xtilde=None, needs=(True,) * 5, design: str = "staged"):
    """K6: the VJP of K5 over the whole sweep in one launch, on K5's
    selections sel and trajectories xtilde. Cotangents and outputs as
    `ffbsi_backward_reference`, which CPU tensors run; CUDA tensors launch
    the kernel of `design` ("staged", the default and the only one the path
    runs, the wide kernel off the staged kernels' shapes: `staged_kernel`;
    "row", the previous design, one CTA per (t, b) with three passes
    of the pair, kept as its yardstick). The kernel reads x_anchor, xtilde,
    sel, r, mr, c and lwn; of xs and lg only the shapes. Without d_logp and
    d_logq no pair carries a cotangent, and the kernel only scatters the
    trajectories' cotangents: the staged design then zeroes d_xs row by row
    on a persistent grid and patches the selected particles, bit for bit
    the row design's d_xs and d_x_anchor."""
    if design not in K6_DESIGNS:
        raise ValueError(f"ffbsi_backward: no design {design!r} (one of {K6_DESIGNS})")
    if x_anchor.device.type == "cpu":
        return ffbsi_backward_reference(x_anchor, xs, r, mr, c, lwn, lg, sel, xtilde, d_x_first,
                                        d_logp, d_logq, d_xtilde, needs)
    if x_anchor.device.type != "cuda":
        raise ValueError(f"ffbsi_backward: unsupported device {x_anchor.device}")
    t_len, batch, m, dx, k = _check_sweep(x_anchor, xs, r, mr, c, lwn, lg,
                                          f"ffbsi_backward ({design})", design != "staged")
    dev = x_anchor.device
    _require(sel, (t_len, batch, m), "sel", dev, torch.int32)
    _require(xtilde, (t_len, batch, m, dx), "xtilde", dev)
    for t, shape, name in ((d_x_first, x_anchor.shape, "d_x_first"), (d_logp, (batch, m), "d_logp"),
                           (d_logq, (batch, m), "d_logq"), (d_xtilde, xtilde.shape, "d_xtilde")):
        if t is not None:
            _require(t, shape, name, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    d_anchor = torch.empty(x_anchor.shape, **f32)
    d_xs = torch.empty(xs.shape, **f32)
    need_r, need_mr, need_c, need_lwn, need_lg = needs
    d_r = torch.empty(xs.shape, **f32) if need_r else None
    d_mr = torch.empty(xs.shape, **f32) if need_mr else None
    d_c, d_lwn, d_lg = (torch.empty(c.shape, **f32) if need else None
                        for need in (need_c, need_lwn, need_lg))
    kernel = staged_kernel(dx, m, backward=True) if design == "staged" else design
    work, ctas, chunk = None, 0, 0  # K6 wide: its scratch, grid and pass-B chunk
    if kernel == "wide":
        ctas = k6_wide_ctas(t_len, batch, torch.cuda.get_device_properties(dev).multi_processor_count)
        chunk = k6_wide_chunk(dx)
        if d_logp is not None or d_logq is not None:  # per CTA and path: pairs, (max, sum), d_q
            work = torch.empty((ctas * m * (k + 2 + dx),), **f32)
    lib = _build.load_library()
    err = lib.psvo_ffbsi_backward(
        x_anchor.data_ptr(), xtilde.data_ptr(), sel.data_ptr(), r.data_ptr(), mr.data_ptr(),
        c.data_ptr(), lwn.data_ptr(), _ptr(d_x_first), _ptr(d_logp), _ptr(d_logq),
        _ptr(d_xtilde), d_anchor.data_ptr(), d_xs.data_ptr(), _ptr(d_r), _ptr(d_mr), _ptr(d_c),
        _ptr(d_lwn), _ptr(d_lg), _ptr(work), ctas, chunk, batch, m, k, t_len, dx,
        _C_K6_KERNELS.index(kernel), torch.cuda.current_stream(dev).cuda_stream,
    )
    ffbsi_backward.launches += 1
    ffbsi_backward.launches_by_design[design] += 1
    _build.check(lib, err, f"ffbsi_backward ({design})")
    return d_anchor, d_xs, d_r, d_mr, d_c, d_lwn, d_lg


ffbsi_backward.launches = 0
ffbsi_backward.launches_by_design = dict.fromkeys(K6_DESIGNS, 0)  # which kernel the launches ran


# ---------------------------------------------------------------------------
# K5 + K6 as one differentiable operation
# ---------------------------------------------------------------------------


class FFBSiSweep(torch.autograd.Function):
    """`ffbsi_forward` with `ffbsi_backward` as its VJP: the counterpart of
    `pallas_ffbsi.ffbsi_scan`'s custom VJP.

    apply(x_anchor, xs, r, mr, c, lwn, lg, gum) returns (x_first, logp,
    logq, xtilde). When an input needs a gradient the forward keeps its
    operands (not gum) and the selections, and the backward runs K6 on them;
    r, mr, c, lwn and lg get a cotangent only where they need one.
    """

    @staticmethod
    def forward(ctx, x_anchor, xs, r, mr, c, lwn, lg, gum):
        x_first, logp, logq, xtilde, sel = ffbsi_forward(x_anchor, xs, r, mr, c, lwn, lg, gum)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x_anchor, xs, r, mr, c, lwn, lg, sel, xtilde)
        ctx.set_materialize_grads(False)
        return x_first, logp, logq, xtilde

    @staticmethod
    def backward(ctx, d_x_first, d_logp, d_logq, d_xtilde):
        def dense(t):
            return None if t is None else t.contiguous()

        grads = ffbsi_backward(
            *ctx.saved_tensors, dense(d_x_first), dense(d_logp), dense(d_logq), dense(d_xtilde),
            needs=tuple(ctx.needs_input_grad[2:7]),
        )
        return (*grads, None)
