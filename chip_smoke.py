#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`psvo_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `psvo_tpu_torch/csrc/`, checks each one
against its plain PyTorch version on the card, then drives the two paths of
the `fhn_fivo_k1024_bench` preset (FHN, FIVO, K=1024, B=32, T=100, relu
heads (64, 64), in-kernel RNG) with random weights from a seed: serving,
through `make_eval_step` and `filter_posterior`, and training, through
`make_train_step` (10 Adam steps per call). Phases:

  (a) the card (nvidia-smi name and power limit); TF32 off
  (b) kernel build time and per-kernel registers
  (c) K3 ancestor_indices vs its plain version on adversarial rows
  (d) K2 stream_noise vs the plain Philox (bit-equal)
  (e) K1 scan_forward, stream mode, vs scan_forward_reference (small, full)
  (f) K1 in-kernel RNG vs K1 and the plain version replaying K2's streams
  (g) serving: eval on batches of 32 and filter_posterior; launch counts
  (h) K4 scan_backward vs scan_backward_reference on one K1 run's residuals
      (small, full; stream mode and in-kernel RNG)
  (i) training: 3 calls of 10 train steps on FHN minibatches of 32; launch
      counts, step time, K4 vs its plain version, peak memory, and the
      device time of one more call by kernel (torch.profiler)

Every phase prints its lines; any failure exits non-zero. The second-to-last
lines are the kernels' JSON record (times beside the bound: the larger of
the operations over 67 TFLOP/s fp32 and the bytes over 3.35 TB/s, the
H100 SXM's published peaks); the last line is the device record. Imports
nothing of JAX: the machine with the card has none.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FP32_PEAK = 67e12  # FLOP/s on the CUDA cores, H100 SXM at 700 W
HBM_PEAK = 3.35e12  # bytes/s


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `reps` runs, CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_breakdown(fn, n_steps: int) -> str:
    """Run fn() once under torch.profiler and split the device time per step
    into K1, K4 and every other kernel; the span runs from the first kernel's
    start to the last one's end, and idle is the share of it with no kernel
    running (one stream, so kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        fail("torch.profiler recorded no device time")
    span = max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)
    busy = sum(e.time_range.elapsed_us() for e in kern)
    k1 = sum(e.time_range.elapsed_us() for e in kern if "scan_forward_kernel" in e.name)
    k4 = sum(e.time_range.elapsed_us() for e in kern
             if "scan_backward_kernel" in e.name or "sum_rows_kernel" in e.name)
    n_other = sum(1 for e in kern if not any(
        s in e.name for s in ("scan_forward_kernel", "scan_backward_kernel", "sum_rows_kernel")))
    per = 1e3 * n_steps  # us -> ms per step
    return (f"span {span / per:.3f} ms/step, device busy {busy / per:.3f} ms/step (idle "
            f"{100 * (1 - busy / span):.1f}% of the span), K1 {k1 / per:.3f}, K4 {k4 / per:.3f}, "
            f"{n_other / n_steps:.0f} other device ops {(busy - k1 - k4) / per:.3f} ms/step")


def slice_config(small: bool):
    """The preset, or its small cut (B=4, K=128, T=10, hidden (16, 16))."""
    from psvo_tpu_torch.config import NetConfig, PRESETS

    cfg = PRESETS["fhn_fivo_k1024_bench"]
    if not small:
        return cfg, 32
    net = NetConfig(hidden=(16, 16))
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, t_steps=10),
        smc=dataclasses.replace(cfg.smc, n_particles=128),
    ).with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                g=dataclasses.replace(net, sigma_init=0.5))
    return cfg, 4


def kernel_inputs(ssm, cfg, ys, gen):
    """What _forward_filter_fused hands K1, plus ell0, with fresh streams."""
    import torch
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import fused_step

    batch, t_steps, _ = ys.shape
    k, dev = cfg.smc.n_particles, ys.device
    ys_tm = ys.transpose(0, 1)
    consts = fused_step.prepare(ssm)
    aq, cq, sq, logsq = fused_step.fusion_coeffs(ssm, cfg.smc, consts, ys_tm)
    eps0 = torch.randn((batch, ssm.dx, k), generator=gen, device=dev)
    eps = torch.randn((t_steps - 1, batch, ssm.dx, k), generator=gen, device=dev)
    u0 = torch.rand((t_steps - 1, batch), generator=gen, device=dev)
    x0, alpha0 = smc._init_t0(ssm, eps0, ys_tm[0], ys_tm[0])
    ab = logsq[1:] - consts["log_sf_sum"] - consts["log_sg_sum"] - ssm.dy * 0.5 * math.log(2 * math.pi)
    coef = fused_step.pack_coef(aq[1:], cq[1:], sq[1:], ys_tm[1:], ab)
    ell0 = torch.logsumexp(alpha0, -1) - math.log(k)
    return dict(x0=x0.contiguous(), alpha0=alpha0.contiguous(), coef=coef, consts=consts,
                eps=eps, positions=fused_step.systematic_positions(u0, k), ell0=ell0)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, n_bytes: float):
    """(ms, what bounds it): the least time for the work at the card's peaks."""
    t_ops, t_bytes = flops / FP32_PEAK, n_bytes / HBM_PEAK
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def trunk_flops(consts) -> int:
    """FLOP of the q1, f and g trunk forwards for one particle."""
    dx, dy, h, n_mid = consts["dx"], consts["dy"], consts["hidden"], consts["n_mid"]

    def net(dout):
        return 2 * (dx * h + n_mid * h * h + h * dout)

    return 2 * net(dx) + net(dy)


def max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def close(got, want, tol):
    import torch

    return all(torch.allclose(g, w, rtol=tol, atol=tol) for g, w in zip(got, want))


def teacher_forced(inp, kern, dx):
    """One plain step from each of the kernel's own states: per-step
    agreement with the accumulated drift removed. A particle whose drawn
    position differs by more than 1e-3 took another ancestor (a flip); the
    rest are compared value by value. Returns (flips, max |Δ| elsewhere)."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    x_all, a_all = kern[3], kern[4]
    t1, b, _, k = x_all.shape
    x_prev = torch_cat_prev(inp["x0"], x_all).reshape(t1 * b, dx, k)
    a_prev = torch_cat_prev(inp["alpha0"], a_all).reshape(t1 * b, k)
    ref = fused_step.scan_forward_reference(
        x_prev.contiguous(), a_prev.contiguous(), inp["coef"].reshape(1, t1 * b, -1),
        inp["consts"], inp["eps"].reshape(1, t1 * b, dx, k),
        inp["positions"].reshape(1, t1 * b, k), cache=True,
    )
    x_ref = ref[3].reshape(t1, b, dx, k)
    a_ref = ref[4].reshape(t1, b, k)
    flipped = ((x_ref - x_all).abs() > 1e-3 * (1 + x_all.abs())).any(dim=2)
    ok = ~flipped
    err = max(float((x_ref - x_all).abs().amax(dim=2)[ok].max()),
              float(((a_ref - a_all).abs() / (1 + a_all.abs()))[ok].max()))
    return int(flipped.sum()), err


def free_run_flips(inp, kern, ref):
    """Ancestor flips between the kernel's and the plain version's free runs.
    Per step, each run draws the ancestors of its own incoming weights (the
    teacher-forced check shows the kernel draws exactly the plain ancestors
    of its own weights). A row's first step with a differing ancestor is
    where rounding crossed a CDF boundary; after it the two runs follow other
    particles. Returns, per row, that first step (-1: none) and the number of
    ancestors that differ there."""
    from psvo_tpu_torch.ops import fused_step

    a_k = torch_cat_prev(inp["alpha0"], kern[4])
    a_r = torch_cat_prev(inp["alpha0"], ref[4])
    t1, b, k = a_k.shape
    pos = inp["positions"].reshape(t1 * b, k)
    idx_k = fused_step.count_form_indices(a_k.reshape(t1 * b, k), pos).reshape(t1, b, k)
    idx_r = fused_step.count_form_indices(a_r.reshape(t1 * b, k), pos).reshape(t1, b, k)
    per_step = (idx_k != idx_r).sum(dim=2)  # [T1, B]
    first, count = [], []
    for row in range(b):
        steps = per_step[:, row].nonzero()
        first.append(int(steps[0]) if len(steps) else -1)
        count.append(int(per_step[first[-1], row]) if len(steps) else 0)
    return first, count


def torch_cat_prev(first, stack):
    """[first, stack[0], ..., stack[-2]]: each step's incoming state."""
    import torch

    return torch.cat([first[None], stack[:-1]])


def check_scan(name, ssm, cfg, ys, gen, tol, rng_seed=None):
    """K1 against its plain version on identical inputs. Returns a dict."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    inp = kernel_inputs(ssm, cfg, ys, gen)
    if rng_seed is not None:  # in-kernel RNG; the plain side replays K2's streams
        t1, b = inp["coef"].shape[:2]
        eps, u0 = fused_step.stream_noise(rng_seed, t1, b, ssm.dx, cfg.smc.n_particles, ys.device)
        inp["eps"], inp["positions"] = eps, fused_step.systematic_positions(u0, cfg.smc.n_particles)
        kern = fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"], inp["consts"],
                                       seed=rng_seed, cache=True)
        same = fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"], inp["consts"],
                                       eps=inp["eps"], positions=inp["positions"], cache=True)
        if not all(torch.equal(a, b) for a, b in zip(kern[:3], same[:3])):
            fail(f"{name}: in-kernel RNG run differs from the stream run on K2's streams")
    else:
        kern = fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"], inp["consts"],
                                       eps=inp["eps"], positions=inp["positions"], cache=True)
    ref = fused_step.scan_forward_reference(inp["x0"], inp["alpha0"], inp["coef"], inp["consts"],
                                            inp["eps"], inp["positions"], cache=True)
    torch.cuda.synchronize()
    log_z_k = inp["ell0"] + kern[2][:, :, 0].sum(0)
    log_z_r = inp["ell0"] + ref[2][:, :, 0].sum(0)
    rel = (log_z_k - log_z_r).abs() / log_z_r.abs()
    tf_flips, tf_err = teacher_forced(inp, kern, ssm.dx)
    first, count = free_run_flips(inp, kern, ref)
    clean = torch.tensor([f < 0 for f in first], device=rel.device)
    finite = all(bool(torch.isfinite(t).all()) for t in kern[:3])
    return dict(
        close=close(kern[:3], ref[:3], tol), max_abs_err=max_err(kern[:3], ref[:3]),
        rel_d_log_z=float(rel.max()),
        rel_d_log_z_clean=float(rel[clean].max()) if bool(clean.any()) else 0.0,
        flipped=[f"{float(r):.1e}@t{f}x{n}" for r, f, n in zip(rel, first, count) if f >= 0],
        flip_rows=int((~clean).sum()), tf_flips=tf_flips, tf_err=tf_err, finite=finite,
    )


def scan_line(r) -> str:
    return (f"allclose(2e-4)={r['close']} max|d|={r['max_abs_err']:.3e}; teacher-forced: "
            f"{r['tf_flips']} flips, max|d| {r['tf_err']:.3e}; free run: max rel d logZ "
            f"{r['rel_d_log_z']:.3e}, {r['flip_rows']} rows with an ancestor flip, max rel "
            f"d logZ over rows without {r['rel_d_log_z_clean']:.3e}; flipped rows as "
            f"rel-d-logZ@t<first step>x<ancestors differing there>: {r['flipped']}")


def scan_ok(r, small: bool) -> bool:
    """Small size: allclose at 2e-4. Full size: every step agrees from the
    kernel's own state (teacher-forced, no flips), and every row without an
    ancestor flip in the free run agrees in log Z to 1e-4 relative."""
    if small:
        return r["close"]
    return (r["finite"] and r["tf_flips"] == 0 and r["tf_err"] < 1e-4
            and r["rel_d_log_z_clean"] < 1e-4)


def check_backward(ssm, cfg, ys, gen, rng_seed=None, cache=False):
    """K4 against scan_backward_reference on the residuals of one K1 run, so no
    ancestor can flip. Cotangents: d_ℓ = −1/B on every step, random ones on
    the dropped stats columns, x_last and alpha_last (and under `cache`
    x_all and alpha_all). Returns per-leaf relative L2 errors and max |Δ|,
    whether idx is nondecreasing, and the operands for timing."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    inp = kernel_inputs(ssm, cfg, ys, gen)
    args = (inp["x0"], inp["alpha0"], inp["coef"], inp["consts"])
    t1, b = inp["coef"].shape[:2]
    k, dev = cfg.smc.n_particles, ys.device
    if rng_seed is not None:  # the plain side replays K2's streams
        eps = fused_step.stream_noise(rng_seed, t1, b, ssm.dx, k, dev)[0]
        noise = {"seed": rng_seed}
        fwd = fused_step.scan_forward(*args, seed=rng_seed, cache=cache, save_res=True)
    else:
        eps, noise = inp["eps"], {"eps": inp["eps"]}
        fwd = fused_step.scan_forward(*args, eps=eps, positions=inp["positions"], cache=cache,
                                      save_res=True)
    x_last, alpha_last, stats, x_all, alpha_all, idx = fwd
    d_stats = torch.randn(stats.shape, generator=gen, device=dev)
    d_stats[..., 0] = -1.0 / b
    cots = [torch.randn(t.shape, generator=gen, device=dev) for t in (x_last, alpha_last)]
    if cache:
        cots += [torch.randn(t.shape, generator=gen, device=dev) * 0.1 for t in (x_all, alpha_all)]
    else:
        cots += [None, None]
    bwd = (inp["x0"], x_all, idx, stats, inp["coef"], inp["consts"], d_stats, *cots)
    got = fused_step.scan_backward(*bwd, **noise)
    want = fused_step.scan_backward_reference(inp["x0"], inp["coef"], inp["consts"], eps, idx,
                                              d_stats, *cots)
    torch.cuda.synchronize()
    rel = [float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in zip(got, want)]
    return dict(
        rel=rel, maxd=[float((g - w).abs().max()) for g, w in zip(got, want)],
        monotone=bool((idx[..., 1:] >= idx[..., :-1]).all()),
        finite=all(bool(torch.isfinite(g).all()) for g in got),
        kernel=lambda: fused_step.scan_backward(*bwd, **noise),
        plain=lambda: fused_step.scan_backward_reference(inp["x0"], inp["coef"], inp["consts"],
                                                         eps, idx, d_stats, *cots),
        n_bytes=nbytes(*bwd[:5], inp["consts"]["packed"], inp["consts"]["sconst"], d_stats,
                       *cots, None if rng_seed is not None else eps, *got),
        flops=3 * trunk_flops(inp["consts"]) * t1 * b * k,
    )


def main() -> int:
    # (a) the card
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        fail(f"nvidia-smi: {exc}")
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import psvo_tpu_torch as pt
    from psvo_tpu_torch.ops import _build, fused_step

    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    print(f"[a] device={name} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} tf32=off", flush=True)

    # (b) build
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    regs = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers[^\n]*", _build.build_log(), re.S)
    spills = re.findall(r"(\d+) bytes spill stores", _build.build_log())
    print(f"[b] build {build_s:.1f} s; registers "
          + ", ".join(f"{n}={r}" for n, r in regs)
          + f"; max spill stores {max(map(int, spills), default=0)} B", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    # (c) K3 on adversarial rows
    k = 1024
    rows = [
        torch.randn(k, device=dev, generator=gen) * 3,                     # generic
        torch.zeros(k, device=dev),                                        # uniform
        torch.randint(0, 3, (k,), device=dev, generator=gen).float() * -1,  # ties
        torch.where(torch.arange(k, device=dev) % 3 == 0, 0.0, -float("inf")),  # zero weights
        torch.full((k,), -3e30, device=dev),                               # all floored
        torch.where(torch.arange(k, device=dev) % 5 == 0, -1.0, -1e30),    # floored mix
        torch.full((k,), -50.0, device=dev).index_fill_(0, torch.tensor([517], device=dev), 0.0),  # dominant
        torch.linspace(-100.0, 0.0, k, device=dev),                        # wide spread
    ]
    logw = torch.stack(rows).contiguous()
    u0 = torch.tensor([0.0, 0.5, 0.25, 0.99999994, 0.125, 0.7, 0.3, 0.999], device=dev)
    idx_k = fused_step.ancestor_indices(logw, u0)
    idx_r = fused_step.ancestor_indices_reference(logw, u0)
    torch.cuda.synchronize()
    mism = (idx_k != idx_r).nonzero().tolist()
    for b, i in mism:  # boundary distance of every mismatch
        m = logw[b].max()
        cdf = torch.cumsum(torch.exp(logw[b] - m).double(), 0)
        target = fused_step.systematic_positions(u0[b:b + 1], k)[0, i].double() * cdf[-1]
        print(f"[c] mismatch row {b} particle {i}: kernel {int(idx_k[b, i])} plain "
              f"{int(idx_r[b, i])}, boundary distance {float((cdf - target).abs().min()):.3e}")
    bl = torch.randn((32, k), device=dev, generator=gen) * 3
    bu = torch.rand(32, device=dev, generator=gen)
    k3_ms = time_ms(lambda: fused_step.ancestor_indices(bl, bu), reps=20)
    k3_plain = time_ms(lambda: fused_step.ancestor_indices_reference(bl, bu), reps=20)
    k3_err = int((fused_step.ancestor_indices(bl, bu) != fused_step.ancestor_indices_reference(bl, bu)).sum())
    print(f"[c] K3 ancestor_indices: {len(mism)} mismatches on {logw.shape[0]} adversarial rows, "
          f"{k3_err} on [32, {k}] random rows; {k3_ms:.4f} ms vs plain {k3_plain:.4f} ms", flush=True)
    if mism or k3_err:
        fail("K3 disagrees with the plain indices")

    # (d) K2 vs plain Philox at the slice shape
    seed = (0x1234ABCD, 0x0F0F1234)
    t1, b_, dx = 99, 32, 2
    e_k, u_k = fused_step.stream_noise(seed, t1, b_, dx, k, dev)
    e_r, u_r = fused_step.stream_noise_reference(seed, t1, b_, dx, k, dev)
    torch.cuda.synchronize()
    e_bad = int((e_k != e_r).sum())
    u_bad = int((u_k != u_r).sum())
    k2_err = float((e_k - e_r).abs().max())
    moments = (float(e_k.mean()), float(e_k.std()), float(u_k.mean()))
    k2_ms = time_ms(lambda: fused_step.stream_noise(seed, t1, b_, dx, k, dev), reps=20)
    k2_plain = time_ms(lambda: fused_step.stream_noise_reference(seed, t1, b_, dx, k, dev), reps=5)
    print(f"[d] K2 stream_noise [{t1},{b_},{dx},{k}]: eps mismatches {e_bad}, u0 mismatches {u_bad}, "
          f"max |d| {k2_err:.3e}; eps mean {moments[0]:.4f} std {moments[1]:.4f}, u0 mean "
          f"{moments[2]:.4f}; {k2_ms:.4f} ms vs plain {k2_plain:.4f} ms", flush=True)
    if e_bad or u_bad:
        fail("K2 is not bit-equal to the plain Philox")

    # (e) K1 stream mode vs plain, small and full
    results = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
        ys = torch.randn((batch, cfg.data.t_steps, 2), device=dev, generator=gen)
        with torch.no_grad():
            r = check_scan(label, ssm, cfg, ys, gen, tol=2e-4)
        results[label] = r
        print(f"[e] K1 stream {label} B={batch} K={cfg.smc.n_particles} T={cfg.data.t_steps} "
              f"hidden={cfg.net('q1').hidden}: {scan_line(r)}", flush=True)
        if not scan_ok(r, small):
            fail(f"K1 (stream mode, {label}) disagrees with scan_forward_reference")

    # (f) K1 in-kernel RNG vs the plain path on K2's streams
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 1), device=dev)
        ys = torch.randn((batch, cfg.data.t_steps, 2), device=dev, generator=gen)
        with torch.no_grad():
            r = check_scan(label, ssm, cfg, ys, gen, tol=2e-4, rng_seed=(7, 0xDEADBEEF))
        print(f"[f] K1 in-kernel RNG {label}: bit-equal to K1 on K2's streams; vs the plain "
              f"replay {scan_line(r)}", flush=True)
        if not scan_ok(r, small):
            fail(f"K1 (in-kernel RNG, {label}) disagrees with the plain replay")

    # (g) serving through its entry points
    cfg, batch = slice_config(small=False)
    ds = pt.generate_dataset(cfg.data, SEED)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    obs = torch.cat([ds.obs_test, ds.obs_train]).to(dev)
    batches = [obs[i * batch:(i + 1) * batch].contiguous() for i in range(3)]
    eval_step = pt.make_eval_step(ssm, cfg)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    fused_step.scan_forward.launches = 0
    fused_step.scan_forward_reference.calls = 0
    fused_step.stream_noise_reference.calls = 0
    t0 = time.perf_counter()
    metrics = [eval_step(run_gen, ys) for ys in batches]
    means, parts, lws = pt.filter_posterior(ssm, batches[0], cfg, return_particles=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_step.scan_forward.launches
    plain_calls = fused_step.scan_forward_reference.calls + fused_step.stream_noise_reference.calls
    elbos = [float(m["elbo"]) for m in metrics]
    r2_1 = [float(m["r2_k"][0]) for m in metrics]
    shapes_ok = (tuple(means.shape) == (batch, 100, 2) and tuple(parts.shape) == (batch, 100, 1024, 2)
                 and tuple(lws.shape) == (batch, 100, 1024))
    finite = all(math.isfinite(e) for e in elbos) and bool(torch.isfinite(means).all())
    with torch.no_grad():
        inp = kernel_inputs(ssm, cfg, batches[0], gen)
        seed = (11, 13)
        eps, u0 = fused_step.stream_noise(seed, 99, batch, 2, 1024, dev)
        pos = fused_step.systematic_positions(u0, 1024)
        args = (inp["x0"], inp["alpha0"], inp["coef"], inp["consts"])
        k1_ms = time_ms(lambda: fused_step.scan_forward(*args, seed=seed))
        k1_plain = time_ms(lambda: fused_step.scan_forward_reference(*args, eps, pos))
        k1_ms_2 = time_ms(lambda: fused_step.scan_forward(*args, seed=seed))
        k1_plain_2 = time_ms(lambda: fused_step.scan_forward_reference(*args, eps, pos))
        ev_ms = time_ms(lambda: eval_step(run_gen, batches[0]))
    print(f"[g] serving fhn_fivo_k1024_bench: ELBO per batch {[round(e, 3) for e in elbos]}, "
          f"R2(1) {[round(v, 4) for v in r2_1]}, K1 launches {launches} for 4 forwards, "
          f"plain-version calls {plain_calls}, shapes ok {shapes_ok}, wall {wall:.2f} s; "
          f"K1 forward {k1_ms:.3f}/{k1_ms_2:.3f} ms vs plain {k1_plain:.3f}/{k1_plain_2:.3f} ms "
          f"(kernel/plain alternated, median of 5 after 2 warm-up); eval_step {ev_ms:.3f} ms", flush=True)
    if launches != 4 or plain_calls != 0:
        fail(f"serving path launched K1 {launches} times (want 4), plain versions {plain_calls}")
    if not (finite and shapes_ok):
        fail("slice outputs non-finite or of the wrong shape")

    t1, k = inp["coef"].shape[0], inp["x0"].shape[-1]
    # reads x0, alpha0, coef and the weights; writes x_last, alpha_last and stats
    k1_bound, k1_by = bound(trunk_flops(inp["consts"]) * t1 * batch * k,
                            2 * nbytes(*args[:2]) + nbytes(args[2], inp["consts"]["packed"],
                                                           inp["consts"]["sconst"])
                            + t1 * batch * (2 + 2) * 4)

    # (h) K4 vs its plain version on one K1 run's residuals
    leaves = ("d_x0", "d_coef", "d_weights", "d_sconst")
    bwd = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 2), device=dev)
        ys = torch.randn((batch, cfg.data.t_steps, 2), device=dev, generator=gen)
        modes = [("stream", None, False), ("in-kernel RNG", (3, 0xC0FFEE), False)]
        if small:
            modes.append(("stream, cache cotangents", None, True))
        for mode, rng_seed, cache in modes:
            with torch.no_grad():
                r = check_backward(ssm, cfg, ys, gen, rng_seed, cache)
            bwd[(label, mode)] = r
            tol = 1e-4 if small else 1e-3
            print(f"[h] K4 {label} B={batch} K={cfg.smc.n_particles} T={cfg.data.t_steps} {mode}: "
                  + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                              for n, e, m in zip(leaves, r["rel"], r["maxd"]))
                  + f"; idx nondecreasing {r['monotone']}; bound rel L2 {tol:g}", flush=True)
            if not r["monotone"]:
                fail("K1's ancestor indices are not nondecreasing: K4's segmented scatter needs them so")
            if not (r["finite"] and max(r["rel"]) <= tol):
                fail(f"K4 ({label}, {mode}) disagrees with scan_backward_reference")
    full = bwd[("full", "in-kernel RNG")]
    with torch.no_grad():
        k4_ms = time_ms(full["kernel"])
        k4_plain = time_ms(full["plain"])
        k4_ms_2 = time_ms(full["kernel"])
        k4_plain_2 = time_ms(full["plain"])
    k4_bound, k4_by = bound(full["flops"], full["n_bytes"])
    print(f"[h] K4 full, in-kernel RNG: {k4_ms:.3f}/{k4_ms_2:.3f} ms vs plain "
          f"{k4_plain:.3f}/{k4_plain_2:.3f} ms (kernel/plain alternated, median of 5 after 2 "
          f"warm-up); bound {k4_bound:.3f} ms ({k4_by}: {full['flops']:.3e} FLOP, "
          f"{full['n_bytes'] / 1e6:.1f} MB)", flush=True)

    # (i) training through make_train_step: 3 calls of steps_per_call steps
    cfg, batch = slice_config(small=False)
    n_per_call = cfg.train.steps_per_call
    ds = pt.generate_dataset(cfg.data, SEED)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = ds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (3, n_per_call, batch),
                         generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]  # [10, B, T, Dy] each
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain_fns = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
                 fused_step.stream_noise_reference, fused_step.ancestor_indices_reference)
    for fn in plain_fns:
        fn.calls = 0
    fused_step.scan_forward.launches = 0
    fused_step.scan_backward.launches = 0
    call_s, train_metrics = [], []
    for bt in train_batches:
        t0 = time.perf_counter()
        train_metrics.append(train_step(run_gen, bt))
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    k1_train, k4_train = fused_step.scan_forward.launches, fused_step.scan_backward.launches
    plain_calls = sum(fn.calls for fn in plain_fns)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in train_metrics]
    norms = [float(m["grad_norm"]) for m in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    step_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[i] training fhn_fivo_k1024_bench: {len(train_batches)} calls x {n_per_call} steps, "
          f"B={batch}: loss per call {[round(v, 3) for v in losses]}, grad norm "
          f"{[round(v, 3) for v in norms]}, parameters moved {moved}; K1 launches {k1_train}, "
          f"K4 launches {k4_train}, plain-version calls {plain_calls}; call times "
          f"{[round(v, 3) for v in call_s]} s, train step {step_ms:.3f} ms (median of the calls "
          f"after the first, per step); K4 {k4_ms:.3f} ms vs plain {k4_plain:.3f} ms; peak "
          f"device memory {peak_gb:.3f} GB", flush=True)
    print(f"[i] profile of one more call: {device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call)}",
          flush=True)
    want = len(train_batches) * n_per_call
    if k1_train != want or k4_train != want or plain_calls != 0:
        fail(f"train path launched K1 {k1_train} and K4 {k4_train} times (want {want} each), "
             f"plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("training gave non-finite losses or gradient norms, or left the parameters as they were")

    # K2: about 80 operations per normal (a Philox4x32-10 call, about 100 integer
    # operations, serves the particle's two normals; the Box-Muller transform about 30
    # each), counted at the fp32 rate; its output written once.
    # K3: the CDF scan and a binary search per particle; logw and u0 in, int32 indices out.
    k2_bound, k2_by = bound(80.0 * e_k.numel(), nbytes(e_k, u_k))
    k3_bound, k3_by = bound(2.0 * bl.numel() * (1 + math.log2(bl.shape[-1])),
                            nbytes(bl, bu) + bl.numel() * 4)
    kernels = [
        {"name": "scan_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_forward.cu",
         "replaces": "psvo_tpu/ops/pallas_step.py:1327", "launches": k1_train,
         "max_abs_err": results["small"]["max_abs_err"], "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "scan_backward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_backward.cu",
         "replaces": "psvo_tpu/ops/pallas_step.py:1425", "launches": k4_train,
         "max_abs_err": max(bwd[("small", "stream")]["maxd"]), "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None},
    ]
    checks = [
        {"name": "stream_noise", "route": "cuda", "source": "psvo_tpu_torch/csrc/stream_noise.cu",
         "replaces": "psvo_tpu/ops/pallas_step.py:540", "launches": 0,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
        {"name": "ancestor_indices", "route": "cuda", "source": "psvo_tpu_torch/csrc/ancestor_indices.cu",
         "replaces": "psvo_tpu/ops/pallas_resample.py:210", "launches": 0,
         "max_abs_err": float(k3_err), "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
    ]
    print(json.dumps({"check_kernels": checks}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
