#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`psvo_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `psvo_tpu_torch/csrc/`, checks each one
against its plain PyTorch version on the card, then drives the serving path
of the `fhn_fivo_k1024_bench` preset (FHN, FIVO, K=1024, B=32, T=100, relu
heads (64, 64), in-kernel RNG) through `make_eval_step` and
`filter_posterior`, with random weights from a seed. Phases:

  (a) the card (nvidia-smi name and power limit); TF32 off
  (b) kernel build time and per-kernel registers
  (c) K3 ancestor_indices vs its plain version on adversarial rows
  (d) K2 stream_noise vs the plain Philox (bit-equal)
  (e) K1 scan_forward, stream mode, vs scan_forward_reference (small, full)
  (f) K1 in-kernel RNG vs K1 and the plain version replaying K2's streams
  (g) the slice: eval on batches of 32 and filter_posterior; launch counts

Every phase prints one line; any failure exits non-zero. The second-to-last
lines are the kernels' JSON record; the last line is the device record.
Imports nothing of JAX: the machine with the card has none.
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

    # (g) the slice through its entry points
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
    print(f"[g] slice fhn_fivo_k1024_bench: ELBO per batch {[round(e, 3) for e in elbos]}, "
          f"R2(1) {[round(v, 4) for v in r2_1]}, K1 launches {launches} for 4 forwards, "
          f"plain-version calls {plain_calls}, shapes ok {shapes_ok}, wall {wall:.2f} s; "
          f"K1 forward {k1_ms:.3f}/{k1_ms_2:.3f} ms vs plain {k1_plain:.3f}/{k1_plain_2:.3f} ms "
          f"(kernel/plain alternated, median of 5 after 2 warm-up); eval_step {ev_ms:.3f} ms", flush=True)
    if launches != 4 or plain_calls != 0:
        fail(f"main path launched K1 {launches} times (want 4), plain versions {plain_calls}")
    if not (finite and shapes_ok):
        fail("slice outputs non-finite or of the wrong shape")

    kern = {
        "name": "scan_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_forward.cu",
        "replaces": "psvo_tpu/ops/pallas_step.py:1327", "launches": launches,
        "max_abs_err": results["small"]["max_abs_err"], "ms": k1_ms, "plain_ms": k1_plain,
    }
    checks = [
        {"name": "stream_noise", "route": "cuda", "source": "psvo_tpu_torch/csrc/stream_noise.cu",
         "replaces": "psvo_tpu/ops/pallas_step.py:540", "launches": 0,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "ancestor_indices", "route": "cuda", "source": "psvo_tpu_torch/csrc/ancestor_indices.cu",
         "replaces": "psvo_tpu/ops/pallas_resample.py:210", "launches": 0,
         "max_abs_err": float(k3_err), "ms": k3_ms, "plain_ms": k3_plain},
    ]
    print(json.dumps({"check_kernels": checks}))
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
