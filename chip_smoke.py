#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`psvo_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `psvo_tpu_torch/csrc/`, checks each one
against its plain PyTorch version on the card, then drives the paths of two
presets with random weights from a seed. `fhn_fivo_k1024_bench` (FHN, FIVO,
K=1024, B=32, T=100, relu heads (64, 64), in-kernel RNG): serving, through
`make_eval_step` and `filter_posterior`, and training, through
`make_train_step` (10 Adam steps per call). `lorenz63_psvo_k1024`
(Lorenz-63, PSVO with FFBSi smoothing, K=1024, M=16, B=32, T=100, stream
noise): serving through `smooth_posterior` and training through
`make_train_step`. Phases:

  (a) the card (nvidia-smi name and power limit); TF32 off
  (b) kernel build time and per-kernel registers
  (c) K3 ancestor_indices vs its plain version on adversarial rows
  (d) K2 stream_noise, the pair design and the previous one (design=
      "particle"), each bit-equal to the plain Philox and to the other; their
      device times alternated, three pairs (the pair design must be faster
      in each)
  (e) K1 scan_forward, stream mode, vs scan_forward_reference (small, full)
  (f) K1 in-kernel RNG vs K1 and the plain version replaying K2's streams
  (g) serving: eval on batches of 32 and filter_posterior; launch counts
  (h) K4 scan_backward vs scan_backward_reference on one K1 run's residuals
      (small, full; stream mode and in-kernel RNG)
  (i) training: 3 calls of 10 train steps on FHN minibatches of 32; launch
      counts, step time, K4 vs its plain version, peak memory, and the
      device time of one more call by kernel (torch.profiler)
  (j) K1 and K4 at the Lorenz-63 shape (Dx=Dy=3, stream mode, K4 with the
      cache cotangents) vs their plain versions (small, full)
  (k) K5 ffbsi_forward vs its plain version on the cache of one K1 run, and
      K6 ffbsi_backward vs its plain version on K5's selections (small, full;
      every cotangent, the direct bound's, the paths alone); K5's staged
      design vs the previous one (design="path"): sel, x~, x_first and logp
      equal, logq within 1e-6; K6's staged design vs the previous one
      (design="row"): the paths alone bit-equal, otherwise within 1e-5
      relative L2 per leaf, each design bit-equal on a relaunch, also at
      M=256 and at K=8192 (chunked rows); both kernels' designs timed
      alternately by device time, three pairs per cotangent pattern (the
      staged design must be faster in each)
  (l) serving: smooth_posterior on three batches of 32 Lorenz-63
      trajectories; shapes, launch counts (every K5 launch the staged
      design), time per call
  (m) training: 3 calls of 10 PSVO train steps on Lorenz-63 minibatches of
      32; launch counts (K5 and K6 all staged), step time, peak memory,
      profile by kernel

then `lorenz96_fivo_k8192_sharded` (Lorenz-96, Dx=Dy=40, FIVO, K=8192, B=8,
T=100, relu heads (64, 64), in-kernel RNG) with the trained snapshot
`checkpoints/l96_pretrained.npz`, served and trained on one card by the
trunk path:

  (n) K2 at Dx=40 as in (d), both designs
  (o) K7 ancestor_indices_large and K8 gather_particles vs their plain
      versions on adversarial rows (small, full); K7's cluster design equal
      to the previous one (design="row") and the same on a second launch;
      the two timed alternately, three pairs (the cluster design must be
      faster in each)
  (p) K9 trunk_forward (the async design) vs its plain version on every
      step of one kernel run, with the streamed ε and the in-kernel draw
      (small, full), and bit-equal to the previous design (design="tile")
      on every step; the two timed alternately, three pairs per noise mode
      (the async design must be faster in each)
  (q) serving through make_eval_step and filter_posterior (with and without
      the particles): launch counts (every K9 launch the async design,
      every K7 launch the cluster design),
      ELBO, R², time per call, peak memory and a profile by kernel
  (r) K11 segment_sum_scatter vs its float64 plain version on the
      adversarial rows of (o) at K=128, 2048 and 8192 (bit-equal on a second
      launch), with its device time beside zeros + scatter_add_'s; the tiled
      design against the previous one (design="row"), max |d| printed, the
      two timed alternately, three pairs on the adversarial rows and one
      each on healthy and one-ancestor rows (the tiled design must be
      faster in each)
  (s) K10 trunk_backward vs its plain version on every step of one kernel
      run, random cotangents, streamed ε and the in-kernel draw (small, full),
      and vs the previous design (design="simt", fp32 FMA) within 1e-5; the
      two designs timed alternately, three pairs per noise mode, beside the
      fp32 bound and the split bound (forward on fp32, backward 3xTF32)
  (t) training through make_train_step from the snapshot: 3 calls of one
      step on minibatches of 8, launch counts (99 per kernel per step), loss,
      grad norm, step time, peak memory and a profile by kernel; every K9
      launch the async design, every K10 launch the tensor-core design,
      every K7 launch the cluster design, every K11 launch the tiled design

then `lorenz63_svo_k256` (Lorenz-63, SVO with the learned backward proposal,
K=256, M=16, B=32, T=100, relu heads (64, 64), in-kernel RNG, the filter's
cache on) with random weights:

  (u) K1 and K4 at its settings (in-kernel draw, cache, K4 with the cache
      cotangents and the seed) vs their plain versions on K2's streams
      (small, full)
  (v) K12 svo_sweep_forward (the split design) vs its plain version: the
      free runs and every step teacher-forced from the kernel's own
      x~_{t+1} (small, full), and bit-equal to the previous design
      (design="chain") in x_first, lp, lq and x~; the two timed
      alternately, three pairs (the split design must be faster in each)
  (w) K13 svo_sweep_backward vs its plain version on K12's x~, random
      cotangents on all four outputs (zeroed on paths with a relu tie, both
      figures reported), bit-equal on a second launch (small, full), and
      within 1e-5 of the previous design (design="chain"); the two timed
      alternately, three pairs (the split design must be faster in each)
  (x) serving: smooth_posterior(method="svo") on three batches of 32;
      shapes, launch counts (every K12 launch the split design), time per
      call, peak memory, profile by kernel
  (y) training: 3 calls of 10 SVO train steps on minibatches of 32; launch
      counts (every K12 and K13 launch the split design), loss and
      elbo_svo, step time, peak memory, profile by kernel

then, with `fused_step.SCAN_FUSED` off (the per-step path of the
reference's `pallas_step.SCAN_FUSED = False`: one K14 launch per filter
step, one K15 launch per step of the backward, streamed noise):

  (z) K14 step_forward vs step_forward_reference on every step of a chain
      of K14 launches, teacher-forced from the kernel's own state, at Dx=2
      (FHN) and Dx=3 (Lorenz-63), small and full; the chain against one K1
      launch on the same streams (indices equal); device time per launch
  (aa) K15 step_backward vs step_backward_reference on every step of those
      chains' residuals, random cotangents of x_new, α and ℓ (zeroed on
      particles with a relu tie, both figures reported), bit-equal on a
      second launch; the chain of K15 launches against one K4 launch on the
      same residuals; K15 at Dx=3, K=2048, beyond K4's shared memory; device
      time per launch
  (ab) fhn_fivo_k1024_bench: make_eval_step on three batches of 32 and 3
      calls of 10 train steps; launch counts (99 K14 per filter, 99 K15 per
      step, no K1 or K4, no plain version), loss, step time, peak memory and
      profiles; one step's loss and gradients against the whole-scan path on
      the same streams and weights
  (ac) lorenz63_psvo_k1024: smooth_posterior on three batches of 32 and 3
      calls of 10 PSVO train steps; launch counts (K14, K15, K5, K6; K5 and
      K6 all staged), times, peak memory and profiles

and, with the toggle back on, K1 and K4 on thread-block clusters (each row
on C CTAs; every phase above launched them at the C that
fused_step.cluster_size picks):

  (ad) K1 and K4 at each cluster size C in {1, 2, 4, 8} that the gates and
      the card admit, at the FHN shape (B=32, K=1024, hidden 64, Dx=2,
      in-kernel draw) and the Lorenz-63 one (Dx=3, stream noise, cache): the
      card's resident clusters per C and the chosen C; K1's outputs and K4's
      d_x0 bit-equal to C=1, K4's other leaves within 1e-6 relative L2, each
      bit-equal on a relaunch; times per C, C=1 and the chosen C alternated
      (the chosen C must be faster)

and K14 and K15 on S CTAs per row with no cluster (every phase from z on
launched them at the S that fused_step.step_slices picks):

  (ae) K14 and K15 at each slice count S in {1, 2, 4, 8} that the gates
      admit, at the FHN and Lorenz-63 shapes (B=32, K=1024, hidden 64), on
      the residuals of phase z's chains: the card's resident CTAs and the
      chosen S; K14's outputs and K15's d_x bit-equal to S=1, K15's other
      leaves within 1e-6 relative L2 (else no further from a float64 replay
      than S=1's), each bit-equal on a relaunch; device times per S, S=1
      and the chosen S alternated, alone (K15's sum_rows_kernel apart: the
      partial-row traffic) and inside one per-step FHN train call, with
      the step's device time and host-clock time per S

and, with the toggle on, `lorenz63_psvo_k1024` under psvo_bound="direct":

  (af) 3 PSVO train steps (one a call) on minibatches of 32, whose K6
      launches take the all-cotangents branch: step time, a profile by
      kernel, launch counts (K1, K4, K5, K6 once a step, K5 and K6 staged),
      no plain version

Every phase prints its lines and its seconds; any failure prints its reason
on stdout and stderr and exits non-zero. A torch.profiler window that comes
back with no device events is run again (profiled_kernels); device time
per call is the mean of a kernel's recorded events times its launches a
call, as windows often hold part of a kernel's events (device_ms); the
run ends with the count of both kinds of window. The second-to-last line is the
kernels' JSON record (times beside the bound: the larger of the operations
over 67 TFLOP/s fp32 and the bytes over 3.35 TB/s, the H100 SXM's published
peaks; K2's, K5's, K6's, K7's, K9's, K11's, K12's and K13's rows also carry
"ms_prev", the previous design's time alternated with theirs; K6's row has
both branches, K2's both widths); the last line is the device record. Imports nothing of JAX: the
machine with the card has none.
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
TF32_PEAK = 495e12  # FLOP/s on the tensor cores, dense TF32


_LAST = [time.perf_counter()]


def phase_done(label: str) -> None:
    """Print the seconds since the previous phase ended."""
    now = time.perf_counter()
    print(f"[time] {label}: {now - _LAST[0]:.1f} s", flush=True)
    _LAST[0] = now


def fail(msg: str) -> None:
    """Print msg on both streams (a caller that keeps only one still sees it)
    and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


PROFILE_TRIES = 8
PROFILE_WINDOWS = {"windows": 0, "empty": 0, "partial": 0}


def profiled_kernels(window, with_cpu: bool) -> list:
    """The device events of one torch.profiler window around window() (and a
    synchronize). Now and then a window comes back with no device events at
    all although its kernels ran (on the H100 with torch 2.11, in a random
    phase, in two of three runs of this script): such a window is run again,
    a second later, up to PROFILE_TRIES times, and counted in PROFILE_WINDOWS;
    a window that stays empty fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if with_cpu else [ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_TRIES + 1):
        PROFILE_WINDOWS["windows"] += 1
        with profile(activities=acts) as prof:
            window()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kern:
            return kern
        PROFILE_WINDOWS["empty"] += 1
        print(f"[profiler] a window recorded no device events (attempt {attempt} of "
              f"{PROFILE_TRIES})", flush=True)
        time.sleep(1.0)
    fail(f"torch.profiler recorded no device time in {PROFILE_TRIES} windows in a row")


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of fn(): the kernels' own time from torch.profiler
    over n calls after one warm-up, without the host's launch gaps (which
    CUDA events around a short call include)."""
    return sum(device_ms_by_kernel(fn, n).values())


def device_ms_by_kernel(fn, n: int = 20) -> dict:
    """device_ms split by kernel name: {name: ms per call of fn()}, each the
    mean of the name's recorded events times its launches a call (its events
    over n, rounded). On the H100 with torch 2.11 a window often records only
    part of a kernel's events (17 of 20 is common, once about half): a sum
    over n calls would read low by the share dropped. Such windows are
    counted in PROFILE_WINDOWS."""
    import torch

    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(n):
            fn()

    kern = profiled_kernels(window, with_cpu=False)
    total, count = {}, {}
    for e in kern:
        total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    if any(c % n for c in count.values()):
        PROFILE_WINDOWS["partial"] += 1
    return {name: total[name] / count[name] * max(1, round(count[name] / n)) / 1e3
            for name in total}


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


def kernel_resources(mangled: str) -> str:
    """Registers and spill stores of a kernel (its mangled name's start) from
    the build's -Xptxas -v output."""
    from psvo_tpu_torch.ops import _build

    log = _build.build_log()
    regs = re.search(re.escape(mangled) + r".*?Used (\d+) registers", log, re.S)
    spill = re.search(re.escape(mangled) + r"[^\n]*\n[^\n]*\n\s*(\d+) bytes stack frame, (\d+) bytes "
                      r"spill stores", log)
    return (f"{regs.group(1) if regs else '?'} registers, "
            f"{spill.group(2) if spill else '?'} bytes spill stores")


def zero_designs(*fns) -> None:
    for fn in fns:
        fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)


FHN_KERNELS = {"K1": ("scan_forward_kernel",), "K4": ("scan_backward_kernel", "sum_rows_kernel")}
K6_KERNELS = ("ffbsi_bwd_paths_kernel", "ffbsi_bwd_staged_kernel")  # the staged design's two kernels
PSVO_KERNELS = dict(FHN_KERNELS, K5=("ffbsi_staged_kernel",), K6=K6_KERNELS)
L96_KERNELS = {"K9": ("trunk_forward_async_kernel",), "K7": ("ancestor_indices_cluster_kernel",),
               "K8": ("gather_particles_kernel",)}
L96_TRAIN_KERNELS = dict(L96_KERNELS, K10=("trunk_backward_tf32x3_kernel", "trunk_sum_ctas_kernel",
                                           "trunk_sum_tiles_kernel"),
                         K11=("segment_sum_tiled_kernel",))
L96 = "lorenz96_fivo_k8192_sharded"


def device_breakdown(fn, n_steps: int, groups: dict) -> str:
    """Run fn() once under torch.profiler and split the device time per step
    into the kernels of `groups` (name -> substrings of kernel names) and
    every other kernel; the span runs from the first kernel's start to the
    last one's end, and idle is the share of it with no kernel running (one
    stream, so kernels do not overlap). Each group prints the events it
    recorded: the profiler may drop some, and its time is theirs."""
    kern = profiled_kernels(fn, with_cpu=True)
    span = max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)
    busy = sum(e.time_range.elapsed_us() for e in kern)
    per = 1e3 * n_steps  # us -> ms per step
    parts, named, n_named = [], 0.0, 0
    for label, keys in groups.items():
        mine = [e for e in kern if any(k in e.name for k in keys)]
        us = sum(e.time_range.elapsed_us() for e in mine)
        named, n_named = named + us, n_named + len(mine)
        parts.append(f"{label} {us / per:.3f} ({len(mine)} events)")
    others = {}
    for e in kern:
        if not any(k in e.name for keys in groups.values() for k in keys):
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    return (f"span {span / per:.3f} ms/step, device busy {busy / per:.3f} ms/step (idle "
            f"{100 * (1 - busy / span):.1f}% of the span), " + ", ".join(parts)
            + f", {(len(kern) - n_named) / n_steps:.0f} other device ops "
            f"{(busy - named) / per:.3f} ms/step, the largest: "
            + "; ".join(f"{n} {us / per:.3f}" for n, us in top))


def slice_config(small: bool, preset: str = "fhn_fivo_k1024_bench"):
    """The preset, or its small cut (B=4, K=128, T=10, hidden (16, 16))."""
    from psvo_tpu_torch.config import NetConfig, PRESETS

    cfg = PRESETS[preset]
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


def ffbsi_operands(ssm, cfg, ys, gen):
    """K5's operands as the PSVO objective builds them, from the cache of one
    K1 run (stream mode): the anchors drawn from the last weights, the
    support x_0 .. x_{T-2}, its transition terms r/mr/c, the normalized
    log-weights, zero emission terms and fresh Gumbels."""
    from types import SimpleNamespace

    import torch
    from psvo_tpu_torch import objectives
    from psvo_tpu_torch.distributions import log_normalize
    from psvo_tpu_torch.ops import fused_step

    inp = kernel_inputs(ssm, cfg, ys, gen)
    x_last, alpha_last, _, x_all, alpha_all, _ = fused_step.scan_forward(
        inp["x0"], inp["alpha0"], inp["coef"], inp["consts"], eps=inp["eps"],
        positions=inp["positions"], cache=True)
    xs = torch.cat([inp["x0"][None], x_all])
    lwn = log_normalize(torch.cat([inp["alpha0"][None], alpha_all])[:-1], dim=-1)[0]
    batch, m, k = ys.shape[0], cfg.smc.n_smoothing_particles, cfg.smc.n_particles
    x_anchor, _ = objectives._sample_final_particles(
        objectives._gumbel(gen, (batch, m, k)), SimpleNamespace(x_last=x_last, logw_last=alpha_last))
    r, mr, c = objectives._support_terms(ssm, xs[:-1], differentiable=False)
    gum = objectives._gumbel(gen, (xs.shape[0] - 1, batch, m, k))
    return [x_anchor.contiguous(), xs[:-1].contiguous(), r, mr, c, lwn.contiguous(),
            torch.zeros_like(lwn), gum]


def check_ffbsi(ops, gen):
    """K5 against its plain version on the same operands, then K6 against its
    plain version on K5's selections, with cotangents on all four outputs
    (the direct bound's case) and on the paths alone (the forward bound's:
    no support gradient wanted). A path with a selection that differs
    somewhere is a flip; every other path is held to x~ equal and logp/logq
    to 1e-5 relative. Returns a dict, with K6's operands for timing."""
    import torch
    from psvo_tpu_torch.ops import ffbsi

    kern = ffbsi.ffbsi_forward(*ops)
    ref = ffbsi.ffbsi_forward_reference(*ops)
    torch.cuda.synchronize()
    differ = kern[4] != ref[4]  # [T-1, B, M]
    clean = ~differ.any(0)  # [B, M]: paths with no differing selection
    same_x = bool(torch.equal(kern[3][:, clean], ref[3][:, clean])
                  and torch.equal(kern[0][clean], ref[0][clean]))
    rel = [float(((a - b).abs() / b.abs().clamp_min(1e-30))[clean].max())
           for a, b in zip(kern[1:3], ref[1:3])]
    x_anchor, xs, r, mr, c, lwn, lg, _ = ops
    sel, xtilde = kern[4], kern[3]
    cots = [torch.randn(t.shape, generator=gen, device=t.device) for t in kern[:4]]
    names = ("d_x_first", "d_logp", "d_logq", "d_xtilde")
    bwd = {}
    for mode, (live, needs) in K6_MODES.items():
        kw = {n: cots[i] if i in live else None for i, n in enumerate(names)}
        args = (x_anchor, xs, r, mr, c, lwn, lg, sel, xtilde)
        got = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
        want = ffbsi.ffbsi_backward_reference(*args, needs=needs, **kw)
        torch.cuda.synchronize()
        pairs = [(g, w) for g, w in zip(got, want) if w is not None]
        reads = (x_anchor, xtilde, sel, r, mr, c, lwn) if mode != "paths only" else (sel,)
        bwd[mode] = dict(
            rel=[float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in pairs],
            maxd=[float((g - w).abs().max()) for g, w in pairs],
            finite=all(bool(torch.isfinite(g).all()) for g, _ in pairs),
            nones=all((g is None) == (w is None) for g, w in zip(got, want)),
            kernel=lambda a=args, n=needs, k=kw: ffbsi.ffbsi_backward(*a, needs=n, **k),
            plain=lambda a=args, n=needs, k=kw: ffbsi.ffbsi_backward_reference(*a, needs=n, **k),
            n_bytes=nbytes(*reads, *[v for v in kw.values() if v is not None],
                           *[g for g, _ in pairs]),
            args=args, kw=kw, needs=needs,
        )
    return dict(flips=int(differ.sum()), flip_paths=int((~clean).sum()), same_x=same_x,
                rel_logp=rel[0], rel_logq=rel[1],
                max_abs_err=max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(kern[:4], ref[:4])),
                finite=all(bool(torch.isfinite(t).all()) for t in kern[:4]),
                bwd=bwd, kern=kern)


def k2_check(seed, t1, b, dx, k, dev, label):
    """K2's pair and particle designs against the plain Philox, bit for bit,
    and against each other; their device times alternated, three pairs (the
    pair design must be faster in each). Returns a dict."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    want = fused_step.stream_noise_reference(seed, t1, b, dx, k, dev)
    got = {d: fused_step.stream_noise(seed, t1, b, dx, k, dev, design=d)
           for d in fused_step.K2_DESIGNS}
    torch.cuda.synchronize()
    bad = {d: [int((g[i] != want[i]).sum()) for i in (0, 1)] for d, g in got.items()}
    same = all(torch.equal(got["pair"][i], got["particle"][i]) for i in (0, 1))
    pairs = [tuple(device_ms(lambda: fused_step.stream_noise(seed, t1, b, dx, k, dev, design=d))
                   for d in fused_step.K2_DESIGNS) for _ in range(3)]
    plain = time_ms(lambda: fused_step.stream_noise_reference(seed, t1, b, dx, k, dev), reps=5)
    eps, u0 = got["pair"]
    bound_ms, by = bound(80.0 * eps.numel(), nbytes(eps, u0))
    r = dict(ms=statistics.mean(p_[0] for p_ in pairs), ms_prev=statistics.mean(p_[1] for p_ in pairs),
             plain=plain, bound=bound_ms, by=by, err=float((eps - want[0]).abs().max()),
             ctas=fused_step.k2_plan(t1, b, dx, k)["ctas"])
    print(f"[{label}] K2 stream_noise [{t1},{b},{dx},{k}]: (eps, u0) mismatches with the plain Philox "
          f"{bad}; pair and particle bit-equal {same}; eps mean {float(eps.mean()):.4f} std "
          f"{float(eps.std()):.4f}, u0 mean {float(u0.mean()):.4f}; device time (pair, particle) "
          f"alternated: " + ", ".join(f"({a:.4f}, {c:.4f})" for a, c in pairs)
          + f" ms ({r['ctas']} CTAs, {kernel_resources('stream_noise_pair_kernel')}); plain "
          f"{plain:.4f} ms (events); bound {bound_ms:.4f} ms ({by})", flush=True)
    if any(sum(v) for v in bad.values()) or not same:
        fail(f"K2 at [{t1},{b},{dx},{k}] is not bit-equal to the plain Philox in both designs")
    if not all(a < c for a, c in pairs):
        fail(f"K2 at [{t1},{b},{dx},{k}]: the pair design is not faster than the particle one in "
             f"every pair")
    return r


def ffbsi_sweep(dev, dx, b, m, k, t1, gen):
    """K6's operands off the presets' shapes: support terms of a transition
    with means near the support, normalized weights, anchors; K5's
    selections and trajectories on them."""
    import torch
    from psvo_tpu_torch.ops import ffbsi

    xs = torch.randn((t1, b, dx, k), generator=gen, device=dev) * 8.0
    mean = xs + torch.randn(xs.shape, generator=gen, device=dev)
    scale = 0.5 + 1.5 * torch.rand(xs.shape, generator=gen, device=dev)
    r = 1.0 / (scale * scale)
    c = -0.5 * (mean * mean * r).sum(2) - torch.log(scale).sum(2) - dx * 0.9189385332
    lwn = torch.log_softmax(torch.randn((t1, b, k), generator=gen, device=dev) * 2.0, dim=-1)
    lg = torch.randn((t1, b, k), generator=gen, device=dev)
    u = torch.rand((t1, b, m, k), generator=gen, device=dev).clamp_min(1e-30)
    ops = [v.contiguous() for v in (torch.randn((b, m, dx), generator=gen, device=dev) * 8.0, xs, r,
                                    mean * r, c, lwn, lg, -torch.log(-torch.log(u)))]
    with torch.no_grad():
        fwd = ffbsi.ffbsi_forward(*ops)
    return (*ops[:7], fwd[4], fwd[3]), fwd


K6_MODES = {  # live cotangents among d_x_first, d_logp, d_logq, d_xtilde; the support's needs
    "all cotangents": ((0, 1, 2, 3), (True,) * 5),
    "direct bound": ((2, 3), (True, True, True, True, False)),  # what its train step hands K6
    "paths only": ((0, 3), (False,) * 5),  # the forward bound's
}


def k6_design_check(args, kw, needs):
    """K6 staged against the row design on the same operands and cotangents:
    per-leaf relative L2, whether every leaf is bit-equal, and whether each
    design gives its own bits again on a relaunch."""
    import torch
    from psvo_tpu_torch.ops import ffbsi

    st = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
    again = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
    row = ffbsi.ffbsi_backward(*args, needs=needs, design="row", **kw)
    row2 = ffbsi.ffbsi_backward(*args, needs=needs, design="row", **kw)
    torch.cuda.synchronize()
    pairs = [(a, w) for a, w in zip(st, row) if a is not None]
    return dict(staged=st, row=row,
                rel=[float((a - w).norm() / w.norm().clamp_min(1e-30)) for a, w in pairs],
                equal=all(torch.equal(a, w) for a, w in pairs),
                relaunch=all(torch.equal(a, w) for a, w in zip(st + row, again + row2)
                             if a is not None),
                finite=all(bool(torch.isfinite(a).all()) for a, _ in pairs))


def k6_wide_check(args, kw, needs, staged, plain, row):
    """Per leaf, the relative L2 distance of the staged design, the float32
    plain version and the row design to the plain version replayed in
    float64. Under the direct bound's cotangents (d_logp = 0) d_q is a
    difference of two nearly equal sums, so every float32 order lies about
    1e-4 to 1e-3 from the others there; the staged design must then be as
    close to float64 as the plain version (within twice, or the tolerance)
    and as the row design (within twice, or 1e-5)."""
    from psvo_tpu_torch.ops import ffbsi

    wide = [a.double() if a.is_floating_point() else a for a in args]
    w64 = ffbsi.ffbsi_backward_reference(*wide, needs=needs,
                                         **{n: None if v is None else v.double() for n, v in kw.items()})

    def dist(got):
        return [float((g.double() - w).norm() / w.norm().clamp_min(1e-300))
                for g, w in zip(got, w64) if w is not None]

    return dist(staged), dist(plain), dist(row)


def l96_config(small: bool):
    """The Lorenz-96 preset (B=8), or its small cut (B=4, K=128, T=10,
    hidden (16, 16)); Dx=Dy=40 either way."""
    cfg, batch = slice_config(small, L96)
    return cfg, (4 if small else cfg.train.batch_size)


def weight_rows(k: int, gen):
    """Eight log-weight rows on the card: generic, uniform, ties, zero
    weights, all floored, a floored mix, one dominant particle (the
    degenerate regime) and a wide spread."""
    import torch

    dev = gen.device
    i = torch.arange(k, device=dev)
    return torch.stack([
        torch.randn(k, device=dev, generator=gen) * 3,
        torch.zeros(k, device=dev),
        torch.randint(0, 3, (k,), device=dev, generator=gen).float() * -1,
        torch.where(i % 3 == 0, 0.0, -float("inf")),
        torch.full((k,), -3e30, device=dev),
        torch.where(i % 5 == 0, -1.0, -1e30),
        torch.where(i == (517 * k) // 1024, 0.0, -50.0),
        torch.linspace(-100.0, 0.0, k, device=dev),
    ]).contiguous()


def trunk_run(ssm, cfg, ys, gen, rng_seed=None):
    """One kernel run of the trunk path over all T−1 steps (K7, K8, K9 on the
    run's own state), holding K9's plain version to every step's x_res
    (teacher-forced) and the previous design (design="tile", bit-equal),
    and with the in-kernel draw also K9's stream mode on K2's ε (bit-equal);
    beside it the plain versions' own free run on the same noise. Returns
    the per-step relative L2 of x_new and α, the largest |Δ|, whether every
    step was allclose at 2e-4, whether every step was bit-equal to the tile
    design, the rows whose free runs took another ancestor somewhere (and
    the first such step), log Ẑ's relative difference over all rows and over
    the rows without, K7's index mismatches against its plain version on the
    same log-weights over every step, and the last step's operands."""
    import torch
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import fused_step, trunk
    from psvo_tpu_torch.ops import resample_gather as rg

    batch, t_steps, _ = ys.shape
    k, dx, dy, dev = cfg.smc.n_particles, ssm.dx, ssm.dy, ys.device
    ys_tm = ys.transpose(0, 1)
    consts = fused_step.prepare(ssm)
    aq, cq, sq, logsq = fused_step.fusion_coeffs(ssm, cfg.smc, consts, ys_tm)
    x0, alpha0 = smc._init_t0(ssm, torch.randn((batch, dx, k), generator=gen, device=dev),
                              ys_tm[0], ys_tm[0])
    ab = logsq[1:] - consts["log_sf_sum"] - consts["log_sg_sum"] - dy * 0.5 * math.log(2 * math.pi)
    coef = fused_step.pack_coef(aq[1:], cq[1:], sq[1:], ys_tm[1:], ab)
    pos = fused_step.systematic_positions(torch.rand((t_steps - 1, batch), generator=gen,
                                                     device=dev), k)
    if rng_seed is not None:
        eps = fused_step.stream_noise(rng_seed, t_steps - 1, batch, dx, k, dev)[0]
    else:
        eps = torch.randn((t_steps - 1, batch, dx, k), generator=gen, device=dev)
    x, logw = x0.contiguous(), alpha0.contiguous()
    x_p, logw_p = x, logw  # the plain versions' own free run
    flip_step = torch.full((batch,), -1, device=dev)
    ell_k, ell_p = [], []
    rel, maxd, close_all, same, same_tile, k7_bad = [], [], True, True, True, 0
    for t in range(t_steps - 1):
        idx = rg.ancestor_indices_large(logw, pos[t].contiguous())
        k7_bad += int((idx != rg.ancestor_indices_large_reference(logw, pos[t])).sum())
        idx_p = rg.ancestor_indices_large_reference(logw_p, pos[t])
        flipped = (idx != idx_p).any(dim=-1) & (flip_step < 0)
        flip_step = torch.where(flipped, torch.full_like(flip_step, t), flip_step)
        x_p, logw_p = trunk.trunk_forward_reference(rg.gather_particles_reference(x_p, idx_p),
                                                    coef[t], consts, eps[t])
        x_res = rg.gather_particles(x, idx)
        noise = {"seed": rng_seed, "t": t} if rng_seed is not None else {"eps": eps[t]}
        got = trunk.trunk_forward(x_res, coef[t], consts, **noise)
        same_tile &= all(torch.equal(a, b) for a, b in
                         zip(got, trunk.trunk_forward(x_res, coef[t], consts, **noise,
                                                      design="tile")))
        if rng_seed is not None:
            same &= all(torch.equal(a, b) for a, b in
                        zip(got, trunk.trunk_forward(x_res, coef[t], consts, eps=eps[t])))
        want = trunk.trunk_forward_reference(x_res, coef[t], consts, eps[t])
        rel.append(torch.stack([(g - w).norm() / w.norm().clamp_min(1e-30)
                                for g, w in zip(got, want)]))
        maxd.append(torch.stack([(g - w).abs().max() for g, w in zip(got, want)]))
        close_all &= close(got, want, 2e-4)
        x, logw = got
        ell_k.append(torch.logsumexp(logw, -1))
        ell_p.append(torch.logsumexp(logw_p, -1))
    rel = torch.stack(rel)
    # log Ẑ less the common t = 0 term and the −log K of every step
    log_z_k, log_z_p = torch.stack(ell_k).sum(0), torch.stack(ell_p).sum(0)
    rel_z = (log_z_k - log_z_p).abs() / log_z_p.abs().clamp_min(1e-30)
    clean = flip_step < 0
    return dict(rel_x=float(rel[:, 0].max()), rel_a=float(rel[:, 1].max()),
                flip_rows=int((~clean).sum()), first_flips=flip_step.tolist(),
                rel_z=float(rel_z.max()),
                rel_z_clean=float(rel_z[clean].max()) if bool(clean.any()) else None,
                maxd=float(torch.stack(maxd).max()), close=close_all, same=bool(same),
                same_tile=bool(same_tile), finite=bool(torch.isfinite(x).all() and torch.isfinite(logw).all()),
                k7_bad=k7_bad, last=(x_res, coef[-1], consts, eps[-1]))


def relu_ties(consts, x_res, x_new, tol=1e-5):
    """[B, K] bool: the particles where a relu pre-activation of q1 or f (on
    x_res) or of g (on x_new) lies within tol of the magnitude of its sum
    (|b| + Σ|w·x|, in float64). There the sign, and so the relu's gradient
    mask, depends on the order of the float32 sum: the kernel and its plain
    version may take either side, and that one unit's whole cotangent then
    passes on one side and not on the other."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    flag = torch.zeros((x_res.shape[0], x_res.shape[-1]), dtype=torch.bool, device=x_res.device)
    for (layers, _), inp in zip(fused_step._unpack_nets(consts), (x_res, x_res, x_new)):
        h = inp.double()
        for w, b in layers:
            w, b = w.double(), b.double()[:, None]
            pre = torch.einsum("de,bdk->bek", w, h) + b
            size = torch.einsum("de,bdk->bek", w.abs(), h.abs()) + b.abs()
            flag |= (pre.abs() < tol * size).any(dim=1)
            h = torch.relu(pre)
    return flag


def trunk_backward_run(ssm, cfg, ys, gen, rng_seed=None):
    """K10 against its plain version on every step of one kernel run of the
    trunk path (K7, K8, K9 on the run's own state), with random cotangents
    of x_new and α: teacher-forced, so both see the same x_res and x_new.
    The cotangents are zero on the particles of `relu_ties`, where a relu's
    mask is a coin toss between two float32 summation orders; the raw
    comparison, with every particle's cotangent, is reported beside it.
    The previous design (`design="simt"`) runs on every step's raw operands
    too: both recompute the trunks in K9's order, so their relu masks and
    floor cuts agree and no particle needs zeroing between them.
    Returns the largest per-step relative L2 of each leaf (d_x_res, d_coef,
    d_weights, d_sconst) and |Δ|, the raw ones, those against the previous
    design, the particles zeroed, whether a second launch on the last step
    gave the same bits, K7's index mismatches against its plain version over
    every step, and the last step's operands for timing."""
    import torch
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import fused_step, trunk
    from psvo_tpu_torch.ops import resample_gather as rg

    batch, t_steps, _ = ys.shape
    k, dx, dy, dev = cfg.smc.n_particles, ssm.dx, ssm.dy, ys.device
    ys_tm = ys.transpose(0, 1)
    consts = fused_step.prepare(ssm)
    aq, cq, sq, logsq = fused_step.fusion_coeffs(ssm, cfg.smc, consts, ys_tm)
    x, logw = smc._init_t0(ssm, torch.randn((batch, dx, k), generator=gen, device=dev),
                           ys_tm[0], ys_tm[0])
    ab = logsq[1:] - consts["log_sf_sum"] - consts["log_sg_sum"] - dy * 0.5 * math.log(2 * math.pi)
    coef = fused_step.pack_coef(aq[1:], cq[1:], sq[1:], ys_tm[1:], ab)
    pos = fused_step.systematic_positions(torch.rand((t_steps - 1, batch), generator=gen,
                                                     device=dev), k)
    if rng_seed is not None:
        eps = fused_step.stream_noise(rng_seed, t_steps - 1, batch, dx, k, dev)[0]
    else:
        eps = torch.randn((t_steps - 1, batch, dx, k), generator=gen, device=dev)
    x, logw = x.contiguous(), logw.contiguous()
    rel, maxd, rel_raw, rel_simt, zeroed, k7_bad = [], [], [], [], 0, 0
    for t in range(t_steps - 1):
        idx = rg.ancestor_indices_large(logw, pos[t].contiguous())
        k7_bad += int((idx != rg.ancestor_indices_large_reference(logw, pos[t])).sum())
        x_res = rg.gather_particles(x, idx)
        noise = {"seed": rng_seed, "t": t} if rng_seed is not None else {"eps": eps[t]}
        x_new, alpha = trunk.trunk_forward(x_res, coef[t], consts, **noise)
        d_x_new = torch.randn(x_new.shape, generator=gen, device=dev)
        d_alpha = torch.randn(alpha.shape, generator=gen, device=dev)
        raw = (x_res, x_new, coef[t], consts, d_x_new, d_alpha)
        got_raw = trunk.trunk_backward(*raw, **noise)
        rel_raw.append(torch.stack(
            [(g - w).norm() / w.norm().clamp_min(1e-30) for g, w in
             zip(got_raw, trunk.trunk_backward_reference(*raw[:4], eps[t], *raw[4:]))]))
        rel_simt.append(torch.stack(
            [(g - w).norm() / w.norm().clamp_min(1e-30) for g, w in
             zip(got_raw, trunk.trunk_backward(*raw, **noise, design="simt"))]))
        keep = ~relu_ties(consts, x_res, x_new)
        zeroed += int((~keep).sum())
        bwd = (x_res, x_new, coef[t], consts, d_x_new * keep[:, None], d_alpha * keep)
        got = trunk.trunk_backward(*bwd, **noise)
        want = trunk.trunk_backward_reference(*bwd[:4], eps[t], *bwd[4:])
        rel.append(torch.stack([(g - w).norm() / w.norm().clamp_min(1e-30)
                                for g, w in zip(got, want)]))
        maxd.append(torch.stack([(g - w).abs().max() for g, w in zip(got, want)]))
        x, logw = x_new, alpha
    same = all(torch.equal(a, b) for a, b in zip(got, trunk.trunk_backward(*bwd, **noise)))
    return dict(rel=torch.stack(rel).amax(0).tolist(), maxd=torch.stack(maxd).amax(0).tolist(),
                rel_raw=torch.stack(rel_raw).amax(0).tolist(),
                rel_simt=torch.stack(rel_simt).amax(0).tolist(), zeroed=zeroed,
                n=(t_steps - 1) * batch * k, same=same, finite=all(bool(torch.isfinite(g).all()) for g in got),
                k7_bad=k7_bad, last=(bwd, noise, eps[-1], got))


SVO = "lorenz63_svo_k256"
SVO_KERNELS = dict(FHN_KERNELS, K12=("svo_forward_split_kernel",),
                   K13=("svo_backward_split_kernel", "svo_sum_ctas_kernel"))


def svo_flops(consts, n_path_steps: int) -> float:
    """FLOP of the qb, f and g trunk forwards on n_path_steps (path, step) pairs."""
    dx, dy, h, n_mid = consts["dx"], consts["dy"], consts["hidden"], consts["n_mid"]

    def net(din, dout):
        return 2 * (din * h + n_mid * h * h + h * dout)

    return float(net(dx + dy, dx) + net(dx, dx) + net(dx, dy)) * n_path_steps


def svo_operands(ssm, cfg, ys, gen):
    """K12's operands as the SVO objective builds them, from one K1 run with
    the preset's in-kernel draw and the cache: the anchors drawn from the
    last weights, fresh ε, and y_t of t = 0 .. T-2."""
    from types import SimpleNamespace

    import torch
    from psvo_tpu_torch import objectives
    from psvo_tpu_torch.ops import fused_step, svo

    inp = kernel_inputs(ssm, cfg, ys, gen)
    x_last, alpha_last = fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"],
                                                 inp["consts"], seed=(23, 29), cache=True)[:2]
    batch, t_steps, _ = ys.shape
    m, k = cfg.smc.n_smoothing_particles, cfg.smc.n_particles
    x_anchor, _ = objectives._sample_final_particles(
        objectives._gumbel(gen, (batch, m, k)), SimpleNamespace(x_last=x_last, logw_last=alpha_last))
    eps = torch.randn((t_steps - 1, batch, m, ssm.dx), generator=gen, device=ys.device)
    y = ys.transpose(0, 1)[:-1].contiguous()
    return svo.prepare(ssm), (x_anchor.contiguous(), eps, y)


def svo_forward_check(consts, ops):
    """K12 (the split design) against its plain version: the free runs
    (x_first, lp, lq, every step of x~) and, teacher-forced, one plain step
    from each of the kernel's own x~_{t+1}; and against the previous design
    (design="chain"), bit for bit in all four outputs. Returns a dict."""
    import torch
    from psvo_tpu_torch.ops import svo

    x_anchor, eps, y = ops
    kern = svo.svo_sweep_forward(*ops, consts)
    prev = svo.svo_sweep_forward(*ops, consts, design="chain")
    ref = svo.svo_sweep_forward_reference(*ops, consts)
    t1, b, m, dx = eps.shape
    x_next = torch.cat([kern[3][1:], x_anchor[None]]).reshape(t1 * b, m, dx)
    x_tf, lp_tf, lq_tf = svo._step(svo._nets(consts), consts["sc"], dx, consts["dy"], x_next,
                                   y.reshape(t1 * b, -1), eps.reshape(t1 * b, m, dx))
    x_k = kern[3].reshape(t1 * b, m, dx)
    torch.cuda.synchronize()

    def rel(a, w):
        return float(((a - w).abs() / (1 + w.abs())).max())

    return dict(kern=kern, close=close(kern, ref, 2e-4), max_abs_err=max_err(kern, ref),
                rel_x=rel(kern[3], ref[3]), rel_lp=rel(kern[1], ref[1]), rel_lq=rel(kern[2], ref[2]),
                tf_x=rel(x_k, x_tf), same_prev=all(torch.equal(a, b) for a, b in zip(kern, prev)),
                finite=all(bool(torch.isfinite(t).all()) for t in kern))


def svo_relu_ties(consts, ops, xtilde, tol=1e-5):
    """[B, M] bool: the paths on which, at some step, a relu pre-activation of
    qb (on [x~_{t+1}; y_t]) or of f or g (on x~_t) lies within tol of the
    magnitude of its sum (|b| + sum |w x|, in float64): there the relu's
    gradient mask depends on the order of the float32 sum (see relu_ties)."""
    import torch
    from psvo_tpu_torch.ops import svo

    x_anchor, _, y = ops
    x_next = torch.cat([xtilde[1:], x_anchor[None]])
    y_b = y[:, :, None, :].expand(-1, -1, x_next.shape[2], -1)
    flag = torch.zeros(x_anchor.shape[:2], dtype=torch.bool, device=x_anchor.device)
    for (layers, _), inp in zip(svo._nets(consts), (torch.cat([x_next, y_b], -1), xtilde, xtilde)):
        h = inp.double()
        for w, b in layers:
            w, b = w.double(), b.double()
            pre = h @ w + b
            size = h.abs() @ w.abs() + b.abs()
            flag |= (pre.abs() < tol * size).any(-1).any(0)
            h = torch.relu(pre)
    return flag


def svo_backward_check(consts, ops, xtilde, gen):
    """K13 (the split design) against its plain version on K12's x~, with
    random cotangents of all four outputs: raw, and zeroed on the paths of
    `svo_relu_ties`. Returns per-leaf relative L2 (d_x_anchor, d_weights,
    d_sc) and |Δ| of the masked run, the raw relative L2, the paths zeroed,
    the masked run's relative L2 against the previous design (chain),
    whether a second launch gave the same bits, and the masked run's
    operands for timing."""
    import torch
    from psvo_tpu_torch.ops import svo

    dev = xtilde.device
    b, m = xtilde.shape[1], xtilde.shape[2]
    cots = [torch.randn(s, generator=gen, device=dev) for s in
            ((b, m, xtilde.shape[3]), (b, m), (b, m), tuple(xtilde.shape))]

    def rel(got, want):
        return [float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in zip(got, want)]

    raw = rel(svo.svo_sweep_backward(*ops, consts, xtilde, *cots),
              svo.svo_sweep_backward_reference(*ops, consts, xtilde, *cots))
    tie = svo_relu_ties(consts, ops, xtilde)
    keep = (~tie).float()
    cots = [cots[0] * keep[..., None], cots[1] * keep, cots[2] * keep, cots[3] * keep[..., None]]
    got = svo.svo_sweep_backward(*ops, consts, xtilde, *cots)
    want = svo.svo_sweep_backward_reference(*ops, consts, xtilde, *cots)
    again = svo.svo_sweep_backward(*ops, consts, xtilde, *cots)
    prev = svo.svo_sweep_backward(*ops, consts, xtilde, *cots, design="chain")
    torch.cuda.synchronize()
    args = (*ops, consts, xtilde, *cots)
    return dict(rel=rel(got, want), maxd=[float((g - w).abs().max()) for g, w in zip(got, want)],
                rel_raw=raw, zeroed=int(tie.sum()), n=b * m, rel_prev=rel(got, prev),
                same=all(torch.equal(g, a) for g, a in zip(got, again)),
                finite=all(bool(torch.isfinite(g).all()) for g in got), args=args, got=got)


STEP_KERNELS = {"K14": ("step_forward_kernel",),
                "K15": ("step_backward_kernel", "sum_rows_kernel")}
STEP_PSVO_KERNELS = dict(STEP_KERNELS, K5=("ffbsi_staged_kernel",), K6=K6_KERNELS)


STEP_OUTPUTS = ("x_new", "alpha", "ell", "ess", "filtered mean")


def step_outputs(out):
    """K14's float outputs, the stats split by column: x_new, α, ℓ, ESS and
    the filtered mean."""
    x_new, alpha, stats = out[:3]
    return x_new, alpha, stats[:, 0], stats[:, 1], stats[:, 2:]


def step_chain_check(ssm, cfg, ys, gen):
    """K14 chained over T−1 steps on fresh streams. Every step is held to
    step_forward_reference on the kernel's own incoming state (teacher-forced:
    indices equal; x_new, α, ℓ, ESS and the filtered mean by relative L2,
    and elementwise |Δ|/(1+|w|) reported), and the chain to one K1 launch on
    the same streams (indices equal, the largest |Δ| of x_new, α and stats).
    Returns a dict with the chain's residuals [x_all, alpha_all, stats, idx]
    and K1's inputs."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    inp = kernel_inputs(ssm, cfg, ys, gen)
    consts, coef, eps, pos = inp["consts"], inp["coef"], inp["eps"], inp["positions"]
    k1 = fused_step.scan_forward(inp["x0"], inp["alpha0"], coef, consts, eps=eps, positions=pos,
                                 cache=True, save_res=True)
    x, lw = inp["x0"], inp["alpha0"]
    steps, idx_bad, tf_l2, tf_rel, tf_abs = [], 0, [], [], 0.0
    for t in range(coef.shape[0]):
        out = fused_step.step_forward(x, lw, coef[t], consts, eps[t], pos[t])
        ref = fused_step.step_forward_reference(x, lw, coef[t], consts, eps[t], pos[t])
        idx_bad += int((out[3] != ref[3]).sum())
        pairs = list(zip(step_outputs(out), step_outputs(ref)))
        tf_l2.append(torch.stack([(a - w).norm() / w.norm().clamp_min(1e-30) for a, w in pairs]))
        tf_rel.append(torch.stack([((a - w).abs() / (1 + w.abs())).max() for a, w in pairs]))
        tf_abs = max(tf_abs, max_err(out[:3], ref[:3]))
        steps.append(out)
        x, lw = out[0], out[1]
    torch.cuda.synchronize()
    chain = [torch.stack([s[i] for s in steps]) for i in range(4)]
    vs_k1 = [float((a.float() - b.float()).abs().max()) for a, b in
             zip(chain, (k1[3], k1[4], k1[2], k1[5]))]
    return dict(inp=inp, chain=chain, idx_bad=idx_bad, tf_l2=torch.stack(tf_l2).amax(0).tolist(),
                tf_rel=torch.stack(tf_rel).amax(0).tolist(), tf_abs=tf_abs,
                k1_idx=int((chain[3] != k1[5]).sum()), vs_k1=vs_k1[:3],
                finite=all(bool(torch.isfinite(c).all()) for c in chain[:3]))


def step_backward_check(res, gen):
    """K15 against step_backward_reference on every step of a K14 chain's
    residuals, with random d x_new, d α and d ℓ (and random dropped stats
    columns): raw, and with d x_new and d α zeroed on the particles of
    `relu_ties`; bit-equal on a second launch. Then the T−1 K15 launches
    chained in reverse against one K4 launch on the same residuals, with
    K4's cache cotangents (d x_new = the next step's d x + d_x_all[t]; d α =
    d_alpha_all[t], plus d_alpha_last at the end) and d_ℓ = −1/B: d_x0,
    d_coef and the summed weight and sconst gradients. Returns a dict, with
    the last step's masked operands for timing."""
    import torch
    from psvo_tpu_torch.ops import fused_step
    from psvo_tpu_torch.ops.resampling import gather_particles

    inp, (x_all, alpha_all, stats, idx) = res["inp"], res["chain"]
    consts, coef, eps, x0 = inp["consts"], inp["coef"], inp["eps"], inp["x0"]
    t1, b, dx, k = x_all.shape
    dev = x_all.device

    def rel(got, want):
        return torch.stack([(g - w).norm() / w.norm().clamp_min(1e-30) for g, w in zip(got, want)])

    rels, raws, maxd, zeroed, same = [], [], [], 0, True
    for t in range(t1):
        x_in = x0 if t == 0 else x_all[t - 1]
        d_stats = torch.randn(stats[t].shape, generator=gen, device=dev)
        d_xn = torch.randn(x_in.shape, generator=gen, device=dev)
        d_al = torch.randn(alpha_all[t].shape, generator=gen, device=dev)
        args = (x_in, x_all[t], idx[t], stats[t], coef[t], consts, eps[t], d_stats)
        plain = (x_in, coef[t], consts, eps[t], idx[t], d_stats)
        raws.append(rel(fused_step.step_backward(*args, d_xn, d_al),
                        fused_step.step_backward_reference(*plain, d_xn, d_al)))
        keep = ~relu_ties(consts, gather_particles(x_in, idx[t]), x_all[t])
        zeroed += int((~keep).sum())
        d_xn, d_al = d_xn * keep[:, None], d_al * keep
        got = fused_step.step_backward(*args, d_xn, d_al)
        again = fused_step.step_backward(*args, d_xn, d_al)
        want = fused_step.step_backward_reference(*plain, d_xn, d_al)
        same &= all(torch.equal(g, a) for g, a in zip(got, again))
        rels.append(rel(got, want))
        maxd.append(torch.stack([(g - w).abs().max() for g, w in zip(got, want)]))
    last = (args, d_xn, d_al, got)

    d_stats = torch.randn(stats.shape, generator=gen, device=dev)
    d_stats[..., 0] = -1.0 / b
    d_x_last = torch.randn(x0.shape, generator=gen, device=dev)
    d_a_last = torch.randn((b, k), generator=gen, device=dev)
    d_x_all = torch.randn(x_all.shape, generator=gen, device=dev) * 0.1
    d_a_all = torch.randn(alpha_all.shape, generator=gen, device=dev) * 0.1
    k4 = fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, d_x_last, d_a_last,
                                  d_x_all, d_a_all, eps=eps)
    d_x, d_coef, d_packed, d_sconst = d_x_last, [None] * t1, 0.0, 0.0
    for t in reversed(range(t1)):
        d_al = d_a_all[t] + d_a_last if t == t1 - 1 else d_a_all[t]
        d_x, d_coef[t], dp, ds = fused_step.step_backward(
            x0 if t == 0 else x_all[t - 1], x_all[t], idx[t], stats[t], coef[t], consts, eps[t],
            d_stats[t], d_x + d_x_all[t], d_al)
        d_packed, d_sconst = d_packed + dp, d_sconst + ds
    vs_k4 = rel((d_x, torch.stack(d_coef), d_packed, d_sconst), k4)
    torch.cuda.synchronize()
    return dict(rel=torch.stack(rels).amax(0).tolist(), maxd=torch.stack(maxd).amax(0).tolist(),
                rel_raw=torch.stack(raws).amax(0).tolist(), zeroed=zeroed, n=t1 * b * k,
                same=bool(same), vs_k4=vs_k4.tolist(), last=last,
                finite=all(bool(torch.isfinite(g).all()) for g in got))


def step_bounds(consts, fwd_args, fwd_out, bwd):
    """Bounds of one K14 launch (its operands in, its outputs out, the three
    trunks' FLOP per particle) and of one K15 launch (three times the FLOP, as
    K4 per step; residuals and cotangents in, gradients out)."""
    x = fwd_args[0]
    n_part = x.shape[0] * x.shape[-1]
    k14 = bound(trunk_flops(consts) * n_part,
                nbytes(*fwd_args, consts["packed"], consts["sconst"], *fwd_out))
    args, d_xn, d_al, got = bwd
    k15 = bound(3 * trunk_flops(consts) * n_part,
                nbytes(*args[:5], args[6], args[7], consts["packed"], consts["sconst"], d_xn, d_al,
                       *got))
    return k14, k15


def cluster_sweep(ssm, cfg, ys, gen, rng_seed=None, cache=False):
    """K1 and K4 at every cluster size C that the gates and the card admit,
    against C = 1 on the same inputs (K1's residual mode, the train path's):
    every K1 output and K4's d_x0 bit for bit, K4's d_coef, weight and sconst
    gradients by relative L2, each C bit-equal on a relaunch. Then CUDA-event
    times of each C (median of 5 after 2 warm-up runs), C = 1 and the chosen
    C alternated: 1, chosen, the others, chosen, 1. Returns a dict."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    inp = kernel_inputs(ssm, cfg, ys, gen)
    consts, coef = inp["consts"], inp["coef"]
    b, k, dev = coef.shape[1], cfg.smc.n_particles, ys.device
    noise = ({"seed": rng_seed} if rng_seed is not None
             else {"eps": inp["eps"], "positions": inp["positions"]})
    bnoise = {"seed": rng_seed} if rng_seed is not None else {"eps": inp["eps"]}
    max_active = [fused_step.max_active_clusters(kern, dev, consts, k) for kern in (0, 1)]
    chosen = (fused_step.cluster_size(b, k, fused_step.K1_MIN_SLICE, max_active[0]),
              fused_step.cluster_size(b, k, fused_step.K4_MIN_SLICE, max_active[1]))
    sizes = ([c for c in fused_step.CLUSTER_SIZES if max_active[0][c] > 0
              and (c == 1 or k % (c * fused_step.K1_MIN_SLICE) == 0)],
             [c for c in fused_step.CLUSTER_SIZES if max_active[1][c] > 0
              and fused_step._k4_ok(consts, k, c)])

    def fwd(c):
        return fused_step.scan_forward(inp["x0"], inp["alpha0"], coef, consts, cache=cache,
                                       save_res=True, cluster=c, **noise)

    def equal(xs, ys_):
        return all(torch.equal(a, w) for a, w in zip(xs, ys_) if a is not None)

    one = fwd(1)
    k1 = {}
    for c in sizes[0]:
        got, again = fwd(c), fwd(c)
        k1[c] = {"equal": equal(got, one), "same": equal(got, again)}
    x_last, alpha_last, stats, x_all, alpha_all, idx = one
    d_stats = torch.randn(stats.shape, generator=gen, device=dev)
    d_stats[..., 0] = -1.0 / b
    cots = [torch.randn(t.shape, generator=gen, device=dev) for t in (x_last, alpha_last)]
    cots += ([torch.randn(t.shape, generator=gen, device=dev) * 0.1 for t in (x_all, alpha_all)]
             if cache else [None, None])
    bwd_args = (inp["x0"], x_all, idx, stats, coef, consts, d_stats, *cots)

    def bwd(c):
        return fused_step.scan_backward(*bwd_args, cluster=c, **bnoise)

    base = bwd(1)
    k4 = {}
    for c in sizes[1]:
        got, again = bwd(c), bwd(c)
        k4[c] = {"dx0_equal": torch.equal(got[0], base[0]), "same": equal(got, again),
                 "rel": [float((g - w).norm() / w.norm().clamp_min(1e-30))
                         for g, w in zip(got[1:], base[1:])]}
    torch.cuda.synchronize()
    ms = []
    for kern, fn in ((0, fwd), (1, bwd)):
        c_ = chosen[kern]
        order = [1, c_] + [c for c in sizes[kern] if c not in (1, c_)] + [c_, 1]
        times = {}
        with torch.no_grad():
            for c in order:
                times.setdefault(c, []).append(time_ms(lambda: fn(c)))
        ms.append(times)
    return dict(max_active=max_active, chosen=chosen, sizes=sizes, k1=k1, k4=k4, ms=ms)


def slice_sweep(fwd_args, bwd_args, gen):
    """K14 and K15 at every slice count S that the gates admit, against S = 1
    on one step's operands: K14 on fwd_args (every output bit for bit), K15
    on bwd_args with random cotangents (d_x bit for bit; d_coef, the weight
    and sconst gradients by relative L2, and where one exceeds 1e-6 its
    distance from a float64 replay of step_backward_reference beside S = 1's),
    each S bit-equal on a relaunch. Then device times per S from
    torch.profiler (20 launches), S = 1 and the chosen S alternated: 1,
    chosen, the others, chosen, 1; K15's sum_rows_kernel apart. Returns a dict."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    consts = fwd_args[3]
    b, k = fwd_args[0].shape[0], fwd_args[0].shape[-1]
    dev = fwd_args[0].device
    mins = (fused_step.K1_MIN_SLICE, fused_step.K4_MIN_SLICE)
    resident = [fused_step.resident_ctas(kern, dev, consts, k) for kern in (0, 1)]
    chosen = [fused_step.step_slices(b, k, mins[kern], resident[kern]) for kern in (0, 1)]
    sizes = [[s for s in fused_step.STEP_SLICES if s == 1 or k % (s * m) == 0] for m in mins]
    x, x_new, idx, stats, coef, eps = bwd_args
    cots = (torch.randn(stats.shape, generator=gen, device=dev),
            torch.randn(x_new.shape, generator=gen, device=dev),
            torch.randn((b, k), generator=gen, device=dev))
    bwd_all = (x, x_new, idx, stats, coef, consts, eps, *cots)

    def fwd(s):
        return fused_step.step_forward(*fwd_args, slices=s)

    def bwd(s):
        return fused_step.step_backward(*bwd_all, slices=s)

    def equal(xs, ys_):
        return all(torch.equal(a, w) for a, w in zip(xs, ys_))

    def rel(a, w):
        return float((a - w).norm() / w.norm().clamp_min(1e-30))

    one_f, one_b = fwd(1), bwd(1)
    k14 = {s: {"equal": equal(fwd(s), one_f), "same": equal(fwd(s), fwd(s))} for s in sizes[0]}
    k15, ref64 = {}, None
    for s in sizes[1]:
        got, again = bwd(s), bwd(s)
        r = k15[s] = {"dx_equal": torch.equal(got[0], one_b[0]), "same": equal(got, again),
                      "rel": [rel(g, w) for g, w in zip(got[1:], one_b[1:])], "vs64": {}}
        for i, e in enumerate(r["rel"], 1):
            if e > 1e-6:  # the sums against float64 instead: no further than S = 1's
                if ref64 is None:
                    c64 = dict(consts, packed=consts["packed"].double(),
                               sconst=consts["sconst"].double())
                    ref64 = fused_step.step_backward_reference(
                        x.double(), coef.double(), c64, eps.double(), idx,
                        *(c.double() for c in cots))
                r["vs64"][i] = (rel(got[i].double(), ref64[i]), rel(one_b[i].double(), ref64[i]))
    torch.cuda.synchronize()
    ms = []
    for kern, fn in ((0, fwd), (1, bwd)):
        c_ = chosen[kern]
        order = [1, c_] + [s for s in sizes[kern] if s not in (1, c_)] + [c_, 1]
        times = {}
        with torch.no_grad():
            for s in order:
                times.setdefault(s, []).append(device_ms_by_kernel(lambda: fn(s)))
        ms.append(times)
    return dict(resident=resident, chosen=chosen, sizes=sizes, k14=k14, k15=k15, ms=ms)


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
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[a] device={name} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} tf32=off", flush=True)

    # (b) build
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    regs = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers[^\n]*", _build.build_log(), re.S)
    spills = re.findall(r"Function properties for (\w+)\s+\d+ bytes stack frame, (\d+) bytes spill "
                        r"stores", _build.build_log())
    print(f"[b] build {build_s:.1f} s; registers "
          + ", ".join(f"{n}={r}" for n, r in regs)
          + f"; max spill stores {max((int(s) for _, s in spills), default=0)} B; spill stores "
          + (", ".join(f"{n}={s} B" for n, s in spills if int(s)) or "none"), flush=True)
    phase_done("a, b: card and build")

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
    phase_done("c")

    # (d) K2 vs plain Philox at the slice shape, both designs
    seed = (0x1234ABCD, 0x0F0F1234)
    t1, b_, dx = 99, 32, 2
    k2 = k2_check(seed, t1, b_, dx, k, dev, "d")
    phase_done("d")

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
    phase_done("e")

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
    phase_done("f")

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
    phase_done("g")

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
    phase_done("h")

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
    held_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases still hold
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
          f"device memory {peak_gb:.3f} GB, of which earlier phases held {held_gb:.3f} GB "
          f"before the run", flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               FHN_KERNELS)
    print(f"[i] profile of one more call: {profile}", flush=True)
    want = len(train_batches) * n_per_call
    if k1_train != want or k4_train != want or plain_calls != 0:
        fail(f"train path launched K1 {k1_train} and K4 {k4_train} times (want {want} each), "
             f"plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("training gave non-finite losses or gradient norms, or left the parameters as they were")
    phase_done("i")

    # (j) K1 and K4 at the Lorenz-63 shape, on Lorenz-63 observations
    l63 = "lorenz63_psvo_k1024"
    lcfg = pt.PRESETS[l63]
    lds = pt.generate_dataset(lcfg.data, SEED)
    l_obs = torch.cat([lds.obs_test, lds.obs_train]).to(dev)
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small, l63)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 3), device=dev)
        ys = l_obs[:batch, :cfg.data.t_steps].contiguous()
        with torch.no_grad():
            r = check_scan(label, ssm, cfg, ys, gen, tol=2e-4)
        print(f"[j] K1 Lorenz-63 stream {label} B={batch} K={cfg.smc.n_particles} "
              f"T={cfg.data.t_steps} hidden={cfg.net('q1').hidden}: {scan_line(r)}", flush=True)
        if not scan_ok(r, small):
            fail(f"K1 (Lorenz-63, {label}) disagrees with scan_forward_reference")
        for mode, cache in (("stream", False), ("stream, cache cotangents", True)):
            with torch.no_grad():
                rb = check_backward(ssm, cfg, ys, gen, None, cache)
            tol = 1e-4 if small else 1e-3
            print(f"[j] K4 Lorenz-63 {label} {mode}: "
                  + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                              for n, e, m in zip(leaves, rb["rel"], rb["maxd"]))
                  + f"; idx nondecreasing {rb['monotone']}; bound rel L2 {tol:g}", flush=True)
            if not rb["monotone"]:
                fail("K1's ancestor indices are not nondecreasing (Lorenz-63)")
            if not (rb["finite"] and max(rb["rel"]) <= tol):
                fail(f"K4 (Lorenz-63, {label}, {mode}) disagrees with scan_backward_reference")
    with torch.no_grad():  # times at full size: K1 with cache, K4 with the cache cotangents
        inp = kernel_inputs(ssm, cfg, ys, gen)
        args = (inp["x0"], inp["alpha0"], inp["coef"], inp["consts"])
        noise = dict(eps=inp["eps"], positions=inp["positions"], cache=True)
        k1l = [time_ms(lambda: fused_step.scan_forward(*args, **noise)),
               time_ms(lambda: fused_step.scan_forward_reference(*args, inp["eps"], inp["positions"],
                                                                 cache=True))]
        k1l += [time_ms(lambda: fused_step.scan_forward(*args, **noise)),
                time_ms(lambda: fused_step.scan_forward_reference(*args, inp["eps"], inp["positions"],
                                                                  cache=True))]
        k4l_run = rb
        k4l = [time_ms(rb["kernel"]), time_ms(rb["plain"]), time_ms(rb["kernel"]), time_ms(rb["plain"])]
    outs_l = fused_step.scan_forward(*args, **noise)
    t1, k = inp["coef"].shape[0], inp["x0"].shape[-1]
    k1l_bound, k1l_by = bound(trunk_flops(inp["consts"]) * t1 * batch * k,
                              nbytes(*args[:3], inp["consts"]["packed"], inp["consts"]["sconst"],
                                     inp["eps"], inp["positions"], *outs_l[:5]))
    k4l_bound, k4l_by = bound(k4l_run["flops"], k4l_run["n_bytes"])
    print(f"[j] Lorenz-63 full: K1 (stream, cache) {k1l[0]:.3f}/{k1l[2]:.3f} ms vs plain "
          f"{k1l[1]:.3f}/{k1l[3]:.3f} ms, bound {k1l_bound:.3f} ms ({k1l_by}); K4 (cache "
          f"cotangents) {k4l[0]:.3f}/{k4l[2]:.3f} ms vs plain {k4l[1]:.3f}/{k4l[3]:.3f} ms, bound "
          f"{k4l_bound:.3f} ms ({k4l_by}); shared memory of K4 "
          f"{fused_step.k4_smem_bytes(inp['consts'], k)} B", flush=True)
    phase_done("j")

    # (k) K5 and K6 vs their plain versions on the cache of one K1 run
    from psvo_tpu_torch.ops import ffbsi

    sweeps = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small, l63)
        if small:
            cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, n_smoothing_particles=8))
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 4), device=dev)
        ys = l_obs[:batch, :cfg.data.t_steps].contiguous()
        with torch.no_grad():
            ops = ffbsi_operands(ssm, cfg, ys, gen)
            rf = check_ffbsi(ops, gen)
        sweeps[label] = (ops, rf)
        tol = 1e-4 if small else 1e-3
        print(f"[k] K5 {label} B={batch} M={ops[0].shape[1]} K={cfg.smc.n_particles} "
              f"T={cfg.data.t_steps}: {rf['flips']} differing selections in {rf['flip_paths']} "
              f"paths; paths without: x~ equal {rf['same_x']}, max rel d logp {rf['rel_logp']:.3e}, "
              f"logq {rf['rel_logq']:.3e}; max|d| {rf['max_abs_err']:.3e}", flush=True)
        for mode, rb in rf["bwd"].items():
            dc = k6_design_check(rb["args"], rb["kw"], rb["needs"])
            print(f"[k] K6 {label} {mode} (staged): per-leaf rel L2 against the plain version "
                  + ", ".join(f"{e:.3e}" for e in rb["rel"]) + " (d_x_anchor, d_xs, then the "
                  f"wanted ones of d_r, d_mr, d_c, d_lwn, d_lg), max|d| {max(rb['maxd']):.3e}; "
                  f"bound rel L2 {tol:g}; against the row design "
                  + ("bit-equal" if dc["equal"] else "max rel L2 " + f"{max(dc['rel']):.3e}")
                  + f"; bit-equal on relaunch {dc['relaunch']}", flush=True)
            if not (rb["finite"] and rb["nones"] and dc["relaunch"] and dc["finite"]):
                fail(f"K6 ({label}, {mode}): non-finite, a leaf wrongly None, or not bit-equal on "
                     f"relaunch")
            if mode == "direct bound":
                with torch.no_grad():
                    plain = ffbsi.ffbsi_backward_reference(*rb["args"], needs=rb["needs"], **rb["kw"])
                d_st, d_pl, d_rw = k6_wide_check(rb["args"], rb["kw"], rb["needs"], dc["staged"],
                                                 plain, dc["row"])
                print(f"[k] K6 {label} direct bound: per-leaf rel L2 to the float64 plain replay, "
                      f"staged {', '.join(f'{e:.3e}' for e in d_st)}; float32 plain "
                      f"{', '.join(f'{e:.3e}' for e in d_pl)}; row "
                      f"{', '.join(f'{e:.3e}' for e in d_rw)}", flush=True)
                if not all(a <= max(tol, 2 * p_) and a <= max(1e-5, 2 * r_)
                           for a, p_, r_ in zip(d_st, d_pl, d_rw)):
                    fail(f"K6 ({label}, direct bound): the staged design is further from the "
                         f"float64 replay than the plain version or the row design")
                continue
            if max(rb["rel"]) > tol:
                fail(f"K6 ({label}, {mode}) disagrees with ffbsi_backward_reference")
            if not (max(dc["rel"]) <= 1e-5 and (mode != "paths only" or dc["equal"])):
                fail(f"K6 ({label}, {mode}): the staged design disagrees with the row design")
        if not (rf["finite"] and rf["same_x"] and rf["rel_logq"] <= 1e-5 and rf["rel_logp"] <= 1e-5):
            fail(f"K5 ({label}) disagrees with ffbsi_forward_reference")
        if small and rf["flips"]:
            fail("K5 (small) picked other particles than its plain version")
        # the staged design against the previous one on the same operands
        with torch.no_grad():
            prev = ffbsi.ffbsi_forward(*ops, design="path")
        torch.cuda.synchronize()
        kern = rf["kern"]
        equal = [torch.equal(kern[i], prev[i]) for i in (4, 3, 0, 1)]
        rel_q = float(((kern[2] - prev[2]).abs() / prev[2].abs().clamp_min(1e-30)).max())
        p_k5 = ffbsi.k5_paths(batch, ops[0].shape[1], n_sms)
        print(f"[k] K5 {label}, staged ({p_k5} paths a CTA, chunk "
              f"{ffbsi.k5_chunk(ops[1].shape[2], ops[1].shape[3], p_k5)} particles) against the "
              f"previous design (path): sel, x~, x_first, logp equal {equal}; logq max "
              f"rel {rel_q:.3e} (bound 1e-06)", flush=True)
        if not (all(equal) and rel_q <= 1e-6):
            fail(f"K5 ({label}): the staged design disagrees with the previous one")
    ops, rf = sweeps["full"]
    with torch.no_grad():
        k5_pairs = [tuple(device_ms(lambda: ffbsi.ffbsi_forward(*ops, design=d))
                          for d in ("staged", "path")) for _ in range(3)]
        k5 = [statistics.mean(p_[0] for p_ in k5_pairs),
              time_ms(lambda: ffbsi.ffbsi_forward_reference(*ops))]
        k5 += [statistics.mean(p_[1] for p_ in k5_pairs),
               time_ms(lambda: ffbsi.ffbsi_forward_reference(*ops))]
        k6 = {}  # mode: (staged, row) device ms alternated, three pairs; plain ms (events)
        for mode, rb in rf["bwd"].items():
            a_, kw_, n_ = rb["args"], rb["kw"], rb["needs"]
            pairs = [tuple(device_ms(lambda: ffbsi.ffbsi_backward(*a_, needs=n_, design=d, **kw_))
                           for d in ffbsi.K6_DESIGNS) for _ in range(3)]
            k6[mode] = dict(pairs=pairs, plain=time_ms(rb["plain"]),
                            ms=statistics.mean(p_[0] for p_ in pairs),
                            ms_prev=statistics.mean(p_[1] for p_ in pairs))
    t1, batch, m, dx, k = ops[1].shape[0], ops[1].shape[1], ops[0].shape[1], ops[1].shape[2], ops[1].shape[3]
    n_pair = t1 * batch * m * k
    # K5: per (t, b, m, j) the pair (5 operations per state dimension and 3 more), the
    # logit, the Gumbel add and compare, and the running exp-sum: 5·Dx + 8.
    k5_bound, k5_by = bound((5 * dx + 8) * n_pair, nbytes(*ops, *rf["kern"]))
    # K6 with pair cotangents: one evaluation of the pair with its floor and logit
    # (5·Dx + 6), the exp and the sums e, e·mr, e·r (2·Dx + 3), d_pair and its
    # per-particle sums (2·Dx + 9) per (t, b, m, j); on the paths alone one selection
    # compare per (t, b, m, j).
    k6_cost = {mode: (9 * dx + 18) * n_pair for mode in k6}
    k6_cost["paths only"] = n_pair
    k6_bound = {mode: bound(k6_cost[mode], rb["n_bytes"]) for mode, rb in rf["bwd"].items()}
    k5_p = ffbsi.k5_paths(batch, m, n_sms)
    print(f"[k] K5 full, device time per call (torch.profiler, 20 calls), (staged, path) "
          f"alternated: " + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in k5_pairs)
          + f" ms; staged {kernel_resources(f'ffbsi_staged_kernelILi{dx}ELi{k5_p}ELb{int(ffbsi.k5_chunk(dx, k, k5_p) >= k)}EE')}, "
          f"{ffbsi.k5_smem_bytes(dx, k, k5_p)} B of dynamic shared memory ({k5_p} paths a CTA, "
          f"{batch * -(-m // k5_p)} CTAs, {ffbsi.k5_slots(dx, k, k5_p)} slots); path "
          f"{kernel_resources(f'ffbsi_forward_kernelILi{dx}EE')}", flush=True)
    if not all(a < b_ for a, b_ in k5_pairs):
        fail("K5: the staged design is not faster than the previous one in every pair")
    print(f"[k] full: K5 staged {k5[0]:.4f} ms (dev), path {k5[2]:.4f} ms (dev) vs plain "
          f"{k5[1]:.3f}/{k5[3]:.3f} ms, bound {k5_bound:.4f} ms ({k5_by})", flush=True)
    for mode, v in k6.items():
        print(f"[k] full: K6 {mode}, device time (staged, row) alternated: "
              + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in v["pairs"])
              + f" ms; plain {v['plain']:.3f} ms (events); bound {k6_bound[mode][0]:.4f} ms "
              f"({k6_bound[mode][1]})", flush=True)
        if not all(a < b_ for a, b_ in v["pairs"]):
            fail(f"K6 ({mode}): the staged design is not faster than the row design in every pair")
    print(f"[k] K6 staged: all-cotangents kernel "
          f"{kernel_resources(f'ffbsi_bwd_staged_kernelILi{dx}ELi{ffbsi.K6_GROUP}ELb1EE')}, "
          f"{ffbsi.k6_smem_bytes(dx, m, k)} B of dynamic shared memory, a persistent CTA per slot "
          f"the card holds; paths-only kernel {kernel_resources(f'ffbsi_bwd_paths_kernelILi{dx}EE')}; "
          f"row design {kernel_resources(f'ffbsi_backward_kernelILi{dx}EE')}", flush=True)
    # K6 off the preset's shapes: M = 256, and K = 8192 (chunked rows), on a generator of
    # their own (the later phases' draws stay as they were)
    gen_x = torch.Generator(device=dev).manual_seed(SEED + 31)
    for label, (b_x, m_x, k_x, t_x) in (("M=256", (8, 256, 1024, 20)), ("K=8192", (2, 16, 8192, 20))):
        args_x, fwd_x = ffbsi_sweep(dev, 3, b_x, m_x, k_x, t_x, gen_x)
        cots_x = [torch.randn(t_.shape, generator=gen_x, device=dev) for t_ in fwd_x[:4]]
        for mode, (live, needs) in K6_MODES.items():
            kw_x = {n_: cots_x[i] if i in live else None
                    for i, n_ in enumerate(("d_x_first", "d_logp", "d_logq", "d_xtilde"))}
            with torch.no_grad():
                got = ffbsi.ffbsi_backward(*args_x, needs=needs, **kw_x)
            want = ffbsi.ffbsi_backward_reference(*args_x, needs=needs, **kw_x)
            rel = [float((g_ - w_).norm() / w_.norm().clamp_min(1e-30))
                   for g_, w_ in zip(got, want) if w_ is not None]
            dc = k6_design_check(args_x, kw_x, needs)
            print(f"[k] K6 {label} (B={b_x}, M={m_x}, K={k_x}, T-1={t_x}) {mode}: max rel L2 against "
                  f"the plain version {max(rel):.3e} (bound 1e-3), against the row design "
                  + ("bit-equal" if dc["equal"] else f"{max(dc['rel']):.3e}")
                  + f", bit-equal on relaunch {dc['relaunch']}", flush=True)
            if not (dc["finite"] and dc["relaunch"]):
                fail(f"K6 at {label} ({mode}): non-finite or not bit-equal on relaunch")
            if mode == "direct bound":
                d_st, d_pl, d_rw = k6_wide_check(args_x, kw_x, needs, dc["staged"], want, dc["row"])
                print(f"[k] K6 {label} direct bound: max rel L2 to the float64 plain replay, staged "
                      f"{max(d_st):.3e}, float32 plain {max(d_pl):.3e}, row {max(d_rw):.3e}", flush=True)
                if not all(a <= max(1e-3, 2 * p_) and a <= max(1e-5, 2 * r_)
                           for a, p_, r_ in zip(d_st, d_pl, d_rw)):
                    fail(f"K6 at {label} (direct bound): the staged design is further from the "
                         f"float64 replay than the plain version or the row design")
            elif not (max(rel) <= 1e-3 and max(dc["rel"]) <= 1e-5
                      and (mode != "paths only" or dc["equal"])):
                fail(f"K6 at {label} ({mode}) disagrees with the plain version or the row design")
        del args_x, fwd_x, cots_x
    phase_done("k")

    # (l) serving: smooth_posterior on three batches of 32 Lorenz-63 trajectories
    cfg, batch = lcfg, 32
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    l_batches = [l_obs[i * batch:(i + 1) * batch].contiguous() for i in range(3)]
    l_plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
               fused_step.stream_noise_reference, fused_step.ancestor_indices_reference,
               ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    for fn in l_plain:
        fn.calls = 0
    fused_step.scan_forward.launches = ffbsi.ffbsi_forward.launches = 0
    zero_designs(ffbsi.ffbsi_forward)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    t0 = time.perf_counter()
    paths = [pt.smooth_posterior(ssm, ys, cfg, run_gen) for ys in l_batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_serve, k5_serve = fused_step.scan_forward.launches, ffbsi.ffbsi_forward.launches
    k5_serve_designs = dict(ffbsi.ffbsi_forward.launches_by_design)
    plain_calls = sum(fn.calls for fn in l_plain)
    shapes_ok = all(tuple(p.shape) == (batch, 16, 100, 3) for p in paths)
    finite = all(bool(torch.isfinite(p).all()) for p in paths)
    sp_ms = [time_ms(lambda: pt.smooth_posterior(ssm, l_batches[0], cfg, run_gen)) for _ in range(2)]
    print(f"[l] serving {l63}: smooth_posterior x3 -> shapes {[tuple(p.shape) for p in paths]} "
          f"ok {shapes_ok}, finite {finite}, K1 launches {k1_serve}, K5 launches {k5_serve} (by "
          f"design {k5_serve_designs}), plain-version calls {plain_calls}, wall {wall:.2f} s; smooth_posterior "
          f"{sp_ms[0]:.3f}/{sp_ms[1]:.3f} ms per call of B={batch} (median of 5 after 2 warm-up)",
          flush=True)
    profile = device_breakdown(lambda: pt.smooth_posterior(ssm, l_batches[0], cfg, run_gen), 1,
                               PSVO_KERNELS)
    print(f"[l] profile of one more call: {profile}", flush=True)
    if k1_serve != 3 or k5_serve != 3 or plain_calls != 0 or k5_serve_designs != {"staged": 3, "path": 0}:
        fail(f"smooth_posterior launched K1 {k1_serve} and K5 {k5_serve} times (want 3 each, every "
             f"K5 launch the staged design: {k5_serve_designs}), plain versions {plain_calls}")
    if not (shapes_ok and finite):
        fail("smooth_posterior gave non-finite paths or the wrong shape")
    phase_done("l")

    # (m) training through make_train_step: 3 calls of steps_per_call PSVO steps
    n_per_call = cfg.train.steps_per_call
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = lds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (3, n_per_call, batch),
                         generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_psvo_gb = torch.cuda.memory_allocated() / 1e9
    l_kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
                 ffbsi.ffbsi_backward)
    for fn in l_plain:
        fn.calls = 0
    for fn in l_kernels:
        fn.launches = 0
    zero_designs(ffbsi.ffbsi_forward, ffbsi.ffbsi_backward)
    call_s, train_metrics = [], []
    for bt in train_batches:
        t0 = time.perf_counter()
        train_metrics.append(train_step(run_gen, bt))
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    psvo_launches = [fn.launches for fn in l_kernels]
    k5_train_designs = dict(ffbsi.ffbsi_forward.launches_by_design)
    k6_train_designs = dict(ffbsi.ffbsi_backward.launches_by_design)
    plain_calls = sum(fn.calls for fn in l_plain)
    peak_psvo_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m_["loss"]) for m_ in train_metrics]
    norms = [float(m_["grad_norm"]) for m_ in train_metrics]
    em = [float(m_["log_joint_smoothed"]) for m_ in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    psvo_step_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[m] training {l63}: {len(train_batches)} calls x {n_per_call} steps, B={batch}: loss "
          f"per call {[round(v, 3) for v in losses]}, grad norm {[round(v, 3) for v in norms]}, "
          f"log_joint_smoothed {[round(v, 2) for v in em]}, parameters moved {moved}; launches "
          f"K1/K4/K5/K6 {psvo_launches} (K5 by design {k5_train_designs}, K6 {k6_train_designs}), "
          f"plain-version calls {plain_calls}; call times "
          f"{[round(v, 3) for v in call_s]} s, train step {psvo_step_ms:.3f} ms (median of the calls "
          f"after the first, per step); peak device memory {peak_psvo_gb:.3f} GB, of which earlier "
          f"phases held {held_psvo_gb:.3f} GB before the run", flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               PSVO_KERNELS)
    print(f"[m] profile of one more call: {profile}", flush=True)
    want = len(train_batches) * n_per_call
    if (psvo_launches != [want] * 4 or plain_calls != 0
            or k5_train_designs != {"staged": want, "path": 0}
            or k6_train_designs != {"staged": want, "row": 0}):
        fail(f"PSVO train path launched K1/K4/K5/K6 {psvo_launches} times (want {want} each, every "
             f"K5 and K6 launch the staged design: {k5_train_designs}, {k6_train_designs}), plain "
             f"versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("PSVO training gave non-finite losses or gradient norms, or left the parameters as they were")
    phase_done("m")

    # (n) K2 at the Lorenz-96 width vs the plain Philox, both designs
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk

    l_cfg, l_batch = l96_config(small=False)
    lk = l_cfg.smc.n_particles
    seed40 = (0x2468ACE0, 0x13579BDF)
    k2l = k2_check(seed40, 3, l_batch, 40, lk, dev, "n")
    phase_done("n")

    # (o) K7 and K8 vs their plain versions, adversarial rows, small and full
    for label, kk, dd in (("small", 128, 40), ("full", lk, 40)):
        lw = weight_rows(kk, gen)
        pos = fused_step.systematic_positions(torch.rand(lw.shape[0], device=dev, generator=gen),
                                              kk).contiguous()
        idx7 = rg.ancestor_indices_large(lw, pos)
        again = rg.ancestor_indices_large(lw, pos)
        idx7_row = rg.ancestor_indices_large(lw, pos, design="row")
        idx7_r = rg.ancestor_indices_large_reference(lw, pos)
        xg = torch.randn((lw.shape[0], dd, kk), device=dev, generator=gen)
        out8 = rg.gather_particles(xg, idx7)
        out8_r = rg.gather_particles_reference(xg, idx7)
        torch.cuda.synchronize()
        k7_bad = int((idx7 != idx7_r).sum())
        k7_bad_row = int((idx7 != idx7_row).sum())
        row_bad = int((idx7_row != idx7_r).sum())
        k7_same = bool(torch.equal(idx7, again))
        k8_equal = bool(torch.equal(out8, out8_r))
        dominant = int(idx7[6].unique().numel())
        print(f"[o] K7/K8 {label} [8, {kk}], D={dd}: K7 cluster design (C = "
              f"{rg.k7_cluster(8, kk, n_sms)}) mismatches {k7_bad} against the "
              f"plain version, {k7_bad_row} against the row design (row against plain {row_bad}), "
              f"same indices on a second launch {k7_same}; K8 bit-equal {k8_equal} (the "
              f"dominant-particle row draws {dominant} distinct ancestor(s))", flush=True)
        if k7_bad or k7_bad_row or row_bad or not k7_same or not k8_equal or dominant != 1:
            fail(f"K7/K8 ({label}) disagree with their plain versions or K7's designs disagree")
    lw = torch.randn((l_batch, lk), device=dev, generator=gen) * 3
    pos = fused_step.systematic_positions(torch.rand(l_batch, device=dev, generator=gen), lk)
    pos = pos.contiguous()
    idx7 = rg.ancestor_indices_large(lw, pos)
    xg = torch.randn((l_batch, 40, lk), device=dev, generator=gen)
    idx64 = idx7.long()[:, None, :].expand(-1, 40, -1)
    k7 = [time_ms(lambda: rg.ancestor_indices_large(lw, pos), reps=20),
          time_ms(lambda: rg.ancestor_indices_large_reference(lw, pos), reps=20)]
    k8 = [time_ms(lambda: rg.gather_particles(xg, idx7), reps=20),
          time_ms(lambda: rg.gather_particles_reference(xg, idx7), reps=20),
          time_ms(lambda: torch.gather(xg, -1, idx64), reps=20)]
    k7 += [time_ms(lambda: rg.ancestor_indices_large(lw, pos), reps=20),
           time_ms(lambda: rg.ancestor_indices_large_reference(lw, pos), reps=20)]
    k8 += [time_ms(lambda: rg.gather_particles(xg, idx7), reps=20),
           time_ms(lambda: rg.gather_particles_reference(xg, idx7), reps=20)]
    # the cluster design and the previous one alternated, three pairs
    k7_pairs = [tuple(device_ms(lambda: rg.ancestor_indices_large(lw, pos, design=d))
                      for d in rg.K7_DESIGNS) for _ in range(3)]
    k7_dev = [statistics.mean(p_[0] for p_ in k7_pairs),
              device_ms(lambda: rg.ancestor_indices_large_reference(lw, pos)),
              statistics.mean(p_[1] for p_ in k7_pairs)]
    k8_dev = [device_ms(lambda: rg.gather_particles(xg, idx7)),
              device_ms(lambda: rg.gather_particles_reference(xg, idx7)),
              device_ms(lambda: torch.gather(xg, -1, idx64))]
    # K7: the CDF scan and a binary search per particle; logw and positions in,
    # int32 indices out. K8: x read once, the indices, x_res written once.
    k7_bound, k7_by = bound(2.0 * lw.numel() * (1 + math.log2(lk)), nbytes(lw, pos, idx7))
    k8_bound, k8_by = bound(0.0, 2 * nbytes(xg) + nbytes(idx7))
    print(f"[o] full [8, {lk}]: K7 {k7[0]:.4f}/{k7[2]:.4f} ms vs plain {k7[1]:.4f}/{k7[3]:.4f} ms, "
          f"bound {k7_bound:.5f} ms ({k7_by}); K8 (D=40) {k8[0]:.4f}/{k8[3]:.4f} ms vs plain "
          f"{k8[1]:.4f}/{k8[4]:.4f} ms, torch.gather on the int64 index {k8[2]:.4f} ms, bound "
          f"{k8_bound:.4f} ms ({k8_by}); kernel/plain alternated, CUDA events around one call, "
          f"median of 20. Device time per call (torch.profiler, 20 calls): K7 {k7_dev[0]:.4f} ms, "
          f"plain {k7_dev[1]:.4f} ms; K8 {k8_dev[0]:.4f} ms, plain {k8_dev[1]:.4f} ms, "
          f"torch.gather {k8_dev[2]:.4f} ms", flush=True)
    k7_c = rg.k7_cluster(l_batch, lk, n_sms)
    print(f"[o] K7 full [8, {lk}], device time per call (torch.profiler, 20 calls), (cluster, row) "
          f"alternated: " + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in k7_pairs)
          + f" ms; bound {k7_bound:.5f} ms: cluster at {100 * k7_bound / k7_dev[0]:.1f}% of it, row "
          f"at {100 * k7_bound / k7_dev[2]:.1f}%; cluster C = {k7_c} ({l_batch * k7_c} CTAs), "
          f"{kernel_resources('ancestor_indices_cluster_kernel')}, "
          f"{rg.k7_cluster_smem_bytes(lk, k7_c)} B of shared memory per CTA; row "
          f"{kernel_resources('ancestor_indices_large_kernel')}, {rg.k7_smem_bytes(lk)} B",
          flush=True)
    if not all(a < b_ for a, b_ in k7_pairs):
        fail("K7: the cluster design is not faster than the row design in every pair")
    phase_done("o")

    # (p) K9 vs its plain version on every step of one kernel run
    l_ds = pt.generate_dataset(l_cfg.data, SEED)
    l_obs = torch.cat([l_ds.obs_test, l_ds.obs_train]).to(dev)
    snapshot = os.path.join(ROOT, "checkpoints", "l96_pretrained.npz")
    k9 = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = l96_config(small)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 6), device=dev)
        if not small:
            pt.load_params_npz(ssm, snapshot)
        ys = l_obs[:batch, :cfg.data.t_steps].contiguous()
        for mode, rng_seed in (("stream", None), ("in-kernel RNG", (17, 0xBEEF))):
            with torch.no_grad():
                r = trunk_run(ssm, cfg, ys, gen, rng_seed)
            k9[(label, mode)] = r
            print(f"[p] K9 {label} B={batch} K={cfg.smc.n_particles} T={cfg.data.t_steps} "
                  f"hidden={cfg.net('q1').hidden} {mode}: every step allclose(2e-4) {r['close']}, "
                  f"max per-step rel L2 x_new {r['rel_x']:.3e} alpha {r['rel_a']:.3e}, max|d| "
                  f"{r['maxd']:.3e}, finite {r['finite']}"
                  + (f", bit-equal to stream mode on K2's eps {r['same']}" if rng_seed else "")
                  + f", every step bit-equal to the previous design (tile) {r['same_tile']}"
                  + f"; K7 index mismatches against its plain version, every step {r['k7_bad']}"
                  + f"; free runs: {r['flip_rows']} of {batch} rows with an ancestor flip (first "
                  f"flip step per row {r['first_flips']}), max rel d logZ {r['rel_z']:.3e}, over "
                  f"rows without "
                  + ("none (no row without)" if r["rel_z_clean"] is None
                     else f"{r['rel_z_clean']:.3e}"), flush=True)
            ok = (r["close"] if small else max(r["rel_x"], r["rel_a"]) <= 1e-4) \
                and (r["rel_z_clean"] is None or r["rel_z_clean"] <= 1e-4)
            if not (ok and r["finite"] and r["same"]):
                fail(f"K9 ({label}, {mode}) disagrees with trunk_forward_reference")
            if not r["same_tile"]:
                fail(f"K9's async design ({label}, {mode}) is not bit-equal to the tile design")
            if r["k7_bad"]:
                fail(f"K7 ({label}, {mode}) gave other indices than its plain version in the trunk run")
    k9_small_err = max(k9[("small", m)]["maxd"] for m in ("stream", "in-kernel RNG"))
    x_res, coef_t, l_consts, eps_t = k9[("full", "in-kernel RNG")]["last"]
    with torch.no_grad():
        k9t = [time_ms(lambda: trunk.trunk_forward(x_res, coef_t, l_consts, seed=(17, 0xBEEF), t=98),
                       reps=20),
               time_ms(lambda: trunk.trunk_forward_reference(x_res, coef_t, l_consts, eps_t), reps=20),
               time_ms(lambda: trunk.trunk_forward(x_res, coef_t, l_consts, eps=eps_t), reps=20)]
        k9t += [time_ms(lambda: trunk.trunk_forward(x_res, coef_t, l_consts, seed=(17, 0xBEEF), t=98),
                        reps=20),
                time_ms(lambda: trunk.trunk_forward_reference(x_res, coef_t, l_consts, eps_t),
                        reps=20)]
        # the async design and the previous one alternated, three pairs per noise mode
        k9_pairs = {mode: [tuple(device_ms(lambda: trunk.trunk_forward(x_res, coef_t, l_consts,
                                                                       **noise, design=d))
                                 for d in trunk.K9_DESIGNS) for _ in range(3)]
                    for mode, noise in (("RNG", {"seed": (17, 0xBEEF), "t": 98}),
                                        ("stream", {"eps": eps_t}))}
        k9_dev = [statistics.mean(p_[0] for p_ in k9_pairs["RNG"]),
                  device_ms(lambda: trunk.trunk_forward_reference(x_res, coef_t, l_consts, eps_t)),
                  statistics.mean(p_[0] for p_ in k9_pairs["stream"]),
                  statistics.mean(p_[1] for p_ in k9_pairs["RNG"])]
    n_part = x_res.shape[0] * x_res.shape[-1]
    # x_res and the step's small operands in, x_new and α out (ε drawn in the kernel)
    k9_bound, k9_by = bound(trunk_flops(l_consts) * n_part,
                            2 * nbytes(x_res) + nbytes(coef_t, l_consts["packed"],
                                                       l_consts["sconst"]) + 4 * n_part)
    k9_plan = trunk.k9_plan(40, 40, 64, 1)
    print(f"[p] K9 full (B={x_res.shape[0]}, K={x_res.shape[-1]}, hidden 64): in-kernel RNG "
          f"{k9t[0]:.4f}/{k9t[3]:.4f} ms, stream {k9t[2]:.4f} ms, plain {k9t[1]:.4f}/{k9t[4]:.4f} ms "
          f"(alternated, CUDA events around one call, median of 20); device time per call "
          f"(torch.profiler, 20 calls), (async, tile) alternated: "
          + "; ".join(f"{mode} " + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in v)
                      for mode, v in k9_pairs.items())
          + f" ms, plain {k9_dev[1]:.4f} ms; bound {k9_bound:.4f} ms ({k9_by}, "
          f"{trunk_flops(l_consts) * n_part:.3e} FLOP): async at {100 * k9_bound / k9_dev[0]:.1f}% "
          f"of it, tile at {100 * k9_bound / k9_dev[3]:.1f}% (RNG); async "
          f"{kernel_resources('trunk_forward_async_kernelILi40ELi40ELi64EE')}, (pair, prefetch) "
          f"{k9_plan}, {trunk.k9_smem_bytes(40, 40, 64, 1, *k9_plan)} B of shared memory per CTA; "
          f"tile {kernel_resources('trunk_forward_kernelILi40ELi40ELi64EE')}, "
          f"{trunk.smem_bytes(40, 40, 64, 1)} B", flush=True)
    if not all(a < b_ for v in k9_pairs.values() for a, b_ in v):
        fail("K9: the async design is not faster than the tile design in every pair")
    del x_res, eps_t
    k9.clear()
    phase_done("p")

    # (q) serving the preset with the trained snapshot through its entry points
    cfg, batch = l_cfg, l_batch
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    pt.load_params_npz(ssm, snapshot)
    ys = l_ds.obs_test[:batch].to(dev).contiguous()
    eval_step = pt.make_eval_step(ssm, cfg)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    l_kernels = (rg.ancestor_indices_large, rg.gather_particles, trunk.trunk_forward)
    l_plain = (rg.ancestor_indices_large_reference, rg.gather_particles_reference,
               trunk.trunk_forward_reference, fused_step.stream_noise_reference,
               fused_step.scan_forward_reference)
    calls = {"eval_step": lambda: eval_step(run_gen, ys),
             "filter_posterior": lambda: pt.filter_posterior(ssm, ys, cfg, run_gen),
             "filter_posterior(return_particles)": lambda: pt.filter_posterior(
                 ssm, ys, cfg, run_gen, return_particles=True)}
    torch.cuda.synchronize()
    held_l96_gb = torch.cuda.memory_allocated() / 1e9
    outs, serve_launches, serve_peak = {}, {}, {}
    k9_serve_designs, k7_serve_designs = {}, {}
    for label, fn in calls.items():
        for f in l_kernels:
            f.launches = 0
        for f in l_plain:
            f.calls = 0
        zero_designs(trunk.trunk_forward, rg.ancestor_indices_large)
        torch.cuda.reset_peak_memory_stats()
        outs[label] = fn()
        torch.cuda.synchronize()
        serve_peak[label] = torch.cuda.max_memory_allocated() / 1e9 - held_l96_gb
        serve_launches[label] = [f.launches for f in l_kernels] + [sum(f.calls for f in l_plain)]
        k9_serve_designs[label] = dict(trunk.trunk_forward.launches_by_design)
        k7_serve_designs[label] = dict(rg.ancestor_indices_large.launches_by_design)
    metrics = outs["eval_step"]
    means = outs["filter_posterior"]
    p_means, parts, lws = outs["filter_posterior(return_particles)"]
    t_steps = cfg.data.t_steps
    shapes_ok = (tuple(means.shape) == (batch, t_steps, 40)
                 and tuple(parts.shape) == (batch, t_steps, lk, 40)
                 and tuple(lws.shape) == (batch, t_steps, lk))
    finite = (math.isfinite(float(metrics["elbo"])) and bool(torch.isfinite(metrics["r2_k"]).all())
              and bool(torch.isfinite(means).all()) and bool(torch.isfinite(parts).all()))
    del outs, parts, lws, p_means
    serve_ms = {label: time_ms(fn) for label, fn in calls.items()}
    serve_ms_2 = {label: time_ms(fn) for label, fn in calls.items()}
    r2 = [round(float(v), 4) for v in metrics["r2_k"]]
    print(f"[q] serving {L96} (B={batch}, K={lk}, T={t_steps}, trained snapshot): ELBO "
          f"{float(metrics['elbo']):.3f}, mean ESS {float(metrics['ess_mean']):.3f}, R2(1..10) {r2}, "
          f"shapes ok {shapes_ok}, finite {finite}; launches K7/K8/K9 and plain-version calls per "
          f"call {serve_launches}; K9 by design {k9_serve_designs}; K7 by design "
          f"{k7_serve_designs}", flush=True)
    for label in calls:
        print(f"[q] {label}: {serve_ms[label]:.3f}/{serve_ms_2[label]:.3f} ms per call (CUDA "
              f"events, median of 5 after 2 warm-up, two rounds); peak device memory "
              f"{serve_peak[label]:.3f} GB above the {held_l96_gb:.3f} GB held before", flush=True)
    profile = device_breakdown(calls["filter_posterior"], 1, L96_KERNELS)
    print(f"[q] profile of one more filter_posterior call: {profile}", flush=True)
    want_launch = [t_steps - 1] * 3 + [0]
    if any(v != want_launch for v in serve_launches.values()):
        fail(f"serving {L96} launched K7/K8/K9 {serve_launches} (want {want_launch} per call)")
    if any(v != {"async": t_steps - 1, "tile": 0} for v in k9_serve_designs.values()):
        fail(f"serving {L96}: K9 by design {k9_serve_designs} (want every launch async)")
    if any(v != {"cluster": t_steps - 1, "row": 0} for v in k7_serve_designs.values()):
        fail(f"serving {L96}: K7 by design {k7_serve_designs} (want every launch the cluster one)")
    if not (shapes_ok and finite):
        fail(f"serving {L96} gave non-finite outputs or the wrong shapes")
    phase_done("q")

    # (r) K11 vs its float64 plain version on phase (o)'s adversarial rows
    k11 = {}
    for kk in (128, 2048, lk):
        lw = weight_rows(kk, gen)
        pos = fused_step.systematic_positions(torch.rand(lw.shape[0], device=dev, generator=gen),
                                              kk).contiguous()
        idx = rg.ancestor_indices_large(lw, pos)
        g11 = torch.randn((lw.shape[0], 40, kk), device=dev, generator=gen)
        got = rg.segment_sum_scatter(g11, idx)
        again = rg.segment_sum_scatter(g11, idx)
        row = rg.segment_sum_scatter(g11, idx, design="row")
        want = rg.segment_sum_scatter_reference(g11.double(), idx)
        torch.cuda.synchronize()
        k11[kk] = dict(rel=float((got.double() - want).norm() / want.norm()),
                       maxd=float((got.double() - want).abs().max()),
                       d_row=float((got - row).abs().max()),
                       rel_row=float((row.double() - want).norm() / want.norm()),
                       same=bool(torch.equal(got, again)),
                       orphans=bool((got[want == 0] == 0).all()),
                       dominant=int(idx[6].unique().numel()))
        r = k11[kk]
        print(f"[r] K11 segment_sum_scatter [8, 40, {kk}] on the adversarial rows: rel L2 "
              f"{r['rel']:.3e} against the float64 plain version, max|d| {r['maxd']:.3e}, "
              f"bit-equal on a second launch {r['same']}, sources with no child exactly 0 "
              f"{r['orphans']} (the dominant-particle row has {r['dominant']} ancestor); tiled "
              f"design {rg.k11_plan(kk)} (P, tiles), max|d| from the row design {r['d_row']:.3e} "
              f"(the row design's rel L2 {r['rel_row']:.3e})", flush=True)
        if not (r["rel"] <= 1e-6 and r["same"] and r["orphans"] and r["dominant"] == 1):
            fail(f"K11 (K={kk}) disagrees with segment_sum_scatter_reference")
    idx64 = idx.long()[:, None, :].expand(-1, 40, -1)
    healthy = rg.ancestor_indices_large(torch.randn((8, lk), device=dev, generator=gen) * 3,
                                        pos)
    one = torch.full((8, lk), -50.0, device=dev)
    one[torch.arange(8, device=dev), torch.randint(0, lk, (8,), device=dev, generator=gen)] = 0.0
    degenerate = rg.ancestor_indices_large(one, pos)
    # the tiled design and the previous one alternated: three pairs on the
    # adversarial rows, one each on healthy and one-ancestor rows
    k11_pairs = {rows: [tuple(device_ms(lambda: rg.segment_sum_scatter(g11, ix, design=d))
                              for d in rg.K11_DESIGNS) for _ in range(n)]
                 for rows, ix, n in (("adversarial", idx, 3), ("healthy", healthy, 1),
                                     ("one ancestor", degenerate, 1))}
    k11_dev = [statistics.mean(p_[0] for p_ in k11_pairs["adversarial"]),
               device_ms(lambda: rg.segment_sum_scatter_reference(g11, idx)),
               device_ms(lambda: torch.zeros_like(g11).scatter_add_(-1, idx64, g11)),
               k11_pairs["healthy"][0][0], k11_pairs["one ancestor"][0][0],
               statistics.mean(p_[1] for p_ in k11_pairs["adversarial"])]
    # g read once, the indices, d_x written once; one addition per element
    k11_bound, k11_by = bound(float(g11.numel()), 2 * nbytes(g11) + nbytes(idx))
    print(f"[r] K11 full [8, 40, {lk}]: device time per call (torch.profiler, 20 calls) "
          f"{k11_dev[0]:.4f} ms on the adversarial rows, {k11_dev[3]:.4f} ms on healthy rows, "
          f"{k11_dev[4]:.4f} ms with one ancestor per row; plain version {k11_dev[1]:.4f} ms, "
          f"zeros + scatter_add_ on the int64 index {k11_dev[2]:.4f} ms; bound "
          f"{k11_bound:.4f} ms ({k11_by})", flush=True)
    k11_per, k11_c = rg.k11_plan(lk)
    print(f"[r] K11 full, (tiled, row) alternated: "
          + "; ".join(f"{rows} " + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in v)
                      for rows, v in k11_pairs.items())
          + f" ms; tiled at {100 * k11_bound / k11_dev[0]:.1f}% of the bound, row at "
          f"{100 * k11_bound / k11_dev[5]:.1f}% (adversarial); tiled P = {k11_per}, {k11_c} tiles a "
          f"row ({l_batch * k11_c * -(-40 // (32 // k11_per))} CTAs), "
          f"{kernel_resources(f'segment_sum_tiled_kernelILi{k11_per}E')}, "
          f"{rg.k11_smem_bytes(k11_per)} B of shared memory per CTA; row "
          f"{kernel_resources('segment_sum_scatter_kernel')}, {4 * lk} B", flush=True)
    if not all(a < b_ for v in k11_pairs.values() for a, b_ in v):
        fail("K11: the tiled design is not faster than the row design in every pair")
    del g11, idx64
    phase_done("r")

    # (s) K10 vs its plain version on every step of one kernel run, teacher-forced
    k10 = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = l96_config(small)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 8), device=dev)
        if not small:
            pt.load_params_npz(ssm, snapshot)
        ys = l_obs[:batch, :cfg.data.t_steps].contiguous()
        tol = 1e-4 if small else 1e-3
        for mode, rng_seed in (("stream", None), ("in-kernel RNG", (19, 0xF00D))):
            with torch.no_grad():
                r = trunk_backward_run(ssm, cfg, ys, gen, rng_seed)
            k10[(label, mode)] = r
            print(f"[s] K10 {label} B={batch} K={cfg.smc.n_particles} T={cfg.data.t_steps} {mode}, "
                  f"every step: " + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}" for n, e, m in
                                              zip(("d_x_res",) + leaves[1:], r["rel"], r["maxd"]))
                  + f"; bit-equal on a second launch {r['same']}; bound rel L2 {tol:g}; cotangents "
                  f"zeroed on {r['zeroed']} of {r['n']} particle-steps with a relu tie; with every "
                  f"particle's cotangent, rel L2 " + ", ".join(f"{e:.3e}" for e in r["rel_raw"])
                  + "; against the previous design (simt), every particle, rel L2 "
                  + ", ".join(f"{e:.3e}" for e in r["rel_simt"]) + " (bound 1e-05); K7 index "
                  f"mismatches against its plain version, every step {r['k7_bad']}", flush=True)
            if not (r["finite"] and r["same"] and max(r["rel"]) <= tol):
                fail(f"K10 ({label}, {mode}) disagrees with trunk_backward_reference")
            if not max(r["rel_simt"]) <= 1e-5:
                fail(f"K10 ({label}, {mode}) is further than 1e-5 from the previous design")
            if r["k7_bad"]:
                fail(f"K7 ({label}, {mode}) gave other indices than its plain version in the trunk run")
    k10_small_err = max(max(k10[("small", m)]["maxd"]) for m in ("stream", "in-kernel RNG"))
    (bwd10, noise10, eps10, got10) = k10[("full", "in-kernel RNG")]["last"]
    bwd10s, noise10s = k10[("full", "stream")]["last"][:2]
    # the new design and the previous one alternated, three pairs per noise mode
    k10_pairs = {"in-kernel RNG": [], "stream": []}
    with torch.no_grad():
        for mode, (b_, n_) in (("in-kernel RNG", (bwd10, noise10)), ("stream", (bwd10s, noise10s))):
            for _ in range(3):
                k10_pairs[mode].append(tuple(
                    device_ms(lambda: trunk.trunk_backward(*b_, **n_, design=d))
                    for d in ("tf32x3", "simt")))
        k10_plain = device_ms(lambda: trunk.trunk_backward_reference(*bwd10[:4], eps10, *bwd10[4:]))
    k10_ms = statistics.mean(p[0] for p in k10_pairs["in-kernel RNG"])
    k10_ms_simt = statistics.mean(p[1] for p in k10_pairs["in-kernel RNG"])
    x_res, x_new = bwd10[0], bwd10[1]
    n_part = x_res.shape[0] * x_res.shape[-1]
    k10_flops = 3 * trunk_flops(bwd10[3]) * n_part
    # x_res, x_new, d x_new, d α and the small operands in; d x_res and the gradients out
    k10_bound, k10_by = bound(k10_flops, nbytes(x_res, x_new, bwd10[2], bwd10[3]["packed"],
                                                bwd10[3]["sconst"], bwd10[4], bwd10[5], *got10))
    # the split bound of the tensor-core design: the three forward units (a third of the
    # FLOP) on the fp32 cores, the six backward units in three TF32 passes on the tensor cores
    k10_split = (k10_flops / 3 / FP32_PEAK + 3 * (2 * k10_flops / 3) / TF32_PEAK) * 1e3
    log = _build.build_log()
    k10_res = {}
    for kname in ("trunk_backward_tf32x3_kernel", "trunk_backward_kernel"):
        regs = re.search(kname + r"ILi40ELi40ELi64EE.*?Used (\d+) registers", log, re.S)
        spill = re.search(kname + r"ILi40ELi40ELi64EE[^\n]*\n[^\n]*\n\s*(\d+) bytes "
                          r"stack frame, (\d+) bytes spill stores", log)
        k10_res[kname] = (regs.group(1) if regs else "?", spill.group(2) if spill else "?")
    for mode, pairs in k10_pairs.items():
        print(f"[s] K10 full (B={x_res.shape[0]}, K={x_res.shape[-1]}, hidden 64) {mode}: device "
              f"time per call (torch.profiler, 20 calls), (tf32x3, simt) alternated "
              + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in pairs) + " ms", flush=True)
    print(f"[s] K10 tf32x3 {k10_ms:.4f} ms, simt {k10_ms_simt:.4f} ms (in-kernel RNG means); plain "
          f"{k10_plain:.4f} ms; fp32 bound {k10_bound:.4f} ms ({k10_by}, {k10_flops:.3e} FLOP): "
          f"tf32x3 at {100 * k10_bound / k10_ms:.1f}% of it, simt at "
          f"{100 * k10_bound / k10_ms_simt:.1f}%; split bound {k10_split:.4f} ms (forward on fp32, "
          f"backward 3xTF32): tf32x3 at {100 * k10_split / k10_ms:.1f}%; registers, spill stores "
          f"tf32x3 {k10_res['trunk_backward_tf32x3_kernel']}, simt "
          f"{k10_res['trunk_backward_kernel']}; shared memory per CTA tf32x3 "
          f"{trunk.k10_smem_bytes(40, 40, 64, 1)} B, simt "
          f"{trunk.k10_smem_bytes(40, 40, 64, 1, 'simt')} B", flush=True)
    del bwd10, bwd10s, got10, eps10, x_res, x_new
    k10.clear()
    phase_done("s")

    # (t) training the preset from the trained snapshot through make_train_step
    cfg, batch = l_cfg, l_batch
    n_per_call = cfg.train.steps_per_call
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    pt.load_params_npz(ssm, snapshot)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = l_ds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (3, batch), generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]  # [B, T, Dy] each
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    t_kernels = (rg.ancestor_indices_large, rg.gather_particles, trunk.trunk_forward,
                 trunk.trunk_backward, rg.segment_sum_scatter)
    t_plain = l_plain + (trunk.trunk_backward_reference, rg.segment_sum_scatter_reference,
                         fused_step.scan_backward_reference)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_train_gb = torch.cuda.memory_allocated() / 1e9
    for f in t_kernels:
        f.launches = 0
    zero_designs(trunk.trunk_backward, trunk.trunk_forward, rg.ancestor_indices_large,
                 rg.segment_sum_scatter)
    for f in t_plain:
        f.calls = 0
    call_s, train_metrics = [], []
    for bt in train_batches:
        t0 = time.perf_counter()
        train_metrics.append(train_step(run_gen, bt))
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    train_launches = [f.launches for f in t_kernels]
    k10_by_design = dict(trunk.trunk_backward.launches_by_design)
    k9_by_design = dict(trunk.trunk_forward.launches_by_design)
    k7_by_design = dict(rg.ancestor_indices_large.launches_by_design)
    k11_by_design = dict(rg.segment_sum_scatter.launches_by_design)
    plain_calls = sum(f.calls for f in t_plain)
    peak_train_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m_["loss"]) for m_ in train_metrics]
    norms = [float(m_["grad_norm"]) for m_ in train_metrics]
    ess_mean = [float(m_["ess_mean"]) for m_ in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    l96_step_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[t] training {L96} from the snapshot: {len(train_batches)} calls x {n_per_call} step, "
          f"B={batch}, K={lk}: loss per call {[round(v, 3) for v in losses]}, grad norm "
          f"{[round(v, 3) for v in norms]}, mean ESS {[round(v, 3) for v in ess_mean]}, "
          f"parameters moved {moved}; launches K7/K8/K9/K10/K11 {train_launches} (K9 by design "
          f"{k9_by_design}, K10 by design {k10_by_design}, K7 by design {k7_by_design}, K11 by "
          f"design {k11_by_design}), plain-version "
          f"calls {plain_calls}; call times {[round(v, 3) for v in call_s]} s, train step "
          f"{l96_step_ms:.3f} ms (median of the calls after the first); peak device memory "
          f"{peak_train_gb - held_train_gb:.3f} GB above the {held_train_gb:.3f} GB held before",
          flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               L96_TRAIN_KERNELS)
    print(f"[t] profile of one more call: {profile}", flush=True)
    want_t = len(train_batches) * n_per_call * (cfg.data.t_steps - 1)
    if (train_launches != [want_t] * 5 or plain_calls != 0
            or k10_by_design != {"tf32x3": want_t, "simt": 0}
            or k9_by_design != {"async": want_t, "tile": 0}
            or k7_by_design != {"cluster": want_t, "row": 0}
            or k11_by_design != {"tiled": want_t, "row": 0}):
        fail(f"training {L96} launched K7/K8/K9/K10/K11 {train_launches} (want {want_t} each; "
             f"K9 by design {k9_by_design}, want all async; K10 by design {k10_by_design}, want "
             f"all tf32x3; K7 {k7_by_design}, want all cluster; K11 {k11_by_design}, want all "
             f"tiled), plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail(f"training {L96} gave non-finite losses or gradient norms, or left the parameters "
             f"as they were")
    phase_done("t")

    # (u) K1 and K4 at the SVO preset's settings: Dx=3, K=256, in-kernel draw, cache
    from psvo_tpu_torch.ops import svo

    s_cfg = pt.PRESETS[SVO]
    s_ds = pt.generate_dataset(s_cfg.data, SEED)
    s_obs = torch.cat([s_ds.obs_test, s_ds.obs_train]).to(dev)
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small, SVO)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 10), device=dev)
        ys = s_obs[:batch, :cfg.data.t_steps].contiguous()
        with torch.no_grad():
            r = check_scan(label, ssm, cfg, ys, gen, tol=2e-4, rng_seed=(31, 0xABCDEF))
            rb = check_backward(ssm, cfg, ys, gen, (37, 0x5EED), cache=True)
        tol = 1e-4 if small else 1e-3
        print(f"[u] K1 {SVO} in-kernel RNG, cache, {label} B={batch} K={cfg.smc.n_particles} "
              f"T={cfg.data.t_steps}: bit-equal to K1 on K2's streams; vs the plain replay "
              f"{scan_line(r)}", flush=True)
        print(f"[u] K4 {label} in-kernel RNG with the cache cotangents: "
              + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                          for n, e, m in zip(leaves, rb["rel"], rb["maxd"]))
              + f"; idx nondecreasing {rb['monotone']}; bound rel L2 {tol:g}", flush=True)
        if not scan_ok(r, small):
            fail(f"K1 ({SVO}, {label}) disagrees with the plain replay")
        if not (rb["monotone"] and rb["finite"] and max(rb["rel"]) <= tol):
            fail(f"K4 ({SVO}, {label}) disagrees with scan_backward_reference")
    phase_done("u")

    # (v) K12 vs its plain version, small and full
    k12, k13 = {}, {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small, SVO)
        if small:
            cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, n_smoothing_particles=8))
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 12), device=dev)
        ys = s_obs[:batch, :cfg.data.t_steps].contiguous()
        with torch.no_grad():
            consts, ops = svo_operands(ssm, cfg, ys, gen)
            r = svo_forward_check(consts, ops)
        k12[label] = (consts, ops, r)
        print(f"[v] K12 {label} B={batch} M={ops[0].shape[1]} T={cfg.data.t_steps} hidden="
              f"{cfg.net('qb').hidden}: allclose(2e-4) {r['close']}, max|d| {r['max_abs_err']:.3e}; "
              f"max |d|/(1+|x|): x~ {r['rel_x']:.3e}, lp {r['rel_lp']:.3e}, lq {r['rel_lq']:.3e}; "
              f"teacher-forced x~ {r['tf_x']:.3e}; finite {r['finite']}; bit-equal to the previous "
              f"design (chain) in x_first, lp, lq and x~ {r['same_prev']}", flush=True)
        ok = r["close"] if small else (r["tf_x"] <= 1e-5 and r["rel_x"] <= 1e-4
                                       and max(r["rel_lp"], r["rel_lq"]) <= 1e-4)
        if not (ok and r["finite"]):
            fail(f"K12 ({label}) disagrees with svo_sweep_forward_reference")
        if not r["same_prev"]:
            fail(f"K12's split design ({label}) is not bit-equal to the chain design")
    consts, ops, r = k12["full"]
    with torch.no_grad():
        # the split design and the previous one alternated, three pairs
        k12_pairs = [tuple(device_ms(lambda: svo.svo_sweep_forward(*ops, consts, design=d))
                           for d in svo.K12_DESIGNS) for _ in range(3)]
        k12_dev = [statistics.mean(p_[0] for p_ in k12_pairs),
                   device_ms(lambda: svo.svo_sweep_forward_reference(*ops, consts), n=3),
                   statistics.mean(p_[1] for p_ in k12_pairs)]
    t1_s, b_s, m_s = ops[1].shape[:3]
    k12_flops = svo_flops(consts, t1_s * b_s * m_s)
    k12_bound, k12_by = bound(k12_flops, nbytes(*ops, consts["packed"], consts["sc"], *r["kern"]))
    k12_plan = svo.k12_plan(3, 3, 64, 1, b_s * m_s, n_sms, t1_s)
    print(f"[v] K12 full (B={b_s}, M={m_s}, T-1={t1_s}, hidden 64): device time per call "
          f"(torch.profiler, 20 calls), (split, chain) alternated: "
          + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in k12_pairs)
          + f" ms; plain {k12_dev[1]:.3f} ms (3 calls); bound {k12_bound:.4f} ms ({k12_by}, "
          f"{k12_flops:.3e} FLOP): split at {100 * k12_bound / k12_dev[0]:.1f}% of it, chain at "
          f"{100 * k12_bound / k12_dev[2]:.1f}%; split "
          f"{kernel_resources('svo_forward_split_kernelILi3ELi3ELi64EE')}, (paths, tile rows, "
          f"steps a chunk) {k12_plan}, {svo.k12_smem_bytes(3, 3, 64, 1, *k12_plan)} B of shared "
          f"memory per CTA; chain {kernel_resources('svo_forward_kernelILi3ELi3ELi64EE')}",
          flush=True)
    if not all(a < b_ for a, b_ in k12_pairs):
        fail("K12: the split design is not faster than the chain design in every pair")
    phase_done("v")

    # (w) K13 vs its plain version on K12's saved x~, small and full
    for label in ("small", "full"):
        consts, ops, r = k12[label]
        with torch.no_grad():
            rb = svo_backward_check(consts, ops, r["kern"][3], gen)
        k13[label] = rb
        tol = 1e-4 if label == "small" else 1e-3
        print(f"[w] K13 {label}: " + ", ".join(
                  f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                  for n, e, m in zip(("d_x_anchor", "d_weights", "d_sc"), rb["rel"], rb["maxd"]))
              + f"; bit-equal on a second launch {rb['same']}; bound rel L2 {tol:g}; cotangents "
              f"zeroed on {rb['zeroed']} of {rb['n']} paths with a relu tie; with every path's "
              f"cotangents, rel L2 " + ", ".join(f"{e:.3e}" for e in rb["rel_raw"])
              + "; against the previous design (chain) " + ", ".join(f"{e:.3e}" for e in rb["rel_prev"])
              + " (bound 1e-05)", flush=True)
        if not (rb["finite"] and rb["same"] and max(rb["rel"]) <= tol):
            fail(f"K13 ({label}) disagrees with svo_sweep_backward_reference")
        if not max(rb["rel_prev"]) <= 1e-5:
            fail(f"K13 ({label}) is further than 1e-5 from the previous design")
    args13 = k13["full"]["args"]
    with torch.no_grad():
        # the split design and the previous one alternated, three pairs
        k13_pairs = [tuple(device_ms(lambda: svo.svo_sweep_backward(*args13, design=d))
                           for d in ("split", "chain")) for _ in range(3)]
        k13_dev = [statistics.mean(p_[0] for p_ in k13_pairs),
                   device_ms(lambda: svo.svo_sweep_backward_reference(*args13), n=3),
                   statistics.mean(p_[1] for p_ in k13_pairs)]
    k13_flops = 3 * k12_flops
    k13_bound, k13_by = bound(k13_flops, nbytes(*args13[:3], args13[3]["packed"], args13[3]["sc"],
                                                *args13[4:], *k13["full"]["got"]))
    n_w13 = args13[3]["packed"].numel()
    rows13 = svo.k13_tile_rows(3, 3, 64, 1, n_w13)
    p13 = svo.k13_paths(b_s * m_s, n_sms, rows13)
    print(f"[w] K13 full: device time per call (torch.profiler, 20 calls), (split, chain) "
          f"alternated: " + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in k13_pairs)
          + f" ms; plain {k13_dev[1]:.3f} ms (3 calls); bound {k13_bound:.4f} ms ({k13_by}, "
          f"{k13_flops:.3e} FLOP): split at {100 * k13_bound / k13_dev[0]:.1f}% of it, chain at "
          f"{100 * k13_bound / k13_dev[2]:.1f}%; split {kernel_resources('svo_backward_split_kernelILi3ELi3ELi64EE')}, "
          f"{svo.k13_smem_bytes(3, 3, 64, 1, n_w13)} B of shared memory per CTA, tiles of "
          f"{rows13} rows, {p13} paths a group ({-(-b_s * m_s // p13)} groups); chain "
          f"{kernel_resources('svo_backward_kernelILi3ELi3ELi64EE')}, "
          f"{svo.k13_smem_bytes(3, 3, 64, 1, n_w13, 'chain')} B", flush=True)
    if not all(a < b_ for a, b_ in k13_pairs):
        fail("K13: the split design is not faster than the previous one in every pair")
    k12_small_err = k12["small"][2]["max_abs_err"]
    k13_small_err = max(k13["small"]["maxd"])
    del k12, k13, args13
    phase_done("w")

    # (x) serving: smooth_posterior(method="svo") on three batches of 32
    cfg, batch = s_cfg, 32
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    s_batches = [s_obs[i * batch:(i + 1) * batch].contiguous() for i in range(3)]
    s_plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
               fused_step.stream_noise_reference, svo.svo_sweep_forward_reference,
               svo.svo_sweep_backward_reference)
    s_kernels = (fused_step.scan_forward, fused_step.scan_backward, svo.svo_sweep_forward,
                 svo.svo_sweep_backward)
    for fn in s_plain:
        fn.calls = 0
    for fn in s_kernels:
        fn.launches = 0
    zero_designs(svo.svo_sweep_backward, svo.svo_sweep_forward)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    torch.cuda.synchronize()
    held_svo_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paths = [pt.smooth_posterior(ssm, ys, cfg, run_gen, method="svo") for ys in s_batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_svo_gb = torch.cuda.max_memory_allocated() / 1e9 - held_svo_gb
    svo_serve = [fn.launches for fn in s_kernels]
    k13_serve_designs = dict(svo.svo_sweep_backward.launches_by_design)
    k12_serve_designs = dict(svo.svo_sweep_forward.launches_by_design)
    plain_calls = sum(fn.calls for fn in s_plain)
    shapes_ok = all(tuple(p.shape) == (batch, 16, 100, 3) for p in paths)
    finite = all(bool(torch.isfinite(p).all()) for p in paths)
    svo_sp_ms = [time_ms(lambda: pt.smooth_posterior(ssm, s_batches[0], cfg, run_gen, method="svo"))
                 for _ in range(2)]
    print(f"[x] serving {SVO}: smooth_posterior(method='svo') x3 -> shapes "
          f"{[tuple(p.shape) for p in paths]} ok {shapes_ok}, finite {finite}; launches "
          f"K1/K4/K12/K13 {svo_serve} (K12 by design {k12_serve_designs}), plain-version calls "
          f"{plain_calls}, wall {wall:.2f} s; "
          f"{svo_sp_ms[0]:.3f}/{svo_sp_ms[1]:.3f} ms per call of B={batch} (median of 5 after 2 "
          f"warm-up); peak device memory {serve_svo_gb:.3f} GB above the {held_svo_gb:.3f} GB "
          f"held before", flush=True)
    profile = device_breakdown(
        lambda: pt.smooth_posterior(ssm, s_batches[0], cfg, run_gen, method="svo"), 1, SVO_KERNELS)
    print(f"[x] profile of one more call: {profile}", flush=True)
    if (svo_serve != [3, 0, 3, 0] or plain_calls != 0
            or k13_serve_designs != {"split": 0, "chain": 0}
            or k12_serve_designs != {"split": 3, "chain": 0}):
        fail(f"smooth_posterior(method='svo') launched K1/K4/K12/K13 {svo_serve} (want "
             f"[3, 0, 3, 0]; K12 by design {k12_serve_designs}, want all split; K13 by design "
             f"{k13_serve_designs}), plain versions {plain_calls}")
    if not (shapes_ok and finite):
        fail("smooth_posterior(method='svo') gave non-finite paths or the wrong shape")
    del paths
    phase_done("x")

    # (y) training through make_train_step: 3 calls of steps_per_call SVO steps
    n_per_call = cfg.train.steps_per_call
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = s_ds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (3, n_per_call, batch),
                         generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_svo_gb = torch.cuda.memory_allocated() / 1e9
    for fn in s_plain:
        fn.calls = 0
    for fn in s_kernels:
        fn.launches = 0
    zero_designs(svo.svo_sweep_backward, svo.svo_sweep_forward)
    call_s, train_metrics = [], []
    for bt in train_batches:
        t0 = time.perf_counter()
        train_metrics.append(train_step(run_gen, bt))
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    svo_launches = [fn.launches for fn in s_kernels]
    k13_train_designs = dict(svo.svo_sweep_backward.launches_by_design)
    k12_train_designs = dict(svo.svo_sweep_forward.launches_by_design)
    plain_calls = sum(fn.calls for fn in s_plain)
    peak_svo_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m_["loss"]) for m_ in train_metrics]
    norms = [float(m_["grad_norm"]) for m_ in train_metrics]
    elbos = [float(m_["elbo_svo"]) for m_ in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    svo_step_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[y] training {SVO}: {len(train_batches)} calls x {n_per_call} steps, B={batch}: loss "
          f"per call {[round(v, 3) for v in losses]}, elbo_svo {[round(v, 3) for v in elbos]}, "
          f"grad norm {[round(v, 3) for v in norms]}, parameters moved {moved}; launches "
          f"K1/K4/K12/K13 {svo_launches} (K12 by design {k12_train_designs}, K13 by design "
          f"{k13_train_designs}), plain-version calls "
          f"{plain_calls}; call times "
          f"{[round(v, 3) for v in call_s]} s, train step {svo_step_ms:.3f} ms (median of the calls "
          f"after the first, per step); peak device memory {peak_svo_gb - held_svo_gb:.3f} GB "
          f"above the {held_svo_gb:.3f} GB held before", flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               SVO_KERNELS)
    print(f"[y] profile of one more call: {profile}", flush=True)
    want = len(train_batches) * n_per_call
    if (svo_launches != [want] * 4 or plain_calls != 0
            or k13_train_designs != {"split": want, "chain": 0}
            or k12_train_designs != {"split": want, "chain": 0}):
        fail(f"SVO train path launched K1/K4/K12/K13 {svo_launches} times (want {want} each, every "
             f"K12 and K13 launch the split design: {k12_train_designs}, {k13_train_designs}), "
             f"plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms + elbos) and moved):
        fail("SVO training gave non-finite losses, ELBOs or gradient norms, or left the "
             "parameters as they were")
    phase_done("y")

    # (z) K14 against its plain version, every step teacher-forced, and its chain against K1
    from psvo_tpu_torch import smc as tsmc
    from psvo_tpu_torch.ops.resampling import gather_particles

    fhn = "fhn_fivo_k1024_bench"
    l63_obs = torch.cat([lds.obs_test, lds.obs_train]).to(dev)  # l_obs holds Lorenz-96's now
    step_runs = {}
    for preset, obs_all, dy in ((fhn, None, 2), (l63, l63_obs, 3)):
        for label, small in (("small", True), ("full", False)):
            cfg, batch = slice_config(small, preset)
            ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 14), device=dev)
            if obs_all is None:
                ys = torch.randn((batch, cfg.data.t_steps, dy), device=dev, generator=gen)
            else:
                ys = obs_all[:batch, :cfg.data.t_steps].contiguous()
            with torch.no_grad():
                r = step_chain_check(ssm, cfg, ys, gen)
            step_runs[(preset, label)] = r
            print(f"[z] K14 {preset} {label} B={batch} K={cfg.smc.n_particles} T={cfg.data.t_steps} "
                  f"hidden={cfg.net('q1').hidden}: every step from the kernel's own state: "
                  f"{r['idx_bad']} indices differ; max per-step rel L2 / max |d|/(1+|w|) "
                  + ", ".join(f"{n} {e:.3e} / {m:.3e}" for n, e, m in
                              zip(STEP_OUTPUTS, r["tf_l2"], r["tf_rel"]))
                  + f" (max|d| {r['tf_abs']:.3e}); chain of {cfg.data.t_steps - 1} "
                  f"launches vs one K1 launch on the same streams: {r['k1_idx']} indices differ, "
                  f"max|d| x {r['vs_k1'][0]:.3e} alpha {r['vs_k1'][1]:.3e} stats "
                  f"{r['vs_k1'][2]:.3e}; finite {r['finite']}; K14 on "
                  f"S={fused_step.step_forward.last_slices} CTAs per row", flush=True)
            if not (r["finite"] and r["idx_bad"] == 0 and max(r["tf_l2"]) <= 1e-4
                    and r["k1_idx"] == 0):
                fail(f"K14 ({preset}, {label}) disagrees with step_forward_reference or with K1")
    k14_small_err = max(step_runs[(p, "small")]["tf_abs"] for p in (fhn, l63))
    slice_inputs = {}  # phase ae's operands: step t_mid of each full chain, and its residuals
    for preset in (fhn, l63):
        rf = step_runs[(preset, "full")]
        tm = rf["inp"]["coef"].shape[0] // 2
        x_all, alpha_all, stats_all, idx_all = (c.clone() for c in rf["chain"])
        slice_inputs[preset] = (
            (x_all[tm - 1], alpha_all[tm - 1], rf["inp"]["coef"][tm], rf["inp"]["consts"],
             rf["inp"]["eps"][tm], rf["inp"]["positions"][tm]),
            (x_all[tm - 1], x_all[tm], idx_all[tm], stats_all[tm], rf["inp"]["coef"][tm],
             rf["inp"]["eps"][tm]))
    full = step_runs[(fhn, "full")]
    inp = full["inp"]
    t_mid = inp["coef"].shape[0] // 2
    x_mid = full["chain"][0][t_mid - 1].contiguous()
    a_mid = full["chain"][1][t_mid - 1].contiguous()
    k14_args = (x_mid, a_mid, inp["coef"][t_mid], inp["consts"], inp["eps"][t_mid],
                inp["positions"][t_mid])
    with torch.no_grad():
        k14_dev = [device_ms(lambda: fused_step.step_forward(*k14_args)),
                   device_ms(lambda: fused_step.step_forward_reference(*k14_args), n=5),
                   device_ms(lambda: fused_step.step_forward(*k14_args))]
        k14_out = fused_step.step_forward(*k14_args)
    k14_regs = re.search(r"step_forward_kernelILi2ELi2ELi64EE.*?Used (\d+) registers",
                         _build.build_log(), re.S)
    print(f"[z] K14 full ({fhn}, B=32, K=1024, hidden 64, step {t_mid}): device time per launch "
          f"(torch.profiler) {k14_dev[0]:.4f}/{k14_dev[2]:.4f} ms (20 launches each), plain "
          f"{k14_dev[1]:.4f} ms (5 calls); registers {k14_regs.group(1) if k14_regs else '?'}",
          flush=True)
    phase_done("z")

    # (aa) K15 against its plain version on K14's residuals; the chain against K4; K=2048
    k15 = {}
    for key, r in step_runs.items():
        with torch.no_grad():
            rb = step_backward_check(r, gen)
        k15[key] = rb
        tol = 1e-4 if key[1] == "small" else 1e-3
        print(f"[aa] K15 {key[0]} {key[1]}, every step: " + ", ".join(
                  f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                  for n, e, m in zip(("d_x",) + leaves[1:], rb["rel"], rb["maxd"]))
              + f"; bit-equal on a second launch {rb['same']}; bound rel L2 {tol:g}; cotangents "
              f"zeroed on {rb['zeroed']} of {rb['n']} particle-steps with a relu tie; with every "
              f"particle's, rel L2 " + ", ".join(f"{e:.3e}" for e in rb["rel_raw"])
              + "; the chain vs one K4 launch, rel L2 " + ", ".join(f"{e:.3e}" for e in rb["vs_k4"])
              + f" (d_x0, d_coef, summed d_weights, d_sconst); K15 on "
              f"S={fused_step.step_backward.last_slices} CTAs per row", flush=True)
        if not (rb["finite"] and rb["same"] and max(rb["rel"]) <= tol and max(rb["vs_k4"]) <= 1e-4):
            fail(f"K15 ({key[0]}, {key[1]}) disagrees with step_backward_reference or with K4")
        if key[1] == "small":
            del rb["last"]
    k15_small_err = max(max(k15[(p, "small")]["maxd"]) for p in (fhn, l63))
    k15_args = k15[(fhn, "full")]["last"]
    (k14_bound, k14_by), (k15_bound, k15_by) = step_bounds(inp["consts"], k14_args[:3] + k14_args[4:],
                                                           k14_out, k15_args)
    args15, d_xn15, d_al15, _ = k15_args
    plain15 = (args15[0], args15[4], args15[5], args15[6], args15[2], args15[7], d_xn15, d_al15)
    with torch.no_grad():
        k15_dev = [device_ms(lambda: fused_step.step_backward(*args15, d_xn15, d_al15)),
                   device_ms(lambda: fused_step.step_backward_reference(*plain15), n=5),
                   device_ms(lambda: fused_step.step_backward(*args15, d_xn15, d_al15))]
    # K15 at Dx=3, K=2048: one step of K14 at that width, then K15 against its plain version
    wcfg, wbatch = slice_config(False, l63)
    wcfg = dataclasses.replace(wcfg, smc=dataclasses.replace(wcfg.smc, n_particles=2048))
    wssm = pt.init_ssm(wcfg, torch.Generator().manual_seed(SEED + 15), device=dev)
    with torch.no_grad():
        winp = kernel_inputs(wssm, wcfg, l63_obs[:wbatch].contiguous(), gen)
        wc = winp["consts"]
        x_new, alpha, stats, idx = fused_step.step_forward(winp["x0"], winp["alpha0"], winp["coef"][0],
                                                           wc, winp["eps"][0], winp["positions"][0])
        w_keep = ~relu_ties(wc, gather_particles(winp["x0"], idx), x_new)
        w_cots = (torch.randn(stats.shape, generator=gen, device=dev),
                  torch.randn(x_new.shape, generator=gen, device=dev) * w_keep[:, None],
                  torch.randn(alpha.shape, generator=gen, device=dev) * w_keep)
        w_args = (winp["x0"], x_new, idx, stats, winp["coef"][0], wc, winp["eps"][0], *w_cots)
        w_got = fused_step.step_backward(*w_args)
        w_want = fused_step.step_backward_reference(winp["x0"], winp["coef"][0], wc, winp["eps"][0],
                                                    idx, *w_cots)
        w_rel = [float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in zip(w_got, w_want)]
        w_dev = device_ms(lambda: fused_step.step_backward(*w_args))
    k15_regs = re.findall(r"step_backward_kernelILi(\d)ELi\dELi64EE.*?Used (\d+) registers",
                          _build.build_log(), re.S)
    print(f"[aa] K15 at Dx=3, K=2048, B={wbatch}, hidden 64 (K4 runs to K="
          f"{max(kk for kk in range(256, 4097, 256) if fused_step._k4_ok(wc, kk))} there, K15 to "
          f"{max(kk for kk in range(256, 4097, 256) if fused_step._k15_ok(wc, kk))}), cotangents "
          f"zeroed on {int((~w_keep).sum())} of {w_keep.numel()} particles with a relu tie: rel L2 "
          + ", ".join(f"{e:.3e}" for e in w_rel) + f"; device time {w_dev:.4f} ms; shared memory "
          f"{fused_step.k15_smem_bytes(wc)} B at any K", flush=True)
    print(f"[aa] K15 full ({fhn}, B=32, K=1024, hidden 64): device time per launch (torch.profiler) "
          f"{k15_dev[0]:.4f}/{k15_dev[2]:.4f} ms (20 launches each, with sum_rows_kernel), plain "
          f"{k15_dev[1]:.4f} ms (5 calls); bound {k15_bound:.4f} ms ({k15_by}); K14 bound "
          f"{k14_bound:.4f} ms ({k14_by}); registers at hidden 64 (Dx, regs) {k15_regs}", flush=True)
    if max(w_rel) > 1e-3:
        fail("K15 at Dx=3, K=2048 disagrees with step_backward_reference")
    del step_runs, k15, k15_args, args15, plain15, w_args, w_got, w_want, winp
    phase_done("aa")

    # (ab) fhn_fivo_k1024_bench with the toggle off: serving and training through K14/K15
    step_plain = (fused_step.step_forward_reference, fused_step.step_backward_reference,
                  fused_step.scan_forward_reference, fused_step.scan_backward_reference,
                  fused_step.stream_noise_reference, fused_step.ancestor_indices_reference)
    step_kernels = (fused_step.step_forward, fused_step.step_backward, fused_step.scan_forward,
                    fused_step.scan_backward)

    def counted(fn):
        for f in step_plain:
            f.calls = 0
        for f in step_kernels:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, [f.launches for f in step_kernels], sum(f.calls for f in step_plain)

    fused_step.SCAN_FUSED = False
    cfg, batch = slice_config(small=False)
    t1 = cfg.data.t_steps - 1
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    eval_step = pt.make_eval_step(ssm, cfg)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    metrics, ev_launch, ev_plain = counted(lambda: [eval_step(run_gen, ys) for ys in batches])
    ev_step_ms = [time_ms(lambda: eval_step(run_gen, batches[0])) for _ in range(2)]
    ev_profile = device_breakdown(lambda: eval_step(run_gen, batches[0]), 1, STEP_KERNELS)
    elbos = [float(m_["elbo"]) for m_ in metrics]
    print(f"[ab] serving {fhn}, per-step path: ELBO per batch {[round(e, 3) for e in elbos]}; "
          f"launches K14/K15/K1/K4 {ev_launch} for {len(batches)} eval calls, plain-version calls "
          f"{ev_plain}; eval_step {ev_step_ms[0]:.3f}/{ev_step_ms[1]:.3f} ms per call of B={batch} "
          f"(median of 5 after 2 warm-up, two rounds)", flush=True)
    print(f"[ab] profile of one more eval_step call: {ev_profile}", flush=True)
    if ev_launch != [len(batches) * t1, 0, 0, 0] or ev_plain or not all(map(math.isfinite, elbos)):
        fail(f"per-step serving launched K14/K15/K1/K4 {ev_launch}, plain versions {ev_plain}")

    n_per_call = cfg.train.steps_per_call
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = ds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (3, n_per_call, batch),
                         generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_step_gb = torch.cuda.memory_allocated() / 1e9
    call_s = []

    def train_calls():
        out = []
        for bt in train_batches:
            t0 = time.perf_counter()
            out.append(train_step(run_gen, bt))
            torch.cuda.synchronize()
            call_s.append(time.perf_counter() - t0)
        return out

    train_metrics, step_train, plain_calls = counted(train_calls)
    peak_step_gb = torch.cuda.max_memory_allocated() / 1e9 - held_step_gb
    losses = [float(m_["loss"]) for m_ in train_metrics]
    norms = [float(m_["grad_norm"]) for m_ in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    step_fhn_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[ab] training {fhn}, per-step path: {len(train_batches)} calls x {n_per_call} steps, "
          f"B={batch}: loss per call {[round(v, 3) for v in losses]}, grad norm "
          f"{[round(v, 3) for v in norms]}, parameters moved {moved}; launches K14/K15/K1/K4 "
          f"{step_train}, plain-version calls {plain_calls}; call times "
          f"{[round(v, 3) for v in call_s]} s, train step {step_fhn_ms:.3f} ms (median of the calls "
          f"after the first, per step); peak device memory {peak_step_gb:.3f} GB above the "
          f"{held_step_gb:.3f} GB held before", flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               STEP_KERNELS)
    print(f"[ab] profile of one more call: {profile}; K14 on S={fused_step.step_forward.last_slices}"
          f", K15 on S={fused_step.step_backward.last_slices} CTAs per row", flush=True)
    fhn_train_batch = train_batches[0]
    want = len(train_batches) * n_per_call * t1
    if step_train != [want, want, 0, 0] or plain_calls != 0:
        fail(f"per-step training launched K14/K15/K1/K4 {step_train} (want [{want}, {want}, 0, 0]), "
             f"plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("per-step training gave non-finite losses or gradient norms, or left the parameters "
             "as they were")
    # one step's loss and gradients with the toggle off and on, same streams and weights
    ab_ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 16), device=dev)
    ab_ys = train_batches[0][0]
    streams = tsmc._draw_noise(torch.Generator(device=dev).manual_seed(SEED + 17), cfg.smc,
                                 cfg.data.t_steps, batch, 2)
    ab = {}
    for scan_fused in (True, False):
        fused_step.SCAN_FUSED = scan_fused
        for p in ab_ssm.parameters():
            p.grad = None
        fwd = tsmc._forward_filter_fused(ab_ssm, None, ab_ys, cfg.smc, cache=False,
                                           streams=streams)
        loss = -torch.mean(fwd.log_z)
        loss.backward()
        ab[scan_fused] = (float(loss), [p.grad.clone() for p in ab_ssm.parameters()
                                        if p.grad is not None])
    ab_rel = [float((a - b_).norm() / b_.norm().clamp_min(1e-30))
              for a, b_ in zip(ab[False][1], ab[True][1])]
    print(f"[ab] one step on the same streams and weights: loss per-step {ab[False][0]:.6f}, whole "
          f"scan {ab[True][0]:.6f}; per-leaf gradient rel L2 max {max(ab_rel):.3e} over "
          f"{len(ab_rel)} leaves", flush=True)
    if abs(ab[False][0] - ab[True][0]) > 1e-6 * abs(ab[True][0]) or max(ab_rel) > 1e-4:
        fail("the per-step path's loss or gradients differ from the whole-scan path's")
    del ab, ab_ssm
    phase_done("ab")

    # (ac) lorenz63_psvo_k1024 with the toggle off: smooth_posterior and PSVO training
    fused_step.SCAN_FUSED = False
    step_kernels += (ffbsi.ffbsi_forward, ffbsi.ffbsi_backward)
    step_plain += (ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    cfg, batch = lcfg, 32
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_l_gb = torch.cuda.memory_allocated() / 1e9
    zero_designs(ffbsi.ffbsi_forward)
    paths, sp_launch, sp_plain = counted(
        lambda: [pt.smooth_posterior(ssm, ys, cfg, run_gen) for ys in l_batches])
    sp_designs = dict(ffbsi.ffbsi_forward.launches_by_design)
    sp_peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_l_gb
    shapes_ok = all(tuple(p.shape) == (batch, 16, 100, 3) for p in paths)
    finite = all(bool(torch.isfinite(p).all()) for p in paths)
    del paths
    sp_step_ms = [time_ms(lambda: pt.smooth_posterior(ssm, l_batches[0], cfg, run_gen))
                  for _ in range(2)]
    sp_profile = device_breakdown(lambda: pt.smooth_posterior(ssm, l_batches[0], cfg, run_gen), 1,
                                  STEP_PSVO_KERNELS)
    print(f"[ac] serving {l63}, per-step path: smooth_posterior x{len(l_batches)} shapes ok "
          f"{shapes_ok}, finite {finite}; launches K14/K15/K1/K4/K5/K6 {sp_launch} (K5 by design "
          f"{sp_designs}), plain-version calls {sp_plain}; {sp_step_ms[0]:.3f}/{sp_step_ms[1]:.3f} "
          f"ms per call of B={batch} "
          f"(median of 5 after 2 warm-up, two rounds); peak device memory {sp_peak_gb:.3f} GB above "
          f"the {held_l_gb:.3f} GB held before", flush=True)
    print(f"[ac] profile of one more call: {sp_profile}", flush=True)
    n_calls = len(l_batches)
    if (sp_launch != [n_calls * t1, 0, 0, 0, n_calls, 0] or sp_plain or not (shapes_ok and finite)
            or sp_designs != {"staged": n_calls, "path": 0}):
        fail(f"per-step smooth_posterior launched K14/K15/K1/K4/K5/K6 {sp_launch} (K5 by design "
             f"{sp_designs}), plain versions {sp_plain}, shapes ok {shapes_ok}, finite {finite}")

    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = lds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (3, n_per_call, batch),
                         generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_l_gb = torch.cuda.memory_allocated() / 1e9
    call_s = []
    zero_designs(ffbsi.ffbsi_forward, ffbsi.ffbsi_backward)
    train_metrics, l_train, plain_calls = counted(train_calls)
    l_train_designs = dict(ffbsi.ffbsi_forward.launches_by_design)
    l_train_k6 = dict(ffbsi.ffbsi_backward.launches_by_design)
    peak_l_gb = torch.cuda.max_memory_allocated() / 1e9 - held_l_gb
    losses = [float(m_["loss"]) for m_ in train_metrics]
    norms = [float(m_["grad_norm"]) for m_ in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    step_l63_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[ac] training {l63}, per-step path: {len(train_batches)} calls x {n_per_call} steps, "
          f"B={batch}: loss per call {[round(v, 3) for v in losses]}, grad norm "
          f"{[round(v, 3) for v in norms]}, parameters moved {moved}; launches K14/K15/K1/K4/K5/K6 "
          f"{l_train} (K5 by design {l_train_designs}, K6 {l_train_k6}), plain-version calls "
          f"{plain_calls}; call "
          f"times {[round(v, 3) for v in call_s]} "
          f"s, train step {step_l63_ms:.3f} ms (median of the calls after the first, per step); "
          f"peak device memory {peak_l_gb:.3f} GB above the {held_l_gb:.3f} GB held before",
          flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               STEP_PSVO_KERNELS)
    print(f"[ac] profile of one more call: {profile}", flush=True)
    n_steps = len(train_batches) * n_per_call
    if (l_train != [n_steps * t1, n_steps * t1, 0, 0, n_steps, n_steps] or plain_calls != 0
            or l_train_designs != {"staged": n_steps, "path": 0}
            or l_train_k6 != {"staged": n_steps, "row": 0}):
        fail(f"per-step PSVO training launched K14/K15/K1/K4/K5/K6 {l_train} (K5 by design "
             f"{l_train_designs}, K6 {l_train_k6}), plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("per-step PSVO training gave non-finite losses or gradient norms, or left the "
             "parameters as they were")
    fused_step.SCAN_FUSED = True
    phase_done("ac")

    # (ad) K1 and K4 by cluster size, at the FHN and Lorenz-63 shapes
    sweeps_c = {}
    for preset, ys, rng_seed, cache in ((fhn, batches[0], (21, 0xBEEF), False),
                                        (l63, l_batches[0], None, True)):
        cfg, batch = slice_config(False, preset)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 19), device=dev)
        with torch.no_grad():
            sw = cluster_sweep(ssm, cfg, ys, gen, rng_seed, cache)
        sweeps_c[preset] = sw
        for kern, name_k, ok_key in ((0, "K1", "equal"), (1, "K4", "dx0_equal")):
            print(f"[ad] {name_k} {preset} B={batch} K={cfg.smc.n_particles} "
                  f"({'in-kernel draw' if rng_seed else 'stream'}{', cache' if cache else ''}): "
                  f"max_active {sw['max_active'][kern]}, chosen C={sw['chosen'][kern]} "
                  f"({batch * sw['chosen'][kern]} CTAs); times by C (ms, median of 5 after 2 "
                  f"warm-up, in the order 1, chosen, others, chosen, 1) "
                  + ", ".join(f"C={c}: " + "/".join(f"{v:.3f}" for v in ts)
                              for c, ts in sw["ms"][kern].items()), flush=True)
        for c, r in sw["k1"].items():
            print(f"[ad] K1 {preset} C={c}: every output (x_last, alpha_last, stats, x_all, "
                  f"alpha_all, idx; 99 free-running steps) bit-equal to C=1 {r['equal']}, "
                  f"bit-equal on a relaunch {r['same']}", flush=True)
        for c, r in sw["k4"].items():
            print(f"[ad] K4 {preset} C={c}: d_x0 bit-equal to C=1 {r['dx0_equal']}, rel L2 to C=1 "
                  + ", ".join(f"{n} {e:.3e}" for n, e in zip(leaves[1:], r["rel"]))
                  + f", bit-equal on a relaunch {r['same']}", flush=True)
        if not all(r["equal"] and r["same"] for r in sw["k1"].values()):
            fail(f"K1 on clusters ({preset}) is not bit-equal to one CTA per row")
        if not all(r["dx0_equal"] and r["same"] and max(r["rel"]) <= 1e-6 for r in sw["k4"].values()):
            fail(f"K4 on clusters ({preset}) disagrees with one CTA per row")
        if min(sw["chosen"]) < 2:
            fail(f"{preset}: K1/K4 chose C={sw['chosen']} at B={batch}, K={cfg.smc.n_particles}")
    fhn_c = sweeps_c[fhn]
    k1_c, k4_c = fhn_c["chosen"]
    k1_ms, k1_ms_c1 = (statistics.mean(fhn_c["ms"][0][c]) for c in (k1_c, 1))
    k4_ms, k4_ms_c1 = (statistics.mean(fhn_c["ms"][1][c]) for c in (k4_c, 1))
    print(f"[ad] {fhn}: K1 at C={k1_c} {k1_ms:.3f} ms vs C=1 {k1_ms_c1:.3f} ms, bound {k1_bound:.3f} "
          f"ms ({100 * k1_bound / k1_ms:.1f}% of it, {100 * k1_bound / k1_ms_c1:.1f}% at C=1); K4 at "
          f"C={k4_c} {k4_ms:.3f} ms vs C=1 {k4_ms_c1:.3f} ms, bound {k4_bound:.3f} ms "
          f"({100 * k4_bound / k4_ms:.1f}%, {100 * k4_bound / k4_ms_c1:.1f}% at C=1)", flush=True)
    if not (k1_ms < k1_ms_c1 and k4_ms < k4_ms_c1):
        fail("K1 or K4 at the chosen cluster size is not faster than at one CTA per row")
    phase_done("ad")

    # (ae) K14 and K15 by slice count S, at the FHN and Lorenz-63 shapes
    def k15_ms(t, part="step_backward_kernel"):
        return sum(v for n_, v in t.items() if part in n_)

    sweeps_s = {}
    for preset in (fhn, l63):
        with torch.no_grad():
            sw = slice_sweep(*slice_inputs[preset], gen)
        sweeps_s[preset] = sw
        b_, k_ = slice_inputs[preset][0][0].shape[0], slice_inputs[preset][0][0].shape[-1]
        n_w = slice_inputs[preset][0][3]["packed"].numel()
        for kern, name_k in ((0, "K14"), (1, "K15")):
            print(f"[ae] {name_k} {preset} B={b_} K={k_} hidden "
                  f"{slice_inputs[preset][0][3]['hidden']}: resident CTAs "
                  f"{sw['resident'][kern]}, chosen S={sw['chosen'][kern]} "
                  f"({b_ * sw['chosen'][kern]} CTAs); device time per launch by S (ms, "
                  f"torch.profiler over 20 launches, in the order 1, chosen, others, chosen, 1) "
                  + ", ".join(f"S={s_}: " + "/".join(f"{sum(t.values()):.4f}" for t in ts)
                              for s_, ts in sw["ms"][kern].items()), flush=True)
        print(f"[ae] K15 {preset}: partial-row traffic, sum_rows_kernel per launch by S (ms; "
              f"B·S rows of {n_w + 2 * slice_inputs[preset][0][0].shape[1]} floats) "
              + ", ".join(f"S={s_}: " + "/".join(f"{k15_ms(t, 'sum_rows_kernel'):.4f}"
                                                  for t in ts)
                          for s_, ts in sw["ms"][1].items())
              + "; step_backward_kernel alone " + ", ".join(
                  f"S={s_}: " + "/".join(f"{k15_ms(t):.4f}" for t in ts)
                  for s_, ts in sw["ms"][1].items()), flush=True)
        for s_, r in sw["k14"].items():
            print(f"[ae] K14 {preset} S={s_}: every output (x_new, alpha, stats, idx) bit-equal to "
                  f"S=1 {r['equal']}, bit-equal on a relaunch {r['same']}", flush=True)
        for s_, r in sw["k15"].items():
            print(f"[ae] K15 {preset} S={s_}: d_x bit-equal to S=1 {r['dx_equal']}, rel L2 to S=1 "
                  + ", ".join(f"{n} {e:.3e}" for n, e in zip(leaves[1:], r["rel"]))
                  + "".join(f"; {leaves[i]} vs a float64 replay {a:.3e} (S=1 {w:.3e})"
                            for i, (a, w) in r["vs64"].items())
                  + f", bit-equal on a relaunch {r['same']}", flush=True)
        if not all(r["equal"] and r["same"] for r in sw["k14"].values()):
            fail(f"K14 on slices ({preset}) is not bit-equal to one CTA per row")
        for s_, r in sw["k15"].items():
            sums_ok = all(e <= 1e-6 or (i in r["vs64"] and r["vs64"][i][0] <= r["vs64"][i][1])
                          for i, e in enumerate(r["rel"], 1))
            if not (r["dx_equal"] and r["same"] and sums_ok):
                fail(f"K15 on {s_} slices ({preset}) disagrees with one CTA per row")
        if min(sw["chosen"]) < 2:
            fail(f"{preset}: K14/K15 chose S={sw['chosen']} at B={b_}, K={k_}")
    # inside one per-step train call of FHN: K14's and K15's device time per launch by S
    fused_step.SCAN_FUSED = False
    cfg, batch = slice_config(small=False)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 20), device=dev)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    fhn_s = sweeps_s[fhn]
    both = [s_ for s_ in fhn_s["sizes"][0] if s_ in fhn_s["sizes"][1]]
    c_ = fhn_s["chosen"][0]
    launches_per_call = cfg.train.steps_per_call * (cfg.data.t_steps - 1)
    pick_s, in_step = fused_step.step_slices, {}
    try:
        for s_ in [1, c_] + [v for v in both if v not in (1, c_)] + [c_, 1]:
            fused_step.step_slices = lambda *_, s_=s_: s_
            t = device_ms_by_kernel(lambda: train_step(run_gen, fhn_train_batch), n=1)
            t0 = time.perf_counter()
            train_step(run_gen, fhn_train_batch)
            torch.cuda.synchronize()
            in_step.setdefault(s_, []).append(
                (k15_ms(t, "step_forward_kernel") / launches_per_call,
                 (k15_ms(t) + k15_ms(t, "sum_rows_kernel")) / launches_per_call,
                 sum(t.values()) / cfg.train.steps_per_call,
                 (time.perf_counter() - t0) / cfg.train.steps_per_call * 1e3))
    finally:
        fused_step.step_slices = pick_s
        fused_step.SCAN_FUSED = True
    print(f"[ae] inside one per-step train call of {fhn} ({cfg.train.steps_per_call} steps, "
          f"{launches_per_call} launches of each), by S (K14 ms / K15 ms with sum_rows per launch, "
          f"device busy ms per step, then one more call's host-clock ms per step; order 1, chosen, "
          f"others, chosen, 1): "
          + ", ".join(f"S={s_}: " + "; ".join(f"{a:.4f} / {b_:.4f}, {c:.2f}, {d:.2f}"
                                              for a, b_, c, d in v)
                      for s_, v in in_step.items()), flush=True)
    k14_s, k15_s = fhn_s["chosen"]
    k14_ms_s1 = statistics.mean(sum(t.values()) for t in fhn_s["ms"][0][1])
    k15_ms_s1 = statistics.mean(sum(t.values()) for t in fhn_s["ms"][1][1])
    phase_done("ae")

    # (af) PSVO training under the direct bound: K6's all-cotangents branch on the path
    dcfg = dataclasses.replace(lcfg, smc=dataclasses.replace(lcfg.smc, psvo_bound="direct"),
                               train=dataclasses.replace(lcfg.train, steps_per_call=1))
    batch = 32
    ssm = pt.init_ssm(dcfg, torch.Generator().manual_seed(SEED), device=dev)
    train_step = pt.make_train_step(ssm, dcfg, pt.make_optimizer(dcfg))
    obs = lds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (3, batch), generator=torch.Generator().manual_seed(SEED + 23))
    direct_batches = [obs[p_.to(dev)].contiguous() for p_ in pick]
    before = [p_.detach().clone() for p_ in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    l_kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
                 ffbsi.ffbsi_backward)
    l_plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
               fused_step.stream_noise_reference, fused_step.ancestor_indices_reference,
               ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    for fn in l_plain:
        fn.calls = 0
    for fn in l_kernels:
        fn.launches = 0
    zero_designs(ffbsi.ffbsi_forward, ffbsi.ffbsi_backward)
    torch.cuda.synchronize()
    step_s, direct_metrics = [], []
    for bt in direct_batches:
        t0 = time.perf_counter()
        direct_metrics.append(train_step(run_gen, bt))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    direct_launches = [fn.launches for fn in l_kernels]
    direct_designs = (dict(ffbsi.ffbsi_forward.launches_by_design),
                      dict(ffbsi.ffbsi_backward.launches_by_design))
    plain_calls = sum(fn.calls for fn in l_plain)
    losses = [float(m_["loss"]) for m_ in direct_metrics]
    norms = [float(m_["grad_norm"]) for m_ in direct_metrics]
    moved = any(not torch.equal(a_, p_) for a_, p_ in zip(before, ssm.parameters()))
    direct_step_ms = statistics.median(step_s[1:]) * 1e3
    print(f"[af] training {l63} under psvo_bound=\"direct\": {len(direct_batches)} steps, B={batch}: "
          f"loss {[round(v, 3) for v in losses]}, grad norm {[round(v, 3) for v in norms]}, "
          f"parameters moved {moved}; launches K1/K4/K5/K6 {direct_launches} (K5 by design "
          f"{direct_designs[0]}, K6 {direct_designs[1]}), plain-version calls {plain_calls}; step "
          f"times {[round(1e3 * v, 3) for v in step_s]} ms, train step {direct_step_ms:.3f} ms "
          f"(median of the steps after the first)", flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, direct_batches[0]), 1, PSVO_KERNELS)
    print(f"[af] profile of one more step: {profile}", flush=True)
    n_direct = len(direct_batches)
    if (direct_launches != [n_direct] * 4 or plain_calls != 0
            or direct_designs != ({"staged": n_direct, "path": 0}, {"staged": n_direct, "row": 0})):
        fail(f"direct-bound PSVO training launched K1/K4/K5/K6 {direct_launches} (want {n_direct} "
             f"each, K5 and K6 all staged: {direct_designs}), plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("direct-bound PSVO training gave non-finite losses or gradient norms, or left the "
             "parameters as they were")
    phase_done("af")

    # K3: the CDF scan and a binary search per particle; logw and u0 in, int32 indices out.
    k3_bound, k3_by = bound(2.0 * bl.numel() * (1 + math.log2(bl.shape[-1])),
                            nbytes(bl, bu) + bl.numel() * 4)
    kernels = [
        # K2: about 80 operations per normal (the count of earlier runs: a Philox4x32-10
        # call of about 100 integer operations per two normals, the Box-Muller transform
        # about 30 each), counted at the fp32 rate; its output written once. "ms" and
        # "ms_prev" are the pair and particle designs' device times at the FHN width,
        # "*_l96" at Lorenz-96's.
        {"name": "stream_noise", "route": "cuda", "source": "psvo_tpu_torch/csrc/stream_noise.cu",
         "replaces": "psvo_tpu/ops/pallas_step.py:540", "launches": 0, "on_path": False,
         "max_abs_err": k2["err"], "ms": k2["ms"], "plain_ms": k2["plain"],
         "bound_ms": k2["bound"], "bound_by": k2["by"], "library_ms": None,
         "ms_prev": k2["ms_prev"], "ms_l96": k2l["ms"], "ms_prev_l96": k2l["ms_prev"],
         "plain_ms_l96": k2l["plain"], "bound_ms_l96": k2l["bound"]},
        {"name": "ancestor_indices", "route": "cuda", "source": "psvo_tpu_torch/csrc/ancestor_indices.cu",
         "replaces": "psvo_tpu/ops/pallas_resample.py:210", "launches": 0, "on_path": False,
         "max_abs_err": float(k3_err), "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
        {"name": "scan_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_forward.cu",
         "replaces": "psvo_tpu/ops/pallas_step.py:1327", "launches": k1_train,
         "max_abs_err": results["small"]["max_abs_err"], "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None, "cluster": k1_c,
         "ms_c1": k1_ms_c1},
        {"name": "scan_backward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_backward.cu",
         "replaces": "psvo_tpu/ops/pallas_step.py:1425", "launches": k4_train,
         "max_abs_err": max(bwd[("small", "stream")]["maxd"]), "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None, "cluster": k4_c,
         "ms_c1": k4_ms_c1},
        {"name": "ffbsi_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/ffbsi.cu",
         "replaces": "psvo_tpu/ops/pallas_ffbsi.py:294", "launches": psvo_launches[2],
         "max_abs_err": sweeps["small"][1]["max_abs_err"], "ms": k5[0], "plain_ms": k5[1],
         "bound_ms": k5_bound, "bound_by": k5_by, "library_ms": None, "ms_prev": k5[2]},
        # K6: "ms" the paths-only branch (the forward bound's, on the path), "*_all" and
        # "*_direct" the all-cotangents branch with every cotangent and with the direct
        # bound's; "ms_prev*" the row design's, alternated with the staged one.
        {"name": "ffbsi_backward", "route": "cuda", "source": "psvo_tpu_torch/csrc/ffbsi.cu",
         "replaces": "psvo_tpu/ops/pallas_ffbsi.py:358", "launches": psvo_launches[3],
         "max_abs_err": max(max(rb["maxd"]) for rb in sweeps["small"][1]["bwd"].values()),
         "ms": k6["paths only"]["ms"], "plain_ms": k6["paths only"]["plain"],
         "bound_ms": k6_bound["paths only"][0], "bound_by": k6_bound["paths only"][1],
         "library_ms": None, "ms_prev": k6["paths only"]["ms_prev"],
         "ms_all": k6["all cotangents"]["ms"], "ms_prev_all": k6["all cotangents"]["ms_prev"],
         "plain_ms_all": k6["all cotangents"]["plain"],
         "bound_ms_all": k6_bound["all cotangents"][0],
         "ms_direct": k6["direct bound"]["ms"], "ms_prev_direct": k6["direct bound"]["ms_prev"],
         "bound_ms_direct": k6_bound["direct bound"][0], "launches_direct": direct_launches[3]},
        {"name": "ancestor_indices_large", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/resample_gather.cu",
         "replaces": "psvo_tpu/ops/pallas_resample.py:338",
         "launches": serve_launches["filter_posterior"][0], "max_abs_err": 0.0, "ms": k7_dev[0],
         "plain_ms": k7_dev[1], "bound_ms": k7_bound, "bound_by": k7_by, "library_ms": None,
         "ms_prev": k7_dev[2]},
        {"name": "gather_particles", "route": "cuda", "source": "psvo_tpu_torch/csrc/resample_gather.cu",
         "replaces": "psvo_tpu/ops/pallas_resample.py:489",
         "launches": serve_launches["filter_posterior"][1], "max_abs_err": 0.0, "ms": k8_dev[0],
         "plain_ms": k8_dev[1], "bound_ms": k8_bound, "bound_by": k8_by, "library_ms": k8_dev[2]},
        {"name": "trunk_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/trunk_forward.cu",
         "replaces": "psvo_tpu/ops/pallas_trunk.py:350",
         "launches": serve_launches["filter_posterior"][2], "max_abs_err": k9_small_err,
         "ms": k9_dev[0], "plain_ms": k9_dev[1], "bound_ms": k9_bound, "bound_by": k9_by,
         "library_ms": None, "ms_prev": k9_dev[3]},
        {"name": "trunk_backward", "route": "cuda", "source": "psvo_tpu_torch/csrc/trunk_backward.cu",
         "replaces": "psvo_tpu/ops/pallas_trunk.py:419", "launches": train_launches[3],
         "on_path": True, "max_abs_err": k10_small_err, "ms": k10_ms, "plain_ms": k10_plain,
         "bound_ms": k10_bound, "bound_by": k10_by, "library_ms": None, "ms_simt": k10_ms_simt,
         "bound_split_ms": k10_split},
        {"name": "segment_sum_scatter", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/resample_gather.cu",
         "replaces": "psvo_tpu/ops/pallas_resample.py:902", "launches": train_launches[4],
         "on_path": True, "max_abs_err": max(r["maxd"] for r in k11.values()), "ms": k11_dev[0],
         "plain_ms": k11_dev[1], "bound_ms": k11_bound, "bound_by": k11_by,
         "library_ms": k11_dev[2], "ms_prev": k11_dev[5]},
        {"name": "svo_sweep_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/svo_sweep.cu",
         "replaces": "psvo_tpu/ops/pallas_svo.py:446", "launches": svo_launches[2],
         "on_path": True, "max_abs_err": k12_small_err, "ms": k12_dev[0], "plain_ms": k12_dev[1],
         "bound_ms": k12_bound, "bound_by": k12_by, "library_ms": None, "ms_prev": k12_dev[2]},
        {"name": "svo_sweep_backward", "route": "cuda", "source": "psvo_tpu_torch/csrc/svo_sweep.cu",
         "replaces": "psvo_tpu/ops/pallas_svo.py:521", "launches": svo_launches[3],
         "on_path": True, "max_abs_err": k13_small_err, "ms": k13_dev[0], "plain_ms": k13_dev[1],
         "bound_ms": k13_bound, "bound_by": k13_by, "library_ms": None, "ms_prev": k13_dev[2]},
        {"name": "step_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_forward.cu",
         "replaces": "psvo_tpu/ops/pallas_step.py:954", "launches": step_train[0],
         "on_path": True, "max_abs_err": k14_small_err, "ms": k14_dev[0], "plain_ms": k14_dev[1],
         "bound_ms": k14_bound, "bound_by": k14_by, "library_ms": None, "slices": k14_s,
         "ms_s1": k14_ms_s1},
        {"name": "step_backward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_backward.cu",
         "replaces": "psvo_tpu/ops/pallas_step.py:1013", "launches": step_train[1],
         "on_path": True, "max_abs_err": k15_small_err, "ms": k15_dev[0], "plain_ms": k15_dev[1],
         "bound_ms": k15_bound, "bound_by": k15_by, "library_ms": None, "slices": k15_s,
         "ms_s1": k15_ms_s1},
    ]
    print(f"[profiler] {PROFILE_WINDOWS['windows']} profiler windows, "
          f"{PROFILE_WINDOWS['empty']} of them with no device events (run again); of the timing "
          f"windows, {PROFILE_WINDOWS['partial']} recorded part of a kernel's events (timed by "
          f"the mean of those recorded)", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
