#!/usr/bin/env python3
"""Hold the kernels K1, K4, K14 and K15 (and K12, K13, K9, K10) of two
checkouts of the port to the same bits, and time them, on an uncontrolled
model (data.di = 0), on one GPU.

    python3 tools/uncontrolled_bits.py dump ROOT OUT.pt   # ROOT: a checkout of the repo
    python3 tools/uncontrolled_bits.py compare A.pt B.pt
    python3 tools/uncontrolled_bits.py time ROOT

`dump` imports `psvo_tpu_torch` from ROOT, builds its kernels, and saves the
outputs of K1 (stream noise and the in-kernel draw, with the cache and the
residuals), K4 (every cotangent), a chain of K14 and K15 on each step, at the
FHN shape (B = 32, K = 1024, hidden (64, 64), Dx = 2) and the Lorenz-63 one
(Dx = 3), and K12 and K13 (the split designs, every cotangent) at the SVO
preset's (B = 32, M = 16, T = 100, hidden (64, 64), Dx = 3), K9 and K10
(every design the kernels' library holds at the shape, the streamed ε and
the in-kernel draw, random cotangents) at the three preset shapes of the
trunk class, FHN's (Dx = Dy = 2), Lorenz-63's (3) and Lorenz-96's (40)
(B = 4, K = 1024, hidden (64, 64)), and K7 and K11 at the Lorenz-96
preset's (B = 8, K = 8192, D = 40), all on inputs made on the card from
fixed seeds. `compare` prints whether every tensor of the two dumps is
bit-equal and exits non-zero if not. `time` prints the kernels' times: K1,
K4, K14 and K15 at the FHN shape, K9 and K10 at the three trunk shapes (B =
32, K = 1024 at Dx = 2 and 3; B = 8, K = 8192 at 40; hidden (64, 64), the
in-kernel draw), K7 and K11 at B = 8, K = 8192 (CUDA events around n
back-to-back calls over n, n = 5 for K1/K4 and 50 for K14/K15 at a mid step;
for K9/K10 (n = 20) and K7/K11 (n = 50) around n calls queued behind a spin
kernel, the device's time alone; the median of 5 after 2 warm-up). Run
`dump` and `time` once per checkout, each in its own process (both
packages have one name), on one card in one call; for times, alternate
them: ROOT A, B, B, A.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _import(root: str):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import psvo_tpu_torch as pt

    if not pt.__file__.startswith(os.path.abspath(root)):
        sys.exit(f"psvo_tpu_torch came from {pt.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch, pt


def _operands(torch, pt, preset, dx, t_steps):
    """The model of `preset` (random weights, seed 0) and K1's operands at
    B = 32, K = 1024 on the card, from fixed seeds."""
    from psvo_tpu_torch.ops import fused_step

    dev = torch.device("cuda:0")
    cfg = pt.PRESETS[preset]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, t_steps=t_steps))
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    b, k, t1 = 32, 1024, t_steps - 1
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
    x0 = torch.randn((b, dx, k), generator=g, device=dev) * 2.0
    a0 = torch.randn((b, k), generator=g, device=dev)
    coef = torch.rand((t1, b, 4 * dx + 1), generator=g, device=dev) + 0.1
    eps = torch.randn((t1, b, dx, k), generator=g, device=dev)
    pos = fused_step.systematic_positions(torch.rand((t1, b), generator=g, device=dev), k)
    return consts, x0, a0, coef, eps, pos, g


def time_kernels(root: str) -> None:
    torch, pt = _import(root)
    from psvo_tpu_torch.ops import fused_step

    consts, x0, a0, coef, eps, pos, g = _operands(torch, pt, "fhn_fivo_k1024_bench", 2, 100)

    def ms(fn, n):
        for _ in range(2):
            fn()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / n)
        return sorted(times)[2]

    with torch.no_grad():
        k1 = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, save_res=True)
        x_last, alpha_last, stats, x_all, _, idx = k1
        cots = [torch.randn(t.shape, generator=g, device=x0.device) for t in (stats, x_last)]
        t = coef.shape[0] // 2
        step = (x_all[t - 1], a0, coef[t], consts, eps[t], pos[t])
        out = fused_step.step_forward(*step)
        got = {
            "K1": ms(lambda: fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos),
                     5),
            "K4": ms(lambda: fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, *cots,
                                                      eps=eps), 5),
            "K14": ms(lambda: fused_step.step_forward(*step), 50),
            "K15": ms(lambda: fused_step.step_backward(x_all[t - 1], out[0], out[3], out[2],
                                                       coef[t], consts, eps[t], cots[0][t]), 50),
        }
        got.update(_trunk_times(torch, pt))
    print(f"{_card()}: {root}: " + ", ".join(f"{n} {v:.4f} ms" for n, v in got.items()),
          flush=True)


_TRUNK_SHAPES = (("fhn", "fhn_fivo_k1024_bench", 2), ("l63", "lorenz63_psvo_k1024", 3),
                 ("l96", "lorenz96_fivo_k8192_sharded", 40))


def _trunk_operands(torch, pt, preset, dx, b, k, seed):
    """K9's operands at preset's width, hidden (64, 64), random weights (seed
    0) and an uncontrolled coefficient row, made on the card from `seed`."""
    from psvo_tpu_torch.ops import fused_step

    dev = torch.device("cuda:0")
    cfg = pt.PRESETS[preset]
    net = pt.NetConfig(hidden=(64, 64))
    cfg = cfg.with_nets(q0=net, q1=net, q2=net, f=net, qb=net, g=net)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
    x_res = torch.randn((b, dx, k), generator=g, device=dev) * 2.0
    coef = torch.rand((b, 4 * dx + 1), generator=g, device=dev) + 0.1
    eps = torch.randn((b, dx, k), generator=g, device=dev)
    return consts, x_res, coef, eps, g


def _resample_operands(torch, b=8, k=8192, d=40, seed=4):
    """K7's and K11's operands at the Lorenz-96 preset's shape: log-weights,
    sorted systematic positions and a cotangent, from `seed` on the card."""
    from psvo_tpu_torch.ops import fused_step

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(seed)
    logw = torch.randn((b, k), generator=g, device=dev) * 3.0
    pos = fused_step.systematic_positions(torch.rand((b,), generator=g, device=dev), k)
    cot = torch.randn((b, d, k), generator=g, device=dev)
    return logw, pos.contiguous(), cot


def _queued_ms(torch, fn, n: int) -> float:
    """Device time per call of fn(): CUDA events around n calls queued behind
    a spin kernel that holds the card while the host launches them (so the
    host's launch cost, which the wrappers' Python adds, stays out), the
    median of 5 windows after 2 warm-up calls."""
    import time

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1e7 / start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    spin_ms = 4e3 * (time.perf_counter() - t0) + 1.0
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[2]


def _trunk_times(torch, pt) -> dict:
    """K9 and K10 at the three trunk shapes, K7 and K11 at the Lorenz-96
    preset's, by queued device time (`_queued_ms`)."""
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk

    def ms(fn, n):
        return _queued_ms(torch, fn, n)

    got = {}
    with torch.no_grad():
        for name, preset, dx in _TRUNK_SHAPES:
            b, k = (8, 8192) if dx == 40 else (32, 1024)
            consts, x_res, coef, _, g = _trunk_operands(torch, pt, preset, dx, b, k, 3)
            noise = {"seed": (5, 7), "t": 3}
            x_new, alpha = trunk.trunk_forward(x_res, coef, consts, **noise)
            cots = [torch.randn(t.shape, generator=g, device=x_res.device) for t in (x_new, alpha)]
            got[f"K9 {name}"] = ms(lambda: trunk.trunk_forward(x_res, coef, consts, **noise), 20)
            got[f"K10 {name}"] = ms(lambda: trunk.trunk_backward(x_res, x_new, coef, consts, *cots,
                                                                 **noise), 20)
        logw, pos, cot = _resample_operands(torch)
        idx = rg.ancestor_indices_large(logw, pos)
        got["K7"] = ms(lambda: rg.ancestor_indices_large(logw, pos), 50)
        got["K11"] = ms(lambda: rg.segment_sum_scatter(cot, idx), 50)
    return got


def dump(root: str, out: str) -> None:
    torch, pt = _import(root)
    from psvo_tpu_torch.ops import fused_step

    outs = {}
    for preset, dx in (("fhn_fivo_k1024_bench", 2), ("lorenz63_psvo_k1024", 3)):
        consts, x0, a0, coef, eps, pos, g = _operands(torch, pt, preset, dx, 20)
        dev, t1 = x0.device, coef.shape[0]
        with torch.no_grad():
            k1 = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cache=True,
                                         save_res=True)
            k1_rng = fused_step.scan_forward(x0, a0, coef, consts, seed=(5, 7), cache=True,
                                             save_res=True)
            x_last, alpha_last, stats, x_all, alpha_all, idx = k1
            cots = [torch.randn(t.shape, generator=g, device=dev)
                    for t in (stats, x_last, alpha_last, x_all, alpha_all)]
            k4 = fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, *cots, eps=eps)
            x, lw, k14, k15 = x0, a0, [], []
            for t in range(t1):
                step = fused_step.step_forward(x, lw, coef[t], consts, eps[t], pos[t])
                k14.append(step)
                k15.append(fused_step.step_backward(x, step[0], step[3], step[2], coef[t], consts,
                                                    eps[t], cots[0][t], cots[3][t], cots[4][t]))
                x, lw = step[0], step[1]
        torch.cuda.synchronize()
        for name, ts in (("K1", k1), ("K1_rng", k1_rng), ("K4", k4)):
            for i, v in enumerate(ts):
                if v is not None:
                    outs[f"{preset}/{name}/{i}"] = v.cpu()
        for name, steps in (("K14", k14), ("K15", k15)):
            for i in range(len(steps[0])):
                outs[f"{preset}/{name}/{i}"] = torch.stack([s[i] for s in steps]).cpu()
    outs.update(_svo_dump(torch, pt))
    outs.update(_trunk_dump(torch, pt))
    torch.save(outs, out)
    print(f"dumped {len(outs)} tensors from {pt.__file__} to {out}", flush=True)


def _svo_dump(torch, pt) -> dict:
    """K12's four outputs and K13's three leaves at lorenz63_svo_k256's shape,
    on operands made on the card from fixed seeds."""
    from psvo_tpu_torch.ops import svo

    dev = torch.device("cuda:0")
    cfg = pt.PRESETS["lorenz63_svo_k256"]
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    b, m, t1 = 32, cfg.smc.n_smoothing_particles, cfg.data.t_steps - 1
    with torch.no_grad():
        for p in ssm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
        consts = svo.prepare(ssm)
    ops = (torch.randn((b, m, 3), generator=g, device=dev) * 3.0,
           torch.randn((t1, b, m, 3), generator=g, device=dev),
           torch.randn((t1, b, 3), generator=g, device=dev) * 3.0)
    with torch.no_grad():
        k12 = svo.svo_sweep_forward(*ops, consts)
        cots = [torch.randn(t.shape, generator=g, device=dev) for t in k12]
        k13 = svo.svo_sweep_backward(*ops, consts, k12[3], *cots)
    torch.cuda.synchronize()
    outs = {f"svo/K12/{i}": v.cpu() for i, v in enumerate(k12)}
    outs.update({f"svo/K13/{i}": v.cpu() for i, v in enumerate(k13)})
    return outs


def _trunk_dump(torch, pt) -> dict:
    """K9's two outputs and K10's four leaves at the three preset shapes of
    the trunk class, each design the kernels' library holds there (K10's
    tensor-core design at Lorenz-96's width alone), streamed ε and the
    in-kernel draw; K7's indices and K11's sums at the Lorenz-96 preset's
    shape; on operands made on the card from fixed seeds (uncontrolled
    coefficient rows)."""
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk

    outs = {}
    with torch.no_grad():
        for name, preset, dx in _TRUNK_SHAPES:
            consts, x_res, coef, eps, g = _trunk_operands(torch, pt, preset, dx, 4, 1024, 3)
            for noise_name, noise in (("stream", {"eps": eps}), ("rng", {"seed": (5, 7), "t": 3})):
                for design in trunk.K9_DESIGNS:
                    x_new, alpha = trunk.trunk_forward(x_res, coef, consts, design=design, **noise)
                    outs[f"{name}/K9/{design}/{noise_name}/0"] = x_new.cpu()
                    outs[f"{name}/K9/{design}/{noise_name}/1"] = alpha.cpu()
                cots = [torch.randn(t.shape, generator=g, device=x_res.device)
                        for t in (x_new, alpha)]
                for design in trunk.DESIGNS if dx == 40 else ("simt",):
                    leaves = trunk.trunk_backward(x_res, x_new, coef, consts, *cots, design=design,
                                                  **noise)
                    for i, v in enumerate(leaves):
                        outs[f"{name}/K10/{design}/{noise_name}/{i}"] = v.cpu()
        logw, pos, cot = _resample_operands(torch)
        for design in rg.K7_DESIGNS:
            outs[f"l96/K7/{design}"] = rg.ancestor_indices_large(logw, pos, design=design).cpu()
        idx = rg.ancestor_indices_large(logw, pos)
        for design in rg.K11_DESIGNS:
            outs[f"l96/K11/{design}"] = rg.segment_sum_scatter(cot, idx, design=design).cpu()
    torch.cuda.synchronize()
    return outs


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    if set(a) != set(b):
        print(f"FAIL: the dumps hold different tensors: {sorted(set(a) ^ set(b))}")
        return 1
    bad = [name for name in sorted(a) if not torch.equal(a[name], b[name])]
    print(f"{_card()}: {len(a) - len(bad)} of {len(a)} tensors bit-equal"
          + (f"; differing: {bad}" if bad else ""), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "dump":
        dump(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 3 and sys.argv[1] == "time":
        time_kernels(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
