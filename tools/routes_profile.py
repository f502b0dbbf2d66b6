#!/usr/bin/env python3
"""Profile segmented long-T PSVO on the plain step body, on one GPU.

    python3 tools/routes_profile.py

The configuration is `chip_smoke.py` phase (ba)'s: the reference's
`lorenz63_psvo_k1024_t1025_seg8` (K = 1024, M = 16, relu heads (64, 64),
B = 8, T = 1025, S = 8 segments) with smc.ess_threshold = 0.5, random
weights, data from seed 0. Outside the whole-scan class, its forward runs
the plain step body a segment, as the reference runs it, and resamples
through K7/K8 (K11 in the backward); each segment sweeps through K5/K6. A
train step launches about 800,000 device operations, and reading a
`torch.profiler` window of one takes minutes, so `chip_smoke.py` times the
step and this script profiles it: one serving call (`smooth_posterior`) and
one train step after a warm-up of each, each in a device-only profiler
window (`chip_smoke.device_breakdown`): the span, the device's busy time
and idle share, each kernel's time, and the count and time of the other
device operations. `fused_step.SCAN_FUSED` off runs the same body with the
same draws, so one of the two is profiled. Prints the card's name and power
limit first; builds the kernels as `chip_smoke.py` does.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import psvo_tpu_torch as pt
    from psvo_tpu_torch.ops import _build

    _build.load_library()
    dev = torch.device("cuda:0")
    cfg = cs.long_t_config(pt, cs.BA_T, cs.BA_S)
    cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, ess_threshold=0.5))
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(cs.SEED), device=dev)
    ys = pt.generate_dataset(cfg.data, cs.SEED).obs_train[:8].to(dev).contiguous()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 170)
    step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    for name, fn in (("smooth_posterior", lambda: pt.smooth_posterior(ssm, ys, cfg, gen)),
                     ("train step", lambda: step(gen, ys))):
        t0 = time.perf_counter()
        fn()  # warm-up
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        prof = cs.device_breakdown(fn, 1, cs.ROUTE_KERNELS)
        print(f"[routes_profile] {card}: {cs.LONG_T} with ess_threshold 0.5 (T={cs.BA_T}, "
              f"S={cs.BA_S}, B=8) {name}: warm-up {1e3 * warm:.1f} ms (host clock); profile "
              f"{prof}; the window and its reading {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
