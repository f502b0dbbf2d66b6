#!/usr/bin/env python3
"""K4's and K15's plans timed against each other, and a depth-5 shape held to
the plain versions, on one GPU.

    python3 tools/step_class_plans.py

1. Builds the kernels' library with the shape libraries of `chip_smoke.py`'s
   phase be beside it (`_build.prebuild_shapes`, nice 10) and prints both
   times.
2. Builds shape libraries that force each plan of `fused_step.K4_PLANS` at
   FHN with three hidden layers of 64 (phase be's be-B, "global" chosen)
   and with five of 48 ("split" chosen).
3. Holds K1, K4, K14 and K15 at five layers of 48 to their plain versions
   (`chip_smoke.check_scan`, `check_backward`, `step_chain_check`,
   `step_backward_check`), small (B = 4, K = 256, T = 10) and full (B = 32,
   K = 1024, T = 100).
4. Times K4 and K15 at both shapes (B = 32, K = 1024, T = 100) under each
   plan with `chip_smoke.pair_ms`, in the order of the plans and back,
   and checks each plan's outputs bit for bit against the chosen plan's.
"""
import dataclasses, os, statistics, sys, time, traceback
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as cs
import psvo_tpu_torch as pt
from psvo_tpu_torch.config import NetConfig, PRESETS
from psvo_tpu_torch.ops import _build, fused_step

def failsoft(msg):
    print("FAIL:", msg, flush=True)
cs.fail = failsoft
print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip(), flush=True)

# 1. phase b as chip_smoke runs it
be_keys = cs.step_class_shapes(pt)
t0 = time.perf_counter()
th = _build.prebuild_shapes(be_keys)
_build.load_library()
lib_s = time.perf_counter() - t0
for t in th:
    t.join()
print(f"[b'] library {lib_s:.1f} s; be shape libraries {be_keys} done at {time.perf_counter() - t0:.1f} s", flush=True)
for k in be_keys:
    print("   ", k, (_build.build_log(k).splitlines() or ["(no log)"])[0], flush=True)

SHAPES = {  # label: dx, dy, hidden, plans to time (the chosen first)
    "be-B": (2, 2, (64, 64, 64), ("global", "split", "stream")),
    "deep5": (2, 2, (48,) * 5, ("split", "stream")),
}
keys = []
for dx, dy, hidden, plans in SHAPES.values():
    c = fused_step.shape_consts(dx, dy, 0, hidden[0], len(hidden) - 1)
    for p in plans:
        k = (dx, dy, hidden[0], len(hidden) - 1, fused_step.K1_PLANS.index(fused_step.k1_plan(c)),
             fused_step.K4_PLANS.index(p))
        if k not in keys and k not in be_keys:
            keys.append(k)
t0 = time.perf_counter()
for t in _build.prebuild_shapes(keys, niceness=0):
    t.join()
print(f"timing libraries {keys} built in {time.perf_counter() - t0:.1f} s", flush=True)
for k in keys:
    try:
        _build.load_shape_library(k)
    except Exception as e:
        print("BUILD FAILED", k, str(e)[-4000:], flush=True)
        sys.exit(1)

CACHES = (fused_step._lib_key_of, fused_step._k1_fits, fused_step._k4_fits, fused_step._k15_fits,
          fused_step._resident_at, fused_step._k4_tile)
orig_plan = fused_step._k4_plan

def force(plan):
    fused_step._k4_plan = (lambda shape, k=None, p=plan: p) if plan else orig_plan
    for f in CACHES:
        f.cache_clear()

def config(dx, dy, hidden, k=1024, t=100):
    cfg = PRESETS["fhn_fivo_k1024_bench"]
    net = NetConfig(hidden=hidden)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dx=dx, dy=dy, t_steps=t),
                              smc=dataclasses.replace(cfg.smc, n_particles=k))
    return cfg.with_nets(q1=net, f=net, g=net)

dev = torch.device("cuda:0")
# 2. the depth-5 shape's kernels against their plain versions, small and full
for size, (k, b, t) in (("small", (256, 4, 10)), ("full", (1024, 32, 100))):
    try:
        cfg = config(2, 2, (48,) * 5, k, t)
        gen = torch.Generator(device=dev).manual_seed(0)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(3), device=dev)
        ys = torch.randn((b, t, 2), device=dev, generator=gen)
        assert fused_step.usable(ssm, cfg.smc) and pt.smc.reference_path(ssm, cfg.smc) == "fused"
        with torch.no_grad():
            r1 = cs.check_scan("deep5", ssm, cfg, ys, gen, tol=2e-4)
            r4 = cs.check_backward(ssm, cfg, ys, gen)
            rs = cs.step_chain_check(ssm, cfg, ys, gen)
            rb = cs.step_backward_check(rs, gen)
        print(f"[deep5 {size}] K1 {cs.scan_line(r1)}; K4 rel {[f'{v:.2e}' for v in r4['rel']]} "
              f"finite {r4['finite']} mono {r4['monotone']}; K14 idx_bad {rs['idx_bad']} tf_rel "
              f"{[f'{v:.1e}' for v in rs['tf_rel']]} vs K1 {rs['k1_idx']} {rs['vs_k1']}; K15 rel "
              f"{[f'{v:.2e}' for v in rb['rel']]} same {rb['same']} vs K4 "
              f"{[f'{v:.1e}' for v in rb['vs_k4']]}", flush=True)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()

# 3. K4 and K15 under each plan, alternated, at B = 32, K = 1024, T = 100
for label, (dx, dy, hidden, plans) in SHAPES.items():
    try:
        force(None)
        cfg = config(dx, dy, hidden)
        gen = torch.Generator(device=dev).manual_seed(1)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(3), device=dev)
        ys = torch.randn((32, 100, dy), device=dev, generator=gen)
        with torch.no_grad():
            r4 = cs.check_backward(ssm, cfg, ys, gen)
            rs = cs.step_chain_check(ssm, cfg, ys, gen)
            rb = cs.step_backward_check(rs, gen)
        args, d_xn, d_al, _ = rb["last"]
        k15 = lambda: fused_step.step_backward(*args, d_xn, d_al)
        consts = args[5]
        print(f"[{label}] chosen plan {fused_step.k4_plan(consts)}", flush=True)
        want4, want15 = r4["kernel"](), k15()
        times = {p: ([], []) for p in plans}
        for rnd in range(2):
            for p in (plans if rnd == 0 else plans[::-1]):
                force(p)
                with torch.no_grad():
                    got4 = r4["kernel"](); c4 = fused_step.scan_backward.last_cluster
                    got15 = k15(); s15 = fused_step.step_backward.last_slices
                    torch.cuda.synchronize()
                    same = ([torch.equal(a, w) for a, w in zip(got4, want4)],
                            [torch.equal(a, w) for a, w in zip(got15, want15)])
                    rel = [float((a - w).norm() / w.norm().clamp_min(1e-30)) for a, w in zip(got4, want4)]
                    t4 = cs.pair_ms(r4["kernel"]); t15 = cs.pair_ms(k15)
                times[p][0].append(t4); times[p][1].append(t15)
                print(f"[{label}] plan {p}: K4 {t4:.3f} ms (C={c4}, smem "
                      f"{fused_step.k4_smem_bytes(consts, 1024, c4)} B), K15 {t15:.4f} ms (S={s15}, smem "
                      f"{fused_step.k15_smem_bytes(consts, 1024)} B); bit-equal to the chosen plan "
                      f"K4 {same[0]} (rel {[f'{v:.1e}' for v in rel]}), K15 {same[1]}", flush=True)
        force(None)
        print(f"[{label}] summary: " + "; ".join(
            f"{p}: K4 {[round(v, 3) for v in a]} ms, K15 {[round(v, 4) for v in b_]} ms"
            for p, (a, b_) in times.items()), flush=True)
    except Exception:
        force(None)
        traceback.print_exc()
        sys.stdout.flush()
print("done", flush=True)
