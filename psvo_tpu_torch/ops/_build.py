"""Build and load the hand-written CUDA kernels of `psvo_tpu_torch/csrc/`.

At first use `nvcc` compiles every `csrc/*.cu` for Hopper (`sm_90a`), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which is loaded with `ctypes`. The
library goes to `psvo_tpu_torch/_build/<hash>/`, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.
A failed build raises with the compiler's output; nothing falls back.

The whole-step kernels K1/K4/K14/K15 are templates over their shape (Dx,
Dy, the hidden width, K4/K15's depth and the plans of `fused_step.k1_plan` /
`k4_plan`), and so are the trunk kernels K9/K10 (Dx, Dy, the hidden width
and where each keeps its weights, `trunk.k9_weights` / `k10_weights`). The
library instantiates the presets' shapes (`csrc/step_math.cuh::with_dims`,
`csrc/trunk_forward.cuh::dispatch_trunk_forward`); any other shape of their
classes is compiled on its first use by `load_shape_library`: the sources
of those kernels (`SHAPE_SOURCES`, `TRUNK_SOURCES`) with the shape as `-D`
macros, one nvcc per source, into a library of their own under
`_build/<hash>/shape_.../` or `trunk_.../`, keyed by the same hash and the
shape. K12/K13 (`SVO_SOURCES`) likewise: the library holds the presets'
(Dx, Dy, width), and any other shape of the SVO class builds its split
designs into `svo_<dx>_<dy>_<hidden>/`. `prebuild_shapes` starts such builds
in the background.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libpsvo_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills -> build.log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
# argtypes of each C entry point; every pointer and the stream are c_void_p
SIGNATURES = {
    # K1 and K4 end in (..., off_f, off_g, ctrl, cluster, stream): ctrl 1 when the coef
    # rows carry the controls' first-layer terms, C CTAs per row
    "psvo_scan_forward": [_P] * 13 + [_U32, _U32] + [_I] * 13 + [_P],
    "psvo_scan_backward": [_P] * 17 + [_U32, _U32] + [_I] * 13 + [_P],
    # (kernel: 0 K1, 1 K4; dx, dy, hidden, ctrl, cluster, smem bytes; int* out)
    "psvo_max_active_clusters": [_I] * 7 + [_P],
    # K2 ends in (..., K, design, stream): 0 the pair design, 1 the particle one
    "psvo_stream_noise": [_P, _P, _U32, _U32, _I, _I, _I, _I, _I, _P],
    "psvo_ancestor_indices": [_P, _P, _P, _I, _I, _P],
    # K5 ends in (..., dx, design, paths, chunk, stream): 0 the staged kernel, 1 the previous
    # one, 2 the wide one
    "psvo_ffbsi_forward": [_P] * 13 + [_I] * 8 + [_P],
    # K6 ends in (..., work, ctas, chunk, B, M, K, T1, dx, design, stream): 0 the staged
    # kernel, 1 the row one, 2 the wide one (a grid of ctas, its scratch work, chunk particles)
    "psvo_ffbsi_backward": [_P] * 19 + [_I] * 8 + [_P],
    # K7 and K11 end in (..., design, ...plan, stream): 0 the new design, 1 the row one; K7's
    # plan (cluster, spread), K11's (per, cluster)
    "psvo_ancestor_indices_large": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "psvo_gather_particles": [_P, _P, _P, _I, _I, _I, _P],
    # K9 ends in (..., off_g, design, pair, prefetch, wplan, ctrl, stream): 0 the async design,
    # 1 the tile one; wplan 1 when the weights stay in device memory; ctrl 1 when the coef rows
    # carry the controls' first-layer terms
    "psvo_trunk_forward": [_P] * 7 + [_U32, _U32] + [_I] * 16 + [_P],
    "psvo_segment_sum_scatter": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # K10 ends in (..., max_ctas, design, wplan, ctrl, stream): 0 the tensor-core design, 1 the
    # previous one; wplan and ctrl as K9's
    "psvo_trunk_backward": [_P] * 13 + [_U32, _U32] + [_I] * 15 + [_P],
    # K12 ends in (..., off_g, design, paths, tile_rows, steps, stream): 0 the split design, 1 the
    # chain; a non-null cbias (the sixth pointer) runs the split design's control mode
    "psvo_svo_forward": [_P] * 10 + [_I] * 14 + [_P],
    # K13 ends in (..., max_ctas, design, tile_rows, paths, stream): 0 the split design, 1 the
    # chain; with cbias also bias_part (scratch) and d_cbias, the last two pointers
    "psvo_svo_backward": [_P] * 16 + [_I] * 14 + [_P],
    # K14 and K15: (..., counter, B, ..., off_g, ctrl, slices, stream): S CTAs per row
    "psvo_step_forward": [_P] * 12 + [_I] * 11 + [_P],
    "psvo_step_backward": [_P] * 18 + [_I] * 11 + [_P],
    # (kernel: 0 K14, 1 K15; dx, dy, hidden, ctrl, smem bytes; int* out)
    "psvo_step_max_active": [_I] * 6 + [_P],
}

# the sources of K1/K14 (both control modes) and K4/K15, which a shape library holds
SHAPE_SOURCES = ("scan_forward.cu", "scan_forward_ctrl.cu", "step_forward.cu",
                 "step_forward_ctrl.cu", "scan_backward.cu", "step_backward.cu")
# PSVO_SHAPE_<name> (step_math.cuh); FP, K1's tile, only under its tiled plan or with BP, K4's
# tile, where that is narrower than 64
SHAPE_MACROS = ("DX", "DY", "H", "NMID", "FWD", "BWD", "FP", "BP")
# the sources of K9 and K10 (both control modes), which a trunk shape library holds, and its
# macros PSVO_TRUNK_<name>: the shape and where K9's and K10's weights stay (0 shared memory,
# 1 device memory; trunk_forward.cuh, trunk_backward.cuh)
TRUNK_SOURCES = ("trunk_forward.cu", "trunk_forward_ctrl.cu", "trunk_backward.cu",
                 "trunk_backward_ctrl.cu")
TRUNK_MACROS = ("DX", "DY", "H", "K9", "K10")
# the sources of K12 and K13 (both control modes), which an SVO shape library holds (their
# split designs alone), and its macros PSVO_SVO_<name> (svo_sweep.cuh::dispatch)
SVO_SOURCES = ("svo_sweep.cu", "svo_sweep_ctrl.cu")
SVO_MACROS = ("DX", "DY", "H")
# a shape library's kind by its key: ("trunk", dx, dy, hidden, k9 weights, k10 weights),
# ("svo", dx, dy, hidden), or the whole-step kernels' (dx, dy, hidden, n_mid, k1 plan, k4 plan
# [, k1 tile[, k4 tile]])
_KINDS = {"trunk": (TRUNK_SOURCES, "PSVO_TRUNK_", TRUNK_MACROS),
          "svo": (SVO_SOURCES, "PSVO_SVO_", SVO_MACROS),
          "step": (SHAPE_SOURCES, "PSVO_SHAPE_", SHAPE_MACROS)}


def _kind(shape: tuple) -> str:
    return shape[0] if shape and shape[0] in ("trunk", "svo") else "step"


def _shape_ints(shape: tuple) -> tuple:
    return tuple(int(v) for v in (shape[1:] if _kind(shape) != "step" else shape))


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(out_dir: Path, srcs=None, defines=(), niceness: int = 0) -> Path:
    """Compile each of `srcs` (every csrc/*.cu by default) into an object,
    in parallel, with the `-D` macros `defines`, and link them into
    out_dir/LIB_NAME (atomically); return its path. The compilers run at
    `niceness` (through `nice`), so that a background build yields the cores to a
    foreground one."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    srcs = sorted(CSRC.glob("*.cu")) if srcs is None else list(srcs)
    t0 = time.perf_counter()
    jobs = []
    nice = shutil.which("nice") if niceness else None
    for src in srcs:
        cmd = [nvcc(), *NVCC_FLAGS, *[f"-D{d}" for d in defines], "-I", str(CSRC), "-c", "-o",
               str(out_dir / f"{src.stem}.o"), str(src)]
        run = [nice, "-n", str(niceness), *cmd] if nice else cmd
        out = tempfile.TemporaryFile(mode="w+", dir=out_dir)  # no pipe to fill while others run
        jobs.append([cmd, subprocess.Popen(run, stdout=out, stderr=subprocess.STDOUT, text=True),
                     out, None])
    while any(job[3] is None for job in jobs):  # each source's own seconds, for the log
        for job in jobs:
            if job[3] is None and job[1].poll() is not None:
                job[3] = time.perf_counter() - t0
        time.sleep(0.2)
    log, failed = [], []
    for cmd, proc, out, secs in jobs:
        out.seek(0)
        text = out.read()
        out.close()
        log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode} after {secs:.1f} s\n{text}")
        if proc.returncode != 0:
            failed.append(text)
    compile_s = time.perf_counter() - t0
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    if not failed:
        cmd = [nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp,
               *[str(out_dir / f"{src.stem}.o") for src in srcs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(proc.stdout + proc.stderr)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        f"# {len(jobs)} sources compiled in parallel in {compile_s:.1f} s, "
        f"{seconds:.1f} s with the link\n" + "\n".join(log)
    )
    if failed:
        if os.path.exists(tmp):  # a failed link may have removed it
            os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "\n".join(f[-8000:] for f in failed))
    os.replace(tmp, lib)
    return lib


def _load(lib_path: Path) -> ctypes.CDLL:
    """Load a built library and declare the argtypes of its entry points."""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:  # a shape library holds its own kernels' entry points only
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.psvo_error_string.argtypes = [ctypes.c_int]
    lib.psvo_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once per process
    (the sources are hashed once, not per launch); argtypes declared."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        build(out_dir)
    return _load(lib_path)


def shape_dir(shape: tuple) -> Path:
    """Where the shape library of `shape` goes, under the current build's
    hash: `shape_<dx>_<dy>_<hidden>_<n_mid>_<k1 plan>_<k4 plan>[_<k1 tile>[_<k4
    tile>]]` for the whole-step kernels, `trunk_<dx>_<dy>_<hidden>_<k9 weights>_<k10 weights>`
    for K9/K10 (key ("trunk", dx, dy, hidden, k9 weights, k10 weights)),
    `svo_<dx>_<dy>_<hidden>` for K12/K13 (key ("svo", dx, dy, hidden))."""
    kind = _kind(shape)
    name = "shape_" if kind == "step" else kind + "_"
    return BUILD_ROOT / source_hash() / (name + "_".join(str(v) for v in _shape_ints(shape)))


_SHAPE_LOCKS: dict = {}
_SHAPE_LIBS: dict = {}
_LOCKS_LOCK = threading.Lock()


def load_shape_library(shape: tuple, niceness: int = 0) -> ctypes.CDLL:
    """The library of K1/K14 and K4/K15 at one shape of their class outside
    the presets' (`fused_step._library` says which): `shape` = (dx, dy,
    hidden, n_mid, k1 plan, k4 plan) as ints, the plans' indices in
    `fused_step.K1_PLANS` / `K4_PLANS`, then under K1's plan "tile" its
    tile's particles and where K4's tile is narrower than 64 that
    (`fused_step.shape_key`); or of K9 and K10 (`trunk._library`):
    `shape` = ("trunk", dx, dy, hidden, k9 weights, k10 weights), the
    weights' places' indices in `trunk.WEIGHT_PLACES`; or of K12 and K13's
    split designs (`svo._library`): `shape` = ("svo", dx, dy, hidden). Built
    on first use (SHAPE_SOURCES with the PSVO_SHAPE_* macros, TRUNK_SOURCES
    with the PSVO_TRUNK_* ones, SVO_SOURCES with the PSVO_SVO_* ones; a failed
    build raises), loaded once per process. Thread-safe: a second caller waits for the first one's build.
    The objects are compiled in a directory of their own and the library
    moved into place, so processes that build the same shape at once do not
    share a file. niceness: the compilers' (`build`)."""
    lib = _SHAPE_LIBS.get(shape)
    if lib is not None:  # the launches' path: loaded already
        return lib
    kind = _kind(shape)
    shape = (() if kind == "step" else (kind,)) + _shape_ints(shape)
    with _LOCKS_LOCK:
        lock = _SHAPE_LOCKS.setdefault(shape, threading.Lock())
    with lock:
        lib = _SHAPE_LIBS.get(shape)
        if lib is None:
            out_dir = shape_dir(shape)
            lib_path = out_dir / LIB_NAME
            if not lib_path.exists():
                out_dir.parent.mkdir(parents=True, exist_ok=True)
                work = Path(tempfile.mkdtemp(prefix=out_dir.name + ".", dir=out_dir.parent))
                srcs, prefix, macros = _KINDS[kind]
                defines = [f"{prefix}{m}={v}" for m, v in zip(macros, _shape_ints(shape))]
                build(work, [CSRC / name for name in srcs], defines, niceness)
                out_dir.mkdir(exist_ok=True)
                os.replace(work / "build.log", out_dir / "build.log")
                os.replace(work / LIB_NAME, lib_path)
                shutil.rmtree(work, ignore_errors=True)
            lib = _SHAPE_LIBS[shape] = _load(lib_path)
    return lib


def prebuild_shapes(shapes, niceness: int = 10) -> list:
    """Start the builds of the shape libraries of `shapes` in background
    threads (each runs its nvcc processes in parallel, at `niceness`);
    returns the threads. A build's error is raised again by the
    `load_shape_library` call that later needs it."""
    def run(shape):
        try:
            load_shape_library(shape, niceness)
        except Exception:  # noqa: BLE001 - the caller's load_shape_library builds again and raises
            pass

    threads = [threading.Thread(target=run, args=(tuple(s),), daemon=True) for s in shapes]
    for t in threads:
        t.start()
    return threads


def build_log(shape: tuple | None = None) -> str:
    """The compiler output of the current build (registers, spills), or of
    the shape library of `shape`."""
    out_dir = BUILD_ROOT / source_hash() if shape is None else shape_dir(shape)
    path = out_dir / "build.log"
    return path.read_text() if path.exists() else ""


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.psvo_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
