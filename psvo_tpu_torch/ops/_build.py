"""Build and load the hand-written CUDA kernels of `psvo_tpu_torch/csrc/`.

At first use `nvcc` compiles every `csrc/*.cu` for Hopper (`sm_90a`), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which is loaded with `ctypes`. The
library goes to `psvo_tpu_torch/_build/<hash>/`, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.
A failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
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
    # K1 and K4 end in (..., off_f, off_g, cluster, stream): C CTAs per row
    "psvo_scan_forward": [_P] * 13 + [_U32, _U32] + [_I] * 12 + [_P],
    "psvo_scan_backward": [_P] * 17 + [_U32, _U32] + [_I] * 12 + [_P],
    # (kernel: 0 K1, 1 K4; dx, dy, hidden, cluster, smem bytes; int* out)
    "psvo_max_active_clusters": [_I] * 6 + [_P],
    # K2 ends in (..., K, design, stream): 0 the pair design, 1 the particle one
    "psvo_stream_noise": [_P, _P, _U32, _U32, _I, _I, _I, _I, _I, _P],
    "psvo_ancestor_indices": [_P, _P, _P, _I, _I, _P],
    # K5 ends in (..., dx, design, paths, chunk, stream): 0 the staged design, 1 the previous one
    "psvo_ffbsi_forward": [_P] * 13 + [_I] * 8 + [_P],
    # K6 ends in (..., dx, design, stream): 0 the staged design, 1 the row one
    "psvo_ffbsi_backward": [_P] * 18 + [_I] * 6 + [_P],
    # K7 and K11 end in (..., design, ...plan, stream): 0 the new design, 1 the row one
    "psvo_ancestor_indices_large": [_P, _P, _P, _I, _I, _I, _I, _P],
    "psvo_gather_particles": [_P, _P, _P, _I, _I, _I, _P],
    # K9 ends in (..., off_g, design, pair, prefetch, stream): 0 the async design, 1 the tile one
    "psvo_trunk_forward": [_P] * 7 + [_U32, _U32] + [_I] * 14 + [_P],
    "psvo_segment_sum_scatter": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # K10 ends in (..., max_ctas, design, stream): 0 the tensor-core design, 1 the previous one
    "psvo_trunk_backward": [_P] * 13 + [_U32, _U32] + [_I] * 13 + [_P],
    # K12 ends in (..., off_g, design, paths, tile_rows, steps, stream): 0 the split design, 1 the chain
    "psvo_svo_forward": [_P] * 9 + [_I] * 14 + [_P],
    # K13 ends in (..., max_ctas, design, tile_rows, paths, stream): 0 the split design, 1 the chain
    "psvo_svo_backward": [_P] * 13 + [_I] * 14 + [_P],
    # K14 and K15: (..., counter, B, ..., off_g, slices, stream): S CTAs per row
    "psvo_step_forward": [_P] * 12 + [_I] * 10 + [_P],
    "psvo_step_backward": [_P] * 18 + [_I] * 10 + [_P],
    # (kernel: 0 K14, 1 K15; dx, dy, hidden, smem bytes; int* out)
    "psvo_step_max_active": [_I] * 5 + [_P],
}

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


def build(out_dir: Path) -> Path:
    """Compile each csrc/*.cu into an object, in parallel, and link them into
    out_dir/LIB_NAME (atomically); return its path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
               str(out_dir / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n{out}")
        if proc.returncode != 0:
            failed.append(out)
    compile_s = time.perf_counter() - t0
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    if not failed:
        cmd = [nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp,
               *[str(out_dir / f"{src.stem}.o") for src in sorted(CSRC.glob("*.cu"))]]
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
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "\n".join(f[-8000:] for f in failed))
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once per process
    (the sources are hashed once, not per launch); argtypes declared."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        build(out_dir)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.psvo_error_string.argtypes = [ctypes.c_int]
    lib.psvo_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """The compiler output of the current build (registers, spills)."""
    path = BUILD_ROOT / source_hash() / "build.log"
    return path.read_text() if path.exists() else ""


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.psvo_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
