"""Build and load the hand-written CUDA kernels of `psvo_tpu_torch/csrc/`.

At first use `nvcc` compiles every `csrc/*.cu` for Hopper (`sm_90a`) into one
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills -> build.log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
# argtypes of each C entry point; every pointer and the stream are c_void_p
SIGNATURES = {
    "psvo_scan_forward": [_P] * 13 + [_U32, _U32] + [_I] * 11 + [_P],
    "psvo_scan_backward": [_P] * 17 + [_U32, _U32] + [_I] * 11 + [_P],
    "psvo_stream_noise": [_P, _P, _U32, _U32, _I, _I, _I, _I, _P],
    "psvo_ancestor_indices": [_P, _P, _P, _I, _I, _P],
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
    """Compile csrc/*.cu into out_dir/LIB_NAME (atomically); return its path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        f"$ {' '.join(cmd)}\n# {seconds:.1f} s, exit {proc.returncode}\n"
        f"{proc.stdout}{proc.stderr}"
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-8000:]}"
        )
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
