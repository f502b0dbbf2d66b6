"""Large-K resampling kernels and their plain versions (counterpart of the
forward of `psvo_tpu/ops/pallas_resample.py::resample_and_gather` above its
fused cap).

Two hand-written CUDA kernels (`csrc/resample_gather.cu`), each behind a
wrapper that launches it for CUDA tensors and runs its plain PyTorch version
for CPU tensors — never the plain version on the card:

- K7 `ancestor_indices_large` (replaces `pallas_resample._indices_large`):
  logw [B, K] and sorted positions [B, K] -> int32 ancestors, the count form
  of `fused_step.count_form_indices` on an fp64 CDF (one CTA per row; the
  shared memory holds K up to `MAX_K` = 19200). Plain version:
  `ancestor_indices_large_reference`.
- K8 `gather_particles` (replaces the gather half of
  `pallas_resample._win_pallas_call`, with the compact branch and the XLA
  fallback of `_win_gather`): x [B, D, K] -> x[b, d, idx[b, k]]. Plain
  version: `gather_particles_reference` (`resampling.gather_particles`).

`resample_and_gather` runs both. Launch counts are `<wrapper>.launches`,
plain-version call counts `.calls`. The reference's index branch (an MXU
cumsum in float32 and a two-level count) can land one index away from the
count form at a CDF boundary tie; the two kernels here agree with their
plain versions exactly.
"""

from __future__ import annotations

import torch

from psvo_tpu_torch.ops import _build
from psvo_tpu_torch.ops.fused_step import SMEM_LIMIT, _require, count_form_indices
from psvo_tpu_torch.ops.resampling import gather_particles as _gather_plain

_THREADS = 256


def k7_smem_bytes(k: int) -> int:
    """Dynamic shared memory of K7: the fp64 CDF and the fp32 log-weights,
    plus one reduction slot per warp for each."""
    return 12 * (k + _THREADS // 32)


MAX_K = 19200  # the largest K with K % 256 == 0 and k7_smem_bytes(K) <= SMEM_LIMIT


def k_ok(k: int) -> bool:
    """K7's block scan: K <= threads, or whole chunks of K / threads per
    thread, and the row in shared memory."""
    return k >= 1 and (k <= _THREADS or k % _THREADS == 0) and k7_smem_bytes(k) <= SMEM_LIMIT


def ancestor_indices_large_reference(logw, positions):
    """Plain version of K7: the count form on an fp64 CDF."""
    ancestor_indices_large_reference.calls += 1
    return count_form_indices(logw, positions)


ancestor_indices_large_reference.calls = 0


def ancestor_indices_large(logw, positions):
    """K7: logw [B, K] f32, sorted positions [B, K] f32 in [0, 1) -> int32
    ancestors [B, K], nondecreasing along K."""
    if logw.device.type == "cpu":
        return ancestor_indices_large_reference(logw, positions)
    if logw.device.type != "cuda":
        raise ValueError(f"ancestor_indices_large: unsupported device {logw.device}")
    batch, k = logw.shape
    _require(logw, (batch, k), "logw", logw.device)
    _require(positions, (batch, k), "positions", logw.device)
    if not k_ok(k):
        raise ValueError(f"ancestor_indices_large: no kernel for K={k} (K <= {_THREADS} or a "
                         f"multiple of it, at most {MAX_K})")
    lib = _build.load_library()
    idx = torch.empty((batch, k), dtype=torch.int32, device=logw.device)
    stream = torch.cuda.current_stream(logw.device).cuda_stream
    err = lib.psvo_ancestor_indices_large(logw.data_ptr(), positions.data_ptr(), idx.data_ptr(),
                                          batch, k, stream)
    ancestor_indices_large.launches += 1
    _build.check(lib, err, "ancestor_indices_large")
    return idx


ancestor_indices_large.launches = 0


def gather_particles_reference(x, idx):
    """Plain version of K8."""
    gather_particles_reference.calls += 1
    return _gather_plain(x, idx)


gather_particles_reference.calls = 0


def gather_particles(x, idx):
    """K8: x [B, D, K] f32, idx int32 [B, K] in [0, K) -> [B, D, K]."""
    if x.device.type == "cpu":
        return gather_particles_reference(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"gather_particles: unsupported device {x.device}")
    batch, d, k = x.shape
    _require(x, (batch, d, k), "x", x.device)
    _require(idx, (batch, k), "idx", x.device, torch.int32)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("gather_particles: the kernel records no gradient (its scatter "
                           "backward is not written yet); call it under torch.no_grad()")
    lib = _build.load_library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.psvo_gather_particles(x.data_ptr(), idx.data_ptr(), out.data_ptr(), batch, d, k,
                                    stream)
    gather_particles.launches += 1
    _build.check(lib, err, "gather_particles")
    return out


gather_particles.launches = 0


def resample_and_gather(u, logw, x):
    """Ancestors and resampled particles of one step: u [B, K] sorted
    positions, logw [B, K], x [B, D, K] -> (idx int32 [B, K], x_res [B, D, K]),
    through K7 and K8 (their plain versions for CPU tensors, where x_res
    carries x's gradient)."""
    idx = ancestor_indices_large(logw.contiguous(), u.contiguous())
    return idx, gather_particles(x.contiguous(), idx)
