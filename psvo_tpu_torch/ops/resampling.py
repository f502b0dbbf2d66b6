"""Particle resampling, plain PyTorch (counterpart of `psvo_tpu/ops/resampling.py`).

Both schemes are inverse-CDF lookups a_i = #{j : C_j <= u_i} over the
inclusive CDF C of the normalized weights; they differ only in the sorted
positions u: systematic u_i = (i + u0)/K with one u0 per row, multinomial
sorted iid uniforms. The plain filter body uses these; the whole-scan
kernel (`ops/fused_step.py`) carries its own index search, and the trunk
path resamples through the large-K kernels (`ops/resample_gather.py`).
"""

from __future__ import annotations

import torch

from psvo_tpu_torch.distributions import effective_sample_size, log_normalize


def quantile_positions_from_raw(u_raw, k: int, method: str):
    """[..., K] inverse-CDF positions in [0, 1), sorted along K: from [...]
    offsets (systematic) or [..., K] iid uniforms (multinomial)."""
    if method == "systematic":
        i = torch.arange(k, dtype=torch.float32, device=u_raw.device)
        return (i + u_raw[..., None]) / k
    if method == "multinomial":
        return torch.sort(u_raw, dim=-1).values
    raise ValueError(f"unknown resampling method {method!r}")


def bulk_positions(generator, t_steps: int, batch: int, k: int, method: str):
    """[T, B, K] positions for a whole filtering pass, one draw."""
    dev = generator.device
    if method == "systematic":
        u_raw = torch.rand((t_steps, batch), generator=generator, device=dev)
    else:
        u_raw = torch.rand((t_steps, batch, k), generator=generator, device=dev)
    return quantile_positions_from_raw(u_raw, k, method)


def inverse_cdf_indices(cumw, u):
    """a_i = #{j : C_j <= u_i} per batch row (searchsorted, right side),
    clipped to [0, K-1]. cumw [B, K] inclusive CDF, u [B, K] positions."""
    idx = torch.searchsorted(cumw.contiguous(), u.contiguous(), right=True)
    return torch.clamp(idx, max=cumw.shape[-1] - 1).to(torch.int32)


def systematic_indices_histogram(cumw, u0):
    """O(K) systematic ancestors: for positions (i + u0)/K,
    a_i = #{j : ceil(K·C_j − u0) <= i}, so bucket each particle at
    v_j = ceil(K·C_j − u0) and prefix-sum the histogram. The reference's
    plain path uses this form; at a boundary it can land one index away
    from the count form `inverse_cdf_indices` computes in float32.

    cumw [B, K] inclusive normalized CDF; u0 [B] in [0, 1).
    """
    batch, k = cumw.shape
    v = torch.ceil(k * cumw - u0[:, None]).to(torch.int64)
    v = torch.clamp(v, 0, k)  # v == k: past the last position, never drawn
    hist = torch.zeros((batch, k + 1), dtype=torch.int64, device=cumw.device)
    hist.scatter_add_(1, v, torch.ones_like(v))
    idx = torch.cumsum(hist[:, :k], dim=-1)
    return torch.clamp(idx, max=k - 1).to(torch.int32)


def gather_particles(x, idx):
    """x [B, D, K], idx [B, K] -> x[b, d, idx[b, k]]."""
    index = idx.long()[:, None, :].expand(-1, x.shape[1], -1)
    return torch.gather(x, -1, index)


def maybe_resample(u, logw, x, *, method: str = "systematic", ess_threshold: float = 1.0,
                   use_kernel: bool = False):
    """ESS-adaptive resampling for one step (channel-major x [B, D, K]).

    u [B, K] are the step's sorted positions. Returns (x_out, logw_out,
    did_resample [B] bool, ess [B], idx [B, K]); resampled rows restart from
    log-weight 0. ess_threshold >= 1 resamples every row unconditionally.
    The indices and the gather run through the large-K kernels K7/K8
    (`ops.resample_gather`, the reference's use_pallas) for CUDA tensors or
    when use_kernel asks for them (their plain versions on the CPU, with the
    count form's index semantics); otherwise the plain histogram form.
    """
    batch, k = logw.shape
    ess = effective_sample_size(logw, dim=-1)
    if use_kernel or logw.is_cuda:
        # imported here: resample_gather imports this module
        from psvo_tpu_torch.ops import resample_gather

        idx, x_res = resample_gather.resample_and_gather(u, logw, x)
    else:
        logw_norm, _ = log_normalize(logw, dim=-1)
        cumw = torch.cumsum(torch.exp(logw_norm), dim=-1)
        if method == "systematic":
            # recover the shared offset from the first affine position
            idx = systematic_indices_histogram(cumw, u[:, 0] * k)
        else:
            idx = inverse_cdf_indices(cumw, u)
        x_res = gather_particles(x, idx)
    if ess_threshold >= 1.0:
        # every row resamples: no selection to make
        do = torch.ones((batch,), dtype=torch.bool, device=logw.device)
        return x_res, torch.zeros_like(logw), do, ess, idx
    do = ess / k < ess_threshold
    x_out = torch.where(do[:, None, None], x_res, x)
    logw_out = torch.where(do[:, None], torch.zeros_like(logw), logw)
    return x_out, logw_out, do, ess, idx
