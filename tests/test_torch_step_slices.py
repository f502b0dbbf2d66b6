"""The host side of K14 and K15 on S CTAs per trajectory row (`fused_step`).

Each row of the per-step kernels runs on S CTAs that form no cluster;
`step_slices` picks S from the card's count of resident CTAs, and the gates
decide which S and K a kernel takes. None of this needs the card: the
choice is a pure function of the occupancy count, and the gates of the
constants' shapes. The kernels themselves are held to S = 1 on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phase ae).
"""

import ctypes
import re

import pytest
import torch

from psvo_tpu_torch.config import PRESETS
from psvo_tpu_torch.models.ssm import init_ssm
from psvo_tpu_torch.ops import _build, fused_step

torch.set_num_threads(1)

H100_RESIDENT = 132  # one CTA of K14 or K15 per SM


@pytest.mark.parametrize("batch,k,min_slice,resident,want", [
    (32, 1024, fused_step.K1_MIN_SLICE, H100_RESIDENT, 4),  # K14 on the FHN and PSVO rows
    (32, 1024, fused_step.K4_MIN_SLICE, H100_RESIDENT, 4),  # K15 there: 8 would need 256 CTAs
    (8, 1024, fused_step.K4_MIN_SLICE, H100_RESIDENT, 8),   # fewer rows: more slices fit
    (8, 1024, fused_step.K1_MIN_SLICE, H100_RESIDENT, 4),   # K14 needs 256 particles a slice
    (32, 128, fused_step.K1_MIN_SLICE, H100_RESIDENT, 1),   # K does not split
    (32, 96, fused_step.K4_MIN_SLICE, H100_RESIDENT, 1),    # nor here (not a multiple of 64)
    (32, 1024, fused_step.K4_MIN_SLICE, 100, 2),            # capped by the resident count
    (32, 1024, fused_step.K4_MIN_SLICE, 2 * H100_RESIDENT, 8),  # two CTAs per SM
    (200, 1024, fused_step.K4_MIN_SLICE, H100_RESIDENT, 1),  # no S fits in one wave
])
def test_step_slices_picks_the_largest_one_wave_split(batch, k, min_slice, resident, want):
    assert fused_step.step_slices(batch, k, min_slice, resident) == want


def _consts(preset, hidden=None):
    """prepare()'s constants of the preset, or (hidden given) their shapes
    at another width of one middle layer: only the shapes matter to the gates."""
    ssm = init_ssm(PRESETS[preset], torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
    if hidden is None:
        return consts
    d = consts["dx"]
    per_net = d * hidden + hidden + hidden * hidden + hidden + hidden * d + d  # W1 b1 W2 b2 W3 b3
    return dict(consts, hidden=hidden, packed=torch.zeros(3 * (-(-per_net // 4) * 4)))


def _k15_bytes_one_cta_per_row(consts, k):
    """K15's shared memory with one CTA per row: the row's d x_res and ancestors inside."""
    dx, dy, h = consts["dx"], consts["dy"], consts["hidden"]
    floats = 2 * consts["packed"].numel() + 4 * h * 68 + (9 * dx + 2 * dy) * 68 + dx * k + 8
    return 4 * floats + 4 * k


@pytest.mark.parametrize("hidden", [16, 32, 64])
@pytest.mark.parametrize("preset", ["fhn_fivo_k1024_bench", "lorenz63_psvo_k1024"])
def test_k15_gate_is_no_narrower_than_one_cta_per_row(preset, hidden):
    consts = _consts(preset, hidden)
    for k in range(32, fused_step.MAX_K + 1, 32):
        assert fused_step.k15_smem_bytes(consts) <= _k15_bytes_one_cta_per_row(consts, k)
        before = fused_step._k_ok(k) and _k15_bytes_one_cta_per_row(consts, k) <= fused_step.SMEM_LIMIT
        assert fused_step._k15_ok(consts, k) >= before
        assert fused_step._k15_ok(consts, k) == fused_step._k_ok(k)  # no K-bound left


def test_k15_range_at_width_64():
    """At hidden (64, 64) one CTA per row admitted K up to 4096 at Dx = 2 and
    2560 at Dx = 3; K15 now keeps every K up to MAX_K at both widths."""
    for preset, before in (("fhn_fivo_k1024_bench", 4096), ("lorenz63_psvo_k1024", 2560)):
        consts = _consts(preset)
        assert consts["hidden"] == 64
        ks = range(256, fused_step.MAX_K + 1, 256)
        assert max(k for k in ks if _k15_bytes_one_cta_per_row(consts, k)
                   <= fused_step.SMEM_LIMIT) == before
        assert max(k for k in ks if fused_step._k15_ok(consts, k)) == fused_step.MAX_K >= before
    assert fused_step.k15_smem_bytes(_consts("fhn_fivo_k1024_bench")) == 183264
    assert fused_step.k15_smem_bytes(_consts("lorenz63_psvo_k1024")) == 189328


def _c_params(name):
    """(type, name) of each parameter of the C entry point `name` in csrc/."""
    for src in _build.CSRC.glob("*.cu"):
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src.read_text(), re.S)
        if m:
            return [tuple(p.strip().rsplit(None, 1)) for p in m.group(1).split(",")]
    raise AssertionError(f"{name} not found")


@pytest.mark.parametrize("name", ["psvo_step_forward", "psvo_step_backward",
                                  "psvo_step_max_active"])
def test_ctypes_signatures_carry_the_slices_and_the_counter(name):
    """Each argtypes list matches its C entry point (pointers and the stream
    c_void_p, ints c_int); the kernels' take the rows' counters as their last
    pointer and the slice count last before the stream."""
    params = _c_params(name)
    want = [ctypes.c_void_p if "*" in t else ctypes.c_int for t, _ in params]
    assert _build.SIGNATURES[name] == want
    names = [n for _, n in params]
    if name != "psvo_step_max_active":
        assert names[want.index(ctypes.c_int) - 1] == "counter"
        assert names[-2:] == ["slices", "stream"]


@pytest.mark.parametrize("kernel,slices,ok", [
    (0, 1, True), (0, 2, True), (0, 4, True), (0, 8, False), (0, 3, False), (0, 0, False),
    (1, 8, True), (1, 16, False), (1, 6, False),
])
def test_a_forced_slice_count_is_checked(kernel, slices, ok):
    consts = _consts("fhn_fivo_k1024_bench")
    x = torch.zeros((32, 2, 1024))
    name = ("step_forward", "step_backward")[kernel]
    if ok:
        assert fused_step._pick_slices(name, kernel, x, consts, slices) == slices
    else:
        with pytest.raises(ValueError, match="no split"):
            fused_step._pick_slices(name, kernel, x, consts, slices)


def test_arrival_counters_are_allocated_once_per_stream():
    first = fused_step._arrival_counters(torch.device("cpu"), 12345, 4)
    assert first.dtype == torch.int32 and first.numel() == 4 and not first.any()
    assert fused_step._arrival_counters(torch.device("cpu"), 12345, 3) is first
    other = fused_step._arrival_counters(torch.device("cpu"), 54321, 4)
    assert other is not first
    grown = fused_step._arrival_counters(torch.device("cpu"), 12345, 8)
    assert grown.numel() == 8 and not grown.any()
    assert fused_step._arrival_counters(torch.device("cpu"), 12345, 4) is grown


@pytest.mark.parametrize("slices", [1, 4, 3])
def test_cpu_tensors_take_the_plain_version_whatever_the_slices(slices):
    consts = _consts("fhn_fivo_k1024_bench")
    g = torch.Generator().manual_seed(1)
    b, k = 2, 256
    x = torch.randn((b, 2, k), generator=g)
    lw = torch.randn((b, k), generator=g)
    coef = torch.rand((b, 9), generator=g) + 0.1
    eps = torch.randn((b, 2, k), generator=g)
    pos = fused_step.systematic_positions(torch.rand((b,), generator=g), k)
    launches = (fused_step.step_forward.launches, fused_step.step_backward.launches)
    calls = (fused_step.step_forward_reference.calls, fused_step.step_backward_reference.calls)
    with torch.no_grad():
        got = fused_step.step_forward(x, lw, coef, consts, eps, pos, slices=slices)
        want = fused_step.step_forward_reference(x, lw, coef, consts, eps, pos)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    x_new, alpha, stats, idx = got
    d_stats = torch.randn(stats.shape, generator=g)
    d_x_new = torch.randn(x_new.shape, generator=g)
    bwd = fused_step.step_backward(x, x_new, idx, stats, coef, consts, eps, d_stats, d_x_new,
                                   slices=slices)
    ref = fused_step.step_backward_reference(x, coef, consts, eps, idx, d_stats, d_x_new)
    assert all(torch.equal(a, w) for a, w in zip(bwd, ref))
    assert (fused_step.step_forward.launches, fused_step.step_backward.launches) == launches
    assert (fused_step.step_forward_reference.calls,
            fused_step.step_backward_reference.calls) == (calls[0] + 2, calls[1] + 2)
