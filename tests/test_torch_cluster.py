"""The host side of K1 and K4 on thread-block clusters (`fused_step`).

Each trajectory row runs on a cluster of C CTAs; `cluster_size` picks C from
the card's occupancy, and the shared-memory gates decide which C and K a
kernel takes. None of this needs the card: the choice is a pure function of
the occupancy counts, and the gates of the constants' shapes. The kernels
themselves are held to C = 1 on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py` phase ad).
"""

import ctypes

import pytest
import torch

from psvo_tpu_torch.config import PRESETS
from psvo_tpu_torch.models.ssm import init_ssm
from psvo_tpu_torch.ops import _build, fused_step

torch.set_num_threads(1)

H100_LIKE = {1: 132, 2: 66, 4: 32, 8: 16}


@pytest.mark.parametrize("batch,k,min_slice,max_active,want", [
    (32, 1024, fused_step.K4_MIN_SLICE, H100_LIKE, 4),   # K4 on the FHN and PSVO rows
    (32, 1024, fused_step.K1_MIN_SLICE, H100_LIKE, 4),   # K1 there
    (8, 1024, fused_step.K4_MIN_SLICE, H100_LIKE, 8),    # fewer rows: larger clusters fit
    (32, 256, fused_step.K1_MIN_SLICE, H100_LIKE, 1),    # SVO's K = 256: one CTA per row
    (32, 1024, fused_step.K4_MIN_SLICE, {**H100_LIKE, 4: 30}, 2),  # 32 clusters of 4 do not fit
    (200, 1024, fused_step.K4_MIN_SLICE, H100_LIKE, 1),  # no C fits in one wave
])
def test_cluster_size_picks_the_largest_one_wave_cluster(batch, k, min_slice, max_active, want):
    assert fused_step.cluster_size(batch, k, min_slice, max_active) == want


def test_cluster_size_needs_k_to_split_into_whole_slices():
    # K1 at K = 512: C = 2 gives 256 particles per CTA, C = 4 only 128
    assert fused_step.cluster_size(8, 512, fused_step.K1_MIN_SLICE, H100_LIKE) == 2
    # K4 at K = 96 (not a multiple of 64): C = 1 only
    assert fused_step.cluster_size(8, 96, fused_step.K4_MIN_SLICE, H100_LIKE) == 1


def test_cluster_size_skips_clusters_that_do_not_fit():
    # K4 at Dx = 3, K = 2048: no room at C = 1 or 2 (max_active 0); several
    # waves at C = 4 beat none at all
    max_active = {1: 0, 2: 0, 4: 32, 8: 16}
    assert fused_step.cluster_size(32, 2048, fused_step.K4_MIN_SLICE, max_active) == 4
    assert fused_step.cluster_size(200, 2048, fused_step.K4_MIN_SLICE, max_active) == 4


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


def test_the_shapes_stand_in_for_prepare():
    for preset in ("fhn_fivo_k1024_bench", "lorenz63_psvo_k1024"):
        assert _consts(preset, 64)["packed"].numel() == _consts(preset)["packed"].numel()


def _k4_bytes_one_cta_per_row(consts, k):
    """K4's shared memory before clusters: the whole row's carry and d x_res."""
    dx, dy, h = consts["dx"], consts["dy"], consts["hidden"]
    floats = 2 * consts["packed"].numel() + 4 * h * 68 + (9 * dx + 2 * dy) * 68 + 2 * dx * k + 8
    return 4 * floats + 4 * k


@pytest.mark.parametrize("hidden", [16, 32, 64])
@pytest.mark.parametrize("preset", ["fhn_fivo_k1024_bench", "lorenz63_psvo_k1024"])
def test_k4_gate_at_one_cta_per_row_is_no_narrower(preset, hidden):
    consts = _consts(preset, hidden)
    for k in range(32, fused_step.MAX_K + 1, 32):
        assert fused_step.k4_smem_bytes(consts, k) == _k4_bytes_one_cta_per_row(consts, k)
        before = fused_step._k_ok(k) and _k4_bytes_one_cta_per_row(consts, k) <= fused_step.SMEM_LIMIT
        assert fused_step._k4_ok(consts, k) == before
        if before and k % (4 * fused_step.K4_MIN_SLICE) == 0:
            assert fused_step._k4_ok(consts, k, 4)  # a smaller carry: C = 4 fits wherever C = 1 did


def test_k4_range_at_width_64_and_its_widening_on_clusters():
    widths = {}
    for preset in ("fhn_fivo_k1024_bench", "lorenz63_psvo_k1024"):
        consts = _consts(preset)
        ks = range(256, fused_step.MAX_K + 1, 256)
        widths[consts["dx"]] = tuple(max(k for k in ks if fused_step._k4_ok(consts, k, c))
                                     for c in fused_step.CLUSTER_SIZES)
        assert fused_step._k4_class(consts, 2048)
    assert widths == {2: (2304, 2816, 4096, 4096), 3: (1536, 1792, 3072, 4096)}


def test_k1_shared_memory_admits_max_k():
    """K1 keeps the whole row in every CTA, double-buffered: about 214 KB at
    Dx = 3, K = MAX_K, hidden 64."""
    consts = _consts("lorenz63_psvo_k1024")
    assert consts["hidden"] == 64
    assert fused_step.k1_smem_bytes(consts, fused_step.MAX_K) == 219280 <= fused_step.SMEM_LIMIT
    assert fused_step.k1_smem_bytes(_consts("fhn_fivo_k1024_bench"), 1024) == 86672


def test_ctypes_signatures_carry_the_cluster_argument():
    sig = _build.SIGNATURES
    # ... n_mid, n_weights, off_f, off_g, ctrl, cluster, stream
    assert sig["psvo_scan_forward"] == [ctypes.c_void_p] * 13 + [ctypes.c_uint32] * 2 + (
        [ctypes.c_int] * 13) + [ctypes.c_void_p]
    assert sig["psvo_scan_backward"] == [ctypes.c_void_p] * 17 + [ctypes.c_uint32] * 2 + (
        [ctypes.c_int] * 13) + [ctypes.c_void_p]
    assert sig["psvo_max_active_clusters"] == [ctypes.c_int] * 7 + [ctypes.c_void_p]
    # the per-step kernels take no cluster: their rows' counters and a slice count instead
    assert sig["psvo_step_forward"] == [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


@pytest.mark.parametrize("kernel,cluster,ok", [
    (0, 1, True), (0, 2, True), (0, 4, True), (0, 8, False), (0, 3, False),
    (1, 8, True), (1, 16, False),
])
def test_a_forced_cluster_is_checked(kernel, cluster, ok):
    consts = _consts("fhn_fivo_k1024_bench")
    x0 = torch.zeros((32, 2, 1024))
    name = ("scan_forward", "scan_backward")[kernel]
    if ok:
        assert fused_step._pick_cluster(name, kernel, x0, consts, cluster) == cluster
    else:
        with pytest.raises(ValueError, match="no cluster"):
            fused_step._pick_cluster(name, kernel, x0, consts, cluster)


def test_cpu_tensors_take_the_plain_version_whatever_the_cluster():
    consts = _consts("fhn_fivo_k1024_bench")
    g = torch.Generator().manual_seed(1)
    b, k, t1 = 2, 256, 3
    x0 = torch.randn((b, 2, k), generator=g)
    a0 = torch.randn((b, k), generator=g)
    coef = torch.rand((t1, b, 9), generator=g) + 0.1
    eps = torch.randn((t1, b, 2, k), generator=g)
    pos = fused_step.systematic_positions(torch.rand((t1, b), generator=g), k)
    launches, calls = fused_step.scan_forward.launches, fused_step.scan_forward_reference.calls
    plain = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, save_res=True)
    forced = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, save_res=True,
                                     cluster=4)
    assert fused_step.scan_forward.launches == launches
    assert fused_step.scan_forward_reference.calls == calls + 2
    for a, w in zip(forced, plain):
        assert (a is None and w is None) or torch.equal(a, w)
    x_last, _, stats, x_all, _, idx = plain
    d_stats = torch.randn(stats.shape, generator=g)
    got = fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, eps=eps,
                                   cluster=8)
    want = fused_step.scan_backward_reference(x0, coef, consts, eps, idx, d_stats)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
