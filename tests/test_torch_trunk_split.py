"""The host side of K10's tensor-core design, and the arithmetic it rests on.

K10 (`ops/trunk.py::trunk_backward`, `csrc/trunk_backward.cu`) runs its
backward products on the tensor cores in 3xTF32: each float32 operand is
split as a = hi + lo with hi = tf32(a) rounded to nearest and lo = a − hi,
which the tensor core reads truncated to TF32, and a·b is taken as hi·hi +
hi·lo + lo·hi (`csrc/mma_tf32.cuh`). None of this needs the card: the
shared-memory layout and the gates are pure functions of the shapes, and
the split is emulated here in torch (round to nearest, ties away, to 10
mantissa bits, as `cvt.rna.tf32.f32` and the kernel's integer version of
it do; lo truncated) at the shapes of K10's stages. The kernel itself is
held to its plain version and to the previous design on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phase s).

K9's async design (`ops/trunk.py::trunk_forward`, `csrc/trunk_forward.cu`)
has its host side here too: its shared memory and the parts of it that fit
(`k9_plan`), the unchanged class of `trunk.usable`, the design argument
and its ctypes signature; its bits against the tile design are checked on
the card (`tests/test_torch_cuda.py`, `chip_smoke.py` phase p).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from psvo_tpu_torch.ops import _build, trunk
from psvo_tpu_torch.ops.fused_step import SMEM_LIMIT

torch.set_num_threads(1)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero on the magnitude: cvt.rna.tf32.f32 for finite x."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _truncate(x: torch.Tensor) -> torch.Tensor:
    """The tensor core's reading of a float32 operand as TF32: its 13 low
    mantissa bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores take it: one TF32 pass (hi·hi), or three
    (hi·hi + hi·lo + lo·hi, the big and the cross terms in separate float32
    accumulators as in mma_3xtf32). Products of TF32 values are exact in
    float64; each accumulator is rounded to float32."""
    ah, bh = _tf32(a), _tf32(b)
    big = (ah.double() @ bh.double()).float()
    if passes == 1:
        return big
    al, bl = _truncate(a - ah), _truncate(b - bh)
    small = (ah.double() @ bl.double() + al.double() @ bh.double()).float()
    return big + small


def _rel(got, want) -> float:
    return float((got.double() - want).norm() / want.norm())


# (M, N, K) of K10's stages at Dx = 40: the input cotangents (M = the tile's
# 64 particles, N = the layer's input width, K = its output width) and the
# weight gradients (M = the hidden width, N = 40 or the hidden width, K = the
# 64 particles)
STAGE_SHAPES = [(64, 40, 64), (64, 64, 64), (64, 40, 40), (64, 16, 40), (64, 32, 40),
                (16, 40, 64), (32, 40, 64), (32, 32, 64), (16, 16, 64)]


@pytest.mark.parametrize("m,n,k", STAGE_SHAPES)
def test_three_tf32_passes_keep_float32_accuracy(m, n, k):
    """3xTF32 within 1e-6 relative L2 of the float64 product; one TF32 pass
    beyond 1e-4, the gate K10 is held to at small size, which is why the
    kernel splits its operands."""
    rng = np.random.default_rng(m * 10000 + n * 100 + k)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    want = a.double() @ b.double()
    assert _rel(_product(a, b, 3), want) <= 1e-6
    assert _rel(_product(a, b, 1), want) > 1e-4


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulated cvt.rna: 10 mantissa bits kept, a tie rounds away from
    zero on either sign; hi + lo with lo truncated reproduces the value to
    2^-21."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4, 1.5],
                     dtype=torch.float32)
    assert _tf32(x).tolist() == [one + ulp, -(one + ulp), one, one + ulp, 1.5]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    hi = _tf32(y)
    lo = _truncate(y - hi)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi.double() + lo.double() - y.double()).abs() / y.double().abs()).max()) \
        <= 2.0 ** -21


def _padded_net(din, h, n_mid, dout):
    n = din * (h + 4) + h + n_mid * (h * (h + 4) + h) + h * (dout + 4) + dout
    return n + (-n) % 4


@pytest.mark.parametrize("hidden,want", [(16, 103024), (32, 138736), (64, 228592)])
def test_k10_shared_memory_at_lorenz96(hidden, want):
    """The tensor-core layout at Dx = Dy = 40, one middle layer: the weights
    with every row padded by 4 floats, six tiles and two hidden layers at a
    stride of 72 floats, the α parts, dα and the coefficients; within one
    CTA's 232,448 bytes at every width (at 64 by 3,856 bytes)."""
    rows = 5 * 40 + 40 + 2 * hidden
    count = 4 * (3 * _padded_net(40, hidden, 1, 40) + rows * 72 + 5 * 64 + 164)
    assert trunk.k10_smem_bytes(40, 40, hidden, 1) == count == want
    assert want <= SMEM_LIMIT
    assert trunk.k10_ok(40, 40, hidden, 1, 8192)
    assert trunk.k10_ok(40, 40, hidden, 1, 8192, "simt")
    # the padding and the wider stride cost 5.9–14 KB over the previous design
    assert 0 < want - trunk.k10_smem_bytes(40, 40, hidden, 1, "simt") <= 14 * 1024


@pytest.mark.parametrize("dx,dy,hidden,n_mid,k", [
    (40, 40, 64, 2, 8192),   # three hidden layers of 64: 300,016 bytes
    (40, 40, 48, 1, 8192),   # a width that is not instantiated
    (40, 40, 64, 1, 8160),   # K not a multiple of the 64-particle tile
    (3, 3, 64, 1, 1024),     # not the Lorenz-96 dims
])
def test_k10_gate_refuses_outside_its_class(dx, dy, hidden, n_mid, k):
    assert not trunk.k10_ok(dx, dy, hidden, n_mid, k)


def test_unknown_design_raises():
    with pytest.raises(ValueError, match="no design"):
        trunk.k10_smem_bytes(40, 40, 64, 1, "tf32")
    x = torch.zeros((1, 40, 64))
    with pytest.raises(ValueError, match="no design"):
        trunk.trunk_backward(x, x, torch.zeros((1, 161)), {}, x, torch.zeros((1, 64)), eps=x,
                             design="bf16")


def test_ctypes_signature_carries_the_design():
    """psvo_trunk_backward's argtypes match its C parameters (pointers and
    the stream c_void_p, seeds c_uint32, ints c_int), with the design last
    before the stream; the wrapper passes DESIGNS' index (0 the tensor-core
    kernel, 1 the previous one)."""
    src = (_build.CSRC / "trunk_backward.cu").read_text()
    m = re.search(r'extern "C" int psvo_trunk_backward\((.*?)\)\s*\{', src, re.S)
    params = [tuple(p.strip().rsplit(None, 1)) for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in t else ctypes.c_uint32 if t == "uint32_t" else ctypes.c_int
            for t, _ in params]
    assert _build.SIGNATURES["psvo_trunk_backward"] == want
    assert [n for _, n in params][-3:] == ["max_ctas", "design", "stream"]
    assert trunk.DESIGNS == ("tf32x3", "simt")
    assert "design == 0" in src and "trunk_backward_tf32x3_kernel" in src


@pytest.mark.parametrize("hidden,pair_prefetch,want", [(16, (True, True), 99456),
                                                       (32, (True, True), 140800),
                                                       (64, (True, True), 231680),
                                                       (64, (False, False), 188016)])
def test_k9_shared_memory_at_lorenz96(hidden, pair_prefetch, want):
    """K9's async design at Dx = Dy = 40, one middle layer: the tile design's
    bytes, plus f's two hidden layers (pair), a second ε tile, a second row
    of 164 coefficients and, where f's spare hidden layer is narrower than
    Dy = 40, a tile for g's mean (prefetch). Both parts fit at every width,
    at hidden 64 with 768 bytes to spare; without them it is the tile
    design's layout."""
    pair, prefetch = pair_prefetch
    own_gm = prefetch and not (pair and hidden >= 40)
    extra = (2 * hidden if pair else 0) + (40 if prefetch else 0) + (40 if own_gm else 0)
    assert trunk.k9_smem_bytes(40, 40, hidden, 1, pair, prefetch) == want
    assert want == (trunk.smem_bytes(40, 40, hidden, 1) + 4 * 64 * extra
                    + (4 * 164 if prefetch else 0)) <= SMEM_LIMIT
    assert trunk.k9_plan(40, 40, hidden, 1) == (True, True)
    if hidden == 64:
        assert SMEM_LIMIT - trunk.k9_smem_bytes(40, 40, 64, 1) == 768


def _l96_ssm(hidden, n_mid):
    from psvo_tpu_torch.config import PRESETS, NetConfig
    from psvo_tpu_torch.models.ssm import SSM

    net = NetConfig(hidden=(hidden,) * (n_mid + 1))
    cfg = PRESETS["lorenz96_fivo_k8192_sharded"]
    return SSM(cfg.with_nets(q0=net, q1=net, q2=net, f=net, qb=net, g=net)), cfg.smc


# the widest n_mid trunk.usable admitted before the async design, per width
_TRUNK_CLASS = {16: 50, 32: 11, 64: 1}
_TRUNK_CASES = [(h, n_mid, n_mid <= top) for h, top in _TRUNK_CLASS.items()
                for n_mid in sorted({0, 1, top - 2, top - 1, top, top + 1}) if n_mid >= 0]


@pytest.mark.parametrize("hidden,n_mid,admitted", _TRUNK_CASES)
def test_trunk_usable_class_is_unchanged(hidden, n_mid, admitted):
    """trunk.usable admits exactly the shapes it admitted before the async
    design (n_mid up to 50, 11 and 1 at widths 16, 32 and 64), and for each
    the async design finds a plan that fits: the parts that fit, down to
    the tile design's layout (at hidden 32, n_mid 10 and 11)."""
    ssm, smc = _l96_ssm(hidden, n_mid)
    assert trunk.usable(ssm, smc) == admitted
    if admitted:
        pair, prefetch = trunk.k9_plan(40, 40, hidden, n_mid)
        assert trunk.k9_smem_bytes(40, 40, hidden, n_mid, pair, prefetch) <= SMEM_LIMIT
        assert trunk.k9_smem_bytes(40, 40, hidden, n_mid, False, False) == trunk.smem_bytes(
            40, 40, hidden, n_mid)
        if (hidden, n_mid) in ((32, 10), (32, 11), (16, 50)):
            assert (pair, prefetch) == (False, False)


def test_unknown_k9_design_raises():
    x = torch.zeros((1, 40, 64))
    with pytest.raises(ValueError, match="no design"):
        trunk.trunk_forward(x, torch.zeros((1, 161)), {}, eps=x, design="simt")


def test_k9_ctypes_signature_carries_the_design():
    """psvo_trunk_forward's argtypes match its C parameters, with the design
    and the async design's two parts last before the stream; design 0 is the
    async kernel (K9_DESIGNS[0]), 1 the tile one."""
    src = (_build.CSRC / "trunk_forward.cu").read_text()
    m = re.search(r'extern "C" int psvo_trunk_forward\((.*?)\)\s*\{', src, re.S)
    params = [tuple(p.strip().rsplit(None, 1)) for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in t else ctypes.c_uint32 if t == "uint32_t" else ctypes.c_int
            for t, _ in params]
    assert _build.SIGNATURES["psvo_trunk_forward"] == want
    assert [n for _, n in params][-4:] == ["design", "pair", "prefetch", "stream"]
    assert trunk.K9_DESIGNS == ("async", "tile")
    assert "design == 0" in src and "trunk_forward_async_kernel" in src
