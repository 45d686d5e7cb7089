"""The rounding premise of the port's bf16-compute kernels, on the CPU.

``Bf16Math`` (``heat3d_tpu_torch/csrc/stencil_common.cuh``) adds and
multiplies bf16 values with the card's native ``add.rn.bf16x2`` /
``mul.rn.bf16x2``: one round-to-nearest-even of the exact result. The plain
version (``ops.stencil_eager`` in bf16 compute, eager PyTorch) computes each
bf16 op in float32 and rounds that to bf16. The kernels equal the plain
version bitwise only if the two roundings agree for every pair of bf16
values, subnormals, signed zeros, infinities and overflow included. These
tests check that over a seeded sample of about 10^6 pairs, against the
exact result computed in float64 and rounded by this file's own
round-to-nearest-even. (A float64 sum of two bf16 values is exact unless
their exponents lie more than 44 apart; then the smaller one lies far
below half a bf16 ulp of the larger and both roundings return the larger.
A product of two bf16 values is always exact in float64.)
"""

import numpy as np
import pytest
import torch

OPS = {"add": np.add, "mul": np.multiply}
N_RANDOM = 1 << 20

# bf16 bit patterns at the edges of the format
SPECIAL_BITS = np.array([
    0x0000, 0x8000,                  # +0, -0
    0x0001, 0x8001, 0x0002, 0x0055,  # subnormals, the least first
    0x007f, 0x807f,                  # the largest subnormals
    0x0080, 0x8080, 0x0081,          # the least normals
    0x3f80, 0xbf80, 0x3f81, 0x4040,  # 1, -1, 1 + ulp, 3
    0x7f7e, 0x7f7f, 0xff7f,          # the largest finite values
    0x7f00, 0x7e80,                  # sums of two of these overflow
    0x7f80, 0xff80,                  # +inf, -inf
], dtype=np.uint16)


def _bf16_to_f64(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _quantum(ax: np.ndarray) -> np.ndarray:
    """The bf16 ulp at finite nonzero magnitudes ``ax`` (2^-133 below the
    normals)."""
    _, e2 = np.frexp(ax)  # ax = m 2^e2, m in [0.5, 1)
    return np.ldexp(1.0, np.maximum(e2 - 1, -126) - 7)


def _rne_bf16(x: np.ndarray) -> np.ndarray:
    """float64 values rounded to bf16 (round to nearest, ties to even;
    subnormals down to 2^-133; overflow to infinity), as bf16 bits."""
    out = x.copy()
    fin = np.isfinite(x) & (x != 0)
    ax = np.abs(x[fin])
    quantum = _quantum(ax)
    r = np.round(ax / quantum) * quantum  # np.round: ties to even
    r[r >= 2.0**128] = np.inf
    out[fin] = np.copysign(r, x[fin])
    return (out.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _exact(op: str, fa: np.ndarray, fb: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore", invalid="ignore"):
        return OPS[op](fa, fb)


def _pairs(seed: int = 21):
    """bf16 bit pairs: uniform bit patterns (every class of value), pairs
    whose exponents lie close (the roundings that carry), pairs around the
    subnormal and overflow ranges, and every pair of ``SPECIAL_BITS``."""
    rng = np.random.default_rng(seed)
    third = N_RANDOM // 3
    uniform = rng.integers(0, 1 << 16, size=(third, 2), dtype=np.uint16)
    sign = rng.integers(0, 2, size=(third, 2), dtype=np.uint16) << 15
    exp = rng.integers(1, 255, size=(third, 1), dtype=np.uint16)
    exp = np.clip(exp + rng.integers(-3, 4, size=(third, 2)), 0, 254).astype(np.uint16)
    close = sign | (exp << 7) | rng.integers(0, 128, size=(third, 2), dtype=np.uint16)
    # exponents whose products land subnormal, or sums and products overflow
    edge_exp = rng.choice(np.r_[np.arange(0, 12), np.arange(56, 72), np.arange(243, 255)],
                          size=(third, 2)).astype(np.uint16)
    edge = sign | (edge_exp << 7) | rng.integers(0, 128, size=(third, 2), dtype=np.uint16)
    a, b = np.meshgrid(SPECIAL_BITS, SPECIAL_BITS)
    special = np.stack([a.ravel(), b.ravel()], axis=1)
    pairs = np.concatenate([uniform, close, edge, special])
    # no NaN operands: a NaN in gives a NaN out whatever the rounding
    nan = ((pairs & 0x7f80) == 0x7f80) & ((pairs & 0x007f) != 0)
    return pairs[~nan.any(axis=1)]


def _assert_same(got: np.ndarray, want: np.ndarray, a: np.ndarray, b: np.ndarray) -> None:
    """Equal bf16 bit patterns, a NaN equal to any NaN."""

    def isnan(bits):
        return ((bits & 0x7f80) == 0x7f80) & ((bits & 0x007f) != 0)

    bad = ~((got == want) | (isnan(got) & isnan(want)))
    idx = np.flatnonzero(bad)[:5]
    assert not bad.any(), [(hex(a[i]), hex(b[i]), hex(got[i]), hex(want[i])) for i in idx]


@pytest.fixture(scope="module")
def sample():
    pairs = _pairs()
    a, b = pairs[:, 0], pairs[:, 1]
    return a, b, _bf16_to_f64(a), _bf16_to_f64(b)


def test_sample_covers_the_edges(sample):
    """The sample holds subnormal, zero, infinite and largest finite
    operands, and results that are subnormal, zero, overflowing and tied."""
    a, b, fa, fb = sample
    assert len(a) > 900_000
    for bits in (0x0001, 0x8000, 0x7f7f, 0x7f80, 0xff80):
        assert (a == bits).any() and (b == bits).any(), hex(bits)
    subnormal = ((a & 0x7f80) == 0) & ((a & 0x7f) != 0)
    assert subnormal.sum() > 1000
    for op in OPS:
        exact = _exact(op, fa, fb)
        want = _rne_bf16(exact)
        finite = np.isfinite(exact)
        assert ((want & 0x7fff) == 0x7f80)[finite].sum() > 100, (op, "no overflow")
        assert (((want & 0x7f80) == 0) & ((want & 0x7f) != 0)).sum() > 100, (op, "no subnormal")
        assert ((want & 0x7fff) == 0).sum() > 100, (op, "no zero")
    # ties: exact sums halfway between two bf16 values
    s = _exact("add", fa, fb)
    s = np.abs(s[np.isfinite(s) & (s != 0)])
    assert (np.mod(s / _quantum(s), 1.0) == 0.5).sum() > 100


@pytest.mark.parametrize("op", sorted(OPS))
def test_float32_then_bf16_is_one_rounding(sample, op):
    """round_bf16(float32(a) op float32(b)), the plain version's and the
    first design's arithmetic, equals one round-to-nearest-even of the
    exact result: what add.rn.bf16x2 / mul.rn.bf16x2 compute."""
    a, b, fa, fb = sample
    want = _rne_bf16(_exact(op, fa, fb))
    with np.errstate(over="ignore", invalid="ignore"):
        f32 = OPS[op](fa.astype(np.float32), fb.astype(np.float32))
    got = torch.from_numpy(f32).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    _assert_same(got, want, a, b)


@pytest.mark.parametrize("op", sorted(OPS))
def test_eager_torch_bf16_op_is_one_rounding(sample, op):
    """Eager PyTorch's bf16 add and multiply on the CPU (the plain
    version's ops) equal the same one rounding."""
    a, b, fa, fb = sample
    want = _rne_bf16(_exact(op, fa, fb))
    ta = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    tb = torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)
    got = (ta + tb if op == "add" else ta * tb).view(torch.int16).numpy().view(np.uint16)
    _assert_same(got, want, a, b)


def test_zero_low_half_stays_zero():
    """The kernels hold a bf16 value as the float word (value, +0): the low
    half of every add and multiply is +0 op +0, which rounds to +0."""
    zero = np.zeros(1)
    for op in OPS:
        assert _rne_bf16(_exact(op, zero, zero))[0] == 0
