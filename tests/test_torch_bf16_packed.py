"""The packed bf16 walk of K1-bf16, K3-bf16 and K2-bf16
(csrc/raster_bf16x2.cuh, two pixels a thread in the lanes of a bf16x2
word), built for the CPU with g++, against the one-pixel BF16 walk
(csrc/raster_common.cuh with CT = BF16), and the premise that makes the
two agree on the card.

  * The premise: an add, sub or mul of two bf16 values computed in
    float32 and rounded to bf16 (round to nearest even) is the correctly
    rounded bf16 op. The reference rounds the float64 result to bf16 on
    its bits (float64 holds the exact product and, double-rounded, the
    exact sum: 53 >= 2 * 8 + 2), and, in the hypothesis test, the exact
    rational result. Operands: random bit patterns, ties, subnormals,
    large exponent gaps, values near the overflow threshold, +-0, +-inf
    and NaN; a NaN must come out a NaN (payloads are not compared, the
    card's packed ops give the canonical one). Exactly, bit for bit.
  * The host's packed type (its add2, sub2, mul2) on the same operands:
    bit for bit the same.
  * The packed walks' division-free cull test (lane_far_ray) implies the
    exact one on the chain's rounded rho2d and rho3d: no (pair, pixel)
    it culls is kept by the exact test, on every scene below, and it
    culls most of the walk.
  * The packed walk (the host library's _bf16 entry points: the forward
    walk and the sweep's first pass on 128 threads of two pixels, the
    reverse walk one pixel a thread on the packed chain's lane 0)
    against the one-pixel walk (_bf16_1px): out, stash, kexit
    and K2-bf16's gradient bit for bit, with SA on (2DGS) and SA off
    (3DGS attributes), normals on and off, all tiles and the coarse
    stride-3 subset at 48x64, pixel coordinates past 256 and 512 (a
    32x640 grid, where bf16 rounds them to even numbers and multiples of
    4), the opaque and degenerate scenes (triggers inside a block; p_z =
    0, NaN), and a ring of 2 records a pixel (-DGS_REC_CAP=2: K2's re-run
    of a block for its earlier records, on the packed chain).
"""
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_bf16 import wide_scene
from test_torch_raster import _build_host_math, _ptr, scene
from test_torch_raster_3dgs import scene_3dgs

import test_torch_raster_k1 as K


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_math(tmp_path_factory):
    return _build_host_math(tmp_path_factory)


@pytest.fixture(scope="module")
def host_math_ring2(tmp_path_factory):
    return _build_host_math(tmp_path_factory, "-DGS_REC_CAP=2")


class _Suffix:
    """The host library's entry points of one compute form under the f32
    ones' names."""

    def __init__(self, lib, suffix):
        self.lib, self.suffix = lib, suffix

    def __getattr__(self, name):
        return getattr(self.lib, name + self.suffix)


# ---------------------------------------------------------------------------
# the premise: float32 op, then bf16 rounding, is the correctly rounded op

BF16_MAX_BITS = 0x7F7F


def bf16_bits(n, rng):
    """n bf16 operands as float32: random bit patterns and edge cases."""
    rand = rng.integers(0, 1 << 16, n).astype(np.uint32)
    # exponents near 1, so that sums and products land near ties
    near = ((rng.integers(0x3F00, 0x4100, n) & 0xFFFF)).astype(np.uint32)
    edge = np.array([0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x0080, 0x00FF,
                     0x3F80, 0xBF80, 0x3F81, 0x3B80, 0x3380, 0x0D80, 0x7F7F,
                     0xFF7F, 0x7F7E, 0x7F00, 0x7F80, 0xFF80, 0x7FC0, 0xFFC1,
                     0x7F81, 0x4B80, 0x3300, 0x0100], np.uint32)
    b = np.concatenate([rand, near, edge])
    return (b << 16).view(np.float32)


def round_to_bf16(x):
    """float64 -> the nearest bf16 (ties to even), as float32; NaN stays
    NaN, beyond the largest bf16 rounds to inf."""
    x = np.asarray(x, np.float64)
    out = np.full(x.shape, np.nan)
    fin = np.isfinite(x)
    _, e = np.frexp(np.where(fin, x, 1.0))
    # 8 significant bits; below 2^-126 the subnormal quantum 2^-133
    q = np.ldexp(1.0, np.maximum(e, -125) - 8)
    r = np.round(np.where(fin, x, 0.0) / q) * q
    r = np.where(np.abs(r) >= 2.0 ** 128, np.copysign(np.inf, x), r)
    out[fin] = r[fin]
    out[np.isinf(x)] = x[np.isinf(x)]
    return out.astype(np.float32)


def f32_op_rounded(a, b):
    """The float32 add, sub and mul of a and b, each rounded to bf16 with
    PyTorch's float -> bfloat16 conversion."""
    with np.errstate(all="ignore"):
        r = [a + b, a - b, a * b]
    return [torch.tensor(x).to(torch.bfloat16).float().numpy() for x in r]


def exact_ops(a, b):
    with np.errstate(all="ignore"):
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        return [round_to_bf16(x) for x in (a64 + b64, a64 - b64, a64 * b64)]


def assert_same_bf16(got, want):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def operand_pairs(seed, n):
    rng = np.random.default_rng(seed)
    a, b = bf16_bits(n, rng), bf16_bits(n, rng)
    # every edge case against every other
    edge = bf16_bits(0, rng)
    ea, eb = np.meshgrid(edge, edge)
    # large exponent gaps: b = a * 2^-k for k = 1 .. 40, signs mixed
    k = rng.integers(1, 41, a.size)
    with np.errstate(all="ignore"):
        gap = round_to_bf16(a * np.ldexp(np.float32(1.0), -k)
                            * rng.choice([-1.0, 1.0], a.size))
    return (np.concatenate([a, ea.ravel(), a]),
            np.concatenate([b, eb.ravel(), gap]))


def test_f32_op_rounded_once_is_the_bf16_op():
    """The premise of the packed walk, on 3 x 200k operand pairs."""
    a, b = operand_pairs(0, 200000)
    for got, want in zip(f32_op_rounded(a, b), exact_ops(a, b)):
        assert_same_bf16(got, want)


def test_host_packed_ops_are_the_bf16_ops(host_math):
    """The host's two-lane type (csrc/raster_bf16x2.cuh's add2, sub2,
    mul2 without CUDA) gives the correctly rounded bf16 op too."""
    a, b = operand_pairs(1, 50000)
    n = a.size
    out = np.zeros(3 * n, np.float32)
    host_math.host_bf16x2_ops(_ptr(np.ascontiguousarray(a)),
                              _ptr(np.ascontiguousarray(b)), _ptr(out), n)
    for i, want in enumerate(exact_ops(a, b)):
        assert_same_bf16(out[i * n:(i + 1) * n], want)


def exact_bf16(fr):
    """A rational -> the nearest bf16 (ties to even), as a float."""
    if fr == 0:
        return 0.0
    sign = -1 if fr < 0 else 1
    m = abs(fr)
    e = m.numerator.bit_length() - m.denominator.bit_length()
    if Fraction(2) ** e > m:
        e -= 1
    # m in [2^e, 2^(e+1)): 8 significant bits, subnormal quantum 2^-133
    q = Fraction(2) ** (max(e, -126) - 7)
    n = m / q
    k = n.numerator // n.denominator
    rem = n - k
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and k % 2 == 1):
        k += 1
    v = k * q
    if v >= Fraction(2) ** 128:
        return sign * float("inf")
    return sign * float(v)


bf16_values = st.integers(0, 0xFFFF).filter(
    lambda b: (b & 0x7FFF) <= BF16_MAX_BITS).map(
    lambda b: float(np.array([b << 16], np.uint32).view(np.float32)[0]))


@settings(max_examples=3000, deadline=None, derandomize=True)
@given(bf16_values, bf16_values)
def test_f32_op_rounded_once_matches_exact_rationals(a, b):
    """The premise again, against the exact rational result, on finite
    operands hypothesis draws (shrinking towards the edge cases)."""
    fa, fb = Fraction(a), Fraction(b)
    got = f32_op_rounded(np.float32([a]), np.float32([b]))
    for g, want in zip(got, (fa + fb, fa - fb, fa * fb)):
        w = np.float32(exact_bf16(want))
        if w == 0.0:
            # the sign of an exact zero: IEEE's, which float32 gives too
            assert g[0] == 0.0
        else:
            assert g[0].view(np.int32) == w.view(np.int32), (a, b, g, w)


# ---------------------------------------------------------------------------
# the packed walk against the one-pixel walk, bit for bit


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def compare_walks(lib, pattrs, ts, te, ids, tiles_x, use_sa, nn):
    packed = K.run_all(_Suffix(lib, "_bf16"), pattrs, ts, te, ids, tiles_x,
                       use_sa, nn)
    one = K.run_all(_Suffix(lib, "_bf16_1px"), pattrs, ts, te, ids, tiles_x,
                    use_sa, nn)
    for name, p, o in zip(("out", "stash", "kexit", "grad"), packed, one):
        np.testing.assert_array_equal(_bits(p), _bits(o), err_msg=name)
    return packed


def scene_args(name):
    if name == "2dgs 48x64":
        grid, ts, te, pattrs, _ = scene(2, 1300)
    elif name == "3dgs 48x64":
        grid, ts, te, pattrs, _ = scene_3dgs(4, 900, False)
    else:
        grid, ts, te, pattrs, _ = wide_scene(5, 1500)
    return grid, ts.astype(np.int32), te.astype(np.int32), pattrs


CASES = [("2dgs 48x64", True, False, False), ("2dgs 48x64", True, True, True),
         ("2dgs 48x64", False, True, False), ("3dgs 48x64", False, False, False),
         ("3dgs 48x64", False, True, True), ("32x640", True, False, False),
         ("32x640", False, True, True)]


@pytest.mark.parametrize("name,use_sa,nn,subset", CASES)
def test_packed_walk_is_the_one_pixel_walk(host_math, name, use_sa, nn,
                                           subset):
    grid, ts, te, pattrs = scene_args(name)
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    if subset:
        ids = ids[::3]
    out, _, kexit, grad, _ = compare_walks(host_math, pattrs, ts[ids],
                                           te[ids], ids, grid.tiles_x,
                                           use_sa, nn)
    assert kexit.max() > 0 and np.abs(out[:, 0]).max() > 0.0
    assert np.abs(grad).max() > 0.0


@pytest.mark.parametrize("hard", ["opaque", "degenerate"])
def test_packed_walk_on_hard_scenes(host_math, hard):
    """Triggers inside a block (bf16 walks on past them), p_z = 0, depth
    below NEAR_N, opacity below ALPHA_MIN, NaN in a ray row or the
    opacity: the same bits (NaN where the one-pixel walk has NaN)."""
    grid, ts, te, pattrs = (K.opaque_scene() if hard == "opaque"
                            else K.degenerate_scene())
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    compare_walks(host_math, pattrs, ts, te, ids, grid.tiles_x, True, False)


@pytest.mark.parametrize("name,use_sa", [("2dgs 48x64", True),
                                         ("32x640", False)])
def test_packed_refill_is_the_one_pixel_refill(host_math_ring2, name,
                                               use_sa):
    """With a ring of 2 records a pixel most pixels re-run their block on
    the packed chain for the earlier records: the same gradient bits."""
    grid, ts, te, pattrs = scene_args(name)
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    compare_walks(host_math_ring2, pattrs, ts, te, ids, grid.tiles_x,
                  use_sa, True)


@pytest.mark.parametrize("name", ["2dgs 48x64", "3dgs 48x64", "32x640",
                                  "degenerate"])
def test_division_free_cull_implies_the_exact_one(host_math, name):
    if name == "degenerate":
        grid, ts, te, pattrs = K.degenerate_scene()
    else:
        grid, ts, te, pattrs = scene_args(name)
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    out = np.zeros(3, np.int64)
    args = [np.ascontiguousarray(a) for a in
            (pattrs, ids, ts.astype(np.int32), te.astype(np.int32))]
    host_math.host_far_ray_counts(_ptr(args[0]), pattrs.shape[1],
                                  *map(_ptr, args[1:]), len(ids),
                                  grid.tiles_x, _ptr(out))
    evals, far, wrong = out
    assert wrong == 0
    assert far > (0.2 if name == "degenerate" else 0.5) * evals, out
