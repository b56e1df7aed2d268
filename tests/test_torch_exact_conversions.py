"""The exact conversions of the fused window kernel (K4,
csrc/sample_windows.cu: byte_f32, tap_origin), emulated in numpy
instruction by instruction and held bit for bit to the plain version's
own functions, which the kernel must equal:

  * a tap byte as a float: PRMT of the byte into the mantissa of 2^23,
    less 2^23, against cuda_ncc._byte, for all 256 bytes in each of the
    four byte positions;
  * the tap origin: clamp in float to [0, w - 2], then an add of
    1.5 * 2^23 rounded toward zero, its bits less 0x4B400000 as the int
    and its value less 1.5 * 2^23 as the float, against
    sampling._bilinear_frac's truncate-then-clamp (via _trunc_i32) and
    (float)lx, the fraction clamp01(x - lx) after it, and the tap word
    ly * w + lx the kernel forms from the two sums' bits, over an edge
    set (NaN, +-inf, +-0, denormals, negatives, integers, w - 2 and its
    neighbours, past int32) and a seeded random set of float32 bit
    patterns, at level widths 0 to 4096;
  * on the finite coordinates within int32, the JAX package's tap
    origin (mvskit_tpu/ops/sampling.py: clip(x.astype(int32), 0, w - 2));
  * the backward kernel's (csrc/sample_windows_grad.cu) slope
    clip'(x - l), l from tap_origin, against ops/sampling.clip01_slope
    of the plain version's fractions and against autograd's derivative
    of those fractions, on both axes, over the edge set, every integer
    from -3 to w + 2 and their neighbours, at level widths 0 to 4096;
  * its tap differences: a byte put into the mantissa of 2^23 by one
    PRMT, with no subtraction, differs from another so put by exactly
    the bytes' difference, for every pair of bytes.

No tolerance: every comparison is of bits. The kernel's own output is
held to the plain version on the card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu_torch.ops import cuda_ncc, sampling
from mvskit_tpu_torch.tools import bench_kernel
from mvskit_tpu_torch.utils import synthetic

TWO23 = np.float32(8388608.0)
MAGIC = np.float32(12582912.0)  # 1.5 * 2^23, bits 0x4B400000


def byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s): byte n of the result is byte
    (s >> 4n) & 7 of the 8-byte value y:x."""
    pool = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint32).astype(np.uint64)
    out = np.zeros(np.shape(pool), np.uint32)
    for n in range(4):
        sel = np.uint64((s >> (4 * n)) & 7)
        byte = ((pool >> (sel * np.uint64(8))) & np.uint64(0xFF)).astype(np.uint32)
        out |= byte << np.uint32(8 * n)
    return out


def byte_f32(v, k):
    """The kernel's byte_f32: one PRMT and one subtraction."""
    bits = byte_perm(v.view(np.uint32), 0x4B000000, 0x7440 + k)
    return bits.view(np.float32) - TWO23


def add_rz(a, b):
    """float32 a + b rounded toward zero (__fadd_rz): the float64 sum,
    rounded to float32, stepped one ulp toward zero where rounding to
    nearest went past it (exact for the operands here: the float64 sum
    never crosses a float32 value)."""
    s = a.astype(np.float64) + b.astype(np.float64)
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def tap_origin(x, w):
    """The kernel's tap_origin(x, w - 2): the sum's bits (0x4B400000 +
    the origin) and the origin as a float."""
    lim = np.float32(w - 2)
    with np.errstate(invalid="ignore"):
        xc = np.fmin(np.fmax(x, np.float32(0)), lim)  # fmaxf(NaN, 0) = 0
    t = add_rz(xc, np.full_like(xc, MAGIC))
    return t.view(np.uint32), t - MAGIC


def tap_word(bx, by, w):
    """The kernel's tap word ly * w + lx from the origins' bits: by * w +
    bx - 0x4B400000 * (w + 1) in wrapping 32-bit arithmetic."""
    u = np.uint32
    bias = u((0x4B400000 * (w + 1)) % 2**32)
    with np.errstate(over="ignore"):
        return (by * u(w % 2**32) + bx - bias).view(np.int32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_byte_conversion_every_byte(k):
    rng = np.random.default_rng(k)
    other = rng.integers(0, 2**32, 256, dtype=np.uint64).astype(np.uint32)
    mask = np.uint32(0xFF << (8 * k))
    v = ((other & ~mask) | (np.arange(256, dtype=np.uint32) << np.uint32(8 * k))).view(np.int32)
    got = byte_f32(v, k)
    want = cuda_ncc._byte(torch.from_numpy(v.copy()), k).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(got, np.arange(256, dtype=np.float32))


def _edge_coordinates(w):
    f = np.float32
    base = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 1.17549435e-38, 0.5, 0.999,
            1.0, 1.5, -0.5, -1.0, -1.5, -3.7, 2.0, 3.0, 7.25, 2**22, 2**23, 2**24, 2**31,
            -2**31, 3e9, -3e9, 1e30, -1e30, np.finfo(np.float32).max,
            -np.finfo(np.float32).max]
    near = [w - 3, w - 2.5, w - 2, w - 1.5, w - 1, w, w + 0.5, w + 7]
    xs = np.asarray(base + near, np.float32)
    ints = np.asarray([0, 1, 2, 5, w - 3, w - 2, w - 1, w], np.float32)
    # the neighbours of every integer near the edges, one ulp either side
    return np.concatenate([xs, ints, np.nextafter(ints, f(-np.inf)),
                           np.nextafter(ints, f(np.inf))])


def _coordinates(w, seed):
    rng = np.random.default_rng(seed)
    patterns = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32).view(np.float32)
    inside = rng.uniform(-4.0, w + 4.0, 4096).astype(np.float32)
    return np.concatenate([_edge_coordinates(w), patterns, inside])


@pytest.mark.parametrize("w", [0, 1, 2, 3, 20, 80, 160, 640, 4096])
def test_tap_origin_clamp_then_truncate_equals_truncate_then_clamp(w):
    x = _coordinates(w, seed=w)
    y = np.random.default_rng(w + 1).permutation(x)
    bx, lf = tap_origin(x, w)
    by, _ = tap_origin(y, w)
    lx = bx.view(np.int32) - np.int32(0x4B400000)
    tx, ty = torch.from_numpy(x.copy()), torch.from_numpy(y.copy())
    tw = torch.full(x.shape, w, dtype=torch.int32)
    want_l, want_ly, _, want_dx1, _, _ = sampling._bilinear_frac(tx, ty, tw, tw)
    np.testing.assert_array_equal(lx, want_l.numpy())
    # the tap word the kernel reads, from the bits alone
    np.testing.assert_array_equal(tap_word(bx, by, w), (want_ly * w + want_l).numpy())
    np.testing.assert_array_equal(_bits(lf), _bits(want_l.to(torch.float32).numpy()))
    # the same as truncating with _trunc_i32 and clamping after it
    trunc = sampling._trunc_i32(tx).numpy().astype(np.int64)
    np.testing.assert_array_equal(lx, np.minimum(np.maximum(trunc, 0), w - 2))
    # the fraction takes the unclamped x: clamp01(x - lx), NaN kept
    dx1 = torch.clamp(tx - torch.from_numpy(lf.copy()), 0.0, 1.0).numpy()
    np.testing.assert_array_equal(_bits(dx1), _bits(want_dx1.numpy()))


def test_tap_origin_matches_the_jax_package_on_finite_coordinates():
    """Where x is finite and within int32, the JAX package's origin
    (jnp.clip(x.astype(int32), 0, w - 2)) is the same integer."""
    for w in (2, 80, 640):
        x = _coordinates(w, seed=100 + w)
        x = x[np.isfinite(x) & (np.abs(x) < 2**31 - 128)]
        bx, _ = tap_origin(x, w)
        lx = bx.view(np.int32) - np.int32(0x4B400000)
        want = np.asarray(jnp.clip(jnp.asarray(x).astype(jnp.int32), 0, w - 2))
        np.testing.assert_array_equal(lx, want)


def test_edge_windows_reach_every_case():
    """bench_kernel.edge_windows, the card tests' and chip_smoke.py's
    edge lattices, holds NaN, +-inf, negative, integer, at-w-2 and
    past-w-2 sample coordinates, and its plain output has the expected
    shape in both channel modes."""
    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120,
                                        device=torch.device("cpu"))
    args = bench_kernel.edge_windows(scene, 96)
    idx, lvl, tl, dx, dy = args
    gx, _ = cuda_ncc.lattice(tl, dx, dy, 7)
    w = scene.lvl_widths[lvl.long()].unsqueeze(1).to(torch.float32)
    finite = torch.isfinite(gx)
    assert torch.isnan(gx).any() and (gx == float("inf")).any() and (gx == -float("inf")).any()
    assert (finite & (gx < 0)).any() and (finite & (gx == gx.round()) & (gx > 0)).any()
    assert (gx == w - 2).any() and (finite & (gx > w - 2)).any()
    for luma, C in ((False, 3), (True, 1)):
        out, fit = cuda_ncc.sample_windows(scene, *args, 7, group=32, luma=luma, fused=True)
        assert fit.all() and out.shape == (96, C * 49)


def clip01_slope(v):
    """The backward kernel's clip01_slope: (v > 0 && v < 1) ? 1 : ((v ==
    0 || v == 1) ? 0.5 : 0), so NaN gives 0."""
    with np.errstate(invalid="ignore"):
        inside = (v > 0) & (v < 1)
        tie = (v == 0) | (v == 1)
    return np.where(inside, np.float32(1), np.where(tie, np.float32(0.5), np.float32(0)))


def _slope_coordinates(w):
    f = np.float32
    ints = np.arange(-3, w + 3, dtype=np.float32)
    return np.concatenate([_edge_coordinates(w), ints, np.nextafter(ints, f(-np.inf)),
                           np.nextafter(ints, f(np.inf)), ints + f(0.5)])


@pytest.mark.parametrize("w", [0, 1, 2, 3, 20, 80, 160, 640, 4096])
def test_backward_slope_equals_the_plain_fractions_slope(w):
    """The kernel's slope of each axis, clip'(x - l) with l = tap_origin's
    float and x - l rounded to nearest, equals clip01_slope of the plain
    version's x - lx and the derivative autograd takes through its
    fractions dx1, dy1: 1 inside, 0.5 on an integer or on w - 1, 0
    outside the level and at NaN or +-inf."""
    x = _slope_coordinates(w)
    y = np.random.default_rng(w + 7).permutation(x)
    got = []
    for c in (x, y):
        _, l = tap_origin(c, w)
        with np.errstate(invalid="ignore"):
            got.append(clip01_slope(c - l))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    ty = torch.from_numpy(y.copy()).requires_grad_()
    tw = torch.full(x.shape, w, dtype=torch.int32)
    lx, ly, _, dx1, _, dy1 = sampling._bilinear_frac(tx, ty, tw, tw)
    autograd = torch.autograd.grad(dx1.sum() + dy1.sum(), (tx, ty))
    for k, (c, lo) in enumerate(((tx, lx), (ty, ly))):
        want = sampling.clip01_slope(c.detach() - lo.to(torch.float32)).numpy()
        np.testing.assert_array_equal(_bits(got[k]), _bits(want))
        np.testing.assert_array_equal(_bits(got[k]), _bits(autograd[k].numpy()))
    # every value of the slope occurs
    assert {0.0, 0.5, 1.0} <= set(np.concatenate(got).tolist()) or w < 2


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_biased_byte_differences_are_exact(k):
    """byte_biased(a) - byte_biased(b), both in [2^23, 2^24), is a - b
    exactly for all 256 x 256 byte pairs in byte position k, the same
    float as byte_f32(a) - byte_f32(b)."""
    rng = np.random.default_rng(10 + k)
    other = rng.integers(0, 2**32, 256, dtype=np.uint64).astype(np.uint32)
    mask = np.uint32(0xFF << (8 * k))
    v = ((other & ~mask) | (np.arange(256, dtype=np.uint32) << np.uint32(8 * k))).view(np.int32)
    biased = byte_perm(v.view(np.uint32), 0x4B000000, 0x7440 + k).view(np.float32)
    diff = biased[:, None] - biased[None, :]
    want = (np.arange(256)[:, None] - np.arange(256)[None, :]).astype(np.float32)
    np.testing.assert_array_equal(_bits(diff), _bits(want + np.float32(0)))
    f = byte_f32(v, k)
    np.testing.assert_array_equal(_bits(diff), _bits(f[:, None] - f[None, :]))
