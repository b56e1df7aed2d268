"""The refinement's gradient polish (refine_grad_steps > 0) of
mvskit_tpu_torch against mvskit_tpu's (JAX refine.py:277-300).

The JAX package takes the polish's gradient by autodiff of its gather
path (its Pallas sampler has no VJP); the port's gradient is autograd
through its plain sampler here, and the window sampler's backward kernel
on a card (tests/test_torch_cuda.py holds that kernel to this plain
version). Tolerances:
  * the gradient of the summed cost in the three encoded parameters:
    within 1e-4 of the row's |g| where JAX's gradient is finite, and
    not finite in the same rows (RGB, luma, three illuminations); where
    the JAX package's own jit and eager gradients differ by more (the
    luma rows near their optimum), within twice that difference;
  * the sampler's vector-Jacobian product on the edge lattices and on
    lattices planted on integers and on w - 1: within 1e-6 of the
    window's summed |cotangent| (float32 sums in another order), the
    same NaN pattern, and a slope of exactly 0.5 on a tie (jnp.clip's
    derivative on a bound; torch.clamp's is 1);
  * refine_batch with grad_steps as tests/test_torch_refine.py holds the
    search: coord 1e-4, ncc 2e-4 on >= 99 % of rows, with the JAX key's
    draws replayed (each normalised step moves a row by grad_lr whatever
    its gradient's size, so a rounding difference in the direction grows
    step by step);
  * the pipeline pair with refine_grad_steps 2:
    tests/test_torch_polish_pipeline.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.core.patches import count_valid as jcount_valid
from mvskit_tpu.ops import ncc as jncc
from mvskit_tpu.pipeline import refine as jrf
from mvskit_tpu.pipeline import views as jvw
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.core.patches import count_valid
from mvskit_tpu_torch.ops import cuda_ncc
from mvskit_tpu_torch.ops import sampling as tsmp
from mvskit_tpu_torch.parallel import shard as tsh
from mvskit_tpu_torch.pipeline import refine as trf
from mvskit_tpu_torch.tools.bench_kernel import edge_windows
from torch_replay import jax_scene_to_torch, refine_deltas, seeded_plane

LEVEL, WSIZE, TAU, MIN_NUM = 1, 7, 6, 3
A1 = math.radians(60.0)
ASCALE = math.pi / 48.0
KW = dict(level=LEVEL, wsize=WSIZE, tau=TAU, min_image_num=MIN_NUM,
          angle_threshold1=A1, ascale=ASCALE, shrink=0.4096,
          init_depth_radius=4.0, init_angle_radius=8.0)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# the cost of the polish (refine_batch's cost_of) in both packages


def jax_cost(js, coord, normal, images, ds, luma=False, n_illums=1):
    """JAX refine_batch's cost_of, p [B, 3] -> cost [B], on the gather
    path, built from decode_coord, decode_normal and _eval_cost."""
    images = jnp.asarray(images)
    ref = jnp.maximum(images[:, 0], 0)
    center = jnp.asarray(coord)
    ray = center - js.cams.center[ref]
    ray = ray / jnp.sqrt(jnp.maximum(jnp.sum(ray * ray, -1, keepdims=True), 1e-20))
    views = images[:, :TAU]
    minimum = jnp.minimum(MIN_NUM, jnp.minimum(TAU, jcount_valid(images)))
    ds = jnp.asarray(ds)
    safe = jnp.where(ds == 0.0, 1.0, ds)

    def cost(p):
        c = jrf.decode_coord(center, ray, safe, p[:, 0])
        n = jrf.decode_normal(js, ref, p[:, 1] * ASCALE, p[:, 2] * ASCALE)
        return jrf._eval_cost(js, views, c, n, minimum, LEVEL, WSIZE, A1, luma=luma,
                              n_illums=n_illums)

    return cost


def torch_cost(ts, coord, normal, images, ds, luma=False, n_illums=1):
    """The port's cost_of of refine_batch, written out the same way."""
    images = _t(images)
    ref = images[:, 0].clamp(min=0).long()
    center = _t(coord)
    ray = center - ts.cams.center[ref]
    ray = ray / torch.sqrt(torch.clamp((ray * ray).sum(-1, keepdim=True), min=1e-20))
    views = images[:, :TAU]
    minimum = torch.clamp(torch.clamp(count_valid(images), max=TAU), max=MIN_NUM)
    ds = _t(ds)
    safe = torch.where(ds == 0.0, torch.ones_like(ds), ds)

    def cost(p):
        c = trf.decode_coord(center, ray, safe, p[:, 0])
        n = trf.decode_normal(ts, ref, p[:, 1] * ASCALE, p[:, 2] * ASCALE)
        return trf._eval_cost(ts, views, c, n, minimum, LEVEL, WSIZE, A1, luma=luma,
                              n_illums=n_illums)

    return cost


def start_poses(js, coord, normal, images, seed):
    """Encoded start poses p [B, 3] of (coord, normal) perturbed by numpy
    draws: depth within +-2 (dscale units), angles within +-3 (ascale)."""
    ref = jnp.maximum(jnp.asarray(images)[:, 0], 0)
    a1, a2 = jrf.encode_normal(js, ref, jnp.asarray(normal))
    p = np.stack([np.zeros(coord.shape[0]), np.asarray(a1) / ASCALE,
                  np.asarray(a2) / ASCALE], -1)
    rng = np.random.default_rng(seed)
    p += rng.uniform(-1, 1, p.shape) * np.array([2.0, 3.0, 3.0])
    return p.astype(np.float32)


def assert_gradients_match(js, ts, coord, normal, images, ds, luma=False, n_illums=1,
                           seed=0):
    """The port's gradient of the summed cost against JAX's (jit), row by
    row: the same rows finite, each finite row within rtol * |g| where
    rtol is 1e-4, or twice the JAX package's own largest relative
    difference between its jit and its eager gradient where that is
    more: near the optimum the gradient is a small difference of terms
    rounded in float32, and XLA's fused evaluation rounds it otherwise
    than its unfused one (up to 1.3e-4 of |g| on the luma rows here).
    Returns (the port's gradient, its largest relative difference)."""
    p = start_poses(js, coord, normal, images, seed)
    jcost = jax_cost(js, coord, normal, images, ds, luma, n_illums)
    grad = jax.grad(lambda q: jnp.sum(jcost(q)))
    gj = np.asarray(jax.jit(grad)(jnp.asarray(p)))
    tcost = torch_cost(ts, coord, normal, images, ds, luma, n_illums)
    q = torch.from_numpy(p).requires_grad_()
    (gt,) = torch.autograd.grad(tcost(q).sum(), q)
    gt = gt.numpy()
    fin = np.isfinite(gj).all(1)
    assert fin.mean() > 0.5, fin.mean()
    np.testing.assert_array_equal(np.isfinite(gt).all(1), fin)
    scale = np.linalg.norm(gj[fin], axis=1)
    live = scale > 0
    assert live.mean() > 0.5
    np.testing.assert_array_equal(gt[fin][~live], 0.0)  # a flat cost (2.0) in both
    rel = lambda a: np.abs(a[fin][live] - gj[fin][live]).max(1) / scale[live]  # noqa: E731
    rtol = 1e-4
    if rel(gt).max() > rtol:  # JAX's own spread, from its unfused evaluation
        rtol = max(rtol, 2.0 * rel(np.asarray(grad(jnp.asarray(p)))).max())
    assert rtol <= 5e-4, rtol
    assert (rel(gt) <= rtol).all(), (rel(gt).max(), rtol)
    return gt, rel(gt).max()


@pytest.fixture(scope="module")
def plane():
    """256 plane patches off the surface with tilted normals (as
    tests/test_torch_refine.py's 64). Four normalised steps amplify
    float32 rounding (on 64 rows one row's coordinate moved 2e-6, 1.4e-5
    and 1.8e-4 after steps 1-3), so the refinement parity needs enough
    rows for its 1 % allowance to hold one."""
    n = 256
    Ps, js, jt, ts, tt = seeded_plane(n_patches=n, capacity=n, seed=2)
    rng = np.random.default_rng(0)
    coord = np.asarray(jt.coord)[:n].copy()
    coord[:, 2] += rng.uniform(-0.05, 0.05, n)
    normal = np.asarray(jt.normal)[:n].copy()
    normal[:, :2] += rng.uniform(-0.15, 0.15, (n, 2))
    normal[:, :3] /= np.linalg.norm(normal[:, :3], axis=1, keepdims=True)
    coord, normal = coord.astype(np.float32), normal.astype(np.float32)
    images = np.array(jt.images)[:n]
    ds, _ = jvw.set_scales(js, jnp.asarray(coord), jnp.asarray(images), LEVEL, TAU, WSIZE)
    return js, ts, coord, normal, images, np.array(ds)


@pytest.mark.parametrize("luma", [False, True], ids=["rgb", "luma"])
def test_cost_gradient_matches_jax(plane, luma):
    js, ts, coord, normal, images, ds = plane
    assert js.planes_rgb_levels is None and js.planes_luma_levels is None  # gather path
    gt, worst = assert_gradients_match(js, ts, coord, normal, images, ds, luma=luma)
    assert np.abs(gt[np.isfinite(gt)]).max() > 0
    if not luma:
        assert worst <= 1e-4


@pytest.fixture(scope="module")
def sphere3():
    Ps, _, js = jsyn.sphere_scene(n_views=8, width=160, height=120, nillums=3)
    ts = jax_scene_to_torch(js, Ps)
    coord, normal = jsyn.visible_surface_points(
        Ps, 96, geometry="sphere", seed=5, width=160, height=120)
    coord, normal = coord.astype(np.float32), normal.astype(np.float32)
    c, n = jnp.asarray(coord), jnp.asarray(normal)
    images = np.full((coord.shape[0], js.n_images), -1, np.int32)
    images[:, 0] = 0
    images = jvw.add_images(js, c, n, jnp.asarray(images), LEVEL, A1)
    images = np.asarray(jvw.sort_images(js, c, n, images, LEVEL))
    ok = images[:, 0] >= 0
    coord, normal, images = coord[ok], normal[ok], images[ok]
    ds = np.asarray(jvw.set_scales(js, jnp.asarray(coord), jnp.asarray(images),
                                   LEVEL, TAU, WSIZE)[0])
    return js, ts, coord, normal, images, ds


def test_cost_gradient_matches_jax_three_illuminations(sphere3):
    js, ts, coord, normal, images, ds = sphere3
    assert ts.n_illums == 3
    assert_gradients_match(js, ts, coord, normal, images, ds, n_illums=3, seed=1)


# ---------------------------------------------------------------------------
# the sampler's vector-Jacobian product and the tie rule


def jax_window_vjp(js, idx, lvl, tl, dx, dy, wsize, cot, luma=False):
    """jax.vjp of JAX's sample_windows_raw (gather path) in tl, dx, dy:
    one view slot (T = 1) of B windows."""
    def f(tl_, dx_, dy_):
        tex, _, _ = jncc.sample_windows_raw(
            js, jnp.asarray(idx)[None], tl_[None], dx_[None], dy_[None],
            jnp.asarray(lvl)[None], wsize, 0, luma)
        return tex[0]

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (tl, dx, dy)))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def planted_ties(ts, wsize):
    """Lattices on integer coordinates and on w - 1 of each level (every
    sample on a tie of the fractions' clip), beside their half-pixel
    shifts (no tie). Returns idx, lvl, tl, dx, dy as numpy arrays."""
    rows = []
    for lv, (w, h) in enumerate(zip(ts.widths, ts.heights)):
        if min(w, h) <= wsize + 2:
            continue
        for v in range(ts.n_images):
            rows += [(v, lv, (3.0, 2.0), (1.0, 0.0), (0.0, 1.0)),
                     (v, lv, (w - 1.0, h - 1.0), (0.0, 0.0), (0.0, 0.0)),
                     (v, lv, (w - 1.0, 2.0), (0.0, 0.0), (0.0, 1.0)),
                     (v, lv, (3.5, 2.25), (1.0, 0.0), (0.0, 1.0))]
    idx, lvl, tl, dx, dy = (np.asarray(c) for c in zip(*rows))
    return (idx.astype(np.int32), lvl.astype(np.int32), tl.astype(np.float32),
            dx.astype(np.float32), dy.astype(np.float32))


@pytest.mark.parametrize("luma", [False, True], ids=["rgb", "luma"])
@pytest.mark.parametrize("wsize", [7, 5])
@pytest.mark.parametrize("windows", ["edge", "ties"])
def test_sampler_vjp_matches_jax(plane, luma, wsize, windows):
    js, ts = plane[:2]
    if windows == "edge":
        args = [a.numpy() for a in edge_windows(ts, 96, seed=wsize)]
    else:
        args = list(planted_ties(ts, wsize))
    B = args[0].shape[0]
    C = 1 if luma else 3
    cot = np.random.default_rng(wsize).normal(size=(B, C * wsize * wsize)).astype(np.float32)
    want = jax_window_vjp(js, *args, wsize, cot, luma)
    targs = (ts, *(_t(a) for a in args), wsize, _t(cot))
    got = [g.numpy() for g in cuda_ncc.sample_windows_grad(*targs, luma=luma)]
    scale = cuda_ncc.grad_scale(cuda_ncc.sample_grad_terms(*targs, luma=luma), wsize).numpy()
    # XLA on the CPU flushes subnormal floats to zero, so JAX takes the
    # denormal edge lattice (tl 1e-45) for one on an integer, a tie, where
    # IEEE arithmetic (torch, and the card) sees 1e-45 past it
    lat = np.concatenate(args[2:], 1)
    subnormal = ((np.abs(lat) < np.finfo(np.float32).tiny) & (lat != 0)).any(1)
    assert subnormal.sum() == (2 if windows == "edge" else 0)
    for g, w, sc in zip(got, want, scale):
        g, w, sc = g[~subnormal], w[~subnormal], sc[~subnormal]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        assert (np.abs(g - w)[fin] <= 1e-6 * sc[fin]).all(), (np.abs(g - w) / sc)[fin].max()
    if windows == "edge":
        assert np.isnan(want[0]).any()  # the NaN lattices reach the gradient


def test_tie_slope_is_one_half(plane):
    """A sample on a tie of its fraction's clip gets half the slope of
    the same cell's interior: at an integer x, dv/dx is half its value
    at x + 0.25 (the same taps and y), and at x = w - 1 half its value
    at w - 1.5; torch.clamp would give the whole slope."""
    ts = plane[1]
    w, h = ts.widths[1], ts.heights[1]
    x = np.array([3.0, 3.25, w - 1.0, w - 1.5], np.float32)
    tl = np.stack([x, np.full(4, 2.4, np.float32)], 1)
    zero = np.zeros((4, 2), np.float32)
    idx, lvl = np.zeros(4, np.int32), np.ones(4, np.int32)
    cot = np.ones((4, 3), np.float32)
    g_tl = cuda_ncc.sample_windows_grad_plain(ts, _t(idx), _t(lvl), _t(tl), _t(zero),
                                              _t(zero), 1, _t(cot))[0].numpy()
    assert g_tl[1, 0] != 0.0 and g_tl[3, 0] != 0.0
    assert g_tl[0, 0] == 0.5 * g_tl[1, 0] and g_tl[2, 0] == 0.5 * g_tl[3, 0]
    assert float(tsmp.clip01_slope(torch.tensor([0.0, 1.0, 0.5, -1.0, 2.0, float("nan")]))
                 .sum()) == 2.0


def test_clip01_keeps_clamp_bits():
    v = torch.tensor([-1e-30, 0.0, 1e-40, 0.3, 1.0, 1.0000001, float("nan"), float("inf")])
    want = torch.clamp(v, 0.0, 1.0)
    vv = v.clone().requires_grad_()
    got = tsmp.clip01(vv)
    assert torch.equal(got.detach().isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got.detach()).view(torch.int32),
                       torch.nan_to_num(want).view(torch.int32))
    (g,) = torch.autograd.grad(got, vv, torch.ones_like(v))
    assert g.tolist() == [0.0, 0.5, 1.0, 1.0, 0.5, 0.0, 0.0, 0.0]
    (g,) = torch.autograd.grad(tsmp.clip01(vv), vv, torch.full_like(v, float("nan")))
    assert torch.isnan(g).all()  # a product, as JAX's: a NaN cotangent stays NaN


# ---------------------------------------------------------------------------
# refine_batch with the polish


def _refine_pair(js, ts, coord, normal, images, ds, key, rounds, n_cands, **extra):
    jres = jrf.refine_batch(
        js, jnp.asarray(coord), jnp.asarray(normal), jnp.asarray(images),
        jnp.asarray(ds), key, rounds=rounds, n_cands=n_cands, group_dma=False,
        **extra, **KW)
    deltas = torch.from_numpy(refine_deltas(key, rounds, coord.shape[0], n_cands))
    tres = trf.refine_batch(
        ts, _t(coord), _t(normal), _t(images), _t(ds), deltas, rounds=rounds,
        n_cands=n_cands, group_dma=False, **extra, **KW)
    return jres, tres, deltas


def test_refine_with_polish_matches_jax(plane):
    js, ts, coord, normal, images, ds = plane
    key = jax.random.PRNGKey(5)
    jres, tres, deltas = _refine_pair(js, ts, coord, normal, images, ds, key, 3, 8,
                                      grad_steps=4, grad_lr=0.5)
    jc, tc = np.asarray(jres.coord), tres.coord.numpy()
    jn, tn = np.asarray(jres.ncc), tres.ncc.numpy()
    ok = (np.abs(jc - tc).max(1) <= 1e-4) & (np.abs(jn - tn) <= 2e-4)
    assert ok.mean() >= 0.99, (ok.mean(), np.abs(jc - tc).max(), np.abs(jn - tn).max())
    # the polish moved rows: it differs from the search alone
    plain = trf.refine_batch(ts, _t(coord), _t(normal), _t(images), _t(ds), deltas,
                             rounds=3, n_cands=8, group_dma=False, **KW)
    moved = (tres.coord != plain.coord).any(1)
    assert moved.any()
    assert (tres.cost <= plain.cost).all()


def test_gradient_polish_improves(plane):
    """Port of tests/test_refine.py::test_gradient_polish_improves: with
    the polish on, the final cost is never worse and typically better
    than random search alone at a tiny search budget."""
    js, ts, coord, normal, images, ds = plane
    ok = images[:, 0] >= 0
    ref = np.maximum(images[:, 0], 0)
    ray = coord - np.asarray(ts.cams.center)[ref]
    ray = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
    start = (coord + (2.0 * ds)[:, None] * ray).astype(np.float32)
    kw = dict(KW, shrink=0.8, rounds=4, n_cands=4)
    deltas = torch.from_numpy(refine_deltas(jax.random.PRNGKey(3), 4, coord.shape[0], 4))
    args = (ts, _t(start), _t(normal), _t(images), _t(ds), deltas)
    base = trf.refine_batch(*args, **kw)
    polished = trf.refine_batch(*args, grad_steps=4, grad_lr=0.5, **kw)
    b = base.cost.numpy()[ok]
    p = polished.cost.numpy()[ok]
    assert np.all(p <= b + 1e-6)
    assert np.mean(p) <= np.mean(b)
    assert (p < b).any()


def test_polish_through_view_shards_equals_unsharded(plane):
    """The gradient flows through the view-sharded sampler (index_select
    into each shard's launch, index_copy_ back): the polished refinement
    on a scene sharded over 2 and 3 views equals the unsharded one bit
    for bit."""
    js, ts, coord, normal, images, ds = plane
    deltas = torch.from_numpy(refine_deltas(jax.random.PRNGKey(9), 2, coord.shape[0], 4))
    kw = dict(KW, rounds=2, n_cands=4, grad_steps=2)
    args = (_t(coord), _t(normal), _t(images), _t(ds), deltas)
    base = trf.refine_batch(ts, *args, **kw)
    for k in (2, 3):
        sharded = tsh.enable_view_sharding(ts, tsh.make_mesh(k, "view", device="cpu"))
        got = trf.refine_batch(sharded, *args, **kw)
        for a, b in zip(got, base):
            assert torch.equal(a, b), k


def test_polish_stats_records_only_inside_its_block(plane):
    """utils/profiling.polish_stats: the polish records the rows each step
    tried and the rows that took it while the block is open (the same
    rows as the result's moves), and nothing outside it."""
    from mvskit_tpu_torch.utils import profiling

    js, ts, coord, normal, images, ds = plane
    deltas = torch.from_numpy(refine_deltas(jax.random.PRNGKey(9), 2, coord.shape[0], 4))
    kw = dict(KW, rounds=2, n_cands=4)
    args = (ts, _t(coord), _t(normal), _t(images), _t(ds), deltas)
    searched = trf.refine_batch(*args, **kw)
    assert profiling.POLISH is None
    with profiling.polish_stats() as stats:
        polished = trf.refine_batch(*args, grad_steps=2, **kw)
    assert profiling.POLISH is None
    rec = stats.as_dict()
    B = coord.shape[0]
    assert rec["rows"] == [B, B] and rec["refine_calls"] == 0
    moved = int((polished.cost != searched.cost).sum())
    assert 0 < moved <= sum(rec["accepted"]) and max(rec["accepted"]) <= B
    trf.refine_batch(*args, grad_steps=2, **kw)
    assert stats.as_dict()["rows"] == [B, B]
