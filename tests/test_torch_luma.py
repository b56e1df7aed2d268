"""The luma candidate search (opt-in luma_refine) of mvskit_tpu_torch
against mvskit_tpu on the same inputs: the quad-packed luma planes, the
luma sampler (plain version of the K3 kernel), the luma windows and
costs, the two-segment luma + RGB-tail refinement and the whole
pipeline with luma_refine=True.

Tolerances and why:
  * luma planes: exact (the same integer arithmetic);
  * raw luma samples vs the JAX gather path: 1e-4 on the 0-255 scale
    (one float32 bilinear sum per sample, evaluated in the same order);
  * normalized windows and incc_cost: 2e-4, the golden-parity bound;
  * vs the Pallas luma kernel in interpret mode where its `fit` is
    true, unfused and fused (K4): 1e-2, the Pallas test's own bound (tests/test_pallas_ncc.py:
    57, 92 — its one-hot matmul sums in another order);
  * refinement: coord and normal 1e-4, ncc 2e-4, on >= 99 % of rows (an
    argmin over near-equal candidate costs may flip);
  * pipeline: alive counts within 3 %, quality within 10 % relative, as
    tests/test_torch_pipeline.py allows. The pipeline pair (JAX driver
    and port, seed + 2 iterations) runs the luma search on a
    3-illumination dataset; tests/test_torch_illums.py runs the RGB
    search on one.
The kernel itself is held to its plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.ops import ncc as jncc
from mvskit_tpu.ops import pallas_ncc as pk
from mvskit_tpu.ops import sampling as jsmp
from mvskit_tpu.pipeline import refine as jrf
from mvskit_tpu.pipeline import views as jvw
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch import config as tconfig
from mvskit_tpu_torch.ops import cuda_ncc
from mvskit_tpu_torch.ops import ncc as tncc
from mvskit_tpu_torch.ops import sampling as tsmp
from mvskit_tpu_torch.pipeline import refine as trf
from mvskit_tpu_torch.utils import synthetic as tsyn
from test_torch_ncc import _geometry, _t, _views
from test_torch_pipeline import assert_alive_tracks_jax, assert_quality_tracks_jax, run_pair
from torch_replay import jax_scene_to_torch, refine_deltas, seeded_plane

LEVEL, WSIZE, TAU, A1 = 1, 7, 6, math.radians(60.0)
S = WSIZE * WSIZE
KW = dict(level=LEVEL, wsize=WSIZE, tau=TAU, min_image_num=3,
          angle_threshold1=A1, ascale=math.pi / 48.0, shrink=0.64,
          init_depth_radius=4.0, init_angle_radius=8.0)


@pytest.fixture(scope="module")
def scenes():
    Ps, _, js = jsyn.plane_scene(n_views=6, width=160, height=120)
    return Ps, js, jax_scene_to_torch(js, Ps)


@pytest.mark.parametrize("kind", ["plane", "sphere3"])
def test_luma_planes_match_jax_exactly(kind):
    """The port builds planes_luma_quad from its own pyramids."""
    if kind == "plane":
        _, _, js = jsyn.plane_scene(n_views=4, width=160, height=120)
        _, _, ts = tsyn.plane_scene(n_views=4, width=160, height=120, device="cpu")
    else:
        _, _, js = jsyn.sphere_scene(n_views=4, width=160, height=120, nillums=3)
        _, _, ts = tsyn.sphere_scene(n_views=4, width=160, height=120, nillums=3,
                                     device="cpu")
    assert ts.planes_luma_quad.dtype == torch.int32
    np.testing.assert_array_equal(ts.planes_luma_quad.numpy(),
                                  np.asarray(js.planes_luma_quad))
    np.testing.assert_array_equal(ts.planes_packed.numpy(), np.asarray(js.planes_packed))


def test_sample_luma_quad_matches_jax(scenes):
    _, js, ts = scenes
    rng = np.random.default_rng(0)
    n = 4096
    img = rng.integers(0, 6, n).astype(np.int32)
    lvl = rng.integers(0, 4, n).astype(np.int32)
    w = np.asarray(js.widths)[lvl]
    h = np.asarray(js.heights)[lvl]
    # mostly inside, some outside (clamped taps) and some NaN-free edges
    x = (rng.uniform(-0.1, 1.1, n) * (w - 1)).astype(np.float32)
    y = (rng.uniform(-0.1, 1.1, n) * (h - 1)).astype(np.float32)
    want = np.asarray(jsmp.sample_luma_quad(js, jnp.asarray(img), jnp.asarray(x),
                                            jnp.asarray(y), jnp.asarray(lvl)))
    got = tsmp.sample_luma_quad(ts, _t(img), _t(x), _t(y), _t(lvl)).numpy()
    assert got.shape == want.shape == (1, n)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("group", [1, 32])
def test_luma_windows_and_costs_match_jax(scenes, group):
    Ps, js, ts = scenes
    if group == 1:
        coord, normal = jsyn.plane_points(Ps, 64, seed=4, extent=1.0)
    else:
        coord, normal = jsyn.plane_points(Ps, 4, seed=5, extent=0.5)
        rng = np.random.default_rng(5)
        coord = np.repeat(coord, group, 0)
        coord[:, 2] += rng.uniform(-0.02, 0.02, coord.shape[0])
        normal = np.repeat(normal, group, 0)
    coord, normal = coord.astype(np.float32), normal.astype(np.float32)
    views = _views(coord.shape[0], 4)
    idx, lvl, tl, dx, dy, valid = _geometry(js, coord, normal, views)
    T, B = valid.shape
    jtex, jfit, ch = jncc.sample_windows_raw(
        js, jnp.asarray(idx.reshape(T, B)), jnp.asarray(tl.reshape(T, B, 2)),
        jnp.asarray(dx.reshape(T, B, 2)), jnp.asarray(dy.reshape(T, B, 2)),
        jnp.asarray(lvl.reshape(T, B)), WSIZE, 0, True, group,
    )
    assert ch == 1 and np.asarray(jfit).all()
    cuda_ncc.reset_launches()
    out, fit = cuda_ncc.sample_windows(ts, _t(idx), _t(lvl), _t(tl), _t(dx), _t(dy),
                                       WSIZE, group=group, luma=True)
    assert all(v == 0 for v in cuda_ncc.LAUNCHES.values())  # CPU: plain version
    assert fit.all() and out.shape == (T * B, S)
    assert valid.mean() > 0.5, "fixture must exercise valid windows"
    np.testing.assert_allclose(out.numpy(), np.asarray(jtex).reshape(T * B, S), atol=1e-4)

    jt, jv = jncc.texs_for_views(js, jnp.asarray(views), jnp.asarray(coord),
                                 jnp.asarray(normal), LEVEL, WSIZE, A1,
                                 luma=True, group=group)
    tt, tv = tncc.texs_for_views(ts, _t(views), _t(coord), _t(normal), LEVEL,
                                 WSIZE, A1, luma=True, group=group)
    assert tt.shape == (T, B, S)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-4)
    np.testing.assert_allclose(tncc.incc_cost(tt, tv, 3).numpy(),
                               np.asarray(jncc.incc_cost(jt, jv, 3)), atol=2e-4)


@pytest.mark.parametrize("group", [1, 32])
def test_luma_plain_matches_pallas_interpret(scenes, group):
    _check_luma_pallas_interpret(scenes, group, fused=False)


def test_luma_fused_matches_pallas_interpret_fused(scenes):
    """K4 in luma mode: the JAX kernel's fused form against the port's
    fused luma launch (its plain version on the CPU)."""
    _check_luma_pallas_interpret(scenes, 32, fused=True)


def _check_luma_pallas_interpret(scenes, group, fused):
    Ps, js, ts = scenes
    coord, normal = jsyn.plane_points(Ps, 8, seed=6, extent=0.5)
    rng = np.random.default_rng(6)
    coord = np.repeat(coord, 32, 0)
    coord[:, 2] += rng.uniform(-0.02, 0.02, coord.shape[0])
    coord, normal = coord.astype(np.float32), np.repeat(normal, 32, 0).astype(np.float32)
    views = np.repeat(np.arange(8) % 6, 32).astype(np.int32)[:, None]
    idx, lvl, tl, dx, dy, valid = _geometry(js, coord, normal, views)
    pout, pfit = pk.sample_windows(
        pk.luma_levels_from_scene(js), jnp.asarray(idx), jnp.asarray(lvl),
        jnp.asarray(tl), jnp.asarray(dx), jnp.asarray(dy), wsize=WSIZE,
        rgb=False, interpret=True, group=group, fused=fused,
    )
    pout, pfit = np.asarray(pout), np.asarray(pfit)
    out, _ = cuda_ncc.sample_windows(ts, _t(idx), _t(lvl), _t(tl), _t(dx), _t(dy),
                                     WSIZE, group=group, luma=True, fused=fused)
    both = pfit & valid.reshape(-1)
    assert both.sum() >= 128
    np.testing.assert_allclose(out.numpy()[both], pout[both, :S], atol=1e-2)


@pytest.fixture(scope="module")
def refine_setup():
    Ps, js, jt, ts, tt = seeded_plane(n_patches=64, seed=2)
    n = 64
    rng = np.random.default_rng(1)
    coord = np.asarray(jt.coord)[:n].copy()
    coord[:, 2] += rng.uniform(-0.05, 0.05, n)          # start off-surface
    normal = np.asarray(jt.normal)[:n].copy()
    normal[:, :2] += rng.uniform(-0.15, 0.15, (n, 2))     # tilted normals
    normal[:, :3] /= np.linalg.norm(normal[:, :3], axis=1, keepdims=True)
    coord, normal = coord.astype(np.float32), normal.astype(np.float32)
    images = np.array(jt.images)[:n]
    ds, _ = jvw.set_scales(js, jnp.asarray(coord), jnp.asarray(images), LEVEL, TAU, WSIZE)
    return js, ts, coord, normal, images, np.array(ds)


def _refine_pair(setup, rounds, n_cands, seed, **extra):
    js, ts, coord, normal, images, ds = setup
    key = jax.random.PRNGKey(seed)
    jres = jrf.refine_batch(
        js, jnp.asarray(coord), jnp.asarray(normal), jnp.asarray(images),
        jnp.asarray(ds), key, rounds=rounds, n_cands=n_cands,
        group_dma=False, **extra, **KW,
    )
    deltas = (torch.from_numpy(refine_deltas(key, rounds, coord.shape[0], n_cands))
              if rounds > 0 else None)
    tres = trf.refine_batch(
        ts, _t(coord), _t(normal), _t(images), _t(ds), deltas,
        rounds=rounds, n_cands=n_cands, group_dma=False, **extra, **KW,
    )
    return jres, tres, deltas


@pytest.mark.parametrize("rgb_tail", [0, 2, 4])
def test_luma_refine_matches_jax(refine_setup, rgb_tail):
    rounds, n_cands = 4, 16
    jres, tres, deltas = _refine_pair(refine_setup, rounds, n_cands, 7 + rgb_tail,
                                      luma=True, rgb_tail=rgb_tail)
    jc, tc = np.asarray(jres.coord), tres.coord.numpy()
    jn, tn = np.asarray(jres.normal), tres.normal.numpy()
    jq, tq = np.asarray(jres.ncc), tres.ncc.numpy()
    ok = ((np.abs(jc - tc).max(1) <= 1e-4) & (np.abs(jn - tn).max(1) <= 1e-4)
          & (np.abs(jq - tq) <= 2e-4))
    assert ok.mean() >= 0.99, (ok.mean(), np.abs(jc - tc).max(), np.abs(jq - tq).max())
    coord = refine_setup[2]
    assert np.median(np.abs(tc[:, 2])) < np.median(np.abs(coord[:, 2]))
    # the grouped form serves the same candidates: identical result
    _, ts, coord, normal, images, ds = refine_setup
    tres_g = trf.refine_batch(
        ts, _t(coord), _t(normal), _t(images), _t(ds), deltas, rounds=rounds,
        n_cands=n_cands, group_dma=True, luma=True, rgb_tail=rgb_tail, **KW,
    )
    assert torch.equal(tres_g.coord, tres.coord) and torch.equal(tres_g.ncc, tres.ncc)


def test_rgb_tail_full_equals_rgb_search(refine_setup):
    """rgb_tail covering all rounds reproduces the RGB search exactly
    (mirrors tests/test_refine.py::test_rgb_tail_full_equals_rgb_search)."""
    _, ts, coord, normal, images, ds = refine_setup
    deltas = torch.from_numpy(
        np.random.default_rng(3).uniform(-1, 1, (4, 64, 8, 3)).astype(np.float32))
    args = (ts, _t(coord), _t(normal), _t(images), _t(ds), deltas)
    want = trf.refine_batch(*args, rounds=4, n_cands=8, luma=False, **KW)
    got = trf.refine_batch(*args, rounds=4, n_cands=8, luma=True, rgb_tail=4, **KW)
    assert torch.equal(got.coord, want.coord) and torch.equal(got.ncc, want.ncc)
    assert torch.equal(got.cost, want.cost)


def test_luma_refine_degenerate_budget_and_bad_tail(refine_setup):
    """rounds <= 0 scores the start pose in the search mode, as JAX
    does; a negative rgb_tail with luma raises (the JAX scan breaks)."""
    jres, tres, _ = _refine_pair(refine_setup, 0, 4, 0, luma=True, rgb_tail=2)
    np.testing.assert_allclose(tres.cost.numpy(), np.asarray(jres.cost), atol=2e-4)
    np.testing.assert_allclose(tres.ncc.numpy(), np.asarray(jres.ncc), atol=2e-4)
    _, ts, coord, normal, images, ds = refine_setup
    with pytest.raises(ValueError, match="rgb_tail"):
        trf.refine_batch(ts, _t(coord), _t(normal), _t(images), _t(ds),
                         torch.zeros((2, 64, 4, 3)), rounds=2, n_cands=4,
                         luma=True, rgb_tail=-1, **KW)
    cfg = tconfig.MVSConfig(images=list(range(4)), luma_refine=True, refine_rgb_tail=-1)
    from mvskit_tpu_torch.pipeline.driver import check_supported

    with pytest.raises(ValueError, match="rgb_tail"):
        check_supported(cfg)



@pytest.fixture(scope="module")
def luma_runs(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("luma"))
    jsyn.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=48, nillums=3)
    return run_pair(prefix, luma_refine=True)


def test_luma_pipeline_tracks_jax(luma_runs):
    for name in ("jax", "torch"):
        p = luma_runs[name]["engine"].prop_params
        assert p.luma_refine and p.rgb_tail == 2 and p.n_illums == 3
    assert_alive_tracks_jax(luma_runs)
    assert_quality_tracks_jax(luma_runs)
