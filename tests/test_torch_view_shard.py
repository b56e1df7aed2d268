"""View-sharded sampling of mvskit_tpu_torch (mirrors tests/test_view_shard.py):
every consumer of a scene marked by parallel/shard.enable_view_sharding
(texs_for_views, compute_patch_ncc, refine_batch, a propagation round,
the driver) equals the unsharded port bit for bit, at k = 2 and 8 shards
of 8 views on copies of the CPU, for ungrouped and grouped (group 4 and
32) batches, the luma form and 3 illuminations; and matches the JAX
package's view-sharded call on its 8 virtual CPU devices (gather path)
within atol 1e-5, JAX's own bound (test_view_shard.py:53-55).

Bit-equality holds because each shard samples its own windows, each
computed alone by the same plain version (the kernel on the card,
tests/test_torch_cuda.py), and they are copied, not summed, into the
home output."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.ops import ncc as jncc
from mvskit_tpu.parallel import shard as jsh
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.ops import ncc as tncc
from mvskit_tpu_torch.parallel import shard as tsh
from mvskit_tpu_torch.pipeline import propagate as tpr
from mvskit_tpu_torch.pipeline import refine as trf
from mvskit_tpu_torch.pipeline import views as tvw
from torch_replay import jax_scene_to_torch

LEVEL, WSIZE, TAU = 1, 7, 6
A1 = math.radians(60.0)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# the JAX package's texs_for_views, compiled once per mesh and mode (its
# eager shard_map takes ~30 s a call on the CPU)
_jtexs = jax.jit(jncc.texs_for_views, static_argnames=(
    "level", "wsize", "angle_threshold1", "illum", "luma", "group"))


def _vshard(scene, k):
    return tsh.enable_view_sharding(scene, tsh.make_mesh(k, "view", device="cpu"))


def _jshard(js, k):
    return jsh.enable_view_sharding(js, jsh.make_mesh(k, axis="view"))


def _seeded_table(ts, coord, normal, views, capacity=1024):
    """The port's patch table of plane patches: views by sortImages,
    scales and NCC from the port's own functions."""
    from mvskit_tpu_torch.core import patches as tpt

    c, n = _t(coord), _t(normal)
    images = tvw.sort_images(ts, c, n, _t(views), LEVEL, is_fixed=False)
    dscale, ascale = tvw.set_scales(ts, c, images, LEVEL, TAU, WSIZE)
    ncc = tncc.compute_patch_ncc(ts, images, c, n, LEVEL, WSIZE, TAU, A1)
    return tpt.from_numpy(coord, normal, images.numpy(), capacity, ts.n_images, "cpu",
                          ncc=ncc.numpy(), dscale=dscale.numpy(), ascale=ascale.numpy())


@pytest.fixture(scope="module")
def sp():
    Ps, _, js = jsyn.plane_scene(n_views=8, width=160, height=120)
    coord, normal = jsyn.plane_points(Ps, 32, extent=0.6)
    views = np.tile(np.arange(8, dtype=np.int32), (32, 1))
    return js, jax_scene_to_torch(js, Ps), coord.astype(np.float32), \
        normal.astype(np.float32), views


def _candidates(coord, normal, views, group):
    """`group` jittered copies of each patch (one candidate group per
    patch, the same view row), as refine_batch lays them out."""
    rng = np.random.default_rng(group)
    c = np.repeat(coord, group, 0)
    c[:, 2] += rng.uniform(-0.02, 0.02, c.shape[0]).astype(np.float32)
    return c, np.repeat(normal, group, 0), np.repeat(views, group, 0)


@pytest.mark.parametrize("mode", ["rgb", "luma", "group4", "group32"])
@pytest.mark.parametrize("k", [2, 8])
def test_view_sharded_texs_match(sp, k, mode):
    js, ts, coord, normal, views = sp
    luma = mode == "luma"
    group = int(mode[5:]) if mode.startswith("group") else 1
    c, n, v = _candidates(coord, normal, views[:, :TAU], group)
    args = (_t(v), _t(c), _t(n), LEVEL, WSIZE, A1, (0,), luma, group)
    vs = _vshard(ts, k)
    assert vs.view_mesh is not None and len(vs.view_shards) == k
    tncc.reset_shard_stats()
    got_t, got_v = tncc.texs_for_views_illums(vs, *args)[0]
    want_t, want_v = tncc.texs_for_views_illums(ts, *args)[0]
    assert torch.equal(got_t, want_t) and torch.equal(got_v, want_v)
    # one sync per sampler call; each shard owning a used view launched
    # its own form once
    assert tncc.SHARD_SYNCS["sampler"] == 1
    form = ("luma_" if luma else "") + ("grouped" if group > 1 else "ungrouped")
    used = {int(x) // (8 // k) for x in np.unique(v)}
    assert {s for s, f in tncc.SHARD_CALLS} == used
    assert {f for _, f in tncc.SHARD_CALLS} == {form}

    jt, jv = _jtexs(_jshard(js, k), jnp.asarray(v), jnp.asarray(c), jnp.asarray(n),
                    level=LEVEL, wsize=WSIZE, angle_threshold1=A1, luma=luma, group=group)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(jt), atol=1e-5)


@pytest.fixture(scope="module")
def plane3(sp):
    """The plane of `sp` under 3 illuminations: 3 textures."""
    from mvskit_tpu.image.scene import scene_from_arrays

    Ps = jsyn.ring_cameras(8, 160, 120)
    imgs = [jsyn.render_plane_views(Ps, 160, 120, seed=s) for s in range(3)]
    js = scene_from_arrays(Ps, [np.stack(v) for v in zip(*imgs)], max_level=4)
    _, _, coord, normal, views = sp
    return js, jax_scene_to_torch(js, Ps), coord, normal, views


@pytest.mark.parametrize("k", [2, 8])
def test_view_sharded_three_illuminations(plane3, k):
    js, ts, coord, normal, views = plane3
    assert ts.n_illums == 3
    args = (_t(views[:, :TAU]), _t(coord), _t(normal), LEVEL, WSIZE, A1, range(3))
    got = tncc.texs_for_views_illums(_vshard(ts, k), *args)
    want = tncc.texs_for_views_illums(ts, *args)
    jscene = _jshard(js, k)
    for il, ((gt, gv), (wt, wv)) in enumerate(zip(got, want)):
        assert torch.equal(gt, wt) and torch.equal(gv, wv)
        jt, jv = _jtexs(jscene, jnp.asarray(views[:, :TAU]), jnp.asarray(coord),
                        jnp.asarray(normal), level=LEVEL, wsize=WSIZE,
                        angle_threshold1=A1, illum=il)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(gt.numpy(), np.asarray(jt), atol=1e-5)
    # the scores averaged over the illuminations
    s_args = (_t(views), _t(coord), _t(normal), LEVEL, WSIZE, TAU, A1)
    assert torch.equal(tncc.compute_patch_ncc_n(_vshard(ts, k), *s_args, n_illums=3),
                       tncc.compute_patch_ncc_n(ts, *s_args, n_illums=3))


def test_view_sharded_patch_ncc_matches(sp):
    js, ts, coord, normal, views = sp
    args = (_t(views), _t(coord), _t(normal), LEVEL, WSIZE, TAU, A1)
    got = tncc.compute_patch_ncc(_vshard(ts, 8), *args)
    assert torch.equal(got, tncc.compute_patch_ncc(ts, *args))
    score = jax.jit(jncc.compute_patch_ncc, static_argnums=(4, 5, 6, 7))
    want = np.asarray(score(_jshard(js, 8), jnp.asarray(views), jnp.asarray(coord),
                            jnp.asarray(normal), LEVEL, WSIZE, TAU, A1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("luma", [False, True])
def test_view_sharded_refine_matches(sp, luma):
    _, ts, coord, normal, views = sp
    c, n = _t(coord), _t(normal)
    images = tvw.sort_images(ts, c, n, _t(views), LEVEL, is_fixed=False)
    dscale, _ = tvw.set_scales(ts, c, images, LEVEL, TAU, WSIZE)
    deltas = torch.from_numpy(
        np.random.default_rng(5).uniform(-1, 1, (3, 32, 4, 3)).astype(np.float32))
    kw = dict(level=LEVEL, wsize=WSIZE, tau=TAU, min_image_num=3, angle_threshold1=A1,
              ascale=math.pi / 48.0, rounds=3, n_cands=4, shrink=0.8,
              init_depth_radius=4.0, init_angle_radius=8.0, luma=luma, rgb_tail=1)
    want = trf.refine_batch(ts, c, n, images, dscale, deltas, **kw)
    got = trf.refine_batch(_vshard(ts, 8), c, n, images, dscale, deltas, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_view_sharded_propagate_round_matches(sp):
    _, ts, coord, normal, views = sp
    tt = _seeded_table(ts, coord, normal, views)
    p = tpr.PropagateParams(
        level=1, csize=2, wsize=7, tau=6, min_image_num=3, cell_capacity=8,
        angle_threshold0=A1, angle_threshold1=A1,
        max_angle_threshold=math.radians(10.0), ascale=math.pi / 48.0,
        refine_rounds=2, refine_cands=2, refine_shrink=0.8,
        refine_depth_radius=4.0, refine_angle_radius=8.0,
        neighbor_threshold=0.5, donor_budget=64, chunk=32)

    def run(scene):
        gen = torch.Generator()
        gen.manual_seed(11)
        return tpr.propagate_round(scene, tt, None, p, 1, 0.7, 0.4, generator=gen)

    want, wstats = run(ts)
    got, gstats = run(_vshard(ts, 8))
    assert gstats == wstats and wstats.passed > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_driver_accepts_view_mesh(sp):
    """PMMVS(cfg, scene, view_mesh=...) runs its gauntlet view-sharded;
    with cfg.mesh_view > 1 as well it raises (the JAX driver shards the
    views twice there, driver.py:123-133)."""
    from mvskit_tpu_torch.config import MVSConfig
    from mvskit_tpu_torch.pipeline.driver import PMMVS

    _, ts, coord, normal, views = sp
    tt = _seeded_table(ts, coord, normal, views)
    cfg = MVSConfig(prefix=".", images=list(range(8)), level=LEVEL, csize=2,
                    wsize=WSIZE, min_image_num=3, max_patches=1024, donor_budget=64,
                    gauntlet_chunk=32, refine_rounds=2, refine_cands=2,
                    prop_rounds=1, n_iterations=1)
    mesh = tsh.make_mesh(8, "view", device="cpu")
    eng = PMMVS(cfg, scene=ts, log=lambda *a: None, view_mesh=mesh)
    assert eng.scene.view_mesh is mesh
    eng.table = tt
    eng.propagate(0)
    assert eng.table.n_alive() > tt.n_alive()
    cfg.mesh_view = 2
    with pytest.raises(ValueError, match="twice"):
        PMMVS(cfg, scene=ts, log=lambda *a: None, view_mesh=mesh)


def test_view_count_must_divide(sp):
    _, ts, *_ = sp
    with pytest.raises(ValueError, match="not divisible"):
        _vshard(ts, 3)
