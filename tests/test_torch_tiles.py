"""Tile-sharded propagation of mvskit_tpu_torch/parallel/tiles.py (mirrors
tests/test_tiles.py) at k = 2 and 8 row tiles on copies of the CPU:
grid build, donor selection, the halo full-cell gate in both directions
and the whole round.

Tolerances: against the unsharded port, exact (every output, the round
fed the same noise). Against the JAX package's tiles.* on its 8 virtual
CPU devices, fed the JAX key tree (tests/torch_replay.py), those of
tests/test_torch_grid.py and test_torch_propagate.py: integer outputs
exact, depth rtol 1e-5, gate NCC rtol 1e-6; the round's counts within
+-1 % and >= 98 % of its inserted rows at the same coordinates to 1e-3
(a near-tie in the refinement argmin or the insertion order can move a
row)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.parallel import shard as jsh
from mvskit_tpu.parallel import tiles as jtiles
from mvskit_tpu.pipeline import propagate as jpr
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.core import grid as tgr
from mvskit_tpu_torch.parallel import shard as tsh
from mvskit_tpu_torch.parallel import tiles as ttiles
from mvskit_tpu_torch.pipeline import propagate as tpr
from torch_replay import _JaxRound, jax_scene_to_torch

LEVEL, CSIZE, CAP = 1, 2, 8
PARAMS = dict(
    level=LEVEL, csize=CSIZE, wsize=7, tau=6, min_image_num=3, cell_capacity=CAP,
    angle_threshold0=math.radians(60.0), angle_threshold1=math.radians(60.0),
    max_angle_threshold=math.radians(10.0), ascale=math.pi / 48.0,
    refine_rounds=2, refine_cands=2, refine_shrink=0.8, refine_depth_radius=4.0,
    refine_angle_radius=8.0, neighbor_threshold=0.5, donor_budget=64, chunk=32,
)


@pytest.fixture(scope="module")
def sp():
    """A 6-view plane scene and a table of 48 seeded patches (views by
    add_images + sortImages, scales, NCC: the port's own functions), in
    both packages: the JAX table holds the port table's values."""
    from mvskit_tpu.core.patches import PatchTable as JPatchTable
    from mvskit_tpu_torch import interop
    from mvskit_tpu_torch.core import patches as tpt
    from mvskit_tpu_torch.ops import ncc as tncc
    from mvskit_tpu_torch.pipeline import views as tvw

    Ps, _, js = jsyn.plane_scene(n_views=6, width=160, height=120)
    ts = jax_scene_to_torch(js, Ps)
    coord, normal = jsyn.plane_points(Ps, 48, seed=1, extent=0.6)
    c = torch.as_tensor(coord, dtype=torch.float32)
    n = torch.as_tensor(normal, dtype=torch.float32)
    a = math.radians(60.0)
    images = tvw.add_images(ts, c, n, torch.full((48, 6), -1, dtype=torch.int32), LEVEL, a)
    images = tvw.sort_images(ts, c, n, images, LEVEL, is_fixed=False)
    dscale, ascale = tvw.set_scales(ts, c, images, LEVEL, 6, 7)
    ncc = tncc.compute_patch_ncc(ts, images, c, n, LEVEL, 7, 6, a)
    tt = tpt.from_numpy(c.numpy(), n.numpy(), images.numpy(), 1024, 6,
                        ncc=ncc.numpy(), dscale=dscale.numpy(), ascale=ascale.numpy(),
                        device="cpu")
    tt = tt._replace(alive=tt.alive & (tpt.count_valid(tt.images) > 0))
    jt = JPatchTable(**{k: jnp.asarray(v) for k, v in interop.table_to_numpy(tt).items()})
    return js, jt, ts, tt


def _tmesh(k):
    return tsh.make_mesh(k, "tile", device="cpu")


@pytest.mark.parametrize("k", [2, 8])
def test_tiled_build_grid_matches(sp, k):
    js, jt, ts, tt = sp
    want = tgr.build_grid(ts, tt, LEVEL, CSIZE, CAP)
    got_t = ttiles.tiled_build_grid(_tmesh(k), ts, tt, LEVEL, CSIZE, CAP)
    got = ttiles.tiled_grid_to_global(ts, got_t, LEVEL, CSIZE)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # padded rows beyond gh hold no cells
    _, gh = tgr.grid_dims(ts, LEVEL, CSIZE)
    assert got_t.slots.shape[1] % k == 0 and (got_t.slots[:, gh:] == -1).all()
    # the live-row bound composes with the row windows
    bounded = ttiles.tiled_build_grid(_tmesh(k), ts, tt, LEVEL, CSIZE, CAP, row_limit=64)
    for a, b in zip(bounded, got_t):
        assert torch.equal(a, b)

    mesh = jsh.make_mesh(k, axis="tile")
    jg = jax.jit(lambda t: jtiles.tiled_build_grid(mesh, js, t, LEVEL, CSIZE, CAP))(jt)
    for f in ("slots", "vslots", "depth_idx", "evicted"):
        np.testing.assert_array_equal(getattr(got_t, f).numpy(), np.asarray(getattr(jg, f)))
    np.testing.assert_allclose(got_t.depth.numpy(), np.asarray(jg.depth), rtol=1e-5)


def test_tiled_select_donors_matches(sp):
    js, jt, ts, tt = sp
    budget = 64
    want = tpr.select_donors(ts, tgr.build_grid(ts, tt, LEVEL, CSIZE, CAP), tt, budget)
    gt = ttiles.tiled_build_grid(_tmesh(8), ts, tt, LEVEL, CSIZE, CAP)
    got = ttiles.tiled_select_donors(_tmesh(8), ts, gt, tt, budget, LEVEL, CSIZE)
    ok = want[4]
    assert torch.equal(got[4], ok) and ok.sum() > 0
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a[ok], b[ok])

    mesh = jsh.make_mesh(8, axis="tile")

    def run(t):
        g = jtiles.tiled_build_grid(mesh, js, t, LEVEL, CSIZE, CAP)
        return jtiles.tiled_select_donors(mesh, js, g, t, budget, LEVEL, CSIZE)
    jd = jax.jit(run)(jt)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(jd[4]))
    for a, b in zip(got[:4], jd[:4]):
        np.testing.assert_array_equal(a.numpy()[ok.numpy()], np.asarray(b)[ok.numpy()])


def test_tiled_select_donors_budget_beyond_a_tile(sp):
    """A budget larger than one tile's slots (JAX's lax.top_k refuses it,
    tiles.py:196): every tile gives all its slots, and the merge still
    equals select_donors. A budget beyond the whole grid raises."""
    _, _, ts, tt = sp
    k = 8
    n = ts.n_images
    gw, gh = tgr.grid_dims(ts, LEVEL, CSIZE)
    gh_l, _ = ttiles._tile_rows(ts, LEVEL, CSIZE, k)
    budget = n * gh_l * gw * CAP + 1
    want = tpr.select_donors(ts, tgr.build_grid(ts, tt, LEVEL, CSIZE, CAP), tt, budget)
    gt = ttiles.tiled_build_grid(_tmesh(k), ts, tt, LEVEL, CSIZE, CAP)
    got = ttiles.tiled_select_donors(_tmesh(k), ts, gt, tt, budget, LEVEL, CSIZE)
    ok = want[4]
    assert got[0].shape == (budget,) and torch.equal(got[4], ok)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a[ok], b[ok])
    with pytest.raises(ValueError, match="exceeds"):
        ttiles.tiled_select_donors(_tmesh(k), ts, gt, tt, n * gh * gw * CAP + 1, LEVEL,
                                   CSIZE)


@pytest.mark.parametrize("direction", [1, -1])
def test_tiled_full_cell_gate_matches(sp, direction):
    """At a cell capacity of 1, so that donors meet full target cells,
    across tile boundaries too."""
    js, jt, ts, tt = sp
    cap = 1
    grid = tgr.build_grid(ts, tt, LEVEL, CSIZE, cap)
    pidx, img, cy, cx, ok = tpr.select_donors(ts, grid, tt, 64)
    gw, gh = tgr.grid_dims(ts, LEVEL, CSIZE)
    gt = ttiles.tiled_build_grid(_tmesh(8), ts, tt, LEVEL, CSIZE, cap)
    mesh = jsh.make_mesh(8, axis="tile")
    for axis_sp in (0, 1):
        ty = cy.numpy() + (direction if axis_sp == 1 else 0)
        tx = cx.numpy() + (direction if axis_sp == 0 else 0)
        inb = (tx >= 0) & (tx < gw) & (ty >= 0) & (ty < gh)
        worst = grid.slots.numpy()[img.numpy(), np.clip(ty, 0, gh - 1),
                                   np.clip(tx, 0, gw - 1), cap - 1]
        want_full, want_ncc = worst >= 0, tt.ncc.numpy()[np.maximum(worst, 0)]
        full, worst_ncc = ttiles.tiled_full_cell_gate(
            _tmesh(8), ts, gt, tt, img, cy, cx, axis_sp, direction, LEVEL, CSIZE)
        # gate values only matter for in-bounds targets of ok donors
        m = inb & ok.numpy()
        assert m.sum() > 0
        np.testing.assert_array_equal(full.numpy()[m], want_full[m])
        mm = m & want_full
        assert mm.sum() > 0
        np.testing.assert_array_equal(worst_ncc.numpy()[mm], want_ncc[mm])

        def run(t, axis_sp=axis_sp):
            g = jtiles.tiled_build_grid(mesh, js, t, LEVEL, CSIZE, cap)
            return jtiles.tiled_full_cell_gate(
                mesh, js, g, t, jnp.asarray(img.numpy()),
                jnp.asarray(cy.numpy()), jnp.asarray(cx.numpy()),
                axis_sp, direction, LEVEL, CSIZE)
        jfull, jncc = jax.jit(run)(jt)
        np.testing.assert_array_equal(full.numpy()[m], np.asarray(jfull)[m])
        np.testing.assert_allclose(worst_ncc.numpy()[mm], np.asarray(jncc)[mm], rtol=1e-6)


@pytest.mark.parametrize("k", [2, 8])
def test_tiled_propagate_round_matches(sp, k):
    js, jt, ts, tt = sp
    p = tpr.PropagateParams(**PARAMS)

    def noise():
        gen = torch.Generator()
        gen.manual_seed(7)
        return tpr.TorchNoise(gen)

    args = (p, 1, 0.7, 0.4)
    want, wstats = tpr.propagate_round(ts, tt, noise(), *args, row_limit=64)
    got, gstats = ttiles.tiled_propagate_round(_tmesh(k), ts, tt, noise(), *args,
                                               row_limit=64)
    assert gstats == wstats and wstats.passed > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    # against the JAX package's tiled round under the same key
    key = jax.random.PRNGKey(7)
    mesh = jsh.make_mesh(k, axis="tile")
    jp = jpr.PropagateParams(**PARAMS)
    jt2, jst = jax.jit(lambda s, t, kk: jtiles.tiled_propagate_round(
        mesh, s, t, kk, jp, 1, 0.7, 0.4))(js, jt, key)
    tt2, tst = ttiles.tiled_propagate_round(_tmesh(k), ts, tt, _JaxRound(key), *args,
                                            row_limit=64)
    for a, b in zip(jst, tst):
        assert abs(int(a) - b) <= max(1, 0.01 * int(a)), (jst, tst)
    new = np.asarray(jt2.alive) & ~np.asarray(jt.alive)
    close = np.abs(tt2.coord.numpy()[new] - np.asarray(jt2.coord)[new]).max(1) <= 1e-3
    close &= tt2.alive.numpy()[new]
    assert new.sum() > 0 and close.mean() >= 0.98, close.mean()


def test_tiled_propagate_round_takes_jax_positional_axis(sp):
    """use_depth, quad_threshold and the mesh axis bound by position as
    JAX binds them (an axis named "rows", which no default supplies)."""
    js, jt, ts, tt = sp
    p = tpr.PropagateParams(**PARAMS)
    key = jax.random.PRNGKey(7)
    mesh = jsh.make_mesh(2, axis="rows")
    jp = jpr.PropagateParams(**PARAMS)
    jt2, jst = jax.jit(lambda s, t, kk: jtiles.tiled_propagate_round(
        mesh, s, t, kk, jp, 1, 0.7, 0.4, True, 2.5, "rows"))(js, jt, key)
    tt2, tst = ttiles.tiled_propagate_round(
        tsh.make_mesh(2, "rows", device="cpu"), ts, tt, _JaxRound(key), p, 1, 0.7, 0.4,
        True, 2.5, "rows")
    for a, b in zip(jst, tst):
        assert abs(int(a) - b) <= max(1, 0.01 * int(a)), (jst, tst)
    new = np.asarray(jt2.alive) & ~np.asarray(jt.alive)
    close = np.abs(tt2.coord.numpy()[new] - np.asarray(jt2.coord)[new]).max(1) <= 1e-3
    close &= tt2.alive.numpy()[new]
    assert new.sum() > 0 and close.mean() >= 0.98, close.mean()
