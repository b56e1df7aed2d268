"""Port filters (pipeline/filters.py) vs mvskit_tpu: each filter phase on
the same table and grid, carried across with interop before every
phase so no difference compounds. Killed masks and kill counts exact;
the rewritten view lists of filter_exact exact."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.core import patches as jpt
from mvskit_tpu.pipeline import filters as jfl
from mvskit_tpu_torch.pipeline import filters as tfl
from torch_replay import jax_table_to_torch, seeded_plane

LEVEL, CSIZE, WSIZE, TAU, MIN_NUM = 1, 2, 7, 6, 3
A1 = math.radians(60.0)
CAP = 16


@pytest.fixture(scope="module")
def sp():
    """Plane patches plus planted outliers: floaters lifted off the
    surface, and a tiny isolated clump far from the rest."""
    Ps, js, jt, ts, _ = seeded_plane(n_views=8, n_patches=160, capacity=512,
                                     seed=7, floaters=12, extent=0.6)
    n = int(np.asarray(jt.alive).sum())
    coord = np.array(jt.coord)
    base = coord[n - 1].copy()
    clump = np.tile(base, (3, 1))
    clump[:, 0] = 0.95 + np.arange(3) * 0.004
    clump[:, 1] = -0.95
    coord[n:n + 3] = clump
    f = {k: np.array(getattr(jt, k)) for k in ("normal", "ncc", "dscale",
                                               "ascale", "images", "vimages", "alive")}
    for k in ("normal", "ncc", "dscale", "ascale", "images"):
        f[k][n:n + 3] = f[k][n - 1]
    f["alive"][n:n + 3] = True
    jt = jpt.PatchTable(coord=jnp.asarray(coord), **{k: jnp.asarray(v) for k, v in f.items()})
    return js, ts, jt


def _rebuild(js, ts, jt, additive):
    jt2, jg = jfl.rebuild(js, jt, LEVEL, CSIZE, CAP, 0.5, additive=additive)
    tt2, tg = tfl.rebuild(ts, jax_table_to_torch(jt), LEVEL, CSIZE, CAP, 0.5,
                          additive=additive)
    np.testing.assert_array_equal(tt2.vimages.numpy(), np.asarray(jt2.vimages))
    np.testing.assert_array_equal(tg.slots.numpy(), np.asarray(jg.slots))
    np.testing.assert_array_equal(tg.vslots.numpy(), np.asarray(jg.vslots))
    return jt2, jg, tg


def _eq_kill(jres, tres, jt):
    (jt2, jn), (tt2, tn) = jres, tres
    np.testing.assert_array_equal(tt2.alive.numpy(), np.asarray(jt2.alive))
    assert tn == int(jn)
    return jt2


def test_filter_outside_matches(sp):
    js, ts, jt = sp
    jt, jg, tg = _rebuild(js, ts, jt, False)
    tt = jax_table_to_torch(jt)
    for thr in (0.7, 0.2):
        jr = jfl.filter_outside(js, jg, jt, LEVEL, CSIZE, thr, 1.0)
        tr = tfl.filter_outside(ts, tg, tt, LEVEL, CSIZE, thr, 1.0)
        _eq_kill(jr, tr, jt)
        np.testing.assert_allclose(
            tfl.compute_gains(ts, tg, tt, LEVEL, CSIZE, thr, 1.0).numpy(),
            np.asarray(jfl.compute_gains(js, jg, jt, LEVEL, CSIZE, thr, 1.0)),
            rtol=1e-5, atol=1e-5,
        )


def test_filter_exact_matches(sp):
    js, ts, jt = sp
    jt, jg, tg = _rebuild(js, ts, jt, True)
    jr = jfl.filter_exact(js, jg, jt, LEVEL, CSIZE, WSIZE, MIN_NUM, 1.0, A1)
    tr = tfl.filter_exact(ts, tg, jax_table_to_torch(jt), LEVEL, CSIZE, WSIZE,
                          MIN_NUM, 1.0, A1, chunk=64)
    _eq_kill(jr, tr, jt)
    np.testing.assert_array_equal(tr[0].images.numpy(), np.asarray(jr[0].images))


def test_filter_neighbor_matches(sp):
    js, ts, jt = sp
    jt, jg, tg = _rebuild(js, ts, jt, True)
    jr = jfl.filter_neighbor(js, jg, jt, LEVEL, CSIZE, TAU, 2.5, 0.5, chunk=128)
    tt = jax_table_to_torch(jt)
    tr = tfl.filter_neighbor_rows(ts, tg, tt, 0, tt.capacity, LEVEL, CSIZE,
                                  TAU, 2.5, 0.5, chunk=100)
    _eq_kill(jr, tr, jt)
    assert tr[1] >= 3, "the isolated clump must die"


def test_filter_small_groups_matches(sp):
    js, ts, jt = sp
    jt, jg, tg = _rebuild(js, ts, jt, True)
    for thr2 in (1.0, 0.05):
        jr = jfl.filter_small_groups(js, jg, jt, LEVEL, CSIZE, thr2)
        tr = tfl.filter_small_groups(ts, tg, jax_table_to_torch(jt), LEVEL,
                                     CSIZE, thr2, chunk=50)
        _eq_kill(jr, tr, jt)
    assert tr[1] > 0


def test_run_filters_matches(sp):
    js, ts, jt = sp
    kw = dict(level=LEVEL, csize=CSIZE, wsize=WSIZE, tau=TAU,
              min_image_num=MIN_NUM, cell_capacity=CAP, ncc_threshold=0.7,
              quad_threshold=2.5, neighbor_threshold=0.5,
              neighbor_threshold1=1.0, neighbor_threshold2=1.0,
              angle_threshold1=A1)
    jt2, js_ = jfl.run_filters(js, jt, **kw)
    tt2, ts_ = tfl.run_filters(ts, jax_table_to_torch(jt), **kw)
    np.testing.assert_array_equal(tt2.alive.numpy(), np.asarray(jt2.alive))
    assert tuple(ts_) == tuple(int(v) for v in js_)
    assert sum(ts_) > 0


def test_check_batch_matches(sp):
    """Optim::check on hypotheses not in the table: floaters above the
    surface and on-surface patches."""
    js, ts, jt = sp
    jt, jg, tg = _rebuild(js, ts, jt, True)
    rows = np.arange(40)
    c = np.array(jt.coord)[rows]
    c[::2, 2] += 0.15
    args = [c] + [np.array(getattr(jt, k))[rows] for k in
                  ("normal", "dscale", "ncc", "images", "vimages")]
    kw = dict(level=LEVEL, csize=CSIZE, tau=TAU, ncc_threshold=0.7,
              quad_threshold=2.5, neighbor_threshold=0.5, neighbor_threshold1=1.0)
    jr = jfl.check_batch(js, jg, jt, *[jnp.asarray(a) for a in args], **kw)
    tr = tfl.check_batch(ts, tg, jax_table_to_torch(jt),
                         *[torch.as_tensor(a) for a in args], **kw)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tr.any() and not tr.all()


def test_compute_radius_matches(sp):
    """Second-smallest per-view unit times csize, to 1e-5 relative."""
    js, ts, jt = sp
    n = int(np.asarray(jt.alive).sum())
    jr = np.asarray(jfl.compute_radius(js, jt, LEVEL, CSIZE))[:n]
    tr = tfl.compute_radius(ts, jax_table_to_torch(jt), LEVEL, CSIZE).numpy()[:n]
    np.testing.assert_allclose(tr, jr, rtol=1e-5)


def test_singular_quad_system_does_not_raise(sp):
    """No neighbors: the 5x5 system is (nearly) singular; the port keeps
    going (torch.linalg.solve_ex) as jnp.linalg.solve does."""
    js, ts, jt = sp
    tt = jax_table_to_torch(jt)
    nbrs = torch.full((4, 8), -1, dtype=torch.int32)
    resid, denom = tfl.quad_residuals_batch(ts, tt, tt.coord[:4], tt.normal[:4],
                                            tt.images[:4], nbrs, LEVEL, TAU)
    assert (denom == -5).all() and resid.shape == (4,)


def test_table_counts_match(sp):
    """PatchTable.n_images_per_patch / max_views against JAX."""
    js, ts, jt = sp
    tt = jax_table_to_torch(jt)
    assert tt.max_views == jt.max_views
    np.testing.assert_array_equal(tt.n_images_per_patch().numpy(),
                                  np.asarray(jt.n_images_per_patch()))
    assert int(tt.n_images_per_patch().sum()) > 0


def _alive_rows(jt):
    return np.flatnonzero(np.asarray(jt.alive)).astype(np.int32)


def test_gather_neighbors_matches(sp):
    """findNeighbors on table rows: the JAX neighbour sets and counts
    exactly, and tests/test_filters.py's properties (no duplicates, not
    self, interior rows with >= 6 neighbours)."""
    js, ts, jt = sp
    jt, jg, tg = _rebuild(js, ts, jt, True)
    rows = _alive_rows(jt)
    kw = dict(margin=2, scale=4.0, neighbor_threshold=0.5, max_neighbors=48)
    jn, jc = jfl.gather_neighbors(js, jg, jt, jnp.asarray(rows), LEVEL, CSIZE, **kw)
    tn, tc = tfl.gather_neighbors(ts, tg, jax_table_to_torch(jt), torch.as_tensor(rows),
                                  LEVEL, CSIZE, **kw)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert np.median(tc.numpy()) >= 6
    for i, r in enumerate(rows):
        nb = tn.numpy()[i][tn.numpy()[i] >= 0]
        assert len(set(nb.tolist())) == len(nb) and r not in nb


def test_quad_residuals_matches(sp):
    """filterQuad's residuals on table rows: the denominators exactly,
    the residuals to 1e-5 relative and 1e-4 absolute, and low on the
    plane (tests/test_filters.py). The absolute floor is float32's: on a
    coplanar neighbourhood the fit is exact and the residual, O(1e-5),
    is rounding in the 5x5 solve, which the two packages order
    differently."""
    js, ts, jt = sp
    jt, jg, tg = _rebuild(js, ts, jt, True)
    tt = jax_table_to_torch(jt)
    rows = _alive_rows(jt)
    kw = dict(margin=2, scale=4.0, neighbor_threshold=0.5, max_neighbors=48)
    jn, jc = jfl.gather_neighbors(js, jg, jt, jnp.asarray(rows), LEVEL, CSIZE, **kw)
    jr, jd = jfl.quad_residuals(js, jt, jnp.asarray(rows), jn, LEVEL, TAU)
    tr, td = tfl.quad_residuals(ts, tt, torch.as_tensor(rows),
                                torch.as_tensor(np.array(jn)), LEVEL, TAU)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-4)
    use = np.asarray(jc) >= 6
    assert use.any() and np.median(tr.numpy()[use]) < 0.5


def test_filter_neighbor_whole_table_matches(sp):
    """The whole-table entry point: JAX filter_neighbor's kill mask and
    count, and the port's filter_neighbor_rows over [0, capacity)."""
    js, ts, jt = sp
    jt, jg, tg = _rebuild(js, ts, jt, True)
    tt = jax_table_to_torch(jt)
    jr = jfl.filter_neighbor(js, jg, jt, LEVEL, CSIZE, TAU, 2.5, 0.5, chunk=128)
    tr = tfl.filter_neighbor(ts, tg, tt, LEVEL, CSIZE, TAU, 2.5, 0.5, chunk=128)
    _eq_kill(jr, tr, jt)
    rr = tfl.filter_neighbor_rows(ts, tg, tt, 0, tt.capacity, LEVEL, CSIZE, TAU,
                                  2.5, 0.5, chunk=128)
    np.testing.assert_array_equal(tr[0].alive.numpy(), rr[0].alive.numpy())
    assert tr[1] == rr[1] >= 3


def _gates(count, resid, denom, quad_threshold):
    """filterNeighbor's verdict on each row split by gate (the reject
    rule of filter_neighbor_rows): killed for fewer than 6 neighbours,
    killed by the quadric, and the survivors with denom < 1, with a
    residual under the threshold, and with a non-finite residual (which
    fails ``>=`` and so survives)."""
    reject = (count < 6) | ((denom >= 1) & (resid >= quad_threshold))
    fit = ~reject & (denom >= 1)
    return {"count_lt_6": int((count < 6).sum()),
            "quadric": int(((count >= 6) & (denom >= 1) & (resid >= quad_threshold)).sum()),
            "survive_denom_lt_1": int((~reject & (denom < 1)).sum()),
            "survive_resid_lt_threshold": int((fit & (resid < quad_threshold)).sum()),
            "survive_resid_not_finite": int((fit & ~np.isfinite(resid)).sum())}


def test_lifted_floaters_meet_the_same_gates_as_jax(tmp_path):
    """chip_smoke.py phase 13 at the pipeline pair's test size: on the
    final table of a port run (seed + 2 iterations, the small config of
    tests/test_torch_pipeline.py), every 50th alive row is lifted 0.2
    off the plane; both packages rebuild the filter grid and run
    filter_neighbor on that table. Kill mask and count equal; on the
    floaters the neighbour counts equal, the residuals within 1e-3 and
    the per-gate counts equal. The neighbour filter kills only some of
    them: the rest keep a quadric residual under the threshold, in
    JAX's filter as in the port's."""
    import jax

    from mvskit_tpu.config import MVSConfig as JMVSConfig
    from mvskit_tpu.image.scene import load_scene as jload_scene
    from mvskit_tpu.utils import synthetic as jsyn
    from mvskit_tpu_torch import interop
    from mvskit_tpu_torch.pipeline.driver import PMMVS
    from test_torch_pipeline import small_cfg

    prefix = str(tmp_path)
    jsyn.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=48)
    cfg = small_cfg(prefix)
    eng = PMMVS(cfg, device="cpu", log=lambda *a: None)
    eng.seed()
    for it in range(2):
        eng.propagate(it)
        eng.filter()
        eng.update_threshold()
        eng.depth += 1
    fields = interop.table_to_numpy(eng.table)
    lift = np.nonzero(fields["alive"])[0][::50]
    fields["coord"][lift, 2] += 0.2
    tt = interop.table_from_numpy(fields, device="cpu")
    jt = jpt.PatchTable(**{k: jnp.asarray(v) for k, v in fields.items()})
    jcfg = small_cfg(prefix, JMVSConfig)
    js = jload_scene(prefix, jcfg.images, jcfg.nillums, jcfg.max_level,
                     use_vis_data=bool(jcfg.use_vis_data))

    grid_args = (cfg.level, cfg.csize, cfg.filter_cell_capacity, cfg.neighbor_threshold)
    filt = (cfg.level, cfg.csize, cfg.tau, cfg.quad_threshold, cfg.neighbor_threshold)
    caps = dict(max_neighbors=cfg.neighbor_capacity, cand_cap=cfg.neighbor_cand_cap)
    nb = dict(margin=2, scale=4.0, neighbor_threshold=cfg.neighbor_threshold, **caps)

    def jax_side(s, t, rows):
        t, g = jfl.rebuild(s, t, *grid_args, additive=False)
        out, n = jfl.filter_neighbor(s, g, t, *filt, **caps)
        nbrs, count = jfl.gather_neighbors(s, g, t, rows, cfg.level, cfg.csize, **nb)
        return (out.alive, n, count) + jfl.quad_residuals(s, t, rows, nbrs, cfg.level,
                                                          cfg.tau)

    j_alive, j_n, j_count, j_resid, j_denom = (
        np.asarray(x) for x in jax.jit(jax_side)(js, jt, jnp.asarray(lift, jnp.int32)))

    ts = eng.scene
    tt, tg = tfl.rebuild(ts, tt, *grid_args, additive=False)
    out, t_n = tfl.filter_neighbor(ts, tg, tt, *filt, **caps)
    rows = torch.as_tensor(lift, dtype=torch.int32)
    nbrs, count = tfl.gather_neighbors(ts, tg, tt, rows, cfg.level, cfg.csize, **nb)
    resid, denom = tfl.quad_residuals(ts, tt, rows, nbrs, cfg.level, cfg.tau)

    np.testing.assert_array_equal(out.alive.numpy(), j_alive)
    assert t_n == int(j_n)
    np.testing.assert_array_equal(count.numpy(), j_count)
    np.testing.assert_array_equal(denom.numpy(), j_denom)
    # a floater whose neighbours fit a quadric almost exactly solves a
    # near-singular 5x5 system: float32 sums in another order move its
    # residual near 0 by up to a few 1e-4, against a threshold of 2.5
    np.testing.assert_allclose(resid.numpy(), j_resid, rtol=1e-5, atol=1e-3)
    gates = _gates(count.numpy(), resid.numpy(), denom.numpy(), cfg.quad_threshold)
    assert gates == _gates(j_count, j_resid, j_denom, cfg.quad_threshold)
    killed = int((~out.alive.numpy()[lift]).sum())
    assert killed == gates["count_lt_6"] + gates["quadric"]
    assert 0 < killed < len(lift) == sum(gates.values())
    assert gates["survive_resid_lt_threshold"] > 0
