"""Port cell grid (core/grid.py) and patch table helpers vs mvskit_tpu on
one table carried across with interop: slots, evictions, depth-map
indices, visibility and vimages exact; depths to 1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.core import grid as jgr
from mvskit_tpu.core import patches as jpt
from mvskit_tpu_torch.core import grid as tgr
from mvskit_tpu_torch.core import patches as tpt
from mvskit_tpu_torch import interop
from torch_replay import jax_table_to_torch, seeded_plane

LEVEL, CSIZE = 1, 2


@pytest.fixture(scope="module")
def sp():
    Ps, js, jt, ts, tt = seeded_plane(n_views=8, n_patches=96, capacity=256,
                                      seed=6, floaters=6)
    return js, jt, ts, tt


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("capacity,row_limit", [(8, None), (2, None), (4, 128)])
def test_build_grid_matches(sp, capacity, row_limit):
    js, jt, ts, tt = sp
    jg = jgr.build_grid(js, jt, LEVEL, CSIZE, capacity, row_limit=row_limit)
    tg = tgr.build_grid(ts, tt, LEVEL, CSIZE, capacity, row_limit=row_limit)
    _eq(tg.slots, jg.slots)
    _eq(tg.vslots, jg.vslots)
    _eq(tg.evicted, jg.evicted)
    _eq(tg.depth_idx, jg.depth_idx)
    np.testing.assert_allclose(tg.depth.numpy(), np.asarray(jg.depth), rtol=1e-5)
    if capacity == 2:
        assert tg.evicted.any(), "small capacity must evict"


def test_eviction_ties_keep_pair_order(sp):
    """Equal-NCC co-located patches: the two-key stable sort keeps the
    lower row first, as lax.sort does."""
    js, _, ts, _ = sp
    B = 10
    coord = np.tile([[0.05, 0.05, 0.0, 1.0]], (B, 1)).astype(np.float32)
    normal = np.tile([[0.0, 0.0, 1.0, 0.0]], (B, 1)).astype(np.float32)
    images = np.full((B, 8), -1, np.int32)
    images[:, 0] = 0
    ncc = np.repeat([0.5, 0.8], 5).astype(np.float32)
    jt = jpt.from_numpy(coord, normal, images, 32, 8, ncc=ncc)
    tt = jax_table_to_torch(jt)
    jg = jgr.build_grid(js, jt, LEVEL, CSIZE, 3)
    tg = tgr.build_grid(ts, tt, LEVEL, CSIZE, 3)
    _eq(tg.slots, jg.slots)
    _eq(tg.evicted, jg.evicted)
    assert set(np.nonzero(~tg.evicted.numpy()[:B])[0]) == {5, 6, 7}


def test_visibility_and_vimages_match(sp):
    js, jt, ts, tt = sp
    jg = jgr.build_grid(js, jt, LEVEL, CSIZE, 8)
    tg = tgr.build_grid(ts, tt, LEVEL, CSIZE, 8)
    for use_depth in (True, False):
        jv = jgr.set_vimages(js, jg, jt, LEVEL, CSIZE, 0.5, use_depth)
        tv = tgr.set_vimages(ts, tg, tt, LEVEL, CSIZE, 0.5, use_depth, chunk=40)
        _eq(tv, jv)
    assert (tv.numpy() >= 0).any()
    n = 32
    lists = np.array(jt.images)[:n]
    jc, jn = jt.coord[:n], jt.normal[:n]
    jx, jy, jval = jgr.patch_cells(js, jc, jnp.asarray(lists), LEVEL, CSIZE)
    tx, ty, tval = tgr.patch_cells(ts, tt.coord[:n], torch.as_tensor(lists), LEVEL, CSIZE)
    _eq(tval, jval)
    m = np.asarray(jval)
    np.testing.assert_array_equal(tx.numpy()[m], np.asarray(jx)[m])
    np.testing.assert_array_equal(ty.numpy()[m], np.asarray(jy)[m])
    jvis = jgr.is_visible(js, jg, jt, jc[:, None], jn[:, None], jnp.maximum(jnp.asarray(lists), 0),
                          jx, jy, 0.5, LEVEL, CSIZE)
    tvis = tgr.is_visible(ts, tg, tt, tt.coord[:n, None], tt.normal[:n, None],
                          torch.as_tensor(lists).clamp(min=0), tx, ty, 0.5, LEVEL, CSIZE)
    _eq(tvis, jvis)


def test_compact_table_and_list_helpers(sp):
    _, jt, _, tt = sp
    alive = np.array(jt.alive)
    alive[np.nonzero(alive)[0][::3]] = False
    jc = jpt.compact_table(jt._replace(alive=jnp.asarray(alive)))
    tc = tpt.compact_table(tt._replace(alive=torch.as_tensor(alive)))
    for k in interop.TABLE_FIELDS:
        _eq(getattr(tc, k), getattr(jc, k))
    lists = np.array(jt.images)[:40]
    lists[::4, 2:] = -1
    _eq(tpt.member_mask(torch.as_tensor(lists), 8), jpt.member_mask(jnp.asarray(lists), 8))
    _eq(tpt.position_in_list(torch.as_tensor(lists), 8),
        jpt.position_in_list(jnp.asarray(lists), 8))
    keys = np.random.default_rng(0).integers(0, 4, (40, 8)).astype(np.float32)
    keys[keys == 3] = 1e30
    _eq(tpt.compact_by_keys(torch.as_tensor(keys)), jpt.compact_by_keys(jnp.asarray(keys)))


def test_interop_round_trip(sp):
    _, jt, _, tt = sp
    back = interop.table_to_numpy(tt)
    for k in interop.TABLE_FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jt, k)))
        assert back[k].dtype == np.asarray(getattr(jt, k)).dtype, k


def test_from_numpy_takes_jax_positional_order():
    """A call in JAX's order (ncc .. vimages positional) fills the same
    fields; the port's device is keyword-only."""
    rng = np.random.default_rng(11)
    n = 12
    arrays = (rng.normal(size=(n, 4)).astype(np.float32),
              rng.normal(size=(n, 4)).astype(np.float32),
              rng.integers(-1, 8, (n, 10)).astype(np.int32), 32, 8,
              rng.uniform(size=n).astype(np.float32),
              rng.uniform(size=n).astype(np.float32),
              rng.uniform(size=n).astype(np.float32),
              rng.integers(-1, 8, (n, 10)).astype(np.int32))
    jt = jpt.from_numpy(*arrays)
    tt = tpt.from_numpy(*arrays, device="cpu")
    for k in jt._fields:
        _eq(getattr(tt, k), getattr(jt, k))
    with pytest.raises(TypeError):
        tpt.from_numpy(*arrays, "cpu")


def test_build_depth_maps_takes_jax_positional_order(sp):
    """row_start, row_count, row_limit bound by position as JAX binds them."""
    js, jt, ts, tt = sp
    jd, ji = jgr.build_depth_maps(js, jt, LEVEL, CSIZE, 3, 5, 64)
    td, ti = tgr.build_depth_maps(ts, tt, LEVEL, CSIZE, 3, 5, 64)
    assert td.shape == jd.shape and td.shape[1] == 5
    _eq(ti, ji)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    assert (ti.numpy() >= 0).any()
