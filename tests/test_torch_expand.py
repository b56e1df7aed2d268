"""The pmvs strategy (pipeline/expand.py) of mvskit_tpu_torch against
mvskit_tpu on the same inputs, the port fed the JAX keys' numbers.

Tolerances and why:
  * find_empty_sectors: candidate coordinates 1e-5 (float32 cos/sin and
    projections in another order); the empty-sector mask exactly, since
    only `fill <= 0` is read and every fill weight is >= 0, so it can
    only flip when a neighbor sits on a sector boundary to the last bit
    of arctan2 (the assertion reports how many flipped);
  * check_counts and update_counts: exact (integer cell arithmetic);
  * two expand rounds from the JAX test's sparse seeds
    (tests/test_extras.py:121-156): RoundStats within +-1 % (or one
    hypothesis) and >= 98 % of JAX's inserted patches found among the
    port's to 1e-3 in coord (a near-tie in the refinement argmin can
    move one, and a neighbor exactly on a sector boundary can open one
    more sector in one package than in the other: on the 12-seed plane
    one neighbor of round 2 sits at 240 degrees, and the port spawns one
    candidate more);
  * the driver pair (tests/test_torch_pipeline.py's run_pair with
    strategy pmvs): alive within 3 % of JAX at every iteration, quality
    within 10 % relative."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.core import grid as jgr
from mvskit_tpu.pipeline import expand as jex
from mvskit_tpu.pipeline import filters as jfl
from mvskit_tpu.pipeline import propagate as jpr
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.core import grid as tgr
from mvskit_tpu_torch.pipeline import expand as tex
from mvskit_tpu_torch.pipeline import filters as tfl
from mvskit_tpu_torch.pipeline import propagate as tpr
from test_grid import make_seeded_table
from test_torch_pipeline import assert_alive_tracks_jax, assert_quality_tracks_jax, run_pair
from torch_replay import JaxExpandRound, jax_scene_to_torch, jax_table_to_torch, seeded_plane

LEVEL, CSIZE = 1, 2
BASE = dict(
    level=LEVEL, csize=CSIZE, wsize=7, tau=6, min_image_num=3, cell_capacity=8,
    angle_threshold0=math.radians(60.0), angle_threshold1=math.radians(60.0),
    max_angle_threshold=math.radians(10.0), ascale=math.pi / 48.0,
    refine_rounds=6, refine_cands=4, refine_shrink=0.8,
    refine_depth_radius=4.0, refine_angle_radius=8.0,
    neighbor_threshold=0.5, donor_budget=96, chunk=48,
)


@pytest.fixture(scope="module")
def dense():
    """A seeded 64-patch plane table and its grids in both packages."""
    Ps, js, jt, ts, tt = seeded_plane(n_views=6, n_patches=64, capacity=1024,
                                      seed=9, extent=0.6)
    return (js, jt, jgr.build_grid(js, jt, LEVEL, CSIZE, 8),
            ts, tt, tgr.build_grid(ts, tt, LEVEL, CSIZE, 8))


def _sectors(dense):
    js, jt, jg, ts, tt, tg = dense
    rows = np.arange(48, dtype=np.int32)
    jc, je = jex.find_empty_sectors(js, jg, jt, jnp.asarray(rows), LEVEL, CSIZE, 0.5)
    tc, te = tex.find_empty_sectors(ts, tg, tt, torch.as_tensor(rows), LEVEL, CSIZE, 0.5)
    return np.asarray(jc), np.asarray(je), tc, te


def test_score2_matches(dense):
    _, jt, _, _, tt, _ = dense
    np.testing.assert_allclose(tfl.score2(tt, 0.7).numpy(),
                               np.asarray(jfl.score2(jt, 0.7)), rtol=1e-6)


def test_find_empty_sectors_matches(dense):
    jc, je, tc, te = _sectors(dense)
    assert tc.shape == (48, 6, 4) and te.shape == (48, 6)
    flips = int((te.numpy() != je).sum())
    assert flips == 0, f"{flips} of {je.size} sectors flipped at a boundary"
    assert 0 < je.sum() < je.size, "fixture must have filled and empty sectors"
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-5)


@pytest.mark.parametrize("depth", [1, 2])
def test_check_counts_matches(dense, depth):
    js, jt, jg, ts, tt, tg = dense
    jc, _, _, _ = _sectors(dense)
    coord = jc.reshape(-1, 4)
    images = np.repeat(np.asarray(jt.images)[:48], 6, 0)
    rng = np.random.default_rng(depth)
    counts = rng.integers(0, 4, tuple(jg.slots.shape[:3])).astype(np.int32)
    want = np.asarray(jex.check_counts(js, jg, jnp.asarray(counts), jnp.asarray(coord),
                                       jnp.asarray(images), LEVEL, CSIZE, 2, 3, depth))
    got = tex.check_counts(ts, tg, torch.as_tensor(counts), torch.as_tensor(coord),
                           torch.as_tensor(images), LEVEL, CSIZE, 2, 3, depth)
    assert 0 < want.sum() < want.size, "fixture must pass and block candidates"
    np.testing.assert_array_equal(got.numpy(), want)


def test_update_counts_matches(dense):
    js, jt, jg, ts, tt, tg = dense
    jc, _, _, _ = _sectors(dense)
    coord = jc.reshape(-1, 4)
    H = coord.shape[0]
    rng = np.random.default_rng(3)
    images = np.repeat(np.asarray(jt.images)[:48], 6, 0)
    vimages = rng.integers(-1, 6, images.shape).astype(np.int32)
    ok = rng.uniform(size=H) > 0.4
    counts = rng.integers(0, 3, tuple(jg.slots.shape[:3])).astype(np.int32)
    want = np.asarray(jex.update_counts(js, jnp.asarray(counts), jnp.asarray(coord),
                                        jnp.asarray(images), jnp.asarray(vimages),
                                        jnp.asarray(ok), LEVEL, CSIZE))
    got = tex.update_counts(ts, torch.as_tensor(counts), torch.as_tensor(coord),
                            torch.as_tensor(images), torch.as_tensor(vimages),
                            torch.as_tensor(ok), LEVEL, CSIZE)
    assert got.dtype == torch.int32 and (want - counts).sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_rounds_match_with_replayed_noise():
    """Two expand rounds from 12 sparse seeds, as the JAX package's own
    test runs them; the port consumes the same keys whole."""
    Ps, _, js = jsyn.plane_scene(n_views=8, width=160, height=120)
    coord, normal = jsyn.plane_points(Ps, 12, seed=3, extent=0.5)
    jt = make_seeded_table(js, jnp.asarray(coord, jnp.float32),
                           jnp.asarray(normal, jnp.float32), capacity=2048)
    ts, tt = jax_scene_to_torch(js, Ps), jax_table_to_torch(jt)
    jp, tp = jpr.PropagateParams(**BASE), tpr.PropagateParams(**BASE)
    jstate, tstate = jex.init_state(js, LEVEL, CSIZE), tex.init_state(ts, LEVEL, CSIZE)
    n0 = int(np.asarray(jt.alive).sum())
    key = jax.random.PRNGKey(2)
    kw = dict(ncc_threshold=0.7, ncc_threshold_before=0.4, count_threshold=4, depth=1)
    jround = jax.jit(jex.expand_round, static_argnames=("p", "depth", "use_depth"))
    for _ in range(2):
        key, sub = jax.random.split(key)
        before = np.asarray(jt.alive)
        jt, jstate, jst = jround(js, jt, jstate, sub, p=jp, **kw)
        tt, tstate, tst = tex.expand_round(ts, tt, tstate, JaxExpandRound(sub), tp, **kw)
        for a, b in zip(jst, tst):
            assert abs(int(a) - b) <= max(1, 0.01 * int(a)), (jst, tst)
        # as sets: one extra or missing acceptance (a sector that flips
        # at a boundary) shifts every later row of the insertion order
        jnew = np.asarray(jt.coord)[np.asarray(jt.alive) & ~before]
        tnew = tt.coord.numpy()[tt.alive.numpy() & ~before]
        dist = np.abs(jnew[:, None, :] - tnew[None, :, :]).max(-1).min(1)
        assert len(jnew) > 0 and (dist <= 1e-3).mean() >= 0.98, dist
    n1 = int(tt.alive.sum())
    assert n1 > n0, (n0, n1)
    assert abs(n1 - int(np.asarray(jt.alive).sum())) <= max(1, 0.01 * n1)
    new = tt.alive.numpy().copy()
    new[:n0] = False
    z = np.abs(tt.coord.numpy()[new, 2])
    assert np.median(z) < 0.05
    jc, tc = int(np.asarray(jstate.counts).sum()), int(tstate.counts.sum())
    assert tc > 0 and abs(tc - jc) <= max(1, 0.02 * jc), (jc, tc)


@pytest.fixture(scope="module")
def pmvs_runs(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("pmvs"))
    jsyn.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=48)
    return run_pair(prefix, strategy="pmvs")


def test_pmvs_pipeline_alive_tracks_jax(pmvs_runs):
    assert_alive_tracks_jax(pmvs_runs)  # the JAX run grows at this size


def test_pmvs_pipeline_quality_tracks_jax(pmvs_runs):
    assert_quality_tracks_jax(pmvs_runs)
