"""The dp axis of mvskit_tpu_torch: every stage of a propagation round and
of the filter pass deals its rows to the dp devices in contiguous blocks
(parallel/shard.deal_rows) and merges them exactly. Shards are copies of
the CPU, at the sizes of tests/test_torch_shard.py.

  * the port against itself: at dp = 2, 3 (blocks that do not divide)
    and 8 the grid build (all five fields), set_vimages, select_donors,
    generate_hypotheses, insert_patches, each filter phase, run_filters,
    propagate_round and expand_round equal the unsharded stage bit for
    bit, on a table with dead rows between its live ones;
  * planted ties: equal NCC in different blocks competing for one cell
    past its capacity (the slot merge and the eviction of a block's
    survivor), equal depth from two blocks in one z-buffer cell, equal
    donor priorities across a block boundary, and blocks with no live
    rows (dp larger than the live prefix);
  * the counter: every dp shard counts rows in every stage;
  * the port against JAX: the dp grid build against the JAX package's
    build_grid on a shard_table table over its 8 virtual CPU devices,
    with test_torch_grid.py::test_build_grid_matches's bounds."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.core import grid as jgr
from mvskit_tpu.core import patches as jpt
from mvskit_tpu.parallel import shard as jsh
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch import interop
from mvskit_tpu_torch.core import grid as tgr
from mvskit_tpu_torch.core import patches as tpt
from mvskit_tpu_torch.ops import ncc as tncc
from mvskit_tpu_torch.parallel import shard as tsh
from mvskit_tpu_torch.pipeline import expand as tex
from mvskit_tpu_torch.pipeline import filters as tfl
from mvskit_tpu_torch.pipeline import propagate as tpr
from mvskit_tpu_torch.pipeline import views as tvw
from mvskit_tpu_torch.utils import profiling
from torch_replay import jax_scene_to_torch, jax_table_to_torch

LEVEL, CSIZE, WSIZE, TAU, MIN_NUM = 1, 2, 7, 6, 3
A1 = math.radians(60.0)
DPS = [2, 3, 8]
CPU = torch.device("cpu")
P = tpr.PropagateParams(
    level=LEVEL, csize=CSIZE, wsize=WSIZE, tau=TAU, min_image_num=MIN_NUM,
    cell_capacity=4, angle_threshold0=A1, angle_threshold1=A1,
    max_angle_threshold=math.radians(10.0), ascale=math.pi / 48.0,
    refine_rounds=2, refine_cands=2, refine_shrink=0.8,
    refine_depth_radius=4.0, refine_angle_radius=8.0,
    neighbor_threshold=0.5, donor_budget=128, chunk=16)
FILTER_KW = dict(level=LEVEL, csize=CSIZE, wsize=WSIZE, tau=TAU, min_image_num=MIN_NUM,
                 cell_capacity=16, ncc_threshold=0.7, quad_threshold=2.5,
                 neighbor_threshold=0.5, neighbor_threshold1=1.0, neighbor_threshold2=1.0,
                 angle_threshold1=A1)


def dp(k):
    return [CPU] * k


def same(a, b):
    """Equal bit for bit, field by field for tuples."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def sp():
    """Plane patches seeded by the port (views by add_images and
    sortImages, scales, NCC), with floaters and an isolated clump (as
    tests/test_torch_filters.py plants them), and the same table with
    every 7th live row dead, so blocks hold dead rows between live ones.
    Returns (jax scene, jax table, port scene, port table, holed table)."""
    Ps, _, js = jsyn.plane_scene(n_views=8, width=160, height=120)
    ts = jax_scene_to_torch(js, Ps)
    coord, normal = jsyn.plane_points(Ps, 160, seed=7, extent=0.6)
    coord[:12, 2] += np.random.default_rng(7).uniform(0.1, 0.3, 12)
    coord[160 - 3:, :2] = np.stack([0.95 + np.arange(3) * 0.004, np.full(3, -0.95)], 1)
    c, n = torch.as_tensor(coord, dtype=torch.float32), torch.as_tensor(normal,
                                                                       dtype=torch.float32)
    images = tvw.add_images(ts, c, n, torch.full((160, 8), -1, dtype=torch.int32), LEVEL, A1)
    images = tvw.sort_images(ts, c, n, images, LEVEL, is_fixed=False)
    dscale, ascale = tvw.set_scales(ts, c, images, LEVEL, TAU, WSIZE)
    ncc = tncc.compute_patch_ncc(ts, images, c, n, LEVEL, WSIZE, TAU, A1)
    tt = tpt.from_numpy(coord, normal, images.numpy(), 512, 8, ncc=ncc.numpy(),
                        dscale=dscale.numpy(), ascale=ascale.numpy(), device="cpu")
    tt = tt._replace(alive=tt.alive & (tpt.count_valid(tt.images) > 0))
    jt = jpt.PatchTable(**{k: jnp.asarray(v) for k, v in interop.table_to_numpy(tt).items()})
    alive = tt.alive.clone()
    alive[::7] = False
    return js, jt, ts, tt, tt._replace(alive=alive)


def _grid(ts, t, cap=4, row_limit=256, dp_devices=None):
    return tgr.build_grid(ts, t, LEVEL, CSIZE, cap, row_limit=row_limit,
                          dp_devices=dp_devices)


# ----------------------------------------------------------------------
# the port against itself
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k", DPS)
@pytest.mark.parametrize("cap,row_limit", [(2, 256), (8, None)])
def test_build_grid_dp(sp, k, cap, row_limit):
    _, _, ts, tt, holes = sp
    for t in (tt, holes):
        want = _grid(ts, t, cap, row_limit)
        same(_grid(ts, t, cap, row_limit, dp(k)), want)
    assert want.evicted.any() or cap == 8


@pytest.mark.parametrize("k", DPS)
def test_set_vimages_and_donors_dp(sp, k):
    _, _, ts, _, t = sp
    g = _grid(ts, t)
    for chunk in (8192, 24):
        want = tgr.set_vimages(ts, g, t, LEVEL, CSIZE, 0.5, row_limit=256, chunk=chunk)
        same(tgr.set_vimages(ts, g, t, LEVEL, CSIZE, 0.5, row_limit=256, chunk=chunk,
                             dp_devices=dp(k)), want)
    assert (want >= 0).any()
    t = t._replace(alive=t.alive & ~g.evicted)
    for budget, policy in ((64, "cell_first"), (4096, "ncc")):
        want = tpr.select_donors(ts, g, t, budget, policy)
        same(tpr.select_donors(ts, g, t, budget, policy, dp_devices=dp(k)), want)
    r_want, ok_want = tex.select_donor_rows(t, 0.3, 40)
    same(tex.select_donor_rows(t, 0.3, 40, dp(k)), (r_want, ok_want))
    assert ok_want.any()


@pytest.mark.parametrize("k", DPS)
def test_generate_hypotheses_dp(sp, k):
    _, _, ts, _, t = sp
    g = _grid(ts, t)
    t = t._replace(alive=t.alive & ~g.evicted)
    donors = tpr.select_donors(ts, g, t, P.donor_budget)
    gen = torch.Generator()
    gen.manual_seed(3)
    jitter = torch.rand((P.donor_budget, 2), generator=gen) - 0.5
    for axis, direction in ((0, 1), (1, -1)):
        want = tpr.generate_hypotheses(ts, t, g, *donors, axis, direction, jitter, P)
        got = tpr.generate_hypotheses(ts, t, g, *donors, axis, direction, jitter, P,
                                      dp_devices=dp(k))
        same(got, want)
        assert want[4].any()


def _gauntlet_out(t, B=48, seed=0):
    """A gauntlet output of B hypotheses with NCC ties among the
    accepted ones."""
    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(rng.integers(0, 150, B))
    ncc = torch.as_tensor(rng.choice([0.5, 0.75, 0.9], B).astype(np.float32))
    ok = torch.as_tensor(rng.random(B) < 0.7)
    zeros = torch.zeros(B)
    return tpr.GauntletOut(coord=t.coord[pick] + 0.01, normal=t.normal[pick],
                           images=t.images[pick], vimages=t.vimages[pick], ncc=ncc,
                           dscale=zeros + 1.0, ascale=zeros + 2.0, ok=ok,
                           fail0=~ok, fail1=torch.zeros(B, dtype=torch.bool))


@pytest.mark.parametrize("k", DPS)
def test_insert_patches_dp(sp, k):
    _, _, _, tt, holes = sp
    for t, B in ((holes, 48), (tt, 400)):  # 400: more accepted than dead rows
        out = _gauntlet_out(t, B)
        want = tpr.insert_patches(t, out)
        same(tpr.insert_patches(t, out, dp_devices=dp(k)), want)
        assert want.n_alive() > t.n_alive()


@pytest.mark.parametrize("k", DPS)
def test_filter_phases_dp(sp, k):
    _, _, ts, tt, _ = sp
    R = 256
    t, g = tfl.rebuild(ts, tt, LEVEL, CSIZE, 16, 0.5, additive=False, row_limit=R)
    same(tfl.rebuild(ts, tt, LEVEL, CSIZE, 16, 0.5, additive=False, row_limit=R,
                     dp_devices=dp(k)), (t, g))
    kills = []
    for thr in (0.7, 0.2):
        want = tfl.filter_outside(ts, g, t, LEVEL, CSIZE, thr, 1.0, row_limit=R)
        same(tfl.filter_outside(ts, g, t, LEVEL, CSIZE, thr, 1.0, row_limit=R,
                                dp_devices=dp(k)), want)
        kills.append(want[1])
    for chunk in (8192, 40):  # at least 6 views, so that some patches die
        want = tfl.filter_exact(ts, g, t, LEVEL, CSIZE, WSIZE, 6, 0.2, A1,
                                row_limit=R, chunk=chunk)
        same(tfl.filter_exact(ts, g, t, LEVEL, CSIZE, WSIZE, 6, 0.2, A1,
                              row_limit=R, chunk=chunk, dp_devices=dp(k)), want)
    kills.append(want[1])
    n = int(t.alive.nonzero().max()) + 1
    for chunk in (1024, 30):
        want = tfl.filter_neighbor_rows(ts, g, t, 0, n, LEVEL, CSIZE, TAU, 2.5, 0.5,
                                        chunk=chunk)
        same(tfl.filter_neighbor_rows(ts, g, t, 0, n, LEVEL, CSIZE, TAU, 2.5, 0.5,
                                      chunk=chunk, dp_devices=dp(k)), want)
    kills.append(want[1])
    for thr2, chunk in ((1.0, 2048), (0.05, 50)):
        want = tfl.filter_small_groups(ts, g, t, LEVEL, CSIZE, thr2, row_limit=R,
                                       chunk=chunk)
        same(tfl.filter_small_groups(ts, g, t, LEVEL, CSIZE, thr2, row_limit=R,
                                     chunk=chunk, dp_devices=dp(k)), want)
    kills.append(want[1])
    assert min(kills) > 0, kills


@pytest.mark.parametrize("k", DPS)
def test_run_filters_dp(sp, k):
    _, _, ts, tt, holes = sp
    for t in (tt, holes):
        want = tfl.run_filters(ts, t, **FILTER_KW, row_limit=256, neighbor_rows=180)
        same(tfl.run_filters(ts, t, **FILTER_KW, row_limit=256, neighbor_rows=180,
                             dp_devices=dp(k)), want)
    assert sum(want[1]) > 0


def _round(ts, t, k, pmvs=False):
    gen = torch.Generator()
    gen.manual_seed(0)
    kw = dict(row_limit=256, dp_devices=dp(k) if k > 1 else None)
    if pmvs:
        state = tex.init_state(ts, LEVEL, CSIZE)
        t, state, stats = tex.expand_round(ts, t, state, tpr.TorchNoise(gen), P, 0.7, 0.4,
                                           count_threshold=2, depth=1, **kw)
        return t, state, stats
    return tpr.propagate_round(ts, t, None, P, 1, 0.7, 0.4, generator=gen, **kw)


@pytest.mark.parametrize("k", DPS)
@pytest.mark.parametrize("pmvs", [False, True])
def test_round_dp(sp, k, pmvs):
    _, _, ts, _, t = sp
    want = _round(ts, t, 1, pmvs)
    same(_round(ts, t, k, pmvs), want)
    assert want[-1].passed > 0


# ----------------------------------------------------------------------
# planted ties
# ----------------------------------------------------------------------

def _stack(ts, n, ncc, coord=(0.05, 0.05, 0.0, 1.0), capacity=32):
    """`n` co-located patches with reference view 0 and the given NCC."""
    coord = np.tile([coord], (n, 1)).astype(np.float32)
    normal = np.tile([[0.0, 0.0, 1.0, 0.0]], (n, 1)).astype(np.float32)
    images = np.full((n, 8), -1, np.int32)
    images[:, 0] = 0
    images[:, 1] = 1
    return tpt.from_numpy(coord, normal, images, capacity, 8,
                          ncc=np.asarray(ncc, np.float32), device="cpu")


@pytest.mark.parametrize("ncc,kept", [([0.5] * 96, {0, 1, 2}),
                                      ([0.5] * 48 + [0.8] * 48, {48, 49, 50})])
def test_slot_merge_ties_across_blocks(sp, ncc, kept):
    """96 rows in one cell of capacity 3, in blocks of 32 or 64 rows: the
    earlier rows win a tie; the survivors of a later block that lose the
    merge (rows 32-34 and 64-66 in the first case) are evicted."""
    ts = sp[2]
    t = _stack(ts, 96, ncc, capacity=128)
    want = tgr.build_grid(ts, t, LEVEL, CSIZE, 3)
    assert set(np.nonzero(~want.evicted.numpy()[:96])[0]) == kept
    for k in (2, 3):
        same(tgr.build_grid(ts, t, LEVEL, CSIZE, 3, dp_devices=dp(k)), want)


def test_depth_ties_across_blocks(sp):
    """Rows 0 and 95 at one point, in different blocks: the cell's
    depth_idx is the greater row, as one scatter gives it."""
    ts = sp[2]
    t = _stack(ts, 96, [0.5] * 96, capacity=128)
    coord = t.coord.clone()
    coord[1:95, 2] += 0.05  # the rows between lie behind rows 0 and 95
    t = t._replace(coord=coord)
    want = tgr.build_grid(ts, t, LEVEL, CSIZE, 16)
    assert 95 in set(want.depth_idx.flatten().tolist())
    assert 0 not in set(want.depth_idx.flatten().tolist())
    for k in (2, 3):
        same(tgr.build_grid(ts, t, LEVEL, CSIZE, 16, dp_devices=dp(k)), want)


def test_donor_ties_across_blocks(sp):
    """Every slot's patch at one NCC: equal priorities everywhere, so the
    donors are the lowest slot indices, across every block boundary."""
    _, _, ts, _, t = sp
    t = t._replace(ncc=torch.full_like(t.ncc, 0.6))
    g = _grid(ts, t)
    for budget in (7, 50, 130):
        want = tpr.select_donors(ts, g, t, budget)
        for k in DPS:
            same(tpr.select_donors(ts, g, t, budget, dp_devices=dp(k)), want)


def test_blocks_without_live_rows(sp):
    """dp larger than the live prefix: 3 live rows under a row bound of
    64 and of 4, over 8 blocks of 32-row units (one all dead, the rest
    empty)."""
    _, _, ts, tt, _ = sp
    t = tt._replace(alive=tt.alive & (torch.arange(tt.capacity) < 3))
    for row_limit in (64, 4):
        same(_grid(ts, t, 2, row_limit, dp(8)), _grid(ts, t, 2, row_limit))
        want = tfl.run_filters(ts, t, **FILTER_KW, row_limit=row_limit)
        same(tfl.run_filters(ts, t, **FILTER_KW, row_limit=row_limit, dp_devices=dp(8)),
             want)
    blocks = tsh.deal_rows("x", 4, dp(8))
    assert [e - s for _, _, s, e in blocks] == [4, 0, 0, 0, 0, 0, 0, 0]
    assert [e - s for _, _, s, e in tsh.deal_rows("x", 100, dp(3))] == [64, 32, 4]
    profiling.COUNTERS.reset()


# ----------------------------------------------------------------------
# the counter
# ----------------------------------------------------------------------

ROUND_STAGES = ("grid", "donors", "hypotheses", "gauntlet", "insert")
FILTER_STAGES = ("grid", "vimages", "outside", "exact", "neighbor", "groups")


def dp_rows_by_stage():
    out = {}
    for (stage, shard), n in tsh.DP_ROWS.items():
        out.setdefault(stage, {})[shard] = n
    return out


def test_counter_every_shard_every_stage(sp):
    _, _, ts, tt, holes = sp
    profiling.COUNTERS.reset()
    _round(ts, holes, 3)
    rows = dp_rows_by_stage()
    for stage in ROUND_STAGES:
        assert sorted(rows[stage]) == [0, 1, 2] and min(rows[stage].values()) > 0, stage
    # the 512 capacity rows in units of 32 rows (shard.DP_GRAIN on the CPU)
    assert rows["insert"] == {0: 192, 1: 160, 2: 160}
    profiling.COUNTERS.reset()
    tfl.run_filters(ts, tt, **FILTER_KW, row_limit=256, dp_devices=dp(3))
    rows = dp_rows_by_stage()
    for stage in FILTER_STAGES:
        assert sorted(rows[stage]) == [0, 1, 2] and min(rows[stage].values()) > 0, stage
    assert rows["exact"] == {0: 96, 1: 96, 2: 64}
    profiling.COUNTERS.reset()
    assert not tsh.DP_ROWS and not tsh.DP_K1


def test_cuda_blocks_are_whole_grains():
    """On CUDA a block holds whole units of 1,024 rows (the devices are
    only named here, nothing runs)."""
    cuda = [torch.device("cuda", 0)] * 4
    assert tsh.dp_grain(cuda) == 1024 and tsh.dp_grain(dp(4)) == 32
    blocks = tsh.deal_rows("x", 16384, cuda)
    assert [(s, e) for _, _, s, e in blocks] == [(0, 4096), (4096, 8192), (8192, 12288),
                                                 (12288, 16384)]
    blocks = tsh.deal_rows("x", 45177, cuda)
    assert [e - s for _, _, s, e in blocks] == [12288, 11264, 11264, 10361]
    profiling.COUNTERS.reset()


# ----------------------------------------------------------------------
# the port against JAX
# ----------------------------------------------------------------------

_jbuild = jax.jit(jgr.build_grid, static_argnames=("level", "csize", "capacity",
                                                   "row_limit"))


@pytest.mark.parametrize("capacity,row_limit", [(2, 256), (8, None)])
def test_dp_build_grid_matches_jax_shard_table(sp, capacity, row_limit):
    js, jt, ts, _, _ = sp
    mesh = jsh.make_mesh(8, axis="dp")
    jg = _jbuild(js, jsh.shard_table(jt, mesh), level=LEVEL, csize=CSIZE,
                 capacity=capacity, row_limit=row_limit)
    tg = _grid(ts, jax_table_to_torch(jt), capacity, row_limit, dp(8))
    for f in ("slots", "vslots", "evicted", "depth_idx"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tg.depth.numpy(), np.asarray(jg.depth), rtol=1e-5)
    if capacity == 2:
        assert tg.evicted.any()
