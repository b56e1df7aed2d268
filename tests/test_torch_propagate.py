"""Port propagation (pipeline/propagate.py) vs mvskit_tpu with replayed
noise: donor selection and insertion exact; one whole propagate_round
from the same table with RoundStats within +-1 % and >= 98 % of the
inserted rows matching in coord to 1e-3 (a near-tie in the refinement
argmin or in the insertion order can move a row)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.core import grid as jgr
from mvskit_tpu.pipeline import propagate as jpr
from mvskit_tpu_torch.core import grid as tgr
from mvskit_tpu_torch.pipeline import propagate as tpr
from torch_replay import _JaxRound, seeded_plane

BASE = dict(
    level=1, csize=2, wsize=7, tau=6, min_image_num=3, cell_capacity=8,
    angle_threshold0=math.radians(60.0), angle_threshold1=math.radians(60.0),
    max_angle_threshold=math.radians(10.0), ascale=math.pi / 48.0,
    refine_rounds=4, refine_cands=8, refine_shrink=0.4096,
    refine_depth_radius=4.0, refine_angle_radius=8.0,
    neighbor_threshold=0.5, donor_budget=96, chunk=64,
)


def params(depth2_check):
    return (jpr.PropagateParams(**BASE, depth2_check=depth2_check),
            tpr.PropagateParams(**BASE, depth2_check=depth2_check))


@pytest.fixture(scope="module")
def sp():
    Ps, js, jt, ts, tt = seeded_plane(n_views=6, n_patches=64, capacity=1024,
                                      seed=9, extent=0.6)
    return js, jt, ts, tt


def test_select_donors_matches(sp):
    js, jt, ts, tt = sp
    jg = jgr.build_grid(js, jt, 1, 2, 8)
    tg = tgr.build_grid(ts, tt, 1, 2, 8)
    for policy in ("cell_first", "ncc"):
        jd = jpr.select_donors(js, jg, jt, 96, policy)
        td = tpr.select_donors(ts, tg, tt, 96, policy)
        for a, b in zip(jd, td):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_generate_hypotheses_matches(sp):
    js, jt, ts, tt = sp
    jp, tp = params(False)
    jg = jgr.build_grid(js, jt, 1, 2, 8)
    tg = tgr.build_grid(ts, tt, 1, 2, 8)
    donors = jpr.select_donors(js, jg, jt, 96)
    tdon = [torch.as_tensor(np.array(d)) for d in donors]
    key = jax.random.PRNGKey(3)
    rnd = _JaxRound(key)
    for axis, direction in ((0, 1), (1, -1)):
        k = rnd.k1a if axis == 0 else rnd.k1b
        jh = jpr.generate_hypotheses(js, jt, jg, *donors, axis, direction, k, jp)
        th = tpr.generate_hypotheses(ts, tt, tg, *tdon, axis, direction,
                                     rnd.jitter(axis, 96), tp)
        np.testing.assert_allclose(th[0].numpy(), np.asarray(jh[0]), atol=1e-5)
        np.testing.assert_array_equal(th[2].numpy(), np.asarray(jh[2]))
        np.testing.assert_allclose(th[3].numpy(), np.asarray(jh[3]), atol=2e-4)
        np.testing.assert_array_equal(th[4].numpy(), np.asarray(jh[4]))
        assert th[4].any()



def test_generate_hypotheses_takes_jax_positional_gate(sp):
    """gate_full, gate_worst_ncc bound by position as JAX binds them."""
    js, jt, ts, tt = sp
    jp, tp = params(False)
    jg = jgr.build_grid(js, jt, 1, 2, 8)
    tg = tgr.build_grid(ts, tt, 1, 2, 8)
    donors = jpr.select_donors(js, jg, jt, 96)
    tdon = [torch.as_tensor(np.array(d)) for d in donors]
    rng = np.random.default_rng(4)
    full = rng.uniform(size=96) < 0.5
    worst = rng.uniform(0.0, 1.2, 96).astype(np.float32)
    rnd = _JaxRound(jax.random.PRNGKey(5))
    jh = jpr.generate_hypotheses(js, jt, jg, *donors, 0, 1, rnd.k1a, jp,
                                 jnp.asarray(full), jnp.asarray(worst))
    th = tpr.generate_hypotheses(ts, tt, tg, *tdon, 0, 1, rnd.jitter(0, 96), tp,
                                 torch.as_tensor(full), torch.as_tensor(worst))
    np.testing.assert_allclose(th[0].numpy(), np.asarray(jh[0]), atol=1e-5)
    np.testing.assert_array_equal(th[2].numpy(), np.asarray(jh[2]))
    np.testing.assert_allclose(th[3].numpy(), np.asarray(jh[3]), atol=2e-4)
    np.testing.assert_array_equal(th[4].numpy(), np.asarray(jh[4]))
    ungated = tpr.generate_hypotheses(ts, tt, tg, *tdon, 0, 1, rnd.jitter(0, 96), tp)
    assert th[4].any() and (ungated[4] & ~th[4]).any()

def test_insert_patches_matches(sp):
    _, jt, _, tt = sp
    H = 40
    rng = np.random.default_rng(0)
    f = dict(
        coord=rng.normal(size=(H, 4)).astype(np.float32),
        normal=rng.normal(size=(H, 4)).astype(np.float32),
        images=rng.integers(-1, 6, (H, 6)).astype(np.int32),
        vimages=rng.integers(-1, 6, (H, 6)).astype(np.int32),
        ncc=np.round(rng.uniform(0, 1, H), 1).astype(np.float32),  # ties
        dscale=rng.uniform(size=H).astype(np.float32),
        ascale=rng.uniform(size=H).astype(np.float32),
        ok=rng.uniform(size=H) > 0.3,
        fail0=np.zeros(H, bool), fail1=np.zeros(H, bool),
    )
    jo = jpr.GauntletOut(**{k: jnp.asarray(v) for k, v in f.items()})
    to = tpr.GauntletOut(**{k: torch.as_tensor(v) for k, v in f.items()})
    alive = np.array(jt.alive)
    alive[5:30:3] = False
    j2 = jpr.insert_patches(jt._replace(alive=jnp.asarray(alive)), jo)
    t2 = tpr.insert_patches(tt._replace(alive=torch.as_tensor(alive)), to)
    for k in j2._fields:
        np.testing.assert_array_equal(getattr(t2, k).numpy(), np.asarray(getattr(j2, k)))


@pytest.mark.parametrize("depth2_check", [False, True])
def test_propagate_round_matches_with_replayed_noise(sp, depth2_check):
    js, jt, ts, tt = sp
    jp, tp = params(depth2_check)
    key = jax.random.PRNGKey(11)
    jt2, jst = jpr.propagate_round(js, jt, key, jp, 1, 0.7, 0.4,
                                   use_depth=True, quad_threshold=2.5)
    tt2, tst = tpr.propagate_round(ts, tt, _JaxRound(key), tp, 1, 0.7, 0.4,
                                   use_depth=True, quad_threshold=2.5)
    for a, b in zip(jst, tst):
        assert abs(int(a) - b) <= max(1, 0.01 * int(a)), (jst, tst)
    assert tst.passed > 20
    before = np.asarray(jt.alive)
    new = np.asarray(jt2.alive) & ~before
    ok = np.abs(tt2.coord.numpy()[new] - np.asarray(jt2.coord)[new]).max(1) <= 1e-3
    ok &= tt2.alive.numpy()[new]
    assert ok.mean() >= 0.98, ok.mean()
