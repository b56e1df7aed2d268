"""The kernel's module (mvskit_tpu_torch.ops.cuda_ncc) and the NCC ops
built on it, against the JAX package on the same inputs.

Tolerances and why:
  (a) raw samples vs JAX sample_windows_raw on the gather path: atol
      1e-3 on the 0-255 scale (float32 rounding of 4-tap sums);
  (b) vs the Pallas kernel in interpret mode where its `fit` is true,
      unfused and fused (K4): 1e-2, the Pallas test's own bound
      (tests/test_pallas_ncc.py:57 — its one-hot matmul sums in another
      order);
  (c) compute_patch_ncc and (d) the NumPy oracle of
      tests/test_golden_parity.py: 2e-4, the golden-parity bound.
The kernel itself is held to this plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.geometry import camera as jcam
from mvskit_tpu.ops import ncc as jncc
from mvskit_tpu.ops import pallas_ncc as pk
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.ops import cuda_ncc
from mvskit_tpu_torch.ops import ncc as tncc
from test_golden_parity import OracleCam, _planes_by_view, oracle_cost
from torch_replay import jax_scene_to_torch

LEVEL, WSIZE, TAU, A1 = 1, 7, 6, math.radians(60.0)
S = WSIZE * WSIZE


@pytest.fixture(scope="module")
def scenes():
    Ps, _, js = jsyn.plane_scene(n_views=6, width=160, height=120)
    return Ps, js, jax_scene_to_torch(js, Ps)


def _views(B, T, n=6):
    v = np.zeros((B, T), np.int32)
    for b in range(B):
        ref = b % n
        v[b] = ([ref] + [x for x in range(n) if x != ref])[:T]
    return v


def _geometry(js, coord, normal, views):
    """JAX window geometry for a [B, T] view list: returns numpy
    (idx[T*B], lvl[T*B], tl[T*B, 2], dx, dy, valid[T, B])."""
    c, n, v = jnp.asarray(coord), jnp.asarray(normal), jnp.asarray(views)
    px, py = jcam.get_paxes(js.cams, jnp.maximum(v[:, 0], 0), c, n, LEVEL)
    tl, dx, dy, lvl, valid = jncc.window_geometry_views(
        js, v.T, c, px, py, n, LEVEL, WSIZE, A1
    )
    T, B = v.T.shape
    f = lambda a, k=(): np.asarray(a).reshape((T * B,) + k)  # noqa: E731
    return (f(jnp.maximum(v.T, 0)), f(lvl), f(tl, (2,)), f(dx, (2,)),
            f(dy, (2,)), np.asarray(valid))


def _candidates(Ps, n_patch, n_cands, seed):
    """Refinement-like candidate groups: each patch repeated n_cands
    times with small depth jitter along z."""
    coord, normal = jsyn.plane_points(Ps, n_patch, seed=seed, extent=0.5)
    rng = np.random.default_rng(seed)
    coord = np.repeat(coord, n_cands, 0)
    coord[:, 2] += rng.uniform(-0.02, 0.02, coord.shape[0])
    return coord.astype(np.float32), np.repeat(normal, n_cands, 0).astype(np.float32)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("group", [1, 32])
def test_plain_matches_jax_gather_path(scenes, group):
    Ps, js, ts = scenes
    if group == 1:
        coord, normal = jsyn.plane_points(Ps, 64, seed=4, extent=1.0)
        coord, normal = coord.astype(np.float32), normal.astype(np.float32)
    else:
        coord, normal = _candidates(Ps, 4, group, seed=5)
    views = _views(coord.shape[0], 3)
    idx, lvl, tl, dx, dy, valid = _geometry(js, coord, normal, views)
    T, B = valid.shape
    jtex, jfit, ch = jncc.sample_windows_raw(
        js, jnp.asarray(idx.reshape(T, B)), jnp.asarray(tl.reshape(T, B, 2)),
        jnp.asarray(dx.reshape(T, B, 2)), jnp.asarray(dy.reshape(T, B, 2)),
        jnp.asarray(lvl.reshape(T, B)), WSIZE, 0, False, group,
    )
    assert ch == 3 and np.asarray(jfit).all()
    out, fit = cuda_ncc.sample_windows(
        ts, _t(idx), _t(lvl), _t(tl), _t(dx), _t(dy), WSIZE, group=group
    )
    assert fit.all() and out.shape == (T * B, 3 * S)
    assert valid.mean() > 0.5, "fixture must exercise valid windows"
    np.testing.assert_allclose(out.numpy(), np.asarray(jtex).reshape(T * B, -1), atol=1e-3)


@pytest.mark.parametrize("group", [1, 32])
def test_plain_matches_pallas_interpret(scenes, group):
    _check_pallas_interpret(scenes, group, fused=False)


def test_fused_matches_pallas_interpret_fused(scenes):
    """K4: the JAX kernel's fused form (one matmul and one store per
    group) against the port's fused launch, which runs the plain version
    on the CPU."""
    _check_pallas_interpret(scenes, 32, fused=True)


def _check_pallas_interpret(scenes, group, fused):
    Ps, js, ts = scenes
    coord, normal = _candidates(Ps, 8, 32, seed=6)  # 256 windows
    views = np.zeros((coord.shape[0], 1), np.int32)
    views[:, 0] = np.repeat(np.arange(8) % 6, 32)
    idx, lvl, tl, dx, dy, valid = _geometry(js, coord, normal, views)
    levels = pk.rgb_levels_from_scene(js)
    pout, pfit = pk.sample_windows(
        levels, jnp.asarray(idx), jnp.asarray(lvl), jnp.asarray(tl),
        jnp.asarray(dx), jnp.asarray(dy), wsize=WSIZE, rgb=True,
        interpret=True, group=group, fused=fused,
    )
    pout, pfit = np.asarray(pout), np.asarray(pfit)
    spad = pout.shape[1] // 3
    out, _ = cuda_ncc.sample_windows(
        ts, _t(idx), _t(lvl), _t(tl), _t(dx), _t(dy), WSIZE, group=group,
        fused=fused,
    )
    both = pfit & valid.reshape(-1)
    assert both.sum() >= 128
    for c in range(3):
        np.testing.assert_allclose(
            out.numpy()[both, c * S:(c + 1) * S],
            pout[both, c * spad:c * spad + S], atol=1e-2,
        )


def test_compute_patch_ncc_matches(scenes):
    Ps, js, ts = scenes
    coord, normal = jsyn.plane_points(Ps, 48, seed=3, extent=1.15)
    coord = coord.astype(np.float32)
    normal = normal.astype(np.float32)
    # perturb half the patches off the surface for a spread of scores
    coord[::2, 2] += 0.05
    views = _views(48, TAU)
    views[::5, 4:] = -1
    jn = jncc.compute_patch_ncc(js, jnp.asarray(views), jnp.asarray(coord),
                                jnp.asarray(normal), LEVEL, WSIZE, TAU, A1)
    tn = tncc.compute_patch_ncc(ts, _t(views), _t(coord), _t(normal),
                                LEVEL, WSIZE, TAU, A1)
    assert np.ptp(np.asarray(jn)) > 0.1
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=2e-4)


def test_incc_aggregations_match(scenes):
    Ps, js, ts = scenes
    coord, normal = jsyn.plane_points(Ps, 32, seed=8, extent=1.0)
    coord, normal = coord.astype(np.float32), normal.astype(np.float32)
    views = _views(32, 5)
    views[::4, 3:] = -1
    jt, jv = jncc.texs_for_views(js, jnp.asarray(views), jnp.asarray(coord),
                                 jnp.asarray(normal), LEVEL, WSIZE, A1)
    tt, tv = tncc.texs_for_views(ts, _t(views), _t(coord), _t(normal),
                                 LEVEL, WSIZE, A1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-4)
    np.testing.assert_allclose(
        tncc.incc_vs_ref(tt, tv, robust=False).numpy(),
        np.asarray(jncc.incc_vs_ref(jt, jv, robust=False)), atol=2e-4)
    np.testing.assert_allclose(
        tncc.incc_pairwise(tt, tv, robust=True).numpy(),
        np.asarray(jncc.incc_pairwise(jt, jv, robust=True)), atol=2e-4)
    w = np.asarray(jncc.compute_weights(js, jnp.asarray(views), jnp.asarray(coord),
                                        jnp.asarray(normal), LEVEL))
    tw = tncc.compute_weights(ts, _t(views), _t(coord), _t(normal), LEVEL)
    np.testing.assert_allclose(tw.numpy(), w, rtol=1e-5)
    np.testing.assert_allclose(
        tncc.incc_weighted(tt, tv, tw).numpy(),
        np.asarray(jncc.incc_weighted(jt, jv, jnp.asarray(w))), atol=2e-4)
    np.testing.assert_allclose(
        tncc.incc_cost(tt, tv, 3).numpy(),
        np.asarray(jncc.incc_cost(jt, jv, 3)), atol=2e-4)


def test_cost_matches_golden_oracle(scenes):
    """Port cost (texs_for_views + incc_cost, plain sampler) == the
    reference cost_func oracle of tests/test_golden_parity.py."""
    Ps, js, ts = scenes
    coord, normal = jsyn.plane_points(Ps, 48, extent=1.15, seed=3)
    views = _views(48, TAU)
    tex, valid = tncc.texs_for_views(
        ts, _t(views), _t(coord, torch.float32), _t(normal, torch.float32),
        LEVEL, WSIZE, A1,
    )
    cost = tncc.incc_cost(tex, valid, 3).numpy()
    cams = [OracleCam(Ps[v]) for v in range(6)]
    planes = _planes_by_view(js)
    worst, n_two = 0.0, 0
    for b in range(48):
        oc = oracle_cost(cams, planes, coord[b], normal[b], list(views[b]),
                         LEVEL, WSIZE, TAU, 3, A1)
        if oc == 2.0 or cost[b] == 2.0:
            assert abs(cost[b] - oc) < 1e-5, b
            n_two += 1
        else:
            worst = max(worst, abs(cost[b] - oc))
    assert worst < 2e-4
    assert n_two < 24


def test_wrapper_checks_and_counts_no_cpu_launch(scenes):
    _, _, ts = scenes
    B = 8
    idx = torch.zeros(B, dtype=torch.int32)
    lvl = torch.ones(B, dtype=torch.int32)
    tl = torch.full((B, 2), 20.0)
    d = torch.tensor([[1.0, 0.0]] * B)
    cuda_ncc.reset_launches()
    out, fit = cuda_ncc.sample_windows(ts, idx, lvl, tl, d, d.flip(1).contiguous(), WSIZE)
    assert out.shape == (B, 3 * S) and fit.all()
    assert all(v == 0 for v in cuda_ncc.LAUNCHES.values())
    with pytest.raises(TypeError):
        cuda_ncc.sample_windows(ts, idx.long(), lvl, tl, d, d, WSIZE)
    with pytest.raises(ValueError):
        cuda_ncc.sample_windows(ts, idx, lvl, tl[:4], d, d, WSIZE)
    with pytest.raises(ValueError):
        cuda_ncc.sample_windows(ts, idx, lvl, tl.T.contiguous().T, d, d, WSIZE)
