"""Multi-illumination scoring of mvskit_tpu_torch against mvskit_tpu
(mirrors tests/test_illums.py): every NCC score and every refinement
cost averages over the illuminations; view selection stays on
illumination 0.

Tolerances: identical illuminations give the single-illumination score
and refinement bit for bit on these inputs (tests/test_illums.py allows
1e-6 for the JAX package); scores on a real
3-illumination scene within 2e-4 of JAX (the golden-parity bound);
refinement as tests/test_torch_refine.py (coord 1e-4, ncc 2e-4 on
>= 99 % of rows); the whole pipeline on a 3-illumination dataset with
the default RGB search, seed + 2 iterations, as
tests/test_torch_pipeline.py holds the single-illumination one (alive
counts within 3 %, acc_mean and comp_frac within 10 % relative of the
JAX driver's). Also: the port's CLI on such a dataset."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.image.scene import scene_from_arrays as jscene_from_arrays
from mvskit_tpu.ops import ncc as jncc
from mvskit_tpu.pipeline import refine as jrf
from mvskit_tpu.pipeline import views as jvw
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch import cli
from mvskit_tpu_torch.config import MVSConfig as TMVSConfig
from mvskit_tpu_torch.image.scene import scene_from_arrays as tscene_from_arrays
from mvskit_tpu_torch.ops import cuda_ncc
from mvskit_tpu_torch.ops import ncc as tncc
from mvskit_tpu_torch.pipeline import refine as trf
from test_torch_ncc import _t
from test_torch_pipeline import assert_alive_tracks_jax, assert_quality_tracks_jax, run_pair
from torch_replay import jax_scene_to_torch, refine_deltas

LEVEL, WSIZE, TAU, A1 = 1, 7, 6, math.radians(60.0)
KW = dict(level=LEVEL, wsize=WSIZE, tau=TAU, min_image_num=3,
          angle_threshold1=A1, ascale=math.pi / 48.0, shrink=0.8,
          init_depth_radius=4.0, init_angle_radius=8.0)


def _view_lists(js, coord, normal):
    c, n = jnp.asarray(coord, jnp.float32), jnp.asarray(normal, jnp.float32)
    images = np.full((coord.shape[0], js.n_images), -1, np.int32)
    images[:, 0] = 0
    images = jvw.add_images(js, c, n, jnp.asarray(images), LEVEL, A1)
    return np.asarray(jvw.sort_images(js, c, n, images, LEVEL))


@pytest.fixture(scope="module")
def dup3():
    """Plane scene whose 3 illuminations are identical images."""
    Ps = jsyn.ring_cameras(6, 160, 120)
    imgs = jsyn.render_plane_views(Ps, 160, 120, seed=0)
    tri = [np.stack([im, im, im]) for im in imgs]
    ts = tscene_from_arrays(Ps, tri, max_level=4, device="cpu")
    js = jscene_from_arrays(Ps, tri, max_level=4)
    coord, normal = jsyn.plane_points(Ps, 32, extent=0.6)
    coord, normal = coord.astype(np.float32), normal.astype(np.float32)
    images = _view_lists(js, coord, normal)
    ds = np.asarray(jvw.set_scales(js, jnp.asarray(coord), jnp.asarray(images),
                                   LEVEL, TAU, WSIZE)[0])
    return ts, coord, normal, images, ds


def test_identical_illums_degenerate_parity(dup3):
    ts, coord, normal, images, _ = dup3
    assert ts.n_illums == 3
    args = (ts, _t(images), _t(coord), _t(normal), LEVEL, WSIZE, TAU, A1)
    s1 = tncc.compute_patch_ncc(*args)
    s3 = tncc.compute_patch_ncc_n(*args, n_illums=3)
    assert np.ptp(s1.numpy()) > 0.0
    assert torch.equal(s3, s1)
    # one illumination of a 3-illumination scene is the plain score
    assert torch.equal(tncc.compute_patch_ncc_n(*args, n_illums=1), s1)


def test_identical_illums_refine_parity(dup3):
    ts, coord, normal, images, ds = dup3
    deltas = torch.from_numpy(
        np.random.default_rng(2).uniform(-1, 1, (6, 32, 4, 3)).astype(np.float32))
    args = (ts, _t(coord), _t(normal), _t(images), _t(ds), deltas)
    r1 = trf.refine_batch(*args, rounds=6, n_cands=4, n_illums=1, **KW)
    r3 = trf.refine_batch(*args, rounds=6, n_cands=4, n_illums=3, **KW)
    assert torch.equal(r3.coord, r1.coord) and torch.equal(r3.ncc, r1.ncc)


@pytest.fixture(scope="module")
def sphere3():
    Ps, _, js = jsyn.sphere_scene(n_views=8, width=160, height=120, nillums=3)
    ts = jax_scene_to_torch(js, Ps)
    coord, normal = jsyn.visible_surface_points(
        Ps, 128, geometry="sphere", seed=5, width=160, height=120)
    coord, normal = coord.astype(np.float32), normal.astype(np.float32)
    images = _view_lists(js, coord, normal)
    ok = images[:, 0] >= 0
    return js, ts, coord[ok], normal[ok], images[ok]


def test_multi_illum_ncc_matches_jax(sphere3):
    js, ts, coord, normal, images = sphere3
    assert ts.n_illums == 3 and coord.shape[0] > 32
    off = coord.copy()
    off[::2, 2] += 0.05  # half off the surface, for a spread of scores
    for c in (coord, off):
        jn = np.asarray(jncc.compute_patch_ncc_n(
            js, jnp.asarray(images), jnp.asarray(c), jnp.asarray(normal),
            LEVEL, WSIZE, TAU, A1, n_illums=3))
        tn = tncc.compute_patch_ncc_n(
            ts, _t(images), _t(c), _t(normal), LEVEL, WSIZE, TAU, A1, n_illums=3)
        np.testing.assert_allclose(tn.numpy(), jn, atol=2e-4)
    # the average differs from illumination 0 alone: the other planes are read
    t0 = tncc.compute_patch_ncc(ts, _t(images), _t(coord), _t(normal),
                                LEVEL, WSIZE, TAU, A1)
    assert np.abs(tn.numpy() - t0.numpy()).max() > 1e-3


def test_multi_illum_refine_matches_jax(sphere3):
    js, ts, coord, normal, images = sphere3
    ds = np.asarray(jvw.set_scales(js, jnp.asarray(coord), jnp.asarray(images),
                                   LEVEL, TAU, WSIZE)[0])
    rng = np.random.default_rng(4)
    start = coord.copy()
    start[:, :3] += rng.uniform(-0.03, 0.03, (coord.shape[0], 3))
    key = jax.random.PRNGKey(11)
    rounds, n_cands = 4, 8
    jres = jrf.refine_batch(
        js, jnp.asarray(start), jnp.asarray(normal), jnp.asarray(images),
        jnp.asarray(ds), key, rounds=rounds, n_cands=n_cands, group_dma=False,
        n_illums=3, **KW)
    deltas = torch.from_numpy(refine_deltas(key, rounds, coord.shape[0], n_cands))
    tres = trf.refine_batch(
        ts, _t(start), _t(normal), _t(images), _t(ds), deltas, rounds=rounds,
        n_cands=n_cands, group_dma=False, n_illums=3, **KW)
    jc, tc = np.asarray(jres.coord), tres.coord.numpy()
    jq, tq = np.asarray(jres.ncc), tres.ncc.numpy()
    ok = (np.abs(jc - tc).max(1) <= 1e-4) & (np.abs(jq - tq) <= 2e-4)
    assert ok.mean() >= 0.99, (ok.mean(), np.abs(jc - tc).max(), np.abs(jq - tq).max())


@pytest.fixture(scope="module")
def illum3_runs(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("illum3"))
    jsyn.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=48, nillums=3)
    return run_pair(prefix)


def test_illum3_pipeline_alive_tracks_jax(illum3_runs):
    for name in ("jax", "torch"):
        p = illum3_runs[name]["engine"].prop_params
        assert p.n_illums == 3 and not p.luma_refine
    assert_alive_tracks_jax(illum3_runs)


def test_illum3_pipeline_quality_tracks_jax(illum3_runs):
    assert assert_quality_tracks_jax(illum3_runs)["acc_median"] < 0.02


def test_multi_illum_cli_cpu(tmp_path):
    """The CLI on an illum-3 dataset: prop_params carries the three
    illuminations, no kernel launches on the CPU, and the cloud lies on
    the plane."""
    import json

    from mvskit_tpu_torch.io import ply
    from mvskit_tpu_torch.utils import synthetic as tsyn

    prefix = str(tmp_path / "illum3")
    tsyn.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=48, nillums=3)
    assert TMVSConfig.from_option_file(prefix).nillums == 3
    report, out = str(tmp_path / "report.json"), str(tmp_path / "final")
    cuda_ncc.reset_launches()
    rc = cli.main([prefix, "--device", "cpu", "--iterations", "1",
                   "--prop-rounds", "2", "--max-patches", "4096", "--donor-budget",
                   "512", "--chunk", "256", "--refine-rounds", "3", "--refine-cands", "4",
                   "--no-snapshots", "--out", out, "--report", report])
    assert rc == 0
    with open(report) as f:
        rep = json.load(f)
    assert rep["prop_params"]["n_illums"] == 3 and rep["final_alive"] > 100
    assert rep["prop_params"]["refine_rounds"] == 3 and rep["prop_params"]["chunk"] == 256
    assert all(v == 0 for v in cuda_ncc.LAUNCHES.values())
    cloud = ply.read_ply(out + ".ply")["xyz"]
    assert cloud.shape[0] == rep["final_alive"]
    assert np.median(np.abs(cloud[:, 2])) < 0.03
    assert not os.path.exists(os.path.join(prefix, "ply", "refined_patches_0.ply"))
