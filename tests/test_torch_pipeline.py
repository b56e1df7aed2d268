"""The slice as a whole: mvskit_tpu_torch's PMMVS vs mvskit_tpu's PMMVS,
seed + two iterations (so the depth >= 2 check runs) on the dataset of
tests/test_pipeline.py, the port fed the JAX driver's random numbers.

Tolerances: alive count per iteration within +-3 %; acc_mean and
comp_frac against the analytic plane within 10 % relative of JAX's.
The two runs start from identical tables and noise, but float32 sums in
another order can flip a near-tie accept/reject, and each flip changes
the donors of later rounds. Also: .patch files written by either
package seed the other identically, and the port's CLI runs."""

import os

import numpy as np
import pytest

from mvskit_tpu.config import MVSConfig as JMVSConfig
from mvskit_tpu.pipeline.driver import PMMVS as JPMMVS
from mvskit_tpu.utils import metrics
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch import cli
from mvskit_tpu_torch.config import MVSConfig as TMVSConfig
from mvskit_tpu_torch.ops import cuda_ncc
from mvskit_tpu_torch.pipeline.driver import PMMVS as TPMMVS
from torch_replay import JaxReplayNoise

ITERS = 2


def small_cfg(prefix, config_cls=TMVSConfig):
    """The test size, in the JAX package's MVSConfig or the port's."""
    cfg = config_cls.from_option_file(prefix)
    cfg.max_patches = 4096
    cfg.donor_budget = 512
    cfg.gauntlet_chunk = 256
    cfg.refine_rounds = 6
    cfg.refine_cands = 4
    cfg.prop_rounds = 2
    cfg.n_iterations = ITERS
    return cfg


def _quality(cloud):
    g = np.linspace(-0.8, 0.8, 160)
    xs, ys = np.meshgrid(g, g)
    gt = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)
    return metrics.accuracy_completeness(cloud, gt, threshold=0.05)


def run_pair(prefix, **overrides):
    """The JAX driver and the port (fed the JAX driver's random numbers)
    on the dataset at `prefix`, the test size with `overrides`, seed +
    ITERS iterations. Returns {name: dict(engine, alive, data)}."""
    out = {}
    for name in ("jax", "torch"):
        cfg = small_cfg(prefix, JMVSConfig if name == "jax" else TMVSConfig)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        e = (JPMMVS(cfg, log=lambda *a: None) if name == "jax" else
             TPMMVS(cfg, device="cpu", noise=JaxReplayNoise(0), log=lambda *a: None))
        e.seed()
        alive = [int(np.asarray(e.table.alive).sum())]
        for it in range(ITERS):
            e.propagate(it)
            e.filter()
            e.update_threshold()
            e.depth += 1
            alive.append(int(np.asarray(e.table.alive).sum()))
        out[name] = dict(engine=e, alive=alive, data=e.collect())
    return out


def assert_alive_tracks_jax(runs):
    ja, ta = runs["jax"]["alive"], runs["torch"]["alive"]
    assert ja[0] == ta[0]  # identical seeding
    assert ta[-1] > ta[0]
    for a, b in zip(ja, ta):
        assert abs(a - b) <= 0.03 * a, (ja, ta)


def assert_quality_tracks_jax(runs):
    mj = _quality(runs["jax"]["data"]["coord"][:, :3])
    mt = _quality(runs["torch"]["data"]["coord"][:, :3])
    for k in ("acc_mean", "comp_frac"):
        assert abs(mt[k] - mj[k]) <= 0.1 * mj[k], (k, mt, mj)
    return mt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("scene"))
    jsyn.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=48)
    return dict(run_pair(prefix), prefix=prefix)


def test_alive_counts_track_jax(runs):
    assert_alive_tracks_jax(runs)


def test_quality_tracks_jax(runs):
    assert assert_quality_tracks_jax(runs)["acc_median"] < 0.02


def test_seeds_match_exactly(runs):
    prefix = runs["prefix"]
    j = JPMMVS(small_cfg(prefix, JMVSConfig), scene=runs["jax"]["engine"].scene,
               log=lambda *a: None)
    t = TPMMVS(small_cfg(prefix), scene=runs["torch"]["engine"].scene, log=lambda *a: None)
    j.seed()
    t.seed()
    dj, dt = j.collect(), t.collect()
    np.testing.assert_array_equal(dt["images"], dj["images"])
    np.testing.assert_array_equal(dt["coord"], dj["coord"])
    np.testing.assert_allclose(dt["ncc"], dj["ncc"], atol=2e-4)
    np.testing.assert_allclose(dt["dscale"], dj["dscale"], rtol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_patch_file_round_trip(runs, writer, tmp_path):
    """A .patch written by one package seeds the other with the same
    patches (values pass through repr(float) text)."""
    prefix = runs["prefix"]
    reader = "torch" if writer == "jax" else "jax"
    path = str(tmp_path / "ply" / "00000001")
    runs[writer]["engine"].write_patches(path, export_ply=False, export_patch=True)
    cfg = small_cfg(prefix, JMVSConfig if reader == "jax" else TMVSConfig)
    cfg.prefix = str(tmp_path)
    scene = runs[reader]["engine"].scene
    e = (JPMMVS(cfg, scene=scene, log=lambda *a: None) if reader == "jax"
         else TPMMVS(cfg, scene=scene, log=lambda *a: None))
    e.seed(resume_iter=1)
    got, want = e.collect(), runs[writer]["data"]
    for k in ("coord", "normal", "ncc", "dscale", "ascale"):
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32), err_msg=k)
    np.testing.assert_array_equal(got["images"], want["images"])


def test_cli_cpu_filter_only_and_report(runs, tmp_path):
    prefix = runs["prefix"]
    runs["torch"]["engine"].write_patches(
        os.path.join(prefix, "ply", "00000002"), export_ply=False, export_patch=True)
    out = str(tmp_path / "final")
    report = str(tmp_path / "report.json")
    cuda_ncc.reset_launches()
    rc = cli.main([prefix, "--device", "cpu", "--filter-only", "--resume-iter", "2",
                   "--export-patch", "--out", out, "--report", report])
    assert rc == 0
    assert os.path.exists(out + ".ply") and os.path.exists(out + ".patch")
    assert os.path.exists(report)
    # on the CPU the sampler runs its plain version: no kernel launch
    assert all(v == 0 for v in cuda_ncc.LAUNCHES.values())
