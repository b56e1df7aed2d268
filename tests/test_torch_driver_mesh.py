"""Driver-level meshes of mvskit_tpu_torch (mirrors tests/test_driver_mesh.py):
PMMVS built with a (dp, view, tile) mesh from its config runs the same
driver path as the unsharded run (seed -> propagate -> filter -> final
cloud) on copies of the CPU, and its cloud equals the unsharded one bit
for bit: mesh_tile=8, (2, 2, 2), mesh_dp=2 and mesh_view=4. One port
run at mesh_tile=8 against the JAX driver at mesh_tile=8 on its 8
virtual devices (tests/test_torch_pipeline.py's run_pair, alive counts
within 3 %). The CLI takes --mesh, and a bad --mesh is a usage error
(exit 2; the JAX CLI raises a bare ValueError, cli.py:68-71)."""

import os

import numpy as np
import pytest

from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch import cli
from mvskit_tpu_torch.config import MVSConfig
from mvskit_tpu_torch.io import ply
from mvskit_tpu_torch.pipeline.driver import PMMVS
from test_torch_pipeline import assert_alive_tracks_jax, run_pair


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("ds"))
    jsyn.write_dataset(td, n_views=4, width=96, height=64, n_seeds=48)
    return td


def _cfg(prefix, **over):
    cfg = MVSConfig.from_option_file(prefix)
    cfg.n_iterations = 1
    cfg.prop_rounds = 2
    cfg.max_patches = 2048
    cfg.donor_budget = 128
    cfg.gauntlet_chunk = 128
    cfg.refine_rounds = 2
    cfg.refine_cands = 4
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _run(cfg):
    eng = PMMVS(cfg, device="cpu", log=lambda *a: None)
    try:
        eng.seed()
        eng.run(write_snapshots=False)
        return eng, eng.collect()
    finally:
        eng.close()


@pytest.fixture(scope="module")
def base_cloud(dataset):
    return _run(_cfg(dataset))[1]


@pytest.mark.parametrize("mesh", [(1, 1, 8), (2, 2, 2), (2, 1, 1), (1, 4, 1)])
def test_mesh_driver_bit_equal(dataset, base_cloud, mesh):
    dp, view, tile = mesh
    eng, got = _run(_cfg(dataset, mesh_dp=dp, mesh_view=view, mesh_tile=tile))
    assert eng.mesh.shape == {"dp": dp, "view": view, "tile": tile}
    assert (eng.scene.view_mesh is not None) == (view > 1)
    assert got["coord"].shape[0] > 0
    for k, want in base_cloud.items():
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_tile_mesh_tracks_jax_tile_mesh(dataset):
    """Both drivers at mesh_tile=8, the port fed the JAX driver's noise."""
    assert_alive_tracks_jax(run_pair(dataset, mesh_tile=8))


def test_cli_mesh(dataset, tmp_path):
    out = str(tmp_path / "cloud")
    rc = cli.main([dataset, "--device", "cpu", "--mesh", "1,2,2", "--iterations", "1",
                   "--prop-rounds", "2", "--max-patches", "2048", "--donor-budget", "128",
                   "--chunk", "128", "--refine-rounds", "2", "--refine-cands", "4",
                   "--no-snapshots", "--out", out])
    assert rc == 0 and os.path.exists(out + ".ply")
    assert ply.read_ply(out + ".ply")["xyz"].shape[0] > 0
    for bad in ("0,1,1", "1,2", "a,b,c"):
        with pytest.raises(SystemExit) as e:
            cli.main([dataset, "--device", "cpu", "--mesh", bad])
        assert e.value.code == 2
