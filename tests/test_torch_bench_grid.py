"""The port's grid-build and round-split benches on the CPU
(mvskit_tpu_torch/tools/bench_grid.py and bench_prop_parts.py), and its
batch-cut check (tools/batch_bits.py), at a small size: bench_grid's JSON keys, its tiled and dp builds equal to the
plain one, and its synthetic table equal to the JAX tool's
(tools/bench_grid.py:63-84, the same numpy code through the JAX
package's from_numpy); bench_prop_parts on a one-iteration run's .patch
names every stage, and its propagate_round(full) table equals
propagate_round's under the same noise; every function of the dp stages
gives a row the same bits in a block of whole CPU grains
(shard.DP_GRAIN) as in the whole batch."""

import json
import os

import numpy as np
import pytest
import torch

from mvskit_tpu.core import patches as jpt
from mvskit_tpu_torch import cli, interop
from mvskit_tpu_torch.config import MVSConfig
from mvskit_tpu_torch.core.grid import pow2_limit
from mvskit_tpu_torch.pipeline import propagate as pr
from mvskit_tpu_torch.pipeline import seed as sd
from mvskit_tpu_torch.pipeline.driver import PMMVS
from mvskit_tpu_torch.tools import batch_bits, bench_grid, bench_prop_parts
from mvskit_tpu_torch.utils import synthetic

SMALL = dict(donor_budget=256, gauntlet_chunk=128, refine_rounds=2, refine_cands=4)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 10-view 160x120 dataset (the table's lists take up to 10 views)
    and the .patch of a one-iteration run."""
    td = str(tmp_path_factory.mktemp("ds"))
    synthetic.write_dataset(td, n_views=10, width=160, height=120, n_seeds=256)
    out = os.path.join(td, "ply", "final_patches")
    rc = cli.main([td, "--device", "cpu", "--iterations", "1", "--prop-rounds", "1",
                   "--max-patches", "4096", "--donor-budget", "256", "--chunk", "128",
                   "--refine-rounds", "2", "--refine-cands", "4", "--no-snapshots",
                   "--export-patch", "--out", out])
    assert rc == 0
    return td, out + ".patch"


def test_bench_grid_cpu(dataset, capsys):
    td, _ = dataset
    assert bench_grid.main(["--prefix", td, "--max-patches", "4096", "--alive", "600",
                            "--tiles", "2", "--dp", "3", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("metric", "value", "capacity_rows", "alive", "cell_capacity", "tiled_ms",
                "dp_ms", "equal", "card", "device"):
        assert key in rec, key
    assert rec["metric"] == "grid_build_ms" and rec["equal"] == {"tiled": True, "dp": True}
    assert (rec["capacity_rows"], rec["alive"]) == (4096, 600)
    assert rec["value"] is None and rec["device"] == "cpu"  # nothing timed on the CPU
    assert rec["occupied_slots"] > 0


def test_bench_grid_table_equals_jax_tools(dataset):
    """The JAX tool's numpy code, as it stands there, through the JAX
    package's from_numpy."""
    n_img, cap, A = 10, 4096, 600
    rng = np.random.default_rng(0)
    coord = np.concatenate(
        [rng.uniform(-1, 1, (A, 2)), rng.normal(0, 0.01, (A, 1)), np.ones((A, 1))],
        axis=1,
    ).astype(np.float32)
    normal = np.tile(np.asarray([0, 0, 1, 0], np.float32), (A, 1))
    images = np.full((A, n_img), -1, np.int32)
    for i in range(A):
        k = rng.integers(4, 11)
        images[i, :k] = rng.choice(n_img, size=k, replace=False)
    jt = jpt.from_numpy(coord, normal, images, cap, n_img,
                        ncc=rng.uniform(0.4, 1.0, (A,)).astype(np.float32), vimages=images)
    _, tt = bench_grid.synthetic_table(n_img, cap, A, "cpu")
    got = interop.table_to_numpy(tt)
    for k in interop.TABLE_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jt, k)), err_msg=k)


def test_bench_prop_parts_cpu(dataset, tmp_path):
    td, patch = dataset
    rec, round_table = bench_prop_parts.run(td, patch, max_patches=4096, reps=1, dp=2,
                                            device="cpu", **SMALL)
    names = {"build_grid", "select_donors", "generate_hypotheses(16k)", "pre_process(4k)",
             "refine(4k)", "post_process(4k)", "vimages(4k)", "check:gain(4k)",
             "check:neighbors(4k)", "check:quad(4k)", "check:total(4k)",
             "gauntlet(4k,total)", "propagate_round(full)", "gauntlet(full)",
             "insert_patches", "filter:rebuild", "filter:outside", "filter:exact",
             "filter:neighbor", "filter:groups"}
    assert set(rec["timings_ms"]) == names
    assert set(rec["stages"]["dp1"]) == names
    assert names - set(rec["stages"]["dp2"]) == {
        "pre_process(4k)", "refine(4k)", "post_process(4k)", "vimages(4k)",
        "check:gain(4k)", "check:neighbors(4k)", "check:quad(4k)", "check:total(4k)",
        "gauntlet(4k,total)"}
    assert rec["round_equal_across_dp"] and rec["alive"] > 0
    json.dumps(rec)
    # the same round through propagate_round, under the same noise
    cfg = MVSConfig.from_option_file(td)
    cfg.max_patches = 4096
    for k, v in SMALL.items():
        setattr(cfg, k, v)
    eng = PMMVS(cfg, device="cpu", log=lambda *a: None)
    eng.close()
    table = sd.seed_from_patch_file(eng.scene, cfg, patch)
    gen = torch.Generator()
    gen.manual_seed(0)
    want, stats = pr.propagate_round(
        eng.scene, table, pr.TorchNoise(gen), eng.prop_params, 1, eng.ncc_threshold,
        eng.ncc_threshold_before, use_depth=True, quad_threshold=cfg.quad_threshold,
        row_limit=pow2_limit(table.n_alive(), table.capacity))
    assert stats.passed > 0
    for a, b in zip(round_table, want):
        assert torch.equal(a, b)


def test_batch_bits_grain_blocks_keep_bits():
    rec = batch_bits.run(points=512, views=8, width=160, height=120, device="cpu")
    assert rec["grain"] == 32 and rec["points"] > 4 * 32
    for name, cuts in rec["differing"].items():
        assert cuts["grain"][0] == 0, name
    # a ragged block does round the column sum differently on the CPU
    assert rec["differing"]["column_sum_6xB"]["ragged3"][0] > 0
