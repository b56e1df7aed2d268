"""The port's end-to-end tool (mvskit_tpu_torch/tools/e2e_run.py) at the JAX
tool's CPU smoke shape (6 views, 160x120, 256 seeds; tools/e2e_run.py:15),
on the plane and the sphere, at a cut depth (1 iteration of 1 round,
256 donors): it writes E2E_<tag>.json where it is told, with the JAX
tool's field names, and refuses to overwrite a JAX record."""

import json

import pytest

from mvskit_tpu_torch.tools import e2e_run

SMOKE = ["--views", "6", "--width", "160", "--height", "120", "--seeds", "256",
         "--device", "cpu", "--iterations", "1", "--prop-rounds", "1",
         "--donor-budget", "256", "--max-patches", "4096"]
# the JAX tool's record (tools/e2e_run.py:206-237)
KEYS = {"tag", "backend", "dataset", "config", "total_seconds", "seeded",
        "alive_per_iter", "final_alive", "hypotheses_total",
        "hypotheses_per_s_overall", "stages"}
CONFIG = {"iterations", "prop_rounds", "donor_budget", "max_patches", "level", "csize",
          "wsize", "refine_rounds", "refine_cands", "strategy", "luma_refine", "mesh"}
SPHERE = {"surface_dist_median", "surface_frac@0.05", "n_off_surface@0.2", "n_on_sphere"}


@pytest.mark.parametrize("geometry", ["plane", "sphere"])
def test_e2e_smoke(tmp_path, geometry):
    out = tmp_path / f"E2E_smoke_{geometry}.json"
    rc = e2e_run.main(SMOKE + ["--geometry", geometry, "--prefix", str(tmp_path / "ds"),
                               "--tag", f"smoke_{geometry}", "--out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert KEYS <= set(rec) and CONFIG <= set(rec["config"])
    assert rec["dataset"]["geometry"] == geometry and rec["backend"] == "cpu"
    m = rec[f"quality_vs_analytic_{geometry}@0.05"]
    assert {"acc_mean", "comp_frac"} <= set(m)
    assert SPHERE <= set(m) if geometry == "sphere" else "plane_rms" in m
    assert len(rec["alive_per_iter"]) == 1 and rec["final_alive"] > rec["seeded"] / 2
    props = [s for s in rec["stages"] if s["stage"].startswith("propagate")]
    assert props[0]["hypotheses"] > 0
    filt = [s for s in rec["stages"] if s["stage"].startswith("filter")]
    assert set(filt[0]["removed"]) == {"outside", "exact", "neighbor", "groups"}


def test_e2e_refuses_a_jax_record(tmp_path):
    out = tmp_path / "E2E_r05.json"
    out.write_text("{}")
    with pytest.raises(SystemExit, match="refusing"):
        e2e_run.main(SMOKE + ["--prefix", str(tmp_path / "ds"), "--out", str(out)])
    assert out.read_text() == "{}"
