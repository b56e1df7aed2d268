"""A cell cut to a tiny size, end to end on the CPU (the engine's plain
sampler, ``use_pallas`` off), past the harness's look for a card."""

import json
import math
import shutil
import subprocess
import sys
import time

import pytest
import torch

from mvsbench import run
from mvsbench.tests.tiny import tiny_cell

SEED = 2**31 + 4321


def _run(cell, trace):
    return run.run_cell(cell, SEED, 0.5, trace, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", ["dino16.plane", "dino16.sphere2"])
def test_tiny_cell_untraced(name):
    cell = tiny_cell(name)
    res = _run(cell, False)
    assert list(res)[:3] == ["correct", "attempted", "failed"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    for m in cell["end_to_end"]:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and math.isfinite(got["value"]) and got["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(res["checks"]) == list(run.CHECKS)
    for k, c in res["checks"].items():
        assert set(c) == {"value", "limit", "kind"} and c["kind"] in ("max", "min")
        assert run.passes(c["value"], {c["kind"]: c["limit"]}), (k, c)
    json.dumps(res)


def test_tiny_cell_traced():
    cell = tiny_cell()
    res = _run(cell, True)
    assert res["correct"] is True
    spans = {"load_s", "seed_s", "propagate_s", "filter_s", "write_s"}
    assert spans <= set(res["metrics"]) <= {m["name"] for m in cell["per_layer"]}
    assert all(res["metrics"][k]["value"] > 0 for k in spans)
    # a traced window times at least one untraced reconstruction, the spans' source
    assert res["attempted"] >= 2
    # no device trace off a card: its readers find nothing and stay out
    assert "device_idle_pct" not in res["metrics"] and "busy_s" not in res["device"]


def test_same_seed_same_inputs():
    from mvsbench import scene

    cell = tiny_cell("dino16.sphere2")
    a = scene.make_scene(cell["config"], cell["traffic"], SEED, "cpu")
    b = scene.make_scene(cell["config"], cell["traffic"], SEED, "cpu")
    c = scene.make_scene(cell["config"], cell["traffic"], SEED + 1, "cpu")
    assert torch.equal(a.images, b.images) and (a.seeds == b.seeds).all()
    assert not torch.equal(a.images, c.images)
    assert a.images.shape == c.images.shape and a.seeds.shape == c.seeds.shape


def test_no_result_without_card_or_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and mvsbench/, and on
    a machine without a card, the command exits non-zero and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("the card is there: this case is for a machine without one")
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "mvsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "mvsbench.run", "--workload", "dino16.plane",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
