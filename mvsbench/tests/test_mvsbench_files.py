"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import re

import pytest

from mvsbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mvsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_metrics_moves_and_layers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"recon_s", "acc_p90", "comp_pct", "setup_s"} == e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = run.load_cell(cell)
    assert c["chips"] == 1
    assert c["config"]["views"] > 0 and c["traffic"]["geometry"] in ("plane", "sphere")
    assert sorted(c["limits"]) == sorted(run.CHECKS)
    assert all(len(v) == 1 and set(v) <= {"max", "min"} for v in c["limits"].values())
    assert {m["name"] for m in c["per_layer"]}, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = run.reader(metric)
    from mvsbench.trace import Reading

    empty = Reading(spans=[], recon_s=1.0, counters={}, wsize=7, windows={})
    assert read(empty) is None  # finds nothing to read, returns nothing


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    c = json.loads((run.ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("mvsbench/") and c["name"] == conf["name"]
    assert c["reduced"] == conf["reduced"]
    for k in ("level", "csize", "threshold", "wsize", "minImageNum"):
        assert k in c["option"]


def test_trace_reading_by_span():
    """Busy time is the union of each traced span's device operations,
    idle time the span's length less that, summed over spans of one name;
    the spans' seconds and the wall time are the untraced
    reconstructions', averaged."""
    from mvsbench.trace import Recorder, read_trace

    rec = Recorder(None)
    rec.spans = [("load", 0.0, 1.0), ("write", 1.0, 1.5), ("propagate[0]", 1.5, 3.5),
                 ("write", 3.5, 4.0)]
    ms = 1_000_000
    rec.ops = [("k", 0, 200 * ms, "load"), ("k", 100 * ms, 200 * ms, "load"),
               ("Memcpy HtoD", 1000 * ms, 100 * ms, "write"),
               ("window_kernel<3, 7, 0>", 1600 * ms, 1000 * ms, "propagate[0]"),
               ("k", 3600 * ms, 100 * ms, "write")]
    rec.counters["hypotheses"] = 2
    plain = [Recorder(None), Recorder(None)]
    plain[0].spans = [("load", 0.0, 0.5), ("propagate[0]", 0.5, 2.0), ("write", 2.0, 2.2),
                      ("write", 2.2, 2.4)]
    plain[1].spans = [("load", 0.0, 0.7), ("propagate[0]", 0.7, 2.0), ("write", 2.0, 2.4)]
    r = read_trace(rec, [(plain[0], 2.5), (plain[1], 3.5)], 7, {"grouped": {786432: 1}})
    assert r.traced_s == 4.0 and r.recon_s == 3.0 and abs(r.busy_s - 1.5) < 1e-12
    assert abs(r.idle_by_span["load"] - 0.7) < 1e-12 and abs(r.idle_by_span["write"] - 0.8) < 1e-12
    assert abs(run.reader("load_s")(r) - 0.6) < 1e-12
    assert abs(run.reader("propagate_s")(r) - 1.4) < 1e-12
    assert abs(run.reader("write_s")(r) - 0.4) < 1e-12
    assert run.reader("seed_s")(r) is None
    assert run.reader("launches_per_hyp")(r) == 0.5
    assert abs(run.reader("device_idle_pct")(r) - 50.0) < 1e-9
    bound_ms = 0.14554889
    assert abs(run.reader("sampler_roofline_pct")(r) - 100 * bound_ms / 1000) < 1e-4
