"""The span recorder of the port (``mvskit_tpu_torch/utils/profiling.py``:
``tracing``, ``span``, ``sync``, ``note``, ``carry``, ``Trace``) on the
CPU: off it is one shared null context and records nothing; on it leaves
every table and count bit for bit as it was, and records the span tree
of a reconstruction (load, seed, propagation's rounds and their stages,
the filter phases, the writes and the writer thread's snapshots) with
each round's hypothesis count; its clock is the one torch.profiler's
events carry; and its summary and idle split are what their docstrings
say. On the CPU a gauntlet chunk runs its stages op by op under its
``chunk`` span; on a card (the one test here that needs one) a chunk is
``graphed``, its key's first holds the ``capture`` (the stages' spans
inside it) and each holds its ``replay``. The card's other side (each
sync the recorder counts is one the CUDA sync debug mode reports, and an
idle gap lands in its span) is in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time

import pytest
import torch

from mvskit_tpu_torch.utils import profiling

# one torch thread per test worker, as tests/torch_replay.py sets it
torch.set_num_threads(1)

SMALL = dict(max_patches=4096, donor_budget=256, gauntlet_chunk=128, refine_cands=4)

# every span name of a reconstruction and the name of its parent
PARENTS = {
    "load": None, "decode": "load", "pyramid": "load", "seed": None,
    "propagate": None, "round": "propagate", "donors": "round", "hypotheses": "round",
    "gauntlet": "round", "chunk": "gauntlet", "pre": "chunk", "refine": "chunk",
    "post": "chunk", "views": "chunk", "check": "chunk", "insert": "round",
    "filter": None, "rebuild": "filter", "outside": "filter", "exact": "filter",
    "neighbor": "filter", "groups": "filter",
    "write": None, "collect": "write", "colors": "write", "encode": "write",
    "snapshot": "write", "join": None,
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from mvskit_tpu_torch.utils import synthetic

    prefix = str(tmp_path_factory.mktemp("tracing") / "plane")
    synthetic.write_dataset(prefix, n_views=6, width=96, height=64, n_seeds=64)
    return prefix


def _config(prefix, **kw):
    from mvskit_tpu_torch.config import MVSConfig

    cfg = MVSConfig.from_option_file(prefix)
    for k, v in {**SMALL, **kw}.items():
        setattr(cfg, k, v)
    return cfg


def _engine(prefix, **kw):
    from mvskit_tpu_torch.pipeline.driver import PMMVS

    return PMMVS(_config(prefix, **kw), device="cpu", log=lambda *a: None)


@pytest.fixture(scope="module")
def traced_run(dataset, tmp_path_factory):
    """A whole traced reconstruction of two iterations (the second runs
    the depth-2 check) with snapshots and a final write."""
    out = str(tmp_path_factory.mktemp("tracing_out") / "final")
    with profiling.tracing() as trace:
        engine = _engine(dataset, n_iterations=2, prop_rounds=2)
        try:
            engine.run(write_snapshots=True)
            engine.write_patches(out, export_ply=True, export_patch=True)
        finally:
            engine.close()
    return trace, engine


def test_off_is_one_shared_null_context():
    assert profiling.TRACE is None
    off = profiling.span("round", hypotheses=3)
    assert off is profiling.span("chunk") is profiling.sync("gauntlet.live")
    with off as got:
        assert got is None
    profiling.note(hypotheses=1)

    def fn():
        return 1

    assert profiling.carry(fn, "snapshot") is fn
    assert profiling.TRACE is None
    with profiling.tracing() as trace:
        assert profiling.TRACE is trace
        with profiling.span("a"):
            pass
    assert profiling.TRACE is None and [s.name for s in trace.spans] == ["a"]


def _table_bits(t):
    return [x.clone() for x in t]


def test_round_and_filters_same_bits_on_and_off(dataset):
    """One propagation round and one filter pass, with the recorder off
    and on: the same tables and counts bit for bit."""
    runs = []
    for on in (False, True):
        with (profiling.tracing() if on else contextlib.nullcontext()) as trace:
            engine = _engine(dataset, prop_rounds=1)
            engine.seed()
            st = engine.propagate(0)
            after_round = _table_bits(engine.table)
            fs = engine.filter()
            engine.close()
        runs.append((st, fs, after_round, _table_bits(engine.table), trace))
    (st0, fs0, r0, f0, _), (st1, fs1, r1, f1, trace) = runs
    assert st0 == st1 and fs0 == fs1
    for a, b in zip(r0 + f0, r1 + f1):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rounds = [s for s in trace.spans if s.name == "round"]
    assert len(rounds) == 1 and rounds[0].attrs == {"hypotheses": st1.total,
                                                    "passed": st1.passed}
    assert st1.total > 0


def test_span_tree(traced_run):
    trace, engine = traced_run
    by_id = {s.id: s for s in trace.spans}
    seen = set()
    for s in trace.spans:
        if s.kind == "sync":
            continue
        seen.add(s.name)
        parent = by_id[s.parent].name if s.parent is not None else None
        if s.name == "grid":
            assert parent in ("round", "rebuild"), parent
        else:
            assert parent == PARENTS[s.name], (s.name, parent)
    assert seen == set(PARENTS) | {"grid"}
    summary = trace.summary()
    for path in ("propagate/round/gauntlet/chunk/refine", "propagate/round/grid",
                 "filter/rebuild/grid", "filter/neighbor", "write/snapshot", "load/pyramid"):
        assert summary[path]["count"] > 0, path
    # each iteration's rounds hold its hypotheses and accepted counts
    stages = [r for r in engine.report["stages"] if r["stage"].startswith("propagate")]
    for it, rec in enumerate(stages):
        prop = [s for s in trace.spans if s.name == "propagate"
                and s.attrs == {"iteration": it}]
        assert len(prop) == 1
        rounds = [s for s in trace.spans if s.name == "round" and s.parent == prop[0].id]
        assert len(rounds) == 2
        assert sum(s.attrs["hypotheses"] for s in rounds) == rec["hypotheses"]
        assert sum(s.attrs["passed"] for s in rounds) == rec["accepted"]
    # a chunk's rows add up to the live hypotheses its gauntlet ran
    chunks = summary["propagate/round/gauntlet/chunk"]
    assert chunks["attrs"]["rows"] == sum(r["hypotheses"] for r in stages)
    # every sync of a round lies under the round; each names its site
    syncs = {trace.paths()[s.id] for s in trace.spans if s.kind == "sync"}
    assert "propagate/round/gauntlet/gauntlet.live" in syncs
    assert "propagate/round/round.total" in syncs
    assert "filter/neighbor/neighbor.kills" in syncs
    assert summary["propagate/round"]["syncs"] > 0


def test_no_sync_inside_a_chunk(traced_run):
    """A chunk gathers its noise rows on the device: no sync span of the
    run has a ``chunk`` span among its ancestors (run_gauntlet on one
    device opens none)."""
    trace, _ = traced_run
    paths = trace.paths()
    syncs = [paths[s.id].split("/") for s in trace.spans if s.kind == "sync"]
    assert ["propagate", "round", "gauntlet", "gauntlet.chunks"] in syncs
    assert not [p for p in syncs if "chunk" in p[:-1]]


STAGES = {"pre", "refine", "post", "views", "check"}


def _children(trace):
    kids = {}
    for s in trace.spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def test_cpu_chunks_run_their_stages_op_by_op(traced_run):
    trace, _ = traced_run
    kids = _children(trace)
    chunks = [s for s in trace.spans if s.name == "chunk"]
    assert chunks
    for c in chunks:
        assert set(c.attrs) == {"rows"}
        names = {k.name for k in kids.get(c.id, []) if k.kind == "span"}
        assert {"pre", "refine", "post", "views"} <= names <= STAGES, names


@pytest.mark.cuda
def test_card_chunks_replay_graphs(tmp_path):
    """On a card each chunk of a traced two-iteration run is graphed and
    holds its replay; the first chunk of each key (one per iteration
    here) holds the capture, with the stages' spans inside it and no
    sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from mvskit_tpu_torch.pipeline import propagate as pr
    from mvskit_tpu_torch.pipeline.driver import PMMVS
    from mvskit_tpu_torch.utils import synthetic

    prefix = str(tmp_path / "plane")
    synthetic.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=256)
    cfg = _config(prefix, n_iterations=2, prop_rounds=2, donor_budget=512,
                  gauntlet_chunk=256)
    profiling.COUNTERS.reset()
    with profiling.tracing() as trace:
        engine = PMMVS(cfg, device="cuda", log=lambda *a: None)
        try:
            engine.run(write_snapshots=False)
        finally:
            engine.close()
    kids, paths = _children(trace), trace.paths()
    chunks = [s for s in trace.spans if s.name == "chunk"]
    assert len(chunks) >= 4 and pr.GRAPHS["replays"] == len(chunks)
    assert pr.GRAPHS["captures"] == 2 and not any(k.startswith("eager") for k in pr.GRAPHS)
    captures = []
    for c in chunks:
        assert c.attrs.get("graphed") == 1, c.attrs
        names = [k.name for k in kids.get(c.id, []) if k.kind == "span"]
        assert names in (["replay"], ["capture", "replay"]), names
        captures += [k for k in kids[c.id] if k.name == "capture"]
    assert len(captures) == 2
    for cap in captures:
        inside = {k.name for k in kids.get(cap.id, [])}
        assert {"pre", "refine", "post", "views"} <= inside <= STAGES, inside
        assert not any(s.kind == "sync" and paths[s.id].startswith(paths[cap.id] + "/")
                       for s in trace.spans)
    # the captures are the first chunk of each iteration's propagation
    firsts = []
    for prop in (s for s in trace.spans if s.name == "propagate"):
        under = [c for c in chunks if paths[c.id].startswith("propagate/")
                 and c.start_ns >= prop.start_ns and c.end_ns <= prop.end_ns]
        firsts.append(min(under, key=lambda c: c.start_ns).id)
    assert sorted(firsts) == sorted(cap.parent for cap in captures)


def test_snapshot_runs_on_the_writer_thread(traced_run):
    trace, _ = traced_run
    by_id = {s.id: s for s in trace.spans}
    snaps = [s for s in trace.spans if s.name == "snapshot"]
    assert len(snaps) == 4  # two a propagation iteration, wait=False
    main = threading.main_thread().name
    for s in snaps:
        assert s.thread != main
        parent = by_id[s.parent]
        assert parent.name == "write" and parent.thread == main
        assert s.start_ns >= parent.start_ns
    assert all(s.thread == main for s in trace.spans if s.name != "snapshot")


def test_encode_span_names_the_writer(traced_run, tmp_path):
    """The final write's ``encode`` span names the encoder that wrote the
    patch file, and ``patch_io.WRITERS`` counts it: native where the
    library loaded (the other side, MVSKIT_NO_NATIVE, is in
    tests/test_torch_patch_native.py). The snapshots write no patch file."""
    from mvskit_tpu_torch.io import native, patch_io

    trace, engine = traced_run
    want = "native" if native.available() else "python"
    assert [s.attrs for s in trace.spans if s.name == "encode"] == [{"writer": want}]
    assert all(not s.attrs for s in trace.spans if s.name == "snapshot")
    assert trace.summary()["write/encode"]["attrs"] == {"writer": {want: 1}}
    before = collections.Counter(patch_io.WRITERS)
    with profiling.tracing() as tr:
        engine.write_patches(str(tmp_path / "again"), export_ply=False, export_patch=True)
    assert patch_io.WRITERS - before == collections.Counter({want: 1})
    assert [s.attrs for s in tr.spans if s.name == "encode"] == [{"writer": want}]


def test_clock_is_the_profilers():
    """A span converted to the Unix clock lies within 1 ms of a
    record_function event of the same block."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(256, 256)
    with profiling.tracing() as trace:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for k in range(4):  # the first block warms the profiler up
                with record_function(f"block{k}"), profiling.span(f"block{k}"):
                    for _ in range(20):
                        x = torch.tanh(x @ x.T / 256)
                    time.sleep(0.002)
    events = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("block"))
    spans = sorted((s.start_ns, s.end_ns) for s in trace.spans)
    assert len(events) == len(spans) == 4
    for (e0, e1), (s0, s1) in zip(events[1:], spans[1:]):
        assert abs(e0 - s0) < 1_000_000 and abs(e1 - s1) < 1_000_000


def _span(trace, name, start_ms, end_ms, parent=None, kind="span", thread="MainThread",
          **attrs):
    s = profiling.Span(next(trace._ids), name, kind, parent, thread, attrs)
    s.start_ns, s.end_ns = int(start_ms * 1e6), int(end_ms * 1e6)
    trace.spans.append(s)
    return s


def test_summary_self_time_and_syncs():
    tr = profiling.Trace()
    a = _span(tr, "a", 0, 100)
    b = _span(tr, "b", 10, 30, a.id, rows=5)
    _span(tr, "s", 12, 14, b.id, kind="sync")
    _span(tr, "b", 40, 50, a.id, rows=7)
    _span(tr, "s", 55, 56, a.id, kind="sync")
    # a job another thread ran for `a`, half of it after `a` closed
    _span(tr, "snapshot", 90, 110, a.id, thread="writer")
    got = tr.summary()
    assert got["a"]["count"] == 1
    assert got["a"]["total_s"] == pytest.approx(0.1)
    # 20 + 10 + 1 ms of children, and 10 ms of the snapshot, inside a
    assert got["a"]["self_s"] == pytest.approx(0.059)
    assert got["a"]["syncs"] == 2 and got["a"]["sync_wait_s"] == pytest.approx(0.003)
    assert got["a/b"]["count"] == 2 and got["a/b"]["total_s"] == pytest.approx(0.03)
    assert got["a/b"]["self_s"] == pytest.approx(0.028)
    assert got["a/b"]["attrs"] == {"rows": 12}
    assert got["a/b"]["syncs"] == 1
    assert got["a/b/s"]["syncs"] == 1 and got["a/s"]["sync_wait_s"] == pytest.approx(0.001)
    assert got["a/snapshot"]["self_s"] == pytest.approx(0.02)


def test_idle_split_by_innermost_span():
    tr = profiling.Trace()
    a = _span(tr, "a", 0, 100)
    b = _span(tr, "b", 20, 60, a.id)
    _span(tr, "c", 30, 40, b.id)
    _span(tr, "w", 0, 100, thread="writer")  # another thread: not an owner
    busy = [(int(5e6), int(25e6)), (int(35e6), int(38e6)), (int(37e6), int(45e6)),
            (int(90e6), int(120e6))]
    got = tr.idle_by_span(busy)
    # a owns [0, 20) and [60, 100): idle [0, 5) and [60, 90)
    assert got["a"] == pytest.approx(0.035)
    # b owns [20, 30) and [40, 60): idle [25, 30) + [45, 60)
    assert got["a/b"] == pytest.approx(0.020)
    # c owns [30, 40): idle [30, 35)
    assert got["a/b/c"] == pytest.approx(0.005)
    # the sum is the span range less the device's busy time inside it
    assert sum(got.values()) == pytest.approx(0.1 - 0.020 - 0.010 - 0.010)
    # within a window: [10, 50) less its busy [10, 25) and [35, 45)
    got = tr.idle_by_span(busy, window=(int(10e6), int(50e6)))
    assert got == pytest.approx({"a/b": 0.010, "a/b/c": 0.005})


def test_cli_report_spans(dataset, tmp_path):
    from mvskit_tpu_torch import cli

    flags = ["--device", "cpu", "--iterations", "1", "--prop-rounds", "1",
             "--max-patches", "4096", "--donor-budget", "256", "--chunk", "128",
             "--refine-cands", "4", "--no-snapshots"]
    for traced in (True, False):
        report = tmp_path / f"r{int(traced)}.json"
        argv = [dataset, *flags, "--out", str(tmp_path / "o"), "--report", str(report)]
        assert cli.main(argv + (["--trace-spans"] if traced else [])) == 0
        got = json.loads(report.read_text())
        assert ("spans" in got) == traced
    assert profiling.TRACE is None
    spans = json.loads((tmp_path / "r1.json").read_text())["spans"]
    assert spans["propagate/round"]["count"] == 1
    assert spans["filter/neighbor"]["count"] == 1
    assert spans["propagate/round"]["attrs"]["hypotheses"] > 0
    assert {"count", "total_s", "self_s", "syncs", "sync_wait_s"} <= set(spans["filter"])
