"""The gauntlet's fixed chunk shape and its CUDA graph rule
(``mvskit_tpu_torch/pipeline/propagate.py``: ``graph_rule``,
``_chunk_inputs``, ``_GauntletGraphs``, ``_gauntlet_chunked``) on the
CPU: the rule names why a chunk runs op by op (the CPU, a dp axis, a
view-sharded scene, the polish) and engages on a lone CUDA device; a
padded chunk's extra rows copy its first row and enter dead, and its
live rows keep their bits; the CPU runs its chunks unpadded and op by op,
each chunk's live rows alone, as before; the runner's static buffers take
each round's grid and table. The counter registry that a replay credits
(``utils/profiling.py`` ``COUNTERS``): one reset clears every counter,
increments credited back double, and ``patch_io.WRITERS`` counts from
two threads. The graphs themselves run only on a card
(``tests/test_torch_cuda.py -k graphed``)."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys
import threading

import numpy as np

import pytest
import torch

from gauntlet_case import ChunkNoise, bits, make_engine, round_inputs
from mvskit_tpu_torch.io import patch_io
from mvskit_tpu_torch.ops import cuda_ncc
from mvskit_tpu_torch.ops import ncc as nccops
from mvskit_tpu_torch.parallel import shard as sh
from mvskit_tpu_torch.pipeline import propagate as pr
from mvskit_tpu_torch.utils import profiling

# one torch thread per test worker, as tests/torch_replay.py sets it
torch.set_num_threads(1)

CUDA = torch.device("cuda")  # a device name only: nothing runs on it here
THRESHOLDS = (0.6, 0.4, True, 2.5)  # ncc_threshold, _before, use_depth, quad


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    e = make_engine(str(tmp_path_factory.mktemp("graphs") / "plane"), "cpu",
                    donor_budget=256)
    yield e
    e.close()


@pytest.fixture(scope="module")
def hyps(engine):
    return round_inputs(engine)


@pytest.mark.parametrize("where,reason", [
    ("cpu", "cpu"), ("dp", "dp"), ("view_mesh", "view_mesh"), ("view_group", "view_mesh"),
    ("polish", "polish"), ("polish_recorded", "polish"), ("lone_card", None)])
def test_graph_rule(engine, where, reason):
    scene, p = engine.scene, engine.prop_params
    dev, dp, ctx = CUDA, None, contextlib.nullcontext()
    if where == "cpu":
        dev = torch.device("cpu")
    elif where == "dp":
        dp = [CUDA, CUDA]
    elif where == "view_mesh":
        scene = sh.enable_view_sharding(scene, sh.make_mesh(2, "view", device="cpu"),
                                        "view")
    elif where == "view_group":
        scene = dataclasses.replace(scene, view_group=object())
    elif where == "polish":
        p = p._replace(grad_steps=2)
    elif where == "polish_recorded":
        ctx = profiling.polish_stats()
    with ctx:
        assert pr.graph_rule(dev, dp, scene, p) == reason
    # a CPU engine holds no runner
    assert engine._graphs is None


def test_padding_rows_copy_the_first_row_dead(hyps):
    _, _, coord, normal, images, ok = hyps
    rows = torch.nonzero(ok).flatten()[3:10]
    n, C = rows.numel(), 16
    got = pr._chunk_inputs(coord, normal, images, ok, rows, C)
    idx = torch.cat([rows, rows[:1].repeat(C - n)])
    for g, src in zip(got[:3], (coord, normal, images)):
        assert g.shape[0] == C and torch.equal(bits(g), bits(src[idx]))
    assert got[3].shape == (C,) and got[3][:n].all() and not got[3][n:].any()
    # a full chunk is its rows
    full = pr._chunk_inputs(coord, normal, images, ok, rows, n)
    assert all(torch.equal(bits(g), bits(src[rows]))
               for g, src in zip(full, (coord, normal, images, ok)))


def test_padded_chunk_keeps_its_live_rows(engine, hyps):
    """The gauntlet on 32 live rows padded to 64 gives the 32 rows'
    outputs bit for bit, and dead outputs on the padding."""
    grid, table, coord, normal, images, ok = hyps
    p = engine.prop_params
    rows = torch.nonzero(ok).flatten()[:32]
    assert rows.numel() == 32
    deltas = ChunkNoise(1, "cpu").refine(0, 1, p.refine_rounds, 64, p.refine_cands)
    deltas[:, 32:] = 0.0
    padded = pr.run_gauntlet(engine.scene, grid, table,
                             *pr._chunk_inputs(coord, normal, images, ok, rows, 64),
                             deltas, p, *THRESHOLDS)
    alone = pr.run_gauntlet(engine.scene, grid, table,
                            *pr._chunk_inputs(coord, normal, images, ok, rows, 32),
                            deltas[:, :32].contiguous(), p, *THRESHOLDS)
    for f in pr.GauntletOut._fields:
        assert torch.equal(bits(getattr(padded, f)[:32]), bits(getattr(alone, f))), f
    assert alone.ok.any()
    assert not (padded.ok[32:].any() or padded.fail0[32:].any() or padded.fail1[32:].any())


@pytest.mark.parametrize("runner", [False, True])
def test_cpu_chunks_run_unpadded_op_by_op(engine, hyps, runner):
    """On the CPU every chunk's live rows run alone through run_gauntlet,
    unpadded, with their JAX chunk's noise rows, whether or not a runner
    is passed; dead hypotheses read zeros with ok False."""
    grid, table, coord, normal, images, ok = hyps
    C = 64
    p = engine.prop_params._replace(chunk=C)
    noise = ChunkNoise(2, "cpu")
    profiling.COUNTERS.reset()
    out = pr._gauntlet_chunked(engine.scene, grid, table, coord, normal, images, ok, noise,
                               p, *THRESHOLDS,
                               graphs=pr._GauntletGraphs("cpu") if runner else None)
    live = torch.nonzero(ok).flatten()
    draws = {}
    chunks = 0
    for s in range(0, live.numel(), C):
        rows = live[s:s + C]
        for ch in {int(r) // C for r in rows}:
            draws.setdefault(ch, noise.refine(ch, 0, p.refine_rounds, C, p.refine_cands))
        deltas = torch.stack([draws[int(r) // C][:, int(r) % C] for r in rows], 1)
        want = pr.run_gauntlet(engine.scene, grid, table, coord[rows], normal[rows],
                               images[rows], ok[rows], deltas, p, *THRESHOLDS)
        for f in pr.GauntletOut._fields:
            assert torch.equal(bits(getattr(out, f)[rows]), bits(getattr(want, f))), f
        chunks += 1
    dead = ~ok
    assert chunks >= 2 and out.ok.any()
    assert not out.ok[dead].any() and (out.images[dead] == -1).all()
    assert (out.coord[dead] == 0).all()
    assert pr.GRAPHS["eager_cpu"] == chunks
    assert pr.GRAPHS["pad_rows"] == pr.GRAPHS["captures"] == pr.GRAPHS["replays"] == 0


def test_runner_buffers_take_each_round(hyps):
    """The runner copies each round's grid and table into the same static
    buffers, and release() drops them."""
    grid, table, *_ = hyps
    runner = pr._GauntletGraphs("cpu")
    runner.load(grid, table)
    sig, g1, t1 = runner.state
    table2 = table._replace(ncc=table.ncc + 1.0)
    runner.load(grid, table2)
    sig2, g2, t2 = runner.state
    assert sig == sig2
    assert all(a is b for a, b in zip(t1 + g1, t2 + g2))
    for buf, src in zip(t2 + g2, table2 + grid):
        assert torch.equal(bits(buf), bits(src)) and buf.data_ptr() != src.data_ptr()
    runner.release()
    assert runner.state is None and not runner.buffers and not runner.graphs


def _bump(n: int) -> None:
    """Add n to one key of every registered counter (WINDOWS: of two forms)."""
    cuda_ncc.LAUNCHES["grouped"] += n
    cuda_ncc.WINDOWS["grouped"][4096] += n
    cuda_ncc.WINDOWS["ungrouped"][512] += n
    nccops.SHARD_CALLS[0, "grouped"] += n
    nccops.SHARD_WINDOWS[0, "grouped"] += n
    sh.DP_ROWS["insert", 1] += n
    sh.DP_K1[1] += n
    pr.GRAPHS["replays"] += n
    patch_io.WRITERS["native"] += n


def test_one_reset_clears_every_counter():
    registered = {"cuda_ncc.LAUNCHES": cuda_ncc.LAUNCHES, "ncc.SHARD_CALLS": nccops.SHARD_CALLS,
                  "ncc.SHARD_WINDOWS": nccops.SHARD_WINDOWS, "shard.DP_ROWS": sh.DP_ROWS,
                  "shard.DP_K1": sh.DP_K1, "propagate.GRAPHS": pr.GRAPHS,
                  "patch_io.WRITERS": patch_io.WRITERS,
                  **{f"cuda_ncc.WINDOWS/{k}": c for k, c in cuda_ncc.WINDOWS.items()}}
    assert all(profiling.COUNTERS.counters[k] is c for k, c in registered.items())
    _bump(3)
    windows = dict(cuda_ncc.WINDOWS)
    profiling.COUNTERS.reset()
    # LAUNCHES keeps every form at 0, WINDOWS every form's own Counter, empty
    assert cuda_ncc.LAUNCHES == dict.fromkeys(cuda_ncc.LAUNCHES, 0)
    assert cuda_ncc.WINDOWS.keys() == cuda_ncc.LAUNCHES.keys() and "grouped" in cuda_ncc.LAUNCHES
    assert all(cuda_ncc.WINDOWS[k] is c and not c for k, c in windows.items())
    assert all(not c for k, c in registered.items() if k != "cuda_ncc.LAUNCHES")


def test_credited_increments_double():
    """The increments since a snapshot, credited back, count twice; what
    was counted before the snapshot is not among them."""
    profiling.COUNTERS.reset()
    _bump(5)
    before = profiling.COUNTERS.snapshot()
    _bump(2)
    inc = profiling.COUNTERS.since(before)
    assert inc["cuda_ncc.LAUNCHES"] == collections.Counter(grouped=2)
    assert inc["cuda_ncc.WINDOWS/ungrouped"] == collections.Counter({512: 2})
    assert not inc["cuda_ncc.WINDOWS/fused"]
    assert inc["shard.DP_ROWS"] == collections.Counter({("insert", 1): 2})
    profiling.COUNTERS.credit(inc)
    again = profiling.COUNTERS.since(before)
    assert again == {name: c + c for name, c in inc.items()}
    assert cuda_ncc.LAUNCHES["grouped"] == 5 + 2 * 2
    assert cuda_ncc.WINDOWS["grouped"] == collections.Counter({4096: 5 + 2 * 2})
    assert pr.GRAPHS == collections.Counter(replays=9)
    profiling.COUNTERS.reset()


def test_writers_count_from_two_threads(tmp_path):
    """Two threads writing patch files at once, the interpreter switching
    threads every microsecond, while this one takes snapshots: every
    file counted."""
    profiling.COUNTERS.reset()
    empty = np.zeros((0, 4), np.float32)
    n = 300

    def writes(t):
        for i in range(n):
            patch_io.write_patch_file(str(tmp_path / f"{t}_{i}.patch"), empty, empty,
                                      empty[:, 0], empty[:, 0], empty[:, 0], [], [])

    threads = [threading.Thread(target=writes, args=(t,)) for t in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            profiling.COUNTERS.snapshot()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert patch_io.WRITERS == collections.Counter(python=2 * n)
    profiling.COUNTERS.reset()
