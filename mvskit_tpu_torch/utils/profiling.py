"""Phase timers, counters and trace capture (port of
``mvskit_tpu/utils/profiling.py``).

The reference's observability is wall-clock prints and pass/fail
counters (reference propagate.cpp:55-63, filter.cpp:90-96,
pmmvps.cpp:112-113). Here: a phase timer that waits for the device
before it stops the clock, structured counters, a ``torch.profiler``
trace written as a Chrome trace, and ``polish_stats()``, which records
what the refinement's gradient polish did while it is open.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch


def _wait_for(out) -> None:
    """Block until the device work that produced tensor `out` is done."""
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


class PhaseTimer:
    """Accumulating per-phase wall-clock timer."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._log: List[tuple] = []

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[torch.Tensor] = None):
        """Time a phase. `sync` (or ``box["sync"]`` set inside the
        block) is a tensor whose CUDA device the timer synchronizes
        before it stops the clock, so the phase includes the device work
        it enqueued. A failed synchronize raises."""
        t0 = time.time()
        box = {}
        try:
            yield box
        finally:
            _wait_for(box.get("sync", sync))
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self._log.append((name, dt))

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{name:30s} {total:8.2f}s x{self.counts[name]}"
            for name, total in rows
        )

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


class Counters:
    """Structured accept/reject counters (the propagation stats of
    reference propagate.cpp:56-63 as data instead of prose)."""

    def __init__(self):
        self.values: Dict[str, int] = {}

    def add(self, **kw):
        for k, v in kw.items():
            self.values[k] = self.values.get(k, 0) + int(v)

    def as_json(self) -> str:
        return json.dumps(self.values, sort_keys=True)

    def rates(self, total_key: str = "total") -> Dict[str, float]:
        total = max(self.values.get(total_key, 0), 1)
        return {
            k: 100.0 * v / total
            for k, v in self.values.items()
            if k != total_key
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    present), written to ``<log_dir>/trace.json`` as a Chrome trace;
    no-op when log_dir is None. Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PolishStats:
    """What the refinement's gradient polish did (pipeline/refine.py),
    summed over the refine_batch calls made while it records: per step
    k, the rows tried (``rows[k]``) and the rows that took the step (a
    0-d tensor per device, summed there, so recording adds no host
    sync); and per call on a card, CUDA events at its start, the
    polish's start and end, and its end."""

    def __init__(self):
        self.rows: Dict[int, int] = {}
        self._accepted: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        self._calls: List[tuple] = []

    def mark(self, dev: torch.device):
        """A CUDA event recorded on `dev`'s current stream (None off a
        card)."""
        if dev.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(dev))
        return e

    def step(self, k: int, improved: torch.Tensor) -> None:
        """Step k tried every row of `improved` [B] and moved the true ones."""
        self.rows[k] = self.rows.get(k, 0) + improved.shape[0]
        key = (k, improved.device)
        n = improved.sum()
        self._accepted[key] = n if key not in self._accepted else self._accepted[key] + n

    def call(self, *marks) -> None:
        """One refine_batch call's four marks (kept on a card only)."""
        if marks[0] is not None:
            self._calls.append(marks)

    def as_dict(self) -> Dict[str, object]:
        """Rows tried and accepted per step; on a card the calls, their
        device time (ms), the polish's and its share."""
        steps = sorted(self.rows)
        refine_ms = sum(a.elapsed_time(d) for a, _, _, d in self._calls)
        polish_ms = sum(b.elapsed_time(c) for _, b, c, _ in self._calls)
        return {"rows": [self.rows[k] for k in steps],
                "accepted": [sum(int(v) for (j, _), v in self._accepted.items() if j == k)
                             for k in steps],
                "refine_calls": len(self._calls), "refine_ms": refine_ms,
                "polish_ms": polish_ms, "polish_share": polish_ms / max(refine_ms, 1e-9)}


# the recorder the polish writes to: None (nothing recorded) unless a
# polish_stats() block is open
POLISH: Optional[PolishStats] = None


@contextlib.contextmanager
def polish_stats():
    """Record the gradient polish over the block; yields the PolishStats."""
    global POLISH
    prev, POLISH = POLISH, PolishStats()
    try:
        yield POLISH
    finally:
        POLISH = prev
