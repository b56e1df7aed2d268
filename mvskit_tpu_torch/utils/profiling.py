"""Phase timers, counters and trace capture (port of
``mvskit_tpu/utils/profiling.py``).

The reference's observability is wall-clock prints and pass/fail
counters (reference propagate.cpp:55-63, filter.cpp:90-96,
pmmvps.cpp:112-113). Here: a phase timer that waits for the device
before it stops the clock, structured counters, and a
``torch.profiler`` trace written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

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
