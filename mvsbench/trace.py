"""Spans around the engine's calls and the device trace of one run.

``Recorder`` keeps host-clock spans of one reconstruction, each from a
device synchronize to a device synchronize, named after the engine call
it wraps (``load``, ``seed``, ``propagate[i]``, ``filter[i]``,
``write``), and the counters the engine returns (hypotheses). Traced,
it runs ``torch.profiler`` (CUDA activity only, events kept in memory,
no file written) over each span in a recording of its own, so that every
device operation carries the span it ran in and no recording holds more
than one stage's events; the profiler's start and its processing fall
between the spans, outside their clocks.

``Reading`` is what the per-layer metric readers (``metrics/<name>.py``)
read: the spans of the untraced reconstructions, averaged, and their
wall time (the profiler lengthens a traced span), and from the traced
reconstruction its counters, its device operations labelled by span,
the sampler's launches per form and batch, and the busy and idle time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

NAME_CHARS = 160


def is_kernel(name: str) -> bool:
    """A kernel, not a copy or a fill, among the trace's device operations."""
    return not name.startswith(("Memcpy", "Memset"))


def device_ops(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, duration_ns) of the device operations a finished
    profiler recording holds."""
    return [(e.name(), int(e.start_ns()), int(e.duration_ns()))
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


class Recorder:
    def __init__(self, device: torch.device, traced: bool = False):
        self.device = device
        self.traced = traced
        self.spans: List[Tuple[str, float, float]] = []
        self.counters: Dict[str, int] = collections.Counter()
        self.ops: List[Tuple[str, int, int, str]] = []
        self._recording = False

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        self.sync()
        prof = None
        if self.traced and not self._recording:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            self._recording = True
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.spans.append((name, t0, time.perf_counter()))
            if prof is not None:
                prof.__exit__(None, None, None)
                self._recording = False
                self.ops.extend((n[:NAME_CHARS], s, d, name) for n, s, d in device_ops(prof))

    def wrap(self, name: str, fn, after=None):
        """fn inside a span; `after(result)` runs outside it."""
        def inner(*args, **kwargs):
            with self.span(name):
                out = fn(*args, **kwargs)
            if after is not None:
                after(out)
            return out
        return inner


@dataclasses.dataclass
class Reading:
    """A traced reconstruction and the untraced ones of its window, as the
    metric readers see them."""

    spans: List[Tuple[str, float]]                 # (name, mean seconds over the untraced)
    recon_s: float                                 # the untraced reconstructions' mean wall time
    counters: Dict[str, int]                       # the traced reconstruction's
    wsize: int
    windows: Dict[str, Dict[int, int]]             # sampler launches per form and batch
    ops: List[Tuple[str, int, int, str]] = dataclasses.field(default_factory=list)
    traced_s: float = 0.0                          # the traced spans' summed time
    busy_s: Optional[float] = None
    idle_by_span: Dict[str, float] = dataclasses.field(default_factory=dict)

    def span_seconds(self, prefix: str) -> Optional[float]:
        hits = [s for n, s in self.spans if n == prefix or n.startswith(prefix + "[")]
        return sum(hits) if hits else None

    def labelled(self) -> bool:
        return bool(self.ops)


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def mean_spans(recs: List[Recorder]) -> List[Tuple[str, float]]:
    """Each span name's summed seconds in a reconstruction, averaged over
    the reconstructions `recs`."""
    total: Dict[str, float] = {}
    for rec in recs:
        for n, t0, t1 in rec.spans:
            total[n] = total.get(n, 0.0) + (t1 - t0)
    return [(n, t / len(recs)) for n, t in total.items()] if recs else []


def read_trace(traced: Recorder, untraced: List[Tuple[Recorder, float]], wsize: int,
               windows: Dict[str, Dict[int, int]]) -> Reading:
    """The Reading of a window: the spans and wall times of the untraced
    reconstructions `untraced` ((recorder, wall seconds) each), and per
    span of the traced one (`traced`), the device's busy time (the union
    of its operations) and its idle time (the span's length less that)."""
    spans = [(n, t1 - t0) for n, t0, t1 in traced.spans]
    walls = [w for _, w in untraced]
    reading = Reading(spans=mean_spans([r for r, _ in untraced]),
                      recon_s=sum(walls) / len(walls) if walls else 0.0,
                      counters=dict(traced.counters), wsize=wsize, windows=windows,
                      ops=list(traced.ops), traced_s=sum(d for _, d in spans))
    if not traced.ops:
        return reading
    by_span = collections.defaultdict(list)
    for _, s, d, span in traced.ops:
        by_span[span].append((s, s + d))
    dur = collections.Counter()
    for name, d in spans:
        dur[name] += d
    idle = {}
    busy = 0.0
    for name, d in dur.items():
        b = _union_ns(by_span.get(name, [])) / 1e9
        busy += b
        idle[name] = max(d - b, 0.0)
    reading.busy_s = busy
    reading.idle_by_span = idle
    return reading


def breakdown(reading: Reading, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time (summed by name) and the
    device's idle time by the span the host was in."""
    by_name = collections.Counter()
    for name, _, dur, _ in reading.ops:
        by_name[name] += dur
    ops = [[n, d / 1e9] for n, d in by_name.most_common(top)]
    gaps = sorted(reading.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": ops, "idle_gaps": [[k, v] for k, v in gaps]}
