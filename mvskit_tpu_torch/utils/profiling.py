"""Phase timers, counters and trace capture (port of
``mvskit_tpu/utils/profiling.py``).

The reference's observability is wall-clock prints and pass/fail
counters (reference propagate.cpp:55-63, filter.cpp:90-96,
pmmvps.cpp:112-113). Here: a phase timer that waits for the device
before it stops the clock, structured counters, a ``torch.profiler``
trace written as a Chrome trace, ``polish_stats()``, which records
what the refinement's gradient polish did while it is open, and
``tracing()``, which records the program's spans and host syncs while
it is open (``span``, ``sync``, ``note``, ``carry``; a ``Trace``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

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


class CounterRegistry:
    """The program's counters by name, each a ``collections.Counter`` that
    the registering module owns and bumps (a thread other than the main
    one under ``lock``). ``since`` gives every counter's increments after
    a ``snapshot`` (every thread's), and ``credit`` adds such increments
    back, as a replayed CUDA graph repeats what its capture counted."""

    def __init__(self):
        self.counters: Dict[str, collections.Counter] = {}
        self._zeros: Dict[str, dict] = {}
        self.lock = threading.Lock()

    def counter(self, name: str, keys: Iterable = ()) -> collections.Counter:
        """A Counter registered as `name`; its `keys` stay at 0 through a reset."""
        self._zeros[name] = dict.fromkeys(keys, 0)
        c = self.counters[name] = collections.Counter(self._zeros[name])
        return c

    def reset(self) -> None:
        with self.lock:
            for name, c in self.counters.items():
                c.clear()
                c.update(self._zeros[name])

    def snapshot(self) -> Dict[str, collections.Counter]:
        return self.since({})

    def since(self, snap: Dict[str, collections.Counter]) -> Dict[str, collections.Counter]:
        with self.lock:
            return {name: c - snap.get(name, collections.Counter())
                    for name, c in self.counters.items()}

    def credit(self, increments: Dict[str, collections.Counter]) -> None:
        with self.lock:
            for name, inc in increments.items():
                self.counters[name].update(inc)


COUNTERS = CounterRegistry()


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


# ----------------------------------------------------------------------
# spans and host syncs
# ----------------------------------------------------------------------

class Span:
    """One closed span: its id, name, kind (``span``, or ``sync`` around a
    call that blocks the host on the device), the id of the span it ran
    inside (None at the top; for a job handed to another thread, the
    span that handed it over), the thread's name, its start and end in
    nanoseconds on the Unix clock that ``torch.profiler``'s kineto events
    stamp (``start_ns()``), and attributes: host integers that were at
    hand already, or strings that name a path the code took."""

    __slots__ = ("id", "name", "kind", "parent", "thread", "start_ns", "end_ns", "attrs")

    def __init__(self, id, name, kind, parent, thread, attrs):
        self.id, self.name, self.kind, self.parent = id, name, kind, parent
        self.thread, self.attrs = thread, attrs
        self.start_ns = self.end_ns = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Open:
    """A span while it is open: pushed on its thread's stack at enter,
    stamped and recorded at exit. Neither end touches the device."""

    __slots__ = ("trace", "span")

    def __init__(self, trace: "Trace", span: Span):
        self.trace, self.span = trace, span

    def __enter__(self) -> Span:
        stack = self.trace._stack()
        if self.span.parent is None and stack:
            self.span.parent = stack[-1].id
        stack.append(self.span)
        self.span.start_ns = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc) -> None:
        s = self.span
        end = time.perf_counter_ns()
        off = self.trace.offset_ns
        s.start_ns, s.end_ns = s.start_ns + off, end + off
        self.trace._stack().pop()
        self.trace.spans.append(s)


def _union(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Trace:
    """The spans of one ``tracing()`` block, from every thread.

    At open it reads ``perf_counter_ns`` and ``time_ns`` together; every span
    stamps ``perf_counter_ns`` and is stored on the Unix clock through
    that pair, the clock of ``torch.profiler``'s events, so the device
    operations of a recording fall into the spans the host had open."""

    def __init__(self):
        # the pair read closest together of a few (a preempted read would
        # shift every span)
        reads = []
        for _ in range(5):
            a, unix, b = time.perf_counter_ns(), time.time_ns(), time.perf_counter_ns()
            reads.append((b - a, unix - (a + b) // 2))
        self.offset_ns = min(reads)[1]
        self.spans: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, kind: str = "span", parent: Optional[int] = None,
             **attrs) -> _Open:
        """A span named `name` inside this thread's innermost open span
        (or inside span id `parent`)."""
        return _Open(self, Span(next(self._ids), name, kind, parent,
                                threading.current_thread().name, attrs))

    def current(self) -> Optional[Span]:
        """This thread's innermost open span."""
        stack = self._stack()
        return stack[-1] if stack else None

    def paths(self) -> Dict[int, str]:
        """Each span's path: the names from the top down, joined by '/'."""
        by_id = {s.id: s for s in self.spans}
        out: Dict[int, str] = {}

        def path(s: Span) -> str:
            if s.id not in out:
                up = by_id.get(s.parent)
                out[s.id] = s.name if up is None else path(up) + "/" + s.name
            return out[s.id]

        for s in self.spans:
            path(s)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span path: ``count``, ``total_s``, ``self_s`` (the total less
        the time its children cover inside it, on any thread), ``syncs``
        and ``sync_wait_s`` (the sync spans at or under the path), and
        where its spans have attributes, their sums (``attrs``; of a
        string attribute, the count of each value)."""
        paths = self.paths()
        by_id = {s.id: s for s in self.spans}
        kids: Dict[int, List[Span]] = collections.defaultdict(list)
        for s in self.spans:
            if s.parent in by_id:
                kids[s.parent].append(s)
        out: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            row = out.setdefault(paths[s.id], {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                              "syncs": 0, "sync_wait_s": 0.0})
            cover = _union((max(k.start_ns, s.start_ns), min(k.end_ns, s.end_ns))
                           for k in kids[s.id] if k.end_ns > s.start_ns
                           and k.start_ns < s.end_ns)
            row["count"] += 1
            row["total_s"] += s.seconds
            row["self_s"] += max(s.end_ns - s.start_ns - cover, 0) / 1e9
            for k, v in s.attrs.items():
                sums = row.setdefault("attrs", {})
                if isinstance(v, str):
                    counts = sums.setdefault(k, {})
                    counts[v] = counts.get(v, 0) + 1
                else:
                    sums[k] = sums.get(k, 0) + v
        for s in self.spans:
            if s.kind != "sync":
                continue
            up: Optional[Span] = s
            while up is not None:
                row = out[paths[up.id]]
                row["syncs"] += 1
                row["sync_wait_s"] += s.seconds
                up = by_id.get(up.parent)
        return dict(sorted(out.items()))

    def idle_by_span(self, busy: Iterable[Tuple[int, int]], thread: Optional[str] = None,
                     window: Optional[Tuple[int, int]] = None) -> Dict[str, float]:
        """Seconds in which the device ran nothing, split among the
        innermost spans open on `thread` (default: the thread that opened
        the first span) at the time, by path. `busy` holds the device's
        operations as [start_ns, end_ns) on the Unix clock (kineto's
        ``start_ns()`` and ``start_ns() + duration_ns()``). The idle time
        counted lies in `window` ([start_ns, end_ns) on that clock;
        default: from the first span's start to the last one's end); idle
        time outside every span goes to ``""``. The values sum to the
        window's length less the device's busy time inside it."""
        spans = sorted((s for s in self.spans
                        if thread is None or s.thread == thread), key=lambda s: s.start_ns)
        if thread is None and spans:
            first = spans[0].thread
            spans = [s for s in spans if s.thread == first]
        if not spans and window is None:
            return {}
        paths = self.paths()
        if window is not None:
            lo, hi = window
        else:
            lo, hi = spans[0].start_ns, max(s.end_ns for s in spans)
        # the idle intervals: [lo, hi) less the union of the device's work
        idle, at = [], lo
        merged: List[List[int]] = []
        for s, e in sorted(busy):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        for s, e in merged:
            if e <= at:
                continue
            if s > at:
                idle.append((at, min(s, hi)))
            at = max(at, e)
            if at >= hi:
                break
        if at < hi:
            idle.append((at, hi))
        # sweep the span boundaries: between two of them the innermost
        # open span is fixed
        events = sorted([(s.start_ns, 1, -(s.end_ns - s.start_ns), s) for s in spans]
                        + [(s.end_ns, 0, 0, s) for s in spans], key=lambda e: e[:3])
        out: Dict[str, float] = collections.Counter()
        stack: List[Span] = []
        t_prev, i = lo, 0
        for t, opening, _, s in events + [(hi, 0, 0, None)]:
            if t > t_prev:
                owner = paths[stack[-1].id] if stack else ""
                while i < len(idle) and idle[i][1] <= t_prev:
                    i += 1
                j = i
                while j < len(idle) and idle[j][0] < t:
                    a, b = max(idle[j][0], t_prev), min(idle[j][1], t)
                    if b > a:
                        out[owner] += (b - a) / 1e9
                    j += 1
                t_prev = t
            if s is None:
                break
            if opening:
                stack.append(s)
            elif s in stack:
                stack.remove(s)
        return dict(out)


# the recorder the program's spans write to: None (nothing recorded)
# unless a tracing() block is open
TRACE: Optional[Trace] = None
_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A span of the program around the block, inside the thread's
    innermost open span; `attrs` are host integers that are already at
    hand (a span never reads the device). Off (``TRACE is None``) it is
    one shared null context, and neither end synchronizes on or off."""
    t = TRACE
    if t is None:
        return _OFF
    return t.open(name, **attrs)


def sync(site: str):
    """A span of kind ``sync`` around one call that blocks the host on the
    device (``.tolist()``, ``int(t.sum())``, ``torch.nonzero``,
    boolean-mask indexing, ``.cpu()``, a copy from the host): it counts
    the sync at `site` and times the host's wait there."""
    t = TRACE
    if t is None:
        return _OFF
    return t.open(site, kind="sync")


def note(**attrs) -> None:
    """Attributes (host integers, or strings naming a path taken) of this
    thread's innermost open span."""
    t = TRACE
    if t is not None:
        s = t.current()
        if s is not None:
            s.attrs.update(attrs)


def carry(fn, name: str):
    """`fn` for another thread, run there inside a span `name` whose
    parent is the span open here now; `fn` itself where tracing is off."""
    t = TRACE
    if t is None:
        return fn
    s = t.current()
    parent = s.id if s is not None else None

    def job(*args, **kwargs):
        with t.open(name, parent=parent):
            return fn(*args, **kwargs)
    return job


def sync_count(trace: Trace, site: str) -> int:
    """The sync spans at `site` that `trace` holds."""
    return sum(1 for s in trace.spans if s.kind == "sync" and s.name == site)


@contextlib.contextmanager
def tracing():
    """Record the program's spans over the block; yields the Trace."""
    global TRACE
    prev, TRACE = TRACE, Trace()
    try:
        yield TRACE
    finally:
        TRACE = prev
