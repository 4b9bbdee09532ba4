"""Per-phase wall-clock timers, the program's spans and counters, and profiler
traces (twin of ``gaussian_process_optimization_tpu/utils/profiling.py``).

- :class:`PhaseTimer`: named phases that accumulate wall time, each closed
  behind a barrier on the device, so that the work a phase queued on the card
  is counted in that phase and not in the next one;
- :data:`counters`: the one registry of the program's named integers, always
  on: the hand-written kernels' launches (``b1.launches`` for the covariance
  build, ``b2.launches`` for its backward, of which ``b2.launches_dx`` also
  wrote dX and ``b2.launches_dz`` were column passes, ``b3.launches`` and
  ``b4.launches`` for the triangular-inverse and Cholesky blocks), the L-BFGS
  iterations and objective calls (``lbfgs.iters``, ``lbfgs.evals``: one
  batched call over every lane each), the jitter ladder's factorizations
  (``chol.factorizations``: one batched factorization each), the reads of a
  tensor's value on the host (``host.syncs``) and the spans dropped past the
  record's cap (``trace.dropped``);
- :func:`span`: a named interval of the program (``layer.what``), recorded
  while, and only while, a ``torch.profiler`` session records, on the
  profiler's own clock (Unix-epoch nanoseconds), with its thread, its parent
  and the increments of every counter while it was open. Off, it costs one
  flag check. Spans are kept in memory (:func:`spans`), never written during
  the run, and are not ``record_function`` ranges, so the device trace holds
  no copy of them;
- :func:`host`: a tensor's value on the host, counted, and timed in a
  ``host.sync`` span while recording: where the host waits for the card;
- :func:`idle_by_span`: the device's idle time put down to the innermost
  program span open on the host;
- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (viewable in Perfetto or ``chrome://tracing``) of the block with
  the program's spans merged in as their own track, and ``idle_by_span.json``.

Usage::

    pt = PhaseTimer()
    with pt("fit"):
        fitted, _ = fitter(model)
        pt.sync(fitted.kern.variance)   # barrier inside the phase
    print(pt.report())

    with trace("prof"):                 # prof/trace.json, prof/idle_by_span.json
        bo.suggest_next_locations()
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import heapq
import json
import os
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    @staticmethod
    def sync(x=None):
        """Barrier: a tensor is waited for by reading one of its elements on
        the host (the reference's one-element read), a ``torch.device`` (or
        nothing: the current card) by ``torch.cuda.synchronize``. Host values
        pass through. Returns ``x``."""
        if isinstance(x, torch.Tensor):
            if x.numel():
                x.reshape(-1)[:1].cpu()
        elif isinstance(x, torch.device) or x is None:
            dev = torch.device("cuda") if x is None else x
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return x

    def report(self) -> str:
        lines = []
        for phase, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[phase]
            lines.append(f"{phase:>16s}: {total:8.3f} s  ({n} calls, "
                         f"{total / max(n, 1) * 1e3:8.2f} ms/call)")
        return "\n".join(lines)


counters: dict[str, int] = dict.fromkeys((
    "b1.launches", "b2.launches", "b2.launches_dx", "b2.launches_dz", "b3.launches",
    "b4.launches", "b5.launches", "lbfgs.iters", "lbfgs.evals", "chol.factorizations",
    "host.syncs", "trace.dropped"), 0)

# the most spans one record holds; a profiler left running drops the rest
SPAN_CAP = 1_000_000


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int | None  # None while open
    thread: int
    parent: int | None  # index in spans() of the span it opened under
    counts: dict[str, int]  # increments of the counters while open, nonzero ones


class _Recorder:
    """The record: spans in the order they opened, and each thread's stack
    of the indices of its open ones. ``generation`` counts the resets, so a
    span that opened before one leaves the new record alone."""

    def __init__(self):
        self.spans: list[Span] = []
        self.stacks: dict[int, list[int]] = {}
        self.generation = 0
        self.lock = threading.Lock()

    def parent(self, thread: int) -> int | None:
        """The innermost open span of ``thread``, or, where it has none, the
        latest opened of another thread's innermost: autograd runs a backward
        on the card's own thread while the caller blocks inside ``grad``, so
        a span opened there belongs under the caller's."""
        stack = self.stacks.get(thread)
        if stack:
            return stack[-1]
        tops = [s[-1] for s in self.stacks.values() if s]
        return max(tops) if tops else None


_recorder = _Recorder()


def recording() -> bool:
    """Whether spans are recorded: exactly while a ``torch.profiler`` session
    records."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "span", "index", "generation", "before")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _recorder
        thread = threading.get_ident()
        with rec.lock:
            if len(rec.spans) >= SPAN_CAP:
                counters["trace.dropped"] += 1
                self.span = None
                return self
            self.span = Span(self.name, 0, None, thread, rec.parent(thread), {})
            self.index, self.generation = len(rec.spans), rec.generation
            rec.spans.append(self.span)
            rec.stacks.setdefault(thread, []).append(self.index)
        self.before = dict(counters)
        self.span.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        s = self.span
        if s is None:
            return False
        s.end_ns = time.time_ns()
        before = self.before
        s.counts = {k: v - before[k] for k, v in counters.items() if v != before[k]}
        rec = _recorder
        with rec.lock:
            stack = rec.stacks.get(s.thread)
            if rec.generation == self.generation and stack and self.index in stack:
                stack.remove(self.index)
        return False


def span(name: str):
    """A context manager around one interval of the program, ``layer.what``.
    It records only while a profiler session records (:func:`recording`)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def spanned(name: str):
    """Decorator: each call of the function is a span named ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _On(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def host(t):
    """``t.cpu()``: the host's read of a tensor's value, which waits for the
    card. Counted in ``host.syncs``; while recording, inside a ``host.sync``
    span. Anything not a tensor passes through."""
    if not isinstance(t, torch.Tensor):
        return t
    counters["host.syncs"] += 1
    if not _autograd_profiler._is_profiler_enabled:
        return t.cpu()
    with _On("host.sync"):
        return t.cpu()


def spans() -> list[Span]:
    """The record: every span recorded since the last :func:`reset`, in the
    order they opened (a span's ``parent`` indexes this list)."""
    return list(_recorder.spans)


def reset():
    """Empty the record; the counters keep counting."""
    rec = _recorder
    with rec.lock:
        rec.spans.clear()
        rec.stacks.clear()
        rec.generation += 1


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


OUTSIDE = "outside spans"


def idle_by_span(device_intervals, spans, window=None) -> dict[str, float]:
    """Seconds of the window in which no device operation ran, by the name of
    the innermost program span open on the host at the time (the deepest;
    :data:`OUTSIDE` where none was open). The values sum to the window's idle
    time. ``device_intervals`` are ``(start_ns, end_ns)`` pairs on the spans'
    clock; ``window`` (``(start_ns, end_ns)``) defaults to the first span's
    start and the last one's end."""
    if window is None:
        if not spans:
            return {}
        window = (min(s.start_ns for s in spans),
                  max(s.end_ns or s.start_ns for s in spans))
    w0, w1 = window
    busy = _union((max(s, w0), min(e, w1)) for s, e in device_intervals if e > w0 and s < w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]

    # the timeline of the innermost open span: (from, to, name) pieces
    depth = []
    for s in spans:
        depth.append(0 if s.parent is None else depth[s.parent] + 1)
    events = []
    for i, s in enumerate(spans):
        end = w1 if s.end_ns is None else s.end_ns
        if end > w0 and s.start_ns < w1 and end > s.start_ns:
            events.append((max(s.start_ns, w0), 1, i))
            events.append((min(end, w1), 0, i))
    events.sort()
    pieces, heap, closed, at = [], [], set(), w0
    for t, opening, i in events:
        if t > at:
            while heap and heap[0][2] in closed:
                heapq.heappop(heap)
            pieces.append((at, t, spans[heap[0][2]].name if heap else OUTSIDE))
            at = t
        if opening:
            heapq.heappush(heap, (-depth[i], -spans[i].start_ns, i))
        else:
            closed.add(i)
    if at < w1:
        pieces.append((at, w1, OUTSIDE))

    out: dict[str, float] = {}
    j = 0
    for s, e in idle:
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            p0, p1, name = pieces[k]
            overlap = min(e, p1) - max(s, p0)
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap / 1e9
            k += 1
    return out


# the categories of the device's operations in an exported Chrome trace:
# kernels, copies and sets, and not the device-side copies of host
# annotations (``gpu_user_annotation``)
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(doc: dict) -> list[tuple[int, int]]:
    """``(start_ns, end_ns)`` of each device operation of a Chrome trace that
    ``torch.profiler`` exported, loaded, on the spans' clock."""
    base = doc.get("baseTimeNanoseconds", 0)
    out = []
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_KINDS:
            start = base + round(e["ts"] * 1e3)
            out.append((start, start + round(e["dur"] * 1e3)))
    return out


def _merge_spans(doc: dict, record: list[Span]):
    """Add the program spans to a loaded Chrome trace as a track of their
    own, on the file's time base."""
    base = doc.get("baseTimeNanoseconds", 0)
    events = doc["traceEvents"]
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    threads = {}
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "program spans"}})
    for i, s in enumerate(record):
        if s.end_ns is None:
            continue
        tid = threads.setdefault(s.thread, len(threads))
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": tid, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"index": i, "parent": s.parent, "counts": s.counts}})


@contextlib.contextmanager
def trace(logdir: str, cuda: bool | None = None):
    """Profile the block with ``torch.profiler`` and write to ``logdir`` its
    Chrome trace, ``trace.json``, with the program's spans merged in, and
    ``idle_by_span.json``: the window's seconds, the device's busy seconds,
    and its idle seconds by the innermost program span open on the host.
    ``cuda`` (default: whether a card is present) adds the card's activity.
    The record is emptied first. The profiler is yielded, so a caller can
    read its ``key_averages()`` or ``events()``."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        yield prof
        if cuda:
            torch.cuda.synchronize()
        t1 = time.time_ns()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    record = spans()
    device = device_intervals(doc)
    busy = sum(e - s for s, e in _union(
        (max(s, t0), min(e, t1)) for s, e in device if e > t0 and s < t1))
    with open(os.path.join(logdir, "idle_by_span.json"), "w") as f:
        json.dump({"window_s": (t1 - t0) / 1e9, "busy_s": busy / 1e9,
                   "idle_s": idle_by_span(device, record, (t0, t1))}, f, indent=1)
    _merge_spans(doc, record)
    with open(path, "w") as f:
        json.dump(doc, f)
