"""The device's side of a traced window, from ``torch.profiler``'s CUDA
activity: the seconds in which an operation ran, the operations that took the
most time, and the longest gaps with nothing running, each named by the
harness's innermost span that was open on the host at the time."""
from __future__ import annotations

import contextlib

SPANS = ("round", "construct", "fit", "acquisition", "objective", "tell")


def span(name: str, on: bool):
    """A host span the trace can see, or nothing when tracing is off."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, spans=SPANS, top: int = 10) -> dict | None:
    """busy_s, window_s, device_ops and idle_gaps of a finished profile, or
    None where the trace holds no device operation. The window runs from the
    first to the last of the outermost spans named ``spans[0]``."""
    events = prof.profiler.kineto_results.events()
    device, annotations = [], []
    for e in events:
        where = e.device_type().name
        if where == "CUDA" and e.name() not in spans:
            # kernels, copies and sets; the device-side copies of the host
            # spans carry the spans' names and are left out
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif where == "CPU" and e.name() in spans:
            annotations.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    outer = [a for a in annotations if a[2] == spans[0]]
    if not device or not outer:
        return None
    w0, w1 = min(a[0] for a in outer), max(a[1] for a in outer)
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in inside])
    busy_ns = sum(e - s for s, e in busy)

    per_op: dict[str, int] = {}
    for s, e, n in inside:
        per_op[n] = per_op.get(n, 0) + (e - s)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s),
                  key=lambda g: g[0] - g[1])[:top]
    labelled = []
    for s, e in gaps:
        mid = (s + e) // 2
        open_spans = [a for a in annotations if a[0] <= mid < a[1]]
        # the innermost span open at the gap's midpoint: the latest started
        label = max(open_spans, key=lambda a: a[0])[2] if open_spans else "between spans"
        labelled.append([label, (e - s) / 1e9])
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "device_ops": [[n[:120], t / 1e9] for n, t in ops],
        "idle_gaps": labelled,
    }
