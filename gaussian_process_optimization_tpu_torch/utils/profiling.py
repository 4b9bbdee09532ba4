"""Per-phase wall-clock timers and profiler traces (twin of
``gaussian_process_optimization_tpu/utils/profiling.py``).

- :class:`PhaseTimer`: named phases that accumulate wall time, each closed
  behind a barrier on the device, so that the work a phase queued on the card
  is counted in that phase and not in the next one;
- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (viewable in Perfetto or ``chrome://tracing``) of the block.

Usage::

    pt = PhaseTimer()
    with pt("fit"):
        fitted, _ = fitter(model)
        pt.sync(fitted.kern.variance)   # barrier inside the phase
    print(pt.report())
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


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


@contextlib.contextmanager
def trace(logdir: str, cuda: bool | None = None):
    """Profile the block with ``torch.profiler`` and write its Chrome trace to
    ``logdir/trace.json``. ``cuda`` (default: whether a card is present) adds
    the card's activity. The profiler is yielded, so a caller can read its
    ``key_averages()`` or ``events()``."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
