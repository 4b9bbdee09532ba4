"""The port's program spans and counters (``utils/profiling.py``): recorded
only under a ``torch.profiler`` session, on the profiler's clock, nested
across threads; the idle time of a profile put down to them; and the span
tree of a whole CPU suggestion of ``BayesianOptimization``."""
import json
import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gaussian_process_optimization_tpu_torch.bo import BayesianOptimization
from gaussian_process_optimization_tpu_torch.utils import profiling
from gaussian_process_optimization_tpu_torch.utils.profiling import Span
from torch_threads import one_torch_thread  # noqa: F401

MS = 1_000_000  # ns


@pytest.fixture
def cpu_profile():
    """A started CPU profiler, stopped at the end; the record emptied first."""
    profiling.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    yield prof
    if profiling.recording():
        prof.stop()


def test_off_records_nothing_and_counters_still_count():
    profiling.reset()
    assert not profiling.recording()
    before = profiling.counters["host.syncs"]
    with profiling.span("bo.fit"):
        x = profiling.host(torch.ones(3) * 2.0)
    assert x.tolist() == [2.0, 2.0, 2.0]
    assert profiling.host(1.5) == 1.5  # a host value passes through, uncounted
    assert profiling.counters["host.syncs"] == before + 1
    assert profiling.spans() == []


def test_recording_follows_the_profilers_start_and_stop():
    profiling.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    assert not profiling.recording()
    prof.start()
    try:
        assert profiling.recording()
        with profiling.span("fit.solve"):
            profiling.host(torch.zeros(1))
    finally:
        prof.stop()
    assert not profiling.recording()
    with profiling.span("fit.solve"):
        pass
    sp = profiling.spans()
    assert [s.name for s in sp] == ["fit.solve", "host.sync"]
    assert sp[1].parent == 0 and sp[0].counts == {"host.syncs": 1}
    assert sp[0].start_ns <= sp[1].start_ns <= sp[1].end_ns <= sp[0].end_ns


def test_a_span_lies_on_the_profilers_clock(cpu_profile):
    """Each program span opened inside a ``record_function`` lies within that
    range's kineto interval, its ends within 0.5 ms of the range's (the
    median of five ranges)."""
    a = torch.randn(64, 64)
    for i in range(5):
        with record_function(f"range{i}"):
            with profiling.span("kern.K"):
                a = torch.tanh(a @ a.T / 64)
    cpu_profile.stop()
    kineto = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in cpu_profile.profiler.kineto_results.events()}
    ours = profiling.spans()
    assert len(ours) == 5
    heads, tails = [], []
    for i, s in enumerate(ours):
        r0, r1 = kineto[f"range{i}"]
        assert r0 <= s.start_ns <= s.end_ns <= r1
        heads.append(s.start_ns - r0)
        tails.append(r1 - s.end_ns)
    assert statistics.median(heads) < 0.5 * MS and statistics.median(tails) < 0.5 * MS


def test_nesting_and_a_span_on_another_thread_while_its_parent_blocks(cpu_profile):
    """Autograd runs a CUDA backward on its own thread while the caller
    blocks in ``grad``; a span opened there nests under the caller's."""
    def backward_thread():
        with profiling.span("gp.exact_bwd"):
            with profiling.span("linalg.tri_inv"):
                pass

    with profiling.span("fit.solve"):
        with profiling.span("lbfgs.eval"):
            worker = threading.Thread(target=backward_thread)
            worker.start()
            worker.join(timeout=30)
        assert not worker.is_alive()
        with profiling.span("lbfgs.step"):
            pass
    cpu_profile.stop()
    sp = profiling.spans()
    names = [s.name for s in sp]
    assert names == ["fit.solve", "lbfgs.eval", "gp.exact_bwd", "linalg.tri_inv",
                     "lbfgs.step"]
    assert [s.parent for s in sp] == [None, 0, 1, 2, 0]
    assert sp[2].thread != sp[1].thread and sp[3].thread == sp[2].thread
    assert all(s.end_ns is not None for s in sp)


def _span(name, start, end, parent=None):
    return Span(name, start * MS, end * MS, 1, parent, {})


def test_idle_by_span_puts_each_idle_gap_on_the_innermost_span():
    record = [_span("bo.fit", 0, 100), _span("fit.solve", 10, 50, 0),
              _span("lbfgs.eval", 20, 30, 1), _span("bo.batch", 150, 200)]
    device = [(5 * MS, 15 * MS), (25 * MS, 28 * MS), (60 * MS, 70 * MS),
              (160 * MS, 300 * MS), (60 * MS, 65 * MS)]
    got = profiling.idle_by_span(device, record, window=(0, 250 * MS))
    want = {"bo.fit": 45e-3, "fit.solve": 25e-3, "lbfgs.eval": 7e-3, "bo.batch": 10e-3,
            profiling.OUTSIDE: 50e-3}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    busy = 10 + 3 + 10 + 90
    assert sum(got.values()) == pytest.approx((250 - busy) * 1e-3, rel=1e-12)
    # the default window runs from the first span's start to the last one's end
    got = profiling.idle_by_span(device, record)
    assert sum(got.values()) == pytest.approx((200 - (10 + 3 + 10 + 40)) * 1e-3, rel=1e-12)
    assert profiling.OUTSIDE in got and profiling.idle_by_span(device, []) == {}


def test_trace_merges_the_spans_into_its_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), cuda=False):
        with record_function("outer"):
            with profiling.span("bo.batch"):
                a = torch.tanh(a @ a.T / 64)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    outer = next(e for e in events if e.get("name") == "outer" and e.get("ph") == "X")
    ours = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in ours] == ["bo.batch"]
    tol = 0.5e3  # us
    assert outer["ts"] - tol <= ours[0]["ts"]
    assert ours[0]["ts"] + ours[0]["dur"] <= outer["ts"] + outer["dur"] + tol
    assert ours[0]["pid"] != outer["pid"]
    idle = json.loads((tmp_path / "idle_by_span.json").read_text())
    assert idle["busy_s"] == 0.0 and idle["window_s"] > 0
    assert sum(idle["idle_s"].values()) == pytest.approx(idle["window_s"], rel=1e-9)
    assert idle["idle_s"]["bo.batch"] > 0


def test_device_intervals_are_the_kernels_copies_and_sets_of_the_trace():
    """Chosen by category: the device-side copy of a host annotation, which
    carries the annotation's name, is no device operation."""
    base = 1_790_000_000_000_000_000
    doc = {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10.5, "dur": 2.25},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 20.0, "dur": 1.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 30.0, "dur": 0.001},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "fit", "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5.0, "dur": 1.0},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}}]}
    assert profiling.device_intervals(doc) == [
        (base + 10_500, base + 12_750), (base + 20_000, base + 21_000),
        (base + 30_000, base + 30_001)]


DOMAIN = [{"name": f"x{i}", "type": "continuous", "domain": (-2.0, 2.0)} for i in range(3)]


def _bo(n=32, **kw):
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, (n, 3))
    Y = np.sin(2 * X[:, :1]) + 0.05 * rng.standard_normal((n, 1))
    return BayesianOptimization(f=None, domain=DOMAIN, X=X, Y=Y, device="cpu",
                                exact_feval=True, max_iters=30, **kw)


# (span, parent) pairs of one suggestion; host.sync spans sit under whatever
# read a value
TREE = {("bo.suggest", None), ("bo.fit", "bo.suggest"), ("space.unzip", "bo.fit"),
        ("fit.solve", "bo.fit"), ("lbfgs.step", "fit.solve"), ("lbfgs.eval", "fit.solve"),
        ("lbfgs.eval", "lbfgs.step"), ("kern.K", "lbfgs.eval"),
        ("gp.exact_fwd", "lbfgs.eval"), ("chol.ladder", "gp.exact_fwd"),
        ("gp.exact_bwd", "lbfgs.eval"), ("linalg.tri_inv", "gp.exact_bwd"),
        ("linalg.tri_tdot", "gp.exact_bwd"), ("gp.posterior", "bo.fit"),
        ("kern.K", "gp.posterior"), ("gp.exact_fwd", "gp.posterior"),
        ("linalg.tri_inv", "gp.posterior"), ("bo.batch", "bo.suggest"),
        ("kern.K", "bo.batch"), ("acq.sweep", "bo.batch"), ("space.unzip", "acq.sweep"),
        ("kern.K", "acq.sweep"), ("acq.lbfgs", "bo.batch"), ("lbfgs.eval", "acq.lbfgs"),
        ("lbfgs.step", "acq.lbfgs"), ("acq.select", "bo.batch"), ("kern.K", "acq.select")}


def test_a_whole_suggestion_gives_the_span_tree_and_its_counts():
    profiling.reset()
    _bo().suggest_next_locations()
    assert profiling.spans() == []  # no profiler, no record

    bo = _bo()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        x = bo.suggest_next_locations()
    finally:
        prof.stop()
    assert x.shape == (1, 3)
    sp = profiling.spans()
    pairs = {(s.name, None if s.parent is None else sp[s.parent].name) for s in sp}
    syncs = {p for p in pairs if p[0] == "host.sync"}
    assert pairs - syncs == TREE
    assert ("host.sync", "lbfgs.step") in syncs and ("host.sync", "chol.ladder") in syncs
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in sp)

    (solve,) = [s for s in sp if s.name == "fit.solve"]
    (fitter,) = bo.model._fitters.values()
    assert solve.counts["lbfgs.evals"] == fitter.evaluations > 0
    assert solve.counts["chol.factorizations"] >= solve.counts["lbfgs.evals"]
    assert 0 < solve.counts["lbfgs.iters"] <= 30
    (root,) = [s for s in sp if s.name == "bo.suggest"]
    assert root.counts["host.syncs"] == sum(s.name == "host.sync" for s in sp)
    (acq,) = [s for s in sp if s.name == "acq.lbfgs"]
    # the acquisition carries no graph: each lbfgs.eval span is one call
    assert acq.counts["lbfgs.evals"] == sum(
        s.name == "lbfgs.eval" and _under(sp, s, acq) for s in sp) > 0


def _under(sp, s, top):
    while s.parent is not None:
        s = sp[s.parent]
        if s is top:
            return True
    return False


def test_an_iteration_of_the_loop_is_a_root_span():
    bo = _bo(n=12)
    profiling.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        bo.run_optimization(max_iter=0)
    finally:
        prof.stop()
    sp = profiling.spans()
    roots = [s.name for s in sp if s.parent is None]
    assert roots == ["bo.iteration"]
    assert [s.name for s in sp if s.parent == 0] == ["bo.fit"]
