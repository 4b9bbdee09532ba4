"""The readers of the program's own spans and counters: over the spans of a
CPU round at N = 32 recorded under the profiler, each returns a finite
number, and over a program that keeps no span record, nothing."""
import math
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100_bench import generator, harness, program_spans, registry

READERS = ("lml_evals_per_fit", "chol_per_lml", "acq_evals_per_round",
           "host_syncs_per_round", "fit_host_s", "acq_host_s")


@pytest.fixture(scope="module")
def profiled_round():
    """The record of one profiled round of the cell's configuration cut to
    N = 32 in float64 on the CPU, and the round's fitter."""
    from gaussian_process_optimization_tpu_torch.utils import profiling

    bench = registry.load_benchmark()
    cfg = registry.config(bench, "matern52_ard_n4096")
    cfg.update(rows=32, dtype="float64")
    cfg["domain"] = cfg["domain"][:3]
    port = harness.import_port()
    harness.set_precision(port, cfg, "")
    X, Y = generator.initial_data(cfg, 2 ** 31 + 7)
    profiling.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        bo, *_ = harness.one_round(port, cfg, registry.traffic("seq"), X, Y,
                                   torch.device("cpu"), generator.told_noise(7), True)
    finally:
        prof.stop()
    (fitter,) = bo.model._fitters.values()
    return profiling.spans(), fitter


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_a_finite_number_from_a_profiled_round(profiled_round, name):
    assert name in {m["name"] for m in registry.per_layer(registry.load_benchmark(),
                                                          "matern52_n4096.seq")}
    value = registry.reader(name).read(types.SimpleNamespace())
    assert value is not None and math.isfinite(value) and value > 0


def test_the_fits_evaluations_are_the_fitters_own_count(profiled_round):
    record, fitter = profiled_round
    assert program_spans.rounds(record) == 1
    value = registry.reader("lml_evals_per_fit").read(types.SimpleNamespace())
    assert value == fitter.evaluations


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_record_reads_nothing(monkeypatch, name):
    from gaussian_process_optimization_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert registry.reader(name).read(types.SimpleNamespace()) is None
