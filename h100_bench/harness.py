"""One run of one cell: BO suggestion rounds of the PyTorch port on one card.

A round is what a user of the reference's ask-tell loop runs: one
``BayesianOptimization(f=None, X=, Y=, ...)`` on the data so far and its
``suggest_next_locations()`` (a refit of the GP, then the acquisition's batch),
then the configuration's function at the suggested rows, with noise from the
seed, told back by appending them to X and Y. Set-up makes the data from the
seed and runs one whole round, which builds every kernel and warms every shape
the window uses; the window then runs whole rounds until ``--seconds`` have
passed, finishing the round in flight. A traced run then profiles a few more
rounds. Once they have closed, the program's last
state is read, freed, and the float64 reference judges every round
(``check.py``).
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
import types

import numpy as np
import torch

from . import check, generator, probe, registry, roofline, tracing


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the lower-precision control: the program's own TF32 path switched on
    p.add_argument("--control", choices=("", "tf32"), default="")
    return p.parse_args(argv)


def import_port():
    """The system under test, imported only here."""
    import importlib

    from gaussian_process_optimization_tpu_torch.bo import BayesianOptimization
    from gaussian_process_optimization_tpu_torch.models.fit import Fitter
    from gaussian_process_optimization_tpu_torch.models.gp import AssembleKy
    from gaussian_process_optimization_tpu_torch.ops import linalg

    return types.SimpleNamespace(BayesianOptimization=BayesianOptimization, Fitter=Fitter,
                                 AssembleKy=AssembleKy, linalg=linalg,
                                 config=importlib.import_module(
                                     "gaussian_process_optimization_tpu_torch.config").config)


def set_precision(port, cfg: dict, control: str):
    """The configuration's precision and the port's settings as it states them;
    the control switches on the port's TF32 path (GPO_TPU_MATMUL_PRECISION=high)."""
    for key, value in cfg["port_config"].items():
        setattr(port.config, key, value)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("high" if control == "tf32" else cfg["matmul_precision"])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def one_round(port, cfg, mix, X, Y, device, noise_rng, trace):
    """Ask, evaluate, tell. Returns (the round's optimizer, X, Y, record)."""
    rec = {"n": len(X), "argmax": []}
    t0 = time.perf_counter()
    with tracing.span("round", trace):
        with tracing.span("construct", trace):
            bo = port.BayesianOptimization(
                f=None, domain=cfg["domain"], X=X, Y=Y, device=device,
                dtype=getattr(torch, cfg["dtype"]), **cfg["bo"], **mix["bo"])
        restore = _instrument(bo, rec, cfg, trace)
        try:
            x = bo.suggest_next_locations()
        finally:
            restore()
        with tracing.span("objective", trace):
            y = generator.objective(cfg, x) + cfg["noise_std"] * noise_rng.standard_normal(
                (len(x), 1))
        with tracing.span("tell", trace):
            X, Y = np.vstack([X, x]), np.vstack([Y, y])
    rec["seconds"] = time.perf_counter() - t0
    rec["fit_seconds"] = bo.fit_seconds
    rec["suggested"] = np.asarray(x, dtype=float)
    return bo, X, Y, rec


def _instrument(bo, rec, cfg, trace):
    """Spans around the calls into each layer, and copies of the answers each
    call returns, kept on the host for the check. Returns the function that
    takes the wrappers off again: each refers to the object it sits on, and
    left there, that cycle would keep every round's model and its device
    memory alive until the garbage collector's next full pass, where the
    program frees them as soon as the round lets go."""
    model, opt, evaluator = bo.model, bo.acquisition_optimizer, bo.evaluator
    update, optimize, compute = model.updateModel, opt.optimize, evaluator.compute_batch

    def update_model(*a, **k):
        with tracing.span("fit", trace):
            out = update(*a, **k)
        post = model.posterior
        rec["lml"] = float(post.lml)
        rec["rung"] = int(post.rung)
        rec["ok"] = bool(post.ok)
        rec["params"], rec["noise"] = probe.parameters(bo, cfg["parameters"])
        return out

    def optimize_acq(*a, **k):
        x, f = optimize(*a, **k)
        rec["argmax"].append((np.array(x, dtype=float), float(np.asarray(f).reshape(-1)[0])))
        return x, f

    def compute_batch(*a, **k):
        with tracing.span("acquisition", trace):
            return compute(*a, **k)

    wrapped = ((model, "updateModel", update_model), (opt, "optimize", optimize_acq),
               (evaluator, "compute_batch", compute_batch))
    own = [(obj, name, vars(obj).get(name)) for obj, name, _ in wrapped]
    for obj, name, fn in wrapped:
        setattr(obj, name, fn)

    def restore():
        for obj, name, before in own:
            if before is None:
                delattr(obj, name)
            else:
                setattr(obj, name, before)

    return restore


class Context:
    """What a per-layer reader gets: the window's rounds that ran without the
    profiler, the trace summary of those that ran under it, the configuration,
    the port, and helpers that time calls on the card."""

    def __init__(self, rounds, trace, cfg, port, bo, device):
        self.rounds = [r for r in rounds if not r["profiled"]]
        self.trace, self.cfg, self.port = trace, cfg, port
        self.roofline, self.device, self._bo, self._lanes = roofline, device, bo, None
        self.notes = {}

    def lanes(self):
        if self._lanes is None:
            self._lanes = probe.lanes(self.port, self._bo, self.cfg)
        return self._lanes

    def note(self, key, value):
        self.notes[key] = value

    def time_ms(self, fn, calls: int, warmup: int = 2) -> float:
        """Milliseconds a call, between CUDA events over ``calls`` calls."""
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(self.device)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / calls


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell_name, cfg, mix, seed, seconds, trace, device, limits, readers=(),
             t_start=None, control="", detail=None):
    """One run; returns the result's fields. ``limits`` names the numbers
    compared and holds their limits; ``readers`` are (metric entry, reader
    module) pairs, read in a traced run; ``detail``, a list, receives each
    round's times and compared values."""
    t_start = time.perf_counter() if t_start is None else t_start
    port = import_port()
    set_precision(port, cfg, control)
    X, Y = generator.initial_data(cfg, seed)
    noise_rng = generator.told_noise(seed)

    bo, X, Y, _ = one_round(port, cfg, mix, X, Y, device, noise_rng, trace=False)
    _sync(device)
    del bo
    setup_s = time.perf_counter() - t_start

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    # A traced run profiles ``trace_rounds`` more rounds once the window's
    # time is up: the profiler, once started, slows the host's launches for
    # the rest of the process, so the rounds before it keep their times.
    rounds, bo, prof, traced = [], None, None, 0
    t0 = time.perf_counter()
    while traced < (mix["trace_rounds"] if trace else 1):
        bo = None  # the last round's state goes before the next is built
        bo, X, Y, rec = one_round(port, cfg, mix, X, Y, device, noise_rng, prof is not None)
        rec["profiled"] = prof is not None
        rounds.append(rec)
        if prof is not None:
            traced += 1
        elif time.perf_counter() - t0 >= seconds:
            if not trace:
                break
            prof = tracing.profiler()
            prof.start()
    if prof is not None:
        prof.stop()
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    summary = tracing.summarize(prof) if prof is not None else None
    del prof
    metrics, bounds = {}, None
    if trace:
        ctx = Context(rounds, summary, cfg, port, bo, device)
        for entry, module in readers:
            v = module.read(ctx)
            if v is not None:
                metrics[entry["name"]] = {"value": float(v), "unit": entry["unit"]}
        bounds = ctx.notes
        del ctx
    else:
        metrics = {
            "suggest_s": {"value": window_s / len(rounds), "unit": "s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }

    # the program's last state, read before it is freed
    with torch.no_grad():
        _, std = bo.model.predict(rounds[-1]["suggested"])
    fitter, gp, U = probe.lanes(port, bo, cfg)
    _, grad = probe.value_and_grad(fitter, gp, U)
    last = {"grad": grad.double().cpu().numpy(),
            "names": probe.packed_names(rounds[-1]["params"], U),
            "std": np.asarray(std, dtype=float).reshape(-1)}
    del fitter, gp, U, grad, bo
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    rows = None if detail is None else []
    values = check.numbers(cfg, rounds, X, Y, last, device, tuple(limits), rows)
    if detail is not None:
        for rec, row in zip(rounds, rows):
            row.update(seconds=rec["seconds"], fit_seconds=rec["fit_seconds"])
        detail.extend(rows)
    correct, table = check.judge(values, limits)
    failed = sum(1 for r in rounds if not r.get("ok", False))
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": bool(correct and failed == 0), "attempted": len(rounds),
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    if bounds:
        # what bounds each roofline share: "flops" or "bytes"
        result["roofline_bounds"] = bounds
    result["checks"] = table
    return result


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    found = registry.forbidden_modules()
    if found:
        print(f"forbidden modules loaded before the run: {found}", file=sys.stderr)
        return 3
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cfg = registry.config(bench, cell["config"])
    mix = registry.traffic(cell["traffic"])
    readers = [(m, registry.reader(m["name"])) for m in registry.per_layer(bench, args.workload)]
    result = run_cell(args.workload, cfg, mix, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), registry.limits(args.workload),
                      readers=readers, t_start=t_start,
                      control=args.control)
    found = registry.forbidden_modules()
    if found:
        print(f"forbidden modules loaded by the run: {found}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
