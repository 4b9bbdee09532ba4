"""The regret protocol of ``benchmarks/regret_compare.py`` through the port.

    python -m gaussian_process_optimization_tpu_torch.regret [--funcs a,b] [--seeds 10]
        [--jobs 1] [--device cpu] [--dtype float32] [--out chiprun_out/regret_torch.json]

Runs ``FUNC_SPECS`` (6 test functions, 10 seeds each: EI, latin initial design of
5, ``exact_feval``, every iteration) on the card in float32, writes every run's
regret curve to a JSON file, and prints per function the median and the
inter-quartile range of the final simple regret beside those of the JAX package's
CPU float64 runs stored in ``benchmarks/regret_raw.json`` (``cpu_f64``), with the
protocol's verdict: the two inter-quartile ranges overlap, to a tolerance of 1e-6
(regret_compare.py:130-134). ``--funcs`` runs a part of the set; the output file
is merged into, so the set can be run in pieces. At these sizes (at most 35
points) a run is a host loop of small launches, so ``--jobs`` runs that many
(function, seed) pairs side by side, each in a process of its own on the same
device; a run's result does not depend on what runs beside it.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from . import workload

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "benchmarks" / "regret_raw.json"
TOL = 1e-6


def final_stats(curves):
    """(median, q1, q3) of the final regret over the runs."""
    final = np.asarray([row[-1] for row in curves])
    q1, med, q3 = np.percentile(final, [25, 50, 75])
    return float(med), float(q1), float(q3)


def iqr_overlap(a, b, tol: float = TOL) -> bool:
    """The protocol's parity criterion on two (median, q1, q3) triples."""
    return bool(a[1] <= b[2] + tol and b[1] <= a[2] + tol)


def reference_curves(path: Path = REFERENCE) -> dict:
    """The JAX package's CPU float64 curves, by function."""
    return json.loads(path.read_text())["cpu_f64"]


def _one(task):
    """One (function, seed) run, in this or in a worker process."""
    name, seed, device, dtype = task
    r = workload.regret_run(name, seed, device=device, dtype=getattr(torch, dtype))
    return name, seed, r.regret, r.evaluations, r.fit_failed, r.seconds


def run(funcs, seeds: int, device=None, dtype=torch.float32, jobs: int = 1,
        log=print) -> dict:
    """``{function: {"curves": [...], "fit_s": ..., "acq_s": ..., "fit_failed":
    count}}`` for each function in ``funcs``; ``fit_s`` and ``acq_s`` sum the
    runs' own host-clock seconds. ``jobs`` > 1 spreads the runs over that many
    worker processes."""
    device = str(workload.resolve_device(device))
    name_of = str(dtype).rsplit(".", 1)[-1]
    tasks = [(name, seed, device, name_of) for name in funcs for seed in range(seeds)]
    out = {name: {"curves": [None] * seeds, "fit_s": 0.0, "acq_s": 0.0, "fit_failed": 0}
           for name in funcs}
    pool = None
    if jobs > 1:
        pool = multiprocessing.get_context("spawn").Pool(jobs)
    try:
        for name, seed, regret, evaluations, failed, seconds in (
                pool.imap_unordered(_one, tasks) if pool else map(_one, tasks)):
            entry = out[name]
            entry["curves"][seed] = regret
            entry["fit_failed"] += int(failed)
            entry["fit_s"] += seconds["fit"]
            entry["acq_s"] += seconds["acquisition"]
            log(f"# {name} seed {seed}: final regret {regret[-1]:.4f}, {evaluations} "
                f"evaluations, fit {seconds['fit']:.2f} s, acquisition "
                f"{seconds['acquisition']:.2f} s", flush=True)
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    return out


def report(results: dict, reference: dict, log=print) -> dict:
    """Prints the table; returns ``{function: overlap}``."""
    verdicts = {}
    log("| function | runs | port median [q1, q3] | JAX CPU f64 median [q1, q3] | "
        "IQRs overlap | fit failed | fit s | acquisition s |")
    log("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for name, r in results.items():
        ours = final_stats(r["curves"])
        if name not in reference:
            log(f"| {name} | {len(r['curves'])} | {ours[0]:.4f} [{ours[1]:.4f}, "
                f"{ours[2]:.4f}] | not stored | - | {r['fit_failed']} | {r['fit_s']:.1f} | "
                f"{r['acq_s']:.1f} |")
            continue
        theirs = final_stats(reference[name])
        verdicts[name] = iqr_overlap(ours, theirs)
        log(f"| {name} | {len(r['curves'])} | {ours[0]:.4f} [{ours[1]:.4f}, {ours[2]:.4f}] | "
            f"{theirs[0]:.4f} [{theirs[1]:.4f}, {theirs[2]:.4f}] | {verdicts[name]} | "
            f"{r['fit_failed']} | {r['fit_s']:.1f} | {r['acq_s']:.1f} |")
    return verdicts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--funcs", default=",".join(workload.FUNC_SPECS))
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--jobs", type=int, default=1, help="runs side by side, one process each")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "regret_torch.json"))
    args = ap.parse_args(argv)
    funcs = [f for f in args.funcs.split(",") if f]
    unknown = [f for f in funcs if f not in workload.FUNC_SPECS]
    if unknown:
        ap.error(f"unknown functions {unknown}; the protocol's are {list(workload.FUNC_SPECS)}")
    device = workload.resolve_device(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    t0 = time.perf_counter()
    results = run(funcs, args.seeds, device=device, dtype=getattr(torch, args.dtype),
                  jobs=args.jobs)
    wall = time.perf_counter() - t0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    merged = json.loads(out.read_text()) if out.exists() else {}
    merged.update(results)
    out.write_text(json.dumps(merged))
    print(f"# {args.dtype} on {device}, {args.seeds} seeds, {args.jobs} job(s), "
          f"{wall:.1f} s in all; curves in {out}")
    verdicts = report(results, reference_curves())
    print(f"# IQR overlap with the JAX package's CPU float64 runs: {verdicts}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
