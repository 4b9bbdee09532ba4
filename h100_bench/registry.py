"""Everything the harness runs is found by name in data files: a cell in
``BENCHMARK.json``, its configuration in the file that entry names, its
traffic mix in ``traffic/<name>.json``, each per-layer metric's reader in
``metrics/<name>.py`` and a cell's limits in ``limits/<cell>.json``. A new
cell, mix or metric is new files and entries, never an edit."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names the measured process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_process_optimization_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(Path(bench_dir) / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The numbers a cell compares, each with its limit and its readings."""
    with open(Path(bench_dir) / "limits" / f"{cell_name}.json") as f:
        return json.load(f)


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        listed = cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved
        if listed:
            out.append(m)
    return out


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The metric's reader module: ``read(ctx) -> float | None``."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
