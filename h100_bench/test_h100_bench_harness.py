"""The harness: found by data, free of JAX and of the package it ports from,
and refusing to run without a card."""
import ast
import gc
import json
import subprocess
import sys
import weakref
from pathlib import Path

import pytest
import torch

from h100_bench import generator, harness, registry

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN_IMPORTS = set(registry.FORBIDDEN) | {"bench", "benchmarks", "workload",
                                               "chip_smoke"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module a file imports (relative imports of
    the benchmark's own modules left out)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_reference_package(path):
    found = _imports(path) & FORBIDDEN_IMPORTS
    assert not found, f"{path.name} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "gaussian_process_optimization_tpu_torch" not in _imports(path)
    assert "h100_bench" not in _imports(path)


def test_guard_compares_top_level_names_whole():
    loaded = ["numpy", "gaussian_process_optimization_tpu_torch.bo", "jaxtyping",
              "h100_bench.harness"]
    assert registry.forbidden_modules(loaded) == []
    assert registry.forbidden_modules(loaded + ["jax.numpy"]) == ["jax"]
    assert registry.forbidden_modules(loaded + ["gaussian_process_optimization_tpu.bo"]) == [
        "gaussian_process_optimization_tpu"]


def test_a_run_loads_neither_jax_nor_the_reference_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from h100_bench import harness, registry, check, calibrate\n"
            "port = harness.import_port()\n"
            "import gaussian_process_optimization_tpu_torch.bo.evaluators\n"
            "print(registry.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                        "matern52_n4096.seq", "--seed", str(2 ** 31 + 3), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0
    assert "correct" not in p.stdout


def test_benchmark_names_its_cells_configs_and_metrics():
    bench = registry.load_benchmark()
    assert [w["name"] for w in bench["workloads"]] == ["matern52_n4096.seq"]
    assert all(w["chips"] == 1 for w in bench["workloads"])
    assert {m["name"] for m in bench["end_to_end"]} == {"suggest_s", "setup_s"}
    for w in bench["workloads"]:
        cfg = registry.config(bench, w["config"])
        assert registry.traffic(w["traffic"])["bo"]
        assert registry.limits(w["name"])
        for m in registry.per_layer(bench, w["name"]):
            assert m["moves"] == "suggest_s"
            assert callable(registry.reader(m["name"]).read)
        assert cfg["rows"] + 40 < 4096  # the rows told back stay in the 4096 bucket
    assert {m["name"] for m in registry.per_layer(bench, "matern52_n4096.seq")} == {
        "fit_s", "acq_s", "lml_grad_ms", "chol_roofline_pct", "kbuild_roofline_pct",
        "device_idle_pct"}


# a host-clock reader: it sees only the rounds that ran without the profiler
NEW_METRIC = '''
UNIT = "1"


def read(ctx):
    return float(len(ctx.rounds))
'''


def test_a_new_cell_mix_and_metric_are_files_and_entries_only(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell's limits
    added as new files in a copy of the benchmark's layout run without an edit
    to any file."""
    bench = registry.load_benchmark()
    cfg = registry.config(bench, "matern52_ard_n4096")
    cfg.update(name="matern52_tiny", rows=24, dtype="float64")
    cfg["domain"] = cfg["domain"][:2]
    cfg["bo"]["max_iters"] = 3
    for sub in ("configs", "traffic", "metrics", "limits"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "matern52_tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "pair.json").write_text(json.dumps(
        {"bo": {"evaluator_type": "random", "batch_size": 2}, "trace_rounds": 1}))
    (tmp_path / "metrics" / "rounds_seen.py").write_text(NEW_METRIC)
    (tmp_path / "limits" / "matern52_tiny.pair.json").write_text(json.dumps(
        {"out_of_domain": {"limit": 0}}))
    bench["configs"].append({"name": "matern52_tiny", "source": "https://example.org",
                             "file": "configs/matern52_tiny.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "matern52_tiny.pair", "config": "matern52_tiny",
                               "traffic": "pair", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "rounds_seen", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "BO loop",
                               "moves": "suggest_s", "workloads": ["matern52_tiny.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = registry.load_benchmark(tmp_path)
    w = registry.cell(bench, "matern52_tiny.pair")
    readers = [(m, registry.reader(m["name"], tmp_path))
               for m in registry.per_layer(bench, w["name"])]
    assert [m["name"] for m, _ in readers] == ["rounds_seen"]
    r = harness.run_cell(w["name"], registry.config(bench, w["config"], tmp_path),
                         registry.traffic(w["traffic"], tmp_path), 2 ** 31 + 11, 0.5, True,
                         torch.device("cpu"), registry.limits(w["name"], tmp_path),
                         readers=readers)
    # the window's first round ran under the profiler and is left out
    assert r["metrics"]["rounds_seen"]["value"] == r["attempted"] - 1 >= 1
    assert r["checks"] == {"out_of_domain": {"value": 0, "limit": 0}}
    assert r["correct"]


def _tiny_config():
    bench = registry.load_benchmark()
    cfg = registry.config(bench, "matern52_ard_n4096")
    cfg.update(name="matern52_tiny", rows=24, dtype="float64")
    cfg["domain"] = cfg["domain"][:2]
    cfg["bo"]["max_iters"] = 3
    return cfg


def test_a_round_frees_its_model_when_it_is_let_go():
    """The harness's wrappers come off after the round, so nothing of the
    harness keeps a round's model (and on the card its device memory) alive
    into the next: the program's refcounts free it, with no collector pass."""
    cfg = _tiny_config()
    port = harness.import_port()
    harness.set_precision(port, cfg, "")
    X, Y = generator.initial_data(cfg, 2 ** 31 + 5)
    gc.disable()
    try:
        bo, X, Y, rec = harness.one_round(port, cfg, registry.traffic("seq"), X, Y,
                                          torch.device("cpu"), generator.told_noise(5), False)
        assert "updateModel" not in vars(bo.model) and rec["argmax"]
        model = weakref.ref(bo.model)
        del bo
        assert model() is None
    finally:
        gc.enable()
