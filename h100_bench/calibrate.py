"""The readings that a cell's limits are set from: one process runs the cell
on many seeds at the package's settings, then on a few seeds with the
control (the port's own TF32 path), and prints each compared number's
largest sound reading beside the control's smallest.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 20 --out calib.json
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100_bench import harness, registry  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    import torch

    bench = registry.load_benchmark()
    cell = registry.cell(bench, a.workload)
    cfg, mix = registry.config(bench, cell["config"]), registry.traffic(cell["traffic"])
    limits = registry.limits(a.workload)
    runs = []
    for control, seeds in (("", a.seeds), ("tf32", a.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            detail = []
            t0 = time.perf_counter()
            r = harness.run_cell(a.workload, cfg, mix, seed, a.seconds, False,
                                 torch.device("cuda", 0), limits, control=control,
                                 detail=detail)
            runs.append({"seed": seed, "control": control, "result": r, "detail": detail,
                         "wall_s": time.perf_counter() - t0})
            print(json.dumps({"seed": seed, "control": control,
                              "checks": {k: v["value"] for k, v in r["checks"].items()},
                              "suggest_s": r["metrics"]["suggest_s"]["value"],
                              "rounds": r["attempted"]}), flush=True)
            Path(a.out).write_text(json.dumps(runs))
    names = runs[0]["result"]["checks"]
    for name in names:
        sound = [r["result"]["checks"][name]["value"] for r in runs if not r["control"]]
        ctrl = [r["result"]["checks"][name]["value"] for r in runs if r["control"]]
        print(f"{name}: lower {max(sound)!r} upper {min(ctrl) if ctrl else None!r}")


if __name__ == "__main__":
    main()
