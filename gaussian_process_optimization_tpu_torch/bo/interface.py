"""A BO experiment from a JSON config, and its command line (twin of
``gaussian_process_optimization_tpu/bo/interface.py``; GPyOpt interface/:
config_parser.py:10 ``default_config``, driver.py:8 ``BODriver``,
func_loader.py, output.py; the CLI of gpyopt.py:1-22).

The config names the objective's file (``main-file``, defining ``f``), the space
and constraints, the model, the acquisition with its optimizer and evaluator,
the initial design, the resources and the output files (the schema of
``default_config``). It may also name the ``device`` to build on (the card when
absent).

Run it as ``python -m gaussian_process_optimization_tpu_torch.bo.interface
config.json``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

import numpy as np

from ..config import resolve_device
from .methods import BayesianOptimization


def default_config():
    """(config_parser.py:10-60)"""
    return {
        "language": "PYTHON",
        "experiment-name": "no-named-experiment",
        "likelihood": "noisy",
        "model": {"type": "GP", "num-inducing": 10, "optimization-restarts": 5,
                  "optimization-iterations": 1000},
        "space": [],
        "constraints": [],
        "acquisition": {"type": "EI", "jitter": 0.01, "weight": 2,
                        "optimizer": {"name": "lbfgs"},
                        "evaluator": {"type": "sequential", "batch-size": 1}},
        "initialization": {"type": "random", "num-eval": 5},
        "resources": {"maximum-iterations": 20, "max-run-time": "NA", "cores": 1,
                      "tolerance": 1e-8},
        "output": {"verbosity": False, "file-report": None, "file-evaluations": None,
                   "file-models": None},
    }


def update_config(config_new, config_default):
    """Recursive default filling (config_parser.py update_config)."""
    if isinstance(config_new, dict) and isinstance(config_default, dict):
        out = dict(config_default)
        for k, v in config_new.items():
            out[k] = update_config(v, config_default.get(k)) if isinstance(v, dict) else v
        return out
    return config_new


def load_objective(config, base_dir="."):
    """The objective ``f`` (or ``objective-name``) of the config's main-file
    (interface/func_loader.py)."""
    main_file = config.get("main-file")
    if main_file is None:
        raise ValueError("config has no 'main-file'")
    spec = importlib.util.spec_from_file_location("gpo_objective",
                                                  os.path.join(base_dir, main_file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, config.get("objective-name", "f"))


class BODriver:
    """Builds and runs a BO experiment from a config dict (interface/driver.py:8).
    The surrogate builds on ``device`` if given, else the config's ``device``,
    else the card; with no card and no device named it raises."""

    def __init__(self, config=None, obj_func=None, device=None):
        self.config = update_config(config or {}, default_config())
        self.obj_func = obj_func
        self.device = resolve_device(device if device is not None else self.config.get("device"))

    def run(self):
        cfg = self.config
        acq = cfg["acquisition"]
        ev = acq.get("evaluator", {})
        res = cfg["resources"]
        out = cfg["output"]
        max_time = res.get("max-run-time", "NA")
        max_time = np.inf if max_time in ("NA", None) else float(max_time) * 60.0
        bo = BayesianOptimization(
            f=self.obj_func, domain=cfg["space"], constraints=cfg["constraints"] or None,
            model_type=cfg["model"]["type"],
            initial_design_numdata=cfg["initialization"].get("num-eval", 5),
            initial_design_type=cfg["initialization"].get("type", "random"),
            acquisition_type=acq.get("type", "EI"),
            acquisition_jitter=acq.get("jitter", 0.01),
            acquisition_weight=acq.get("weight", 2),
            acquisition_optimizer_type=acq.get("optimizer", {}).get("name", "lbfgs"),
            evaluator_type=ev.get("type", "sequential"), batch_size=ev.get("batch-size", 1),
            exact_feval=(cfg.get("likelihood", "noisy").lower() == "noiseless"),
            num_cores=res.get("cores", 1) or 1, verbosity=bool(out.get("verbosity", False)),
            optimize_restarts=cfg["model"].get("optimization-restarts", 5),
            max_iters=cfg["model"].get("optimization-iterations", 1000),
            num_inducing=cfg["model"].get("num-inducing", 10), device=self.device)
        bo.run_optimization(
            max_iter=res.get("maximum-iterations", 20), max_time=max_time,
            eps=res.get("tolerance", 1e-8), verbosity=bool(out.get("verbosity", False)),
            report_file=out.get("file-report"), evaluations_file=out.get("file-evaluations"),
            models_file=out.get("file-models"))
        return bo


def main(argv=None):
    """The command line: ``python -m gaussian_process_optimization_tpu_torch.bo.interface
    <config.json>`` (the reference's ``gpyopt.py <config.json>``)."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m gaussian_process_optimization_tpu_torch.bo.interface "
              "<config.json>")
        return 1
    with open(argv[0]) as fh:
        cfg = json.load(fh)
    base_dir = os.path.dirname(os.path.abspath(argv[0]))
    f = load_objective(cfg, base_dir) if "main-file" in cfg else None
    bo = BODriver(cfg, f).run()
    print(f"Best found: f={bo.fx_opt} at x={bo.x_opt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
