"""The comparison that decides ``correct``: what the timed rounds produced,
held against the plain float64 reference (``reference/gp.py``) at the same
data, the same fitted hyperparameters and the same suggested rows.

The numbers a cell compares are the keys of its ``limits/<cell>.json``, and
only those are computed:

- ``acq_gap``: every round's EI at its suggested row, relative gap (the
  sequential evaluator's acquisition).
- ``std_gap``: the last round's predictive std at its suggestions, relative
  gap.
- ``grad_gap``: the last round's -LML gradient in the fit's coordinates over
  its restart lanes, the largest component gap over the row count.
- ``out_of_domain``: suggestions outside the box or off the discrete grid.
"""
from __future__ import annotations

import numpy as np
import torch

from . import generator
from .reference import gp as ref


def _kernel_params(values: dict, dt, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), dtype=dt, device=device)
            for k, v in values.items()}


def numbers(cfg: dict, rounds: list, X: np.ndarray, Y: np.ndarray, last: dict,
            device, wanted, detail: list | None = None) -> dict:
    """The ``wanted`` numbers of a run (float64 reference on ``device``);
    with ``detail``, one entry per round of what was compared is appended."""
    dt = torch.float64
    spec, stated = cfg["kernel"], dict(cfg["stated"])
    if cfg["dtype"] != "float32":
        stated["noise_floor"] = 0.0  # the floor holds in float32 alone

    def t(a):
        return torch.as_tensor(np.atleast_2d(np.asarray(a, dtype=float)), dtype=dt,
                               device=device)

    out = {w: 0.0 for w in wanted}
    per_round, last_post = "acq_gap" in out, "std_gap" in out
    for i, rec in enumerate(rounds):
        if not per_round and not (last_post and i == len(rounds) - 1):
            continue
        n = rec["n"]
        kern = ref.Kernel(spec, _kernel_params(rec["params"], dt, device))
        post = ref.Posterior(kern, t(X[:n]), t(Y[:n]), rec["noise"], stated, rec["rung"])
        row = {"n": n, "rung": rec["rung"], "lml": [rec["lml"], post.lml], "acq": []}
        if per_round:
            fmin = post.fmin()
            for x, f in rec["argmax"]:
                mu, s = post.predict(t(x))
                e = float(ref.expected_improvement(mu, s, fmin)[0])
                gap = abs(-float(f) - e) / e if e > 0 else (0.0 if f == 0 else float("inf"))
                out["acq_gap"] = max(out["acq_gap"], gap)
                row["acq"].append([-float(f), e])
        if last_post and i == len(rounds) - 1:
            _, s = post.predict(t(rec["suggested"]))
            out["std_gap"] = float(np.max(np.abs(last["std"] / s.cpu().numpy() - 1.0)))
        del post
        if detail is not None:
            detail.append(row)

    if "out_of_domain" in out:
        out["out_of_domain"] = sum(int((~generator.in_domain(cfg, r["suggested"])).sum())
                                   for r in rounds)
    if "grad_gap" in out:
        rec = rounds[-1]
        names = list(dict.fromkeys(last["names"]))
        _, grads = ref.neg_lml_grad(spec, t(X[:rec["n"]]), t(Y[:rec["n"]]),
                                    {k: rec["params"][k] for k in names}, rec["noise"],
                                    stated, rec["rung"])
        g_ref = torch.cat([grads[k] for k in names]).cpu().numpy()
        out["grad_gap"] = float(np.max(np.abs(last["grad"] - g_ref[None, :]))) / rec["n"]
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every compared number at or
    under its limit."""
    table = {name: {"value": v, "limit": limits[name]["limit"]} for name, v in values.items()}
    ok = all(np.isfinite(r["value"]) and r["value"] <= r["limit"] for r in table.values())
    return ok, table
