"""Surrogate fit: the mean of the BO loop's own ``fit_seconds`` over the
window's rounds (bo/bo_loop.py, models/bo_models.py, models/fit.py,
ops/lbfgs.py)."""
UNIT = "s"


def read(ctx):
    vals = [r["fit_seconds"] for r in ctx.rounds if r.get("fit_seconds") is not None]
    return sum(vals) / len(vals) if vals else None
