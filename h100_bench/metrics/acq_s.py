"""Acquisition and batch: each round's time less its fit, averaged over the
window's rounds (bo/optimizer.py, bo/acquisitions.py, bo/evaluators.py)."""
UNIT = "s"


def read(ctx):
    vals = [r["seconds"] - r["fit_seconds"] for r in ctx.rounds
            if r.get("fit_seconds") is not None]
    return sum(vals) / len(vals) if vals else None
