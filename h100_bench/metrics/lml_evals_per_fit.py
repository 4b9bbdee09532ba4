"""Surrogate fit: the -LML's batched evaluations in a refit, each one call of
the objective over every restart lane with its line-search trials: the
program's ``lbfgs.evals`` counter inside each ``fit.solve`` span of the
profiled rounds, mean per refit (models/fit.py, ops/lbfgs.py)."""
UNIT = "1"


def read(ctx):
    from h100_bench import program_spans

    fits = program_spans.in_rounds(program_spans.record(), "fit.solve")
    return program_spans.total(fits, "lbfgs.evals") / len(fits) if fits else None
