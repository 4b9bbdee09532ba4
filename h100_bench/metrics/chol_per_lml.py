"""Linear algebra: the jitter ladder's batched factorizations per -LML
evaluation in the refits, ``chol.factorizations`` over ``lbfgs.evals`` inside
the profiled rounds' ``fit.solve`` spans; 1.0 means no evaluation climbed a
rung (ops/linalg.py ``jitchol_full``)."""
UNIT = "1"


def read(ctx):
    from h100_bench import program_spans

    fits = program_spans.in_rounds(program_spans.record(), "fit.solve")
    evals = program_spans.total(fits, "lbfgs.evals")
    return program_spans.total(fits, "chol.factorizations") / evals if evals else None
