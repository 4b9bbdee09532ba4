"""Acquisition and batch: the acquisition's batched evaluations a round, one
call over every anchor lane each, the program's ``lbfgs.evals`` counter
inside the profiled rounds' ``acq.lbfgs`` spans (bo/optimizer.py,
ops/lbfgs.py)."""
UNIT = "1"


def read(ctx):
    from h100_bench import program_spans

    return program_spans.per_round("lbfgs.evals", "acq.lbfgs")
