"""Surrogate fit: the host's own seconds in a refit, each profiled round's
``bo.fit`` span less the ``host.sync`` spans inside it, in which the host
waited for the card; read under the profiler, so it carries the profiler's
launch slowdown (bo/bo_loop.py, models/bo_models.py, models/fit.py)."""
UNIT = "s"


def read(ctx):
    from h100_bench import program_spans

    return program_spans.host_s("bo.fit")
