"""BO loop: the host's reads of a value from the card a round, each a wait
for the card, the program's ``host.syncs`` counter inside the profiled
rounds' ``bo.suggest`` spans (utils/profiling.py ``host``)."""
UNIT = "1"


def read(ctx):
    from h100_bench import program_spans

    return program_spans.per_round("host.syncs", program_spans.ROUND)
