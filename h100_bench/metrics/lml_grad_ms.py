"""-LML (models/gp.py): the fit's objective, value and gradient, over the
fit's restart lanes at the cell's padded shapes and fitted hyperparameters,
milliseconds a call between CUDA events."""
UNIT = "ms"


def read(ctx):
    fitter, gp, U = ctx.lanes()
    from h100_bench.probe import value_and_grad

    return ctx.time_ms(lambda: value_and_grad(fitter, gp, U), calls=10)
