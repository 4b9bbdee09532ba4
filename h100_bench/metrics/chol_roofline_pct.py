"""Linear algebra (ops/linalg.py): the jitter-ladder factorization the -LML
runs (``jitchol_full``, from the fitted rung) on the cell's own Ky over the
fit's restart lanes, as the port's ``AssembleKy`` builds it, against
lanes * N^3 / 3 flops."""
UNIT = "%"


def read(ctx):
    import torch

    fitter, gp, U = ctx.lanes()
    with torch.no_grad():
        m = fitter.packer.unpack(U, reference=gp)
        K = m.kern.K(m.X)
        Ky = ctx.port.AssembleKy.apply(K, m._effective_noise(K.dtype), m.mask,
                                       m.heteroscedastic)
        del K
        hint = gp.jitter_hint
        ms = ctx.time_ms(lambda: ctx.port.linalg.jitchol_full(Ky, k_start=hint, greedy=True),
                         calls=10)
    lanes, n = Ky.shape[0], Ky.shape[-1]
    flops, bytes_ = ctx.roofline.cholesky_work(lanes, n)
    ctx.note("chol_bound", ctx.roofline.least_seconds(flops, bytes_)[1])
    return ctx.roofline.share_pct(flops, bytes_, ms / 1e3)
