"""Kernels: the cell's kernel object's public ``K`` over the fit's restart
lanes at the padded (lanes, N, N) shape, against the roofline of the work the
kernel family's formula needs (``roofline.kbuild_work``), whatever builds it."""
UNIT = "%"


def read(ctx):
    import torch

    fitter, gp, U = ctx.lanes()
    with torch.no_grad():
        m = fitter.packer.unpack(U, reference=gp)
        ms = ctx.time_ms(lambda: m.kern.K(m.X), calls=20)
    lanes, n, d = U.shape[0], gp.X.shape[0], gp.X.shape[1]
    family = ctx.cfg["kernel"]["family"]
    cont = len(ctx.cfg["kernel"].get("continuous_dims", range(d)))
    flops, bytes_ = ctx.roofline.kbuild_work(family, lanes, n, n, d, continuous=cont)
    ctx.note("kbuild_bound", ctx.roofline.least_seconds(flops, bytes_)[1])
    return ctx.roofline.share_pct(flops, bytes_, ms / 1e3)
