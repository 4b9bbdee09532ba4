"""Where the torch port's thesis iteration spends its time, on one CUDA card.

Runs the bench's thesis path (N=4096, 4 continuous and 2 discrete inputs,
Gower kernel, exact_feval, 5x30 fit, local-penalization batch of 5, float32)
through ``gaussian_process_optimization_tpu_torch.workload``: one cold call,
then warm calls on perturbed Y with ``config.cuda_chol_blocks`` on and off in
turns (on, off, off, on), each printing its host-clock split and the ladder's
rungs; then one warm call under ``torch.profiler`` for the device-busy share
and the device time by kernel name (no trace file: the call launches too many
kernels for one). Needs a CUDA device:

    python benchmarks/prof_torch_thesis.py

With ``--numerics`` it instead takes the f32 thesis posterior's precision
apart: one cold call on the default route (B5, ``cuda_linalg.chol_full``, for the
ladder's full-size attempts); then, for each of the fit's restart lanes at its
fitted hyperparameters, the verified ladder's accepted rung through B5 and
through ``cholesky_ex`` (the kernels off for that call) and each route's f32
-LML gap from float64 at its accepted jitter; B4's forward error on the
fitted model's diagonal blocks against float64; the f32 -LML of the fitted Ky
through three routes (``cholesky_ex``, B5, blocked with B4) against float64 on
the same Ky, with its float64 condition number, at the accepted jitter and at
the ladder's next rung; then one warm call on the default route and the same
readings at its own posterior jitter. After each call the posterior's Ky goes
through the verified ladder on B5 and on ``cholesky_ex``, and both rungs are
printed.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def b4_block_readings(model, post, nb: int = 256):
    """B4 and its plain version on the Schur-complement diagonal blocks of the
    posterior's Ky (what a blocked factorization feeds B4), against float64."""
    from chip_smoke import _ky_of

    from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl

    Ky, L = _ky_of(model, post.jitter), post.L
    blocks = torch.stack([Ky[k:k + nb, k:k + nb] - L[k:k + nb, :k] @ L[k:k + nb, :k].mT
                          for k in range(0, Ky.shape[-1], nb)]).contiguous()
    got, want = cl.cholesky_blocks(blocks), cl.cholesky_plain(blocks)
    exact = torch.linalg.cholesky(blocks.double())
    scale = exact.abs().amax(dim=(-2, -1))
    fwd = ((got.double() - exact).abs().amax(dim=(-2, -1)) / scale).max()
    fwd_plain = ((want.double() - exact).abs().amax(dim=(-2, -1)) / scale).max()
    eig = torch.linalg.eigvalsh(blocks.double())
    print(f"B4 on the fitted model's {blocks.shape[0]} diagonal blocks: forward error "
          f"max |L - L64| / max |L64| kernel {float(fwd):.3e}, plain {float(fwd_plain):.3e}; "
          f"max cond_2 {float((eig[:, -1] / eig[:, 0]).max()):.4g}")


def lml_readings(model, jitter, tag):
    """The f32 -LML of the model's Ky at ``jitter`` through three full-size
    routes, against float64 on the same Ky, and that Ky's float64 condition
    number."""
    from chip_smoke import _ky_of, _lml

    from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    m64 = tree_map(lambda t: t.double(), model)
    Ky64 = _ky_of(m64, jitter.double())
    lml64 = _lml(torch.linalg.cholesky(Ky64), m64._normalized_Y(), m64.num_data)
    eig = torch.linalg.eigvalsh(Ky64)
    del Ky64
    Ky, Yc = _ky_of(model, jitter), model._normalized_Y()
    routes = []
    for route, factor in (("cholesky_ex", cl.cholesky_plain), ("B5", cl.chol_full),
                          ("blocked with B4", _blocked_b4)):
        L = factor(Ky)
        if bool(torch.isfinite(L).all()):
            lml = _lml(L, Yc, model.num_data)
            routes.append(f"{route} {-lml:.6f} (rel {abs(lml - lml64) / abs(lml64):.3e})")
        else:
            routes.append(f"{route} fails (not positive definite in float32)")
    print(f"{tag}: jitter {float(jitter):.4g}; -LML f64 {-lml64:.6f}, f32 "
          f"{', '.join(routes)}; Ky eigenvalues {float(eig[0]):.4g} .. {float(eig[-1]):.4g}, "
          f"cond {float(eig[-1] / eig[0]):.4g} (float64)")


def _blocked_b4(Ky):
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.ops import linalg

    old = config.cuda_chol_blocks
    config.cuda_chol_blocks = True
    try:
        return linalg.blocked_cholesky(Ky)
    finally:
        config.cuda_chol_blocks = old


def lane_readings(bo):
    """The fit's restart lanes, refitted from the model's starts: each lane's
    Ky at its fitted hyperparameters through the verified ladder on B5 and on
    ``cholesky_ex`` (``use_cuda_kernels`` off for that call alone), with each
    route's accepted rung and its f32 -LML's gap from float64 at the same
    jitter."""
    from chip_smoke import _ky_of, _lml

    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.ops import linalg
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    model = bo.model.model
    (fitter,) = bo.model._fitters.values()
    gen = torch.Generator(device=model.X.device).manual_seed(0)
    _, res = fitter.solve(model, fitter.draw_starts(model, gen))
    lanes = [fitter.packer.unpack(res.x[i], reference=model) for i in range(res.x.shape[0])]
    with torch.no_grad():
        Ky = torch.stack([_ky_of(m, torch.zeros((), device=model.X.device)) for m in lanes])
    ladders = {}
    for route, kernels in (("B5", "auto"), ("cholesky_ex", False)):
        old = config.use_cuda_kernels
        config.use_cuda_kernels = kernels
        try:
            ladders[route] = linalg.jitchol_full(Ky)
        finally:
            config.use_cuda_kernels = old
    del Ky
    for i, m in enumerate(lanes):
        m64 = tree_map(lambda t: t.double(), m)
        Yc = m._normalized_Y()
        cells = []
        for route, (L, jitter, ok, rung) in ladders.items():
            if not bool(ok[i]):
                cells.append(f"{route} rung {int(rung[i])} (fails)")
                continue
            Ky64 = _ky_of(m64, jitter[i].double())
            lml64 = _lml(torch.linalg.cholesky(Ky64), m64._normalized_Y(), m64.num_data)
            del Ky64
            lml = _lml(L[i], Yc, m.num_data)
            cells.append(f"{route} rung {int(rung[i])}, -LML f32 {-lml:.6f}, f64 {-lml64:.6f} "
                         f"(rel {abs(lml - lml64) / abs(lml64):.3e})")
        print(f"lane {i} (fit f {float(res.f[i]):.6f}): {'; '.join(cells)}")


def posterior_rungs(model, tag):
    """The verified ladder's rung on the posterior's Ky through B5 and through
    ``cholesky_ex`` (``use_cuda_kernels`` off for that call alone)."""
    from chip_smoke import _ky_of

    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.ops import linalg

    Ky = _ky_of(model, torch.zeros((), device=model.X.device))[None]
    cells = []
    for route, kernels in (("B5", "auto"), ("cholesky_ex", False)):
        old = config.use_cuda_kernels
        config.use_cuda_kernels = kernels
        try:
            _, jitter, ok, rung = linalg.jitchol_full(Ky)
        finally:
            config.use_cuda_kernels = old
        cells.append(f"{route} rung {int(rung[0])} (jitter {float(jitter[0]):.4g}, "
                     f"ok {bool(ok[0])})")
    print(f"{tag}, the posterior's Ky through the verified ladder: {', '.join(cells)}")


def numerics(bo, Y):
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.config import config

    workload.thesis_iteration(bo)
    model, post = bo.model.model, bo.model.posterior
    print(f"cold call, default route (B5): ladder {bo.model.ladder[-1]}, "
          f"-LML f32 {-float(post.lml):.6f}")
    lane_readings(bo)
    posterior_rungs(model, "cold call")
    b4_block_readings(model, post)
    lml_readings(model, post.jitter, "fitted Ky at the accepted rung")
    # the ladder's next rung: jitter mean(diag) * base * 10^rung (ops/linalg.py)
    from chip_smoke import _ky_of

    rung = bo.model.ladder[-1]["posterior_rung"]
    diag_mean = torch.diagonal(_ky_of(model, torch.zeros(()))).mean()
    lml_readings(model, diag_mean * config.jitchol_base * 10.0 ** rung,
                 "fitted Ky one rung up")
    bo.Y = Y + 0.01 * np.random.default_rng(10).standard_normal(Y.shape)
    workload.thesis_iteration(bo)
    model, post = bo.model.model, bo.model.posterior
    print(f"warm call, default route (B5): ladder {bo.model.ladder[-1]}, "
          f"-LML f32 {-float(post.lml):.6f}")
    posterior_rungs(model, "warm call")
    lml_readings(model, post.jitter, "fitted Ky at the accepted rung")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--numerics", action="store_true",
                        help="the f32 posterior's precision readings instead of the timings")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_torch_thesis: needs a CUDA device")

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.utils.profiling import counters

    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda")
    X, Y = workload.thesis_data()
    bo = workload.thesis_bo(X, Y, device=dev, dtype=torch.float32)
    if args.numerics:
        numerics(bo, Y)
        return
    config.cuda_chol_blocks = True
    workload.thesis_iteration(bo)  # cold: builds, cuSOLVER set-up, first ladder climb

    def warm(i, chol_blocks):
        config.cuda_chol_blocks = chol_blocks
        bo.Y = Y + 0.01 * np.random.default_rng(10 + i).standard_normal(Y.shape)
        counters["b4.launches"] = 0
        t0 = time.perf_counter()
        it = workload.thesis_iteration(bo)
        total = time.perf_counter() - t0
        print(f"cuda_chol_blocks={chol_blocks!s:5}: total {total:.3f} s = fit {it.fit_s:.3f} "
              f"+ estimate_L {it.estimate_L_s:.3f} + argmaxes "
              f"{' + '.join(f'{a:.3f}' for a in it.argmax_s)}; ladder {bo.model.ladder[-1]}, "
              f"B4 launches {counters['b4.launches']}")

    for i, on in enumerate((True, False, False, True)):
        warm(i, on)

    from torch.profiler import ProfilerActivity, profile

    config.cuda_chol_blocks = True
    bo.Y = Y + 0.01 * np.random.default_rng(20).standard_normal(Y.shape)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        it = workload.thesis_iteration(bo)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device kernels only: operator rows repeat their kernels' time
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"# profiled warm call (cuda_chol_blocks=True): wall {wall:.3f} s (fit "
          f"{it.fit_s:.3f}, estimate_L {it.estimate_L_s:.3f}, argmaxes "
          f"{sum(it.argmax_s):.3f}), device busy {dev_us / 1e6:.3f} s "
          f"({100 * dev_us / 1e6 / wall:.1f}% of wall)")
    print(events.table(sort_by="self_device_time_total", row_limit=20))


if __name__ == "__main__":
    main()
