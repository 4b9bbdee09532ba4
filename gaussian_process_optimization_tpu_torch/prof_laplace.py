"""Where the float32 Laplace evidence departs from float64 (ROADMAP C10).

    python -m gaussian_process_optimization_tpu_torch.prof_laplace [--devices cuda,cpu]

At the main path's inputs (N = 4096, D = 6, labels sign(Y - median Y)), a
Bernoulli likelihood and an RBF kernel at ``LEAVES`` (the Bernoulli Laplace
leg's fitted leaves on an NVIDIA H100 in ``chip_smoke.py`` phase 9, exact
float32 values), prints for each device, against the float64 evidence on the
CPU:

- the float32 -LML's relative error with the Newton loop capped at 40 to 60
  steps, with K from the kernel route, from the plain route, and from float64
  rounded to float32;
- the jitter-ladder rung of B = I + W^1/2 K W^1/2 at the float32 mode;
- the float32 mode's largest distance from the float64 one;
- the three terms of the -LML (-sum log p(y|f), log det(B) / 2 and the
  quadratic a^T f / 2) at the float32 and the float64 mode;
- on a card, the float32 -LML's error with each stage on the host
  (``prof_stages.readings``: the K build, the factorization of B, now in
  float64, and the triangular solves).
"""
from __future__ import annotations

import argparse

import torch

from . import workload
from .config import config
from .kernels.stationary import RBF
from .models.laplace import laplace_inference
from .models.likelihoods import Bernoulli
from .ops import linalg

CAPS = (40, 45, 48, 49, 50, 51, 52, 55, 60)
LEAVES = {"kern.variance": 5246.02587890625, "kern.lengthscale": 4.5667643547058105}


def terms(post, y, lik):
    """(-sum log p(y|f), log det(B) / 2, a^T f / 2) of a Laplace posterior."""
    lik_term = -float(torch.sum(lik.logpdf(post.f_hat, y)))
    det = float(torch.sum(torch.log(torch.diagonal(post.L))))
    return lik_term, det, -float(post.lml) - lik_term - det


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="cuda")
    args = ap.parse_args()
    variance, lengthscale = LEAVES["kern.variance"], LEAVES["kern.lengthscale"]
    X, Y = workload.bench_data()
    labels = workload.classification_labels(Y)
    lik = Bernoulli()

    def K_of(dtype, device, route):
        old = config.use_cuda_kernels
        config.use_cuda_kernels = route
        try:
            kern = RBF.create(X.shape[1], variance=variance, lengthscale=lengthscale,
                              dtype=dtype, device=device)
            return kern.K(torch.as_tensor(X, dtype=dtype, device=device))
        finally:
            config.use_cuda_kernels = old

    y64 = torch.as_tensor(labels, dtype=torch.float64)
    with torch.no_grad():
        p64 = laplace_inference(K_of(torch.float64, "cpu", False), y64, lik)
    lml64 = -float(p64.lml)
    print(f"# prof_laplace: N={X.shape[0]}, D={X.shape[1]}, RBF variance {variance!r}, "
          f"lengthscale {lengthscale!r}, Bernoulli; float64 -LML on the CPU {lml64:.6f}, "
          f"terms (-log p, logdet/2, quad) {tuple(round(t, 4) for t in terms(p64, y64, lik))}")
    for device in args.devices.split(","):
        y = torch.as_tensor(labels, dtype=torch.float32, device=device)
        routes = {"kernel route": K_of(torch.float32, device, "auto"),
                  "plain route": K_of(torch.float32, device, False),
                  "float64 rounded": K_of(torch.float64, device, False).float()}
        for name, K in routes.items():
            with torch.no_grad():
                errs = [abs(-float(laplace_inference(K, y, lik, maxiter=c).lml) - lml64) / lml64
                        for c in CAPS]
                post = laplace_inference(K, y, lik)
                sW = torch.sqrt(post.W)
                B = torch.eye(K.shape[-1], dtype=K.dtype, device=device) \
                    + sW[:, None] * K * sW[None, :]
                rung = int(linalg.jitchol_full(B)[3])
                gap = float((post.f_hat.double().cpu() - p64.f_hat).abs().max())
            print(f"# prof_laplace, {device}, K by the {name}: -LML rel error at Newton caps "
                  f"{CAPS}: {' '.join(f'{e:.2e}' for e in errs)}; at the cap of 50: rung "
                  f"{rung}, max |mode f32 - f64| {gap:.3f}, terms (-log p, logdet/2, quad) "
                  f"{tuple(round(t, 4) for t in terms(post, y, lik))}")
        if device.startswith("cuda"):
            from . import prof_stages

            def measure():
                with torch.no_grad():
                    lml = -float(laplace_inference(K_of(torch.float32, device, "auto"), y,
                                                   lik).lml)
                return {"rel": abs(lml - lml64) / lml64}

            print(f"# prof_laplace, {device}, stage swaps: " + prof_stages.format_readings(
                prof_stages.readings(measure), ("rel",)))


if __name__ == "__main__":
    main()
