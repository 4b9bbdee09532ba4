#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``gaussian_process_optimization_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device   — refuses to run without CUDA; prints the card's name and power limit;
                checks that the entry points build on the card when no device is
                given;
  2. build    — builds the native design engine (g++, utils/native.py) and holds its
                properties on this host, then compiles the CUDA kernels from
                ``csrc/`` (nvcc, sm_90a, one process per source) and times it;
  3. kernels  — each kernel against its plain PyTorch version at its path's
                shapes (B1's K(X, X) also bitwise equal to its transpose, and
                its mean signed error against a float64 K printed beside the
                plain version's; what the
                model calls, ``stationary_K`` forward and backward, timed beside the
                bare kernels and the symmetrization pass it no longer runs; B2's dZ
                pass timed at the sweep shape), with its time, the plain version's, the one PyTorch call
                that computes the same function where there is one (B3:
                solve_triangular against I, B4: cholesky_ex) and the roofline
                bound from the shapes (bytes at 3.35 TB/s or f32 flops at
                67 TFLOP/s, the larger); times are medians of CUDA-event timings
                of back-to-back calls after warm-up; and one full (5, 4096, 4096)
                factorization timed four ways: cholesky_ex, blocked_cholesky with
                B4, blocked_cholesky with plain diagonal blocks, and B5 (the
                default ladder route), which is also checked and timed on the
                MCMC lanes' (10, 4096, 4096) RBF Gram against float64,
                cholesky_ex and its plain version;
  4. main     — one BO iteration at the bench's full size (N=4096, D=6, 5x30 fit,
                1000-candidate EI sweep, 5x50 anchors, float32), twice; the second
                run's launch counts of B1-B3 must be non-zero (B4 is off this
                path and counted too); the fitted model's
                LML, its gradient and the EI at the argmax are held against a float64
                recomputation on the card;
  4b. options — the main path's fit once each with the JAX package's fit options: the
                trace (each lane finite to its last step, its minimum the lane's f,
                plot_optimizer through a recording backend), the thread ladder (rungs
                and -LML beside the default fit's), nonmonotone_eta=0.5 with
                grow_backtracked=1.0 (num_ls beside the default's, no lane above its
                start) and grad_matmul_precision="high" (the start gradient against
                float64 at each precision with a one-bf16-pass control, the backward's
                time both ways, a 4096^2 product under each global precision), B1-B3
                launched in each; then the thread ladder on the thesis Ky with
                ``cuda_chol_blocks`` on (B3 and B4 launched);
  4c. calls  — the JAX package's call forms on phase 4's fitted model (N=4096, D=6,
                float32): EI's argmax by ``optimize(f=, f_df=, acquisition=)`` bit for
                bit ``acq.optimize()``'s (B1 and B3 launched) and ``optimize(f=)`` on
                the host path, timed; ``make_svgp_train_step(optimizer=...)`` at
                phase 9's SVGP setting (the default factory bit for bit Adam at
                optax's settings, an SGD factory's first step u0 - lr * grad, B1 and
                B2's row pass launched); ``ensemble_sample(init=...)`` on ES_EPMGP's
                log-density at phase 8's size (the chain of the same draws from
                init, bit for bit); one ``suggest_next_locations`` of a ``BO`` with
                ``normalization_type="maxmin"`` equal to one with ``"stats"``;
  5. B3 again — on the diagonal blocks of the fitted model's own Cholesky factor,
                with the componentwise residual held to forward substitution's
                rounding bound;
  6. thesis   — the bench's thesis iteration (N=4096, 4 continuous and 2 discrete
                inputs, Gower kernel, exact_feval, 5x30 fit, local-penalization
                batch of 5 through BayesianOptimization.suggest_next_locations) with
                ``config.cuda_chol_blocks`` on, twice (cold, then warm on perturbed
                Y); the time split into fit, Lipschitz estimate and 5 penalized
                argmaxes, the ladder's rungs, peak memory, the four kernels' launch
                counts (B3 and B4 must be non-zero); the batch, the hint carried between the
                calls, B4 on the fitted model's own diagonal blocks, the
                posterior factor's backward error, and the -LML against float64
                on the factor's own L L^T are checked; the -LML against float64
                on the same Ky is printed as a reading;
  7. loop     — leg A, the tell-and-ask loop itself: ``regret_run`` on
                branin (12 iterations) and hartmann6 (10 of the protocol's 30),
                latin design of 5, EI, ``exact_feval``, float32, the two runs side by
                side in interpreters of their own (one host thread each), started
                after phase 9 and run beside phases 10-13 (host loops that leave
                the card idle), then waited for and held: every iteration ran, no fit
                failed, branin's best under 1.0, hartmann6's regret inside the range
                of the JAX package's stored CPU float64 runs after as many
                evaluations; seconds per iteration split into
                fit and acquisition. Leg B, the composite path at the main path's
                size (N=4096, D=6): an ``Add`` of an ARD Matern52 and an
                RBF on the first input, Gamma priors, a constant mean function, LCB
                from Sobol anchors, ``run_optimization(max_iter=2)`` (three refits,
                N grows to 4098 in the 8192 bucket): B1 launched twice per LML trial
                of every fit, B1-B3 counts non-zero, -(LML + log prior) and its
                start gradient against float64 on the card, the two suggestions in
                the box and distinct; then one Thompson batch, one random batch and
                one argmax by the host optimizer under a cost, each timed;
  8. surrogates — GPyOpt's other surrogates and acquisitions at full width, float32
                on the card, through their entry points with no device given (run
                before leg A): GP_MCMC + EI_MCMC at GPyOpt's HMC defaults but the
                leapfrog step and a chain cut to 100 steps on the main
                data (accept rate > 0, per-sample predictions and EI_MCMC at the
                argmax against float64 on the same samples, B1-B3 launched) and a
                local-penalization batch of 3 over LCB_MCMC; ES_EPMGP and ES on phase
                4's fitted model (p_min normalized, EPMGP in f32 against f64 on the
                same mu and Sigma); the VarDTC bound at N=50 000, D=2, M=256 against
                float64, the FITC, DTC and PEP bounds, a 50-step fit (the bound does
                not fall, 5 predictions near the truth, B2's row pass launched with
                dX at Kmn's 256 x 50 000), and sparseGP through BayesianOptimization
                (its fit cut to 200 steps);
                warpedGP and input_warped_GP (50 fit steps, -LML against float64 on
                the card and on the CPU at the fitted point, with a control the
                limit must catch) and RF at N=256. Phase 3 also holds B1 and B2 at
                Kmn's 256 x 50 000 (B2's dZ there too, a pass the sparse fit does
                not run) and B1 at the MCMC surrogate's 10 x 4096 x 4096;
  9. approximate — approximate inference, pool batches, the CLI and serialization, float32
                on the card, through their entry points with no device given (run
                before leg A): SVGP at BASELINE.md configuration 4 (N=50 000, D=2,
                M=256, 300 Adam steps at batch 2048: -ELBO falls, 5 predictions
                near the truth, the ELBO against float64 at workload.svgp_probe's
                leaves, limit from the JAX package's own float32 error there, and
                at the fitted leaves, each with a control its limit must catch,
                B2's row pass at Kmn 256 x 2048);
                dense EP and EPDTC classification on the main data (N=4096, D=6,
                labels sign(Y - median Y): EP to convergence, two alternated
                rounds of 30 steps, the evidence not falling, training accuracy
                > 0.8; sequential EP at N=256); GPLaplace with Bernoulli and with
                a Student-t on the main targets with 5% outliers, and
                TPRegression, each fitted 1 x 30 (-LML falls, f32 vs f64 printed);
                an LP batch of 5 from a pool of 10 000 thesis-space rows (B3
                launched); the command line in a child interpreter (7
                evaluation rows) and save_model / load_model bit for bit. Phase 3
                also holds B1 and B2 at the SVGP's Kmn 256 x 2048;
 10. zoo      — the kernel zoo and the first multi-output, grid and state-space models,
                float32 on the card, through their entry points with no device given
                (run before leg A). Leg 1, the slice's main path: ICM coregionalized
                regression (3 tasks of 1366 + 1365 + 1365 rows, ARD Matern52 on 6 inputs
                read through active_dims, rank 1), a 5 x 30 fit, the posterior and 3 x
                1000 predictions (B1-B3 launched, -LML and its gradient at the fitted
                point against float64, every variance > 0). Leg 2: an exact GP at
                N=4096 on 1-D times under RBF + StandardPeriodic * RBF + RatQuad +
                Linear + Bias, the same gates. Leg 3: the Kronecker grid GP on 64 x 64
                points (f32 against f64, the float64 -LML against the dense GP's, a
                1 x 30 fit). Leg 4: the quasi-periodic state-space GP at N=4096 (seconds
                per -LML and gradient, f32 against f64, the Matern32 form's float64
                -LML against the dense GP's, a fit cut to 1 step). Leg 5: every other
                zoo kernel at N=4096, K and each leaf's gradient, f32 against f64. B1
                and B2 also timed at legs 1-2's shapes (D=6 through a 7-column slice,
                D=1), with plain times and byte bounds. The phase reports every leg
                before it fails on any;
 11. latent   — the latent-variable models, float32 on the card, through their entry
                points with no device given (run before leg A). Leg 1, the slice's main
                path: the point GPLVM (N=4096, D=12 oil-flow stand-in, Q=6, RBF ARD +
                Bias, one L-BFGS lane of at most 200 steps over 24 585 parameters: B1,
                B2's row and column passes, B3), infer_newX on 256 held-out rows (one
                with a NaN entry) and its reconstruction RMSE; the -LML and its gradient
                with the X block against float64. Leg 2: the Bayesian GPLVM (Q=7, M=40,
                100 steps, peak memory), predict and the uncertain infer_newX. Leg 3:
                MRD, SS-GPLVM, LVMOGP, the SVI Bayesian GPLVM, the IBP latent force
                model, the zoo.py models and the magnification of leg 1's model, one
                short run each, f32 against f64. Phase 3 also holds B2 with dX and dZ
                at the GPLVM's (1, 4096, 4096), Q=6. The fitted leaves are saved to
                chiprun_out/latent_fitted.npz;
 12. sharded  — the multi-device layer on a 4-shard mesh (four cards where there are
                four, else four shards of card 0), float32, run before leg A: the
                sharded and distributed -LML at the main data (N=4096), the
                distributed Cholesky at N=8192 with ``cuda_chol_blocks`` off and on
                (B4 once per panel), the VarDTC bound at the sparse example
                (N=50 000) and 5 SVGP steps at configuration 4, the main path's fit
                at 2 restarts a shard and one ``BayesianOptimization(mesh=...)``
                suggestion, each against the same call unsharded and against
                float64 (limits from the JAX package's own float32 on its CPU mesh);
                offset-GP clustering of 40 series in four families (each lane cut to
                30 L-BFGS steps; in float32 its first round, 820 lanes, in float64
                to its end); one ``torch.profiler`` trace of a sharded -LML into
                chiprun_out/trace_phase12 that must name B1's kernel; the plot family
                through the 'none' backend. Each leg prints its ``PhaseTimer`` split;
                B1 at a shard's row block and B1 / B2 at the clustering's lanes and
                B4 inside the distributed Cholesky are timed beside their plain
                versions and bounds. The launches of the sharded calls and of the
                clustering are counted apart;
 13. examples — the example twins (``gaussian_process_optimization_tpu_torch/examples``),
                float32 on the card with no device given, run before leg A: every
                gallery demo unoptimized, its objective against the port's float64
                on the CPU (limit 10x the port's own float32 gap on the CPU, floor
                1e-6 and cap 1e-2 relative; the three objectives whose float32 the
                JAX package's own CPU run puts past the cap are held in float64 on
                the card and their float32 printed); ``tests/test_gallery.py``'s
                seven optimized demos at their budgets (each ends finite and no
                worse than it started); the
                nine example scripts at ``tests/test_examples.py``'s arguments, each
                held to what that test checks (the BO ones cut to one iteration,
                ``multichip_bo`` on a 4-shard mesh, ``large_scale_sparse`` at its
                full N = 50 000 with the SVGP cut to 50 of 300 steps) and the
                Forrester example at N = 512, whose fit puts an example's
                GPRegression on B1-B3 (the examples' own sizes stay under B1's gate
                and B3's block; phase 3 checks and times B1 / B2 at that fit's
                5 x 512 x 512 and B3 at its 10 blocks). B1-B3 launched (B4 counted);
     Phases 9, 10 and 11 also print, at the Bernoulli Laplace leg's fitted
     point, at leg 1's ICM fitted point and at the Bayesian GPLVM's stored
     fitted leaves (tests/data/latent_card_fitted.npz), the float32 objective
     against float64 with each stage (K build, ladder Cholesky, triangular
     solves) and each pair of them on the host's CPU, with the port's blocked
     Cholesky, and on the CPU entirely (prof_stages.py; ROADMAP C10, C11, C13);
 14. summary  — the wall time of each phase, a JSON line of kernels, then
                ``{"ok": true, "device": {...}}`` last.

Any failed check raises, and the script exits non-zero.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def _time_ms(fn, calls: int = 20, rounds: int = 5, warmup: int = 2) -> float:
    """Median over ``rounds`` of the mean time of ``calls`` back-to-back calls,
    CUDA events around each run: the host's launch overhead overlaps the
    device's work, as in a stream of calls, wherever the call is device-bound."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# Roofline of one NVIDIA H100 SXM at its 700 W limit (data sheet): HBM3 bytes
# per second, and float32 flops per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def _bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the flops over the f32 rate, and which of the two it is."""
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    t = max(t_bytes, t_flops)
    return {"bound_ms": t * 1e3, "bound_us": t * 1e6,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# Flops per entry of a stationary K (B1) and of its parameter backward (B2),
# counted from their formulas with d input dimensions: the scaled difference,
# its square and the sum are 4 per dimension, the Matern52 profile (sqrt, exp
# and the polynomial) about 10; the backward recomputes r, forms dK/dr / r and
# G K, and accumulates one term per lengthscale, about 7 per dimension and 20.
def _k_flops(d: int) -> int:
    return 4 * d + 10


def _k_bwd_flops(d: int) -> int:
    return 7 * d + 20


def _max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def _close(name, got, want, rtol, atol):
    torch.testing.assert_close(got.double(), want.double(), rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")


# Forward substitution in float32 is componentwise backward stable:
# |L X - I| <= gamma_nb |L| |X| with gamma_n = n u / (1 - n u), u = 2^-24
# (Higham, Accuracy and Stability of Numerical Algorithms, Thm 8.5), in any
# summation order and at any conditioning. B3's residual is held to that bound.
def _gamma(n: int) -> float:
    u = 2.0 ** -24
    return n * u / (1.0 - n * u)


def _tri_residual(L, X) -> float:
    """max over entries of |L X - I| / (|L| |X|), in float64, for X ~ L^-1."""
    Ld, Xd = L.double(), X.double()
    eye = torch.eye(L.shape[-1], dtype=torch.float64, device=L.device)
    R = (Ld @ Xd - eye).abs()
    S = Ld.abs() @ Xd.abs()
    return float((R / S.clamp_min(1e-300)).max())


def _close_blocks(name, got, want, rtol):
    """|got - want| <= rtol (|want| + max |want| of the same block), per block."""
    w = want.double()
    err = (got.double() - w).abs()
    scale = w.abs().amax(dim=(-2, -1), keepdim=True)
    bad = err > rtol * (w.abs() + scale)
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} entries differ by more than "
                             f"rtol {rtol} of the entry plus the block's max; "
                             f"max |err| {float(err.max()):.3e}")


def _check_tri_inv(name, L, got, want):
    """B3's output against its plain version and the residual bound; returns
    (max |got - want|, kernel residual, plain residual)."""
    _close_blocks(name, got, want, rtol=5e-4)
    if not bool((torch.triu(got, 1) == 0).all()):
        raise AssertionError(f"{name}: strict upper triangle not exactly zero")
    res, res_plain = _tri_residual(L, got), _tri_residual(L, want)
    limit = _gamma(L.shape[-1])
    print(f"# {name}: max |kernel - plain| {_max_err(got, want):.3e}; componentwise "
          f"residual |LX-I|/(|L||X|) kernel {res:.3e}, plain {res_plain:.3e}, "
          f"limit gamma_{L.shape[-1]} = {limit:.3e}")
    if res > limit:
        raise AssertionError(f"{name}: residual {res:.3e} above the bound {limit:.3e}")
    return _max_err(got, want), res, res_plain


def _chol_backward_error(A, L) -> float:
    """max over entries of |L L^T - A| / (|L| |L^T|), in float64."""
    Ld = L.double()
    R = (Ld @ Ld.mT - A.double()).abs()
    return float((R / (Ld.abs() @ Ld.abs().mT).clamp_min(1e-300)).max())


def _check_chol(name, A, got, want, rtol=1e-4):
    """B4's output against its plain version (when ``rtol`` is given), an
    exactly zero strict upper triangle, and Cholesky's componentwise backward
    error |L L^T - A| <= gamma_{nb+1} |L| |L^T| (Higham, Thm 10.3), which
    holds at any conditioning; returns max |got - want|."""
    if rtol is not None:
        _close_blocks(name, got, want, rtol=rtol)
    if not bool((torch.triu(got, 1) == 0).all()):
        raise AssertionError(f"{name}: strict upper triangle not exactly zero")
    res, res_plain = _chol_backward_error(A, got), _chol_backward_error(A, want)
    limit = _gamma(A.shape[-1] + 1)
    print(f"# {name}: max |kernel - plain| {_max_err(got, want):.3e}; componentwise "
          f"backward error |LL^T-A|/(|L||L^T|) kernel {res:.3e}, plain {res_plain:.3e}, "
          f"limit gamma_{A.shape[-1] + 1} = {limit:.3e}")
    if res > limit:
        raise AssertionError(f"{name}: backward error {res:.3e} above the bound {limit:.3e}")
    return _max_err(got, want)


def _check_full(name, A, got, plain):
    """B5's factor of A against float64 and cholesky_ex: an exactly zero strict
    upper triangle, every lane finite with a positive diagonal, each lane's
    normwise backward error ||L L^T - A||_F / ||A||_F at most 1.5x
    cholesky_ex's, its forward error max |L - L64| / max |L64| at most 4x
    cholesky_ex's (tests/test_torch_chol_full.py's limits), and max |kernel -
    plain| / max |L64| at most 4x cholesky_ex's forward error (both factors lie
    within their forward error of L64: on an H100 max |kernel - plain| read
    1.6e-6 on the Matern52 Ky and 2.0e-5 on the RBF one, where cholesky_ex's
    forward errors read 1.2e-6 and 1.3e-5); returns max |got - plain|, the
    plain version's factor."""
    if not bool((torch.triu(got, 1) == 0).all()):
        raise AssertionError(f"{name}: strict upper triangle not exactly zero")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: a lane failed")
    if not bool((torch.diagonal(got, dim1=-2, dim2=-1) > 0).all()):
        raise AssertionError(f"{name}: a diagonal entry is not positive")
    ex = torch.linalg.cholesky_ex(A)[0]
    exact = torch.linalg.cholesky(A.double())
    scale = exact.abs().amax(dim=(-2, -1))
    Ad = A.double()

    def backward(L):
        Ld = L.double()
        return (Ld @ Ld.mT - Ad).norm(dim=(-2, -1)) / Ad.norm(dim=(-2, -1))

    def forward(L):
        return (L.double() - exact).abs().amax(dim=(-2, -1)) / scale

    bwd, bwd_ex = backward(got), backward(ex)
    fwd, fwd_ex = forward(got), forward(ex)
    apart = (got.double() - plain.double()).abs().amax(dim=(-2, -1)) / scale
    print(f"# {name}: backward error ||LL^T-A||/||A|| kernel {float(bwd.max()):.3e}, "
          f"cholesky_ex {float(bwd_ex.max()):.3e}, plain {float(backward(plain).max()):.3e}; "
          f"forward error from float64 kernel {float(fwd.max()):.3e}, cholesky_ex "
          f"{float(fwd_ex.max()):.3e}; max |kernel - plain| {_max_err(got, plain):.3e}, "
          f"over max |L64| {float(apart.max()):.3e} (limit 4x cholesky_ex's forward error)")
    if not bool((bwd <= 1.5 * bwd_ex).all()):
        raise AssertionError(f"{name}: backward error {bwd.tolist()} above 1.5x "
                             f"cholesky_ex's {bwd_ex.tolist()}")
    if not bool((fwd <= 4 * fwd_ex).all()):
        raise AssertionError(f"{name}: forward error {fwd.tolist()} above 4x "
                             f"cholesky_ex's {fwd_ex.tolist()}")
    if not bool((apart <= 4 * fwd_ex).all()):
        raise AssertionError(f"{name}: kernel and plain version {apart.tolist()} apart, "
                             f"above 4x cholesky_ex's forward error {fwd_ex.tolist()}")
    return _max_err(got, plain)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a GPU only")
    if not (ROOT / "gaussian_process_optimization_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: the port's package is not beside this script")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"# device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(smi)
    return smi


def phase_default_device():
    """A bare call of each entry point builds on the card."""
    from gaussian_process_optimization_tpu_torch import convert, workload
    from gaussian_process_optimization_tpu_torch.bo.cost import CostModel
    from gaussian_process_optimization_tpu_torch.kernels.stationary import Matern52
    from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
    from gaussian_process_optimization_tpu_torch.bo.interface import BODriver
    from gaussian_process_optimization_tpu_torch.models.classification import (
        GPClassification, SparseGPClassification)
    from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
    from gaussian_process_optimization_tpu_torch.models.laplace import GPLaplace
    from gaussian_process_optimization_tpu_torch.models.svgp import SVGP
    from gaussian_process_optimization_tpu_torch.models.tp import TPRegression

    X, Y = workload.thesis_data(n=16)
    model = workload.make_model(X, Y)
    built = {
        "regret_run": workload.regret_run("forrester", 0, iters=0, max_iters=0).bo.model.device,
        "composite_bo": workload.composite_bo(*workload.bench_data(n=16), steps=0).model.device,
        "CostModel": CostModel("evaluation_time").cost_model.device,
        "make_model": model.X,
        "GPRegression.create": GPRegression.create(X, Y).X,
        "Matern52.create": Matern52.create(6).variance,
        "GPModel": GPModel().device,
        "gp_from_leaves": convert.gp_from_leaves(convert.leaves_of(model)).X,
        "thesis_bo": workload.thesis_bo(X, Y).model.device,
        "SVGP.create": SVGP.create(X, Y, num_inducing=4).Z,
        "GPLaplace.create": GPLaplace.create(X, Y).X,
        "GPClassification.create": GPClassification.create(X, Y).X,
        "SparseGPClassification.create": SparseGPClassification.create(X, Y, num_inducing=4).Z,
        "TPRegression.create": TPRegression.create(X, Y).X,
        "BODriver": BODriver({}).device,
    }
    devices = {k: (v if isinstance(v, torch.device) else v.device).type
               for k, v in built.items()}
    print(f"# entry points with no device given build on: {devices}")
    if set(devices.values()) != {"cuda"}:
        raise AssertionError(f"an entry point built off the card: {devices}")


def _native_engine():
    """The host design engine (utils/native.py): built and loaded here, and its
    properties held on this host: one point per stratum, maximin no worse than
    a single random LHS, the discrete levels represented, Sobol equal to
    scipy's unscrambled sequence."""
    from scipy.stats import qmc

    from gaussian_process_optimization_tpu_torch.utils import native

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native design engine did not build (g++) or load")
    seconds = time.perf_counter() - t0
    X = native.maximin_lhs(25, 3, 30, 123)
    strata = all(len(set(np.floor(X[:, j] * 25).astype(int).tolist())) == 25 for j in range(3))
    ordered = native.min_pairwise_dist(X) >= native.min_pairwise_dist(
        native.maximin_lhs(25, 3, 1, 7)) * 0.8
    H, ok = native.discrete_lhs(20, [4, 3], 30, 10, 0.8, 99)
    levels = ok and all(np.bincount(np.floor(H[:, j] * L).astype(int), minlength=L).min()
                        >= max(np.floor(0.8 * 20 / L), 1) for j, L in enumerate([4, 3]))
    sobol = np.array_equal(native.sobol_points(256, 8), qmc.Sobol(8, scramble=False).random(256))
    print(f"# build: native design engine {native.library_path().relative_to(ROOT)} in "
          f"{seconds:.2f} s; one point per stratum {strata}, maximin ordered {ordered}, "
          f"levels represented {levels}, Sobol equal to scipy's {sobol}")
    if not (strata and ordered and levels and sobol):
        raise AssertionError("the native design engine fails its properties")


def phase_build():
    from gaussian_process_optimization_tpu_torch.ops import _build

    _native_engine()

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    print(f"# build: {path.relative_to(ROOT)} in {seconds:.2f} s")
    # nvcc's report: the kernels that spill (the chunked D > 8 instantiations
    # do, around their out-of-line r^2) and the main path's kernels (B3, B4, and
    # B1 / B2 for ARD Matern52 at D = 6)
    log = path.with_suffix(".log")
    lines = log.read_text().splitlines() if log.exists() else []
    kernels = {}
    for i, line in enumerate(lines):
        if line.startswith("# ") and "compiled in" in line:
            print(f"# build: {line[2:]}")
        if "Compiling entry function" in line:
            kernels[line.split("'")[1]] = " ".join(lines[i + 1:i + 4])
    regs = [int(m.group(1)) for m in (re.search(r"Used (\d+) registers", v)
                                      for v in kernels.values()) if m]
    spilled = {k: v for k, v in kernels.items() if not re.search(r" 0 bytes spill stores", v)}
    print(f"# ptxas: {len(kernels)} kernels, at most {max(regs, default=0)} registers, "
          f"{len(spilled)} with spills")
    for name, report in kernels.items():
        if name in spilled or "stationary" not in name or "ILi4ELb1ELi6ELb0" in name:
            used = re.search(r"Used .*", report)
            spills = re.search(r"\d+ bytes stack frame.*spill loads", report)
            print(f"# ptxas: {name[-60:]}: {used.group(0) if used else report}"
                  + (f"; SPILLS: {spills.group(0) if spills else report}"
                     if name in spilled else ""))
    return seconds


def _matern_rows(dev, lanes, gen):
    """(lanes, 8) params rows [variance, 0, lengthscale x 6] near a fit's values."""
    var = 0.5 + torch.rand(lanes, 1, generator=gen, device=dev)
    ls = 0.5 + 1.5 * torch.rand(lanes, 6, generator=gen, device=dev)
    return torch.cat([var, torch.zeros_like(var), ls], dim=1).contiguous()


# B1's and B2's mean signed error against float64 may be at most this
# multiple of the plain version's, in magnitude (ROADMAP C9: ex2.approx of a
# pre-scaled argument read +6.7e-9 of the variance in K where the plain
# version reads -2.9e-9, and +2e-7 in B2's d variance / d lengthscale where
# the plain version reads -8e-8; prof_b1_bias.py takes it apart)
BIAS_RATIO_LIMIT = 2.0


def _gate_bias(name, kernel, plain):
    """|kernel| <= BIAS_RATIO_LIMIT |plain| for a mean signed error."""
    ratio = abs(kernel) / abs(plain)
    print(f"# {name}: kernel mean {kernel:+.3e}, plain mean {plain:+.3e} (|kernel| / |plain| "
          f"{ratio:.2f}, limit {BIAS_RATIO_LIMIT:g}; C9)")
    if not ratio <= BIAS_RATIO_LIMIT:
        raise AssertionError(f"{name}: the kernel's mean error is biased against the plain "
                             f"version's")


def _b1_bias(X, p, got, want):
    """B1's and the plain version's mean signed (and mean absolute) error of K
    (B, N, N) against a float64 K on the card, over each lane's variance,
    gated by :func:`_gate_bias`."""
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck

    K64 = ck.k_build_plain(X.double(), X.double(), p.double(), "matern52", True)
    var = p[:, 0].double().reshape(-1, 1, 1)
    (s, a), (sp, ap) = [(float(e.mean()), float(e.abs().mean()))
                        for e in ((got.double() - K64) / var, (want.double() - K64) / var)]
    del K64
    print(f"# B1 K - K64 over the variance: kernel mean |.| {a:.3e}, plain mean |.| {ap:.3e}")
    _gate_bias("B1 K - K64 over the variance", s, sp)


def _b2_bias(dp, plain, want):
    """B2's and the plain version's mean signed relative error of the d
    variance and d lengthscale columns of ``dp (B, 8)`` against the float64
    ``want``, gated by :func:`_gate_bias`."""
    for name, cols in (("d variance", slice(0, 1)), ("d lengthscale", slice(2, 8))):
        k, p = (float(((g.double() - want) / want.abs())[:, cols].mean()) for g in (dp, plain))
        _gate_bias(f"B2 {name} - float64, relative", k, p)


def phase_kernels(dev, n: int = 4096, m: int = 1000):
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck
    from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl
    from gaussian_process_optimization_tpu_torch.ops import linalg

    gen = torch.Generator(device=dev).manual_seed(0)
    X = (4 * torch.rand(1, n, 6, generator=gen, device=dev) - 2).contiguous()
    C = (4 * torch.rand(1, m, 6, generator=gen, device=dev) - 2).contiguous()
    p5 = _matern_rows(dev, 5, gen)
    p1 = p5[:1].contiguous()
    rows = {}

    # B1: K build, fit shape (5 lanes of 4096 x 4096) and sweep shape (4096 x 1000)
    errs = []
    fit_tag, sweep_tag = f"5x{n}x{n}", f"{n}x{m}"
    for Z, p, tag in ((X, p5, fit_tag), (C, p1, sweep_tag)):
        got = ck.stationary_k_build(X, Z, p, "matern52", True)
        want = ck.k_build_plain(X, Z, p, "matern52", True)
        _close(f"B1 {tag}", got, want, rtol=2e-5, atol=2e-6)
        errs.append(_max_err(got, want))
        if Z is X:
            # what lets stationary_K return the kernel's output as it is
            if not torch.equal(got, got.mT):
                raise AssertionError("B1: K(X, X) is not bitwise symmetric")
            print(f"# B1 {tag}: K(X, X) equals its transpose bit for bit")
            _b1_bias(X, p, got, want)
        ms = _time_ms(lambda: ck.stationary_k_build(X, Z, p, "matern52", True))
        plain = _time_ms(lambda: ck.k_build_plain(X, Z, p, "matern52", True))
        inputs = (X, p) if Z is X else (X, Z, p)  # K(X, X) reads X once
        bound = _bound(_nbytes(*inputs, got), got.numel() * _k_flops(X.shape[-1]))
        del got, want
        print(f"# B1 stationary_k_build {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        if tag == fit_tag:
            rows["B1"] = {"ms": ms, "plain_ms": plain, "library_ms": None, **bound}
    rows["B1"]["max_abs_err"] = max(errs)

    # B2: K backward. Parameter gradients (what the fit asks for) at the fit
    # shape, against the plain version in float64 on the card; dX and dZ at the
    # sweep shape; two runs bitwise equal.
    G = (2 * torch.rand(5, n, n, generator=gen, device=dev) - 0.5).contiguous()
    dp, _, _ = ck.stationary_k_backward(X, X, p5, G, "matern52", True, False, False, True)
    dp2, _, _ = ck.stationary_k_backward(X, X, p5, G, "matern52", True, False, False, True)
    if not torch.equal(dp, dp2):
        raise AssertionError("B2: two runs differ (the backward must be deterministic)")
    want, _, _ = ck.k_backward_plain(X.double(), X.double(), p5.double(), G.double(),
                                     "matern52", True, False, False, True)
    _close(f"B2 dparams {fit_tag}", dp, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    errs = [_max_err(dp, want)]
    dp_plain, _, _ = ck.k_backward_plain(X, X, p5, G, "matern52", True, False, False, True)
    _b2_bias(dp, dp_plain, want)
    del want, dp_plain
    Gs = (2 * torch.rand(1, n, m, generator=gen, device=dev) - 0.5).contiguous()
    got = ck.stationary_k_backward(X, C, p1, Gs, "matern52", True)
    again = ck.stationary_k_backward(X, C, p1, Gs, "matern52", True)
    want = ck.k_backward_plain(X.double(), C.double(), p1.double(), Gs.double(),
                               "matern52", True)
    for name, a, b, w in zip(("dparams", "dX", "dZ"), got, again, want):
        if not torch.equal(a, b):
            raise AssertionError(f"B2 {name}: two runs differ")
        _close(f"B2 {name} {sweep_tag}", a, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
        errs.append(_max_err(a, w))
    del got, again, want
    ms = _time_ms(lambda: ck.stationary_k_backward(X, X, p5, G, "matern52", True,
                                                   False, False, True))
    plain = _time_ms(lambda: ck.k_backward_plain(X, X, p5, G, "matern52", True,
                                                 False, False, True))
    bound = _bound(_nbytes(X, p5, G, dp), G.numel() * _k_bwd_flops(X.shape[-1]))
    print(f"# B2 stationary_k_backward {fit_tag} (parameter gradients): "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']})")
    rows["B2"] = {"ms": ms, "plain_ms": plain, "library_ms": None, **bound,
                  "max_abs_err": max(errs)}
    # the dZ pass (a thread owns columns and walks down rows) and the dX variant
    # of the row pass, at the sweep shape
    for name, flags in (("dZ", (False, True, False)), ("parameter gradients + dX",
                                                       (True, False, True))):
        ms = _time_ms(lambda: ck.stationary_k_backward(X, C, p1, Gs, "matern52", True, *flags))
        print(f"# B2 stationary_k_backward {sweep_tag} ({name}): kernel {ms:.4f} ms")

    # What the model calls: stationary_K(kern, X) with lane-batched
    # hyperparameters, forward and backward through autograd, beside the
    # (K + K^T) / 2 pass that used to follow the kernel.
    from gaussian_process_optimization_tpu_torch.kernels.stationary import Matern52

    var = p5[:, 0].clone().requires_grad_(True)
    ls = p5[:, 2:8].clone().requires_grad_(True)
    kern = Matern52(input_dim=6, variance=var, lengthscale=ls)

    def forward_backward():
        torch.autograd.grad(ck.stationary_K(kern, X[0]), (var, ls), G)

    fwd = _time_ms(lambda: ck.stationary_K(kern, X[0]))
    both = _time_ms(forward_backward)
    K = ck.stationary_K(kern, X[0]).detach()
    sym = _time_ms(lambda: 0.5 * (K + K.mT))
    del K
    print(f"# stationary_K(kern, X) {fit_tag}: forward {fwd:.4f} ms, forward + backward "
          f"{both:.4f} ms (backward {both - fwd:.4f} ms); the pass it no longer runs, "
          f"0.5 * (K + K^T), {sym:.4f} ms forward and as much again on G in the backward")
    del G, Gs

    # The surrogates' new shapes (phase 8). The sparse bound's Kmn = K(Z, X) at
    # M = 256 inducing inputs by N = 50 000 points (D = 2, RBF): B1, and B2 with
    # every output, the inducing inputs' gradient being the row pass's dX; and
    # B1 on the MCMC surrogate's S = 10 lanes of K(X, X) at 4096 (RBF).
    rows["B1"]["max_abs_err"] = max(rows["B1"]["max_abs_err"],
                                    _surrogate_shapes(dev, X, gen))

    # B3 and B4 on blocks of nb = 256, each beside the one PyTorch call that
    # computes the same function, at both shapes its paths give it. Each lane
    # reads the lower triangle of one block (both functions use nothing else),
    # writes one whole block and does nb^3 / 3 flops.
    def block_row(name, kernel, plain, library, inp):
        ms, plain_ms, lib_ms = _time_ms(kernel), _time_ms(plain), _time_ms(library)
        nb = inp.shape[-1]
        nbytes = inp.shape[0] * (nb * (nb + 1) // 2 + nb * nb) * inp.element_size()
        bound = _bound(nbytes, inp.shape[0] * nb ** 3 / 3)
        print(f"# {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
              f"the kernel is {'faster' if ms < lib_ms else 'NOT faster'} than the library "
              f"call ({lib_ms / ms:.2f}x)")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **bound}

    # B3: triangular-inverse blocks: G = 80 (fit backward), 16 (posterior), 160
    # (the MCMC surrogate's 10-lane posterior), 10 (the Forrester example's
    # backward in phase 13). These inputs are well
    # conditioned; phase_tri_inv_on_main_path repeats the check on the diagonal
    # blocks of the main path's own Cholesky factor.
    errs = []
    for g in (80, 16, 160, 10):
        A = torch.randn(g, 256, 256, generator=gen, device=dev)
        L = torch.linalg.cholesky(A @ A.mT + 256 * torch.eye(256, device=dev)).contiguous()
        got = cl.tri_inv_blocks(L)
        want = cl.tri_inv_plain(L)
        if not torch.equal(got, cl.tri_inv_blocks(L)):
            raise AssertionError("B3: two launches differ")
        errs.append(_check_tri_inv(f"B3 G={g} (random SPD)", L, got, want)[0])
        eye = torch.eye(256, device=dev).expand(L.shape)
        row = block_row(f"B3 tri_inv_blocks G={g} nb=256", lambda: cl.tri_inv_blocks(L),
                        lambda: cl.tri_inv_plain(L),
                        lambda: torch.linalg.solve_triangular(L, eye, upper=False), L)
        rows.setdefault("B3", row)
    rows["B3"]["max_abs_err"] = max(errs)

    # B4: Cholesky blocks: G = 5 (a fit trial's 5 lanes), 1 (posterior)
    errs = []
    for g in (5, 1):
        A = torch.randn(g, 256, 256, generator=gen, device=dev)
        A = (A @ A.mT + 256 * torch.eye(256, device=dev)).contiguous()
        got = cl.cholesky_blocks(A)
        if not torch.equal(got, cl.cholesky_blocks(A)):
            raise AssertionError("B4: two launches differ")
        errs.append(_check_chol(f"B4 G={g} (random SPD)", A, got, cl.cholesky_plain(A)))
        row = block_row(f"B4 cholesky_blocks G={g} nb=256", lambda: cl.cholesky_blocks(A),
                        lambda: cl.cholesky_plain(A), lambda: torch.linalg.cholesky_ex(A), A)
        rows.setdefault("B4", row)
    bad = cl.cholesky_blocks(torch.stack([-torch.eye(256, device=dev), A[0]]))
    if not (bool(torch.isnan(bad[0]).all()) and torch.equal(bad[1], got[0])):
        raise AssertionError("B4: a -I lane must come out all NaN, and the lane beside "
                             "it equal to that lane factored alone")
    rows["B4"]["max_abs_err"] = max(errs)
    del A, got, bad

    # one full factorization, four ways, on the fit shape's Matern52 Gram
    K = ck.stationary_k_build(X, X, p5, "matern52", True)
    Ky = K + 0.05 * torch.eye(n, device=dev)
    del K
    old = config.cuda_chol_blocks
    times = {}
    try:
        for route, on in (("blocked_cholesky, B4 diagonal blocks", True),
                          ("blocked_cholesky, plain diagonal blocks", False)):
            config.cuda_chol_blocks = on
            Lb = linalg.blocked_cholesky(Ky)
            res = float((Lb.double() @ Lb.double().mT - Ky.double()).abs().max()
                        / Ky.abs().max())
            print(f"# {route}: max |LL^T - Ky| / max |Ky| {res:.3e} (limit n u = "
                  f"{n * 2.0 ** -24:.3e})")
            if not res <= n * 2.0 ** -24:
                raise AssertionError(f"{route}: the factor does not reproduce Ky")
            del Lb
            times[route] = _time_ms(lambda: linalg.blocked_cholesky(Ky), calls=5)
    finally:
        config.cuda_chol_blocks = old
    times["cholesky_ex (the ladder's route outside B5's gate)"] = _time_ms(
        lambda: torch.linalg.cholesky_ex(Ky), calls=5)

    # B5, the default ladder route: the same Ky, and the MCMC surrogate's 10
    # RBF lanes, against float64 and cholesky_ex
    X1 = (4 * torch.rand(1, n, 1, generator=gen, device=dev) - 2).contiguous()
    Ky10 = ck.stationary_k_build(X1, X1, _rbf_rows(dev, 10, gen), "rbf", False)
    Ky10.diagonal(dim1=-2, dim2=-1).add_(1e-2)
    errs = []
    for A, tag in ((Ky, f"5x{n}x{n} Matern52"), (Ky10, f"10x{n}x{n} RBF")):
        got = cl.chol_full(A)
        if not torch.equal(got, cl.chol_full(A)):
            raise AssertionError("B5: two calls differ")
        errs.append(_check_full(f"B5 chol_full {tag}", A, got, cl.chol_full_plain(A)))
        del got
        lanes = A.shape[0]
        row = {"ms": _time_ms(lambda: cl.chol_full(A), calls=5),
               "plain_ms": _time_ms(lambda: cl.chol_full_plain(A), calls=3),
               "library_ms": _time_ms(lambda: torch.linalg.cholesky_ex(A), calls=5),
               **_bound(2 * 4 * lanes * n * (n + 1) // 2, lanes * n ** 3 / 3)}
        print(f"# B5 chol_full {tag}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"cholesky_ex {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}): {100 * row['bound_ms'] / row['ms']:.1f}% of it")
        rows.setdefault("B5", row)
    rows["B5"]["max_abs_err"] = max(errs)
    times["B5 chol_full (the default ladder route)"] = rows["B5"]["ms"]
    for route, ms in times.items():
        print(f"# full factorization 5x{n}x{n} f32, {route}: {ms:.4f} ms")
    return rows


def _rbf_rows(dev, lanes, gen):
    """(lanes, 8) isotropic RBF params rows [variance, 0, lengthscale, 0...]."""
    row = torch.zeros(lanes, 8, device=dev)
    row[:, 0] = 0.5 + torch.rand(lanes, generator=gen, device=dev)
    row[:, 2] = 0.7 + torch.rand(lanes, generator=gen, device=dev)
    return row


def _surrogate_shapes(dev, X, gen) -> float:
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck

    errs = []
    Zi = (6 * torch.rand(1, 256, 2, generator=gen, device=dev) - 3).contiguous()
    p1 = _rbf_rows(dev, 1, gen)
    # Kmn at the sparse bound's N = 50 000 and at the SVGP's minibatch of 2048
    for n, what in ((50_000, "the sparse fit"), (2048, "an SVGP step")):
        Xs = (6 * torch.rand(1, n, 2, generator=gen, device=dev) - 3).contiguous()
        tag = f"256x{n}"
        got = ck.stationary_k_build(Zi, Xs, p1, "rbf", False)
        want = ck.k_build_plain(Zi, Xs, p1, "rbf", False)
        _close(f"B1 Kmn {tag}", got, want, rtol=2e-5, atol=2e-6)
        errs.append(_max_err(got, want))
        ms = _time_ms(lambda: ck.stationary_k_build(Zi, Xs, p1, "rbf", False))
        plain = _time_ms(lambda: ck.k_build_plain(Zi, Xs, p1, "rbf", False))
        bound = _bound(_nbytes(Zi, Xs, p1, got), got.numel() * _k_flops(2))
        print(f"# B1 stationary_k_build Kmn {tag} (D=2, RBF): kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        G = (2 * torch.rand(1, 256, n, generator=gen, device=dev) - 1).contiguous()
        out = ck.stationary_k_backward(Zi, Xs, p1, G, "rbf", False)
        ref = ck.k_backward_plain(Zi.double(), Xs.double(), p1.double(), G.double(), "rbf",
                                  False)
        for name, a, w in zip(("dparams", "dX (the inducing inputs' gradient)",
                               "dZ (the data's, off the path)"), out, ref):
            _close(f"B2 {name} Kmn {tag}", a, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
        ms = _time_ms(lambda: ck.stationary_k_backward(Zi, Xs, p1, G, "rbf", False, True,
                                                       False, True))
        plain = _time_ms(lambda: ck.k_backward_plain(Zi, Xs, p1, G, "rbf", False, True,
                                                     False, True))
        bound = _bound(_nbytes(Zi, Xs, p1, G, out[0], out[1]), G.numel() * _k_bwd_flops(2))
        print(f"# B2 stationary_k_backward Kmn {tag} (parameter gradients + dX, what {what} "
              f"asks for): kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        del got, want, G, out, ref

    # B1 on the MCMC surrogate's S = 10 lanes of K(X, X) at 4096 (RBF), and on
    # the Forrester example's fit in phase 13 (5 lanes of 512 x 512, D = 1),
    # there with B2's parameter gradients (what a fit asks for)
    X1 = torch.rand(1, EXAMPLES_KERNEL_N, 1, generator=gen, device=dev)
    p5 = _rbf_rows(dev, 5, gen)
    for Xk, p, tag, what in ((X, _rbf_rows(dev, 10, gen), "10x4096x4096",
                              "the MCMC surrogate's S lanes"),
                             (X1, p5, f"5x{EXAMPLES_KERNEL_N}x{EXAMPLES_KERNEL_N} D=1",
                              "the Forrester example's fit")):
        got = ck.stationary_k_build(Xk, Xk, p, "rbf", False)
        want = ck.k_build_plain(Xk, Xk, p, "rbf", False)
        _close(f"B1 {tag} (RBF)", got, want, rtol=2e-5, atol=2e-6)
        errs.append(_max_err(got, want))
        del want
        ms = _time_ms(lambda: ck.stationary_k_build(Xk, Xk, p, "rbf", False), calls=5)
        plain = _time_ms(lambda: ck.k_build_plain(Xk, Xk, p, "rbf", False), calls=5)
        bound = _bound(_nbytes(Xk, p, got), got.numel() * _k_flops(Xk.shape[-1]))
        print(f"# B1 stationary_k_build {tag} (RBF, {what}): kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        del got
    G = (torch.rand(5, EXAMPLES_KERNEL_N, EXAMPLES_KERNEL_N, generator=gen, device=dev)
         - 0.5).contiguous()
    flags = (False, False, True)  # need_dx, need_dz, need_params
    got = ck.stationary_k_backward(X1, X1, p5, G, "rbf", False, *flags)[0]
    want = ck.k_backward_plain(X1.double(), X1.double(), p5.double(), G.double(), "rbf",
                               False, *flags)[0]
    _close("B2 dparams 5x512x512 D=1", got, want, rtol=1e-4,
           atol=1e-4 * float(want.abs().max()))
    ms = _time_ms(lambda: ck.stationary_k_backward(X1, X1, p5, G, "rbf", False, *flags))
    plain = _time_ms(lambda: ck.k_backward_plain(X1, X1, p5, G, "rbf", False, *flags))
    bound = _bound(_nbytes(X1, p5, G, got), G.numel() * _k_bwd_flops(1))
    print(f"# B2 stationary_k_backward 5x{EXAMPLES_KERNEL_N}x{EXAMPLES_KERNEL_N} D=1 RBF, "
          f"parameter gradients (the Forrester example's fit): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); max "
          f"|kernel - plain| {_max_err(got, want):.3e}")
    return max(errs)


def _run_main_path(dev, seed):
    from gaussian_process_optimization_tpu_torch import workload

    X, Y = workload.bench_data()
    model = workload.make_model(X, Y, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, res = workload.fit(model, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    acq = workload.acquire(fitted, generator=gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return model, fitted, res, acq, t1 - t0, t2 - t1


# f32 against f64 gradient limits, about 10x the readings on an H100. At the
# fit's start (noise 0.05): 1.07e-5 and 1.14e-5 of max |g|. At the fitted point
# (noise ~1.3e-3, Ky far worse conditioned) each component is a difference of
# terms ~300x its size, so it is held against the larger term: reading 8.8e-4.
GRAD_START_LIMIT = 1e-4
GRAD_TERMS_LIMIT = 1e-2


def _neg_lml_grad_terms(model, packer=None):
    """Gradients of the -LML's two terms, 0.5 p logdet and 0.5 quad, with
    respect to the packed parameters (float64, (n,) each; by default the fit's
    packer); their sum is the fit objective's gradient. The forward is
    GPRegression._core's."""
    from gaussian_process_optimization_tpu_torch.models.gp import AssembleKy, ExactCore
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer

    packer = make_packer(model) if packer is None else packer
    u = packer.pack(model)[None].clone().requires_grad_(True)
    m = packer.unpack(u, reference=model)
    Yc = m._normalized_Y()
    K = m.kern.K(m.X)
    Ky = AssembleKy.apply(K, m._effective_noise(K.dtype), m.mask)
    logdet, quad, *_ = ExactCore.apply(Ky, Yc, m.jitter_hint, m.jitter_greedy)
    (g_logdet,) = torch.autograd.grad(0.5 * Yc.shape[-1] * logdet.sum(), u,
                                      retain_graph=True)
    (g_quad,) = torch.autograd.grad(0.5 * quad.sum(), u)
    return g_logdet[0].double(), g_quad[0].double()


def _print_fitted_gradient(fitted, fitted64, quiet=False) -> float:
    """Per-component f32 and f64 gradients at the fitted point, beside the f64
    logdet and quad terms; returns max |g32 - g64| / max(|logdet term|, |quad term|)."""
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
    from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves

    names = []
    for (path, t), fixed in zip(named_leaves(fitted), make_packer(fitted).fixed):
        if not fixed:
            names += [path] if t.numel() == 1 else [f"{path}[{k}]" for k in range(t.numel())]
    ld32, q32 = _neg_lml_grad_terms(fitted)
    ld64, q64 = _neg_lml_grad_terms(fitted64)
    g32, g64 = ld32 + q32, ld64 + q64
    terms = torch.maximum(ld64.abs(), q64.abs())
    err = (g32 - g64).abs()
    if quiet:
        return float((err / terms).max())
    m = fitted64
    Ky = m.kern.K(m.X) + m._effective_noise(torch.float64) * torch.eye(
        m.X.shape[0], dtype=torch.float64, device=m.X.device)
    eig = torch.linalg.eigvalsh(Ky)
    print(f"# gradient at the fitted point, f32 vs f64: rel {float(err.max() / g64.abs().max()):.2e} "
          f"of max |g64|, max |g32 - g64| / |term| {float((err / terms).max()):.2e}; "
          f"likelihood_variance {float(fitted.likelihood_variance):.6g}, "
          f"cond(Ky) {float(eig[-1] / eig[0]):.4g} (float64 eigenvalues)")
    print("#   component: g64, g32, logdet term, quad term, |g32-g64|/|g64|, |g32-g64|/|term|")
    for i, name in enumerate(names):
        print(f"#   {name}: {float(g64[i]):.6g}, {float(g32[i]):.6g}, {float(ld64[i]):.6g}, "
              f"{float(q64[i]):.6g}, {float(err[i] / g64[i].abs()):.2e}, "
              f"{float(err[i] / terms[i]):.2e}")
    return float((err / terms).max())


def phase_tri_inv_on_main_path(L, nb: int = 256):
    """B3 on the diagonal blocks of the main path's fitted Cholesky factor: the
    blocks tri_inv_lower gives it, at their real conditioning. The forward
    errors against a float64 inverse are readings; the residual is checked."""
    from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl

    blocks = torch.stack([L[i:i + nb, i:i + nb] for i in range(0, L.shape[-1], nb)])
    blocks = blocks.contiguous()
    got, want = cl.tri_inv_blocks(blocks), cl.tri_inv_plain(blocks)
    err, _, _ = _check_tri_inv(f"B3 G={blocks.shape[0]} (main-path L blocks)",
                               blocks, got, want)
    exact = cl.tri_inv_plain(blocks.double())
    scale = exact.abs().amax(dim=(-2, -1))
    fwd = ((got.double() - exact).abs().amax(dim=(-2, -1)) / scale).max()
    fwd_plain = ((want.double() - exact).abs().amax(dim=(-2, -1)) / scale).max()
    cond = (blocks.double().abs().sum(-1).amax(-1) * exact.abs().sum(-1).amax(-1)).max()
    print(f"# B3 main-path blocks: forward error max |X - X64| / max |X64| kernel "
          f"{float(fwd):.3e}, plain {float(fwd_plain):.3e}; max cond_inf {float(cond):.4g}")
    return err


def phase_main(dev):
    """The main path at the bench's sizes."""
    from gaussian_process_optimization_tpu_torch.bo.acquisitions import neg_ei
    from gaussian_process_optimization_tpu_torch.models.fit import make_objective
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
    from gaussian_process_optimization_tpu_torch.utils import profiling
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    counters = LAUNCHES
    *_, fit_cold, acq_cold = _run_main_path(dev, 1)
    print(f"# main path, first run: fit {fit_cold:.3f} s, acquisition {acq_cold:.3f} s")

    for name in counters.values():
        profiling.counters[name] = 0
    torch.cuda.reset_peak_memory_stats()
    model, fitted, res, acq, fit_s, acq_s = _run_main_path(dev, 0)
    launches = {k: profiling.counters[name] for k, name in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    post = acq.posterior
    print(f"# main path (N=4096, D=6, 5x30 fit, 1000 sweep, 5x50 anchors, f32): "
          f"fit {fit_s:.3f} s, acquisition {acq_s:.3f} s, peak memory {peak_gib:.2f} GiB")
    print(f"# fit num_ls per lane {res.num_ls.tolist()}, f per lane {res.f.tolist()}")
    print(f"# acquisition num_ls per anchor {acq.result.num_ls.tolist()}, "
          f"argmax {acq.x.tolist()}, -EI {float(acq.f):.6g}, fmin {float(acq.fmin):.6g}")
    print(f"# launches during the main path: {launches}")

    for name, t in (("lml", post.lml), ("variance", fitted.kern.variance),
                    ("lengthscale", fitted.kern.lengthscale),
                    ("likelihood_variance", fitted.likelihood_variance),
                    ("argmax", acq.x), ("ei", acq.f)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"main path: {name} is not finite: {t}")
    if not bool(post.ok):
        raise AssertionError("main path: posterior factorization failed")
    if acq.x.shape != (6,) or not bool(((acq.x >= -2.0) & (acq.x <= 2.0)).all()):
        raise AssertionError(f"main path: argmax {acq.x} outside the box")
    for k in ("B1", "B2", "B3", "B5"):  # B4 is off the main path (cuda_chol_blocks off)
        if launches[k] <= 0:
            raise AssertionError(f"main path: kernel {k} was never launched")

    # reference: float64 recomputation on the card (plain path, no kernels).
    # -LML and -EI at the fitted point; the gradient at the fit's start, where
    # it is far from zero. At the fitted point the gradient is the difference
    # of two nearly equal terms; each component is printed beside both terms.
    packer = make_packer(fitted)
    obj = make_objective(packer)
    f64m = tree_map(lambda t: t.double(), fitted)
    f32 = float(obj(packer.pack(fitted)[None], fitted)[0])
    f64 = float(obj(packer.pack(f64m)[None], f64m)[0])
    g32 = sum(_neg_lml_grad_terms(model))
    g64 = sum(_neg_lml_grad_terms(tree_map(lambda t: t.double(), model)))
    lml_rel = abs(f32 - f64) / abs(f64)
    grad_rel = float((g32 - g64).abs().max() / g64.abs().max())
    post64 = f64m.inference(precompute_inverse=True)
    ei64 = float(neg_ei(f64m, post64, acq.fmin.double(), acq.x.double()[None])[0])
    ei_rel = abs(float(acq.f) - ei64) / max(abs(ei64), 1e-12)
    print(f"# f32 vs f64: -LML at the fitted point {f32:.6f} vs {f64:.6f} (rel {lml_rel:.2e}), "
          f"gradient at the start rel {grad_rel:.2e} (max |g| {float(g64.abs().max()):.4g}), "
          f"-EI at the argmax {float(acq.f):.6g} vs {ei64:.6g} (rel {ei_rel:.2e})")
    fit_grad_rel = _print_fitted_gradient(fitted, f64m)
    if lml_rel > 1e-3 or grad_rel > GRAD_START_LIMIT or ei_rel > 1e-2:
        raise AssertionError("main path: the float32 run disagrees with float64")
    if fit_grad_rel > GRAD_TERMS_LIMIT:
        raise AssertionError("main path: the float32 gradient at the fitted point "
                             "disagrees with float64 beyond its terms' rounding")
    return launches, fitted, post, res


# The bf16x3 gradient gate: the float32 gradient of the main path's fit
# objective at its start against float64, max over the components of
# |g32 - g64| / |g64|. On the CPU through the plain versions (bf16 parts
# upcast and multiplied in float32, four threads) it reads 2.97e-6 at full
# precision, 1.42e-5 with grad_matmul_precision "high" and 7.74e-4 with one bf16
# pass (tests/test_torch_fit_options.py::test_grad_precision_reading_at_the_main_paths_start,
# printed with -m slow -s): the limit is ~10x the "high" reading, and the
# one-pass control must read past it.
GRAD_HIGH_LIMIT = 1.5e-4


class _TraceBackend:
    """A plotting backend that keeps what plot_optimizer draws (the card's
    machine has no matplotlib): a figure token, and (x, y) per plot call."""

    name = "trace-record"

    def __init__(self):
        self.lines = []

    def figure(self, rows=1, cols=1, figsize=None):
        return "figure", [None] * (rows * cols)

    def plot(self, ax, x, y, **kw):
        self.lines.append((np.asarray(x), np.asarray(y)))

    def __getattr__(self, name):
        return lambda *a, **k: None


def _launched(counters, fn):
    """``(fn(), seconds, launches)``: the host clock around ``fn`` ending in a
    synchronize, and each kernel's launches during it."""
    from gaussian_process_optimization_tpu_torch.utils import profiling

    for name in counters.values():
        profiling.counters[name] = 0
    t0 = _sync()
    out = fn()
    return out, _sync() - t0, {k: profiling.counters[name] for k, name in counters.items()}


def _start_gradient(model, precision):
    """The fit objective's gradient at the model's own parameters, with
    ExactCore's backward at ``precision`` (float64 (n,))."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.models.fit import make_objective
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer

    packer = make_packer(model)
    u = packer.pack(model)[None].clone().requires_grad_(True)
    old, config.grad_matmul_precision = config.grad_matmul_precision, precision
    try:
        (g,) = torch.autograd.grad(make_objective(packer)(u, model).sum(), u)
    finally:
        config.grad_matmul_precision = old
    return g[0].double()


def _backward_ms(model, starts, precision):
    """ExactCore's backward alone at the fit's 5 start lanes (tri_inv_lower,
    tri_tdot, Li^T t, alpha alpha^T), CUDA events around back-to-back calls."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.models.gp import AssembleKy, ExactCore
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer

    with torch.no_grad():
        m = make_packer(model).unpack(starts, reference=model)
        Yc = m._normalized_Y()
        Ky = AssembleKy.apply(m.kern.K(m.X), m._effective_noise(torch.float32), m.mask)
    Ky.requires_grad_(True)
    logdet, quad, *_ = ExactCore.apply(Ky, Yc, None, False)
    loss = (logdet + quad).sum()
    old, config.grad_matmul_precision = config.grad_matmul_precision, precision
    try:
        return _time_ms(lambda: torch.autograd.grad(loss, Ky, retain_graph=True),
                        calls=5, rounds=3)
    finally:
        config.grad_matmul_precision = old


def _matmul_modes(dev, n=4096):
    """One float32 n x n product under each of torch's float32 matmul
    precisions (the global pin's targets), its error against float64."""
    from gaussian_process_optimization_tpu_torch.config import matmul_precision

    gen = torch.Generator(device=dev).manual_seed(5)
    A = torch.randn(n, n, generator=gen, device=dev)
    B = torch.randn(n, n, generator=gen, device=dev)
    exact = A.double() @ B.double()
    out = {}
    try:
        for mode in ("highest", "high", "medium"):
            torch.set_float32_matmul_precision(mode)
            out[mode] = float((A @ B - exact).abs().max() / exact.abs().max())
    finally:
        torch.set_float32_matmul_precision(matmul_precision())
    return out


def phase_fit_options(dev, default_fitted, default_res):
    """The JAX package's fit options through the port at the main path's size
    (N=4096, D=6, ARD Matern52, 5 x 30, float32, the main path's starts), one
    refit each: the trace, the thread ladder, the nonmonotone search with the
    hold policy, and bf16x3 gradient matmuls; then the thread ladder on the
    thesis Ky with cuda_chol_blocks on."""
    import dataclasses

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.models.fit import Fitter, make_objective
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
    from gaussian_process_optimization_tpu_torch.utils import plotting_library as tpl
    from gaussian_process_optimization_tpu_torch.utils.normalizer import normalize_stats
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    counters = LAUNCHES
    X, Y = workload.bench_data()
    model = workload.make_model(X, Y, dtype=torch.float32, device=dev)
    kw = dict(num_restarts=workload.FIT_RESTARTS, maxiter=workload.FIT_STEPS, tol=0.0)
    starts = Fitter(model, **kw).draw_starts(model, torch.Generator(device=dev).manual_seed(0))
    packer = make_packer(model)
    obj = make_objective(packer)
    with torch.no_grad():
        f_start = obj(starts, model)

    def neg_lml(fitted):
        with torch.no_grad():
            return float(obj(packer.pack(fitted)[None], fitted)[0])

    total = dict.fromkeys(counters, 0)

    def refit(name, **options):
        fitter = Fitter(model, **kw, **options)
        (fitted, res), secs, launches = _launched(counters,
                                                  lambda: fitter.solve(model, starts))
        print(f"# fit options, {name}: fit {secs:.3f} s, f per lane {res.f.tolist()}, "
              f"num_ls {res.num_ls.tolist()}, num_iters {res.num_iters.tolist()}; "
              f"launches {launches}")
        _gate_launches(f"fit options, {name}", launches, ("B1", "B2", "B3"))
        if not bool(torch.isfinite(res.f).all()):
            raise AssertionError(f"fit options, {name}: f per lane {res.f.tolist()}")
        for k in total:
            total[k] += launches[k]
        return fitted, res

    print(f"# fit options, default (phase 4): f per lane {default_res.f.tolist()}, "
          f"num_ls {default_res.num_ls.tolist()}")

    # (a) the trace, and plot_optimizer on it
    _, res = refit("trace=True", trace=True)
    tr, k = res.trace.cpu(), res.num_iters.cpu()
    if tr.shape != (workload.FIT_RESTARTS, workload.FIT_STEPS + 1):
        raise AssertionError(f"fit options: trace of shape {tuple(tr.shape)}")
    for lane in range(tr.shape[0]):
        ran, rest = tr[lane, :int(k[lane]) + 1], tr[lane, int(k[lane]) + 1:]
        if not (bool(torch.isfinite(ran).all()) and bool(torch.isnan(rest).all())):
            raise AssertionError(f"fit options: lane {lane}'s trace {tr[lane].tolist()}")
        if float(ran.min()) != float(res.f[lane]):
            raise AssertionError(f"fit options: lane {lane}'s trace minimum {float(ran.min())} "
                                 f"is not its f {float(res.f[lane])}")
    saved, tpl._current = tpl._current, _TraceBackend()
    try:
        backend = tpl._current
        fig = tpl.plot_optimizer(res)
    finally:
        tpl._current = saved
    lengths = [len(x) for x, _ in backend.lines]
    print(f"# fit options, trace: lane 0 {[round(v, 3) for v in tr[0, :6].tolist()]} ...; "
          f"plot_optimizer drew {len(lengths)} lines of {lengths} points")
    if fig is None or lengths != [int(v) + 1 for v in k]:
        raise AssertionError(f"fit options: plot_optimizer gave {fig}, lines {lengths}")

    # (b) the thread ladder
    fitted, res = refit("thread_ladder=True", thread_ladder=True)
    print(f"# fit options, thread ladder: accepted rungs per lane {res.aux.tolist()}; -LML "
          f"at the fitted point {neg_lml(fitted):.6f} (default fit {neg_lml(default_fitted):.6f})")
    if res.aux is None or res.aux.shape != (workload.FIT_RESTARTS,):
        raise AssertionError(f"fit options: thread ladder aux {res.aux}")

    # (c) the nonmonotone search with the hold policy
    _, res = refit("nonmonotone_eta=0.5, grow_backtracked=1.0", nonmonotone_eta=0.5,
                   grow_backtracked=1.0)
    print(f"# fit options, nonmonotone + hold: num_ls per lane {res.num_ls.tolist()} "
          f"(default {default_res.num_ls.tolist()}); f at the start {f_start.tolist()}")
    if not bool((res.f <= f_start).all()):
        raise AssertionError("fit options: the nonmonotone fit returned an f above its start")

    # (d) bf16x3 gradient matmuls: the start gradient against float64, its
    # control, the backward's time, the global pin's modes, then the refit
    g64 = _start_gradient(tree_map(lambda t: t.double(), model), "highest")
    rel = {}
    for prec in ("highest", "high", "default"):
        g = _start_gradient(model, prec)
        rel[prec] = (float(((g - g64).abs() / g64.abs()).max()),
                     float((g - g64).abs().max() / g64.abs().max()))
    ms = {prec: _backward_ms(model, starts, prec) for prec in ("highest", "high")}
    print(f"# fit options, gradient at the start vs float64, max |g32 - g64| / |g64| over "
          f"components (and / max |g64|): highest {rel['highest'][0]:.3e} "
          f"({rel['highest'][1]:.3e}), high {rel['high'][0]:.3e} ({rel['high'][1]:.3e}), "
          f"limit {GRAD_HIGH_LIMIT:g}; control, one bf16 pass, {rel['default'][0]:.3e} "
          f"({rel['default'][1]:.3e})")
    print(f"# fit options, ExactCore backward at 5 x 4096: highest {ms['highest']:.3f} ms, "
          f"high {ms['high']:.3f} ms")
    print(f"# fit options, a 4096^2 float32 product against float64 under torch's float32 "
          f"matmul precision: {_matmul_modes(dev)}")
    if rel["high"][0] > GRAD_HIGH_LIMIT:
        raise AssertionError("fit options: the bf16x3 gradient is past its limit")
    if rel["default"][0] <= GRAD_HIGH_LIMIT:
        raise AssertionError("fit options: the one-pass control did not read past the limit")
    old, config.grad_matmul_precision = config.grad_matmul_precision, "high"
    try:
        fitted, _ = refit('grad_matmul_precision="high"')
    finally:
        config.grad_matmul_precision = old
    print(f"# fit options, bf16x3 gradients: -LML at the fitted point {neg_lml(fitted):.6f} "
          f"(default fit {neg_lml(default_fitted):.6f})")

    # the thread ladder on the thesis Ky, factored by blocked_cholesky with B4
    Xt, Yt = workload.thesis_data()
    bo = workload.thesis_bo(Xt, Yt, device=dev, dtype=torch.float32)
    gm = bo.model
    steps, gm.max_iters = gm.max_iters, 0
    gm.updateModel(bo.space.unzip_inputs(bo.X), np.asarray(normalize_stats(bo.Y)))
    gm.max_iters = steps
    tmodel = dataclasses.replace(gm.model, jitter_hint=torch.zeros((), device=dev))
    fitter = Fitter(tmodel, num_restarts=workload.FIT_RESTARTS, maxiter=steps,
                    fix=("likelihood_variance",), thread_ladder=True)
    old, config.cuda_chol_blocks = config.cuda_chol_blocks, True
    try:
        (_, res), secs, launches = _launched(counters, lambda: fitter(
            tmodel, torch.Generator(device=dev).manual_seed(0)))
    finally:
        config.cuda_chol_blocks = old
    print(f"# fit options, thread ladder on the thesis Ky (cuda_chol_blocks on): fit "
          f"{secs:.3f} s, accepted rungs per lane {res.aux.tolist()}, f per lane "
          f"{res.f.tolist()}, num_ls {res.num_ls.tolist()}; launches {launches}")
    _gate_launches("fit options, thesis thread ladder", launches, ("B3", "B4"))
    if not bool(torch.isfinite(res.f).all()):
        raise AssertionError("fit options: the thesis thread-ladder fit is not finite")
    for k in total:
        total[k] += launches[k]
    return total


def phase_calls(dev, fitted):
    """4c: the JAX package's call forms through the port at the main path's size
    (N=4096, D=6, ARD Matern52, float32), on phase 4's fitted model. (a) EI's
    argmax by ``AcquisitionOptimizer.optimize(f=, f_df=, acquisition=)`` equals
    ``acq.optimize()``'s bit for bit (two optimizers of the same seed), and
    ``optimize(f=)`` without the acquisition takes the host path; (b)
    ``make_svgp_train_step(optimizer=...)`` at phase 9's SVGP setting: the default
    factory's 3 steps equal Adam at optax's settings bit for bit, and an SGD
    factory's first step is u0 - lr * grad; (c) ``ensemble_sample(init=...)`` on
    the ES representers' log-density at phase 8's size equals the chain of the
    same draws whose initial walkers are ``init``; (d) one
    ``suggest_next_locations`` of a ``BO`` built with ``normalization_type="maxmin"``
    equals one built with ``"stats"``. Returns each kernel's launches in the
    phase."""
    import dataclasses

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.bo.acquisitions import AcquisitionEI
    from gaussian_process_optimization_tpu_torch.bo.bo_loop import BO
    from gaussian_process_optimization_tpu_torch.bo.entropy_search import (
        AcquisitionEntropySearchEPMGP)
    from gaussian_process_optimization_tpu_torch.bo.evaluators import Sequential
    from gaussian_process_optimization_tpu_torch.bo.mcmc_sampler import (ensemble_draws,
                                                                         ensemble_sample)
    from gaussian_process_optimization_tpu_torch.bo.optimizer import AcquisitionOptimizer
    from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace, bounds_to_space
    from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
    from gaussian_process_optimization_tpu_torch.models.svgp import make_svgp_train_step

    t_phase = _now()
    d = fitted.X.shape[1]
    space = DesignSpace(bounds_to_space([workload.BOX] * d))
    total = dict.fromkeys(LAUNCHES, 0)

    def counted(name, fn, keys):
        _zero_counts()
        t0 = _sync()
        out = fn()
        secs = _sync() - t0
        launches = _read_counts()
        _gate_launches(f"calls, {name}", launches, keys)
        for k in total:
            total[k] += launches[k]
        return out, secs, launches

    # (a) the optimizer's call forms on EI
    def ei(seed):
        surrogate = GPModel.from_fitted(fitted)
        opt = AcquisitionOptimizer(space, model=surrogate, seed=seed)
        return AcquisitionEI(surrogate, space, opt)

    def by_forms():
        acq = ei(0)
        return acq.optimizer.optimize(f=acq.acquisition_function,
                                      f_df=acq.acquisition_function_withGradients,
                                      acquisition=acq)

    (xa, fa), secs_a, la = counted("acq.optimize()", lambda: ei(0).optimize(), ("B1", "B3"))
    (xb, fb), secs_b, lb = counted("optimize(f=, f_df=, acquisition=)", by_forms, ("B1", "B3"))
    print(f"# calls (a), EI on phase 4's fitted model: acq.optimize() {secs_a:.3f} s, launches "
          f"{la}; optimize(f=, f_df=, acquisition=) {secs_b:.3f} s, launches {lb}; x "
          f"{xb[0].tolist()}, -EI {float(fb[0, 0]):.6g}; bit for bit "
          f"{bool(np.array_equal(xa, xb) and np.array_equal(fa, fb))}")
    if not (np.array_equal(xa, xb) and np.array_equal(fa, fb)):
        raise AssertionError("calls (a): optimize(f=, f_df=, acquisition=) is not acq.optimize()")
    host = ei(1)
    evals = []

    def f(x):
        evals.append(np.atleast_2d(x).shape[0])
        return host.acquisition_function(x)

    (xc, fc), secs_c, lc = counted("optimize(f=)", lambda: host.optimizer.optimize(f=f), ())
    _in_box("calls (a), host path", xc)
    print(f"# calls (a), optimize(f=) without the acquisition, the host path (scipy L-BFGS-B "
          f"on f alone from {host.optimizer.num_anchor} anchors): {secs_c:.3f} s, {len(evals)} "
          f"calls of f on {sum(evals)} rows, launches {lc}; x {xc[0].tolist()}, -EI "
          f"{float(fc[0, 0]):.6g} (device path {float(fa[0, 0]):.6g})")
    if not np.isfinite(fc).all():
        raise AssertionError("calls (a): the host path's value is not finite")

    # (b) make_svgp_train_step(optimizer=...) at phase 9's setting
    Xs, Ys = workload.sparse_data()
    model = workload.svgp_model(Xs, Ys)
    like = dict(dtype=model.Z.dtype, device=model.Z.device)
    batches = []
    for seed in range(3):
        rows = np.random.default_rng(seed).permutation(Xs.shape[0])[:workload.SVGP_BATCH]
        batches.append(tuple(torch.as_tensor(a[rows], **like) for a in (Xs, Ys)))
    lr = workload.SVGP_LR

    def steps(optimizer):
        _, u, _, step = make_svgp_train_step(optimizer, lr)(model)
        for Xb, Yb in batches:
            step(Xb, Yb)
        return u.detach()

    u_default, secs_d, ld = counted("SVGP default steps", lambda: steps(None), ("B1", "B2"))
    u_adam = steps(lambda p: torch.optim.Adam(p, lr=lr, betas=(0.9, 0.999), eps=1e-8))
    packer, u, opt, step = make_svgp_train_step(lambda p: torch.optim.SGD(p, lr=lr))(model)
    u0 = u.detach().clone()
    Xb, Yb = batches[0]
    u_grad = u0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(-packer.unpack(u_grad, reference=model).elbo(Xb, Yb), u_grad)
    want = u0.add(g, alpha=-lr)
    _, secs_s, ls = counted("SVGP SGD step", lambda: step(Xb, Yb), ("B1", "B2"))
    sgd_err = float((u.detach() - want).abs().max() / want.abs().max())
    print(f"# calls (b), make_svgp_train_step(optimizer=...) at phase 9's setting (N="
          f"{Xs.shape[0]}, M={model.Z.shape[0]}, batch {workload.SVGP_BATCH}, lr {lr:g}, "
          f"{model.Z.dtype}): the default factory's 3 steps "
          f"{secs_d:.3f} s, launches {ld}, bit for bit Adam at optax's settings "
          f"{bool(torch.equal(u_default, u_adam))}; {type(opt).__name__} factory, step 1 "
          f"{secs_s:.3f} s, launches {ls}, max |u1 - (u0 - lr grad)| / max |u1| {sgd_err:.3e} "
          f"(bit for bit {bool(torch.equal(u.detach(), want))})")
    if not torch.equal(u_default, u_adam):
        raise AssertionError("calls (b): the default factory is not Adam at optax's settings")
    if sgd_err > torch.finfo(want.dtype).eps:
        raise AssertionError("calls (b): the SGD factory's step is not u0 - lr * grad")
    for name, launches in (("default", ld), ("SGD", ls)):
        if launches["B2 dX"] - launches["B2 dZ"] <= 0:
            raise AssertionError(f"calls (b), {name}: B2's row pass was never launched")

    # (c) ensemble_sample(init=...) on the ES representers' log-density
    es = AcquisitionEntropySearchEPMGP(GPModel.from_fitted(fitted), space)
    log_p = es._log_p(*es.model.device_state())
    new = dict(dtype=fitted.X.dtype, device=fitted.X.device)
    lower, upper = (torch.full((d,), b, **new) for b in workload.BOX)
    walkers = es.num_representer_points + es.num_representer_points % 2
    draws = ensemble_draws(lower, upper, walkers, es.burn_in_steps,
                           torch.Generator(device=dev).manual_seed(3))
    init = lower + (upper - lower) * torch.rand(
        (walkers, d), generator=torch.Generator(device=dev).manual_seed(4), **new)
    (chain, _), secs_e, le = counted("ensemble_sample(init=)", lambda: ensemble_sample(
        log_p, lower, upper, walkers, es.burn_in_steps, None, 2.0, init, draws=draws), ("B1",))
    same, _ = ensemble_sample(log_p, lower, upper, walkers, es.burn_in_steps,
                              draws=dataclasses.replace(draws, init=init))
    print(f"# calls (c), ensemble_sample(init=...) on ES_EPMGP's log-density ({walkers} walkers, "
          f"{es.burn_in_steps} steps): {secs_e:.3f} s, launches {le}; the chain of the same "
          f"draws started at init, bit for bit {bool(torch.equal(chain, same))}; first step's "
          f"walkers moved from init {int((chain[0] != init).any(-1).sum())} of {walkers}")
    if not torch.equal(chain, same) or not bool(torch.isfinite(chain).all()):
        raise AssertionError("calls (c): ensemble_sample(init=) is not the chain from init")

    # (d) BO(normalization_type=...): the reference normalizes by stats either way
    X, Y = workload.bench_data()

    def suggest(normalization_type):
        gm = GPModel(max_iters=workload.FIT_STEPS, optimize_restarts=workload.FIT_RESTARTS,
                     ARD=True, device=dev, dtype=fitted.X.dtype)
        acq = AcquisitionEI(gm, space, AcquisitionOptimizer(space, model=gm))
        bo = BO(gm, space, None, acq, Sequential(acq), X, Y,
                normalization_type=normalization_type)
        return bo.suggest_next_locations()

    x_max, secs_m, lm = counted('BO normalization_type="maxmin"', lambda: suggest("maxmin"),
                                ("B1", "B2", "B3"))
    x_sta, secs_t, lt = counted('BO normalization_type="stats"', lambda: suggest("stats"),
                                ("B1", "B2", "B3"))
    _in_box("calls (d)", x_max)
    print(f'# calls (d), BO(normalization_type=...).suggest_next_locations() at N={X.shape[0]} '
          f'({workload.FIT_RESTARTS} x {workload.FIT_STEPS} fit, EI): "maxmin" {secs_m:.3f} s, '
          f'launches {lm}; "stats" {secs_t:.3f} s, '
          f'launches {lt}; batch {x_max.tolist()}, equal {bool(np.array_equal(x_max, x_sta))}')
    if not np.array_equal(x_max, x_sta):
        raise AssertionError("calls (d): maxmin and stats gave different batches")
    print(f"# calls: phase 4c took {_now() - t_phase:.1f} s; launches {total}")
    return total


# The f32 thesis -LML against float64 on the matrix the f32 factor does
# represent, L L^T: what is left is the rounding of the logdet and the half
# solve. About 10x the reading on an H100, rel 1.92e-6.
THESIS_OWN_LML_LIMIT = 2e-5


def _ky_of(model, jitter):
    """The posterior's Ky: the masked K + effective noise, plus the accepted
    jitter on the whole diagonal (``models/gp.py``, ``ops/linalg.jitchol_full``).
    The noise is floored as in float32 whatever the model's dtype, so a float64
    copy of a float32 model gives the same matrix in float64."""
    from gaussian_process_optimization_tpu_torch.ops import linalg

    with torch.no_grad():
        K = model.kern.K(model.X)
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        noise = model._effective_noise(torch.float32).to(K.dtype)
        return linalg.masked_gram(K + noise * eye, model.mask) + jitter.to(K.dtype) * eye


def _lml(L, Yc, num_data) -> float:
    """0.5 (-n log 2 pi - logdet - Yc^T Ky^-1 Yc) from Ky's Cholesky factor."""
    t = torch.linalg.solve_triangular(L, Yc, upper=False)
    return float(0.5 * (-float(num_data) * math.log(2 * math.pi)
                        - 2.0 * torch.log(torch.diagonal(L)).sum() - (t * t).sum()))


def phase_thesis(dev, nb: int = 256):
    """The thesis path at the bench's full size with the blocked ladder on."""
    import numpy as np

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl
    from gaussian_process_optimization_tpu_torch.utils import profiling
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    counters = LAUNCHES
    X, Y = workload.thesis_data()
    old = config.cuda_chol_blocks
    config.cuda_chol_blocks = True
    try:
        bo = workload.thesis_bo(X, Y, device=dev, dtype=torch.float32)
        for call in ("cold", "warm"):
            if call == "warm":  # fresh Y, as bench.py:208 does
                bo.Y = Y + 0.01 * np.random.default_rng(10).standard_normal(Y.shape)
            for name in counters.values():
                profiling.counters[name] = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            it = workload.thesis_iteration(bo)
            total = time.perf_counter() - t0
            launches = {k: profiling.counters[name] for k, name in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            post = bo.model.posterior
            print(f"# thesis {call} (N=4096, Gower, exact_feval, 5x30 fit, LP batch of 5, "
                  f"f32): suggest_next_locations {total:.3f} s = fit {it.fit_s:.3f} s + "
                  f"estimate_L {it.estimate_L_s:.3f} s + argmaxes "
                  f"{' + '.join(f'{a:.3f}' for a in it.argmax_s)} s; peak memory {peak:.2f} GiB")
            print(f"# thesis {call}: ladder per refit {bo.model.ladder[-1]}, posterior "
                  f"jitter {float(post.jitter):.4g}, -LML {-float(post.lml):.6f}; "
                  f"launches {launches}")
            print(f"# thesis {call}: batch {it.batch.tolist()}")
            batch = it.batch
            if batch.shape != (5, 6) or not np.all(np.isfinite(batch)):
                raise AssertionError(f"thesis: batch {batch}")
            if not set(np.unique(batch[:, 4:])) <= {0.0, 1.0, 2.0}:
                raise AssertionError(f"thesis: discrete values outside {{0, 1, 2}}: {batch}")
            if not np.all(np.abs(batch[:, :4]) <= 2.0):
                raise AssertionError(f"thesis: continuous values outside the box: {batch}")
            if len({tuple(r) for r in batch}) != 5:
                raise AssertionError(f"thesis: repeated rows in the batch: {batch}")
            if not bool(post.ok):
                raise AssertionError("thesis: posterior factorization failed")
            for k in ("B3", "B4"):  # the Gower K has no kernel
                if launches[k] <= 0:
                    raise AssertionError(f"thesis: kernel {k} was never launched")
        first, second = bo.model.ladder
        if second["fit_hint"] != first["posterior_rung"]:
            raise AssertionError(f"thesis: the warm fit started from rung "
                                 f"{second['fit_hint']}, not the cold posterior's "
                                 f"{first['posterior_rung']}")
    finally:
        config.cuda_chol_blocks = old

    # B4 on the diagonal blocks the fitted model's blocked factorization gave it:
    # Ky_kk - L_k,<k L_k,<k^T, from the posterior's own Ky and L
    model, post = bo.model.model, bo.model.posterior
    Ky = _ky_of(model, post.jitter)
    L = post.L
    blocks = torch.stack([Ky[k:k + nb, k:k + nb] - L[k:k + nb, :k] @ L[k:k + nb, :k].mT
                          for k in range(0, Ky.shape[-1], nb)]).contiguous()
    got, want = cl.cholesky_blocks(blocks), cl.cholesky_plain(blocks)
    err = _check_chol(f"B4 G={blocks.shape[0]} (thesis model's diagonal blocks)", blocks,
                      got, want, rtol=None)

    # The posterior's whole f32 factor is backward stable: L L^T is Ky up to
    # gamma_{n+1} |L| |L^T| (Higham, Thm 10.3), and the f32 -LML is that of
    # L L^T to the rounding of the logdet and the half solve.
    Yc = model._normalized_Y()
    n = Ky.shape[-1]
    bwd, limit = _chol_backward_error(Ky, L), _gamma(n + 1)
    lml_own = _lml(L.double(), Yc.double(), model.num_data)
    rel_own = abs(float(post.lml) - lml_own) / abs(lml_own)
    print(f"# thesis posterior factor: componentwise backward error |LL^T-Ky|/(|L||L^T|) "
          f"{bwd:.3e} (limit gamma_{n + 1} = {limit:.3e}); -LML f32 vs float64 on the "
          f"f32 factor's own L L^T: rel {rel_own:.3e} (limit {THESIS_OWN_LML_LIMIT:g})")
    if bwd > limit:
        raise AssertionError(f"thesis: the posterior factor's backward error {bwd:.3e} is "
                             f"above the bound {limit:.3e}")
    if rel_own > THESIS_OWN_LML_LIMIT:
        raise AssertionError("thesis: the float32 -LML disagrees with its own factor's")

    # A reading, not a check: the f32 -LML against float64 on the same Ky.
    # That Ky is conditioned beyond float32's 2^24, so the f32 -LML is mostly
    # rounding and no limit here would separate a fault from it (PERF.md;
    # benchmarks/prof_torch_thesis.py --numerics takes the gap apart).
    m64 = tree_map(lambda t: t.double(), model)
    lml64 = _lml(torch.linalg.cholesky(_ky_of(m64, post.jitter.double())),
                 m64._normalized_Y(), m64.num_data)
    print(f"# thesis: -LML f32 {-float(post.lml):.6f} vs f64 on the same Ky {-lml64:.6f} "
          f"(rel {abs(float(post.lml) - lml64) / abs(lml64):.3e}, a reading, not checked); "
          f"effective noise {float(model._effective_noise(torch.float32)):.4g} + jitter "
          f"{float(post.jitter):.4g}")
    return launches, err


def _objective_and_gradient(obj, packer, model):
    """The fit objective at the model's own parameters, and its gradient in
    the packed coordinates (float64 tensors)."""
    u = packer.pack(model)[None].clone().requires_grad_(True)
    f = obj(u, model)[0]
    (g,) = torch.autograd.grad(f, u)
    return float(f.detach()), g[0].double()


def _bench_cost(x):
    """A smooth, positive, non-constant evaluation cost with its gradient."""
    import numpy as np

    x = np.atleast_2d(x)
    c = 1.5 + 0.25 * x[:, :1] + 0.05 * x[:, 1:2] ** 2
    return c, np.hstack([np.full_like(c, 0.25), 0.1 * x[:, 1:2], np.zeros_like(x[:, 2:])])


# The protocol runs hartmann6 for 30 iterations; a refit at these sizes costs
# 12-21 s of host time on the card (every lane runs its 1000 L-BFGS steps), so
# the smoke stops after 10, beside branin's 12, and reads the stored runs at
# the same evaluation. Branin's 15 became 12 when phase 12 took the whole
# script past 1000 s of its 1200 on a slow host (a cut of depth).
HARTMANN6_ITERS = 10
BRANIN_ITERS = 12
LOOP_TIMEOUT_S = 900          # from their start, for both runs together

_LOOP_CHILD = """
import json, sys, time
sys.path.insert(0, {root!r})
from gaussian_process_optimization_tpu_torch import workload
t0 = time.perf_counter()
r = workload.regret_run({name!r}, seed=0, iters={iters})
model = r.bo.model
print("RESULT::" + json.dumps({{
    "total": time.perf_counter() - t0, "seconds": r.seconds, "fx_opt": r.fx_opt,
    "regret": r.regret, "evaluations": r.evaluations, "fit_failed": r.fit_failed,
    "device": model.device.type, "dtype": str(model.dtype),
    "rungs": sorted({{l["posterior_rung"] for l in model.ladder}}),
    "fit_evaluations": [f.evaluations for f in model._fitters.values()]}}))
"""


def start_loop_protocol():
    """Leg A: the canonical drive script, on the default device in float32. At
    N <= 35 a run is a host loop of small launches that leaves the card idle
    most of the time, so the two runs start in interpreters of their own, one
    host thread each, and go on beside phases 10-13; ``phase_loop_protocol``
    waits for them and holds their results. Their output goes to temporary
    files, so that no pipe fills while they run."""
    import tempfile

    runs = (("branin", BRANIN_ITERS), ("hartmann6", HARTMANN6_ITERS))
    started = []
    for name, iters in runs:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        child = subprocess.Popen(
            [sys.executable, "-c", _LOOP_CHILD.format(root=str(ROOT), name=name, iters=iters)],
            stdout=out, stderr=err, text=True, cwd=ROOT,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
        started.append((name, iters, child, out, err))
    print(f"# loop: branin ({BRANIN_ITERS} iterations) and hartmann6 ({HARTMANN6_ITERS}) "
          f"started beside phases 10-13, one host thread each")
    return started, time.perf_counter()


def _stop(started):
    for _, _, child, _, _ in started:
        if child.poll() is None:
            child.kill()
            child.wait()


def phase_loop_protocol(started, t_start):
    """Leg A's end: waits for the runs ``start_loop_protocol`` began, then holds
    each as the protocol asks."""
    stored = json.loads((ROOT / "benchmarks" / "regret_raw.json").read_text())["cpu_f64"]
    # the stored runs' largest regret after as many evaluations as this run makes
    limit = max(row[5 + HARTMANN6_ITERS - 1] for row in stored["hartmann6"])
    t_wait = time.perf_counter()
    try:
        for _, _, child, _, _ in started:
            child.wait(timeout=max(1.0, LOOP_TIMEOUT_S - (time.perf_counter() - t_start)))
    finally:
        _stop(started)
    t_end = time.perf_counter()
    print(f"# loop: the script waited {t_end - t_wait:.1f} s for the runs after phase 13, "
          f"{t_wait - t_start:.1f} s after it started them (each run's own time below)")
    outputs = []
    for _, _, _, out, err in started:
        out.seek(0)
        err.seek(0)
        outputs.append((out.read(), err.read()))
        out.close()
        err.close()
    runs = [(name, iters) for name, iters, _, _, _ in started]
    children = [child for _, _, child, _, _ in started]
    for (name, iters), child, (out, err) in zip(runs, children, outputs):
        lines = [line for line in out.splitlines() if line.startswith("RESULT::")]
        if child.returncode != 0 or not lines:
            raise AssertionError(f"loop {name}: the run failed (exit {child.returncode}):\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
        if "surrogate fit failed" in out:
            raise AssertionError(f"loop {name}: a surrogate fit failed")
        r = json.loads(lines[0][len("RESULT::"):])
        print(f"# loop {name} (latin 5, EI, exact_feval, {iters} iterations, {r['dtype']}, "
              f"{r['device']}; beside the other run and phases 10-13): {r['total']:.2f} s; "
              f"per iteration fit "
              f"{r['seconds']['fit'] / (iters + 1):.3f} s, acquisition "
              f"{r['seconds']['acquisition'] / iters:.3f} s; fx_opt {r['fx_opt']:.6f}, final "
              f"regret {r['regret'][-1]:.6f}; ladder rungs {r['rungs']}; LML trials of each "
              f"bucket's last fit {r['fit_evaluations']}; regret per evaluation "
              f"{[round(v, 6) for v in r['regret']]}")
        if r["device"] != "cuda" or r["dtype"] != "torch.float32":
            raise AssertionError(f"loop {name}: ran on {r['device']} in {r['dtype']}")
        if r["evaluations"] != 5 + iters or r["fit_failed"]:
            raise AssertionError(f"loop {name}: {r['evaluations']} evaluations of "
                                 f"{5 + iters}, fit failed: {r['fit_failed']}")
        if name == "branin" and not r["fx_opt"] < 1.0:
            raise AssertionError(f"loop branin: fx_opt {r['fx_opt']} is not under 1.0")
        if name == "hartmann6":
            print(f"# loop hartmann6: regret {r['regret'][-1]:.6f} after {r['evaluations']} "
                  f"evaluations against the largest of the JAX package's CPU float64 runs "
                  f"after as many, {limit:.6f} (10 seeds, benchmarks/regret_raw.json)")
            if not r["regret"][-1] <= limit:
                raise AssertionError("loop hartmann6: regret outside the stored range")


def phase_composite(dev):
    """Leg B: the composite path at the main path's size."""
    import numpy as np

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.models import fit as fit_mod
    from gaussian_process_optimization_tpu_torch.utils import profiling
    from gaussian_process_optimization_tpu_torch.utils.normalizer import normalize_stats
    from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves, tree_map

    counters = LAUNCHES
    X, Y = workload.bench_data()
    bo = workload.composite_bo(X, Y)
    gm = bo.model
    if gm.device.type != "cuda" or gm.dtype != torch.float32:
        raise AssertionError(f"composite: built on {gm.device} in {gm.dtype}")

    # the gradient at the fit's start, f32 against f64, every free leaf (both
    # parts', the bounded noise, the mean function's constant)
    gm._create_model(bo.space.unzip_inputs(X), np.asarray(normalize_stats(Y)), max_points=4096)
    fitter = gm._fitter_for(4096)
    names = [p for (p, _), fx in zip(named_leaves(gm.model), fitter.packer.fixed) if not fx]
    _, g32 = _objective_and_gradient(fitter.objective, fitter.packer, gm.model)
    _, g64 = _objective_and_gradient(fitter.objective, fitter.packer,
                                     tree_map(lambda t: t.double(), gm.model))
    grad_rel = float((g32 - g64).abs().max() / g64.abs().max())
    print(f"# composite: free leaves {names}; -(LML + log prior) gradient at the fit's "
          f"start, f32 vs f64: rel {grad_rel:.2e} of max |g| {float(g64.abs().max()):.4g}")

    # every fit: B1 launches against LML trials
    fits = []
    real_solve = fit_mod.Fitter.solve

    def solve(self, model, starts):
        before = profiling.counters["b1.launches"]
        out = real_solve(self, model, starts)
        fits.append((self.evaluations, profiling.counters["b1.launches"] - before,
                     out[1].num_ls.tolist()))
        return out

    fit_mod.Fitter.solve = solve
    for name in counters.values():
        profiling.counters[name] = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        bo.run_optimization(max_iter=2, eps=-1)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        fit_mod.Fitter.solve = real_solve
    launches = {k: profiling.counters[name] for k, name in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, post = gm.model, gm.posterior
    print(f"# composite (N=4096 -> {len(bo.X)}, D=6, Matern52 ARD + RBF on input 0, Gamma "
          f"priors, constant mean, LCB, Sobol anchors, 5x30 fits, f32): run_optimization(2) "
          f"{total:.3f} s = fits {bo.seconds['fit']:.3f} s (3) + acquisitions "
          f"{bo.seconds['acquisition']:.3f} s (2); buckets {sorted(gm._fitters)}; peak memory "
          f"{peak:.2f} GiB")
    print(f"# composite: per fit (LML trials, B1 launches, num_ls per lane) {fits}; ladder "
          f"{gm.ladder}; launches {launches}")
    print(f"# composite: suggestions {bo.X[4096:].tolist()}, Y {bo.Y[4096:, 0].tolist()}; "
          f"fitted variances {[float(p.variance) for p in model.kern.parts]}, noise "
          f"{float(model.likelihood_variance):.4g}, mean constant "
          f"{float(model.mean_function.C):.4g}")
    if bo._fit_failed or not bool(post.ok) or len(fits) != 3:
        raise AssertionError("composite: a refit failed or did not run")
    if len(bo.X) != 4098 or int(model.num_data) != 4098 or model.X.shape[0] != 8192:
        raise AssertionError(f"composite: N is {len(bo.X)} in a bucket of {model.X.shape[0]}")
    for trials, b1, _ in fits:
        if b1 != 2 * trials or trials <= 0:
            raise AssertionError(f"composite: {b1} B1 launches in a fit of {trials} LML "
                                 "trials (two parts: twice as many)")
    for k in ("B1", "B2", "B3"):
        if launches[k] <= 0:
            raise AssertionError(f"composite: kernel {k} was never launched")
    new = bo.X[4096:]
    if new.shape != (2, 6) or not np.all(np.abs(new) <= 2.0) or np.allclose(new[0], new[1]):
        raise AssertionError(f"composite: suggestions {new}")

    # -(LML + log prior) at the fitted point, f32 against f64 on the card
    fitter = gm._fitter_for(8192)
    f32, _ = _objective_and_gradient(fitter.objective, fitter.packer, model)
    f64, _ = _objective_and_gradient(fitter.objective, fitter.packer,
                                     tree_map(lambda t: t.double(), model))
    plain = fit_mod.make_objective(fitter.packer)(fitter.packer.pack(model)[None], model)
    lml_rel = abs(f32 - f64) / abs(f64)
    print(f"# composite f32 vs f64: -(LML + log prior) at the fitted point {f32:.6f} vs "
          f"{f64:.6f} (rel {lml_rel:.2e}); the log prior's share {f32 - float(plain[0]):.6f}")
    if lml_rel > 1e-3 or grad_rel > GRAD_START_LIMIT:
        raise AssertionError("composite: the float32 run disagrees with float64")

    # the other evaluators and the host optimizer, on the fitted model (no refit)
    fitted = dict(kernel=model.kern, mean_function=model.mean_function,
                  noise_var=float(model.likelihood_variance), steps=0)
    calls = (("thompson_sampling batch of 5", dict(evaluator_type="thompson_sampling",
                                                   batch_size=5, de_duplication=True)),
             ("random batch of 5", dict(evaluator_type="random", batch_size=5,
                                        de_duplication=True)),
             ("lbfgs_host argmax of EI under a cost", dict(
                 acquisition_type="EI", acquisition_optimizer_type="lbfgs_host",
                 cost_withGradients=_bench_cost)))
    for label, kw in calls:
        other = workload.composite_bo(bo.X, bo.Y, **fitted, **kw)
        before = {k: profiling.counters[name] for k, name in counters.items()}
        t0 = time.perf_counter()
        batch = other.suggest_next_locations()
        seconds = time.perf_counter() - t0
        delta = {k: profiling.counters[name] - before[k] for k, name in counters.items()}
        print(f"# composite, {label}: suggest_next_locations {seconds:.3f} s (posterior "
              f"{other.fit_seconds:.3f} s), launches {delta}, batch {batch.tolist()}")
        rows = kw.get("batch_size", 1)
        if (batch.shape != (rows, 6) or not np.all(np.abs(batch) <= 2.0)
                or len({tuple(r) for r in batch}) != rows):
            raise AssertionError(f"composite, {label}: batch {batch}")
        if "host" in label and not other.acquisition.has_cost:
            raise AssertionError("composite: the host call's acquisition carries no cost")
    return launches


# each kernel's launch counter in the program's registry (utils/profiling.py)
LAUNCHES = {"B1": "b1.launches", "B2": "b2.launches", "B3": "b3.launches",
            "B4": "b4.launches", "B5": "b5.launches"}
# of B2's: the row passes that wrote dX, and the column (dZ) passes
LAUNCHES_B2 = {"B2 dX": "b2.launches_dx", "B2 dZ": "b2.launches_dz"}


def _zero_counts():
    from gaussian_process_optimization_tpu_torch.utils import profiling

    for name in (*LAUNCHES.values(), *LAUNCHES_B2.values()):
        profiling.counters[name] = 0


def _read_counts():
    from gaussian_process_optimization_tpu_torch.utils import profiling

    return {k: profiling.counters[name] for k, name in {**LAUNCHES, **LAUNCHES_B2}.items()}


def _in_box(name, x, lo=-2.0, hi=2.0):
    x = torch.as_tensor(x)
    if not bool(torch.isfinite(x).all()) or not bool(((x >= lo) & (x <= hi)).all()):
        raise AssertionError(f"{name}: suggestion {x.tolist()} outside the box")


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


# Phase 8's limits (stated with the leg that checks them)
MCMC_PREDICT_LIMIT = 1e-3     # per-sample means and stds, f32 vs f64, same samples
MCMC_EI_LIMIT = 1e-2          # -EI_MCMC at the argmax, f32 vs f64
LOGP_SUM_LIMIT = 1e-4         # |logsumexp(logP)| of EPMGP's p_min
LOGP_F32_LIMIT = 1e-3         # EPMGP logP, f32 vs f64 on the same mu and Sigma (absolute)
# the VarDTC bound, f32 vs f64 at the same parameters: Kmm's condition number
# (4e7) is above float32's 1 / eps, and the JAX package's own float32 bound at
# this configuration is 2.58e-4 from its float64 one, the port's 2.43e-4 (CPU,
# tests/test_torch_sparse.py::test_f32_bound_error_is_the_references)
SPARSE_BOUND_LIMIT = 1e-3
SPARSE_PREDICT_LIMIT = 0.05   # |prediction - truth| at 5 points after the fit
SPARSE_BO_STEPS = 200         # sparseGP's fit through BO, cut from GPyOpt's 1000 (depth)
# warped -LML at the fitted parameters, f32 vs f64 (relative), per model. The
# leg also reads it through the plain K on the card and on the CPU at the same
# leaves, and a control each limit must catch: the card's float32 -LML with
# what the warp reads (the targets, or the inputs) off by WARPED_CONTROL_SHIFT
# relative, a random sign per row. warpedGP's fitted Ky (variance 3.26, noise
# 2.0e-4, N = 4096) is past float32's 1 / eps, and its -LML (~ -8e2) is a small
# difference of terms ~1e4: the sound readings are 5.72e-4 through B1 / B2,
# 4.42e-3 through the plain K, 3.33e-3 on the CPU, and the control 1.79e-2,
# so its limit is 5e-3, under 1.5x the plain K's reading (B1's profile biased
# K before ROADMAP C9's repair, and the limit was 2e-2). input_warped_GP reads
# 6.72e-4, 6.66e-4 and 8.28e-6, its control 1.25e-1: the limit stays 1e-3.
# (NVIDIA H100 80GB HBM3, 700 W; the readings this script prints, PERF.md
# section 6.)
WARPED_LML_LIMIT = {"warpedGP": 5e-3, "input_warped_GP": 1e-3}
WARPED_CONTROL_SHIFT = 1e-2


# The MCMC leg's leapfrog step. GPyOpt's 0.1 is stable only while 0.1 times the
# square root of the potential's largest Hessian eigenvalue at the fitted point
# stays under 2, which on the bench's data holds to N ~ 300: the product reads
# 0.35, 1.57 and 6.18 at N = 64, 256 and 1024 (float64, CPU) and 12.6 at N =
# 4096 (float32, CPU), where every proposal is rejected, in the JAX package as
# in the port (both accept 0.00 at N = 1024). 0.005 puts it at 0.63; the other
# settings stay GPyOpt's.
MCMC_STEP = 0.005
# The chain's depth, cut from GPyOpt's burn-in of 100 and interval of 10 (200
# HMC steps, ~49 s on the card) to 50 and 5 (100 steps) to keep the script
# inside its time limit; the 10 samples stay, so the S lanes keep their width.
MCMC_BURNIN = 50
MCMC_INTERVAL = 5


def _leg_mcmc(dev, X, Y):
    """GP_MCMC with EI_MCMC at GPyOpt's defaults but the leapfrog step
    (``MCMC_STEP``) on the main data; then a local-penalization batch of 3 over
    LCB_MCMC on the same samples."""
    import numpy as np

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.bo.acquisitions import AcquisitionLP
    from gaussian_process_optimization_tpu_torch.bo.acquisitions_mcmc import (
        AcquisitionEI_MCMC, AcquisitionLCB_MCMC)
    from gaussian_process_optimization_tpu_torch.bo.evaluators import LocalPenalization
    from gaussian_process_optimization_tpu_torch.models.mcmc_bo_model import GPModel_MCMC
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    _zero_counts()
    bo = workload.surrogate_bo(X, Y, "GP_MCMC", "EI_MCMC", step_size=MCMC_STEP,
                               n_burnin=MCMC_BURNIN, subsample_interval=MCMC_INTERVAL)
    it = workload.surrogate_iteration(bo)
    launches = _read_counts()
    model = bo.model
    print(f"# surrogates, MCMC (N={len(X)}, D={X.shape[1]}, GP_MCMC + EI_MCMC, n_samples 10, "
          f"n_burnin {MCMC_BURNIN}, interval {MCMC_INTERVAL} (cut from 100 and 10: depth), "
          f"step {MCMC_STEP} (GPyOpt's 0.1 rejects every proposal "
          f"at this N), 20 leapfrog steps, {model.dtype} on "
          f"{model.device.type}): fit {it.seconds['fit']:.3f} s, HMC {it.seconds['hmc']:.3f} s "
          f"({MCMC_BURNIN + 10 * MCMC_INTERVAL} steps), S-lane posterior "
          f"{it.seconds['posterior']:.3f} s, argmax "
          f"{it.seconds['argmax']:.3f} s; accept rate {model.accept_rate:.3f}; launches "
          f"{launches}; suggestion {it.batch.tolist()}")
    if model.device.type != dev.type or model.dtype != torch.float32:
        raise AssertionError(f"MCMC: built on {model.device} in {model.dtype}")
    if not model.accept_rate > 0:
        raise AssertionError("MCMC: no HMC proposal was accepted")
    _in_box("MCMC", it.batch)
    for k in ("B1", "B2", "B3"):
        if launches[k] <= 0:
            raise AssertionError(f"MCMC: kernel {k} was never launched")

    # the same kept samples in float64 on the card
    m64 = GPModel_MCMC(device=dev, dtype=torch.float64, n_samples=model.n_samples)
    m64.set_samples(tree_map(lambda t: t.double(), model.model), model.hmc_samples)
    Xt = np.random.default_rng(1).uniform(-2, 2, (200, X.shape[1]))
    pred = [_rel(np.stack(a), np.stack(b)) for a, b in zip(model.predict(Xt), m64.predict(Xt))]
    ei32 = float(bo.acquisition._compute_acq(it.batch)[0, 0])
    ei64 = float(AcquisitionEI_MCMC(m64, bo.space)._compute_acq(it.batch)[0, 0])
    ei_rel = abs(ei32 - ei64) / max(abs(ei64), 1e-12)
    print(f"# surrogates, MCMC f32 vs f64 on the same samples: means rel {pred[0]:.2e}, stds "
          f"rel {pred[1]:.2e} (limit {MCMC_PREDICT_LIMIT:g}); EI_MCMC at the argmax "
          f"{ei32:.6g} vs {ei64:.6g} (rel {ei_rel:.2e}, limit {MCMC_EI_LIMIT:g})")
    if max(pred) > MCMC_PREDICT_LIMIT or ei_rel > MCMC_EI_LIMIT:
        raise AssertionError("MCMC: the float32 run disagrees with float64")
    del m64

    _zero_counts()
    opt = bo.acquisition_optimizer
    lp = AcquisitionLP(model, bo.space, opt, AcquisitionLCB_MCMC(model, bo.space, opt))
    evaluator = LocalPenalization(lp, 3)
    t0 = time.perf_counter()
    batch = evaluator.compute_batch()
    seconds = time.perf_counter() - t0
    lp_launches = _read_counts()
    print(f"# surrogates, MCMC: local-penalization batch of 3 over LCB_MCMC on the same "
          f"samples {seconds:.3f} s (estimate_L {evaluator.seconds['estimate_L']:.3f} s, "
          f"argmaxes {[round(a, 3) for a in evaluator.seconds['argmax']]} s); launches "
          f"{lp_launches}; batch {batch.tolist()}")
    _in_box("MCMC LP batch", batch)
    if batch.shape != (3, X.shape[1]) or len({tuple(r) for r in batch}) != 3:
        raise AssertionError(f"MCMC LP batch {batch}")
    return {k: launches[k] + lp_launches[k] for k in launches}


def _leg_entropy_search(fitted, post):
    """ES_EPMGP and ES on the main path's fitted model (no refit)."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.bo.epmgp import joint_min

    total = {}
    for name in ("ES_EPMGP", "ES"):
        _zero_counts()
        r = workload.entropy_search_argmax(fitted, name, posterior=post)
        launches = _read_counts()
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        print(f"# surrogates, {name} (main path's fitted model, 50 representers, 50 burn-in "
              f"steps, 1000-candidate sweep): representers {r.seconds['representers']:.3f} s, "
              f"argmax {r.seconds['argmax']:.3f} s; launches {launches}; argmax "
              f"{r.x.tolist()}, value {float(r.f[0, 0]):.6g}")
        _in_box(name, r.x)
        if name != "ES_EPMGP":
            continue
        Z, logP = r.acquisition._state[:2]
        lse = float(torch.logsumexp(logP.double(), 0))
        gp = fitted
        with torch.no_grad():
            mu, cov = gp._raw_predict(Z, full_cov=True, posterior=post)
            cov = cov + gp.likelihood_variance * torch.eye(Z.shape[0], device=cov.device)
            lp32 = joint_min(mu[:, 0], cov)
            lp64 = joint_min(mu[:, 0].double(), cov.double())
        err = float((lp32.double() - lp64).abs().max())
        print(f"# surrogates, ES_EPMGP: logsumexp(logP) {lse:.3e} (limit {LOGP_SUM_LIMIT:g}); "
              f"logP f32 vs f64 on the same mu and Sigma: max abs {err:.3e} (limit "
              f"{LOGP_F32_LIMIT:g})")
        if abs(lse) > LOGP_SUM_LIMIT or err > LOGP_F32_LIMIT:
            raise AssertionError("ES_EPMGP: p_min is not normalized or float32 disagrees")
    return total


def _leg_sparse(X, Y):
    """BASELINE.md configuration 4: the VarDTC bound at N = 50 000, D = 2,
    M = 256 (examples/large_scale_sparse.py), a 1-restart 50-step fit, 5
    predictions; then sparseGP through BayesianOptimization on the main data."""
    import dataclasses

    import numpy as np

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    Xs, Ys = workload.sparse_data()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    model = workload.sparse_model(Xs, Ys)
    with torch.no_grad():
        b32 = float(model.log_marginal_likelihood())
        b64 = float(tree_map(lambda t: t.double(), model).log_marginal_likelihood())
        others = {inf: float(dataclasses.replace(model, inference=inf).log_marginal_likelihood())
                  for inf in ("fitc", "dtc", "pep")}
    fitted, res, fit_s = workload.sparse_fit(model, steps=50)
    launches = _read_counts()
    with torch.no_grad():
        b_fit = float(fitted.log_marginal_likelihood())
        Xt = np.random.default_rng(0).uniform(-3, 3, size=(5, 2))
        mu, _ = fitted.predict(torch.as_tensor(Xt, dtype=fitted.X.dtype, device=fitted.X.device))
    err = np.abs(mu.cpu().numpy() - workload.sparse_truth(Xt)).max()
    peak = torch.cuda.max_memory_allocated() / 2**30
    rel = abs(b32 - b64) / abs(b64)
    # Kmm = K(Z, Z) passes one tensor as both arguments, so its backward runs
    # the row pass with dX and the column (dZ) pass; Kmn = K(Z, X) asks only
    # for the row pass with dX (X is data). The dX launches beyond the dZ ones
    # are Kmn's.
    kmn_rows = launches["B2 dX"] - launches["B2 dZ"]
    print(f"# surrogates, sparse (N=50000, D=2, M=256, RBF, noise 0.05, {model.X.dtype}): "
          f"VarDTC bound {b32:.3f} vs f64 {b64:.3f} (rel {rel:.2e}, limit "
          f"{SPARSE_BOUND_LIMIT:g}); FITC {others['fitc']:.3f}, DTC {others['dtc']:.3f}, PEP "
          f"{others['pep']:.3f}; fit (1 restart, 50 steps) {fit_s:.3f} s, {res.num_ls.tolist()} "
          f"line-search trials, bound {b32:.3f} -> {b_fit:.3f}; max |prediction - truth| at 5 "
          f"points {err:.4f} (limit {SPARSE_PREDICT_LIMIT:g}); peak memory {peak:.2f} GiB; "
          f"launches {launches}, of which Kmn {kmn_rows} row passes with dX at 256 x 50 000")
    if rel > SPARSE_BOUND_LIMIT:
        raise AssertionError("sparse: the float32 bound disagrees with float64")
    if not b_fit >= b32:
        raise AssertionError("sparse: the fit lowered the bound")
    if not err <= SPARSE_PREDICT_LIMIT:
        raise AssertionError("sparse: the predictions miss the truth")
    if launches["B1"] <= 0 or kmn_rows <= 0:
        raise AssertionError("sparse: B1, or B2's row pass at Kmn, was never launched")

    _zero_counts()
    it = workload.surrogate_iteration(workload.surrogate_bo(X, Y, "sparseGP", num_inducing=256,
                                                            max_iters=SPARSE_BO_STEPS))
    bo_launches = _read_counts()
    print(f"# surrogates, sparseGP + EI on the main data (M=256, 5 restarts x {SPARSE_BO_STEPS} "
          f"steps, cut from 1000: depth): fit "
          f"{it.seconds['fit']:.3f} s, argmax {it.seconds['argmax']:.3f} s; launches "
          f"{bo_launches}; suggestion {it.batch.tolist()}")
    _in_box("sparseGP", it.batch)
    return {k: launches[k] + bo_launches[k] for k in launches}


# The warped fits stop after this many L-BFGS steps (GPyOpt's 1000 otherwise):
# a cut of depth, not of width
WARPED_STEPS = 50


def _warp_input_moved(m, shift):
    """The warped model with what its warp reads (warpedGP: the targets,
    input_warped_GP: the inputs) off by ``shift`` relative, the sign random per
    row (seeded)."""
    import dataclasses

    field = "Y" if hasattr(m.warp, "fgrad_y") else "X"
    v = getattr(m.gp, field)
    gen = torch.Generator(device=v.device).manual_seed(0)
    sign = torch.randint(0, 2, (v.shape[0], 1), generator=gen, device=v.device) * 2 - 1
    return dataclasses.replace(m, gp=dataclasses.replace(
        m.gp, **{field: v * (1.0 + shift * sign.to(v.dtype))}))


def _leg_warped_rf(X, Y):
    """warpedGP and input_warped_GP on the main data; RF at N = 256 (host-only
    in both packages)."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    from gaussian_process_optimization_tpu_torch.config import config

    total, failed = {}, []
    for name in ("warpedGP", "input_warped_GP"):
        _zero_counts()
        bo = workload.surrogate_bo(X, Y, name, max_iters=WARPED_STEPS)
        it = workload.surrogate_iteration(bo)
        launches = _read_counts()
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        m = bo.model.model
        m64 = tree_map(lambda t: t.double(), m)
        with torch.no_grad():
            l32 = float(m.log_marginal_likelihood())
            l64 = float(m64.log_marginal_likelihood())
            c32 = float(tree_map(lambda t: t.cpu(), m).log_marginal_likelihood())
            c64 = float(tree_map(lambda t: t.cpu(), m64).log_marginal_likelihood())
            control = float(_warp_input_moved(m, WARPED_CONTROL_SHIFT).log_marginal_likelihood())
            gz = m._warped_gp() if hasattr(m.warp, "fgrad_y") else m._warped()
            k32 = gz.kern.K(gz.X).double()
            config.use_cuda_kernels = False
            try:
                p32 = float(m.log_marginal_likelihood())
                kp32 = gz.kern.K(gz.X).double()
            finally:
                config.use_cuda_kernels = "auto"
            g64 = tree_map(lambda t: t.double(), gz)
            k64 = g64.kern.K(g64.X)
            var = float(gz.kern.variance.max())
            k_err = [(float((k - k64).abs().mean()) / var, float((k - k64).mean()) / var)
                     for k in (k32, kp32)]
            del gz, g64, k32, kp32, k64
        limit = WARPED_LML_LIMIT[name]
        rel, rel_cpu = abs(l32 - l64) / abs(l64), abs(c32 - c64) / abs(c64)
        rel_control = abs(control - l64) / abs(l64)
        gp = m.gp
        print(f"# surrogates, {name} + EI on the main data ({WARPED_STEPS} L-BFGS steps of 5 "
              f"restarts, cut from 1000): fit {it.seconds['fit']:.3f} s, argmax (host path) "
              f"{it.seconds['argmax']:.3f} s; -LML f32 {-l32:.4f} vs f64 {-l64:.4f} (rel "
              f"{rel:.2e}, limit {limit:g}); launches {launches}; suggestion "
              f"{it.batch.tolist()}")
        print(f"# surrogates, {name} at the card's fitted point (kernel variance "
              f"{float(gp.kern.variance.max()):.6g}, noise {float(gp.likelihood_variance):.6g}): "
              f"-LML on the CPU f32 {-c32:.4f} vs f64 {-c64:.4f} (rel {rel_cpu:.2e}); card f32 "
              f"vs CPU f32 rel {abs(l32 - c32) / abs(c64):.2e}; card f32 with the plain K "
              f"(no B1 / B2) {-p32:.4f} (rel {abs(p32 - l64) / abs(l64):.2e}); control, the warp's "
              f"{'targets' if hasattr(m.warp, 'fgrad_y') else 'inputs'} off by "
              f"{WARPED_CONTROL_SHIFT:g}: -LML f32 {-control:.4f} (rel {rel_control:.2e} from "
              f"f64, must exceed the limit)")
        print(f"# surrogates, {name}: K at the fitted point against float64, mean |dK| / "
              f"variance (mean dK / variance): B1 {k_err[0][0]:.3e} ({k_err[0][1]:.2e}), plain "
              f"{k_err[1][0]:.3e} ({k_err[1][1]:.2e})")
        _in_box(name, it.batch)
        if rel > limit:
            failed.append(f"{name}: the float32 LML disagrees with float64")
        if rel_control <= limit:
            failed.append(f"{name}: the limit does not catch the control")
    if failed:
        raise AssertionError("; ".join(failed))
    it = workload.surrogate_iteration(workload.surrogate_bo(X[:256], Y[:256], "RF"))
    print(f"# surrogates, RF + EI at N=256 (host): fit {it.seconds['fit']:.3f} s, argmax "
          f"{it.seconds['argmax']:.3f} s; suggestion {it.batch.tolist()}")
    _in_box("RF", it.batch)
    return total


def phase_surrogates(dev, fitted, post):
    """Phase 8: GPyOpt's other surrogates and acquisitions at full width, float32
    on the card, through their own entry points with no device given. Each leg
    zeroes the launch counts just before it and reads them just after; the sum
    is returned."""
    from gaussian_process_optimization_tpu_torch import workload

    X, Y = workload.bench_data()
    t0 = time.perf_counter()
    legs = [_leg_mcmc(dev, X, Y), _leg_entropy_search(fitted, post), _leg_sparse(X, Y),
            _leg_warped_rf(X, Y)]
    total = {k: sum(leg.get(k, 0) for leg in legs) for k in legs[0]}
    print(f"# surrogates: phase 8 took {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


# Phase 9's limits (stated with the leg that checks them)
# SVGP, BASELINE.md configuration 4: the minibatch ELBO, float32 against
# float64, on one fixed batch of 2048 rows. Kmm's condition number (~4e7) is
# past float32's 1 / eps, and the whitened mean passes through its factor.
# The gate is at workload.svgp_probe's leaves, a point both packages can read
# with the same inputs: there the JAX package's own float32 ELBO is 2.75e-3
# from its float64 one and the port's 4.09e-3 (CPU, tests/test_torch_svgp.py::
# test_f32_elbo_error_is_the_references), and the limit is twice the JAX
# package's, the rule of that test. Its control, Z off by
# SVGP_PROBE_CONTROL_SHIFT relative with a random sign per entry, reads
# 5.24e-2 on the CPU and must exceed the limit. The fitted leaves differ
# between the packages (other minibatch draws), so the fitted point has only
# a coarse bound: the JAX package's float32 error at its own fitted point of
# this configuration reads 3.85e-2 (CPU, test_f32_elbo_error_at_the_fitted_
# point_is_the_references), and the control there, Z off by
# SVGP_CONTROL_SHIFT, must exceed that bound.
SVGP_PROBE_LIMIT = 5.5e-3
SVGP_PROBE_CONTROL_SHIFT = 1e-1
SVGP_ELBO_LIMIT = 5e-2
SVGP_CONTROL_SHIFT = 1e-2
SVGP_PREDICT_LIMIT = 0.05     # |prediction - truth| at 5 points after the 300 steps
CLASSIFY_ACCURACY = 0.8       # training accuracy of the classifiers
# an evidence "falls" when it drops by more than this, relative: below it is
# float32's rounding of an evidence of ~1e3
EVIDENCE_SLACK = 1e-5
# dense EP's float32 evidence against float64 at the leg's fitted point, EP
# from zero sites in each dtype: 10x the JAX package's own float32 reading
# there on the CPU (tests/test_torch_ep_cancellation.py::
# test_jax_f32_evidence_at_the_cards_ep_fit), at most 1e-3
EP_JAX_F32 = 2.291e-04
EP_EVIDENCE_LIMIT = min(1e-3, 10 * EP_JAX_F32)
SEQUENTIAL_EP_N = 256         # sequential EP's eager rank-1 loop, at this N only
POOL_ROWS = 10_000
# the CLI run's refits stop after this many L-BFGS steps (GPyOpt's 1000
# otherwise, a refit of 13-20 s at N <= 7 on the card: ROADMAP C1): a cut of
# depth
CLI_FIT_STEPS = 100


def _sync():
    torch.cuda.synchronize()
    return time.perf_counter()


def _gate_launches(leg, launches, keys=("B1", "B2")):
    for k in keys:
        if launches[k] <= 0:
            raise AssertionError(f"{leg}: kernel {k} was never launched")


def _stage_swaps(name, measure, measure_cpu, keys, configs=None):
    """The float32 readings of ``measure`` with one stage at a time on the
    host's CPU in float32 (K build, ladder Cholesky, triangular solves;
    ``prof_stages``; ``configs``, by default all of ``prof_stages.CONFIGS``),
    and of ``measure_cpu``, the model on the CPU entirely; each with the rungs
    its ladder settled on (ROADMAP C10, C11, C13)."""
    from gaussian_process_optimization_tpu_torch import prof_stages

    t0 = _now()
    rows = prof_stages.readings(measure, configs or prof_stages.CONFIGS) + prof_stages.readings(
        measure_cpu, (("CPU entirely", ()),))
    print(f"# {name}, stage swaps ({_now() - t0:.1f} s): "
          f"{prof_stages.format_readings(rows, keys)}")
    return rows


def _leg_svgp():
    """BASELINE.md configuration 4's SVGP leg (examples/large_scale_sparse.py:
    38-41): N = 50 000, D = 2, RBF, M = 256, noise 0.05, 300 Adam steps at batch
    2048 and learning rate 1e-2, float32 on the card."""
    import dataclasses

    import numpy as np

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    Xs, Ys = workload.sparse_data()
    torch.cuda.reset_peak_memory_stats()
    model = workload.svgp_model(Xs, Ys)
    _zero_counts()
    fitted, losses, secs = workload.svgp_fit(model, Xs, Ys)
    launches = _read_counts()
    rows = np.random.default_rng(0).permutation(Xs.shape[0])[:workload.SVGP_BATCH]
    like = dict(dtype=fitted.Z.dtype, device=fitted.Z.device)
    Xb, Yb = (torch.as_tensor(a[rows], **like) for a in (Xs, Ys))
    sign = torch.as_tensor(np.random.default_rng(1).choice([-1.0, 1.0], size=fitted.Z.shape),
                           **like)
    probe = workload.svgp_probe(model)
    with torch.no_grad():
        e32 = float(fitted.elbo(Xb, Yb))
        e64 = float(tree_map(lambda t: t.double(), fitted).elbo(Xb.double(), Yb.double()))
        ec = float(dataclasses.replace(fitted, Z=fitted.Z * (1 + SVGP_CONTROL_SHIFT * sign))
                   .elbo(Xb, Yb))
        p32 = float(probe.elbo(Xb, Yb))
        p64 = float(tree_map(lambda t: t.double(), probe).elbo(Xb.double(), Yb.double()))
        pc = float(dataclasses.replace(probe, Z=probe.Z * (1 + SVGP_PROBE_CONTROL_SHIFT * sign))
                   .elbo(Xb, Yb))
        Xt = np.random.default_rng(0).uniform(-3, 3, size=(5, 2))
        mu, _ = fitted.predict(Xt)
    err = float(np.abs(mu.cpu().numpy() - workload.sparse_truth(Xt)).max())
    rel, control = abs(e32 - e64) / abs(e64), abs(ec - e64) / abs(e64)
    probe_rel, probe_control = abs(p32 - p64) / abs(p64), abs(pc - p64) / abs(p64)
    kmn_rows = launches["B2 dX"] - launches["B2 dZ"]
    print(f"# approximate, SVGP (N=50000, D=2, RBF, M=256, batch 2048, 300 Adam steps, lr "
          f"1e-2, {fitted.Z.dtype}): {secs:.3f} s ({1e3 * secs / len(losses):.2f} ms a step); "
          f"-ELBO {losses[0]:.1f} -> {losses[-1]:.1f}; max |prediction - truth| at 5 points "
          f"{err:.4f} (limit {SVGP_PREDICT_LIMIT:g}); ELBO f32 vs f64 at workload.svgp_probe's "
          f"leaves {p32:.2f} vs {p64:.2f} (rel {probe_rel:.3e}, limit {SVGP_PROBE_LIMIT:g}; "
          f"control, Z off by {SVGP_PROBE_CONTROL_SHIFT:g}: rel {probe_control:.3e}); at the "
          f"fitted leaves {e32:.2f} vs {e64:.2f} (rel {rel:.3e}, bound {SVGP_ELBO_LIMIT:g}; "
          f"control, Z off by {SVGP_CONTROL_SHIFT:g}: rel {control:.3e}); noise "
          f"{float(fitted.likelihood_variance):.4f}, lengthscale "
          f"{float(fitted.kern.lengthscale):.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}, of which "
          f"Kmn {kmn_rows} row passes with dX at 256 x 2048")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("SVGP: -ELBO after the last step is not below the first")
    if not err <= SVGP_PREDICT_LIMIT:
        raise AssertionError("SVGP: the predictions miss the truth")
    if not probe_rel <= SVGP_PROBE_LIMIT < probe_control:
        raise AssertionError("SVGP: the float32 ELBO at the probe disagrees with float64, or "
                             "the limit misses its control")
    if not rel <= SVGP_ELBO_LIMIT < control:
        raise AssertionError("SVGP: the float32 ELBO at the fitted leaves is past its coarse "
                             "bound, or the bound misses its control")
    _gate_launches("SVGP", launches)
    if kmn_rows <= 0:
        raise AssertionError("SVGP: B2's row pass at Kmn was never launched")
    return launches


def _accuracy(model, post):
    with torch.no_grad():
        p = model.predict(model.X, posterior=post)
    return float(((p >= 0.5) == (model.Y > 0)).double().mean())


def _alternated(name, model, post):
    """optimize(rounds=2, maxiter=30), one round at a time so that the
    evidence is read after each; returns (model, posterior, evidences, the EP
    run behind each as "sweeps / last sweep's mean squared site change", s)."""
    lmls, runs = [float(post.lml)], [f"{post.sweeps} / {post.site_change:.2e}"]
    t0 = _sync()
    for _ in range(2):
        model, _ = model.optimize(rounds=1, maxiter=30)
        post = model.inference()
        lmls.append(float(post.lml))
        runs.append(f"{post.sweeps} / {post.site_change:.2e}")
    secs = _sync() - t0
    if not all(math.isfinite(v) for v in lmls):
        raise AssertionError(f"{name}: the EP evidence is not finite: {lmls}")
    for a, b in zip(lmls, lmls[1:]):
        if b < a - EVIDENCE_SLACK * abs(a):
            raise AssertionError(f"{name}: the EP evidence fell over the rounds: {lmls}")
    return model, post, lmls, runs, secs


def _ep_rounds(X, labels):
    """EP to convergence, then two alternated rounds; the float32 evidence at
    the fitted point against float64 (EP from zero sites in each dtype).
    Returns (model, posterior, sweeps of the first EP, EP s, the rounds'
    evidences, their EP runs, optimize s, float64 evidence, rel)."""
    from gaussian_process_optimization_tpu_torch.models.classification import GPClassification
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    t0 = _sync()
    model = GPClassification.create(X, labels)
    post = model.inference()
    ep_s = _sync() - t0
    sweeps = post.sweeps
    model, post, lmls, runs, opt_s = _alternated("EP", model, post)
    with torch.no_grad():
        e64 = float(tree_map(lambda t: t.double(), model).inference().lml)
    return (model, post, sweeps, ep_s, lmls, runs, opt_s, e64,
            abs(lmls[-1] - e64) / abs(e64))


def _ep_f32_factor_evidence(model, post, kernels=False):
    """The EP gate's control: the evidence at ``post``'s sites with B = I +
    S^1/2 K S^1/2 factored in float32 by the jitter ladder, where
    ``models/ep`` factors it in float64: through ``cholesky_ex`` (the kernels
    off for that call alone), or with ``kernels`` on its default route (B5 at
    N = 4096)."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.models import ep
    from gaussian_process_optimization_tpu_torch.models.likelihoods import Bernoulli
    from gaussian_process_optimization_tpu_torch.ops import linalg

    with torch.no_grad():
        K = model.kern.K(model.X)
        tau, nu = post.tau_site.to(K.dtype), post.nu_site.to(K.dtype)
        sW = torch.sqrt(torch.clamp(tau, min=ep._TAU_EPS))
        old = config.use_cuda_kernels
        config.use_cuda_kernels = "auto" if kernels else False
        try:
            L, _, _ = linalg.jitchol(ep._eye(K.shape[-1], K) + sW[:, None] * K * sW[None, :])
        finally:
            config.use_cuda_kernels = old
        mu, sigma2, L, _ = ep._posterior_from_factor(K, tau, nu, L)
        return float(ep._dense_ep_lml(Bernoulli(), model.Y, tau, nu, mu, sigma2, L, 1.0))


def _leg_ep(X, labels):
    """Dense EP classification at N = 4096, D = 6 (parallel sweeps to
    convergence, then two alternated rounds), through the kernels and through
    the plain route; sequential EP at N = 256."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.models.classification import GPClassification
    from gaussian_process_optimization_tpu_torch.models.ep import _dense_posterior_from_sites
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    _zero_counts()
    model, post, sweeps, ep_s, lmls, runs, opt_s, e64, rel = _ep_rounds(X, labels)
    launches = _read_counts()
    with torch.no_grad():
        sig = [_dense_posterior_from_sites(m.kern.K(m.X), post.tau_site.to(m.X.dtype),
                                           post.nu_site.to(m.X.dtype))[1]
               for m in (model, tree_map(lambda t: t.double(), model))]
        smin32, smin64 = (float(v.min()) for v in sig)
        del sig
    acc = _accuracy(model, post)
    config.use_cuda_kernels = False
    try:
        with torch.no_grad():
            e32_plain = float(model.inference().lml)
        plain = _ep_rounds(X, labels)
    finally:
        config.use_cuda_kernels = "auto"
    rel_plain = abs(e32_plain - e64) / abs(e64)
    rel_control = abs(_ep_f32_factor_evidence(model, post) - e64) / abs(e64)
    rel_b5 = abs(_ep_f32_factor_evidence(model, post, kernels=True) - e64) / abs(e64)
    small = GPClassification.create(X[:SEQUENTIAL_EP_N], labels[:SEQUENTIAL_EP_N],
                                    inference_mode="sequential")
    t0 = _sync()
    seq = small.inference()
    seq_s = _sync() - t0
    par = GPClassification.create(X[:SEQUENTIAL_EP_N], labels[:SEQUENTIAL_EP_N]).inference()
    print(f"# approximate, EP (N=4096, D=6, RBF, probit, parallel, f32): EP {ep_s:.3f} s "
          f"({sweeps} sweeps); min diag Sigma f32 {smin32:.4e} vs f64 {smin64:.4e} at the same "
          f"sites; optimize(rounds=2, maxiter=30) {opt_s:.3f} s, evidence {lmls}, each from EP "
          f"of sweeps / last site change {runs} (stop below 1e-6); at the fitted point "
          f"(variance {float(model.kern.variance):.6g}, lengthscale "
          f"{float(model.kern.lengthscale):.6g}) f32 {lmls[-1]:.4f} vs f64 {e64:.4f} (rel "
          f"{rel:.3e}, limit {EP_EVIDENCE_LIMIT:g}); training accuracy {acc:.4f} (limit > "
          f"{CLASSIFY_ACCURACY}); launches {launches}; sequential EP at N={SEQUENTIAL_EP_N}: "
          f"{seq_s:.3f} s ({seq.sweeps} sweeps of {SEQUENTIAL_EP_N} rank-1 updates), evidence "
          f"{float(seq.lml):.4f} vs parallel {float(par.lml):.4f}")
    pm = plain[0]
    print(f"# approximate, EP through the plain route (no B1 / B2 / B3): at the leg's fitted "
          f"point f32 {e32_plain:.4f} vs f64 {e64:.4f} (rel {rel_plain:.3e}, limit "
          f"{EP_EVIDENCE_LIMIT:g}); EP {plain[3]:.3f} s ({plain[2]} sweeps); optimize(rounds=2, "
          f"maxiter=30) {plain[6]:.3f} s, evidence {plain[4]}, each from EP of sweeps / last "
          f"site change {plain[5]}; at its own fitted point (variance "
          f"{float(pm.kern.variance):.6g}, lengthscale {float(pm.kern.lengthscale):.6g}) f32 "
          f"{plain[4][-1]:.4f} vs f64 {plain[7]:.4f} (rel {plain[8]:.3e}, a reading)")
    print(f"# approximate, EP's control: the same sites' float32 evidence with B factored in "
          f"float32 (cholesky_ex) {rel_control:.3e} from float64 (must exceed "
          f"{EP_EVIDENCE_LIMIT:g}); through the ladder's default route (B5) {rel_b5:.3e}, "
          f"a reading")
    if not acc > CLASSIFY_ACCURACY:
        raise AssertionError("EP: training accuracy too low")
    if not (math.isfinite(float(seq.lml)) and math.isfinite(smin32)):
        raise AssertionError("EP: sequential evidence or Sigma's diagonal not finite")
    for route, r in (("kernels", rel), ("plain route", rel_plain)):
        if not r <= EP_EVIDENCE_LIMIT:
            raise AssertionError(f"EP ({route}): the float32 evidence at the fitted point is "
                                 f"{r:.3e} from float64, past {EP_EVIDENCE_LIMIT:g}")
    if not rel_control > EP_EVIDENCE_LIMIT:
        raise AssertionError(f"EP: the control (B factored in float32) reads {rel_control:.3e}, "
                             f"not past {EP_EVIDENCE_LIMIT:g}: the gate cannot see the factor")
    _gate_launches("EP", launches, keys=("B1", "B2", "B3"))
    return launches


def _leg_epdtc(X, labels):
    """EPDTC classification at N = 4096, M = 256 (the same gates as EP's)."""
    from gaussian_process_optimization_tpu_torch.models.classification import (
        SparseGPClassification)

    _zero_counts()
    t0 = _sync()
    model = SparseGPClassification.create(X, labels, num_inducing=256)
    post = model.inference()
    ep_s = _sync() - t0
    sweeps = post.sweeps
    model, post, lmls, runs, opt_s = _alternated("EPDTC", model, post)
    launches = _read_counts()
    acc = _accuracy(model, post)
    print(f"# approximate, EPDTC (N=4096, D=6, M=256, RBF, probit, parallel, f32): EP "
          f"{ep_s:.3f} s ({sweeps} sweeps); optimize(rounds=2, maxiter=30) {opt_s:.3f} s, "
          f"evidence {lmls}, each from EP of sweeps / last site change {runs} (stop below "
          f"1e-6, cap {model.max_sweeps} sweeps); training accuracy {acc:.4f}; "
          f"launches {launches}")
    if not acc > CLASSIFY_ACCURACY:
        raise AssertionError("EPDTC: training accuracy too low")
    _gate_launches("EPDTC", launches)
    return launches


def _fit_leg(name, model, extra=""):
    """1 restart x 30 steps through models/fit.fit: the -LML falls and is
    finite; the float32 -LML against float64 at the fitted point printed, and
    float32 through the plain K (no B1 / B2), and the fitted leaves, exact in
    float32, for the CPU reading of the JAX package's float32 value there
    (tests/test_torch_laplace.py::test_f32_lml_error_at_the_cards_fitted_point)."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.models import fit as fit_module
    from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves, tree_map

    _zero_counts()
    with torch.no_grad():
        before = -float(model.log_marginal_likelihood())
    t0 = _sync()
    fitted, res = fit_module.fit(model, num_restarts=1, maxiter=30)
    fit_s = _sync() - t0
    launches = _read_counts()
    with torch.no_grad():
        after = -float(fitted.log_marginal_likelihood())
        after64 = -float(tree_map(lambda t: t.double(), fitted).log_marginal_likelihood())
        config.use_cuda_kernels = False
        try:
            plain = -float(fitted.log_marginal_likelihood())
        finally:
            config.use_cuda_kernels = "auto"
    rel, rel_plain = abs(after - after64) / abs(after64), abs(plain - after64) / abs(after64)
    leaves = {k: v.tolist() for k, v in named_leaves(fitted) if k not in ("X", "Y")}
    print(f"# approximate, {name} (N=4096, D=6, RBF, f32, 1 restart x 30 steps): fit "
          f"{fit_s:.3f} s, {res.num_ls.tolist()} line-search trials; -LML {before:.4f} -> "
          f"{after:.4f}; f32 vs f64 at the fitted point {after:.4f} vs {after64:.4f} (rel "
          f"{rel:.2e}), f32 through the plain K {plain:.4f} (rel {rel_plain:.2e})"
          f"{extra(fitted) if extra else ''}; launches {launches}; fitted leaves "
          f"{json.dumps(leaves)}")
    if not (math.isfinite(after) and after < before):
        raise AssertionError(f"{name}: the -LML did not fall, or is not finite")
    _gate_launches(name, launches)
    return launches


def _newton_steps(model):
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    with torch.no_grad():
        steps = int(model.inference().iterations)
        steps64 = int(tree_map(lambda t: t.double(), model).inference().iterations)
    return f"; Newton steps at the fitted point {steps} (float64 {steps64})"


def _leg_laplace(X, labels, outliers):
    """GPLaplace with Bernoulli on the labels and with a Student-t (deg_free
    4) on the targets with outliers."""
    from gaussian_process_optimization_tpu_torch.models.laplace import GPLaplace
    from gaussian_process_optimization_tpu_torch.models.likelihoods import StudentT

    out = []
    for name, targets, lik in (("Laplace, Bernoulli", labels, None),
                               ("Laplace, Student-t", outliers, StudentT.create(deg_free=4.0))):
        model = GPLaplace.create(X, targets, likelihood=lik)
        with torch.no_grad():
            start = int(model.inference().iterations)
        out.append(_fit_leg(f"{name} (Newton steps at the start {start})", model,
                            _newton_steps))
    return {k: sum(d[k] for d in out) for k in out[0]}


def _leg_tp(X, outliers):
    from gaussian_process_optimization_tpu_torch.models.tp import TPRegression

    return _fit_leg("TPRegression on the outlier targets (deg_free 5)",
                    TPRegression.create(X, outliers),
                    lambda m: f"; deg_free {float(m.deg_free):.3f}")


def _leg_pool():
    """An LP batch of 5 from a pool of 10 000 rows of the thesis space, on a
    thesis BO updated once inside the leg (N = 4096, Gower, 5 x 30 fit)."""
    import numpy as np

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.bo.designs import initial_design
    from gaussian_process_optimization_tpu_torch.bo.pool import suggest_from_pool

    bo = workload.thesis_bo(*workload.thesis_data())
    pool = initial_design("random", bo.space, POOL_ROWS, seed=0)
    _zero_counts()
    t0 = _sync()
    bo._update_model()
    fit_s = _sync() - t0
    idx, rows = suggest_from_pool(bo.acquisition, pool, bo.space,
                                  batch_size=workload.THESIS_BATCH)
    pool_s = _sync() - t0 - fit_s
    launches = _read_counts()
    t1 = time.perf_counter()
    Xm = bo.space.unzip_inputs(pool)
    unzip_s = time.perf_counter() - t1
    scorings = workload.THESIS_BATCH  # score_pool unzips the whole pool each time
    print(f"# approximate, pool (thesis BO, N=4096, LP batch of {workload.THESIS_BATCH} from "
          f"{POOL_ROWS} rows, f32): update {fit_s:.3f} s, pool batch {pool_s:.3f} s, of which "
          f"unzipping the pool {scorings} x {unzip_s:.3f} s ({scorings * unzip_s / pool_s:.0%}, "
          f"C6); picks {idx.tolist()}; launches {launches}")
    cont, disc = rows[:, :4], rows[:, 4:]
    feasible = (np.all((cont >= -2.0) & (cont <= 2.0)) and np.all(np.isin(disc, (0, 1, 2)))
                and np.all(bo.space.indicator_constraints(Xm[idx]) == 1))
    if len(set(idx.tolist())) != workload.THESIS_BATCH or not feasible:
        raise AssertionError(f"pool: picks {idx.tolist()} not distinct or not feasible")
    _gate_launches("pool", launches, ("B3",))
    return launches


_CLI_OBJECTIVE = """import numpy as np


def f(x):
    x = np.atleast_2d(x)
    b, c, t = 5.1 / (4 * np.pi ** 2), 5.0 / np.pi, 1.0 / (8 * np.pi)
    return ((x[:, 1:2] - b * x[:, :1] ** 2 + c * x[:, :1] - 6.0) ** 2
            + 10.0 * (1 - t) * np.cos(x[:, :1]) + 10.0)
"""


def _leg_cli(fitted):
    """The command line in a child interpreter on the card (branin, 5 initial
    points, 2 iterations), then save_model / load_model of phase 4's fitted GP."""
    import tempfile

    from gaussian_process_optimization_tpu_torch.utils import serialization

    _zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "objective.py").write_text(_CLI_OBJECTIVE)
        cfg = {"main-file": "objective.py", "likelihood": "noiseless",
               "model": {"optimization-iterations": CLI_FIT_STEPS},
               "space": [{"name": "x1", "type": "continuous", "domain": [-5, 10]},
                         {"name": "x2", "type": "continuous", "domain": [0, 15]}],
               "initialization": {"num-eval": 5}, "resources": {"maximum-iterations": 2},
               "output": {"file-report": str(tmp / "report.txt"),
                          "file-evaluations": str(tmp / "evaluations.txt"),
                          "file-models": str(tmp / "models.txt")}}
        (tmp / "cfg.json").write_text(json.dumps(cfg))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m",
                               "gaussian_process_optimization_tpu_torch.bo.interface",
                               str(tmp / "cfg.json")], cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        rows = ((tmp / "evaluations.txt").read_text().strip().splitlines()[1:]
                if (tmp / "evaluations.txt").exists() else [])
        files = sorted(p.name for p in tmp.iterdir())
        path = tmp / "fitted.json.gz"
        serialization.save_model(fitted, path)
        back = serialization.load_model(path)
        with torch.no_grad():
            a, b = fitted.log_marginal_likelihood(), back.log_marginal_likelihood()
    best = [line for line in proc.stdout.splitlines() if line.startswith("Best found")]
    print(f"# approximate, CLI (python -m gaussian_process_optimization_tpu_torch.bo.interface, "
          f"branin, 5 initial + 2 iterations, fits cut to {CLI_FIT_STEPS} steps): exit "
          f"{proc.returncode} in {cli_s:.2f} s, {len(rows)} evaluation rows, files {files}; "
          f"{best[0] if best else 'no result line'}; save_model / load_model of phase 4's "
          f"fitted GP: -LML {-float(a):.6f} vs {-float(b):.6f} on {back.X.device}, bit for bit "
          f"{bool(torch.equal(a, b))}")
    if proc.returncode != 0 or len(rows) != 7:
        raise AssertionError(f"CLI: exit {proc.returncode}, {len(rows)} rows:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    if back.X.device.type != "cuda" or not torch.equal(a, b):
        raise AssertionError("CLI: the loaded model is not the saved one bit for bit")
    return _read_counts()


def phase_approximate(fitted):
    """Phase 9: approximate inference, pool batches, the CLI and serialization, float32
    on one card, through their entry points with no device given. Each leg
    zeroes the launch counts just before it and reads them just after; the sum
    is returned."""
    from gaussian_process_optimization_tpu_torch import workload

    X, Y = workload.bench_data()
    labels, outliers = workload.classification_labels(Y), workload.outlier_targets(Y)
    t0 = time.perf_counter()
    legs = [_leg_svgp(), _leg_ep(X, labels), _leg_epdtc(X, labels),
            _leg_laplace(X, labels, outliers), _leg_tp(X, outliers), _leg_pool(),
            _leg_cli(fitted)]
    total = {k: sum(leg[k] for leg in legs) for k in legs[0]}
    print(f"# approximate: phase 9 took {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


# Phase 10's limits. Legs 1-2: the -LML at the fitted point, f32 against f64
# at the f32 ladder's jitter (relative), and the gradient there, max |g32 -
# g64| over the larger of its two terms (the main path's measure,
# _print_fitted_gradient). The JAX package's own float32 at the card's fitted
# points on the CPU (tests/test_torch_zoo_f32.py::test_f32_lml_error_at_the_
# cards_fitted_point) reads -LML 2.95e-5 and gradient 1.48e-3 (leg 1), 2.31e-5
# and 7.12e-1 (leg 2: the Bias variance's component, a float32 sum of N^2
# entries of Ky^-1, is its own rounding). The -LML limit is the main path's
# (phase 4), above 30x those readings; each gradient limit is 10x the
# reading. Leg 3 (grid) and leg 4 (state space): the -LML and its gradient at
# the model's start, relative to max |g64|; the JAX package's float32 there
# (CPU, test_f32_error_of_the_grid_and_state_space_legs) reads 1.71e-5 and
# 1.03e-2 (grid), 9.58e-7 and 3.83e-3 (state space), and each limit is 10x
# the reading. Leg 5: K (max |K32 - K64| / max |K64|) and every leaf's
# gradient of sum(W * K) (max over leaves of max |g32 - g64| / max |g64|).
ICM_LML_LIMIT = 1e-3
ICM_GRAD_LIMIT = 1.5e-2
CO2_LML_LIMIT = 1e-3
CO2_GRAD_LIMIT = 7.1
GRID_LML_LIMIT = 1.7e-4
GRID_GRAD_LIMIT = 1.0e-1
GRID_DENSE_LIMIT = 1e-9       # float64 grid -LML against the dense GP's
SS_LML_LIMIT = 9.6e-6
SS_GRAD_LIMIT = 3.8e-2
SS_DENSE_LIMIT = 1e-9         # float64 Matern32 state-space -LML against the dense GP's
SS_FIT_STEPS = 1              # the state-space fit's depth (a cut: 6-11 s an evaluation)
# Leg 5: the JAX package's own float32 error against float64 at N = 64 on the
# CPU, per kernel, (K, gradient), as tests/test_torch_zoo_f32.py::
# test_f32_error_is_the_references prints it (workload.zoo_cases's inputs).
# Each limit is 10x that reading, and at least ZOO_K_FLOOR / ZOO_GRAD_FLOOR
# (a few float32 roundings: the readings of the exact kernels are ~1e-7, and a
# gradient sums N^2 terms). EQ_ODE2's float32 is the reference's own: 1.5e-2
# and 8.4e-2 at N = 64 (complex64 through the Faddeeva function).
ZOO_JAX_F32 = {
    "TruncLinear": (1.036e-07, 7.333e-07), "TruncLinearInf": (7.626e-08, 8.424e-07),
    "Hierarchical": (1.925e-07, 1.103e-05), "Symmetric": (1.321e-07, 2.868e-06),
    "PolynomialBasisFunc": (6.924e-08, 5.563e-08),
    "LinearSlopeBasisFunc": (7.691e-08, 6.033e-07),
    "ChangePointBasisFunc": (0.000e+00, 3.028e-07), "DomainKernel": (0.000e+00, 1.129e-08),
    "LogisticBasisFunc": (1.088e-07, 2.736e-07),
    "IndependentOutputs": (4.773e-07, 4.564e-07), "SplitKern": (2.162e-07, 2.563e-05),
    "DEtime": (2.123e-07, 5.686e-06), "MultioutputKern": (1.637e-07, 2.662e-06),
    "PeriodicExponential": (3.860e-07, 8.830e-07),
    "PeriodicMatern32": (4.346e-07, 9.146e-07), "PeriodicMatern52": (5.322e-07, 6.758e-06),
    "Integral": (2.633e-07, 2.623e-06), "IntegralLimits": (2.850e-07, 3.082e-06),
    "MultidimensionalIntegralLimits": (4.492e-07, 2.388e-06),
    "ODE_UY": (3.182e-07, 4.033e-06), "ODE_UYC": (2.441e-07, 2.420e-05),
    "ODE_t": (2.111e-07, 1.707e-05), "ODE_st": (1.464e-07, 1.025e-06),
    "EQ_ODE1": (3.377e-07, 8.966e-07), "EQ_ODE2": (1.498e-02, 8.409e-02),
    "Symbolic": (1.054e-07, 9.615e-07), "MLP": (3.077e-07, 8.773e-06),
    "Poly": (1.753e-07, 4.012e-07), "Brownian": (3.623e-08, 8.630e-08),
    "Spline": (1.761e-07, 2.312e-06), "LinearFull": (6.479e-08, 2.422e-07),
    "WhiteHeteroscedastic": (2.108e-08, 4.033e-08), "Fixed": (1.074e-07, 4.887e-07),
}
ZOO_K_FLOOR = 1e-5
ZOO_GRAD_FLOOR = 1e-4
ZOO_LIMITS = {name: (max(10 * k, ZOO_K_FLOOR), max(10 * g, ZOO_GRAD_FLOOR))
              for name, (k, g) in ZOO_JAX_F32.items()}
ZOO_BLOCK_ROWS = 512          # leg 5's row blocks for the LFM kernels' gradient
ZOO_BLOCKWISE = ("EQ_ODE1", "EQ_ODE2")


def _now():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter()


def _f64(obj):
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.double() if t.is_floating_point() else t, obj)


def _lml_and_terms(name, fitted, lml_limit, grad_limit, failures):
    """The -LML at the fitted point, f32 against f64 at the jitter the f32
    posterior's ladder chose (the same Ky), and the gradient there against its
    terms; the f32 -LML and gradient through the plain K (no B1 / B2) are
    printed beside them. Appends to ``failures`` what is past its limit."""
    import dataclasses

    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.models.fit import make_objective
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer

    packer = make_packer(fitted)
    obj = make_objective(packer)
    with torch.no_grad():
        post = fitted.inference()
        jitter = float(post.jitter)
        f64m = _f64(fitted)
        same_ky = dataclasses.replace(f64m, likelihood_variance=f64m.likelihood_variance + jitter)
        f32 = float(obj(packer.pack(fitted)[None], fitted)[0])
        f64 = float(obj(packer.pack(f64m)[None], f64m)[0])
        f64j = float(obj(packer.pack(same_ky)[None], same_ky)[0])
    rel, rel_j = abs(f32 - f64) / abs(f64), abs(f32 - f64j) / abs(f64j)
    grad = _print_fitted_gradient(fitted, f64m)
    config.use_cuda_kernels = False
    try:
        with torch.no_grad():
            plain = float(obj(packer.pack(fitted)[None], fitted)[0])
        grad_plain = _print_fitted_gradient(fitted, f64m, quiet=True)
    finally:
        config.use_cuda_kernels = "auto"
    print(f"# zoo, {name}: -LML at the fitted point f32 {f32:.6f}, f64 {f64:.6f} (rel "
          f"{rel:.3e}); the f32 ladder's rung {int(post.rung)}, jitter {jitter:.3g}: f64 at "
          f"that jitter {f64j:.6f} (rel {rel_j:.3e}, limit {lml_limit:g}); gradient "
          f"{grad:.3e} of its terms (limit {grad_limit:g}); through the plain K: -LML rel "
          f"{abs(plain - f64j) / abs(f64j):.3e}, gradient {grad_plain:.3e}")
    if not rel_j <= lml_limit:
        failures.append(f"{name}: -LML f32 vs f64 rel {rel_j:.3e} > {lml_limit:g}")
    if not grad <= grad_limit:
        failures.append(f"{name}: gradient f32 vs f64 {grad:.3e} of its terms > {grad_limit:g}")
    return rel_j, grad


def _check_predictions(name, preds, failures):
    for i, (mu, var) in enumerate(preds):
        if not (bool(torch.isfinite(mu).all()) and bool((var > 0).all())
                and bool(torch.isfinite(var).all())):
            failures.append(f"{name}: prediction {i} has a non-finite mean or a variance <= 0")


def _leg_icm(n, restarts, steps, where, failures):
    """Leg 1: GPCoregionalizedRegression, 3 tasks, ARD Matern52 on 6 inputs,
    rank 1, noise 0.1: a restarts x steps fit, the posterior, mean and
    variance of each task at 1000 points."""
    import numpy as np

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves

    Xs, Ys = workload.icm_data(n=n)
    model = workload.icm_model(Xs, Ys, **where)
    _zero_counts()
    t0 = _now()
    res = workload.icm_fit(model, restarts=restarts, steps=steps,
                           generator=torch.Generator(device=model.model.X.device).manual_seed(0))
    t1 = _now()
    post = model.model.inference(precompute_inverse=True)
    t2 = _now()
    Xt = np.random.default_rng(1).uniform(-2.0, 2.0, size=(1000, Xs[0].shape[1]))
    preds = [model.predict(Xt, task, posterior=post) for task in range(len(Xs))]
    t3 = _now()
    launches = _read_counts()
    fitted = model.model
    coreg = fitted.kern.parts[1]
    print(f"# zoo, leg 1 ICM (N={sum(len(x) for x in Xs)} = {' + '.join(str(len(x)) for x in Xs)}, "
          f"D={Xs[0].shape[1]} + task, Matern52 ARD x Coregionalize rank 1, "
          f"{fitted.X.dtype}, {restarts} x {steps}): fit {t1 - t0:.3f} s, posterior "
          f"{t2 - t1:.3f} s, predict 3 x 1000 {t3 - t2:.3f} s; launches {launches}; "
          f"num_ls {res.num_ls.tolist()}, f {res.f.tolist()}; B {coreg.B.tolist()}")
    print(f"# zoo, leg 1 fitted leaves {json.dumps({k: v.tolist() for k, v in named_leaves(fitted) if k not in ('X', 'Y')})}")
    _gate_launches("zoo leg 1 (ICM)", launches, ("B1", "B2", "B3"))
    _check_predictions("zoo leg 1 (ICM)", preds, failures)
    _lml_and_terms("leg 1 ICM", fitted, ICM_LML_LIMIT, ICM_GRAD_LIMIT, failures)
    _icm_stage_swaps(fitted)
    return launches, fitted, Xs


# C11's readings at the ICM fitted point: each stage alone, all three and the
# blocked Cholesky; the three pairs (~16 s on the host's CPU) are cut to keep
# the script inside its time limit (prof_stages.CONFIGS has them all)
ICM_STAGES_CUT = ("K + Cholesky on host", "K + solves on host", "Cholesky + solves on host")


def _icm_stage_swaps(fitted):
    """C11: the -LML (at the f32 ladder's jitter) and the gradient error of its
    terms at the fitted point, with one stage at a time on the host."""
    import dataclasses

    from gaussian_process_optimization_tpu_torch.models.fit import make_objective
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
    from gaussian_process_optimization_tpu_torch.prof_stages import CONFIGS
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    f64m = _f64(fitted)
    ld64, q64 = _neg_lml_grad_terms(f64m)
    terms = torch.maximum(ld64.abs(), q64.abs())

    def measure(m):
        packer = make_packer(m)
        with torch.no_grad():
            jitter = float(m.inference().jitter)
            f32 = float(make_objective(packer)(packer.pack(m)[None], m)[0])
        same = dataclasses.replace(f64m, likelihood_variance=f64m.likelihood_variance + jitter)
        packer64 = make_packer(same)
        with torch.no_grad():
            f64 = float(make_objective(packer64)(packer64.pack(same)[None], same)[0])
        ld32, q32 = _neg_lml_grad_terms(m)
        grad = float((((ld32 + q32).to(ld64.device) - (ld64 + q64)).abs() / terms).max())
        return {"lml": abs(f32 - f64) / abs(f64), "grad": grad}

    _stage_swaps("zoo, leg 1 ICM at the fitted point (-LML rel at the f32 ladder's jitter, "
                 "gradient of its terms)", lambda: measure(fitted),
                 lambda: measure(tree_map(lambda t: t.cpu(), fitted)), ("lml", "grad"),
                 tuple(c for c in CONFIGS if c[0] not in ICM_STAGES_CUT))


def _leg_co2(n, restarts, steps, where, failures):
    """Leg 2: an exact GP at N = 4096 on 1-D times with RBF + StandardPeriodic
    * RBF + RatQuad + Linear + Bias."""
    import numpy as np

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves

    X, Y = workload.co2_data(n=n)
    model = workload.co2_model(X, Y, **where)
    _zero_counts()
    t0 = _now()
    fitted, res = workload.fit(model, restarts=restarts, steps=steps,
                               generator=torch.Generator(device=model.X.device).manual_seed(0))
    t1 = _now()
    post = fitted.inference(precompute_inverse=True)
    t2 = _now()
    Xt = torch.as_tensor(np.linspace(0.0, 22.0, 1000)[:, None], dtype=fitted.X.dtype,
                         device=fitted.X.device)
    preds = [fitted.predict(Xt, posterior=post)]
    t3 = _now()
    launches = _read_counts()
    print(f"# zoo, leg 2 Mauna Loa composition (N={n}, 1-D, RBF + StdPeriodic * RBF + RatQuad "
          f"+ Linear + Bias, {fitted.X.dtype}, {restarts} x {steps}): fit {t1 - t0:.3f} s, "
          f"posterior {t2 - t1:.3f} s, predict 1000 {t3 - t2:.3f} s; launches {launches}; "
          f"num_ls {res.num_ls.tolist()}, f {res.f.tolist()}")
    print(f"# zoo, leg 2 fitted leaves {json.dumps({k: v.tolist() for k, v in named_leaves(fitted) if k not in ('X', 'Y')})}")
    _gate_launches("zoo leg 2 (composition)", launches, ("B1", "B2", "B3"))
    _check_predictions("zoo leg 2 (composition)", preds, failures)
    _lml_and_terms("leg 2 composition", fitted, CO2_LML_LIMIT, CO2_GRAD_LIMIT, failures)
    return launches


def _value_and_grad(model):
    """(-LML, its gradient in the optimizer's coordinates), float64 numbers."""
    from gaussian_process_optimization_tpu_torch.models.fit import make_objective
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer

    packer = make_packer(model)
    u = packer.pack(model)[None].clone().requires_grad_(True)
    f = make_objective(packer)(u, model)[0]
    (g,) = torch.autograd.grad(f, u)
    return float(f.detach()), g[0].double()


def _f32_vs_f64(name, model, lml_limit, grad_limit, failures):
    """-LML and gradient f32 vs f64; returns the f32 evaluation's seconds."""
    t0 = _now()
    f32, g32 = _value_and_grad(model)
    seconds = _now() - t0
    f64, g64 = _value_and_grad(_f64(model))
    rel = abs(f32 - f64) / abs(f64)
    grel = float((g32 - g64).abs().max() / g64.abs().max())
    print(f"# zoo, {name}: at the start -LML f32 {f32:.6f} vs f64 {f64:.6f} (rel {rel:.3e}, "
          f"limit {lml_limit:g}), gradient rel {grel:.3e} of max |g64| {float(g64.abs().max()):.4g} "
          f"(limit {grad_limit:g})")
    if not rel <= lml_limit:
        failures.append(f"{name}: -LML f32 vs f64 rel {rel:.3e} > {lml_limit:g}")
    if not grel <= grad_limit:
        failures.append(f"{name}: gradient f32 vs f64 rel {grel:.3e} > {grad_limit:g}")
    return seconds


def _leg_grid(side, steps, where, failures):
    """Leg 3: GPGridRegression on a side x side grid, an RBF per axis."""
    from gaussian_process_optimization_tpu_torch import workload

    axes, Y = workload.grid_data(side=side)
    model = workload.grid_model(axes, Y, **where)
    _f32_vs_f64(f"leg 3 grid {side} x {side}", model, GRID_LML_LIMIT, GRID_GRAD_LIMIT, failures)
    m64 = _f64(model)
    with torch.no_grad():
        g64 = float(m64.log_marginal_likelihood())
        d64 = float(workload.grid_dense(m64).log_marginal_likelihood())
    rel = abs(g64 - d64) / abs(d64)
    print(f"# zoo, leg 3: float64 -LML grid {-g64:.10f} vs dense GP {-d64:.10f} (rel {rel:.3e}, "
          f"limit {GRID_DENSE_LIMIT:g})")
    if not rel <= GRID_DENSE_LIMIT:
        failures.append(f"grid: float64 -LML against the dense GP rel {rel:.3e}")
    t0 = _now()
    fitted, res = workload.grid_fit(model, steps=steps)
    t1 = _now()
    Xt = torch.rand(1000, 2, generator=torch.Generator().manual_seed(0)).double().numpy()
    mu, var = fitted.predict(Xt)
    t2 = _now()
    with torch.no_grad():
        before, after = -float(model.log_marginal_likelihood()), -float(fitted.log_marginal_likelihood())
    print(f"# zoo, leg 3 fit 1 x {steps} {t1 - t0:.3f} s ({int(res.num_ls.sum())} trials), "
          f"-LML {before:.4f} -> {after:.4f}; predict 1000 {t2 - t1:.3f} s; lengthscales "
          f"{[float(k.lengthscale) for k in fitted.kerns]}, noise {float(fitted.likelihood_variance):.5g}")
    if not (after < before and math.isfinite(after)):
        failures.append("grid: the fit did not lower the -LML")
    _check_predictions("grid", [(mu, var)], failures)


def _leg_state_space(n, steps, where, failures):
    """Leg 4: StateSpaceGP with Matern32 + StandardPeriodic * Matern32."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.kernels import Matern32
    from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
    from gaussian_process_optimization_tpu_torch.models.state_space import StateSpaceGP

    t, y = workload.state_space_data(n=n)
    model = workload.state_space_model(t, y, **where)
    seconds = _f32_vs_f64("leg 4 state space", model, SS_LML_LIMIT, SS_GRAD_LIMIT, failures)
    print(f"# zoo, leg 4 state space (N={n}, {model.family}, order {model.order}, state "
          f"dimension {2 + 2 * 2 * (model.order + 1)}, {model.X.dtype}): one -LML + gradient "
          f"{seconds:.3f} s")
    # Matern32 alone in float64 is exact: its -LML equals the dense GP's
    m = StateSpaceGP.create(t, y, family="matern32", variance=0.5, lengthscale=5.0,
                            noise_var=0.01, dtype=torch.float64, device=model.X.device)
    dense = GPRegression.create(t[:, None], y, kernel=Matern32.create(
        1, variance=0.5, lengthscale=5.0, dtype=torch.float64, device=model.X.device),
        noise_var=0.01 - 1e-8, dtype=torch.float64, device=model.X.device)
    with torch.no_grad():
        s64, d64 = float(m.log_marginal_likelihood()), float(dense.log_marginal_likelihood())
    rel = abs(s64 - d64) / abs(d64)
    print(f"# zoo, leg 4: Matern32 float64 -LML state space {-s64:.10f} vs dense GP "
          f"{-d64:.10f} (rel {rel:.3e}, limit {SS_DENSE_LIMIT:g})")
    if not rel <= SS_DENSE_LIMIT:
        failures.append(f"state space: float64 Matern32 -LML against the dense GP rel {rel:.3e}")
    t2 = _now()
    from gaussian_process_optimization_tpu_torch.models import fit as fit_module

    fitted, res = fit_module.fit(model, num_restarts=1, maxiter=steps)
    t3 = _now()
    mu, var = fitted.predict(t[:16] + 0.05)
    t4 = _now()
    with torch.no_grad():
        before = -float(model.log_marginal_likelihood())
        after = -float(fitted.log_marginal_likelihood())
    print(f"# zoo, leg 4 fit 1 x {steps} (cut from 30: depth) {t3 - t2:.3f} s "
          f"({int(res.num_ls.sum())} trials), -LML {before:.4f} -> {after:.4f}; RTS predict at "
          f"16 points {t4 - t3:.3f} s")
    if not (after < before and math.isfinite(after)):
        failures.append("state space: the fit did not lower the -LML")
    _check_predictions("state space", [(mu, var)], failures)


def _leaf_grads(kern, X, W, rows=None):
    """{path: d sum(W * K) / d leaf}; ``rows`` builds K a block of rows at a
    time (K(X[b], X) is those rows of K(X) for the kernels it is used on)."""
    from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves, replace_leaves

    named = named_leaves(kern)
    leaves = [t.detach().clone().requires_grad_(True) for _, t in named]
    k = replace_leaves(kern, leaves)
    total = [torch.zeros_like(t) for t in leaves]
    blocks = [slice(None)] if rows is None else [slice(i, i + rows)
                                                 for i in range(0, X.shape[0], rows)]
    for b in blocks:
        K = k.K(X) if rows is None else k.K(X[b], X)
        gs = torch.autograd.grad(torch.sum(W[b] * K), leaves, allow_unused=True)
        total = [acc if g is None else acc + g for acc, g in zip(total, gs)]
        del K
    return {path: g for (path, _), g in zip(named, total)}


def _leg_kernels(n, where, failures):
    """Leg 5: every other zoo kernel at N rows: K and each leaf's gradient of
    sum(W * K), float32 against float64."""
    from gaussian_process_optimization_tpu_torch import workload

    readings = {}
    t0 = _now()
    cases = workload.zoo_cases(n=n, **where)
    cases64 = {name: (k, X) for name, k, X in workload.zoo_cases(n=n, dtype=torch.float64,
                                                                  device=cases[0][2].device)}
    for name, kern, X in cases:
        t1 = _now()
        k64, X64 = cases64[name]
        rows = ZOO_BLOCK_ROWS if name in ZOO_BLOCKWISE else None
        with torch.no_grad():
            if rows is None:
                K32, K64 = kern.K(X), k64.K(X64)
            else:
                K32 = torch.cat([kern.K(X[i:i + rows], X) for i in range(0, n, rows)])
                K64 = torch.cat([k64.K(X64[i:i + rows], X64) for i in range(0, n, rows)])
        kerr = float((K32.double() - K64).abs().max() / K64.abs().max().clamp(min=1e-300))
        finite = bool(torch.isfinite(K32).all())
        del K32, K64
        W = torch.randn(n, n, generator=torch.Generator(device=X.device).manual_seed(1),
                        dtype=X.dtype, device=X.device)
        W = 0.5 * (W + W.mT)
        g32 = _leaf_grads(kern, X, W, rows)
        g64 = _leaf_grads(k64, X64, W.double(), rows)
        del W
        gerr = 0.0
        for path, g in g64.items():
            scale = float(g.abs().max())
            if scale > 0:
                gerr = max(gerr, float((g32[path].double() - g).abs().max()) / scale)
            finite = finite and bool(torch.isfinite(g32[path]).all())
        klim, glim = ZOO_LIMITS[name]
        readings[name] = (kerr, gerr)
        print(f"# zoo, leg 5 {name} (N={n}{', blocks of ' + str(rows) + ' rows' if rows else ''}): "
              f"K rel {kerr:.3e} (limit {klim:g}), gradient rel {gerr:.3e} (limit {glim:g}) "
              f"over {len(g64)} leaves; {_now() - t1:.2f} s")
        if not finite:
            failures.append(f"{name}: non-finite K or gradient in float32")
        if not (kerr <= klim and gerr <= glim):
            failures.append(f"{name}: K rel {kerr:.3e} / gradient rel {gerr:.3e} past "
                            f"({klim:g}, {glim:g})")
    print(f"# zoo, leg 5: {len(cases)} kernels in {_now() - t0:.1f} s")
    return readings


def _zoo_kernel_rows(dev, n=4096, lanes=5):
    """B1 and B2 at the zoo legs' shapes: Matern52 ARD on 6 columns read
    through an active_dims slice of 7 (leg 1), RBF and RatQuad on one
    (leg 2, padded to 4), each beside its plain version and its byte bound."""
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device=dev).manual_seed(3)
    X7 = 4 * torch.rand(n, 7, generator=gen, device=dev) - 2
    X6 = X7[:, :6].contiguous()[None]        # what Kernel._slice hands the wrapper
    X1 = 20 * torch.rand(1, n, 1, generator=gen, device=dev)
    rows = {}
    for tag, X, fam, ard, p in (
            ("Matern52 ARD D=6 (7-column slice)", X6, "matern52", True,
             _matern_rows(dev, lanes, gen)),
            ("RBF D=1", X1, "rbf", False, _rbf_rows(dev, lanes, gen)),
            ("RatQuad D=1", X1, "ratquad", False, _rbf_rows(dev, lanes, gen))):
        if fam == "ratquad":
            p[:, 1] = 1.0
        got = ck.stationary_k_build(X, X, p, fam, ard)
        _close(f"B1 {tag}", got, ck.k_build_plain(X, X, p, fam, ard), rtol=2e-5, atol=2e-6)
        ms = _time_ms(lambda: ck.stationary_k_build(X, X, p, fam, ard))
        plain = _time_ms(lambda: ck.k_build_plain(X, X, p, fam, ard), calls=5)
        bound = _bound(_nbytes(X, p, got), got.numel() * _k_flops(X.shape[-1]))
        print(f"# B1 stationary_k_build {lanes}x{n}x{n} {tag}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        rows[f"B1 {tag}"] = {"ms": ms, "plain_ms": plain, **bound}
        G = (2 * torch.rand(lanes, n, n, generator=gen, device=dev) - 0.5)
        dp, _, _ = ck.stationary_k_backward(X, X, p, G, fam, ard, False, False, True)
        want, _, _ = ck.k_backward_plain(X.double(), X.double(), p.double(), G.double(), fam,
                                         ard, False, False, True)
        _close(f"B2 {tag}", dp, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
        ms = _time_ms(lambda: ck.stationary_k_backward(X, X, p, G, fam, ard, False, False, True))
        plain = _time_ms(lambda: ck.k_backward_plain(X, X, p, G, fam, ard, False, False, True),
                         calls=5)
        bound = _bound(_nbytes(X, p, G, dp), G.numel() * _k_bwd_flops(X.shape[-1]))
        print(f"# B2 stationary_k_backward {lanes}x{n}x{n} {tag} (parameter gradients): "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})")
        rows[f"B2 {tag}"] = {"ms": ms, "plain_ms": plain, **bound}
        del got, G, dp, want
    return rows


def phase_zoo(dev=None, n=4096, side=64, restarts=5, steps=30, ss_steps=SS_FIT_STEPS,
              where=None):
    """Phase 10: the kernel zoo and the multi-output, grid and state-space
    models, float32 on the card, through their entry points with no device
    given. Legs 1 and 2 zero the launch counts just before and read them just
    after; the sum is returned. Every leg runs; the phase fails at its end if
    any check failed."""
    where = {} if where is None else where
    failures = []
    t0 = time.perf_counter()
    split = {}
    if dev is not None:
        _zoo_kernel_rows(dev)
    t = _now()
    icm, _, _ = _leg_icm(n, restarts, steps, where, failures)
    split["ICM"] = _now() - t
    t = _now()
    co2 = _leg_co2(n, restarts, steps, where, failures)
    split["composition"] = _now() - t
    t = _now()
    _leg_grid(side, steps, where, failures)
    split["grid"] = _now() - t
    t = _now()
    _leg_state_space(n, ss_steps, where, failures)
    split["state space"] = _now() - t
    t = _now()
    _leg_kernels(n, where, failures)
    split["kernels"] = _now() - t
    total = {k: icm[k] + co2[k] for k in icm}
    print(f"# zoo: phase 10 took {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in split.items())}); launches {total}")
    if failures:
        raise AssertionError("zoo: " + "; ".join(failures))
    return total


# Phase 11's limits. Leg 1 (the point GPLVM): the -LML at the fitted point,
# f32 against f64 at the f32 ladder's jitter (relative), and its gradient with
# the X block, max over components of |g32 - g64| over the larger of the
# component's two f64 terms (0.5 p logdet, 0.5 quad), each term floored at
# 1e-3 of the largest (most of the 24 576 X components are far smaller than
# the hyperparameters'). Leg 2 (the Bayesian GPLVM): the -ELBO f32 against f64
# at the model's start; at the fitted point the float32 bound is rounding in
# both packages (ROADMAP C13), so there the f64 -ELBO must be below the
# start's and the f32 reading is printed beside the JAX package's. Leg 3:
# each model's -bound at its fitted point, f32 against f64 (relative). Each
# limit is 10x the JAX package's own float32 reading on the CPU at the card's
# fitted leaves (tests/test_torch_latent_f32.py, marked slow, prints them;
# NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 6), and at least
# LATENT_FLOOR. LVMOGP's and the offset regression's float32 bounds are
# rounding at their fitted points in both packages (C13): their limits hold
# the port to the reference's own error there and no closer.
LATENT_JAX_F32 = {"gplvm": (8.590e-06, 3.510e-02), "bgplvm_start": 1.355e-07,
                  "bgplvm_fitted": 7.024e-02}
LATENT_LEG3_JAX_F32 = {
    "MRD": 2.771e-05, "SSGPLVM": 6.225e-03, "LVMOGP": 5.794e+00, "BGPLVM_SVI": 1.348e-06,
    "IBPLFM": 1.356e-07, "GPHeteroscedasticRegression": 9.041e-03,
    "GPKroneckerGaussianRegression": 2.309e-06, "GPVariationalGaussianApproximation": 2.068e-07,
    "OneVsAllClassification": 8.795e-08, "OneVsAllSparseClassification": 2.117e-05,
    "bcgplvm": 4.845e-07, "sparse_gplvm": 1.293e-04, "GPOffsetRegression": 5.453e-01}
LATENT_FLOOR = 1e-5
LATENT_TERM_FLOOR = 1e-3
LATENT_LEG3_N = 512
LATENT_LEG3_STEPS = 60
LATENT_FITTED = ROOT / "chiprun_out" / "latent_fitted.npz"
HELD = 256  # rows predicted at, and held out for infer_newX


def _limit(reading):
    return max(10.0 * reading, LATENT_FLOOR)


def _gplvm_terms(model):
    """The -LML's two terms' gradients in the GPLVM's packed coordinates (the
    hyperparameters and X), float64."""
    from gaussian_process_optimization_tpu_torch.models.gplvm import gplvm_packer

    return _neg_lml_grad_terms(model, gplvm_packer(model))


def gplvm_gradient_error(ld32, q32, ld64, q64, n_hyper):
    """(all, hyperparameters, X block) of max |g32 - g64| / max(|ld64|, |q64|,
    LATENT_TERM_FLOOR x the largest such term)."""
    terms = torch.maximum(ld64.abs(), q64.abs())
    terms = torch.clamp(terms, min=LATENT_TERM_FLOOR * float(terms.max()))
    ratio = ((ld32 + q32) - (ld64 + q64)).abs() / terms
    return float(ratio.max()), float(ratio[:n_hyper].max()), float(ratio[n_hyper:].max())


def _save_fitted(fitted: dict):
    """The fitted leaves of phase 11's models under chiprun_out/, keyed
    '<model>/<leaf path>' (the targets are regenerated from their seeds)."""
    import numpy as np

    from gaussian_process_optimization_tpu_torch.convert import leaves_of

    out = {f"{name}/{path}": v for name, m in fitted.items()
           for path, v in leaves_of(m).items()
           if path.split(".")[0] not in ("Y", "Ys", "mask")}
    LATENT_FITTED.parent.mkdir(exist_ok=True)
    np.savez_compressed(LATENT_FITTED, **out)
    print(f"# latent: fitted leaves of {len(fitted)} models saved to {LATENT_FITTED.relative_to(ROOT)}")


def _leg_gplvm(where, failures, steps):
    """Leg 1: the point GPLVM, N = 4096, D = 12, Q = 6, RBF ARD + Bias, one
    lane of at most ``steps`` L-BFGS steps; then infer_newX on the held-out
    rows (one with a NaN entry) and the reconstruction RMSE."""
    import dataclasses

    import numpy as np

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.models.fit import make_objective
    from gaussian_process_optimization_tpu_torch.models.gplvm import gplvm_packer
    from gaussian_process_optimization_tpu_torch.models.inference_x import infer_newX

    Y, _, Y_new = workload.latent_data()
    model = workload.gplvm_model(Y, **where)
    _zero_counts()
    t0 = _now()
    fitted, res = workload.gplvm_fit(model, steps=steps)
    t1 = _now()
    post = fitted.inference(precompute_inverse=True)
    mu_train, _ = fitted.predict(fitted.X[:HELD], posterior=post)
    t2 = _now()
    X_new, info = infer_newX(fitted, Y_new)
    t3 = _now()
    launches = _read_counts()
    mu, var = fitted.predict(X_new, posterior=post)
    Yt = torch.as_tensor(Y_new, dtype=mu.dtype, device=mu.device)
    seen = ~torch.isnan(Yt)
    rmse = float(torch.sqrt(torch.mean(torch.square((mu - Yt)[seen]))))
    rmse_train = float(torch.sqrt(torch.mean(torch.square(
        mu_train - fitted.Y[:HELD]))))
    n_hyper = gplvm_packer(fitted).num_free - fitted.X.numel()
    print(f"# latent, leg 1 point GPLVM (N={Y.shape[0]}, D={Y.shape[1]}, Q={fitted.X.shape[1]}, "
          f"RBF ARD + Bias, {fitted.X.dtype}, {gplvm_packer(fitted).num_free} parameters, 1 x "
          f"{steps} L-BFGS, the reference's 500 cut: depth): fit {t1 - t0:.3f} s "
          f"({int(res.num_iters)} steps, {int(res.num_ls)} trials, converged "
          f"{bool(res.converged)}), -LML {float(res.f):.4f}; posterior + predict {HELD} "
          f"{t2 - t1:.3f} s; infer_newX {Y_new.shape[0]} rows {t3 - t2:.3f} s; launches "
          f"{launches}; reconstruction RMSE held out {rmse:.4f} (train rows {rmse_train:.4f}, "
          f"Y's std {float(np.nanstd(Y)):.4f}); noise {float(fitted.likelihood_variance):.5g}, "
          f"lengthscales {fitted.kern.parts[0].lengthscale.tolist()}")
    _gate_launches("latent leg 1 (GPLVM)", launches, ("B1", "B2", "B3"))
    if launches["B2 dX"] <= 0 or launches["B2 dZ"] <= 0:
        failures.append(f"GPLVM: B2's row (dX) and column (dZ) passes not both launched: "
                        f"{launches}")
    if not (math.isfinite(rmse) and bool(torch.isfinite(X_new).all())
            and bool(torch.isfinite(info["objective"]).all())):
        failures.append("GPLVM: infer_newX gave a non-finite latent or objective")

    packer = gplvm_packer(fitted)
    obj = make_objective(packer)
    with torch.no_grad():
        p32 = fitted.inference()
        jitter = float(p32.jitter)
        f64m = _f64(fitted)
        same_ky = dataclasses.replace(f64m, likelihood_variance=f64m.likelihood_variance + jitter)
        f32 = float(obj(packer.pack(fitted), fitted))
        f64j = float(obj(packer.pack(same_ky), same_ky))
    rel = abs(f32 - f64j) / abs(f64j)
    ld32, q32 = _gplvm_terms(fitted)
    ld64, q64 = _gplvm_terms(same_ky)
    g_all, g_hyp, g_x = gplvm_gradient_error(ld32, q32, ld64, q64, n_hyper)
    lml_limit, grad_limit = (_limit(r) for r in LATENT_JAX_F32["gplvm"])
    print(f"# latent, leg 1: -LML at the fitted point f32 {f32:.6f}, f64 at the ladder's "
          f"jitter {jitter:.3g} (rung {int(p32.rung)}) {f64j:.6f}: rel {rel:.3e} (limit "
          f"{lml_limit:g}); gradient max |g32 - g64| / term {g_all:.3e} (limit {grad_limit:g}): "
          f"hyperparameters {g_hyp:.3e}, X block {g_x:.3e}")
    if not rel <= lml_limit:
        failures.append(f"GPLVM: -LML f32 vs f64 rel {rel:.3e} > {lml_limit:g}")
    if not g_all <= grad_limit:
        failures.append(f"GPLVM: gradient f32 vs f64 {g_all:.3e} > {grad_limit:g}")
    t4 = _now()
    mag = fitted.predict_magnification(X_new[:HELD], posterior=post)
    t5 = _now()
    print(f"# latent, leg 3 predict_magnification on leg 1's model at {mag.shape[0]} points: "
          f"{t5 - t4:.3f} s, range {float(mag.min()):.4g} .. {float(mag.max()):.4g}")
    if not bool(torch.isfinite(mag).all()):
        failures.append("predict_magnification: non-finite")
    return launches, fitted, {"fit": t1 - t0, "predict": t2 - t1, "infer": t3 - t2}


def _leg_bgplvm(where, failures, steps):
    """Leg 2: the Bayesian GPLVM, N = 4096, D = 12, Q = 7, M = 40, ARD RBF:
    fit one lane, predict, and the uncertain infer_newX on the held-out rows
    (the NaN entry set to the column mean, 0 after centring)."""
    import numpy as np

    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.models.inference_x import infer_newX

    Y, _, Y_new = workload.latent_data()
    model = workload.bgplvm_model(Y, **where)
    with torch.no_grad():
        s32, s64 = -float(model.elbo()), -float(_f64(model).elbo())
    start_rel, start_limit = abs(s32 - s64) / abs(s64), _limit(LATENT_JAX_F32["bgplvm_start"])
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = _now()
    fitted, res = workload.bgplvm_fit(model, steps=steps)
    t1 = _now()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        post = fitted.posterior_u()
        mu, var = fitted.predict(fitted.q_mu[:HELD], posterior=post)
    t2 = _now()
    q, info = infer_newX(fitted, np.nan_to_num(Y_new - Y.mean(0)))
    t3 = _now()
    launches = _read_counts()
    with torch.no_grad():
        f32 = -float(fitted.elbo())
        f64 = -float(_f64(fitted).elbo())
    rel = abs(f32 - f64) / abs(f64)
    print(f"# latent, leg 2 Bayesian GPLVM (N={Y.shape[0]}, D={Y.shape[1]}, "
          f"Q={fitted.q_mu.shape[1]}, M={fitted.Z.shape[0]}, {fitted.Z.dtype}, 1 x {steps} "
          f"L-BFGS): fit {t1 - t0:.3f} s ({int(res.num_iters)} steps, {int(res.num_ls)} trials), "
          f"peak memory {peak:.3f} GiB (the (N, M, M, Q) intermediate "
          f"{fitted.q_mu.numel() * fitted.Z.shape[0] ** 2 * 4 / 1e6:.0f} MB); predict {HELD} {t2 - t1:.3f} s; "
          f"uncertain infer_newX {Y_new.shape[0]} rows {t3 - t2:.3f} s; launches {launches}; "
          f"-ELBO at the start f32 {s32:.6f} vs f64 {s64:.6f} (rel {start_rel:.3e}, limit "
          f"{start_limit:g}); at the fitted point f64 {f64:.6f} (below the start's: "
          f"{f64 < s64}), f32 {f32:.6f} (rel {rel:.3e}, the JAX package's own float32 there "
          f"{LATENT_JAX_F32['bgplvm_fitted']:.3e}: rounding, C13); ARD relevance 1/l^2 "
          f"{(1 / fitted.kern.lengthscale ** 2).tolist()}")
    _bgplvm_stage_swaps(model)
    if not start_rel <= start_limit:
        failures.append(f"Bayesian GPLVM: -ELBO f32 vs f64 at the start rel {start_rel:.3e} > "
                        f"{start_limit:g}")
    if not f64 < s64:
        failures.append(f"Bayesian GPLVM: the fit did not lower the f64 -ELBO ({s64} -> {f64})")
    finite = all(bool(torch.isfinite(t).all()) for t in (mu, var, q.mean, q.variance,
                                                         info["objective"]))
    if not (finite and bool((var > 0).all()) and bool((q.variance > 0).all())):
        failures.append("Bayesian GPLVM: non-finite prediction or q(x*)")
    return launches, fitted, {"fit": t1 - t0, "predict": t2 - t1, "infer": t3 - t2,
                              "peak_GiB": peak}


STORED_FITTED = ROOT / "tests" / "data" / "latent_card_fitted.npz"


def _bgplvm_stage_swaps(template):
    """C13: the -ELBO f32 against f64 at the stored fitted leaves of the
    Bayesian GPLVM (STORED_FITTED, a card run's phase 11), with one stage at a
    time on the host."""
    import numpy as np

    from gaussian_process_optimization_tpu_torch.utils.tree import (named_leaves,
                                                                    replace_leaves, tree_map)

    data = np.load(STORED_FITTED)
    saved = {k[len("bgplvm/"):]: data[k] for k in data.files if k.startswith("bgplvm/")}
    m = replace_leaves(template, [
        torch.as_tensor(saved[path], dtype=t.dtype, device=t.device) if path in saved else t
        for path, t in named_leaves(template)])
    with torch.no_grad():
        f64 = -float(_f64(m).elbo())

    def rel(model):
        with torch.no_grad():
            return {"rel": abs(-float(model.elbo()) - f64) / abs(f64)}

    _stage_swaps("latent, leg 2 Bayesian GPLVM at the stored fitted leaves, -ELBO f32 vs f64",
                 lambda: rel(m), lambda: rel(tree_map(lambda t: t.cpu(), m)), ("rel",))


def _leg_models(where, failures, n, steps):
    """Leg 3: every other latent and zoo model, one short run each; each
    gated on finite results and its -bound f32 against f64 at its fitted
    leaves."""
    from gaussian_process_optimization_tpu_torch import workload

    fitted, readings = {}, {}
    _zero_counts()
    for leg in workload.latent_legs(n=n, steps=steps, **where):
        t0 = _now()
        m, preds = leg.run()
        t1 = _now()
        with torch.no_grad():
            f32 = -float(m.log_marginal_likelihood())
            f64 = -float(_f64(m).log_marginal_likelihood())
        rel = abs(f32 - f64) / abs(f64)
        limit = _limit(LATENT_LEG3_JAX_F32[leg.name])
        flat = [t for p in preds for t in (p if isinstance(p, tuple) else (p,))]
        finite = math.isfinite(f32) and all(bool(torch.isfinite(t).all()) for t in flat)
        readings[leg.name] = rel
        fitted[leg.name] = m
        print(f"# latent, leg 3 {leg.name} (N={n}; reduced: {leg.reduced}): {t1 - t0:.3f} s; "
              f"-bound f32 {f32:.6f} vs f64 {f64:.6f} (rel {rel:.3e}, limit {limit:g}); "
              f"{len(flat)} prediction tensors, finite {finite}")
        if not finite:
            failures.append(f"{leg.name}: non-finite bound or prediction")
        if not rel <= limit:
            failures.append(f"{leg.name}: -bound f32 vs f64 rel {rel:.3e} > {limit:g}")
    return _read_counts(), fitted, readings


def _gplvm_kernel_row(dev, n=4096, q=6):
    """B2 with dX and dZ at the GPLVM's (1, n, n), Q = q, ARD RBF: what a
    trainable X asks of K(X, X)'s backward, beside its plain version and its
    byte bound (G, X and the parameters read once; dX, dZ and the parameters'
    gradient written once)."""
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device=dev).manual_seed(11)
    X = (4 * torch.rand(1, n, q, generator=gen, device=dev) - 2).contiguous()
    p = torch.zeros(1, 8, device=dev)
    p[0, 0] = 1.3
    p[0, 2:2 + q] = 0.5 + torch.rand(q, generator=gen, device=dev)
    G = (torch.rand(1, n, n, generator=gen, device=dev) - 0.5).contiguous()
    G = 0.5 * (G + G.mT)
    got = ck.stationary_k_backward(X, X, p, G, "rbf", True)
    want = ck.k_backward_plain(X.double(), X.double(), p.double(), G.double(), "rbf", True)
    errs = []
    for name, a, w in zip(("dparams", "dX", "dZ"), got, want):
        _close(f"B2 {name} (1, {n}, {n}) Q={q}", a, w, rtol=1e-4,
               atol=1e-4 * float(w.abs().max()))
        errs.append(_max_err(a, w))
    ms = _time_ms(lambda: ck.stationary_k_backward(X, X, p, G, "rbf", True))
    plain = _time_ms(lambda: ck.k_backward_plain(X, X, p, G, "rbf", True), calls=5)
    bound = _bound(_nbytes(G, X, p, got[0], got[1], got[2]), G.numel() * _k_bwd_flops(q))
    print(f"# B2 stationary_k_backward (1, {n}, {n}) Q={q} RBF ARD, parameters + dX + dZ (the "
          f"GPLVM's trainable X): kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); max |kernel - plain| "
          f"{max(errs):.3e}")
    return {"ms": ms, "plain_ms": plain, **bound, "max_abs_err": max(errs)}


def phase_latent(where=None, gplvm_steps=None, bgplvm_steps=None, n3=LATENT_LEG3_N,
                 steps3=LATENT_LEG3_STEPS, save=True):
    """Phase 11: the latent-variable models, float32 on the card with no device
    given. Leg 1, the point GPLVM, carries B1 / B2 / B3; its launch counts are
    zeroed just before its fit and read after its infer_newX. Every leg runs;
    the phase fails at its end if any check failed."""
    from gaussian_process_optimization_tpu_torch import workload

    where = {} if where is None else where
    gplvm_steps = workload.GPLVM_STEPS if gplvm_steps is None else gplvm_steps
    bgplvm_steps = workload.BGPLVM_STEPS if bgplvm_steps is None else bgplvm_steps
    failures = []
    t0 = _now()
    l1, gplvm, s1 = _leg_gplvm(where, failures, gplvm_steps)
    l2, bgplvm, s2 = _leg_bgplvm(where, failures, bgplvm_steps)
    t2 = _now()
    l3, fitted, _ = _leg_models(where, failures, n3, steps3)
    t3 = _now()
    if save:
        _save_fitted({"gplvm": gplvm, "bgplvm": bgplvm, **fitted})
    print(f"# latent: phase 11 took {t3 - t0:.1f} s (leg 1 {', '.join(f'{k} {v:.2f} s' for k, v in s1.items())}; "
          f"leg 2 {', '.join(f'{k} {v:.2f}' for k, v in s2.items())}; leg 3 {t3 - t2:.1f} s); "
          f"launches leg 1 {l1}, leg 2 {l2}, leg 3 {l3}")
    if failures:
        raise AssertionError("latent: " + "; ".join(failures))
    return l1


# ------------------------------------------------------------- phase 12: sharded
# The JAX package's own float32 gaps on its 8-device CPU mesh at this phase's
# sizes (tests/test_torch_sharded.py::test_jax_f32_readings_behind_phase_12_limits);
# each limit is 10x its reading, floored at SHARDED_FLOOR (float32's rounding
# of a sum of a few thousand terms). "bo_ei_vs_f64" is read at the card's
# fitted BayesianOptimization(mesh=...) surrogate and suggestion
# (tests/data/sharded_bo_fitted.npz; test_jax_f32_ei_reading_at_the_cards_bo_fit):
# there cond(Ky) ~ 1e8 and float32's -EI is 6% off in both packages; its
# limit is 2.5x the reading (SHARDED_EI_F64_LIMIT). At the card's fit with the
# unbiased K (tests/data/sharded_bo_fitted_unbiased_k.npz;
# test_jax_f32_ei_mesh_vs_no_mesh_at_the_cards_bo_fit, pinned to one core) the
# JAX package's own float32 argmax with and without a 4-device mesh ends up to
# 2.31e-1 apart in -EI over five sweep seeds ("bo_ei_mesh_f32"; float64 2.1e-10,
# "bo_ei_mesh_f64"): the anchors' float32 lanes, batched otherwise, end in
# other optima. So the argmax with and without the mesh is compared in float64
# on the card at this phase's seed (SHARDED_EI_LIMIT, the main path's -EI
# limit). What the mesh computes is held at fixed points, the sweep and its
# best anchors: in float64 sharded against unsharded (SHARDED_BO_F64_LIMIT);
# in float32 each against float64 and against each other at 2x the JAX
# package's own float32 error there ("acq_*_vs_f64": 18-24%, the EI's best
# points resting on a variance ~1e-4 of k(x, x)). How far two float32
# programs drift apart moves with any change of rounding, the host's thread
# count included (1.4e-2 to 1.9e-1 for the sweep, prof_stages.mesh_sweep), so
# a sharded-vs-unsharded reading of either package is no limit. The fits'
# limit is the main path's (phase 4): -LML f32 vs f64 1e-3.
SHARDED_JAX_F32 = {
    "exact_vs_unsharded": 2.085e-07, "exact_vs_f64": 1.829e-07,
    "distributed_vs_unsharded": 6.254e-07, "distributed_vs_f64": 2.341e-07,
    "vardtc_vs_unsharded": 2.156e-06, "vardtc_vs_f64": 2.604e-04,
    "svgp_first_vs_unsharded": 2.080e-07, "svgp_first_vs_f64": 1.970e-07,
    "svgp_steps_vs_f64": 2.307e-03,
    "cholesky_vs_f64": 1.505e-06, "cholesky_vs_unsharded": 2.109e-06,
    "bo_ei_vs_f64": 6.332e-02,
    "bo_ei_mesh_f32": 2.308e-01, "bo_ei_mesh_f64": 2.108e-10,
    "acq_sweep_vs_f64": 2.235e-01, "acq_anchor_vs_f64": 2.388e-01,
    "acq_grad_vs_f64": 1.814e-01}
SHARDED_FLOOR = 1e-5
SHARDED_FIT_LIMIT = 1e-3
# the argmax with and without the mesh in float64 (the main path's -EI limit)
SHARDED_EI_LIMIT = 1e-2
# -EI f32 vs f64 at the card's BO fit: 2.5x the JAX package's reading there
# (the card's own reading was 9.53e-3 on an H100 80GB HBM3, 700 W)
SHARDED_EI_F64_LIMIT = 2.5 * SHARDED_JAX_F32["bo_ei_vs_f64"]
# the BO fit with and without the mesh in float64 on the card, where no
# float32 rounding can send a lane to another optimum
SHARDED_BO_F64_LIMIT = 1e-6
SWEEP_POINTS = 1000           # the mesh's float32 gate: seeded points in the box
FIXED_ANCHORS = 8             # and the best of them by -EI, one lane pair a shard
SHARDS = 4
SHARDED_RESTARTS = 2          # restarts a shard (8 in all)
SHARDED_STEPS = 30
SHARDED_CHOL_N = 8192         # the composite path's bucket: 32 panels of 256
SHARDED_SVGP_STEPS = 5
CLUSTER_SERIES = 40
CLUSTER_POINTS = 20
CLUSTER_MAXITER = 30          # the reference's 80 is a cut of depth: 147 s at 80
TRACE_DIR = ROOT / "chiprun_out" / "trace_phase12"
SHARDED_BO_FITTED = ROOT / "chiprun_out" / "sharded_bo_fitted.npz"
CLUSTER_FITTED = ROOT / "chiprun_out" / "cluster_first_round.npz"
# the clustering's first-round lane log likelihoods, float32 against float64
# at the same leaves and noise (max |LL32 - LL64| / max |LL64| over lanes):
# 10x the JAX package's own float32 reading at the card's leaves
# (tests/test_torch_cluster.py::test_jax_f32_first_round_reading_at_the_cards_leaves)
CLUSTER_LL_JAX_F32 = 1.483e-03
CLUSTER_LL_LIMIT = 10 * CLUSTER_LL_JAX_F32
# the float64 clustering's lanes a fit (its first round's 820 take the plain
# K route, which does not hold them at once in 80 GB)
CLUSTER_F64_LANES = 128


def _sharded_limit(key):
    return max(10.0 * SHARDED_JAX_F32[key], SHARDED_FLOOR)


def _mesh4():
    """Four shards: four cards where there are four, else four on card 0."""
    from gaussian_process_optimization_tpu_torch.parallel.sharded import make_mesh

    if torch.cuda.device_count() >= SHARDS:
        return make_mesh(SHARDS)
    return make_mesh(SHARDS, device="cuda:0")


class _Counted:
    """Adds the kernels' launches made inside the block to ``into``: the
    sharded calls only, not the unsharded and float64 comparisons."""

    def __init__(self, into):
        self.into = into

    def __enter__(self):
        self.before = _read_counts()

    def __exit__(self, *exc):
        after = _read_counts()
        for k in after:
            self.into[k] = self.into.get(k, 0) + after[k] - self.before[k]


def _check(name, value, ref, limit, failures):
    r = _rel(value, ref)
    print(f"# sharded, {name}: {float(value):.6f} vs {float(ref):.6f}, rel {r:.3e} "
          f"(limit {limit:.3g})")
    if not r <= limit:
        failures.append(f"{name}: rel {r:.3e} > {limit:.3g}")
    return r


def _report(leg, pt):
    for line in pt.report().splitlines():
        print(f"# sharded, {leg} split: {line.strip()}")


def _leg_sharded_exact(dev, mesh, acc, failures):
    """The sharded and the distributed -LML at the main data (N = 4096, ARD
    Matern52 at its start, noise 0.05)."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.parallel import sharded
    from gaussian_process_optimization_tpu_torch.utils.profiling import PhaseTimer

    pt = PhaseTimer()
    X, Y = workload.bench_data()
    m = workload.make_model(X, Y)
    args = (m.kern, m.X, m.Y, m.likelihood_variance)
    lml = sharded.make_sharded_exact_lml(mesh)
    dist = sharded.make_distributed_exact_lml(mesh, nb=256)
    with torch.no_grad():
        for rep in range(2):  # the first call builds; the second is timed
            tag = "" if rep else " (first)"
            with pt("sharded -LML" + tag), _Counted(acc):
                v, (_, _, ok) = lml(*args, m.mask)
                pt.sync(v)
            with pt("distributed -LML" + tag), _Counted(acc):
                d = dist(*args)
                pt.sync(d)
        with pt("unsharded -LML"):
            u = m.log_marginal_likelihood()
            pt.sync(u)
        f64 = _f64(m).log_marginal_likelihood()
    if not bool(ok):
        failures.append("sharded -LML: the gathered Gram did not factor")
    _check("exact -LML f32 sharded vs unsharded", v, u,
           _sharded_limit("exact_vs_unsharded"), failures)
    _check("exact -LML f32 sharded vs f64", v, f64, _sharded_limit("exact_vs_f64"), failures)
    _check("distributed -LML f32 vs unsharded", d, u,
           _sharded_limit("distributed_vs_unsharded"), failures)
    _check("distributed -LML f32 vs f64", d, f64, _sharded_limit("distributed_vs_f64"),
           failures)
    _report("exact N=4096", pt)
    return m, lml


def _b4_in_distributed_row(A):
    """B4 at G = 1 on the first diagonal block of the distributed Cholesky's
    matrix, beside its plain version, cholesky_ex and its bound."""
    from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl

    blk = A[None, :256, :256].contiguous()
    ms = _time_ms(lambda: cl.cholesky_blocks(blk))
    plain = _time_ms(lambda: cl.cholesky_plain(blk))
    lib = _time_ms(lambda: torch.linalg.cholesky_ex(blk))
    err = _check_chol("B4 G=1 inside the distributed Cholesky", blk, cl.cholesky_blocks(blk),
                      cl.cholesky_plain(blk))
    bound = _bound((256 * 257 // 2 + 256 * 256) * 4, 256 ** 3 / 3)
    print(f"# B4 cholesky_blocks G=1 nb=256 inside the distributed Cholesky: kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, library (cholesky_ex) {lib:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); max |kernel - plain| {err:.3e}")
    return err


def _leg_distributed_cholesky(dev, mesh, acc, failures):
    """chol of the main data's Gram at N = 8192 (32 panels), the diagonal
    blocks by cholesky_ex and by B4 (cuda_chol_blocks off, then on)."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.kernels.stationary import Matern52
    from gaussian_process_optimization_tpu_torch.parallel import sharded
    from gaussian_process_optimization_tpu_torch.utils import profiling
    from gaussian_process_optimization_tpu_torch.utils.profiling import PhaseTimer

    pt = PhaseTimer()
    n = SHARDED_CHOL_N
    X, _ = workload.bench_data(n=n)
    kern = Matern52.create(6, ARD=True)
    Xt = torch.as_tensor(X, dtype=torch.float32, device=dev)
    eye = torch.eye(n, device=dev)
    with torch.no_grad():
        A = kern.K(Xt) + 0.05 * eye
        A64 = _f64(kern).K(Xt.double()) + 0.05 * eye.double()
        L64 = torch.linalg.cholesky(A64)
        del A64
        with pt("unsharded cholesky_ex"):
            Lu = torch.linalg.cholesky(A)
            pt.sync(Lu)
    chol = sharded.make_distributed_cholesky(mesh, nb=256)
    scale = float(L64.abs().max())
    old = config.cuda_chol_blocks
    b4_err = 0.0
    try:
        for on in (False, True):
            config.cuda_chol_blocks = on
            tag = f"cuda_chol_blocks {'on' if on else 'off'}"
            before = profiling.counters["b4.launches"]
            with torch.no_grad():
                chol(A)  # builds
                with pt(f"distributed, {tag}"), _Counted(acc):
                    L = chol(A)
                    pt.sync(L)
            b4 = (profiling.counters["b4.launches"] - before) // 2
            e64 = float((L.double() - L64).abs().max()) / scale
            eu = float((L - Lu).abs().max()) / scale
            print(f"# sharded, distributed Cholesky N={n} {tag}: B4 launches a call {b4}; "
                  f"max |L - L64| / max |L64| {e64:.3e} (limit "
                  f"{_sharded_limit('cholesky_vs_f64'):.3g}), vs unsharded cholesky_ex "
                  f"{eu:.3e} (limit {_sharded_limit('cholesky_vs_unsharded'):.3g})")
            if not bool((torch.triu(L, 1) == 0).all()):
                failures.append(f"distributed Cholesky ({tag}): upper triangle not zero")
            if e64 > _sharded_limit("cholesky_vs_f64"):
                failures.append(f"distributed Cholesky ({tag}) vs f64 {e64:.3e}")
            if eu > _sharded_limit("cholesky_vs_unsharded"):
                failures.append(f"distributed Cholesky ({tag}) vs unsharded {eu:.3e}")
            if b4 != (n // 256 if on else 0):
                failures.append(f"distributed Cholesky ({tag}): B4 launched {b4} times a "
                                f"call, not {n // 256 if on else 0}")
            del L
        b4_err = _b4_in_distributed_row(A)
    finally:
        config.cuda_chol_blocks = old
    _report(f"distributed Cholesky N={n}", pt)
    return b4_err


def _leg_sharded_sparse(dev, mesh, acc, failures):
    """The VarDTC bound at the sparse example (N = 50 000, D = 2, M = 256:
    12 500 rows a shard) and five data-parallel SVGP Adam steps at BASELINE
    configuration 4 (batch 2048, 512 a shard)."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.models.svgp import make_svgp_train_step
    from gaussian_process_optimization_tpu_torch.parallel import sharded
    from gaussian_process_optimization_tpu_torch.utils.profiling import PhaseTimer

    pt = PhaseTimer()
    X, Y = workload.sparse_data()
    sp = workload.sparse_model(X, Y)
    ones = torch.ones(X.shape[0], device=dev)
    bound = sharded.make_sharded_vardtc_lml(mesh)
    with torch.no_grad():
        for rep in range(2):
            with pt("sharded VarDTC" + ("" if rep else " (first)")), _Counted(acc):
                b = bound(sp.kern, sp.Z, sp.X, sp.Y, sp.likelihood_variance, ones)
                pt.sync(b)
        with pt("unsharded VarDTC"):
            bu = sp.log_marginal_likelihood()
            pt.sync(bu)
        b64 = _f64(sp).log_marginal_likelihood()
    _check("VarDTC f32 sharded vs unsharded", b, bu, _sharded_limit("vardtc_vs_unsharded"),
           failures)
    _check("VarDTC f32 sharded vs f64", b, b64, _sharded_limit("vardtc_vs_f64"), failures)

    m = workload.svgp_model(X, Y)
    idx = np.random.default_rng(0).permutation(X.shape[0])[:SHARDED_SVGP_STEPS * 2048]
    idx = torch.as_tensor(idx.reshape(SHARDED_SVGP_STEPS, 2048), device=dev)
    Xt = torch.as_tensor(X, dtype=torch.float32, device=dev)
    Yt = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    _, init, step = sharded.make_sharded_svgp_step(m, mesh, learning_rate=workload.SVGP_LR)
    _, init64, step64 = sharded.make_sharded_svgp_step(_f64(m), mesh,
                                                       learning_rate=workload.SVGP_LR)
    _, _, _, ustep = make_svgp_train_step(learning_rate=workload.SVGP_LR)(m)
    u, opt = init(m)
    u64, opt64 = init64(_f64(m))
    rows = []
    for i in range(SHARDED_SVGP_STEPS):
        Xb, Yb = Xt[idx[i]], Yt[idx[i]]
        with pt("sharded SVGP step"), _Counted(acc):
            u, opt, v = step(u, opt, m, Xb, Yb)
            pt.sync(v)
        with pt("unsharded SVGP step"):
            vu = ustep(Xb, Yb)
            pt.sync(vu)
        u64, opt64, v64 = step64(u64, opt64, _f64(m), Xb.double(), Yb.double())
        rows.append((float(v), float(vu), float(v64)))
    print(f"# sharded, SVGP -ELBO per step (sharded f32, unsharded f32, f64): {rows}")
    first, later = rows[0], rows[1:]
    _check("SVGP first step f32 sharded vs unsharded", first[0], first[1],
           _sharded_limit("svgp_first_vs_unsharded"), failures)
    _check("SVGP first step f32 sharded vs f64", first[0], first[2],
           _sharded_limit("svgp_first_vs_f64"), failures)
    worst_u = max(_rel(a, b) for a, b, _ in later)
    worst_64 = max(_rel(a, c) for a, _, c in later)
    limit = _sharded_limit("svgp_steps_vs_f64")
    print(f"# sharded, SVGP steps 2-{SHARDED_SVGP_STEPS}: worst rel vs unsharded {worst_u:.3e}, "
          f"vs f64 {worst_64:.3e} (limit {limit:.3g})")
    if not (worst_u <= limit and worst_64 <= limit):
        failures.append(f"SVGP steps: rel {max(worst_u, worst_64):.3e} > {limit:.3g}")
    if not rows[-1][0] < rows[0][0]:
        failures.append("SVGP steps: the sharded -ELBO did not fall")
    _report("sparse N=50000", pt)


def _leg_sharded_fit(dev, mesh, acc, failures):
    """The restart-sharded multistart fit of the main path (2 restarts a
    shard, 8 in all, x 30 L-BFGS steps), against the unsharded Fitter from
    the same starts, and one BayesianOptimization(mesh=...) suggestion on the
    main data beside the same call without the mesh."""
    from gaussian_process_optimization_tpu_torch import convert, workload
    from gaussian_process_optimization_tpu_torch.bo import BayesianOptimization
    from gaussian_process_optimization_tpu_torch.bo.acquisitions import neg_ei
    from gaussian_process_optimization_tpu_torch.models.bo_models import masked_fmin
    from gaussian_process_optimization_tpu_torch.models.fit import Fitter
    from gaussian_process_optimization_tpu_torch.parallel import sharded
    from gaussian_process_optimization_tpu_torch.utils.profiling import PhaseTimer

    pt = PhaseTimer()
    X, Y = workload.bench_data()
    m = workload.make_model(X, Y)
    run = sharded.make_sharded_multistart_fit(m, mesh, restarts_per_device=SHARDED_RESTARTS,
                                              maxiter=SHARDED_STEPS, tol=0.0)
    starts = run.draw_starts(m, torch.Generator(device=dev).manual_seed(0))
    with pt("sharded fit"), _Counted(acc):
        fitted, res_s = run.solve(m, starts)
        pt.sync(res_s.f)
    fs = torch.where(torch.isfinite(res_s.f), res_s.f, torch.full_like(res_s.f, float("inf")))
    unsharded = Fitter(m, num_restarts=run.num_restarts, maxiter=SHARDED_STEPS, tol=0.0)
    with pt("unsharded fit"):
        _, res = unsharded.solve(m, starts)
        pt.sync(res.f)
    fu = torch.where(torch.isfinite(res.f), res.f, torch.full_like(res.f, float("inf")))
    # one shard's lanes alone on card 0: an evaluation of all shards takes
    # about SHARDS times as long where the shards run in turn, about as long
    # where they overlap on their cards
    alone = Fitter(m, num_restarts=SHARDED_RESTARTS, maxiter=SHARDED_STEPS, tol=0.0)
    with pt("one shard's lanes alone"):
        _, res_1 = alone.solve(m, starts[:SHARDED_RESTARTS])
        pt.sync(res_1.f)
    per_eval = [pt.totals[k] * 1e3 / f.evaluations for k, f in (
        ("sharded fit", run), ("unsharded fit", unsharded), ("one shard's lanes alone", alone))]
    print(f"# sharded, fit ms per batched evaluation on {len(set(mesh.shards()))} card(s): "
          f"{SHARDS} shards {per_eval[0]:.2f} ({run.evaluations} evaluations), unsharded "
          f"{per_eval[1]:.2f} ({unsharded.evaluations}), one shard's {SHARDED_RESTARTS} lanes "
          f"alone {per_eval[2]:.2f} ({alone.evaluations}); {SHARDS} shards / one shard "
          f"{per_eval[0] / per_eval[2]:.2f}")
    print(f"# sharded, fit -LML per lane: sharded {fs.tolist()}, unsharded {fu.tolist()}")
    _check("fit best -LML f32 sharded vs unsharded", fs.min(), fu.min(), SHARDED_FIT_LIMIT,
           failures)
    with torch.no_grad():
        f32 = -fitted.log_marginal_likelihood()
        f64 = -_f64(fitted).log_marginal_likelihood()
    _check("fitted -LML f32 vs f64", f32, f64, SHARDED_FIT_LIMIT, failures)
    _report("fit N=4096", pt)

    pt = PhaseTimer()
    domain = [{"name": f"x{i}", "type": "continuous", "domain": (-2.0, 2.0)}
              for i in range(X.shape[1])]
    kw = dict(f=None, domain=domain, X=X, Y=Y, acquisition_type="EI", seed=0,
              max_iters=SHARDED_STEPS, optimize_restarts=SHARDS * SHARDED_RESTARTS)
    bo = BayesianOptimization(mesh=mesh, **kw)
    opt = bo.acquisition_optimizer
    seed0 = opt._seed
    with pt("suggest, mesh"), _Counted(acc):
        x = bo.suggest_next_locations()
    _in_box("BayesianOptimization(mesh=...)", x)
    # the same acquisition on the same fitted model and sweep, without the mesh
    opt._seed, opt.mesh = seed0, None
    with pt("acquisition argmax, no mesh"):
        xa, fa = opt.optimize(acquisition=bo.acquisition)
    opt.mesh = mesh
    f_mesh = float(bo.acquisition.acquisition_function(x)[0, 0])
    print(f"# sharded, suggestion -EI f32 mesh vs no mesh (same model): {f_mesh:.6f} vs "
          f"{float(fa[0, 0]):.6f}, rel {_rel(f_mesh, float(fa[0, 0])):.3e} (a reading: the JAX "
          f"package's own float32 moves it up to {SHARDED_JAX_F32['bo_ei_mesh_f32']:.3e} over "
          f"five sweep seeds, its float64 {SHARDED_JAX_F32['bo_ei_mesh_f64']:.3e})")
    gp64 = _mesh_acquisition(bo, mesh, failures)
    # the fit without the mesh, from the same 8 starts in one lane batch: a
    # reading in float32 (the sharded fit is gated against it above, at fixed
    # data and settings); here the noise trains, and float32 lanes that differ
    # only in their batches' rounding can end in other optima. The same two
    # fits in float64 are gated: they must agree
    plain = BayesianOptimization(**kw)
    with pt("suggest, no mesh"):
        xu = plain.suggest_next_locations()
    with torch.no_grad():
        fits = [float(-b.model.model.log_marginal_likelihood()) for b in (bo, plain)]
    print(f"# sharded, BO fit -LML with the mesh {fits[0]:.6f}, without {fits[1]:.6f} (rel "
          f"{_rel(fits[0], fits[1]):.3e}, a reading)")
    fits64 = []
    for mesh_or_none in (mesh, None):
        b64 = BayesianOptimization(mesh=mesh_or_none, dtype=torch.float64, **kw)
        with pt("BO fit f64, " + ("mesh" if mesh_or_none else "no mesh")):
            b64._update_model()
            with torch.no_grad():
                fits64.append(float(-b64.model.model.log_marginal_likelihood()))
        if mesh_or_none is not None:
            # the argmax with and without the mesh on the same float64 model
            o64 = b64.acquisition_optimizer
            s64 = o64._seed
            with pt("acquisition argmax f64, mesh"):
                _, f64_mesh = o64.optimize(acquisition=b64.acquisition)
            o64._seed, o64.mesh = s64, None
            with pt("acquisition argmax f64, no mesh"):
                _, f64_plain = o64.optimize(acquisition=b64.acquisition)
            o64.mesh = mesh
    _check("BO fit -LML f64 mesh vs no mesh", fits64[0], fits64[1], SHARDED_BO_F64_LIMIT,
           failures)
    _check("suggestion -EI f64 mesh vs no mesh (same model)", float(f64_mesh[0, 0]),
           float(f64_plain[0, 0]), SHARDED_EI_LIMIT, failures)
    # the leaves go to chiprun_out for the JAX package's own float32 readings
    gp, post, fmin = bo.model.device_state()
    SHARDED_BO_FITTED.parent.mkdir(exist_ok=True)
    np.savez_compressed(SHARDED_BO_FITTED, x=np.asarray(x), **convert.leaves_of(gp))
    with torch.no_grad():
        post64 = gp64.inference(precompute_inverse=True)
        xt = torch.as_tensor(x, dtype=torch.float64, device=dev)
        ei64 = float(neg_ei(gp64, post64, masked_fmin(gp64, post64), xt)[0])
        ei32 = float(neg_ei(gp, post, fmin, xt.float())[0])
    print(f"# sharded, suggestion with the mesh {x.tolist()}, without {xu.tolist()}, argmax "
          f"without the mesh on the mesh's model {xa.tolist()}; fitted noise "
          f"{float(gp.likelihood_variance):.4g}")
    _check("suggestion -EI f32 vs f64", ei32, ei64, SHARDED_EI_F64_LIMIT, failures)
    _report("BayesianOptimization(mesh=...)", pt)


def _f64_at_f32_leaves(gp):
    """``gp`` in float64 at its float32 leaves and at the noise float32
    evaluates (float32 floors it at ``config.f32_noise_floor``, float64 does
    not)."""
    import dataclasses

    from gaussian_process_optimization_tpu_torch.config import config

    floor = config.f32_noise_floor - config.noise_jitter
    return dataclasses.replace(_f64(gp), likelihood_variance=torch.clamp(
        gp.likelihood_variance.double(), min=floor))


def _gate(name, r, limit, failures):
    print(f"# sharded, {name}: rel {r:.3e} (limit {limit:.3g})")
    if not r <= limit:
        failures.append(f"{name}: rel {r:.3e} > {limit:.3g}")


def _mesh_acquisition(bo, mesh, failures):
    """What the mesh changes in the argmax, at fixed points: -EI at
    SWEEP_POINTS seeded points in the box, its rows split over the shards,
    and -EI with its gradient at the FIXED_ANCHORS best of them, the lanes
    split as the L-BFGS call splits them, each against the same rows or lanes
    unsplit. In float64 at the float32 run's leaves no rounding of the mesh's
    can move them past SHARDED_BO_F64_LIMIT. In float32, sharded and
    unsharded are each held against float64 and against each other at twice
    the JAX package's own float32 error at those points (two values each
    within it of float64 differ by at most twice it), with a control: the
    anchors' lanes gathered one shard out of place must read past it. The
    points are those of tests/test_torch_sharded.py::fixed_anchor_points.
    Returns the float64 model."""
    from gaussian_process_optimization_tpu_torch.bo.acquisitions import neg_ei
    from gaussian_process_optimization_tpu_torch.models.bo_models import masked_fmin
    from gaussian_process_optimization_tpu_torch.parallel import sharded

    gp, post, _ = bo.model.device_state()
    gp64 = _f64_at_f32_leaves(gp)
    with torch.no_grad():
        post64 = gp64.inference(precompute_inverse=True)
        args = {torch.float32: (gp, post, masked_fmin(gp, post)),
                torch.float64: (gp64, post64, masked_fmin(gp64, post64))}

    def neg(A, a):
        return neg_ei(*a, A)

    P = np.random.default_rng(0).uniform(-2.0, 2.0, size=(SWEEP_POINTS, 6))
    pts = torch.as_tensor(P, dtype=gp.X.dtype, device=gp.X.device)
    with torch.no_grad():
        anchors = pts[torch.argsort(neg(pts, args[torch.float32]))[:FIXED_ANCHORS]]

    def readings(a):
        """{(what, "sharded" | "unsharded"): values} in a's dtype."""
        dtype = a[0].X.dtype
        P_, U_ = pts.to(dtype), anchors.to(dtype)
        with torch.no_grad():
            out = {("the sweep's -EI", "unsharded"): neg(P_, a),
                   ("the sweep's -EI", "sharded"):
                       sharded.make_sharded_sweep(lambda a, A: neg(A, a), mesh)(a, P_)}
        for name, fun in (("unsharded", lambda U: neg(U, a)),
                          ("sharded", sharded.sharded_lanes(
                              mesh, neg, [sharded.place(a, d) for d in mesh.shards()]))):
            U = U_.clone().requires_grad_(True)
            v = fun(U)
            (g,) = torch.autograd.grad(v.sum(), U)
            out["the anchors' -EI", name] = v.detach()
            out["the anchors' -EI gradient", name] = g
        return out

    r32, r64 = readings(args[torch.float32]), readings(args[torch.float64])
    keys = {"the sweep's -EI": "acq_sweep_vs_f64", "the anchors' -EI": "acq_anchor_vs_f64",
            "the anchors' -EI gradient": "acq_grad_vs_f64"}
    shift = FIXED_ANCHORS // SHARDS
    for what, key in keys.items():
        _gate(f"{what} f64, sharded vs unsharded", _rel(r64[what, "sharded"],
                                                        r64[what, "unsharded"]),
              SHARDED_BO_F64_LIMIT, failures)
        limit = 2 * SHARDED_JAX_F32[key]
        for name in ("unsharded", "sharded"):
            _gate(f"{what} f32 vs f64, {name}", _rel(r32[what, name], r64[what, "unsharded"]),
                  limit, failures)
        _gate(f"{what} f32, sharded vs unsharded", _rel(r32[what, "sharded"],
                                                        r32[what, "unsharded"]),
              limit, failures)
        if what != "the sweep's -EI":
            control = _rel(torch.roll(r32[what, "sharded"], shift, 0), r32[what, "unsharded"])
            print(f"# sharded, control for {what} f32, the lanes gathered one shard out of "
                  f"place: rel {control:.3e} (must exceed {limit:.3g})")
            if not control > limit:
                failures.append(f"{what}: the control reads {control:.3e}, not past "
                                f"{limit:.3g}")
    return gp64


def _leg_profile(mesh, m, lml, acc, failures):
    """One sharded -LML under torch.profiler; the Chrome trace goes to
    chiprun_out/trace_phase12 and must name B1's kernel."""
    from gaussian_process_optimization_tpu_torch.utils.profiling import trace

    with trace(str(TRACE_DIR)) as prof, torch.no_grad(), _Counted(acc):
        v, _ = lml(m.kern, m.X, m.Y, m.likelihood_variance, m.mask)
        float(v)
    rows = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))

    top = sorted(rows, key=dev_us, reverse=True)[:5]
    print("# sharded, profile of one sharded -LML: " + "; ".join(
        f"{e.key[:60]} {dev_us(e) / 1e3:.3f} ms" for e in top))
    text = (TRACE_DIR / "trace.json").read_text()
    if "k_build_kernel" not in text:
        failures.append("profile: the trace does not name B1's kernel (k_build_kernel)")
    else:
        print(f"# sharded, trace {TRACE_DIR / 'trace.json'} ({len(text) / 1e6:.1f} MB) names "
              "B1's kernel k_build_kernel")


def _family_sets(groups, fam):
    return [sorted({fam[i] for i in g}) for g in groups]


def _four_families(found):
    return (len(found) == 4 and all(len(f) == 1 for f in found)
            and sorted(f[0] for f in found) == [0, 1, 2, 3])


def _first_round_items(data, inputs):
    """The lanes of ``utils/cluster.cluster``'s first round, in its order: each
    series alone, then each pair with every earlier series."""
    data = [np.asarray(d, dtype=float) for d in data]
    inputs = [np.asarray(x, dtype=float) for x in inputs]
    items = []
    for i in range(len(data)):
        items.append((inputs[i], data[i].T, np.zeros(inputs[i].shape[0])))
        for j in range(i):
            items.append((np.vstack([inputs[i], inputs[j]]), np.vstack([data[i].T, data[j].T]),
                          np.concatenate([np.zeros(inputs[i].shape[0]),
                                          np.ones(inputs[j].shape[0])])))
    return items


def _leg_cluster(acc, failures):
    """Offset-GP clustering of CLUSTER_SERIES series (first round: all
    singles and pairs, 820 lanes at n_max = 800), no device given, each lane
    fit cut to CLUSTER_MAXITER L-BFGS steps: the first round in float32 (its
    lane log likelihoods against float64 at the same leaves, gated, with a
    control; the float32 clustering's later rounds are cut, a cut of depth:
    ``prof_stages --cluster`` runs it to its end and prints each join beside
    float64), then the whole clustering in float64 on the card, which must
    find the four families."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.prof_stages import refit
    from gaussian_process_optimization_tpu_torch.utils.cluster import (cluster, f32_effective,
                                                                       lane_lml)

    data, inputs, fam = workload.cluster_data(CLUSTER_SERIES, CLUSTER_POINTS)
    items = _first_round_items(data, inputs)
    t0 = _now()
    with _Counted(acc):
        ll32, U = refit(items, CLUSTER_MAXITER, n_max=CLUSTER_SERIES * CLUSTER_POINTS)
    t1 = _now()
    U = U.astype(np.float32)      # the float32 leaves, exactly
    print(f"# cluster f32: {CLUSTER_SERIES} series x {CLUSTER_POINTS} points, the first round's "
          f"{len(items)} lanes at n_max {CLUSTER_SERIES * CLUSTER_POINTS}, {CLUSTER_MAXITER} "
          f"steps: {t1 - t0:.2f} s (the later rounds cut: depth)")
    ll64 = lane_lml(f32_effective(U), items, dtype=torch.float64)
    # the control: the float32 lanes with their offsets dropped
    no_offset = U.copy()
    no_offset[:, 3] = 0.0
    control = lane_lml(no_offset, items, dtype=torch.float32)

    def rel(a):
        return float(np.max(np.abs(a - ll64)) / np.max(np.abs(ll64)))

    CLUSTER_FITTED.parent.mkdir(exist_ok=True)
    np.savez_compressed(CLUSTER_FITTED, U=U, ll32=ll32, ll64=ll64)
    print(f"# cluster f32, first round's {len(items)} lane log likelihoods against float64 at "
          f"the same leaves and noise: max |diff| / max |LL64| {rel(ll32):.3e} (limit "
          f"{CLUSTER_LL_LIMIT:.3g}; leaves in {CLUSTER_FITTED}); the control, the same lanes "
          f"with their offsets dropped, {rel(control):.3e} (must exceed it)")
    if not rel(ll32) <= CLUSTER_LL_LIMIT:
        failures.append(f"cluster: first round's float32 lane log likelihoods {rel(ll32):.3e} "
                        f"from float64, past {CLUSTER_LL_LIMIT:.3g}")
    if not rel(control) > CLUSTER_LL_LIMIT:
        failures.append(f"cluster: the control (offsets dropped) reads {rel(control):.3e}, not "
                        f"past {CLUSTER_LL_LIMIT:.3g}")
    t2 = _now()
    groups64 = cluster([d.copy() for d in data], [x.copy() for x in inputs],
                       maxiter=CLUSTER_MAXITER, dtype=torch.float64,
                       max_lanes=CLUSTER_F64_LANES)
    t3 = _now()
    found64 = _family_sets(groups64, fam)
    print(f"# cluster f64 on the card: {t3 - t2:.2f} s, {len(groups64)} groups, families per "
          f"group {found64}, sizes {[len(g) for g in groups64]}")
    if not _four_families(found64):
        failures.append(f"cluster: the float64 groups {found64} are not the four families")
    return t1 - t0


def _leg_plots(failures):
    """The plot family through the 'none' backend on the main and latent
    models (no drawing library is needed)."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.kernels.stationary import Matern52
    from gaussian_process_optimization_tpu_torch.utils import plotting_library as pl

    t0 = _now()
    pl.change_plotting_library("none")
    try:
        X, Y = workload.bench_data()
        m = workload.make_model(X, Y)
        fixed = pl.fixed_inputs(m, [0])
        for name in ("plot", "plot_mean", "plot_confidence", "plot_samples", "plot_density",
                     "plot_f"):
            getattr(m, name)(visible_dims=[0], fixed_inputs=fixed, resolution=100)
        m.plot_errorbars_trainset()
        Yl, _, _ = workload.latent_data()
        g = workload.gplvm_model(Yl)
        g.plot_latent(resolution=8)
        _, steep, _ = g.plot_steepest_gradient_map(resolution=5)
        b = workload.bgplvm_model(Yl)
        _, M = b.plot_magnification(resolution=8)
        b.plot_latent(resolution=8)
        _, sens = m.kern.plot_ARD()
        _, K = Matern52.create(1).plot_covariance()
    finally:
        pl.change_plotting_library("matplotlib")
    t1 = _now()
    ok = all(np.all(np.isfinite(a)) for a in (steep, M, sens, K))
    print(f"# plots through the 'none' backend (main model sliced to input 0; GPLVM and "
          f"Bayesian GPLVM at N=4096): {t1 - t0:.2f} s, arrays finite {ok}")
    if not ok:
        failures.append("plots: a plotted array is not finite")


def _kernel_rows_sharded(dev):
    """B1 at a shard's row block (1024 x 4096, D = 6) beside the whole K, and
    B1 / B2 at the clustering lanes (820 x 800 x 800, D = 1, one RBF per lane,
    every gradient: the offsets move both inputs)."""
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device=dev).manual_seed(12)
    X = (4 * torch.rand(1, 4096, 6, generator=gen, device=dev) - 2).contiguous()
    p = _matern_rows(dev, 1, gen)
    rows = X[:, :1024].contiguous()
    got = ck.stationary_k_build(rows, X, p, "matern52", True)
    want = ck.k_build_plain(rows, X, p, "matern52", True)
    _close("B1 1024x4096 row block", got, want, rtol=2e-5, atol=2e-6)
    err = _max_err(got, want)
    ms = _time_ms(lambda: ck.stationary_k_build(rows, X, p, "matern52", True))
    plain = _time_ms(lambda: ck.k_build_plain(rows, X, p, "matern52", True))
    whole = _time_ms(lambda: ck.stationary_k_build(X, X, p, "matern52", True))
    bound = _bound(_nbytes(rows, X, p, got), got.numel() * _k_flops(6))
    print(f"# B1 stationary_k_build 1024x4096 (a shard's row block of the main data): "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); the whole 4096x4096 {whole:.4f} ms; max |kernel - plain| "
          f"{err:.3e}")
    errs = [err]
    B, n = CLUSTER_SERIES * (CLUSTER_SERIES + 1) // 2, CLUSTER_SERIES * CLUSTER_POINTS
    Xc = (3 * torch.rand(B, n, 1, generator=gen, device=dev)).contiguous()
    pc = torch.zeros(B, 8, device=dev)
    pc[:, 0] = 0.5 + torch.rand(B, generator=gen, device=dev)
    pc[:, 2] = 0.5 + torch.rand(B, generator=gen, device=dev)
    K = ck.stationary_k_build(Xc, Xc, pc, "rbf", False)
    idx = torch.randint(0, B, (8,), generator=gen, device=dev)
    want = ck.k_build_plain(Xc[idx], Xc[idx], pc[idx], "rbf", False)
    _close("B1 clustering lanes", K[idx], want, rtol=2e-5, atol=2e-6)
    errs.append(_max_err(K[idx], want))
    ms = _time_ms(lambda: ck.stationary_k_build(Xc, Xc, pc, "rbf", False), calls=5)
    plain = _time_ms(lambda: ck.k_build_plain(Xc, Xc, pc, "rbf", False), calls=2, rounds=3)
    bound = _bound(_nbytes(Xc, pc, K), K.numel() * _k_flops(1))
    print(f"# B1 stationary_k_build {B}x{n}x{n} D=1 RBF (the clustering lanes): kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); max |kernel - plain| on 8 lanes {errs[-1]:.3e}")
    G = (torch.rand(B, n, n, generator=gen, device=dev) - 0.5).contiguous()
    del K
    got = ck.stationary_k_backward(Xc, Xc, pc, G, "rbf", False)
    want = ck.k_backward_plain(Xc[idx].double(), Xc[idx].double(), pc[idx].double(),
                               G[idx].double(), "rbf", False)
    for name, a, w in zip(("dparams", "dX", "dZ"), got, want):
        _close(f"B2 {name} clustering lanes", a[idx], w, rtol=1e-4,
               atol=1e-4 * float(w.abs().max()))
        errs.append(_max_err(a[idx], w))
    ms = _time_ms(lambda: ck.stationary_k_backward(Xc, Xc, pc, G, "rbf", False), calls=5)
    plain = _time_ms(lambda: ck.k_backward_plain(Xc, Xc, pc, G, "rbf", False), calls=1,
                     rounds=3, warmup=1)
    bound = _bound(_nbytes(Xc, pc, G, *got), G.numel() * _k_bwd_flops(1))
    print(f"# B2 stationary_k_backward {B}x{n}x{n} D=1 RBF, parameters + dX + dZ (the "
          f"clustering lanes): kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); max |kernel - plain| on 8 "
          f"lanes {max(errs[-3:]):.3e}")
    return errs


def phase_sharded(dev):
    """Phase 12: the multi-device layer on a 4-shard mesh, offset-GP
    clustering, a profiler trace and the plot family, float32 on the card.
    Launches are counted around the sharded calls (``launches_sharded``) and
    the clustering (``launches_cluster``) only. Every leg runs; the phase fails
    at its end if any check failed."""
    failures = []
    mesh = _mesh4()
    print(f"# sharded: {mesh} on {torch.cuda.device_count()} card(s)")
    t0 = _now()
    errs = _kernel_rows_sharded(dev)
    sharded, clustered = {}, {}
    m, lml = _leg_sharded_exact(dev, mesh, sharded, failures)
    b4_err = _leg_distributed_cholesky(dev, mesh, sharded, failures)
    _leg_sharded_sparse(dev, mesh, sharded, failures)
    _leg_sharded_fit(dev, mesh, sharded, failures)
    _leg_profile(mesh, m, lml, sharded, failures)
    t1 = _now()
    cluster_s = _leg_cluster(clustered, failures)
    _leg_plots(failures)
    t2 = _now()
    print(f"# sharded: phase 12 took {t2 - t0:.1f} s (sharded legs {t1 - t0:.1f} s, "
          f"clustering {cluster_s:.1f} s); launches sharded {sharded}, clustering {clustered}")
    for k in ("B1", "B2", "B3"):
        if sharded[k] <= 0:
            failures.append(f"sharded legs: kernel {k} was never launched")
    if sharded["B4"] <= 0:
        failures.append("sharded legs: B4 was never launched (cuda_chol_blocks on)")
    for k in ("B1", "B2"):
        if clustered[k] <= 0:
            failures.append(f"clustering: kernel {k} was never launched")
    if failures:
        raise AssertionError("sharded: " + "; ".join(failures))
    return sharded, clustered, errs, b4_err


# ------------------------------------------------------------- phase 13: examples
# tests/test_gallery.py::OPTIMIZED at its budgets
EXAMPLES_OPTIMIZED = [
    ("regression", "toy_rbf_1d", dict(max_iters=30)),
    ("regression", "sparse_GP_regression_1D", dict(num_samples=40, max_iters=20)),
    ("regression", "warped_gp_cubic_sine", dict(max_iters=20)),
    ("classification", "toy_linear_1d_classification", {}),
    ("dimensionality_reduction", "gplvm_simulation", dict(max_iters=30)),
    ("non_gaussian", "student_t_approx", dict(max_iters=15)),
    ("state_space", "state_space_example", dict(max_iters=15, n=120)),
]
# the card's float32 objective of an unoptimized demo against the port's
# float64 on the CPU: 10x the port's own float32 gap on the CPU, floored at
# 1e-6 and capped at 1e-2 of the objective, so that a wrong value fails
# whatever the CPU's float32 reads
EXAMPLES_GAP_FACTOR = 10.0
EXAMPLES_REL_FLOOR = 1e-6
EXAMPLES_REL_CAP = 1e-2
# (module, demo, objective index): the objectives whose float32 the cap cannot
# hold, because the JAX package's own float32 on the CPU is further than
# EXAMPLES_REL_CAP / EXAMPLES_GAP_FACTOR from its float64
# (tests/test_torch_gallery.py holds each to that). Each also runs on the card
# in float64, held to the CPU's float64 at EXAMPLES_F64_RTOL; its float32
# reading is printed unchecked (ROADMAP C16).
EXAMPLES_F32_ILL_POSED = {
    ("classification", "oil", 0):
        "EPDTC: Qnn << Knn at most points in 12-D, so the cavity 1/sigma^2 - tau "
        "loses tau; sites fall to the floor and the bound's terms cancel",
    ("classification", "sparse_toy_linear_1d_classification_uncertain_input", 0):
        "Kmm near singular: float32 takes a higher rung of the jitter ladder than "
        "float64, which moves the psi2 bound",
    ("non_gaussian", "student_t_approx", 2):
        "TPRegression: K carries only the 1e-8 jitter, cond ~1e8",
}
EXAMPLES_F64_RTOL = 1e-6
# an optimized demo ends no worse than it started, to float32's rounding
EXAMPLES_START_SLACK = 1e-6
EXAMPLES_SVGP_STEPS = 50      # large_scale_sparse's 300 SVGP steps, cut (depth)
# The examples' models at their own sizes stay under B1's gate (128^2 elements)
# except large_scale_sparse, and under B3's 256-row block all of them: the
# Forrester example at this N puts an example's GPRegression fit on B1-B3.
EXAMPLES_KERNEL_N = 512


def _demo_objectives(out):
    """The objectives in what a gallery demo returns: each model's
    ``log_marginal_likelihood``, a returned bound, a returned dict's values."""
    if hasattr(out, "log_marginal_likelihood"):
        return [float(out.log_marginal_likelihood())]
    if isinstance(out, tuple):
        return [v for o in out for v in _demo_objectives(o)]
    if isinstance(out, dict):
        return [float(v) for v in out.values()]
    return [float(out)]


def _unoptimized(fn, **kw):
    import inspect

    params = inspect.signature(fn).parameters
    kw.update({k: False for k in ("optimize", "plot") if k in params})
    return fn(**kw)


def _gallery_demos():
    import inspect

    from gaussian_process_optimization_tpu_torch.examples import gallery

    return [(m.__name__.split(".")[-1], name, f) for m in gallery.MODULES
            for name, f in inspect.getmembers(m, inspect.isfunction)
            if not name.startswith("_") and f.__module__ == m.__name__]


def _leg_gallery(failures):
    """Every gallery demo unoptimized on the card (float32, no device given),
    each objective against the port's float64 on the CPU; the demos of
    EXAMPLES_F32_ILL_POSED also in float64 on the card."""
    demos = _gallery_demos()
    worst = 0.0
    for mod, name, fn in demos:
        card = _demo_objectives(_unoptimized(fn))
        f64 = _demo_objectives(_unoptimized(fn, device="cpu", dtype=torch.float64))
        f32 = _demo_objectives(_unoptimized(fn, device="cpu", dtype=torch.float32))
        ill = [i for i in range(len(card)) if (mod, name, i) in EXAMPLES_F32_ILL_POSED]
        card64 = _demo_objectives(_unoptimized(fn, dtype=torch.float64)) if ill else None
        for i, (c, a, b) in enumerate(zip(card, f64, f32)):
            tag = f"{mod}.{name}" + (f"[{i}]" if len(card) > 1 else "")
            if i in ill:
                err, limit = abs(card64[i] - a), EXAMPLES_F64_RTOL * abs(a)
                print(f"# examples: {tag}: card f64 {card64[i]:.12g}, CPU f64 {a:.12g}, "
                      f"|diff| {err:.3e} (limit {limit:.3e}); card f32 {c:.9g}, CPU f32 "
                      f"{b:.9g}, unchecked: {EXAMPLES_F32_ILL_POSED[mod, name, i]}")
                if not err <= limit:
                    failures.append(f"gallery {tag}: card f64 {card64[i]} vs CPU f64 {a}")
                continue
            limit = min(max(EXAMPLES_GAP_FACTOR * abs(b - a), EXAMPLES_REL_FLOOR * abs(a)),
                        EXAMPLES_REL_CAP * abs(a))
            err = abs(c - a)
            worst = max(worst, err / limit if limit > 0 else math.inf)
            print(f"# examples: {tag}: card f32 {c:.9g}, CPU f64 {a:.9g}, |diff| {err:.3e} "
                  f"(limit {limit:.3e}; CPU f32 gap {abs(b - a):.3e})")
            if not (math.isfinite(c) and err <= limit):
                failures.append(f"gallery {tag}: card f32 {c} vs CPU f64 {a} past {limit:.3e}")
    return len(demos), worst


def _leg_gallery_optimized(failures):
    """tests/test_gallery.py::OPTIMIZED on the card: each demo's objectives end
    finite and no worse than where they started."""
    demos = {(mod, name): fn for mod, name, fn in _gallery_demos()}
    for mod, name, kw in EXAMPLES_OPTIMIZED:
        fn = demos[mod, name]
        start = _demo_objectives(_unoptimized(fn, **{k: v for k, v in kw.items()
                                                    if k != "max_iters"}))
        t0 = _now()
        end = _demo_objectives(fn(optimize=True, **kw))
        t1 = _now()
        print(f"# examples: optimized {mod}.{name} {kw}: objective {start} -> {end} "
              f"({t1 - t0:.2f} s)")
        for s, e in zip(start, end):
            if not (math.isfinite(e) and e >= s - EXAMPLES_START_SLACK * abs(s)):
                failures.append(f"optimized {mod}.{name}: objective {s} -> {e}")


def _check_example(name, ok, failures, detail):
    print(f"# examples: {name}: {detail}")
    if not ok:
        failures.append(f"example {name}: {detail}")


def _leg_example_scripts(failures, seconds):
    """The nine example twins at tests/test_examples.py's arguments, each held
    to what the reference's test checks. The BO examples run one iteration,
    large_scale_sparse its full N with the SVGP cut to EXAMPLES_SVGP_STEPS; plots
    go through the 'none' backend (no drawing library on the card's machine)."""
    import tempfile

    from gaussian_process_optimization_tpu_torch.bo import objectives
    from gaussian_process_optimization_tpu_torch.examples import (
        branin_bo, classification_and_latents, forrester_gp, large_scale_sparse,
        latent_inference, latent_plots_and_clustering, mixed_design_batch, multichip_bo,
        uncertainty_quantification)
    from gaussian_process_optimization_tpu_torch.utils import plotting_library as pl

    lo, hi = np.asarray(objectives.branin.bounds).T
    here = os.getcwd()
    pl.change_plotting_library("none")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)

            def timed(name, fn):
                t0 = _now()
                out = fn()
                seconds[name] = _now() - t0
                return out

            bo = timed("branin_bo", lambda: branin_bo.main(max_iter=1, plot=False))
            _check_example("branin_bo", bo.Y.shape[0] == 6 and np.isfinite(bo.fx_opt)
                           and np.all((bo.X >= lo) & (bo.X <= hi)), failures,
                           f"{bo.Y.shape[0]} evaluations, best {bo.fx_opt:.5f}")
            bo = timed("multichip_bo", lambda: multichip_bo.main(max_iter=1))
            _check_example("multichip_bo", bo.Y.shape[0] == 6 and np.isfinite(bo.fx_opt)
                           and np.all((bo.X >= lo) & (bo.X <= hi)), failures,
                           f"{bo.Y.shape[0]} evaluations on a {multichip_bo.CARD_SHARDS}-shard "
                           f"mesh, best {bo.fx_opt:.5f}")
            X, Y = timed("mixed_design_batch", lambda: mixed_design_batch.main(
                iterations=1, batch=2, state_file="st.npz"))
            X2, _ = timed("mixed_design_batch resumed", lambda: mixed_design_batch.main(
                iterations=1, batch=2, state_file="st.npz"))
            _check_example("mixed_design_batch", X.shape[0] == 14 and X2.shape[0] >= 14
                           and np.all(np.isfinite(Y)), failures,
                           f"{X.shape[0]} rows, {X2.shape[0]} after the resume")
            m = timed("forrester_gp", lambda: forrester_gp.main(n=12, plot=True,
                                                               out="f.png"))
            _check_example("forrester_gp", float(m.kern.lengthscale) > 0, failures,
                           f"lengthscale {float(m.kern.lengthscale):.4f}")
            lml_ss, lml_dense = timed("classification_and_latents",
                                      lambda: classification_and_latents.main(plot=False))
            _check_example("classification_and_latents",
                           abs(lml_ss - lml_dense) < 1e-3 * max(1.0, abs(lml_dense)),
                           failures, f"state-space LML {lml_ss:.5f}, dense {lml_dense:.5f}")
            rmse = timed("latent_inference infer_newX",
                         lambda: latent_inference.infer_newx_demo(n=30, maxiter=150))
            m_mh, m_hmc, rate = timed("latent_inference MCMC",
                                      lambda: latent_inference.mcmc_tail_demo(num_samples=800))
            _check_example("latent_inference", rmse < 0.3 and 0.05 < rate < 0.95
                           and abs(m_mh[0] - 1.0) < 0.5 and abs(m_hmc[0] - 1.0) < 0.5,
                           failures, f"RMSE {rmse:.4f}, MH accept {rate:.2f}, means "
                           f"{np.round(m_mh, 3)} / {np.round(m_hmc, 3)}")
            _, rec, loc_err, groups = timed(
                "latent_plots_and_clustering",
                lambda: latent_plots_and_clustering.main(plot=True, outdir=tmp, maxiter=80))
            _check_example("latent_plots_and_clustering",
                           np.isfinite(rec) and np.isfinite(loc_err)
                           and sorted(sorted(g) for g in groups) == [[0, 1], [2, 3]], failures,
                           f"reconstruction {rec:.3f}, placement {loc_err:.3f}, groups "
                           f"{sorted(sorted(g) for g in groups)}")
            gp, tp, _, _ = timed("uncertainty_quantification", uncertainty_quantification.main)
            Xs = torch.as_tensor(np.linspace(-2, 2, 5)[:, None], dtype=gp.X.dtype,
                                 device=gp.X.device)
            (glo, ghi), (tlo, thi) = gp.predict_quantiles(Xs), tp.predict_quantiles(Xs)
            _check_example("uncertainty_quantification", bool(torch.all(thi - tlo > ghi - glo)),
                           failures, "TP bands wider than the GP's at all 5 points")
            fitted, _ = timed("large_scale_sparse", lambda: large_scale_sparse.main(
                svgp_steps=EXAMPLES_SVGP_STEPS))
            Xs = np.random.default_rng(1).uniform(-3, 3, size=(5, 2))
            mu, _ = fitted.predict(torch.as_tensor(Xs, dtype=fitted.X.dtype,
                                                   device=fitted.X.device))
            err = float(np.abs(mu.cpu().numpy() - np.sin(Xs[:, :1] * 2) * np.cos(Xs[:, 1:])).max())
            _check_example("large_scale_sparse", err <= SPARSE_PREDICT_LIMIT, failures,
                           f"N=50 000, M=256, fitted bound "
                           f"{float(fitted.log_marginal_likelihood()):.1f}, |prediction - truth| "
                           f"{err:.4f} (limit {SPARSE_PREDICT_LIMIT:g})")
            m = timed(f"forrester_gp n={EXAMPLES_KERNEL_N}", lambda: forrester_gp.main(
                n=EXAMPLES_KERNEL_N, plot=False))
            _check_example(f"forrester_gp n={EXAMPLES_KERNEL_N}",
                           math.isfinite(float(m.log_marginal_likelihood())), failures,
                           f"fitted LML {float(m.log_marginal_likelihood()):.3f}")
    finally:
        os.chdir(here)
        pl.change_plotting_library("matplotlib")


def phase_examples():
    """Phase 13: the gallery and the example scripts, float32 on the card with
    no device given. Launches are counted over the whole phase; B1-B3 must be
    non-zero (B4 is off this path and counted too). Every leg runs; the phase
    fails at its end if any check failed."""
    failures = []
    _zero_counts()
    t0 = _now()
    n_demos, worst = _leg_gallery(failures)
    t1 = _now()
    _leg_gallery_optimized(failures)
    t2 = _now()
    seconds = {}
    _leg_example_scripts(failures, seconds)
    t3 = _now()
    launches = _read_counts()
    print(f"# examples: phase 13 took {t3 - t0:.1f} s (gallery {n_demos} demos unoptimized "
          f"{t1 - t0:.1f} s, worst diff / limit {worst:.3f}; optimized {t2 - t1:.1f} s; scripts "
          f"{t3 - t2:.1f} s: {', '.join(f'{k} {v:.2f}' for k, v in seconds.items())}); "
          f"cuts: BO examples 1 iteration, large_scale_sparse SVGP {EXAMPLES_SVGP_STEPS} of "
          f"300 steps; launches {launches}")
    for k in ("B1", "B2", "B3"):
        if launches[k] <= 0:
            failures.append(f"kernel {k} was never launched")
    if failures:
        raise AssertionError("examples: " + "; ".join(failures))
    return launches


class _PhaseClock:
    """The script's wall time by phase, on the host's clock."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.laps = []

    def lap(self, name):
        t = time.perf_counter()
        self.laps.append((name, t - self.t))
        self.t = t

    def report(self):
        split = ", ".join(f"{name} {s:.1f}" for name, s in self.laps)
        print(f"# wall time by phase (s): {split}; total {time.perf_counter() - self.t0:.1f} s")


def main():
    phase_device()
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    clock = _PhaseClock()
    phase_default_device()
    phase_build()
    clock.lap("1-2 device and build")
    rows = phase_kernels(dev)
    gplvm_row = _gplvm_kernel_row(dev)
    rows["B2"]["max_abs_err"] = max(rows["B2"]["max_abs_err"], gplvm_row["max_abs_err"])
    clock.lap("3 kernels")
    launches, fitted, post, res = phase_main(dev)
    rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"],
                                    phase_tri_inv_on_main_path(post.L))
    clock.lap("4-5 main")
    option_launches = phase_fit_options(dev, fitted, res)
    clock.lap("4b options")
    call_launches = phase_calls(dev, fitted)
    clock.lap("4c calls")
    del res
    thesis_launches, b4_err = phase_thesis(dev)
    rows["B4"]["max_abs_err"] = max(rows["B4"]["max_abs_err"], b4_err)
    clock.lap("6 thesis")
    composite_launches = phase_composite(dev)
    clock.lap("7 composite")
    surrogate_launches = phase_surrogates(dev, fitted, post)
    clock.lap("8 surrogates")
    approximate_launches = phase_approximate(fitted)
    clock.lap("9 approximate")
    del fitted, post
    loop = start_loop_protocol()
    try:
        zoo_launches = phase_zoo(dev)
        clock.lap("10 zoo")
        latent_launches = phase_latent()
        clock.lap("11 latent")
        sharded_launches, cluster_launches, sharded_errs, b4_sharded_err = phase_sharded(dev)
        clock.lap("12 sharded")
        rows["B1"]["max_abs_err"] = max(rows["B1"]["max_abs_err"], sharded_errs[0],
                                        sharded_errs[1])
        rows["B2"]["max_abs_err"] = max(rows["B2"]["max_abs_err"], *sharded_errs[2:])
        rows["B4"]["max_abs_err"] = max(rows["B4"]["max_abs_err"], b4_sharded_err)
        example_launches = phase_examples()
        clock.lap("13 examples")
        phase_loop_protocol(*loop)
        clock.lap("7 loop (the wait)")
    finally:
        _stop(loop[0])
    clock.report()
    # B1 and B2 run on the main, composite, surrogate, approximate and zoo paths,
    # B4 on the thesis path, B3 on all but the sparse leg; "launches" is the main
    # path's count (B4: the thesis path's)
    launches["B4"] = thesis_launches["B4"]
    sources = {
        "B1": ("stationary_k_build", "gaussian_process_optimization_tpu_torch/csrc/stationary_k.cu",
               "gaussian_process_optimization_tpu/ops/pallas_kernels.py:82"),
        "B2": ("stationary_k_backward",
               "gaussian_process_optimization_tpu_torch/csrc/stationary_k.cu",
               "gaussian_process_optimization_tpu/ops/pallas_kernels.py:242"),
        "B3": ("tri_inv_blocks", "gaussian_process_optimization_tpu_torch/csrc/tri_inv.cu",
               "gaussian_process_optimization_tpu/ops/pallas_linalg.py:230"),
        "B4": ("cholesky_blocks", "gaussian_process_optimization_tpu_torch/csrc/chol_blocks.cu",
               "gaussian_process_optimization_tpu/ops/pallas_linalg.py:223"),
        "B5": ("chol_full", "gaussian_process_optimization_tpu_torch/csrc/chol_full.cu", None),
    }
    kernels = []
    for key, (name, source, replaces) in sources.items():
        r = rows[key]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[key],
                        "launches_thesis": thesis_launches[key],
                        "launches_composite": composite_launches[key],
                        "launches_surrogates": surrogate_launches[key],
                        "launches_approximate": approximate_launches[key],
                        "launches_zoo": zoo_launches[key],
                        "launches_latent": latent_launches[key],
                        "launches_sharded": sharded_launches[key],
                        "launches_cluster": cluster_launches[key],
                        "launches_examples": example_launches[key],
                        "launches_options": option_launches[key],
                        "launches_calls": call_launches[key],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_us": r["bound_us"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
