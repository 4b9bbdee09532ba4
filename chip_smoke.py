#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``gaussian_process_optimization_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device   — refuses to run without CUDA; prints the card's name and power limit;
                checks that the entry points build on the card when no device is
                given;
  2. build    — compiles the CUDA kernels from ``csrc/`` (nvcc, sm_90a, one process
                per source) and times it;
  3. kernels  — each kernel against its plain PyTorch version at its path's
                shapes (B1's K(X, X) also bitwise equal to its transpose; what the
                model calls, ``stationary_K`` forward and backward, timed beside the
                bare kernels and the symmetrization pass it no longer runs; B2's dZ
                pass timed at the sweep shape), with its time, the plain version's, the one PyTorch call
                that computes the same function where there is one (B3:
                solve_triangular against I, B4: cholesky_ex) and the roofline
                bound from the shapes (bytes at 3.35 TB/s or f32 flops at
                67 TFLOP/s, the larger); times are medians of CUDA-event timings
                of back-to-back calls after warm-up; and one full (5, 4096, 4096)
                factorization timed three ways: cholesky_ex, blocked_cholesky with
                B4, blocked_cholesky with plain diagonal blocks;
  4. main     — one BO iteration at the bench's full size (N=4096, D=6, 5x30 fit,
                1000-candidate EI sweep, 5x50 anchors, float32), twice; the second
                run's launch counts of B1-B3 must be non-zero (B4 is off this
                path and counted too); the fitted model's
                LML, its gradient and the EI at the argmax are held against a float64
                recomputation on the card;
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
  7. loop     — leg A (run last), the tell-and-ask loop itself: ``regret_run`` on
                branin (15 iterations) and hartmann6 (20 of the protocol's 30),
                latin design of 5, EI, ``exact_feval``, float32, the two runs side by
                side in interpreters of their own: every iteration ran, no fit
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
                before leg A): GP_MCMC + EI_MCMC at GPyOpt's HMC defaults on the main
                data (accept rate > 0, per-sample predictions and EI_MCMC at the
                argmax against float64 on the same samples, B1-B3 launched) and a
                local-penalization batch of 3 over LCB_MCMC; ES_EPMGP and ES on phase
                4's fitted model (p_min normalized, EPMGP in f32 against f64 on the
                same mu and Sigma); the VarDTC bound at N=50 000, D=2, M=256 against
                float64, the FITC, DTC and PEP bounds, a 50-step fit (the bound does
                not fall, 5 predictions near the truth, B2's row pass launched with
                dX at Kmn's 256 x 50 000), and sparseGP through BayesianOptimization;
                warpedGP and input_warped_GP (50 fit steps, -LML against float64 on
                the card and on the CPU at the fitted point, with a control the
                limit must catch) and RF at N=256. Phase 3 also holds B1 and B2 at
                Kmn's 256 x 50 000 (B2's dZ there too, a pass the sparse fit does
                not run) and B1 at the MCMC surrogate's 10 x 4096 x 4096;
  9. summary  — a JSON line of kernels, then ``{"ok": true, "device": {...}}`` last.

Any failed check raises, and the script exits non-zero.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
    from gaussian_process_optimization_tpu_torch.models.gp import GPRegression

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
    }
    devices = {k: (v if isinstance(v, torch.device) else v.device).type
               for k, v in built.items()}
    print(f"# entry points with no device given build on: {devices}")
    if set(devices.values()) != {"cuda"}:
        raise AssertionError(f"an entry point built off the card: {devices}")


def phase_build():
    from gaussian_process_optimization_tpu_torch.ops import _build

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
    del want
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
    # (the MCMC surrogate's 10-lane posterior). These inputs are well
    # conditioned; phase_tri_inv_on_main_path repeats the check on the diagonal
    # blocks of the main path's own Cholesky factor.
    errs = []
    for g in (80, 16, 160):
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

    # one full factorization, three ways, on the fit shape's Matern52 Gram
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
    times["cholesky_ex (the default ladder route)"] = _time_ms(
        lambda: torch.linalg.cholesky_ex(Ky), calls=5)
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
    Xs = (6 * torch.rand(1, 50_000, 2, generator=gen, device=dev) - 3).contiguous()
    p1 = _rbf_rows(dev, 1, gen)
    tag = "256x50000"
    got = ck.stationary_k_build(Zi, Xs, p1, "rbf", False)
    want = ck.k_build_plain(Zi, Xs, p1, "rbf", False)
    _close(f"B1 Kmn {tag}", got, want, rtol=2e-5, atol=2e-6)
    errs.append(_max_err(got, want))
    ms = _time_ms(lambda: ck.stationary_k_build(Zi, Xs, p1, "rbf", False))
    plain = _time_ms(lambda: ck.k_build_plain(Zi, Xs, p1, "rbf", False))
    bound = _bound(_nbytes(Zi, Xs, p1, got), got.numel() * _k_flops(2))
    print(f"# B1 stationary_k_build Kmn {tag} (D=2, RBF): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    G = (2 * torch.rand(1, 256, 50_000, generator=gen, device=dev) - 1).contiguous()
    out = ck.stationary_k_backward(Zi, Xs, p1, G, "rbf", False)
    ref = ck.k_backward_plain(Zi.double(), Xs.double(), p1.double(), G.double(), "rbf", False)
    for name, a, w in zip(("dparams", "dX (the inducing inputs' gradient)",
                           "dZ (the data's, off the sparse fit's path)"), out, ref):
        _close(f"B2 {name} Kmn {tag}", a, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
    ms = _time_ms(lambda: ck.stationary_k_backward(Zi, Xs, p1, G, "rbf", False, True, False,
                                                   True))
    plain = _time_ms(lambda: ck.k_backward_plain(Zi, Xs, p1, G, "rbf", False, True, False,
                                                 True))
    bound = _bound(_nbytes(Zi, Xs, p1, G, out[0], out[1]), G.numel() * _k_bwd_flops(2))
    print(f"# B2 stationary_k_backward Kmn {tag} (parameter gradients + dX, what the sparse "
          f"fit asks for): kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    del got, want, G, out, ref

    p10 = _rbf_rows(dev, 10, gen)
    tag = "10x4096x4096"
    got = ck.stationary_k_build(X, X, p10, "rbf", False)
    want = ck.k_build_plain(X, X, p10, "rbf", False)
    _close(f"B1 {tag} (RBF)", got, want, rtol=2e-5, atol=2e-6)
    errs.append(_max_err(got, want))
    del want
    ms = _time_ms(lambda: ck.stationary_k_build(X, X, p10, "rbf", False), calls=5)
    plain = _time_ms(lambda: ck.k_build_plain(X, X, p10, "rbf", False), calls=5)
    bound = _bound(_nbytes(X, p10, got), got.numel() * _k_flops(X.shape[-1]))
    print(f"# B1 stationary_k_build {tag} (RBF, the MCMC surrogate's S lanes): kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']})")
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


def _neg_lml_grad_terms(model):
    """Gradients of the -LML's two terms, 0.5 p logdet and 0.5 quad, with
    respect to the packed parameters (float64, (n,) each); their sum is the
    fit objective's gradient. The forward is GPRegression._core's."""
    from gaussian_process_optimization_tpu_torch.models.gp import AssembleKy, ExactCore
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer

    packer = make_packer(model)
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


def _print_fitted_gradient(fitted, fitted64) -> float:
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
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck
    from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    counters = {"B1": ck.stationary_k_build, "B2": ck.stationary_k_backward,
                "B3": cl.tri_inv_blocks, "B4": cl.cholesky_blocks}
    *_, fit_cold, acq_cold = _run_main_path(dev, 1)
    print(f"# main path, first run: fit {fit_cold:.3f} s, acquisition {acq_cold:.3f} s")

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    model, fitted, res, acq, fit_s, acq_s = _run_main_path(dev, 0)
    launches = {k: fn.launches for k, fn in counters.items()}
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
    for k in ("B1", "B2", "B3"):  # B4 is off the main path (cuda_chol_blocks off)
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
    return launches, fitted, post


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
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck
    from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    counters = {"B1": ck.stationary_k_build, "B2": ck.stationary_k_backward,
                "B3": cl.tri_inv_blocks, "B4": cl.cholesky_blocks}
    X, Y = workload.thesis_data()
    old = config.cuda_chol_blocks
    config.cuda_chol_blocks = True
    try:
        bo = workload.thesis_bo(X, Y, device=dev, dtype=torch.float32)
        for call in ("cold", "warm"):
            if call == "warm":  # fresh Y, as bench.py:208 does
                bo.Y = Y + 0.01 * np.random.default_rng(10).standard_normal(Y.shape)
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            it = workload.thesis_iteration(bo)
            total = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
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
# the smoke stops after 10, beside branin's 15, and reads the stored runs at
# the same evaluation.
HARTMANN6_ITERS = 10

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


def phase_loop_protocol():
    """Leg A: the canonical drive script, on the default device in float32. At
    N <= 35 a run is a host loop of small launches, so the two runs go side by
    side, each in an interpreter of its own; nothing else runs meanwhile."""
    stored = json.loads((ROOT / "benchmarks" / "regret_raw.json").read_text())["cpu_f64"]
    runs = (("branin", 15), ("hartmann6", HARTMANN6_ITERS))
    # the stored runs' largest regret after as many evaluations as this run makes
    limit = max(row[5 + HARTMANN6_ITERS - 1] for row in stored["hartmann6"])
    children = [subprocess.Popen(
        [sys.executable, "-c", _LOOP_CHILD.format(root=str(ROOT), name=name, iters=iters)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for name, iters in runs]
    try:
        outputs = [child.communicate(timeout=900) for child in children]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    for (name, iters), child, (out, err) in zip(runs, children, outputs):
        lines = [line for line in out.splitlines() if line.startswith("RESULT::")]
        if child.returncode != 0 or not lines:
            raise AssertionError(f"loop {name}: the run failed (exit {child.returncode}):\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
        if "surrogate fit failed" in out:
            raise AssertionError(f"loop {name}: a surrogate fit failed")
        r = json.loads(lines[0][len("RESULT::"):])
        print(f"# loop {name} (latin 5, EI, exact_feval, {iters} iterations, {r['dtype']}, "
              f"{r['device']}; beside the other run): {r['total']:.2f} s; per iteration fit "
              f"{r['seconds']['fit'] / (iters + 1):.3f} s, acquisition "
              f"{r['seconds']['acquisition'] / iters:.3f} s; fx_opt {r['fx_opt']:.6f}, final "
              f"regret {r['regret'][-1]:.6f}; ladder rungs {r['rungs']}; LML trials of each "
              f"bucket's last fit {r['fit_evaluations']}")
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
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck
    from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl
    from gaussian_process_optimization_tpu_torch.utils.normalizer import normalize_stats
    from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves, tree_map

    counters = {"B1": ck.stationary_k_build, "B2": ck.stationary_k_backward,
                "B3": cl.tri_inv_blocks, "B4": cl.cholesky_blocks}
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
        before = ck.stationary_k_build.launches
        out = real_solve(self, model, starts)
        fits.append((self.evaluations, ck.stationary_k_build.launches - before,
                     out[1].num_ls.tolist()))
        return out

    fit_mod.Fitter.solve = solve
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        bo.run_optimization(max_iter=2, eps=-1)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        fit_mod.Fitter.solve = real_solve
    launches = {k: fn.launches for k, fn in counters.items()}
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
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        batch = other.suggest_next_locations()
        seconds = time.perf_counter() - t0
        delta = {k: fn.launches - before[k] for k, fn in counters.items()}
        print(f"# composite, {label}: suggest_next_locations {seconds:.3f} s (posterior "
              f"{other.fit_seconds:.3f} s), launches {delta}, batch {batch.tolist()}")
        rows = kw.get("batch_size", 1)
        if (batch.shape != (rows, 6) or not np.all(np.abs(batch) <= 2.0)
                or len({tuple(r) for r in batch}) != rows):
            raise AssertionError(f"composite, {label}: batch {batch}")
        if "host" in label and not other.acquisition.has_cost:
            raise AssertionError("composite: the host call's acquisition carries no cost")
    return launches


def _counts():
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck
    from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl

    return {"B1": ck.stationary_k_build, "B2": ck.stationary_k_backward,
            "B3": cl.tri_inv_blocks, "B4": cl.cholesky_blocks}


def _zero_counts():
    for fn in _counts().values():
        fn.launches = 0
    b2 = _counts()["B2"]
    b2.launches_dx = b2.launches_dz = 0


def _read_counts():
    out = {k: fn.launches for k, fn in _counts().items()}
    b2 = _counts()["B2"]
    out["B2 dX"], out["B2 dZ"] = b2.launches_dx, b2.launches_dz
    return out


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
# warped -LML at the fitted parameters, f32 vs f64 (relative), per model. The
# leg also reads it through the plain K on the card and on the CPU at the same
# leaves, and a control each limit must catch: the card's float32 -LML with
# what the warp reads (the targets, or the inputs) off by WARPED_CONTROL_SHIFT
# relative, a random sign per row. warpedGP's fitted Ky (variance 11.2, noise
# 5.6e-4, N = 4096) has cond ~8e7, past float32's 1 / eps, and its -LML (~ -8e2)
# is a small difference of terms ~1e4: the sound readings are 9.50e-3 through
# B1 / B2, 3.12e-3 through the plain K, 2.59e-3 on the CPU, and the control
# 2.73e-2, so its limit sits at 2e-2. input_warped_GP reads 6.71e-4, 6.78e-4
# and 1.56e-5, its control 1.25e-1: the limit stays 1e-3. (NVIDIA H100 80GB
# HBM3, 700 W; the readings this script prints, PERF.md section 6.)
WARPED_LML_LIMIT = {"warpedGP": 2e-2, "input_warped_GP": 1e-3}
WARPED_CONTROL_SHIFT = 1e-2


# The MCMC leg's leapfrog step. GPyOpt's 0.1 is stable only while 0.1 times the
# square root of the potential's largest Hessian eigenvalue at the fitted point
# stays under 2, which on the bench's data holds to N ~ 300: the product reads
# 0.35, 1.57 and 6.18 at N = 64, 256 and 1024 (float64, CPU) and 12.6 at N =
# 4096 (float32, CPU), where every proposal is rejected, in the JAX package as
# in the port (both accept 0.00 at N = 1024). 0.005 puts it at 0.63; the other
# settings stay GPyOpt's.
MCMC_STEP = 0.005


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
    bo = workload.surrogate_bo(X, Y, "GP_MCMC", "EI_MCMC", step_size=MCMC_STEP)
    it = workload.surrogate_iteration(bo)
    launches = _read_counts()
    model = bo.model
    print(f"# surrogates, MCMC (N={len(X)}, D={X.shape[1]}, GP_MCMC + EI_MCMC, n_samples 10, "
          f"n_burnin 100, interval 10, step {MCMC_STEP} (GPyOpt's 0.1 rejects every proposal "
          f"at this N), 20 leapfrog steps, {model.dtype} on "
          f"{model.device.type}): fit {it.seconds['fit']:.3f} s, HMC {it.seconds['hmc']:.3f} s "
          f"(200 steps), S-lane posterior {it.seconds['posterior']:.3f} s, argmax "
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
    it = workload.surrogate_iteration(workload.surrogate_bo(X, Y, "sparseGP", num_inducing=256))
    bo_launches = _read_counts()
    print(f"# surrogates, sparseGP + EI on the main data (M=256, 5 restarts x 1000 steps): fit "
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


def main():
    phase_device()
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    phase_default_device()
    phase_build()
    rows = phase_kernels(dev)
    launches, fitted, post = phase_main(dev)
    rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"],
                                    phase_tri_inv_on_main_path(post.L))
    thesis_launches, b4_err = phase_thesis(dev)
    rows["B4"]["max_abs_err"] = max(rows["B4"]["max_abs_err"], b4_err)
    composite_launches = phase_composite(dev)
    surrogate_launches = phase_surrogates(dev, fitted, post)
    del fitted, post
    phase_loop_protocol()
    # B1 and B2 run on the main, composite and surrogate paths, B4 on the thesis
    # path, B3 on all but the sparse leg; "launches" is the main path's count
    # (B4: the thesis path's)
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
    }
    kernels = []
    for key, (name, source, replaces) in sources.items():
        r = rows[key]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[key],
                        "launches_thesis": thesis_launches[key],
                        "launches_composite": composite_launches[key],
                        "launches_surrogates": surrogate_launches[key],
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
