"""Which step of the covariance kernels' radial profile biases their float32
results, and what its repair does downstream (ROADMAP C9).

    python -m gaussian_process_optimization_tpu_torch.prof_b1_bias [--skip-fits] [--svgp] [--ep] [--phase12]

Copies ``csrc/`` into variant trees under ``_build/variants/``, each with one
change to the profile of ``csrc/stationary_family.cuh`` that B1 and B2 share
(the package itself is not touched), builds each into its own library and
loads it in turn:

- ``as is``: the sources as they stand (``exp_nat``: ``ex2.approx`` of t = x
  log2(e)_hi corrected by the FMA residual of that product, ``sqrt.approx``,
  ratquad's IEEE ``log2f``);
- ``before C9``: the profile before its repair (``ex2.approx`` of the
  pre-scaled argument x log2 e, ratquad's ``lg2.approx``), and with one of its
  approximate intrinsics swapped for the IEEE form (``exp2f``, ``sqrtf``);
- ``pre-scaled exponential`` and ``lg2.approx``: one half of the repair undone;
- ``expf``: the exponentials as ``expf`` of the natural-log argument (the
  plain version's arithmetic); ``sqrtf``; ``sqrtf + expf``;
- ``before C9 in B2 only``: the repaired profile in the K build, the old one in
  its backward.

For each it prints the mean signed and the mean absolute error of K against a
float64 K built on the card from the same float32 inputs, relative to the
kernel variance, at ``chip_smoke.py`` phase 3's 5 x 4096 x 4096 ARD Matern52
(same seed and inputs), the K build's time there, and the mean signed relative
error of B2's d variance and d lengthscales against float64; beside them the
plain float32 routes: the explicit-difference plain version of the kernels and
the models' own route with the kernels off (r^2 by a matrix product). Unless
``--skip-fits``, it then fits warpedGP on the main data as phase 8 does, and
the Mauna Loa composition of phase 10's leg 2, and prints for each variant the
float32 -LML's error against float64 at the fitted point, and warpedGP's K
errors there. ``--svgp`` also fits phase 9's SVGP (300 Adam steps) through the
plain route, ``as is``, ``before C9``, ``before C9 in B2 only`` and float64;
``--ep`` runs phase 9's dense EP rounds through the plain route, ``as is``
(also with some of its linear algebra elsewhere), ``before C9`` and float64;
``--phase12`` runs phase 12's clustering and sharded BO legs through ``as
is`` and ``before C9``.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import shutil
import subprocess
import time

import torch

from . import workload
from .config import config
from .ops import _build
from .ops import cuda_kernels as ck
from .prof_k import time_ms
from .utils.tree import tree_map

_ASM = {
    "exp2f": r'asm\("ex2\.approx\.ftz\.f32 %0, %1;" : "=f"\(y\) : "f"\(x\)\);',
    "sqrtf": r'asm\("sqrt\.approx\.ftz\.f32 %0, %1;" : "=f"\(y\) : "f"\(x\)\);',
}
# the profile's exponentials -> ex2.approx of the pre-scaled argument (before C9)
_PRESCALED = {
    "exp_nat(-0.5f * r2)": "ex2_approx((-0.5f * kLog2e) * r2)",
    "exp_nat(-r)": "ex2_approx(-kLog2e * r)",
    "exp_nat(-kSqrt3 * r)": "ex2_approx((-kSqrt3 * kLog2e) * r)",
    "exp_nat(-kSqrt5 * r)": "ex2_approx((-kSqrt5 * kLog2e) * r)",
}
_EXP_NAT = re.compile(r"__device__ __forceinline__ float exp_nat\(float x\) \{\n.*?\n\}\n",
                      re.S)
_EXPF = "__device__ __forceinline__ float exp_nat(float x) { return expf(x); }\n"
_LG2 = ("__device__ __forceinline__ float lg2_approx(float x) {\n"
        "  float y;\n"
        '  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
        "  return y;\n"
        "}\n")
_ANCHOR = "// From r2 = r^2 >= 0:"
_PROFILE = "template <int FAMILY>\n__device__ __forceinline__ void profile("
_END = "}  // namespace gpo"
BEFORE = ("prescaled", "lg2")
VARIANTS = {
    "as is": (),
    "before C9": BEFORE,
    "before C9, exp2f": BEFORE + ("exp2f",),
    "before C9, sqrtf": BEFORE + ("sqrtf",),
    "pre-scaled exponential": ("prescaled",),
    "lg2.approx": ("lg2",),
    "expf": ("expf",),
    "sqrtf": ("sqrtf",),
    "sqrtf + expf": ("sqrtf", "expf"),
    "before C9 in B2 only": ("backward before",),
}
_FORWARD_CALL = "profile<FAMILY>(r2[i][c] * scale, variance"


def _undo_repair(text: str, changes) -> str:
    """The profile code in ``text`` with the pre-scaled exponential
    ("prescaled") and / or ratquad's lg2.approx ("lg2") of before C9."""
    if "prescaled" in changes:
        for new, old in _PRESCALED.items():
            assert text.count(new) == 1, new
            text = text.replace(new, old)
    if "lg2" in changes:
        assert text.count("log2f(base)") == 1
        text = text.replace("log2f(base)", "lg2_approx(base)")
    return text


def _patched(text: str, changes) -> str:
    """``stationary_family.cuh``'s text with ``changes`` applied."""
    if "lg2" in changes or "backward before" in changes:
        assert text.count(_ANCHOR) == 1
        text = text.replace(_ANCHOR, _LG2 + "\n" + _ANCHOR)
    text = _undo_repair(text, changes)
    for c in changes:
        if c in _ASM:
            text, n = re.subn(_ASM[c], f"y = {c}(x);", text)
            assert n == 1, c
    if "expf" in changes:
        text, n = _EXP_NAT.subn(_EXPF, text)
        assert n == 1
    if "backward before" in changes:
        start, end = text.index(_PROFILE), text.index(_END)
        copy = _undo_repair(text[start:end], BEFORE).replace("void profile(",
                                                              "void profile_before(")
        text = text[:end] + copy + text[end:]
    return text


def variant_sources(header: str, kernels: str) -> dict:
    """``{variant: (stationary_family.cuh, stationary_k_kernels.cuh)}``, the
    texts of each variant built from the two files' texts ``header`` and
    ``kernels``; raises ``AssertionError`` where a pattern no longer matches."""
    out = {}
    for name, changes in VARIANTS.items():
        k = kernels
        if "backward before" in changes:
            # B2's calls take the old profile, B1's keeps the repaired one
            assert k.count(_FORWARD_CALL) == 1 and k.count("profile<FAMILY>(") == 3
            k = k.replace("profile<FAMILY>(", "profile_before<FAMILY>(").replace(
                _FORWARD_CALL.replace("profile<", "profile_before<"), _FORWARD_CALL)
        out[name] = (_patched(header, changes), k)
    return out


def _variant_dirs() -> dict:
    root = _build.BUILD_DIR / "variants"
    sources = variant_sources((_build.SRC_DIR / "stationary_family.cuh").read_text(),
                              (_build.SRC_DIR / "stationary_k_kernels.cuh").read_text())
    out = {}
    for i, (name, (header, kernels)) in enumerate(sources.items()):
        d = root / f"v{i}"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(_build.SRC_DIR, d)
        (d / "stationary_family.cuh").write_text(header)
        (d / "stationary_k_kernels.cuh").write_text(kernels)
        out[name] = d
    return out


def _use(src_dir):
    _build.SRC_DIR = src_dir
    _build._lib = None
    _build.library()


def _k_errors(K32, K64, variance) -> tuple[float, float]:
    """(mean signed, mean absolute) of (K32 - K64) / variance per lane."""
    e = (K32.double() - K64) / variance.double().reshape(-1, 1, 1)
    return float(e.mean()), float(e.abs().mean())


def _phase3_inputs(dev, n=4096, m=1000):
    """chip_smoke.py phase 3's X and params rows (same generator, same order)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    X = (4 * torch.rand(1, n, 6, generator=gen, device=dev) - 2).contiguous()
    (4 * torch.rand(1, m, 6, generator=gen, device=dev) - 2)  # phase 3's sweep rows
    var = 0.5 + torch.rand(5, 1, generator=gen, device=dev)
    ls = 0.5 + 1.5 * torch.rand(5, 6, generator=gen, device=dev)
    return X, torch.cat([var, torch.zeros_like(var), ls], dim=1).contiguous()


def _sq_dist_route(X, p):
    """The models' own float32 route with the kernels off (r^2 by a matrix
    product, ``kernels/stationary.sq_dist``), lane by lane."""
    from .kernels.stationary import Matern52

    old = config.use_cuda_kernels
    config.use_cuda_kernels = False
    try:
        out = []
        for row in p:
            k = Matern52.create(6, variance=float(row[0]), lengthscale=row[2:8].tolist(),
                                ARD=True, dtype=torch.float32, device=X.device)
            out.append(k.K(X[0]))
        return torch.stack(out)
    finally:
        config.use_cuda_kernels = old


def _lml(m) -> float:
    with torch.no_grad():
        return float(m.log_marginal_likelihood())


def _svgp(dirs, source):
    """Phase 9's SVGP leg (300 Adam steps) through the plain route, ``as is``,
    ``before C9``, ``before C9 in B2 only`` and float64: -ELBO every 50 steps and the largest prediction error at its
    5 points (limit 0.05 in chip_smoke.py)."""
    import numpy as np

    Xs, Ys = workload.sparse_data()
    Xt = np.random.default_rng(0).uniform(-3, 3, size=(5, 2))
    runs = [("plain route", source, False, None)] + [
        (name, d, "auto", None) for name, d in dirs.items()
        if name in ("as is", "before C9", "before C9 in B2 only")]
    runs.append(("float64", source, "auto", torch.float64))
    for name, d, route, dtype in runs:
        _use(d)
        config.use_cuda_kernels = route
        try:
            fitted, losses, _ = workload.svgp_fit(workload.svgp_model(Xs, Ys, dtype=dtype), Xs, Ys)
            with torch.no_grad():
                mu, _ = fitted.predict(Xt)
        finally:
            config.use_cuda_kernels = "auto"
        err = float(np.abs(mu.cpu().numpy() - workload.sparse_truth(Xt)).max())
        print(f"# SVGP, {name}: -ELBO at steps 0, 50, ..., 250, 260, ..., 290, 299: "
              f"{[round(float(v), 1) for v in list(losses[:251:50]) + list(losses[260::10])]}"
              f" {round(float(losses[-1]), 1)}; "
              f"max |prediction - truth| {err:.4f}; noise "
              f"{float(fitted.likelihood_variance):.4g}, lengthscale "
              f"{float(fitted.kern.lengthscale):.4g}")
    _use(source)


def _ep(dirs, source):
    """Phase 9's dense EP leg (N = 4096: EP to convergence, then two alternated
    rounds of 30 steps) through the plain route, ``before C9``, ``as is`` (also
    with the ladder's Cholesky and the triangular solves on the host's CPU, with
    the port's blocked Cholesky and B4, and with torch's MAGMA backend for the
    factorization) and float64: the evidence after each round (chip_smoke.py
    holds it from falling) and the EP sweeps behind it."""
    import contextlib

    from .models.classification import GPClassification
    from .prof_stages import on_host

    @contextlib.contextmanager
    def magma():
        old = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("magma")
        try:
            yield
        finally:
            torch.backends.cuda.preferred_linalg_library(old)

    X, Y = workload.bench_data()
    labels = workload.classification_labels(Y)
    repair = dirs["as is"]
    runs = [("plain route", source, False, None, contextlib.nullcontext),
            ("before C9", dirs["before C9"], "auto", None, contextlib.nullcontext),
            ("as is", repair, "auto", None, contextlib.nullcontext),
            ("as is, Cholesky + solves on the host", repair, "auto", None,
             lambda: on_host(("chol", "solves"))),
            ("as is, blocked Cholesky with B4", repair, "auto", None,
             lambda: on_host(("blocks",))),
            ("as is, MAGMA factorization", repair, "auto", None, magma),
            ("float64", source, "auto", torch.float64, contextlib.nullcontext)]
    for name, d, route, dtype, context in runs:
        _use(d)
        config.use_cuda_kernels = route
        try:
            with context():
                model = GPClassification.create(X, labels, dtype=dtype)
                post = model.inference()
                lmls, sweeps = [float(post.lml)], [int(post.sweeps)]
                for _ in range(2):
                    model, _ = model.optimize(rounds=1, maxiter=30)
                    post = model.inference()
                    lmls.append(float(post.lml))
                    sweeps.append(int(post.sweeps))
        finally:
            config.use_cuda_kernels = "auto"
        print(f"# EP, {name}: evidence {[round(v, 4) for v in lmls]}, sweeps {sweeps}; "
              f"variance {float(model.kern.variance):.6g}, lengthscale "
              f"{float(model.kern.lengthscale):.6g}", flush=True)
    _use(source)


def _phase12(dirs, source):
    """``chip_smoke.py`` phase 12's clustering and its sharded fit with the
    BayesianOptimization(mesh=...) suggestion, through ``before C9`` and
    ``as is`` (the plain route does not fit the clustering's 820 lanes in
    80 GB): the lines those legs print, and the checks they would fail."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", source.parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    for name in ("before C9", "as is"):
        _use(dirs[name])
        failures = []
        print(f"# phase 12 legs, {name}:", flush=True)
        smoke._leg_cluster({}, failures)
        smoke._leg_sharded_fit(dev, smoke._mesh4(), {}, failures)
        print(f"# phase 12 legs, {name}: checks failed {failures}", flush=True)
    _use(source)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-fits", action="store_true")
    ap.add_argument("--svgp", action="store_true",
                    help="also fit phase 9's SVGP through each variant and the plain route")
    ap.add_argument("--ep", action="store_true",
                    help="also run phase 9's dense EP rounds through each variant")
    ap.add_argument("--phase12", action="store_true",
                    help="also run phase 12's clustering and sharded BO through each variant")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_b1_bias: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    source = _build.SRC_DIR
    t0 = time.perf_counter()
    dirs = _variant_dirs()
    for name, d in dirs.items():
        _use(d)
    print(f"# prof_b1_bias: {len(dirs)} variants built in {time.perf_counter() - t0:.1f} s")

    X, p5 = _phase3_inputs(dev)
    K64 = ck.k_build_plain(X.double(), X.double(), p5.double(), "matern52", True)
    var = p5[:, 0]
    plain = ck.k_build_plain(X, X, p5, "matern52", True)
    print("# C9 table, 5 x 4096 x 4096 ARD Matern52 (phase 3's inputs): K - K64 over the "
          "variance, mean signed / mean absolute; kernel ms")
    s, a = _k_errors(plain, K64, var)
    print(f"#   plain (explicit differences): {s:+.3e} / {a:.3e}")
    del plain
    s, a = _k_errors(_sq_dist_route(X, p5), K64, var)
    print(f"#   plain (models' route, r^2 by matmul): {s:+.3e} / {a:.3e}")
    del K64
    G = (2 * torch.rand(5, X.shape[1], X.shape[1], generator=torch.Generator(
        device=dev).manual_seed(1), device=dev) - 0.5).contiguous()
    g64, _, _ = ck.k_backward_plain(X.double(), X.double(), p5.double(), G.double(),
                                    "matern52", True, False, False, True)

    def b2_bias(dp):
        rel = (dp.double() - g64) / g64.abs()
        return float(rel[:, 0].mean()), float(rel[:, 2:8].mean())

    dp, _, _ = ck.k_backward_plain(X, X, p5, G, "matern52", True, False, False, True)
    print("#   B2, plain: d variance %+.3e, d lengthscale %+.3e" % b2_bias(dp))
    for name, d in dirs.items():
        _use(d)
        K = ck.stationary_k_build(X, X, p5, "matern52", True)
        K64 = ck.k_build_plain(X.double(), X.double(), p5.double(), "matern52", True)
        s, a = _k_errors(K, K64, var)
        del K, K64
        ms = time_ms(lambda: ck.stationary_k_build(X, X, p5, "matern52", True))
        dp, _, _ = ck.stationary_k_backward(X, X, p5, G, "matern52", True, False, False, True)
        bv, bl = b2_bias(dp)
        print(f"#   {name}: {s:+.3e} / {a:.3e}; {ms:.4f} ms; B2 d variance {bv:+.3e}, "
              f"d lengthscale {bl:+.3e}")

    if args.svgp:
        _svgp(dirs, source)
    if args.ep:
        _ep(dirs, source)
    if args.phase12:
        _phase12(dirs, source)
    if args.skip_fits:
        return
    _use(source)
    Xb, Yb = workload.bench_data()
    bo = workload.surrogate_bo(Xb, Yb, "warpedGP", max_iters=50)
    workload.surrogate_iteration(bo)
    m = bo.model.model
    l64 = _lml(tree_map(lambda t: t.double(), m))
    gz = m._warped_gp()
    g64 = tree_map(lambda t: t.double(), gz)
    with torch.no_grad():
        K64 = g64.kern.K(g64.X)
    v = gz.kern.variance.reshape(1)
    config.use_cuda_kernels = False
    try:
        with torch.no_grad():
            s, a = _k_errors(gz.kern.K(gz.X)[None], K64[None], v)
        print(f"# C9 warpedGP (variance {float(v):.6g}, noise "
              f"{float(gz.likelihood_variance):.6g}): plain K route: -LML rel "
              f"{abs(_lml(m) - l64) / abs(l64):.3e}; K {s:+.3e} / {a:.3e}")
    finally:
        config.use_cuda_kernels = "auto"
    for name, d in dirs.items():
        _use(d)
        with torch.no_grad():
            s, a = _k_errors(gz.kern.K(gz.X)[None], K64[None], v)
        print(f"# C9 warpedGP, {name}: -LML rel {abs(_lml(m) - l64) / abs(l64):.3e}; "
              f"K {s:+.3e} / {a:.3e}")
    del K64

    _use(source)
    Xc, Yc = workload.co2_data()
    fitted, _ = workload.fit(workload.co2_model(Xc, Yc), generator=torch.Generator(
        device=dev).manual_seed(0))
    f64m = tree_map(lambda t: t.double(), fitted)

    def co2_rel():
        """-LML f32 against f64 at the jitter the f32 ladder chose (the same Ky)."""
        with torch.no_grad():
            jitter = float(fitted.inference().jitter)
        same_ky = dataclasses.replace(f64m, likelihood_variance=f64m.likelihood_variance
                                      + jitter)
        l64 = _lml(same_ky)
        return abs(_lml(fitted) - l64) / abs(l64)

    config.use_cuda_kernels = False
    try:
        print(f"# C9 Mauna Loa (zoo leg 2), plain K route: -LML rel {co2_rel():.3e}")
    finally:
        config.use_cuda_kernels = "auto"
    for name, d in dirs.items():
        _use(d)
        print(f"# C9 Mauna Loa, {name}: -LML rel {co2_rel():.3e}")
    _use(source)


if __name__ == "__main__":
    main()
