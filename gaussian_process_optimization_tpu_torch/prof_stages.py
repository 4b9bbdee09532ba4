"""Which stage carries the card's extra float32 error (ROADMAP C10, C11, C13).

A float32 objective on the card is recomputed with one stage at a time done
on the host's CPU in float32, its inputs copied there and its outputs copied
back (autograd runs through the copies), everything else left on the card:

- ``K``: the stationary covariance build (``Stationary.K``, so B1 and the
  plain route alike) and the RBF psi statistics of the latent bounds;
- ``chol``: every factorization of the jitter ladder (``cholesky_plain``);
- ``solves``: the triangular solves (``torch.linalg.solve_triangular``) and
  the triangular inverse (``tri_inv_lower``, B3 or plain);
- ``blocks`` (not a host stage): the ladder's factorizations by the port's
  own ``blocked_cholesky`` with B4's diagonal blocks (``cuda_chol_blocks``),
  on the card.

``chip_smoke.py`` phases 10-11 and ``prof_laplace`` call :func:`readings`
at their fitted points.
``python -m gaussian_process_optimization_tpu_torch.prof_stages`` prints the
backward error and the log-determinant error of each float32 factorization
route against float64 on a Matern52 Gram at two noise levels, and dense EP's
float32 evidence at phase 9's fitted point with each stage on the host,
through each reading of Sigma (``EP_FORMS``) and, split into its pieces, with
each factor route (``ep_pieces``). ``--sweep PATH`` prints phase 12's sweep
-EI at the surrogate stored in PATH, float32 sharded against unsharded and
each against float64, with the stages of L^-1 Kx swapped (:func:`mesh_sweep`);
``--cluster PATH`` prints each join of phase 12's float32 clustering beside
float64 and saves the joins of two families to PATH
(:func:`cluster_readings`).
Within :func:`recording_rungs`, every call of the ladder appends its lanes'
rungs, so a reading can name the rung each device settled on.
"""
from __future__ import annotations

import contextlib

import torch

from .config import config
from .kernels.stationary import Stationary
from .models import gplvm
from .ops import cuda_linalg, linalg
from .utils.tree import _is_node, tree_map

STAGES = ("K", "chol", "solves")
CONFIGS = (("card", ()), ("K on host", ("K",)), ("Cholesky on host", ("chol",)),
           ("solves on host", ("solves",)), ("K + Cholesky on host", ("K", "chol")),
           ("K + solves on host", ("K", "solves")),
           ("Cholesky + solves on host", ("chol", "solves")),
           ("all three on host", STAGES), ("card, blocked Cholesky with B4", ("blocks",)))


def _move(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if _is_node(v):
        return tree_map(lambda t: t.to(device), v)
    if isinstance(v, (tuple, list)):
        return type(v)(_move(x, device) for x in v)
    return v


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (tuple, list)):
            d = _device_of(a)
            if d is not None:
                return d
    return None


def _on_host(fn):
    """``fn`` run on the CPU when its tensor arguments lie on a card."""

    def wrapped(*args, **kwargs):
        dev = _device_of(args)
        if dev is None or dev.type == "cpu":
            return fn(*args, **kwargs)
        out = fn(*_move(args, "cpu"), **{k: _move(v, "cpu") for k, v in kwargs.items()})
        return _move(out, dev)

    return wrapped


def _patches(stages):
    out = []
    if "K" in stages:
        k = Stationary.K
        out += [(Stationary, "K", lambda self, X, X2=None: _move(
            k(_move(self, "cpu"), _move(X, "cpu"), _move(X2, "cpu")), X.device)),
                (gplvm, "rbf_psi_stats", _on_host(gplvm.rbf_psi_stats))]
    if "chol" in stages:
        out.append((cuda_linalg, "cholesky_plain", _on_host(cuda_linalg.cholesky_plain)))
    if "blocks" in stages:
        out.append((config, "cuda_chol_blocks", True))
    if "solves" in stages:
        out += [(torch.linalg, "solve_triangular", _on_host(torch.linalg.solve_triangular)),
                (linalg, "tri_inv_lower", _on_host(linalg.tri_inv_lower))]
    return out


@contextlib.contextmanager
def on_host(stages):
    """Run the named ``stages`` (of :data:`STAGES`) on the CPU in float32."""
    patches = _patches(stages)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


@contextlib.contextmanager
def recording_rungs():
    """Yields a list that collects the rungs of every jitter-ladder call."""
    rungs, full = [], linalg.jitchol_full

    def recorded(*args, **kwargs):
        out = full(*args, **kwargs)
        rungs.append(out[3].reshape(-1).tolist())
        return out

    linalg.jitchol_full = recorded
    try:
        yield rungs
    finally:
        linalg.jitchol_full = full


def readings(measure, configs=CONFIGS):
    """``[(label, measure(), rungs), ...]``, one per configuration: ``measure``
    returns the float32 objective's readings (its error against float64, for
    one) with the configuration's stages on the host."""
    out = []
    for label, stages in configs:
        with on_host(stages), recording_rungs() as rungs:
            value = measure()
        out.append((label, value, rungs))
    return out


def format_readings(rows, keys) -> str:
    """One line: each configuration's readings under ``keys`` and its rungs
    (distinct ladder outcomes, in call order)."""
    parts = []
    for label, value, rungs in rows:
        seen = []
        for r in rungs:
            if r not in seen:
                seen.append(r)
        parts.append(f"{label}: " + ", ".join(f"{k} {value[k]:.3e}" for k in keys)
                     + f" (rungs {seen[:4]}{' ...' if len(seen) > 4 else ''})")
    return "; ".join(parts)


def _factor_errors(A, L):
    """(max |L L^T - A| / max |A|, |logdet - logdet64| / |logdet64|) in float64."""
    A64 = A.double()
    L64 = L.double()
    back = float((L64 @ L64.mT - A64).abs().max() / A64.abs().max())
    ld = linalg.logdet_from_chol(L64)
    ld64 = linalg.logdet_from_chol(torch.linalg.cholesky(A64))
    return back, float(((ld - ld64).abs() / ld64.abs()).max())


def main():
    """The float32 factorizations the ladder can take, on the card and on the
    host, against float64: 5 lanes of phase 3's 4096 x 4096 ARD Matern52 Gram
    plus noise 5e-2 and plus noise 1e-4 (cond ~1e6 and ~1e8, the fitted points
    of the ICM and warped legs)."""
    import subprocess

    from .ops import cuda_kernels as ck
    from .prof_b1_bias import _phase3_inputs

    if not torch.cuda.is_available():
        raise SystemExit("prof_stages: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    X, p5 = _phase3_inputs(dev)
    K = ck.stationary_k_build(X, X, p5, "matern52", True)
    eye = torch.eye(K.shape[-1], device=dev)
    for noise in (5e-2, 1e-4):
        A = K + noise * eye
        routes = {"cholesky_ex (the default)": lambda: cuda_linalg.cholesky_plain(A),
                  "host LAPACK": lambda: cuda_linalg.cholesky_plain(A.cpu()).to(dev)}
        for label, on in (("blocked, B4 diagonal blocks", True),
                          ("blocked, plain diagonal blocks", False)):
            def blocked(on=on):
                old = config.cuda_chol_blocks
                config.cuda_chol_blocks = on
                try:
                    return linalg.blocked_cholesky(A)
                finally:
                    config.cuda_chol_blocks = old
            routes[label] = blocked
        for label, factor in routes.items():
            back, ld = _factor_errors(A, factor())
            print(f"# factorization, noise {noise:g}, {label}: max |LL^T - A| / max |A| "
                  f"{back:.3e}, logdet rel {ld:.3e}")
    del K, A
    _elementwise_and_gemm(dev)
    _ep_point()


def _elementwise_and_gemm(dev):
    """float32 on the card against float64: torch's log_ndtr over z in [-40,
    40] (the probit likelihood's log Z), and a 4096 x 4096 x 4096 product, with
    the TF32 switches as they stand."""
    z = torch.linspace(-40.0, 40.0, 200001, dtype=torch.float64, device=dev)
    want = torch.special.log_ndtr(z)
    got = torch.special.log_ndtr(z.float()).double()
    err = (got - want).abs()
    big = want.abs() > 1e-6
    print(f"# log_ndtr f32 on the card: max abs error {float(err.max()):.3e} at z = "
          f"{float(z[int(err.argmax())]):.3f}; max rel error where |log_ndtr| > 1e-6 "
          f"{float((err / want.abs())[big].max()):.3e}")
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(4096, 4096, generator=gen, device=dev)
    C = (A @ A.mT).double()
    C64 = A.double() @ A.double().mT
    print(f"# GEMM 4096^3 f32 on the card (allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"float32 matmul precision {torch.get_float32_matmul_precision()}): max |C - C64| / "
          f"max |C64| {float((C - C64).abs().max() / C64.abs().max()):.3e}")


# dense EP's readings of Sigma = K - V^T V: the Gaussian term's nu^T Sigma nu
# ("nu . mu" as the port has it, "Sigma @ nu" as the JAX package has it),
# diag Sigma ("tau": (1 - ||L^-1 e_i||^2) / tau_i where tau_i K_ii > 1, as the
# port has it; "K - V^T V": the product's diagonal), and mu = K alpha's alpha
# ("solve": S^1/2 B^-1 S^-1/2 nu as the port has it; "nu - ...": nu - S^1/2
# B^-1 S^1/2 K nu as the JAX package has it)
EP_FORMS = (("port", "nu . mu", "tau", "solve"),
            ("reference's alpha", "nu . mu", "tau", "nu - ..."),
            ("reference's quadratic", "Sigma @ nu", "tau", "solve"),
            ("reference's diag Sigma", "nu . mu", "K - V^T V", "solve"),
            ("reference", "Sigma @ nu", "K - V^T V", "nu - ..."))


def ep_evidence(K, y, quad="nu . mu", diag="tau", alpha="solve", max_sweeps=60):
    """Dense parallel EP from zero sites on ``K`` with probit sites (the
    sweeps and evidence of ``models/ep.ep_inference``), with nu^T Sigma nu
    read as ``quad``, diag Sigma as ``diag`` and alpha as ``alpha`` in the
    sweeps and the evidence (:data:`EP_FORMS`). Returns (evidence, sweeps)."""
    from .models import ep
    from .models.likelihoods import Bernoulli

    lik, y = Bernoulli(), y.reshape(-1)

    def posterior(tau, nu):
        mu, sigma2, L, Sigma = ep._dense_posterior_from_sites(K, tau, nu, full=True)
        if alpha == "nu - ...":
            sW = torch.sqrt(torch.clamp(tau, min=ep._TAU_EPS))
            mu = K @ (nu - sW * linalg.cho_solve(L, (sW * (K @ nu))[:, None])[:, 0])
        return mu, (torch.diagonal(Sigma) if diag == "K - V^T V" else sigma2), L, Sigma

    def sweep(tau, nu):
        mu, sigma2, _, _ = posterior(tau, nu)
        d_tau, d_nu, _, _, _ = ep._site_deltas(lik, y, tau, nu, mu, sigma2, 1.0, 0.5)
        return torch.clamp(tau + d_tau, min=ep._TAU_EPS), nu + d_nu

    with torch.no_grad():
        tau, nu, sweeps, _ = ep._run_sweeps(sweep, K.shape[-1], K, max_sweeps, 1e-6)
        mu, sigma2, L, Sigma = posterior(tau, nu)
        lml = ep._dense_ep_lml(lik, y, tau, nu, mu, sigma2, L, 1.0)
        if quad == "Sigma @ nu":
            lml = lml + 0.5 * (torch.sum(nu * (Sigma @ nu)) - torch.sum(nu * mu))
    return float(lml), sweeps


def ep_forms(kern, X, y):
    """``{form: (float32 evidence, its rel error against float64, sweeps)}``
    over :data:`EP_FORMS` at the RBF ``kern`` on ``X``, EP from zero sites in
    each dtype; the float64 evidence (the forms agree there) under
    "float64"."""
    with torch.no_grad():
        K32 = kern.K(X)
        K64 = tree_map(lambda t: t.double(), kern).K(X.double())
    e64, _ = ep_evidence(K64, y.double())
    out = {"float64": (e64, 0.0, 0)}
    for label, *form in EP_FORMS:
        e, sweeps = ep_evidence(K32, y.float(), *form)
        out[label] = (e, abs(e - e64) / abs(e64), sweeps)
    return out


def _ep_point():
    """Dense EP fitted as ``chip_smoke.py`` phase 9's leg fits it (EP, then two
    alternated rounds of 30 steps, float32 on the card); at the fitted point,
    the float32 evidence against float64 with each stage and pair of stages
    on the host (EP to convergence, fresh sites), through each reading of
    Sigma, and split into its pieces for each factor route."""
    from . import workload
    from .models.classification import GPClassification

    X, Y = workload.bench_data()
    model, _ = GPClassification.create(X, workload.classification_labels(Y)).optimize(
        rounds=2, maxiter=30)
    point = (f"variance {float(model.kern.variance):.6g}, lengthscale "
             f"{float(model.kern.lengthscale):.6g}")
    with torch.no_grad():
        e64 = float(tree_map(lambda t: t.double(), model).inference().lml)

    def rel(m):
        with torch.no_grad():
            post = m.inference()
        return {"rel": abs(float(post.lml) - e64) / abs(e64), "evidence": float(post.lml),
                "sweeps": int(post.sweeps)}

    rows = readings(lambda: rel(model)) + readings(
        lambda: rel(tree_map(lambda t: t.cpu(), model)), (("CPU entirely", ()),))
    print(f"# EP at the fitted point ({point}), float32 evidence against float64 "
          f"({e64:.4f}), stage swaps: " + format_readings(rows, ("rel", "evidence", "sweeps")))
    print("# EP at the fitted point, forms of Sigma: " + format_forms(
        ep_forms(model.kern, model.X, model.Y)))
    for route, d in ep_pieces(model.kern, model.X, model.Y).items():
        print(f"# EP at the fitted point, pieces of the evidence at float64's sites, factor by "
              f"{route}: " + "; ".join(f"{k} {v:+.3e}" for k, v in d.items()))


def ep_pieces(kern, X, y):
    """Dense EP's float32 evidence at float64 EP's converged sites for the RBF
    ``kern`` on ``X``, with B = I + S^1/2 K S^1/2 factored by each route: in
    float32 by ``cholesky_ex`` on the card, by the host's LAPACK, by the
    port's blocked Cholesky with B4; in float64, rounded to float32 (what
    ``models/ep`` does). Returns ``{route: {piece: error}}``: each of -1/2
    log|B|, 1/2 nu . mu and the rest (Z_tilde's cavities) against float64's,
    over |evidence|, and the mean signed relative error of diag Sigma and of
    mu."""
    from .models import ep
    from .models.likelihoods import Bernoulli

    lik = Bernoulli()
    kern64 = tree_map(lambda t: t.double(), kern)
    with torch.no_grad():
        K64 = kern64.K(X.double())
        post = ep.ep_inference(K64, y.double(), lik)
        K32 = kern.K(X)
    tau, nu = post.tau_site.float(), post.nu_site.float()
    sW = torch.sqrt(torch.clamp(tau, min=ep._TAU_EPS))
    B = ep._eye(K32.shape[-1], K32) + sW[:, None] * K32 * sW[None, :]

    def pieces(K, tau, nu, L):
        with torch.no_grad():
            mu, sigma2, L, _ = ep._posterior_from_factor(K, tau, nu, L)
            lml = ep._dense_ep_lml(lik, y.to(K.dtype), tau, nu, mu, sigma2, L, 1.0)
            ld = -0.5 * linalg.logdet_from_chol(L)
            q = 0.5 * torch.sum(nu * mu)
        return ([float(v) for v in (ld, q, lml - ld - q, lml)], sigma2.double(), mu.double())

    ref, s64, m64 = pieces(K64, post.tau_site, post.nu_site,
                           ep._dense_posterior_from_sites(K64, post.tau_site, post.nu_site)[2])
    factors = {
        "cholesky_ex f32": lambda: cuda_linalg.cholesky_plain(B),
        "host LAPACK f32": lambda: cuda_linalg.cholesky_plain(B.cpu()).to(B.device),
        "blocked with B4 f32": lambda: linalg.blocked_cholesky(B),
        "float64, rounded (the port)": lambda: cuda_linalg.cholesky_plain(B.double()).float()}
    out = {}
    for route, factor in factors.items():
        with torch.no_grad():
            L = factor()
        got, s32, m32 = pieces(K32, tau, nu, L)
        out[route] = {k: (g - r) / abs(ref[3]) for k, g, r in zip(
            ("-log|B| / 2", "nu . mu / 2", "rest", "evidence"), got, ref)}
        out[route]["diag Sigma"] = float(((s32 - s64) / s64).mean())
        out[route]["mu"] = float(((m32 - m64) / m64.abs().max()).mean())
    return out


def format_forms(forms):
    return "; ".join(f"{k} {e:.4f} (rel {r:.3e}, {n} sweeps)" for k, (e, r, n) in forms.items())


# the acquisition sweep's float32 -EI (``chip_smoke.py`` phase 12) at a
# stored fitted surrogate, with the stages of L^-1 Kx swapped
SWEEP_CONFIGS = CONFIGS[:4] + (
    ("plain K and triangular inverse", ("plain",)),
    ("L^-1 Kx by a triangular solve, no Li", ("no Li",)),
    ("Li Kx and var in float64 from float32 Li, Kx", ("gemm64",)))


@contextlib.contextmanager
def _sweep_stage(stages):
    """The stages of :data:`SWEEP_CONFIGS` that :func:`on_host` lacks."""
    from .models.gp import GPRegression

    half = GPRegression._half
    old = config.use_cuda_kernels, config.cuda_tri_inv
    try:
        if "plain" in stages:
            config.use_cuda_kernels, config.cuda_tri_inv = False, False
        if "gemm64" in stages:
            GPRegression._half = lambda self, post, Kx: post.Li.double() @ Kx.double()
        with on_host(tuple(s for s in stages if s in STAGES)):
            yield
    finally:
        config.use_cuda_kernels, config.cuda_tri_inv = old
        GPRegression._half = half


def mesh_sweep(leaves, n_shards=4, points=1000, seed=0, device=None):
    """-EI at ``points`` seeded points in [-2, 2]^D at the fitted surrogate
    ``leaves`` (``convert.gp_from_leaves``), float32 with the rows split over
    ``n_shards`` shards of one device and unsplit, each against float64 at
    the same leaves (the noise float32 evaluates): ``[(label, {reading:
    max |a - b| / max |b|}, rungs)]`` per configuration of
    :data:`SWEEP_CONFIGS` (the CPU entirely last), and the worst point's
    values on the device as is."""
    import numpy as np

    from . import convert
    from .bo.acquisitions import neg_ei
    from .models.bo_models import masked_fmin
    from .parallel import sharded

    device = torch.device(device or "cuda")
    leaves = {k: v for k, v in leaves.items() if k != "x"}
    gp32 = convert.gp_from_leaves(leaves, dtype=torch.float32, device=device)
    floor = config.f32_noise_floor - config.noise_jitter
    gp64 = convert.gp_from_leaves(leaves, dtype=torch.float64, device=device)
    gp64 = type(gp64)(**{**{f: getattr(gp64, f) for f in gp64.__dataclass_fields__},
                         "likelihood_variance": torch.clamp(gp64.likelihood_variance,
                                                            min=floor)})
    P = np.random.default_rng(seed).uniform(-2.0, 2.0, size=(points, gp32.X.shape[-1]))

    def neg(gp, post, pts, mesh=None):
        args = (gp, post, masked_fmin(gp, post))
        if mesh is None:
            return neg_ei(*args, pts)
        return sharded.make_sharded_sweep(lambda a, A: neg_ei(*a, A), mesh)(args, pts)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    with torch.no_grad():
        post64 = gp64.inference(precompute_inverse=True)
        pts64 = torch.as_tensor(P, dtype=torch.float64, device=device)
        e64 = neg(gp64, post64, pts64)
        e64s = neg(gp64, post64, pts64, sharded.make_mesh(n_shards, device=str(device)))

    def measure(gp, stages=()):
        mesh = sharded.make_mesh(n_shards, device=str(gp.X.device))
        pts = torch.as_tensor(P, dtype=torch.float32, device=gp.X.device)
        with _sweep_stage(stages), torch.no_grad():
            post = gp.inference(precompute_inverse="no Li" not in stages)
            su, ss = neg(gp, post, pts), neg(gp, post, pts, mesh)
        ref = e64.to(su.device)
        return {"sharded vs unsharded": rel(ss, su), "unsharded vs f64": rel(su, ref),
                "sharded vs f64": rel(ss, ref), "_values": (su, ss)}

    rows = []
    for label, stages in SWEEP_CONFIGS:
        with recording_rungs() as rungs:
            rows.append((label, measure(gp32, stages), rungs))
    with recording_rungs() as rungs:
        rows.append(("CPU entirely", measure(tree_map(lambda t: t.cpu(), gp32)), rungs))
    su, ss = rows[0][1]["_values"]
    i = int((ss.double() - su.double()).abs().argmax())
    with torch.no_grad():
        pt = torch.as_tensor(P[i:i + 1], device=device)
        m64, v64 = gp64.predict(pt, posterior=gp64.inference())
        m32, v32 = gp32.predict(pt.float(), posterior=gp32.inference(precompute_inverse=True))
        kdiag = float(gp64.kern.Kdiag(pt)[0])
    worst = (f"float64 sharded vs unsharded {rel(e64s, e64):.3e}; point {i}: -EI unsharded {float(su[i]):.6g}, sharded {float(ss[i]):.6g}, "
             f"float64 {float(e64[i]):.6g} (max |-EI64| {float(e64.abs().max()):.6g}); "
             f"variance f32 {float(v32):.6g} vs f64 {float(v64):.6g} of k(x, x) {kdiag:.6g}; "
             f"mean f32 {float(m32):.6g} vs f64 {float(m64):.6g}")
    return rows, worst


def main_sweep(path):
    """:func:`mesh_sweep` at the surrogate stored in ``path``, printed."""
    import numpy as np

    rows, worst = mesh_sweep(dict(np.load(path)))
    print(f"# the sweep's -EI at {path}, float32: "
          + format_readings(rows, ("sharded vs unsharded", "unsharded vs f64",
                                   "sharded vs f64")))
    print(f"# the sweep's widest sharded vs unsharded gap on the card, {worst}")


def refit(items, maxiter, dtype=None, device=None, n_max=None):
    """Each ``(X, Y, sel)`` of ``items`` fitted as ``utils/cluster.cluster``
    fits a lane (from its start, ``maxiter`` L-BFGS steps, padded to
    ``n_max`` rows, by default their own largest), all in one lane batch:
    ``(log likelihoods, fitted packed leaves (B, 4))`` as numpy arrays."""
    from .utils import cluster as tc

    dtype, device = tc._where(device, dtype)
    n_max = n_max or max(x.shape[0] for x, _, _ in items)
    ll, _, U = tc._fit_lanes(tc._u0(len(items), dtype, device),
                             *tc.pad_stack(items, n_max, dtype, device), True, maxiter)
    return ll.double().cpu().numpy(), U.double().cpu().numpy()


def cluster_joins(history):
    """Each round's best join, from ``utils/cluster.cluster(history=...)``:
    ``[(improvement, joined, pair fit, (single fit, single fit))]``, a fit
    being ``(members, (X, Y, sel), U, ll)``; the last is the stop."""
    latest, active, out = {}, None, []
    for fits in history:
        latest.update({f[0]: f for f in fits})
        singles = [f[0][0] for f in fits if len(f[0]) == 1]
        if active is None:
            active = singles
        else:
            (new,) = singles
            active = [c for c in active if not set(c) <= set(new)] + [new]
        best = None
        for a in range(len(active)):
            for b in range(a):
                pair = latest.get((active[a], active[b])) or latest[(active[b], active[a])]
                si, sj = latest[(pair[0][0],)], latest[(pair[0][1],)]
                imp = pair[3] - si[3] - sj[3]
                if best is None or imp > best[0]:
                    best = (imp, imp > 0, pair, (si, sj))
        if best is None:
            break
        out.append(best)
    return out


def cluster_readings(series=40, points=20, maxiter=30, path=None, device=None):
    """``chip_smoke.py`` phase 12's float32 clustering on the card, and for
    each round's best join its improvement (the pair's log likelihood less
    its singles') in float32, in float64 at the same leaves and noise, and in
    float64 with the three lanes fitted again from the loop's start: one line
    a round. The joins of two families and the stop go to ``path`` (npz:
    each round's three lanes, their float32 leaves and log likelihoods) for
    the JAX package's own fits of the same lanes
    (tests/test_torch_cluster.py::test_jax_fits_of_the_cards_family_joins)."""
    import numpy as np

    from . import workload
    from .utils import cluster as tc

    data, inputs, fam = workload.cluster_data(series, points)
    n_max = series * points
    history = []
    groups = tc.cluster([d.copy() for d in data], [x.copy() for x in inputs],
                        maxiter=maxiter, history=history, device=device,
                    dtype=torch.float32)
    print(f"# cluster f32: families per group "
          f"{[sorted({fam[i] for i in g}) for g in groups]}")
    joins = cluster_joins(history)
    lanes = [f for _, _, pair, singles in joins for f in (pair,) + singles]
    items = [f[1] for f in lanes]
    at_leaves = tc.lane_lml(tc.f32_effective(np.stack([f[2] for f in lanes])), items,
                            dtype=torch.float64, device=device)
    refitted, _ = refit(items, maxiter, dtype=torch.float64, device=device, n_max=n_max)
    saved = {"n_max": np.array(n_max), "maxiter": np.array(maxiter)}
    for r, (imp, joined, pair, _) in enumerate(joins):
        same, fit = at_leaves[3 * r:3 * r + 3], refitted[3 * r:3 * r + 3]
        members = [sorted({fam[i] for i in m}) for m in pair[0]]
        print(f"# cluster f32, round {r + 1} {'join' if joined else 'stop, best rejected'} "
              f"families {members[0]} + {members[1]}: f32 {imp:+.4f}; f64 at the same leaves "
              f"{same[0] - same[1] - same[2]:+.4f}; f64 fitted from the same start "
              f"{fit[0] - fit[1] - fit[2]:+.4f}; pair LL f32 {pair[3]:.4f}, f64 at its leaves "
              f"{same[0]:.4f}, f64 fitted {fit[0]:.4f}")
        if members[0] != members[1] or not joined:
            for k, f in enumerate(lanes[3 * r:3 * r + 3]):
                for name, a in zip(("X", "Y", "sel"), f[1]):
                    saved[f"r{r + 1}_{name}{k}"] = np.asarray(a)
            saved[f"r{r + 1}_U"] = np.stack([f[2] for f in lanes[3 * r:3 * r + 3]])
            saved[f"r{r + 1}_ll"] = np.array([f[3] for f in lanes[3 * r:3 * r + 3]])
    if path is not None:
        np.savez_compressed(path, **saved)
    return joins


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 2 and sys.argv[1] == "--sweep":
        main_sweep(sys.argv[2])
    elif len(sys.argv) > 2 and sys.argv[1] == "--cluster":
        cluster_readings(path=sys.argv[2])
    else:
        main()
