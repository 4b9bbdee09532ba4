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

``chip_smoke.py`` phases 9-11 call :func:`readings` at their fitted points.
``python -m gaussian_process_optimization_tpu_torch.prof_stages`` prints the
backward error and the log-determinant error of each float32 factorization
route against float64 on a Matern52 Gram at two noise levels, and dense EP's
float32 evidence at a card-fitted point with each stage on the host.
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


# dense EP's hyperparameters after two float32 alternated rounds on an H100
# (chip_smoke.py phase 9's leg, RBF, N = 4096, with prof_b1_bias.py's
# ``repair`` profile in the kernels)
EP_POINT = {"variance": 455.782, "lengthscale": 3.44876}


def _ep_point():
    """Dense EP's float32 evidence at EP_POINT against float64, with each stage
    and pair of stages on the host (EP to convergence, fresh sites)."""
    from . import workload
    from .kernels.stationary import RBF
    from .models.classification import GPClassification

    X, Y = workload.bench_data()
    labels = workload.classification_labels(Y)

    def evidence(dtype, device="cuda"):
        kern = RBF.create(X.shape[1], **EP_POINT, dtype=dtype, device=device)
        post = GPClassification.create(X, labels, kernel=kern, dtype=dtype,
                                       device=device).inference()
        return float(post.lml), int(post.sweeps)

    e64, _ = evidence(torch.float64)

    def rel(device="cuda"):
        e, sweeps = evidence(torch.float32, device)
        return {"rel": abs(e - e64) / abs(e64), "evidence": e, "sweeps": sweeps}

    rows = readings(rel) + readings(lambda: rel("cpu"), (("CPU entirely", ()),))
    for label, form in (("Sigma's product V^T V on the host", "host"),
                        ("diag Sigma as diag K - sum V^2", "sum")):
        with _sigma_form(form), recording_rungs() as rungs:
            rows.append((f"card, {label}", rel(), rungs))
    print(f"# EP at {EP_POINT}, float32 evidence against float64 ({e64:.4f}), stage swaps: "
          + format_readings(rows, ("rel", "evidence", "sweeps")))


@contextlib.contextmanager
def _sigma_form(form):
    """Dense EP's posterior with Sigma = K - V^T V formed otherwise: the
    product on the host ("host"), or its diagonal replaced by diag K - the
    column sums of V^2 ("sum"), the rest as ``models/ep`` has it."""
    from .models import ep

    original = ep._dense_posterior_from_sites

    def posterior(K, tau, nu):
        n = K.shape[-1]
        sW = torch.sqrt(torch.clamp(tau, min=ep._TAU_EPS))
        L, _, _ = linalg.jitchol(ep._eye(n, K) + sW[..., :, None] * K * sW[..., None, :])
        V = linalg.solve_lower(L, sW[..., :, None] * K)
        if form == "host":
            Sigma = K - (V.mT.cpu() @ V.cpu()).to(K.device)
        else:
            Sigma = K - V.mT @ V
            Sigma.diagonal(dim1=-2, dim2=-1).copy_(
                torch.diagonal(K, dim1=-2, dim2=-1) - torch.sum(V * V, dim=-2))
        aux = linalg.cho_solve(L, (sW * ep._mv(K, nu))[..., None])[..., 0]
        alpha = nu - sW * aux
        return ep._mv(K, alpha), Sigma, L, alpha

    ep._dense_posterior_from_sites = posterior
    try:
        yield
    finally:
        ep._dense_posterior_from_sites = original


if __name__ == "__main__":
    main()
