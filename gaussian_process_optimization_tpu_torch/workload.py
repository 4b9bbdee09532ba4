"""The bench's workloads, through the port's own entry points.

The main path, one BO iteration as the JAX package's ``bench.py`` (``run_ours``)
defines it: a padded ``GPRegression`` with an ARD Matern52 kernel on the bench's
data recipe, a multi-restart L-BFGS fit of the negative LML, the posterior with
L^-1 precomputed, an EI sweep over random candidates, and box-bounded value-only
L-BFGS from the best few candidates. Candidates and restart starts can be handed
in.

The thesis path (``run_gower_lp``, bench.py:177-213): ``BayesianOptimization``
on 4 continuous and 2 discrete inputs with the Gower kernel, ``exact_feval``,
and a local-penalization batch of 5, one ``suggest_next_locations`` per
iteration (fit, Lipschitz estimate, 5 penalized argmaxes).

The sequential loop (``regret_run``): one run of the regret protocol of
``benchmarks/regret_compare.py``, ``BayesianOptimization(f, domain, EI, latin
init 5, exact_feval).run_optimization(iters, eps=-1)`` on one of the test
functions of ``bo/objectives.py``.

The composite path (``composite_bo``): the main path's data under the options the
main path leaves out: an ``Add`` kernel (ARD Matern52 on every input plus an RBF
on the first), Gamma priors on every lengthscale and variance, a constant mean
function, the LCB acquisition from Sobol anchors, and the tell-and-ask loop on
the recipe's noise-free function.

The surrogates (``surrogate_bo``, ``surrogate_iteration``,
``entropy_search_argmax``, ``sparse_data`` / ``sparse_model``): GPyOpt's other
model types and acquisitions on the bench's data through
``BayesianOptimization`` (GP_MCMC with EI_MCMC at GPyOpt's HMC defaults,
sparseGP, warpedGP, input_warped_GP, RF), entropy search (ES, ES_EPMGP) on a
fitted exact GP, and the sparse bound at the recipe of
``examples/large_scale_sparse.py`` (N = 50 000, D = 2, M = 256 inducing points,
RBF, noise 0.05). Each iteration reports a host-clock split.

The sizes are arguments, so a test can run the same functions small.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .bo import objectives
from .bo.acquisitions import AcquisitionBase, neg_ei
from .bo.entropy_search import AcquisitionEntropySearch, AcquisitionEntropySearchEPMGP
from .bo.optimizer import AcquisitionOptimizer
from .bo.space import DesignSpace
from .bo.methods import BayesianOptimization
from .bo.space import bounds_to_space
from .config import resolve_device, resolve_dtype
from .kernels.stationary import RBF, Matern52
from .models import fit as fit_module
from .models.bo_models import GPModel
from .models.fit import Fitter
from .models.gp import GPRegression, Posterior
from .models.sparse import SparseGPRegression
from .models.mean_functions import Constant
from .ops import lbfgs
from .ops.lbfgs import LBFGSResult
from .utils.priors import GammaPrior

# benchmarks/regret_compare.py:28-35: name -> (iterations, bounds, None = the function's own)
FUNC_SPECS = {
    "forrester": (20, None),
    "branin": (20, None),
    "sixhumpcamel": (25, None),
    "alpine1": (25, [(-10.0, 10.0)] * 2),
    "ackley": (25, [(-32.768, 32.768)] * 2),
    "hartmann6": (30, None),
}

# bench.py:70-76
N = 4096
D = 6
FIT_RESTARTS = 5
FIT_STEPS = 30
ACQ_SWEEP = 1000
ACQ_ANCHORS = 5
ACQ_STEPS = 50
BOX = (-2.0, 2.0)
# bench.py:187-203
THESIS_BATCH = 5
THESIS_DOMAIN = (
    [{"name": f"x{i}", "type": "continuous", "domain": (-2.0, 2.0)} for i in range(4)]
    + [{"name": f"d{i}", "type": "discrete", "domain": (0, 1, 2)} for i in range(2)])


def bench_data(n: int = N, d: int = D, seed: int = 0):
    """The bench's data recipe (bench.py:79-84), numpy float64."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n, d))
    Y = np.sin(X[:, :1] * 2.0) + 0.3 * np.cos(X.sum(1, keepdims=True)) \
        + 0.05 * rng.standard_normal((n, 1))
    return X, Y


def make_model(X, Y, dtype=None, device=None) -> GPRegression:
    """The bench's padded ARD Matern52 GP; ``device`` None means the card,
    ``dtype`` None float32 there (float64 on the CPU)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    d = X.shape[1]
    return GPRegression.create(
        X, Y, kernel=Matern52.create(d, ARD=True, dtype=dtype, device=device),
        noise_var=0.05, max_points=X.shape[0], dtype=dtype, device=device)


def fit(model: GPRegression, restarts: int = FIT_RESTARTS, steps: int = FIT_STEPS,
        starts: torch.Tensor | None = None, generator: torch.Generator | None = None):
    """``Fitter(restarts, maxiter=steps, tol=0.0)``; returns (fitted, LBFGSResult)."""
    fitter = Fitter(model, num_restarts=restarts, maxiter=steps, tol=0.0)
    if starts is None:
        starts = fitter.draw_starts(model, generator)
    return fitter.solve(model, starts)


@dataclasses.dataclass
class Acquisition:
    posterior: Posterior
    fmin: torch.Tensor
    candidates: torch.Tensor
    anchors: torch.Tensor
    result: LBFGSResult  # one lane per anchor
    x: torch.Tensor      # argmax of EI
    f: torch.Tensor      # its negative EI


def acquire(model: GPRegression, sweep: int = ACQ_SWEEP, anchors: int = ACQ_ANCHORS,
            steps: int = ACQ_STEPS, candidates: torch.Tensor | None = None,
            generator: torch.Generator | None = None) -> Acquisition:
    """EI argmax as bench.py:132-159: posterior with Li, fmin over the real
    rows, a candidate sweep, the ``anchors`` best candidates, and value-only
    box-bounded L-BFGS from each (one lane per anchor)."""
    X = model.X
    d = X.shape[1]
    post = model.inference(precompute_inverse=True)
    mu = model.predict(X, posterior=post)[0]
    fmin = torch.min(torch.where(model.mask[:, None] > 0, mu,
                                 torch.full_like(mu, float("inf"))))
    lo = torch.full((d,), BOX[0], dtype=X.dtype, device=X.device)
    hi = torch.full((d,), BOX[1], dtype=X.dtype, device=X.device)
    if candidates is None:
        u = torch.rand((sweep, d), generator=generator, dtype=X.dtype, device=X.device)
        candidates = lo + (hi - lo) * u
    scores = neg_ei(model, post, fmin, candidates)
    starts = candidates[torch.argsort(scores, stable=True)[:anchors]]
    res = lbfgs.minimize(lambda A: neg_ei(model, post, fmin, A[:, None, :])[:, 0],
                         starts, lower=lo, upper=hi, maxiter=steps, tol=0.0,
                         carry_graph=False)
    best = int(torch.argmin(res.f))
    return Acquisition(posterior=post, fmin=fmin, candidates=candidates, anchors=starts,
                       result=res, x=res.x[best], f=res.f[best])


def thesis_data(n: int = N, seed: int = 0):
    """The thesis recipe (bench.py:187-193), numpy float64: 4 continuous
    inputs in [-2, 2] and 2 discrete ones in {0, 1, 2}."""
    rng = np.random.default_rng(seed)
    Xc = rng.uniform(-2.0, 2.0, (n, 4))
    Xd = rng.integers(0, 3, (n, 2)).astype(float)
    X = np.hstack([Xc, Xd])
    Y = (np.sin(Xc[:, :1] * 2.0) + 0.3 * np.cos(Xc.sum(1, keepdims=True))
         + 0.1 * Xd[:, :1] + 0.05 * rng.standard_normal((n, 1)))
    return X, Y


def thesis_bo(X, Y, restarts: int = FIT_RESTARTS, steps: int = FIT_STEPS,
              batch: int = THESIS_BATCH, device=None,
              dtype=None) -> BayesianOptimization:
    """The bench's ask-tell optimizer (bench.py:198-203); ``device`` None
    means the card."""
    return BayesianOptimization(
        f=None, domain=THESIS_DOMAIN, X=X, Y=Y, Gower=True, acquisition_type="EI",
        evaluator_type="local_penalization", batch_size=batch, exact_feval=True, seed=0,
        max_iters=steps, optimize_restarts=restarts, device=resolve_device(device),
        dtype=dtype)


@dataclasses.dataclass
class ThesisIteration:
    batch: np.ndarray        # (batch, 6), objective space
    fit_s: float             # refit (multi-restart fit and posterior)
    estimate_L_s: float      # Lipschitz estimate
    argmax_s: list           # one per penalized argmax


def thesis_iteration(bo: BayesianOptimization) -> ThesisIteration:
    """One ``suggest_next_locations`` and its host-clock split. Each piece ends
    in a host read of its result, so its device work is inside its time."""
    batch = bo.suggest_next_locations()
    seconds = bo.evaluator.seconds
    return ThesisIteration(batch=batch, fit_s=bo.fit_seconds,
                           estimate_L_s=seconds["estimate_L"], argmax_s=seconds["argmax"])


@dataclasses.dataclass
class RegretRun:
    regret: list             # best-so-far minus the function's minimum, per evaluation
    fx_opt: float
    evaluations: int
    fit_failed: bool
    seconds: dict            # the loop's host-clock sums: fit, acquisition, objective
    bo: BayesianOptimization


def regret_run(func_name: str, seed: int, iters: int | None = None, device=None,
               dtype=None, **kwargs) -> RegretRun:
    """One run of the regret protocol (benchmarks/regret_compare.py:61-68): EI,
    latin initial design of 5, ``exact_feval``, ``eps=-1`` so that every
    iteration runs. ``iters`` None is the protocol's count for the function;
    ``device`` None means the card."""
    func = getattr(objectives, func_name)
    spec_iters, bounds = FUNC_SPECS.get(func_name, (20, None))
    bo = BayesianOptimization(
        f=func, domain=bounds_to_space(bounds or func.bounds), acquisition_type="EI",
        initial_design_numdata=5, initial_design_type="latin", exact_feval=True, seed=seed,
        device=resolve_device(device), dtype=dtype, **kwargs)
    bo.run_optimization(max_iter=spec_iters if iters is None else iters, eps=-1)
    regret = np.minimum.accumulate(bo.Y[:, 0]) - float(func.fmin)
    return RegretRun(regret=regret.tolist(), fx_opt=bo.fx_opt, evaluations=len(bo.Y),
                     fit_failed=bo._fit_failed, seconds=dict(bo.seconds), bo=bo)


def bench_function(x):
    """The bench recipe's function without its noise (bench.py:82-83)."""
    x = np.atleast_2d(x)
    return np.sin(x[:, :1] * 2.0) + 0.3 * np.cos(x.sum(1, keepdims=True))


def composite_bo(X, Y, restarts: int = FIT_RESTARTS, steps: int = FIT_STEPS, device=None,
                 dtype=None, kernel=None, mean_function=None,
                 **kwargs) -> BayesianOptimization:
    """The composite path's optimizer on given data: ``Matern52(ARD) +
    RBF(active_dims=(0,))``, Gamma(2, 1) priors on ``lengthscale`` and
    ``variance`` (every part's), a ``Constant`` mean function, LCB from Sobol
    anchors, the sequential evaluator. ``kernel`` / ``mean_function`` replace
    the defaults (a fitted model's, say); further ``kwargs`` go to
    ``BayesianOptimization`` and override these choices. ``device`` None means
    the card."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    d = X.shape[1]
    if kernel is None:
        kernel = (Matern52.create(d, ARD=True, dtype=dtype, device=device)
                  + RBF.create(1, active_dims=(0,), dtype=dtype, device=device))
    if mean_function is None:
        mean_function = Constant.create(d, dtype=dtype, device=device)
    options = dict(
        acquisition_type="LCB", evaluator_type="sequential", anchor_points_design="sobol",
        priors={"lengthscale": GammaPrior(2.0, 1.0), "variance": GammaPrior(2.0, 1.0)},
        max_iters=steps, optimize_restarts=restarts, seed=0)
    options.update(kwargs)
    return BayesianOptimization(
        f=bench_function, domain=bounds_to_space([BOX] * d), X=X, Y=Y, kernel=kernel,
        mean_function=mean_function, device=device, dtype=dtype, **options)


def _synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def surrogate_bo(X, Y, model_type: str, acquisition_type: str = "EI", device=None, dtype=None,
                 **kwargs) -> BayesianOptimization:
    """Ask-tell ``BayesianOptimization`` on the given data over the bench's box
    with another surrogate (``model_type``: 'GP_MCMC', 'sparseGP', 'warpedGP',
    'input_warped_GP', 'RF' or 'GP') and acquisition, GPyOpt's defaults
    otherwise; ``kwargs`` go to it. ``device`` None means the card."""
    return BayesianOptimization(
        f=None, domain=bounds_to_space([BOX] * X.shape[1]), X=X, Y=Y, model_type=model_type,
        acquisition_type=acquisition_type, seed=0, device=resolve_device(device),
        dtype=dtype, **kwargs)


@dataclasses.dataclass
class SurrogateIteration:
    batch: np.ndarray        # the suggestion(s), objective space
    seconds: dict            # host clock: fit (and, for GP_MCMC, hmc and posterior), argmax


def surrogate_iteration(bo: BayesianOptimization) -> SurrogateIteration:
    """One ``suggest_next_locations`` and its split. The MCMC surrogate's refit
    is split into its fit, its HMC chain and the S-lane posterior."""
    t0 = time.perf_counter()
    batch = bo.suggest_next_locations()
    total = time.perf_counter() - t0
    seconds = {"fit": bo.fit_seconds}
    model_seconds = getattr(bo.model, "seconds", None)
    if isinstance(model_seconds, dict) and "hmc" in model_seconds:
        seconds = dict(model_seconds)
    seconds["argmax"] = total - bo.fit_seconds
    return SurrogateIteration(batch=batch, seconds=seconds)


@dataclasses.dataclass
class EntropySearchArgmax:
    x: np.ndarray            # (1, d), the argmax
    f: np.ndarray            # (1, 1), its minimize-convention value
    acquisition: AcquisitionBase
    seconds: dict            # host clock: representers (sampler and p_min), argmax


def entropy_search_argmax(model: GPRegression, acquisition: str = "ES_EPMGP",
                          representers: int = 50, burn_in: int = 50, sweep: int = ACQ_SWEEP,
                          anchors: int = ACQ_ANCHORS, posterior=None) -> EntropySearchArgmax:
    """One argmax of entropy search on a fitted exact GP, over the bench's box,
    on the model's device and in its dtype: the representers (ensemble sampler,
    then EPMGP's p_min or the MC draws), then the sweep of ``sweep`` candidates,
    whose best ``anchors`` are the candidates (ES has no gradient)."""
    surrogate = GPModel.from_fitted(model, posterior=posterior)
    space = DesignSpace(bounds_to_space([BOX] * model.X.shape[1]))
    opt = AcquisitionOptimizer(space, model=surrogate, num_samples=sweep, num_anchor=anchors)
    cls = {"ES": AcquisitionEntropySearch, "ES_EPMGP": AcquisitionEntropySearchEPMGP}[acquisition]
    acq = cls(surrogate, space, opt, num_representer_points=representers,
              burn_in_steps=burn_in)
    t0 = time.perf_counter()
    acq._update_representers()
    _synchronize(model.X.device)
    t1 = time.perf_counter()
    x, f = AcquisitionBase.optimize(acq)
    return EntropySearchArgmax(x=x, f=f, acquisition=acq,
                               seconds={"representers": t1 - t0,
                                        "argmax": time.perf_counter() - t1})


# examples/large_scale_sparse.py:20-48 (BASELINE.md configuration 4)
SPARSE_N = 50_000
SPARSE_M = 256


def sparse_truth(X):
    return np.sin(X[:, :1] * 2.0) * np.cos(X[:, 1:2])


def sparse_data(n: int = SPARSE_N, seed: int = 0):
    """The sparse example's recipe, numpy float64: X uniform in [-3, 3]^2,
    sin(2 x0) cos(x1) plus noise of std 0.1."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, size=(n, 2))
    return X, sparse_truth(X) + 0.1 * rng.standard_normal((n, 1))


def sparse_model(X, Y, num_inducing: int = SPARSE_M, inference: str = "vardtc", device=None,
                 dtype=None) -> SparseGPRegression:
    """The example's model: RBF (variance 1, lengthscale 1), noise 0.05, Z a
    seeded random subset of X; ``device`` None means the card."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    kern = RBF.create(X.shape[1], variance=1.0, lengthscale=1.0, dtype=dtype, device=device)
    return SparseGPRegression.create(X, Y, kernel=kern, num_inducing=num_inducing,
                                     noise_var=0.05, inference=inference, dtype=dtype,
                                     device=device)


def sparse_fit(model: SparseGPRegression, steps: int = 50, generator=None):
    """The example's fit: one restart of ``steps`` L-BFGS steps on the bound,
    Z included; returns (fitted, LBFGSResult, seconds)."""
    t0 = time.perf_counter()
    fitted, res = fit_module.fit(model, num_restarts=1, maxiter=steps, generator=generator)
    _synchronize(model.X.device)
    return fitted, res, time.perf_counter() - t0
