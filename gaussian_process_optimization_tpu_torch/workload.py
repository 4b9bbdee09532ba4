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

The approximate-inference slice (``svgp_model`` / ``svgp_fit`` / ``svgp_probe``,
``classification_labels``, ``outlier_targets``): minibatch SVGP at the same
sparse recipe with the example's 300 Adam steps at batch 2048 and learning rate
1e-2, the classifiers' labels sign(Y - median Y) on the main data, and the main
targets with 5% of rows lifted by 5 standard deviations (the robust-regression
gallery's outliers).

The zoo slice (``icm_data`` / ``icm_model`` / ``icm_fit``, ``co2_data`` /
``co2_model``, ``grid_data`` / ``grid_model`` / ``grid_fit``, ``state_space_data``
/ ``state_space_model``, ``zoo_cases``): ICM coregionalized regression on three
correlated targets of the bench function over the main data's inputs (rank 1,
ARD Matern52 on the inputs); the Mauna Loa composition of Rasmussen & Williams
2006, eq. 5.19, plus a linear trend, on a 1-D seasonal series; a Kronecker GP
on a square grid with an RBF per axis; the quasi-periodic state-space GP on a
1-D series; and every other zoo kernel on inputs of its own layout.

The latent slice (``oil_like``, ``simulate_sincos``, ``latent_data``,
``gplvm_model`` / ``gplvm_fit``, ``bgplvm_model`` / ``bgplvm_fit``,
``latent_legs``): the gallery's data generators
(``examples/gallery/dimensionality_reduction.py:19-40``, numpy copies); the
point GPLVM of GPy's ``gplvm_oil_100`` (RBF ARD + Bias, Q = 6) and the Bayesian
GPLVM of ``bgplvm_oil`` (ARD RBF, Q = 7, M = 40) on an oil-flow-shaped stand-in
of 12 dimensions and 3 classes at N = 4096, with 256 held-out rows; and one
short run of each other latent and zoo model.

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
from .kernels.base import placement
from .kernels.linear import Linear, LinearFull
from .kernels.other import MLP, Brownian, Poly, Spline, StandardPeriodic
from .kernels.static import Bias, Fixed, WhiteHeteroscedastic
from .kernels.stationary import RBF, Matern32, Matern52, RatQuad
from .models import fit as fit_module
from .models.bo_models import GPModel
from .models.fit import Fitter
from .models.gp import GPRegression, Posterior
from .models.gp_grid import GPGridRegression
from .models.multioutput import GPCoregionalizedRegression
from .models.state_space import StateSpaceGP, from_kernel
from .models.sparse import SparseGPRegression
from .models.svgp import SVGP, fit_svgp
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


# examples/large_scale_sparse.py:38-40: the SVGP leg of BASELINE.md configuration 4
SVGP_STEPS = 300
SVGP_BATCH = 2048
SVGP_LR = 1e-2


def svgp_model(X, Y, num_inducing: int = SPARSE_M, device=None, dtype=None) -> SVGP:
    """The example's SVGP: RBF (variance 1, lengthscale 1), noise 0.05, Z a
    seeded random subset of X, q(u) whitened at N(0, I); ``device`` None
    means the card."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    kern = RBF.create(X.shape[1], variance=1.0, lengthscale=1.0, dtype=dtype, device=device)
    return SVGP.create(X, Y, kernel=kern, num_inducing=num_inducing, noise_var=0.05,
                       dtype=dtype, device=device)


def svgp_fit(model: SVGP, X, Y, steps: int = SVGP_STEPS, batch: int = SVGP_BATCH,
             generator=None, indices=None):
    """The example's minibatch Adam; returns (fitted, -ELBO per step, seconds)."""
    t0 = time.perf_counter()
    fitted, losses = fit_svgp(model, X, Y, num_steps=steps, batch_size=batch,
                              learning_rate=SVGP_LR, generator=generator, indices=indices)
    _synchronize(model.Z.device)
    return fitted, losses, time.perf_counter() - t0


def svgp_probe(model: SVGP, seed: int = 0) -> SVGP:
    """The model with a seeded, non-trivial q(u) (q_mu ~ N(0, 0.25), q_sqrt
    0.3 I plus a small random lower triangle), drawn in numpy float64 so that
    every device and dtype gets the same leaves: a point at which to hold the
    float32 ELBO against float64, where the whitened mean passes through
    Kmm's ill-conditioned factor."""
    rng = np.random.default_rng(seed)
    m, p = model.q_mu.shape
    q_mu = 0.5 * rng.standard_normal((m, p))
    Ls = 0.3 * np.eye(m)[None] + 0.01 * np.tril(rng.standard_normal((p, m, m)), -1)
    rows, cols = np.tril_indices(m)
    like = dict(dtype=model.q_mu.dtype, device=model.q_mu.device)
    return dataclasses.replace(model, q_mu=torch.as_tensor(q_mu, **like),
                               q_sqrt_flat=torch.as_tensor(Ls[:, rows, cols].T.copy(), **like))


def classification_labels(Y):
    """sign(Y - median(Y)) as {-1, +1}."""
    Y = np.asarray(Y, dtype=float).reshape(-1)
    return np.where(Y > np.median(Y), 1.0, -1.0)


def outlier_targets(Y, share: float = 0.05, sigmas: float = 5.0, seed: int = 0):
    """Y with a seeded ``share`` of its rows lifted by ``sigmas`` standard
    deviations (examples/gallery/non_gaussian.py's corrupted targets)."""
    Y = np.asarray(Y, dtype=float).reshape(-1).copy()
    rows = np.random.default_rng(seed).permutation(Y.shape[0])[:int(share * Y.shape[0])]
    Y[rows] += sigmas * Y.std()
    return Y


# the zoo slice's main path: ICM over 3 tasks of the main data (4096 rows in all)
ICM_TASKS = 3
ICM_SCALES = (1.0, 0.7, -0.5)   # task t's target: s_t f(x) + c_t + noise
ICM_OFFSETS = (0.0, 0.3, -0.2)
ICM_NOISE = 0.05


def icm_data(n: int = N, d: int = D, tasks: int = ICM_TASKS, seed: int = 0):
    """(X_list, Y_list): the bench's inputs split into ``tasks`` near-equal
    parts (1366 + 1365 + 1365 at N = 4096), task t's targets s_t f(x) + c_t plus
    noise of std 0.05 with f the bench function: one latent function, so a
    rank-1 coregionalization fits them."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(BOX[0], BOX[1], size=(n, d))
    Xs = np.array_split(X, tasks)
    Ys = [ICM_SCALES[t % len(ICM_SCALES)] * bench_function(Xt) + ICM_OFFSETS[t % 3]
          + ICM_NOISE * rng.standard_normal((len(Xt), 1)) for t, Xt in enumerate(Xs)]
    return Xs, Ys


def icm_model(X_list, Y_list, rank: int = 1, noise_var: float = 0.1, dtype=None,
              device=None) -> GPCoregionalizedRegression:
    """GPCoregionalizedRegression with an ARD Matern52 on the inputs;
    ``device`` None means the card."""
    where = placement(dtype, device)
    d = np.atleast_2d(X_list[0]).shape[1]
    return GPCoregionalizedRegression(X_list, Y_list,
                                      base_kernel=Matern52.create(d, ARD=True, **where),
                                      rank=rank, noise_var=noise_var, **where)


def icm_fit(model: GPCoregionalizedRegression, restarts: int = FIT_RESTARTS,
            steps: int = FIT_STEPS, starts: torch.Tensor | None = None, generator=None):
    """The main path's fit on the coregionalized GP (``Fitter(restarts,
    maxiter=steps, tol=0.0)``); the model takes the fitted GP. Returns the
    LBFGSResult."""
    model.model, res = fit(model.model, restarts, steps, starts=starts, generator=generator)
    return res


def co2_data(n: int = N, seed: int = 0):
    """A seasonal series: 1-D times over 20 years, a linear trend, a yearly
    cycle, a slower 7-year swing and noise of std 0.1 (numpy float64)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 20.0, n))[:, None]
    y = (0.15 * t + 0.8 * np.sin(2 * np.pi * t) + 0.3 * np.sin(2 * np.pi * t / 7.0)
         + 0.1 * rng.standard_normal((n, 1)))
    return t, y


def co2_kernel(dtype=None, device=None):
    """RBF (long-term) + StandardPeriodic * RBF (a decaying yearly cycle) +
    RatQuad (medium-term irregularities) + Linear + Bias: the Mauna Loa CO2
    composition (Rasmussen & Williams 2006, sec. 5.4.3, eq. 5.19) plus a
    linear trend."""
    where = placement(dtype, device)
    return (RBF.create(1, variance=1.0, lengthscale=5.0, **where)
            + StandardPeriodic.create(1, variance=1.0, period=1.0, lengthscale=1.0, **where)
            * RBF.create(1, variance=1.0, lengthscale=10.0, **where)
            + RatQuad.create(1, variance=0.5, lengthscale=1.0, power=1.0, **where)
            + Linear.create(1, variances=0.01, **where) + Bias.create(1, variance=1.0, **where))


def co2_model(X, Y, dtype=None, device=None) -> GPRegression:
    where = placement(dtype, device)
    return GPRegression.create(X, Y, kernel=co2_kernel(**where), noise_var=0.01, **where)


GRID_SIDE = 64


def grid_data(side: int = GRID_SIDE, seed: int = 0):
    """(axes, Y): a side x side grid on [0, 1]^2, sin(6 x1) cos(4 x2) plus
    noise of std 0.05."""
    rng = np.random.default_rng(seed)
    a1, a2 = np.linspace(0.0, 1.0, side), np.linspace(0.0, 1.0, side)
    Y = (np.sin(6 * a1)[:, None] * np.cos(4 * a2)[None, :]
         + 0.05 * rng.standard_normal((side, side)))
    return (a1, a2), Y


def grid_model(axes, Y, dtype=None, device=None) -> GPGridRegression:
    """GPGridRegression with an RBF (lengthscale 0.2) per axis, noise 0.05."""
    where = placement(dtype, device)
    return GPGridRegression.create(axes, Y, [RBF.create(1, lengthscale=0.2, **where)
                                             for _ in axes], noise_var=0.05, **where)


def grid_dense(model: GPGridRegression) -> GPRegression:
    """The same model as a dense GP on the grid's points (the product of the
    axis kernels, each on its own column)."""
    pts = torch.cartesian_prod(*(a[:, 0] for a in model.axes))
    pts = pts.reshape(-1, len(model.axes))
    kern = None
    for i, k in enumerate(model.kerns):
        part = dataclasses.replace(k, active_dims=(i,))
        kern = part if kern is None else kern * part
    return GPRegression(kern=kern, likelihood_variance=model.likelihood_variance, X=pts,
                        Y=model.Y.reshape(-1, 1))


def grid_fit(model: GPGridRegression, restarts: int = 1, steps: int = FIT_STEPS):
    """L-BFGS on the -LML with the grid's coordinates fixed (the reference's
    packing trains them); returns (fitted, LBFGSResult)."""
    return fit_module.fit(model, num_restarts=restarts, maxiter=steps, fix=("axes",))


def state_space_data(n: int = N, seed: int = 0):
    """A quasi-periodic 1-D series: times over [0, 40], a cycle of period 2
    under a slow amplitude drift, noise of std 0.1."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 40.0, n))
    y = (1.0 + 0.5 * np.sin(t / 7.0)) * np.sin(np.pi * t) + 0.1 * rng.standard_normal(n)
    return t, y


def state_space_kernel(dtype=None, device=None):
    """Matern32 + StandardPeriodic * Matern32 (quasi-periodic)."""
    where = placement(dtype, device)
    return (Matern32.create(1, variance=0.5, lengthscale=5.0, **where)
            + StandardPeriodic.create(1, variance=1.0, period=2.0, lengthscale=1.0, **where)
            * Matern32.create(1, variance=1.0, lengthscale=10.0, **where))


def state_space_model(t, y, kernel=None, order: int = 7, dtype=None,
                      device=None) -> StateSpaceGP:
    where = placement(dtype, device)
    kernel = state_space_kernel(**where) if kernel is None else kernel
    return from_kernel(kernel, t, y, noise_var=0.01, order=order, **where)


def zoo_cases(n: int = N, seed: int = 0, dtype=None, device=None):
    """[(name, kernel, X)]: every zoo kernel beyond the stationary families,
    the coregionalization and the state-space legs' kernels, each on ``n``
    rows of its own input layout (index columns, time windows, 1-D times)."""
    from . import kernels as zk

    where = placement(dtype, device)
    rng = np.random.default_rng(seed)

    def idx(k):
        return rng.integers(0, k, n).astype(float)

    normal2 = rng.standard_normal((n, 2))
    times = np.sort(rng.uniform(0.0, 3.0, n))
    lfm_X = np.column_stack([times, idx(4)])
    cases = [
        ("TruncLinear", zk.TruncLinear.create(2, variances=[0.7, 1.2], delta=[0.1, -0.2],
                                              ARD=True, **where), normal2),
        ("TruncLinearInf", zk.TruncLinearInf.create(2, interval=(-1.0, 2.0), ARD=True,
                                                    **where), normal2),
        ("Hierarchical", zk.Hierarchical.create([RBF.create(1, **where),
                                                 RBF.create(1, variance=0.5, **where)]),
         np.column_stack([rng.standard_normal(n), idx(5)])),
        ("Symmetric", zk.Symmetric.create(RBF.create(1, **where), -np.eye(1), "even"),
         rng.uniform(0.2, 2.0, (n, 1))),
        ("PolynomialBasisFunc", zk.PolynomialBasisFuncKernel.create(1, degree=2, **where),
         rng.standard_normal((n, 1))),
        ("LinearSlopeBasisFunc", zk.LinearSlopeBasisFuncKernel.create(
            1, start=[-1.0, 0.0], stop=[0.5, 1.5], ARD=True, **where),
         rng.standard_normal((n, 1))),
        ("ChangePointBasisFunc", zk.ChangePointBasisFuncKernel.create(1, changepoint=0.1,
                                                                      **where),
         rng.standard_normal((n, 1))),
        ("DomainKernel", zk.DomainKernel.create(1, start=-0.5, stop=0.7, **where),
         rng.standard_normal((n, 1))),
        ("LogisticBasisFunc", zk.LogisticBasisFuncKernel.create(1, centers=[-0.5, 0.5],
                                                                ARD=True, **where),
         rng.standard_normal((n, 1))),
        ("IndependentOutputs", zk.IndependentOutputs(RBF.create(1, lengthscale=0.7, **where),
                                                     output_dim=2),
         np.column_stack([rng.standard_normal(n), idx(2)])),
        ("SplitKern", zk.SplitKern.create(RBF.create(1, variance=1.5, lengthscale=0.8,
                                                     **where), [[0.3]]),
         np.column_stack([rng.standard_normal(n), idx(2)])),
        ("DEtime", zk.DEtime.create(RBF.create(1, **where), idx_p=4, Xp=[[1.0]]),
         np.column_stack([rng.uniform(0.0, 2.0, n), np.repeat([0.0, 1.0], [n // 2, n - n // 2])])),
        ("MultioutputKern", zk.MultioutputKern.create(
            [RBF.create(1, lengthscale=0.5, **where),
             Matern52.create(1, variance=2.0, lengthscale=1.5, **where)]),
         np.column_stack([rng.standard_normal(n), idx(2)])),
        ("PeriodicExponential", zk.PeriodicExponential.create(**where),
         rng.uniform(0.0, 2.0, (n, 1))),
        ("PeriodicMatern32", zk.PeriodicMatern32.create(**where), rng.uniform(0.0, 2.0, (n, 1))),
        ("PeriodicMatern52", zk.PeriodicMatern52.create(**where), rng.uniform(0.0, 2.0, (n, 1))),
        ("Integral", zk.Integral.create(variances=1.4, lengthscale=0.8, **where),
         rng.uniform(0.1, 2.0, (n, 1))),
        ("IntegralLimits", zk.IntegralLimits.create(variances=1.2, lengthscale=0.9, **where),
         np.column_stack([rng.uniform(1.0, 2.0, n), rng.uniform(0.0, 1.0, n)])),
        ("MultidimensionalIntegralLimits", zk.MultidimensionalIntegralLimits.create(
            4, variances=1.1, lengthscale=[0.8, 1.1], **where),
         np.column_stack([rng.uniform(1.0, 2.0, n), rng.uniform(0.0, 1.0, n),
                          rng.uniform(1.0, 2.0, n), rng.uniform(0.0, 1.0, n)])),
        ("ODE_UY", zk.ODE_UY.create(variance_U=1.2, variance_Y=0.9, lengthscale_U=0.7,
                                    lengthscale_Y=1.3, **where),
         np.column_stack([times, idx(2)])),
        ("ODE_UYC", zk.ODE_UYC.create(variance_U=1.2, variance_Y=0.9, lengthscale_U=0.7,
                                      lengthscale_Y=1.3, ubias=0.4, **where),
         np.column_stack([times, idx(2)])),
        ("ODE_t", zk.ODE_t.create(variance_Yt=1.4, lengthscale_Yt=0.8, ubias=0.3, **where),
         np.column_stack([times, idx(2)])),
        ("ODE_st", zk.ODE_st.create(a=0.6, b=1.1, c=0.8, **where),
         np.column_stack([times, rng.uniform(-1, 1, n), idx(2)])),
        ("EQ_ODE1", zk.EQ_ODE1.create(output_dim=2, rank=2, W=[[0.8, 0.3], [1.2, -0.5]],
                                      lengthscale=[0.8, 1.2], decay=[0.5, 1.5], **where),
         lfm_X),
        ("EQ_ODE2", zk.EQ_ODE2.create(output_dim=2, rank=2, W=[[0.9, 0.2], [1.1, -0.4]],
                                      lengthscale=[0.8, 1.3], C=[0.5, 3.0], B=[2.0, 1.0],
                                      **where), lfm_X),
        ("Symbolic", zk.SymbolicKernel.create(
            2, lambda x, z, p: p["variance"] * torch.exp(
                -0.5 * torch.sum((x - z) ** 2) / p["lengthscale"] ** 2),
            params={"variance": 1.3, "lengthscale": 0.8}, **where), normal2),
        ("MLP", MLP.create(2, **where), normal2),
        ("Poly", Poly.create(2, order=3, **where), normal2),
        ("Brownian", Brownian.create(**where), rng.uniform(0.1, 3.0, (n, 1))),
        ("Spline", Spline.create(**where), rng.uniform(0.1, 1.0, (n, 1))),
        ("LinearFull", LinearFull.create(3, 2, **where), rng.standard_normal((n, 3))),
        ("WhiteHeteroscedastic", WhiteHeteroscedastic.create(
            2, num_data=n, variance=np.linspace(0.1, 0.7, n), **where), normal2),
        ("Fixed", Fixed.create(2, fixed_K=np.exp(-np.abs(np.subtract.outer(times, times))),
                               variance=0.6, **where), normal2),
    ]
    return [(name, k, torch.as_tensor(X, **where)) for name, k, X in cases]


# ------------------------------------------------------------------ latent slice
# GPy dimensionality_reduction.py gplvm_oil_100 (Q, kernel) and bgplvm_oil (Q,
# num_inducing) on the oil data's 12 dimensions, N scaled to the bench's 4096
LATENT_N = N
LATENT_D = 12
GPLVM_Q = 6
BGPLVM_Q = 7
BGPLVM_M = 40
GPLVM_STEPS = 200   # the reference's max_iters is 500: a cut of depth
BGPLVM_STEPS = 100
HELD_OUT = 256


def simulate_sincos(N=40, D1=6, D2=5, D3=4, seed=0):
    """Three centred views driven by shared sin / cos latents plus private
    signals (GPy dimensionality_reduction.py _simulate_sincos:257)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, N)
    s1, s2, s3 = np.sin(t), np.cos(t), np.sin(2 * t)
    S1 = np.stack([s1, s2], 1) @ rng.standard_normal((2, D1))
    S2 = np.stack([s1, s3], 1) @ rng.standard_normal((2, D2))
    S3 = np.stack([s2], 1) @ rng.standard_normal((1, D3))
    Ys = [S + 0.05 * rng.standard_normal(S.shape) for S in (S1, S2, S3)]
    return [Y - Y.mean(0) for Y in Ys]


def oil_like(N=60, D=12, seed=1):
    """(centred Y, labels): an oil-flow stand-in, 3 classes in D dimensions."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, D)) * 2.0
    labels = rng.integers(0, 3, N)
    Y = centers[labels] + 0.3 * rng.standard_normal((N, D))
    return Y - Y.mean(0), labels


def latent_data(n: int = LATENT_N, held_out: int = HELD_OUT, d: int = LATENT_D, seed: int = 1):
    """(Y, labels, Y_new): ``n`` training rows of ``oil_like`` and ``held_out``
    more, the first of which has one unobserved (NaN) entry."""
    Y, labels = oil_like(N=n + held_out, D=d, seed=seed)
    Y_new = Y[n:].copy()
    Y_new[0, 3] = np.nan
    return Y[:n], labels[:n], Y_new


def gplvm_model(Y, q: int = GPLVM_Q, dtype=None, device=None) -> GPRegression:
    """The point GPLVM with RBF ARD + Bias on the latent, PCA start, noise 0.1."""
    from .models.gplvm import make_gplvm

    where = placement(dtype, device)
    return make_gplvm(Y, q, kernel=RBF.create(q, ARD=True, **where) + Bias.create(q, **where),
                      **where)


def gplvm_fit(model: GPRegression, steps: int = GPLVM_STEPS, priors=None):
    """``fit_gplvm``: one L-BFGS lane over the kernel, the noise and X."""
    from .models.gplvm import fit_gplvm

    return fit_gplvm(model, maxiter=steps, priors=priors)


def bgplvm_model(Y, q: int = BGPLVM_Q, m: int = BGPLVM_M, dtype=None, device=None):
    """The Bayesian GPLVM with an ARD RBF (``bgplvm_oil``)."""
    from .models.gplvm import BayesianGPLVM

    where = placement(dtype, device)
    return BayesianGPLVM.create(Y, q, num_inducing=m, kernel=RBF.create(q, ARD=True, **where),
                                **where)


def bgplvm_fit(model, steps: int = BGPLVM_STEPS):
    """The gallery's fit: the default packer (Y fixed, the rest free), one lane."""
    from .models.gplvm import minimize_one
    from .models.parameters import make_packer

    return minimize_one(make_packer(model), model, steps)


@dataclasses.dataclass(frozen=True)
class Classifiers:
    """A one-vs-all classifier's per-class models as one tree of leaves; its
    log marginal likelihood is their sum."""

    models: tuple = ()

    def log_marginal_likelihood(self):
        return sum(m.log_marginal_likelihood() for m in self.models)


@dataclasses.dataclass(frozen=True)
class LatentLeg:
    """One model of the latent slice's third leg: ``run()`` builds and fits it
    and returns ``(fitted, predictions)``; ``fitted`` is a tree of leaves with a
    ``log_marginal_likelihood``; ``reduced`` names the cuts from the
    reference's sizes."""

    name: str
    run: object
    reduced: str = ""


def latent_leg_data(n: int = 512, seed: int = 0) -> dict:
    """The third leg's inputs (numpy): ``Y`` the oil stand-in, ``views`` the
    three sin / cos views, ``x1`` / ``lv_Y`` 8 phase-shifted sines on 1-D inputs
    (LVMOGP), ``ibp_X`` / ``ibp_Y`` three outputs on stacked (time, output)
    rows (IBP-LFM), ``Xc`` / ``yc`` / ``cls`` a 2-D regression and its 3-class
    labels, ``off_X`` / ``off_Y`` three shifted clusters, ``g1`` / ``g2`` /
    ``grid_Y`` a 32 x 32 grid."""
    rng = np.random.default_rng(seed)
    d = {"Y": oil_like(N=n, D=LATENT_D, seed=seed + 1)[0], "views": simulate_sincos(N=n, seed=seed)}
    x1 = np.linspace(0.0, 5.0, n)[:, None]
    d["x1"] = x1
    d["lv_Y"] = np.concatenate([np.sin(x1 + p) + 0.05 * rng.standard_normal((n, 1))
                                for p in rng.uniform(0, 3, 8)], axis=1)
    t = np.linspace(0.0, 5.0, n // 3)
    d["ibp_X"] = np.concatenate([np.column_stack([t, np.full_like(t, k)]) for k in range(3)])
    d["ibp_Y"] = np.concatenate([np.sin((k + 1) * t) for k in range(3)])[:, None]
    Xc = rng.uniform(-2.0, 2.0, (n, 2))
    yc = np.sin(2 * Xc[:, 0]) * np.cos(Xc[:, 1]) + 0.1 * rng.standard_normal(n)
    d.update(Xc=Xc, yc=yc, cls=(yc > np.quantile(yc, 1 / 3)).astype(int)
             + (yc > np.quantile(yc, 2 / 3)))
    d["off_X"] = np.column_stack([x1[:, 0], np.arange(n) % 3])
    d["off_Y"] = np.sin(x1[:, 0] + 0.3 * (np.arange(n) % 3))
    d["g1"], d["g2"] = np.linspace(0, 1, 32)[:, None], np.linspace(0, 1, 32)[:, None]
    d["grid_Y"] = np.sin(3 * d["g1"]) @ np.cos(2 * d["g2"]).T + 0.05 * rng.standard_normal(
        (32, 32))
    return d


def latent_legs(n: int = 512, steps: int = 60, seed: int = 0, dtype=None, device=None):
    """[LatentLeg]: MRD on the three sin / cos views, the spike-and-slab
    GPLVM, LVMOGP, the SVI Bayesian GPLVM (minibatch Adam), the IBP latent
    force model and the ``zoo.py`` models on :func:`latent_leg_data`, each at
    ``n`` rows (the gallery's are 24-80) and at most ``steps`` optimizer steps
    (the gallery's 40-60)."""
    from .models import zoo
    from .models.bgplvm_svi import BGPLVM_SVI, fit_bgplvm_svi
    from .models.ibp_lfm import IBPLFM
    from .models.lvmogp import LVMOGP, fit_lvmogp
    from .models.mrd import MRD, fit_mrd
    from .models.ss_gplvm import SSGPLVM, fit_ssgplvm

    where = placement(dtype, device)
    d = latent_leg_data(n, seed)
    Y, views, x1, Xc, yc, cls = d["Y"], d["views"], d["x1"], d["Xc"], d["yc"], d["cls"]
    g1, g2 = d["g1"], d["g2"]
    stepped = f"{steps} steps"

    def mrd():
        m, _ = fit_mrd(MRD.create(views, 4, num_inducing=8, **where), maxiter=steps)
        return m, []

    def ssgplvm():
        m, _ = fit_ssgplvm(SSGPLVM.create(Y, 3, num_inducing=8, **where), maxiter=steps)
        return m, []

    def lvmogp():
        m, _ = fit_lvmogp(LVMOGP.create(x1, d["lv_Y"], 2, num_inducing=(10, 5), **where),
                          maxiter=steps)
        return m, [m.predict(np.linspace(-0.5, 5.5, 64)[:, None])]

    def svi():
        # the reference leaves q_S unconstrained: at batch 64 Adam drives an entry
        # negative after ~118 steps, in float64 as in float32
        m, _ = fit_bgplvm_svi(BGPLVM_SVI.create(views[0], 3, num_inducing=8, **where),
                              steps=steps, batch=min(64, n))
        return m, []

    def ibp():
        m, _ = IBPLFM.create(d["ibp_X"], d["ibp_Y"], output_dim=3, rank=2, num_inducing=10,
                             **where).optimize(maxiter=steps // 2)
        return m, [m.predict(d["ibp_X"][::7])]

    def hetero():
        m = zoo.GPHeteroscedasticRegression(Xc, yc[:, None], noise_vars=np.full(n, 0.05),
                                            **where)
        m, _ = fit_module.fit(m, num_restarts=1, maxiter=steps)
        return m, [m.predict(torch.as_tensor(Xc[:64], **where), noise_at_test="mean")]

    def kron():
        m = zoo.GPKroneckerGaussianRegression(g1, g2, d["grid_Y"], RBF.create(1, **where),
                                              RBF.create(1, **where), noise_var=0.1, **where)
        m, _ = fit_module.fit(m, num_restarts=1, maxiter=steps, fix=("axes",))
        return m, [m.predict(np.column_stack([g1[:, 0], g2[::-1, 0]]))]

    def vargauss():
        m = zoo.GPVariationalGaussianApproximation.create(Xc[:256], yc[:256], **where)
        return m, [m.predict_latent(Xc[:64])]

    def one_vs_all():
        m = zoo.OneVsAllClassification(Xc[:256], cls[:256], **where)
        return Classifiers(tuple(m.models.values())), [
            torch.as_tensor(m.predict_proba(Xc[:64]))]

    def one_vs_all_sparse():
        m = zoo.OneVsAllSparseClassification(Xc, cls, num_inducing=32, **where)
        return Classifiers(tuple(m.models.values())), [
            torch.as_tensor(m.predict_proba(Xc[:64]))]

    def bcgplvm():
        m, _, _ = zoo.fit_bcgplvm(Y, 2, maxiter=steps, **where)
        return m, [m.predict(m.X[:16])]

    def sparse_gplvm():
        m, _ = zoo.fit_sparse_gplvm(Y, 2, num_inducing=16, maxiter=steps, **where)
        return m, [m.predict(m.X[:16])]

    def offset():
        m, _ = zoo.GPOffsetRegression.create(d["off_X"], d["off_Y"], **where).optimize(
            maxiter=steps)
        return m, [m.predict(x1[:16], cluster=1)]

    return [LatentLeg("MRD", mrd, stepped), LatentLeg("SSGPLVM", ssgplvm, stepped),
            LatentLeg("LVMOGP", lvmogp, stepped),
            LatentLeg("BGPLVM_SVI", svi, f"{steps} Adam steps at batch 64"),
            LatentLeg("IBPLFM", ibp, f"{steps // 2} Adam steps (EQ_ODE2's complex64 K)"),
            LatentLeg("GPHeteroscedasticRegression", hetero, stepped),
            LatentLeg("GPKroneckerGaussianRegression", kron, f"32 x 32 grid, {stepped}"),
            LatentLeg("GPVariationalGaussianApproximation", vargauss, "N = 256"),
            LatentLeg("OneVsAllClassification", one_vs_all, "N = 256"),
            LatentLeg("OneVsAllSparseClassification", one_vs_all_sparse, "M = 32"),
            LatentLeg("bcgplvm", bcgplvm, stepped), LatentLeg("sparse_gplvm", sparse_gplvm,
                                                              stepped),
            LatentLeg("GPOffsetRegression", offset, stepped)]


def cluster_data(series: int = 40, points: int = 20, seed: int = 0):
    """``series`` series of ``points`` times in four shape families (two
    sinusoids, two ramps, as examples/latent_plots_and_clustering.py), each
    shifted in time by U(-0.3, 0.3), noise 0.1; returns (data, inputs, family
    of each series) in ``utils/cluster.cluster``'s layout."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 3.0, points)[:, None]
    families = (lambda s: np.sin(2.0 * s), lambda s: 1.5 * np.cos(3.0 * s),
                lambda s: 2.0 - 2.0 * s, lambda s: -1.0 + 1.0 * s)
    data, inputs, fam = [], [], []
    for i in range(series):
        f = i % len(families)
        d = rng.uniform(-0.3, 0.3)
        data.append(families[f](t - d).T + 0.1 * rng.standard_normal((1, points)))
        inputs.append(t.copy())
        fam.append(f)
    return data, inputs, fam
