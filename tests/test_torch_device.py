"""The torch port's entry points build on the card unless the caller names
another device: with no CUDA device a bare call raises, before it builds
anything, and never falls back to the CPU; ``device="cpu"`` builds there. The
dtype follows the device: float32 on the card, float64 on the CPU."""
import pytest
import torch

from gaussian_process_optimization_tpu_torch import convert, workload
from gaussian_process_optimization_tpu_torch.bo import (BayesianOptimization,
                                                        ModularBayesianOptimization)
from gaussian_process_optimization_tpu_torch.bo.acquisitions import AcquisitionEI
from gaussian_process_optimization_tpu_torch.bo.interface import BODriver
from gaussian_process_optimization_tpu_torch.bo.cost import CostModel
from gaussian_process_optimization_tpu_torch.bo.evaluators import Sequential
from gaussian_process_optimization_tpu_torch.bo.optimizer import AcquisitionOptimizer
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.config import resolve_device, resolve_dtype
from gaussian_process_optimization_tpu_torch import kernels as zoo
from gaussian_process_optimization_tpu_torch.kernels.stationary import Matern52, RatQuad, Sinc
from gaussian_process_optimization_tpu_torch.models import multioutput
from gaussian_process_optimization_tpu_torch.models.gp_grid import GPGridRegression
from gaussian_process_optimization_tpu_torch.models.state_space import StateSpaceGP, from_kernel
from gaussian_process_optimization_tpu_torch.models import mean_functions
from gaussian_process_optimization_tpu_torch.models import zoo as zoo_models
from gaussian_process_optimization_tpu_torch.models.bgplvm_svi import BGPLVM_SVI
from gaussian_process_optimization_tpu_torch.models.gplvm import BayesianGPLVM, make_gplvm
from gaussian_process_optimization_tpu_torch.models.ibp_lfm import IBPLFM
from gaussian_process_optimization_tpu_torch.models.lvmogp import LVMOGP, LVMOGP_MD
from gaussian_process_optimization_tpu_torch.models.mrd import MRD
from gaussian_process_optimization_tpu_torch.models.ss_gplvm import SSGPLVM, SSMRD
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from gaussian_process_optimization_tpu_torch.models.classification import (
    GPClassification, SparseGPClassification, SparseGPClassificationUncertainInput)
from gaussian_process_optimization_tpu_torch.models.laplace import GPLaplace
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.mcmc_bo_model import GPModel_MCMC
from gaussian_process_optimization_tpu_torch.models.sparse import SparseGPRegression
from gaussian_process_optimization_tpu_torch.models.sparse_bo_model import SparseGPModel
from gaussian_process_optimization_tpu_torch.models.svgp import SVGP
from gaussian_process_optimization_tpu_torch.models.tp import TPRegression
from gaussian_process_optimization_tpu_torch.models.warped import (InputWarpedGP, TanhWarp,
                                                                   WarpedGP)
from gaussian_process_optimization_tpu_torch.models.warped_bo_model import (InputWarpedGPModel,
                                                                            WarpedGPModel)
from gaussian_process_optimization_tpu_torch.parallel import sharded
from gaussian_process_optimization_tpu_torch.utils import cluster
from torch_threads import one_torch_thread  # noqa: F401


def _data():
    return workload.thesis_data(n=12)


def _leaves():
    X, Y = _data()
    return convert.leaves_of(workload.make_model(X, Y, device="cpu"))


def _modular(**kw):
    """The modular API builds on its surrogate's device."""
    space = DesignSpace(workload.THESIS_DOMAIN)
    model = GPModel(max_iters=0, **kw)
    acq = AcquisitionEI(model, space, AcquisitionOptimizer(space))
    X, Y = _data()
    return ModularBayesianOptimization(model, space, None, acq, Sequential(acq), X, Y)


def _timed_bo(**kw):
    """The one-stop API with an 'evaluation_time' cost: a second surrogate."""
    X, Y = _data()
    return BayesianOptimization(f=None, domain=workload.THESIS_DOMAIN, X=X, Y=Y,
                                cost_withGradients="evaluation_time", max_iters=0, **kw)


# name -> a call of the entry point; ``**kw`` carries the device, if any
ENTRY_POINTS = {
    "regret_run": lambda **kw: workload.regret_run(
        "forrester", 0, iters=0, max_iters=0, **kw).bo.model.device,
    "composite_bo": lambda **kw: workload.composite_bo(
        *workload.bench_data(n=12), steps=0, **kw).model.device,
    "CostModel": lambda **kw: CostModel("evaluation_time", **kw).cost_model.device,
    "BayesianOptimization.cost": lambda **kw: _timed_bo(**kw).cost.cost_model.device,
    "ModularBayesianOptimization": lambda **kw: _modular(**kw).model.device,
    "Sinc.create": lambda **kw: Sinc.create(3, **kw).variance.device,
    "Constant.create": lambda **kw: mean_functions.Constant.create(3, **kw).C.device,
    "LinearMapping.create": lambda **kw: mean_functions.LinearMapping.create(3, **kw).A.device,
    "MLPMapping.create": lambda **kw: mean_functions.MLPMapping.create(3, **kw).W1.device,
    "KernelMapping.create": lambda **kw: mean_functions.KernelMapping.create(
        3, 1, [[0.0, 0.0, 0.0]], **kw).kern.variance.device,
    "PiecewiseLinear.create": lambda **kw: mean_functions.PiecewiseLinear.create(
        [0.0, 1.0], [0.0, 1.0], **kw).values.device,
    "make_model": lambda **kw: workload.make_model(*_data(), **kw).X.device,
    "thesis_bo": lambda **kw: workload.thesis_bo(*_data(), steps=0, **kw).model.device,
    "GPRegression.create": lambda **kw: GPRegression.create(*_data(), **kw).X.device,
    "Matern52.create": lambda **kw: Matern52.create(6, ARD=True, **kw).lengthscale.device,
    "RatQuad.create": lambda **kw: RatQuad.create(6, **kw).variance.device,
    "GPModel": lambda **kw: GPModel(**kw).device,
    "gp_from_leaves": lambda **kw: convert.gp_from_leaves(_leaves(), **kw).X.device,
    "GPModel_MCMC": lambda **kw: GPModel_MCMC(**kw).device,
    "SparseGPModel": lambda **kw: SparseGPModel(**kw).device,
    "WarpedGPModel": lambda **kw: WarpedGPModel(**kw).device,
    "InputWarpedGPModel": lambda **kw: InputWarpedGPModel(None, **kw).device,
    "SparseGPRegression.create": lambda **kw: SparseGPRegression.create(
        *_data(), num_inducing=4, **kw).Z.device,
    "WarpedGP.create": lambda **kw: WarpedGP.create(*_data(), **kw).warp.a.device,
    "InputWarpedGP.create": lambda **kw: InputWarpedGP.create(*_data(), **kw).warp.lo.device,
    "TanhWarp.create": lambda **kw: TanhWarp.create(**kw).d.device,
    "mcmc_from_samples": lambda **kw: convert.mcmc_from_samples(
        _leaves(), [[0.5] * 7], family="matern52", exact_feval=True, **kw).samples.X.device,
    "SVGP.create": lambda **kw: SVGP.create(*_data(), num_inducing=4, **kw).Z.device,
    "GPLaplace.create": lambda **kw: GPLaplace.create(*_data(), **kw).X.device,
    "GPClassification.create": lambda **kw: GPClassification.create(*_data(), **kw).Y.device,
    "SparseGPClassification.create": lambda **kw: SparseGPClassification.create(
        *_data(), num_inducing=4, **kw).Z.device,
    "SparseGPClassificationUncertainInput.create":
        lambda **kw: SparseGPClassificationUncertainInput.create(
            _data()[0], 0.01, _data()[1], num_inducing=4, **kw).X_variance.device,
    "TPRegression.create": lambda **kw: TPRegression.create(*_data(), **kw).deg_free.device,
    "BODriver": lambda **kw: BODriver({}, None, **kw).device,
}


def _first(kern):
    return kern._leaf_like().device


def _tasks():
    X, Y = _data()
    return [X[:6], X[6:]], [Y[:6], Y[6:]]


def _grid_leaves():
    return {"kerns.0.variance": 1.0, "kerns.0.lengthscale": 0.5, "likelihood_variance": 0.1,
            "axes.0": [[0.0], [0.5], [1.0]], "Y": [0.1, 0.2, 0.3]}


def _ss_leaves():
    return {"variance": 1.0, "lengthscale": 0.5, "noise_variance": 0.1, "period": 1.0,
            "lengthscale_damp": 1.0, "X": [[0.0], [0.5], [1.0]], "Y": [[0.1], [0.2], [0.3]]}


# the zoo's constructors: name -> a build with ``**kw`` carrying the device, if any
ZOO_ENTRY_POINTS = {
    "White.create": lambda **kw: _first(zoo.White.create(2, **kw)),
    "Bias.create": lambda **kw: _first(zoo.Bias.create(2, **kw)),
    "WhiteHeteroscedastic.create": lambda **kw: _first(zoo.WhiteHeteroscedastic.create(
        2, num_data=4, **kw)),
    "Fixed.create": lambda **kw: _first(zoo.Fixed.create(2, fixed_K=[[1.0]], **kw)),
    "Linear.create": lambda **kw: _first(zoo.Linear.create(2, ARD=True, **kw)),
    "LinearFull.create": lambda **kw: _first(zoo.LinearFull.create(2, 1, **kw)),
    "StandardPeriodic.create": lambda **kw: _first(zoo.StandardPeriodic.create(1, **kw)),
    "MLP.create": lambda **kw: _first(zoo.MLP.create(2, **kw)),
    "Poly.create": lambda **kw: _first(zoo.Poly.create(2, **kw)),
    "Brownian.create": lambda **kw: _first(zoo.Brownian.create(**kw)),
    "Spline.create": lambda **kw: _first(zoo.Spline.create(**kw)),
    "Coregionalize.create": lambda **kw: _first(zoo.Coregionalize.create(1, 3, **kw)),
    "TruncLinear.create": lambda **kw: _first(zoo.TruncLinear.create(2, **kw)),
    "TruncLinearInf.create": lambda **kw: _first(zoo.TruncLinearInf.create(2, (0.0, 1.0),
                                                                          **kw)),
    "PolynomialBasisFuncKernel.create": lambda **kw: _first(
        zoo.PolynomialBasisFuncKernel.create(1, 2, **kw)),
    "LinearSlopeBasisFuncKernel.create": lambda **kw: _first(
        zoo.LinearSlopeBasisFuncKernel.create(1, 0.0, 1.0, **kw)),
    "ChangePointBasisFuncKernel.create": lambda **kw: _first(
        zoo.ChangePointBasisFuncKernel.create(1, 0.5, **kw)),
    "DomainKernel.create": lambda **kw: _first(zoo.DomainKernel.create(1, 0.0, 1.0, **kw)),
    "LogisticBasisFuncKernel.create": lambda **kw: _first(
        zoo.LogisticBasisFuncKernel.create(1, [0.0, 1.0], **kw)),
    "SplitKern.create": lambda **kw: _first(zoo.SplitKern.create(zoo.RBF.create(1, **kw),
                                                                 [[0.5]])),
    "PeriodicMatern32.create": lambda **kw: _first(zoo.PeriodicMatern32.create(**kw)),
    "Integral.create": lambda **kw: _first(zoo.Integral.create(**kw)),
    "IntegralLimits.create": lambda **kw: _first(zoo.IntegralLimits.create(**kw)),
    "MultidimensionalIntegralLimits.create": lambda **kw: _first(
        zoo.MultidimensionalIntegralLimits.create(4, **kw)),
    "ODE_UY.create": lambda **kw: _first(zoo.ODE_UY.create(**kw)),
    "ODE_UYC.create": lambda **kw: _first(zoo.ODE_UYC.create(**kw)),
    "ODE_t.create": lambda **kw: _first(zoo.ODE_t.create(**kw)),
    "ODE_st.create": lambda **kw: _first(zoo.ODE_st.create(**kw)),
    "EQ_ODE1.create": lambda **kw: _first(zoo.EQ_ODE1.create(2, 1, **kw)),
    "EQ_ODE2.create": lambda **kw: _first(zoo.EQ_ODE2.create(2, 1, **kw)),
    "SymbolicKernel.create": lambda **kw: _first(zoo.SymbolicKernel.create(
        1, lambda x, z, p: p["v"] * (x * z).sum(), params={"v": 1.0}, **kw)),
    "icm_kernel": lambda **kw: _first(multioutput.icm_kernel(2, 3, **kw)),
    "private_kernel": lambda **kw: _first(multioutput.private_kernel(2, 3, **kw)),
    "GPCoregionalizedRegression": lambda **kw: multioutput.GPCoregionalizedRegression(
        *_tasks(), **kw).model.X.device,
    "SparseGPCoregionalizedRegression": lambda **kw:
        multioutput.SparseGPCoregionalizedRegression(*_tasks(), num_inducing=2,
                                                     **kw).model.Z.device,
    "SparseGPRegressionMD": lambda **kw: multioutput.SparseGPRegressionMD(
        _data()[0], _data()[1][:, 0], [0, 1] * 6, num_inducing=3, **kw).model.Z.device,
    "GPGridRegression.create": lambda **kw: GPGridRegression.create(
        [[0.0, 1.0], [0.0, 1.0]], [[0.1, 0.2], [0.3, 0.4]],
        [zoo.RBF.create(1, device="cpu")] * 2, **kw).Y.device,
    "StateSpaceGP.create": lambda **kw: StateSpaceGP.create(
        [0.0, 0.5, 1.0], [0.1, 0.2, 0.3], **kw).X.device,
    "state_space.from_kernel": lambda **kw: from_kernel(
        zoo.Matern32.create(1, device="cpu"), [0.0, 0.5], [0.1, 0.2], **kw).X.device,
    "kernel_from_leaves": lambda **kw: convert.kernel_from_leaves(
        {"kern.variance": 1.0, "kern.period": 1.0, "kern.lengthscale": 1.0},
        {"class": "StandardPeriodic", "input_dim": 1}, **kw).period.device,
    "multioutput_from_leaves": lambda **kw: convert.multioutput_from_leaves(
        {"kern.parts.0.variance": 1.0, "kern.parts.0.lengthscale": 1.0,
         "kern.parts.1.W": [[0.5], [0.5]], "kern.parts.1.kappa": [0.5, 0.5],
         "likelihood_variance": 0.1, "X": [[0.0, 0.0], [1.0, 1.0]], "Y": [[0.1], [0.2]]},
        {"class": "Prod", "parts": [{"class": "RBF", "input_dim": 1, "active_dims": [0]},
                                    {"class": "Coregionalize", "input_dim": 1,
                                     "active_dims": [1]}]}, 2, **kw).model.X.device,
    "grid_from_leaves": lambda **kw: convert.grid_from_leaves(
        _grid_leaves(), [{"class": "RBF", "input_dim": 1}], **kw).Y.device,
    "state_space_from_leaves": lambda **kw: convert.state_space_from_leaves(
        _ss_leaves(), **kw).X.device,
}
ENTRY_POINTS.update(ZOO_ENTRY_POINTS)


def _oil():
    return workload.oil_like(N=12, D=4)[0]


def _bgplvm_leaves():
    return convert.leaves_of(BayesianGPLVM.create(_oil(), 2, num_inducing=3, device="cpu"))


# the latent slice's constructors and converters
LATENT_ENTRY_POINTS = {
    "make_gplvm": lambda **kw: make_gplvm(_oil(), 2, **kw).X.device,
    "gplvm_model": lambda **kw: workload.gplvm_model(_oil(), 2, **kw).X.device,
    "BayesianGPLVM.create": lambda **kw: BayesianGPLVM.create(_oil(), 2, num_inducing=3,
                                                              **kw).q_mu.device,
    "bgplvm_model": lambda **kw: workload.bgplvm_model(_oil(), 2, 3, **kw).Z.device,
    "MRD.create": lambda **kw: MRD.create([_oil(), _oil()[:, :2]], 2, num_inducing=3,
                                          **kw).q_mu.device,
    "SSGPLVM.create": lambda **kw: SSGPLVM.create(_oil(), 2, num_inducing=3, **kw).q_gamma.device,
    "SSMRD.create": lambda **kw: SSMRD.create([_oil(), _oil()], 2, num_inducing=3,
                                              **kw).q_gamma.device,
    "LVMOGP.create": lambda **kw: LVMOGP.create(_data()[0][:, :1], _oil()[:, :3], 1,
                                                num_inducing=(3, 2), **kw).qU_mean.device,
    "LVMOGP_MD.create": lambda **kw: LVMOGP_MD.create(_data()[0][:, :1], [0, 1] * 6,
                                                      _data()[1][:, 0], 2, 1,
                                                      num_inducing=(3, 2), **kw).out_idx.device,
    "BGPLVM_SVI.create": lambda **kw: BGPLVM_SVI.create(_oil(), 2, num_inducing=3,
                                                        **kw).qU_A.device,
    "IBPLFM.create": lambda **kw: IBPLFM.create([[0.0, 0.0], [1.0, 1.0]], [0.1, 0.2], 2, 1,
                                                num_inducing=2, **kw).tau.device,
    "GPHeteroscedasticRegression": lambda **kw: zoo_models.GPHeteroscedasticRegression(
        *_data(), **kw).X.device,
    "GPKroneckerGaussianRegression": lambda **kw: zoo_models.GPKroneckerGaussianRegression(
        [[0.0], [1.0]], [[0.0], [1.0]], [[0.1, 0.2], [0.3, 0.4]],
        zoo.RBF.create(1, device="cpu"), zoo.RBF.create(1, device="cpu"), **kw).Y.device,
    "GPVariationalGaussianApproximation.create":
        lambda **kw: zoo_models.GPVariationalGaussianApproximation.create(
            _data()[0], _data()[1][:, 0], **kw).X.device,
    "OneVsAllClassification": lambda **kw: next(iter(zoo_models.OneVsAllClassification(
        _data()[0], [0, 1, 2] * 4, **kw).models.values())).X.device,
    "OneVsAllSparseClassification": lambda **kw: next(iter(
        zoo_models.OneVsAllSparseClassification(_data()[0], [0, 1, 2] * 4, num_inducing=3,
                                                **kw).models.values())).Z.device,
    "fit_bcgplvm": lambda **kw: zoo_models.fit_bcgplvm(_oil(), 2, maxiter=0, **kw)[0].X.device,
    "fit_sparse_gplvm": lambda **kw: zoo_models.fit_sparse_gplvm(
        _oil(), 2, num_inducing=3, maxiter=0, **kw)[0].Z.device,
    "GPOffsetRegression.create": lambda **kw: zoo_models.GPOffsetRegression.create(
        [[0.0, 0.0], [1.0, 1.0]], [0.1, 0.2], **kw).offset.device,
    "latent_from_leaves": lambda **kw: convert.latent_from_leaves(
        "BayesianGPLVM", _bgplvm_leaves(), {"kern": {"class": "RBF", "input_dim": 2}},
        **kw).q_S.device,
}
ENTRY_POINTS.update(LATENT_ENTRY_POINTS)


def _series(fn, **kw):
    """A tiny clustering call; the device it ran on is the one asked for."""
    t = [[0.0], [1.0], [2.0]]
    fn([[[0.1, 0.5, 0.2]], [[0.0, 0.4, 0.3]]], [t, t], **kw)
    return torch.device(kw["device"])


# the multi-device layer: a mesh holds the devices its sharded functions run on
ENTRY_POINTS.update({
    "make_mesh": lambda **kw: sharded.make_mesh(2, **kw).shards()[0],
    "Mesh": lambda **kw: sharded.Mesh([kw["device"]] * 2 if kw else None).shards()[0],
    "cluster": lambda **kw: _series(lambda d, x, **k: cluster.cluster(d, x, maxiter=2, **k),
                                    **kw),
    "get_log_likelihood": lambda **kw: _series(
        lambda d, x, **k: cluster.get_log_likelihood(x, d, [0, 1], maxiter=2, **k), **kw),
    "get_log_likelihood_offset": lambda **kw: _series(
        lambda d, x, **k: cluster.get_log_likelihood_offset(x, d, [0, 1], maxiter=2, **k),
        **kw),
})


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_bare_call_raises_without_a_card(name, no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_cpu_when_asked(name):
    assert ENTRY_POINTS[name](device="cpu") == torch.device("cpu")


def test_resolve_device(monkeypatch):
    """None is the card when there is one; a named device is taken as given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


def test_dtype_follows_the_device():
    """float32 on a CUDA device (the JAX package's dtype on its accelerator,
    and the one the CUDA kernels take), float64 on the CPU; a named dtype
    wins."""
    assert resolve_dtype(None, "cuda") == torch.float32
    assert resolve_dtype(None, torch.device("cuda", 0)) == torch.float32
    assert resolve_dtype(None, "cpu") == torch.float64
    assert resolve_dtype(torch.float64, "cuda") == torch.float64
    assert resolve_dtype(torch.float32, "cpu") == torch.float32


@pytest.mark.parametrize("name", ["GPModel", "GPModel_MCMC", "SparseGPModel", "WarpedGPModel",
                                  "Matern52.create", "GPRegression.create", "make_model"])
def test_cpu_default_dtype_is_float64(name):
    """What the CPU parity tests rely on: a CPU build with no dtype is float64."""
    built = {
        "GPModel": lambda: GPModel(device="cpu").dtype,
        "GPModel_MCMC": lambda: GPModel_MCMC(device="cpu").dtype,
        "SparseGPModel": lambda: SparseGPModel(device="cpu").dtype,
        "WarpedGPModel": lambda: WarpedGPModel(device="cpu").dtype,
        "Matern52.create": lambda: Matern52.create(3, device="cpu").variance.dtype,
        "GPRegression.create": lambda: GPRegression.create(*_data(), device="cpu").X.dtype,
        "make_model": lambda: workload.make_model(*_data(), device="cpu").X.dtype,
    }[name]()
    assert built == torch.float64


@pytest.mark.parametrize("dtype,want", [(None, torch.float64), ("float32", torch.float32)])
def test_regret_runner_dtype_follows_the_device(monkeypatch, dtype, want):
    """The regret runner with no dtype runs the CPU in float64, as every entry
    point; a named dtype wins."""
    from gaussian_process_optimization_tpu_torch import regret

    seen = []
    real = workload.regret_run

    def spy(name, seed, **kw):
        seen.append(kw["dtype"])
        return real(name, seed, iters=0, max_iters=1, optimize_restarts=1, **kw)

    monkeypatch.setattr(workload, "regret_run", spy)
    regret.run(["forrester"], 1, device="cpu",
               dtype=None if dtype is None else getattr(torch, dtype), log=lambda *a, **k: None)
    assert seen == [want]
