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
from gaussian_process_optimization_tpu_torch.bo.cost import CostModel
from gaussian_process_optimization_tpu_torch.bo.evaluators import Sequential
from gaussian_process_optimization_tpu_torch.bo.optimizer import AcquisitionOptimizer
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.config import resolve_device, resolve_dtype
from gaussian_process_optimization_tpu_torch.kernels.stationary import Matern52, RatQuad, Sinc
from gaussian_process_optimization_tpu_torch.models import mean_functions
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.mcmc_bo_model import GPModel_MCMC
from gaussian_process_optimization_tpu_torch.models.sparse import SparseGPRegression
from gaussian_process_optimization_tpu_torch.models.sparse_bo_model import SparseGPModel
from gaussian_process_optimization_tpu_torch.models.warped import (InputWarpedGP, TanhWarp,
                                                                   WarpedGP)
from gaussian_process_optimization_tpu_torch.models.warped_bo_model import (InputWarpedGPModel,
                                                                            WarpedGPModel)


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
}


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
