"""The torch port's entry points build on the card unless the caller names
another device: with no CUDA device a bare call raises, before it builds
anything, and never falls back to the CPU; ``device="cpu"`` builds there."""
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
from gaussian_process_optimization_tpu_torch.config import resolve_device
from gaussian_process_optimization_tpu_torch.kernels.stationary import Matern52, RatQuad, Sinc
from gaussian_process_optimization_tpu_torch.models import mean_functions
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression


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
