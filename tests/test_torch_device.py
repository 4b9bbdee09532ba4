"""The torch port's entry points build on the card unless the caller names
another device: with no CUDA device a bare call raises, before it builds
anything, and never falls back to the CPU; ``device="cpu"`` builds there."""
import pytest
import torch

from gaussian_process_optimization_tpu_torch import convert, workload
from gaussian_process_optimization_tpu_torch.config import resolve_device
from gaussian_process_optimization_tpu_torch.kernels.stationary import Matern52, RatQuad
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression


def _data():
    return workload.thesis_data(n=12)


def _leaves():
    X, Y = _data()
    return convert.leaves_of(workload.make_model(X, Y, device="cpu"))


# name -> a call of the entry point; ``**kw`` carries the device, if any
ENTRY_POINTS = {
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
