"""The torch port's random forest (``models/rf_model.py``, the port's own copy of
the JAX package's numpy forest) against the JAX package: the trees, the
predictions and fmin bitwise equal for the same seed, and EI over the forest
through the host acquisition path, the suggestion equal to the reference's."""
import numpy as np
import pytest

from gaussian_process_optimization_tpu.bo import objectives
from gaussian_process_optimization_tpu.bo.methods import BayesianOptimization as JBO
from gaussian_process_optimization_tpu.models import rf_model as jrf
from gaussian_process_optimization_tpu.utils import native
from gaussian_process_optimization_tpu_torch.utils import native as tnative
from gaussian_process_optimization_tpu_torch.bo import BayesianOptimization
from gaussian_process_optimization_tpu_torch.models import rf_model as trf
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def numpy_branch(monkeypatch):
    """Hold both packages' designs to their numpy branch (the native engines
    are held to each other in tests/test_torch_native.py)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


@pytest.mark.parametrize("seed,depth", [(0, 8), (3, 12)])
def test_forest_is_bitwise_the_reference(seed, depth):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(80, 2))
    Y = (X[:, 0] ** 2 + np.sin(X[:, 1]))[:, None]
    theirs = jrf.RFModel(n_estimators=20, max_depth=depth, seed=seed)
    ours = trf.RFModel(n_estimators=20, max_depth=depth, seed=seed)
    theirs.updateModel(X, Y)
    ours.updateModel(X, Y)
    for a, b in zip(ours.model.trees, theirs.model.trees):
        for field in ("feature", "threshold", "left", "right", "value"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    Xs = rng.uniform(-2.5, 2.5, size=(30, 2))
    for a, b in zip(ours.predict(Xs), theirs.predict(Xs)):
        np.testing.assert_array_equal(a, b)
    assert ours.get_fmin() == theirs.get_fmin()
    # (test_models_extra.py::test_rf_model) the forest fits its data
    mu, s = ours.predict(X[:10])
    assert np.mean((mu[:, 0] - Y[:10, 0]) ** 2) < 0.5 and np.all(s >= 0)


def test_rf_has_no_gradients():
    with pytest.raises(NotImplementedError):
        trf.RFModel().predict_withGradients(np.zeros((1, 1)))


@pytest.mark.parametrize("acquisition", ["EI", "LCB"])
def test_bo_over_the_forest_matches_jax(acquisition):
    """(test_models_extra.py::test_bo_with_rf_and_sparse) ask-tell: the host
    acquisition path (no tensor state), the same suggestion as the reference."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(25, 1))
    Y = np.asarray(objectives.forrester(X))
    kw = dict(f=None, domain=[{"name": "x", "type": "continuous", "domain": (0.0, 1.0)}],
              X=X, Y=Y, model_type="RF", acquisition_type=acquisition,
              anchor_points_samples=100)
    ours = BayesianOptimization(**kw, device="cpu")
    assert not ours.acquisition.supports_device
    x = ours.suggest_next_locations()
    assert x.shape == (1, 1) and 0 <= x[0, 0] <= 1
    np.testing.assert_allclose(x, JBO(**kw).suggest_next_locations(), rtol=1e-12)
