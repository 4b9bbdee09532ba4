"""The torch port's host-side pieces against the JAX package's, exactly: the
six experiment designs (both packages pinned to their numpy branch; the
native engines are tested in test_torch_native.py), the 16 test functions with their bounds and minima, the anchor
point generators, and the DIRECT and CMA-ES optimizers."""
import numpy as np
import pytest

from gaussian_process_optimization_tpu.bo import anchor_points as janchor
from gaussian_process_optimization_tpu.bo import designs as jdesigns
from gaussian_process_optimization_tpu.bo import objectives as jobjectives
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.ops.cmaes import cma_minimize as jcma
from gaussian_process_optimization_tpu.ops.direct import direct_minimize as jdirect
from gaussian_process_optimization_tpu.utils import native
from gaussian_process_optimization_tpu_torch.utils import native as tnative
from gaussian_process_optimization_tpu_torch.bo import anchor_points as tanchor
from gaussian_process_optimization_tpu_torch.bo import designs as tdesigns
from gaussian_process_optimization_tpu_torch.bo import objectives as tobjectives
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.bo.variables import InvalidConfigError
from gaussian_process_optimization_tpu_torch.ops.cmaes import cma_minimize
from gaussian_process_optimization_tpu_torch.ops.direct import direct_minimize
from torch_threads import one_torch_thread  # noqa: F401

SPACES = {
    "continuous": [{"name": "a", "type": "continuous", "domain": (-5.0, 10.0)},
                   {"name": "b", "type": "continuous", "domain": (1.0, 15.0)},
                   {"name": "c", "type": "continuous", "domain": (0.0, 1.0)}],
    "mixed": [{"name": "a", "type": "continuous", "domain": (-2.0, 2.0)},
              {"name": "d", "type": "discrete", "domain": (0, 1, 2, 3)},
              {"name": "b", "type": "continuous", "domain": (0.0, 4.0)},
              {"name": "k", "type": "categorical", "domain": (0, 1, 2)},
              {"name": "e", "type": "discrete", "domain": (10, 20, 30)}],
}
DESIGNS = ["random", "latin", "latin_mixed", "sobol", "grid", "hammersley"]


@pytest.fixture
def numpy_branch(monkeypatch):
    """Both packages' designs take their native engine when it is built; here
    both are held to their numpy branch (the engines are held to each other in
    tests/test_torch_native.py)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


@pytest.mark.parametrize("space", list(SPACES))
@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("n,seed", [(5, 0), (12, 7)])
def test_design_equals_jax(design, space, n, seed, numpy_branch):
    ours = tdesigns.initial_design(design, DesignSpace(SPACES[space]), n, seed=seed)
    theirs = jdesigns.initial_design(design, JSpace(SPACES[space]), n, seed=seed)
    assert ours.shape == theirs.shape and ours.shape[1] == len(SPACES[space])
    np.testing.assert_array_equal(ours, theirs)


def test_a_generator_is_taken_as_the_seed(numpy_branch):
    ours = tdesigns.latin_design(DesignSpace(SPACES["mixed"]), 6, seed=np.random.default_rng(4))
    theirs = jdesigns.latin_design(JSpace(SPACES["mixed"]), 6, seed=np.random.default_rng(4))
    np.testing.assert_array_equal(ours, theirs)


def test_sobol_points_are_the_unscrambled_sequence():
    unit = tdesigns._sobol_unit(4, 2)
    np.testing.assert_array_equal(unit, [[0.0, 0.0], [0.5, 0.5], [0.75, 0.25], [0.25, 0.75]])


def test_constrained_random_design_equals_jax(numpy_branch):
    cons = [{"name": "c", "constraint": "x[:, 0] + x[:, 1] - 8.0"}]
    ours = tdesigns.initial_design("random", DesignSpace(SPACES["continuous"], cons), 9, seed=2)
    theirs = jdesigns.initial_design("random", JSpace(SPACES["continuous"], cons), 9, seed=2)
    np.testing.assert_array_equal(ours, theirs)
    assert np.all(ours[:, 0] + ours[:, 1] <= 8.0)


@pytest.mark.parametrize("design", ["latin", "latin_mixed", "sobol", "grid"])
def test_designs_refuse_constraints(design):
    cons = [{"name": "c", "constraint": "x[:, 0] - 1.0"}]
    with pytest.raises(InvalidConfigError, match="constraints"):
        tdesigns.initial_design(design, DesignSpace(SPACES["continuous"], cons), 5)


def test_unknown_design_raises():
    with pytest.raises(ValueError, match="Unknown design"):
        tdesigns.initial_design("halton", DesignSpace(SPACES["continuous"]), 5)


OBJECTIVES = ["forrester", "branin", "rosenbrock", "sixhumpcamel", "mccormick", "goldstein",
              "eggholder", "alpine1", "ackley", "gSobol", "beale", "dropwave", "cosines",
              "powers", "alpine2", "hartmann6"]


@pytest.mark.parametrize("name", OBJECTIVES)
def test_objective_matches_jax(name, rng):
    """Values at 20 points of the function's own domain, 1e-12, and the same
    ``bounds`` and ``fmin`` where the function carries them."""
    ours, theirs = getattr(tobjectives, name), getattr(jobjectives, name)
    bounds = getattr(theirs, "bounds", None) or [(0.0, 1.0)] * (6 if name == "hartmann6"
                                                               else 3)
    lo, hi = np.array(bounds).T
    x = lo + rng.uniform(size=(20, len(bounds))) * (hi - lo)
    got = ours(x)
    assert isinstance(got, np.ndarray) and got.shape == (20, 1)
    np.testing.assert_allclose(got, np.asarray(theirs(x)), rtol=1e-12, atol=1e-12)
    for attr in ("bounds", "fmin"):
        assert getattr(ours, attr, None) == getattr(theirs, attr, None)


def test_the_objectives_module_has_the_reference_functions():
    public = lambda mod: {n for n, v in vars(mod).items()  # noqa: E731
                          if callable(v) and not n.startswith("_")}
    assert public(tobjectives) == public(jobjectives) == set(OBJECTIVES)


class _Surrogate:
    """predict() of a fixed smooth mean and std, for the Thompson generator."""

    def predict(self, X):
        X = np.atleast_2d(X)
        return np.sin(X[:, :1]) + X[:, 1:2] ** 2, 0.1 + 0.05 * np.abs(X[:, 2:3])


@pytest.mark.parametrize("kind", ["objective", "thompson", "random"])
def test_anchor_points_equal_jax(kind, numpy_branch):
    tspace, jspace = DesignSpace(SPACES["mixed"]), JSpace(SPACES["mixed"])

    def score(X):
        return np.sum((X - 0.3) ** 2, axis=1)

    if kind == "objective":
        ours = tanchor.ObjectiveAnchorPointsGenerator(tspace, "latin", score, num_samples=60)
        theirs = janchor.ObjectiveAnchorPointsGenerator(jspace, "latin", score, num_samples=60)
    elif kind == "thompson":
        ours = tanchor.ThompsonSamplingAnchorPointsGenerator(tspace, "sobol", _Surrogate(),
                                                             num_samples=60, seed=3)
        theirs = janchor.ThompsonSamplingAnchorPointsGenerator(jspace, "sobol", _Surrogate(),
                                                               num_samples=60, seed=3)
    else:
        ours = tanchor.RandomAnchorPointsGenerator(tspace, num_samples=60)
        theirs = janchor.RandomAnchorPointsGenerator(jspace, num_samples=60)
    a, b = ours.get(num_anchor=7, seed=11), theirs.get(num_anchor=7, seed=11)
    assert a.shape == (7, tspace.model_dimensionality)
    np.testing.assert_array_equal(a, b)


def _bowl(X):
    X = np.atleast_2d(X)
    return np.sum((X - np.array([0.3, -0.6])) ** 2, axis=1) + 0.1 * np.sin(5 * X[:, 0])


@pytest.mark.parametrize("name", ["DIRECT", "CMA"])
def test_global_optimizers_equal_jax(name):
    lo, hi = np.array([-2.0, -2.0]), np.array([2.0, 2.0])
    if name == "DIRECT":
        ours, theirs = direct_minimize(_bowl, lo, hi, max_evals=200), jdirect(
            _bowl, lo, hi, max_evals=200)
    else:
        x0 = np.array([1.0, 1.0])
        ours, theirs = cma_minimize(_bowl, x0, lo, hi, max_evals=300), jcma(
            _bowl, x0, lo, hi, max_evals=300)
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert float(ours[1]) == float(theirs[1]) < 0.09  # the bowl's minimum is 0.0871
