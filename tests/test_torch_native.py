"""The port's native design engine (utils/native.py, csrc/gpo_native.cpp)
against the JAX package's, each built from its own source: bitwise-equal
outputs, equal designs through ``initial_design`` with both engines on, and
the ports of tests/test_native.py's property tests."""
import numpy as np
import pytest
from scipy.stats import qmc

from gaussian_process_optimization_tpu.bo import designs as jdesigns
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.utils import native as jnative
from gaussian_process_optimization_tpu_torch.bo import designs as tdesigns
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace as TSpace
from gaussian_process_optimization_tpu_torch.utils import native
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not (native.available() and jnative.available()),
                                reason="no C++ compiler: neither engine builds")

CASES = [(8, 4, 0), (25, 3, 123), (15, 2, 2**61 + 7), (40, 6, 99)]


@pytest.mark.parametrize("n,d,seed", CASES)
def test_engines_are_bitwise_equal(n, d, seed):
    a, b = native.maximin_lhs(n, d, 30, seed), jnative.maximin_lhs(n, d, 30, seed)
    assert a.tobytes() == b.tobytes()
    assert native.min_pairwise_dist(a) == jnative.min_pairwise_dist(a)
    levels = [2, 3, 5, 4, 3, 2][:d]
    (ha, oka), (hb, okb) = (native.discrete_lhs(n, levels, 30, 10, 0.8, seed),
                            jnative.discrete_lhs(n, levels, 30, 10, 0.8, seed))
    assert ha.tobytes() == hb.tobytes() and oka == okb
    assert native.sobol_points(n, d).tobytes() == jnative.sobol_points(n, d).tobytes()


def test_sobol_past_sixteen_dimensions_is_refused_by_both():
    assert native.sobol_points(8, 17) is None and jnative.sobol_points(8, 17) is None


DOMAIN = [
    {"name": "x0", "type": "continuous", "domain": (-2.0, 3.0)},
    {"name": "x1", "type": "continuous", "domain": (0.0, 1.0)},
    {"name": "d0", "type": "discrete", "domain": (0, 1, 2)},
    {"name": "d1", "type": "discrete", "domain": (1, 5, 10, 20)},
    {"name": "c", "type": "categorical", "domain": (0, 1, 2)},
]


@pytest.mark.parametrize("design", ["latin_mixed", "latin", "sobol"])
@pytest.mark.parametrize("n,seed", [(7, 0), (20, 3)])
def test_initial_design_is_the_references_with_the_engine_on(design, n, seed):
    want = jdesigns.initial_design(design, JSpace(DOMAIN), n, seed=seed)
    got = tdesigns.initial_design(design, TSpace(DOMAIN), n, seed=seed)
    np.testing.assert_array_equal(got, want)


def test_latin_mixed_takes_the_engine(monkeypatch):
    """With the engine off, the numpy branch gives other points for the same
    seed: the engine is what the default run takes."""
    space = TSpace(DOMAIN[:3])
    on = tdesigns.latin_mixed_design(space, 12, seed=1)
    monkeypatch.setattr(native, "available", lambda: False)
    off = tdesigns.latin_mixed_design(space, 12, seed=1)
    assert on.shape == off.shape and not np.array_equal(on, off)


def test_no_native_switch_is_honoured(monkeypatch):
    monkeypatch.setenv("GPO_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert not native.available()
    with pytest.raises(RuntimeError, match="native engine unavailable"):
        native.maximin_lhs(4, 2, 1, 0)


def test_the_build_is_keyed_by_its_source():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("libgpo_native_") and path.suffix == ".so"


def test_the_cuda_build_leaves_the_engine_source_out():
    """The CUDA kernels' nvcc build (and its source hash) takes csrc/*.cu and
    *.cuh only, not the engine's C++ source beside them."""
    from gaussian_process_optimization_tpu_torch.ops import _build

    assert native.SOURCE.parent == _build.SRC_DIR
    assert native.SOURCE not in _build._sources()


# ---------------------------------------- tests/test_native.py's properties
def test_maximin_lhs_properties():
    X = native.maximin_lhs(25, 3, 30, 123)
    assert X.shape == (25, 3)
    assert X.min() >= 0 and X.max() <= 1
    for j in range(3):
        strata = np.floor(X[:, j] * 25).astype(int)
        assert len(set(strata.tolist())) == 25  # one point per stratum
    # maximin beats a single random LHS on average
    X1 = native.maximin_lhs(25, 3, 1, 7)
    assert native.min_pairwise_dist(X) >= native.min_pairwise_dist(X1) * 0.8


def test_min_pairwise_dist_is_the_brute_force_minimum():
    X = np.random.default_rng(0).uniform(size=(30, 4))
    D = np.linalg.norm(X[:, None] - X[None], axis=-1) + np.eye(30) * 1e9
    np.testing.assert_allclose(native.min_pairwise_dist(X), D.min(), rtol=1e-15)


def test_discrete_lhs_representation():
    n = 20
    H, ok = native.discrete_lhs(n, [4, 3], 30, 10, 0.8, 99)
    assert ok
    for j, L in enumerate([4, 3]):
        lv = np.floor(H[:, j] * L).astype(int)
        counts = np.bincount(lv, minlength=L)
        assert counts.min() >= max(np.floor(0.8 * n / L), 1)


def test_sobol_equidistribution_and_scipy():
    S = native.sobol_points(256, 8)
    assert S.shape == (256, 8)
    for j in range(8):
        counts = np.bincount(np.floor(S[:, j] * 16).astype(int), minlength=16)
        assert np.all(counts == 16)
    np.testing.assert_array_equal(S, qmc.Sobol(8, scramble=False).random(256))


def test_designs_native_vs_fallback(monkeypatch):
    """The designs layer satisfies the same contracts with the engine off."""
    space = TSpace([
        {"name": "xc", "type": "continuous", "domain": (0.0, 2.0)},
        {"name": "xd", "type": "discrete", "domain": (0, 1, 2)},
    ])
    X_native = tdesigns.latin_mixed_design(space, 15, seed=3)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert not native.available()
    X_py = tdesigns.latin_mixed_design(space, 15, seed=3)
    for X in (X_native, X_py):
        assert X.shape == (15, 2)
        assert set(np.unique(X[:, 1])).issubset({0.0, 1.0, 2.0})
        counts = np.bincount(X[:, 1].astype(int), minlength=3)
        assert counts.min() >= np.floor(0.8 * 15 / 3)
