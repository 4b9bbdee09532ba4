"""The port's public surface against the JAX package's: every name of every
``__all__``, the top-level lazy names and ``__version__``, every public class
and function each module defines, and every public attribute of those classes,
with the exclusions listed below (each with its reason), and every parameter
name of every public function and method both packages define. Then the values of
what the surface added: the ``DesignSpace`` queries, ``predictive_gradients``
of the warped GPs and ``get_d_moments`` through their BO wrappers, the
stationary kernels' ``dK_dr``, ``Integral.k_ff`` and ``Packer.map_constrained``,
held against the JAX package in float64."""
import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu as jpkg
import gaussian_process_optimization_tpu_torch as tpkg
from gaussian_process_optimization_tpu.bo import general as jgeneral
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.models import warped_bo_model as jwbo
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu_torch.bo import general as tgeneral
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace as TSpace
from gaussian_process_optimization_tpu_torch.models import warped_bo_model as twbo
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from torch_threads import one_torch_thread  # noqa: F401


REF, PORT = jpkg.__name__, tpkg.__name__

# reference modules with no twin module
MODULES_NOT_PORTED = {
    "ops.pallas_kernels": "the Pallas kernels B1 / B2: the port's are CUDA C++ "
                          "(csrc/stationary_k*.cu), bound in ops/cuda_kernels.py",
    "ops.pallas_linalg": "the Pallas kernels B3 / B4: the port's are CUDA C++ "
                         "(csrc/tri_inv.cu, csrc/chol_blocks.cu), bound in ops/cuda_linalg.py",
    "utils.pytree": "the JAX pytree registration: the port's is utils/tree.py",
}
# public names of reference modules (module.name or module.Class.attribute)
# with no twin
NAMES_NOT_PORTED = {
    "config.pallas_enabled": "the Pallas gate: the port's is config.kernels_enabled",
    "config.Config.use_pallas": "the Pallas switch: the port's is use_cuda_kernels",
    "config.Config.pallas_interpret": "Pallas's interpret mode: a CUDA wrapper takes its "
                                      "plain version for CPU tensors",
    "config.Config.pallas_tri_inv": "the Pallas routing of tri_inv_lower: the port's is "
                                    "cuda_tri_inv",
    "config.Config.pallas_chol_blocks": "the Pallas routing of blocked_cholesky: the "
                                        "port's is cuda_chol_blocks",
    "kernels.misc.jax_sigmoid": "a JAX helper; the port uses torch.sigmoid",
}


def _ref_modules():
    names = [REF] + [m.name for m in pkgutil.walk_packages(jpkg.__path__, REF + ".")]
    return [n for n in names if n[len(REF) + 1:] not in MODULES_NOT_PORTED]


def _twin(name):
    return importlib.import_module(PORT + name[len(REF):])


def _defined_here(module):
    """Public classes and callables the module defines (not imports)."""
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and callable(v)
            and getattr(v, "__module__", None) == module.__name__}


def test_version_and_lazy_names():
    assert tpkg.__version__ == jpkg.__version__
    for name in ("GPRegression", "SparseGPRegression", "SVGP", "Fitter",
                 "BayesianOptimization", "ModularBayesianOptimization", "DesignSpace",
                 "bounds_to_space", "initial_design", "kernels"):
        assert getattr(tpkg, name).__name__.split(".")[-1] == name
    assert type(tpkg.config).__name__ == type(jpkg.config).__name__ == "Config"
    with pytest.raises(AttributeError):
        tpkg.no_such_name  # noqa: B018


def test_acceptance_imports():
    from gaussian_process_optimization_tpu_torch.bo import (  # noqa: F401
        AcquisitionOptimizer, initial_design)
    from gaussian_process_optimization_tpu_torch.models import GPRegression  # noqa: F401

    assert tpkg.GPRegression is GPRegression
    assert tpkg.__version__ == "0.1.0"


WITH_ALL = [m.name[len(REF) + 1:] for m in pkgutil.walk_packages(jpkg.__path__, REF + ".")
            if m.ispkg and hasattr(importlib.import_module(m.name), "__all__")]


def test_all_lists_are_the_three_subpackages():
    assert sorted(WITH_ALL) == ["bo", "kernels", "models"]


@pytest.mark.parametrize("sub", WITH_ALL)
def test_every_all_name_imports(sub):
    ref = importlib.import_module(f"{REF}.{sub}")
    twin = importlib.import_module(f"{PORT}.{sub}")
    want = list(ref.__all__)
    missing = [n for n in want if not hasattr(twin, n)]
    assert not missing, f"{sub}: {missing}"
    assert set(want) <= set(twin.__all__)
    for n in want:
        ours, theirs = getattr(twin, n), getattr(ref, n)
        assert type(ours).__name__ == type(theirs).__name__ or (
            callable(ours) and callable(theirs)), n


def test_models_fit_is_the_submodule():
    from gaussian_process_optimization_tpu_torch import models

    assert type(models.fit).__name__ == "module"
    assert models.BOModel.MCMC_sampler is False
    from gaussian_process_optimization_tpu_torch.models.mcmc_bo_model import GPModel_MCMC
    from gaussian_process_optimization_tpu_torch.models.rf_model import RFModel
    from gaussian_process_optimization_tpu_torch.models.sparse_bo_model import SparseGPModel

    for cls in (models.GPModel, SparseGPModel, twbo.WarpedGPModel, twbo.InputWarpedGPModel,
                RFModel, GPModel_MCMC):
        assert issubclass(cls, models.BOModel)
        assert cls.MCMC_sampler is (cls is GPModel_MCMC)


@pytest.mark.parametrize("name", _ref_modules())
def test_module_surface_matches(name):
    """Every public class and function the reference module defines exists in
    the twin module, and every public attribute of such a class exists on the
    twin class."""
    ref, twin = importlib.import_module(name), _twin(name)
    short = name[len(REF) + 1:]
    missing = []
    for k, v in sorted(_defined_here(ref).items()):
        if f"{short}.{k}" in NAMES_NOT_PORTED:
            continue
        if not hasattr(twin, k):
            missing.append(k)
            continue
        if isinstance(v, type):
            ours = set(dir(getattr(twin, k)))
            missing += [f"{k}.{a}" for a in sorted(dir(v))
                        if not a.startswith("_") and a not in ours
                        and f"{short}.{k}.{a}" not in NAMES_NOT_PORTED]
    assert not missing, f"{short or REF}: {missing}"


def test_exclusions_are_still_gaps():
    """Each exclusion names something the reference has and the port lacks, so
    that a name ported later leaves the list."""
    for short in MODULES_NOT_PORTED:
        importlib.import_module(f"{REF}.{short}")
        with pytest.raises(ImportError):
            importlib.import_module(f"{PORT}.{short}")
    for path in NAMES_NOT_PORTED:
        ref, twin = _resolve(path, 1)
        name = path.split(".")[-1]
        assert hasattr(ref, name) and not hasattr(twin, name), path


# parameters of the reference's public functions and methods (module.qualname.
# parameter) that the twin takes under another name at the same place: the
# twin's name and the reason. The reference's ``key`` (a JAX PRNG key) is the
# twin's ``generator`` or ``rng`` wherever the twin takes one.
KEY_NAMES = ("generator", "rng")
PARAMETERS_NOT_PORTED = {
    "ops.lbfgs.minimize.carry_vjp": ("carry_graph", "a trial keeps its autograd graph, "
                                                    "not a vjp closure"),
    "utils.packing.Packer.pack.params": ("model", "the same model"),
    "models.bgplvm_svi.BGPLVM_SVI.data_term.idx_Y": ("Y", "the batch's rows"),
    "models.bgplvm_svi.BGPLVM_SVI.data_term.idx_mu": ("mu", "the batch's means"),
    "models.bgplvm_svi.BGPLVM_SVI.data_term.idx_S": ("S", "the batch's variances"),
    "bo.entropy_search.AcquisitionEntropySearchEPMGP.pure_raw_acq.gp_unused":
        ("gp", "as in the base class"),
    "bo.entropy_search.AcquisitionEntropySearchEPMGP.pure_raw_acq.posterior_unused":
        ("posterior", "as in the base class"),
    "bo.entropy_search.AcquisitionEntropySearchEPMGP.pure_raw_acq.fmin_unused":
        ("fmin", "as in the base class"),
}
# functions and methods (module.qualname) whose positional parameters do not
# sit where the reference's do, with the reason
ORDER_NOT_PORTED = {
    "config.Config.__init__": "the dataclass's fields are the port's: the Pallas switches "
                              "are renamed or have no twin (NAMES_NOT_PORTED)",
}
# parameters (module.qualname.parameter) whose default differs, with the reason
DEFAULTS_NOT_PORTED = {
    "config.Config.__init__.grad_matmul_precision":
        "the port keeps every reduced-precision knob opt-in: 'highest', where the "
        "reference defaults to bf16x3 'high'",
}
_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _callables(cls_or_module, twin):
    """(qualname, reference callable, twin callable) of every public function
    or method both define; a class's own methods, __init__ included."""
    out = []
    for k, v in sorted(_defined_here(cls_or_module).items()):
        tv = getattr(twin, k, None)
        if tv is None:
            continue
        if not isinstance(v, type):
            out.append((k, v, tv))
            continue
        for a, av in vars(v).items():
            if a.startswith("_") and a != "__init__":
                continue
            tav = inspect.getattr_static(tv, a, None)
            av, tav = (getattr(x, "__func__", x) for x in (av, tav))
            if inspect.isfunction(av) and inspect.isfunction(tav):
                out.append((f"{k}.{a}", av, tav))
    return out


def _twin_name(path, name, theirs):
    """The twin's name for the reference's parameter ``name``, or None."""
    if name in theirs:
        return name
    if name == "key":
        return next((k for k in KEY_NAMES if k in theirs), None)
    renamed = PARAMETERS_NOT_PORTED.get(f"{path}.{name}", (None,))[0]
    return renamed if renamed in theirs else None


def _pairs(name):
    ref, twin = importlib.import_module(name), _twin(name)
    short = name[len(REF) + 1:]
    for qual, f, tf in _callables(ref, twin):
        yield (f"{short}.{qual}", qual, inspect.signature(f).parameters,
               inspect.signature(tf).parameters)


@pytest.mark.parametrize("name", _ref_modules())
def test_parameter_names_match(name):
    """Every parameter of a public function or method of the reference module
    is a parameter of the twin's, under its name, as ``generator`` / ``rng``
    for ``key``, or as listed in PARAMETERS_NOT_PORTED (a class attribute the
    port does not have, listed in NAMES_NOT_PORTED, excepted for a dataclass's
    fields). A twin's ``**kwargs`` takes a missing name only where the
    reference's function takes ``**kwargs`` too; the reference's ``*args`` and
    ``**kwargs`` need the twin's."""
    short = name[len(REF) + 1:]
    missing = []
    for path, qual, ours, theirs in _pairs(name):
        kinds = {p.kind for p in theirs.values()}
        ref_kinds = {p.kind for p in ours.values()}
        cls = qual.split(".")[0]
        for p, param in ours.items():
            if p in ("self", "cls"):
                continue
            if param.kind in _VAR:
                if param.kind not in kinds:
                    missing.append(f"{qual}({p})")
                continue
            if _twin_name(path, p, theirs) is not None:
                continue
            if inspect.Parameter.VAR_KEYWORD in kinds & ref_kinds:
                continue
            if qual.endswith("__init__") and f"{short}.{cls}.{p}" in NAMES_NOT_PORTED:
                continue
            missing.append(f"{qual}({p})")
    assert not missing, f"{short or REF}: {missing}"


@pytest.mark.parametrize("name", _ref_modules())
def test_parameter_order_matches(name):
    """Every parameter the reference takes positionally sits at the same index
    among the twin's positional parameters (``key`` where the twin has
    ``generator`` or ``rng``), so that a positional call written for the
    reference binds the same in the port: the port's own parameters come after
    the reference's."""
    short = name[len(REF) + 1:]
    moved = []
    for path, qual, ours, theirs in _pairs(name):
        if path in ORDER_NOT_PORTED:
            continue
        mine = [n for n, p in theirs.items() if p.kind in _POSITIONAL]
        for i, p in enumerate(n for n, q in ours.items() if q.kind in _POSITIONAL):
            want = _twin_name(path, p, theirs)
            if i >= len(mine) or mine[i] != want:
                moved.append(f"{qual}: {p} at {i}, the port has "
                             f"{mine[i] if i < len(mine) else None}")
                break
    assert not moved, f"{short or REF}: {moved}"


def _same(a, b):
    """Equal defaults of one type (0 and 0.0 are not the same default)."""
    try:
        return type(a) is type(b) and bool(a == b)
    except (TypeError, ValueError):
        return a is b


@pytest.mark.parametrize("name", _ref_modules())
def test_parameter_defaults_match(name):
    """Where the reference and the twin both give a parameter a default, the
    two are equal."""
    short = name[len(REF) + 1:]
    differ = []
    empty = inspect.Parameter.empty
    for path, qual, ours, theirs in _pairs(name):
        for p, param in ours.items():
            tn = _twin_name(path, p, theirs)
            if tn is None or param.default is empty or theirs[tn].default is empty:
                continue
            if f"{path}.{p}" not in DEFAULTS_NOT_PORTED and not _same(
                    param.default, theirs[tn].default):
                differ.append(f"{qual}({p}): {param.default!r} vs {theirs[tn].default!r}")
    assert not differ, f"{short or REF}: {differ}"


def _resolve(path, depth):
    """The reference's and the twin's objects at ``path`` less its last
    ``depth`` parts: the longest module prefix both packages import, then
    attributes."""
    parts = path.split(".")
    for cut in range(len(parts) - depth, 0, -1):
        try:
            ref = importlib.import_module(f"{REF}.{'.'.join(parts[:cut])}")
            twin = importlib.import_module(f"{PORT}.{'.'.join(parts[:cut])}")
            break
        except ImportError:
            continue
    for attr in parts[cut:len(parts) - depth]:
        ref, twin = getattr(ref, attr), getattr(twin, attr)
    return ref, twin


def test_parameter_exclusions_are_still_gaps():
    """Each listed parameter is the reference's and not the twin's, which
    takes the listed name in its place."""
    for path, (renamed, _) in PARAMETERS_NOT_PORTED.items():
        ref, twin = _resolve(path, 1)
        name = path.split(".")[-1]
        ours, theirs = inspect.signature(ref).parameters, inspect.signature(twin).parameters
        assert name in ours and name not in theirs, path
        assert renamed in theirs and renamed not in ours, path
        assert list(ours).index(name) == list(theirs).index(renamed), path


def test_order_exclusions_are_still_gaps():
    """Each function listed in ORDER_NOT_PORTED still takes its positional
    parameters in another order than the reference's."""
    for path in ORDER_NOT_PORTED:
        ref, twin = _resolve(path, 0)
        ours = [n for n, p in inspect.signature(ref).parameters.items() if p.kind in _POSITIONAL]
        theirs = [n for n, p in inspect.signature(twin).parameters.items()
                  if p.kind in _POSITIONAL]
        assert ours[:len(theirs)] != theirs[:len(ours)], path


def test_default_exclusions_are_still_gaps():
    """Each default listed in DEFAULTS_NOT_PORTED still differs."""
    for path in DEFAULTS_NOT_PORTED:
        ref, twin = _resolve(path, 1)
        name = path.split(".")[-1]
        a = inspect.signature(ref).parameters[name].default
        b = inspect.signature(twin).parameters[name].default
        assert inspect.Parameter.empty not in (a, b) and not _same(a, b), path


# ------------------------------------------------------------------ DesignSpace
SPACES = {
    "mixed": [{"name": "xc", "type": "continuous", "domain": (0.0, 4.0)},
              {"name": "xd", "type": "discrete", "domain": (0, 1, 2)},
              {"name": "xk", "type": "categorical", "domain": (0, 1, 2, 3)}],
    "shifts": [{"name": "a", "type": "continuous", "domain": (2.0, 5.0)},
               {"name": "b", "type": "discrete", "domain": (10, 20, 30)}],
    "grid": [{"name": "a", "type": "discrete", "domain": (0, 1)},
             {"name": "b", "type": "discrete", "domain": (5, 6, 7)}],
    "bandit": [{"name": "c", "type": "continuous", "domain": (-1.0, 1.0), "dimensionality": 2},
               {"name": "arm", "type": "bandit",
                "domain": np.array([[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]])}],
}


def test_zero_start_shifts():
    """tests/test_space_designs.py::test_zero_start_shifts through the port."""
    s = TSpace(SPACES["shifts"])
    assert s.zeroStart_shifted_bounds() == [(0, 3.0), (0, 20)]
    X = np.array([[3.0, 20.0]])
    shifted = s.fit_to_zeroStart_shifted_bounds(X)
    np.testing.assert_allclose(shifted, [[1.0, 10.0]])
    np.testing.assert_allclose(s.revert_from_zeroStart_shifted_bounds(shifted), X)


def test_discrete_grid():
    """tests/test_space_designs.py::test_discrete_grid through the port."""
    assert TSpace(SPACES["grid"]).get_discrete_grid().shape == (6, 2)


def _variables(vs):
    return [(v.name, v.type, np.asarray(v.domain).tolist()) for v in vs]


@pytest.mark.parametrize("name", list(SPACES))
def test_space_queries_match_jax(name):
    """The twelve queries the port's DesignSpace gained, exactly the JAX
    package's on the same space."""
    ours, theirs = TSpace(SPACES[name]), JSpace(SPACES[name])
    for q in ("has_types", "has_continuous", "has_discrete", "get_categorical_dims",
              "input_dim"):
        assert getattr(ours, q)() == getattr(theirs, q)(), q
    for q in ("get_continuous_space", "get_discrete_space"):
        assert _variables(getattr(ours, q)()) == _variables(getattr(theirs, q)()), q
    np.testing.assert_array_equal(ours.get_discrete_grid(), theirs.get_discrete_grid())
    X = theirs.sample_uniform(7, np.random.default_rng(4))
    np.testing.assert_array_equal(ours.sample_uniform(7, np.random.default_rng(4)), X)
    assert X.shape == (7, ours.input_dim())
    if ours.has_types()["bandit"]:
        return  # a bandit's domain is a table of rows: no zero-start shift
    assert ours.zeroStart_shifted_bounds() == theirs.zeroStart_shifted_bounds()
    np.testing.assert_array_equal(ours.fit_to_zeroStart_shifted_bounds(X),
                                  theirs.fit_to_zeroStart_shifted_bounds(X))
    np.testing.assert_array_equal(ours.revert_from_zeroStart_shifted_bounds(X),
                                  theirs.revert_from_zeroStart_shifted_bounds(X))


# ------------------------------------------------------------------ warped gradients
def _warped_data():
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 1.0, (10, 2))
    Y = np.exp(np.sin(3.0 * X[:, :1]) + X[:, 1:])
    return X, Y, rng.uniform(0.1, 0.9, (4, 2))


@pytest.mark.parametrize("kind", ["WarpedGPModel", "InputWarpedGPModel"])
def test_warped_predictive_gradients_match_jax(kind):
    """``predictive_gradients`` of the warped GP the BO wrapper builds ((M, D,
    1) and (M, D)) to rtol 1e-8 in float64. ``get_d_moments`` stops on such a
    model in both packages, bare or in its wrapper: ``_train_X`` reads ``X``,
    which a warped GP keeps in its ``gp`` (reference bo/general.py:24). The
    error is the reference's own (ROADMAP C17): a fix on both sides changes
    this assertion."""
    X, Y, Xs = _warped_data()
    jw, tw = getattr(jwbo, kind)(), getattr(twbo, kind)(device="cpu")
    jw.model, tw.model = jw._make(X, Y, 16), tw._make(X, Y, 16)
    jw._post, tw._post = jwbo._warped_posterior(jw.model), tw.model.posterior_cache()
    jdm, jdv = jw.model.predictive_gradients(jnp.asarray(Xs))
    tdm, tdv = tw.model.predictive_gradients(torch.as_tensor(Xs))
    assert tdm.shape == (4, 2, 1) and tdv.shape == (4, 2)
    np.testing.assert_allclose(tdm.numpy(), np.asarray(jdm), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(jdv), rtol=1e-8, atol=1e-12)
    for general, models in ((jgeneral, (jw, jw.model)), (tgeneral, (tw, tw.model))):
        for model in models:
            with pytest.raises(AttributeError, match="'X'"):
                general.get_d_moments(model, Xs)


# ------------------------------------------------------------------ kernels, packer
@pytest.mark.parametrize("family", ["RBF", "ExpQuad", "Exponential", "OU", "Matern32",
                                    "Matern52", "Cosine", "Sinc", "RatQuad"])
def test_dK_dr_matches_jax(family):
    r = np.linspace(0.0, 3.0, 12).reshape(3, 4)
    ours = getattr(tpkg.kernels, family).create(2, variance=1.7, device="cpu")
    theirs = getattr(jpkg.kernels, family).create(2, variance=1.7)
    np.testing.assert_allclose(ours.dK_dr(torch.as_tensor(r)).numpy(),
                               np.asarray(theirs.dK_dr(jnp.asarray(r))), rtol=1e-10,
                               atol=1e-14)


def test_integral_k_ff_matches_jax():
    t, tp = np.linspace(0.0, 2.0, 5)[:, None], np.linspace(0.5, 1.5, 4)[None, :]
    ours = tpkg.kernels.Integral.create(1, variances=1.3, lengthscale=0.7, device="cpu")
    theirs = jpkg.kernels.Integral.create(1, variances=1.3, lengthscale=0.7)
    np.testing.assert_allclose(ours.k_ff(torch.as_tensor(t), torch.as_tensor(tp)).numpy(),
                               np.asarray(theirs.k_ff(jnp.asarray(t), jnp.asarray(tp))),
                               rtol=1e-10)
    X = np.linspace(0.0, 2.0, 5)[:, None]
    np.testing.assert_allclose(ours.Kdiag(torch.as_tensor(X)).numpy(),
                               np.asarray(theirs.Kdiag(jnp.asarray(X))), rtol=1e-12)


def test_map_constrained_matches_jax():
    X, Y, _ = _warped_data()
    jm = jpkg.GPRegression.create(X, Y, kernel=jpkg.kernels.RBF.create(2, ARD=True))
    tm = tpkg.GPRegression.create(X, Y, kernel=tpkg.kernels.RBF.create(2, ARD=True,
                                                                       device="cpu"),
                                  device="cpu")
    fix = ("likelihood_variance",)

    def leaf(value, fixed):
        v = value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        return v.tolist(), fixed

    ours = make_packer(tm, fix=fix).map_constrained(leaf, tm)
    theirs = jmake_packer(jm, fix=fix).map_constrained(leaf, jm)
    assert ours == theirs
