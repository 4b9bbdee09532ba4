"""The port's gallery twins (``gaussian_process_optimization_tpu_torch/examples/
gallery``) against the reference's demos (``examples/gallery``), on the CPU in
float64: each public demo is called in both packages unoptimized, on the same
numpy data, and what it returns is compared. A model's objective (its
``log_marginal_likelihood``: the LML, or the bound or evidence the model has)
agrees to rtol 1e-8 where it is closed-form and 1e-6 where it comes from an
iterative scheme (Laplace's Newton steps, EP's sweeps) at the same caps; its
predictions at 5 fixed points to the same tolerance. Anything else a demo
returns is compared element by element at rtol 1e-8."""
import inspect
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from examples import gallery as jgallery  # noqa: E402
from gaussian_process_optimization_tpu_torch.examples import gallery as tgallery  # noqa: E402
from gaussian_process_optimization_tpu_torch.utils.tree import tree_map  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402


def _public_functions(module):
    return [f for name, f in inspect.getmembers(module, inspect.isfunction)
            if not name.startswith("_") and f.__module__ == module.__name__]


def _module_name(module):
    return module.__name__.split(".")[-1]


def _unoptimized(fn, **kw):
    params = inspect.signature(fn).parameters
    kw.update({k: False for k in ("optimize", "plot") if k in params})
    return fn(**kw)


REF_DEMOS = [(_module_name(m), f.__name__) for m in jgallery.MODULES
             for f in _public_functions(m)]
_TWINS = {_module_name(m): m for m in tgallery.MODULES}
_REFS = {_module_name(m): m for m in jgallery.MODULES}

# models whose objective comes out of an iterative scheme: Laplace's Newton
# steps and EP's sweeps stop on a tolerance, so the two packages' last
# iterates differ in the rounding of their path
ITERATIVE = {"GPLaplace", "GPClassification", "SparseGPClassification",
             "SparseGPClassificationUncertainInput"}
# the TP's K carries only the 1e-8 jitter (cond ~1e8 on student_t_approx's
# data), so its predictive solves keep ~8 digits in float64: 6e-8 apart
ILL_CONDITIONED_PREDICTIONS = {"TPRegression"}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _input_dim(model):
    """Columns of the inputs ``predict`` takes, or None for a model without
    ``predict``."""
    if not hasattr(model, "predict"):
        return None
    d = getattr(model, "input_dim", None)
    if isinstance(d, int) and not hasattr(model, "q_mu"):
        return d
    for path in ("q_mu", "X", "gp.X", "model.X"):
        obj = model
        for attr in path.split("."):
            obj = getattr(obj, attr, None)
        if obj is not None:
            return int(obj.shape[-1])
    raise AssertionError(f"no input width for {type(model).__name__}")


def _predict(model, X):
    params = inspect.signature(model.predict).parameters
    out = model.predict(X, task=0) if "task" in params else model.predict(X)
    return out if isinstance(out, (tuple, list)) else (out,)


def _compare(ref, twin, where):
    """The JAX side runs under ``jax.jit``: one compile of a small program costs
    less than the op-by-op dispatch of the same program."""
    if hasattr(twin, "log_marginal_likelihood"):
        name = type(twin).__name__
        assert type(ref).__name__ == name, where
        rtol = 1e-6 if name in ITERATIVE else 1e-8
        np.testing.assert_allclose(_np(twin.log_marginal_likelihood()),
                                   np.asarray(jax.jit(ref.log_marginal_likelihood)()),
                                   rtol=rtol, err_msg=f"{where}: objective")
        d = _input_dim(twin)
        if d is not None:
            X5 = np.random.default_rng(123).uniform(-1.0, 1.0, (5, d))
            got = [_np(o) for o in _predict(twin, torch.as_tensor(X5, dtype=torch.float64))]
            want = [np.asarray(o) for o in jax.jit(lambda: _predict(ref, X5))()]
            assert len(got) == len(want), where
            if name in ILL_CONDITIONED_PREDICTIONS:
                rtol = 1e-6
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12,
                                           err_msg=f"{where}: prediction")
    elif isinstance(twin, dict):
        assert set(twin) == set(ref), where
        for k in twin:
            _compare(ref[k], twin[k], f"{where}[{k}]")
    elif isinstance(twin, tuple):
        assert len(twin) == len(ref), where
        for i, (r, t) in enumerate(zip(ref, twin)):
            _compare(r, t, f"{where}[{i}]")
    else:
        np.testing.assert_allclose(_np(twin), np.asarray(ref), rtol=1e-8, err_msg=where)


def test_gallery_covers_reference_breadth():
    """The port's gallery has the reference's modules and, in each, the
    reference's public demos one to one."""
    twins = [(_module_name(m), f.__name__) for m in tgallery.MODULES
             for f in _public_functions(m)]
    assert [_module_name(m) for m in tgallery.MODULES] == [_module_name(m)
                                                           for m in jgallery.MODULES]
    assert sorted(twins) == sorted(REF_DEMOS)
    assert len(REF_DEMOS) == 47


@pytest.mark.parametrize("mod,name", REF_DEMOS, ids=[f"{m}.{n}" for m, n in REF_DEMOS])
def test_gallery_twin_matches_reference(mod, name):
    ref = _unoptimized(getattr(_REFS[mod], name))
    twin = _unoptimized(getattr(_TWINS[mod], name), device="cpu", dtype=torch.float64)
    _compare(ref, twin, f"{mod}.{name}")


def _scaled(tree, s, dtype, tree_map):
    """Every float leaf times ``s``, cast to ``dtype``."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return (a * s).to(dtype) if a.is_floating_point() else a
        if hasattr(a, "dtype") and np.issubdtype(a.dtype, np.floating):
            return (a * s).astype(dtype)
        return a
    return tree_map(leaf, tree)


def _objective_of(model):
    return model.log_marginal_likelihood()


def _objective(model):
    return float(_np(model.log_marginal_likelihood()))


# one demo per gallery module, and the model in what it returns that is held
F32_DEMOS = [("regression", "toy_rbf_1d", 0), ("classification", "toy_heaviside", 0),
             ("dimensionality_reduction", "bgplvm_simulation", 0),
             ("non_gaussian", "student_t_approx", 1), ("state_space", "state_space_example", 0)]
SCALES = (1.0, 1.01, 1.02, 1.03, 1.04, 1.05, 1.06, 1.07)


@pytest.mark.parametrize("mod,name,which", F32_DEMOS,
                         ids=[f"{m}.{n}" for m, n, _ in F32_DEMOS])
def test_f32_objective_gap_is_the_references(mod, name, which):
    """The port's float32 objective on the CPU is as close to its float64 one
    as the JAX package's float32 is to its own: each package's float64 model,
    every float leaf scaled by s, is cast to float32 and both objectives taken.
    The gap is rounding noise, one package ahead at one s and the other at the
    next, so the check is on the mean gap over eight s: the port's within 2x of
    the JAX package's. Phase 13 of chip_smoke.py bounds the card's float32 by
    the port's CPU gap (capped at 1e-2 of the objective), so this is what makes
    its limit honest."""
    ref = _unoptimized(getattr(_REFS[mod], name))
    twin = _unoptimized(getattr(_TWINS[mod], name), device="cpu", dtype=torch.float64)
    ref, twin = (ref[which], twin[which]) if isinstance(ref, tuple) else (ref, twin)
    jax_gaps, port_gaps = [], []
    lml = jax.jit(_objective_of)
    for s in SCALES:
        j64 = float(lml(_scaled(ref, s, np.float64, jax.tree_util.tree_map)))
        with jax.enable_x64(False):
            j32 = float(lml(_scaled(ref, s, np.float32, jax.tree_util.tree_map)))
        jax_gaps.append(abs(j32 - j64))
        t64 = _objective(_scaled(twin, s, torch.float64, tree_map))
        port_gaps.append(abs(_objective(_scaled(twin, s, torch.float32, tree_map)) - t64))
    print(f"{mod}.{name}: mean f32 gap port {np.mean(port_gaps):.3e} "
          f"jax {np.mean(jax_gaps):.3e}; per s port {np.round(port_gaps, 8)} "
          f"jax {np.round(jax_gaps, 8)}")
    assert np.all(np.isfinite(port_gaps)) and np.all(np.isfinite(jax_gaps))
    assert np.mean(port_gaps) <= 2.0 * np.mean(jax_gaps)


ILL_POSED = sorted(chip_smoke.EXAMPLES_F32_ILL_POSED)


@pytest.mark.parametrize("mod,name,which", ILL_POSED,
                         ids=[f"{m}.{n}[{i}]" for m, n, i in ILL_POSED])
def test_f32_ill_posed_objectives_are_the_references_own(mod, name, which):
    """Phase 13 holds these objectives in float64 on the card, not in float32,
    because the JAX package's own float32 misses them: the reference demo
    built with x64 off is further from its float64 objective than the phase's
    cap over its gap factor, so 10x its own gap would pass the cap. The demo's
    float64 model, every float leaf cast to float32, gives the float32
    objective."""
    out = _unoptimized(getattr(_REFS[mod], name))
    model = out[which] if isinstance(out, tuple) else out
    lml = jax.jit(_objective_of)
    f64 = float(lml(model))
    with jax.enable_x64(False):
        f32 = float(lml(_scaled(model, 1.0, np.float32, jax.tree_util.tree_map)))
    print(f"{mod}.{name}[{which}]: JAX float64 {f64:.9g}, float32 {f32:.9g}, "
          f"rel {abs(f32 - f64) / abs(f64):.3e}")
    assert abs(f32 - f64) > (chip_smoke.EXAMPLES_REL_CAP / chip_smoke.EXAMPLES_GAP_FACTOR
                             * abs(f64))


def _objectives(out):
    """Every objective in what a demo returns, as floats (chip_smoke's
    ``_demo_objectives`` for either package)."""
    if hasattr(out, "log_marginal_likelihood"):
        return [float(_np(out.log_marginal_likelihood()))]
    if isinstance(out, tuple):
        return [v for o in out for v in _objectives(o)]
    if isinstance(out, dict):
        return [float(_np(v)) for v in out.values()]
    return [float(_np(out))]


@pytest.mark.slow
@pytest.mark.parametrize("mod,name", REF_DEMOS, ids=[f"{m}.{n}" for m, n in REF_DEMOS])
def test_f32_ill_posed_list_is_complete(mod, name):
    """Each demo built in float32 in both packages, against its float64, on the
    CPU: an objective of ``chip_smoke.EXAMPLES_F32_ILL_POSED`` misses its
    float64 by more than the cap over the gap factor in the JAX package; every
    other objective is within that in both packages, so phase 13's float32
    limit can hold it. Prints the four readings of each objective."""
    ref, twin = getattr(_REFS[mod], name), getattr(_TWINS[mod], name)
    j64 = _objectives(_unoptimized(ref))
    with jax.enable_x64(False):
        j32 = _objectives(_unoptimized(ref))
    t64 = _objectives(_unoptimized(twin, device="cpu", dtype=torch.float64))
    t32 = _objectives(_unoptimized(twin, device="cpu", dtype=torch.float32))
    rel = chip_smoke.EXAMPLES_REL_CAP / chip_smoke.EXAMPLES_GAP_FACTOR
    for i, (a, b, c, d) in enumerate(zip(j64, j32, t64, t32)):
        jgap, tgap = abs(b - a) / abs(a), abs(d - c) / abs(c)
        print(f"{mod}.{name}[{i}]: float32 gap rel JAX {jgap:.3e}, port {tgap:.3e}")
        if (mod, name, i) in chip_smoke.EXAMPLES_F32_ILL_POSED:
            assert jgap > rel
        else:
            assert jgap <= rel and tgap <= rel
