"""The port's kernel zoo against the JAX package's, in float64 on the CPU.

Every kernel of the JAX harness's ``RECIPES`` (``test_kernel_zoo_harness.py``)
and the structured ones (task, condition and output columns, the
coregionalized product, the static and basis-function kernels, the symbolic
kernel) is built in the JAX package, carried into the port by
``convert.kernel_from_leaves`` from its leaves and a spec read off the JAX
object, and held to it: K(X), Kdiag(X), K(X, X2), and autograd's gradient of
sum(W * K) for every leaf against ``jax.grad`` (rtol 1e-8). A kernel whose
leaves carry 3 lanes equals three single-lane builds (rtol 1e-12).

The helpers here are imported by ``test_torch_lfm_ode.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models.multioutput import icm_kernel as jicm
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.models.parameters import DATA_NAMES
from gaussian_process_optimization_tpu_torch.utils.tree import (leaf_name, named_leaves,
                                                                replace_leaves)
from test_kernel_zoo_harness import RECIPES
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-8
LANE_RTOL = 1e-12


def jax_leaves(obj, prefix="kern."):
    """The JAX object's leaves keyed by the port's dotted paths."""
    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    out = {}
    for path, leaf in flat:
        parts = []
        for e in path:
            if isinstance(e, jax.tree_util.GetAttrKey):
                parts.append(e.name)
            elif isinstance(e, jax.tree_util.SequenceKey):
                parts.append(str(e.idx))
            elif isinstance(e, jax.tree_util.DictKey):
                parts.append(str(e.key))
        out[prefix + ".".join(parts)] = np.asarray(leaf)
    return out


def spec_of(k):
    """``convert.kernel_from_leaves``'s spec of a JAX kernel: its class name,
    its static fields and its sub-kernels."""
    spec = {"class": type(k).__name__}
    for f in dataclasses.fields(k):
        v = getattr(k, f.name)
        if isinstance(v, jk.Kernel):
            spec[f.name] = spec_of(v)
        elif isinstance(v, tuple) and v and isinstance(v[0], jk.Kernel):
            spec[f.name] = [spec_of(p) for p in v]
        elif f.metadata.get("static", False):
            spec[f.name] = v
    return spec


def port_of(jkern, **overrides):
    spec = {**spec_of(jkern), **overrides}
    return convert.kernel_from_leaves(jax_leaves(jkern), spec, device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a, dtype=float))


def _close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want, dtype=float)
    got = np.asarray(got, dtype=float)
    atol = 1e-12 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def port_grads(kern, loss):
    """{path: d loss / d leaf} of a port kernel, zeros for an unused leaf."""
    named = named_leaves(kern)
    leaves = [t.detach().clone().requires_grad_(True) for _, t in named]
    value = loss(replace_leaves(kern, leaves))
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return {path: (torch.zeros_like(t) if g is None else g)
            for (path, t), g in zip(named, grads)}


def check_kernel(jkern, X, X2=None, cross=True, tkern=None, seed=1):
    """K, Kdiag, K(X, X2) and every leaf's gradient of sum(W * K), port
    against the JAX package."""
    tkern = port_of(jkern) if tkern is None else tkern
    Xj, Xt = jnp.asarray(X), _t(X)
    _close(tkern.K(Xt).detach(), jkern.K(Xj), what="K(X)")
    _close(tkern.Kdiag(Xt).detach(), jkern.Kdiag(Xj), what="Kdiag")
    if cross:
        _close(tkern.K(Xt, _t(X2)).detach(), jkern.K(Xj, jnp.asarray(X2)), what="K(X, X2)")
    n = X.shape[0]
    W = np.random.default_rng(seed).standard_normal((n, n))
    W = 0.5 * (W + W.T)
    gj = jax_leaves(jax.grad(lambda kk: jnp.sum(jnp.asarray(W) * kk.K(Xj)))(jkern), "")
    gt = port_grads(tkern, lambda kk: torch.sum(_t(W) * kk.K(Xt)))
    assert sorted(gj) == sorted(gt), (sorted(gj), sorted(gt))
    for path, g in gt.items():
        _close(g, gj[path], what=f"d/d {path}")
    return tkern


def check_lanes(tkern, X, scales=(1.0, 1.1, 0.9)):
    """Three lanes of leaves (each leaf scaled per lane; data leaves
    unbatched) give the three single-lane K, K(X, X2) and Kdiag."""
    named = named_leaves(tkern)
    Xt = _t(X)

    def lane(s):
        return replace_leaves(tkern, [t if leaf_name(p) in DATA_NAMES else t * s
                                      for p, t in named])

    laned = replace_leaves(tkern, [t if leaf_name(p) in DATA_NAMES
                                   else torch.stack([t * s for s in scales]) for p, t in named])
    K3 = laned.K(Xt)
    assert K3.shape == (len(scales), X.shape[0], X.shape[0])
    d3 = laned.Kdiag(Xt)
    for i, s in enumerate(scales):
        single = lane(s)
        _close(K3[i], single.K(Xt), rtol=LANE_RTOL, what=f"lane {i} K")
        _close(d3[i], single.Kdiag(Xt), rtol=LANE_RTOL, what=f"lane {i} Kdiag")


def _tasks(rng, n, d, tasks):
    return np.column_stack([rng.standard_normal((n, d)), rng.integers(0, tasks, n)])


# name -> (JAX kernel, inputs (rng -> X), options)
STRUCTURED = {
    "Coregionalize": (
        lambda: jk.Coregionalize.create(1, output_dim=3, rank=2,
                                        W=[[0.5, -0.2], [1.0, 0.3], [-0.3, 0.8]],
                                        kappa=[0.2, 0.4, 0.1]),
        lambda rng: rng.integers(0, 3, (7, 1)).astype(float), {}),
    "ICM": (
        lambda: jicm(2, 3, jk.Matern52.create(2, ARD=True, lengthscale=[0.7, 1.3]), rank=1,
                     W=[[0.5], [1.0], [-0.3]], kappa=[0.2, 0.4, 0.1]),
        lambda rng: _tasks(rng, 7, 2, 3), {}),
    "StandardPeriodicARD": (
        lambda: jk.StandardPeriodic.create(2, variance=1.2, period=[1.0, 1.5],
                                           lengthscale=[0.6, 0.9], ARD1=True, ARD2=True),
        lambda rng: rng.standard_normal((7, 2)), {}),
    "MLPARD": (lambda: jk.MLP.create(2, weight_variance=[0.5, 2.0], bias_variance=0.7, ARD=True),
               lambda rng: rng.standard_normal((7, 2)), {}),
    "Poly2": (lambda: jk.Poly.create(2, variance=0.8, weight_variance=1.3, bias_variance=0.4,
                                     order=2),
              lambda rng: rng.standard_normal((7, 2)), {}),
    "TruncLinearShared": (lambda: jk.TruncLinear.create(2, variances=0.7, delta=0.2),
                          lambda rng: rng.standard_normal((7, 2)), {}),
    "LinearSlopeBasisFunc": (
        lambda: jk.LinearSlopeBasisFuncKernel.create(1, start=[-1.0, 0.0], stop=[0.5, 1.5],
                                                     variance=[0.7, 1.3], ARD=True),
        lambda rng: rng.standard_normal((7, 1)), {}),
    "ChangePointBasisFunc": (
        lambda: jk.ChangePointBasisFuncKernel.create(1, changepoint=0.1, variance=0.8),
        lambda rng: rng.standard_normal((7, 1)), {}),
    "DomainKernel": (lambda: jk.DomainKernel.create(1, start=-0.5, stop=0.7, variance=1.2),
                     lambda rng: rng.standard_normal((7, 1)), {}),
    "Fixed": (
        lambda: jk.Fixed.create(2, fixed_K=np.cov(np.random.default_rng(3).standard_normal(
            (7, 12))), variance=0.6),
        lambda rng: rng.standard_normal((7, 2)), {}),
    "WhiteHeteroscedastic": (
        lambda: jk.WhiteHeteroscedastic.create(2, num_data=7,
                                               variance=np.linspace(0.1, 0.7, 7)),
        lambda rng: rng.standard_normal((7, 2)), {}),
    "SplitKern": (lambda: jk.SplitKern.create(jk.RBF.create(1, variance=1.5, lengthscale=0.8),
                                              [[0.3]]),
                  lambda rng: _tasks(rng, 7, 1, 2), {}),
    "DEtime": (lambda: jk.DEtime.create(jk.RBF.create(1, variance=1.2, lengthscale=0.9), idx_p=2,
                                        Xp=[[0.5]]),
               lambda rng: np.column_stack([rng.uniform(0, 2, 8), np.repeat([0.0, 1.0], 4)]),
               {"cross": False}),
    "MultioutputKern": (
        lambda: jk.MultioutputKern.create([jk.RBF.create(1, variance=1.0, lengthscale=0.5),
                                           jk.Matern52.create(1, variance=2.0, lengthscale=1.5)]),
        lambda rng: _tasks(rng, 7, 1, 2), {}),
    "IndependentOutputs": (lambda: jk.IndependentOutputs(jk.RBF.create(1, lengthscale=0.7),
                                                         output_dim=2),
                           lambda rng: _tasks(rng, 7, 1, 2), {}),
    "GridRBF": (lambda: jk.GridRBF.create(1, variance=1.2, lengthscale=0.7),
                lambda rng: rng.standard_normal((7, 1)), {}),
    "Symbolic": (
        lambda: jk.SymbolicKernel.create(
            2, lambda x, z, p: p["variance"] * jnp.exp(
                -0.5 * jnp.sum((x - z) ** 2) / p["lengthscale"] ** 2),
            params={"variance": 1.3, "lengthscale": 0.8}),
        lambda rng: rng.standard_normal((7, 2)),
        {"expr": lambda x, z, p: p["variance"] * torch.exp(
            -0.5 * torch.sum((x - z) ** 2) / p["lengthscale"] ** 2)}),
}


def _structured(name):
    make, make_X, opts = STRUCTURED[name]
    opts = dict(opts)
    expr = opts.pop("expr", None)
    jkern = make()
    tkern = port_of(jkern, **({} if expr is None else {"expr": expr}))
    rng = np.random.default_rng(0)
    return jkern, tkern, make_X(rng), make_X(rng)[:5], opts


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_kernel_matches_jax(name):
    make, make_X = RECIPES[name]
    rng = np.random.default_rng(0)
    X, X2 = make_X(rng), make_X(rng)[:5]
    tkern = check_kernel(make(), X, X2)
    check_lanes(tkern, X)


@pytest.mark.parametrize("name", sorted(STRUCTURED))
def test_structured_kernel_matches_jax(name):
    jkern, tkern, X, X2, opts = _structured(name)
    check_kernel(jkern, X, X2, tkern=tkern, **opts)
    check_lanes(tkern, X)


def test_coregionalize_task_column_gradient_is_zero():
    """The rounded task column gets an exactly-zero gradient, as in the
    reference (what keeps sparse inducing task columns on their integers)."""
    jkern, tkern, X, _, _ = _structured("ICM")
    Xt = _t(X).requires_grad_(True)
    (g,) = torch.autograd.grad(tkern.K(Xt).sum(), Xt)
    assert torch.all(g[:, -1] == 0.0)
    gj = jax.grad(lambda x: jnp.sum(jkern.K(x)))(jnp.asarray(X))
    _close(g.detach(), gj, what="dK/dX")


def test_coregionalize_out_of_range_task_takes_the_nearest():
    """An index past either end reads the nearest task, as JAX's clamped
    gather does; -1 counts from the end."""
    jkern, tkern, _, _, _ = _structured("Coregionalize")
    X = np.array([[-1.0], [0.0], [2.0], [5.0]])
    _close(tkern.K(_t(X)).detach(), jkern.K(jnp.asarray(X)))


def test_symbolic_from_sympy_raises_without_sympy():
    from gaussian_process_optimization_tpu_torch.kernels import SymbolicKernel

    try:
        import sympy  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="sympy"):
            SymbolicKernel.from_sympy(1, None, [], [], [])
    else:
        x, z, v = sympy.symbols("x z v")
        k = SymbolicKernel.from_sympy(1, v * sympy.exp(-(x - z) ** 2), [x], [z], [v],
                                      params={"v": 1.3}, device="cpu")
        X = torch.linspace(0, 1, 4)[:, None].double()
        _close(k.K(X), 1.3 * np.exp(-np.square(X.numpy() - X.numpy().T)))


def test_kernels_package_exports_the_references():
    import gaussian_process_optimization_tpu_torch.kernels as tk

    assert set(jk.__all__) <= set(tk.__all__)
    for name in jk.__all__:
        assert hasattr(tk, name), name
