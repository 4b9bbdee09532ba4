"""The torch port's kernel algebra against the JAX package, in float64: the
``Add`` / ``Prod`` combinations with ``active_dims`` (values, lanes, the packed
parameter vector of a model that holds one), ``Sinc``, ``gradients_X``, the
diagonal curvature ``d2K_dXdX2_diag``, ``input_sensitivity``, and the carrying
of a composite model through ``convert``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.parameters import _leaf_names as jleaf_names
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch import kernels as tk
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.parameters import leaf_names, make_packer
from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves, replace_leaves
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9
LS = np.array([0.7, 1.4, 0.9, 1.1])


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=torch.float64, **kw)


def _pair(cls, input_dim, variance, lengthscale, active_dims=None, **extra):
    """The same stationary kernel in both packages."""
    j = getattr(jk, cls)(input_dim=input_dim, active_dims=active_dims,
                         variance=jnp.asarray(variance), lengthscale=jnp.asarray(lengthscale),
                         **{k: jnp.asarray(v) for k, v in extra.items()})
    t = getattr(tk, cls)(input_dim=input_dim, active_dims=active_dims, variance=_t(variance),
                         lengthscale=_t(lengthscale), **{k: _t(v) for k, v in extra.items()})
    return j, t


def _combo(op):
    """Matern52 ARD on all 4 inputs, op, RBF on inputs (0, 2), op, RatQuad on (3,)."""
    parts = [_pair("Matern52", 4, 1.3, LS), _pair("RBF", 2, 0.6, 0.8, active_dims=(0, 2)),
             _pair("RatQuad", 1, 0.9, 1.7, active_dims=(3,), power=1.5)]
    j, t = parts[0]
    for pj, pt in parts[1:]:
        j, t = (j + pj, t + pt) if op == "add" else (j * pj, t * pt)
    return j, t


@pytest.mark.parametrize("op", ["add", "prod"])
def test_combination_K_matches_jax(op, rng):
    """K(X), K(X, X2) and Kdiag of three parts with ``active_dims``, 1e-9; the
    combination is flat (three parts, not nested)."""
    j, t = _combo(op)
    assert type(t).__name__ == type(j).__name__ and len(t.parts) == len(j.parts) == 3
    assert t.input_dim == j.input_dim == 4
    X, X2 = rng.uniform(-2, 2, (15, 4)), rng.uniform(-2, 2, (6, 4))
    np.testing.assert_allclose(t.K(_t(X)).numpy(), np.asarray(j.K(jnp.asarray(X))), rtol=RTOL)
    np.testing.assert_allclose(t.K(_t(X), _t(X2)).numpy(),
                               np.asarray(j.K(jnp.asarray(X), jnp.asarray(X2))), rtol=RTOL)
    np.testing.assert_allclose(t.Kdiag(_t(X)).numpy(), np.asarray(j.Kdiag(jnp.asarray(X))),
                               rtol=RTOL)


@pytest.mark.parametrize("op", ["add", "prod"])
def test_combination_parameter_gradients_match_jax(op, rng):
    """d sum(K(X) W) / d every leaf, against jax.grad, 1e-9: the product's
    rematerialized build gives the plain product's gradients."""
    j, t = _combo(op)
    X, W = rng.uniform(-2, 2, (12, 4)), rng.standard_normal((12, 12))
    jg = jax.grad(lambda k: jnp.sum(k.K(jnp.asarray(X)) * W))(j)
    leaves = [v.clone().requires_grad_(True) for _, v in named_leaves(t)]
    tr = replace_leaves(t, leaves)
    grads = torch.autograd.grad(torch.sum(tr.K(_t(X)) * _t(W)), leaves)
    for g, want in zip(grads, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("op", ["add", "prod"])
def test_combination_lanes_broadcast(op, rng):
    """Two lanes in one part's hyperparameters and none in the others: lane b
    of the (2, N, M) result is the unbatched kernel with lane b's values."""
    _, t = _combo(op)
    first = t.parts[0]
    var2, ls2 = _t([1.3, 0.4]), _t(np.stack([LS, LS[::-1]]))
    lanes = type(t)(parts=(type(first)(input_dim=4, variance=var2, lengthscale=ls2),)
                    + t.parts[1:], input_dim=4)
    X, X2 = _t(rng.uniform(-2, 2, (9, 4))), _t(rng.uniform(-2, 2, (5, 4)))
    K2, Kd2 = lanes.K(X, X2), lanes.Kdiag(X2)
    assert K2.shape == (2, 9, 5) and Kd2.shape == (2, 5)
    for b in range(2):
        one = type(t)(parts=(type(first)(input_dim=4, variance=var2[b], lengthscale=ls2[b]),)
                      + t.parts[1:], input_dim=4)
        np.testing.assert_allclose(K2[b].numpy(), one.K(X, X2).numpy(), rtol=1e-13)
        np.testing.assert_allclose(Kd2[b].numpy(), one.Kdiag(X2).numpy(), rtol=1e-13)


def _composite_models(rng, op="add", n=14, max_points=16):
    X, Y = rng.uniform(-2, 2, (n, 4)), rng.standard_normal((n, 1))
    (j1, t1), (j2, t2) = _pair("Matern52", 4, 1.3, LS), _pair("RBF", 2, 0.6, 0.8,
                                                              active_dims=(0, 2))
    jkern, tkern = (j1 + j2, t1 + t2) if op == "add" else (j1 * j2, t1 * t2)
    jm = JGP.create(X, Y, kernel=jkern, noise_var=0.2, max_points=max_points)
    tm = GPRegression.create(X, Y, kernel=tkern, noise_var=0.2, max_points=max_points,
                             device="cpu")
    return jm, tm


def test_composite_packer_matches_jax(rng):
    """``Add(Matern52 ARD, RBF)`` in a model: the leaves' paths and names, and
    the flat vector's order and values, are the JAX packer's; the names key the
    transforms, so both parts' variances are softplus-constrained."""
    jm, tm = _composite_models(rng)
    paths = [p for p, _ in named_leaves(tm)]
    assert paths[:5] == ["kern.parts.0.variance", "kern.parts.0.lengthscale",
                         "kern.parts.1.variance", "kern.parts.1.lengthscale",
                         "likelihood_variance"]
    assert leaf_names(tm)[:5] == jleaf_names(jm)[:5] == [
        "variance", "lengthscale", "variance", "lengthscale", "likelihood_variance"]
    jp, tp = jmake_packer(jm), make_packer(tm)
    u = tp.pack(tm)
    assert u.shape == (8,)  # 1 + 4, 1 + 1, noise
    np.testing.assert_allclose(u.numpy(), np.asarray(jp.pack(jm)), rtol=1e-13)
    back = tp.unpack(u + 0.25, reference=tm)
    jback = jp.unpack(jnp.asarray((u + 0.25).numpy()), reference=jm)
    for (_, a), b in zip(named_leaves(back.kern), jax.tree_util.tree_leaves(jback.kern)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13)


@pytest.mark.parametrize("op", ["add", "prod"])
def test_composite_lml_and_gradient_match_jax(op, rng):
    """-LML of a model with a combination kernel, and its gradient in the
    packed coordinates, 1e-8; three lanes at once against each alone."""
    jm, tm = _composite_models(rng, op)
    jp, tp = jmake_packer(jm), make_packer(tm)
    jobj, tobj = jfit.make_objective(jp), make_objective(tp)
    U = tp.pack(tm)[None] + _t(rng.normal(0, 0.3, (3, tp.num_free)))
    Ur = U.clone().requires_grad_(True)
    f = tobj(Ur, tm)
    (g,) = torch.autograd.grad(f.sum(), Ur)
    for b in range(3):
        jf, jg = jax.value_and_grad(lambda u: jobj(u, jm))(jnp.asarray(U[b].numpy()))
        np.testing.assert_allclose(float(f[b].detach()), float(jf), rtol=1e-8)
        np.testing.assert_allclose(g[b].numpy(), np.asarray(jg), rtol=1e-8, atol=1e-10)


def test_composite_model_converts(rng):
    """A JAX model with an ``Add`` kernel carried through ``gp_from_leaves``:
    the same leaves, paths and LML."""
    jm, tm = _composite_models(rng)
    flat, _ = jax.tree_util.tree_flatten_with_path(jm)
    jleaves = {".".join(str(getattr(k, "name", getattr(k, "idx", k))) for k in path):
               np.asarray(leaf) for path, leaf in flat}
    spec = {"op": "add", "parts": [{"family": "matern52", "active_dims": None},
                                   {"family": "rbf", "active_dims": (0, 2)}]}
    got = convert.gp_from_leaves(jleaves, composite=spec, device="cpu")
    assert list(convert.leaves_of(got)) == list(convert.leaves_of(tm))
    for (_, a), (_, b) in zip(named_leaves(got), named_leaves(tm)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(float(got.log_marginal_likelihood()),
                               float(jm.log_marginal_likelihood()), rtol=1e-10)


def test_sinc_matches_jax(rng):
    """Sinc's K and its parameter gradients; it is outside the CUDA kernels'
    families, so no call of it is ever routed to them."""
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels

    j, t = _pair("Sinc", 3, 1.2, np.array([0.7, 1.1, 1.6]))
    assert not cuda_kernels.supports(t, torch.zeros(200, 3), None)
    X, W = rng.uniform(-2, 2, (11, 3)), rng.standard_normal((11, 11))
    np.testing.assert_allclose(t.K(_t(X)).numpy(), np.asarray(j.K(jnp.asarray(X))), rtol=RTOL)
    jg = jax.grad(lambda k: jnp.sum(k.K(jnp.asarray(X)) * W))(j)
    v, ls = t.variance.clone().requires_grad_(True), t.lengthscale.clone().requires_grad_(True)
    K = tk.Sinc(input_dim=3, variance=v, lengthscale=ls).K(_t(X))
    gv, gl = torch.autograd.grad(torch.sum(K * _t(W)), (v, ls))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jg.variance), rtol=RTOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(jg.lengthscale), rtol=RTOL)


KERNELS = {
    "rbf": lambda: _pair("RBF", 3, 1.2, np.array([0.7, 1.1, 1.6])),
    "matern32": lambda: _pair("Matern32", 3, 0.8, 1.3),
    "matern52": lambda: _pair("Matern52", 3, 1.2, np.array([0.7, 1.1, 1.6])),
    "cosine": lambda: _pair("Cosine", 3, 1.1, 1.4),
    "sinc": lambda: _pair("Sinc", 3, 1.1, 1.4),
    "ratquad": lambda: _pair("RatQuad", 3, 0.9, 1.2, power=1.5),
    "exponential": lambda: _pair("Exponential", 3, 0.9, 1.2),
    "sliced": lambda: _pair("Matern52", 2, 1.2, np.array([0.7, 1.6]), active_dims=(0, 2)),
}


def _combo3(op):
    (j1, t1), (j2, t2) = KERNELS["rbf"](), KERNELS["sliced"]()
    return (j1 + j2, t1 + t2) if op == "add" else (j1 * j2, t1 * t2)


KERNELS["add"] = lambda: _combo3("add")
KERNELS["prod"] = lambda: _combo3("prod")


@pytest.mark.parametrize("name", list(KERNELS))
def test_gradients_X_matches_jax(name, rng):
    j, t = KERNELS[name]()
    X, X2 = rng.uniform(-2, 2, (8, 3)), rng.uniform(-2, 2, (5, 3))
    W, W2 = rng.standard_normal((8, 8)), rng.standard_normal((8, 5))
    np.testing.assert_allclose(t.gradients_X(_t(W), _t(X)).numpy(),
                               np.asarray(j.gradients_X(jnp.asarray(W), jnp.asarray(X))),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(
        t.gradients_X(_t(W2), _t(X), _t(X2)).numpy(),
        np.asarray(j.gradients_X(jnp.asarray(W2), jnp.asarray(X), jnp.asarray(X2))),
        rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("name", [k for k in KERNELS if k != "exponential"])
def test_d2K_dXdX2_diag_matches_jax(name, rng):
    """The prior curvature at coincident inputs: the analytic r -> 0 limit for
    the stationary families, the sum and the product rule for combinations."""
    j, t = KERNELS[name]()
    x = rng.uniform(-2, 2, 3)
    got = t.d2K_dXdX2_diag(_t(x)).numpy()
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, np.asarray(j.d2K_dXdX2_diag(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-12)


def test_d2K_default_is_nested_forward_mode(rng):
    """The base class's default (nested forward-mode differentiation of K)
    agrees with the analytic override where K is smooth in r^2."""
    from gaussian_process_optimization_tpu_torch.kernels.base import Kernel

    _, t = KERNELS["rbf"]()
    x = _t(rng.uniform(-2, 2, 3))
    np.testing.assert_allclose(Kernel.d2K_dXdX2_diag(t, x).numpy(),
                               t.d2K_dXdX2_diag(x).numpy(), rtol=1e-10, atol=1e-12)


def test_exponential_has_no_curvature():
    _, t = KERNELS["exponential"]()
    with pytest.raises(NotImplementedError, match="curvature"):
        t.d2K_dXdX2_diag(torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("name", ["matern52", "sliced", "add", "prod", "ratquad"])
def test_input_sensitivity_matches_jax(name):
    j, t = KERNELS[name]()
    np.testing.assert_allclose(t.input_sensitivity().numpy(),
                               np.asarray(j.input_sensitivity()), rtol=1e-12)
