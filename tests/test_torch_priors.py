"""The torch port's priors against the JAX package, in float64: each prior's
log-density and its gradient, ``log_prior`` over a mirrored tree, and the fit
objective -(LML + log prior) with the transforms' log-Jacobians, on a model
whose kernel is an ``Add`` (a prior keyed by a field name reaches every part);
``checkgrad``, the one-shot ``fit`` and ``make_packer``'s ``train_only``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu.ops import lbfgs as jlbfgs
from gaussian_process_optimization_tpu.utils import priors as jpr
from gaussian_process_optimization_tpu.utils.transforms import Logistic as JLogistic
from gaussian_process_optimization_tpu_torch import kernels as tk
from gaussian_process_optimization_tpu_torch.models import fit as tfit
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.parameters import (
    bounded_noise_transform, make_packer)
from gaussian_process_optimization_tpu_torch.utils import priors as tpr
from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves
from torch_threads import one_torch_thread  # noqa: F401

PRIORS = {
    "GaussianPrior": dict(mu=0.4, sigma=1.3),
    "UniformPrior": dict(lower=0.1, upper=3.5),
    "LogGaussianPrior": dict(mu=0.2, sigma=0.8),
    "GammaPrior": dict(a=2.5, b=1.5),
    "InverseGammaPrior": dict(a=3.0, b=2.0),
    "ExponentialPrior": dict(l=1.7),
    "StudentTPrior": dict(mu=0.3, sigma=1.2, nu=5.0),
    "HalfTPrior": dict(A=1.5, nu=3.0),
}


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=torch.float64, **kw)


@pytest.mark.parametrize("name", list(PRIORS))
def test_lnpdf_and_gradient_match_jax(name, rng):
    """Elementwise log-density at 12 positive points and its derivative, 1e-9."""
    x = rng.uniform(0.2, 3.0, 12)
    jp, tp = getattr(jpr, name)(**PRIORS[name]), getattr(tpr, name)(**PRIORS[name])
    xr = _t(x, requires_grad=True)
    val = tp.lnpdf(xr)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jp.lnpdf(jnp.asarray(x))),
                               rtol=1e-9)
    if name != "UniformPrior":  # flat inside its support
        (g,) = torch.autograd.grad(val.sum(), xr)
        jg = jax.grad(lambda v: jnp.sum(jp.lnpdf(v)))(jnp.asarray(x))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9)


@pytest.mark.parametrize("name", ["UniformPrior", "HalfTPrior"])
def test_outside_the_support_is_minus_infinity(name):
    tp = getattr(tpr, name)(**PRIORS[name])
    assert float(tp.lnpdf(_t([-0.5]))[0]) == -np.inf


def test_gamma_from_EV():
    j, t = jpr.GammaPrior.from_EV(2.0, 0.5), tpr.GammaPrior.from_EV(2.0, 0.5)
    assert (float(t.a), float(t.b)) == pytest.approx((float(j.a), float(j.b)), rel=1e-15)


def test_log_prior_over_a_mirrored_tree(rng):
    """A tree of priors mirroring a tree of parameters leaf for leaf, None
    where there is no prior; a count mismatch raises as the reference does."""
    v, ls = rng.uniform(0.5, 2.0), rng.uniform(0.5, 2.0, 3)
    tparams = {"variance": _t(v), "lengthscale": _t(ls), "mask": None}
    jparams = {"variance": jnp.asarray(v), "lengthscale": jnp.asarray(ls), "mask": None}
    kw = dict(a=2.0, b=1.0)
    tpri = {"variance": tpr.GammaPrior(**kw), "lengthscale": tpr.GaussianPrior(1.0, 0.5),
            "mask": None}
    jpri = {"variance": jpr.GammaPrior(**kw), "lengthscale": jpr.GaussianPrior(1.0, 0.5),
            "mask": None}
    np.testing.assert_allclose(float(tpr.log_prior(tpri, tparams)),
                               float(jpr.log_prior(jpri, jparams)), rtol=1e-12)
    assert float(tpr.log_prior(None, tparams)) == 0.0
    with pytest.raises(ValueError, match="leaf-for-leaf"):
        tpr.log_prior({"variance": tpr.GammaPrior(**kw)}, tparams)
    with pytest.raises(ValueError, match="None parameter slot"):
        tpr.log_prior({"variance": None, "lengthscale": None, "mask": tpr.GammaPrior(**kw)},
                      tparams)


def _models(rng, n=14, max_points=16):
    X, Y = rng.uniform(-2, 2, (n, 3)), rng.standard_normal((n, 1))
    ls = np.array([0.7, 1.4, 0.9])
    jkern = (jk.Matern52(input_dim=3, variance=jnp.asarray(1.3), lengthscale=jnp.asarray(ls))
             + jk.RBF(input_dim=2, active_dims=(0, 2), variance=jnp.asarray(0.6),
                      lengthscale=jnp.asarray(0.8)))
    tkern = (tk.Matern52(input_dim=3, variance=_t(1.3), lengthscale=_t(ls))
             + tk.RBF(input_dim=2, active_dims=(0, 2), variance=_t(0.6), lengthscale=_t(0.8)))
    jm = JGP.create(X, Y, kernel=jkern, noise_var=0.2, max_points=max_points)
    tm = GPRegression.create(X, Y, kernel=tkern, noise_var=0.2, max_points=max_points,
                             device="cpu")
    return jm, tm


def _prior_sets():
    return {
        "gamma_on_kernel": (
            {"lengthscale": jpr.GammaPrior(2.0, 1.0), "variance": jpr.GammaPrior(2.0, 2.0)},
            {"lengthscale": tpr.GammaPrior(2.0, 1.0), "variance": tpr.GammaPrior(2.0, 2.0)}),
        "mixed_with_noise": (
            {"lengthscale": jpr.LogGaussianPrior(0.1, 0.7), "variance": jpr.HalfTPrior(2.0, 4.0),
             "likelihood_variance": jpr.InverseGammaPrior(3.0, 1.0)},
            {"lengthscale": tpr.LogGaussianPrior(0.1, 0.7), "variance": tpr.HalfTPrior(2.0, 4.0),
             "likelihood_variance": tpr.InverseGammaPrior(3.0, 1.0)}),
    }


@pytest.mark.parametrize("packing", ["free", "fixed_noise", "bounded_noise"])
@pytest.mark.parametrize("which", ["gamma_on_kernel", "mixed_with_noise"])
def test_objective_with_priors_matches_jax(which, packing, rng):
    """-(LML + log prior) and its gradient, 1e-8: the prior on the constrained
    value plus the transform's log-Jacobian for every leaf that is not fixed
    (softplus, or the bounded Logistic on the noise); three lanes at once."""
    jm, tm = _models(rng)
    jpri, tpri = _prior_sets()[which]
    if packing == "fixed_noise":
        jkw, tkw = dict(fix=("likelihood_variance",)), dict(fix=("likelihood_variance",))
    elif packing == "bounded_noise":
        jkw = dict(transform_overrides={"likelihood_variance": JLogistic(1e-9, 1e6)})
        tkw = dict(transform_overrides={"likelihood_variance": bounded_noise_transform()})
    else:
        jkw, tkw = {}, {}
    jp, tp = jmake_packer(jm, **jkw), make_packer(tm, **tkw)
    jobj, tobj = jfit.make_objective(jp, priors=jpri), tfit.make_objective(tp, priors=tpri)
    U = tp.pack(tm)[None] + _t(rng.normal(0, 0.3, (3, tp.num_free)))
    Ur = U.clone().requires_grad_(True)
    f = tobj(Ur, tm)
    assert f.shape == (3,)
    (g,) = torch.autograd.grad(f.sum(), Ur)
    plain = tfit.make_objective(tp)(U, tm)
    assert not np.allclose(plain.numpy(), f.detach().numpy())  # the priors are in
    for b in range(3):
        jf, jg = jax.value_and_grad(lambda u: jobj(u, jm))(jnp.asarray(U[b].numpy()))
        np.testing.assert_allclose(float(f[b].detach()), float(jf), rtol=1e-8)
        np.testing.assert_allclose(g[b].numpy(), np.asarray(jg), rtol=1e-8, atol=1e-10)


def test_checkgrad_matches_jax(rng):
    jm, tm = _models(rng)
    jpri, tpri = _prior_sets()["gamma_on_kernel"]
    assert tfit.checkgrad(tm, priors=tpri) and jfit.checkgrad(jm, priors=jpri)
    assert tfit.checkgrad(tm, fix=("likelihood_variance",))


def test_one_shot_fit_with_priors_matches_jax(rng, monkeypatch):
    """``fit`` (3 restarts, 6 L-BFGS steps, history 5, max_ls 6) from injected
    starts: the fitted leaves of the JAX L-BFGS run from the same starts, 1e-6."""
    jm, tm = _models(rng)
    jpri, tpri = _prior_sets()["gamma_on_kernel"]
    jp = jmake_packer(jm)
    u0 = np.asarray(jp.pack(jm))
    z = rng.standard_normal((2, u0.shape[0]))
    starts = np.vstack([u0, np.asarray(jax.vmap(jp.map_restart)(jnp.asarray(z)))])
    jobj = jfit.make_objective(jp, priors=jpri)
    res = jax.vmap(lambda u: jlbfgs.minimize(lambda uu: jobj(uu, jm), u, maxiter=6, tol=1e-5,
                                             history=5, max_ls=6))(jnp.asarray(starts))
    jfitted = jp.unpack(res.x[jnp.argmin(jnp.where(jnp.isfinite(res.f), res.f, jnp.inf))],
                        reference=jm)
    monkeypatch.setattr(tfit.Fitter, "draw_starts",
                        lambda self, model, generator=None: _t(starts))
    fitted, tres = tfit.fit(tm, num_restarts=3, maxiter=6, priors=tpri, history=5, max_ls=6)
    np.testing.assert_allclose(tres.f.numpy(), np.asarray(res.f), rtol=1e-7)
    for (_, a), b in zip(named_leaves(fitted.kern), jax.tree_util.tree_leaves(jfitted.kern)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_train_only_matches_jax(rng):
    """``train_only=("lengthscale",)`` frees both parts' lengthscales and
    nothing else."""
    jm, tm = _models(rng)
    jp, tp = jmake_packer(jm, train_only=("lengthscale",)), make_packer(
        tm, train_only=("lengthscale",))
    assert tp.num_free == jp.num_free == 4
    np.testing.assert_allclose(tp.pack(tm).numpy(), np.asarray(jp.pack(jm)), rtol=1e-13)
    free = [p for (p, _), fx in zip(named_leaves(tm), tp.fixed) if not fx]
    assert free == ["kern.parts.0.lengthscale", "kern.parts.1.lengthscale"]
