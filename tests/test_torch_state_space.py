"""The port's state-space GP against the JAX package's, in float64 on the
CPU: every spec family's -LML and its gradient for every leaf (rtol 1e-9 and
1e-7), the RTS prediction (rtol 1e-8; the Brownian + linear sum 1e-6, whose
smoother inverts a near-singular predicted covariance), the kernel bridge
``from_kernel``, the Matern forms against the dense GP (exact SDEs), and
``convert.state_space_from_leaves``."""
import jax
import numpy as np
import pytest

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import state_space as jss
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.kernels import (Bias, Matern32, Matern52,
                                                             StandardPeriodic, White)
from gaussian_process_optimization_tpu_torch.models import state_space as tss
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from test_torch_kernel_zoo import _close, jax_leaves, port_grads
from torch_threads import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")


def _data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 5, n))
    return X, np.sin(2 * X) + 0.1 * rng.standard_normal(n)


FAMILIES = {
    "matern12": dict(variance=1.1, lengthscale=0.8),
    "matern32": dict(variance=1.1, lengthscale=0.8),
    "matern52": dict(variance=1.1, lengthscale=0.8),
    "periodic": dict(variance=0.9, period=1.3, lengthscale=0.8),
    "quasiperiodic_matern12": dict(period=1.3, lengthscale=0.8, lengthscale_damp=2.0),
    "quasiperiodic_matern32": dict(period=1.3, lengthscale=0.8, lengthscale_damp=2.0),
    "rbf": dict(variance=1.2, lengthscale=0.9, order=6),
    "matern32+bias+white": dict(family=("matern32", "bias", "white"),
                                variance=[1.0, 0.3, 0.05], lengthscale=[0.8, 1.0, 1.0]),
    "brownian+linear": dict(family=("brownian", "linear"), variance=[0.5, 0.2]),
}


def _models(name, **extra):
    kw = dict(FAMILIES[name])
    fam = kw.pop("family", name)
    X, Y = _data()
    jm = jss.StateSpaceGP.create(X, Y, family=fam, noise_var=0.1, **kw, **extra)
    tm = tss.StateSpaceGP.create(X, Y, family=fam, noise_var=0.1, **kw, **extra, **CPU)
    return jm, tm


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_lml_gradient_and_prediction_match_jax(name):
    jm, tm = _models(name)
    _close(float(tm.log_marginal_likelihood()), float(jm.log_marginal_likelihood()), rtol=1e-9)
    gj = jax_leaves(jax.grad(lambda m: m.log_marginal_likelihood())(jm), "")
    gt = port_grads(tm, lambda m: m.log_marginal_likelihood())
    for path in ("variance", "lengthscale", "noise_variance", "period", "lengthscale_damp"):
        _close(gt[path], gj[path], rtol=1e-7, what=path)
    Xnew = np.linspace(-0.5, 5.5, 9)
    mt, vt = tm.predict(Xnew)
    mj, vj = jm.predict(Xnew)
    rtol = 1e-6 if name == "brownian+linear" else 1e-8
    _close(mt, mj, rtol=rtol)
    _close(vt, vj, rtol=rtol)


def test_from_kernel_bridge_matches_jax():
    X, Y = _data()
    jkern = (jk.Matern32.create(1, variance=0.8, lengthscale=1.2)
             + jk.StandardPeriodic.create(1, variance=1.1, period=1.4, lengthscale=0.9)
             * jk.Matern32.create(1, lengthscale=2.5) + jk.Bias.create(1, variance=0.2))
    tkern = (Matern32.create(1, variance=0.8, lengthscale=1.2, **CPU)
             + StandardPeriodic.create(1, variance=1.1, period=1.4, lengthscale=0.9, **CPU)
             * Matern32.create(1, lengthscale=2.5, **CPU) + Bias.create(1, variance=0.2, **CPU))
    jm = jss.from_kernel(jkern, X, Y, noise_var=0.1)
    tm = tss.from_kernel(tkern, X, Y, noise_var=0.1, **CPU)
    assert tm.family == jm.family
    _close(float(tm.log_marginal_likelihood()), float(jm.log_marginal_likelihood()), rtol=1e-9)
    with pytest.raises(ValueError, match="no state-space"):
        tss.from_kernel(White.create(1, **CPU) * Bias.create(1, **CPU), X, Y, **CPU)


@pytest.mark.parametrize("cls,fam", [(Matern32, "matern32"), (Matern52, "matern52")])
def test_matern_forms_equal_the_dense_gp(cls, fam):
    X, Y = _data()
    tm = tss.StateSpaceGP.create(X, Y, family=fam, variance=1.1, lengthscale=0.8,
                                 noise_var=0.1, **CPU)
    dense = GPRegression.create(X[:, None], Y, kernel=cls.create(1, variance=1.1,
                                                                 lengthscale=0.8, **CPU),
                                noise_var=0.1 - 1e-8, **CPU)
    _close(float(tm.log_marginal_likelihood()), float(dense.log_marginal_likelihood()),
           rtol=1e-9)


def test_state_space_carried_by_convert():
    jm, _ = _models("quasiperiodic_matern32")
    tm = convert.state_space_from_leaves(jax_leaves(jm, ""), family=jm.family, order=jm.order,
                                         **CPU)
    _close(float(tm.log_marginal_likelihood()), float(jm.log_marginal_likelihood()), rtol=1e-10)


def test_one_dimensional_only():
    with pytest.raises(ValueError, match="1-D"):
        tss.StateSpaceGP.create(np.zeros((5, 2)), np.zeros(5), **CPU)
    with pytest.raises(ValueError, match="t=0"):
        tss.StateSpaceGP.create(np.array([-1.0, 0.0]), np.zeros(2), family="brownian", **CPU)
