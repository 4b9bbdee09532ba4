"""The port's Kronecker grid GP against the JAX package's and against the
port's own dense GP on the same points, in float64 on the CPU: the -LML, its
gradient for every leaf (through ``eigh``), and the prediction (rtol 1e-9
against JAX, 1e-8 against the dense GP). ``convert.grid_from_leaves`` carries
the JAX model over."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models.gp_grid import GPGridRegression as JGrid
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.kernels import RBF, GridRBF, Matern32
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.gp_grid import GPGridRegression
from test_torch_kernel_zoo import _close, jax_leaves, port_grads, spec_of
from torch_threads import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")


def _grid(n1=9, n2=7, seed=0):
    rng = np.random.default_rng(seed)
    a1, a2 = np.linspace(0, 3, n1), np.linspace(-1, 1, n2)
    A1, A2 = np.meshgrid(a1, a2, indexing="ij")
    Y = np.sin(2 * A1) * np.cos(A2) + 0.05 * rng.standard_normal(A1.shape)
    return a1, a2, Y


def _models():
    a1, a2, Y = _grid()
    jm = JGrid.create([a1, a2], Y, [jk.GridRBF.create(1, variance=1.2, lengthscale=0.7),
                                    jk.Matern32.create(1, variance=0.9, lengthscale=0.6)],
                      noise_var=0.05)
    tm = GPGridRegression.create([a1, a2], Y, [GridRBF.create(1, variance=1.2, lengthscale=0.7,
                                                              **CPU),
                                               Matern32.create(1, variance=0.9, lengthscale=0.6,
                                                               **CPU)],
                                 noise_var=0.05, **CPU)
    return jm, tm


def test_grid_lml_gradient_and_predict_match_jax():
    jm, tm = _models()
    _close(float(tm.log_marginal_likelihood()), float(jm.log_marginal_likelihood()), rtol=1e-9)
    gj = jax_leaves(jax.grad(lambda m: m.log_marginal_likelihood())(jm), "")
    gt = port_grads(tm, lambda m: m.log_marginal_likelihood())
    for path in ("kerns.0.variance", "kerns.0.lengthscale", "kerns.1.variance",
                 "kerns.1.lengthscale", "likelihood_variance"):
        _close(gt[path], gj[path], rtol=1e-7, what=path)
    Xnew = np.column_stack([np.random.default_rng(1).uniform(0, 3, 6),
                            np.random.default_rng(2).uniform(-1, 1, 6)])
    mt, vt = tm.predict(Xnew)
    mj, vj = jm.predict(jnp.asarray(Xnew))
    _close(mt, mj, rtol=1e-9)
    _close(vt, vj, rtol=1e-9)


def test_grid_equals_the_dense_gp():
    """Same model, other algebra: the dense GP with the product kernel on
    the grid's points."""
    _, tm = _models()
    a1, a2, Y = _grid()
    A1, A2 = np.meshgrid(a1, a2, indexing="ij")
    X = np.column_stack([A1.ravel(), A2.ravel()])
    kern = (RBF.create(1, variance=1.2, lengthscale=0.7, active_dims=[0], **CPU)
            * Matern32.create(1, variance=0.9, lengthscale=0.6, active_dims=[1], **CPU))
    dense = GPRegression.create(X, Y.reshape(-1, 1), kernel=kern, noise_var=0.05, **CPU)
    _close(float(tm.log_marginal_likelihood()), float(dense.log_marginal_likelihood()),
           rtol=1e-8)
    Xnew = np.column_stack([np.linspace(0.1, 2.9, 5), np.linspace(-0.9, 0.9, 5)])
    mt, vt = tm.predict(Xnew)
    md, vd = dense.predict(torch.tensor(Xnew))
    _close(mt, md, rtol=1e-8)
    _close(vt, vd, rtol=1e-8)


def test_grid_carried_by_convert():
    jm, _ = _models()
    tm = convert.grid_from_leaves(jax_leaves(jm, ""), [spec_of(k) for k in jm.kerns], **CPU)
    _close(float(tm.log_marginal_likelihood()), float(jm.log_marginal_likelihood()), rtol=1e-10)
