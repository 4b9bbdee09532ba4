"""The port's state-space GP against the JAX package's, in float64 on the
CPU: every spec family's -LML and its gradient for every leaf (rtol 1e-9 and
1e-7), the RTS prediction (rtol 1e-8; the Brownian + linear sum 1e-6, whose
smoother inverts a near-singular predicted covariance), the kernel bridge
``from_kernel``, the Matern forms against the dense GP (exact SDEs), and
``convert.state_space_from_leaves``; the float32 and float64 matrix
exponential against ``jax.scipy.linalg.expm`` and the float32 -LML gap of
``state_space_example`` against the JAX package's."""
import jax
import numpy as np
import pytest
import torch

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


# ------------------------------------------------ the matrix exponential (C18)
# ||A||_1 of one case in each Pade branch of each dtype (float32: 3 / 5 / 7
# below 0.426 / 1.88 / 3.93; float64: 3 / 5 / 7 / 9 / 13 below 0.015 / 0.254 /
# 0.950 / 2.10 / 5.37) and one that needs squarings in both
EXPM_NORMS = (0.01, 0.1, 0.5, 1.0, 3.0, 50.0)


def _expm_case(norm, dtype, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((6, 6)) - 2.0 * np.eye(6)  # stable, as F dt is
    return (G / np.abs(G).sum(0).max() * norm).astype(dtype)


def _expm_pair(A):
    """(port, jax.scipy.linalg.expm) of A, in A's dtype."""
    import jax.numpy as jnp
    from jax.scipy.linalg import expm

    with jax.enable_x64(A.dtype == np.float64):
        want = np.asarray(jax.jit(expm)(jnp.asarray(A)))
    got = tss._expm(torch.as_tensor(A)).numpy()
    assert got.dtype == want.dtype == A.dtype
    return got, want


@pytest.mark.parametrize("norm", EXPM_NORMS)
def test_expm_float32_is_the_references_pade(norm):
    """Within 4 float32 ulps of the largest entry, times 2 for each squaring
    (a squaring at most doubles a relative difference)."""
    A = _expm_case(norm, np.float32)
    got, want = _expm_pair(A)
    squarings = max(0.0, np.floor(np.log2(np.abs(A).sum(0).max() / 3.925724783138660)))
    tol = 4 * 2.0 ** squarings * np.finfo(np.float32).eps * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("norm", EXPM_NORMS)
def test_expm_float64_is_the_references_pade(norm):
    got, want = _expm_pair(_expm_case(norm, np.float64))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_expm_takes_each_matrix_own_branch_in_a_batch():
    """A batch of every norm: each matrix's exponential is the reference's
    within the unbatched tolerances (a branch taken from another matrix's norm
    would miss them by the approximant's error), and more than 16 squarings
    give NaN, as in the reference."""
    for dtype, rel in ((np.float32, 4 * np.finfo(np.float32).eps), (np.float64, 1e-12)):
        A = np.stack([_expm_case(n, dtype, seed=i) for i, n in enumerate(EXPM_NORMS)])
        batch = tss._expm(torch.as_tensor(A)).numpy()
        for i in range(len(A)):
            _, want = _expm_pair(A[i])
            squarings = max(0.0, np.floor(np.log2(np.abs(A[i]).sum(0).max() / 3.925724783138660)))
            tol = rel * (2.0 ** squarings if dtype == np.float32 else 1.0)
            assert np.abs(batch[i] - want).max() <= tol * np.abs(want).max()
    huge = tss._expm(torch.full((2, 2), 1e7, dtype=torch.float64))
    assert bool(torch.isnan(huge).all())


def test_state_space_example_f32_gap_is_the_references():
    """``state_space_example``'s float32 -LML against its float64, in both
    packages (each float64 model, every float leaf scaled by s, cast to
    float32), the mean gap over four s: the port's within 1.5x of the JAX
    package's now that both take the same float32 exponential."""
    from examples.gallery import state_space as jgallery
    from gaussian_process_optimization_tpu_torch.examples.gallery import state_space as tgallery
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    ref = jgallery.state_space_example(optimize=False, plot=False)
    twin = tgallery.state_space_example(optimize=False, plot=False, device="cpu",
                                        dtype=torch.float64)
    lml = jax.jit(lambda m: m.log_marginal_likelihood())

    def scaled(tree, s, dtype, tmap):
        def leaf(a):
            if isinstance(a, torch.Tensor):
                return (a * s).to(dtype) if a.is_floating_point() else a
            if hasattr(a, "dtype") and np.issubdtype(a.dtype, np.floating):
                return (a * s).astype(dtype)
            return a
        return tmap(leaf, tree)

    jax_gaps, port_gaps = [], []
    for s in (1.0, 1.01, 1.02, 1.03):
        j64 = float(lml(scaled(ref, s, np.float64, jax.tree_util.tree_map)))
        with jax.enable_x64(False):
            j32 = float(lml(scaled(ref, s, np.float32, jax.tree_util.tree_map)))
        jax_gaps.append(abs(j32 - j64) / abs(j64))
        t64 = float(scaled(twin, s, torch.float64, tree_map).log_marginal_likelihood())
        t32 = float(scaled(twin, s, torch.float32, tree_map).log_marginal_likelihood())
        port_gaps.append(abs(t32 - t64) / abs(t64))
    print(f"state_space_example f32 -LML rel gap: port {np.mean(port_gaps):.3e} "
          f"jax {np.mean(jax_gaps):.3e}")
    assert np.mean(port_gaps) <= 1.5 * np.mean(jax_gaps)
