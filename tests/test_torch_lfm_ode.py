"""The port's Faddeeva function, latent-force, ODE and integral kernels against
the JAX package's, in float64 on the CPU.

``wofz`` and ``cerf`` against the JAX package's and ``scipy.special`` (rtol
1e-10 against JAX: the same Weideman approximation), and the custom
derivative of ``wofz`` against autograd through the polynomial. Each kernel
through ``test_torch_kernel_zoo.check_kernel`` (K, Kdiag, K(X, X2), every
leaf's gradient of sum(W * K), rtol 1e-8) and ``check_lanes`` (rtol 1e-12).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.ops import special as jspecial
from gaussian_process_optimization_tpu_torch.ops import special
from test_torch_kernel_zoo import _close, check_kernel, check_lanes, port_of
from torch_threads import one_torch_thread  # noqa: F401


def _points(rng, n=200):
    return rng.uniform(-6, 6, n) + 1j * rng.uniform(-6, 6, n)


def test_wofz_and_cerf_match_jax_and_scipy():
    rng = np.random.default_rng(0)
    z = _points(rng)
    upper = z.real + 1j * np.abs(z.imag)
    zt = torch.tensor(upper)
    got = special.wofz(zt).numpy()
    _close(got.real, np.asarray(jspecial.wofz(jnp.asarray(upper))).real, rtol=1e-10)
    _close(got.imag, np.asarray(jspecial.wofz(jnp.asarray(upper))).imag, rtol=1e-10)
    np.testing.assert_allclose(got, scipy.special.wofz(upper), rtol=1e-11, atol=1e-13)
    small = z / 3.0  # erf grows as exp(-z^2): compare where it stays moderate
    e = special.cerf(torch.tensor(small)).numpy()
    ej = np.asarray(jspecial.cerf(jnp.asarray(small)))
    _close(e.real, ej.real, rtol=1e-10)
    _close(e.imag, ej.imag, rtol=1e-10)
    np.testing.assert_allclose(e, scipy.special.erf(small), rtol=1e-9, atol=1e-11)


def test_wofz_derivative_matches_the_polynomials():
    """The closed-form pullback of w against autograd through the Weideman
    polynomial itself."""
    rng = np.random.default_rng(1)
    z = rng.uniform(-4, 4, 50) + 1j * rng.uniform(0, 4, 50)
    c = torch.tensor(rng.standard_normal(50) + 1j * rng.standard_normal(50))
    za = torch.tensor(z, requires_grad=True)
    (g1,) = torch.autograd.grad((special.wofz(za) * c).real.sum(), za)
    zb = torch.tensor(z, requires_grad=True)
    (g2,) = torch.autograd.grad((special._wofz_value(zb) * c).real.sum(), zb)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-10, atol=1e-12)


def test_complex_dtype_follows_the_real_one():
    assert special.wofz(torch.tensor([0.5], dtype=torch.float32)).dtype == torch.complex64
    assert special.wofz(torch.tensor([0.5], dtype=torch.float64)).dtype == torch.complex128


def _lfm_X(rng, outputs, rank, n=9):
    return np.column_stack([rng.uniform(0.0, 3.0, n), rng.integers(0, outputs + rank, n)])


# name -> (JAX kernel, inputs (rng -> X))
KERNELS = {
    "EQ_ODE1": (lambda: jk.EQ_ODE1.create(output_dim=2, rank=2, W=[[0.8, 0.3], [1.2, -0.5]],
                                          lengthscale=[0.8, 1.2], decay=[0.5, 1.5]),
                lambda rng: _lfm_X(rng, 2, 2)),
    "EQ_ODE1_large_nu": (lambda: jk.EQ_ODE1.create(output_dim=2, rank=1, W=[[1.0], [0.7]],
                                                   lengthscale=[5.0], decay=[4.0, 10.0]),
                         lambda rng: _lfm_X(rng, 2, 1)),
    "EQ_ODE2": (lambda: jk.EQ_ODE2.create(output_dim=2, rank=2, W=[[0.9, 0.2], [1.1, -0.4]],
                                          lengthscale=[0.8, 1.3], C=[0.5, 3.0], B=[2.0, 1.0]),
                lambda rng: _lfm_X(rng, 2, 2)),
    "ODE_UY": (lambda: jk.ODE_UY.create(variance_U=1.2, variance_Y=0.9, lengthscale_U=0.7,
                                        lengthscale_Y=1.3),
               lambda rng: np.column_stack([rng.uniform(0, 3, 8), rng.integers(0, 2, 8)])),
    "ODE_UYC": (lambda: jk.ODE_UYC.create(variance_U=1.2, variance_Y=0.9, lengthscale_U=0.7,
                                          lengthscale_Y=1.3, ubias=0.4),
                lambda rng: np.column_stack([rng.uniform(0, 3, 8), rng.integers(0, 2, 8)])),
    "ODE_t": (lambda: jk.ODE_t.create(variance_Yt=1.4, lengthscale_Yt=0.8, ubias=0.3),
              lambda rng: np.column_stack([rng.uniform(0, 3, 8), rng.integers(0, 2, 8)])),
    "ODE_st": (lambda: jk.ODE_st.create(a=0.6, b=1.1, c=0.8),
               lambda rng: np.column_stack([rng.uniform(0, 2, 8), rng.uniform(-1, 1, 8),
                                            rng.integers(0, 2, 8)])),
    "Integral": (lambda: jk.Integral.create(variances=1.4, lengthscale=0.8),
                 lambda rng: rng.uniform(0.1, 2.0, (7, 1))),
    "IntegralLimits": (lambda: jk.IntegralLimits.create(variances=1.2, lengthscale=0.9),
                       lambda rng: np.column_stack([rng.uniform(1.0, 2.0, 7),
                                                    rng.uniform(0.0, 1.0, 7)])),
    "MultidimensionalIntegralLimits": (
        lambda: jk.MultidimensionalIntegralLimits.create(4, variances=1.1,
                                                         lengthscale=[0.8, 1.1]),
        lambda rng: np.column_stack([rng.uniform(1.0, 2.0, 7), rng.uniform(0.0, 1.0, 7),
                                     rng.uniform(1.0, 2.0, 7), rng.uniform(0.0, 1.0, 7)])),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matches_jax(name):
    make, make_X = KERNELS[name]
    rng = np.random.default_rng(0)
    X, X2 = make_X(rng), make_X(rng)[:5]
    tkern = check_kernel(make(), X, X2)
    check_lanes(tkern, X)


def test_eq_ode2_per_force_diagonal_matches_jax():
    make, make_X = KERNELS["EQ_ODE2"]
    jkern = make()
    X = make_X(np.random.default_rng(2))
    got = port_of(jkern).Kdiag_per_force(torch.tensor(X)).numpy()
    _close(got, jkern.Kdiag_per_force(jnp.asarray(X)))
    _close(got.sum(-1)[X[:, 1] < 2], np.diag(np.asarray(jkern.K(jnp.asarray(X))))[X[:, 1] < 2])


def test_eq_ode2_float32_error_is_the_references():
    """EQ_ODE2 in float32 (complex64) against float64: the port's error is
    within 4x the JAX package's own float32 error at the same inputs."""
    import jax

    make, make_X = KERNELS["EQ_ODE2"]
    jkern = make()
    X = make_X(np.random.default_rng(3))
    K64 = np.asarray(jkern.K(jnp.asarray(X)))
    with jax.enable_x64(False):
        j32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jkern)
        Kj32 = np.asarray(j32.K(jnp.asarray(X, jnp.float32)), dtype=float)
    tk = port_of(jkern)
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    Kt32 = tree_map(lambda t: t.float(), tk).K(torch.tensor(X, dtype=torch.float32))
    scale = np.abs(K64).max()
    err_j = np.abs(Kj32 - K64).max() / scale
    err_t = np.abs(Kt32.double().numpy() - K64).max() / scale
    print(f"EQ_ODE2 K float32 vs float64, max rel: port {err_t:.3e}, JAX package {err_j:.3e}")
    assert Kt32.dtype == torch.float32
    assert err_t <= 4 * max(err_j, 1e-7)
