"""The torch port's ``infer_newX`` against the JAX package's, float64: the
starting rows of every init mode (the 'rand' draws injected from the JAX
package's key), the objective at the start, and the L-BFGS solution per row,
for the point GPLVM (with a NaN entry in one row, and a masked, padded
training set) and for the Bayesian GPLVM (mean and variance of q(x*)). The
reference vmaps one L-BFGS per row; the port runs each row as a lane."""
import jax
import numpy as np
import pytest

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import gplvm as jg
from gaussian_process_optimization_tpu.models import inference_x as jix
from gaussian_process_optimization_tpu_torch.models import gplvm as tg
from gaussian_process_optimization_tpu_torch.models import inference_x as tix
from test_torch_gplvm import Y_OIL, port_gp, port_latent
from torch_threads import one_torch_thread  # noqa: F401

Y_NEW = Y_OIL[::4] + 0.1 * np.random.default_rng(11).standard_normal((8, 5))
Y_NAN = Y_NEW.copy()
Y_NAN[2, 1] = np.nan


@pytest.fixture(scope="module")
def point_pair():
    jm, _ = jg.fit_gplvm(jg.make_gplvm(Y_OIL, 2, kernel=jk.RBF.create(2, ARD=True)), maxiter=15)
    return jm, port_gp(jm)


@pytest.fixture(scope="module")
def bayes_pair():
    jm = jg.BayesianGPLVM.create(Y_OIL, 2, num_inducing=6)
    return jm, port_latent("BayesianGPLVM", jm)


@pytest.mark.parametrize("init", ["L2", "NCC", "rand"])
def test_start_rows_match_jax(init):
    key = jax.random.PRNGKey(4)
    valid = ~np.isnan(Y_NAN)
    want = jix._init_idx(Y_OIL, np.where(valid, Y_NAN, 0.0), init, key, valid=valid)
    if init == "rand":  # the JAX package's draws, injected
        return np.testing.assert_array_equal(
            want, np.asarray(jax.random.randint(key, (8,), 0, 30)))
    got = tix._init_idx(Y_OIL, np.where(valid, Y_NAN, 0.0), init, valid=valid)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("Y", [Y_NEW, Y_NAN], ids=["observed", "nan"])
def test_point_infer_newX_matches_jax(point_pair, Y):
    """Each row's objective at its start (rtol 1e-10) and after L-BFGS: the
    latent rows within 1e-6 of max |x| and the objectives within 1e-8."""
    jm, tm = point_pair
    Xj0, info0 = jix.infer_newX(jm, Y, optimize=False)
    Xt0, tinfo0 = tix.infer_newX(tm, Y, optimize=False)
    np.testing.assert_array_equal(Xt0.numpy(), np.asarray(Xj0))
    np.testing.assert_allclose(tinfo0["objective"].numpy(), np.asarray(info0["objective"]),
                               rtol=1e-10)
    Xj, info = jix.infer_newX(jm, Y, maxiter=50)
    Xt, tinfo = tix.infer_newX(tm, Y, maxiter=50)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=1e-6 * np.abs(Xj).max())
    np.testing.assert_allclose(tinfo["objective"].numpy(), np.asarray(info["objective"]),
                               rtol=1e-8)


def test_point_infer_newX_with_injected_rand_starts(point_pair):
    jm, tm = point_pair
    key = jax.random.PRNGKey(9)
    Xj, _ = jix.infer_newX(jm, Y_NEW, init="rand", key=key, maxiter=30)
    idx = np.asarray(jax.random.randint(key, (8,), 0, 30))
    Xt, _ = tix.infer_newX(tm, Y_NEW, init="rand", init_idx=idx, maxiter=30)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=1e-6 * np.abs(Xj).max())


def test_point_infer_newX_on_a_padded_model_matches_unpadded(point_pair):
    """A masked model (the training rows padded to 40) starts from the real
    rows only and finds the same latents (1e-8)."""
    _, tm = point_pair
    padded = tg.GPRegression.create(tm.X.numpy(), tm.Y.numpy(), kernel=tm.kern,
                                    noise_var=tm.likelihood_variance, max_points=40,
                                    device="cpu")
    a, _ = tix.infer_newX(tm, Y_NAN, maxiter=30)
    b, _ = tix.infer_newX(padded, Y_NAN, maxiter=30)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-8)


def test_uncertain_infer_newX_matches_jax(bayes_pair):
    """q(x*) for the Bayesian GPLVM: the objective at the start (rtol 1e-10)
    and the optimized mean and variance per row (1e-6 relative)."""
    jm, tm = bayes_pair
    Yc = Y_NEW - Y_OIL.mean(0)
    qj0, info0 = jix.infer_newX(jm, Yc, optimize=False)
    qt0, tinfo0 = tix.infer_newX(tm, Yc, optimize=False)
    np.testing.assert_allclose(tinfo0["objective"].numpy(), np.asarray(info0["objective"]),
                               rtol=1e-10)
    qj, info = jix.infer_newX(jm, Yc, maxiter=50)
    qt, tinfo = tix.infer_newX(tm, Yc, maxiter=50)
    np.testing.assert_allclose(qt.mean.numpy(), np.asarray(qj.mean),
                               atol=1e-6 * np.abs(qj.mean).max())
    np.testing.assert_allclose(qt.variance.numpy(), np.asarray(qj.variance), rtol=1e-6)
    np.testing.assert_allclose(tinfo["objective"].numpy(), np.asarray(info["objective"]),
                               rtol=1e-8)


def test_infer_newX_rejects_other_models():
    with pytest.raises(TypeError, match="infer_newX takes"):
        tix.infer_newX(object(), Y_NEW)
