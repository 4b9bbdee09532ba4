"""The torch port's warped GPs (``models/warped.py``, ``models/warped_bo_model.py``)
against the JAX package, in float64: the tanh warp and its Newton inverse, the
warped and input-warped LMLs and their gradients in the packed parameters (with
a lane axis, on padded data), prediction (median, Gauss-Hermite mean,
quantiles, predictive density), the log and identity warps, and the BO
wrappers' refits with their parameter carry (after
``tests/test_models_extra.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.bo import objectives
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.bo.space import bounds_to_space
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import warped as jw
from gaussian_process_optimization_tpu.models import warped_bo_model as jwb
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.kernels.stationary import RBF, Matern52
from gaussian_process_optimization_tpu_torch.models import warped as tw
from gaussian_process_optimization_tpu_torch.models import warped_bo_model as twb
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(15, 1))
    return X, np.asarray(objectives.forrester(X))


def _warp_pair():
    d, a, b, c = 1.3, np.array([0.6, 1.1]), np.array([0.8, 1.7]), np.array([-0.2, 0.4])
    return (jw.TanhWarp(d=jnp.asarray(d), a=jnp.asarray(a), b=jnp.asarray(b), c=jnp.asarray(c)),
            tw.TanhWarp(d=torch.tensor(d, dtype=torch.float64), a=torch.tensor(a),
                        b=torch.tensor(b), c=torch.tensor(c)))


def test_tanh_warp_matches_jax():
    jwarp, twarp = _warp_pair()
    y = np.linspace(-3, 3, 13)
    for name in ("f", "fgrad_y", "f_inv"):
        np.testing.assert_allclose(getattr(twarp, name)(torch.tensor(y)).numpy(),
                                   np.asarray(getattr(jwarp, name)(jnp.asarray(y))), rtol=1e-12)
    np.testing.assert_allclose(twarp.f_inv(twarp.f(torch.tensor(y))).numpy(), y, atol=1e-8)
    default = tw.TanhWarp.create(2, device="cpu")
    assert default.a.shape == (2,) and float(default.d) == 1.0 and float(default.c.abs().sum()) == 0


def _packed_check(jm, tm, rtol_grad=1e-8):
    """-LML at two lanes of packed parameters (rel 1e-10) and its gradient."""
    jp, tp = jmake_packer(jm), make_packer(tm)
    assert tp.num_free == jp.num_free and tp.fixed == jp.fixed
    jobj, tobj = jfit.make_objective(jp), make_objective(tp)
    u0 = np.asarray(jp.pack(jm))
    np.testing.assert_allclose(tp.pack(tm).numpy(), u0, rtol=1e-13)
    U = np.stack([u0, u0 + 0.1 * np.cos(np.arange(u0.shape[0]))])
    Ut = torch.tensor(U, requires_grad=True)
    f = tobj(Ut, tm)
    (g,) = torch.autograd.grad(f.sum(), Ut)
    jvg = jax.jit(jax.value_and_grad(jobj))
    for b in range(2):
        val, grad = jvg(jnp.asarray(U[b]), jm)
        assert abs(float(f[b]) - float(val)) <= 1e-10 * abs(float(val))
        np.testing.assert_allclose(g[b].numpy(), np.asarray(grad), rtol=rtol_grad,
                                   atol=rtol_grad * np.abs(np.asarray(grad)).max())


def _warped_pair(data, **kw):
    X, Y = data
    return (jw.WarpedGP.create(X, Y, kernel=jk.RBF.create(1), noise_var=0.1, max_points=16, **kw),
            tw.WarpedGP.create(X, Y, kernel=RBF.create(1, device="cpu"), noise_var=0.1,
                               max_points=16, device="cpu", **kw))


def test_warped_lml_and_gradient_match_jax(data):
    jm, tm = _warped_pair(data, warping_terms=2)
    _packed_check(jm, tm)


def test_warped_prediction_matches_jax(data):
    X, Y = data
    jm, tm = _warped_pair(data, warping_terms=2)
    Xs = np.linspace(0, 1, 6)[:, None]
    jpredict = jax.jit(lambda m, X, median: m.predict(X, median=median), static_argnums=2)
    for median in (False, True):
        for got, want in zip(tm.predict(torch.tensor(Xs), median=median),
                             jpredict(jm, jnp.asarray(Xs), median)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
    for got, want in zip(tm.predict_quantiles(torch.tensor(Xs)),
                         jax.jit(lambda m, X: m.predict_quantiles(X))(jm, jnp.asarray(Xs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    want = jax.jit(lambda m, X, Y: m.log_predictive_density(X, Y))(jm, jnp.asarray(X[:4]),
                                                                   jnp.asarray(Y[:4]))
    np.testing.assert_allclose(tm.log_predictive_density(torch.tensor(X[:4]), Y[:4]).numpy(),
                               np.asarray(want), rtol=1e-9)


def test_warp_tail_identity_and_log(data):
    """(test_models_extra.py::test_warp_tail_identity_and_log): the identity
    warp is the exact GP; the log warp is a GP on log Y plus sum log(1 / y);
    padding stays finite under the log warp."""
    X, Y = data
    m_id = tw.WarpedGP.create(X, Y, kernel=RBF.create(1, device="cpu"), noise_var=0.1,
                              warping_function=tw.IdentityWarp(), device="cpu")
    plain = GPRegression.create(X, Y, kernel=RBF.create(1, device="cpu"), noise_var=0.1,
                                device="cpu")
    assert float(m_id.log_marginal_likelihood()) == pytest.approx(
        float(plain.log_marginal_likelihood()), rel=1e-12)
    Ypos = np.abs(Y) + 1.0
    m_log = tw.WarpedGP.create(X, Ypos, kernel=RBF.create(1, device="cpu"), noise_var=0.1,
                               warping_function=tw.LogWarp(), max_points=16, device="cpu")
    on_log = GPRegression.create(X, np.log(Ypos), kernel=RBF.create(1, device="cpu"),
                                 noise_var=0.1, device="cpu")
    assert float(m_log.log_marginal_likelihood()) == pytest.approx(
        float(on_log.log_marginal_likelihood()) - float(np.sum(np.log(Ypos))), rel=1e-12)
    med, _ = m_log.predict(torch.tensor(X[:5]), median=True)
    mu_l, _ = on_log.predict(torch.tensor(X[:5]))
    np.testing.assert_allclose(med.numpy(), np.exp(mu_l.numpy()), rtol=1e-10)


def _input_warped_pair(dims=(0, 1)):
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 2, (14, 3))
    Y = np.sin(3 * X[:, :1]) + X[:, 2:] ** 2
    ls = np.array([0.7, 1.1, 0.9])
    jm = jw.InputWarpedGP.create(X, Y, kernel=jk.Matern52.create(3, lengthscale=ls, ARD=True),
                                 noise_var=0.05, warping_indices=dims, max_points=16)
    tm = tw.InputWarpedGP.create(X, Y, kernel=Matern52.create(3, lengthscale=ls, ARD=True,
                                                              device="cpu"),
                                 noise_var=0.05, warping_indices=dims, max_points=16,
                                 device="cpu")
    jm = jm.__class__(gp=jm.gp, warp=jm.warp.__class__(
        a=jnp.asarray([0.7, 1.6]), b=jnp.asarray([1.4, 0.8]), lo=jm.warp.lo, hi=jm.warp.hi,
        dims=jm.warp.dims))
    tm = tw.InputWarpedGP(gp=tm.gp, warp=tw.KumarWarp(
        a=torch.tensor([0.7, 1.6], dtype=torch.float64),
        b=torch.tensor([1.4, 0.8], dtype=torch.float64),
        lo=tm.warp.lo, hi=tm.warp.hi, dims=tm.warp.dims))
    return X, jm, tm


def test_input_warped_matches_jax():
    X, jm, tm = _input_warped_pair()
    np.testing.assert_allclose(tm.warp.f(torch.tensor(X)).numpy(),
                               np.asarray(jm.warp.f(jnp.asarray(X))), rtol=1e-12)
    _packed_check(jm, tm)
    Xs = np.random.default_rng(2).uniform(-1, 2, (5, 3))
    for got, want in zip(tm.predict(torch.tensor(Xs)), jm.predict(jnp.asarray(Xs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)


def test_convert_warped_models(data):
    jm, _ = _warped_pair(data, warping_terms=2)
    leaves = {"gp.kern.variance": jm.gp.kern.variance, "gp.kern.lengthscale":
              jm.gp.kern.lengthscale, "gp.likelihood_variance": jm.gp.likelihood_variance,
              "gp.X": jm.gp.X, "gp.Y": jm.gp.Y, "gp.mask": jm.gp.mask, "warp.d": jm.warp.d,
              "warp.a": jm.warp.a, "warp.b": jm.warp.b, "warp.c": jm.warp.c}
    back = convert.warped_from_leaves({k: np.asarray(v) for k, v in leaves.items()},
                                      family="rbf", device="cpu")
    assert float(back.log_marginal_likelihood()) == pytest.approx(
        float(jm.log_marginal_likelihood()), rel=1e-12)
    _, jin, _ = _input_warped_pair()
    leaves = {"gp.kern.variance": jin.gp.kern.variance, "gp.kern.lengthscale":
              jin.gp.kern.lengthscale, "gp.likelihood_variance": jin.gp.likelihood_variance,
              "gp.X": jin.gp.X, "gp.Y": jin.gp.Y, "gp.mask": jin.gp.mask, "warp.a": jin.warp.a,
              "warp.b": jin.warp.b, "warp.lo": jin.warp.lo, "warp.hi": jin.warp.hi}
    back = convert.input_warped_from_leaves({k: np.asarray(v) for k, v in leaves.items()},
                                            dims=(0, 1), device="cpu")
    assert float(back.log_marginal_likelihood()) == pytest.approx(
        float(jin.log_marginal_likelihood()), rel=1e-12)


@pytest.mark.parametrize("name", ["WarpedGPModel", "InputWarpedGPModel"])
def test_warped_bo_models_match_jax(data, name):
    """(test_models_extra.py::test_warped_bo_models) one restart of 8 steps on
    12 points, then a second refit on 15 from the carried parameters: the
    predictions, their gradients and fmin after each."""
    X, Y = data
    kw = dict(max_iters=8, optimize_restarts=1)
    if name == "InputWarpedGPModel":
        theirs = jwb.InputWarpedGPModel(JSpace(bounds_to_space([(0.0, 1.0)])), **kw)
        ours = twb.InputWarpedGPModel(DesignSpace(bounds_to_space([(0.0, 1.0)])), device="cpu",
                                      **kw)
    else:
        theirs, ours = jwb.WarpedGPModel(**kw), twb.WarpedGPModel(device="cpu", **kw)
    Xs = np.array([[0.3], [0.8]])
    for Xa, Ya in ((X[:12], Y[:12]), (X, Y)):
        theirs.updateModel(Xa, Ya)
        ours.updateModel(Xa, Ya)
        for got, want in zip(ours.predict(Xs), theirs.predict(Xs)):
            assert got.shape == (2, 1)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        for got, want in zip(ours.predict_withGradients(Xs), theirs.predict_withGradients(Xs)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
        assert ours.get_fmin() == pytest.approx(theirs.get_fmin(), rel=1e-6)


@pytest.mark.parametrize("acquisition", ["EI", "MPI", "LCB"])
def test_host_acquisition_gradients_match_jax(data, acquisition):
    """A surrogate without tensor state has the host face only: the
    acquisition and its gradient by the chain rule through
    ``predict_withGradients``, as the JAX package's."""
    from gaussian_process_optimization_tpu.bo import acquisitions as jacq
    from gaussian_process_optimization_tpu_torch.bo import acquisitions as tacq

    X, Y = data
    kw = dict(max_iters=8, optimize_restarts=1)
    theirs, ours = jwb.WarpedGPModel(**kw), twb.WarpedGPModel(device="cpu", **kw)
    theirs.updateModel(X, Y)
    ours.updateModel(X, Y)
    name = f"Acquisition{acquisition}"
    space = bounds_to_space([(0.0, 1.0)])
    ja = getattr(jacq, name)(theirs, JSpace(space))
    ta = getattr(tacq, name)(ours, DesignSpace(space))
    assert not ta.supports_device and not ta.analytical_gradient_acq
    x = np.array([[0.15], [0.55], [0.9]])
    for got, want in zip(ta.acquisition_function_withGradients(x),
                         ja.acquisition_function_withGradients(x)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(ta.acquisition_function(x), ja.acquisition_function(x),
                               rtol=1e-5, atol=1e-9)


# The JAX package's WarpedGPModel fit (5 restarts of 50 L-BFGS steps, float64)
# of the bench's data recipe at N = 4096, normalized outputs
_FITTED_4096 = dict(variance=12.781488507699411, lengthscale=4.702881911745641,
                    noise=0.0007233282160842739, d=0.5677014164210032,
                    a=[0.7959025800996986, 0.6453988287096082, 0.08442233654255932],
                    b=[7.6668703006847325, 0.12073978839539494, 0.03702889878620822],
                    c=[-2.095375118731628, 2.0916942665712495, -0.19109140783746556])


def test_f32_lml_error_is_the_references():
    """At a fitted warped GP at full size (N = 4096, D = 6) neither package's
    float32 -LML meets its float64 one to 1e-3: the fitted noise is small
    beside the kernel variance, and Ky's condition number is near float32's
    1 / eps. The port's float32 error, against the port's float64 on the same
    leaves, is within 2x of the JAX package's against its own."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.utils.normalizer import normalize_stats
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    p = _FITTED_4096
    X, Y = workload.bench_data()
    Y = np.asarray(normalize_stats(Y))
    jm = jw.WarpedGP.create(X, Y, kernel=jk.Matern52.create(6, variance=p["variance"],
                                                           lengthscale=p["lengthscale"]),
                            noise_var=p["noise"], max_points=4096)
    jm = jw.WarpedGP(gp=jm.gp, warp=jw.TanhWarp(**{k: jnp.asarray(p[k]) for k in "dabc"}))
    j32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if getattr(a, "dtype", None) == jnp.float64 else a, jm)
    jl64, jl32 = float(jm.log_marginal_likelihood()), float(j32.log_marginal_likelihood())
    leaves = {"gp.kern.variance": jm.gp.kern.variance,
              "gp.kern.lengthscale": jm.gp.kern.lengthscale,
              "gp.likelihood_variance": jm.gp.likelihood_variance, "gp.X": jm.gp.X,
              "gp.Y": jm.gp.Y, "gp.mask": jm.gp.mask, "warp.d": jm.warp.d, "warp.a": jm.warp.a,
              "warp.b": jm.warp.b, "warp.c": jm.warp.c}
    t32 = convert.warped_from_leaves({k: np.asarray(v) for k, v in leaves.items()},
                                     dtype=torch.float32, device="cpu")
    with torch.no_grad():
        tl32 = float(t32.log_marginal_likelihood())
        tl64 = float(tree_map(lambda t: t.double(), t32).log_marginal_likelihood())
    jax_err, port_err = abs(jl32 - jl64) / abs(jl64), abs(tl32 - tl64) / abs(tl64)
    print(f"warped -LML f32 rel error at N = 4096: JAX {jax_err:.3e}, port {port_err:.3e}")
    assert tl64 == pytest.approx(jl64, rel=1e-6)
    assert port_err <= 2.0 * jax_err, (port_err, jax_err)
