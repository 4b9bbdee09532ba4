"""The torch port's GPLVM family against the JAX package: ``ops/linalg.py``'s
tdot / backsub_both_sides / trace_dot, the discriminative-GPLVM priors, the
RBF psi statistics, the Bayesian GPLVM (bound, its gradient, q(u), predict),
the point GPLVM (-LML and its gradient with the X block, a 20-step fit), the
gp.py tail (sampled log predictive density, Wishart embedding,
magnification) and the converter. Float64, the port's models built from the
JAX models' leaves through ``convert``; each tolerance is stated where it is
used. The X-gradient is also held in float32 with the JAX package's Pallas
kernels in interpret mode beside the port's kernel wrappers, whose plain
versions (``k_build_plain``, ``k_backward_plain``) run for CPU tensors."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.config import config as jconfig
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import gplvm as jg
from gaussian_process_optimization_tpu.models.parameters import (DATA_NAMES, POSITIVE_NAMES,
                                                                 _leaf_names)
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu.ops import linalg as jlinalg
from gaussian_process_optimization_tpu.utils import priors as jpriors
from gaussian_process_optimization_tpu.utils.packing import Packer as JPacker
from gaussian_process_optimization_tpu.utils.transforms import IDENTITY, POSITIVE
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.config import config as tconfig
from gaussian_process_optimization_tpu_torch.models import gplvm as tg
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck
from gaussian_process_optimization_tpu_torch.ops import linalg as tlinalg
from gaussian_process_optimization_tpu_torch.utils import priors as tpriors
from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves
from test_torch_kernel_zoo import jax_leaves, spec_of
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10  # float64 parity of one forward or gradient
_R = np.random.default_rng(0)
Y_OIL = np.concatenate([c + 0.3 * _R.standard_normal((10, 5))
                        for c in 2.0 * _R.standard_normal((3, 5))])
LABELS = np.repeat(np.arange(3), 10)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=float))


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, dtype=float)


def jgplvm_packer(jm):
    """The JAX package's fit_gplvm packer (models/gplvm.py:59-66)."""
    names = _leaf_names(jm)
    return JPacker(jm, transforms=[POSITIVE if n in POSITIVE_NAMES else IDENTITY
                                   for n in names],
                   fixed=[n in (DATA_NAMES - {"X"}) for n in names])


def port_gp(jm, dtype=None):
    return convert.gp_from_leaves(jax_leaves(jm, ""), kernel=spec_of(jm.kern), dtype=dtype,
                                  device="cpu")


def port_latent(name, jm, **static):
    kernels = {f: spec_of(getattr(jm, f)) for f in ("kern", "kern_c", "kern_r")
               if hasattr(jm, f)}
    if hasattr(jm, "kerns"):
        kernels["kerns"] = [spec_of(k) for k in jm.kerns]
    return convert.latent_from_leaves(name, jax_leaves(jm, ""), kernels, device="cpu", **static)


FITTED = Path(__file__).parent / "data" / "latent_card_fitted.npz"


def saved_leaves(name):
    """The leaves of one model in ``FITTED`` (the card's fitted point of
    ``chip_smoke.py`` phase 11), keyed by their port path."""
    data = np.load(FITTED)
    return {k[len(name) + 1:]: data[k] for k in data.files if k.startswith(name + "/")}


def with_leaves(template, saved):
    """``template`` with each leaf whose port path is in ``saved`` replaced."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for path, leaf in flat:
        key = ".".join(str(getattr(e, "name", getattr(e, "idx", getattr(e, "key", ""))))
                       for e in path)
        out.append(jnp.asarray(saved[key], dtype=jnp.asarray(leaf).dtype) if key in saved
                   else leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


def value_and_grad_both(jobj, jpacker, jm, tobj, tpacker, tm, u=None):
    """(f_jax, g_jax, f_port, g_port) of the two objectives at one packed point."""
    u = np.asarray(jpacker.pack(jm)) if u is None else u
    fj, gj = jax.value_and_grad(lambda uu: jobj(uu, jm))(jnp.asarray(u))
    ut = torch.tensor(u, requires_grad=True)
    ft = tobj(ut, tm)
    (gt,) = torch.autograd.grad(ft, ut)
    return float(fj), np.asarray(gj), float(ft), gt.numpy()


# ------------------------------------------------------------------ linalg tail
def test_linalg_tail_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((6, 4))
    L = np.tril(rng.standard_normal((6, 6))) + 4 * np.eye(6)
    X = rng.standard_normal((6, 6))
    np.testing.assert_allclose(tlinalg.tdot(_t(A)).numpy(), np.asarray(jlinalg.tdot(A)),
                               rtol=1e-13)
    assert torch.equal(tlinalg.tdot(_t(A)), tlinalg.tdot(_t(A)).T)
    for side in ("left", "right"):
        np.testing.assert_allclose(
            tlinalg.backsub_both_sides(_t(L), _t(X), side).numpy(),
            np.asarray(jlinalg.backsub_both_sides(jnp.asarray(L), jnp.asarray(X), side)),
            rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(float(tlinalg.trace_dot(_t(X), _t(L))),
                               float(jlinalg.trace_dot(jnp.asarray(X), jnp.asarray(L))),
                               rtol=1e-13)


# ------------------------------------------------------------------ priors
def _prior_pairs():
    rng = np.random.default_rng(2)
    lbl = np.eye(3)[LABELS]
    lbl2 = np.eye(2)[LABELS % 2]
    cov = np.array([[1.0, 0.3], [0.3, 0.5]])
    vec = rng.standard_normal((2, 2))
    return {
        "MultivariateGaussian": (jpriors.MultivariateGaussianPrior(mu=np.array([0.1, -0.2]),
                                                                   var=cov),
                                 tpriors.MultivariateGaussianPrior(mu=[0.1, -0.2], var=cov)),
        "DGPLVM": (jpriors.DGPLVMPrior(lbl=lbl, sigma2=0.5),
                   tpriors.DGPLVMPrior(lbl=lbl, sigma2=0.5)),
        "DGPLVMLamda": (jpriors.DGPLVMLamdaPrior(lbl=lbl, lamda=np.array([0.7, 1.3])),
                        tpriors.DGPLVMLamdaPrior(lbl=lbl, lamda=[0.7, 1.3])),
        "DGPLVMT": (jpriors.DGPLVMTPrior(lbl=lbl, vec=vec), tpriors.DGPLVMTPrior(lbl=lbl, vec=vec)),
        "DGPLVMKFDA": (jpriors.DGPLVMKFDAPrior(lbl=lbl2, kern=jk.RBF.create(2, lengthscale=1.5),
                                               lambdaa=0.1),
                       tpriors.DGPLVMKFDAPrior(lbl=lbl2, kern=tg.RBF.create(
                           2, lengthscale=1.5, device="cpu"), lambdaa=0.1)),
    }


@pytest.mark.parametrize("name", list(_prior_pairs()))
def test_whole_leaf_priors_match_jax(name):
    """lnpdf and its gradient in X (rtol 1e-10), and the lane axis: a (2, N, Q)
    leaf gives each lane its own value."""
    jp, tp = _prior_pairs()[name]
    X = np.random.default_rng(3).standard_normal((30, 2))
    fj, gj = jax.value_and_grad(lambda x: jnp.sum(jp.lnpdf(x)))(jnp.asarray(X))
    Xt = _t(X).requires_grad_(True)
    ft = torch.sum(tp.lnpdf(Xt))
    (gt,) = torch.autograd.grad(ft, Xt)
    np.testing.assert_allclose(float(ft), float(fj), rtol=RTOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-9, atol=1e-12)
    lanes = tp.lnpdf(torch.stack([_t(X), 2 * _t(X)]))
    assert lanes.shape[0] == 2
    np.testing.assert_allclose(float(lanes[1].sum()), float(jnp.sum(jp.lnpdf(2 * X))),
                               rtol=RTOL)


def test_fit_gplvm_objective_with_a_dgplvm_prior_matches_jax():
    """-(LML + log DGPLVM(X)) and its gradient in the packed parameters, X
    included (rtol 1e-10): the fit objective takes a prior on an (N, Q) leaf."""
    jm = jg.make_gplvm(Y_OIL, 2, kernel=jk.RBF.create(2, ARD=True))
    tm = port_gp(jm)
    lbl = np.eye(3)[LABELS]
    jpk, tpk = jgplvm_packer(jm), tg.gplvm_packer(tm)
    jobj = jfit.make_objective(jpk, priors={"X": jpriors.DGPLVMPrior(lbl=lbl)})
    tobj = make_objective(tpk, priors={"X": tpriors.DGPLVMPrior(lbl=lbl)})
    fj, gj, ft, gt = value_and_grad_both(jobj, jpk, jm, tobj, tpk, tm)
    np.testing.assert_allclose(ft, fj, rtol=RTOL)
    np.testing.assert_allclose(gt, gj, rtol=1e-8, atol=1e-10 * np.abs(gj).max())


# ------------------------------------------------------------------ psi statistics
def test_rbf_psi_stats_match_jax():
    rng = np.random.default_rng(4)
    mu, S, Z = rng.standard_normal((12, 3)), rng.uniform(0.1, 0.9, (12, 3)), rng.standard_normal((5, 3))
    jkern = jk.RBF.create(3, variance=1.3, lengthscale=[0.7, 1.1, 1.9], ARD=True)
    tkern = tg.RBF.create(3, variance=1.3, lengthscale=[0.7, 1.1, 1.9], ARD=True, device="cpu")
    for jf, tf in ((jg.rbf_psi_stats, tg.rbf_psi_stats), (jg.rbf_psi_stats_n, tg.rbf_psi_stats_n)):
        for a, b in zip(jf(jkern, jnp.asarray(Z), jnp.asarray(mu), jnp.asarray(S)),
                        tf(tkern, _t(Z), _t(mu), _t(S))):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-12, atol=1e-15)


# ------------------------------------------------------------------ Bayesian GPLVM
@pytest.fixture(scope="module")
def bgplvm_pair():
    jm = jg.BayesianGPLVM.create(Y_OIL, 3, num_inducing=6)
    tm = tg.BayesianGPLVM.create(Y_OIL, 3, num_inducing=6, device="cpu")
    return jm, tm


def test_bgplvm_create_and_converter_match_jax(bgplvm_pair):
    jm, tm = bgplvm_pair
    for path, leaf in jax_leaves(jm, "").items():
        np.testing.assert_allclose(_np(dict(named_leaves(tm))[path]), leaf, rtol=1e-12,
                                   atol=1e-14)
    conv = port_latent("BayesianGPLVM", jm)
    assert float(conv.elbo()) == float(tm.elbo())


def test_bgplvm_elbo_and_gradient_match_jax(bgplvm_pair):
    """The bound at the start and at a moved point, and its gradient in the
    packed parameters (q_mu, q_S, Z, the kernel, the noise): rtol 1e-10."""
    jm, tm = bgplvm_pair
    jpk, tpk = jmake_packer(jm), make_packer(tm)
    assert jpk.num_free == tpk.num_free
    u = np.asarray(jpk.pack(jm)) + 0.05 * np.sin(np.arange(jpk.num_free))
    fj, gj, ft, gt = value_and_grad_both(jfit.make_objective(jpk), jpk, jm, make_objective(tpk),
                                         tpk, tm, u=u)
    np.testing.assert_allclose(ft, fj, rtol=RTOL)
    np.testing.assert_allclose(gt, gj, rtol=1e-8, atol=1e-10 * np.abs(gj).max())


def test_f32_bgplvm_elbo_is_finite_at_the_cards_fitted_leaves():
    """At the card's fitted Bayesian GPLVM (N = 4096, Q = 7, M = 40, cond(Kmm)
    ~ 2e5) float32's I + A is indefinite through the reference's two solves;
    the JAX package's float32 -ELBO is finite there (rel 7.0e-2 against
    float64), so the port's must be too (ROADMAP C13), and no further than
    1.5x the JAX package's gap from float64 (the port's float64 value is the
    JAX package's to 3e-11). The jitter rung that float32's chol(psi2) takes
    is printed: the port's A is built on it."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    Y, _, _ = workload.latent_data()
    start = jg.BayesianGPLVM.create(Y, 7, num_inducing=40, kernel=jk.RBF.create(7, ARD=True))
    jm = with_leaves(start, saved_leaves("bgplvm"))
    with jax.enable_x64(False):
        j32 = -float(jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
            jm).elbo())
    tm = port_latent("BayesianGPLVM", jm)
    with torch.no_grad():
        t64 = -float(tm.elbo())
        tm32 = tree_map(lambda t: t.to(torch.float32), tm)
        t32 = -float(tm32.elbo())
        _, _, psi2 = tg.rbf_psi_stats(tm32.kern, tm32.Z, tm32.q_mu, tm32.q_S)
        _, jitter, ok, rung = tlinalg.jitchol_full(psi2)
    rel_j, rel_t = abs(j32 - t64) / abs(t64), abs(t32 - t64) / abs(t64)
    print(f"bgplvm -ELBO at the card's fitted leaves: JAX f32 {j32:.6f} (rel {rel_j:.3e}), "
          f"port f32 {t32:.6f} (rel {rel_t:.3e}), port f64 {t64:.6f}; f32 chol(psi2) rung "
          f"{int(rung)}, jitter {float(jitter):.3e}, ok {bool(ok)}")
    assert np.isfinite(j32)
    assert np.isfinite(t32)
    assert rel_t <= 1.5 * rel_j


def test_bgplvm_posterior_u_and_predict_match_jax(bgplvm_pair):
    jm, tm = bgplvm_pair
    for a, b in zip(jm.posterior_u(), tm.posterior_u()):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-9, atol=1e-12)
    Xs = np.random.default_rng(5).standard_normal((7, 3))
    for full_cov in (False, True):
        for a, b in zip(jm.predict(jnp.asarray(Xs), full_cov=full_cov),
                        tm.predict(_t(Xs), full_cov=full_cov)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-9, atol=1e-12)


# ------------------------------------------------------------------ point GPLVM
@pytest.mark.parametrize("init", ["pca", "random"])
def test_make_gplvm_matches_jax(init):
    jm = jg.make_gplvm(Y_OIL, 2, init=init, seed=3)
    tm = tg.make_gplvm(Y_OIL, 2, init=init, seed=3, device="cpu")
    np.testing.assert_allclose(tm.X.numpy(), np.asarray(jm.X), rtol=1e-12, atol=1e-14)
    assert float(tm.likelihood_variance) == 0.1


def _oil_kernel_pair(jdtype=jnp.float64):
    jkern = jk.RBF.create(3, variance=1.2, lengthscale=[0.9, 1.4, 2.0], ARD=True) \
        + jk.Bias.create(3, variance=0.3)
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), jkern)


def test_gplvm_lml_and_x_gradient_match_jax():
    """The point GPLVM's -LML and its gradient, the X block included, float64,
    RBF ARD + Bias (rtol 1e-10 on the value, 1e-8 of max |g| on the gradient)."""
    jm = jg.make_gplvm(Y_OIL, 3, kernel=_oil_kernel_pair())
    tm = port_gp(jm)
    jpk, tpk = jgplvm_packer(jm), tg.gplvm_packer(tm)
    assert jpk.num_free == tpk.num_free == 30 * 3 + 6
    fj, gj, ft, gt = value_and_grad_both(jfit.make_objective(jpk), jpk, jm, make_objective(tpk),
                                         tpk, tm)
    np.testing.assert_allclose(ft, fj, rtol=RTOL)
    np.testing.assert_allclose(gt, gj, rtol=1e-8, atol=1e-8 * np.abs(gj).max())


@pytest.fixture
def interpret_mode():
    old_j = jconfig.pallas_interpret, jconfig.use_pallas
    old_t = tconfig.use_cuda_kernels
    jconfig.pallas_interpret, jconfig.use_pallas = True, False
    tconfig.use_cuda_kernels = True  # through the kernel wrappers (their plain versions)
    yield
    jconfig.pallas_interpret, jconfig.use_pallas = old_j
    tconfig.use_cuda_kernels = old_t


def _f32_pair(n=144):
    rng = np.random.default_rng(6)
    Y = np.concatenate([c + 0.3 * rng.standard_normal((n // 3, 4))
                        for c in 2.0 * rng.standard_normal((3, 4))])
    jm = jg.make_gplvm(Y, 3, kernel=_oil_kernel_pair())
    return jm, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jm)


@pytest.mark.parametrize("prior", [None, "DGPLVM"])
def test_gplvm_x_gradient_through_the_kernels_matches_jax_interpret(prior, interpret_mode):
    """N = 144 (past the 128^2 gate), float32: the JAX package's -LML and
    gradient through its Pallas K and K-backward in interpret mode (dX, and dZ
    by the swapped call, over the symmetrized G) against the port's through
    its K-build and K-backward wrappers (the row pass's dX plus the column
    pass's dZ), both against float64; with and without a DGPLVM prior on X,
    which feeds X's gradient beside G. The port's float32 error stays within
    3x the JAX package's (plus 1e-6 of max |g|)."""
    jm64, jm32 = _f32_pair()
    lbl = np.eye(3)[np.repeat(np.arange(3), 48)]
    jpriors_ = {"X": jpriors.DGPLVMPrior(lbl=lbl)} if prior else None
    tpriors_ = {"X": tpriors.DGPLVMPrior(lbl=lbl)} if prior else None
    called = {"bwd": 0}
    orig = ck.k_backward_plain

    def counted(*a, **k):
        called["bwd"] += 1
        assert k.get("need_dx", a[6] if len(a) > 6 else True)
        return orig(*a, **k)

    tm32 = port_gp(jm32, dtype=torch.float32)
    jpk, tpk = jgplvm_packer(jm32), tg.gplvm_packer(tm32)
    with jax.enable_x64(False):
        fj, gj = jax.value_and_grad(lambda u: jfit.make_objective(jpk, priors=jpriors_)(
            u, jm32))(jpk.pack(jm32))
        fj, gj = float(fj), np.asarray(gj, dtype=float)
    jpk64 = jgplvm_packer(jm64)
    f64, g64 = jax.value_and_grad(lambda u: jfit.make_objective(jpk64, priors=jpriors_)(
        u, jm64))(jpk64.pack(jm64))
    f64, g64 = float(f64), np.asarray(g64)
    ck.k_backward_plain = counted
    try:
        u = tpk.pack(tm32).detach().clone().requires_grad_(True)
        ft = make_objective(tpk, priors=tpriors_)(u, tm32)
        (gt,) = torch.autograd.grad(ft, u)
    finally:
        ck.k_backward_plain = orig
    assert called["bwd"] == 1  # one backward call of the wrapper: dX and dZ together
    ft, gt = float(ft), gt.double().numpy()
    scale = np.abs(g64).max()
    err_j, err_t = np.abs(gj - g64).max() / scale, np.abs(gt - g64).max() / scale
    print(f"float32 gradient error over max |g64|: JAX interpret {err_j:.3e}, port {err_t:.3e}; "
          f"-LML rel JAX {abs(fj - f64) / abs(f64):.3e}, port {abs(ft - f64) / abs(f64):.3e}")
    assert err_t <= 3 * err_j + 1e-6
    assert abs(ft - f64) <= 3 * abs(fj - f64) + 1e-6 * abs(f64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_padded_rows_of_a_trainable_x_get_zero_gradient(dtype, interpret_mode):
    """X padded to 40 rows under a mask: the padded rows' gradient is exactly
    0, through the plain path (float64) and the kernel wrappers (float32)."""
    jm = jg.make_gplvm(Y_OIL, 2)
    tm = port_gp(jm, dtype=dtype)
    padded = tg.GPRegression.create(tm.X.numpy(), Y_OIL, kernel=tm.kern, noise_var=0.1,
                                    max_points=160 if dtype == torch.float32 else 40,
                                    dtype=dtype, device="cpu")
    X = padded.X.clone().requires_grad_(True)
    import dataclasses
    lml = dataclasses.replace(padded, X=X).log_marginal_likelihood()
    (g,) = torch.autograd.grad(lml, X)
    assert torch.all(g[30:] == 0)
    assert torch.all(torch.isfinite(g)) and float(g[:30].abs().max()) > 0


@pytest.fixture(scope="module")
def fitted_pair():
    jm = jg.make_gplvm(Y_OIL, 2, kernel=jk.RBF.create(2, ARD=True) + jk.Bias.create(2))
    tm = port_gp(jm)
    return jg.fit_gplvm(jm, maxiter=20), tg.fit_gplvm(tm, maxiter=20), tm


def test_fit_gplvm_matches_jax(fitted_pair):
    """20 L-BFGS steps over the kernel, the noise and X: the same iterations,
    the fitted leaves within 1e-6 (relative) and the objectives within 1e-9."""
    (jf, jres), (tf, tres), _ = fitted_pair
    assert int(tres.num_iters) == int(jres.num_iters)
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-9)
    for path, leaf in jax_leaves(jf, "").items():
        np.testing.assert_allclose(_np(dict(named_leaves(tf))[path]), leaf, rtol=1e-6,
                                   atol=1e-6 * np.abs(leaf).max())


# ------------------------------------------------------------------ gp.py tail
def test_gp_tail_matches_jax(fitted_pair):
    """Sampled log predictive density with the JAX package's own draws
    injected, the Wishart embedding and the magnification (rtol 1e-8)."""
    (jf, _), (tf, _), _ = fitted_pair
    Xs = np.random.default_rng(7).standard_normal((6, 2))
    Ys = np.random.default_rng(8).standard_normal((6, 5))
    key = jax.random.PRNGKey(3)
    z = jax.random.normal(key, (6, 200), dtype=jnp.float64)
    tf1 = tg.GPRegression(kern=tf.kern, likelihood_variance=tf.likelihood_variance, X=tf.X,
                          Y=tf.Y[:, :1])
    jf1 = jg.GPRegression(kern=jf.kern, likelihood_variance=jf.likelihood_variance, X=jf.X,
                          Y=jf.Y[:, :1], mask=None, mean_function=None, normalizer=None)
    want = jf1.log_predictive_density_sampling(jnp.asarray(Xs), jnp.asarray(Ys[:, :1]), key,
                                               num_samples=200)
    got = tf1.log_predictive_density_sampling(_t(Xs), _t(Ys[:, :1]), z=_t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    np.testing.assert_allclose(tf.predict_wishart_embedding(_t(Xs)).numpy(),
                               np.asarray(jf.predict_wishart_embedding(jnp.asarray(Xs))),
                               rtol=1e-8, atol=1e-12)
    for dims in (None, (1, 0)):
        np.testing.assert_allclose(
            tf.predict_magnification(_t(Xs), dimensions=dims).numpy(),
            np.asarray(jf.predict_magnification(jnp.asarray(Xs), dimensions=dims)),
            rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("fam", list(ck.FAMILIES))
def test_k_forward_mode_rule_matches_the_plain_build(fam):
    """The K build's forward-mode rule (k_jvp_plain) against torch.func.jvp of
    its plain version, X, Z and the parameters all moving, 2 lanes (1e-13)."""
    gen = torch.Generator().manual_seed(0)
    for ard in (False, True):
        args = [torch.rand(s, dtype=torch.float64, generator=gen) + 0.5
                for s in ((2, 9, 3), (2, 7, 3), (2, 8))]
        tangents = [torch.randn(a.shape, dtype=torch.float64, generator=gen) for a in args]
        want = torch.func.jvp(lambda a, b, c: ck.k_build_plain(a, b, c, fam, ard), tuple(args),
                              tuple(tangents))[1]
        got = ck.k_jvp_plain(*args, *tangents, fam, ard)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-13)


def test_magnification_through_the_kernel_wrappers_matches_plain_route(interpret_mode):
    """predict_jacobian's forward-mode pass through the K build's custom
    Function (its forward-mode rule) equals the plain route's, float32, N = 144."""
    _, jm32 = _f32_pair()
    tm = port_gp(jm32, dtype=torch.float32)
    Xs = tm.X[:12] + 0.1
    got = tm.predict_magnification(Xs)
    tconfig.use_cuda_kernels = False
    want = tm.predict_magnification(Xs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4)
