"""The torch port's IBP latent force model against the JAX package, float64:
``ibp_neg_kl`` (torch's digamma and lgamma), the spike-and-slab psi
statistics of EQ_ODE2 (through the port's own Faddeeva function), the bound
and its gradient in the packed parameters (rtol 1e-9 / 1e-7: EQ_ODE2's
Weideman series is held to ~1e-12 in K), the prediction, and 10 Adam steps
(marked slow)."""
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_optimization_tpu.models import ibp_lfm as jibp
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu_torch.models import ibp_lfm as tibp
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves
from test_torch_gplvm import _np, _t, jax_leaves, port_latent, value_and_grad_both
from torch_threads import one_torch_thread  # noqa: F401

_T = np.linspace(0.0, 4.0, 12)
X = np.concatenate([np.column_stack([_T, np.full_like(_T, d)]) for d in range(3)])
Y = np.concatenate([np.sin((d + 1) * _T) for d in range(3)])[:, None]


@pytest.fixture(scope="module")
def pair():
    jm = jibp.IBPLFM.create(X, Y, output_dim=3, rank=2, num_inducing=8)
    return jm, port_latent("IBPLFM", jm, alpha=jm.alpha)


def test_create_matches_jax():
    jm = jibp.IBPLFM.create(X, Y, output_dim=3, rank=2, num_inducing=8, seed=2)
    tm = tibp.IBPLFM.create(X, Y, output_dim=3, rank=2, num_inducing=8, seed=2, device="cpu")
    got = dict(named_leaves(tm))
    for path, leaf in jax_leaves(jm, "").items():
        np.testing.assert_allclose(_np(got[path]), leaf, rtol=1e-12, atol=1e-14)


def test_ibp_neg_kl_matches_jax():
    rng = np.random.default_rng(3)
    gamma, tau = rng.uniform(0.05, 0.95, (4, 3)), rng.uniform(0.5, 3.0, (2, 3))
    np.testing.assert_allclose(float(tibp.ibp_neg_kl(_t(gamma), _t(tau), 2.0)),
                               float(jibp.ibp_neg_kl(jnp.asarray(gamma), jnp.asarray(tau), 2.0)),
                               rtol=1e-12)


def test_psi_stats_bound_and_gradient_match_jax(pair):
    jm, tm = pair
    for a, b in zip(jm._psi_stats(), tm._psi_stats()):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-9, atol=1e-12)
    fix = ("X", "Y")
    jpk, tpk = jmake_packer(jm, fix=fix), make_packer(tm, fix=fix)
    u = np.asarray(jpk.pack(jm)) + 0.02 * np.sin(np.arange(jpk.num_free))
    fj, gj, ft, gt = value_and_grad_both(lambda uu, m: -jpk.unpack(uu, reference=m).elbo(),
                                         jpk, jm, make_objective(tpk), tpk, tm, u=u)
    np.testing.assert_allclose(ft, fj, rtol=1e-9)
    np.testing.assert_allclose(gt, gj, rtol=1e-7, atol=1e-8 * np.abs(gj).max())


def test_predict_matches_jax(pair):
    jm, tm = pair
    Xs = X[::5] + np.array([0.05, 0.0])
    for inc in (True, False):
        for a, b in zip(jm.predict(jnp.asarray(Xs), include_likelihood=inc),
                        tm.predict(_t(Xs), include_likelihood=inc)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-9, atol=1e-12)


@pytest.mark.slow
def test_adam_steps_match_jax(pair):
    """10 Adam steps (lr 0.02, the reference's defaults): the ELBO trace within
    1e-8 and the fitted leaves within 1e-7 of their scale. Marked slow: the
    JAX package compiles its EQ_ODE2 step for ~45 s."""
    jm, tm = pair
    jf, jtrace = jm.optimize(maxiter=10)
    tf, ttrace = tm.optimize(maxiter=10)
    np.testing.assert_allclose(ttrace, jtrace, rtol=1e-8)
    got = dict(named_leaves(tf))
    for path, leaf in jax_leaves(jf, "").items():
        np.testing.assert_allclose(_np(got[path]), leaf, atol=1e-7 * max(np.abs(leaf).max(), 1))
