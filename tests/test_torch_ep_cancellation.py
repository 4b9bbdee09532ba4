"""Dense EP's evidence where Sigma = K - V^T V cancels (``models/ep.py``): at
an RBF of variance 456 and lengthscale 6 on the bench's data, the regime of
the classifier fitted on an H100 (diag Sigma ~1e-1 against K_ii = 456). The
port reads the evidence's nu^T Sigma nu as nu . mu (mu = K alpha) and diag
Sigma as (1 - ||L^-1 e_i||^2) / tau_i where tau_i K_ii > 1; the JAX package
reads sum(nu * (Sigma @ nu)) and diag(K - V^T V). In float64 both agree (rel
1e-8, evidence and site-fixed gradient); under noise in V^T V only the
reference's form moves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import ep as jep
from gaussian_process_optimization_tpu.models import likelihoods as jl
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu_torch import workload
from gaussian_process_optimization_tpu_torch.kernels.stationary import RBF
from gaussian_process_optimization_tpu_torch.models import classification as tc
from gaussian_process_optimization_tpu_torch.models import ep as tep
from gaussian_process_optimization_tpu_torch.models import likelihoods as tl
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from torch_threads import one_torch_thread  # noqa: F401

N = 384
VARIANCE, LENGTHSCALE = 456.0, 6.0
NOISE = 1e-5  # symmetric relative noise on V^T V in the structural test
X, _Y = workload.bench_data(n=N)
LABELS = workload.classification_labels(_Y)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=float))


@pytest.fixture(scope="module")
def point():
    """The JAX package's converged sites at the point, its evidence, and
    K there (float64)."""
    K = np.asarray(jk.RBF.create(6, variance=VARIANCE, lengthscale=LENGTHSCALE).K(
        jnp.asarray(X)))
    post = jep.ep_inference(jnp.asarray(K), jnp.asarray(LABELS), jl.Bernoulli())
    return K, np.asarray(post.tau_site), np.asarray(post.nu_site), float(post.lml)


def test_point_is_cancellation_heavy(point):
    """diag Sigma is a small fraction of K_ii at the converged sites."""
    K, tau, nu, _ = point
    _, sigma2, _, _ = tep._dense_posterior_from_sites(_t(K), _t(tau), _t(nu))
    assert float(sigma2.max()) < 1e-2 * VARIANCE
    assert float((_t(tau) * VARIANCE > 1.0).double().mean()) > 0.5


def test_dense_evidence_matches_jax_where_sigma_cancels(point):
    """EP from zero sites in the port: the same sites and evidence as the
    JAX package's, rel 1e-8."""
    K, tau, nu, lml = point
    post = tep.ep_inference(_t(K), _t(LABELS), tl.Bernoulli())
    np.testing.assert_allclose(post.tau_site.numpy(), tau, rtol=1e-8,
                               atol=1e-8 * np.abs(tau).max())
    np.testing.assert_allclose(post.nu_site.numpy(), nu, rtol=1e-8,
                               atol=1e-8 * np.abs(nu).max())
    assert float(post.lml) == pytest.approx(lml, rel=1e-8)


def test_site_fixed_gradient_matches_jax_where_sigma_cancels(point):
    """The alternated optimizer's objective at the converged sites, and its
    gradient in the packed kernel leaves, against the JAX package's, rel 1e-8."""
    from gaussian_process_optimization_tpu.models import classification as jc

    _, tau, nu, _ = point
    jm = jc.GPClassification.create(
        X, (LABELS > 0).astype(float),
        kernel=jk.RBF.create(6, variance=VARIANCE, lengthscale=LENGTHSCALE))
    tm = tc.GPClassification.create(
        X, (LABELS > 0).astype(float),
        kernel=RBF.create(6, variance=VARIANCE, lengthscale=LENGTHSCALE, device="cpu"),
        device="cpu")
    jp, tp = jmake_packer(jm), make_packer(tm)

    def jlml(u):
        m = jp.unpack(u, reference=jm)
        K = m.kern.K(m.X)
        mu, Sigma, L, _ = jep._dense_posterior_from_sites(K, jnp.asarray(tau), jnp.asarray(nu))
        return jep._dense_ep_lml(jl.Bernoulli(), m.Y, K, jnp.asarray(tau), jnp.asarray(nu),
                                 mu, Sigma, L, 1.0)

    u0 = jp.pack(jm)
    jval, jgrad = jax.value_and_grad(jlml)(u0)
    u = torch.tensor(np.asarray(u0), requires_grad=True)
    tval = tp.unpack(u, reference=tm).site_fixed_lml(_t(tau), _t(nu))
    (g,) = torch.autograd.grad(tval, u)
    assert float(tval) == pytest.approx(float(jval), rel=1e-8)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(jgrad)).max())


def test_noise_in_vtv_moves_only_the_references_form(point, monkeypatch):
    """At the converged sites, V^T V with symmetric relative noise of 1e-5
    (a float32 GEMM's is ~3e-6) moves the port's evidence by less than 1e-7
    of it, and the reference's form, sum(nu * (Sigma @ nu)) with diag(K -
    V^T V) in the cavities, by more than 1e-5. Prints both readings."""
    K, tau, nu, _ = point
    Kt, taut, nut, y = _t(K), _t(tau), _t(nu), _t(LABELS)
    E = np.random.default_rng(0).standard_normal((N, N))
    S = _t((E + E.T) / np.sqrt(2.0))
    gram = tep._gram

    def noisy(V, full):
        VtV = V.mT @ V * (1.0 + NOISE * S)
        return VtV if full else torch.diagonal(VtV)

    def evidences():
        mu, sigma2, L, Sigma = tep._dense_posterior_from_sites(Kt, taut, nut, full=True)
        ours = float(tep._dense_ep_lml(tl.Bernoulli(), y, taut, nut, mu, sigma2, L, 1.0))
        theirs = float(tep._dense_ep_lml(tl.Bernoulli(), y, taut, nut, mu,
                                         torch.diagonal(Sigma), L, 1.0)
                       + 0.5 * (torch.sum(nut * (Sigma @ nut)) - torch.sum(nut * mu)))
        return ours, theirs

    clean = evidences()
    monkeypatch.setattr(tep, "_gram", noisy)
    moved = evidences()
    monkeypatch.setattr(tep, "_gram", gram)
    ours, theirs = (abs(m - c) / abs(c) for m, c in zip(moved, clean))
    print(f"noise {NOISE:g} in V^T V at N = {N}: the port's evidence moves {ours:.3e}, "
          f"the reference's form {theirs:.3e} (evidence {clean[0]:.6f})")
    assert ours < 1e-7 < 1e-5 < theirs


def test_every_reading_of_sigma_is_the_references_evidence_in_float64(point):
    """``prof_stages.ep_evidence``, the card's comparison of the four readings
    of Sigma (``prof_stages.EP_FORMS``), gives the JAX package's float64
    evidence through each (rel 1e-8)."""
    from gaussian_process_optimization_tpu_torch import prof_stages

    K, _, _, lml = point
    for _, *form in prof_stages.EP_FORMS:
        e, sweeps = prof_stages.ep_evidence(_t(K), _t(LABELS), *form)
        assert e == pytest.approx(lml, rel=1e-8) and sweeps > 2


# dense EP's hyperparameters at the end of chip_smoke.py phase 9's leg on an
# H100 (two float32 alternated rounds, RBF, N = 4096, the bench's data)
EP_CARD_FIT = {"variance": 1026.51, "lengthscale": 3.66219}


@pytest.mark.slow
def test_jax_f32_evidence_at_the_cards_ep_fit():
    """The JAX package's own float32 dense EP evidence at the card's fitted
    point (``EP_CARD_FIT``), EP from zero sites, against its float64 there,
    printed with ``-s``: the reading behind ``chip_smoke.EP_JAX_F32``, beside
    the port's own float32 on the CPU. Marked slow: EP at N = 4096 in two
    dtypes in each package."""
    from gaussian_process_optimization_tpu.models import classification as jc

    Xb, Yb = workload.bench_data()
    labels = workload.classification_labels(Yb)
    jm = jc.GPClassification.create(Xb, (labels > 0).astype(float),
                                    kernel=jk.RBF.create(6, **EP_CARD_FIT))
    j64 = float(jm.log_marginal_likelihood())
    with jax.enable_x64(False):
        j32 = float(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32)
            if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a,
            jm).log_marginal_likelihood())
    ours = {}
    for dtype in (torch.float64, torch.float32):
        tm = tc.GPClassification.create(
            Xb, (labels > 0).astype(float),
            kernel=RBF.create(6, **EP_CARD_FIT, dtype=dtype, device="cpu"), dtype=dtype,
            device="cpu")
        ours[dtype] = float(tm.log_marginal_likelihood())
    rel = abs(j32 - j64) / abs(j64)
    rel_port = abs(ours[torch.float32] - ours[torch.float64]) / abs(ours[torch.float64])
    print(f"dense EP at the card's fitted point {EP_CARD_FIT}: the JAX package's float32 "
          f"evidence {j32:.4f} vs float64 {j64:.4f} (rel {rel:.3e}); the port on the CPU "
          f"{ours[torch.float32]:.4f} vs {ours[torch.float64]:.4f} (rel {rel_port:.3e})")
    assert ours[torch.float64] == pytest.approx(j64, rel=1e-8)
