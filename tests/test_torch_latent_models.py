"""The torch port's MRD, spike-and-slab GPLVM / MRD, LVMOGP (with its
missing-data form) and SVI Bayesian GPLVM against the JAX package, float64:
each model's create, its converter twin, the bound and its gradient in the
packed parameters at a moved point (rtol 1e-10 / 1e-8), the predictions, and
a fit of at most 20 L-BFGS or Adam steps (the Adam minibatches injected).
The sizes are the gallery's (examples/gallery/dimensionality_reduction.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_optimization_tpu.models import bgplvm_svi as jsvi
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import lvmogp as jlv
from gaussian_process_optimization_tpu.models import mrd as jmrd
from gaussian_process_optimization_tpu.models import ss_gplvm as jss
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu_torch import workload
from gaussian_process_optimization_tpu_torch.models import bgplvm_svi as tsvi
from gaussian_process_optimization_tpu_torch.models import lvmogp as tlv
from gaussian_process_optimization_tpu_torch.models import mrd as tmrd
from gaussian_process_optimization_tpu_torch.models import ss_gplvm as tss
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves
from test_torch_gplvm import RTOL, Y_OIL, _np, _t, jax_leaves, port_latent, value_and_grad_both
from torch_threads import one_torch_thread  # noqa: F401

YS = workload.simulate_sincos(N=30)
_R = np.random.default_rng(12)
X_LV = np.linspace(0, 5, 24)[:, None]
Y_LV = np.concatenate([np.sin(X_LV + p) for p in _R.uniform(0, 3, 6)], axis=1)


def _cases():
    """name -> (JAX model, port twin built by create, the class's static fields)."""
    jmd = jlv.LVMOGP_MD.create(X_LV, np.arange(24) % 6, Y_LV[np.arange(24), np.arange(24) % 6],
                               D=6, Xr_dim=2, num_inducing=(5, 3))
    return {
        "MRD": (jmrd.MRD.create(YS, 3, num_inducing=6),
                tmrd.MRD.create(YS, 3, num_inducing=6, device="cpu"), {}),
        "SSGPLVM": (jss.SSGPLVM.create(Y_OIL, 3, num_inducing=6, pi=0.4),
                    tss.SSGPLVM.create(Y_OIL, 3, num_inducing=6, pi=0.4, device="cpu"),
                    {"pi": 0.4}),
        "SSMRD": (jss.SSMRD.create(YS, 3, num_inducing=6),
                  tss.SSMRD.create(YS, 3, num_inducing=6, device="cpu"), {}),
        "LVMOGP": (jlv.LVMOGP.create(X_LV, Y_LV, 2, num_inducing=(6, 3)),
                   tlv.LVMOGP.create(X_LV, Y_LV, 2, num_inducing=(6, 3), device="cpu"), {}),
        "LVMOGP_MD": (jmd, tlv.LVMOGP_MD.create(X_LV, np.arange(24) % 6,
                                                Y_LV[np.arange(24), np.arange(24) % 6], D=6,
                                                Xr_dim=2, num_inducing=(5, 3), device="cpu"), {}),
        "BGPLVM_SVI": (jsvi.BGPLVM_SVI.create(YS[0], 3, num_inducing=6),
                       tsvi.BGPLVM_SVI.create(YS[0], 3, num_inducing=6, device="cpu"), {}),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_create_and_converter_match_jax(name):
    """create draws the same leaves (1e-12), and the converter's twin holds
    them exactly."""
    jm, tm, static = CASES[name]
    port = dict(named_leaves(tm))
    conv = dict(named_leaves(port_latent(name, jm, **static)))
    for path, leaf in jax_leaves(jm, "").items():
        np.testing.assert_allclose(_np(port[path]), leaf, rtol=1e-12, atol=1e-14)
        np.testing.assert_array_equal(_np(conv[path]), leaf)


@pytest.mark.parametrize("name", list(CASES))
def test_bound_and_gradient_match_jax(name):
    """The bound and its gradient in the packed parameters (every leaf the
    reference's make_packer frees) at a moved point."""
    jm, _, static = CASES[name]
    tm = port_latent(name, jm, **static)
    fix = ("out_idx",)  # an integer leaf
    jpk, tpk = jmake_packer(jm, fix=fix), make_packer(tm, fix=fix)
    assert jpk.num_free == tpk.num_free
    u = np.asarray(jpk.pack(jm)) + 0.03 * np.cos(np.arange(jpk.num_free))
    fj, gj, ft, gt = value_and_grad_both(jfit.make_objective(jpk), jpk, jm, make_objective(tpk),
                                         tpk, tm, u=u)
    np.testing.assert_allclose(ft, fj, rtol=RTOL)
    np.testing.assert_allclose(gt, gj, rtol=1e-8, atol=1e-9 * np.abs(gj).max())


def test_relevance_and_lvmogp_predict_match_jax():
    for name in ("MRD", "SSGPLVM"):
        jm, tm, _ = CASES[name]
        np.testing.assert_allclose(_np(tm.relevance()), np.asarray(jm.relevance()), rtol=1e-12)
    jm, _, _ = CASES["LVMOGP"]
    tm = port_latent("LVMOGP", jm)
    Xs = np.linspace(-0.5, 5.5, 9)[:, None]
    for inc in (True, False):
        for a, b in zip(jm.predict(jnp.asarray(Xs), include_likelihood=inc),
                        tm.predict(_t(Xs), include_likelihood=inc)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-9, atol=1e-12)


def test_lvmogp_md_on_a_full_grid_equals_lvmogp():
    """The pointwise bound on every (input, output) pair is LVMOGP's (1e-10)."""
    _, tm, _ = CASES["LVMOGP"]
    n, D = Y_LV.shape
    md = tlv.LVMOGP_MD(**{**{f: getattr(tm, f) for f in (
        "kern_c", "kern_r", "likelihood_variance", "Zc", "Zr", "q_Hmu", "q_HS", "qU_mean",
        "qU_Ac", "qU_Ar")}, "X": tm.X.repeat_interleave(D, 0),
        "out_idx": torch.arange(D).repeat(n), "Y": tm.Y.reshape(-1)})
    np.testing.assert_allclose(float(md.elbo()), float(tm.elbo()), rtol=1e-10)


@pytest.mark.parametrize("name,jfit_fn,tfit_fn", [
    ("MRD", jmrd.fit_mrd, tmrd.fit_mrd), ("SSGPLVM", jss.fit_ssgplvm, tss.fit_ssgplvm),
    ("LVMOGP", jlv.fit_lvmogp, tlv.fit_lvmogp)])
def test_fits_match_jax(name, jfit_fn, tfit_fn):
    """15 L-BFGS steps with the models' own packers (MRD's positive q_S and
    noises, SS-GPLVM's logistic gamma): the objective within 1e-8 and the
    leaves within 1e-5 of their scale."""
    jm, _, static = CASES[name]
    tm = port_latent(name, jm, **static)
    jf, jres = jfit_fn(jm, maxiter=15)
    tf, tres = tfit_fn(tm, maxiter=15)
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-8)
    got = dict(named_leaves(tf))
    for path, leaf in jax_leaves(jf, "").items():
        np.testing.assert_allclose(_np(got[path]), leaf, atol=1e-5 * max(np.abs(leaf).max(), 1))


def test_svgplvm_minibatch_kl_and_optimal_qu_match_jax():
    jm, _, _ = CASES["BGPLVM_SVI"]
    tm = port_latent("BGPLVM_SVI", jm)
    idx = np.array([1, 4, 9, 17, 22])
    np.testing.assert_allclose(float(tm.elbo_minibatch(torch.as_tensor(idx))),
                               float(jm.elbo_minibatch(jnp.asarray(idx))), rtol=RTOL)
    np.testing.assert_allclose(float(tm.kl_u()), float(jm.kl_u()), rtol=RTOL)
    for a, b in zip(jm.optimal_qU(), tm.optimal_qU()):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-8, atol=1e-11)


def test_svgplvm_adam_steps_match_jax():
    """20 Adam steps (lr 1e-2) on the minibatch -ELBO with the gallery's
    numpy draws on both sides: every loss within 1e-9 and the leaves within
    1e-8 of their scale."""
    import optax

    jm, _, _ = CASES["BGPLVM_SVI"]
    tm = port_latent("BGPLVM_SVI", jm)
    rng = np.random.default_rng(0)
    batches = [np.sort(rng.choice(30, size=8, replace=False)) for _ in range(20)]
    packer = jmake_packer(jm)
    opt = optax.adam(1e-2)
    u = packer.pack(jm)
    state = opt.init(u)
    losses = []
    for idx in batches:
        val, g = jax.value_and_grad(
            lambda uu: -packer.unpack(uu, reference=jm).elbo_minibatch(jnp.asarray(idx)))(u)
        upd, state = opt.update(g, state, u)
        u = optax.apply_updates(u, upd)
        losses.append(float(val))
    jf = packer.unpack(u, reference=jm)
    tf, tlosses = tsvi.fit_bgplvm_svi(tm, steps=20, indices=batches)
    np.testing.assert_allclose(tlosses, losses, rtol=1e-9)
    got = dict(named_leaves(tf))
    for path, leaf in jax_leaves(jf, "").items():
        np.testing.assert_allclose(_np(got[path]), leaf, atol=1e-8 * max(np.abs(leaf).max(), 1))
