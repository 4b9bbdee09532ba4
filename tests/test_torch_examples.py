"""The port's example scripts (``gaussian_process_optimization_tpu_torch/
examples``) on the CPU, at ``tests/test_examples.py``'s arguments. Each checks
what the reference's test checks, and is held against the JAX package where
its inputs can be taken apart: the initial designs (the same numpy draws from
the same seed), and the initial model's objective on the script's data. The
scripts' fits are not compared: JAX's PRNG and torch's generator draw
different restarts."""
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jkern
from gaussian_process_optimization_tpu.bo import objectives as jobjectives
from gaussian_process_optimization_tpu.bo.designs import initial_design as jinitial_design
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.bo.space import bounds_to_space as jbounds_to_space
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.utils import native
from gaussian_process_optimization_tpu_torch.utils import native as tnative
from gaussian_process_optimization_tpu_torch.examples import (
    branin_bo,
    classification_and_latents,
    forrester_gp,
    large_scale_sparse,
    latent_inference,
    latent_plots_and_clustering,
    mixed_design_batch,
    multichip_bo,
    uncertainty_quantification,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def numpy_branch(monkeypatch):
    """Both packages' designs take their native engine when it is built; here
    both are held to their numpy branch (the engines are held to each other in
    tests/test_torch_native.py)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _branin_design(n=5, seed=0):
    return jinitial_design("latin", JSpace(jbounds_to_space(jobjectives.branin.bounds)), n,
                           seed=seed)


def test_branin_bo_example(tmp_path, monkeypatch, numpy_branch):
    monkeypatch.chdir(tmp_path)
    bo = branin_bo.main(max_iter=3, plot=False, device="cpu")
    assert bo.Y.shape[0] == 8
    np.testing.assert_array_equal(bo.X[:5], _branin_design())
    np.testing.assert_allclose(bo.Y[:5], np.asarray(jobjectives.branin(bo.X[:5])), rtol=1e-12)
    assert (tmp_path / "branin_report.txt").exists()
    assert (tmp_path / "branin_evaluations.txt").exists()


def test_multichip_bo_example(tmp_path, monkeypatch, numpy_branch):
    """On the CPU mesh of tests/test_torch_sharded.py: eight CPU shards."""
    monkeypatch.chdir(tmp_path)
    bo = multichip_bo.main(max_iter=3, seed=0, device="cpu")
    assert bo.Y.shape[0] == 8 and np.isfinite(bo.fx_opt)
    np.testing.assert_array_equal(bo.X[:5], _branin_design())
    lo, hi = np.asarray(jobjectives.branin.bounds).T
    assert np.all((bo.X >= lo) & (bo.X <= hi))


def test_forrester_gp_example(tmp_path, monkeypatch):
    """The twin's initial -LML on the script's data is the JAX package's."""
    monkeypatch.chdir(tmp_path)
    model = forrester_gp.main(n=12, plot=True, out=str(tmp_path / "f.png"), device="cpu")
    assert (tmp_path / "f.png").exists()
    assert float(model.kern.lengthscale) > 0
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(12, 1))
    Y = np.asarray(jobjectives.forrester(X)) + 0.2 * rng.standard_normal((12, 1))
    ref = JGP.create(X, Y, kernel=jkern.RBF.create(1), noise_var=0.5, normalizer=True)
    twin = forrester_gp.GPRegression.create(
        X, Y, kernel=forrester_gp.kern.RBF.create(1, device="cpu"), noise_var=0.5,
        normalizer=True, device="cpu")
    np.testing.assert_allclose(float(twin.log_marginal_likelihood()),
                               float(ref.log_marginal_likelihood()), rtol=1e-10)


def test_mixed_design_example(tmp_path, monkeypatch, numpy_branch):
    monkeypatch.chdir(tmp_path)
    state = str(tmp_path / "st.npz")
    X, Y = mixed_design_batch.main(iterations=1, batch=2, state_file=state, device="cpu")
    assert X.shape[0] == 14  # 12 initial + a batch of 2
    design = jinitial_design("latin_mixed", JSpace(mixed_design_batch.DOMAIN), 12, seed=0)
    np.testing.assert_array_equal(X[:12], design)
    np.testing.assert_array_equal(Y, mixed_design_batch.objective(X))
    lo, hi = np.asarray([(min(d["domain"]), max(d["domain"]))
                         for d in mixed_design_batch.DOMAIN]).T
    assert np.all((X[12:] >= lo) & (X[12:] <= hi))
    X2, _ = mixed_design_batch.main(iterations=1, batch=2, state_file=state, device="cpu")
    assert X2.shape[0] >= 14  # resumed from the saved state


def test_classification_and_latents_example(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    lml_ss, lml_dense = classification_and_latents.main(
        plot=True, out=str(tmp_path / "c.png"), device="cpu")
    assert (tmp_path / "c.png").exists()
    assert abs(lml_ss - lml_dense) < 1e-3 * max(1.0, abs(lml_dense))


def test_latent_inference_example():
    rmse = latent_inference.infer_newx_demo(n=30, maxiter=150, device="cpu")
    assert rmse < 0.3
    m_mh, m_hmc, rate = latent_inference.mcmc_tail_demo(num_samples=800, device="cpu")
    assert 0.05 < rate < 0.95
    assert abs(m_mh[0] - 1.0) < 0.5 and abs(m_hmc[0] - 1.0) < 0.5


def test_latent_plots_and_clustering_example(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    m, rec, loc_err, groups = latent_plots_and_clustering.main(
        plot=True, outdir=str(tmp_path), maxiter=80, device="cpu")
    for f in ("latent.png", "steepest.png", "ard.png"):
        assert (tmp_path / f).exists(), f
    assert np.isfinite(rec) and np.isfinite(loc_err)
    assert sorted(sorted(g) for g in groups) == [[0, 1], [2, 3]]


def test_uncertainty_quantification_example():
    m, mt, mw, sv = uncertainty_quantification.main(device="cpu")
    Xs = torch.as_tensor(np.linspace(-2, 2, 5)[:, None])
    lo, hi = m.predict_quantiles(Xs)
    tlo, thi = mt.predict_quantiles(Xs)
    # the TP's t bands are wider than the GP's Gaussian ones at matched moments
    assert torch.all(thi - tlo > hi - lo)
    wlo, _ = mw.predict_quantiles(Xs)
    assert torch.all(wlo > 0)


def test_large_scale_sparse_example():
    """At a CPU size (the reference's test suite does not run this script):
    N = 2000, M = 32, 20 SVGP steps."""
    fitted, svgp = large_scale_sparse.main(n=2000, m=32, svgp_steps=20, device="cpu")
    assert np.isfinite(float(fitted.log_marginal_likelihood()))
    Xs = np.random.default_rng(1).uniform(-3, 3, size=(5, 2))
    mu, _ = fitted.predict(torch.as_tensor(Xs))
    truth = np.sin(Xs[:, :1] * 2) * np.cos(Xs[:, 1:])
    assert np.abs(mu.numpy() - truth).max() < 0.2
    assert np.all(np.isfinite(svgp.q_mu.numpy()))
