"""The torch port's MCMC surrogate (``models/mcmc_bo_model.py``) and its
integrated acquisitions (``bo/acquisitions_mcmc.py``) against the JAX package,
in float64: a refit's kept HMC samples under the reference's draws (reproduced
from its keys), the per-sample predictions, fmins and gradients, EI / MPI /
LCB_MCMC on the same samples, local penalization over EI_MCMC and LCB_MCMC (after
``tests/test_lp_mcmc.py``), and the integrated loop through
``BayesianOptimization``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_optimization_tpu.bo import acquisitions_mcmc as jam
from gaussian_process_optimization_tpu.bo import objectives
from gaussian_process_optimization_tpu.bo.acquisitions import AcquisitionLP as JLP
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.bo.space import bounds_to_space
from gaussian_process_optimization_tpu.models.mcmc_bo_model import GPModel_MCMC as JMCMC
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.bo import BayesianOptimization
from gaussian_process_optimization_tpu_torch.bo import acquisitions_mcmc as tam
from gaussian_process_optimization_tpu_torch.bo.acquisitions import AcquisitionLCB, AcquisitionLP
from gaussian_process_optimization_tpu_torch.bo.evaluators import LocalPenalization, estimate_L
from gaussian_process_optimization_tpu_torch.bo.optimizer import AcquisitionOptimizer
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.models.mcmc_bo_model import GPModel_MCMC
from torch_threads import one_torch_thread  # noqa: F401

SIZES = dict(n_samples=4, n_burnin=4, subsample_interval=2, step_size=0.05, leapfrog_steps=3)
XS = np.linspace(0.0, 1.0, 7)[:, None]


def jax_model_draws(seed=0):
    """The draws of the reference's GPModel_MCMC refits (mcmc_bo_model.py:74-85,
    :138-140; models/hmc.py:37-44): eps, momenta, log accept uniforms."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draws(total, dim):
        state["key"], _, k_hmc = jax.random.split(state["key"], 3)
        k1, k2 = jax.random.split(k_hmc)
        eps = np.asarray(jax.random.normal(k1, (dim,), dtype=jnp.float64))
        momenta, log_u = [], []
        for k in jax.random.split(k2, total):
            ka, kb = jax.random.split(k)
            momenta.append(np.asarray(jax.random.normal(ka, (dim,), dtype=jnp.float64)))
            log_u.append(np.log(float(jax.random.uniform(kb, dtype=jnp.float64))))
        return eps, np.stack(momenta), np.asarray(log_u)
    return draws


def _leaves(jm):
    out = {"kern.variance": jm.kern.variance, "kern.lengthscale": jm.kern.lengthscale,
           "likelihood_variance": jm.likelihood_variance, "X": jm.X, "Y": jm.Y,
           "mask": jm.mask}
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(12, 1))
    return X, np.asarray(objectives.forrester(X))


@pytest.fixture(scope="module")
def fitted(data):
    """One refit of each package, the port under the reference's draws."""
    X, Y = data
    theirs = JMCMC(**SIZES)
    theirs.updateModel(X, Y)
    ours = GPModel_MCMC(**SIZES, device="cpu", draws=jax_model_draws())
    ours.updateModel(X, Y)
    return theirs, ours


def test_refit_samples_match_jax(fitted):
    """The 200-step fit, the perturbation and the HMC chain: the kept samples
    and the chain's matrix (get_model_parameters)."""
    theirs, ours = fitted
    assert ours.hmc_samples.shape == (4, 3)
    np.testing.assert_allclose(ours.hmc_samples, np.asarray(theirs.hmc_samples), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(ours.get_model_parameters(), theirs.get_model_parameters(),
                               rtol=1e-8)
    assert ours.get_model_parameters_names() == list(theirs.get_model_parameters_names())
    assert 0.0 <= ours.accept_rate <= 1.0 and set(ours.seconds) == {"fit", "hmc", "posterior"}


@pytest.fixture(scope="module")
def carried(fitted):
    """The port's model on the reference's own kept samples."""
    theirs, _ = fitted
    return theirs, convert.mcmc_from_samples(_leaves(theirs.model), theirs.hmc_samples,
                                             device="cpu", **SIZES)


def test_per_sample_predictions_match_jax(carried):
    theirs, ours = carried
    for got, want in zip(ours.predict(XS), theirs.predict(XS)):
        assert len(got) == 4 and got[0].shape == (7, 1)
        np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ours.get_fmin(), theirs.get_fmin(), rtol=1e-9)
    for got, want in zip(ours.predict_withGradients(XS[:3]),
                         theirs.predict_withGradients(XS[:3])):
        np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=1e-8, atol=1e-10)
    assert ours.Y_min() == pytest.approx(theirs.Y_min())


@pytest.mark.parametrize("name", ["EI_MCMC", "MPI_MCMC", "LCB_MCMC"])
def test_integrated_acquisition_matches_jax(carried, name):
    """The lane mean of the per-sample acquisition; its autograd gradient
    against central differences of the port's own values."""
    theirs, ours = carried
    jspace, tspace = JSpace(bounds_to_space([(0.0, 1.0)])), DesignSpace(
        bounds_to_space([(0.0, 1.0)]))
    jacq = getattr(jam, f"Acquisition{name}")(theirs, jspace)
    tacq = getattr(tam, f"Acquisition{name}")(ours, tspace)
    np.testing.assert_allclose(tacq._compute_acq(XS), np.asarray(jacq._compute_acq(XS)),
                               rtol=1e-9, atol=1e-12)
    f_t, df_t = tacq.acquisition_function_withGradients(XS[2:3])
    np.testing.assert_allclose(f_t, tacq.acquisition_function(XS[2:3]), rtol=1e-12)
    h = 1e-6
    fd = (tacq.acquisition_function(XS[2:3] + h) - tacq.acquisition_function(XS[2:3] - h)) / (2 * h)
    np.testing.assert_allclose(df_t, fd, rtol=1e-5, atol=1e-8)
    # the S posteriors are the model's, factored once per refit
    gp, post, fmins, _ = tacq.device_args()
    assert post is ours.samples_posterior and fmins.shape == (4,)


def test_mcmc_acquisition_needs_samples():
    from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel

    with pytest.raises(ValueError, match="Samples"):
        tam.AcquisitionEI_MCMC(GPModel(device="cpu"), None)


@pytest.mark.parametrize("cls", [AcquisitionLCB, tam.AcquisitionLCB_MCMC])
def test_lp_softplus_for_lcb(cls):
    """(test_lp_mcmc.py::test_lp_lcb_mcmc_softplus_transform)"""
    lcb = cls.__new__(cls)
    assert AcquisitionLP(None, None, None, lcb).transform == "softplus"


@pytest.mark.parametrize("name", ["EI_MCMC", "LCB_MCMC"])
def test_lp_over_mcmc_matches_jax(carried, name):
    """The penalized acquisition over an integrated one, with the hammers from
    the sample-averaged prediction; and the Lipschitz constant from the
    point-estimate model (the MCMC surrogate has no single posterior)."""
    theirs, ours = carried
    bounds = [(0.0, 1.0)]
    jspace, tspace = JSpace(bounds_to_space(bounds)), DesignSpace(bounds_to_space(bounds))
    jlp = JLP(theirs, jspace, None, getattr(jam, f"Acquisition{name}")(theirs, jspace))
    tlp = AcquisitionLP(ours, tspace, None, getattr(tam, f"Acquisition{name}")(ours, tspace))
    assert tlp.transform == jlp.transform
    L = estimate_L(ours, bounds)
    assert np.isfinite(L) and L > 0
    for lp in (jlp, tlp):
        lp.update_batches(np.array([[0.35]]), L, ours.Y_min())
    np.testing.assert_allclose(tlp.r_x0, jlp.r_x0, rtol=1e-9)
    np.testing.assert_allclose(tlp.acquisition_function(XS),
                               np.asarray(jlp.acquisition_function(XS)), rtol=1e-9, atol=1e-12)


def test_lp_batch_over_mcmc_runs():
    """(test_lp_mcmc.py::test_lp_over_mcmc_acquisition) a batch of 2 over
    EI_MCMC through the loop, and the modular batch of 3 over LCB_MCMC."""
    dom = [{"name": f"x{i}", "type": "continuous", "domain": (-1.0, 1.0)} for i in range(2)]

    def f(x):
        return np.sum(np.square(np.atleast_2d(x) - 0.3), axis=1, keepdims=True)

    bo = BayesianOptimization(f=f, domain=dom, model_type="GP_MCMC", acquisition_type="EI_MCMC",
                              evaluator_type="local_penalization", batch_size=2,
                              initial_design_numdata=4, exact_feval=True, seed=0,
                              n_samples=4, n_burnin=4, leapfrog_steps=3, device="cpu",
                              anchor_points_samples=100)
    bo.run_optimization(max_iter=1, eps=-1)
    assert bo.Y.shape[0] == 6 and np.all(np.isfinite(bo.Y))
    model, space = bo.model, bo.space
    opt = AcquisitionOptimizer(space, model=model, num_samples=100)
    lp = AcquisitionLP(model, space, opt, tam.AcquisitionLCB_MCMC(model, space, opt))
    batch = LocalPenalization(lp, 3).compute_batch()
    assert batch.shape == (3, 2) and np.all(np.abs(batch) <= 1.0)


@pytest.mark.parametrize("name", ["EI_MCMC", "MPI_MCMC"])
def test_bo_with_mcmc_model(data, name):
    """(test_models_extra.py::test_bo_with_mcmc_model) ask-tell on the data:
    one suggestion in the box, the argmax of the integrated acquisition over
    the sweep's anchors."""
    X, Y = data
    bo = BayesianOptimization(
        f=None, domain=[{"name": "x", "type": "continuous", "domain": (0.0, 1.0)}], X=X, Y=Y,
        model_type="GP_MCMC", acquisition_type=name, anchor_points_samples=100,
        device="cpu", **SIZES)
    x = bo.suggest_next_locations()
    assert x.shape == (1, 1) and 0.0 <= x[0, 0] <= 1.0
    grid = np.linspace(0.0, 1.0, 201)[:, None]
    assert bo.acquisition.acquisition_function(x)[0, 0] <= \
        bo.acquisition.acquisition_function(grid).min() + 1e-6
