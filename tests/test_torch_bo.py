"""The torch port's thesis path against the JAX package, in float64: the Gower
kernel and its gradients, the packer's fix / transform overrides, the BO
surrogate's refit with injected restart starts, the local-penalization
acquisition and Lipschitz estimate, and whole local-penalization batches
through ``BayesianOptimization``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_optimization_tpu.bo.acquisitions import AcquisitionEI as JEI
from gaussian_process_optimization_tpu.bo.acquisitions import AcquisitionLP as JLP
from gaussian_process_optimization_tpu.bo.designs import initial_design as jdesign
from gaussian_process_optimization_tpu.bo.evaluators import estimate_L as jestimate_L
from gaussian_process_optimization_tpu.bo.methods import BayesianOptimization as JBO
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.kernels import Gower as JGower
from gaussian_process_optimization_tpu.kernels import Matern52 as JMatern52
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models.bo_models import GPModel as JGPModel
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu.ops import lbfgs as jlbfgs
from gaussian_process_optimization_tpu.utils.pytree import replace as jreplace
from gaussian_process_optimization_tpu.utils.transforms import Logistic as JLogistic
from gaussian_process_optimization_tpu_torch import convert, workload
from gaussian_process_optimization_tpu_torch.bo.acquisitions import AcquisitionEI, AcquisitionLP
from gaussian_process_optimization_tpu_torch.bo.evaluators import estimate_L
from gaussian_process_optimization_tpu_torch.bo.methods import BayesianOptimization
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.kernels import Gower, Matern52
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from gaussian_process_optimization_tpu_torch.models.fit import Fitter
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.parameters import (
    bounded_noise_transform, make_packer)

CONT, DISC, RANGES = (0, 1, 2, 3), (4, 5), [4.0] * 4
GOWER = {"cont_dims": CONT, "disc_dims": DISC, "gpy_compat": True}


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=torch.float64, **kw)


def _mixed(rng, n):
    return np.hstack([rng.uniform(-2.0, 2.0, (n, 4)), rng.integers(0, 3, (n, 2))])


def _jleaves(tree):
    """JAX pytree leaves keyed by their dotted field path."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf) for path, leaf in flat}


@pytest.mark.parametrize("gpy_compat", [True, False], ids=["gpy_compat", "corrected"])
def test_gower_matches_jax(gpy_compat, rng):
    """K(X), K(X, X2) and Kdiag of a Gower kernel over an ARD Matern52, and
    the gradients of a weighted sum of them with respect to the variance, the
    lengthscales and X2, against jax.grad, 1e-10; then two hyperparameter
    lanes at once against each lane alone."""
    X, X2 = _mixed(rng, 20), _mixed(rng, 7)
    X2[:3, 4:] = X[:3, 4:]  # some equal discrete values across the two sets
    W, W2, wd = rng.standard_normal((20, 20)), rng.standard_normal((20, 7)), rng.standard_normal(7)
    var, ls = 1.3, np.array([0.7, 1.4, 0.9, 1.1, 0.8, 1.2])

    def jloss(v, l, x2):
        k = JGower.create(JMatern52(input_dim=6, variance=v, lengthscale=l), RANGES, CONT,
                          DISC, gpy_compat)
        return (jnp.sum(k.K(jnp.asarray(X)) * W) + jnp.sum(k.K(jnp.asarray(X), x2) * W2)
                + jnp.sum(k.Kdiag(x2) * wd))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(var), jnp.asarray(ls), jnp.asarray(X2))

    v, l, x2 = _t(var, requires_grad=True), _t(ls, requires_grad=True), _t(X2, requires_grad=True)
    k = Gower.create(Matern52(input_dim=6, variance=v, lengthscale=l), RANGES, CONT, DISC,
                     gpy_compat)
    val = (torch.sum(k.K(_t(X)) * _t(W)) + torch.sum(k.K(_t(X), x2) * _t(W2))
           + torch.sum(k.Kdiag(x2) * _t(wd)))
    grads = torch.autograd.grad(val, (v, l, x2), allow_unused=True)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-10)
    if gpy_compat:  # the lengthscale is ignored: no gradient reaches it
        assert grads[1] is None and not np.asarray(jgrads[1]).any()
        grads, jgrads = (grads[0], grads[2]), (jgrads[0], jgrads[2])
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-12)

    lanes = Gower.create(Matern52(input_dim=6, variance=_t([var, 0.6]),
                                  lengthscale=_t(np.stack([ls, ls[::-1]]))),
                         RANGES, CONT, DISC, gpy_compat)
    K2 = lanes.K(_t(X), _t(X2)).numpy()
    for b, (vb, lb) in enumerate(((var, ls), (0.6, ls[::-1]))):
        jk = JGower.create(JMatern52(input_dim=6, variance=jnp.asarray(vb),
                                     lengthscale=jnp.asarray(lb)), RANGES, CONT, DISC, gpy_compat)
        np.testing.assert_allclose(K2[b], np.asarray(jk.K(jnp.asarray(X), jnp.asarray(X2))),
                                   rtol=1e-12)


def _gp_pair(rng, n=12, max_points=16):
    X, Y = _mixed(rng, n), rng.standard_normal((n, 1))
    jk = JGower.create(JMatern52.create(6, variance=1.0), RANGES, CONT, DISC, True)
    jm = jreplace(JGP.create(X, Y, kernel=jk, noise_var=0.3, max_points=max_points),
                  jitter_hint=jnp.asarray(2.0, jnp.float32), jitter_greedy=True)
    tk = Gower.create(Matern52.create(6, variance=1.0, device="cpu"), RANGES, CONT, DISC,
                      True)
    tm = dataclasses.replace(
        GPRegression.create(X, Y, kernel=tk, noise_var=0.3, max_points=max_points,
                            device="cpu"),
        jitter_hint=torch.tensor(2.0, dtype=torch.float32), jitter_greedy=True)
    return X, Y, jm, tm


@pytest.mark.parametrize("exact_feval", [True, False], ids=["fixed_noise", "bounded_noise"])
def test_make_packer_matches_jax(exact_feval, rng):
    """The BO wrappers' packers (noise fixed, or under the bounded Logistic):
    the same fixed flags, packed vector, restart map and unpacked values as the
    JAX packer."""
    _, _, jm, tm = _gp_pair(rng)
    if exact_feval:
        jp = jmake_packer(jm, fix=("likelihood_variance",))
        tp = make_packer(tm, fix=("likelihood_variance",))
    else:
        jp = jmake_packer(jm, transform_overrides={"likelihood_variance": JLogistic(1e-9, 1e6)})
        tp = make_packer(tm, transform_overrides={
            "likelihood_variance": bounded_noise_transform()})
    # the two models order their data leaves differently: compare by path
    assert dict(zip(convert.leaves_of(tm), tp.fixed)) == dict(zip(_jleaves(jm), jp.fixed))
    u = tp.pack(tm)
    np.testing.assert_allclose(u.numpy(), np.asarray(jp.pack(jm)), rtol=1e-14)
    assert u.shape == ((2,) if exact_feval else (3,))
    z = rng.standard_normal((4, u.shape[0]))
    np.testing.assert_allclose(tp.map_restart(_t(z)).numpy(),
                               np.asarray(jax.vmap(jp.map_restart)(jnp.asarray(z))),
                               rtol=1e-12)
    u2 = u + 0.3
    ours, theirs = tp.unpack(u2, reference=tm), jp.unpack(jnp.asarray(u2.numpy()), reference=jm)
    for a, b in ((ours.kern.base.variance, theirs.kern.base.variance),
                 (ours.likelihood_variance, theirs.likelihood_variance)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13)


def test_with_data_carries_the_ladder_state(rng):
    X, Y, jm, tm = _gp_pair(rng)
    jnew = jm.with_data(X[:9], Y[:9], max_points=16)
    tnew = tm.with_data(X[:9], Y[:9], max_points=16)
    assert tnew.jitter_greedy and jnew.jitter_greedy
    assert float(tnew.jitter_hint) == float(jnew.jitter_hint) == 2.0
    np.testing.assert_array_equal(tnew.mask.numpy(), np.asarray(jnew.mask))
    np.testing.assert_array_equal(tnew.X.numpy(), np.asarray(jnew.X))


def _thesis_space():
    return JSpace(list(workload.THESIS_DOMAIN)), DesignSpace(list(workload.THESIS_DOMAIN))


def test_gpmodel_update_matches_jax(monkeypatch):
    """GPModel.updateModel (Gower, exact_feval) with 3 injected restart starts
    and 8 L-BFGS steps at N=24: the same fitted parameters, posterior rung and
    next hint as the JAX wrapper's refit run over the same starts."""
    X, Y = workload.thesis_data(n=24, seed=3)
    jspace, tspace = _thesis_space()
    jgm = JGPModel(exact_feval=True, Gower=True, space=jspace, max_iters=8,
                   optimize_restarts=3)
    jgm._create_model(X, Y, max_points=32)
    jm = jgm.model
    packer = jgm._fitter_for(32).packer
    u0 = np.asarray(packer.pack(jm))
    z = np.random.default_rng(7).standard_normal((2, u0.shape[0]))
    starts = np.vstack([u0, np.asarray(jax.vmap(packer.map_restart)(jnp.asarray(z)))])
    obj = jfit.make_objective(packer)
    res = jax.jit(jax.vmap(lambda u: jlbfgs.minimize(
        lambda uu: obj(uu, jm), u, maxiter=8, tol=1e-5, history=10, max_ls=8)))(
        jnp.asarray(starts))
    f = jnp.where(jnp.isfinite(res.f), res.f, jnp.inf)
    jfitted = packer.unpack(res.x[jnp.argmin(f)], reference=jm)
    jpost = jreplace(jfitted, jitter_greedy=False).inference(precompute_inverse=True)

    monkeypatch.setattr(Fitter, "draw_starts", lambda self, model, generator=None: _t(starts))
    tgm = GPModel(exact_feval=True, Gower=True, space=tspace, max_iters=8,
                  optimize_restarts=3, device="cpu")
    tgm.updateModel(X, Y)
    base = tgm.model.kern.base
    np.testing.assert_allclose(float(base.variance), float(jfitted.kern.base.variance),
                               rtol=1e-8)
    np.testing.assert_allclose(float(base.lengthscale), float(jfitted.kern.base.lengthscale),
                               rtol=1e-8)
    assert int(tgm.posterior.rung) == int(jpost.rung)
    assert float(tgm.model.jitter_hint) == float(jpost.rung)
    assert tgm.ladder == [{"fit_hint": 0, "posterior_rung": int(jpost.rung)}]
    np.testing.assert_allclose(float(tgm.posterior.lml), float(jpost.lml), rtol=1e-10)


@pytest.fixture(scope="module")
def lp_models():
    """A JAX GPModel on the thesis recipe (N=40) with hyperparameters away from
    their defaults, and the port's GPModel carrying the same state through
    ``convert.gp_from_leaves``."""
    X, Y = workload.thesis_data(n=40, seed=1)
    jspace, tspace = _thesis_space()
    jgm = JGPModel(exact_feval=True, Gower=True, space=jspace, max_iters=0)
    jgm.updateModel(X, Y)
    jm = jgm.model
    jm = jreplace(jm, kern=jreplace(jm.kern, base=jreplace(
        jm.kern.base, variance=jnp.asarray(1.7), lengthscale=jnp.asarray(0.6))))
    jgm.model = jm
    jgm.posterior = jreplace(jm, jitter_greedy=False).inference(precompute_inverse=True)
    jgm._fmin = None

    tgm = GPModel(exact_feval=True, Gower=True, space=tspace, max_iters=0, device="cpu")
    tm = convert.gp_from_leaves(_jleaves(jm), gower=GOWER, device="cpu")
    assert float(tm.jitter_hint) == float(jm.jitter_hint)
    tgm.model = dataclasses.replace(tm, jitter_greedy=True)
    tgm.posterior = tm.inference(precompute_inverse=True)
    return jgm, tgm, jspace, tspace


def test_lp_acquisition_and_gradient_match_jax(lp_models, rng):
    """The penalized log-EI at 10 points and its gradient, with 3 points in
    the batch, 1e-10; the hammer radii and widths too."""
    jgm, tgm, jspace, tspace = lp_models
    assert tgm.get_fmin() == pytest.approx(jgm.get_fmin(), rel=1e-12)
    jlp = JLP(jgm, jspace, None, JEI(jgm, jspace))
    tlp = AcquisitionLP(tgm, tspace, None, AcquisitionEI(tgm, tspace))
    X_batch, Xq = _mixed(rng, 3), _mixed(rng, 10)
    for lp in (jlp, tlp):
        lp.update_batches(X_batch, 2.5, -1.2)
    np.testing.assert_allclose(tlp.r_x0, jlp.r_x0, rtol=1e-10)
    np.testing.assert_allclose(tlp.s_x0, jlp.s_x0, rtol=1e-10)
    jf, jdf = jlp.acquisition_function_withGradients(Xq)
    gp, post, fmin, state = tlp.device_args()
    Xr = _t(Xq, requires_grad=True)
    f = tlp.pure_neg_acq(gp, post, fmin, state, Xr)
    (df,) = torch.autograd.grad(f.sum(), Xr)
    np.testing.assert_allclose(f.detach().numpy(), jf[:, 0], rtol=1e-10)
    np.testing.assert_allclose(df.numpy(), jdf, rtol=1e-10, atol=1e-12)


def test_estimate_L_matches_jax(lp_models):
    jgm, tgm, jspace, tspace = lp_models
    ours = estimate_L(tgm, tspace.get_bounds())
    theirs = jestimate_L(jgm, jspace.get_bounds())
    assert ours == pytest.approx(theirs, rel=1e-8)


def test_thesis_batch_matches_jax():
    """``suggest_next_locations`` on the bench's thesis recipe at N=64
    (Gower, exact_feval, local-penalization batch of 5, no fit): the same
    batch as the JAX package, discrete columns exactly, continuous to 1e-6."""
    X, Y = workload.thesis_data(n=64)
    kw = dict(f=None, domain=list(workload.THESIS_DOMAIN), X=X, Y=Y, Gower=True,
              acquisition_type="EI", evaluator_type="local_penalization", batch_size=5,
              exact_feval=True, seed=0, max_iters=0)
    theirs = JBO(**kw).suggest_next_locations()
    bo = workload.thesis_bo(X, Y, steps=0, device="cpu")
    ours = workload.thesis_iteration(bo).batch
    assert ours.shape == (5, 6)
    np.testing.assert_array_equal(ours[:, 4:], theirs[:, 4:])
    np.testing.assert_allclose(ours[:, :4], theirs[:, :4], rtol=0, atol=1e-6)
    assert bool(bo.model.posterior.ok)


def test_mixed_space_lp_batch_with_dedup():
    """tests/test_bo.py:80-120 through the port: continuous and discrete
    inputs, Gower, a local-penalization batch of 3 with de-duplication and a
    fitted (bounded) noise. The batch has allowed values and distinct rows."""

    def balance(x):
        x = np.atleast_2d(x)
        return (x[:, 0:1] - x[:, 1:2]) ** 2 + 0.1 * np.sin(5 * x[:, 0:1])

    domain = [{"name": "xc", "type": "continuous", "domain": (0.0, 4.0)},
              {"name": "xd", "type": "discrete", "domain": (0, 1, 2, 3, 4)}]
    X = jdesign("latin_mixed", JSpace(domain), 8, seed=3)
    bo = BayesianOptimization(f=None, domain=domain, X=X, Y=balance(X), model_type="GP",
                              acquisition_type="EI", evaluator_type="local_penalization",
                              batch_size=3, Gower=True, exact_feval=False, noise_var=1e-4,
                              de_duplication=True, seed=3, device="cpu")
    batch = bo.suggest_next_locations()
    assert batch.shape == (3, 2)
    assert set(np.unique(batch[:, 1])).issubset({0.0, 1.0, 2.0, 3.0, 4.0})
    assert np.all((batch[:, 0] >= 0.0) & (batch[:, 0] <= 4.0))
    assert len({tuple(row) for row in np.round(batch, 6)}) == 3
    assert not {tuple(row) for row in batch} & {tuple(row) for row in X}
    assert isinstance(bo.model.model.kern, Gower)
    assert bool(bo.model.posterior.ok)
