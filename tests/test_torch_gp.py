"""The torch port's parameterization and exact GP against the JAX package, in
float64: model conversion, the packer's order and values, the LML and its
gradient (on ``__graft_entry__.entry()``'s model), and prediction."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import gaussian_process_optimization_tpu.kernels as jkern
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu.utils import transforms as jtr
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.kernels import Matern52, RatQuad
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from gaussian_process_optimization_tpu_torch.utils import transforms as ttr
from torch_threads import one_torch_thread  # noqa: F401


def _leaves(jm):
    out = {"kern.variance": jm.kern.variance, "kern.lengthscale": jm.kern.lengthscale,
           "likelihood_variance": jm.likelihood_variance, "X": jm.X, "Y": jm.Y}
    if jm.mask is not None:
        out["mask"] = jm.mask
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def entry_model():
    _, (u0, jm) = graft.entry()
    return jm, convert.gp_from_leaves(_leaves(jm), device="cpu")


def test_convert_round_trip(entry_model):
    jm, tm = entry_model
    back = convert.leaves_of(tm)
    leaves = _leaves(jm)
    assert list(back) == ["kern.variance", "kern.lengthscale", "likelihood_variance",
                          "X", "Y", "mask"]
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v)
    again = convert.gp_from_leaves(back, device="cpu")
    for (p1, a), (p2, b) in zip(convert.leaves_of(again).items(), back.items()):
        assert p1 == p2 and np.array_equal(a, b)


def test_packer_order_and_values_match_jax(entry_model):
    jm, tm = entry_model
    jp, tp = jmake_packer(jm), make_packer(tm)
    u_j = np.asarray(jp.pack(jm))
    u_t = tp.pack(tm).numpy()
    assert u_t.shape == (8,)  # [variance, lengthscale x 6, likelihood_variance]
    np.testing.assert_allclose(u_t, u_j, rtol=1e-15)
    assert tp.fixed == jp.fixed
    # unpack with a lane axis: each lane's leaves equal the JAX unpack
    rng = np.random.default_rng(3)
    U = rng.standard_normal((3, 8))
    tl = tp.unpack(torch.tensor(U), reference=tm)
    assert tl.kern.variance.shape == (3,) and tl.kern.lengthscale.shape == (3, 6)
    for b in range(3):
        jl = jp.unpack(jnp.asarray(U[b]), reference=jm)
        np.testing.assert_allclose(tl.kern.lengthscale[b].numpy(),
                                   np.asarray(jl.kern.lengthscale), rtol=1e-14)
        np.testing.assert_allclose(float(tl.likelihood_variance[b]),
                                   float(jl.likelihood_variance), rtol=1e-14)
    # restart map
    np.testing.assert_allclose(tp.map_restart(torch.tensor(U)).numpy(),
                               np.asarray(jax.vmap(jp.map_restart)(jnp.asarray(U))),
                               rtol=1e-14)


@pytest.mark.parametrize("name", ["Positive", "Identity", "Logistic"])
def test_transforms_match_jax(name):
    z = np.linspace(-40.0, 40.0, 81)
    if name == "Logistic":
        jt, tt = jtr.Logistic(lo=1e-3, hi=5.0), ttr.Logistic(lo=1e-3, hi=5.0)
    else:
        jt, tt = getattr(jtr, name)(), getattr(ttr, name)()
    v_j = np.asarray(jt.forward(jnp.asarray(z)))
    v_t = tt.forward(torch.tensor(z)).numpy()
    np.testing.assert_allclose(v_t, v_j, rtol=1e-14)
    inside = v_j > (1e-3 if name == "Logistic" else -np.inf)
    np.testing.assert_allclose(tt.inverse(torch.tensor(v_j[inside])).numpy(),
                               np.asarray(jt.inverse(jnp.asarray(v_j[inside]))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tt.random_restart(torch.tensor(z)).numpy(),
                               np.asarray(jt.random_restart(jnp.asarray(z))), rtol=1e-12)
    pos = np.abs(v_j[inside]) + 1e-3
    np.testing.assert_allclose(tt.log_jacobian(torch.tensor(pos)).numpy(),
                               np.asarray(jt.log_jacobian(jnp.asarray(pos))),
                               rtol=1e-12, atol=1e-12)


def test_lml_value_and_gradient_match_jax(entry_model):
    """entry()'s model (N=256, D=6, ARD Matern52): -LML and its gradient in the
    packed coordinates, relative 1e-10 and 1e-8, for two lanes at once."""
    jm, tm = entry_model
    step, (u0, _) = graft.entry()
    jp = jmake_packer(jm)
    jobj = jfit.make_objective(jp)
    tp = make_packer(tm)
    tobj = make_objective(tp)
    U = np.stack([np.asarray(u0), np.asarray(u0) + np.linspace(-0.3, 0.3, 8)])
    Ut = torch.tensor(U, requires_grad=True)
    f = tobj(Ut, tm)
    (g,) = torch.autograd.grad(f.sum(), Ut)
    f = f.detach()
    for b in range(2):
        val, grad = jax.value_and_grad(jobj)(jnp.asarray(U[b]), jm)
        assert abs(float(f[b]) - float(val)) <= 1e-10 * abs(float(val))
        gj = np.asarray(grad)
        assert np.max(np.abs(g[b].numpy() - gj)) <= 1e-8 * np.max(np.abs(gj))


def _small_models(rng, normalizer=False, kernel="matern52"):
    n, d = 40, 3
    X = rng.uniform(-2, 2, (n, d))
    Y = np.sin(2 * X[:, :1]) + 0.1 * rng.standard_normal((n, 1)) + 0.5
    if kernel == "ratquad":
        jk = jkern.RatQuad.create(d, variance=1.2, lengthscale=0.9, power=1.7)
        tk = RatQuad.create(d, variance=1.2, lengthscale=0.9, power=1.7, device="cpu")
    else:
        ls = np.array([0.8, 1.3, 0.6])
        jk = jkern.Matern52.create(d, variance=1.4, lengthscale=ls, ARD=True)
        tk = Matern52.create(d, variance=1.4, lengthscale=ls, ARD=True, device="cpu")
    jm = JGP.create(X, Y, kernel=jk, noise_var=0.02, max_points=48, normalizer=normalizer)
    tm = GPRegression.create(X, Y, kernel=tk, noise_var=0.02, max_points=48,
                             normalizer=normalizer, device="cpu")
    return jm, tm


@pytest.mark.parametrize("normalizer,kernel", [(False, "matern52"), (True, "matern52"),
                                               (False, "ratquad")])
def test_inference_matches_jax(normalizer, kernel, rng):
    jm, tm = _small_models(rng, normalizer, kernel)
    jp, tp = jm.inference(), tm.inference()
    np.testing.assert_allclose(float(tp.lml), float(jp.lml), rtol=1e-12)
    np.testing.assert_allclose(tp.L.numpy(), np.asarray(jp.L), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(tp.alpha.numpy(), np.asarray(jp.alpha), rtol=1e-9,
                               atol=1e-12)
    assert bool(tp.ok) and int(tp.rung) == int(jp.rung)


@pytest.mark.parametrize("with_li", [False, True])
def test_predict_matches_jax(with_li, rng):
    jm, tm = _small_models(rng, normalizer=True)
    Xs = rng.uniform(-2.5, 2.5, (30, 3))
    jpost = jm.inference(precompute_inverse=with_li)
    tpost = tm.inference(precompute_inverse=with_li)
    assert (tpost.Li is not None) == with_li
    mu_j, var_j = jm.predict(jnp.asarray(Xs), posterior=jpost)
    mu_t, var_t = tm.predict(torch.tensor(Xs), posterior=tpost)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-9, atol=1e-12)
    # lane-batched test points: (5, 1, D) gives the same as one (5, D) call
    mu_b, var_b = tm.predict(torch.tensor(Xs[:5, None, :]), posterior=tpost)
    np.testing.assert_allclose(mu_b[:, 0].numpy(), mu_t[:5].numpy(), rtol=1e-12)
    np.testing.assert_allclose(var_b[:, 0].numpy(), var_t[:5].numpy(), rtol=1e-12)


def test_f32_noise_floor_applies_in_f32_only(rng):
    jm, tm = _small_models(rng)
    tm = GPRegression(kern=tm.kern, likelihood_variance=torch.tensor(1e-6, dtype=torch.float64),
                      X=tm.X, Y=tm.Y, mask=tm.mask)
    assert float(tm._effective_noise(torch.float64)) == pytest.approx(1e-6 + 1e-8)
    assert float(tm._effective_noise(torch.float32)) == pytest.approx(1e-4)
