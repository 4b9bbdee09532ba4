"""The float32 error of every zoo kernel of ``chip_smoke.py`` phase 10's leg 5,
against float64, in the JAX package and in the port, on the CPU at N = 64
(``workload.zoo_cases``'s inputs): K's max |K32 - K64| / max |K64| and the
largest over the leaves of max |g32 - g64| / max |g64| for the gradient of
sum(W * K). The JAX twin of each port kernel is built from the port kernel's
own leaves. The port's error is held within 4x the JAX package's (or under
1e-6 where the JAX package reads below it); ``-s`` prints both, the readings
behind leg 5's limits on the card. Marked slow: the JAX package's eager
gradients of the latent-force kernels take ~1.5 min in all."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu_torch import workload
from gaussian_process_optimization_tpu_torch.kernels.base import Kernel
from gaussian_process_optimization_tpu_torch.utils.tree import (named_leaves, replace_leaves,
                                                                tree_map)
from test_torch_kernel_zoo import jax_leaves
from torch_threads import one_torch_thread  # noqa: F401

N = 64
CASES = [name for name, _, _ in workload.zoo_cases(n=8, device="cpu")]


def _jexpr(x, z, p):
    return p["variance"] * jnp.exp(-0.5 * jnp.sum((x - z) ** 2) / p["lengthscale"] ** 2)


def jax_twin(tk):
    """The JAX package's kernel with the port kernel's leaves and statics."""
    jcls = getattr(jk, type(tk).__name__)
    fields = {}
    for f in dataclasses.fields(jcls):
        v = getattr(tk, f.name, None)
        if isinstance(v, Kernel):
            fields[f.name] = jax_twin(v)
        elif isinstance(v, tuple) and v and isinstance(v[0], Kernel):
            fields[f.name] = tuple(jax_twin(p) for p in v)
        elif isinstance(v, torch.Tensor):
            fields[f.name] = jnp.asarray(v.detach().cpu().numpy())
        elif f.name == "params":
            fields[f.name] = {k: jnp.asarray(t.numpy()) for k, t in v.items()}
        elif f.name == "expr":
            fields[f.name] = _jexpr
        else:
            fields[f.name] = v
    return jcls(**fields)


def _errors(K32, K64, g32, g64):
    kerr = float(np.abs(K32 - K64).max() / max(np.abs(K64).max(), 1e-300))
    gerr = 0.0
    for path, g in g64.items():
        scale = float(np.abs(g).max())
        if scale > 0:
            gerr = max(gerr, float(np.abs(g32[path] - g).max()) / scale)
    return kerr, gerr


def _jax_readings(jkern, X, W):
    def run(k, X, W):
        K = np.asarray(k.K(X), dtype=float)
        g = jax.grad(lambda kk: jnp.sum(W * kk.K(X)))(k)
        return K, {p: np.asarray(v, dtype=float) for p, v in jax_leaves(g, "").items()}

    K64, g64 = run(jkern, jnp.asarray(X), jnp.asarray(W))
    with jax.enable_x64(False):
        k32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jkern)
        K32, g32 = run(k32, jnp.asarray(X, jnp.float32), jnp.asarray(W, jnp.float32))
    return _errors(K32, K64, g32, g64)


def _port_readings(tk, X, W):
    def run(k, X, W):
        named = named_leaves(k)
        leaves = [t.detach().clone().requires_grad_(True) for _, t in named]
        K = replace_leaves(k, leaves).K(X)
        gs = torch.autograd.grad(torch.sum(W * K), leaves, allow_unused=True)
        return K.detach().double().numpy(), {
            p: (np.zeros(t.shape) if g is None else g.double().numpy())
            for (p, t), g in zip(named, gs)}

    K64, g64 = run(tk, X, W)
    K32, g32 = run(tree_map(lambda t: t.float(), tk), X.float(), W.float())
    return _errors(K32, K64, g32, g64)


@pytest.mark.slow
@pytest.mark.parametrize("name", CASES)
def test_f32_error_is_the_references(name):
    cases = {n: (k, X) for n, k, X in workload.zoo_cases(n=N, device="cpu")}
    tk, X = cases[name]
    W = np.random.default_rng(1).standard_normal((N, N))
    W = 0.5 * (W + W.T)
    jk_err, jg_err = _jax_readings(jax_twin(tk), X.numpy(), W)
    tk_err, tg_err = _port_readings(tk, X, torch.tensor(W))
    print(f"{name}: float32 vs float64 at N={N}: K JAX {jk_err:.3e} port {tk_err:.3e}; "
          f"gradient JAX {jg_err:.3e} port {tg_err:.3e}")
    assert tk_err <= max(4 * jk_err, 1e-6)
    assert tg_err <= max(4 * jg_err, 1e-6)


# The fitted leaves of chip_smoke.py phase 10's legs 1 and 2 on the card
# (NVIDIA H100 80GB HBM3, 700 W), rounded as printed there.
ICM_FITTED = {
    "variance": 0.04499540850520134,
    "lengthscale": [2.7408411502838135, 4.601040840148926, 4.679868221282959,
                    4.56873083114624, 4.6087965965271, 4.601780891418457],
    "W": [[10.0289306640625], [7.122726917266846], [-5.043647766113281]],
    "kappa": [0.28213992714881897, 0.005972278770059347, 0.003341126721352339],
    "noise": 0.0018404611619189382}
CO2_FITTED = {
    "rbf": (0.9804236888885498, 5.0472588539123535), "per": (1.0261821746826172,
                                                             0.9986229538917542,
                                                             1.9402265548706055),
    "decay": (1.0280380249023438, 10.272575378417969),
    "ratquad": (0.27472662925720215, 2.8070695400238037, 0.5514928102493286),
    "linear": 0.010577109642326832, "bias": 1.0254937410354614, "noise": 0.010073530250787734}


def _jax_model(leg):
    from gaussian_process_optimization_tpu.models import multioutput as jmo
    from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP

    if leg == "icm":
        p = ICM_FITTED
        X, Y = jmo.build_stacked_XY(*workload.icm_data())
        base = jk.Matern52.create(6, variance=p["variance"], lengthscale=p["lengthscale"],
                                  ARD=True)
        kern = jmo.icm_kernel(6, 3, base, rank=1, W=p["W"], kappa=p["kappa"])
    else:
        p = CO2_FITTED
        X, Y = workload.co2_data()
        (v0, l0), (v1, t1, l1), (v2, l2) = p["rbf"], p["per"], p["decay"]
        v3, l3, a3 = p["ratquad"]
        kern = (jk.RBF.create(1, variance=v0, lengthscale=l0)
                + jk.StandardPeriodic.create(1, variance=v1, period=t1, lengthscale=l1)
                * jk.RBF.create(1, variance=v2, lengthscale=l2)
                + jk.RatQuad.create(1, variance=v3, lengthscale=l3, power=a3)
                + jk.Linear.create(1, variances=p["linear"]) + jk.Bias.create(1, variance=p["bias"]))
    return JGP.create(X, Y, kernel=kern, noise_var=p["noise"])


def _port_terms(model):
    """The -LML's gradient terms, 0.5 logdet and 0.5 quad, in the packed
    coordinates (float64 on the CPU), as chip_smoke.py's _neg_lml_grad_terms."""
    from gaussian_process_optimization_tpu_torch.models.gp import AssembleKy, ExactCore
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer

    packer = make_packer(model)
    u = packer.pack(model)[None].clone().requires_grad_(True)
    m = packer.unpack(u, reference=model)
    Yc = m._normalized_Y()
    K = m.kern.K(m.X)
    Ky = AssembleKy.apply(K, m._effective_noise(K.dtype), m.mask)
    logdet, quad, *_ = ExactCore.apply(Ky, Yc, m.jitter_hint, m.jitter_greedy)
    (g_ld,) = torch.autograd.grad(0.5 * Yc.shape[-1] * logdet.sum(), u, retain_graph=True)
    (g_q,) = torch.autograd.grad(0.5 * quad.sum(), u)
    return g_ld[0].numpy(), g_q[0].numpy()


@pytest.mark.slow
@pytest.mark.parametrize("leg", ["icm", "co2"])
def test_f32_lml_error_at_the_cards_fitted_point(leg):
    """The JAX package's own float32 -LML and gradient at the card's fitted
    leaves of phase 10's legs 1 and 2 (N = 4096), against float64: the
    readings behind those legs' limits. The port's float64 -LML equals the
    JAX package's there."""
    from gaussian_process_optimization_tpu.models import fit as jfit
    from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake

    from test_torch_kernel_zoo import spec_of

    from gaussian_process_optimization_tpu_torch import convert

    jm = _jax_model(leg)

    def value_and_grad(m):
        packer = jmake(m)
        obj = jfit.make_objective(packer)
        f, g = jax.value_and_grad(lambda uu: obj(uu, m))(packer.pack(m))
        return float(f), np.asarray(g, dtype=float)

    f64, g64 = value_and_grad(jm)
    with jax.enable_x64(False):
        f32, g32 = value_and_grad(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32), jm))
    tm = convert.gp_from_leaves(jax_leaves(jm, ""), kernel=spec_of(jm.kern), device="cpu")
    ld, q = _port_terms(tm)
    np.testing.assert_allclose(ld + q, g64, rtol=1e-6, atol=1e-6 * np.abs(ld).max())
    rel = abs(f32 - f64) / abs(f64)
    terms = np.maximum(np.abs(ld), np.abs(q))
    grad = float((np.abs(g32 - g64) / terms).max())
    print(f"{leg}: the JAX package's float32 at the card's fitted point: -LML {f32:.6f} vs "
          f"{f64:.6f} (rel {rel:.3e}); gradient max |g32 - g64| / |term| {grad:.3e}; per "
          f"component {np.round(np.abs(g32 - g64) / terms, 6).tolist()}")
    assert np.isfinite(f32) and np.isfinite(grad)


@pytest.mark.slow
def test_f32_error_of_the_grid_and_state_space_legs():
    """The JAX package's float32 -LML and gradient at phase 10's legs 3 and 4
    inputs (the 64 x 64 grid; the quasi-periodic state space at N = 4096), at
    their start, against float64: the readings behind those legs' limits."""
    from gaussian_process_optimization_tpu.models import fit as jfit
    from gaussian_process_optimization_tpu.models import state_space as jss
    from gaussian_process_optimization_tpu.models.gp_grid import GPGridRegression as JGrid
    from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake

    axes, Y = workload.grid_data()
    grid = JGrid.create(axes, Y, [jk.RBF.create(1, lengthscale=0.2) for _ in axes],
                        noise_var=0.05)
    t, y = workload.state_space_data()
    kern = (jk.Matern32.create(1, variance=0.5, lengthscale=5.0)
            + jk.StandardPeriodic.create(1, variance=1.0, period=2.0, lengthscale=1.0)
            * jk.Matern32.create(1, variance=1.0, lengthscale=10.0))
    ss = jss.from_kernel(kern, t, y, noise_var=0.01, order=7)

    def value_and_grad(m, fix=()):
        packer = jmake(m, fix=fix)
        obj = jfit.make_objective(packer)
        f, g = jax.jit(jax.value_and_grad(lambda uu: obj(uu, m)))(packer.pack(m))
        return float(f), np.asarray(g, dtype=float)

    for name, m, fix in (("grid", grid, ("axes",)), ("state space", ss, ())):
        f64, g64 = value_and_grad(m, fix)
        with jax.enable_x64(False):
            f32, g32 = value_and_grad(jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float32), m), fix)
        rel = abs(f32 - f64) / abs(f64)
        grel = float(np.abs(g32 - g64).max() / np.abs(g64).max())
        print(f"{name}: the JAX package's float32 at the start: -LML {f32:.6f} vs {f64:.6f} "
              f"(rel {rel:.3e}), gradient rel {grel:.3e} of max |g64| {np.abs(g64).max():.4g}")
        assert np.isfinite(f32) and np.isfinite(grel)
