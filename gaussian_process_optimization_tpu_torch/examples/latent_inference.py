"""A feature tour (twin of ``examples/latent_inference.py``): latent-X inference
for new observations (``infer_newX``) on a GPLVM, a row with a missing entry
included, and the MCMC samplers' tail (Metropolis-Hastings with Gelman tuning,
HMC with the shortcut test).

Run: python -m gaussian_process_optimization_tpu_torch.examples.latent_inference
"""
import numpy as np
import torch

from ..kernels.base import placement
from ._util import generator, to_numpy


def _spiral(n=40, seed=3):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(-2, 2, n))
    Y = np.stack([np.sin(t), np.cos(t), t, 0.5 * t**2], axis=1)
    return t, Y + 0.03 * rng.standard_normal(Y.shape)


def infer_newx_demo(n=40, seed=3, maxiter=300, device=None, dtype=None):
    """Train a point GPLVM, then place held-out observations in its latent
    space (GPy infer_newX), one batched L-BFGS over all rows; one row has a
    missing (NaN) entry, which the reference takes one row at a time
    (inferenceX.py:47). Returns the reconstruction RMSE."""
    from ..models.gplvm import fit_gplvm, make_gplvm
    from ..models.inference_x import infer_newX

    new = placement(dtype, device)
    _, Y = _spiral(n, seed)
    train = np.arange(n) % 5 != 0
    model, _ = fit_gplvm(make_gplvm(Y[train], input_dim=1, **new), maxiter=maxiter)

    Y_new = Y[~train].copy()
    Y_new[0, 1] = np.nan
    x_star, _ = infer_newX(model, torch.as_tensor(Y_new, **new), maxiter=maxiter)
    y_rec, _ = model.predict(x_star)
    valid = ~np.isnan(Y_new)
    err = to_numpy(y_rec) - np.where(valid, Y_new, 0.0)
    return float(np.sqrt(np.mean(np.square(err[valid]))))


def mcmc_tail_demo(num_samples=2000, seed=0, device=None, dtype=None):
    """The MCMC samplers' tail on a correlated Gaussian target: random-walk MH
    with Gelman tuning (samplers.py:18) and HMC with the shortcut trajectory
    test (hmc.py:70) agree on the posterior mean."""
    from ..models.hmc import hmc_shortcut_sample, metropolis_hastings

    new = placement(dtype, device)
    mu = torch.tensor([1.0, -2.0], **new)
    prec = torch.tensor([[2.0, 0.3], [0.3, 1.0]], **new)

    def logpost(u):
        d = u - mu
        return -0.5 * d @ prec @ d

    s_mh, rate, _, _ = metropolis_hastings(
        logpost, torch.zeros(2, **new), num_samples=num_samples, burnin=num_samples // 5,
        thin=4, generator=generator(seed, new["device"]))
    s_hmc, _ = hmc_shortcut_sample(
        lambda u: -logpost(u), torch.zeros(2, **new), num_samples=num_samples // 2,
        stepsize_range=(1e-3, 0.5), leapfrog_steps=10, generator=generator(seed + 1, new["device"]))
    m_mh = to_numpy(s_mh).mean(0)
    m_hmc = to_numpy(s_hmc[num_samples // 8:]).mean(0)
    return m_mh, m_hmc, float(rate)


if __name__ == "__main__":
    rmse = infer_newx_demo()
    print(f"infer_newX held-out reconstruction RMSE (incl. a NaN entry): {rmse:.4f}")
    m_mh, m_hmc, rate = mcmc_tail_demo()
    print(f"MH posterior mean {np.round(m_mh, 2)} (accept {rate:.2f}); "
          f"HMC-shortcut mean {np.round(m_hmc, 2)}; target [1, -2]")
