"""Latent-space plots and offset-GP clustering (twin of
``examples/latent_plots_and_clustering.py``):

1. Fit a Bayesian GPLVM on three noisy views of a 1-D latent walk, then draw
   the latent plot family (GPy gpy_plot/latent_plots.py): ``plot_latent``,
   ``plot_steepest_gradient_map`` and the kernel's ``plot_ARD``.
2. Decode latent points with ``BayesianGPLVM.predict`` and place observations
   with ``infer_newX``.
3. Cluster series that are shifted copies of two curves with the greedy
   offset-GP ``cluster`` (GPy util/cluster_with_offset.py).

Run: python -m gaussian_process_optimization_tpu_torch.examples.latent_plots_and_clustering
"""
import numpy as np


def main(plot=True, outdir=".", seed=0, maxiter=150, device=None, dtype=None):
    from ..kernels.base import placement
    from ..models.gplvm import BayesianGPLVM, minimize_one
    from ..models.inference_x import infer_newX
    from ..models.parameters import make_packer
    from ..utils.cluster import cluster
    from ..utils.plotting_library import inject_plotting

    inject_plotting()
    new = placement(dtype, device)
    rng = np.random.default_rng(seed)

    # 1. the BGPLVM on three views of one latent walk
    t = np.sort(rng.uniform(-2, 2, 30))
    Y = np.stack([np.sin(t), np.cos(t), 0.5 * t], axis=1)
    Y += 0.05 * rng.standard_normal(Y.shape)

    m = BayesianGPLVM.create(Y, input_dim=2, num_inducing=10, seed=seed, **new)
    m, _ = minimize_one(make_packer(m), m, maxiter)
    print(f"BGPLVM ELBO after fit: {float(m.elbo()):.2f}")

    if plot:
        m.plot_latent(labels=(t > 0).astype(int), filename=f"{outdir}/latent.png",
                      resolution=25)
        m.plot_steepest_gradient_map(resolution=10, output_labels=["sin", "cos", "lin"],
                                     filename=f"{outdir}/steepest.png")
        m.kern.plot_ARD(filename=f"{outdir}/ard.png")

    # 2. decode, and place observations
    mu, _ = m.predict(m.q_mu[:5])
    rec = float(np.sqrt(np.mean((mu.detach().cpu().numpy()
                                 - m.Y[:5].detach().cpu().numpy()) ** 2)))
    print(f"decode reconstruction rmse (5 training rows): {rec:.3f}")

    q, _ = infer_newX(m, m.Y[:5], optimize=True, maxiter=100)
    loc_err = float((q.mean - m.q_mu[:5]).abs().max())
    print(f"infer_newX max |X* - X_train| on training rows: {loc_err:.3f}")

    # 3. offset-GP clustering
    tt = np.linspace(0, 3, 10)[:, None]
    curves = [np.sin(2 * tt), np.sin(2 * (tt - 0.4)), 2.0 - 2.0 * tt, 2.0 - 2.0 * (tt - 0.4)]
    data = [c.T + 0.01 * rng.standard_normal((1, 10)) for c in curves]
    inputs = [tt.copy() for _ in curves]
    groups = cluster(data, inputs, maxiter=60, device=device, dtype=dtype)
    print("clusters found:", [sorted(g) for g in groups])
    return m, rec, loc_err, groups


if __name__ == "__main__":
    main()
