"""Dimensionality-reduction gallery (twin of
``examples/gallery/dimensionality_reduction.py``; GPy
examples/dimensionality_reduction.py, the GPLVM family).

GPLVM, Bayesian GPLVM, sparse, back-constrained and spike-and-slab GPLVMs and
MRD on the reference's simulated outputs; the dataset demos (oil flow, mocap
sticks, swiss roll) use its synthetic stand-ins of the same shape.
"""
import numpy as np

from ... import kernels as kern
from ...kernels.base import placement
from ...models import fit as fit_mod
from ...models.gplvm import BayesianGPLVM, fit_gplvm, make_gplvm
from .._util import generator


def _simulate_sincos(N=40, D1=6, D2=5, D3=4, seed=0):
    """The reference's _simulate_sincos (dimensionality_reduction.py:257): three
    views driven by shared sin / cos latents plus private signals."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, N)
    s1, s2, s3 = np.sin(t), np.cos(t), np.sin(2 * t)
    S1 = np.stack([s1, s2], 1) @ rng.standard_normal((2, D1))
    S2 = np.stack([s1, s3], 1) @ rng.standard_normal((2, D2))
    S3 = np.stack([s2], 1) @ rng.standard_normal((1, D3))
    noise = 0.05
    Ys = [S + noise * rng.standard_normal(S.shape) for S in (S1, S2, S3)]
    return [Y - Y.mean(0) for Y in Ys]


def _oil_like(N=60, D=12, seed=1):
    """Oil-flow stand-in: 3 latent classes in D dimensions, and the labels."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, D)) * 2.0
    labels = rng.integers(0, 3, N)
    Y = centers[labels] + 0.3 * rng.standard_normal((N, D))
    return Y - Y.mean(0), labels


def _fit_bgplvm(m, maxiter):
    fitted, _ = fit_mod.fit(m, num_restarts=1, maxiter=maxiter,
                            generator=generator(0, m.Y.device))
    return fitted


def bgplvm_test_model(optimize=False, verbose=0, plot=False, output_dim=20, nan=False,
                      device=None, dtype=None):
    """dimensionality_reduction.py:8: a BayesianGPLVM on simulated data with a
    finite bound."""
    new = placement(dtype, device)
    Ys = _simulate_sincos(N=30, D1=output_dim, D2=4, D3=4)
    m = BayesianGPLVM.create(Ys[0], input_dim=3, num_inducing=8, **new)
    assert np.isfinite(float(m.log_marginal_likelihood()))
    if optimize:
        m = _fit_bgplvm(m, maxiter=60)
    return m


def gplvm_oil_100(optimize=True, verbose=0, plot=False, max_iters=80, device=None,
                  dtype=None):
    """dimensionality_reduction.py:71: the point GPLVM on the oil stand-in."""
    new = placement(dtype, device)
    Y, _ = _oil_like(N=50)
    m = make_gplvm(Y, input_dim=2, kernel=kern.RBF.create(2, ARD=True, **new), **new)
    if optimize:
        m, _ = fit_gplvm(m, maxiter=max_iters)
    return m


def sparse_gplvm_oil(optimize=True, verbose=0, plot=False, N=50, Q=2, num_inducing=10,
                     max_iters=50, device=None, dtype=None):
    """dimensionality_reduction.py:84: the sparse GPLVM (inducing points)."""
    from ...models.zoo import fit_sparse_gplvm

    Y, _ = _oil_like(N=N)
    m, _ = fit_sparse_gplvm(Y, input_dim=Q, num_inducing=num_inducing,
                            maxiter=max_iters if optimize else 0, device=device, dtype=dtype)
    return m


def swiss_roll(optimize=True, verbose=0, plot=False, N=80, num_inducing=12, Q=3, sigma=0.2,
               max_iters=60, device=None, dtype=None):
    """dimensionality_reduction.py:104: a BGPLVM on a swiss roll made here."""
    new = placement(dtype, device)
    rng = np.random.default_rng(3)
    t = 1.5 * np.pi * (1 + 2 * rng.uniform(size=N))
    h = 21 * rng.uniform(size=N)
    Y = np.stack([t * np.cos(t), h, t * np.sin(t)], 1)
    Y = (Y - Y.mean(0)) / Y.std(0) + sigma * rng.standard_normal((N, 3))
    m = BayesianGPLVM.create(Y, input_dim=Q, num_inducing=num_inducing, **new)
    if optimize:
        m = _fit_bgplvm(m, maxiter=max_iters)
    return m


def bgplvm_oil(optimize=True, verbose=0, plot=False, N=50, Q=3, num_inducing=10,
               max_iters=60, device=None, dtype=None, **k):
    """dimensionality_reduction.py:161: the Bayesian GPLVM with ARD on the oil
    stand-in."""
    new = placement(dtype, device)
    Y, _ = _oil_like(N=N)
    m = BayesianGPLVM.create(Y, input_dim=Q, num_inducing=num_inducing,
                             kernel=kern.RBF.create(Q, ARD=True, **new), **new)
    if optimize:
        m = _fit_bgplvm(m, maxiter=max_iters)
    return m


def ssgplvm_oil(optimize=True, verbose=0, plot=False, N=40, Q=3, num_inducing=8,
                max_iters=60, device=None, dtype=None, **k):
    """dimensionality_reduction.py:191: the spike-and-slab GPLVM."""
    from ...models.ss_gplvm import SSGPLVM, fit_ssgplvm

    Y, _ = _oil_like(N=N)
    m = SSGPLVM.create(Y, input_dim=Q, num_inducing=num_inducing, device=device, dtype=dtype)
    if optimize:
        m, _ = fit_ssgplvm(m, maxiter=max_iters)
    return m


def bgplvm_simulation(optimize=True, verbose=0, plot=False, plot_sim=False, max_iters=60,
                      device=None, dtype=None):
    """dimensionality_reduction.py:321: the BGPLVM on the simulated views."""
    new = placement(dtype, device)
    Ys = _simulate_sincos()
    m = BayesianGPLVM.create(Ys[0], input_dim=4, num_inducing=10,
                             kernel=kern.RBF.create(4, ARD=True, **new), **new)
    if optimize:
        m = _fit_bgplvm(m, maxiter=max_iters)
    return m


def gplvm_simulation(optimize=True, verbose=0, plot=False, plot_sim=False, max_iters=80,
                     device=None, dtype=None):
    """dimensionality_reduction.py:346: the point GPLVM on the same simulation."""
    new = placement(dtype, device)
    Ys = _simulate_sincos()
    m = make_gplvm(Ys[0], input_dim=2, kernel=kern.RBF.create(2, ARD=True, **new), **new)
    if optimize:
        m, _ = fit_gplvm(m, maxiter=max_iters)
    return m


def ssgplvm_simulation(optimize=True, verbose=0, plot=False, plot_sim=False, max_iters=50,
                       device=None, dtype=None):
    """dimensionality_reduction.py:369: the spike-and-slab GPLVM, simulation."""
    from ...models.ss_gplvm import SSGPLVM, fit_ssgplvm

    Ys = _simulate_sincos(N=30)
    m = SSGPLVM.create(Ys[0], input_dim=3, num_inducing=8, device=device, dtype=dtype)
    if optimize:
        m, _ = fit_ssgplvm(m, maxiter=max_iters)
    return m


def ssgplvm_simulation_linear(max_iters=40, optimize=True, plot=False, device=None,
                              dtype=None):
    """dimensionality_reduction.py:702: the SS-GPLVM on linearly generated data."""
    from ...models.ss_gplvm import SSGPLVM, fit_ssgplvm

    rng = np.random.default_rng(4)
    X = rng.standard_normal((30, 2))
    W = rng.standard_normal((2, 8))
    Y = X @ W + 0.05 * rng.standard_normal((30, 8))
    m = SSGPLVM.create(Y - Y.mean(0), input_dim=3, num_inducing=8, device=device, dtype=dtype)
    if optimize:
        m, _ = fit_ssgplvm(m, maxiter=max_iters)
    return m


def bgplvm_simulation_missing_data(optimize=True, verbose=0, plot=False, max_iters=50,
                                   percent_missing=0.3, device=None, dtype=None):
    """dimensionality_reduction.py:394: the missing-data bound, entries of Y
    absent per (point, output) and marginalized by the per-output VarDTC bound
    (``SparseGPRegression.missing_data_lml``) on PCA latents."""
    from ...models.gplvm import minimize_one
    from ...models.parameters import make_packer
    from ...models.sparse import SparseGPRegression

    new = placement(dtype, device)
    Ys = _simulate_sincos(N=30)
    Y = Ys[0]
    rng = np.random.default_rng(5)
    mask = (rng.uniform(size=Y.shape) > percent_missing).astype(float)
    # PCA latents as fixed inputs (the point-estimate limit of the demo)
    Yc = Y - Y.mean(0)
    _, _, Vt = np.linalg.svd(Yc, full_matrices=False)
    X0 = Yc @ Vt[:3].T
    m = SparseGPRegression.create(X0, np.where(mask > 0, Y, 0.0),
                                  kernel=kern.RBF.create(3, ARD=True, **new),
                                  num_inducing=8, noise_var=0.1, **new)
    assert np.isfinite(float(m.missing_data_lml(mask)))
    if optimize:
        packer = make_packer(m)
        m, _ = minimize_one(packer, m, max_iters, objective=lambda u: -packer.unpack(
            u, reference=m).missing_data_lml(mask))
    return m


def bgplvm_simulation_missing_data_stochastics(optimize=True, verbose=0, plot=False,
                                               max_iters=40, batch=16, device=None,
                                               dtype=None):
    """dimensionality_reduction.py:424: the minibatch (SVI) variant, Adam in
    place of the reference's climin schedules."""
    from ...models.bgplvm_svi import BGPLVM_SVI, fit_bgplvm_svi

    Ys = _simulate_sincos(N=32)
    m = BGPLVM_SVI.create(Ys[0], input_dim=3, num_inducing=8, device=device, dtype=dtype)
    if optimize:
        m, _ = fit_bgplvm_svi(m, steps=max_iters, batch=batch,
                              generator=np.random.default_rng(0))
    return m


def mrd_simulation(optimize=True, verbose=0, plot=False, plot_sim=False, max_iters=60,
                   device=None, dtype=None, **kw):
    """dimensionality_reduction.py:455: Manifold Relevance Determination; the
    views share a latent space and per-view ARD separates shared from private
    latents."""
    from ...models.mrd import MRD, fit_mrd

    Ys = _simulate_sincos(N=30)
    m = MRD.create(Ys, input_dim=4, num_inducing=8, device=device, dtype=dtype)
    if optimize:
        m, _ = fit_mrd(m, maxiter=max_iters)
    return m


def mrd_simulation_missing_data(optimize=True, verbose=0, plot=False, plot_sim=False,
                                max_iters=40, device=None, dtype=None, **kw):
    """dimensionality_reduction.py:475: MRD with a fifth of view 0's entries
    replaced by their column means."""
    from ...models.mrd import MRD, fit_mrd

    Ys = _simulate_sincos(N=24)
    rng = np.random.default_rng(6)
    mask = rng.uniform(size=Ys[0].shape) < 0.2
    Y0 = np.where(mask, Ys[0].mean(0, keepdims=True), Ys[0])
    m = MRD.create([Y0] + Ys[1:], input_dim=4, num_inducing=8, device=device, dtype=dtype)
    if optimize:
        m, _ = fit_mrd(m, maxiter=max_iters)
    return m


def stick_bgplvm(model=None, optimize=True, verbose=0, plot=False, max_iters=50,
                 device=None, dtype=None):
    """dimensionality_reduction.py:640: a BGPLVM on motion-capture-like joint
    angle curves (synthetic stick figure)."""
    new = placement(dtype, device)
    rng = np.random.default_rng(7)
    t = np.linspace(0, 2 * np.pi, 40)
    joints = np.stack([np.sin(2 * t + p) for p in rng.uniform(0, np.pi, 12)], 1)
    Y = joints + 0.03 * rng.standard_normal(joints.shape)
    m = BayesianGPLVM.create(Y, input_dim=2, num_inducing=10,
                             kernel=kern.RBF.create(2, ARD=True, **new), **new)
    if optimize:
        m = _fit_bgplvm(m, maxiter=max_iters)
    return m


def bcgplvm_linear_stick(kernel=None, optimize=True, verbose=0, plot=False, max_iters=50,
                         device=None, dtype=None):
    """dimensionality_reduction.py:585: the back-constrained GPLVM with the
    default back-mapping (the ``fit_bcgplvm`` MLP, as the reference's)."""
    from ...models.zoo import fit_bcgplvm

    rng = np.random.default_rng(8)
    t = np.linspace(0, 2 * np.pi, 36)
    Y = np.stack([np.sin(2 * t + p) for p in rng.uniform(0, np.pi, 8)], 1)
    m, _, _ = fit_bcgplvm(Y, input_dim=2, maxiter=max_iters if optimize else 0,
                          device=device, dtype=dtype)
    return m


def bcgplvm_stick(kernel=None, optimize=True, verbose=0, plot=False, max_iters=50,
                  device=None, dtype=None):
    """dimensionality_reduction.py:605: the back-constrained GPLVM with a
    kernel back-mapping X = K(Y, Y) A."""
    from ...models.mean_functions import KernelMapping
    from ...models.zoo import fit_bcgplvm

    new = placement(dtype, device)
    rng = np.random.default_rng(9)
    t = np.linspace(0, 2 * np.pi, 36)
    Y = np.stack([np.sin(2 * t + p) for p in rng.uniform(0, np.pi, 8)], 1)
    mapping = KernelMapping.create(Y.shape[1], 2, Z=Y,
                                   kernel=kern.RBF.create(Y.shape[1], **new), **new)
    m, _, _ = fit_bcgplvm(Y, input_dim=2, mapping=mapping,
                          maxiter=max_iters if optimize else 0, **new)
    return m


def robot_wireless(optimize=True, verbose=0, plot=False, max_iters=60, device=None,
                   dtype=None):
    """dimensionality_reduction.py:626: the GPLVM recovers the robot's path from
    WiFi signal strengths (synthetic, as in regression)."""
    new = placement(dtype, device)
    rng = np.random.default_rng(10)
    path = np.linspace(0, 2 * np.pi, 50)
    pos = np.stack([np.cos(path), np.sin(path)], 1)
    aps = rng.uniform(-1.5, 1.5, (6, 2))
    d = np.linalg.norm(pos[:, None, :] - aps[None], axis=-1)
    Y = -30 - 20 * np.log10(d + 0.1) + 0.5 * rng.standard_normal(d.shape)
    Y = (Y - Y.mean(0)) / Y.std(0)
    m = make_gplvm(Y, input_dim=2, kernel=kern.RBF.create(2, ARD=True, **new), **new)
    if optimize:
        m, _ = fit_gplvm(m, maxiter=max_iters)
    return m
