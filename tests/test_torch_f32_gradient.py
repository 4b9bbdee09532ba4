"""The float32 -LML gradient at a fitted point, the port against the JAX package
on the CPU: each package's float32 gradient is held against its own float64
gradient at the same parameters, and the port's relative error must stay within
twice the JAX package's. At a fitted point each gradient component is a small
difference of large terms, so float32 cannot resolve it well in either package;
this separates what float32 costs from what the port adds.

The error is rounding noise: over these eight points it runs 6.7e-4 to 1.7e-2
in the port and 1.4e-3 to 1.5e-2 in the JAX package (jitted, as its Fitter
runs), one package ahead at one point and the other at the next. So the check
is on the mean over the points.

The fitted points are the JAX package's own fit of the main path's model (ARD
Matern52, noise 0.05 to start) on the bench's data recipe at N = 256: its
Fitter, 5 restarts of 30 L-BFGS steps with tol 0, PRNGKey(0), in float64, for
data seeds 0 to 7. The fitted leaves are written out below so that the test
does not pay for the JAX fit's compilation; both packages' models are built from
them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu_torch import convert, workload
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from torch_threads import one_torch_thread  # noqa: F401

FITTED = {
    0: (1.1860471489195303, [1.226745941292863, 304.5739057627313, 166.30057109035968,
                             172.32937981530654, 431.9937771656171, 354.46177868242984],
        0.047288408617839325),
    1: (2.3509257026229227, [1.6376154386682322, 169.61798479368852, 280.3550922141716,
                             181.01509952811324, 309.30662775223334, 206.47640479735395],
        0.04387644063375299),
    2: (1.4940545512174783, [1.439033086809639, 100.0976973821651, 84.82412647832324,
                             79.79282368883834, 124.1544460593589, 110.09987469031786],
        0.04534204421914857),
    3: (0.5850198830736085, [0.8871294121967902, 33.77603311115413, 29.548963316665073,
                             34.230380530048514, 25.89627312973551, 32.64534499414927],
        0.03949609176997743),
    4: (2.462712481426709, [1.7129392787877387, 137.1203841053681, 113.57067942069897,
                            123.31449621140216, 144.53263405634107, 79.21012081321979],
        0.044483766881351985),
    5: (3.5488766688312263, [1.8174097401571354, 116.12274728112251, 583.3020849153877,
                             566.1161413531993, 594.5343512829365, 517.1555879512721],
        0.04994956870358416),
    6: (1.9960798182092279, [1.5643167614592897, 218.30100878080748, 232.05745222442903,
                             304.52918664742026, 284.245886191149, 225.11240897072233],
        0.04808081165615265),
    7: (2.7413693669162646, [1.697564452464409, 123.90048248365852, 211.42300232161375,
                             200.967538460382, 292.4166374534298, 230.02108105716707],
        0.05040823593654933),
}


def _jax_model(seed):
    variance, lengthscale, noise = FITTED[seed]
    X, Y = workload.bench_data(n=256, seed=seed)
    kern = jk.Matern52.create(6, variance=variance, lengthscale=np.asarray(lengthscale),
                              ARD=True)
    return JGP.create(X, Y, kernel=kern, noise_var=noise, max_points=256)


_JAX_GRADS = {}


def _jax_grad(m):
    """The JAX objective's jitted gradient, one program per dtype (every point
    has the same structure)."""
    packer = jmake_packer(m)
    dtype = m.X.dtype
    if dtype not in _JAX_GRADS:
        _JAX_GRADS[dtype] = jax.jit(jax.grad(jfit.make_objective(packer)))
    return np.asarray(_JAX_GRADS[dtype](packer.pack(m), m), dtype=float)


def _port_grad(leaves, dtype):
    model = convert.gp_from_leaves(leaves, dtype=dtype, device="cpu")
    packer = make_packer(model)
    u = packer.pack(model)[None].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(make_objective(packer)(u, model)[0], u)
    return g[0].double().numpy()


def _rel(g32, g64):
    return float(np.abs(g32 - g64).max() / np.abs(g64).max())


def _errors(seed):
    """(rel error of the JAX f32 gradient, of the port's), each against its own
    float64 gradient; the two float64 gradients agree to 1e-8."""
    jm = _jax_model(seed)
    j64 = _jax_grad(jm)
    j32 = _jax_grad(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jm))
    leaves = {"kern.variance": jm.kern.variance, "kern.lengthscale": jm.kern.lengthscale,
              "likelihood_variance": jm.likelihood_variance, "X": jm.X, "Y": jm.Y,
              "mask": jm.mask}
    leaves = {k: np.asarray(v) for k, v in leaves.items()}
    t64, t32 = _port_grad(leaves, torch.float64), _port_grad(leaves, torch.float32)
    np.testing.assert_allclose(t64, j64, rtol=1e-8, atol=1e-8 * np.abs(j64).max())
    return _rel(j32, j64), _rel(t32, t64)


def test_f32_gradient_error_is_the_references():
    errors = np.array([_errors(seed) for seed in FITTED])
    for seed, (rel_jax, rel_port) in zip(FITTED, errors):
        print(f"seed {seed}: f32 gradient rel error JAX {rel_jax:.4e}, port {rel_port:.4e}")
    mean_jax, mean_port = errors.mean(axis=0)
    print(f"mean over {len(FITTED)} points: JAX {mean_jax:.4e}, port {mean_port:.4e}")
    assert mean_port <= 2.0 * mean_jax
    assert np.all(errors < 0.1)
