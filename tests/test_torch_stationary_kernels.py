"""The torch port's stationary kernels and K-build / K-backward kernels against
the JAX package.

The JAX side runs as its own tests run it: the Pallas tile kernels in
interpreter mode on the CPU (tests/test_pallas_kernels.py), the plain path in
float64. The port's kernel wrappers take their plain PyTorch versions for CPU
tensors; the CUDA kernels themselves are held against those plain versions in
tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jkern
import gaussian_process_optimization_tpu_torch.kernels as tkern
from gaussian_process_optimization_tpu.config import config as jconfig
from gaussian_process_optimization_tpu.ops import pallas_kernels as pk
from gaussian_process_optimization_tpu_torch.config import config as tconfig
from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck
from gaussian_process_optimization_tpu_torch.utils.profiling import counters
from torch_threads import one_torch_thread  # noqa: F401

FAMILIES = [("rbf", "RBF"), ("exponential", "Exponential"), ("ou", "OU"),
            ("matern32", "Matern32"), ("matern52", "Matern52"), ("cosine", "Cosine"),
            ("ratquad", "RatQuad")]
CASES = [(fam, cls, ard) for fam, cls in FAMILIES for ard in (False, True)]
IDS = [f"{fam}-{'ard' if ard else 'iso'}" for fam, _, ard in CASES]


@pytest.fixture
def interpret_mode():
    old = jconfig.pallas_interpret, jconfig.use_pallas
    jconfig.pallas_interpret = True
    jconfig.use_pallas = False
    yield
    jconfig.pallas_interpret, jconfig.use_pallas = old


def _kernels(cls_name, d, ard, jdtype, tdtype, variance=1.3, power=1.5):
    ls = np.array([0.7, 1.4, 0.9, 1.1][:d]) if ard else 0.8
    jcls, tcls = getattr(jkern, cls_name), getattr(tkern, cls_name)
    if cls_name == "RatQuad":
        jk = jcls.create(d, variance=variance, lengthscale=ls, power=power, ARD=ard)
        tk = tcls.create(d, variance=variance, lengthscale=ls, power=power, ARD=ard,
                         dtype=tdtype, device="cpu")
    else:
        jk = jcls.create(d, variance=variance, lengthscale=ls, ARD=ard)
        tk = tcls.create(d, variance=variance, lengthscale=ls, ARD=ard, dtype=tdtype,
                         device="cpu")
    jk = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype=jdtype), jk)
    return jk, tk


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("fam,cls_name,ard", CASES, ids=IDS)
def test_k_build_plain_matches_pallas_interpret(fam, cls_name, ard, rng, interpret_mode):
    """B1's plain version against the Pallas tile in interpret mode, f32, at
    the tolerances of tests/test_pallas_kernels.py:49."""
    d = 3
    X = rng.uniform(-3, 3, size=(70, d)).astype(np.float32)
    Z = rng.uniform(-3, 3, size=(40, d)).astype(np.float32)
    jk, tk = _kernels(cls_name, d, ard, jnp.float32, torch.float32)
    K_j = np.asarray(pk.stationary_K(jk, jnp.asarray(X), jnp.asarray(Z)))
    K_t = ck.stationary_K(tk, _t(X), _t(Z)).numpy()
    np.testing.assert_allclose(K_t, K_j, rtol=2e-5, atol=2e-6)
    # symmetric case: exactly symmetric, exact variance diagonal
    S_j = np.asarray(pk.stationary_K(jk, jnp.asarray(X), None))
    S_t = ck.stationary_K(tk, _t(X)).numpy()
    np.testing.assert_allclose(S_t, S_j, rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(S_t, S_t.T)
    np.testing.assert_allclose(np.diag(S_t), 1.3, rtol=1e-6)


@pytest.mark.parametrize("fam,cls_name,ard", CASES, ids=IDS)
def test_K_and_Kdiag_match_jax_f64(fam, cls_name, ard, rng):
    """The port's plain path (the matmul distance, safe_sqrt, K_of_r2) against
    the JAX package's in float64."""
    d = 4
    X = rng.uniform(-2, 2, size=(25, d))
    Z = rng.uniform(-2, 2, size=(17, d))
    jk, tk = _kernels(cls_name, d, ard, jnp.float64, torch.float64)
    for args_j, args_t in (((X, Z), (_t(X, torch.float64), _t(Z, torch.float64))),
                           ((X,), (_t(X, torch.float64),))):
        K_j = np.asarray(jk.K(*[jnp.asarray(a) for a in args_j]))
        K_t = tk.K(*args_t).numpy()
        np.testing.assert_allclose(K_t, K_j, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tk.Kdiag(_t(X, torch.float64)).numpy(),
                               np.asarray(jk.Kdiag(jnp.asarray(X))), rtol=1e-12)


def _torch_grads(tk, X, Z, G, fwd):
    """(dvariance, dlengthscale, dpower, dX, dZ) of sum(K * G) with K = fwd(...);
    ``Z`` None leaves dZ out and hands ``fwd`` None."""
    leaves = {"variance": tk.variance.clone().requires_grad_(True),
              "lengthscale": tk.lengthscale.clone().requires_grad_(True)}
    if getattr(tk, "power", None) is not None:
        leaves["power"] = tk.power.clone().requires_grad_(True)
    k = dataclasses.replace(tk, **leaves)
    Xt = _t(X).requires_grad_(True)
    Zt = None if Z is None else _t(Z).requires_grad_(True)
    loss = torch.sum(fwd(k, Xt, Zt) * _t(G))
    points = {"X": Xt} if Z is None else {"X": Xt, "Z": Zt}
    grads = torch.autograd.grad(loss, list(leaves.values()) + list(points.values()))
    return dict(zip(list(leaves) + list(points), [g.numpy() for g in grads]))


def _plain_fwd(k, X, Z):
    ard = k.is_ard
    params = ck.params_rows(k, X.shape[-1], ard)
    return ck.k_build_plain(X[None], Z[None], params, k._family, ard)[0]


def _check_grads_against_jax(fam, cls_name, ard, X, Z, G):
    """Gradients of sum(K * G) through the port's stationary_K against jax.grad
    through the Pallas path in interpret mode, and against torch autograd
    through the plain forward (tolerances of test_pallas_kernels.py). ``Z`` None
    is the symmetric case K(X); there autograd through the plain forward's
    sqrt is undefined on the diagonal (r = 0) and only jax.grad is the reference."""
    jk, tk = _kernels(cls_name, X.shape[1], ard, jnp.float32, torch.float32)
    if Z is None:
        def loss(kk, Xv):
            return jnp.sum(pk.stationary_K(kk, Xv, None) * G)

        gk, gX = jax.grad(loss, argnums=(0, 1))(jk, jnp.asarray(X))
        ours = _torch_grads(tk, X, None, G, ck.stationary_K)
        auto = None
        ref = {"X": gX}
    else:
        def loss(kk, Xv, Zv):
            return jnp.sum(pk.stationary_K(kk, Xv, Zv) * G)

        gk, gX, gZ = jax.grad(loss, argnums=(0, 1, 2))(jk, jnp.asarray(X), jnp.asarray(Z))
        ours = _torch_grads(tk, X, Z, G, ck.stationary_K)
        auto = _torch_grads(tk, X, Z, G, _plain_fwd)
        ref = {"X": gX, "Z": gZ}
    ref.update(variance=gk.variance, lengthscale=gk.lengthscale)
    if fam == "ratquad":
        ref["power"] = gk.power
    for name, want in ref.items():
        np.testing.assert_allclose(ours[name], np.asarray(want), rtol=3e-4, atol=3e-4,
                                   err_msg=name)
        if auto is not None:
            np.testing.assert_allclose(ours[name], auto[name], rtol=3e-4, atol=3e-4,
                                       err_msg=name)


@pytest.mark.parametrize("fam,cls_name,ard", CASES, ids=IDS)
def test_k_backward_plain_matches_jax_grad(fam, cls_name, ard, rng, interpret_mode):
    """B2's plain backward (dvariance, dlengthscale, dpower, dX, dZ) against
    jax.grad through the Pallas path in interpret mode, and against torch
    autograd through the plain forward (tolerances of test_pallas_kernels.py)."""
    d = 3
    X = rng.uniform(-2, 2, size=(40, d)).astype(np.float32)
    Z = rng.uniform(-2, 2, size=(25, d)).astype(np.float32)
    G = rng.standard_normal((40, 25)).astype(np.float32)
    _check_grads_against_jax(fam, cls_name, ard, X, Z, G)


@pytest.mark.parametrize("fam,cls_name,ard", CASES, ids=IDS)
def test_symmetric_K_gradient_with_nonsymmetric_G_matches_jax(fam, cls_name, ard, rng,
                                                              interpret_mode):
    """K(X) hands its upstream gradient to B2 as it is, where the reference
    routes it through (K + K^T) / 2: with a deliberately non-symmetric G the
    gradients (parameters, and X through both of its roles) still match
    jax.grad, so the dropped mirror pass changes nothing."""
    d = 3
    X = rng.uniform(-2, 2, size=(40, d)).astype(np.float32)
    G = rng.standard_normal((40, 40)).astype(np.float32)
    assert np.abs(G - G.T).max() > 1.0
    _check_grads_against_jax(fam, cls_name, ard, X, None, G)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("fam,cls_name,ard", CASES, ids=IDS)
def test_k_build_plain_is_bitwise_symmetric(fam, cls_name, ard, dtype, rng):
    """k_build_plain(X, X) equals its transpose bit for bit, with the variance
    exactly on the diagonal: what lets stationary_K skip (K + K^T) / 2. The
    CUDA kernel is held to the same in tests/test_torch_cuda_kernels.py."""
    d = 4
    X = torch.tensor(rng.uniform(-3, 3, size=(1, 90, d)), dtype=dtype)
    _, tk = _kernels(cls_name, d, ard, jnp.float32, dtype)
    params = ck.params_rows(tk, d, ard)
    K = ck.k_build_plain(X, X, params, fam, ard)
    assert torch.equal(K, K.mT)
    assert torch.equal(torch.diagonal(K[0]), params[0, 0].expand(90))
    # the routed entry returns exactly this matrix
    assert torch.equal(ck.stationary_K(tk, X[0]), K[0])


@pytest.mark.parametrize("ard", [False, True])
def test_lane_batched_call_equals_single_lane_calls(ard, rng):
    """A (B=3)-lane call (lane-batched hyperparameters, shared X) equals three
    single-lane calls, forward and backward."""
    d = 3
    X = _t(rng.uniform(-2, 2, size=(30, d)))
    Z = _t(rng.uniform(-2, 2, size=(20, d)))
    G = _t(rng.standard_normal((3, 30, 20)))
    var = torch.tensor([0.5, 1.0, 2.0])
    ls = _t(rng.uniform(0.5, 2.0, size=(3, d) if ard else (3,)))
    pw = torch.tensor([0.5, 1.5, 3.0])

    def lane_grads(v, lsv, p, Gs):
        v, lsv, p = (t.clone().requires_grad_(True) for t in (v, lsv, p))
        k = tkern.RatQuad(input_dim=d, variance=v, lengthscale=lsv, power=p)
        K = ck.stationary_K(k, X, Z)
        return K.detach(), torch.autograd.grad(torch.sum(K * Gs), (v, lsv, p))

    K3, g3 = lane_grads(var, ls, pw, G)
    assert K3.shape == (3, 30, 20)
    for lane in range(3):
        K1, g1 = lane_grads(var[lane], ls[lane], pw[lane], G[lane])
        torch.testing.assert_close(K3[lane], K1, rtol=1e-6, atol=1e-7)
        for a, b in zip(g3, g1):
            torch.testing.assert_close(a[lane], b, rtol=1e-5, atol=1e-6)


def test_gate_is_per_lane():
    """supports() sees the per-lane shape, as the reference does under vmap:
    stacking 5 one-point anchors into a (5, 1, D) batch keeps the plain route."""
    old = tconfig.use_cuda_kernels
    tconfig.use_cuda_kernels = True
    try:
        k = tkern.Matern52.create(6, ARD=True, dtype=torch.float32, device="cpu")
        X = torch.zeros(4096, 6)
        assert ck.supports(k, X, torch.zeros(1000, 6))
        assert ck.supports(k, X, None)
        assert not ck.supports(k, X, torch.zeros(5, 1, 6))
        assert not ck.supports(k, X[:100], torch.zeros(100, 6))
        assert not ck.supports(k, X.double(), torch.zeros(1000, 6).double())
        assert not ck.supports(k, torch.zeros(200, 65), None)
    finally:
        tconfig.use_cuda_kernels = old
    # 'auto' on the CPU: the plain path
    assert not ck.supports(tkern.RBF.create(2, dtype=torch.float32, device="cpu"),
                           torch.zeros(300, 2), None)


def test_kernel_wrappers_route_cpu_tensors_to_plain(rng):
    """On CPU tensors the wrappers never launch (their counters stay put)."""
    X = _t(rng.uniform(-1, 1, size=(20, 3)))[None]
    params = torch.tensor([[1.0, 0.0, 0.5, 0.5, 0.5, 0.0, 0.0, 0.0]])
    before = counters["b1.launches"], counters["b2.launches"]
    K = ck.stationary_k_build(X, X, params, "matern52", True)
    ck.stationary_k_backward(X, X, params, torch.ones_like(K), "matern52", True)
    assert (counters["b1.launches"], counters["b2.launches"]) == before
