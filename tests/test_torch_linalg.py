"""The torch port's dense linear algebra and triangular-inverse kernel against
the JAX package: the plain version of the block-inverse kernel against the
Pallas kernel in interpret mode, the blocked solves and inverses in float64,
and the jitter ladder lane by lane."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_optimization_tpu.config import config as jconfig
from gaussian_process_optimization_tpu.ops import linalg as jlinalg
from gaussian_process_optimization_tpu.ops import pallas_linalg as pli
from gaussian_process_optimization_tpu_torch.config import config as tconfig
from gaussian_process_optimization_tpu_torch.ops import cuda_linalg
from gaussian_process_optimization_tpu_torch.ops import linalg as tlinalg
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def interpret_mode():
    old = jconfig.pallas_interpret, jconfig.use_pallas, jconfig.pallas_tri_inv
    jconfig.pallas_interpret = True
    jconfig.use_pallas = False
    jconfig.pallas_tri_inv = True
    yield
    jconfig.pallas_interpret, jconfig.use_pallas, jconfig.pallas_tri_inv = old


def _spd(rng, G, nb):
    X = rng.standard_normal((G, nb, nb))
    return X @ np.swapaxes(X, -1, -2) + nb * np.eye(nb)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("G,nb", [(2, 32), (5, 64), (3, 128)])
def test_tri_inv_blocks_plain_matches_pallas(G, nb, rng, interpret_mode):
    """B3's plain version against the Pallas kernel (interpret) and numpy's
    inverse, f32, rtol 5e-4 (tests/test_pallas_linalg.py:46), with an exactly
    zero strict upper triangle."""
    L = np.linalg.cholesky(_spd(rng, G, nb)).astype(np.float32)
    old = tconfig.use_cuda_kernels
    tconfig.use_cuda_kernels = True  # route through the wrapper, as the kernel gate would
    try:
        ours = cuda_linalg.tri_inv_blocks(_t(L, torch.float32)).numpy()
    finally:
        tconfig.use_cuda_kernels = old
    theirs = np.asarray(pli.tri_inv_blocks(jnp.asarray(L)))
    np.testing.assert_allclose(ours, theirs, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(ours, np.linalg.inv(L.astype(np.float64)),
                               rtol=5e-4, atol=5e-4)
    assert np.all(np.triu(ours, 1) == 0.0)


@pytest.mark.parametrize("n,block", [(300, 256), (200, 64), (100, 256)])
def test_tri_inv_lower_matches_jax(n, block, rng):
    """D&C inverse (padding, merges, the small-n path) against JAX in f64."""
    L = np.linalg.cholesky(_spd(rng, 2, n))
    ours = tlinalg.tri_inv_lower(_t(L), block=block).numpy()
    theirs = np.asarray(jlinalg.tri_inv_lower(jnp.asarray(L), block=block))
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(ours, np.linalg.inv(L), rtol=1e-9, atol=1e-12)
    assert np.all(np.triu(ours, 1) == 0.0)


@pytest.mark.parametrize("n", [64, 600, 1100])
def test_blocked_solve_lower_matches_jax(n, rng):
    B = 3
    L = np.tril(rng.standard_normal((B, n, n))) + n * np.eye(n)
    for k in (1, 3):
        rhs = rng.standard_normal((B, n, k))
        ours = tlinalg.blocked_solve_lower(_t(L), _t(rhs), nb=256).numpy()
        theirs = np.asarray(jlinalg.blocked_solve_lower(jnp.asarray(L), jnp.asarray(rhs),
                                                        nb=256))
        np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-12)
    # a shared right-hand side broadcast over lanes
    rhs = rng.standard_normal((n, 1))
    ours = tlinalg.blocked_solve_lower(_t(L), _t(rhs), nb=256).numpy()
    for b in range(B):
        np.testing.assert_allclose(
            ours[b], np.asarray(jlinalg.solve_lower(jnp.asarray(L[b]), jnp.asarray(rhs))),
            rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [50, 700, 1200])
def test_tri_tdot_matches_jax(n, rng):
    L = np.tril(rng.standard_normal((2, n, n))) + n * np.eye(n)
    Li = np.stack([np.linalg.inv(L[i]) for i in range(2)])
    ours = tlinalg.tri_tdot(_t(Li), nb=512).numpy()
    theirs = np.asarray(jlinalg.tri_tdot(jnp.asarray(Li), nb=512))
    np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-12)
    assert np.array_equal(ours, np.swapaxes(ours, 1, 2))


def _needs_rung(rng, n, rung):
    """Symmetric matrix whose minimal jitter-ladder rung is ``rung`` (0..5);
    rung 6 fails at every rung."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = rng.uniform(0.5, 2.0, n)
    mean = lam.mean()
    if rung == 6:
        lam[0] = -mean
    elif rung > 0:
        # halfway between the jitters of rungs rung-1 and rung (x10 apart)
        lam[0] = -0.5 * mean * 1e-6 * 10.0 ** (rung - 1)
    A = (Q * lam) @ Q.T
    return 0.5 * (A + A.T)


def _ladder_batch(rng, n=24):
    return np.stack([_needs_rung(rng, n, r) for r in (0, 1, 2, 3, 4, 5, 6, 2)])


@pytest.mark.parametrize("hint", [None, 0.0, 2.0, 5.0])
def test_jitchol_ladder_matches_jax_per_lane(hint, rng):
    """Per lane: the same accepted rung, jitter, ok and factor as the JAX
    ladder, on lanes that need rungs 0..5 and one that fails everywhere; the
    failed lane's NaN stays in its own lane."""
    A = _ladder_batch(rng)
    L, j, ok, rung = tlinalg.jitchol_full(_t(A), k_start=hint)
    jL, jj, jok, jrung = jlinalg.jitchol_full(jnp.asarray(A), k_start=hint)
    np.testing.assert_array_equal(rung.numpy(), np.asarray(jrung))
    np.testing.assert_array_equal(rung.numpy(), [0, 1, 2, 3, 4, 5, 6, 2])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=1e-14, atol=0.0)
    Ln, jLn = L.numpy(), np.asarray(jL)
    good = ok.numpy()
    np.testing.assert_allclose(Ln[good], jLn[good], rtol=1e-10, atol=1e-12)
    assert np.all(np.isnan(Ln[~good])) and not np.all(np.isfinite(jLn[~good]))
    assert np.all(np.isfinite(Ln[good]))


def test_cholesky_ex_failure_is_finite_and_caught():
    """The failure signal the ladder relies on: cholesky_ex reports info > 0
    with an all-finite factor, so finiteness alone would pass a failed lane."""
    A = torch.diag(torch.tensor([1.0, 1.0, -1e-3, 1.0], dtype=torch.float64))
    Lraw, info = torch.linalg.cholesky_ex(A)
    assert int(info) == 3 and bool(torch.isfinite(Lraw).all())
    L, j, ok, rung = tlinalg.jitchol_full(A)
    jL, jj, jok, jrung = jlinalg.jitchol_full(jnp.asarray(A.numpy()))
    assert bool(ok) == bool(jok) and int(rung) == int(jrung)
    assert float(j) == pytest.approx(float(jj), rel=1e-14)


def test_masked_gram_and_logdet_match_jax(rng):
    K = _spd(rng, 1, 12)[0]
    mask = (np.arange(12) < 9).astype(float)
    ours = tlinalg.masked_gram(_t(K), _t(mask)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jlinalg.masked_gram(jnp.asarray(K),
                                                                        jnp.asarray(mask))))
    L = np.linalg.cholesky(ours)
    np.testing.assert_allclose(tlinalg.logdet_from_chol(_t(L)).numpy(),
                               np.asarray(jlinalg.logdet_from_chol(jnp.asarray(L))),
                               rtol=1e-13)
