"""The torch port's batched Cholesky (B4's plain version), blocked Cholesky
and jitter ladder against the JAX package in float64: the plain version
against the Pallas kernel in interpret mode, the blocked factorization with the
Pallas diagonal blocks, NaN locality, and the greedy and verified ladders lane
by lane over both factorization routes."""
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
def pallas_chol():
    """The JAX package's diagonal blocks through the Pallas kernel (interpret
    mode), as tests/test_pallas_linalg.py:16-27 sets it."""
    old = jconfig.pallas_interpret, jconfig.use_pallas, jconfig.pallas_chol_blocks
    jconfig.pallas_interpret, jconfig.use_pallas, jconfig.pallas_chol_blocks = True, False, True
    yield
    jconfig.pallas_interpret, jconfig.use_pallas, jconfig.pallas_chol_blocks = old


@pytest.fixture(params=[False, True], ids=["cholesky_ex", "blocked"])
def chol_route(request):
    """The port's two ladder routes: full cholesky_ex, or blocked_cholesky with
    its diagonal blocks through the kernel wrapper (plain on the CPU)."""
    old = tconfig.cuda_chol_blocks, tconfig.use_cuda_kernels
    tconfig.cuda_chol_blocks, tconfig.use_cuda_kernels = request.param, True
    yield request.param
    tconfig.cuda_chol_blocks, tconfig.use_cuda_kernels = old


def _spd(rng, G, n):
    X = rng.standard_normal((G, n, n))
    return X @ np.swapaxes(X, -1, -2) + n * np.eye(n)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("G,nb", [(1, 32), (5, 64), (2, 96), (3, 128)])
def test_cholesky_plain_matches_pallas(G, nb, rng, pallas_chol):
    """B4's plain version (and the wrapper, which takes it on the CPU) against
    the Pallas kernel in interpret mode, rtol 1e-10, upper triangle exactly 0;
    nb = 96 is three panels, not a power of two."""
    A = _spd(rng, G, nb)
    theirs = np.asarray(pli.cholesky_blocks(jnp.asarray(A)))
    old = tconfig.use_cuda_kernels
    tconfig.use_cuda_kernels = True
    try:
        for ours in (cuda_linalg.cholesky_plain(_t(A)), cuda_linalg.cholesky_blocks(_t(A))):
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-10, atol=1e-12)
            assert np.all(np.triu(ours.numpy(), 1) == 0.0)
    finally:
        tconfig.use_cuda_kernels = old


def test_blocked_cholesky_matches_jax(rng, pallas_chol, chol_route):
    """blocked_cholesky(nb=32) at n=96 (three panels) against the JAX one with
    its diagonal blocks in the Pallas kernel, rtol 1e-10."""
    A = _spd(rng, 2, 96)
    ours = tlinalg.blocked_cholesky(_t(A), nb=32).numpy()
    theirs = np.asarray(jlinalg.blocked_cholesky(jnp.asarray(A), nb=32))
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours, np.linalg.cholesky(A), rtol=1e-10, atol=1e-12)


def test_nan_stays_in_its_lane(rng, chol_route):
    """A -I lane is non-finite; every other lane equals that lane factored
    alone. For the blocked factorization the failing lane fails in its second
    diagonal block, so the NaN must travel through the panel solve and the
    Schur updates of that lane only."""
    A = _spd(rng, 3, 64)
    A[1] = -np.eye(64)
    got = cuda_linalg.cholesky_blocks(_t(A))
    assert bool(torch.isnan(got[1]).all())
    for g in (0, 2):
        assert torch.equal(got[g], cuda_linalg.cholesky_blocks(_t(A[g:g + 1]))[0])

    B = _spd(rng, 3, 96)
    B[1, 32:, 32:] = -np.eye(64)
    got = tlinalg.blocked_cholesky(_t(B), nb=32)
    assert not bool(torch.isfinite(got[1]).all())
    assert bool(torch.isfinite(got[1, :32, :32]).all())
    for g in (0, 2):
        assert bool(torch.isfinite(got[g]).all())
        assert torch.equal(got[g], tlinalg.blocked_cholesky(_t(B[g:g + 1]), nb=32)[0])


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


@pytest.fixture(scope="module")
def ladder_batch():
    """Lanes needing rungs 0..5 and one failing at every rung, n = 512 so the
    blocked route (two 256-blocks) is taken when it is switched on."""
    rng = np.random.default_rng(5)
    return np.stack([_needs_rung(rng, 512, r) for r in (0, 1, 2, 3, 4, 5, 6)])


@pytest.mark.parametrize("greedy", [False, True], ids=["verified", "greedy"])
@pytest.mark.parametrize("hint", [0, 1, 2, 3, 4, 5])
def test_ladder_matches_jax_per_lane(hint, greedy, ladder_batch, chol_route):
    """Per lane: the same (rung, jitter, ok) as the JAX ladder, and the same
    factor where it succeeds; a failed lane is NaN in its own lane only."""
    A = ladder_batch
    L, j, ok, rung = tlinalg.jitchol_full(_t(A), k_start=float(hint), greedy=greedy)
    jL, jj, jok, jrung = jlinalg.jitchol_full(jnp.asarray(A), k_start=float(hint),
                                              greedy=greedy)
    np.testing.assert_array_equal(rung.numpy(), np.asarray(jrung))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=1e-14, atol=0.0)
    want = np.array([max(r, hint) if greedy else r for r in range(6)] + [6])
    np.testing.assert_array_equal(rung.numpy(), want)
    good = ok.numpy()
    np.testing.assert_allclose(L.numpy()[good], np.asarray(jL)[good], rtol=1e-9, atol=1e-11)
    assert np.all(np.isnan(L.numpy()[~good])) and np.all(np.isfinite(L.numpy()[good]))
