"""The full-size batched Cholesky (B5, ``ops/cuda_linalg.chol_full``) and its
route in the jitter ladder.

On the CPU: the plain right-looking version against LAPACK in float64, its
failed lanes, and the ladder's gate. On the card (marked ``cuda``, skipped
without one): the kernel against float64 and against ``cholesky_ex`` at the
ladder's full-size shapes, its failed lanes, and its launch count over a fit.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_chol_full.py -q
"""
import types

import pytest
import torch

from gaussian_process_optimization_tpu_torch.config import config
from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl
from gaussian_process_optimization_tpu_torch.ops import linalg
from gaussian_process_optimization_tpu_torch.utils.profiling import counters
from torch_threads import one_torch_thread  # noqa: F401

U64 = 2.0 ** -53


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spd(G, n, seed=0, cond=None, dtype=torch.float64, device="cpu"):
    """SPD matrices made in float64 on the CPU: X X^T + n I, or, given
    ``cond``, Q diag(lam) Q^T with a random orthogonal Q and lam geometric
    from 1 down to 1 / cond."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    X = torch.randn(G, n, n, generator=gen, dtype=torch.float64)
    if cond is None:
        A = X @ X.mT + n * torch.eye(n, dtype=torch.float64)
    else:
        Q, _ = torch.linalg.qr(X)
        lam = cond ** (-torch.arange(n, dtype=torch.float64) / (n - 1))
        A = (Q * lam) @ Q.mT
        A = 0.5 * (A + A.mT)
    return A.to(dtype=dtype, device=device)


def _backward_error(A, L):
    """||L L^T - A||_F / ||A||_F per lane, in float64."""
    Ld, Ad = L.double(), A.double()
    return (Ld @ Ld.mT - Ad).norm(dim=(-2, -1)) / Ad.norm(dim=(-2, -1))


def _forward_error(L, exact):
    """max |L - exact| / max |exact| per lane."""
    return ((L.double() - exact).abs().amax(dim=(-2, -1))
            / exact.abs().amax(dim=(-2, -1)))


@pytest.mark.parametrize("cond", [1e2, 1e4, 1e6])
@pytest.mark.parametrize("n", [512, 1024])
def test_plain_matches_lapack(n, cond):
    """The plain right-looking version (four and eight 128-column panels) in
    float64 against LAPACK: forward error within 8 cond u, backward error
    within twice LAPACK's, strict upper triangle exactly zero."""
    A = _spd(3, n, cond=cond)
    L = cl.chol_full_plain(A)
    want = torch.linalg.cholesky(A)
    assert bool((_forward_error(L, want) <= 8 * cond * U64).all())
    assert bool((_backward_error(A, L) <= 2 * _backward_error(A, want)).all())
    assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.parametrize("n", [200, 384, 640])
def test_plain_takes_any_size(n):
    """A last panel narrower than 128 (200, 640 = 5 panels of 128) and one
    panel of a pair (384): the same factor as LAPACK."""
    A = _spd(2, n, seed=3)
    L = cl.chol_full_plain(A)
    torch.testing.assert_close(L, torch.linalg.cholesky(A), rtol=1e-12, atol=1e-12)
    assert bool((torch.triu(L, 1) == 0).all())


def test_plain_failing_lane_is_all_nan():
    """A lane indefinite at pivot 900 of 1024 (panel 8 of 8, after seven
    panels' products and updates) and a -I lane come out all NaN; the lanes
    beside them equal the same lanes factored beside positive-definite
    ones."""
    A = _spd(4, 1024, seed=1)
    good = cl.chol_full_plain(A)
    A[1, 900, 900] = -1.0
    A[2] = -torch.eye(1024, dtype=torch.float64)
    got = cl.chol_full_plain(A)
    assert bool(torch.isnan(got[1]).all()) and bool(torch.isnan(got[2]).all())
    for g in (0, 3):
        assert torch.equal(got[g], good[g])


def _near_singular(pivot, n=1024, j=896, dtype=torch.float32, device="cpu"):
    """Three lanes of I whose lane 1 couples columns j - 1 and j so that pivot
    j is ``pivot`` times its diagonal entry (1 - c^2, c = sqrt(1 - pivot));
    j = 896 opens panel 8, after the update from panel 7, which holds j - 1."""
    A = torch.eye(n, dtype=torch.float64).repeat(3, 1, 1)
    c = (1.0 - pivot) ** 0.5
    A[1, j, j - 1] = A[1, j - 1, j] = c
    return A.to(dtype=dtype, device=device)


def _floor_ratio(dtype, n=1024):
    """B5's pivot floor as a share of the diagonal entry."""
    return float(cl.pivot_floors(torch.ones(1, n, dtype=dtype).diag_embed())[0, 0])


@pytest.mark.parametrize("above", [False, True])
def test_plain_pivot_floor(above):
    """A float32 lane whose pivot is positive but a quarter of its floor fails
    and comes out all NaN, where LAPACK's test passes it; at four times its
    floor it factors as LAPACK does. The lanes beside it are unchanged."""
    ratio = _floor_ratio(torch.float32) * (4.0 if above else 0.25)
    A = _near_singular(ratio)
    assert bool(torch.isfinite(torch.linalg.cholesky_ex(A)[0]).all())
    L = cl.chol_full_plain(A)
    assert bool(torch.isfinite(L[1]).all()) is above
    if not above:
        assert bool(torch.isnan(L[1]).all())
    else:
        torch.testing.assert_close(L[1], torch.linalg.cholesky(A[1]), rtol=0, atol=1e-4)
    for g in (0, 2):
        assert torch.equal(L[g], torch.eye(1024))


def test_chol_full_on_the_cpu_is_the_plain_version():
    """:func:`chol_full` on a CPU tensor returns the plain version's factor."""
    A = _spd(2, 384, seed=11, dtype=torch.float32)
    assert torch.equal(cl.chol_full(A), cl.chol_full_plain(A))


def _like(device_type="cuda", dtype=torch.float32, shape=(5, 512, 512)):
    """What the gate reads of a tensor, for devices this host may not have."""
    return types.SimpleNamespace(is_cuda=device_type == "cuda", dtype=dtype,
                                 ndim=len(shape), shape=shape)


@pytest.mark.parametrize("case,eligible", [
    ("cuda_f32_512", True),
    ("cuda_f32_640", True),
    ("cuda_f32_256", False),
    ("cuda_f32_384", False),
    ("cuda_f32_4096_2d", True),
    ("cpu_f32_512", False),
    ("cuda_f64_512", False),
    ("cuda_f32_128", False),
    ("cuda_f32_320", False),
    ("cuda_f32_nonsquare", False),
])
def test_gate(case, eligible):
    """B5 takes CUDA float32 square matrices with n a multiple of 128 and at
    least 512; CPU tensors, float64, n < 512 (the sparse models' M x M
    Grams of 256) and ragged n stay on ``cholesky_plain``."""
    like = {
        "cuda_f32_512": _like(),
        "cuda_f32_640": _like(shape=(2, 640, 640)),
        "cuda_f32_256": _like(shape=(3, 256, 256)),
        "cuda_f32_384": _like(shape=(3, 384, 384)),
        "cuda_f32_4096_2d": _like(shape=(4096, 4096)),
        "cpu_f32_512": _like(device_type="cpu"),
        "cuda_f64_512": _like(dtype=torch.float64),
        "cuda_f32_128": _like(shape=(5, 128, 128)),
        "cuda_f32_320": _like(shape=(5, 320, 320)),
        "cuda_f32_nonsquare": _like(shape=(5, 256, 512)),
    }[case]
    assert cl.chol_full_eligible(like) is eligible


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_ladder_keeps_cholesky_plain(dtype):
    """On the CPU the ladder's attempts factor with ``cholesky_plain``, bit for
    bit, and launch no B5, at a size B5 would take on the card."""
    A = _spd(2, 512, seed=4, dtype=dtype)
    before = counters["b5.launches"]
    L, _, ok, rung = linalg.jitchol_full(A)
    assert counters["b5.launches"] == before
    assert bool(ok.all()) and bool((rung == 0).all())
    assert torch.equal(L, cl.cholesky_plain(A))


# ---------------------------------------------------------------- on the card

def _matern_ky(dev, lanes, noise, n=4096, seed=0):
    """The cell's Ky: an ARD Matern52 Gram of n points in [-2, 2]^6 over
    ``lanes`` hyperparameter rows near a fit's values, plus noise I."""
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device=dev).manual_seed(seed)
    X = (4 * torch.rand(1, n, 6, generator=gen, device=dev) - 2).contiguous()
    var = 0.5 + torch.rand(lanes, 1, generator=gen, device=dev)
    ls = 0.5 + 1.5 * torch.rand(lanes, 6, generator=gen, device=dev)
    p = torch.cat([var, torch.zeros_like(var), ls], dim=1).contiguous()
    K = ck.stationary_k_build(X, X, p, "matern52", True)
    return K + noise * torch.eye(n, device=dev)


def _rbf_ky(dev, lanes, noise, n=4096, seed=1):
    """The MCMC lanes' Ky: an RBF Gram of n points in [-2, 2] plus noise I."""
    from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device=dev).manual_seed(seed)
    X = (4 * torch.rand(1, n, 1, generator=gen, device=dev) - 2).contiguous()
    p = torch.zeros(lanes, 8, device=dev)
    p[:, 0] = 0.5 + torch.rand(lanes, generator=gen, device=dev)
    p[:, 2] = 0.7 + torch.rand(lanes, generator=gen, device=dev)
    K = ck.stationary_k_build(X, X, p, "rbf", False)
    return K + noise * torch.eye(n, device=dev)


def _check_against_references(A, ratio=1.5):
    """B5 on A against float64 and against ``cholesky_ex``: every lane
    finite, the strict upper triangle exactly zero, two calls bitwise equal,
    the backward error within ``ratio`` times ``cholesky_ex``'s, and the
    forward error from float64 within 4x ``cholesky_ex``'s (an H100 read
    1.2-1.9x at n = 1024 and 4096, 1.7-3.1x at n = 256-512, where the
    diagonal blocks' rounding, B4's, is most of the factor), and a positive
    diagonal."""
    L = cl.chol_full(A)
    assert torch.equal(L, cl.chol_full(A))
    assert bool(torch.isfinite(L).all())
    assert bool((torch.triu(L, 1) == 0).all())
    assert bool((torch.diagonal(L, dim1=-2, dim2=-1) > 0).all())
    ex = cl.cholesky_plain(A)
    assert bool(torch.isfinite(ex).all())
    bwd, bwd_ex = _backward_error(A, L), _backward_error(A, ex)
    assert bool((bwd <= ratio * bwd_ex).all()), (bwd.tolist(), bwd_ex.tolist())
    exact = torch.linalg.cholesky(A.double())
    fwd, fwd_ex = _forward_error(L, exact), _forward_error(ex, exact)
    assert bool((fwd <= 4 * fwd_ex).all()), (fwd.tolist(), fwd_ex.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [1e-2, 1e-4])
def test_b5_on_the_cells_ky(noise, cuda):
    """(5, 4096, 4096) ARD Matern52 Ky, the noise at 1e-2 and at the
    Gram floor 1e-4."""
    _check_against_references(_matern_ky(cuda, 5, noise))


@pytest.mark.cuda
def test_b5_on_the_mcmc_lanes_ky(cuda):
    """(10, 4096, 4096) RBF Ky, the MCMC surrogate's lanes."""
    _check_against_references(_rbf_ky(cuda, 10, 1e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("G,n,cond", [(3, 512, None), (2, 640, None), (3, 1024, None),
                                      (3, 1024, 1e5), (3, 1024, 1e6)])
def test_b5_small_shapes(G, n, cond, cuda):
    """The smallest n the gate takes (four panels), five panels, and chosen
    spectra up to cond 1e6. Here the diagonal blocks, which round as B4's
    tiles do, are an eighth to a quarter of the work, and the backward error
    read 1.7-2.2x ``cholesky_ex``'s on an H100 at n = 256-1024: held to 3x."""
    _check_against_references(_spd(G, n, seed=5, cond=cond, dtype=torch.float32, device=cuda),
                              ratio=3.0)


@pytest.mark.cuda
def test_b5_failing_lanes_are_all_nan(cuda):
    """A -I lane (fails at the first pivot) and a lane indefinite at pivot 900
    of 1024 (panel 8 of 8) come out all NaN; the lanes beside them equal the
    same lanes factored beside positive-definite ones, bit for bit."""
    A = _spd(4, 1024, seed=6, dtype=torch.float32, device=cuda)
    good = cl.chol_full(A)
    A[1] = -torch.eye(1024, device=cuda)
    A[2, 900, 900] = -1.0
    got = cl.chol_full(A)
    assert bool(torch.isnan(got[1]).all()) and bool(torch.isnan(got[2]).all())
    for g in (0, 3):
        assert torch.equal(got[g], good[g])


@pytest.mark.cuda
def test_ladder_verdict_and_nan_fill_on_the_card(cuda):
    """The ladder's verdict is finiteness, and on B5's route B5 alone fills a
    failed lane with NaN: a lane whose input carries one NaN below the
    diagonal, and one with +inf on its diagonal (a pivot that is positive but
    not finite), are not ok and come out all NaN; the lane beside them is ok
    and finite."""
    A = _spd(3, 512, seed=9, dtype=torch.float32, device=cuda)
    A[0, 300, 7] = float("nan")
    A[2, 40, 40] = float("inf")
    L, _, ok, rung = linalg.jitchol_full(A, maxtries=1)
    assert ok.tolist() == [False, True, False]
    assert bool(torch.isnan(L[0]).all()) and bool(torch.isnan(L[2]).all())
    assert bool(torch.isfinite(L[1]).all())
    t = torch.ones(3, 256, 256, device=cuda)
    t[1, 5, 200] = float("nan")
    t[2, 255, 0] = float("inf")
    norm = torch.linalg.vector_norm(t, float("inf"), dim=(-2, -1))
    assert torch.isnan(norm[1]) and torch.isinf(norm[2]) and norm[0] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("above", [False, True])
def test_b5_pivot_floor(above, cuda):
    """B5's verdict as the plain version's: a pivot a quarter of its floor
    fails the lane (all NaN) where ``cholesky_ex`` passes it; at four times
    its floor the lane factors. The lanes beside it are the identity."""
    ratio = _floor_ratio(torch.float32) * (4.0 if above else 0.25)
    A = _near_singular(ratio, device=cuda)
    assert bool(torch.isfinite(cl.cholesky_plain(A)).all())
    L = cl.chol_full(A)
    assert bool(torch.isfinite(L[1]).all()) is above
    if not above:
        assert bool(torch.isnan(L[1]).all())
    else:
        torch.testing.assert_close(L[1], cl.cholesky_plain(A[1]), rtol=0, atol=1e-4)
    eye = torch.eye(1024, device=cuda)
    for g in (0, 2):
        assert torch.equal(L[g], eye)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f64", "n320", "n128", "kernels_off"])
def test_b5_raises_outside_its_gate_on_the_card(case, cuda):
    """A CUDA tensor that B5's gate does not admit raises: its caller chooses
    the factorization."""
    A = _spd(2, {"n320": 320, "n128": 128}.get(case, 512),
             dtype=torch.float64 if case == "f64" else torch.float32, device=cuda)
    old = config.use_cuda_kernels
    try:
        config.use_cuda_kernels = "auto" if case != "kernels_off" else False
        with pytest.raises(ValueError, match="chol_full"):
            cl.chol_full(A)
    finally:
        config.use_cuda_kernels = old


@pytest.mark.cuda
def test_b5_overwrites_only_when_asked(cuda):
    """``overwrite_a`` factors in A's memory; without it A is unchanged."""
    A = _spd(2, 512, seed=7, dtype=torch.float32, device=cuda)
    keep = A.clone()
    L = cl.chol_full(A)
    assert torch.equal(A, keep)
    L2 = cl.chol_full(A, overwrite_a=True)
    assert L2.data_ptr() == A.data_ptr() and torch.equal(L2, L)


@pytest.mark.cuda
def test_ladder_routes_on_the_card(cuda):
    """The ladder launches B5 once an attempt for CUDA float32 at n = 512 and
    not for float64, n = 320 or with the kernels off; where it launches B5 the
    rung is cholesky_ex's."""
    A = _spd(2, 512, seed=8, dtype=torch.float32, device=cuda)
    before = counters["b5.launches"], counters["chol.factorizations"]
    _, _, ok, rung = linalg.jitchol_full(A)
    assert (counters["b5.launches"] - before[0]
            == counters["chol.factorizations"] - before[1] > 0)
    old = config.use_cuda_kernels
    try:
        config.use_cuda_kernels = False
        _, _, ok_ex, rung_ex = linalg.jitchol_full(A)
        before = counters["b5.launches"]
        linalg.jitchol_full(A)
        linalg.jitchol_full(A.double())
        linalg.jitchol_full(_spd(2, 320, dtype=torch.float32, device=cuda))
    finally:
        config.use_cuda_kernels = old
    linalg.jitchol_full(A.double())
    linalg.jitchol_full(_spd(2, 320, dtype=torch.float32, device=cuda))
    assert counters["b5.launches"] == before
    assert torch.equal(rung, rung_ex) and torch.equal(ok, ok_ex)


@pytest.mark.cuda
def test_b5_launches_equal_factorizations_over_a_fit(cuda):
    """A 5-restart fit at N = 1024 on the card: every ladder attempt is one
    B5 factorization."""
    from gaussian_process_optimization_tpu_torch.workload import bench_data, fit, make_model

    X, Y = bench_data(n=1024)
    model = make_model(X, Y, dtype=torch.float32, device=cuda)
    before = counters["b5.launches"], counters["chol.factorizations"]
    fit(model, steps=3)
    b5 = counters["b5.launches"] - before[0]
    chol = counters["chol.factorizations"] - before[1]
    assert b5 == chol > 0
