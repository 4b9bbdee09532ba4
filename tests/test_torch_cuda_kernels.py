"""The torch port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips itself without one. The file
imports neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from gaussian_process_optimization_tpu_torch.ops import cuda_kernels as ck
from gaussian_process_optimization_tpu_torch.ops import cuda_linalg as cl
from gaussian_process_optimization_tpu_torch.workload import bench_data, make_model
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from gaussian_process_optimization_tpu_torch.config import config
from gaussian_process_optimization_tpu_torch.parallel import sharded
from gaussian_process_optimization_tpu_torch.utils import cluster
from gaussian_process_optimization_tpu_torch.utils.profiling import counters

pytestmark = pytest.mark.cuda

FAMILIES = list(ck.FAMILIES)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, n=300, m=170, d=6):
    gen = torch.Generator(device="cpu").manual_seed(0)
    X = (torch.rand(1, n, d, generator=gen) * 4 - 2).to(dev)
    Z = (torch.rand(1, m, d, generator=gen) * 4 - 2).to(dev)
    G = torch.randn(2, n, m, generator=gen).to(dev)
    return X, Z, G


def _params(dev, lanes, d, seed=1):
    """(lanes, max(2 + d, 8)) rows [variance, power, lengthscale x d]; the
    lengthscales grow with sqrt(d) so that r stays of order 1 at any width."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    var = 0.5 + torch.rand(lanes, 1, generator=gen)
    power = 0.5 + 2.0 * torch.rand(lanes, 1, generator=gen)
    ls = (0.5 + torch.rand(lanes, d, generator=gen)) * (d ** 0.5)
    row = torch.cat([var, power, ls], dim=1)
    return torch.nn.functional.pad(row, (0, max(8 - row.shape[1], 0))).to(dev)


def _check_backward(X, Z, params, G, fam, ard):
    """B2 against the float64 plain version (rtol 1e-4 of the entry plus 1e-4
    of the output's max: sums of ~n m terms of both signs), two launches
    bitwise equal."""
    got = ck.stationary_k_backward(X, Z, params, G, fam, ard)
    again = ck.stationary_k_backward(X, Z, params, G, fam, ard)
    want = ck.k_backward_plain(X.double(), Z.double(), params.double(), G.double(),
                               fam, ard)
    for name, a, b, w in zip(("dparams", "dX", "dZ"), got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.double(), w, rtol=1e-4, atol=1e-4 * float(w.abs().max()),
                                   msg=lambda m: f"{name}: {m}")
    return got


# D = 1..8 is the one-chunk instantiation, 9..64 the chunked one
@pytest.mark.parametrize("d", [1, 3, 6, 8, 9, 33, 64])
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("fam", FAMILIES)
def test_k_build_and_backward_match_plain(fam, ard, d, cuda):
    """Every (family, ARD, dimension bucket) instantiation of B1 and B2
    against the plain versions (f64 for the backward: parameter gradients from
    the row pass, dX from its dX variant, dZ from the column pass), at a shape
    ragged in both directions, with the backward bitwise deterministic."""
    X, Z, G = _inputs(cuda, d=d)
    params = _params(cuda, 2, d)
    K = ck.stationary_k_build(X, Z, params, fam, ard)
    torch.testing.assert_close(K, ck.k_build_plain(X, Z, params, fam, ard),
                               rtol=2e-5, atol=2e-6)
    _check_backward(X, Z, params, G, fam, ard)
    # parameter gradients alone take the wider row strip
    dp, _, _ = ck.stationary_k_backward(X, Z, params, G, fam, ard, False, False, True)
    want, _, _ = ck.k_backward_plain(X.double(), Z.double(), params.double(), G.double(),
                                     fam, ard, False, False, True)
    torch.testing.assert_close(dp.double(), want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("d", [6, 33])
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("fam", FAMILIES)
def test_k_build_symmetric_is_bitwise_symmetric(fam, ard, d, cuda):
    """K(X, X) from B1 equals its transpose bit for bit (what lets
    stationary_K skip the (K + K^T) / 2 pass), with an exact variance diagonal."""
    X, _, _ = _inputs(cuda, n=517, d=d)
    params = _params(cuda, 2, d)
    K = ck.stationary_k_build(X, X, params, fam, ard)
    assert torch.equal(K, K.mT)
    torch.testing.assert_close(torch.diagonal(K, dim1=-2, dim2=-1),
                               params[:, :1].expand(2, 517), rtol=0, atol=0)


@pytest.mark.parametrize("n,m", [(130, 1000), (257, 129), (33, 7), (128, 1001), (5, 643)])
def test_ragged_shapes(n, m, cuda):
    """N and M off the tiles' multiples and off multiples of 4 (the scalar
    store and load tails), and the sweep's M = 1000."""
    X, Z, G = _inputs(cuda, n=n, m=m)
    params = _params(cuda, 2, 6)
    K = ck.stationary_k_build(X, Z, params, "matern52", True)
    torch.testing.assert_close(K, ck.k_build_plain(X, Z, params, "matern52", True),
                               rtol=2e-5, atol=2e-6)
    _check_backward(X, Z, params, G, "matern52", True)


@pytest.mark.parametrize("view", ["transposed", "misaligned_rows", "offset_base"])
def test_backward_reads_strided_g(view, cuda):
    """G views the 16-byte path cannot take (last stride != 1; rows or base off
    16 bytes) go through the scalar loads and give the same gradients as a
    contiguous copy, bit for bit (the loads differ, the arithmetic does not)."""
    X, Z, _ = _inputs(cuda, n=260, m=172)
    params = _params(cuda, 2, 6)
    gen = torch.Generator(device="cpu").manual_seed(5)
    if view == "transposed":
        G = torch.randn(2, 172, 260, generator=gen).to(cuda).mT
    elif view == "misaligned_rows":
        G = torch.randn(2, 260, 175, generator=gen).to(cuda)[:, :, :172]
    else:
        G = torch.randn(2, 260, 176, generator=gen).to(cuda)[:, :, 1:173]
    assert not G.is_contiguous()
    got = _check_backward(X, Z, params, G, "matern52", True)
    for a, b in zip(got, ck.stationary_k_backward(X, Z, params, G.contiguous(),
                                                   "matern52", True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bx,bz,bp", [(1, 1, 3), (3, 1, 3), (1, 3, 1), (3, 3, 1), (3, 3, 3)])
def test_lane_broadcasting(bx, bz, bp, cuda):
    """Each of X, Z and params has 1 lane (shared) or B = 3; the kernels equal
    the plain versions on the expanded inputs."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    X = (torch.rand(bx, 150, 6, generator=gen) * 4 - 2).to(cuda)
    Z = (torch.rand(bz, 140, 6, generator=gen) * 4 - 2).to(cuda)
    G = torch.randn(3, 150, 140, generator=gen).to(cuda)
    params = _params(cuda, bp, 6)
    Xe, Ze, pe = X.expand(3, -1, -1), Z.expand(3, -1, -1), params.expand(3, -1)
    K = ck.stationary_k_build(X, Z, params, "ratquad", True)
    torch.testing.assert_close(K, ck.k_build_plain(Xe, Ze, pe, "ratquad", True),
                               rtol=2e-5, atol=2e-6)
    got = ck.stationary_k_backward(X, Z, params, G, "ratquad", True)
    want = ck.k_backward_plain(Xe.double(), Ze.double(), pe.double(), G.double(),
                               "ratquad", True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.double(), w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


def test_autograd_function_matches_cpu(cuda):
    """The StationaryK autograd.Function on the card (kernel forward and
    backward, f32) against the same Function on the CPU in f64 (plain forward
    and backward), symmetric and cross cases, lane-batched hyperparameters."""
    from gaussian_process_optimization_tpu_torch.kernels import Matern52

    X, Z, _ = _inputs(torch.device("cpu"), n=200, m=150)
    gen = torch.Generator(device="cpu").manual_seed(1)
    for Zi in (None, Z[0]):
        m = X.shape[1] if Zi is None else Zi.shape[0]
        G = torch.randn(3, X.shape[1], m, generator=gen)
        ls0 = 0.5 + torch.rand(3, 6, generator=gen)
        grads = []
        for dev, dt in ((cuda, torch.float32), (torch.device("cpu"), torch.float64)):
            var = torch.tensor([0.5, 1.0, 2.0], device=dev, dtype=dt, requires_grad=True)
            ls = ls0.to(dev, dt).requires_grad_(True)
            k = Matern52(input_dim=6, variance=var, lengthscale=ls)
            Xr = X[0].to(dev, dt).requires_grad_(True)
            Zr = None if Zi is None else Zi.to(dev, dt)
            K = ck.stationary_K(k, Xr, Zr)
            g = torch.autograd.grad(torch.sum(K * G.to(dev, dt)), (var, ls, Xr))
            grads.append([t.double().cpu() for t in g])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_kernel_wrappers_raise_on_unsupported_cuda_input(cuda):
    X, Z, G = _inputs(cuda)
    p = torch.ones(1, 8, device=cuda)
    with pytest.raises(TypeError):
        ck.stationary_k_build(X.double(), Z.double(), p.double(), "rbf", True)
    with pytest.raises(ValueError):
        ck.stationary_k_build(X[:, :, :0], Z[:, :, :0], p, "rbf", True)


# B3 and B4 take any nb that is a multiple of 32; the paths run nb = 256 with
# G = 80 and 16 (B3) and G = 5 and 1 (B4).
BLOCK_SHAPES = [(G, nb) for G in (1, 3, 5, 16, 80) for nb in (32, 64, 128, 256)]
CONDS = [1e5, 1e6, 1e7]


def _gamma(n):
    u = 2.0 ** -24
    return n * u / (1 - n * u)


def _spd_blocks(G, nb=256, seed=0, cond=None, dtype=torch.float32):
    """SPD blocks made in float64: A A^T + nb I, or, given ``cond``, Q diag(lam)
    Q^T with a random orthogonal Q and lam geometric from 1 down to 1 / cond."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    A = torch.randn(G, nb, nb, generator=gen, dtype=torch.float64)
    if cond is None:
        return (A @ A.mT + nb * torch.eye(nb, dtype=torch.float64)).to(dtype)
    Q, _ = torch.linalg.qr(A)
    lam = cond ** (-torch.arange(nb, dtype=torch.float64) / (nb - 1))
    B = (Q * lam) @ Q.mT
    return (0.5 * (B + B.mT)).to(dtype)


def _tri_residual(L, X) -> float:
    """max over entries of |L X - I| / (|L| |X|), in float64."""
    Ld, Xd = L.double(), X.double()
    R = (Ld @ Xd - torch.eye(L.shape[-1], dtype=torch.float64, device=L.device)).abs()
    return float((R / (Ld.abs() @ Xd.abs()).clamp_min(1e-300)).max())


def _check_tri_inv(L, got, close=True):
    """B3's output against its plain version (rtol 5e-4 of the entry plus the
    block's max, when ``close``; on ill-conditioned blocks the two may differ
    by cond u and only the residuals are compared), an exact-zero upper
    triangle, the componentwise residual |L X - I| <= gamma_nb |L| |X| of
    float32 forward substitution, and two launches bitwise equal."""
    want = cl.tri_inv_plain(L)
    if close:
        err = (got.double() - want.double()).abs()
        scale = want.double().abs().amax(dim=(-2, -1), keepdim=True)
        assert bool((err <= 5e-4 * (want.double().abs() + scale)).all()), float(err.max())
    assert bool((torch.triu(got, 1) == 0).all())
    limit = _gamma(L.shape[-1])
    assert _tri_residual(L, got) <= limit, (_tri_residual(L, got), _tri_residual(L, want))
    assert torch.equal(got, cl.tri_inv_blocks(L))


@pytest.mark.parametrize("G,nb", BLOCK_SHAPES)
def test_tri_inv_blocks_match_plain(G, nb, cuda):
    """B3 against its plain version on random well-conditioned blocks."""
    L = torch.linalg.cholesky(_spd_blocks(G, nb, dtype=torch.float64)).float().to(cuda)
    _check_tri_inv(L, cl.tri_inv_blocks(L))


@pytest.mark.parametrize("cond", CONDS)
def test_tri_inv_blocks_ill_conditioned(cond, cuda):
    """B3 on triangular blocks with cond_2 = ``cond``: the float64 Cholesky
    factors of blocks whose spectrum runs from 1 to cond^-2, rounded to
    float32. The residual bound holds at any conditioning."""
    A = _spd_blocks(5, 256, seed=3, cond=cond ** 2, dtype=torch.float64)
    L = torch.linalg.cholesky(A).float().to(cuda)
    s = torch.linalg.svdvals(L.double())
    assert float((s[:, 0] / s[:, -1]).min()) > 0.1 * cond
    _check_tri_inv(L, cl.tri_inv_blocks(L), close=False)


def test_tri_inv_blocks_on_gp_cholesky_blocks(cuda):
    """B3 on the diagonal blocks of a bench-data Matern52 GP's float32 Cholesky
    factor (N=1024): the blocks tri_inv_lower gives it on the main path."""
    X, Y = bench_data(n=1024)
    post = make_model(X, Y, dtype=torch.float32, device=cuda).inference()
    assert bool(post.ok)
    L = torch.stack([post.L[i:i + 256, i:i + 256] for i in range(0, 1024, 256)])
    L = L.contiguous()
    _check_tri_inv(L, cl.tri_inv_blocks(L))


def test_lml_gradient_f32_kernels_match_f64(cuda):
    """-LML and its gradient at N=600 on the card: the f32 path through all
    three kernels against the f64 plain path."""
    X, Y = bench_data(n=600)
    m32 = make_model(X, Y, dtype=torch.float32, device=cuda)
    m64 = make_model(X, Y, dtype=torch.float64, device=cuda)
    before = (counters["b1.launches"], counters["b2.launches"],
              counters["b3.launches"])
    out = []
    for m in (m32, m64):
        packer = make_packer(m)
        U = torch.stack([packer.pack(m), packer.pack(m) + 0.2]).requires_grad_(True)
        f = make_objective(packer)(U, m)
        (g,) = torch.autograd.grad(f.sum(), U)
        out.append((f.detach().double(), g.double()))
    after = (counters["b1.launches"], counters["b2.launches"],
             counters["b3.launches"])
    assert all(a > b for a, b in zip(after, before))
    (f32, g32), (f64, g64) = out
    # about 10x the readings on an H100: value rel 4.2e-8, gradient rel 1.6e-6
    torch.testing.assert_close(f32, f64, rtol=5e-7, atol=0.0)
    np.testing.assert_allclose(g32.cpu().numpy(), g64.cpu().numpy(), rtol=2e-5,
                               atol=2e-5 * float(g64.abs().max()))


def _chol_backward_error(A, L) -> float:
    """max over entries of |L L^T - A| / (|L| |L^T|), in float64."""
    Ld, Ad = L.double(), A.double()
    R = (Ld @ Ld.mT - Ad).abs()
    return float((R / (Ld.abs() @ Ld.abs().mT).clamp_min(1e-300)).max())


def _check_chol(A, got, close=True):
    """B4's output against its plain version (rtol 1e-4 of the entry plus its
    block's max, when ``close``), an exactly zero strict upper triangle,
    Cholesky's componentwise backward error within gamma_{nb+1} of float32
    (Higham, Thm 10.3), and two launches bitwise equal."""
    want = cl.cholesky_plain(A)
    if close:
        err = (got.double() - want.double()).abs()
        scale = want.double().abs().amax(dim=(-2, -1), keepdim=True)
        assert bool((err <= 1e-4 * (want.double().abs() + scale)).all()), float(err.max())
    assert bool((torch.triu(got, 1) == 0).all())
    limit = _gamma(A.shape[-1] + 1)
    assert _chol_backward_error(A, got) <= limit, (_chol_backward_error(A, got),
                                                   _chol_backward_error(A, want))
    assert torch.equal(got, cl.cholesky_blocks(A))


@pytest.mark.parametrize("G,nb", BLOCK_SHAPES)
def test_cholesky_blocks_match_plain(G, nb, cuda):
    """B4 against its plain version on random well-conditioned blocks."""
    A = _spd_blocks(G, nb).to(cuda)
    _check_chol(A, cl.cholesky_blocks(A))


@pytest.mark.parametrize("cond", CONDS)
def test_cholesky_blocks_ill_conditioned(cond, cuda):
    """B4 on blocks with cond_2 = ``cond`` (a chosen spectrum): every lane
    factors, within the backward-error bound, which holds at any
    conditioning; the forward error against the plain version is cond u and
    is not compared."""
    A = _spd_blocks(5, 256, seed=4, cond=cond).to(cuda)
    got = cl.cholesky_blocks(A)
    assert bool(torch.isfinite(got).all())
    _check_chol(A, got, close=False)


def test_cholesky_blocks_repeated_launches_agree(cuda):
    """Two lanes per SM, launched 20 times: every launch bitwise equal to the
    first and within the backward-error bound. A read of a shared-memory entry
    that another warp overwrites in the same panel step would show here as a
    launch that differs."""
    G = 2 * torch.cuda.get_device_properties(cuda).multi_processor_count
    A = _spd_blocks(G, seed=2).to(cuda)
    first = cl.cholesky_blocks(A)
    for _ in range(19):
        assert torch.equal(cl.cholesky_blocks(A), first)
    assert _chol_backward_error(A, first) <= _gamma(257)


def test_cholesky_blocks_nan_stays_in_its_lane(cuda):
    """A lane that is not positive definite comes out all NaN, and the lanes
    beside it equal the same lanes factored alone, bit for bit: a -I lane
    (fails at the first pivot) and a lane that fails at pivot 200, inside
    panel 6 of 8, after the earlier panels' solves and updates."""
    A = _spd_blocks(4, seed=1).to(cuda)
    A[1] = -torch.eye(256, device=cuda)
    A[2, 200, 200] = -1.0
    got = cl.cholesky_blocks(A)
    for g in (1, 2):
        assert bool(torch.isnan(got[g]).all())
    for g in (0, 3):
        assert torch.equal(got[g], cl.cholesky_blocks(A[g:g + 1].contiguous())[0])
    assert torch.equal(got.view(torch.int32), cl.cholesky_blocks(A).view(torch.int32))


def test_linalg_wrappers_raise_when_tiles_do_not_fit(cuda):
    """A block size whose tiles exceed the 227 KB of shared memory a thread
    block can have on an H100 raises in the wrapper and launches nothing; one
    tile row less launches. B4 holds the lower triangle's 32 x 32 tiles (fits
    up to nb = 320), B3 a 32-column strip and five tiles (up to nb = 1632)."""
    before = counters["b3.launches"], counters["b4.launches"]
    for fn, nb in ((cl.cholesky_blocks, 352), (cl.tri_inv_blocks, 1664)):
        A = torch.eye(nb, device=cuda)[None]
        with pytest.raises(ValueError, match="shared memory"):
            fn(A)
        fn(A[:, 32:, 32:].contiguous())  # one tile row less fits and launches
    assert (counters["b3.launches"], counters["b4.launches"]) == (before[0] + 1,
                                                                          before[1] + 1)


def test_blocked_ladder_through_b4_matches_cholesky_ex(cuda):
    """The jitter ladder with cuda_chol_blocks on (blocked_cholesky, diagonal
    blocks in B4) against the default route (full cholesky_ex) on a bench-data
    Matern52 Gram matrix at N=1024, float32: the same rung per lane, and both
    factors reproduce Ky to n u of its largest entry (u = 2^-24)."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.ops import linalg

    X, Y = bench_data(n=1024)
    m = make_model(X, Y, dtype=torch.float32, device=cuda)
    Ky = m.kern.K(m.X) + 0.05 * torch.eye(1024, device=cuda)
    Ky = torch.stack([Ky, Ky * 2.0])
    before = counters["b4.launches"]
    old = config.cuda_chol_blocks
    try:
        config.cuda_chol_blocks = True
        L, _, ok, rung = linalg.jitchol_full(Ky)
    finally:
        config.cuda_chol_blocks = old
    assert counters["b4.launches"] > before
    L0, _, ok0, rung0 = linalg.jitchol_full(Ky)
    assert bool(ok.all()) and torch.equal(rung, rung0)
    for f in (L, L0):
        f = f.double()
        res = float((f @ f.mT - Ky.double()).abs().max() / Ky.abs().max())
        assert res <= 1024 * 2.0 ** -24, res


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("op", ["add", "prod"])
def test_composite_kernel_route_matches_plain_route(op, lanes, cuda):
    """``Add`` / ``Prod`` of two parts that pass the kernel gate, each on its
    own ``active_dims`` (a strided slice of X): with the kernels on, each part
    launches B1 (and B2 under autograd; the product's rematerialized build
    launches B1 again on the way back); values and parameter gradients equal
    the plain route's, at this file's tolerances."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.kernels import RBF, Matern52
    from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves, replace_leaves

    gen = torch.Generator(device="cpu").manual_seed(3)
    X = (torch.rand(300, 6, generator=gen) * 4 - 2).to(cuda)
    G = torch.randn(lanes, 300, 300, generator=gen).to(cuda)
    p1, p2 = _params(cuda, lanes, 4, seed=1), _params(cuda, lanes, 2, seed=2)
    shape = (lanes,) if lanes > 1 else ()
    parts = (Matern52(input_dim=4, active_dims=(0, 1, 3, 5), variance=p1[:, 0].reshape(shape),
                      lengthscale=p1[:, 2:6].reshape(shape + (4,))),
             RBF(input_dim=2, active_dims=(2, 4), variance=p2[:, 0].reshape(shape),
                 lengthscale=p2[:, 2].reshape(shape)))
    kern = parts[0] + parts[1] if op == "add" else parts[0] * parts[1]

    def run(use_kernels):
        old = config.use_cuda_kernels
        config.use_cuda_kernels = use_kernels
        try:
            leaves = [t.clone().requires_grad_(True) for _, t in named_leaves(kern)]
            K = replace_leaves(kern, leaves).K(X)
            grads = torch.autograd.grad(torch.sum(K * G), leaves)
            return K.detach(), grads
        finally:
            config.use_cuda_kernels = old

    counters["b1.launches"] = counters["b2.launches"] = 0
    K, grads = run("auto")
    assert counters["b1.launches"] == (2 if op == "add" else 4)
    assert counters["b2.launches"] == 2
    launches = counters["b1.launches"]
    K_plain, grads_plain = run(False)
    assert counters["b1.launches"] == launches  # the plain route launches nothing
    assert K.shape == ((lanes, 300, 300) if lanes > 1 else (300, 300))
    torch.testing.assert_close(K, K_plain, rtol=2e-5, atol=2e-6)
    for a, b in zip(grads, grads_plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    assert torch.equal(K, K.mT)


@pytest.mark.parametrize("n", [1000, 1237])
def test_sparse_kmn_and_z_gradient_match_plain(n, cuda):
    """The sparse bound's Kmn = K(Z, X) at M = 256 inducing inputs and a
    ragged N: B1 against the plain build, and through autograd the gradient
    with respect to Z (B2's row pass) and the parameters against the plain
    route's; the launches are counted."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.kernels import RBF

    gen = torch.Generator(device="cpu").manual_seed(5)
    X = (torch.rand(n, 2, generator=gen) * 6 - 3).to(cuda)
    Z0 = (torch.rand(256, 2, generator=gen) * 6 - 3).to(cuda)
    G = torch.randn(256, n, generator=gen).to(cuda)
    kern = RBF.create(2, variance=1.3, lengthscale=0.8, dtype=torch.float32, device=cuda)

    def run(use_kernels):
        old = config.use_cuda_kernels
        config.use_cuda_kernels = use_kernels
        try:
            Z = Z0.clone().requires_grad_(True)
            var = kern.variance.clone().requires_grad_(True)
            K = RBF(input_dim=2, variance=var, lengthscale=kern.lengthscale).K(Z, X)
            return (K.detach(),) + torch.autograd.grad(torch.sum(K * G), (Z, var))
        finally:
            config.use_cuda_kernels = old

    counters["b1.launches"] = counters["b2.launches"] = 0
    counters["b2.launches_dx"] = 0
    got = run("auto")
    assert counters["b1.launches"] == 1 and counters["b2.launches_dx"] == 1
    want = run(False)
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-6)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_lane_posterior_equals_single_lane_posteriors(cuda):
    """The MCMC surrogate's S-lane posterior, factored in one batched call,
    against S posteriors of one lane each: the same predictions."""
    from gaussian_process_optimization_tpu_torch.models.mcmc_bo_model import GPModel_MCMC

    X, Y = bench_data(n=300)
    m = make_model(X, Y, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(0)
    rows = np.hstack([rng.uniform(0.3, 1.0, (4, 1)), rng.uniform(0.8, 2.0, (4, 6)),
                      rng.uniform(-4.0, -3.0, (4, 1))])
    lanes = GPModel_MCMC(device=cuda)
    lanes.set_samples(m, rows)
    Xt = rng.uniform(-2, 2, (50, 6))
    mus, stds = lanes.predict(Xt)
    for s in range(4):
        one = GPModel_MCMC(device=cuda)
        one.set_samples(m, rows[s:s + 1])
        mu, sd = one.predict(Xt)
        np.testing.assert_allclose(mus[s], mu[0], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(stds[s], sd[0], rtol=1e-4, atol=1e-5)
    assert lanes.samples.kern.variance.shape == (4,)


def test_mcmc_update_launches_the_kernels(cuda):
    """One GP_MCMC refit at N = 300 (a short chain; the 512 bucket, so that
    tri_inv_lower has two 256-blocks for B3) in float32 on the card: B1, B2 and
    B3 launched, the samples finite."""
    from gaussian_process_optimization_tpu_torch.models.mcmc_bo_model import GPModel_MCMC

    X, Y = bench_data(n=300)
    model = GPModel_MCMC(n_samples=3, n_burnin=2, subsample_interval=2, leapfrog_steps=3,
                         device=cuda)
    assert model.dtype == torch.float32
    counters["b1.launches"] = counters["b2.launches"] = 0
    counters["b3.launches"] = 0
    model.updateModel(X, Y)
    assert counters["b1.launches"] > 0 and counters["b2.launches"] > 0
    assert counters["b3.launches"] > 0
    assert np.all(np.isfinite(model.hmc_samples)) and model.hmc_samples.shape[0] == 3


def test_bare_bayesian_optimization_runs_float32_kernels(cuda):
    """A bare BayesianOptimization(f, domain) builds on the card in float32 and
    its refit launches B1."""
    from gaussian_process_optimization_tpu_torch.bo import BayesianOptimization, bounds_to_space

    def f(x):
        x = np.atleast_2d(x)
        return np.sum(np.square(x - 0.3), axis=1, keepdims=True)

    X = np.random.default_rng(0).uniform(-2, 2, (200, 2))
    bo = BayesianOptimization(f, bounds_to_space([(-2.0, 2.0)] * 2), X=X, max_iters=5)
    assert bo.model.device.type == "cuda" and bo.model.dtype == torch.float32
    counters["b1.launches"] = 0
    x = bo.suggest_next_locations()
    assert counters["b1.launches"] > 0
    assert x.shape == (1, 2) and np.all(np.abs(x) <= 2.0)


@pytest.mark.parametrize("batch", [2048, 1000])
def test_svgp_elbo_launches_and_z_gradient_match_plain(batch, cuda):
    """A minibatch ELBO of the SVGP at M = 256 (D = 2, RBF, lengthscale 0.4):
    Kmm and Kmn = K(Z, X_batch) go through B1, Z's gradient through B2 (Kmm's
    both passes, Kmn's row pass). Kmm's factor amplifies float32's rounding of
    K, so each route is held against the float64 plain route: the kernel
    route's error in the ELBO and in its gradient in Z and the kernel within 4x
    the plain float32 route's (B1's per-entry error is ~1.1x the plain K's)."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.kernels import RBF
    from gaussian_process_optimization_tpu_torch.models.svgp import SVGP
    from gaussian_process_optimization_tpu_torch.workload import sparse_data, svgp_probe

    X, Y = sparse_data(n=5000)
    kern = RBF.create(2, variance=1.0, lengthscale=0.4, device=cuda)
    model = svgp_probe(SVGP.create(X, Y, kernel=kern, num_inducing=256, noise_var=0.05,
                                   device=cuda))
    Xb = torch.as_tensor(X[:batch], dtype=torch.float32, device=cuda)
    Yb = torch.as_tensor(Y[:batch], dtype=torch.float32, device=cuda)

    def run(use_kernels, dtype=torch.float32):
        old = config.use_cuda_kernels
        config.use_cuda_kernels = use_kernels
        try:
            t = {k: getattr(model, k).to(dtype) for k in ("Z", "q_mu", "q_sqrt_flat",
                                                         "likelihood_variance", "num_data")}
            Z = t.pop("Z").requires_grad_(True)
            ls = model.kern.lengthscale.to(dtype).requires_grad_(True)
            m = SVGP(kern=RBF(input_dim=2, variance=model.kern.variance.to(dtype),
                              lengthscale=ls), Z=Z, **t)
            elbo = m.elbo(Xb.to(dtype), Yb.to(dtype))
            return (elbo.detach(),) + torch.autograd.grad(elbo, (Z, ls))
        finally:
            config.use_cuda_kernels = old

    counters["b1.launches"] = counters["b2.launches"] = 0
    counters["b2.launches_dx"] = counters["b2.launches_dz"] = 0
    got = run("auto")
    assert counters["b1.launches"] == 2
    assert counters["b2.launches_dx"] == 2 and counters["b2.launches_dz"] == 1
    plain = run(False)
    ref = run(False, torch.float64)
    for a, b, r in zip(got, plain, ref):
        scale = float(r.abs().max())
        err_kernel = float((a.double() - r).abs().max()) / scale
        err_plain = float((b.double() - r).abs().max()) / scale
        print(f"SVGP f32 error against the float64 plain route: kernel {err_kernel:.3e}, "
              f"plain {err_plain:.3e}")
        assert err_kernel <= 4.0 * err_plain + 1e-6, (err_kernel, err_plain)


@pytest.mark.parametrize("which", ["laplace", "ep", "tp"])
def test_approximate_inference_launches_the_kernels(which, cuda):
    """The Laplace evidence, the EP evidence at fixed sites and the Student-t
    process evidence at N = 256, D = 6 in float32: B1 forward and B2 backward
    launched, the value and the kernel gradient against the plain route."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.kernels import RBF
    from gaussian_process_optimization_tpu_torch.models.classification import GPClassification
    from gaussian_process_optimization_tpu_torch.models.laplace import GPLaplace
    from gaussian_process_optimization_tpu_torch.models.tp import TPRegression
    from gaussian_process_optimization_tpu_torch.workload import classification_labels

    X, Y = bench_data(n=256)
    labels = classification_labels(Y)
    kern = RBF.create(6, variance=1.0, lengthscale=1.5, device=cuda)
    if which == "laplace":
        model = GPLaplace.create(X, labels, kernel=kern, device=cuda)
    elif which == "tp":
        model = TPRegression.create(X, Y, kernel=kern, deg_free=5.0, device=cuda)
    else:
        model = GPClassification.create(X, labels, kernel=kern, device=cuda)
        post = model.inference()

    def run(use_kernels):
        old = config.use_cuda_kernels
        config.use_cuda_kernels = use_kernels
        try:
            ls = model.kern.lengthscale.clone().requires_grad_(True)
            m = dataclasses.replace(model, kern=RBF(input_dim=6, variance=model.kern.variance,
                                                    lengthscale=ls))
            val = (m.site_fixed_lml(post.tau_site, post.nu_site) if which == "ep"
                   else m.log_marginal_likelihood())
            return val.detach(), torch.autograd.grad(val, ls)[0]
        finally:
            config.use_cuda_kernels = old

    counters["b1.launches"] = counters["b2.launches"] = 0
    got = run("auto")
    assert counters["b1.launches"] >= 1 and counters["b2.launches"] >= 1
    want = run(False)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-3 * float(want[1].abs().max()))


@pytest.mark.parametrize("lanes", [1, 3])
def test_icm_product_with_active_dims_matches_plain_route(lanes, cuda):
    """The ICM kernel, ARD Matern52 on 6 of 7 columns (an ``active_dims``
    slice) times Coregionalize on the task column: with the kernels on, the
    Matern52 part launches B1 (twice under autograd: the product's
    rematerialized build) and B2's row and column passes; K and every leaf's
    gradient equal the plain
    route's; the task column's gradient is exactly zero on both."""
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.kernels import Matern52
    from gaussian_process_optimization_tpu_torch.models.multioutput import icm_kernel
    from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves, replace_leaves

    gen = torch.Generator(device="cpu").manual_seed(4)
    X = torch.cat([torch.rand(300, 6, generator=gen) * 4 - 2,
                   torch.randint(0, 3, (300, 1), generator=gen).float()], dim=1).to(cuda)
    G = torch.randn(lanes, 300, 300, generator=gen).to(cuda)
    base = Matern52.create(6, ARD=True, lengthscale=[0.7, 1.1, 0.9, 1.4, 0.8, 1.2],
                           dtype=torch.float32, device=cuda)
    kern = icm_kernel(6, 3, base, rank=1, W=[[0.5], [1.0], [-0.3]], kappa=[0.2, 0.4, 0.1])
    if lanes > 1:
        scale = torch.linspace(0.9, 1.1, lanes, device=cuda)
        kern = replace_leaves(kern, [t * scale.reshape((lanes,) + (1,) * t.ndim)
                                     for _, t in named_leaves(kern)])

    def run(use_kernels):
        old = config.use_cuda_kernels
        config.use_cuda_kernels = use_kernels
        try:
            leaves = [t.clone().requires_grad_(True) for _, t in named_leaves(kern)]
            Xg = X.clone().requires_grad_(True)
            K = replace_leaves(kern, leaves).K(Xg)
            grads = torch.autograd.grad(torch.sum(K * G), leaves + [Xg])
            return K.detach(), grads
        finally:
            config.use_cuda_kernels = old

    counters["b1.launches"] = counters["b2.launches"] = 0
    K, grads = run("auto")
    assert counters["b1.launches"] == 2
    # X is both arguments and gets a gradient: the row pass and the column pass
    assert counters["b2.launches"] == 2
    K_plain, grads_plain = run(False)
    torch.testing.assert_close(K, K_plain, rtol=2e-5, atol=2e-6)
    # the leaves' gradients; X's only on its task column (the plain route's
    # float32 dX goes through the matmul form of r^2 and is not an oracle)
    for a, b in zip(grads[:-1], grads_plain[:-1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    assert torch.all(grads[-1][:, -1] == 0) and torch.all(grads_plain[-1][:, -1] == 0)


def test_icm_lml_through_b1_matches_plain_route(cuda):
    """The coregionalized GP's -LML and its gradient in the optimizer's
    coordinates at N = 600 (3 tasks) in float32: through B1 / B2 / B3 against
    the plain route, each within 4x the plain route's error against float64."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    Xs, Ys = workload.icm_data(n=600)
    model = workload.icm_model(Xs, Ys, dtype=torch.float32, device=cuda).model
    packer = make_packer(model)
    obj = make_objective(packer)

    def value_and_grad(m, use_kernels="auto"):
        old = config.use_cuda_kernels
        config.use_cuda_kernels = use_kernels
        try:
            u = packer.pack(m)[None].clone().requires_grad_(True)
            f = obj(u, m)[0]
            (g,) = torch.autograd.grad(f, u)
            return float(f.detach()), g[0].double()
        finally:
            config.use_cuda_kernels = old

    counters["b1.launches"] = counters["b3.launches"] = 0
    f_k, g_k = value_and_grad(model)
    assert counters["b1.launches"] > 0 and counters["b3.launches"] > 0
    f_p, g_p = value_and_grad(model, False)
    f64, g64 = value_and_grad(tree_map(lambda t: t.double(), model), False)
    scale = float(g64.abs().max())
    err_k, err_p = abs(f_k - f64) / abs(f64), abs(f_p - f64) / abs(f64)
    gerr_k = float((g_k - g64).abs().max()) / scale
    gerr_p = float((g_p - g64).abs().max()) / scale
    print(f"ICM -LML f32 vs f64: kernels {err_k:.2e}, plain {err_p:.2e}; gradient "
          f"kernels {gerr_k:.2e}, plain {gerr_p:.2e}")
    assert err_k <= 4 * max(err_p, 1e-7)
    assert gerr_k <= 4 * max(gerr_p, 1e-6)


@pytest.mark.parametrize("lanes", [1, 3])
def test_symmetric_k_x_gradient_is_row_plus_column_pass(lanes, cuda):
    """A trainable X fed as both inputs of K(X, X): autograd's dX is B2's row
    pass (dX) plus its column pass (dZ), each launched once, equal to the plain
    route's and within 1e-4 (relative) of the float64 gradient of sum(G K)."""
    from gaussian_process_optimization_tpu_torch.kernels import RBF

    gen = torch.Generator(device="cpu").manual_seed(7)
    X0 = (torch.rand(lanes, 300, 6, generator=gen) * 4 - 2).to(cuda)
    G = torch.randn(lanes, 300, 300, generator=gen).to(cuda)
    ls = (0.5 + torch.rand(lanes, 6, generator=gen)).to(cuda)
    var = (0.5 + torch.rand(lanes, generator=gen)).to(cuda)

    def grad(dtype):
        X = X0.to(dtype).requires_grad_(True)
        kern = RBF(input_dim=6, variance=var.to(dtype), lengthscale=ls.to(dtype))
        # float32 passes the kernel gate; float64 takes the plain route
        (g,) = torch.autograd.grad(torch.sum(kern.K(X) * G.to(dtype)), X)
        return g

    counters["b2.launches_dx"] = counters["b2.launches_dz"] = 0
    got = grad(torch.float32)
    assert counters["b2.launches_dx"] == 1
    assert counters["b2.launches_dz"] == 1
    X3 = X0.contiguous()
    p = ck.params_rows(RBF(input_dim=6, variance=var, lengthscale=ls), 6, True)
    _, dX, dZ = ck.k_backward_plain(X3.double(), X3.double(), p.double(), G.double(), "rbf",
                                    True)
    want = grad(torch.float64)
    torch.testing.assert_close(want, dX + dZ, rtol=1e-10, atol=1e-10)
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err < 1e-4, err


def test_padded_rows_of_a_trainable_x_get_zero_gradient_through_the_kernels(cuda):
    """A GPLVM padded to 512 rows under a mask: the padded rows' X-gradient
    through B1 / B2 / B3 is exactly 0."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.models.gp import GPRegression

    Y, _, _ = workload.latent_data(n=400, held_out=1)
    m = workload.gplvm_model(Y, device=cuda)
    m = GPRegression.create(m.X.cpu().numpy(), Y, kernel=m.kern, noise_var=0.1, max_points=512,
                            device=cuda)
    X = m.X.clone().requires_grad_(True)
    counters["b2.launches_dz"] = 0
    (g,) = torch.autograd.grad(dataclasses.replace(m, X=X).log_marginal_likelihood(), X)
    assert counters["b2.launches_dz"] == 1
    assert bool((g[400:] == 0).all()) and bool(torch.isfinite(g).all())


def test_gplvm_gradient_through_the_kernels_matches_plain_route(cuda):
    """The point GPLVM's -LML gradient (the X block included) at N = 512
    through B1 / B2 / B3 and through the plain route, both float32, against
    float64: the kernels' error within 4x the plain route's (plus 1e-6)."""
    from gaussian_process_optimization_tpu_torch import workload
    from gaussian_process_optimization_tpu_torch.config import config
    from gaussian_process_optimization_tpu_torch.models.gplvm import gplvm_packer
    from gaussian_process_optimization_tpu_torch.utils.tree import tree_map

    Y, _, _ = workload.latent_data(n=512, held_out=1)
    model = workload.gplvm_model(Y, device=cuda)
    packer = gplvm_packer(model)
    obj = make_objective(packer)

    def grad(m, use_kernels):
        old = config.use_cuda_kernels
        config.use_cuda_kernels = use_kernels
        try:
            u = packer.pack(m).detach().clone().requires_grad_(True)
            return torch.autograd.grad(obj(u, m), u)[0].double()
        finally:
            config.use_cuda_kernels = old

    for name in ("b1.launches", "b2.launches", "b3.launches"):
        counters[name] = 0
    got = grad(model, "auto")
    assert counters["b1.launches"] > 0 and counters["b2.launches"] > 0
    assert counters["b3.launches"] > 0
    plain = grad(model, False)
    ref = grad(tree_map(lambda t: t.double(), model), False)
    scale = float(ref.abs().max())
    err_k, err_p = (float((g - ref).abs().max()) / scale for g in (got, plain))
    print(f"GPLVM f32 gradient error against float64: kernels {err_k:.3e}, plain {err_p:.3e}")
    assert err_k <= 4.0 * err_p + 1e-6, (err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 4])
def test_distributed_cholesky_through_the_kernel_matches_cholesky_ex(cuda, n_shards):
    """float32, N = 2048 in panels of 256 over 1 or 4 shards of the card: the
    diagonal blocks through the batched Cholesky kernel, against the same
    panel loop through ``cholesky_ex`` and against float64 LAPACK; the kernel
    launches once per panel."""
    rng = np.random.default_rng(2)
    Xr = rng.standard_normal((2048, 64))
    A64 = Xr @ Xr.T / 64 + np.eye(2048)
    A = torch.tensor(A64, dtype=torch.float32, device=cuda)
    chol = sharded.make_distributed_cholesky(sharded.make_mesh(n_shards, device="cuda:0"), nb=256)
    old = config.cuda_chol_blocks
    try:
        config.cuda_chol_blocks = False
        L_plain = chol(A)
        config.cuda_chol_blocks = True
        before = counters["b4.launches"]
        L_kernel = chol(A)
        assert counters["b4.launches"] - before == 2048 // 256
    finally:
        config.cuda_chol_blocks = old
    L64 = np.linalg.cholesky(A64)
    err_kernel = np.abs(L_kernel.double().cpu().numpy() - L64).max()
    err_plain = np.abs(L_plain.double().cpu().numpy() - L64).max()
    print(f"distributed Cholesky f32 vs f64: kernel {err_kernel:.3e}, cholesky_ex "
          f"{err_plain:.3e}")
    assert err_kernel <= 4 * max(err_plain, 1e-6)
    np.testing.assert_allclose(L_kernel.cpu().numpy(), L_plain.cpu().numpy(), atol=2e-5)


@pytest.mark.cuda
def test_cluster_round_through_the_kernels_matches_plain_k(cuda):
    """One round of 10 lanes (4 singles, 6 pairs of tests/test_cluster.py's
    two shifted copies of two curves, noise 0.1) padded to 128 rows (the K
    kernel's gate wants 128^2 entries a lane) in float32 on the card: the
    lanes' objective and gradient at the start through the K kernel and its
    backward equal the plain K's to 1e-4, and after 60 L-BFGS steps each
    lane's LL agrees to 1e-2 (the two runs' rounding steers the line
    searches apart) and its offset to 0.05."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 3, 10)[:, None]
    curves = [np.sin(2.0 * (t - d)) for d in (0.0, 0.4)] + [2.0 - 2.0 * (t - d)
                                                          for d in (0.0, 0.4)]
    data = [c.T + 0.1 * rng.standard_normal((1, 10)) for c in curves]
    jobs = [(t, data[i].T, np.zeros(10)) for i in range(4)]
    jobs += [(np.vstack([t, t]), np.vstack([data[i].T, data[j].T]),
              np.r_[np.zeros(10), np.ones(10)]) for i in range(4) for j in range(i)]
    batch = cluster.pad_stack(jobs, 128, torch.float32, cuda)
    U0 = cluster._u0(len(jobs), torch.float32, cuda).clone()

    def start_and_fit():
        U = U0.clone().requires_grad_(True)
        f = -cluster._masked_lml(U, *batch, True)
        (g,) = torch.autograd.grad(f.sum(), U)
        return f.detach(), g, cluster.fit_batch(U0, *batch, True, 60)

    b1, b2 = counters["b1.launches"], counters["b2.launches"]
    f, g, (ll, off) = start_and_fit()
    assert counters["b1.launches"] > b1 and counters["b2.launches"] > b2
    old = config.use_cuda_kernels
    try:
        config.use_cuda_kernels = False
        f_p, g_p, (ll_p, off_p) = start_and_fit()
    finally:
        config.use_cuda_kernels = old
    print(f"cluster round f32, kernel vs plain: start value "
          f"{float(((f - f_p).abs() / f_p.abs()).max()):.3e}, gradient "
          f"{float((g - g_p).abs().max() / g_p.abs().max()):.3e}; fitted LL "
          f"{float(((ll - ll_p).abs() / ll_p.abs()).max()):.3e}, offsets "
          f"{float((off - off_p).abs().max()):.3e}")
    torch.testing.assert_close(f, f_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4 * float(g_p.abs().max()))
    torch.testing.assert_close(ll, ll_p, rtol=1e-2, atol=1e-1)
    torch.testing.assert_close(off.detach(), off_p.detach(), rtol=0, atol=5e-2)
