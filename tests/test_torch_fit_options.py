"""The port's fit options against the JAX package's, in float64 on the CPU:
the L-BFGS trace, the Zhang-Hager nonmonotone search and the hold policy, the
aux channel, the Fitter's thread ladder, the environment variables that set
their defaults, and the gradient's matmul precision in ``tri_inv_lower`` and
``tri_tdot``. The JAX references run vmapped under ``jax.jit`` from the same
injected starts."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.config import config as jconfig
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.ops import lbfgs as jlbfgs
import gaussian_process_optimization_tpu_torch.kernels as tk
from gaussian_process_optimization_tpu_torch import workload
from gaussian_process_optimization_tpu_torch.config import config as tconfig
from gaussian_process_optimization_tpu_torch.models.fit import Fitter
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression as TGP
from gaussian_process_optimization_tpu_torch.ops import lbfgs, linalg
from gaussian_process_optimization_tpu_torch.utils.tree import tree_map
from test_torch_slice import PROBLEMS
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

# test_torch_slice.py's objectives, and Rosenbrock's, on which the
# nonmonotone search changes a lane's trials within 20 steps (the hold policy
# changes them on the quadratic). Past ~20 steps its valley amplifies the two
# packages' last-bit differences beyond the trace's 1e-10.
PROBLEMS = dict(PROBLEMS, rosenbrock=(
    lambda X: 100.0 * (X[:, 1] - X[:, 0] ** 2) ** 2 + (1 - X[:, 0]) ** 2,
    lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2,
    [[-1.2, 1.0], [2.0, -1.0], [0.5, 2.5]],
    dict(maxiter=20, tol=0.0)))


def _run_both(name, carry, tfun, jfun, aux0=None, **options):
    """The port's batched run and the JAX package's vmapped one from the
    problem's starts, with the same options (and per-lane aux0, if given)."""
    _, _, starts, opts = PROBLEMS[name]
    starts = np.asarray(starts, dtype=float)
    lo, hi = opts.get("lower"), opts.get("upper")
    kw = dict(maxiter=opts["maxiter"], tol=opts.get("tol", 1e-5), **options)
    ours = lbfgs.minimize(tfun, torch.tensor(starts), lower=lo, upper=hi, carry_graph=carry,
                          aux0=None if aux0 is None else torch.tensor(aux0, dtype=torch.float64),
                          **kw)

    def solve(x0, a0):
        return jlbfgs.minimize(jfun, x0, lower=None if lo is None else jnp.full(x0.shape, lo),
                               upper=None if hi is None else jnp.full(x0.shape, hi),
                               carry_vjp=carry, aux0=a0, **kw)

    if aux0 is None:
        theirs = jax.jit(jax.vmap(lambda x0: solve(x0, None)))(jnp.asarray(starts))
    else:
        theirs = jax.jit(jax.vmap(solve))(jnp.asarray(starts), jnp.asarray(aux0))
    return ours, theirs


def _same_lanes(ours, theirs):
    np.testing.assert_array_equal(ours.num_ls.numpy(), np.asarray(theirs.num_ls))
    np.testing.assert_array_equal(ours.num_iters.numpy(), np.asarray(theirs.num_iters))
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(theirs.failed))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(theirs.x), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(ours.f.numpy(), np.asarray(theirs.f), rtol=1e-8, atol=1e-12)


def _same_trace(ours, theirs):
    """NaN in the same places; rtol 1e-10 where both are finite (atol 1e-14
    for the objectives that reach 0)."""
    t, j = ours.trace.numpy(), np.asarray(theirs.trace)
    assert t.shape == j.shape
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    both = np.isfinite(t) & np.isfinite(j)
    np.testing.assert_allclose(t[both], j[both], rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_trace_matches_jax(name, carry):
    """``trace=True``: each lane's (maxiter + 1,) record, f0 then each step's
    value, NaN after its last step; the default run's results unchanged."""
    tfun, jfun, _, _ = PROBLEMS[name]
    ours, theirs = _run_both(name, carry, tfun, jfun, trace=True)
    _same_lanes(ours, theirs)
    _same_trace(ours, theirs)
    k = ours.num_iters.numpy()
    t = ours.trace.numpy()
    for lane in range(t.shape[0]):
        assert np.all(np.isnan(t[lane, k[lane] + 1:]))
    assert ours.aux is None
    _, _, starts, opts = PROBLEMS[name]
    plain = lbfgs.minimize(tfun, torch.tensor(starts, dtype=torch.float64),
                           lower=opts.get("lower"), upper=opts.get("upper"),
                           maxiter=opts["maxiter"], tol=opts.get("tol", 1e-5), carry_graph=carry)
    assert plain.trace is None
    for a, b in zip(plain[:6], ours[:6]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("option", [{"nonmonotone_eta": 0.5}, {"grow_backtracked": 1.0}],
                         ids=["eta", "hold"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_line_search_options_match_jax(name, option):
    """The Zhang-Hager search (each lane against its own C) and the hold
    policy: the same x, f (rtol 1e-8), num_iters and num_ls (exact), the
    trace too."""
    tfun, jfun, _, _ = PROBLEMS[name]
    ours, theirs = _run_both(name, True, tfun, jfun, trace=True, **option)
    _same_lanes(ours, theirs)
    _same_trace(ours, theirs)


@pytest.mark.parametrize("name, option", [("rosenbrock", {"nonmonotone_eta": 0.5}),
                                          ("quadratic", {"grow_backtracked": 1.0})])
def test_options_change_the_search(name, option):
    """Neither option is the default search under another name: each spends
    a different number of trials in some lane."""
    tfun, _, starts, opts = PROBLEMS[name]
    x0 = torch.tensor(starts, dtype=torch.float64)
    kw = dict(maxiter=opts["maxiter"], tol=opts.get("tol", 1e-5))
    plain = lbfgs.minimize(tfun, x0, **kw)
    assert not torch.equal(plain.num_ls, lbfgs.minimize(tfun, x0, **kw, **option).num_ls)


def _aux_pair(name):
    """The problem's objective scaled by 1 + tanh(aux) / 20, and an aux_out
    that depends on the evaluated point and on the aux it was given."""
    tfun, jfun, _, _ = PROBLEMS[name]

    def taux(X, A):
        return tfun(X) * (1.0 + 0.05 * torch.tanh(A)), 0.5 * A + X.sum(-1)

    def jaux(x, a):
        return jfun(x) * (1.0 + 0.05 * jnp.tanh(a)), 0.5 * a + jnp.sum(x)

    return taux, jaux


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("name", ["quadratic", "nan_region"])
def test_aux_channel_matches_jax(name, carry):
    """``aux0`` per lane: each evaluation gets the aux of its lane's last
    accepted one, so the objective itself depends on the accepted path;
    ``result.aux`` and every lane's result equal the JAX package's
    (nan_region: lanes whose searches fail at max_ls)."""
    taux, jaux = _aux_pair(name)
    ours, theirs = _run_both(name, carry, taux, jaux, aux0=[0.0, 1.0, -2.0], trace=True)
    _same_lanes(ours, theirs)
    _same_trace(ours, theirs)
    np.testing.assert_allclose(ours.aux.numpy(), np.asarray(theirs.aux), rtol=1e-10,
                               atol=1e-14)


def test_aux_single_lane_and_scalar_broadcast():
    """A 1-D x0 is one lane, its aux unbatched; a scalar aux0 reaches every
    lane of a batch."""
    taux, _ = _aux_pair("quadratic")
    _, _, starts, _ = PROBLEMS["quadratic"]
    x0 = torch.tensor(starts, dtype=torch.float64)
    batch = lbfgs.minimize(taux, x0, maxiter=20, aux0=torch.tensor(0.5, dtype=torch.float64))
    one = lbfgs.minimize(taux, x0[1], maxiter=20, aux0=torch.tensor(0.5, dtype=torch.float64))
    assert one.aux.shape == () and one.x.shape == (3,)
    assert torch.equal(one.aux, batch.aux[1]) and torch.equal(one.x, batch.x[1])
    with pytest.raises(ValueError, match="rows for 3 lanes"):
        lbfgs.minimize(taux, x0, maxiter=2, aux0=torch.zeros(2, dtype=torch.float64))


# ------------------------------------------------------------------ thread ladder
@pytest.fixture
def no_noise_floor():
    """Both packages' added noise off (the ladder-climbing data need Ky
    singular or indefinite before the jitter)."""
    saved = [(c, c.noise_jitter, c.f32_noise_floor) for c in (jconfig, tconfig)]
    for c, _, _ in saved:
        c.noise_jitter = c.f32_noise_floor = 0.0
    yield
    for c, jit, floor in saved:
        c.noise_jitter, c.f32_noise_floor = jit, floor


def _duplicated(noise):
    """12 inputs each repeated 3 times with the same target: K has rank 12 of
    36. With noise 1e-18 every lane's Ky fails at rung 0 and takes rung 1;
    with a fixed noise of -1e-4, Ky is indefinite until the jitter outweighs
    it, so each lane's rung follows its variance (3 or 4 here), far from any
    rounding boundary."""
    rng = np.random.default_rng(0)
    X = np.repeat(rng.uniform(-2, 2, (12, 2)), 3, axis=0)
    Y = np.sin(X[:, :1] * 2) + 0.1 * np.repeat(rng.standard_normal((12, 1)), 3, axis=0)
    jm = JGP.create(X, Y, kernel=jk.RBF.create(2, ARD=True, variance=2.0), noise_var=noise)
    tm = TGP.create(X, Y, kernel=tk.RBF.create(2, ARD=True, variance=2.0, device="cpu"),
                    noise_var=noise, device="cpu")
    return jm, tm


@pytest.mark.parametrize("noise", [1e-18, -1e-4])
def test_thread_ladder_matches_jax(noise, no_noise_floor):
    """``Fitter(thread_ladder=True)`` on a GP whose ladder leaves rung 0, 3
    restarts x 20 steps from the JAX Fitter's own starts (PRNGKey(0)): per-lane
    f (rtol 1e-8), the accepted rungs in ``result.aux`` (exact), num_ls and
    num_iters (exact)."""
    jm, tm = _duplicated(noise)
    fix = ("likelihood_variance",)
    jf = jfit.Fitter(jm, num_restarts=3, maxiter=20, tol=0.0, fix=fix, thread_ladder=True)
    key = jax.random.PRNGKey(0)
    _, jres = jf(jm, key)
    u0 = jf.packer.pack(jm)
    z = jax.random.normal(key, (2, u0.shape[0]), dtype=u0.dtype)
    starts = np.asarray(jnp.concatenate([u0[None], jax.vmap(jf.packer.map_restart)(z)]))
    tf = Fitter(tm, num_restarts=3, maxiter=20, tol=0.0, fix=fix, thread_ladder=True)
    assert tf.thread_ladder
    _, res = tf.solve(tm, torch.tensor(starts))
    np.testing.assert_allclose(res.f.numpy(), np.asarray(jres.f), rtol=1e-8)
    np.testing.assert_array_equal(res.aux.numpy(), np.asarray(jres.aux))
    assert res.aux.dtype == torch.float32 and float(res.aux.min()) >= 1.0
    np.testing.assert_array_equal(res.num_ls.numpy(), np.asarray(jres.num_ls))
    np.testing.assert_array_equal(res.num_iters.numpy(), np.asarray(jres.num_iters))


def test_thread_ladder_starts_from_the_models_hint():
    """A model carrying a hint seeds every lane's aux with it; on
    well-conditioned data greedy from 2 accepts 2 (tests/test_fit_thread_ladder.py
    ::test_threaded_fit_respects_initial_hint through the port). Only an
    exact GPRegression takes the ladder."""
    import dataclasses

    from gaussian_process_optimization_tpu_torch.models.sparse import SparseGPRegression

    X, Y = workload.bench_data(n=32, d=2)
    tm = TGP.create(X, Y, noise_var=0.05, device="cpu")
    tm = dataclasses.replace(tm, jitter_hint=torch.tensor(2.0))
    _, res = Fitter(tm, num_restarts=2, maxiter=3, tol=0.0, thread_ladder=True)(tm)
    np.testing.assert_array_equal(res.aux.numpy(), [2.0, 2.0])
    sm = SparseGPRegression.create(X, Y, num_inducing=8, device="cpu")
    assert not Fitter(sm, num_restarts=1, maxiter=2, thread_ladder=True).thread_ladder


def test_thread_ladder_through_a_mesh():
    """With a mesh the rungs split and gather with the lanes: the sharded
    fit equals the unsharded one lane for lane, aux included."""
    from gaussian_process_optimization_tpu_torch.parallel.sharded import make_mesh

    X, Y = workload.bench_data(n=48, d=2)
    tm = TGP.create(X, Y, noise_var=0.05, device="cpu")
    starts = Fitter(tm, num_restarts=4).draw_starts(tm, torch.Generator().manual_seed(3))
    runs = [Fitter(tm, num_restarts=4, maxiter=8, tol=0.0, thread_ladder=True,
                   mesh=mesh).solve(tm, starts)[1]
            for mesh in (None, make_mesh(2, device="cpu"))]
    for a, b in zip(*runs):
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert runs[0].aux.shape == (4,)


_ENV_PROBE = """
import sys
import torch
import gaussian_process_optimization_tpu_torch as tpkg
from gaussian_process_optimization_tpu_torch import workload
from gaussian_process_optimization_tpu_torch.models import fit as tfit
X, Y = workload.bench_data(n=8, d=2)
tf = tfit.Fitter(tpkg.GPRegression.create(X, Y, device="cpu"), maxiter=1)
got = (tpkg.config.grad_matmul_precision, tpkg.config.ls_grow_backtracked, tf.thread_ladder,
       tf.grow_backtracked, torch.get_float32_matmul_precision())
if sys.argv[1] == "jax":
    import gaussian_process_optimization_tpu as jpkg
    from gaussian_process_optimization_tpu.models import fit as jfit
    jf = jfit.Fitter(jpkg.GPRegression.create(X, Y), maxiter=1)
    got += (jpkg.config.grad_matmul_precision, jpkg.config.ls_grow_backtracked,
            jf.thread_ladder)
print(repr(got))
"""


@pytest.mark.parametrize("env, want", [
    ({}, ("highest", 2.0, False, 2.0, "highest", "high", 2.0, False)),
    ({"GPO_GRAD_MATMUL_PRECISION": "high", "GPO_LS_GROW_BACKTRACKED": "1.0",
      "GPO_THREAD_LADDER": "1", "GPO_TPU_MATMUL_PRECISION": "high"},
     ("high", 1.0, True, 1.0, "high", "high", 1.0, True)),
    ({"GPO_TPU_FAST_MATMUL": "1"}, ("highest", 2.0, False, 2.0, "medium")),
], ids=["unset", "set", "fast"])
def test_env_defaults(env, want):
    """Each package's defaults read from its environment variables at import,
    in a fresh interpreter (the port's fields, its Fitter's, torch's float32
    matmul precision, then the JAX package's): the port's gradient precision
    defaults to "highest" where the JAX package's is "high"; the rest agree;
    the global pin maps to torch's float32 matmul precision (the JAX
    package's pin is a JAX flag: the last case reads the port alone)."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("GPO_GRAD_MATMUL_PRECISION", "GPO_LS_GROW_BACKTRACKED",
                         "GPO_THREAD_LADDER", "GPO_TPU_MATMUL_PRECISION",
                         "GPO_TPU_FAST_MATMUL")}
    base.update(env, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    which = "jax" if len(want) > 5 else "port"
    out = subprocess.run([sys.executable, "-c", _ENV_PROBE, which], env=base, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert eval(out.stdout.strip().splitlines()[-1]) == want


# ------------------------------------------------------------------ precision
def _lower(n, dtype, seed=0):
    """The Cholesky factor of a well-conditioned SPD matrix (n x n)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n)
    L = np.linalg.cholesky(A @ A.T + np.eye(n))
    return torch.tensor(L, dtype=dtype)


# bf16x3 keeps ~16 mantissa bits per product. Of max |float64|, at n = 1024
# (tri_inv_lower, tri_tdot): full float32 8.0e-8, 1.4e-6; "high" 1.0e-6,
# 1.4e-5; one bf16 pass 4.7e-4, 4.6e-3. The bound is 7x "high"'s larger
# reading and under a fifth of one pass's smaller.
HIGH_BOUND = 1e-4


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def test_precision_in_tri_inv_and_tri_tdot():
    """float64 operands: "high" changes nothing, bit for bit. float32: "high"
    within HIGH_BOUND of float64 in both functions (n = 1024: four 256-blocks
    merged twice, and the blocked lauum), past full float32's error, and one
    bf16 pass ("default") past the bound."""
    L64 = _lower(1024, torch.float64)
    Li64 = linalg.tri_inv_lower(L64)
    assert torch.equal(linalg.tri_inv_lower(L64, precision="high"), Li64)
    W64 = linalg.tri_tdot(Li64)
    assert torch.equal(linalg.tri_tdot(Li64, precision="high"), W64)
    L32, Li32 = L64.float(), Li64.float()
    errs = {}
    for prec in (None, "high", "default"):
        errs[prec] = (_rel(linalg.tri_inv_lower(L32, precision=prec), Li64),
                      _rel(linalg.tri_tdot(Li32, precision=prec), W64))
    assert max(errs["high"]) < HIGH_BOUND, errs
    assert errs["high"][0] > errs[None][0] and errs["high"][1] > errs[None][1], errs
    assert min(errs["default"]) > HIGH_BOUND, errs
    W = linalg.tri_tdot(Li32, precision="high")
    assert torch.equal(W, W.mT)


def test_matmul_precision_values():
    A = torch.randn(3, 5, 4, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    B = torch.randn(4, 2, dtype=torch.float32, generator=torch.Generator().manual_seed(1))
    assert torch.equal(linalg.matmul(A, B), A @ B)
    assert torch.equal(linalg.matmul(A, B, "highest"), A @ B)
    assert linalg.matmul(A, B, "high").shape == (3, 5, 2)
    with pytest.raises(ValueError, match="precision 'low'"):
        linalg.matmul(A, B, "low")


def _start_gradient(model, prec):
    """The fit objective's gradient at the model's own parameters with the
    backward at ``prec`` (float64 (n,))."""
    from gaussian_process_optimization_tpu_torch.models.fit import make_objective
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer

    packer = make_packer(model)
    u = packer.pack(model)[None].clone().requires_grad_(True)
    old = tconfig.grad_matmul_precision
    tconfig.grad_matmul_precision = prec
    try:
        (g,) = torch.autograd.grad(make_objective(packer)(u, model).sum(), u)
    finally:
        tconfig.grad_matmul_precision = old
    return g[0].double()


def test_grad_precision_changes_float32_gradient_only():
    """ExactCore's backward at "high": the float64 gradient bit for bit, the
    float32 one within 1e-3 of float64 relative to its largest component
    (N = 600: two 256-blocks padded to four, the tri_tdot panels)."""
    X, Y = workload.bench_data(n=600)
    m64 = workload.make_model(X, Y, dtype=torch.float64, device="cpu")
    g64 = _start_gradient(m64, "highest")
    assert torch.equal(_start_gradient(m64, "high"), g64)
    m32 = tree_map(lambda t: t.float(), m64)
    g_high = _start_gradient(m32, "high")
    rel = float((g_high - g64).abs().max() / g64.abs().max())
    assert rel < 1e-3
    assert not torch.equal(g_high, _start_gradient(m32, "highest"))


@pytest.mark.slow
def test_grad_precision_reading_at_the_main_paths_start():
    """The reading behind chip_smoke.py's bf16x3 gate: the float32 gradient of
    the main path's fit objective at its start (N = 4096, D = 6, ARD Matern52,
    noise 0.05) against float64, on the CPU through the plain versions, for
    "highest", "high" and one bf16 pass: the max over the components of
    |g32 - g64| / |g64| (the gate's reading) and max |g32 - g64| / max |g64|.
    Run with ``-m slow -s`` to print them (~15 s with four threads)."""
    torch.set_num_threads(4)
    X, Y = workload.bench_data()
    m64 = workload.make_model(X, Y, dtype=torch.float64, device="cpu")
    g64 = _start_gradient(m64, "highest")
    m32 = tree_map(lambda t: t.float(), m64)
    rel = {}
    for prec in ("highest", "high", "default"):
        err = (_start_gradient(m32, prec) - g64).abs()
        rel[prec] = (float((err / g64.abs()).max()), float(err.max() / g64.abs().max()))
    print(f"\ngradient at the main path's start, float32 vs float64 on the CPU "
          f"(componentwise, of max |g64|): {rel}")
    assert rel["highest"][0] <= rel["high"][0] < 10 * rel["high"][0] < rel["default"][0]
