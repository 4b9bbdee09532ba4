"""The torch port's multi-device layer (``parallel/sharded.py`` and the ``mesh``
option) against the JAX package's, in float64 on the CPU: the JAX package on
its virtual 8-device CPU mesh (tests/conftest.py), the port on a mesh that
lists the CPU eight times, at the sizes of tests/test_parallel.py (N = 64).
Each sharded function equals the JAX package's sharded function and the port's
own unsharded computation to rtol 1e-9 unless a test says otherwise. The JAX
package draws fit starts and sweep candidates from its PRNG; the tests draw
them the same way and hand them to the port. The card's test of the
distributed Cholesky through the batched Cholesky kernel is in
tests/test_torch_cuda_kernels.py, which runs where JAX is not installed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.bo import objectives
from gaussian_process_optimization_tpu.bo.methods import BayesianOptimization as JBO
from gaussian_process_optimization_tpu.bo.space import bounds_to_space
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu.models.sparse import SparseGPRegression as JSparse
from gaussian_process_optimization_tpu.models.svgp import SVGP as JSVGP
from gaussian_process_optimization_tpu.parallel import sharded as js
from gaussian_process_optimization_tpu.utils import native
from gaussian_process_optimization_tpu_torch.utils import native as tnative
import gaussian_process_optimization_tpu_torch.kernels as tk
from gaussian_process_optimization_tpu_torch.bo import BayesianOptimization
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from gaussian_process_optimization_tpu_torch.models.fit import Fitter
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression as TGP
from gaussian_process_optimization_tpu_torch.models.sparse import SparseGPRegression as TSparse
from gaussian_process_optimization_tpu_torch.models.svgp import SVGP as TSVGP
from gaussian_process_optimization_tpu_torch.models.svgp import make_svgp_train_step
from gaussian_process_optimization_tpu_torch.ops import lbfgs as tlbfgs
from gaussian_process_optimization_tpu_torch.parallel import sharded as ts
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9


def _t(a):
    return torch.tensor(np.asarray(a, dtype=float))


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def meshes():
    return js.make_mesh(8, ("data",)), ts.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(64, 2))
    Y = np.sin(X[:, :1]) * np.cos(X[:, 1:]) + 0.05 * rng.standard_normal((64, 1))
    return X, Y


@pytest.fixture(scope="module")
def exact_pair(data):
    X, Y = data
    jm = JGP.create(X, Y, kernel=jk.Matern52.create(2, variance=1.3, lengthscale=0.9),
                    noise_var=0.05, max_points=64)
    tm = TGP.create(X, Y, kernel=tk.Matern52.create(2, variance=1.3, lengthscale=0.9,
                                                    device="cpu"),
                    noise_var=0.05, max_points=64, device="cpu")
    return jm, tm


# ------------------------------------------------------------------------- mesh
def test_mesh_shapes_and_refusals(meshes):
    """A 1-D mesh lists its shards; a 2-D one splits as evenly as the JAX
    package's; a mesh that is not the port's raises by name; no card, no
    default mesh."""
    jmesh, tmesh = meshes
    assert tmesh.shape == {"data": 8} == dict(jmesh.shape)
    assert tmesh.shards() == [torch.device("cpu")] * 8
    two = ts.make_mesh(8, ("data", "model"), device="cpu")
    assert two.shape == dict(js.make_mesh(8, ("data", "model")).shape) == {"data": 2, "model": 4}
    assert len(two.shards()) == 2 and len(two.shards("model")) == 4
    with pytest.raises(TypeError, match="mesh"):
        ts.check_mesh(jmesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ts.make_mesh(4)


def test_the_sharded_fit_is_a_fitter_with_a_mesh(data, meshes):
    """``make_sharded_multistart_fit`` and ``GPModel(mesh=...)`` build a
    ``Fitter`` whose restarts are a multiple of the axis size (restarts
    ceil(5 / 8) a shard: 8); a restart count that does not split raises."""
    _, tmesh = meshes
    tm = _fit_model(data)
    fitter = ts.make_sharded_multistart_fit(tm, tmesh, restarts_per_device=2)
    assert isinstance(fitter, Fitter) and fitter.num_restarts == 16
    assert fitter.mesh is tmesh
    with pytest.raises(ValueError, match="do not split"):
        Fitter(tm, num_restarts=7, mesh=tmesh)
    model = GPModel(optimize_restarts=5, max_iters=0, mesh=tmesh, device="cpu")
    X, Y = data
    model.updateModel(X, Y[:, :1])
    built = model._fitter_for(64)
    assert isinstance(built, Fitter) and built.num_restarts == 8 and built.mesh is tmesh


def test_sharded_exact_lml_matches_jax_and_unsharded(exact_pair, meshes):
    jm, tm = exact_pair
    jmesh, tmesh = meshes
    jval, (jL, jalpha, jok) = js.make_sharded_exact_lml(jmesh)(
        jm.kern, jm.X, jm.Y, jm.likelihood_variance, jm.mask)
    val, (L, alpha, ok) = ts.make_sharded_exact_lml(tmesh)(
        tm.kern, tm.X, tm.Y, tm.likelihood_variance, tm.mask)
    assert bool(ok) and bool(jok)
    np.testing.assert_allclose(float(val), float(jval), rtol=RTOL)
    np.testing.assert_allclose(_np(alpha), np.asarray(jalpha), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(_np(L), np.asarray(jL), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(float(val), float(tm.log_marginal_likelihood()), rtol=RTOL)
    with pytest.raises(ValueError, match="multiple"):
        ts.make_sharded_exact_lml(tmesh)(tm.kern, tm.X[:60], tm.Y[:60],
                                         tm.likelihood_variance, tm.mask[:60])


@pytest.mark.parametrize("nb", [16, 24], ids=["aligned", "straddling"])
def test_distributed_cholesky_matches_lapack(meshes, nb):
    """n = 256 over 8 shards: nb = 16 gives 2 panels a shard, nb = 24 panels
    that straddle two shards (32 rows a shard); the strict upper triangle is
    exactly zero and the row blocks stay on their shards."""
    _, tmesh = meshes
    rng = np.random.default_rng(1)
    Xr = rng.standard_normal((256, 256))
    A = Xr @ Xr.T + 256 * np.eye(256)
    chol = ts.make_distributed_cholesky(tmesh, nb=nb)
    L = _np(chol(_t(A)))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=RTOL, atol=1e-9)
    assert np.all(np.triu(L, 1) == 0.0)
    blocks = chol(_t(A), gather=False)
    assert [tuple(b.shape) for b in blocks] == [(32, 256)] * 8
    np.testing.assert_array_equal(np.concatenate([_np(b) for b in blocks]), L)


@pytest.mark.parametrize("n,nb", [(64, 8), (64, 3), (60, 8)],
                         ids=["aligned", "uneven_panels", "padded_rows"])
def test_distributed_exact_lml_value_and_grad(data, meshes, n, nb):
    """The distributed -LML and its gradient in the kernel's parameters and
    the noise: against the JAX package's (nb = 8 over 64 rows), and against
    the port's unsharded GP on the same rows, including 60 rows padded to 64
    and panels of 3 rows that do not divide a shard's 8."""
    X, Y = data
    jmesh, tmesh = meshes
    kern = tk.Matern52.create(2, variance=1.3, lengthscale=0.9, device="cpu")
    var = kern.variance.clone().requires_grad_(True)
    noise = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    kern = dataclasses.replace(kern, variance=var)
    val = ts.make_distributed_exact_lml(tmesh, nb=nb)(kern, _t(X[:n]), _t(Y[:n]), noise)
    g = torch.autograd.grad(val, (var, noise))
    ref = TGP.create(X[:n], Y[:n], kernel=kern, noise_var=noise, device="cpu")
    ref = dataclasses.replace(ref, likelihood_variance=noise)
    rval = ref.log_marginal_likelihood()
    rg = torch.autograd.grad(rval, (var, noise))
    np.testing.assert_allclose(float(val.detach()), float(rval.detach()), rtol=RTOL)
    np.testing.assert_allclose([float(x) for x in g], [float(x) for x in rg], rtol=1e-8)
    if n == 64 and nb == 8:
        jkern = jk.Matern52.create(2, variance=1.3, lengthscale=0.9)
        dist = js.make_distributed_exact_lml(jmesh, nb=8)

        def jval(kp, nz):
            return dist(kp, jnp.asarray(X), jnp.asarray(Y), nz)

        jv = jax.jit(jval)(jkern, 0.05)
        jg = jax.jit(jax.grad(jval, argnums=(0, 1)))(jkern, 0.05)
        np.testing.assert_allclose(float(val), float(jv), rtol=RTOL)
        np.testing.assert_allclose([float(g[0]), float(g[1])],
                                   [float(jg[0].variance), float(jg[1])], rtol=1e-8)


def test_sharded_vardtc_matches_jax_and_unsharded(data, meshes):
    X, Y = data
    jmesh, tmesh = meshes
    js_ = JSparse.create(X, Y, kernel=jk.RBF.create(2, variance=1.0, lengthscale=0.8),
                         num_inducing=12, noise_var=0.05, max_points=64)
    jval = js.make_sharded_vardtc_lml(jmesh)(js_.kern, js_.Z, js_.X, js_.Y,
                                             js_.likelihood_variance, js_.mask)
    tsp = TSparse.create(X, Y, kernel=tk.RBF.create(2, variance=1.0, lengthscale=0.8,
                                                    device="cpu"),
                         Z=np.array(js_.Z), noise_var=0.05, max_points=64, device="cpu")
    val = ts.make_sharded_vardtc_lml(tmesh)(tsp.kern, tsp.Z, tsp.X, tsp.Y,
                                            tsp.likelihood_variance, tsp.mask)
    np.testing.assert_allclose(float(val), float(jval), rtol=RTOL)
    np.testing.assert_allclose(float(val), float(tsp.log_marginal_likelihood()), rtol=1e-8)


def test_sharded_svgp_step_matches_jax_step_by_step(data, meshes):
    """Three data-parallel Adam steps: the loss of every step equals the JAX
    package's (optax adam) and the port's unsharded step's, the first the
    port's whole-batch -ELBO. The packed parameters agree to 1e-7 absolute
    (a step is 1e-2): Adam divides each gradient entry by its own magnitude
    plus 1e-8, so an entry near 1e-8, a difference of larger terms summed in
    another order, moves its step by up to ~1e-6 of the learning rate; so
    after the first step the losses agree to 1e-7."""
    X, Y = data
    jmesh, tmesh = meshes
    jm = JSVGP.create(X, Y, kernel=jk.RBF.create(2), num_inducing=8, noise_var=0.05)
    tm = TSVGP.create(X, Y, kernel=tk.RBF.create(2, device="cpu"), num_inducing=8,
                      noise_var=0.05, device="cpu")
    _, jinit, jstep = js.make_sharded_svgp_step(jm, jmesh, learning_rate=1e-2)
    _, tinit, tstep = ts.make_sharded_svgp_step(tm, tmesh, learning_rate=1e-2)
    ju, jst = jinit(jm)
    tu, opt = tinit(tm)
    np.testing.assert_allclose(_np(tu), np.asarray(ju), rtol=RTOL)
    with torch.no_grad():
        elbo = float(tm.elbo(_t(X), _t(Y)))
    _, uu, _, ustep = make_svgp_train_step(1e-2)(tm)
    for i in range(3):
        ju, jst, jv = jstep(ju, jst, jm, jnp.asarray(X), jnp.asarray(Y))
        tu, opt, tv = tstep(tu, opt, tm, _t(X), _t(Y))
        uv = ustep(_t(X), _t(Y))
        rtol = RTOL if i == 0 else 1e-7
        if i == 0:
            np.testing.assert_allclose(float(tv), -elbo, rtol=RTOL)
        np.testing.assert_allclose(float(tv), float(jv), rtol=rtol)
        np.testing.assert_allclose(float(tv), float(uv), rtol=rtol)
        np.testing.assert_allclose(_np(tu), np.asarray(ju), rtol=0, atol=1e-7)
        np.testing.assert_allclose(_np(tu), _np(uu), rtol=0, atol=1e-7)


def _neg_lcb(state, Xc):
    mdl, post = state
    mu, v = mdl.predict(Xc, posterior=post)
    return mu[..., 0] - 2.0 * (v[..., 0] ** 0.5)


def test_sharded_sweep_matches_jax(exact_pair, meshes):
    jm, tm = exact_pair
    jmesh, tmesh = meshes
    Xc = np.random.default_rng(1).uniform(-2, 2, size=(800, 2))
    jpost = jm.inference()
    jv = js.make_sharded_sweep(_neg_lcb, jmesh)((jm, jpost), jnp.asarray(Xc))
    with torch.no_grad():
        post = tm.inference()
    tv = ts.make_sharded_sweep(_neg_lcb, tmesh)((tm, post), _t(Xc))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=RTOL)
    with torch.no_grad():
        np.testing.assert_allclose(_np(tv), _np(_neg_lcb((tm, post), _t(Xc))), rtol=RTOL)


@pytest.fixture(scope="module")
def fit_pair(data, meshes):
    """The JAX package's restart-sharded fit (8 restarts x 40 steps, tol 0)
    and its starts, drawn as its ``run`` draws them."""
    X, Y = data
    jmesh, _ = meshes
    jm = JGP.create(X, Y, kernel=jk.RBF.create(2, ARD=True), noise_var=0.1, max_points=64)
    key = jax.random.PRNGKey(3)
    fitted, (us, fs) = js.make_sharded_multistart_fit(jm, jmesh, maxiter=40, tol=0.0)(jm, key)
    packer = jmake_packer(jm)
    u0 = packer.pack(jm)
    z = jax.random.normal(key, (7, u0.shape[0]), dtype=u0.dtype)
    starts = np.asarray(jnp.concatenate([u0[None], jax.vmap(packer.map_restart)(z)]))
    return fitted, np.asarray(us), np.asarray(fs), starts


def _fit_model(data):
    X, Y = data
    return TGP.create(X, Y, kernel=tk.RBF.create(2, ARD=True, device="cpu"), noise_var=0.1,
                      max_points=64, device="cpu")


def test_sharded_multistart_fit_matches_the_unsharded_fitter(data, meshes):
    """8 lanes (one a shard) from drawn starts, restart 0 the model's own
    point: each lane's value equals the unsharded ``Fitter``'s from the same
    starts; the points 1e-5 (40 steps with no tolerance walk a flat valley,
    where rounding at 1e-16 from other batch sizes leaves the value equal to
    1e-9 and moves the point ~1e-7 along it). The fitted model is the best
    lane."""
    _, tmesh = meshes
    tm = _fit_model(data)
    fitter = ts.make_sharded_multistart_fit(tm, tmesh, maxiter=40, tol=0.0)
    assert isinstance(fitter, Fitter) and fitter.num_restarts == 8
    starts = fitter.draw_starts(tm, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(_np(starts[0]), _np(fitter.packer.pack(tm)))
    fitted, sres = fitter.solve(tm, starts)
    _, res = Fitter(tm, num_restarts=8, maxiter=40, tol=0.0).solve(tm, starts)
    np.testing.assert_allclose(_np(sres.f), _np(res.f), rtol=RTOL)
    np.testing.assert_allclose(_np(sres.x), _np(res.x), rtol=1e-5, atol=1e-9)
    assert fitter.evaluations > 0
    with torch.no_grad():
        np.testing.assert_allclose(float(-fitted.log_marginal_likelihood()),
                                   float(sres.f.min()), rtol=RTOL)


@pytest.mark.slow
def test_sharded_multistart_fit_matches_jax(data, meshes, fit_pair):
    """The 8 lanes from the JAX package's starts: each lane's value equals
    the JAX package's sharded fit's, the points 1e-5 (as above). Marked slow,
    as the JAX package marks its own sharded fit test: its shard_map'd
    L-BFGS program takes ~100 s under the suite's parallel workers."""
    _, tmesh = meshes
    jfitted, jus, jfs, starts = fit_pair
    tm = _fit_model(data)
    fitted, res = ts.make_sharded_multistart_fit(tm, tmesh, maxiter=40, tol=0.0).solve(
        tm, _t(starts))
    np.testing.assert_allclose(_np(res.f), jfs, rtol=RTOL)
    np.testing.assert_allclose(_np(res.x), jus, rtol=1e-5, atol=1e-9)
    with torch.no_grad():
        np.testing.assert_allclose(float(fitted.log_marginal_likelihood()),
                                   float(jfitted.log_marginal_likelihood()), rtol=RTOL)


def test_sharded_acq_argmax_matches_jax(exact_pair, meshes):
    """The sweep of 800 (the JAX package's uniform draw) and 8 anchor lanes of
    30 box-bounded steps: the same best value and point as the JAX package's,
    and as the port's unsharded replay of both phases."""
    jm, tm = exact_pair
    jmesh, tmesh = meshes
    lo, hi = -2.0 * jnp.ones(2), 2.0 * jnp.ones(2)
    key = jax.random.PRNGKey(7)
    jx, jf = js.make_sharded_acq_argmax(_neg_lcb, jmesh, lo, hi, num_samples=800,
                                        maxiter=30)((jm, jm.inference()), key)
    cands = np.asarray(jax.random.uniform(key, (800, 2), minval=lo, maxval=hi, dtype=lo.dtype))
    with torch.no_grad():
        post = tm.inference()
    tlo, thi = _t(np.asarray(lo)), _t(np.asarray(hi))
    tx, tf = ts.make_sharded_acq_argmax(_neg_lcb, tmesh, tlo, thi, num_samples=800,
                                        maxiter=30)((tm, post), candidates=_t(cands))
    np.testing.assert_allclose(float(tf), float(jf), rtol=RTOL)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=1e-7, atol=1e-9)
    with torch.no_grad():
        scores = _neg_lcb((tm, post), _t(cands))
    anchors = _t(cands)[torch.argsort(scores)[:8]]
    res = tlbfgs.minimize(lambda A: _neg_lcb((tm, post), A), anchors, lower=tlo, upper=thi,
                          maxiter=30, carry_graph=False)
    np.testing.assert_allclose(float(tf), float(torch.min(res.f)), rtol=RTOL)
    assert float(tf) <= float(scores.min()) + 1e-10


def test_bo_suggest_on_mesh_matches_jax(meshes, monkeypatch):
    """One ``suggest_next_locations`` of EI on forrester with ``mesh=``: the
    fit's 8 restarts sharded (the JAX package's starts handed to the port),
    the sweep of 160 and the 4 anchors padded to 8 lanes. The JAX package's
    point, 1e-6 (the loop tests' tolerance)."""
    jmesh, tmesh = meshes
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    kw = dict(f=lambda x: np.asarray(objectives.forrester(x)),
              domain=bounds_to_space(objectives.forrester.bounds), acquisition_type="EI",
              initial_design_numdata=4, initial_design_type="latin", exact_feval=True,
              seed=0, anchor_points_samples=160, anchor_points_num=4, max_iters=30)
    theirs = JBO(mesh=jmesh, **kw).suggest_next_locations()
    make = ts.make_sharded_multistart_fit

    def with_jax_starts(*a, **k):
        fitter = make(*a, **k)

        def jax_starts(model, generator=None):
            u0 = fitter.packer.pack(model).detach()
            sub = jax.random.split(jax.random.PRNGKey(0))[1]
            z = np.asarray(jax.random.normal(sub, (fitter.num_restarts - 1, u0.shape[0]),
                                             dtype=jnp.float64))
            return torch.cat([u0[None], fitter.packer.map_restart(_t(z))])

        fitter.draw_starts = jax_starts
        return fitter

    monkeypatch.setattr(ts, "make_sharded_multistart_fit", with_jax_starts)
    bo = BayesianOptimization(mesh=tmesh, device="cpu", **kw)
    ours = bo.suggest_next_locations()
    lo, hi = objectives.forrester.bounds[0]
    assert ours.shape == (1, 1) and lo <= ours[0, 0] <= hi
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


def _f32(m):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32) if jnp.issubdtype(jnp.asarray(a).dtype,
                                                                 jnp.floating) else a, m)


@pytest.mark.slow
def test_jax_f32_readings_behind_phase_12_limits(meshes):
    """The JAX package's own float32 gaps on its 8-device CPU mesh at phase
    12's sizes, printed with ``-s``: the readings behind ``chip_smoke.py``'s
    ``SHARDED_JAX_F32`` (each limit is 10x its reading, floored at 1e-5).
    The exact and distributed -LML at the main data (N = 4096, ARD Matern52,
    noise 0.05), the VarDTC bound at the sparse example (N = 50 000, M = 256),
    five SVGP steps at configuration 4 (batch 2048), and the distributed
    Cholesky at N = 8192 (max |L - L64| / max |L64|). Marked slow: minutes of
    the JAX package's float32 programs on the CPU."""
    from gaussian_process_optimization_tpu_torch import workload

    jmesh, _ = meshes
    X, Y = workload.bench_data()
    m64 = JGP.create(X, Y, kernel=jk.Matern52.create(6, ARD=True), noise_var=0.05,
                     max_points=4096)
    v64 = float(m64.log_marginal_likelihood())
    with jax.enable_x64(False):
        m = _f32(m64)
        u32 = float(m.log_marginal_likelihood())
        s32, _ = js.make_sharded_exact_lml(jmesh)(m.kern, m.X, m.Y, m.likelihood_variance,
                                                  m.mask)
        d32 = js.make_distributed_exact_lml(jmesh, nb=256)(m.kern, m.X, m.Y,
                                                           m.likelihood_variance)

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    readings = {"exact_vs_unsharded": rel(s32, u32), "exact_vs_f64": rel(s32, v64),
                "distributed_vs_unsharded": rel(d32, u32), "distributed_vs_f64": rel(d32, v64)}
    Xs, Ys = workload.sparse_data()
    sp = JSparse.create(Xs, Ys, kernel=jk.RBF.create(2, variance=1.0, lengthscale=1.0),
                        num_inducing=256, noise_var=0.05, max_points=50_000)
    b64 = float(sp.log_marginal_likelihood())
    with jax.enable_x64(False):
        s = _f32(sp)
        bu32 = float(s.log_marginal_likelihood())
        bs32 = float(js.make_sharded_vardtc_lml(jmesh)(s.kern, s.Z, s.X, s.Y,
                                                        s.likelihood_variance, s.mask))
    readings.update(vardtc_vs_unsharded=rel(bs32, bu32), vardtc_vs_f64=rel(bs32, b64))
    sv64 = JSVGP.create(Xs, Ys, kernel=jk.RBF.create(2, variance=1.0, lengthscale=1.0),
                        num_inducing=256, noise_var=0.05)
    idx = np.random.default_rng(0).permutation(50_000)[:5 * 2048].reshape(5, 2048)
    losses = {}
    for dtype in (jnp.float64, jnp.float32):
        with jax.enable_x64(dtype == jnp.float64):
            mdl = sv64 if dtype == jnp.float64 else _f32(sv64)
            _, init, step = js.make_sharded_svgp_step(mdl, jmesh, learning_rate=1e-2)
            u, st = init(mdl)
            vals = []
            for i in range(5):
                Xb, Yb = jnp.asarray(Xs[idx[i]], dtype), jnp.asarray(Ys[idx[i]], dtype)
                if i == 0:
                    first_unsharded = float(-mdl.elbo(Xb, Yb))
                u, st, v = step(u, st, mdl, Xb, Yb)
                vals.append(float(v))
            losses[dtype] = (vals, first_unsharded)
    (v32, first32), (v64s, _) = losses[jnp.float32], losses[jnp.float64]
    readings.update(svgp_first_vs_unsharded=rel(v32[0], first32),
                    svgp_first_vs_f64=rel(v32[0], v64s[0]),
                    svgp_steps_vs_f64=max(rel(a, b) for a, b in zip(v32[1:], v64s[1:])))
    X8, _ = workload.bench_data(n=8192)
    A64 = np.asarray(jk.Matern52.create(6, ARD=True).K(jnp.asarray(X8))) + 0.05 * np.eye(8192)
    L64 = np.linalg.cholesky(A64)
    with jax.enable_x64(False):
        A = jnp.asarray(A64, jnp.float32)
        L = np.asarray(js.make_distributed_cholesky(jmesh, nb=256)(A), dtype=float)
        Lu = np.asarray(jnp.linalg.cholesky(A), dtype=float)
    scale = np.abs(L64).max()
    readings.update(cholesky_vs_f64=np.abs(L - L64).max() / scale,
                    cholesky_vs_unsharded=np.abs(L - Lu).max() / scale)
    for k, v in readings.items():
        print(f"the JAX package's float32 on its CPU mesh, {k}: {v:.3e}")
    assert all(np.isfinite(v) for v in readings.values())


@pytest.mark.slow
def test_jax_f32_ei_reading_at_the_cards_bo_fit():
    """The JAX package's own float32 -EI against float64 at the card's fitted
    ``BayesianOptimization(mesh=...)`` surrogate and its suggestion
    (tests/data/sharded_bo_fitted.npz, from ``chip_smoke.py`` phase 12's
    chiprun_out/sharded_bo_fitted.npz), printed with ``-s``: the reading
    behind ``SHARDED_JAX_F32["bo_ei_vs_f64"]``, beside the port's own float32
    on the CPU. Marked slow: float64 and float32 posteriors at N = 4096."""
    from pathlib import Path

    from gaussian_process_optimization_tpu.bo.acquisitions import get_quantiles
    from gaussian_process_optimization_tpu_torch import convert
    from gaussian_process_optimization_tpu_torch.bo.acquisitions import neg_ei
    from gaussian_process_optimization_tpu_torch.models.bo_models import masked_fmin

    saved = dict(np.load(Path(__file__).parent / "data" / "sharded_bo_fitted.npz"))
    x = saved.pop("x")

    def jax_neg_ei(m):
        post = m.inference()
        mu = m.predict(m.X, posterior=post)[0][:, 0]
        fmin = jnp.min(jnp.where(m.mask > 0, mu, jnp.inf))
        mx, v = m.predict(jnp.asarray(x, m.X.dtype), posterior=post)
        s = jnp.sqrt(jnp.maximum(v, 1e-10))
        phi, Phi, u = get_quantiles(0.01, fmin, mx, s)
        return -float((s * (u * Phi + phi))[0, 0])

    kern = jk.Matern52.create(6, variance=float(saved["kern.variance"]),
                              lengthscale=float(saved["kern.lengthscale"]))
    m64 = JGP.create(saved["X"].astype(float), saved["Y"].astype(float), kernel=kern,
                     noise_var=float(saved["likelihood_variance"]), max_points=4096)
    j64 = jax_neg_ei(m64)
    with jax.enable_x64(False):
        j32 = jax_neg_ei(_f32(m64))
    ours = {}
    for dtype in (torch.float64, torch.float32):
        gp = convert.gp_from_leaves(saved, dtype=dtype, device="cpu")
        with torch.no_grad():
            post = gp.inference(precompute_inverse=True)
            ours[dtype] = float(neg_ei(gp, post, masked_fmin(gp, post),
                                       torch.tensor(x, dtype=dtype))[0])
    rel = abs(j32 - j64) / abs(j64)
    print(f"the JAX package's float32 -EI at the card's BO fit: {j32:.6f} vs float64 "
          f"{j64:.6f} (rel {rel:.3e}); the port on the CPU {ours[torch.float32]:.6f} vs "
          f"{ours[torch.float64]:.6f} (rel "
          f"{abs(ours[torch.float32] - ours[torch.float64]) / abs(ours[torch.float64]):.3e})")
    np.testing.assert_allclose(ours[torch.float64], j64, rtol=1e-9)
    assert np.isfinite(j32)


SWEEP_POINTS, FIXED_ANCHORS = 1000, 8


def fixed_anchor_points(score, lo=-2.0, hi=2.0, d=6):
    """The sweep points and fixed anchors of the mesh's float32 gate
    (``chip_smoke.py`` phase 12): SWEEP_POINTS seeded uniform points in the
    box, and the FIXED_ANCHORS best of them by ``score`` (lower is better)."""
    sweep = np.random.default_rng(0).uniform(lo, hi, size=(SWEEP_POINTS, d))
    return sweep, sweep[np.argsort(np.asarray(score(sweep)))[:FIXED_ANCHORS]]


@pytest.mark.slow
def test_jax_f32_ei_mesh_vs_no_mesh_at_the_cards_bo_fit():
    """The JAX package's own float32 at the card's fitted
    ``BayesianOptimization(mesh=...)`` surrogate
    (tests/data/sharded_bo_fitted_unbiased_k.npz, the fit with the unbiased
    exponential in the K kernel),
    on a 4-device mesh against no mesh, printed with ``-s``: (1) the -EI of
    the acquisition argmax over five sweep seeds, how far float32 alone moves
    the suggestion when the anchors' L-BFGS lanes are batched otherwise (EI,
    1000 sweep points, 5 anchors padded to 8 lanes on the mesh, 200 steps: the
    port's defaults and ``chip_smoke.py`` phase 12's), with float64's beside
    it; (2) what the mesh itself computes: the sweep's -EI at 1000 points and
    -EI with its gradient at 8 fixed anchors, sharded against unsharded, with
    the port's own on a 4-shard CPU mesh beside them, and the same in float64;
    (3) the float32 sweep's -EI, the anchors' -EI and its gradient against
    float64 at the same points (``["acq_sweep_vs_f64"]``,
    ``["acq_anchor_vs_f64"]``, ``["acq_grad_vs_f64"]``: the readings behind
    the float32 limits). How far two float32 programs drift apart moves with
    the CPU's thread count; pin the test to one core (``taskset -c 0``) to
    reproduce the stored readings. Marked slow: ten float32 and ten float64
    argmaxes at N = 4096."""
    from pathlib import Path

    from jax.sharding import PartitionSpec as P

    from gaussian_process_optimization_tpu.bo.acquisitions import AcquisitionEI
    from gaussian_process_optimization_tpu.bo.optimizer import AcquisitionOptimizer
    from gaussian_process_optimization_tpu.bo.space import DesignSpace
    from gaussian_process_optimization_tpu.models.bo_models import _fmin_device

    saved = dict(np.load(Path(__file__).parent / "data" / "sharded_bo_fitted_unbiased_k.npz"))
    kern = jk.Matern52.create(6, variance=float(saved["kern.variance"]),
                              lengthscale=float(saved["kern.lengthscale"]))
    m64 = JGP.create(saved["X"].astype(float), saved["Y"].astype(float), kernel=kern,
                     noise_var=float(saved["likelihood_variance"]), max_points=4096)
    space = DesignSpace(bounds_to_space([(-2.0, 2.0)] * 6))
    mesh = js.make_mesh(4, ("data",))

    class _Fitted:
        def __init__(self, gp):
            self.gp, self.post = gp, gp.inference()

        def device_state(self):
            return self.gp, self.post, _fmin_device(self.gp, self.post)

    def argmax_gaps(m):
        acq = AcquisitionEI(_Fitted(m), space)
        gaps = []
        for seed in range(5):
            fx = [float(AcquisitionOptimizer(space, seed=seed, mesh=mm).optimize(
                acquisition=acq)[1][0, 0]) for mm in (mesh, None)]
            gaps.append(abs(fx[0] - fx[1]) / abs(fx[1]))
        return gaps

    def rel(a, b):
        a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
        return float(np.abs(a - b).max() / np.abs(b).max())

    def mesh_readings(m, anchors=None):
        """Sharded vs unsharded at the sweep and at the anchors (the best of
        the sweep by m's own -EI unless given), and the unsharded values."""
        acq = AcquisitionEI(_Fitted(m), space)
        args = acq.device_args()

        def neg(*a):
            return acq.pure_neg_acq(*a[:4], a[4])

        def value_and_grad(*a):
            return jax.vmap(jax.value_and_grad(lambda x: neg(*a[:4], x[None, :])[0]))(a[4])

        rep = (P(),) * 4
        sweep_s = jax.jit(js.shard_map(neg, mesh=mesh, in_specs=rep + (P("data", None),),
                                       out_specs=P("data"), check_vma=False))
        vg_s = jax.jit(js.shard_map(value_and_grad, mesh=mesh,
                                    in_specs=rep + (P("data", None),),
                                    out_specs=(P("data"), P("data", None)), check_vma=False))
        dtype = m.X.dtype
        sweep, best = fixed_anchor_points(lambda A: jax.jit(neg)(*args, jnp.asarray(A, dtype)))
        anchors = best if anchors is None else anchors
        sweep, at = jnp.asarray(sweep, dtype), jnp.asarray(anchors, dtype)
        (v, g), (vu, gu) = vg_s(*args, at), jax.jit(value_and_grad)(*args, at)
        su = jax.jit(neg)(*args, sweep)
        return ((rel(sweep_s(*args, sweep), su), rel(v, vu), rel(g, gu)),
                tuple(np.asarray(a, dtype=float) for a in (su, vu, gu)), np.asarray(anchors))

    def port_mesh_readings():
        """The port's own float32 on a 4-shard CPU mesh, the same readings."""
        from gaussian_process_optimization_tpu_torch import convert
        from gaussian_process_optimization_tpu_torch.bo.acquisitions import neg_ei
        from gaussian_process_optimization_tpu_torch.models.bo_models import masked_fmin

        tmesh = ts.make_mesh(4, device="cpu")
        gp = convert.gp_from_leaves(saved, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            post = gp.inference(precompute_inverse=True)
        args = (gp, post, masked_fmin(gp, post))

        def neg(A, a):
            return neg_ei(*a, A)

        def f32(A):
            return torch.as_tensor(np.asarray(A), dtype=torch.float32)

        with torch.no_grad():
            sweep, anchors = fixed_anchor_points(lambda A: neg(f32(A), args).numpy())
            su = neg(f32(sweep), args)
            ss = ts.make_sharded_sweep(lambda a, A: neg(A, a), tmesh)(args, f32(sweep))

        def value_and_grad(fun):
            U = f32(anchors).requires_grad_(True)
            v = fun(U)
            return v.detach().numpy(), torch.autograd.grad(v.sum(), U)[0].numpy()

        vs, gs = value_and_grad(ts.sharded_lanes(tmesh, neg, [args] * 4))
        vu, gu = value_and_grad(lambda U: neg(U, args))
        return rel(ss.numpy(), su.numpy()), rel(vs, vu), rel(gs, gu)

    gaps64 = argmax_gaps(m64)
    with jax.enable_x64(False):
        m32 = _f32(m64)
        gaps32 = argmax_gaps(m32)
        readings, values32, anchors = mesh_readings(m32)
    readings64, values64, _ = mesh_readings(m64, anchors)
    vs_f64 = tuple(rel(a, b) for a, b in zip(values32, values64))
    port = port_mesh_readings()
    print(f"the JAX package's -EI at its argmax, mesh vs no mesh at the card's BO fit, rel "
          f"per sweep seed 0-4: float32 {[f'{g:.3e}' for g in gaps32]} (max "
          f"{max(gaps32):.3e}); float64 {[f'{g:.3e}' for g in gaps64]} (max "
          f"{max(gaps64):.3e}); float32 sharded vs unsharded at the same points, the sweep's "
          f"-EI / the fixed anchors' -EI / its gradient there: the JAX package "
          f"{' / '.join(f'{r:.3e}' for r in readings)}, the port on the CPU "
          f"{' / '.join(f'{r:.3e}' for r in port)}; the JAX package's float64 sharded vs "
          f"unsharded {' / '.join(f'{r:.3e}' for r in readings64)}; the JAX package's float32 "
          f"against its float64, unsharded {' / '.join(f'{r:.3e}' for r in vs_f64)}")
    assert np.isfinite(readings + port + readings64 + vs_f64).all()
