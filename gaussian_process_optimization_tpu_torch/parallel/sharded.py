"""Multi-device scale-out over a device mesh (twin of
``gaussian_process_optimization_tpu/parallel/sharded.py``).

The reference's distributed layer is GPy's optional MPI (``sparse_gp_mpi.py``:
scatter the data, allreduce the gradients; ``var_dtc_parallel.py``: partial
sums of the sufficient statistics across ranks). The JAX package writes it as
one SPMD program over a ``jax.sharding.Mesh``; this port keeps that package's
single-controller semantics: one process holds one :class:`Mesh`, a tuple of
``torch.device`` along a ``'data'`` axis, and each function below runs one
shard's body per device on that device's slice of the data. The collectives
are explicit: a psum is the sum of the shards' tensors and an all_gather their
concatenation, each moved with ``.to(device)``. The shards run one after
another from this one thread, on one card or on several: a shard body's host
reads (the jitter ladder's verdict) wait for its card before the next shard is
issued, and the bodies are bound by the host's dispatch of their small ops.

A mesh may list one device more than once: the CPU tests run eight shards on
the CPU (the JAX tests' virtual 8-device mesh), and one card can run four.
``torch.distributed`` process groups are not used: the API hands one mesh
object into one program (``BayesianOptimization(mesh=...)``), and NCCL cannot
put two ranks on one card.

- the ``'data'`` axis shards training rows, candidate points, restart lanes
  and anchor lanes;
- :func:`make_sharded_exact_lml`: each shard builds its K row block against
  the full X, the Cholesky consumes the gathered Gram;
- :func:`make_distributed_cholesky` / :func:`make_distributed_exact_lml`: the
  factorization itself row-sharded, the full factor never on one shard;
- :func:`make_sharded_vardtc_lml`: the Titsias bound with its sufficient
  statistics psum-reduced (``var_dtc_parallel``'s allreduce);
- :func:`make_sharded_svgp_step`: data-parallel SVGP Adam steps;
- :func:`make_sharded_sweep`, :func:`make_sharded_multistart_fit`,
  :func:`make_sharded_acq_argmax`: candidate rows, restart lanes and anchor
  lanes split across the shards; L-BFGS runs all lanes of all shards in
  lockstep, and reads its flags once every shard's evaluation has returned.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..config import config, resolve_device
from ..models.gp import LOG_2_PI
from ..utils.tree import tree_map


class Mesh:
    """A device mesh: ``devices`` (a sequence, or a nested one for more axes)
    along ``axis_names``; ``shape[name]`` is the axis's size, as in JAX. With
    no ``devices``, every card (raises where there is none)."""

    def __init__(self, devices=None, axis_names=("data",)):
        if devices is None:
            resolve_device(None)
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        grid = np.asarray(devices, dtype=object)
        if len(axis_names) == 1:
            grid = grid.reshape(-1)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f"a mesh of {grid.shape} devices cannot have axes {axis_names}")
        flat = [torch.device(d) for d in grid.reshape(-1)]
        self.devices = np.empty(grid.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    def shards(self, axis: str = "data") -> list[torch.device]:
        """The devices along ``axis`` (the first of every other axis): one per
        shard of that axis."""
        i = self.axis_names.index(axis)
        index = [0] * len(self.axis_names)
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(n_devices=None, axis_names=("data",), device=None) -> Mesh:
    """A mesh over the first ``n_devices`` cards (all of them by default),
    ``('data',)`` by default; ``('data', 'model')`` splits them as evenly as
    possible. ``device`` lists that one device ``n_devices`` times instead
    (``device="cpu"`` for the CPU, ``"cuda:0"`` for shards sharing a card)."""
    if device is not None:
        devices = [resolve_device(device)] * int(n_devices or 1)
    else:
        resolve_device(None)
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if n > count:
            raise ValueError(f"{n} devices asked for, {count} present; pass device='cuda:0' "
                             "to run several shards on one card")
        devices = [torch.device(f"cuda:{i}") for i in range(n)]
    n = len(devices)
    if len(axis_names) == 1:
        shape = (n,)
    else:
        d = int(np.floor(np.sqrt(n)))
        while n % d:
            d -= 1
        shape = (d, n // d)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axis_names)


def check_mesh(mesh):
    """``mesh`` itself when it is None or a :class:`Mesh`; anything else
    (the JAX package's ``jax.sharding.Mesh``, say) raises by name."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.sharded.Mesh (make_mesh), not "
                        f"{type(mesh).__name__}")
    return mesh


# ---------------------------------------------------------------- collectives
def on(device):
    """The context a shard's body runs in: its card current, so the kernels
    it launches go to that card's stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def place(obj, device):
    """``obj`` with every tensor on ``device``: a tensor, a dataclass model
    (its leaves), or a tuple or list of them; anything else as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return tree_map(lambda t: t.to(device), obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(place(o, device) for o in obj)
    return obj


def psum(parts, device):
    """The sum of the shards' tensors, on ``device``."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def all_gather(parts, device, dim: int = 0):
    """The shards' tensors concatenated along ``dim``, on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def split_rows(X, n_shards: int):
    """``X``'s rows in ``n_shards`` equal blocks (views)."""
    if X.shape[0] % n_shards:
        raise ValueError(f"{X.shape[0]} rows do not split over {n_shards} shards: pad them "
                         "to a multiple of the 'data' axis size")
    return torch.split(X, X.shape[0] // n_shards)


def map_shards(mesh, body, *sharded, replicated=()):
    """``[body(*replicated_s, *rows_s) for each shard s]``: ``sharded`` tensors
    are split by rows, ``replicated`` objects placed whole, both on the
    shard's device, where the body runs."""
    devs = mesh.shards()
    pieces = [split_rows(x, len(devs)) for x in sharded]
    out = []
    for s, dev in enumerate(devs):
        with on(dev):
            args = [place(r, dev) for r in replicated] + [p[s].to(dev) for p in pieces]
            out.append(body(*args))
    return out


def sharded_lanes(mesh, fun, per_shard):
    """``F(U)`` for L-BFGS over lanes split across the shards: lane block s of
    ``U (B, n)`` goes to shard s, where ``fun(U_s, per_shard[s])`` gives its
    ``(B_s,)`` values; they are gathered on U's device. Differentiable: the
    backward returns each shard's gradient through the same moves. With the
    L-BFGS aux channel, ``F(U, aux)``: the aux's rows split with the lanes,
    ``fun(U_s, per_shard[s], aux_s)`` gives ``(values, aux_out)``, and both
    are gathered."""
    devs = mesh.shards()

    def F(U, *aux):
        blocks = [split_rows(a, len(devs)) for a in aux]
        parts = []
        for s, (dev, blk, ctx) in enumerate(zip(devs, split_rows(U, len(devs)), per_shard)):
            with on(dev):
                parts.append(fun(blk.to(dev), ctx, *(b[s].to(dev) for b in blocks)))
        if not aux:
            return all_gather(parts, U.device)
        return (all_gather([f for f, _ in parts], U.device),
                all_gather([a for _, a in parts], U.device))

    return F


# ---------------------------------------------------------------------- exact GP
def make_sharded_exact_lml(mesh):
    """``lml(kern, X, Y, noise, mask) -> (value, (L, alpha, ok))`` with the K
    row-block build sharded over ``'data'``: each shard builds its rows against
    the full X (the K kernel on a card), the gathered Gram is factored by the
    jitter ladder on X's device. X must be padded to a multiple of the axis
    size."""
    from ..ops import linalg

    def lml(kern, X, Y, noise, mask):
        n = X.shape[0]
        blocks = map_shards(mesh, lambda k, Xf, Xr: k.K(Xr, Xf), X, replicated=(kern, X))
        with on(X.device):
            K = all_gather(blocks, X.device)
            Ky = K + (noise + config.noise_jitter) * torch.eye(n, dtype=K.dtype,
                                                               device=K.device)
            L, _, ok = linalg.jitchol(linalg.masked_gram(Ky, mask))
            Yc = Y * mask[:, None]
            alpha = linalg.cho_solve(L, Yc)
            p = Y.shape[1]
            val = 0.5 * (-torch.sum(mask) * p * LOG_2_PI - p * linalg.logdet_from_chol(L)
                         - torch.sum(alpha * Yc))
        return val, (L, alpha, ok)

    return lml


# --------------------------------------------------- distributed factorization
class _CholBlocks(torch.autograd.Function):
    """The batched Cholesky kernel's factor with the Cholesky pullback, so the
    distributed -LML stays differentiable with ``cuda_chol_blocks`` on."""

    @staticmethod
    def forward(ctx, A):
        from ..ops import cuda_linalg

        L = cuda_linalg.cholesky_blocks(A)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, L_bar):
        from ..ops import linalg

        (L,) = ctx.saved_tensors
        return linalg.cholesky_pullback(L, L_bar)


def _diag_chol(blk):
    """A panel's diagonal block factor, routed as ``ops/linalg.blocked_cholesky``
    routes its diagonal blocks: the batched Cholesky kernel (B4) when
    ``config.cuda_chol_blocks`` is on, else ``cholesky_ex``; a failed block is
    NaN either way."""
    if config.cuda_chol_blocks:
        return _CholBlocks.apply(blk[None])[0]
    L, info = torch.linalg.cholesky_ex(blk)
    return torch.where(info != 0, float("nan"), L)


def _dist_chol(blocks, devs, nb, home):
    """Shard-local blocked right-looking Cholesky (the reference's
    ``_dist_chol_body``). ``blocks[s]``, on ``devs[s]``, holds rows
    [s r, (s + 1) r) of an (n, n) SPD matrix. Per panel [k0, k1): gather the
    (n, nb) block column on ``home``, factor its diagonal block and solve the
    panel below it there, hand each shard its rows of the factored column, and
    let each shard apply its trailing update masked to global rows >= k1.
    Returns the factor's row blocks, on their shards, strictly-upper zero. A
    panel may straddle two shards: rows per shard need not be a multiple of nb."""
    rows, n = blocks[0].shape
    trail = list(blocks)           # shard s: its columns from k0 on
    done = [[] for _ in devs]      # shard s: its factored column panels
    grow = [s * rows + torch.arange(rows, device=d) for s, d in enumerate(devs)]
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        w = k1 - k0
        with on(home):
            col = all_gather([t[:, :w] for t in trail], home)
            Lkk = _diag_chol(col[k0:k1])
            parts = [col.new_zeros(k0, w), Lkk]
            if k1 < n:
                parts.append(torch.linalg.solve_triangular(Lkk.transpose(-1, -2), col[k1:],
                                                           upper=True, left=False))
            L_col = torch.cat(parts)
        for s, dev in enumerate(devs):
            with on(dev):
                Lc = L_col.to(dev)
                mine = Lc[s * rows:(s + 1) * rows]
                done[s].append(mine)
                if k1 < n:
                    panel = torch.where((grow[s] >= k1)[:, None], mine, 0.0)
                    trail[s] = trail[s][:, w:] - panel @ Lc[k1:].transpose(-1, -2)
    out = []
    for s, dev in enumerate(devs):
        with on(dev):
            L_s = torch.cat(done[s], dim=1)
            keep = torch.arange(n, device=dev)[None, :] <= grow[s][:, None]
            out.append(torch.where(keep, L_s, 0.0))
    return out


def _dist_solve_lower(L_blocks, devs, B, nb, home):
    """Forward substitution L x = B with L row-sharded and B (n, p) on
    ``home`` (the reference's ``_dist_solve_lower_body``): sequential over
    segments that lie in one panel and one shard; the owner of a segment
    solves it against the x found so far and hands it back. Returns x on
    ``home``."""
    rows, n = L_blocks[0].shape
    cuts = sorted(set(range(0, n, nb)) | set(range(0, n, rows)) | {n})
    xs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        s = a // rows
        dev = devs[s]
        with on(dev):
            blk = L_blocks[s][a - s * rows:b - s * rows]
            rhs = B[a:b].to(dev)
            if a > 0:
                rhs = rhs - blk[:, :a] @ torch.cat(xs).to(dev)
            z = torch.linalg.solve_triangular(blk[:, a:b], rhs, upper=False)
        xs.append(z.to(home))
    return torch.cat(xs)


def make_distributed_cholesky(mesh, nb: int = 256):
    """chol(A) with A and L row-block-sharded over ``'data'``: the factorization
    itself distributed, unlike :func:`make_sharded_exact_lml`, which factors
    the gathered Gram on one device. Per-shard memory is (n / P) n plus two
    (n, nb) panels; per panel, one (n, nb) gather and one broadcast.

    Returns ``chol(A, gather=True)``: ``A (n, n)`` on one device, its rows
    scattered to the shards (n must be a multiple of the axis size; nb need
    not divide n / P), and the factor gathered on A's device, or with
    ``gather=False`` its row blocks on their shards. Differentiable. The
    diagonal blocks go through the batched Cholesky kernel when
    ``config.cuda_chol_blocks`` is on."""
    devs = mesh.shards()

    def chol(A, gather: bool = True):
        blocks = [r.to(d) for r, d in zip(split_rows(A, len(devs)), devs)]
        L_blocks = _dist_chol(blocks, devs, nb, A.device)
        return all_gather(L_blocks, A.device) if gather else L_blocks

    return chol


def make_distributed_exact_lml(mesh, nb: int = 256):
    """Exact-GP log marginal likelihood with the Gram build, the Cholesky and
    the log determinant all row-sharded: per-shard memory ~ N^2 / P + 2 N nb.

    Returns ``lml(kern, X, Y, noise)`` (a scalar on X's device). X (n, d) and
    Y (n, p) are whole. Rows are padded up to a multiple of the axis size with
    identity rows of the Gram and zero targets, which add nothing to the
    value. No jitter ladder, as in the reference: the distributed path targets
    large-N fits where the noise dominates float32 round-off. Differentiable
    with respect to the kernel's parameters and the noise."""
    devs = mesh.shards()
    P = len(devs)

    def lml(kern, X, Y, noise):
        n, p = X.shape[0], Y.shape[1]
        n_pad = -(-n // P) * P
        home = X.device
        Xp = torch.cat([X, X.new_zeros(n_pad - n, X.shape[1])])
        Yp = torch.cat([Y, Y.new_zeros(n_pad - n, p)])
        rows = n_pad // P

        def body(k, Xf, nz, Xr, grow):
            cols = torch.arange(n_pad, device=Xr.device)
            real = grow < n
            keep = (real[:, None] & (cols < n)[None, :]).to(Xr.dtype)
            diag = torch.where(real, nz + config.noise_jitter, torch.ones_like(nz))
            eye = (cols[None, :] == grow[:, None]).to(Xr.dtype)
            return k.K(Xr, Xf) * keep + diag[:, None] * eye

        blocks = map_shards(mesh, body, Xp, torch.arange(n_pad, device=home),
                            replicated=(kern, Xp, noise))
        L_blocks = _dist_chol(blocks, devs, nb, home)
        c = _dist_solve_lower(L_blocks, devs, Yp, nb, home)
        logdet = 2.0 * psum([torch.sum(torch.log(torch.diagonal(L, offset=s * rows)))
                             for s, L in enumerate(L_blocks)], home)
        return 0.5 * (-n * p * LOG_2_PI - p * logdet - torch.sum(torch.square(c)))

    return lml


# ---------------------------------------------------------------------- sparse GP
def make_sharded_vardtc_lml(mesh):
    """``bound(kern, Z, X, Y, noise, mask)``: the Titsias collapsed bound with
    data-parallel sufficient statistics (A A^T, A y, |y|^2, the traces and the
    row counts) psum-reduced over ``'data'``: ``var_dtc_parallel``'s
    allreduce. Every shard factors Kmm itself, as the reference's replicated
    program does."""
    from ..ops import linalg

    def stats(kern, Z, X_s, Y_s, mask_s):
        m = Z.shape[0]
        Kmm = kern.K(Z)
        Kmm = Kmm + 1e-6 * torch.mean(torch.diagonal(Kmm)) * torch.eye(
            m, dtype=X_s.dtype, device=X_s.device)
        Lm, _, _ = linalg.jitchol(Kmm)
        A = linalg.solve_lower(Lm, kern.K(Z, X_s) * mask_s[None, :])
        Yc = Y_s * mask_s[:, None]
        return (A @ A.transpose(-1, -2), A @ Yc, torch.sum(torch.square(Yc)),
                torch.sum(kern.Kdiag(X_s) * mask_s) - torch.sum(torch.square(A)),
                torch.sum(mask_s))

    def bound(kern, Z, X, Y, noise, mask):
        home = X.device
        sigma2 = noise + config.noise_jitter
        m, p = Z.shape[0], Y.shape[1]
        per = map_shards(mesh, stats, X, Y, mask, replicated=(kern, Z))
        with on(home):
            AAT, Ay, yy, tr, n_real = (psum(list(t), home) for t in zip(*per))
            LB, _, _ = linalg.jitchol(torch.eye(m, dtype=AAT.dtype, device=home) + AAT / sigma2)
            c = linalg.solve_lower(LB, Ay) / sigma2
            return (-0.5 * n_real * p * (LOG_2_PI + torch.log(sigma2))
                    - 0.5 * p * linalg.logdet_from_chol(LB)
                    - 0.5 * yy / sigma2
                    + 0.5 * torch.sum(torch.square(c))
                    - 0.5 * p * tr / sigma2)

    return bound


# ---------------------------------------------------------------------- SVGP step
def make_sharded_svgp_step(model_template, mesh, learning_rate=1e-2):
    """Data-parallel SVGP training step: batch rows sharded on ``'data'``,
    parameters whole on every shard; the shards' gradients are psum-ed and
    one Adam update (``torch.optim.Adam`` with optax's ``adam`` settings, as
    ``models/svgp.py`` trains) applies them: the SVI counterpart of
    ``sparse_gp_mpi``'s gradient allreduce.

    Returns ``(packer, init(model) -> (u, opt), step(u, opt, model, X, Y) ->
    (u, opt, -ELBO))``; ``step`` updates ``u`` in place. The global batch must
    be a multiple of the axis size."""
    from ..models.parameters import make_packer

    packer = make_packer(model_template, fix=("num_data",))
    p_data = mesh.shape["data"]

    def local_loss(u, model_ref, X_s, Y_s):
        # the shards' losses sum to the global one:
        # -(scale sum_i ell_i - KL) == sum_shards -(scale ell_shard - KL / p)
        mdl = packer.unpack(u, reference=model_ref)
        mu, var = mdl._predict_f(X_s)
        ell = mdl._expected_log_lik(Y_s, mu, var)
        scale = mdl.num_data / (X_s.shape[0] * p_data)
        return -(scale * torch.sum(ell) - mdl.kl() / p_data)

    def init(model):
        u = packer.pack(model).detach().clone().requires_grad_(True)
        return u, torch.optim.Adam([u], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def step(u, opt, model, X, Y):
        def body(uu, mdl, X_s, Y_s):
            uu = uu.detach().requires_grad_(True)
            with torch.enable_grad():
                val = local_loss(uu, mdl, X_s, Y_s)
                (g,) = torch.autograd.grad(val, uu)
            return val.detach(), g

        vals, grads = zip(*map_shards(mesh, body, X, Y, replicated=(u, model)))
        u.grad = psum(list(grads), u.device)
        opt.step()
        u.grad = None
        return u, opt, psum(list(vals), u.device)

    return packer, init, step


# ---------------------------------------------------------------------- sweeps
def make_sharded_sweep(score_fn, mesh):
    """Candidate-scoring sweep sharded over ``'data'`` (the acquisition's
    1000-25000-point sweep at multi-device scale). ``score_fn(state, X_shard)
    -> (n_shard,)`` must be shard-local (pure prediction); ``state`` (a
    tensor, a model, or a tuple of them) is placed whole on every shard."""

    def sweep(state, X):
        with torch.no_grad():
            return all_gather(map_shards(mesh, score_fn, X, replicated=(state,)), X.device)

    return sweep


# ------------------------------------------------------------- multi-start fit
def make_sharded_multistart_fit(template_model, mesh, restarts_per_device=1, maxiter=1000,
                                tol=1e-5, max_ls=8, fix=(), transform_overrides=None,
                                priors=None, **kw):
    """Multi-restart hyperparameter fit with the restart axis sharded over the
    mesh: a ``models/fit.Fitter`` of axis size x ``restarts_per_device``
    restarts whose lane blocks each run on their shard's device, every lane of
    every shard stepped in lockstep by one ``ops/lbfgs.minimize``; the best
    finite lane is taken. Restart 0 starts from the model's own parameters,
    the others from N(0, 1) draws through each transform's ``random_restart``.
    ``fitter(model, generator)`` draws and runs; ``fitter.solve(model,
    starts)`` takes given starts."""
    from ..models.fit import Fitter

    total = mesh.shape["data"] * max(1, int(restarts_per_device))
    return Fitter(template_model, num_restarts=total, maxiter=maxiter, tol=tol, max_ls=max_ls,
                  fix=fix, transform_overrides=transform_overrides, priors=priors, mesh=mesh,
                  **kw)


# -------------------------------------------------- multi-start acq argmax
def make_sharded_acq_argmax(neg_acq, mesh, lower, upper, num_samples=1000,
                            anchors_per_device=1, maxiter=200):
    """Acquisition argmax with both phases sharded over the mesh: the random
    candidate sweep splits its rows across the shards, and the anchor L-BFGS
    lanes (one block per shard) run in lockstep. ``neg_acq(state, X) -> (n,)``
    must be pointwise and shard-local.

    Returns ``argmax(state, generator=None, candidates=None) -> (x_best,
    f_best)``; ``candidates`` (the sweep rounded up to a multiple of the axis
    size) replaces the uniform draw. This is the library variant over a plain
    box; ``bo/optimizer.AcquisitionOptimizer`` has its own mesh path with the
    design space's rounding, context, constraints and de-duplication."""
    from ..ops import lbfgs

    devs = mesh.shards()
    n_anchor = len(devs) * anchors_per_device
    n_sweep = -(-num_samples // len(devs)) * len(devs)
    sweep = make_sharded_sweep(neg_acq, mesh)

    def argmax(state, generator=None, candidates=None):
        lo = torch.as_tensor(lower)
        hi = torch.as_tensor(upper, dtype=lo.dtype, device=lo.device)
        if candidates is None:
            u = torch.rand((n_sweep, lo.shape[0]), generator=generator, dtype=lo.dtype,
                           device=lo.device)
            candidates = lo + (hi - lo) * u
        scores = sweep(state, candidates)
        anchors = candidates[torch.argsort(scores)[:n_anchor]]
        fun = sharded_lanes(mesh, lambda X, st: neg_acq(st, X), [place(state, d) for d in devs])
        res = lbfgs.minimize(fun, anchors, lower=lo, upper=hi, maxiter=maxiter,
                             carry_graph=False)
        fs = torch.where(torch.isfinite(res.f), res.f, torch.full_like(res.f, float("inf")))
        best = int(torch.argmin(fs))
        return res.x[best], fs[best]

    return argmax
