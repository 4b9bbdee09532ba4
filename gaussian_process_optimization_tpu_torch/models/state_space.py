"""State-space (Kalman) form of 1-D GPs: linear-time exact inference (twin of
``gaussian_process_optimization_tpu/models/state_space.py``; GPy
models/state_space_main.py, state_space_cython.pyx, kern/src/sde_*.py).

Many 1-D kernels are exactly (or to spectral order) Markovian SDEs, so the LML
and the prediction are a Kalman filter and an RTS smoother, O(N) instead of
O(N^3). Forms: Matern-1/2, 3/2, 5/2 (exact); 'periodic', the standard periodic
kernel as a truncated harmonic expansion (Solin & Sarkka 2014); the
quasi-periodic products of it with Matern-1/2 or 3/2 (Kronecker sum of the
drifts); 'white', 'bias', 'brownian', 'linear'; 'rbf' to spectral order; and
sums of these (block-diagonal stacking).

Discretization: stationary forms use A = expm(F dt), Q = P_inf - A P_inf A^T;
Brownian and linear ones Van Loan's block matrix exponential, with the
filter's clock started at t = 0.

The reference runs the filter and the smoother as ``lax.scan``s; here they are
Python loops of small tensor operations per time step (which rows observe is
known on the host, so a step either updates or predicts). Lanes: the
hyperparameters may carry a leading lane axis (the fitter's restarts); the
-LML then runs one filter per lane. ``predict`` takes one set. As in the
reference, ``lengthscale_damp`` is an unconstrained leaf (not a positive
name).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..kernels.base import placement

LOG_2_PI = math.log(2 * math.pi)


def _bessel_iv_series(orders, z, terms=40):
    """Modified Bessel I_j(z), j = 0..orders-1, by its ascending series (the
    moderate z = 1/lengthscale^2 where the periodic SDE is valid)."""
    j = torch.arange(orders, dtype=z.dtype, device=z.device)[:, None]
    m = torch.arange(terms, dtype=z.dtype, device=z.device)[None, :]
    log_t = ((2 * m + j) * torch.log(z / 2.0) - torch.lgamma(m + 1.0)
             - torch.lgamma(m + j + 1.0))
    return torch.sum(torch.exp(log_t), dim=1)


def _zeros(d, like):
    return torch.zeros(d, d, dtype=like.dtype, device=like.device)


def _h(*row, like):
    return torch.tensor([list(row)], dtype=like.dtype, device=like.device)


def _matern_blocks(family, variance, lengthscale, like):
    """Exact SDE (F, P_inf, H) of the Matern family (sde_matern.py)."""
    if family == "matern12":
        lam = 1.0 / lengthscale
        return (-lam).reshape(1, 1), variance.reshape(1, 1), _h(1.0, like=like)
    if family == "matern32":
        lam = math.sqrt(3.0) / lengthscale
        one, zero = torch.ones_like(lam), torch.zeros_like(lam)
        F = torch.stack([torch.stack([zero, one]), torch.stack([-lam ** 2, -2 * lam])])
        P = torch.stack([torch.stack([variance, zero]),
                         torch.stack([zero, variance * lam ** 2])])
        return F, P, _h(1.0, 0.0, like=like)
    if family == "matern52":
        lam = math.sqrt(5.0) / lengthscale
        one, zero = torch.ones_like(lam), torch.zeros_like(lam)
        F = torch.stack([torch.stack([zero, one, zero]), torch.stack([zero, zero, one]),
                         torch.stack([-lam ** 3, -3 * lam ** 2, -3 * lam])])
        kappa = variance * lam ** 2 / 3.0
        P = torch.stack([torch.stack([variance, zero, -kappa]),
                         torch.stack([zero, kappa, zero]),
                         torch.stack([-kappa, zero, variance * lam ** 4])])
        return F, P, _h(1.0, 0.0, 0.0, like=like)
    raise ValueError(f"unsupported Matern state-space family {family!r}")


def _periodic_blocks(variance, lengthscale, period, order, like):
    """Harmonic expansion of the standard periodic kernel
    (sde_standard_periodic.py:72-120); this package's StandardPeriodic is
    Solin-Sarkka's with l_ss = 2 l."""
    z = 1.0 / torch.square(2.0 * lengthscale)
    w0 = 2.0 * math.pi / period
    q2 = 2.0 * variance * torch.exp(-z) * _bessel_iv_series(order + 1, z)
    q2 = torch.cat([0.5 * q2[:1], q2[1:]])
    js = torch.arange(order + 1, dtype=like.dtype, device=like.device)
    d = 2 * (order + 1)
    F = _zeros(d, like)
    F[0::2, 1::2] = torch.diag(-js * w0)
    F[1::2, 0::2] = torch.diag(js * w0)
    P_inf = torch.diag(torch.repeat_interleave(q2, 2))
    H = _h(1.0, 0.0, like=like).repeat(1, order + 1)
    return F, P_inf, H


@functools.lru_cache(maxsize=None)
def _rbf_companion_constants(order):
    """Unit-lengthscale monic coefficients of the stable spectral factor of
    the RBF's Taylor-expanded spectral density (sde_stationary.py:93-120): the
    roots scale as 1/l, so a_j scales as l^-j."""
    N = int(order)
    fn = math.factorial(N)
    pp = np.zeros(2 * N + 1)
    for n in range(N + 1):
        pp[2 * (N - n)] = fn * (2.0 ** (N - n)) / math.factorial(n) * (-1.0) ** n
    roots = np.roots(pp)
    neg = roots[np.round(roots.real, 6) < 0]
    if len(neg) != N:
        raise ValueError(f"rbf SDE order {N}: expected {N} stable roots, got {len(neg)}")
    aa = np.poly(neg)
    if not np.allclose(aa.imag, 0.0, atol=1e-8):
        raise ValueError("rbf SDE companion coefficients not real")
    return aa.real


def _rbf_blocks(variance, lengthscale, order, like):
    """The RBF to spectral order N (sde_stationary.py:73-166): companion F,
    P_inf from the Lyapunov equation as a linear system, then diagonal
    balancing so that P_inf has a unit diagonal."""
    N = int(order)
    aa = _rbf_companion_constants(N)
    a_tail = torch.tensor(aa[1:][::-1].copy(), dtype=like.dtype, device=like.device)
    powers = torch.arange(N, 0, -1, dtype=like.dtype, device=like.device)
    F = _zeros(N, like)
    F[torch.arange(N - 1), torch.arange(1, N)] = 1.0
    F = torch.cat([F[:-1], (-a_tail * lengthscale ** (-powers))[None]])
    qc = (variance * math.sqrt(2.0 * math.pi) * lengthscale ** (1 - 2 * N)
          * math.factorial(N) * (2.0 ** N))
    rhs = torch.zeros(N * N, dtype=like.dtype, device=like.device)
    rhs = torch.cat([rhs[:-1], -qc.reshape(1)])
    eye = torch.eye(N, dtype=like.dtype, device=like.device)
    M = torch.kron(F, eye) + torch.kron(eye, F)
    P = torch.linalg.solve(M, rhs).reshape(N, N)
    P = 0.5 * (P + P.mT)
    H = _h(*([1.0] + [0.0] * (N - 1)), like=like)
    d = torch.sqrt(torch.clamp(torch.diagonal(P), min=1e-30))
    return F * (d[None, :] / d[:, None]), P / (d[:, None] * d[None, :]), H * d[None, :]


# The matrix exponential as the reference takes it (jax.scipy.linalg.expm:
# scaling and squaring with a diagonal Pade approximant r_m = q_m^-1 p_m, m
# chosen from ||A||_1; Higham 2005, "The scaling and squaring method for the
# matrix exponential revisited"), written from its formulas: per dtype, the
# norm that bounds the scaled matrix, the norms where m steps up, and the m.
_PADE = {
    3: (120., 60., 12., 1.),
    5: (30240., 15120., 3360., 420., 30., 1.),
    7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
    9: (17643225600., 8821612800., 2075673600., 302702400., 30270240., 2162160., 110880.,
        3960., 90., 1.),
    13: (64764752532480000., 32382376266240000., 7771770303897600., 1187353796428800.,
         129060195264000., 10559470521600., 670442572800., 33522128640., 1323241920.,
         40840800., 960960., 16380., 182., 1.),
}
_EXPM = {
    torch.float32: (3.925724783138660, (4.258730016922831e-1, 1.880152677804762), (3, 5, 7)),
    torch.float64: (5.371920351148152, (1.495585217958292e-2, 2.539398330063230e-1,
                                        9.504178996162932e-1, 2.097847961257068),
                    (3, 5, 7, 9, 13)),
}
_MAX_SQUARINGS = 16


def _pade_uv(A, m):
    """(U, V) of the order-m Pade approximant: p_m = U + V, q_m = -U + V."""
    b = _PADE[m]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A2 = A @ A
    if m == 3:
        return A @ (b[3] * A2 + b[1] * eye), b[2] * A2 + b[0] * eye
    A4 = A2 @ A2
    if m == 5:
        return (A @ (b[5] * A4 + b[3] * A2 + b[1] * eye),
                b[4] * A4 + b[2] * A2 + b[0] * eye)
    A6 = A4 @ A2
    if m == 7:
        return (A @ (b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye),
                b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    if m == 9:
        A8 = A6 @ A2
        return (A @ (b[9] * A8 + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye),
                b[8] * A8 + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    return (A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2) + b[7] * A6 + b[5] * A4
                 + b[3] * A2 + b[1] * eye),
            A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2) + b[6] * A6 + b[4] * A4 + b[2] * A2
            + b[0] * eye)


def _expm(M):
    """exp(M) over the last two axes by scaling and squaring, in ``M``'s dtype
    (float32: Pade 3 / 5 / 7; float64: 3 / 5 / 7 / 9 / 13), each matrix with
    its own order and squarings; NaN where more than 16 squarings are needed.
    The float32 form matters: Q = P0 - A P0 A^T cancels where the step is
    short, and another float32 exponential (torch's series) put 5x the
    reference's float32 error into the LML."""
    if M.dtype not in _EXPM:
        raise TypeError(f"_expm takes float32 or float64, not {M.dtype}")
    maxnorm, conds, orders = _EXPM[M.dtype]
    norm = M.detach().abs().sum(-2).amax(-1)  # ||M||_1, per matrix; picks, not differentiated
    squarings = torch.clamp(torch.floor(torch.log2(norm / maxnorm)), min=0.0)
    A = M / (2.0 ** squarings)[..., None, None]
    branch = torch.bucketize(norm, torch.tensor(conds, dtype=M.dtype, device=M.device),
                             right=True)
    U, V = torch.empty_like(A), torch.empty_like(A)
    for k in torch.unique(branch).tolist():
        rows = branch == k
        U[rows], V[rows] = _pade_uv(A[rows], orders[k])
    R = torch.linalg.solve(-U + V, U + V)
    for i in range(min(int(squarings.max()) if squarings.numel() else 0, _MAX_SQUARINGS)):
        R = torch.where((squarings > i)[..., None, None], R @ R, R)
    return torch.where((squarings > _MAX_SQUARINGS)[..., None, None],
                       torch.full_like(R, float("nan")), R)


def _block_diag(blocks):
    """Block-diagonal stacking over the last two axes (leading axes shared)."""
    D = sum(b.shape[-1] for b in blocks)
    rows, off = [], 0
    for b in blocks:
        rows.append(torch.nn.functional.pad(b, (off, D - off - b.shape[-1])))
        off += b.shape[-1]
    return torch.cat(rows, dim=-2)


def _kron_product(Fa, Pa, Ha, Fb, Pb, Hb):
    """The product kernel k_a k_b: a Kronecker sum of the drifts, Kronecker
    products of P_inf and H."""
    Ia = torch.eye(Fa.shape[0], dtype=Fa.dtype, device=Fa.device)
    Ib = torch.eye(Fb.shape[0], dtype=Fb.dtype, device=Fb.device)
    return torch.kron(Fa, Ib) + torch.kron(Ia, Fb), torch.kron(Pa, Pb), torch.kron(Ha, Hb)


def _kernel_to_spec(k):
    """A kernel -> (family, variance, lengthscale, period, ls_damp), the sde_*
    bridge (GPy kern/src/sde_*.py)."""
    from ..kernels.base import Prod
    from ..kernels.linear import Linear
    from ..kernels.other import Brownian, StandardPeriodic
    from ..kernels.static import Bias, White
    from ..kernels.stationary import OU, RBF, Exponential, Matern32, Matern52

    one = 1.0
    if isinstance(k, (OU, Exponential)):
        return ("matern12", k.variance, k.lengthscale, one, one)
    if isinstance(k, Matern32):
        return ("matern32", k.variance, k.lengthscale, one, one)
    if isinstance(k, Matern52):
        return ("matern52", k.variance, k.lengthscale, one, one)
    if isinstance(k, StandardPeriodic):
        return ("periodic", k.variance, k.lengthscale, k.period, one)
    if isinstance(k, RBF):
        if k.lengthscale.ndim > 0 and k.lengthscale.numel() > 1:
            raise ValueError("state-space RBF form is 1-D (no ARD)")
        return ("rbf", k.variance, k.lengthscale.reshape(()), one, one)
    if isinstance(k, White):
        return ("white", k.variance, one, one, one)
    if isinstance(k, Bias):
        return ("bias", k.variance, one, one, one)
    if isinstance(k, Brownian):
        return ("brownian", k.variance, one, one, one)
    if isinstance(k, Linear):
        # K = sigma^2 x x' (sde_linear.py:12 with t0 = 0, in the 'period' slot)
        return ("linear", k.variances.reshape(()), one, 0.0, one)
    if isinstance(k, Prod) and len(k.parts) == 2:
        per = [p for p in k.parts if isinstance(p, StandardPeriodic)]
        mat = [p for p in k.parts if isinstance(p, (OU, Exponential, Matern32))]
        if len(per) == 1 and len(mat) == 1:
            fam = ("quasiperiodic_matern12" if isinstance(mat[0], (OU, Exponential))
                   else "quasiperiodic_matern32")
            # the product's variance folds into the periodic factor
            return (fam, per[0].variance * mat[0].variance, per[0].lengthscale,
                    per[0].period, mat[0].lengthscale)
    raise ValueError(
        f"no state-space (SDE) form for kernel {type(k).__name__}; supported: "
        "OU/Exponential, Matern32, Matern52, StandardPeriodic, RBF (spectral "
        "approximation), White, Bias, Brownian, Linear, "
        "StandardPeriodic*Matern products, and Add sums of those")


def from_kernel(kernel, X, Y, noise_var=0.1, order=7, dtype=None, device=None):
    """A StateSpaceGP from kernel objects (the sde_* bridge): the Matern
    family, StandardPeriodic, periodic x Matern products and ``Add`` sums."""
    from ..kernels.base import Add

    parts = kernel.parts if isinstance(kernel, Add) else (kernel,)
    specs = [_kernel_to_spec(p) for p in parts]
    fams = tuple(s[0] for s in specs)
    kw = dict(noise_var=noise_var, order=order, dtype=dtype, device=device)
    if len(fams) == 1:
        f, v, l, p, ld = specs[0]
        return StateSpaceGP.create(X, Y, family=f, variance=float(v), lengthscale=float(l),
                                   period=float(p), lengthscale_damp=float(ld), **kw)
    return StateSpaceGP.create(
        X, Y, family=fams, variance=np.asarray([float(s[1]) for s in specs]),
        lengthscale=np.asarray([float(s[2]) for s in specs]),
        period=np.asarray([float(s[3]) for s in specs]),
        lengthscale_damp=np.asarray([float(s[4]) for s in specs]), **kw)


@dataclasses.dataclass(frozen=True)
class StateSpaceGP:
    """1-D GP regression in state-space form (GPy models/state_space.py).
    ``family`` is one form or a tuple of forms (a sum kernel, with per-part
    ``variance``, ``lengthscale``, ``period``, ``lengthscale_damp`` vectors);
    ``lengthscale_damp`` is the Matern lengthscale of a quasi-periodic part."""

    variance: torch.Tensor = None
    lengthscale: torch.Tensor = None
    noise_variance: torch.Tensor = None
    period: torch.Tensor = None
    lengthscale_damp: torch.Tensor = None
    X: torch.Tensor = None  # (N, 1) times
    Y: torch.Tensor = None  # (N, 1)
    family: str | tuple = "matern32"
    order: int = 7          # periodic harmonics, RBF spectral order

    @classmethod
    def create(cls, X, Y, family="matern32", variance=1.0, lengthscale=1.0, noise_var=0.1,
               period=1.0, lengthscale_damp=1.0, order=7, dtype=None, device=None):
        """``device`` None means the card."""
        where = placement(dtype, device)
        X = np.asarray(X, dtype=float)
        if X.ndim >= 2 and X.shape[-1] != 1:
            raise ValueError(
                f"state-space GPs are 1-D (time) models; got X with "
                f"{X.shape[-1]} input dims — use a kernel-on-X model instead")
        X = X.reshape(-1, 1)
        Y = np.asarray(Y, dtype=float).reshape(-1, 1)
        if X.shape[0] != Y.shape[0]:
            raise ValueError(f"X/Y length mismatch: {X.shape[0]} vs {Y.shape[0]}")
        fams = family if isinstance(family, tuple) else (family,)
        if any(f in ("brownian", "linear") for f in fams) and X.min() < 0:
            raise ValueError(
                f"family {family!r} pins the state at t=0 "
                f"(sde_brownian.py:35 / sde_linear.py:44); negative "
                f"times (min {X.min():.3g}) are outside the process "
                f"domain — shift the time axis to start at >= 0")
        k = len(family) if isinstance(family, tuple) else None

        def vec(v):
            v = torch.as_tensor(np.asarray(v, dtype=float), **where)
            return v.reshape(()) if k is None else v.reshape(-1).expand(k).clone()

        return cls(variance=vec(variance), lengthscale=vec(lengthscale),
                   noise_variance=torch.as_tensor(float(noise_var), **where).reshape(()),
                   period=vec(period), lengthscale_damp=vec(lengthscale_damp),
                   X=torch.as_tensor(X, **where), Y=torch.as_tensor(Y, **where),
                   family=family, order=order)

    # ------------------------------------------------------------------ matrices
    def _component(self, family, variance, lengthscale, period, ls_damp):
        """One part -> (F, Qc, P0, H, kind): 'stationary' (Q from P_inf), 'vanloan'
        (Brownian and linear, P0 the covariance at t = 0), 'white' (A = 0,
        Q = P_inf every step, sde_static.py:35)."""
        like = self.X
        if family in ("matern12", "matern32", "matern52"):
            F, P, H = _matern_blocks(family, variance, lengthscale, like)
            return F, None, P, H, "stationary"
        if family == "periodic":
            F, P, H = _periodic_blocks(variance, lengthscale, period, self.order, like)
            return F, None, P, H, "stationary"
        if family.startswith("quasiperiodic_"):
            Fp, Pp, Hp = _periodic_blocks(variance, lengthscale, period, self.order, like)
            Fm, Pm, Hm = _matern_blocks(family.split("_", 1)[1], torch.ones_like(ls_damp),
                                        ls_damp, like)
            F, P, H = _kron_product(Fp, Pp, Hp, Fm, Pm, Hm)
            return F, None, P, H, "stationary"
        if family == "rbf":
            F, P, H = _rbf_blocks(variance, lengthscale, self.order, like)
            return F, None, P, H, "stationary"
        one = _h(1.0, like=like)
        if family == "white":
            return _zeros(1, like), None, variance * one, one, "white"
        if family == "bias":
            # F = 0: A = I, Q = 0, a frozen random constant
            return _zeros(1, like), None, variance * one, one, "stationary"
        if family == "brownian":
            return _zeros(1, like), variance * one, _zeros(1, like), one, "vanloan"
        if family == "linear":
            # the 'period' slot carries t0: K = sigma^2 (x + t0)(x' + t0)
            t0 = torch.as_tensor(period, dtype=like.dtype, device=like.device)
            F = _zeros(2, like)
            F[0, 1] = 1.0
            P0 = variance * torch.stack([torch.stack([t0 * t0, t0]),
                                         torch.stack([t0, torch.ones_like(t0)])])
            return F, _zeros(2, like), P0, _h(1.0, 0.0, like=like), "vanloan"
        raise ValueError(f"unsupported state-space family {family!r}")

    def _families(self):
        return self.family if isinstance(self.family, tuple) else (self.family,)

    def _component_specs(self):
        specs = []
        for i, fam in enumerate(self._families()):
            if isinstance(self.family, tuple):
                v, l = self.variance[i], self.lengthscale[i]
                p, ld = self.period[i], self.lengthscale_damp[i]
            else:
                v, l, p, ld = self.variance, self.lengthscale, self.period, self.lengthscale_damp
            specs.append(self._component(fam, v, l, p, ld))
        return specs

    def _origin_at_zero(self):
        return any(f in ("brownian", "linear") for f in self._families())

    @staticmethod
    def _discretize_component(spec, dts):
        F, Qc, P0, H, kind = spec
        d, n = F.shape[0], dts.shape[0]
        if kind == "white":
            return F.new_zeros(n, d, d), P0.expand(n, d, d)
        if kind == "stationary":
            A = _expm(F * dts[:, None, None])
            Q = P0 - A @ P0 @ A.mT
            return A, 0.5 * (Q + Q.mT)
        # Van Loan: Q(dt) = Phi_12 A^T, Phi = expm([[F, Qc], [0, -F^T]] dt)
        M = torch.cat([torch.cat([F, Qc], dim=1), torch.cat([torch.zeros_like(F), -F.mT], dim=1)])
        Phi = _expm(M * dts[:, None, None])
        A = Phi[:, :d, :d]
        Q = Phi[:, :d, d:] @ A.mT
        return A, 0.5 * (Q + Q.mT)

    def _discretize(self, dts):
        """Per-step transitions A_k, process noises Q_k, the initial
        covariance P0 and H of the (block-diagonal) model."""
        specs = self._component_specs()
        if len(specs) == 1:
            A, Q = self._discretize_component(specs[0], dts)
            return A, Q, specs[0][2], specs[0][3]
        As, Qs = zip(*(self._discretize_component(s, dts) for s in specs))
        return (_block_diag(As), _block_diag(Qs), _block_diag([s[2] for s in specs]),
                torch.cat([s[3] for s in specs], dim=1))

    # ------------------------------------------------------------------ inference
    def _filter(self, t, y, observed):
        """Kalman filter over the sorted times; ``observed`` (host booleans)
        says which steps update and which only predict. Returns the order, the
        filtered means and covariances, the discretization, H and the LML."""
        order = torch.argsort(t, stable=True)
        t_s, y_s = t[order], y[order]
        obs = [observed[i] for i in order.tolist()]
        first = t_s[0:1] * 0.0 if self._origin_at_zero() else t_s[0:1]
        dts = torch.diff(t_s, prepend=first)
        A, Q, P, H = self._discretize(dts)
        R = self.noise_variance
        m = torch.zeros(P.shape[0], 1, dtype=t.dtype, device=t.device)
        ms, Ps, lls = [], [], []
        for k in range(t_s.shape[0]):
            Ak = A[k]
            m = Ak @ m
            P = Ak @ P @ Ak.mT + Q[k]
            if obs[k]:
                v = y_s[k] - (H @ m)[0, 0]
                PHt = P @ H.mT
                S = (H @ PHt)[0, 0] + R
                K = PHt / S
                lls.append(-0.5 * (LOG_2_PI + torch.log(S) + v * v / S))
                m = m + K * v
                P = P - K @ (H @ P)
            ms.append(m)
            Ps.append(P)
        lml = torch.stack(lls).sum() if lls else t.new_zeros(())
        return order, torch.stack(ms)[..., 0], torch.stack(Ps), A, Q, H, lml

    def _lanes(self):
        """One model per lane: a leaf with a leading axis beyond its own rank
        (0 for one form, 1 for a sum) is indexed, the others shared."""
        own = 0 if not isinstance(self.family, tuple) else 1
        fields = ("variance", "lengthscale", "period", "lengthscale_damp")
        sizes = {getattr(self, f).shape[0] for f in fields if getattr(self, f).ndim > own}
        if self.noise_variance.ndim > 0:
            sizes.add(self.noise_variance.shape[0])
        if not sizes:
            return None
        (B,) = sizes
        pick = {f: own for f in fields}
        pick["noise_variance"] = 0
        return [dataclasses.replace(self, **{f: getattr(self, f)[b] for f, r in pick.items()
                                             if getattr(self, f).ndim > r})
                for b in range(B)]

    def log_marginal_likelihood(self):
        lanes = self._lanes()
        if lanes is not None:
            return torch.stack([m.log_marginal_likelihood() for m in lanes])
        t = self.X[:, 0]
        return self._filter(t, self.Y[:, 0], [True] * t.shape[0])[-1]

    def predict(self, Xnew, include_likelihood=True):
        """RTS smoother over the merged training and test timeline."""
        t_train = self.X[:, 0]
        t_new = torch.as_tensor(np.asarray(Xnew, dtype=float), dtype=self.X.dtype,
                                device=self.X.device).reshape(-1)
        t_all = torch.cat([t_train, t_new])
        y_all = torch.cat([self.Y[:, 0], torch.zeros_like(t_new)])
        observed = [True] * t_train.shape[0] + [False] * t_new.shape[0]
        order, mf, Pf, A, Q, H, _ = self._filter(t_all, y_all, observed)
        n = mf.shape[0]
        eye = torch.eye(Pf.shape[-1], dtype=Pf.dtype, device=Pf.device)
        ms_next, Ps_next = mf[-1], Pf[-1]
        ms, Ps = [ms_next], [Ps_next]
        for k in range(n - 2, -1, -1):  # transition k -> k+1 uses A, Q at k+1
            A_next = A[k + 1]
            m_pred = A_next @ mf[k]
            P_pred = A_next @ Pf[k] @ A_next.mT + Q[k + 1]
            G = Pf[k] @ A_next.mT @ torch.linalg.inv(P_pred + 1e-10 * eye)
            ms_next = mf[k] + G @ (ms_next - m_pred)
            Ps_next = Pf[k] + G @ (Ps_next - P_pred) @ G.mT
            ms.append(ms_next)
            Ps.append(Ps_next)
        ms, Ps = torch.stack(ms[::-1]), torch.stack(Ps[::-1])
        mu_all = ms @ H[0]
        var_all = (H @ Ps @ H.mT)[:, 0, 0]
        if include_likelihood:
            var_all = var_all + self.noise_variance
        inv = torch.argsort(order)
        mu = mu_all[inv][t_train.shape[0]:]
        var = var_all[inv][t_train.shape[0]:]
        return mu[:, None], torch.clamp(var, min=1e-15)[:, None]
