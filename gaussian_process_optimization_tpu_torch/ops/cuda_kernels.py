"""CUDA kernels for the covariance hot path (twin of ``gaussian_process_optimization_tpu/ops/pallas_kernels.py``).

Two kernels, in ``csrc/stationary_k.cu`` (entry points and design note),
``csrc/stationary_k_kernels.cuh`` (the templates) and one
``csrc/stationary_k_<family>.cu`` per family (the instantiations):

- :func:`stationary_k_build` (forward) — replaces the JAX package's
  ``pallas_kernels._pallas_K`` / ``_make_tile_kernel``. One launch writes the
  whole lane batch ``(B, N, M)``: the lane axis is a grid dimension, in place of
  the sequential grid dimension Pallas's vmap rule would add. Bound: storing
  ``B*N*M`` floats; the design keeps the instructions per entry low enough to
  come near it (see the source note).
- :func:`stationary_k_backward` — replaces ``_pallas_K_bwd`` /
  ``_make_bwd_tile_kernel``. The TPU kernel's cross-grid-step ``+=`` is a race
  on a GPU; here a block sweeps its rows' columns itself with every sum in
  registers, a second kernel owns columns for dZ, and per-block partials are
  summed in a second, fixed-order pass, so it is deterministic.

The family, the ARD flag and the dimension bucket (4, 6 or 8 dimensions in
registers, chunks of 8 above) pick a template instantiation; the wrappers pad
``X`` and ``Z`` with zero columns to the bucket's width.

Each wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; a CPU tensor takes the plain PyTorch version beside it
(the same explicit-difference arithmetic). Routing into the wrappers is the
reference's gate, :func:`supports`. ``launches`` on each wrapper counts kernel
launches; the backward's ``launches_dx`` and ``launches_dz`` count, of those,
the row passes that wrote dX and the column (dZ) passes.

Shapes: ``X (Bx, N, D)``, ``Z (Bz, M, D)``, ``params (Bp, W)`` with each of
``Bx, Bz, Bp`` either 1 (shared by all lanes) or ``B``. The params row per lane
is ``[variance, power, lengthscale...]`` padded to ``W >= 8``
(``pallas_kernels._params_row``).
"""
from __future__ import annotations

import math

import torch

from ..config import kernels_enabled
from . import _build

FAMILIES = ("rbf", "exponential", "ou", "matern32", "matern52", "cosine", "ratquad")
_MAX_D = 64
_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def k_of_r(family, r, variance, power=None):
    if family == "rbf":
        return variance * torch.exp(-0.5 * r * r)
    if family in ("exponential", "ou"):
        return variance * torch.exp(-r)
    if family == "matern32":
        return variance * (1.0 + _SQRT3 * r) * torch.exp(-_SQRT3 * r)
    if family == "matern52":
        return variance * (1.0 + _SQRT5 * r + (5.0 / 3.0) * r * r) * torch.exp(-_SQRT5 * r)
    if family == "cosine":
        return variance * torch.cos(r)
    if family == "ratquad":
        return variance * torch.exp(-power * torch.log1p(0.5 * r * r))
    raise ValueError(family)


def k_dr_over_r(family, r, variance, power=None):
    """dK_of_r/dr / r with the r -> 0 limit where it exists (``_k_dr_over_r``)."""
    safe_r = torch.clamp(r, min=1e-30)
    if family == "rbf":
        return -variance * torch.exp(-0.5 * r * r)
    if family in ("exponential", "ou"):
        return -variance * torch.exp(-r) / safe_r
    if family == "matern32":
        return -3.0 * variance * torch.exp(-_SQRT3 * r)
    if family == "matern52":
        return -(5.0 / 3.0) * variance * (1.0 + _SQRT5 * r) * torch.exp(-_SQRT5 * r)
    if family == "cosine":
        return torch.where(r < 1e-12, -variance, -variance * torch.sin(r) / safe_r)
    if family == "ratquad":
        return -variance * power * torch.exp(-(power + 1.0) * torch.log1p(0.5 * r * r))
    raise ValueError(family)


def supports(kern, X, X2) -> bool:
    """Kernel routing (``pallas_kernels.supports``): stationary family, f32,
    D <= 64, and at least 128^2 elements PER LANE — the shape the reference
    sees under ``vmap``, so stacking lanes never changes the route."""
    if getattr(kern, "_family", None) not in FAMILIES:
        return False
    if not kernels_enabled(X):
        return False
    if X.dtype != torch.float32:
        return False
    if X.shape[-1] > _MAX_D:
        return False
    n = X.shape[-2]
    m = n if X2 is None else X2.shape[-2]
    return n * m >= 128 * 128


def params_rows(kern, d: int, ard: bool) -> torch.Tensor:
    """``(Bp, W)`` rows ``[variance, power, lengthscale...]`` (``_params_row``)."""
    variance = kern.variance
    lanes = tuple(variance.shape)
    power = getattr(kern, "power", None)
    power = torch.zeros_like(variance) if power is None else power.reshape(lanes)
    ls = kern.lengthscale.reshape(lanes + (-1,))
    ls = ls[..., :d] if ard else ls[..., :1]
    row = torch.cat([variance[..., None], power[..., None], ls], dim=-1)
    width = max(row.shape[-1], 8)
    row = torch.nn.functional.pad(row, (0, width - row.shape[-1]))
    return row.reshape(-1, width)


# ---------------------------------------------------------------- plain versions
def _unpack_params(params, ard, d):
    variance = params[:, 0, None, None]
    power = params[:, 1, None, None]
    ls = [params[:, 2 + k if ard else 2, None, None] for k in range(d)]
    return variance, power, ls


def k_build_plain(X, Z, params, family: str, ard: bool) -> torch.Tensor:
    """K (B, N, M) by explicit per-dimension differences (the TPU tile's math)."""
    d = X.shape[-1]
    variance, power, ls = _unpack_params(params, ard, d)
    r2 = None
    for k in range(d):
        dx = X[:, :, k, None] - Z[:, None, :, k]
        if ard:
            dx = dx / ls[k]
        r2 = dx * dx if r2 is None else r2 + dx * dx
    if not ard:
        r2 = r2 / (ls[0] * ls[0])
    r = torch.sqrt(torch.clamp(r2, min=0.0))
    return k_of_r(family, r, variance, power)


def k_backward_plain(X, Z, params, G, family: str, ard: bool, need_dx=True,
                     need_dz=True, need_params=True):
    """(dparams (B, W), dX (B, N, D), dZ (B, M, D)) — the fused backward tile's
    formulas over the whole matrix; entries not asked for are None."""
    d = X.shape[-1]
    variance, power, ls = _unpack_params(params, ard, d)
    us = [(X[:, :, k, None] - Z[:, None, :, k]) / ls[k] for k in range(d)]
    r2 = None
    for u in us:
        r2 = u * u if r2 is None else r2 + u * u
    r = torch.sqrt(torch.clamp(r2, min=0.0))
    W = G * k_dr_over_r(family, r, variance, power)
    dparams = dX = dZ = None
    if need_params:
        B = W.shape[0]
        dparams = torch.zeros(B, params.shape[1], dtype=G.dtype, device=G.device)
        dparams[:, 0] = torch.sum(G * k_of_r(family, r, 1.0, power), dim=(-2, -1))
        if family == "ratquad":
            Kv = k_of_r(family, r, variance, power)
            dparams[:, 1] = -torch.sum(G * Kv * torch.log1p(0.5 * r2), dim=(-2, -1))
        dls = [-torch.sum(W * u * u, dim=(-2, -1)) / ls[k][:, 0, 0]
               for k, u in enumerate(us)]
        if ard:
            dparams[:, 2:2 + d] = torch.stack(dls, dim=-1)
        else:
            dparams[:, 2] = sum(dls)
    if need_dx:
        dX = torch.stack([torch.sum(W * u, dim=-1) / ls[k][:, :, 0]
                          for k, u in enumerate(us)], dim=-1)
    if need_dz:
        dZ = torch.stack([-torch.sum(W * u, dim=-2) / ls[k][:, :, 0]
                          for k, u in enumerate(us)], dim=-1)
    return dparams, dX, dZ


# ---------------------------------------------------------------- kernel wrappers
def _lanes(*sizes) -> int:
    B = max(sizes)
    if any(s not in (1, B) for s in sizes):
        raise ValueError(f"lane sizes {sizes} do not broadcast")
    return B


def _check_inputs(X, Z, params, G=None):
    dev = X.device
    for name, t in (("X", X), ("Z", Z), ("params", params), ("G", G)):
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must lie on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if name != "G" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if X.ndim != 3 or Z.ndim != 3 or params.ndim != 2:
        raise ValueError("expected X (B, N, D), Z (B, M, D), params (B, W)")
    d = X.shape[-1]
    if Z.shape[-1] != d or not 1 <= d <= _MAX_D:
        raise ValueError(f"bad input width {d} / {Z.shape[-1]} (1..{_MAX_D})")
    if params.shape[1] < 2 + d:
        raise ValueError(f"params width {params.shape[1]} < 2 + D")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _padded(T: torch.Tensor) -> torch.Tensor:
    """``T`` (B, N, D) with zero columns appended up to the width the kernels
    take (4, 6 or 8 for D <= 8, else the next multiple of 8), 16-byte aligned.
    Padded dimensions add exactly 0 to r^2."""
    extra = _build.library().gpo_padded_width(T.shape[-1]) - T.shape[-1]
    if extra:
        return torch.nn.functional.pad(T, (0, extra))
    return T if T.data_ptr() % 16 == 0 else T.clone()


def _padded_pair(X, Z):
    Xp = _padded(X)
    same = Z is X or (Z.data_ptr() == X.data_ptr() and Z.shape == X.shape)
    return Xp, (Xp if same else _padded(Z))


def _lane_stride(T) -> int:
    return T.shape[1] * T.shape[2] if T.shape[0] > 1 else 0


def stationary_k_build(X, Z, params, family: str, ard: bool) -> torch.Tensor:
    """K (B, N, M); kernel on CUDA, plain version on the CPU. K(X, X) comes out
    bitwise symmetric from either."""
    if not X.is_cuda:
        return k_build_plain(X, Z, params, family, ard)
    _check_inputs(X, Z, params)
    B = _lanes(X.shape[0], Z.shape[0], params.shape[0])
    N, D = X.shape[1:]
    M = Z.shape[1]
    params = params.expand(B, -1).contiguous()
    out = torch.empty(B, N, M, dtype=X.dtype, device=X.device)
    if out.numel():
        lib = _build.library()
        Xp, Zp = _padded_pair(X, Z)
        _build.check(lib.gpo_stationary_k(
            Xp.data_ptr(), Zp.data_ptr(), params.data_ptr(), out.data_ptr(), B, N, M, D,
            Xp.shape[-1], params.shape[1], _lane_stride(Xp), _lane_stride(Zp),
            FAMILIES.index(family), int(ard), _stream()), "stationary_k_build")
        stationary_k_build.launches += 1
    return out


stationary_k_build.launches = 0


def stationary_k_backward(X, Z, params, G, family: str, ard: bool, need_dx=True,
                          need_dz=True, need_params=True):
    """(dparams (B, W), dX (B, N, D), dZ (B, M, D)) given G = dL/dK (B, N, M);
    kernel on CUDA, plain version on the CPU. One launch sweeps G by row strips
    for the parameter gradients and dX, a second by column strips for dZ. G may
    be any strided view (16 bytes a load when its last stride is 1 and its rows
    are 16-byte aligned, 4 bytes otherwise); it is never copied."""
    if not X.is_cuda:
        return k_backward_plain(X, Z, params, G, family, ard, need_dx, need_dz,
                                need_params)
    _check_inputs(X, Z, params, G)
    B = _lanes(X.shape[0], Z.shape[0], params.shape[0], G.shape[0])
    N, D = X.shape[1:]
    M = Z.shape[1]
    if G.shape != (B, N, M):
        raise ValueError(f"G has shape {tuple(G.shape)}, expected {(B, N, M)}")
    params = params.expand(B, -1).contiguous()
    W = params.shape[1]
    sgb, sgn, sgm = G.stride()
    if G.shape[0] == 1:
        sgb = 0
    lib = _build.library()
    Xp, Zp = _padded_pair(X, Z)
    common = (B, N, M, D, Xp.shape[-1], W, _lane_stride(Xp), _lane_stride(Zp), sgb, sgn,
              sgm, FAMILIES.index(family), int(ard), _stream())
    dparams = dX = dZ = None
    new = dict(dtype=X.dtype, device=X.device)
    if need_params or need_dx:
        tiles = lib.gpo_bwd_partial_rows(B, N, M, int(need_dx))
        partials = torch.empty(B, tiles, W, **new) if need_params else None
        dX = torch.empty(B, N, D, **new) if need_dx else None
        _build.check(lib.gpo_stationary_k_bwd_rows(
            Xp.data_ptr(), Zp.data_ptr(), params.data_ptr(), G.data_ptr(),
            dX.data_ptr() if need_dx else None,
            partials.data_ptr() if need_params else None, *common),
            "stationary_k_backward (row pass)")
        stationary_k_backward.launches += 1
        stationary_k_backward.launches_dx += int(need_dx)
        if need_params:
            dparams = torch.empty(B, W, **new)
            _build.check(lib.gpo_sum_partials(partials.data_ptr(), dparams.data_ptr(),
                                              B, tiles, W, _stream()),
                         "stationary_k_backward (partial sums)")
    if need_dz:
        strips = -(-N // lib.gpo_bwd_col_strip())
        scratch = torch.empty(B, strips, M, D, **new)
        _build.check(lib.gpo_stationary_k_bwd_cols(
            Xp.data_ptr(), Zp.data_ptr(), params.data_ptr(), G.data_ptr(),
            scratch.data_ptr(), *common), "stationary_k_backward (column pass)")
        stationary_k_backward.launches += 1
        stationary_k_backward.launches_dz += 1
        dZ = torch.empty(B, M, D, **new)
        _build.check(lib.gpo_sum_partials(scratch.data_ptr(), dZ.data_ptr(), B, strips,
                                          M * D, _stream()),
                     "stationary_k_backward (strip sums)")
    return dparams, dX, dZ


stationary_k_backward.launches = 0
# of those: row passes that also wrote dX, and column (dZ) passes
stationary_k_backward.launches_dx = 0
stationary_k_backward.launches_dz = 0


def _sum_to_lanes(g, lanes: int):
    if g is None or g.shape[0] == lanes:
        return g
    return g.sum(dim=0, keepdim=True)


def k_jvp_plain(X, Z, params, dX, dZ, dparams, family: str, ard: bool) -> torch.Tensor:
    """The tangent of K (B, N, M) along (dX, dZ, dparams), any of them None:
    dK = (dk/dr / r) sum_d u_d du_d + K dvariance / variance (+ the RatQuad
    power's term), u_d = (x_d - z_d) / l_d. Plain PyTorch: forward-mode
    derivatives (``GPRegression.predict_jacobian``) are off the hot path."""
    d = X.shape[-1]
    variance, power, ls = _unpack_params(params, ard, d)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    dvar, dpow, dls = zero, zero, [zero] * d
    if dparams is not None:
        dvar, dpow, dls = _unpack_params(dparams, ard, d)
    us = [(X[:, :, k, None] - Z[:, None, :, k]) / ls[k] for k in range(d)]
    r2 = sum(u * u for u in us)
    r = torch.sqrt(torch.clamp(r2, min=0.0))
    inner = 0.0
    for k, u in enumerate(us):
        du = -u * dls[k] / ls[k]
        if dX is not None:
            du = du + dX[:, :, k, None] / ls[k]
        if dZ is not None:
            du = du - dZ[:, None, :, k] / ls[k]
        inner = inner + u * du
    out = k_dr_over_r(family, r, variance, power) * inner
    out = out + k_of_r(family, r, 1.0, power) * dvar
    if family == "ratquad":
        out = out - k_of_r(family, r, variance, power) * torch.log1p(0.5 * r2) * dpow
    return out


class StationaryK(torch.autograd.Function):
    """K(X, Z) with the fused backward (the reference's ``_K_entry`` custom VJP):
    forward :func:`stationary_k_build`, backward :func:`stationary_k_backward`,
    computing only the gradients autograd asks for. Forward-mode derivatives
    (``torch.func.jvp``) take :func:`k_jvp_plain`."""

    @staticmethod
    def forward(X, Z, params, family, ard):
        return stationary_k_build(X, Z, params, family, ard)

    @staticmethod
    def setup_context(ctx, inputs, output):
        X, Z, params, family, ard = inputs
        ctx.save_for_backward(X, Z, params)
        ctx.save_for_forward(X, Z, params)
        ctx.family, ctx.ard = family, ard

    @staticmethod
    def jvp(ctx, dX, dZ, dparams, *_):
        X, Z, params = ctx.saved_tensors
        return k_jvp_plain(X, Z, params, dX, dZ, dparams, ctx.family, ctx.ard)

    @staticmethod
    def backward(ctx, G):
        X, Z, params = ctx.saved_tensors
        need_dx, need_dz, need_p = ctx.needs_input_grad[:3]
        dp, dX, dZ = stationary_k_backward(X, Z, params, G, ctx.family, ctx.ard,
                                           need_dx, need_dz, need_p)
        return (_sum_to_lanes(dX, X.shape[0]), _sum_to_lanes(dZ, Z.shape[0]),
                _sum_to_lanes(dp, params.shape[0]), None, None)


def stationary_K(kern, X, X2=None) -> torch.Tensor:
    """Kernel-routed K (``pallas_kernels.stationary_K``). ``X`` / ``X2`` are
    ``(N, D)`` or lane-batched ``(B, N, D)``; the lanes of ``kern`` come from
    its variance's shape. The reference returns ``(K + K^T) / 2`` in the
    symmetric case; here K(X, X) is bitwise symmetric as computed (by the
    kernel and by the plain version: ``(x_i - x_j) c`` is the exact negative of
    ``(x_j - x_i) c``, and the sum over dimensions runs in one order), so that
    pass would return K itself and is not run, nor is its mirror on the way
    back."""
    d = X.shape[-1]
    ard = kern.is_ard
    Z = X if X2 is None else X2
    params = params_rows(kern, d, ard)
    batch = torch.broadcast_shapes(tuple(kern.variance.shape), tuple(X.shape[:-2]),
                                   tuple(Z.shape[:-2]))
    X3 = X.reshape((-1,) + tuple(X.shape[-2:])).contiguous()
    Z3 = X3 if X2 is None else Z.reshape((-1,) + tuple(Z.shape[-2:])).contiguous()
    K = StationaryK.apply(X3, Z3, params.contiguous(), kern._family, ard)
    return K.reshape(tuple(batch) + tuple(K.shape[-2:]))
