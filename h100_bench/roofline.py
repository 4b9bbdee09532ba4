"""Work and peak arithmetic: the operations and bytes one call needs, counted
from its shapes, and the least time the card could take for them.

Each input is counted as read once and each output as written once, whatever
an implementation reads again. The peaks are the data-sheet figures of one
NVIDIA H100 SXM at its 700 W limit: 67 TFLOP/s in float32 outside the tensor
cores and 3.35 TB/s of HBM bandwidth.
"""
from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4

# flops per covariance entry of the Matern52 ARD build: per dimension a
# difference, a scale, a square and an add; then the root, the profile
# (sqrt5 r, r^2, 5/3 r^2, two adds, the exponential, a product) and the variance
MATERN52_PER_DIM = 4
MATERN52_FIXED = 10
# the Gower build: per continuous dimension a difference, an absolute value
# and a division by the range, per discrete one a comparison, shared by the
# lanes; then per lane and dimension the profile (8) and the product (1)
GOWER_R_CONT = 3
GOWER_R_DISC = 1
GOWER_PER_LANE_DIM = 9


def kbuild_work(family: str, lanes: int, n: int, m: int, dims: int,
                continuous: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of K(X1, X2) for ``lanes`` hyperparameter sets, X1
    (n, dims), X2 (m, dims), output (lanes, n, m) float32."""
    entries = n * m
    params = lanes * (dims + 1)
    bytes_ = F32 * ((n + m) * dims + params + lanes * entries)
    if family == "matern52_ard":
        flops = lanes * entries * (MATERN52_PER_DIM * dims + MATERN52_FIXED)
    elif family == "gower_matern52":
        cont = dims if continuous is None else continuous
        flops = (entries * (GOWER_R_CONT * cont + GOWER_R_DISC * (dims - cont))
                 + lanes * entries * GOWER_PER_LANE_DIM * dims)
    else:
        raise ValueError(f"no work count for kernel family {family!r}")
    return float(flops), float(bytes_)


def cholesky_work(lanes: int, n: int) -> tuple[float, float]:
    """(flops, bytes) of ``lanes`` Cholesky factorizations of n x n: n^3 / 3
    flops each; the lower triangle read once and written once."""
    tri = n * (n + 1) // 2
    return lanes * n ** 3 / 3.0, float(2 * F32 * lanes * tri)


def least_seconds(flops: float, bytes_: float) -> tuple[float, str]:
    """The roofline's least time and what bounds it: 'flops' or 'bytes'."""
    t_f, t_b = flops / F32_FLOPS, bytes_ / HBM_BYTES_PER_S
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")


def share_pct(flops: float, bytes_: float, seconds: float) -> float:
    """Percent of the roofline a call reached in ``seconds``."""
    return 100.0 * least_seconds(flops, bytes_)[0] / seconds
