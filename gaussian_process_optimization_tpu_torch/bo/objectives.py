"""Benchmark objective functions (twin of
``gaussian_process_optimization_tpu/bo/objectives.py``, which this package keeps its
own copy of; GPyOpt/GPyOpt/objective_examples/: experiments1d.py
forrester:22; experiments2d.py branin:174 (fmin=0.397887, :201), rosenbrock:48,
beale:79, dropwave:110, cosines:141, sixhumpcamel:259, goldstein:219,
mccormick:296, powers:333, eggholder:365; experimentsNd.py
alpine1:7, alpine2:39, gSobol:69, ackley:101). Hartmann6 is not in GPyOpt: it is
implemented from the standard definition, for the regret comparisons.

All are host numpy functions of (n, d) arrays returning (n, 1), with their
standard domains (``bounds``) and minima (``fmin``) attached.
"""
from __future__ import annotations

import numpy as np


def forrester(x):
    """f(x) = (6x-2)^2 sin(12x-4) on [0,1]; fmin ~= -6.0207 at x~=0.7572."""
    x = np.atleast_2d(x)[:, :1]
    return ((6 * x - 2) ** 2) * np.sin(12 * x - 4)


forrester.bounds = [(0.0, 1.0)]
forrester.fmin = -6.020740
forrester.xmin = np.array([[0.757249]])


def branin(x):
    """Branin on [-5,10]x[1,15]; fmin = 0.397887 (experiments2d.py:201)."""
    x = np.atleast_2d(x)
    x1, x2 = x[:, 0:1], x[:, 1:2]
    a, b, c = 1.0, 5.1 / (4 * np.pi**2), 5.0 / np.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * np.pi)
    return a * (x2 - b * x1**2 + c * x1 - r) ** 2 + s * (1 - t) * np.cos(x1) + s


branin.bounds = [(-5.0, 10.0), (1.0, 15.0)]
branin.fmin = 0.397887
branin.xmin = np.array([[-np.pi, 12.275], [np.pi, 2.275], [9.42478, 2.475]])


def rosenbrock(x):
    """2-D Rosenbrock on [-0.5,3]x[-1.5,2] (experiments2d.py:48); fmin=0 at (1,1)."""
    x = np.atleast_2d(x)
    x1, x2 = x[:, 0:1], x[:, 1:2]
    return 100.0 * (x2 - x1**2) ** 2 + (x1 - 1.0) ** 2


rosenbrock.bounds = [(-0.5, 3.0), (-1.5, 2.0)]
rosenbrock.fmin = 0.0
rosenbrock.xmin = np.array([[1.0, 1.0]])


def sixhumpcamel(x):
    """Six-hump camel on [-2,2]x[-1,1]; fmin=-1.0316."""
    x = np.atleast_2d(x)
    x1, x2 = x[:, 0:1], x[:, 1:2]
    return (4 - 2.1 * x1**2 + x1**4 / 3) * x1**2 + x1 * x2 + (-4 + 4 * x2**2) * x2**2


sixhumpcamel.bounds = [(-2.0, 2.0), (-1.0, 1.0)]
sixhumpcamel.fmin = -1.0316
sixhumpcamel.xmin = np.array([[0.0898, -0.7126], [-0.0898, 0.7126]])


def mccormick(x):
    """McCormick on [-1.5,4]x[-3,4]; fmin=-1.9133."""
    x = np.atleast_2d(x)
    x1, x2 = x[:, 0:1], x[:, 1:2]
    return np.sin(x1 + x2) + (x1 - x2) ** 2 - 1.5 * x1 + 2.5 * x2 + 1.0


mccormick.bounds = [(-1.5, 4.0), (-3.0, 4.0)]
mccormick.fmin = -1.9133
mccormick.xmin = np.array([[-0.54719, -1.54719]])


def goldstein(x):
    """Goldstein-Price on [-2,2]^2; fmin=3 at (0,-1)."""
    x = np.atleast_2d(x)
    x1, x2 = x[:, 0:1], x[:, 1:2]
    a = 1 + (x1 + x2 + 1) ** 2 * (19 - 14 * x1 + 3 * x1**2 - 14 * x2 + 6 * x1 * x2 + 3 * x2**2)
    b = 30 + (2 * x1 - 3 * x2) ** 2 * (18 - 32 * x1 + 12 * x1**2 + 48 * x2 - 36 * x1 * x2 + 27 * x2**2)
    return a * b


goldstein.bounds = [(-2.0, 2.0), (-2.0, 2.0)]
goldstein.fmin = 3.0
goldstein.xmin = np.array([[0.0, -1.0]])


def eggholder(x):
    """Eggholder on [-512,512]^2; fmin=-959.6407."""
    x = np.atleast_2d(x)
    x1, x2 = x[:, 0:1], x[:, 1:2]
    return -(x2 + 47) * np.sin(np.sqrt(np.abs(x2 + x1 / 2 + 47))) - x1 * np.sin(
        np.sqrt(np.abs(x1 - (x2 + 47)))
    )


eggholder.bounds = [(-512.0, 512.0), (-512.0, 512.0)]
eggholder.fmin = -959.6407
eggholder.xmin = np.array([[512.0, 404.2319]])


def alpine1(x, input_dim=None):
    """Alpine-1, N-D on [-10,10]^d (experimentsNd.py:7); fmin=0 at origin."""
    x = np.atleast_2d(x)
    return np.sum(np.abs(x * np.sin(x) + 0.1 * x), axis=1, keepdims=True)


alpine1.fmin = 0.0


def ackley(x, input_dim=None):
    """Ackley, N-D on [-32.768, 32.768]^d (experimentsNd.py:101); fmin=0 at origin."""
    x = np.atleast_2d(x)
    d = x.shape[1]
    s1 = np.sum(np.square(x), axis=1, keepdims=True)
    s2 = np.sum(np.cos(2 * np.pi * x), axis=1, keepdims=True)
    return (
        20.0
        - 20.0 * np.exp(-0.2 * np.sqrt(s1 / d))
        + np.e
        - np.exp(s2 / d)
    )


ackley.fmin = 0.0


def gSobol(x, a=None):
    """g-Sobol, N-D on [-4,6]^d (experimentsNd.py:69). a defaults to ones."""
    x = np.atleast_2d(x)
    d = x.shape[1]
    if a is None:
        a = np.ones((d,))
    a = np.asarray(a, dtype=x.dtype)
    g = (np.abs(4 * x - 2) + a) / (1 + a)
    return np.prod(g, axis=1, keepdims=True)


def beale(x):
    """'Beale' as the reference defines it (experiments2d.py:79): the returned
    value is -(100(x2-x1^2)^2 + (x1-1)^2) on [-1,1]^2 — NOT the textbook Beale
    function (the reference body is a negated Rosenbrock; reproduced verbatim
    for parity, with the reference's own fmin=0-at-(0,0) metadata kept)."""
    x = np.atleast_2d(x)
    x1, x2 = x[:, 0:1], x[:, 1:2]
    return -(100.0 * (x2 - x1**2) ** 2 + (x1 - 1.0) ** 2)


beale.bounds = [(-1.0, 1.0), (-1.0, 1.0)]
# the reference's own metadata (fmin=0 at (0,0), :90-91) contradicts its
# formula; the true minimum of the returned value on [-1,1]^2 is -404 at (-1,-1)
beale.fmin = -404.0
beale.xmin = np.array([[-1.0, -1.0]])


def dropwave(x):
    """Drop-wave on [-1,1]^2 (experiments2d.py:110). The reference returns the
    POSITIVE well (1+cos(12 r))/(0.5 r^2 + 2): its f computes the standard
    negative form and returns -fval."""
    x = np.atleast_2d(x)
    x1, x2 = x[:, 0:1], x[:, 1:2]
    r2 = x1**2 + x2**2
    return (1.0 + np.cos(12.0 * np.sqrt(r2))) / (0.5 * r2 + 2.0)


dropwave.bounds = [(-1.0, 1.0), (-1.0, 1.0)]
# minimum of the returned positive well: 0 wherever cos(12 r) = -1, first at
# r = pi/12 (reference metadata says (0,0), which is its MAXIMUM)
dropwave.fmin = 0.0
dropwave.xmin = np.array([[np.pi / 12.0, 0.0]])


def cosines(x):
    """Cosines on [0,1]^2 (experiments2d.py:141): returns
    -(1 - (u^2 + v^2 - 0.3 cos(3 pi u) - 0.3 cos(3 pi v))) with u = 1.6 x1 - 0.5,
    v = 1.6 x2 - 0.5; fmin = -1.59622468 (:153)."""
    x = np.atleast_2d(x)
    u = 1.6 * x[:, 0:1] - 0.5
    v = 1.6 * x[:, 1:2] - 0.5
    fval = 1.0 - (u**2 + v**2 - 0.3 * np.cos(3 * np.pi * u)
                  - 0.3 * np.cos(3 * np.pi * v))
    return -fval


cosines.bounds = [(0.0, 1.0), (0.0, 1.0)]
cosines.fmin = -1.59622468
cosines.xmin = np.array([[0.31426205, 0.30249864]])


def powers(x):
    """Sum-of-powers |x1|^2 + |x2|^3 on [-1,1]^2 (experiments2d.py:333);
    fmin = 0 at the origin."""
    x = np.atleast_2d(x)
    return np.abs(x[:, 0:1]) ** 2 + np.abs(x[:, 1:2]) ** 3


powers.bounds = [(-1.0, 1.0), (-1.0, 1.0)]
powers.fmin = 0.0
powers.xmin = np.array([[0.0, 0.0]])


def alpine2(x, input_dim=None):
    """Alpine-2, N-D on [1,10]^d (experimentsNd.py:39): -prod_i sqrt(x_i) sin(x_i);
    fmin = -2.808^d at x_i ~= 7.917."""
    x = np.atleast_2d(x)
    return -np.prod(np.sqrt(x) * np.sin(x), axis=1, keepdims=True)


alpine2.fmin = None  # -2.808**d, d-dependent (experimentsNd.py:53)


_H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_H6_A = np.array(
    [
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ]
)
_H6_P = 1e-4 * np.array(
    [
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ]
)


def hartmann6(x):
    """Hartmann-6 on [0,1]^6 (standard definition; not in the reference, see
    BASELINE.md); fmin = -3.32237."""
    x = np.atleast_2d(x)
    A = np.asarray(_H6_A, dtype=x.dtype)
    P = np.asarray(_H6_P, dtype=x.dtype)
    alpha = np.asarray(_H6_ALPHA, dtype=x.dtype)
    inner = np.sum(A[None, :, :] * (x[:, None, :] - P[None, :, :]) ** 2, axis=-1)
    return -np.sum(alpha * np.exp(-inner), axis=-1, keepdims=True)


hartmann6.bounds = [(0.0, 1.0)] * 6
hartmann6.fmin = -3.32237
hartmann6.xmin = np.array([[0.20169, 0.150011, 0.476874, 0.275332, 0.311652, 0.6573]])
