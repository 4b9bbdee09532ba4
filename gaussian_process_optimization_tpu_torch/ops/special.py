"""Special functions torch lacks for complex arguments: the Faddeeva function
w(z) and the complex error function erf(z) (twin of
``gaussian_process_optimization_tpu/ops/special.py``).

The second-order latent-force kernel (``kernels/lfm.py`` EQ_ODE2) evaluates
first-order closed forms at complex decay rates, so erf of complex arguments
appears; ``torch.special.erf`` takes real arguments only.

w(z) is Weideman's rational approximation (SIAM Rev. 36(4), 1994, "cef"): one
polynomial in (L + iz) / (L - iz), accurate to ~1e-13 on the closed upper
half-plane for N = 64 terms. The coefficients are this module's own numpy FFT
at import (the reference's recipe, computed here, not imported). The complex
dtype follows the real one: complex128 for float64, complex64 for float32 (the
reference's ``complex128`` request under float32 on its accelerator).

:class:`Wofz` evaluates the polynomial without a graph and differentiates with
the Faddeeva function's own derivative, w'(z) = -2 z w(z) + 2i / sqrt(pi): a
graph through the 64 Horner steps would keep 64 complex buffers of the
argument's size per call.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_N = 64
_SQRT_PI = math.sqrt(math.pi)


def _weideman_coeffs(N=_N):
    M = 2 * N
    M2 = 2 * M
    k = np.arange(-M + 1, M)
    L = np.sqrt(N / np.sqrt(2.0))
    theta = k * np.pi / M
    t = L * np.tan(theta / 2.0)
    f = np.exp(-(t**2)) * (L**2 + t**2)
    f = np.append(0.0, f)
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / M2
    a = np.flipud(a[1: N + 1])
    return float(L), a


_L, _A = _weideman_coeffs()


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype of a real (or complex) one."""
    if dtype in (torch.float64, torch.complex128):
        return torch.complex128
    return torch.complex64


def as_complex(z) -> torch.Tensor:
    z = torch.as_tensor(z)
    return z if z.is_complex() else z.to(complex_dtype(z.dtype))


def _wofz_value(z):
    iz = 1j * z
    Z = (_L + iz) / (_L - iz)
    p = torch.zeros_like(z)
    for a in _A:  # numpy polyval order: highest power first
        p = p * Z + float(a)
    return 2.0 * p / (_L - iz) ** 2 + (1.0 / _SQRT_PI) / (_L - iz)


class Wofz(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(z):
        return _wofz_value(z)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, grad):
        z, w = ctx.saved_tensors
        dw = -2.0 * z * w + 2j / _SQRT_PI
        # a holomorphic function's pullback: grad * conj(f'(z))
        return grad * dw.conj()


def wofz(z):
    """Faddeeva w(z) = exp(-z^2) erfc(-iz), valid for Im(z) >= 0."""
    return Wofz.apply(as_complex(z))


def cerf(z):
    """erf for complex arguments via w(z), odd-extended to Re(z) < 0."""
    z = as_complex(z)
    flip = z.real < 0
    zp = torch.where(flip, -z, z)  # Re(zp) >= 0 -> Im(i zp) >= 0 for wofz
    val = 1.0 - torch.exp(-(zp**2)) * wofz(1j * zp)
    return torch.where(flip, -val, val)
