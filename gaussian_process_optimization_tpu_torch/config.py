"""Global runtime configuration (twin of ``gaussian_process_optimization_tpu/config.py``).

The numeric floors and the jitter-ladder shape are the reference's. Kernel routing
mirrors its ``use_pallas`` / ``pallas_tri_inv`` / ``pallas_chol_blocks`` switches:
``'auto'`` routes a call into the hand-written CUDA kernels when the tensor it
gets lies on a CUDA device. :func:`resolve_device` gives every entry point its
device: the card unless the caller names another, and :func:`resolve_dtype` its
dtype: float32 on the card, float64 on the CPU.

Importing this module pins float32 matmuls to full precision: TF32 keeps ~10
mantissa bits, and the reference pins its matmuls to full f32 because reduced
precision moved regret. The reference's gradient-only ``grad_matmul_precision``
knob (a bf16x3 TPU setting) has no counterpart: gradients run in full f32.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass
class Config:
    # 'auto': launch the CUDA kernels for tensors on a CUDA device. True sends
    # every gated call through the kernel wrappers (which take their plain
    # PyTorch versions for CPU tensors, like the reference's interpret mode).
    use_cuda_kernels: Literal["auto", True, False] = "auto"
    # sigma^2 + 1e-8 on the Gram diagonal (GPy exact_gaussian_inference.py:52)
    noise_jitter: float = 1e-8
    # jitchol ladder: first jitter = mean(diag)*base, then *10 each try
    jitchol_base: float = 1e-6
    jitchol_maxtries: int = 5
    # predictive-variance floor (GPyOpt gpmodel.py:99)
    variance_floor: float = 1e-10
    # float32-only minimum effective noise on the Gram diagonal
    f32_noise_floor: float = 1e-4
    # acquisition std floor (GPyOpt util/general.py:121)
    std_floor: float = 1e-10
    # route tri_inv_lower's diagonal blocks into the triangular-inverse kernel
    cuda_tri_inv: bool = True
    # factor each jitter-ladder attempt (n >= 2 * 256) by blocked_cholesky, its
    # diagonal blocks in the batched Cholesky kernel; off, as the reference's
    # pallas_chol_blocks is: the full-size cholesky_ex
    cuda_chol_blocks: bool = False


config = Config()


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: ``device`` if given, else the card.
    With no CUDA device a bare call raises rather than run on the CPU; pass
    ``device="cpu"`` for that."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU unless asked "
                           "otherwise; pass device='cpu' to build on the CPU")
    return torch.device("cuda")


def resolve_dtype(dtype=None, device=None) -> torch.dtype:
    """The dtype an entry point builds in: ``dtype`` if given, else float32 on
    a CUDA device (the JAX package's dtype on its accelerator, and the one the
    CUDA kernels take) and float64 elsewhere (the CPU parity tests' dtype)."""
    if dtype is not None:
        return dtype
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def kernels_enabled(t: torch.Tensor) -> bool:
    """Resolve ``use_cuda_kernels`` for a tensor (the ``pallas_enabled`` twin)."""
    if config.use_cuda_kernels == "auto":
        return t.is_cuda
    return bool(config.use_cuda_kernels)
