"""Global runtime configuration (twin of ``gaussian_process_optimization_tpu/config.py``).

The numeric floors and the jitter-ladder shape are the reference's. Kernel routing
mirrors its ``use_pallas`` / ``pallas_tri_inv`` / ``pallas_chol_blocks`` switches:
``'auto'`` routes a call into the hand-written CUDA kernels when the tensor it
gets lies on a CUDA device. :func:`resolve_device` gives every entry point its
device: the card unless the caller names another, and :func:`resolve_dtype` its
dtype: float32 on the card, float64 on the CPU.

Importing this module pins float32 matmuls to full precision, as importing the
reference pins ``jax_default_matmul_precision``: reduced precision moved regret
there. The reference's two switches of that pin map to torch's nearest idiom,
:func:`matmul_precision`. The gradient-only ``grad_matmul_precision`` (the
exact GP's backward matmuls in bf16x3, ``ops/linalg.matmul``) is a field below.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Literal

import torch

# the reference's jax_default_matmul_precision names -> torch's float32 matmul
# precision
_PRECISIONS = {"highest": "highest", "float32": "highest",
               "high": "high", "tensorfloat32": "high", "bfloat16_3x": "high",
               "default": "medium", "bfloat16": "medium", "fastest": "medium"}


def matmul_precision() -> str:
    """The global float32 matmul precision from the reference's environment
    variables (its ``__init__.py``): none set pins "highest";
    ``GPO_TPU_MATMUL_PRECISION=high`` gives torch's "high", which on the card is
    TF32 (10 explicit mantissa bits, where the TPU's bf16x3 keeps about 16);
    ``GPO_TPU_FAST_MATMUL`` gives "medium", torch's name for a bf16 pass (the
    TPU's own single pass), which cuBLAS runs as TF32 on the card: a 4096^2
    product reads the same error under "high" and "medium" there
    (``chip_smoke.py`` phase 4b)."""
    if os.environ.get("GPO_TPU_FAST_MATMUL"):
        return "medium"
    name = os.environ.get("GPO_TPU_MATMUL_PRECISION", "highest")
    if name not in _PRECISIONS:
        raise ValueError(f"GPO_TPU_MATMUL_PRECISION={name!r}: one of {sorted(_PRECISIONS)}")
    return _PRECISIONS[name]


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision(matmul_precision())


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
    # Matmul precision of the exact GP's backward only (ExactCore.backward:
    # tri_inv_lower's merge products, tri_tdot, Li^T t and alpha alpha^T):
    # "highest" (float32) or "high" (bf16x3: each float32 operand split into
    # two bf16 parts, three bf16 products summed in float32, ~16 mantissa
    # bits). The reference defaults to "high"; the port to "highest", for
    # three reasons: JAX on the CPU ignores the precision, so the two packages
    # agree there already; every reduced-precision knob stays opt-in behind the
    # regret gate (ROADMAP); and the card's float32 gates (chip_smoke.py) were
    # set at full precision. GPO_GRAD_MATMUL_PRECISION=high opts in.
    grad_matmul_precision: str = os.environ.get("GPO_GRAD_MATMUL_PRECISION", "highest")
    # the line search's warm-start growth after a backtracked accept (the
    # Fitter's default grow_backtracked; ops/lbfgs.py); 1.0 is the hold
    # policy, which moved regret in the reference's A/B, so 2.0 stays
    ls_grow_backtracked: float = float(os.environ.get("GPO_LS_GROW_BACKTRACKED", "2.0"))


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
