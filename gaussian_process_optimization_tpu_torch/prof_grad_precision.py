"""Where the time of the exact GP's backward goes at each gradient precision.

    python -m gaussian_process_optimization_tpu_torch.prof_grad_precision [--n 4096] [--lanes 5]

On the card, at the main path's backward shape: one (lanes, n, n) product as a
float32 GEMM, as TF32, as a bf16 GEMM with bf16 output and with float32
output (``out_dtype``), the bf16 split of its operands, and ``ops/linalg.matmul``
at "high" (bf16x3); then ``tri_inv_lower`` and ``tri_tdot`` of a Cholesky factor,
and ExactCore's backward, at "highest" and at "high". Medians of back-to-back
calls between CUDA events; the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from .config import config, matmul_precision
from .ops import linalg
from .prof_k import time_ms


def _at(precision, fn):
    """``fn`` timed with ``config.grad_matmul_precision`` set."""
    old, config.grad_matmul_precision = config.grad_matmul_precision, precision
    try:
        return time_ms(fn, calls=5, rounds=3)
    finally:
        config.grad_matmul_precision = old


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--lanes", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_grad_precision: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev, n, b = torch.device("cuda"), args.n, args.lanes
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(b, n, n, generator=gen, device=dev)
    B = torch.randn(b, n, n, generator=gen, device=dev)
    Ah, Bh = A.bfloat16(), B.bfloat16()
    rows = {
        "float32 bmm": lambda: A @ B,
        "bf16 bmm, bf16 out": lambda: Ah @ Bh,
        "bf16 bmm, float32 out": lambda: torch.bmm(Ah, Bh, out_dtype=torch.float32),
        "bf16 split of both operands": lambda: (linalg._split_bf16(A), linalg._split_bf16(B)),
        "matmul 'high' (bf16x3)": lambda: linalg.matmul(A, B, "high"),
        "bf16x3 as one bf16 bmm over 3n, float32 out": lambda: torch.bmm(
            torch.cat([Ah, Ah, A.sub(Ah.float()).bfloat16()], -1),
            torch.cat([B.sub(Bh.float()).bfloat16(), Bh, Bh], -2), out_dtype=torch.float32),
    }
    for name, fn in rows.items():
        print(f"{name}: {time_ms(fn, calls=5, rounds=3):.3f} ms")
    try:
        torch.set_float32_matmul_precision("high")
        print(f"TF32 bmm: {time_ms(lambda: A @ B, calls=5, rounds=3):.3f} ms")
    finally:
        torch.set_float32_matmul_precision(matmul_precision())
    flops = 2.0 * b * n ** 3
    print(f"(one product: {flops / 1e9:.1f} GFLOP; 67 TFLOP/s float32 is "
          f"{flops / 67e12 * 1e3:.3f} ms, 989 TFLOP/s bf16 {flops / 989e12 * 1e3:.3f} ms)")

    S = torch.randn(b, n, n, generator=gen, device=dev) / n ** 0.5
    S = S @ S.mT + torch.eye(n, device=dev)
    L = torch.linalg.cholesky(S)
    Li = linalg.tri_inv_lower(L)
    for prec in ("highest", "high"):
        inv = _at(prec, lambda: linalg.tri_inv_lower(L, precision=None if prec == "highest"
                                                     else prec))
        tdot = _at(prec, lambda: linalg.tri_tdot(Li, precision=None if prec == "highest"
                                                 else prec))
        print(f"{prec}: tri_inv_lower {inv:.3f} ms, tri_tdot {tdot:.3f} ms")

    from .models.gp import ExactCore

    Ky = S.clone().requires_grad_(True)
    Yc = torch.randn(b, n, 1, generator=gen, device=dev)
    logdet, quad, *_ = ExactCore.apply(Ky, Yc, None, False)
    loss = (logdet + quad).sum()
    for prec in ("highest", "high"):
        ms = _at(prec, lambda: torch.autograd.grad(loss, Ky, retain_graph=True))
        print(f"{prec}: ExactCore backward {ms:.3f} ms")


if __name__ == "__main__":
    main()
