"""Times of the covariance kernels B1 (K build) and B2 (K backward) on the card.

    python -m gaussian_process_optimization_tpu_torch.prof_k [--family matern52] [--d 6]

Builds the CUDA kernels, prints nvcc's register and spill report for the
stationary-K kernels of the chosen family, checks each kernel once against its
plain version, and prints medians of back-to-back calls between CUDA events at
the fit shape (5 x 4096 x 4096) and the sweep shape (4096 x 1000), beside the
time the bytes alone need at 3.35 TB/s.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from .ops import _build
from .ops import cuda_kernels as ck


def time_ms(fn, calls=20, rounds=5):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="matern52")
    ap.add_argument("--d", type=int, default=6)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--m", type=int, default=1000)
    ap.add_argument("--wrappers-only", action="store_true",
                    help="time the wrappers only, not the bare launches")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_k: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"build {time.perf_counter() - t0:.2f} s")
    dp = max(4, args.d + args.d % 2) if args.d <= 8 else 8
    tags = (f"ILi{ck.FAMILIES.index(args.family)}ELb", f"ELi{dp}ELb{int(args.d > 8)}")
    lines = path.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and all(t in line for t in tags):
            name = line.split("'")[1]
            print(name[name.index("k_b"):], "|",
                  " ".join(lines[i + 1:i + 4]).replace("ptxas info    :", ""))

    dev, fam, d, n, m = torch.device("cuda"), args.family, args.d, args.n, args.m
    gen = torch.Generator(device=dev).manual_seed(0)
    X = 4 * torch.rand(1, n, d, generator=gen, device=dev) - 2
    C = 4 * torch.rand(1, m, d, generator=gen, device=dev) - 2
    w = max(2 + d, 8)
    p5 = torch.zeros(5, w, device=dev)
    p5[:, 0] = 0.5 + torch.rand(5, generator=gen, device=dev)
    p5[:, 1] = 1.5
    p5[:, 2:2 + d] = (0.5 + 1.5 * torch.rand(5, d, generator=gen, device=dev)) * (d / 6) ** 0.5
    p1 = p5[:1].contiguous()
    G = 2 * torch.rand(5, n, n, generator=gen, device=dev) - 0.5
    Gs = 2 * torch.rand(1, n, m, generator=gen, device=dev) - 0.5
    mb = lambda t: t.numel() * 4 / 3.35e12 * 1e3  # noqa: E731

    for ard in (True, False):
        K = ck.stationary_k_build(X, X, p5, fam, ard)
        want = ck.k_build_plain(X, X, p5, fam, ard)
        err = float((K - want).abs().max())
        print(f"{fam} ard={ard} d={d}: B1 max |kernel - plain| {err:.3e}, "
              f"symmetric {torch.equal(K, K.mT)}")
        # both float32 versions against float64, one lane: max and rms error
        K64 = ck.k_build_plain(X.double(), X.double(), p1.double(), fam, ard)
        for name, K32 in (("kernel", K[:1]), ("plain f32", want[:1])):
            e = K32.double() - K64
            print(f"  B1 {name} - float64: max {float(e.abs().max()):.3e}, "
                  f"rms {float(e.pow(2).mean().sqrt()):.3e}")
        del K, want, K64, e
        dp, _, _ = ck.stationary_k_backward(X, X, p5, G, fam, ard, False, False, True)
        wp, _, _ = ck.k_backward_plain(X.double(), X.double(), p5.double(), G.double(), fam,
                                       ard, False, False, True)
        print(f"  B2 dparams rel err {float((dp - wp).abs().max() / wp.abs().max()):.3e}")
        del wp
        rows = [
            ("B1 fit 5xNxN", lambda: ck.stationary_k_build(X, X, p5, fam, ard), mb(G)),
            ("B1 sweep NxM", lambda: ck.stationary_k_build(X, C, p1, fam, ard), mb(Gs)),
            ("B2 fit params", lambda: ck.stationary_k_backward(
                X, X, p5, G, fam, ard, False, False, True), mb(G)),
            ("B2 fit params+dX", lambda: ck.stationary_k_backward(
                X, X, p5, G, fam, ard, True, False, True), mb(G)),
            ("B2 fit dZ", lambda: ck.stationary_k_backward(
                X, X, p5, G, fam, ard, False, True, False), mb(G)),
            ("B2 sweep params+dX", lambda: ck.stationary_k_backward(
                X, C, p1, Gs, fam, ard, True, False, True), mb(Gs)),
            ("B2 sweep dZ", lambda: ck.stationary_k_backward(
                X, C, p1, Gs, fam, ard, False, True, False), mb(Gs)),
        ]
        for name, fn, bound in rows:
            print(f"  {name}: {time_ms(fn):.4f} ms (bytes alone {bound:.4f} ms)")
        if args.wrappers_only:
            continue
        # the launches alone, on buffers made once: no wrapper work on the host
        lib, fi, st = _build.library(), ck.FAMILIES.index(fam), torch.cuda.current_stream().cuda_stream
        Xp = ck._padded(X)
        w_, dp_ = p5.shape[1], Xp.shape[-1]
        out = torch.empty(5, n, n, device=dev)
        t_rows = lib.gpo_bwd_partial_rows(5, n, n, 0)
        part = torch.empty(5, t_rows, w_, device=dev)
        print(f"  launch alone, B1 fit: " + format(time_ms(lambda: lib.gpo_stationary_k(
            Xp.data_ptr(), Xp.data_ptr(), p5.data_ptr(), out.data_ptr(), 5, n, n, d, dp_, w_,
            0, 0, fi, int(ard), st)), ".4f") + " ms")
        print(f"  launch alone, B2 fit params ({t_rows} partial rows): " + format(time_ms(
            lambda: lib.gpo_stationary_k_bwd_rows(
                Xp.data_ptr(), Xp.data_ptr(), p5.data_ptr(), G.data_ptr(), None,
                part.data_ptr(), 5, n, n, d, dp_, w_, 0, 0, n * n, n, 1, fi, int(ard), st)),
            ".4f") + " ms")
        del out, part


if __name__ == "__main__":
    main()
