#!/usr/bin/env python3
"""Model of the f32 GEMM's accumulation error on the tensor cores (numpy).

    python3 tools/tf32_accum_model.py [--k 6144]

The H100's tensor cores take TF32 (or bf16) products exactly but add them
into their f32 accumulators with truncation (rounding toward zero) at
every MMA step. Over a long k loop that rounding is biased, and the error
of three-TF32-product (3xTF32) sums grows with the number of steps into
one accumulator. This script models one rounding toward zero per k8 MMA
step (k16 for bf16) and prints mean|y - exact| / mean|exact| for a
[256, K] x [K, 64] product of normal operands, the weights scaled by
K^-0.5 as in csrc/f32_gemm.cu's tests:

- sequential f32 sums rounded to nearest (what an FFMA loop or cuBLAS's
  f32 GEMM does);
- 3xTF32 into one accumulator (lo_a hi_b, hi_a lo_b, hi_a hi_b per k8);
- 3xTF32 with the small products in a second accumulator;
- 3xTF32 with a fresh accumulator per k step of 32, 64 or 128 values,
  each added to the sums in f32 rounded to nearest (csrc/f32_gemm.cu
  folds every 32);
- one TF32 product (the control of the f32 gate);
- bf16 operands into one accumulator per k16 step, next to the bf16
  GEMM's measured error on the card (PERF.md).

The lo parts are passed untruncated, as the kernels pass them; the model
truncates them to TF32 as the tensor cores read them. Runs on the CPU in
a few seconds; no GPU is involved.
"""

import argparse

import numpy as np


def rz32(x: np.ndarray) -> np.ndarray:
    """float64 x rounded to f32 toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def bits(x, keep, half=0):
    u = x.astype(np.float32).view(np.uint32)
    mag = (u & np.uint32(0x7FFFFFFF)) + np.uint32(half)
    return ((mag & np.uint32(keep)) | (u & np.uint32(0x80000000))).view(np.float32)


def tf32_round(x):
    return bits(x, 0xFFFFE000, 0x1000)


def tf32_trunc(x):
    return bits(x, 0xFFFFE000)


def bf16_round(x):
    u = x.astype(np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def tensor_core_sum(pairs, k, step, fold=None):
    """Sum of the products in `pairs` (list of (A, B) of [M, K] and [N, K])
    with one rounding toward zero per `step` of k per product, into a fresh
    accumulator every `fold` values (added in f32, to nearest)."""
    m, n = pairs[0][0].shape[0], pairs[0][1].shape[0]
    total = np.zeros((m, n), np.float32)
    fold = fold or k
    for k0 in range(0, k, fold):
        acc = np.zeros((m, n), np.float32)
        for s in range(k0, k0 + fold, step):
            for a, b in pairs:
                acc = rz32(acc.astype(np.float64)
                           + a[:, s:s + step].astype(np.float64)
                           @ b[:, s:s + step].T.astype(np.float64))
        total = (total + acc).astype(np.float32)
    return total


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--k", type=int, default=6144)
    k = parser.parse_args().k
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, k)).astype(np.float32)
    w = (rng.standard_normal((64, k)) * k ** -0.5).astype(np.float32)
    exact = a.astype(np.float64) @ w.T.astype(np.float64)

    def err(y, ref=exact):
        return np.abs(y - ref).mean() / np.abs(ref).mean()

    seq = np.zeros((256, 64), np.float32)
    for s in range(k):
        seq = (seq + a[:, s:s + 1] * w[:, s][None]).astype(np.float32)
    ah, wh = tf32_round(a), tf32_round(w)
    al, wl = tf32_trunc(a - ah), tf32_trunc(w - wh)
    three = [(al, wh), (ah, wl), (ah, wh)]
    rows = [("sequential f32, rounded to nearest", seq),
            ("3xTF32, one accumulator", tensor_core_sum(three, k, 8)),
            ("3xTF32, small products apart",
             tensor_core_sum([(ah, wh)], k, 8)
             + tensor_core_sum([(al, wh), (ah, wl)], k, 8))]
    for fold in (32, 64, 128):
        rows.append((f"3xTF32, fresh accumulator every {fold}",
                     tensor_core_sum(three, k, 8, fold)))
    rows.append(("one TF32 product", tensor_core_sum([(ah, wh)], k, 8)))
    print(f"[tf32_accum_model] [256, {k}] x [{k}, 64]: mean|y - exact| / "
          f"mean|exact| (toward-zero rounding per tensor-core step)")
    for label, y in rows:
        print(f"  {label:<42} {err(y):.3e}   vs sequential f32 {err(y, seq):.3e}")
    ab, wb = bf16_round(a), bf16_round(w)
    exact_b = ab.astype(np.float64) @ wb.T.astype(np.float64)
    print(f"  {'bf16 operands, one accumulator (k16)':<42} "
          f"{err(tensor_core_sum([(ab, wb)], k, 16), exact_b):.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
