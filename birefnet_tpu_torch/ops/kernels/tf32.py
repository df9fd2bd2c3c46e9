"""The three-product TF32 split of the f32 kernel tier (csrc/f32_gemm.cu and
csrc/window_core_f32.cuh), in plain PyTorch.

The f32 kernels compute their products on the H100's tensor cores, which
take TF32 operands (10 explicit significand bits). Each f32 operand x is
split as

    hi = tf32(x)               (round to nearest, ties away from zero:
                                what cvt.rna.tf32.f32 gives)
    lo = x - hi                (exact in f32; the tensor cores read its
                                top 19 bits, lo truncated to TF32)

and a product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, each
TF32 x TF32 product exact in the f32 accumulator (11 x 11 significand
bits). What is dropped is lo_a lo_b (at most 2^-22 |a b|) and the
truncation of the lo parts (at most 2^-21 |a b| each): about 1e-6
relative per product, with random sign, where one TF32 product is off by
up to 2^-11. On a TPU, precision=HIGHEST (the JAX kernels' f32 contract)
is the same kind of multi-pass split, into bf16 pieces.

This module holds the split itself (`tf32_round`, `tf32_split`), the
weight layout the f32 GEMM reads (`split_weight`, `weight_split_of`), and
emulations of the kernels' arithmetic for the CPU tests: `linear_split`
and `window_attention_split` with passes=3 (the kernels) or passes=1 (one
TF32 product, the control that must miss the f32 bar).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_SIGN = -(1 << 31)          # 0x80000000 as an int32
_MAG = (1 << 31) - 1        # 0x7fffffff
_INF = 0x7F800000
_HALF = 1 << 12             # half of the last TF32 significand bit
_KEEP = ~((1 << 13) - 1)    # clears the 13 bits TF32 drops


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as cvt.rna.tf32.f32 rounds it: the magnitude
    to 10 significand bits, ties away from zero, the 13 low bits zero.
    Infinities and NaNs pass unchanged; |x| within half a TF32 step of the
    f32 maximum rounds to infinity."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes f32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    mag = bits & _MAG
    rounded = ((mag + _HALF) & _KEEP) | (bits & _SIGN)
    return torch.where(mag >= _INF, bits, rounded).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) with hi = tf32_round(x) and lo = x - hi, exact in f32, so
    hi + lo == x for every finite x below the rounding-to-infinity edge."""
    hi = tf32_round(x)
    return hi, x - hi


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """f32 x as the tensor cores read a TF32 operand: the 13 low bits
    dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & _KEEP).view(torch.float32)


def split_weight(w: torch.Tensor) -> torch.Tensor:
    """A linear's f32 weight [N, K] as the f32 GEMM reads it: [2, N, K],
    hi = tf32_round(w) then lo = w - hi."""
    return torch.stack(tf32_split(w.float())).contiguous()


def weight_split_of(linear) -> torch.Tensor:
    """The linear's `weight_tf32` (params.split_tf32_weights adds it once
    where the tree is prepared), else its weight split now."""
    w = linear.get("weight_tf32")
    return w if w is not None else split_weight(linear["weight"])


def matmul_split(x: torch.Tensor, y: torch.Tensor, passes: int = 3):
    """x @ y in f32 from TF32 pieces: passes=3 sums the small products
    first, (lo_x hi_y + hi_x lo_y) + hi_x hi_y, the lo parts truncated to
    TF32 as the tensor cores read them; passes=1 is one TF32 product."""
    if passes == 1:
        return tf32_round(x) @ tf32_round(y)
    if passes != 3:
        raise ValueError(f"passes is 1 or 3, got {passes}")
    xh, xl = tf32_split(x)
    yh, yl = tf32_split(y)
    return (tf32_truncate(xl) @ yh + xh @ tf32_truncate(yl)) + xh @ yh


def linear_split(a: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 passes: int = 3) -> torch.Tensor:
    """F.linear(a, weight, bias) with the product from TF32 pieces."""
    y = matmul_split(a, weight.t(), passes)
    return y if bias is None else y + bias


def window_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           addend: torch.Tensor,
                           passes: int = 3) -> torch.Tensor:
    """The f32 core on [B_, heads, N, d]: softmax(q s k^T + addend) v with
    s = f32(d^-0.5) and both products from TF32 pieces; `addend` is the
    f32 bias and mask, summed, broadcast to [B_, heads, N, N]."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=torch.float32)
    s = matmul_split(q * scale, k.transpose(-1, -2), passes) + addend
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return matmul_split(p, v, passes)


def mlp_residual_split(x: torch.Tensor, norm2_params, mlp_params,
                       passes: int = 3) -> torch.Tensor:
    """The f32 K2 with its two products from TF32 pieces: LN2 in f32, fc1
    + b1, the exact GELU, fc2 + b2, + x."""
    fc1, fc2 = mlp_params["fc1"], mlp_params["fc2"]
    h = F.layer_norm(x, (x.shape[-1],), norm2_params["scale"],
                     norm2_params["bias"], 1e-5)
    h = F.gelu(linear_split(h, fc1["weight"], fc1["bias"], passes))
    return x + linear_split(h, fc2["weight"], fc2["bias"], passes)
