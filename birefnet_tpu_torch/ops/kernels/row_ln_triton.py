"""Triton source of the row LayerNorm kernel (see row_ln.py).

This module imports triton at its top, so only row_ln's launching function
imports it, at the first launch on a CUDA tensor; the package itself never
does.
"""

import triton
import triton.language as tl


@triton.jit
def row_ln_kernel(x_ptr, g_ptr, b_ptr, y_ptr, n_rows, n_cols, eps,
                  BLOCK_C: tl.constexpr, ROWS: tl.constexpr):
    """One program normalizes ROWS rows of an [n_rows, n_cols] matrix:
    f32 mean and variance, eps inside the rsqrt, f32 affine, cast back."""
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < n_cols
    mask = (rows < n_rows)[:, None] & cmask[None, :]
    offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / n_cols
    d = tl.where(mask, x - mean[:, None], 0.0)
    var = tl.sum(d * d, axis=1) / n_cols
    rstd = 1.0 / tl.sqrt(var + eps)
    g = tl.load(g_ptr + cols, mask=cmask, other=0.0)
    b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
    y = d * rstd[:, None] * g[None, :] + b[None, :]
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)
