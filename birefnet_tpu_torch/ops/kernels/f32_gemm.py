"""The f32 GEMM (csrc/f32_gemm.cu) and the f32 row pass (csrc/row_ln.cu),
called alone.

The model reaches both only inside the f32 K1 (`bt_fused_block_attn_f32`:
LN1 rows with the canvas's pad tokens zeroed, the qkv GEMM with the "store"
epilogue, the proj GEMM with "residual") and the f32 K2
(`bt_fused_mlp_f32`: LN2 rows, fc1 with "gelu", fc2 with "residual"),
whose C entries launch them on one stream. These two entries run them on
their own, for the tests and chip_smoke.py, which hold them against their
plain versions; they are the f32 counterparts of ops/kernels/bf16_gemm.py:

- `f32_gemm`: epilogue(a w^T + b) for f32 a [M, K] and a linear's f32
  `weight` [N, K] and `bias` [N], f32 out: "store" (K1's qkv), "residual"
  (res + y: K1's proj and K2's fc2) or "gelu" (the exact GELU, K2's fc1).
  The kernel runs the products on the tensor cores as three TF32 products
  (ops/kernels/tf32.py): it reads the weight's TF32 hi and lo parts
  (`weight_tf32` [2, N, K], added once by params.split_tf32_weights, else
  split at the call) and splits a itself; each product is within about
  1e-6 of the f32 one, and the sums are f32, so it holds the f32 bar of
  the JAX kernels' dots at precision=HIGHEST. PyTorch's TF32 flags do not
  govern it. The plain version is F.linear in f32 plus the epilogue, which
  gives the same function only with those flags off
  (pipeline.make_infer_fn sets them for f32).
- `ln_rows_f32`: LayerNorm of f32 rows with f32 statistics, the pad tokens
  of a canvas zeroed when one is given (K1's LN1); the plain version is
  layers.layer_norm and the pad mask.

Each takes its plain version for a CPU tensor and launches its kernel for a
CUDA tensor or raises; each counts its own launches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import layers as L
from . import build
from .bf16_gemm import EPILOGUES
from .fused_block_attn import Canvas, pad_token_rows
from .tf32 import weight_split_of


def f32_gemm_plain(a: torch.Tensor, params, epilogue: str,
                   res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: y = a w^T + b in f32 for a [M, K], then the epilogue
    (res + y, or the exact GELU F.gelu(y))."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"f32_gemm epilogue {epilogue!r} not in "
                         f"{list(EPILOGUES)}")
    y = F.linear(a, params["weight"]) + params["bias"]
    if epilogue == "residual":
        return res + y
    return F.gelu(y) if epilogue == "gelu" else y


def f32_gemm(a: torch.Tensor, params, epilogue: str,
             res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """epilogue(a W^T + b) for a [M, K] f32 and a linear's `weight` [N, K]
    and `bias` [N] f32: f32 [M, N] ("residual" takes res f32 [M, N])."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"f32_gemm epilogue {epilogue!r} not in "
                         f"{list(EPILOGUES)}")
    if a.device.type == "cpu":
        return f32_gemm_plain(a, params, epilogue, res)
    if a.device.type != "cuda":
        raise ValueError(f"f32_gemm runs on cpu or cuda, got {a.device}")
    m, k = a.shape
    n = params["weight"].shape[0]
    if n % 4 or k % 8:
        raise ValueError(f"f32_gemm needs N % 4 == 0 and K % 8 == 0, got "
                         f"N={n}, K={k}")
    f32, dev = torch.float32, a.device
    check = build.check_tensor
    w = weight_split_of(params)
    check("f32_gemm a", a, f32, (m, k), dev)
    check("f32_gemm weight_tf32", w, f32, (2, n, k), dev)
    check("f32_gemm bias", params["bias"], f32, (n,), dev)
    if epilogue == "residual":
        check("f32_gemm res", res, f32, (m, n), dev)
    out = torch.empty((m, n), device=dev, dtype=f32)
    fn = build.function("bt_f32_gemm", 5, 4)
    code = fn(a.data_ptr(), w.data_ptr(),
              params["bias"].data_ptr(),
              res.data_ptr() if epilogue == "residual" else None,
              out.data_ptr(), m, n, k, EPILOGUES[epilogue], build.stream(dev))
    build.check(code, "f32_gemm")
    f32_gemm.launches += 1
    return out


f32_gemm.launches = 0


def ln_rows_f32_plain(x: torch.Tensor, ln,
                      canvas: Optional[Canvas] = None) -> torch.Tensor:
    """Plain version: LayerNorm(x) of f32 x [T, C], with the pad tokens of
    the canvas zeroed (`canvas`; the rows are [B, Hp, Wp] canvas tokens in
    order)."""
    h = L.layer_norm(ln, x)
    if canvas is None:
        return h
    valid = pad_token_rows(canvas, x.shape[0], x.device)
    return torch.where(valid[:, None], h, torch.zeros((), device=h.device))


def ln_rows_f32(x: torch.Tensor, ln,
                canvas: Optional[Canvas] = None) -> torch.Tensor:
    """The row pass of `ln_rows_f32_plain` on f32 rows [T, C]."""
    if x.device.type == "cpu":
        return ln_rows_f32_plain(x, ln, canvas)
    if x.device.type != "cuda":
        raise ValueError(f"ln_rows_f32 runs on cpu or cuda, got {x.device}")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"ln_rows_f32 takes f32 [T, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    t, c = x.shape
    if c % 4 or c > 8192:
        raise ValueError(f"ln_rows_f32 needs C % 4 == 0 and C <= 8192, got "
                         f"C={c}")
    build.check_tensor("ln_rows_f32 x", x, x.dtype, (t, c), x.device)
    for name in ("scale", "bias"):
        build.check_tensor(f"ln_rows_f32 ln {name}", ln[name], torch.float32,
                           (c,), x.device)
    if canvas is not None and t % (canvas[0] * canvas[1]):
        raise ValueError(f"ln_rows_f32: {t} rows are no whole canvases of "
                         f"{canvas[0]} x {canvas[1]}")
    out = torch.empty_like(x)
    fn = build.function("bt_f32_ln_rows", 4, 8)
    code = fn(x.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(),
              out.data_ptr(), t, c, *(canvas or (0, 0, 0, 0, 0, 0)),
              build.stream(x.device))
    build.check(code, "ln_rows_f32")
    ln_rows_f32.launches += 1
    return out


ln_rows_f32.launches = 0
