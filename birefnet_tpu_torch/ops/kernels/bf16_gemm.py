"""The bf16 GEMM (csrc/bf16_gemm.cu) and the bf16 row pass (csrc/row_ln.cu),
called alone.

The model reaches both only inside K1 (`bt_fused_block_attn_bf16`: LN1
rows with the canvas's pad tokens zeroed, the qkv GEMM with the "store"
epilogue, the proj GEMM with "residual") and K2 (`bt_fused_mlp_bf16`: LN2
rows, fc1 with "gelu", fc2 with "residual"), whose C entries launch them
on one stream. These two entries run them on their own, for the tests and
chip_smoke.py, which hold them against their plain versions:

- `bf16_gemm`: epilogue(a w^T + b) for bf16 a [M, K] and a linear's bf16
  `weight` [N, K] and f32 `bias` [N], bf16 out: "store" (bf16(y), K1's
  qkv), "residual" (res + bf16(y), K1's proj and K2's fc2) or "gelu"
  (bf16 of the 3-term erf GELU of y in f32, K2's fc1). The plain version
  is F.linear in f32 of the bf16 operands plus the epilogue; the kernel
  sums in f32 in another order, so the two differ where a sum lands near
  a bf16 rounding boundary.
- `ln_rows`: bf16(LayerNorm(x)) of bf16 rows, with the pad tokens of a
  canvas zeroed when one is given (K1's LN1); the plain version is
  layers.layer_norm, the pad mask, bf16.

Each takes its plain version for a CPU tensor and launches its kernel for a
CUDA tensor or raises; each counts its own launches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import layers as L
from .. import quant
from . import build
from .fused_block_attn import Canvas, pad_token_rows

EPILOGUES = {"store": 0, "residual": 1, "gelu": 2}


def bf16_gemm_plain(a: torch.Tensor, params, epilogue: str,
                    res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: y = a w^T + b in f32 for a [M, K], then the epilogue,
    bf16 out."""
    y = F.linear(a.float(), params["weight"].float()) + params["bias"].float()
    if epilogue == "store":
        return y.to(torch.bfloat16)
    if epilogue == "residual":
        return res + y.to(torch.bfloat16)
    if epilogue == "gelu":
        return quant.gelu_erf3(y).to(torch.bfloat16)
    raise ValueError(f"bf16_gemm epilogue {epilogue!r} not in {list(EPILOGUES)}")


def bf16_gemm(a: torch.Tensor, params, epilogue: str,
              res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """epilogue(a W^T + b) for a [M, K] bf16 and a linear's `weight` [N, K]
    bf16 and `bias` [N] f32: bf16 [M, N] ("residual" takes res bf16
    [M, N])."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"bf16_gemm epilogue {epilogue!r} not in "
                         f"{list(EPILOGUES)}")
    if a.device.type == "cpu":
        return bf16_gemm_plain(a, params, epilogue, res)
    if a.device.type != "cuda":
        raise ValueError(f"bf16_gemm runs on cpu or cuda, got {a.device}")
    build.refuse_grad("bf16_gemm", a, params, res)
    m, k = a.shape
    n = params["weight"].shape[0]
    if n % 8 or k % 8:
        raise ValueError(f"bf16_gemm needs N % 8 == 0 and K % 8 == 0, got "
                         f"N={n}, K={k}")
    bf, dev = torch.bfloat16, a.device
    check = build.check_tensor
    check("bf16_gemm a", a, bf, (m, k), dev)
    check("bf16_gemm weight", params["weight"], bf, (n, k), dev)
    check("bf16_gemm bias", params["bias"], torch.float32, (n,), dev)
    if epilogue == "residual":
        check("bf16_gemm res", res, bf, (m, n), dev)
    out = torch.empty((m, n), device=dev, dtype=bf)
    fn = build.function("bt_bf16_gemm", 5, 4)
    code = fn(a.data_ptr(), params["weight"].data_ptr(),
              params["bias"].data_ptr(),
              res.data_ptr() if epilogue == "residual" else None,
              out.data_ptr(), m, n, k, EPILOGUES[epilogue], build.stream(dev))
    build.check(code, "bf16_gemm")
    bf16_gemm.launches += 1
    return out


bf16_gemm.launches = 0


def ln_rows_plain(x: torch.Tensor, ln,
                  canvas: Optional[Canvas] = None) -> torch.Tensor:
    """Plain version: bf16(LayerNorm(x)) of x [T, C] (f32 statistics), with
    the pad tokens of the canvas zeroed (`canvas`; the rows are
    [B, Hp, Wp] canvas tokens in order)."""
    h = L.layer_norm(ln, x)
    if canvas is not None:
        valid = pad_token_rows(canvas, x.shape[0], x.device)
        h = torch.where(valid[:, None], h, torch.zeros((), dtype=h.dtype,
                                                      device=h.device))
    return h.to(torch.bfloat16)


def ln_rows(x: torch.Tensor, ln,
            canvas: Optional[Canvas] = None) -> torch.Tensor:
    """The row pass of `ln_rows_plain` on bf16 rows [T, C]."""
    if x.device.type == "cpu":
        return ln_rows_plain(x, ln, canvas)
    if x.device.type != "cuda":
        raise ValueError(f"ln_rows runs on cpu or cuda, got {x.device}")
    build.refuse_grad("ln_rows", x, ln)
    if x.ndim != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"ln_rows takes bf16 [T, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    t, c = x.shape
    if c % 8:
        raise ValueError(f"ln_rows needs C % 8 == 0, got C={c}")
    build.check_tensor("ln_rows x", x, x.dtype, (t, c), x.device)
    for name in ("scale", "bias"):
        build.check_tensor(f"ln_rows ln {name}", ln[name], torch.float32,
                           (c,), x.device)
    if canvas is not None and t % (canvas[0] * canvas[1]):
        raise ValueError(f"ln_rows: {t} rows are no whole canvases of "
                         f"{canvas[0]} x {canvas[1]}")
    out = torch.empty_like(x)
    fn = build.function("bt_bf16_ln_rows", 4, 8)
    code = fn(x.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(),
              out.data_ptr(), t, c, *(canvas or (0, 0, 0, 0, 0, 0)),
              build.stream(x.device))
    build.check(code, "ln_rows")
    ln_rows.launches += 1
    return out


ln_rows.launches = 0
