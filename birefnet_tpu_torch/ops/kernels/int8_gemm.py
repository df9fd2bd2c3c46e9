"""The int8 GEMM and the int8 row pass of csrc/int8_gemm.cu, called alone.

The model reaches the GEMM only inside K1-int8 (`bt_fused_block_attn_i8`,
`bt_fused_block_attn_i8_f32`) and the row pass inside K1-int8 and K3
(`bt_fused_mlp_i8[_f32]`: its LN2 codes), whose C entries launch them on
one stream. These two entries run them on their own, for the tests and
chip_smoke.py, which hold them bit for bit against their plain versions:

- `int8_gemm`: epilogue(acc * (sx * sw) + bias) with acc = q w_q8^T exact,
  the epilogue one of "bf16" (round to bf16, K1-int8's qkv), "f32" (y
  unrounded, K1-int8's qkv on f32 activations) or "residual" (res +
  y rounded to res's dtype: bf16(res + bf16(y)), K1-int8's proj, or res +
  y in f32 for an f32 res); the plain version is ops/quant.py::int8_linear
  cast the same way. Its plain version also takes "gelu" (the 3-term erf
  GELU in f32, f32 out): the fc1 step of K3's plain chain, which runs on
  the card only inside K3's cluster kernel (csrc/fused_mlp_i8.cu), so a
  CUDA tensor with "gelu" is refused.
- `quantize_rows`: per-token int8 codes and scales of bf16 or f32 x (K1-
  int8's attention rows), of LayerNorm(x) (K3's LN2) or of x.dtype(
  LayerNorm(x) with the canvas's pad tokens zeroed) (K1-int8's LN1: bf16
  rows are rounded to bf16, f32 rows not at all); the plain version is
  ops/quant.py::quantize_rows after the same steps, its LayerNorm with the
  kernel's f32 statistics (sum / K, then the mean square of x - mean).
- `ln_code_flips`: the row pass's LN codes against the model's plain path
  (F.layer_norm, then quantize_rows): how many differ, and by how much.

Each takes its plain version for a CPU tensor and launches its kernel for a
CUDA tensor or raises; each counts its own launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import layers as L
from .. import quant
from . import build
from .fused_block_attn import Canvas, pad_token_rows

EPILOGUES = ("bf16", "f32", "residual", "gelu")
# The epilogues the CUDA GEMM runs, by its Epilogue (csrc/common.cuh:
# kStore 0, kResidual 1); csrc/int8_gemm.cu instantiates each for bf16 and
# f32 outputs.
KERNEL_EPILOGUES = {"bf16": 0, "f32": 0, "residual": 1}


def int8_gemm_plain(q: torch.Tensor, sx: torch.Tensor, params, epilogue: str,
                    res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: int8_linear(q, sx) for q [M, K] int8 and sx [M, 1] f32,
    then the epilogue."""
    y = quant.int8_linear(q, sx, params)
    if epilogue == "bf16":
        return y.to(torch.bfloat16)
    if epilogue == "f32":
        return y
    if epilogue == "residual":
        return res + y.to(res.dtype)
    if epilogue == "gelu":
        return quant.gelu_erf3(y)
    raise ValueError(f"int8_gemm epilogue {epilogue!r} not in {list(EPILOGUES)}")


def int8_gemm(q: torch.Tensor, sx: torch.Tensor, params, epilogue: str,
              res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """epilogue(q W^T dequantized) for q [M, K] int8, sx [M, 1] f32 and a
    linear's `weight_q8` [N, K], `scale_q8` [N], `bias` [N]: [M, N] bf16
    ("bf16"), f32 ("f32"), of res's dtype ("residual" with res bf16 or f32
    [M, N]) or, on the CPU only, f32 ("gelu")."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"int8_gemm epilogue {epilogue!r} not in "
                         f"{list(EPILOGUES)}")
    if q.device.type == "cpu":
        return int8_gemm_plain(q, sx, params, epilogue, res)
    if q.device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cpu or cuda, got {q.device}")
    if epilogue not in KERNEL_EPILOGUES:
        raise ValueError(f"int8_gemm kernel epilogue {epilogue!r} not in "
                         f"{list(KERNEL_EPILOGUES)}: K3's GELU runs inside "
                         f"its cluster kernel")
    m, k = q.shape
    n = params["weight_q8"].shape[0]
    if n % 8 or k % 16:
        raise ValueError(f"int8_gemm needs N % 8 == 0 and K % 16 == 0, got "
                         f"N={n}, K={k}")
    f32, dev = torch.float32, q.device
    check = build.check_tensor
    check("int8_gemm q", q, torch.int8, (m, k), dev)
    check("int8_gemm sx", sx, f32, (m, 1), dev)
    check("int8_gemm weight_q8", params["weight_q8"], torch.int8, (n, k), dev)
    check("int8_gemm scale_q8", params["scale_q8"], f32, (n,), dev)
    check("int8_gemm bias", params["bias"], f32, (n,), dev)
    out_dtype = {"bf16": torch.bfloat16, "f32": f32}.get(
        epilogue, None if res is None else res.dtype)
    if epilogue == "residual":
        if out_dtype not in (torch.bfloat16, f32):
            raise ValueError(f"int8_gemm residual takes a bf16 or f32 res, got "
                             f"{None if res is None else res.dtype}")
        check("int8_gemm res", res, out_dtype, (m, n), dev)
    out = torch.empty((m, n), device=dev, dtype=out_dtype)
    fn = build.function("bt_i8_gemm", 7, 5)
    code = fn(q.data_ptr(), sx.data_ptr(), params["weight_q8"].data_ptr(),
              params["scale_q8"].data_ptr(), params["bias"].data_ptr(),
              res.data_ptr() if epilogue == "residual" else None,
              out.data_ptr(), m, n, k, KERNEL_EPILOGUES[epilogue],
              int(out_dtype == f32), build.stream(dev))
    build.check(code, "int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def layer_norm_rows_f32(ln, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm of f32 rows [T, K] with the row pass's statistics: mean =
    sum / K, rstd = rsqrt(sum((x - mean)^2) / K + 1e-5), then
    (x - mean) * rstd * scale + bias, each step rounded to f32. The sums
    are divided by a tensor of K: PyTorch multiplies by a rounded 1/K when
    the divisor is a Python number, which is not the kernel's division."""
    s = x.sum(-1, keepdim=True)
    k = torch.full_like(s, x.shape[-1])
    mean = s / k
    d = x - mean
    rstd = torch.rsqrt((d * d).sum(-1, keepdim=True) / k + 1e-5)
    return d * rstd * ln["scale"] + ln["bias"]


def quantize_rows_plain(x: torch.Tensor, ln=None,
                        canvas: Optional[Canvas] = None):
    """Plain version: (int8 codes [T, K], f32 scales [T, 1]) of the rows of
    x [T, K]: of x itself, of LayerNorm(x) (`ln`), or of LayerNorm(x) with
    the pad tokens of the canvas zeroed, rounded to x.dtype (`ln` and
    `canvas`; the rows are [B, Hp, Wp] canvas tokens in order), as the JAX
    kernel's h.astype(tokens.dtype)."""
    h = x.float()
    if ln is not None:
        h = layer_norm_rows_f32(ln, h)
    if canvas is not None:
        valid = pad_token_rows(canvas, x.shape[0], x.device)
        h = torch.where(valid[:, None], h, torch.zeros((), device=h.device))
        h = h.to(x.dtype).float()
    return quant.quantize_rows(h)


def quantize_rows(x: torch.Tensor, ln=None, canvas: Optional[Canvas] = None):
    """The row pass of `quantize_rows_plain` on bf16 or f32 rows, in every
    form."""
    if canvas is not None and ln is None:
        raise ValueError("quantize_rows: a canvas needs the LayerNorm")
    if x.device.type == "cpu":
        return quantize_rows_plain(x, ln, canvas)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows runs on cpu or cuda, got {x.device}")
    if x.ndim != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantize_rows kernel takes bf16 or f32 [T, K], got "
                         f"{x.dtype} {tuple(x.shape)}")
    t, k = x.shape
    if k * x.element_size() % 16:
        raise ValueError(f"quantize_rows needs rows of a multiple of 16 bytes, "
                         f"got K={k}")
    build.check_tensor("quantize_rows x", x, x.dtype, (t, k), x.device)
    mode = 0 if ln is None else 1 if canvas is None else 2
    if ln is not None:
        for name in ("scale", "bias"):
            build.check_tensor(f"quantize_rows ln {name}", ln[name],
                               torch.float32, (k,), x.device)
    if canvas is not None and t % (canvas[0] * canvas[1]):
        raise ValueError(f"quantize_rows: {t} rows are no whole canvases of "
                         f"{canvas[0]} x {canvas[1]}")
    codes = torch.empty((t, k), dtype=torch.int8, device=x.device)
    scales = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    fn = build.function("bt_i8_quant_rows", 5, 10)
    code = fn(x.data_ptr(), None if ln is None else ln["scale"].data_ptr(),
              None if ln is None else ln["bias"].data_ptr(), codes.data_ptr(),
              scales.data_ptr(), t, k, mode, int(x.dtype == torch.float32),
              *(canvas or (0, 0, 0, 0, 0, 0)), build.stream(x.device))
    build.check(code, "quantize_rows")
    quantize_rows.launches += 1
    return codes, scales


quantize_rows.launches = 0


def ln_code_flips(x: torch.Tensor, ln, canvas: Optional[Canvas] = None,
                  plain_round: Optional[torch.dtype] = None):
    """The LN codes of `quantize_rows(x, ln, canvas)` (bf16 or f32 rows
    [T, K]) against the plain model's: quant.quantize_rows of
    F.layer_norm(x) in f32 (K3's LN2 in fused_mlp_residual_int8_plain) or,
    with a canvas, of that LayerNorm with the pad tokens zeroed, rounded
    to x.dtype (K1-int8's LN1), or to `plain_round` where given (a control:
    f32 rows against a plain model that rounds them to bf16). The two sum
    the statistics in other orders, so a code on a rounding boundary may
    flip. Returns (codes that differ, largest |difference|, codes
    compared)."""
    codes, _ = quantize_rows(x, ln, canvas)
    h = L.layer_norm(ln, x.float())
    if canvas is not None:
        valid = pad_token_rows(canvas, x.shape[0], x.device)
        h = torch.where(valid[:, None], h, torch.zeros((), device=h.device))
        h = h.to(plain_round or x.dtype).float()
    want, _ = quant.quantize_rows(h)
    d = (codes.int() - want.int()).abs()
    return int(d.ne(0).sum()), int(d.max()), d.numel()
