"""Fused Swin MLP half-block kernel (CUDA C++, csrc/fused_mlp.cu).

    out = x + fc2(GELU_erf(LN2(x) @ W1^T + b1)) @ W2^T + b2

Replaces birefnet_tpu/ops/pallas/fused_mlp.py::_fused (bf16 branch), called
from models/swin.py for every Swin block: 48 calls per Swin-L forward, on
[T, C] tokens from [131072, 192] to [512, 1536], and 24 per swin_t forward
(20 with int8_mlp), from [131072, 96] to [512, 768].

On the card the MLP is 16*C FLOPs per token byte, so the unfused version is
bound by writing and re-reading the [T, 4C] hidden activation; the kernel
keeps the hidden on chip (chunks of 128 hidden units in shared memory,
the fc2 sum in registers) and streams the weights from L2 for every block
of 16 to 64 rows, which makes L2 weight traffic its bound (see the source
note in csrc/fused_mlp.cu). The JAX kernel's VMEM residency gate is not ported:
the weights never need to fit on chip.

W8A8 (ComputeConfig.int8_mlp): blocks whose fc1 carries `weight_q8`
(params.quantize_mlp_int8) run `fused_mlp_residual_int8` instead, the port
of birefnet_tpu/ops/pallas/fused_mlp.py::_fused_i8 (body `_kernel_i8`), as
the JAX function dispatches on `kernel_q8`. Its CUDA route
(csrc/fused_mlp_i8.cu) is four launches: LN2 + per-token int8 rows, an
int8 fc1 GEMM whose epilogue dequantizes, adds b1 and applies the 3-term
erf GELU into an f32 [T, 4C] scratch, per-token int8 of that hidden over
all 4C units, and an int8 fc2 GEMM with dequant, b2 and the residual.

The kernels take bf16 activations only. Both wrappers take their plain
version for a CPU tensor and launch their kernel for a CUDA tensor or
raise; each counts its own launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import layers as L
from .. import quant
from . import build


def fused_mlp_residual_plain(x: torch.Tensor, norm2_params,
                             mlp_params) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points: LN in f32,
    fc1 + b1 and GELU in f32, hidden and fc2 + b2 in x.dtype, then x + y."""
    fc1 = mlp_params["fc1"]
    h = L.layer_norm(norm2_params, x)
    h = F.linear(h, fc1["weight"].to(x.dtype)).float() + fc1["bias"].float()
    return x + L.linear(mlp_params["fc2"], F.gelu(h).to(x.dtype))


def _plan(t: int, c: int, device) -> tuple:
    """(row_groups, splits) of the kernel launch: 16 * row_groups token rows
    per block (row_groups * C <= 1536 keeps the fc2 sum in registers), and
    the fewest hidden splits, a divisor of the ceil(4C/256) hidden chunks
    (the last one shorter at C = 96), that give at least one block per
    SM."""
    row_groups = 4 if c <= 384 else (2 if c <= 768 else 1)
    blocks = -(-t // (16 * row_groups))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = -(-4 * c // 256)
    splits = 1
    if t % 16 == 0:
        while blocks * splits < sms and splits < chunks:
            splits += 1
            while chunks % splits:
                splits += 1
    return row_groups, splits


def fused_mlp_residual_int8_plain(x: torch.Tensor, norm2_params,
                                  mlp_params) -> torch.Tensor:
    """Plain PyTorch version of the W8A8 kernel (JAX `_kernel_i8`): LN2 in
    f32, not rounded, -> per-token int8 -> exact fc1 product, dequant + b1
    -> 3-term erf GELU in f32 -> per-token int8 over all 4C hidden units ->
    exact fc2 product, dequant + b2 rounded to x.dtype -> x + y."""
    fc1, fc2 = mlp_params["fc1"], mlp_params["fc2"]
    q, sx = quant.quantize_rows(L.layer_norm(norm2_params, x.float()))
    h = quant.gelu_erf3(quant.int8_linear(q, sx, fc1))
    q2, sx2 = quant.quantize_rows(h)
    return x + quant.int8_linear(q2, sx2, fc2).to(x.dtype)


def _check(x: torch.Tensor, tensors, multiple: int) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_mlp kernel takes bf16 activations, got "
                        f"{x.dtype} (run f32 with use_flash_attention=False)")
    c = x.shape[-1]
    if c % multiple or c > 1536:
        raise ValueError(f"fused_mlp kernel needs C % {multiple} == 0 and "
                         f"C <= 1536, got C={c}")
    if not x.is_contiguous():
        raise ValueError("fused_mlp needs a contiguous input")
    for name, t, dtype, shape in tensors:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 32):
            raise ValueError(
                f"fused_mlp {name}: want contiguous 32-byte aligned {dtype} "
                f"{shape} on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def fused_mlp_residual(x: torch.Tensor, norm2_params,
                       mlp_params) -> torch.Tensor:
    """x + MLP(LN2(x)) on [..., C]: plain version on the CPU, the CUDA
    kernel on a CUDA tensor (bf16 only). W8A8 blocks (fc1 carries
    `weight_q8`) go to fused_mlp_residual_int8."""
    if "weight_q8" in mlp_params["fc1"]:
        return fused_mlp_residual_int8(x, norm2_params, mlp_params)
    if x.device.type == "cpu":
        return fused_mlp_residual_plain(x, norm2_params, mlp_params)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cpu or cuda, got {x.device}")
    c = x.shape[-1]
    f32, bf = torch.float32, torch.bfloat16
    args = [("x", x, bf, tuple(x.shape)),
            ("ln scale", norm2_params["scale"], f32, (c,)),
            ("ln bias", norm2_params["bias"], f32, (c,)),
            ("fc1 weight", mlp_params["fc1"]["weight"], bf, (4 * c, c)),
            ("fc1 bias", mlp_params["fc1"]["bias"], f32, (4 * c,)),
            ("fc2 weight", mlp_params["fc2"]["weight"], bf, (c, 4 * c)),
            ("fc2 bias", mlp_params["fc2"]["bias"], f32, (c,))]
    _check(x, args, 16)
    t = x.numel() // c
    row_groups, splits = _plan(t, c, x.device)
    out = torch.empty_like(x)
    partial = (torch.empty((splits, t, c), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    fn = build.function("bt_fused_mlp_bf16", 9, 4)
    code = fn(*[a.data_ptr() for _, a, _, _ in args], out.data_ptr(),
              None if partial is None else partial.data_ptr(), t, c, row_groups,
              splits, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "fused_mlp")
    fused_mlp_residual.launches += 1
    return out


fused_mlp_residual.launches = 0


def fused_mlp_residual_int8(x: torch.Tensor, norm2_params,
                            mlp_params) -> torch.Tensor:
    """W8A8 x + MLP(LN2(x)) on [..., C]: plain version on the CPU, the CUDA
    kernels of csrc/fused_mlp_i8.cu on a CUDA tensor (bf16 only)."""
    if x.device.type == "cpu":
        return fused_mlp_residual_int8_plain(x, norm2_params, mlp_params)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_int8 runs on cpu or cuda, got {x.device}")
    c = x.shape[-1]
    f32, i8 = torch.float32, torch.int8
    fc1, fc2 = mlp_params["fc1"], mlp_params["fc2"]
    args = [("x", x, torch.bfloat16, tuple(x.shape)),
            ("ln scale", norm2_params["scale"], f32, (c,)),
            ("ln bias", norm2_params["bias"], f32, (c,)),
            ("fc1 weight_q8", fc1["weight_q8"], i8, (4 * c, c)),
            ("fc1 scale_q8", fc1["scale_q8"], f32, (4 * c,)),
            ("fc1 bias", fc1["bias"], f32, (4 * c,)),
            ("fc2 weight_q8", fc2["weight_q8"], i8, (c, 4 * c)),
            ("fc2 scale_q8", fc2["scale_q8"], f32, (c,)),
            ("fc2 bias", fc2["bias"], f32, (c,))]
    _check(x, args, 64)
    t = x.numel() // c
    codes = torch.empty((t, 4 * c), dtype=i8, device=x.device)
    scales = torch.empty((t,), dtype=f32, device=x.device)
    hidden = torch.empty((t, 4 * c), dtype=f32, device=x.device)
    out = torch.empty_like(x)
    fn = build.function("bt_fused_mlp_i8", 13, 2)
    code = fn(*[a.data_ptr() for _, a, _, _ in args], codes.data_ptr(),
              scales.data_ptr(), hidden.data_ptr(), out.data_ptr(), t, c,
              torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "fused_mlp_int8")
    fused_mlp_residual_int8.launches += 1
    return out


fused_mlp_residual_int8.launches = 0
