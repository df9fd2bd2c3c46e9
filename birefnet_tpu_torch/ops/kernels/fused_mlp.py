"""Fused Swin MLP half-block kernel (CUDA C++, csrc/fused_mlp.cu).

    out = x + fc2(GELU_erf(LN2(x) @ W1^T + b1)) @ W2^T + b2

Replaces birefnet_tpu/ops/pallas/fused_mlp.py::_fused (bf16 and f32
branches), called from models/swin.py for every Swin block: 48 calls per
Swin-L forward, on [T, C] tokens from [131072, 192] to [512, 1536], and 24
per swin_t forward (20 with int8_mlp), from [131072, 96] to [512, 768].

On the card the MLP is 16 C^2 operations per token, which only the bf16
tensor cores' wgmma reaches. The CUDA version (`bt_fused_mlp_bf16`) is
three launches on one stream: the bf16 row pass (LN2 rows into the output
buffer, csrc/row_ln.cu), the bf16 wgmma/TMA GEMM of csrc/bf16_gemm.cu for
fc1 with the bias and the 3-term erf GELU in its epilogue into a bf16
[T, 4C] scratch, and the same GEMM for fc2 with the bias and the residual
(ops/kernels/bf16_gemm.py calls the GEMM and the row pass alone). The
hidden's round trip through device memory bounds the narrow stages (see
the source note in csrc/fused_mlp.cu). The JAX kernel's VMEM residency
gate is not ported: the weights never need to fit on chip.

W8A8 (ComputeConfig.int8_mlp): blocks whose fc1 carries `weight_q8`
(params.quantize_mlp_int8) run `fused_mlp_residual_int8` instead, the port
of birefnet_tpu/ops/pallas/fused_mlp.py::_fused_i8 (body `_kernel_i8`), as
the JAX function dispatches on `kernel_q8`. Its CUDA route
(csrc/fused_mlp_i8.cu) is two launches: LN2 + per-token int8 rows (the
row pass of csrc/int8_gemm.cu, into [T, C] codes and [T] scales), then one
thread-block-cluster kernel that runs fc1, the dequant, b1 and the 3-term
erf GELU, the per-token int8 of the whole 4C hidden row and fc2 with the
dequant, b2 and the residual, the hidden kept in the cluster's shared
memory (CLUSTER_SLICE hidden units per CTA, `cluster_size(C)` CTAs). There
is no [T, 4C] scratch. `fused_mlp_residual_int8_codes` runs the cluster
kernel alone from given LN2 codes (for the tests and chip_smoke.py). An
f32 x (the TPU kernel's `_kernel_i8` at f32) runs the same two launches
through `bt_fused_mlp_i8_f32`: the f32 LN2 row pass, then the cluster
kernel built for f32 x and out, whose last step adds y + x in f32 where
the bf16 one rounds y and the sum to bf16; the GELU stays the 3-term erf.

f32 (ComputeConfig(dtype=float32) on the kernel tier): an f32 x runs
`bt_fused_mlp_f32`, the f32 branch of the same TPU kernel (its dots at
precision=HIGHEST, the 5-coefficient erf), as the same three launches on
f32 tensors: the f32 row pass, the f32 GEMM of csrc/f32_gemm.cu with the
exact GELU into an f32 [T, 4C] scratch, and the same GEMM with the
residual (ops/kernels/f32_gemm.py calls both alone). The GEMM takes each
product on the tensor cores as three TF32 products (ops/kernels/tf32.py),
reading fc1's and fc2's `weight_tf32` (split once by
params.split_tf32_weights, else at the call); PyTorch's TF32 flags do not
govern it. Every wrapper takes its plain version for a CPU tensor and launches
its kernel for a CUDA tensor or raises; each counts its own launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import layers as L
from .. import quant
from . import build
from .tf32 import weight_split_of


def fused_mlp_residual_plain(x: torch.Tensor, norm2_params,
                             mlp_params) -> torch.Tensor:
    """Plain PyTorch version with the JAX kernel's rounding points: LN in
    f32 rounded to x.dtype; fc1 summed in f32, + b1 and GELU in f32, the
    hidden rounded to x.dtype; fc2 summed in f32, + b2 rounded to x.dtype;
    then x + y. The GELU is the JAX kernel's: the 3-term erf for bf16
    (`_erf(fast=True)`), exact erf for f32 (JAX's 7.1.26 form there is
    within 1.5e-7 of it)."""
    fc1, fc2 = mlp_params["fc1"], mlp_params["fc2"]
    h = L.layer_norm(norm2_params, x).float()
    h = F.linear(h, fc1["weight"].to(x.dtype).float()) + fc1["bias"].float()
    h = quant.gelu_erf3(h) if x.dtype == torch.bfloat16 else F.gelu(h)
    y = F.linear(h.to(x.dtype).float(), fc2["weight"].to(x.dtype).float())
    return x + (y + fc2["bias"].float()).to(x.dtype)


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


# Hidden units and fc2 output columns per CTA of K3's cluster kernel
# (csrc/fused_mlp_i8.cu: kSlice, kOut), and its largest cluster.
CLUSTER_SLICE, CLUSTER_OUT, CLUSTER_MAX = 384, 96, 16


def cluster_size(c: int) -> int:
    """CTAs per cluster of K3's kernel at width C: ceil(C / 96), so that
    the slices cover the 4C hidden units and the output columns the C."""
    return -(-c // CLUSTER_OUT)


def fused_mlp_residual_int8_codes_plain(x: torch.Tensor, codes: torch.Tensor,
                                        scales: torch.Tensor,
                                        mlp_params) -> torch.Tensor:
    """Plain version of the cluster kernel from given LN2 codes [T, C] int8
    and scales [T, 1] f32 (x [T, C]): int8_linear -> gelu_erf3 ->
    quantize_rows -> int8_linear -> + x, as fused_mlp_residual_int8_plain
    after its LN2 codes."""
    h = quant.gelu_erf3(quant.int8_linear(codes, scales, mlp_params["fc1"]))
    q2, sx2 = quant.quantize_rows(h)
    return x + quant.int8_linear(q2, sx2, mlp_params["fc2"]).to(x.dtype)


# The C entries' widest rows: the row pass takes rows of up to 16384 bf16
# or 8192 f32 values (csrc/rows.cuh).
MAX_C = {torch.bfloat16: 16384, torch.float32: 8192}


def _check(x: torch.Tensor, tensors, multiple: int, max_c: int) -> None:
    """Raise unless the kernel takes x and its tensors: bf16 or f32
    activations, 32-byte aligned bf16 or int8 operands (16-byte aligned
    with f32 activations), 16-byte aligned f32 ones, C a multiple of
    `multiple` up to max_c."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_mlp kernel takes bf16 or f32 activations, "
                        f"got {x.dtype}")
    c = x.shape[-1]
    if c % multiple or c > max_c:
        raise ValueError(f"fused_mlp kernel needs C % {multiple} == 0 and "
                         f"C <= {max_c}, got C={c}")
    if not x.is_contiguous():
        raise ValueError("fused_mlp needs a contiguous input")
    align = 16 if x.dtype == torch.float32 else 32
    for name, t, dtype, shape in tensors:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(
                f"fused_mlp {name}: want contiguous {align}-byte aligned "
                f"{dtype} {shape} on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def fused_mlp_residual(x: torch.Tensor, norm2_params,
                       mlp_params) -> torch.Tensor:
    """x + MLP(LN2(x)) on [..., C]: plain version on the CPU, the CUDA
    kernels on a CUDA tensor (bf16 or f32, with weights of x's dtype). W8A8
    blocks (fc1 carries `weight_q8`) go to fused_mlp_residual_int8."""
    if "weight_q8" in mlp_params["fc1"]:
        return fused_mlp_residual_int8(x, norm2_params, mlp_params)
    if x.device.type == "cpu":
        return fused_mlp_residual_plain(x, norm2_params, mlp_params)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cpu or cuda, got {x.device}")
    c = x.shape[-1]
    f32, wt = torch.float32, x.dtype
    fc1, fc2 = mlp_params["fc1"], mlp_params["fc2"]
    # The f32 GEMM reads each weight's TF32 hi and lo parts, [2, out, in].
    w1, w2, split = ((weight_split_of(fc1), weight_split_of(fc2), (2,))
                     if wt == f32 else (fc1["weight"], fc2["weight"], ()))
    args = [("x", x, wt, tuple(x.shape)),
            ("ln scale", norm2_params["scale"], f32, (c,)),
            ("ln bias", norm2_params["bias"], f32, (c,)),
            ("fc1 weight", w1, wt, (*split, 4 * c, c)),
            ("fc1 bias", fc1["bias"], f32, (4 * c,)),
            ("fc2 weight", w2, wt, (*split, c, 4 * c)),
            ("fc2 bias", fc2["bias"], f32, (c,))]
    _check(x, args, 8, MAX_C.get(wt, 0))
    t = x.numel() // c
    hidden = torch.empty((t, 4 * c), dtype=wt, device=x.device)
    out = torch.empty_like(x)
    name = "bt_fused_mlp_f32" if wt == f32 else "bt_fused_mlp_bf16"
    code = build.function(name, 9, 2)(
        *[a.data_ptr() for _, a, _, _ in args], hidden.data_ptr(),
        out.data_ptr(), t, c, build.stream(x.device))
    build.check(code, "fused_mlp")
    fused_mlp_residual.launches += 1
    return out


fused_mlp_residual.launches = 0


def _int8_weights(x: torch.Tensor, mlp_params):
    c = x.shape[-1]
    f32, i8 = torch.float32, torch.int8
    fc1, fc2 = mlp_params["fc1"], mlp_params["fc2"]
    return [("fc1 weight_q8", fc1["weight_q8"], i8, (4 * c, c)),
            ("fc1 scale_q8", fc1["scale_q8"], f32, (4 * c,)),
            ("fc1 bias", fc1["bias"], f32, (4 * c,)),
            ("fc2 weight_q8", fc2["weight_q8"], i8, (c, 4 * c)),
            ("fc2 scale_q8", fc2["scale_q8"], f32, (c,)),
            ("fc2 bias", fc2["bias"], f32, (c,))]


def fused_mlp_residual_int8(x: torch.Tensor, norm2_params,
                            mlp_params) -> torch.Tensor:
    """W8A8 x + MLP(LN2(x)) on [..., C]: plain version on the CPU; on a
    CUDA tensor (bf16 or f32) the LN2 row pass and the cluster kernel of
    csrc/fused_mlp_i8.cu, counted as one launch of K3."""
    if x.device.type == "cpu":
        return fused_mlp_residual_int8_plain(x, norm2_params, mlp_params)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_int8 runs on cpu or cuda, got {x.device}")
    c = x.shape[-1]
    f32 = torch.float32
    args = [("x", x, x.dtype, tuple(x.shape)),
            ("ln scale", norm2_params["scale"], f32, (c,)),
            ("ln bias", norm2_params["bias"], f32, (c,)),
            *_int8_weights(x, mlp_params)]
    _check(x, args, 64, CLUSTER_MAX * CLUSTER_OUT)
    t = x.numel() // c
    codes = torch.empty((t, c), dtype=torch.int8, device=x.device)
    scales = torch.empty((t,), dtype=f32, device=x.device)
    out = torch.empty_like(x)
    fn = build.function("bt_fused_mlp_i8_f32" if x.dtype == f32
                        else "bt_fused_mlp_i8", 12, 2)
    code = fn(*[a.data_ptr() for _, a, _, _ in args], codes.data_ptr(),
              scales.data_ptr(), out.data_ptr(), t, c, build.stream(x.device))
    build.check(code, "fused_mlp_int8")
    fused_mlp_residual_int8.launches += 1
    return out


fused_mlp_residual_int8.launches = 0


def fused_mlp_residual_int8_codes(x: torch.Tensor, codes: torch.Tensor,
                                  scales: torch.Tensor,
                                  mlp_params) -> torch.Tensor:
    """The cluster kernel alone on x [T, C] bf16 or f32 from given LN2
    codes [T, C] int8 and scales [T, 1] f32: the plain version on the CPU,
    the kernel on a CUDA tensor; its launches are counted apart from
    K3's."""
    if x.device.type == "cpu":
        return fused_mlp_residual_int8_codes_plain(x, codes, scales,
                                                   mlp_params)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_int8 runs on cpu or cuda, got {x.device}")
    if x.ndim != 2:
        raise ValueError(f"fused_mlp_int8_codes takes x [T, C], got "
                         f"{tuple(x.shape)}")
    t, c = x.shape
    args = [("codes", codes, torch.int8, (t, c)),
            ("scales", scales, torch.float32, (t, 1)),
            ("x", x, x.dtype, (t, c)), *_int8_weights(x, mlp_params)]
    _check(x, args, 64, CLUSTER_MAX * CLUSTER_OUT)
    out = torch.empty_like(x)
    fn = build.function("bt_fused_mlp_i8_codes_f32" if x.dtype == torch.float32
                        else "bt_fused_mlp_i8_codes", 10, 2)
    code = fn(*[a.data_ptr() for _, a, _, _ in args], out.data_ptr(), t, c,
              build.stream(x.device))
    build.check(code, "fused_mlp_int8_codes")
    fused_mlp_residual_int8_codes.launches += 1
    return out


fused_mlp_residual_int8_codes.launches = 0
