"""Fused Swin window-attention block kernel (CUDA C++, csrc/fused_block_attn.cu).

On a padded (and, for cyclic shifted blocks, rolled) NHWC canvas:

    x + proj(per head softmax(q k^T * d^-0.5 + bias [+ SW-MSA mask]) v),
    with q, k, v = qkv(LN1(x) with pad tokens zeroed)

Replaces birefnet_tpu/ops/pallas/fused_block_attn.py::_fused (bf16 and f32;
the int8 branch below), called from models/swin.py for every Swin block: 48
calls per Swin-L forward, on canvases from [2, 264, 264, 192] (6 heads) to
[2, 24, 24, 1536] (48 heads), window 12 (N = 144), head dim 32.

A Hopper block cannot hold the TPU kernel's whole strip of windows, so the
CUDA version (`bt_fused_block_attn_bf16`) runs four hand-written launches:
the bf16 row pass (LN1 + pad-zero, csrc/row_ln.cu), the bf16 wgmma/TMA
GEMM for the qkv product (csrc/bf16_gemm.cu, the machinery of
csrc/wgmma_ring.cuh that the int8 GEMM shares), the window-attention core
of csrc/window_core.cuh (shared with K6-K8,
ops/kernels/flash_window_attn.py) with scores and probabilities in
registers, and the same GEMM for the projection with bias and residual
(ops/kernels/bf16_gemm.py calls the GEMM and the row pass alone). Its
bounds on the card and the design are in the source notes of
csrc/fused_block_attn.cu, csrc/bf16_gemm.cu and csrc/window_core.cuh. The
softmax stays in f32 per head; the TPU's packed head groups, which round
exp(s-m) to bf16, are not copied. The core takes the f32 rel-pos bias and
the SW-MSA mask dense or as the [nW, N] int32 region ids the model passes
(window.sw_msa_region_ids, built once per stage geometry), as they are:
nothing is converted per call.

W8A8 (ComputeConfig.int8_attn): blocks whose qkv carries `weight_q8`
(params.quantize_attn_int8) run `fused_window_block_attention_int8`, the
port of the int8 branch of the same TPU kernel (`_kernel`'s `sqkv_ref`
path, fused_block_attn.py:100-112, 208-215). Its CUDA route
(`bt_fused_block_attn_i8`) is five launches: LN1 + pad-zero + bf16
rounding + per-token int8 rows, an int8 qkv GEMM with dequant and bias,
the same bf16 attention core, per-token int8 of the attention rows,
and an int8 proj GEMM with dequant, bias and the residual. An f32 canvas
(the same branch at tokens.dtype == float32) runs
`bt_fused_block_attn_i8_f32`: the same five launches with nothing rounded
to bf16, the qkv dequantized into an f32 scratch, the f32 core, and the
proj's residual added in f32.

f32 (ComputeConfig(dtype=float32) on the kernel tier): an f32 canvas runs
`bt_fused_block_attn_f32`, the f32 branch of the same TPU kernel (dots at
precision=HIGHEST; the q scale, bias and mask unrounded), as the same four
launches on f32 tensors: the f32 row pass, the f32 GEMM of
csrc/f32_gemm.cu for qkv, the f32 core of csrc/window_core_f32.cuh, and the
same GEMM for the projection with the residual. The GEMM and the core take
their products on the tensor cores as three TF32 products each
(ops/kernels/tf32.py), within about 1e-6 of f32 products and summed in
f32; the GEMM reads the qkv and proj `weight_tf32` (split once by
params.split_tf32_weights, else at the call). PyTorch's TF32 flags do not
govern them. The TPU kernel's f32 body already computes per head; its bf16 packed
head groups (`_PACKED_G`, a TPU matrix-unit workaround) are not copied by
either route. Both wrappers take their plain version for a CPU tensor
and launch their kernels for a CUDA tensor or raise; each counts its own
launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import layers as L
from .. import quant
from .. import window as W
from ..attention import (qkv_window_attention, round_addends,
                         window_attention_forward)
from . import build
from . import window_core as core
from .tf32 import weight_split_of


def _pad_token_mask(hp: int, wp: int, shift: int, origin: int, h_real: int,
                    w_real: int, device) -> torch.Tensor:
    """[hp, wp] bool, True at real tokens of the padded (rolled or offset)
    canvas: the coordinates the TPU kernel computes from its grid."""
    rows = torch.arange(hp, device=device)
    cols = torch.arange(wp, device=device)
    if shift:
        rows = (rows + shift) % hp
        cols = (cols + shift) % wp
    vr = (rows >= origin) & (rows < origin + h_real)
    vc = (cols >= origin) & (cols < origin + w_real)
    return vr[:, None] & vc[None, :]


# (Hp, Wp, shift, origin, h_real, w_real) of a padded canvas [B, Hp, Wp, C].
Canvas = Tuple[int, int, int, int, int, int]


def pad_token_rows(canvas: Canvas, t: int, device) -> torch.Tensor:
    """[t] bool, True at the real tokens of t rows that are whole canvases
    [B, Hp, Wp] in order; canvas = (Hp, Wp, shift, origin, h_real,
    w_real)."""
    hp, wp = canvas[:2]
    return _pad_token_mask(*canvas, device).reshape(-1).repeat(t // (hp * wp))


def fused_window_block_attention_plain(
        x: torch.Tensor, norm1_params, attn_params, window_size: int,
        shift_size: int, num_heads: int, attn_mask: Optional[torch.Tensor],
        h_real: int, w_real: int, origin: int = 0) -> torch.Tensor:
    """Plain PyTorch version: window partition, naive window attention and
    window reverse around LN1 and the projections; the rel-pos bias and the
    mask are rounded as the kernel takes them (round_addends)."""
    _, hp, wp, _ = x.shape
    h = L.layer_norm(norm1_params, x)
    valid = _pad_token_mask(hp, wp, shift_size, origin, h_real, w_real,
                            x.device)
    h = torch.where(valid[None, :, :, None], h, torch.zeros((), dtype=h.dtype,
                                                           device=h.device))
    bias, mask = round_addends(x.dtype, attn_params["cached_bias"], attn_mask)
    y = window_attention_forward(dict(attn_params, cached_bias=bias),
                                 W.window_partition(h, window_size), mask,
                                 num_heads)
    return x + W.window_reverse(y, window_size, hp, wp)


def fused_window_block_attention_int8_plain(
        x: torch.Tensor, norm1_params, attn_params, window_size: int,
        shift_size: int, num_heads: int, attn_mask: Optional[torch.Tensor],
        h_real: int, w_real: int, origin: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the W8A8 branch, with the JAX kernel's
    rounding points: LN1 in f32, pad tokens zeroed, rows rounded to
    x.dtype, per-token int8, exact qkv product, dequant + bias rounded to
    x.dtype; the attention core as in the bf16 version; per-token int8 of
    the attention rows, exact proj product, dequant + bias rounded to
    x.dtype, + x. The rel-pos bias and the mask are rounded as in the bf16
    version."""
    _, hp, wp, _ = x.shape
    h = L.layer_norm(norm1_params, x.float())
    valid = _pad_token_mask(hp, wp, shift_size, origin, h_real, w_real,
                            x.device)
    h = torch.where(valid[None, :, :, None], h, torch.zeros((), device=h.device))
    q, sx = quant.quantize_rows(h.to(x.dtype).float())
    qkv = quant.int8_linear(q, sx, attn_params["qkv"]).to(x.dtype)
    bias, mask = round_addends(x.dtype, attn_params["cached_bias"], attn_mask)
    o = qkv_window_attention(W.window_partition(qkv, window_size), bias, mask,
                             num_heads)
    o = W.window_reverse(o, window_size, hp, wp)
    qa, sa = quant.quantize_rows(o.float())
    return x + quant.int8_linear(qa, sa, attn_params["proj"]).to(x.dtype)


def _check(x, ws, heads, tensors):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_block_attn kernel takes bf16 or f32 "
                        f"activations, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("fused_block_attn needs a contiguous [B, Hp, Wp, C] "
                         "input")
    b, hp, wp, c = x.shape
    n = ws * ws
    if c != heads * 32 or c % 64 or n % 16 or n > 144 or hp % ws or wp % ws:
        raise ValueError(
            f"fused_block_attn kernel needs head dim 32, C % 64 == 0, "
            f"ws*ws % 16 == 0 and <= 144, Hp and Wp multiples of ws; got "
            f"x {tuple(x.shape)}, heads {heads}, ws {ws}")
    # bf16 and int8 operands 32-byte aligned, f32 ones 16-byte aligned.
    align = 16 if x.dtype == torch.float32 else 32
    for name, t, dtype, shape in tensors:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(
                f"fused_block_attn {name}: want contiguous {align}-byte "
                f"aligned {dtype} {shape} on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _addends(x, attn_params, attn_mask, ws, heads):
    """The attention core's addends as given, with nothing converted per
    call: (bias pointer, mask pointer, MaskKind). The rel-pos bias is
    [heads, N, N] f32; the mask None, a dense [nW, N, N] f32 mask, or
    [nW, N] int32 region ids, nW the canvas's windows."""
    _, hp, wp, _ = x.shape
    n, nw = ws * ws, (hp // ws) * (wp // ws)
    bias = attn_params["cached_bias"]
    core.check_addend("fused_block_attn rel-pos bias", bias, (heads, n, n),
                      torch.float32, x.device)
    kind = core.mask_kind("fused_block_attn", attn_mask, n, x.device)
    if attn_mask is not None and attn_mask.shape[0] != nw:
        raise ValueError(f"fused_block_attn mask: want {nw} windows, got "
                         f"{attn_mask.shape[0]}")
    return (bias.data_ptr(),
            None if attn_mask is None else attn_mask.data_ptr(), kind)


def fused_window_block_attention(
        x: torch.Tensor, norm1_params, attn_params, window_size: int,
        shift_size: int, num_heads: int, attn_mask: Optional[torch.Tensor],
        h_real: int, w_real: int, origin: int = 0) -> torch.Tensor:
    """x + proj(window attention(LN1(x))) on a padded NHWC canvas.

    Same contract as the JAX function: x is [B, Hp, Wp, C], pre-norm, padded
    to window multiples and, for cyclic shifted blocks, rolled by -shift;
    attn_mask is the [nW, N, N] SW-MSA mask (the offset variant with
    shift_size=0 and origin=ws-shift for the roll-free partition), its
    [nW, N] int32 region ids (the form models/swin.py passes), or None.
    The Swin block's shortcut add is always fused (the JAX function's
    `residual=True`, the only value its model passes). Pad-region outputs
    are unspecified; the caller crops them. W8A8 blocks (qkv carries
    `weight_q8`) go to fused_window_block_attention_int8.
    """
    if "weight_q8" in attn_params["qkv"]:
        return fused_window_block_attention_int8(
            x, norm1_params, attn_params, window_size, shift_size, num_heads,
            attn_mask, h_real, w_real, origin)
    if x.device.type == "cpu":
        return fused_window_block_attention_plain(
            x, norm1_params, attn_params, window_size, shift_size, num_heads,
            attn_mask, h_real, w_real, origin)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_attn runs on cpu or cuda, got {x.device}")
    b, hp, wp, c = x.shape
    ws = window_size
    f32, wt = torch.float32, x.dtype
    qkv_p, proj_p = attn_params["qkv"], attn_params["proj"]
    # The f32 GEMM reads each weight's TF32 hi and lo parts, [2, out, in].
    w_qkv, w_proj, split = (
        (weight_split_of(qkv_p), weight_split_of(proj_p), (2,)) if wt == f32
        else (qkv_p["weight"], proj_p["weight"], ()))
    args = [("ln scale", norm1_params["scale"], f32, (c,)),
            ("ln bias", norm1_params["bias"], f32, (c,)),
            ("qkv weight", w_qkv, wt, (*split, 3 * c, c)),
            ("qkv bias", qkv_p["bias"], f32, (3 * c,)),
            ("proj weight", w_proj, wt, (*split, c, c)),
            ("proj bias", proj_p["bias"], f32, (c,))]
    _check(x, ws, num_heads, [("x", x, wt, tuple(x.shape))] + args)
    bias, mask_ptr, kind = _addends(x, attn_params, attn_mask, ws, num_heads)
    qkv = torch.empty((b, hp, wp, 3 * c), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for _, t, _, _ in args]
    fn = build.function("bt_fused_block_attn_f32" if wt == f32
                        else "bt_fused_block_attn_bf16", 12, 11)
    code = fn(x.data_ptr(), *ptrs, bias, mask_ptr, qkv.data_ptr(),
              attn.data_ptr(), out.data_ptr(), b, hp, wp, c, num_heads, ws,
              shift_size, origin, h_real, w_real, kind, build.stream(x.device))
    build.check(code, "fused_block_attn")
    fused_window_block_attention.launches += 1
    return out


fused_window_block_attention.launches = 0


def fused_window_block_attention_int8(
        x: torch.Tensor, norm1_params, attn_params, window_size: int,
        shift_size: int, num_heads: int, attn_mask: Optional[torch.Tensor],
        h_real: int, w_real: int, origin: int = 0) -> torch.Tensor:
    """W8A8 x + proj(window attention(LN1(x))), the contract of
    fused_window_block_attention: plain version on the CPU, the CUDA
    kernels on a CUDA tensor (bf16 or f32 activations)."""
    if x.device.type == "cpu":
        return fused_window_block_attention_int8_plain(
            x, norm1_params, attn_params, window_size, shift_size, num_heads,
            attn_mask, h_real, w_real, origin)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_attn_int8 runs on cpu or cuda, got "
                         f"{x.device}")
    b, hp, wp, c = x.shape
    ws = window_size
    f32, i8 = torch.float32, torch.int8
    qkv_p, proj_p = attn_params["qkv"], attn_params["proj"]
    args = [("ln scale", norm1_params["scale"], f32, (c,)),
            ("ln bias", norm1_params["bias"], f32, (c,)),
            ("qkv weight_q8", qkv_p["weight_q8"], i8, (3 * c, c)),
            ("qkv scale_q8", qkv_p["scale_q8"], f32, (3 * c,)),
            ("qkv bias", qkv_p["bias"], f32, (3 * c,)),
            ("proj weight_q8", proj_p["weight_q8"], i8, (c, c)),
            ("proj scale_q8", proj_p["scale_q8"], f32, (c,)),
            ("proj bias", proj_p["bias"], f32, (c,))]
    _check(x, ws, num_heads, [("x", x, x.dtype, tuple(x.shape))] + args)
    bias, mask_ptr, kind = _addends(x, attn_params, attn_mask, ws, num_heads)
    t = b * hp * wp
    codes = torch.empty((t, c), dtype=i8, device=x.device)
    scales = torch.empty((t,), dtype=f32, device=x.device)
    qkv = torch.empty((t, 3 * c), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for _, a, _, _ in args]
    fn = build.function("bt_fused_block_attn_i8_f32" if x.dtype == f32
                        else "bt_fused_block_attn_i8", 16, 11)
    code = fn(x.data_ptr(), *ptrs, bias, mask_ptr, codes.data_ptr(),
              scales.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
              out.data_ptr(), b, hp, wp, c, num_heads, ws, shift_size, origin,
              h_real, w_real, kind, build.stream(x.device))
    build.check(code, "fused_block_attn_int8")
    fused_window_block_attention_int8.launches += 1
    return out


fused_window_block_attention_int8.launches = 0
