"""Fused Swin window-attention block kernel (CUDA C++, csrc/fused_block_attn.cu).

On a padded (and, for cyclic shifted blocks, rolled) NHWC canvas:

    x + proj(per head softmax(q k^T * d^-0.5 + bias [+ SW-MSA mask]) v),
    with q, k, v = qkv(LN1(x) with pad tokens zeroed)

Replaces birefnet_tpu/ops/pallas/fused_block_attn.py::_fused (bf16, not the
int8 branch), called from models/swin.py for every Swin block: 48 calls per
Swin-L forward, on canvases from [2, 264, 264, 192] (6 heads) to
[2, 24, 24, 1536] (48 heads), window 12 (N = 144), head dim 32.

A Hopper block cannot hold the TPU kernel's whole strip of windows, so the
CUDA version runs three hand-written kernels: the LN1 + pad-zero + qkv
product over all tokens, one block per (window, head) for the scores, the
f32 softmax and P v in shared memory, and the token-local projection with
bias and residual. Its bounds on the card and the design are in the
source note of csrc/fused_block_attn.cu. The softmax
stays in f32 per head; the TPU's packed head groups, which round exp(s-m)
to bf16, are not copied.

The kernel takes bf16 only. `fused_window_block_attention` takes the plain
version for a CPU tensor and launches the kernels for a CUDA tensor or
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import layers as L
from .. import window as W
from ..attention import window_attention_forward
from . import build


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


def fused_window_block_attention_plain(
        x: torch.Tensor, norm1_params, attn_params, window_size: int,
        shift_size: int, num_heads: int, attn_mask: Optional[torch.Tensor],
        h_real: int, w_real: int, origin: int = 0) -> torch.Tensor:
    """Plain PyTorch version: window partition, naive window attention and
    window reverse around LN1 and the projections."""
    _, hp, wp, _ = x.shape
    h = L.layer_norm(norm1_params, x)
    valid = _pad_token_mask(hp, wp, shift_size, origin, h_real, w_real,
                            x.device)
    h = torch.where(valid[None, :, :, None], h, torch.zeros((), dtype=h.dtype,
                                                           device=h.device))
    y = window_attention_forward(attn_params, W.window_partition(h, window_size),
                                 attn_mask, num_heads)
    return x + W.window_reverse(y, window_size, hp, wp)


def _check(x, ws, heads, tensors):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_block_attn kernel takes bf16 activations, got "
                        f"{x.dtype} (run f32 with use_flash_attention=False)")
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
    for name, t, dtype, shape in tensors:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 32):
            raise ValueError(
                f"fused_block_attn {name}: want contiguous 32-byte aligned "
                f"{dtype} {shape} on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def fused_window_block_attention(
        x: torch.Tensor, norm1_params, attn_params, window_size: int,
        shift_size: int, num_heads: int, attn_mask: Optional[torch.Tensor],
        h_real: int, w_real: int, origin: int = 0) -> torch.Tensor:
    """x + proj(window attention(LN1(x))) on a padded NHWC canvas.

    Same contract as the JAX function: x is [B, Hp, Wp, C], pre-norm, padded
    to window multiples and, for cyclic shifted blocks, rolled by -shift;
    attn_mask is the [nW, N, N] SW-MSA mask (the offset variant with
    shift_size=0 and origin=ws-shift for the roll-free partition) or None.
    The Swin block's shortcut add is always fused (the JAX function's
    `residual=True`, the only value its model passes). Pad-region outputs
    are unspecified; the caller crops them.
    """
    if x.device.type == "cpu":
        return fused_window_block_attention_plain(
            x, norm1_params, attn_params, window_size, shift_size, num_heads,
            attn_mask, h_real, w_real, origin)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_attn runs on cpu or cuda, got {x.device}")
    b, hp, wp, c = x.shape
    ws, n = window_size, window_size * window_size
    f32, bf = torch.float32, torch.bfloat16
    args = [("ln scale", norm1_params["scale"], f32, (c,)),
            ("ln bias", norm1_params["bias"], f32, (c,)),
            ("qkv weight", attn_params["qkv"]["weight"], bf, (3 * c, c)),
            ("qkv bias", attn_params["qkv"]["bias"], f32, (3 * c,)),
            ("proj weight", attn_params["proj"]["weight"], bf, (c, c)),
            ("proj bias", attn_params["proj"]["bias"], f32, (c,)),
            ("rel-pos bias", attn_params["cached_bias"], f32,
             (num_heads, n, n))]
    if attn_mask is not None:
        args.append(("mask", attn_mask, f32, ((hp // ws) * (wp // ws), n, n)))
    _check(x, ws, num_heads, [("x", x, bf, tuple(x.shape))] + args)
    qkv = torch.empty((b, hp, wp, 3 * c), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for _, t, _, _ in args[:7]]
    mask_ptr = attn_mask.data_ptr() if attn_mask is not None else None
    fn = build.function("bt_fused_block_attn_bf16", 12, 10)
    code = fn(x.data_ptr(), *ptrs, mask_ptr, qkv.data_ptr(), attn.data_ptr(),
              out.data_ptr(), b, hp, wp, c, num_heads, ws, shift_size, origin,
              h_real, w_real, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "fused_block_attn")
    fused_window_block_attention.launches += 1
    return out


fused_window_block_attention.launches = 0
