"""Naive windowed multi-head attention with relative-position bias.

Counterpart of birefnet_tpu/ops/attention.py: softmax((q*scale) @ k^T +
bias [+ mask]) @ v with the softmax in f32, all windows and heads batched.
`window_attention_forward` wraps it with the qkv and proj projections
(models/swin.py in the JAX package); it serves the unfused Swin block and
the plain version of the fused block-attention kernel
(ops/kernels/fused_block_attn.py), whose W8A8 plain version calls
`qkv_window_attention` between its int8 projections. `round_addends`
gives the bias and mask as the kernel tier takes them, for the plain
versions of the block-attention and window-attention kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import layers as L
from . import window as W


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: [B_, heads, N, d] with B_ = batch * nW; bias [heads, N, N];
    mask [nW, N, N] of 0/-100 or None. Returns [B_, heads, N, d]."""
    b_, heads, n, d = q.shape
    # The scale in q.dtype, as the JAX package multiplies (bf16 rounds it).
    q = q * torch.tensor(d ** -0.5, dtype=q.dtype)
    # Scores in f32 from the (bf16) operands, as the JAX package takes them.
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = attn + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b_ // nw, nw, heads, n, n)
        attn = attn + mask.float()[None, :, None]
        attn = attn.reshape(b_, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def qkv_window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor],
                         num_heads: int) -> torch.Tensor:
    """Multi-head window attention from packed qkv [B_, N, 3C] (q, k, v
    each head-major over C) -> [B_, N, C]."""
    b_, n, c3 = qkv.shape
    c = c3 // 3
    qkv = qkv.reshape(b_, n, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)
    out = window_attention(qkv[0], qkv[1], qkv[2], bias, mask)
    return out.transpose(1, 2).reshape(b_, n, c)


def round_addends(dtype: torch.dtype, bias: torch.Tensor,
                  mask: Optional[torch.Tensor] = None):
    """The score addends as the kernel tier takes them: with bf16
    activations the rel-pos bias and the mask are rounded to bf16 (as the
    JAX kernels take them, flash_window_attn via models/swin.py:85-87 and
    fused_block_attn.py:348-351); the unfused path keeps them in f32. A
    mask given as region ids (window.sw_msa_region_ids) is expanded to its
    dense 0 / -100 form first."""
    mask = W.dense_mask(mask)
    if dtype != torch.bfloat16:
        return bias, mask
    return bias.to(dtype), None if mask is None else mask.to(dtype)


def window_attention_forward(params, x: torch.Tensor,
                             mask: Optional[torch.Tensor],
                             num_heads: int) -> torch.Tensor:
    """W-MSA on window tokens [B_, N, C]: qkv, window attention, proj."""
    out = qkv_window_attention(L.linear(params["qkv"], x),
                               params["cached_bias"], mask, num_heads)
    return L.linear(params["proj"], out)
