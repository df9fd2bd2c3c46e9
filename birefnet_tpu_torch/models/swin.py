"""Swin Transformer v1 backbone on NHWC tensors.

Counterpart of birefnet_tpu/models/swin.py: patch embed, Swin blocks with
the cyclic shift or the roll-free offset partition, patch merging, and
per-stage LayerNormed features. A Python loop runs the blocks where the
JAX package scans over block pairs.

Tiers (as in the JAX package, models/swin.py:111-121, 355-374): with
`compute.use_flash_attention` a ws=12 block runs the fused block-attention
and fused-MLP kernels; a ws=7 block (swin_t, swin_s) runs the middle tier:
the plain LN1, pad, roll and window partition, the qkv and proj products
outside any kernel, the packed-qkv window-attention kernel (K6) between
them, and the fused-MLP kernel; the standalone norms run the row-LN
kernel. Any other window size runs unfused.

W8A8 (ComputeConfig.int8_mlp/int8_attn) is no tier of its own: blocks
whose params carry `weight_q8` leaves (params.quantize_*_int8) reach the
int8 kernels through the same fused wrappers, which dispatch on them; the
unfused path and the middle tier's qkv and proj products read only the
`weight` leaves, as the JAX package's L.linear reads only `kernel`, so
int8_attn changes nothing at ws=7.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from ..configs import ComputeConfig, SwinConfig
from ..ops import attention as attn_ops
from ..ops import layers as L
from ..ops import window as W
from ..ops.kernels import (flash_window_attn, fused_block_attn, fused_mlp,
                           row_ln)


def _tier(compute: ComputeConfig, window_size: int) -> ComputeConfig:
    """Resolve the kernel tier for a window geometry: ws=12 runs the fused
    block, ws=7 the middle tier, any other window size unfused."""
    if compute.use_flash_attention and window_size not in (7, 12):
        return compute.with_overrides(use_flash_attention=False)
    return compute


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    """fc1 -> exact GELU -> fc2."""
    return L.linear(params["fc2"], L.gelu_exact(L.linear(params["fc1"], x)))


def _ln(params, x: torch.Tensor, compute: ComputeConfig) -> torch.Tensor:
    """LayerNorm at the standalone sites: the row-LN kernel on the kernel
    tier, the plain LayerNorm otherwise."""
    if compute.use_flash_attention:
        return row_ln.layer_norm_rows(params, x.contiguous())
    return L.layer_norm(params, x)


def fused_block_canvas(x: torch.Tensor, window_size: int, shift_size: int,
                       attn_mask: Optional[torch.Tensor]):
    """The fused block kernel's input for one Swin block on NHWC `x`.

    Returns (canvas, kernel_shift, mask, origin). A shifted block whose
    window-pad slack covers ws - shift on both axes takes the roll-free
    offset partition: pad `origin` = ws - shift rows/cols at the top-left,
    with the offset SW-MSA mask (window.py::sw_msa_mask_offset, or its
    region ids when `attn_mask` is given as region ids). Any other
    shifted block pads bottom/right and rolls by -shift (the caller rolls
    the result back), with the cyclic `attn_mask`. The block output is the
    kernel output cropped to [origin, origin + h) x [origin, origin + w).
    """
    _, h, w, _ = x.shape
    ws = window_size
    p0 = ws - shift_size
    if shift_size > 0 and (-h) % ws >= p0 and (-w) % ws >= p0:
        hp, wp = h + (-h) % ws, w + (-w) % ws
        canvas = F.pad(x, (0, 0, p0, wp - w - p0, p0, hp - h - p0))
        if W.is_region_ids(attn_mask):
            mask = W.sw_msa_region_ids(hp, wp, ws, shift_size, x.device,
                                       offset=True)
        else:
            mask = W.sw_msa_mask_offset(hp, wp, ws, shift_size, x.device)
        return canvas, 0, mask, p0
    canvas = W.pad_to_multiple(x, ws)
    if shift_size > 0:
        return W.roll_2d(canvas, -shift_size, -shift_size), shift_size, \
            attn_mask, 0
    return canvas.contiguous(), 0, None, 0


def swin_block_forward(params, x: torch.Tensor, window_size: int,
                       shift_size: int, num_heads: int,
                       attn_mask: Optional[torch.Tensor],
                       compute: ComputeConfig) -> torch.Tensor:
    """One Swin block on NHWC input."""
    b, h, w, c = x.shape
    ws = window_size
    compute = _tier(compute, ws)
    if compute.use_flash_attention and ws == 12:
        canvas, k_shift, mask, origin = fused_block_canvas(x, ws, shift_size,
                                                           attn_mask)
        y = fused_block_attn.fused_window_block_attention(
            canvas, params["norm1"], params["attn"], ws, k_shift, num_heads,
            mask, h, w, origin=origin)
        if k_shift:
            y = W.roll_2d(y, k_shift, k_shift)
        x = y[:, origin:origin + h, origin:origin + w, :]
        return fused_mlp.fused_mlp_residual(x.contiguous(), params["norm2"],
                                            params["mlp"])

    shortcut = x
    x = W.pad_to_multiple(L.layer_norm(params["norm1"], x), ws)
    _, hp, wp, _ = x.shape
    mask = None
    if shift_size > 0:
        x = W.roll_2d(x, -shift_size, -shift_size)
        mask = attn_mask
    windows = W.window_partition(x, ws)
    if compute.use_flash_attention:  # the ws=7 middle tier
        p = params["attn"]
        attn = flash_window_attn.flash_window_attention_qkv(
            L.linear(p["qkv"], windows), p["cached_bias"], mask, num_heads)
        attn = L.linear(p["proj"], attn)
    else:
        attn = attn_ops.window_attention_forward(params["attn"], windows, mask,
                                                 num_heads)
    x = W.window_reverse(attn, ws, hp, wp)
    if shift_size > 0:
        x = W.roll_2d(x, shift_size, shift_size)
    x = shortcut + x[:, :h, :w, :]
    if compute.use_flash_attention:
        return fused_mlp.fused_mlp_residual(x.contiguous(), params["norm2"],
                                            params["mlp"])
    return x + mlp_forward(params["mlp"], L.layer_norm(params["norm2"], x))


def patch_merging_forward(params, x: torch.Tensor,
                          compute: ComputeConfig = ComputeConfig()) -> torch.Tensor:
    """2x downsample on NHWC input."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0],
                   x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
    return L.linear(params["reduction"], _ln(params["norm"], x, compute))


def basic_layer_forward(params, x: torch.Tensor, depth: int, num_heads: int,
                        window_size: int, compute: ComputeConfig,
                        downsample: bool):
    """One stage. Returns (x_out, x_down): the pre-downsample feature and
    the input of the next stage."""
    _, h, w, _ = x.shape
    shift_size = window_size // 2
    hp = -(-h // window_size) * window_size
    wp = -(-w // window_size) * window_size
    # Built once per stage geometry (cached): the kernel tier takes the
    # mask as region ids, the unfused path as the dense mask.
    if _tier(compute, window_size).use_flash_attention:
        attn_mask = W.sw_msa_region_ids(hp, wp, window_size, shift_size,
                                        x.device)
    else:
        attn_mask = W.sw_msa_mask(hp, wp, window_size, shift_size, x.device)
    for j in range(depth):
        x = swin_block_forward(params[f"blocks_{j}"], x, window_size,
                               0 if j % 2 == 0 else shift_size, num_heads,
                               attn_mask, compute)
    x_down = (patch_merging_forward(params["downsample"], x, compute)
              if downsample else x)
    return x, x_down


def patch_embed_forward(params, x: torch.Tensor, patch_size: int,
                        compute: ComputeConfig = ComputeConfig()) -> torch.Tensor:
    """Pad to the patch grid -> conv k=s=patch -> LayerNorm."""
    _, h, w, _ = x.shape
    p = patch_size
    x = F.pad(x, (0, 0, 0, (p - w % p) % p, 0, (p - h % p) % p))
    y = L.conv2d(params["proj"], x, stride=p)
    if "norm" in params:
        y = _ln(params["norm"], y, compute)
    return y


def swin_forward(params, cfg: SwinConfig, x: torch.Tensor,
                 compute: ComputeConfig = ComputeConfig()) -> List[torch.Tensor]:
    """Backbone forward on NHWC input: the four per-stage normalized
    features."""
    compute = _tier(compute, cfg.window_size)
    x = patch_embed_forward(params["patch_embed"], x, cfg.patch_size, compute)
    outs: List[torch.Tensor] = []
    for i, depth in enumerate(cfg.depths):
        x_out, x = basic_layer_forward(
            params[f"layers_{i}"], x, depth, cfg.num_heads[i],
            cfg.window_size, compute, downsample=i < len(cfg.depths) - 1)
        outs.append(_ln(params[f"norm_{i}"], x_out, compute))
    return outs
