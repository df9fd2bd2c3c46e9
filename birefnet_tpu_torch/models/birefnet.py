"""BiRefNet model assembly on NHWC tensors.

Counterpart of birefnet_tpu/models/birefnet.py: the Swin backbone at full
and half scale, the multi-scale and cxt concats, the squeeze block and the
decoder. `forward_logits` maps a normalized [B, H, W, 3] image to
[B, H, W, 1] logits (pipeline.py applies the sigmoid in f32).
"""

from __future__ import annotations

import torch

from ..configs import BiRefNetConfig, ComputeConfig
from ..ops.resize import resize_bilinear_align_corners
from .decoder import basic_dec_blk_forward, decoder_forward
from .swin import swin_forward


def squeeze_module_forward(params, x: torch.Tensor,
                           compute: ComputeConfig) -> torch.Tensor:
    """The squeeze BasicDecBlk(s); Swin-L has one 5760->3072 block."""
    i = 0
    while f"blocks_{i}" in params:
        x = basic_dec_blk_forward(params[f"blocks_{i}"], x, compute)
        i += 1
    return x


def forward_logits(params, cfg: BiRefNetConfig, x: torch.Tensor,
                   compute: ComputeConfig = ComputeConfig()) -> torch.Tensor:
    """[B, H, W, 3] normalized image (H, W divisible by 32) -> [B, H, W, 1]."""
    _, h, w, _ = x.shape
    if h % 32 or w % 32:
        raise ValueError(f"BiRefNet input H and W must be divisible by 32; "
                         f"got {h}x{w}. Resize first (pipeline.preprocess).")
    swin_cfg = cfg.swin_config()
    feats = swin_forward(params["bb"], swin_cfg, x, compute)
    x1, x2, x3, x4 = feats
    if cfg.mul_scl_ipt:
        x_half = resize_bilinear_align_corners(x, h // 2, w // 2)
        feats_half = swin_forward(params["bb"], swin_cfg, x_half, compute)
        ups = [resize_bilinear_align_corners(fh, f.shape[1], f.shape[2])
               for f, fh in zip(feats, feats_half)]
        x1 = torch.cat([x1, ups[0]], dim=-1)
        x2 = torch.cat([x2, ups[1]], dim=-1)
        x3 = torch.cat([x3, ups[2]], dim=-1)
        x4 = torch.cat([x4, ups[3]], dim=-1)
    if cfg.cxt:
        h4, w4 = x4.shape[1:3]
        x4 = torch.cat([resize_bilinear_align_corners(x1, h4, w4),
                        resize_bilinear_align_corners(x2, h4, w4),
                        resize_bilinear_align_corners(x3, h4, w4), x4], dim=-1)
    x4 = squeeze_module_forward(params["squeeze_module"], x4, compute)
    return decoder_forward(params["decoder"], cfg, x, x1, x2, x3, x4,
                           compute)[..., None]
