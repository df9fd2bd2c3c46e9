"""BiRefNet decoder on NHWC tensors.

Counterpart of birefnet_tpu/models/decoder.py: SimpleConvs, the lateral and
decoder blocks, the GDT gates, the image2patches input pyramid and the
folded final head. The head folds as in the JAX package: the 1x1 conv_out1
is absorbed into decoder_block1's conv_out/bn_out (the p1 branch) and into
ipt_blk1's conv pair, which is composed into one 5x5 conv from the image
with an exact recompute of the outermost output ring. On the kernel tier,
a bf16 CUDA image runs that 5x5 conv through the tap-conv kernel, unless
`compute.differentiable` is set.
"""

from __future__ import annotations

import torch

from ..configs import BiRefNetConfig, ComputeConfig
from ..ops import layers as L
from ..ops.kernels.tap_conv import tap_conv_same
from ..ops.resize import resize_bilinear_align_corners
from .aspp import aspp_deformable_forward


def simple_convs_forward(params, x: torch.Tensor) -> torch.Tensor:
    """conv3x3 -> conv3x3 with no activation between."""
    return L.conv2d(params["conv_out"], L.conv2d(params["conv1"], x, padding=1),
                    padding=1)


def basic_lat_blk_forward(params, x) -> torch.Tensor:
    """1x1 lateral projection; `x` may be a parts list for its channel concat."""
    if isinstance(x, (list, tuple)):
        return L.conv2d_concat(params["conv"], list(x))
    return L.conv2d(params["conv"], x)


def basic_dec_blk_forward(params, x, compute: ComputeConfig,
                          use_aspp_deformable: bool = True,
                          return_pre_out: bool = False) -> torch.Tensor:
    """conv_in -> BN -> ReLU -> [ASPP] -> conv_out -> BN (no final ReLU).
    `x` may be a parts list standing for its channel concat;
    `return_pre_out` stops before conv_out (folded into the final head)."""
    if isinstance(x, (list, tuple)):
        x = L.conv2d_concat(params["conv_in"], list(x), padding=1)
    else:
        x = L.conv2d(params["conv_in"], x, padding=1)
    x = L.relu(L.batch_norm_inference(params["bn_in"], x))
    if use_aspp_deformable:
        x = aspp_deformable_forward(params["dec_att"], x, compute)
    if return_pre_out:
        return x
    x = L.conv2d(params["conv_out"], x, padding=1)
    return L.batch_norm_inference(params["bn_out"], x)


def gdt_convs_forward(params, x: torch.Tensor) -> torch.Tensor:
    """conv3x3(in->16) -> BN -> ReLU."""
    x = L.conv2d(params["conv"], x, padding=1)
    return L.relu(L.batch_norm_inference(params["bn"], x))


def image2patches(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """[B, gh*th, gw*tw, C] -> [B, th, tw, C*gh*gw], output channel index
    (c*gh + i)*gw + j (the reference's NCHW channel order)."""
    b, h, w, c = x.shape
    gh, gw = h // target_h, w // target_w
    x = x.reshape(b, gh, target_h, gw, target_w, c).permute(0, 2, 4, 5, 1, 3)
    return x.reshape(b, target_h, target_w, c * gh * gw)


def use_tap_conv(dtype: torch.dtype, device, compute: ComputeConfig) -> bool:
    """Whether the composed 5x5 head runs the tap-conv kernel: a bf16 CUDA
    image on the kernel tier, unless `compute.differentiable` asks for a
    differentiable forward (the kernel computes no gradient), as in
    birefnet_tpu/models/decoder.py:194-204."""
    return (dtype == torch.bfloat16 and torch.device(device).type == "cuda"
            and compute.use_flash_attention and not compute.differentiable)


def _composed_pair_conv(pa, pb, x: torch.Tensor,
                        compute: ComputeConfig) -> torch.Tensor:
    """conv3x3_B(conv3x3_A(x)) with a single output channel, as ONE composed
    5x5 conv plus the exact two-conv recompute of the outermost ring.
    Returns channel-less [B, H, W] logits."""
    wa = pa["weight"].float().permute(2, 3, 1, 0)  # HWIO
    wb = pb["weight"].float().permute(2, 3, 1, 0)
    kh, kw, ci, _ = wa.shape
    co = wb.shape[-1]
    if co != 1:
        raise ValueError("the composed head is single-channel")
    k_comp = torch.zeros((kh + 2, kw + 2, ci, co), device=wa.device)
    for u1 in range(kh):
        for v1 in range(kw):
            k_comp[u1:u1 + 3, v1:v1 + 3] += torch.einsum(
                "im,uvmo->uvio", wa[u1, v1], wb)
    b_comp = None
    if "bias" in pa:
        b_comp = torch.einsum("uvmo,m->o", wb, pa["bias"].float())
    if "bias" in pb:
        bb = pb["bias"].float()
        b_comp = bb if b_comp is None else b_comp + bb

    if use_tap_conv(x.dtype, x.device, compute):
        out = tap_conv_same(x.contiguous(), k_comp, b_comp)
    else:
        comp = {"weight": k_comp.permute(3, 2, 0, 1)}
        if b_comp is not None:
            comp["bias"] = b_comp
        out = L.conv2d(comp, x, padding=2)[..., 0]

    def pair(strip):
        return L.conv2d(pb, L.conv2d(pa, strip, padding=1), padding=1)[..., 0]

    h, w = x.shape[1:3]
    top = pair(x[:, 0:3])[:, 0:1]
    bot = pair(x[:, h - 3:])[:, 2:3]
    left = pair(x[:, :, 0:3])[:, :, 0:1]
    right = pair(x[:, :, w - 3:])[:, :, 2:3]
    out = torch.cat([top, out[:, 1:h - 1], bot], dim=1)
    return torch.cat([left, out[:, :, 1:w - 1], right], dim=2)


def input_pyramid(params, cfg: BiRefNetConfig, x: torch.Tensor,
                  compute: ComputeConfig):
    """ipt_blk5..2 on image2patches plus the folded full-resolution ipt1
    head logit (channel-less)."""
    _, h, w, _ = x.shape
    ipt = {
        f"ipt{k}": simple_convs_forward(params[f"ipt_blk{k}"],
                                        image2patches(x, h // g, w // g))
        for k, g in ((5, 32), (4, 16), (3, 8), (2, 4))
    }
    ipt1p = params["ipt_blk1"]
    k_head = params["conv_out1"]["weight"][0, :, 0, 0].float()  # [240]
    dec_out1_c = params["decoder_block1"]["conv_out"]["weight"].shape[0]
    k_ipt1 = k_head[dec_out1_c:]                                 # [48]
    w_i1 = torch.einsum("dchw,d->chw",
                        ipt1p["conv_out"]["weight"].float(), k_ipt1)[None]
    b_i1 = (ipt1p["conv_out"]["bias"].float() * k_ipt1).sum()
    ipt["logit_ipt1"] = _composed_pair_conv(
        ipt1p["conv1"], {"weight": w_i1, "bias": b_i1[None]}, x, compute)
    return ipt


def decoder_forward(params, cfg: BiRefNetConfig, x: torch.Tensor, x1, x2, x3,
                    x4: torch.Tensor, compute: ComputeConfig) -> torch.Tensor:
    """Full decoder on NHWC inputs; returns channel-less [B, H, W] logits."""
    pyramid = input_pyramid(params, cfg, x, compute)
    h, w = pyramid["logit_ipt1"].shape[1:3]
    h1, w1 = x1.shape[1:3]
    h2, w2 = x2.shape[1:3]
    h3, w3 = x3.shape[1:3]

    def gdt_gate(p, stage: str):
        g = gdt_convs_forward(params[f"gdt_convs_{stage}"], p)
        return p * L.sigmoid(L.conv2d(params[f"gdt_convs_attn_{stage}"], g))

    p4 = basic_dec_blk_forward(params["decoder_block4"], [x4, pyramid["ipt5"]],
                               compute, cfg.use_aspp_deformable)
    p4 = gdt_gate(p4, "4")
    p3_in = (resize_bilinear_align_corners(p4, h3, w3)
             + basic_lat_blk_forward(params["lateral_block4"], x3))

    ipt4_up = resize_bilinear_align_corners(pyramid["ipt4"], h3, w3)
    p3 = basic_dec_blk_forward(params["decoder_block3"], [p3_in, ipt4_up],
                               compute, cfg.use_aspp_deformable)
    p3 = gdt_gate(p3, "3")
    p2_in = (resize_bilinear_align_corners(p3, h2, w2)
             + basic_lat_blk_forward(params["lateral_block3"], x2))

    ipt3_up = resize_bilinear_align_corners(pyramid["ipt3"], h2, w2)
    p2 = basic_dec_blk_forward(params["decoder_block2"], [p2_in, ipt3_up],
                               compute, cfg.use_aspp_deformable)
    p2 = gdt_gate(p2, "2")
    p1_in = (resize_bilinear_align_corners(p2, h1, w1)
             + basic_lat_blk_forward(params["lateral_block2"], x1))

    ipt2_up = resize_bilinear_align_corners(pyramid["ipt2"], h1, w1)
    p1_feat = basic_dec_blk_forward(
        params["decoder_block1"], [p1_in, ipt2_up], compute,
        cfg.use_aspp_deformable, return_pre_out=True)

    # p1 branch of the head: conv_out1 (1x1) o bn_out o conv_out (3x3)
    # folded into one 3x3 conv 64->1.
    blk1 = params["decoder_block1"]
    k_head = params["conv_out1"]["weight"][0, :, 0, 0].float()
    dec_out1_c = blk1["conv_out"]["weight"].shape[0]
    k_p1 = k_head[:dec_out1_c]
    bn = blk1["bn_out"]
    w_p1 = torch.einsum("dchw,d,d->chw", blk1["conv_out"]["weight"].float(),
                        bn["scale"], k_p1)[None]
    b_p1 = ((bn["scale"] * blk1["conv_out"]["bias"] + bn["shift"]) * k_p1).sum()
    logit_p1 = L.conv2d({"weight": w_p1, "bias": b_p1[None]}, p1_feat,
                        padding=1)

    logits = (resize_bilinear_align_corners(logit_p1[..., 0], h, w)
              + pyramid["logit_ipt1"])
    if "bias" in params["conv_out1"]:
        logits = logits + params["conv_out1"]["bias"].to(logits.dtype)
    return logits
