"""Deformable ASPP modules on NHWC tensors.

Counterpart of birefnet_tpu/models/aspp.py: DeformConvASPP (modulated
deformable conv v2), ASPPModuleDeformable (deform -> BN -> ReLU) and
ASPPDeformable (the 5-branch pyramid fused by a 1x1 conv), plus the
standalone DeformableConv2d layer. Two modes, as in the JAX package:
"deformable" (the default) samples at the learned offsets through
ops/deform_conv.py (kernel D1 on the card); "regular" runs the regular
conv and ignores the offsets and the modulator, the reference's CPU
semantics (reference: src/aspp.rs:183-185). "deformable-local" is refused
by ComputeConfig.
"""

from __future__ import annotations

import torch

from ..configs import ComputeConfig
from ..ops import layers as L
from ..ops.deform_conv import deform_conv2d

# Parallel deformable branch kernel sizes (reference: src/aspp.rs:244).
ASPP_DEFORM_KERNELS = (1, 3, 7)


def deform_conv_aspp_forward(params, x: torch.Tensor, kernel_size: int,
                             padding: int, compute: ComputeConfig,
                             stride: int = 1) -> torch.Tensor:
    """DeformConvASPP: offsets from offset_conv (read as f32), the mask
    2*sigmoid(modulator_conv) in f32 rounded to x.dtype, then the modulated
    deformable conv with regular_conv's weight (and bias, if it has one).
    In regular mode, regular_conv alone."""
    if compute.deform_mode == "regular":
        return L.conv2d(params["regular_conv"], x, stride=stride,
                        padding=padding)
    offset = L.conv2d(params["offset_conv"], x, stride=stride, padding=padding)
    mod_raw = L.conv2d(params["modulator_conv"], x, stride=stride,
                       padding=padding)
    mask = (2.0 * torch.sigmoid(mod_raw.float())).to(x.dtype)
    reg = params["regular_conv"]
    return deform_conv2d(x, offset.float(), mask, reg["weight"],
                         bias=reg.get("bias"), stride=stride, padding=padding)


def aspp_module_deformable_forward(params, x: torch.Tensor, kernel_size: int,
                                   padding: int,
                                   compute: ComputeConfig) -> torch.Tensor:
    """DeformConv -> BN(eval) -> ReLU."""
    x = deform_conv_aspp_forward(params["atrous_conv"], x, kernel_size,
                                 padding, compute)
    return L.relu(L.batch_norm_inference(params["bn"], x))


def aspp_deformable_forward(params, x: torch.Tensor,
                            compute: ComputeConfig) -> torch.Tensor:
    """5-branch ASPP: aspp1, the k=1/3/7 branches and the global-pool
    branch, fused by a 1x1 conv over their concat (never materialized: the
    conv's weight is split per branch, and the spatially constant
    global-pool branch is convolved at 1x1 and broadcast)."""
    branches = [aspp_module_deformable_forward(params["aspp1"], x, 1, 0,
                                               compute)]
    for i, k in enumerate(ASPP_DEFORM_KERNELS):
        branches.append(aspp_module_deformable_forward(
            params[f"aspp_deforms_{i}"], x, k, k // 2, compute))

    x5 = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
    x5 = L.conv2d(params["global_avg_pool_conv"], x5)
    x5 = L.relu(L.batch_norm_inference(params["global_avg_pool_bn"], x5))

    weight = params["conv1"]["weight"]
    c_sp = sum(bi.shape[-1] for bi in branches)
    out = L.conv2d_concat({"weight": weight[:, :c_sp]}, branches)
    out = out + L.conv2d({"weight": weight[:, c_sp:]}, x5)
    return L.relu(L.batch_norm_inference(params["bn1"], out))


def deformable_conv2d_forward(params, x: torch.Tensor, kernel_size: int,
                              stride: int = 1, padding: int = 0,
                              compute: ComputeConfig = ComputeConfig()
                              ) -> torch.Tensor:
    """The standalone DeformableConv2d layer (model-unused; API parity with
    birefnet_tpu.models.aspp.deformable_conv2d_forward): offset and
    modulator convs, then modulated deformable sampling with stride and
    the regular conv's bias. params: {offset_conv, modulator_conv,
    regular_conv} conv dicts."""
    return deform_conv_aspp_forward(params, x, kernel_size, padding, compute,
                                    stride=stride)
