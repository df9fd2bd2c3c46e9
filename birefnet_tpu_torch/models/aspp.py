"""Deformable ASPP (regular mode) on NHWC tensors.

Counterpart of birefnet_tpu/models/aspp.py with `deform_mode="regular"`:
each DeformConvASPP runs its regular conv and ignores the offsets and the
modulator, exactly the reference's CPU semantics (reference:
src/aspp.rs:183-185) and the basis of the mask-MAE gate. Faithful
deformable sampling is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..configs import ComputeConfig
from ..ops import layers as L

# Parallel deformable branch kernel sizes (reference: src/aspp.rs:244).
ASPP_DEFORM_KERNELS = (1, 3, 7)


def deform_conv_aspp_forward(params, x: torch.Tensor, kernel_size: int,
                             padding: int, compute: ComputeConfig,
                             stride: int = 1) -> torch.Tensor:
    """DeformConvASPP in regular mode: the bias-free regular conv."""
    if compute.deform_mode != "regular":
        raise NotImplementedError(
            f"deform_mode={compute.deform_mode!r} is not ported yet "
            "(ROADMAP.md, 'Still to port', item 'Faithful deform_conv2d')")
    return L.conv2d(params["regular_conv"], x, stride=stride, padding=padding)


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
