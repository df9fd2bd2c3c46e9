"""5x5 tap-accumulation head conv kernel (CUDA C++, csrc/tap_conv.cu).

Replaces birefnet_tpu/ops/pallas/tap_conv.py::_tap_conv: the decoder's
folded ipt1 head, a 5x5 'same' conv from [B, H, W, 3] to [B, H, W] with f32
accumulation and a scalar bias, run once per forward at full resolution
([2, 1024, 1024, 3] bf16 on the main path). The caller overwrites the
outermost ring with the exact two-conv recompute (models/decoder.py).

On the card its f32 FMAs (157 M, 4.7 us at 67 TFLOP/s) and its bytes
(16.8 MB, 5.0 us at 3.35 TB/s) bound it about equally; the kernel keeps
4 x 4 outputs per thread in registers, each staged input value feeding up
to 20 of them, on a persistent grid that streams the next tile in while
the current one computes (csrc/tap_conv.cu). The JAX package's s2d-matmul
route was a TPU layout workaround and is not ported: the plain version is
one F.conv2d.

The kernel takes bf16 only. `tap_conv_same` takes the plain version for a
CPU tensor and launches the kernel for a CUDA tensor or raises. An f32
kernel tensor of 75 contiguous values and an f32 bias of one (or None)
are passed to the kernel as they are: the wrapper copies nothing per call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import build


def _flat_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """[5, 5, 3, 1] or [5, 5, 3] (HWI order) -> [5, 5, 3] f32."""
    return (kernel[..., 0] if kernel.ndim == 4 else kernel).float()


def tap_conv_same_plain(x: torch.Tensor, kernel: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: F.conv2d(padding=2) in f32, cast to x.dtype."""
    k = _flat_kernel(kernel)
    kk = k.shape[0]
    w = k.permute(2, 0, 1)[None]  # [1, Cin, K, K]
    b = None if bias is None else bias.reshape(1).float()
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w, b, padding=(kk - 1) // 2)
    return y[:, 0].to(x.dtype)


def tap_conv_same(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """5x5 'same' conv [B, H, W, 3] -> [B, H, W]: plain version on the CPU,
    the CUDA kernel on a CUDA tensor (bf16 only)."""
    if x.device.type == "cpu":
        return tap_conv_same_plain(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"tap_conv runs on cpu or cuda, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"tap_conv kernel takes bf16, got {x.dtype}")
    if x.ndim != 4 or x.shape[-1] != 3 or not x.is_contiguous():
        raise ValueError(f"tap_conv needs a contiguous [B, H, W, 3] input, "
                         f"got {tuple(x.shape)}")
    k = kernel
    if k.dtype != torch.float32 or not k.is_contiguous():
        k = k.float().contiguous()
    if (k.numel() != 75 or tuple(k.shape[:3]) != (5, 5, 3)
            or k.device != x.device):
        raise ValueError(f"tap_conv needs a [5, 5, 3] or [5, 5, 3, 1] kernel "
                         f"on {x.device}, got {tuple(kernel.shape)} on "
                         f"{kernel.device}")
    b = bias
    if b is not None:
        if b.dtype != torch.float32 or not b.is_contiguous():
            b = b.float().contiguous()
        if b.numel() != 1 or b.device != x.device:
            raise ValueError(f"tap_conv bias must be one value on {x.device}")
    bsz, h, w, _ = x.shape
    out = torch.empty((bsz, h, w), dtype=x.dtype, device=x.device)
    fn = build.function("bt_tap_conv5_bf16", 4, 3)
    code = fn(x.data_ptr(), k.data_ptr(), None if b is None else b.data_ptr(),
              out.data_ptr(), bsz, h, w, build.stream(x.device))
    build.check(code, "tap_conv")
    tap_conv_same.launches += 1
    return out


tap_conv_same.launches = 0
