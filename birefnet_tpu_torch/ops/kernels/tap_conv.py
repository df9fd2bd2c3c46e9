"""5x5 tap-accumulation head conv kernel (CUDA C++, csrc/tap_conv.cu).

Replaces birefnet_tpu/ops/pallas/tap_conv.py::_tap_conv: the decoder's
folded ipt1 head, a 5x5 'same' conv from [B, H, W, 3] to [B, H, W] with f32
accumulation and a scalar bias, run once per forward at full resolution
([2, 1024, 1024, 3] bf16 on the main path). The caller overwrites the
outermost ring with the exact two-conv recompute (models/decoder.py).

On the card it is bound by device-memory bandwidth (75 FMAs per 8 bytes
moved); the kernel reads each input pixel once per 16 x 64 output tile
through shared memory. The JAX package's s2d-matmul route was a TPU layout
workaround and is not ported: the plain version is one F.conv2d.

The kernel takes bf16 only. `tap_conv_same` takes the plain version for a
CPU tensor and launches the kernel for a CUDA tensor or raises.
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
    k = _flat_kernel(kernel).contiguous()
    if tuple(k.shape) != (5, 5, 3) or k.device != x.device:
        raise ValueError(f"tap_conv needs a [5, 5, 3] kernel on {x.device}, "
                         f"got {tuple(k.shape)} on {k.device}")
    b = (torch.zeros(1, device=x.device) if bias is None
         else bias.reshape(1).float().contiguous())
    if b.device != x.device:
        raise ValueError(f"tap_conv bias must be on {x.device}")
    bsz, h, w, _ = x.shape
    out = torch.empty((bsz, h, w), dtype=x.dtype, device=x.device)
    fn = build.function("bt_tap_conv5_bf16", 4, 3)
    code = fn(x.data_ptr(), k.data_ptr(), b.data_ptr(), out.data_ptr(), bsz,
              h, w, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "tap_conv")
    tap_conv_same.launches += 1
    return out


tap_conv_same.launches = 0
