"""Row LayerNorm kernel (CUDA C++, csrc/row_ln.cu) for the standalone Swin
LayerNorms.

Replaces birefnet_tpu/ops/pallas/row_ln.py::_row_ln, which runs at the
patch-embed norm, the three patch-merge norms and the four stage-output
norms of each backbone pass (16 calls per forward at Swin-L), on [N, C]
activations from [131072, 192] to [512, 3072].

On the card the op is bound by device-memory bandwidth: 2 bytes read and
2 written per bf16 element, and about 8 flops. The kernel holds each row
in registers at its exact width (csrc/rows.cuh: 16-byte vectors, a group
of 4 to 256 threads per row), takes the f32 statistics there and writes
the row back in the input dtype once, so nothing f32 reaches device
memory (the plain version materializes the f32 upcast and the f32
result). It launches through the library's plain C entry (ctypes).

`layer_norm_rows` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from .. import layers as L
from . import build


def layer_norm_rows_plain(params, x: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: LayerNorm over the last axis, f32 stats."""
    return L.layer_norm(params, x, eps=eps)


def _check(params, x: torch.Tensor) -> int:
    """Raise unless the kernel takes x and params; returns C. Kept to a few
    cheap tensor queries: the launch path sets the time of the small
    calls."""
    if x.dtype is not torch.bfloat16 and x.dtype is not torch.float32:
        raise TypeError(f"row_ln takes bf16 or f32, got {x.dtype}")
    c = x.shape[-1]
    row_bytes = c * x.element_size()
    if not x.is_contiguous() or x.data_ptr() & 15:
        raise ValueError("row_ln needs a contiguous, 16-byte aligned input")
    if row_bytes & 15 or row_bytes > 16 * 2048:
        raise ValueError(f"row_ln kernel needs rows of a multiple of 16 bytes "
                         f"up to 32 KB, got C = {c} of {x.dtype}")
    dev = x.get_device()
    for name in ("scale", "bias"):
        p = params[name]
        if (p.dtype is not torch.float32 or p.shape != (c,)
                or p.get_device() != dev or not p.is_contiguous()
                or p.data_ptr() & 15):
            raise ValueError(f"row_ln {name} must be contiguous 16-byte "
                             f"aligned f32 [{c}] on {x.device}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    return c


def layer_norm_rows(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of [..., C]: plain version on the CPU,
    the CUDA kernel on a CUDA tensor (bf16 or f32)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layer_norm_rows_plain(params, x, eps)
        raise ValueError(f"row_ln runs on cpu or cuda, got {x.device}")
    c = _check(params, x)
    out = torch.empty_like(x)
    n = x.numel() // c if c else 0
    if n:
        code = build.function("bt_row_ln", 4, 3, 1)(
            x.data_ptr(), params["scale"].data_ptr(), params["bias"].data_ptr(),
            out.data_ptr(), n, c, x.dtype is torch.float32, eps,
            build.stream(x.device))
        build.check(code, "row_ln")
        layer_norm_rows.launches += 1
    return out


layer_norm_rows.launches = 0
