"""Row LayerNorm kernel (Triton) for the standalone Swin LayerNorms.

Replaces birefnet_tpu/ops/pallas/row_ln.py::_row_ln, which runs at the
patch-embed norm, the three patch-merge norms and the four stage-output
norms of each backbone pass (16 calls per forward at Swin-L), on [N, C]
activations from [131072, 192] to [2048, 3072].

On the card the op is bound by device-memory bandwidth: 2 bytes read and
2 written per bf16 element, and about 8 flops. The Triton kernel reads
each row once into registers, takes the f32 statistics there and writes
the row back in the input dtype, so nothing f32 reaches device memory (the
plain version materializes the f32 upcast and the f32 result).

`layer_norm_rows` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from .. import layers as L


def layer_norm_rows_plain(params, x: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: LayerNorm over the last axis, f32 stats."""
    return L.layer_norm(params, x, eps=eps)


def _check(params, x: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"row_ln takes bf16 or f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("row_ln needs a contiguous input")
    c = x.shape[-1]
    for name in ("scale", "bias"):
        p = params[name]
        if (p.dtype != torch.float32 or tuple(p.shape) != (c,)
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"row_ln {name} must be contiguous f32 [{c}] on "
                             f"{x.device}, got {p.dtype} {tuple(p.shape)} "
                             f"on {p.device}")


def _launch(params, x2d: torch.Tensor, out: torch.Tensor, eps: float) -> None:
    import triton

    from .row_ln_triton import row_ln_kernel

    n, c = x2d.shape
    block_c = triton.next_power_of_2(c)
    rows = max(1, min(16, 4096 // block_c))
    grid = (triton.cdiv(n, rows),)
    row_ln_kernel[grid](x2d, params["scale"], params["bias"], out, n, c, eps,
                        BLOCK_C=block_c, ROWS=rows,
                        num_warps=4 if block_c <= 1024 else 8)


def layer_norm_rows(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of [..., C]: plain version on the CPU,
    the Triton kernel on a CUDA tensor (bf16 or f32)."""
    if x.device.type == "cpu":
        return layer_norm_rows_plain(params, x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"row_ln runs on cpu or cuda, got {x.device}")
    _check(params, x)
    c = x.shape[-1]
    x2d = x.reshape(-1, c)
    out = torch.empty_like(x2d)
    _launch(params, x2d, out, eps)
    layer_norm_rows.launches += 1
    return out.reshape(x.shape)


layer_norm_rows.launches = 0
