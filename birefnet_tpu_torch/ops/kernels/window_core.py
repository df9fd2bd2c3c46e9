"""Host side of the window-attention cores (csrc/window_core.cuh, and its
f32 counterpart csrc/window_core_f32.cuh).

The cores serve two callers, ops/kernels/flash_window_attn.py (K6, K7,
K8) and ops/kernels/fused_block_attn.py (K1 and K1-int8). Both pass them
the score addends as they are, with nothing converted per call and in the
same form for bf16 and f32 activations: the rel-pos bias as [heads, N, N]
f32, and the mask as one of the cores' MaskKinds. This module holds those
kinds and the checks of the addends.

The f32 core computes q s k^T and P v on the tensor cores as three TF32
products each (ops/kernels/tf32.py::window_attention_split emulates it):
the f32 operands are split into TF32 hi and lo parts in registers, and
lo hi + hi lo + hi hi is within about 1e-6 of the f32 product; scores,
softmax and sums stay f32. PyTorch's TF32 flags do not govern it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import window as W

# MaskKind of csrc/window_core.cuh.
NO_MASK, MASK_F32, REGION_IDS, CAUSAL = range(4)


def check_addend(name: str, t: torch.Tensor, shape, dtype: torch.dtype,
                 device) -> None:
    """Check an addend the core reads as it is: a contiguous tensor of
    `shape` and `dtype` on `device`."""
    if (t.shape != shape or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: want a contiguous {shape} {dtype} tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def mask_kind(name: str, mask: Optional[torch.Tensor], n: int, device) -> int:
    """The core's MaskKind for a mask: None, a dense [nW, N, N] f32
    additive mask, or [nW, N] int32 region ids (window.sw_msa_region_ids);
    checks its shape."""
    if mask is None:
        return NO_MASK
    if W.is_region_ids(mask):
        check_addend(f"{name} region ids", mask, (mask.shape[0], n),
                     torch.int32, device)
        return REGION_IDS
    check_addend(f"{name} mask", mask, (mask.shape[0], n, n), torch.float32,
                 device)
    return MASK_F32
