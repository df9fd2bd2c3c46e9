"""Window ops for shifted-window attention (NHWC torch tensors).

Counterpart of birefnet_tpu/ops/window.py: partition/reverse, cyclic roll,
the SW-MSA mask with -100.0 entries (reference: src/swin.rs:603-655), its
roll-free offset variant, and the relative-position index, all with the
JAX package's values. The masks are built on the device from arange, once
per geometry and device (ops/device_cache.py, which lets a captured CUDA
graph own what it reads), in two forms: the dense [nW, N, N]
additive mask of the plain path, and the [nW, N] int32 region ids the
kernel tier takes (mask -100 where two tokens' ids differ).

Windows are [B*nW, ws*ws, C] with the window grid enumerated row-major.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .device_cache import device_cache


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C]; H and W multiples of ws."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // ws) * (w // ws), ws * ws, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int,
                   w: int) -> torch.Tensor:
    """[B*nW, ws*ws, C] -> [B, H, W, C]."""
    ws = window_size
    b_nw, _, c = windows.shape
    b = b_nw // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def roll_2d(x: torch.Tensor, shift_h: int, shift_w: int) -> torch.Tensor:
    """Cyclic shift over H and W of an NHWC tensor."""
    return torch.roll(x, shifts=(shift_h, shift_w), dims=(1, 2))


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: int) -> np.ndarray:
    """[ws*ws, ws*ws] int32 index into the (2*ws-1)^2 bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    rel = coords_flat[:, :, None] - coords_flat[:, None, :]
    rel_h = rel[0] + (ws - 1)
    rel_w = rel[1] + (ws - 1)
    return (rel_h * (2 * ws - 1) + rel_w).astype(np.int32)


def _region_ids_dev(hp: int, wp: int, window_size: int, shift_size: int,
                    device) -> torch.Tensor:
    """[hp//ws, wp//ws, ws*ws] int32 region ids of the 9-region fill."""
    ws = window_size
    row = torch.arange(hp, device=device, dtype=torch.int32)
    col = torch.arange(wp, device=device, dtype=torch.int32)
    rr = (row >= hp - ws).int() + (row >= hp - shift_size).int()
    cc = (col >= wp - ws).int() + (col >= wp - shift_size).int()
    img = rr[:, None] * 3 + cc[None, :]
    m = img.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3)
    return m.reshape(hp // ws, wp // ws, ws * ws)


def region_mask(ids: torch.Tensor) -> torch.Tensor:
    """[nW, N] region ids -> the [nW, N, N] float32 mask of 0 / -100.0,
    -100 where the ids of query i and key j differ."""
    diff = ids[:, None, :] - ids[:, :, None]
    # Python scalars, not tensors built on ids.device: a host-to-device copy
    # per call is what CUDA graph capture refuses (pipeline.make_infer_fn).
    return torch.where(diff != 0, -100.0, 0.0).to(torch.float32)


def is_region_ids(mask: Optional[torch.Tensor]) -> bool:
    """True for an [nW, N] int32 region-id form of an SW-MSA mask."""
    return mask is not None and mask.dtype == torch.int32


def dense_mask(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The [nW, N, N] additive mask of either form: region ids expand to
    0 / -100, a dense mask or None passes through."""
    return region_mask(mask) if is_region_ids(mask) else mask


@device_cache(maxsize=64)
def sw_msa_region_ids(hp: int, wp: int, window_size: int, shift_size: int,
                      device=None, offset: bool = False) -> torch.Tensor:
    """[nW, ws*ws] int32 region ids of the SW-MSA mask (9-region fill; with
    `offset`, of the roll-free offset partition's mask), on `device`.

    Built once per geometry and device and shared by every caller, which
    must not write to it: the kernel tier's form of the mask
    (ops/kernels/flash_window_attn.py), 4 bytes per token in place of the
    dense mask's 4 N bytes."""
    ws = window_size
    with torch.inference_mode(False):
        m = _region_ids_dev(hp, wp, ws, shift_size, device)
        if offset:
            m = torch.roll(m, shifts=(1, 1), dims=(0, 1))
        return m.reshape(-1, ws * ws).contiguous()


@device_cache(maxsize=64)
def sw_msa_mask(hp: int, wp: int, window_size: int, shift_size: int,
                device=None) -> torch.Tensor:
    """SW-MSA attention mask [nW, ws*ws, ws*ws] float32 of 0 / -100.0
    (9-region fill; hp/wp are the window-padded dims), on `device`; built
    once per geometry and device (callers must not write to it)."""
    with torch.inference_mode(False):
        return region_mask(sw_msa_region_ids(hp, wp, window_size, shift_size,
                                             device))


@device_cache(maxsize=64)
def sw_msa_mask_offset(hp: int, wp: int, window_size: int, shift_size: int,
                       device=None) -> torch.Tensor:
    """SW-MSA mask for the roll-free OFFSET window partition: the cyclic
    mask with the window grid rolled by one window (derivation in
    birefnet_tpu/ops/window.py::sw_msa_mask_offset), on `device`; built
    once per geometry and device."""
    with torch.inference_mode(False):
        return region_mask(sw_msa_region_ids(hp, wp, window_size, shift_size,
                                             device, offset=True))


def pad_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad H and W (bottom/right) of NHWC input up to a multiple."""
    _, h, w, _ = x.shape
    pad_b = (multiple - h % multiple) % multiple
    pad_r = (multiple - w % multiple) % multiple
    if pad_b == 0 and pad_r == 0:
        return x
    return F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
