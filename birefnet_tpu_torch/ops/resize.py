"""Resize ops on NHWC (or channel-less NHW) tensors as separable matrices.

Counterpart of birefnet_tpu/ops/resize.py. Each resize is two dense
contractions with a [dst, src] interpolation matrix along H and along W.
The numpy matrix functions are copied from the JAX package, so both
packages interpolate with identical weights: align-corners bilinear
(PyTorch `align_corners=True` semantics), the antialiased half-pixel
triangle filter of the preprocessing resize, and the antialiased Lanczos3
filter of the mask resize. `F.interpolate` is not used: its antialiased
modes do not match these filters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .device_cache import device_cache


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(src: int, dst: int) -> np.ndarray:
    """Dense [dst, src] bilinear matrix, align_corners=True."""
    m = np.zeros((dst, src), dtype=np.float32)
    if src == 1 or dst == 1:
        m[:, 0] = 1.0
        return m
    scale = (src - 1) / (dst - 1)
    coords = np.arange(dst, dtype=np.float64) * scale
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, src - 1)
    hi = np.minimum(lo + 1, src - 1)
    frac = (coords - lo).astype(np.float32)
    rows = np.arange(dst)
    m[rows, lo] += 1.0 - frac
    m[rows, hi] += frac
    return m


@functools.lru_cache(maxsize=None)
def _lanczos3_matrix(src: int, dst: int) -> np.ndarray:
    """Dense [dst, src] Lanczos-3 matrix, half-pixel centers, antialiased
    on downscale."""
    a = 3.0
    scale = src / dst
    support = a * max(scale, 1.0)
    m = np.zeros((dst, src), dtype=np.float64)
    src_idx = np.arange(src, dtype=np.float64)

    def lanczos(t: np.ndarray) -> np.ndarray:
        t = np.abs(t)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(
                t < 1e-8, 1.0,
                a * np.sin(np.pi * t) * np.sin(np.pi * t / a)
                / (np.pi * np.pi * t * t))
        return np.where(t >= a, 0.0, out)

    norm = max(scale, 1.0)
    for i in range(dst):
        center = (i + 0.5) * scale - 0.5
        t = (src_idx - center) / norm
        weights = np.where(np.abs(src_idx - center) <= support, lanczos(t), 0.0)
        s = weights.sum()
        m[i] = weights / s if s != 0 else 0.0
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _triangle_matrix(src: int, dst: int) -> np.ndarray:
    """Dense [dst, src] half-pixel triangle (bilinear) matrix, antialiased
    on downscale."""
    scale = src / dst
    support = max(scale, 1.0)
    m = np.zeros((dst, src), dtype=np.float64)
    src_idx = np.arange(src, dtype=np.float64)
    for i in range(dst):
        center = (i + 0.5) * scale - 0.5
        weights = np.clip(1.0 - np.abs(src_idx - center) / support, 0.0, None)
        s = weights.sum()
        if s > 0:
            m[i] = weights / s
        else:
            m[i, int(np.clip(round(center), 0, src - 1))] = 1.0
    return m.astype(np.float32)


@device_cache(maxsize=256)
def _device_matrix(matrix_fn, src: int, dst: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """matrix_fn's matrix as a tensor on `device`, copied once per
    (shape, device, dtype) rather than at every call. Built outside
    inference mode, so that a forward autograd records (training) may use
    the copy a forward under torch.inference_mode (serving) cached."""
    with torch.inference_mode(False):
        return torch.from_numpy(matrix_fn(src, dst)).to(device=device,
                                                        dtype=dtype)


def _apply_separable(x: torch.Tensor, out_h: int, out_w: int,
                     matrix_fn) -> torch.Tensor:
    """Apply a separable [dst, src] filter pair on NHWC (4D) or NHW (3D)
    input, in the contraction order of the JAX package (the H contraction
    runs on the smaller side of the W resize)."""
    if x.ndim == 3:
        _, h, w = x.shape
        eq_h, eq_w = "oh,bhw->bow", "ow,bhw->bho"
    else:
        _, h, w, _ = x.shape
        eq_h, eq_w = "oh,bhwc->bowc", "ow,bhwc->bhoc"

    def along_h(t):
        return torch.einsum(eq_h, _device_matrix(matrix_fn, h, out_h, t.device,
                                                 t.dtype), t)

    def along_w(t):
        return torch.einsum(eq_w, _device_matrix(matrix_fn, w, out_w, t.device,
                                                 t.dtype), t)

    if out_w < w:
        if w != out_w:
            x = along_w(x)
        if h != out_h:
            x = along_h(x)
    else:
        if h != out_h:
            x = along_h(x)
        if w != out_w:
            x = along_w(x)
    return x


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True on NHWC (or NHW) input."""
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    return _apply_separable(x, out_h, out_w, _align_corners_matrix)


def resize_lanczos3(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Separable Lanczos-3 resize on NHWC (or NHW) input."""
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    return _apply_separable(x, out_h, out_w, _lanczos3_matrix)


def resize_bilinear_half_pixel(x: torch.Tensor, out_h: int,
                               out_w: int) -> torch.Tensor:
    """Antialiased half-pixel triangle-filter resize on NHWC input (the
    preprocessing resize)."""
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    return _apply_separable(x, out_h, out_w, _triangle_matrix)
