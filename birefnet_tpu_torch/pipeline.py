"""uint8 frames -> masks inference pipeline on one device.

Counterpart of birefnet_tpu/pipeline.py: antialiased triangle resize to the
model size, /255 and ImageNet normalization, the model, sigmoid, and the
Lanczos3 resize back, all on the device; only uint8 frames go in and
masks come out. PyTorch runs it eagerly, so `make_infer_fn` is one plain
function (the JAX package's staged executables were a TPU compile-size
workaround and are not ported).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from .configs import IMAGENET_MEAN, IMAGENET_STD, BiRefNetConfig, ComputeConfig
from .models import birefnet
from .ops.resize import resize_bilinear_half_pixel, resize_lanczos3
from .params import (cast_matmul_weights, quantize_attn_int8,
                     quantize_mlp_int8, split_tf32_weights, to_device)


def preprocess(frames_u8: torch.Tensor, size: Tuple[int, int] = (1024, 1024),
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> normalized [B, size[0], size[1], 3]."""
    x = frames_u8.float() / 255.0
    x = resize_bilinear_half_pixel(x, size[1], size[0])
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def postprocess(mask: torch.Tensor, out_h: int, out_w: int,
                as_uint8: bool = True) -> torch.Tensor:
    """[B, h, w, 1] or [B, h, w] mask -> [B, out_h, out_w], Lanczos3
    resized, optionally quantized to uint8."""
    if mask.ndim == 4:
        mask = mask[..., 0]
    m = resize_lanczos3(mask.float(), out_h, out_w)
    if as_uint8:
        m = torch.clamp(torch.round(m * 255.0), 0.0, 255.0).to(torch.uint8)
    return m


@contextlib.contextmanager
def full_f32():
    """Both of PyTorch's TF32 flags off inside, the caller's values back
    after. cuDNN's flag defaults to True, which runs every f32 convolution
    in TF32 (about three decimal digits); the JAX package's f32 contract
    is precision=HIGHEST at every conv and dot."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def make_infer_fn(params, cfg: BiRefNetConfig,
                  compute: ComputeConfig = ComputeConfig(), device=None,
                  out_size: Optional[Tuple[int, int]] = None,
                  as_uint8: bool = True):
    """Build the uint8-in -> mask-out inference function on `device`.

    `device` defaults to the CUDA device; pass "cpu" to run the plain
    PyTorch versions on the CPU. The tree is moved to `device` once, here;
    under `compute.int8_mlp` / `int8_attn` the wide Swin blocks' weights
    are quantized from the f32 values (params.quantize_*_int8) before the
    matmul and conv weights are cast to `compute.dtype`, as the JAX
    package does; on the f32 kernel tier on the card the Swin blocks'
    f32 GEMM weights are split into their TF32 parts once
    (params.split_tf32_weights). The returned function takes [B, H, W, 3]
    uint8 frames (numpy or tensor) and returns [B, out_h, out_w] masks on the device,
    out_size defaulting to the frame size. With an f32 `compute` it runs
    with PyTorch's TF32 flags off (`full_f32`), the int8 flags included.
    """
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_infer_fn runs on the CUDA device unless "
                           "device='cpu' is given, and no CUDA device is "
                           "available")
    # f32 runs every convolution and product in full f32, whatever TF32
    # flags the caller has set; bf16 leaves them alone.
    precision = (full_f32 if compute.dtype == torch.float32
                 else contextlib.nullcontext)
    params = to_device(params, device)
    if compute.int8_mlp:
        params = quantize_mlp_int8(params)
    if compute.int8_attn:
        params = quantize_attn_int8(params)
    params = cast_matmul_weights(params, compute.dtype)
    if (device.type == "cuda" and compute.dtype == torch.float32
            and compute.use_flash_attention):
        # The f32 GEMM reads each weight's TF32 hi and lo parts: split once.
        params = split_tf32_weights(params)

    @torch.inference_mode()
    def infer(frames_u8) -> torch.Tensor:
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(frames_u8)
        frames_u8 = frames_u8.to(device)
        _, h, w, _ = frames_u8.shape
        oh, ow = out_size if out_size is not None else (h, w)
        with precision():
            x = preprocess(frames_u8, cfg.size, dtype=compute.dtype)
            # Sigmoid in f32 on the logits: a bf16 mask would round every
            # value near 0.5 by up to 2e-3 (measured on the card: mask MAE
            # 8.5e-4 against the f32 pipeline with bf16 masks, with logits
            # off by only 5e-4).
            logits = birefnet.forward_logits(params, cfg, x, compute)
            return postprocess(torch.sigmoid(logits.float()), oh, ow,
                               as_uint8=as_uint8)

    return infer
