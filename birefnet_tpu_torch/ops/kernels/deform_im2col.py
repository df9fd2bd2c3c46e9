"""D1: the deformable-im2col kernel (CUDA C++, csrc/deform_im2col.cu).

The modulated deformable conv v2 of the decoder's 20 ASPP sites samples
its input at learned sub-pixel offsets: per output position and tap, four
bilinear corners, weighted by the modulation mask. The JAX package
computes that sampling as an XLA gather and a 4-corner einsum
(birefnet_tpu/ops/deform_conv.py:68-139), not as a Pallas kernel; this is
its port. `deform_im2col` returns the column buffer [B*OH*OW, K*C] (taps
major, channels minor) in x's dtype; the contraction with the weight is a
matmul beside it (ops/deform_conv.py).

A plain PyTorch gather materializes the [B, P, K, 4, C] corner values
(3.3 GB in bf16 at the 256^2, k = 7 site of a 1024^2 batch-2 forward);
the kernel reads each corner row from x (which stays in L2) and writes
each column once. Its bound is the columns' bytes: 1.35 GB per bf16
forward.

`deform_im2col` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises; it never falls back. The kernel
computes the plain version's f32 operations in the same order without FMA
contraction, so the two give bitwise the same columns.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

# Bytes of the f32 corner products the plain version holds per block of
# output positions (birefnet_tpu/ops/deform_conv.py: _IM2COL_BUDGET).
_IM2COL_BUDGET = 96 * 1024 * 1024


def output_size(h: int, w: int, kh: int, kw: int, stride: int, padding: int,
                dilation: int) -> Tuple[int, int]:
    """(OH, OW) of a conv with symmetric padding."""
    oh = (h + 2 * padding - (dilation * (kh - 1) + 1)) // stride + 1
    ow = (w + 2 * padding - (dilation * (kw - 1) + 1)) // stride + 1
    return oh, ow


def deform_im2col_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, kh: int, kw: int, stride: int = 1,
                        padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version. x [B, H, W, C]; offset [B, OH, OW, 2K] ((dy,
    dx) per row-major tap, read as f32); mask [B, OH, OW, K] (read as f32).
    Returns cols [B*OH*OW, K*C] in x.dtype.

    Per (position, tap): ys = (base + tap) + dy in f32; the sample is zero
    unless -1 < ys < H and -1 < xs < W, each corner also outside the image;
    corner weight ((wy * wx) * valid) * mask rounded to x.dtype; the corner
    sum ((q00 + q01) + q10) + q11 of f32 products, rounded to x.dtype. The
    gather runs over blocks of positions under a byte budget."""
    b, h, w, c = x.shape
    k = kh * kw
    oh, ow = output_size(h, w, kh, kw, stride, padding, dilation)
    p = oh * ow
    dev, f32 = x.device, torch.float32
    base_y = torch.arange(oh, dtype=f32, device=dev) * stride - padding
    base_x = torch.arange(ow, dtype=f32, device=dev) * stride - padding
    tap_y = (torch.arange(kh, dtype=f32, device=dev) * dilation).repeat_interleave(kw)
    tap_x = (torch.arange(kw, dtype=f32, device=dev) * dilation).repeat(kh)
    by = base_y[:, None].expand(oh, ow).reshape(p, 1) + tap_y  # [P, K], exact
    bx = base_x[None, :].expand(oh, ow).reshape(p, 1) + tap_x
    off = offset.float().reshape(b, p, k, 2)
    ys = by + off[..., 0]  # [B, P, K]
    xs = bx + off[..., 1]
    m_all = mask.float().reshape(b, p, k)
    x_rows = x.reshape(b * h * w, c)
    b_base = (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1)

    cols = torch.empty((b, p, k * c), dtype=x.dtype, device=dev)
    pb = max(1, min(p, _IM2COL_BUDGET // max(1, b * k * c * 4)))
    for p0 in range(0, p, pb):
        sl = slice(p0, min(p, p0 + pb))
        yy, xx, m = ys[:, sl], xs[:, sl], m_all[:, sl]
        valid = (yy > -1) & (yy < h) & (xx > -1) & (xx < w)
        y0f, x0f = torch.floor(yy), torch.floor(xx)
        ly, lx = yy - y0f, xx - x0f
        hy, hx = 1.0 - ly, 1.0 - lx
        # Clamped before the int conversion; only an invalid sample (all
        # weights zero) is moved by it.
        y0 = y0f.clamp(-2, h).to(torch.int64)
        x0 = x0f.clamp(-2, w).to(torch.int64)
        acc = None
        for cy, cx, wy, wx in ((y0, x0, hy, hx), (y0, x0 + 1, hy, lx),
                               (y0 + 1, x0, ly, hx), (y0 + 1, x0 + 1, ly, lx)):
            inside = valid & (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            wt = (wy * wx * inside.to(f32) * m).to(x.dtype).float()
            idx = b_base + cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)
            term = x_rows[idx.reshape(-1)].float().reshape(*idx.shape, c) * wt[..., None]
            acc = term if acc is None else acc + term
        cols[:, sl] = acc.to(x.dtype).reshape(b, -1, k * c)
    return cols.reshape(b * p, k * c)


def deform_im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  kh: int, kw: int, stride: int = 1, padding: int = 0,
                  dilation: int = 1) -> torch.Tensor:
    """The column buffer [B*OH*OW, K*C]: the plain version on the CPU, the
    CUDA kernel on a CUDA tensor (bf16 or f32 x, the mask in x's dtype as
    models/aspp.py rounds it). Inputs that are not contiguous are made so
    (the conv outputs of ops/layers.py are permuted views); the call makes
    no host sync, so it can be captured in a CUDA graph."""
    if x.device.type == "cpu":
        return deform_im2col_plain(x, offset, mask, kh, kw, stride, padding,
                                   dilation)
    if x.device.type != "cuda":
        raise ValueError(f"deform_im2col runs on cpu or cuda, got {x.device}")
    if x.dtype is not torch.bfloat16 and x.dtype is not torch.float32:
        raise TypeError(f"deform_im2col kernel takes bf16 or f32, got {x.dtype}")
    if mask.dtype is not x.dtype:
        raise TypeError(f"deform_im2col kernel takes the mask in x's dtype "
                        f"{x.dtype}, got {mask.dtype}")
    b, h, w, c = x.shape
    oh, ow = output_size(h, w, kh, kw, stride, padding, dilation)
    k = kh * kw
    x = x.contiguous()
    offset = offset.float().contiguous()
    mask = mask.contiguous()
    for name, t, shape in (("offset", offset, (b, oh, ow, 2 * k)),
                           ("mask", mask, (b, oh, ow, k))):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"deform_im2col {name}: want {shape} on "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")
    cols = torch.empty((b * oh * ow, k * c), dtype=x.dtype, device=x.device)
    fn = build.function("bt_deform_im2col", 4, 12)
    code = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), cols.data_ptr(),
              b, h, w, c, oh, ow, kh, kw, stride, padding, dilation,
              int(x.dtype is torch.float32), build.stream(x.device))
    build.check(code, "deform_im2col")
    deform_im2col.launches += 1
    return cols


deform_im2col.launches = 0
