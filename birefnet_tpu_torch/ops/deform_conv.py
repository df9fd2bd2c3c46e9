"""Modulated deformable convolution v2 on NHWC tensors.

Counterpart of birefnet_tpu/ops/deform_conv.py::deform_conv2d (torchvision
deform_conv2d semantics, the reference's Metal `deformable_im2col`
followed by a matmul): per-output-pixel learned offsets, bilinear sampling
with zero padding outside the image, and a multiplicative modulation mask.

The columns come from `deform_im2col` (ops/kernels/deform_im2col.py: the
plain version on the CPU, kernel D1 on the card), then ONE torch.matmul
takes them against the weight reshaped to [K*C, O] in tap-major,
channel-minor order, with f32 accumulation rounded once to x's dtype, and
the bias is added after that cast, in x's dtype. Both routes share that
contraction, so their outputs differ exactly where their columns do.

Gradients (training, train.py): `im2col` picks the columns' route. On a
CUDA tensor that autograd records, `DeformIm2col` launches D1 in its
forward, saving only x, offset and mask, and D1b (the kernel's backward,
csrc/deform_col2im.cu) in its backward: the counterpart of the VJP that
JAX forms for its gather. On the CPU the plain version is differentiated
by autograd, block by block under torch.utils.checkpoint, the counterpart
of the JAX package's scan over jax.checkpoint; neither route saves the
gathered corners. With grad disabled both routes are the inference ones.

Layout: NHWC; offset[..., 2k] = dy, offset[..., 2k + 1] = dx for row-major
tap k; the weight in the port's OIHW layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.deform_im2col import deform_col2im, deform_im2col, output_size


class DeformIm2col(torch.autograd.Function):
    """D1 forward, D1b backward, on CUDA tensors (f32 for the backward)."""

    @staticmethod
    def forward(ctx, x, offset, mask, kh, kw, stride, padding, dilation):
        ctx.geometry = (kh, kw, stride, padding, dilation)
        ctx.save_for_backward(x, offset, mask)
        return deform_im2col(x, offset, mask, kh, kw, stride, padding,
                             dilation)

    @staticmethod
    def backward(ctx, grad_cols):
        x, offset, mask = ctx.saved_tensors
        grads = deform_col2im(grad_cols, x, offset, mask, *ctx.geometry)
        return (*grads, None, None, None, None, None)


def im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
           kh: int, kw: int, stride: int = 1, padding: int = 0,
           dilation: int = 1) -> torch.Tensor:
    """The column buffer [B*OH*OW, K*C] of `deform_im2col`, differentiable:
    through `DeformIm2col` (D1, D1b) where autograd records a CUDA call,
    else `deform_im2col` (the plain version on the CPU, which autograd
    differentiates itself; D1 on the card)."""
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, offset, mask))):
        return DeformIm2col.apply(x, offset, mask, kh, kw, stride, padding,
                                  dilation)
    return deform_im2col(x, offset, mask, kh, kw, stride, padding, dilation)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 0,
                  dilation: int = 1) -> torch.Tensor:
    """x [B, H, W, C]; offset [B, OH, OW, 2*kh*kw] (read as f32); mask
    [B, OH, OW, kh*kw] (the caller applies 2*sigmoid); weight [O, C, kh, kw];
    bias [O] or None. Returns [B, OH, OW, O] in x.dtype."""
    b, h, w, c = x.shape
    out_c, _, kh, kw = weight.shape
    oh, ow = output_size(h, w, kh, kw, stride, padding, dilation)
    cols = im2col(x, offset, mask, kh, kw, stride, padding, dilation)
    w_kc = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(kh * kw * c, out_c)
    out = torch.matmul(cols, w_kc).reshape(b, oh, ow, out_c)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out
