"""Primitive NN layers on NHWC tensors with explicit parameter dicts.

Counterpart of birefnet_tpu/ops/layers.py. Parameters are torch tensors in
torch layouts (see params.py):
  linear:     {"weight": [out, in], "bias": [out]?}
  conv2d:     {"weight": [out, in, kh, kw] (OIHW), "bias": [out]?}
  layer_norm: {"scale": [C], "bias": [C]}
  batch_norm: {"scale": [C], "shift": [C]}   (folded at load)

Numerics follow the JAX package: products in the activation dtype with f32
accumulation, biases, norms and activations applied in f32 and rounded
back once. Activations stay NHWC; a convolution views its input as a
channels-last NCHW tensor, so no layout copy is made around it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _add_bias(y: torch.Tensor, params: Params, dtype) -> torch.Tensor:
    if "bias" in params:
        y = y.float() + params["bias"].float()
    return y.to(dtype)


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Dense layer on the last axis."""
    y = F.linear(x, params["weight"].to(x.dtype))
    return _add_bias(y, params, x.dtype)


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int,
               padding: int, dilation: int) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), None,
                 stride=stride, padding=padding, dilation=dilation)
    return y.permute(0, 2, 3, 1)


def conv2d(params: Params, x: torch.Tensor, stride: int = 1,
           padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """NHWC conv with OIHW weights and symmetric zero padding."""
    y = _conv_nhwc(x, params["weight"], stride, padding, dilation)
    return _add_bias(y, params, x.dtype)


def conv2d_concat(params: Params, xs: Sequence[torch.Tensor], stride: int = 1,
                  padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """conv2d over the channel concat of `xs` without materializing it:
    the weight is split along its input channels, each part's conv is
    stored in the activation dtype and the parts are summed."""
    weight = params["weight"]
    out = None
    off = 0
    for x in xs:
        c = x.shape[-1]
        y = _conv_nhwc(x, weight[:, off:off + c], stride, padding, dilation)
        out = y if out is None else out + y
        off += c
    if off != weight.shape[1]:
        raise ValueError(f"inputs cover {off} channels, the weight "
                         f"takes {weight.shape[1]}")
    return _add_bias(out, params, xs[0].dtype)


def layer_norm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics."""
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def batch_norm_inference(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm as the folded channel-wise affine."""
    y = x.float() * params["scale"].float() + params["shift"].float()
    return y.to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU computed in f32."""
    return F.gelu(x.float()).to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x.float()).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)
