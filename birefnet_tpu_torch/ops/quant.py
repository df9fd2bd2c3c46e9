"""W8A8 arithmetic in plain PyTorch: the plain versions of the int8 kernels.

Counterpart of the int8 pieces of birefnet_tpu/ops/pallas/fused_mlp.py
(`_quantize_rows`, `_kernel_i8`, `_erf(fast=True)`) and of the int8 branch
of fused_block_attn.py, with their formulas and rounding points:

- per-token activations: scale = max(amax, 1e-30) * (1/127) and
  q = clip(round(h * (1/scale)), -127, 127), rounding half to even;
- weights per output channel (params.quantize_*_int8), int8 [out, in];
- the integer product is exact, dequantized as acc * (sx * sw) + bias in
  f32.

Integer sums reach 127^2 * 6144 ~ 9.9e7, past f32's exact 2^24, so the
plain product runs in f64 (exact below 2^53) on every device and is
rounded to f32 once, as the JAX package converts its i32 sums.
"""

from __future__ import annotations

import torch


def quantize_rows(h: torch.Tensor):
    """Per-row symmetric int8 of an f32 [..., K] tensor: (int8 codes, f32
    [..., 1] dequant scales). A zero row gets the 1e-30 floor's scale and
    all-zero codes."""
    amax = h.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)
    q = torch.clamp(torch.round(h * (1.0 / scale)), -127.0, 127.0)
    return q.to(torch.int8), scale


def int8_linear(q: torch.Tensor, sx: torch.Tensor, params) -> torch.Tensor:
    """f32 (q @ weight_q8^T) * (sx * scale_q8) + bias for int8 codes q
    [..., K] with row scales sx [..., 1]; the product is exact."""
    acc = torch.matmul(q.double(), params["weight_q8"].double().t()).float()
    return acc * (sx * params["scale_q8"].float()) + params["bias"].float()


def erf3(z: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.25 (3-term) erf in f32, the JAX int8 MLP
    kernel's `_erf(fast=True)`. The reciprocal is exact here; the TPU
    kernel takes the hardware's approximate one."""
    a = z.abs()
    t = 1.0 / (1.0 + 0.47047 * a)
    poly = t * (0.3480242 + t * (-0.0958798 + t * 0.7478556))
    e = 1.0 - poly * torch.exp(-a * a)
    return torch.where(z < 0, -e, e)


def gelu_erf3(h: torch.Tensor) -> torch.Tensor:
    """h * 0.5 * (1 + erf3(h / sqrt 2)) in f32."""
    return h * 0.5 * (1.0 + erf3(h * (2.0 ** -0.5)))
