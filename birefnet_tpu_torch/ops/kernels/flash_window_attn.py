"""Window-attention core kernel (CUDA C++, csrc/flash_window_attn.cu).

    out = softmax(q * d^-0.5 @ k^T + bias [+ mask[w % nW]]) @ v

per window w and head, with the rounding points of the JAX kernels: in
bf16 the scale, the q product, the bias and mask addends and the
probabilities are rounded to bf16, and scores, softmax and the P v sum are
f32; in f32 everything is f32.

Replaces the three Pallas kernels of
birefnet_tpu/ops/pallas/flash_window_attn.py with one CUDA kernel, the
window-attention core of csrc/window_core.cuh (shared with the fused Swin
block, ops/kernels/fused_block_attn.py), behind three entry points with
the JAX names and contracts (minus `interpret`):

- `flash_window_attention_qkv` (K6, `_flash_qkv`) on the packed [B_, N, 3C]
  qkv projection -> [B_, N, C]: the attention core of the Swin ws=7 middle
  tier (models/swin.py), 24 calls per swin_t forward at N = 49, head dim 32;
- `flash_window_attention` (K7 `_flash_masked` with a mask, K8
  `_flash_plain` without) on [B_, heads, N, d];
- `flash_attention` (K8) with the JAX package's zero or causal -1e9 bias in
  q.dtype; the kernel takes a causal flag in place of the bias and adds
  that bias where a key lies after its query: CAUSAL_NEG (-1e9 rounded to
  bf16) in bf16, -1e9 in f32.

The kernel reads q, k and v at element strides, so K6 takes its heads'
columns straight out of the packed projection. It reads the addends as
they are given, with no conversion per call (ops/kernels/window_core.py):
the rel-pos bias in f32 (rounded to bf16 as it is staged), the mask as a
dense [nW, N, N] f32 tensor or as the [nW, N] int32 region ids of an
SW-MSA mask (window.sw_msa_region_ids, built once per geometry: -100
where two tokens' ids differ). It is bound by device-memory bytes (see
the source note). It takes N <= 256 and d a multiple of 8 up to 64, and
raises outside them.

f32 q, k and v (ComputeConfig(dtype=float32) on the kernel tier) run the
f32 branch of the same Pallas kernels, whose dots run at
precision=HIGHEST: the f32 core of csrc/window_core_f32.cuh
(`bt_flash_window_attn_f32`), with the scale, the bias and the mask
unrounded and the causal addend -1e9 in f32. Its two products run on the
tensor cores as three TF32 products each (ops/kernels/tf32.py), within
about 1e-6 of f32 products and summed in f32; PyTorch's TF32 flags do not
govern it.

Each entry point has a plain PyTorch version beside it, built on
ops/attention.py::window_attention with the bias and mask rounded as the
kernels round them (`round_addends`, which also expands region ids). A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each entry point counts its own launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..attention import qkv_window_attention, round_addends, window_attention
from . import build
from . import window_core as core

MAX_N, MAX_D = 256, 64


def flash_window_attention_qkv_plain(qkv: torch.Tensor, bias: torch.Tensor,
                                     mask: Optional[torch.Tensor],
                                     num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of K6: [B_, N, 3C] -> [B_, N, C]."""
    bias, mask = round_addends(qkv.dtype, bias, mask)
    return qkv_window_attention(qkv, bias, mask, num_heads)


def flash_window_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, bias: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of K7/K8 on [B_, heads, N, d]."""
    bias, mask = round_addends(q.dtype, bias, mask)
    return window_attention(q, k, v, bias, mask)


def causal_bias(q: torch.Tensor, causal: bool) -> torch.Tensor:
    """flash_attention's [heads, N, N] bias in q.dtype: zero, or -1e9 where
    a key lies after its query (the JAX package's finite causal mask)."""
    heads, n = q.shape[1], q.shape[2]
    if causal:
        i = torch.arange(n, device=q.device)
        bias = torch.where(i[:, None] >= i[None, :], 0.0, -1e9)
    else:
        bias = torch.zeros((n, n), device=q.device)
    return bias.to(q.dtype).expand(heads, n, n)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of flash_attention."""
    return flash_window_attention_plain(q, k, v, causal_bias(q, causal))


# flash_attention's causal addend as the bf16 kernel applies it for its
# causal flag: causal_bias's -1e9 rounded to bf16. The f32 kernel adds -1e9
# unrounded, as causal_bias gives it in f32.
CAUSAL_NEG = float(torch.tensor(-1e9, dtype=torch.bfloat16))


def _strides(t: torch.Tensor, name: str, dtype: torch.dtype):
    """(window, head, token) element strides of a [B_, heads, N, d] view of
    `dtype` (bf16 or f32)."""
    if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != dtype:
        raise TypeError(f"flash_window_attn kernel takes bf16 or f32 q, k, v "
                        f"and out of one dtype, got {name} {t.dtype} beside "
                        f"{dtype}")
    s = t.stride()
    per16 = 16 // t.element_size()  # elements in 16 bytes
    if s[3] != 1 or (s[0] | s[1] | s[2]) % per16 or t.data_ptr() % 16:
        raise ValueError(f"flash_window_attn {name}: want a contiguous head "
                         f"dim and 16-byte aligned rows, got strides {s}")
    return s[:3]


def _launch(q, k, v, out, bias, mask, num_heads, causal=False) -> None:
    """Launch the kernel on [B_, heads, N, d] views q, k, v and out."""
    b_, heads, n, d = q.shape
    if heads != num_heads or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_window_attn: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, heads "
                         f"{num_heads}")
    if n > MAX_N or d % 8 or d > MAX_D:
        raise ValueError(f"flash_window_attn kernel needs N <= {MAX_N} and d "
                         f"a multiple of 8 up to {MAX_D}, got N={n}, d={d}")
    if bias is not None:
        core.check_addend("flash_window_attn bias", bias, (heads, n, n),
                          torch.float32, q.device)
    kind = core.CAUSAL if causal else core.mask_kind("flash_window_attn",
                                                     mask, n, q.device)
    nw = 1 if mask is None else mask.shape[0]
    if b_ % nw:
        raise ValueError(f"flash_window_attn: B_={b_} is not a multiple of "
                         f"the mask's {nw} windows")
    dt = q.dtype
    strides = (*_strides(q, "q", dt), *_strides(k, "k", dt),
               *_strides(v, "v", dt), *_strides(out, "out", dt))
    fn = build.function("bt_flash_window_attn_f32" if dt == torch.float32
                        else "bt_flash_window_attn", 6, 18)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              None if bias is None else bias.data_ptr(),
              None if mask is None else mask.data_ptr(),
              *strides, b_, heads, n, d, nw, kind,
              build.stream(q.device))
    build.check(code, "flash_window_attn")


def _cuda(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")
    return x.device.type == "cuda"


def flash_window_attention_qkv(qkv: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor] = None,
                               num_heads: int = 1) -> torch.Tensor:
    """Fused window attention on the packed qkv projection.

    qkv: [B_, N, 3C], features ordered [q|k|v] x head-major (the torch
    convention); bias: [heads, N, N]; mask: optional [nW, N, N], or the
    [nW, N] int32 region ids of an SW-MSA mask, with B_ % nW == 0. Returns
    [B_, N, C], ready for the output projection."""
    if not _cuda(qkv, "flash_window_attention_qkv"):
        return flash_window_attention_qkv_plain(qkv, bias, mask, num_heads)
    build.refuse_grad("flash_window_attn_qkv", qkv, bias)
    b_, n, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % num_heads or not qkv.is_contiguous():
        raise ValueError(f"flash_window_attention_qkv needs a contiguous "
                         f"[B_, N, 3C] input with C divisible by the heads, "
                         f"got {tuple(qkv.shape)}, heads {num_heads}")
    d = c // num_heads
    # [B_, heads, N, d] views of the packed projection and of the output.
    q, k, v = qkv.view(b_, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    out = torch.empty((b_, n, c), dtype=qkv.dtype, device=qkv.device)
    _launch(q, k, v, out.view(b_, n, num_heads, d).transpose(1, 2), bias,
            mask, num_heads)
    flash_window_attention_qkv.launches += 1
    return out


flash_window_attention_qkv.launches = 0


def flash_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for ops.attention.window_attention with the kernel tier's
    rounding: q, k, v [B_, heads, N, d], B_ = batch * nW; bias [heads, N, N];
    mask optional [nW, N, N] (0 / -100) or [nW, N] int32 region ids,
    B_ % nW == 0."""
    if not _cuda(q, "flash_window_attention"):
        return flash_window_attention_plain(q, k, v, bias, mask)
    build.refuse_grad("flash_window_attn", q, k, v, bias)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, bias, mask, q.shape[1])
    flash_window_attention.launches += 1
    return out


flash_window_attention.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Bias-free attention on [B_, heads, N, d] (the JAX package's API-parity
    entry point; the model never calls it): causal masks keys after their
    query with a finite -1e9 addend."""
    if not _cuda(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal)
    build.refuse_grad("flash_attention", q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, None, None, q.shape[1], causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
