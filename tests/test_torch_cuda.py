"""birefnet_tpu_torch kernels on the card: each hand-written kernel against
its plain PyTorch version on the same bf16 (or, for the f32 tier at the
end and the W8A8 kernels' f32 branches, f32) inputs.

These tests need an NVIDIA GPU and skip without one. Run them on the card
with
    BIREFNET_TEST_CUDA=1 python -m pytest --noconftest tests/test_torch_cuda.py
(`--noconftest` because tests/conftest.py imports jax, which the GPU
machine does not have; this file imports torch and the port only).

Bound for every comparison: max|kernel - plain| <= 2e-2 * max|plain|. The
two round to bf16 at the same points but sum in other orders, and the
plain version rounds its matmul outputs to bf16 before adding the f32
biases where the kernels add them in f32 first. The int8 kernels' integer
products are exact like their plain versions'; a LayerNorm or softmax sum
in another order can flip one int8 code by a step, so they also hold a
bound on the mean difference (MEAN_BOUND_I8). The f32 kernels are held to
max|kernel - plain| <= 1e-4 * max|plain| and mean|kernel - plain| /
mean|plain| <= MEAN_BOUND_F32 = 1e-5, their plain versions run with TF32
off; the same plain versions with TF32 on must break the mean bound.
"""

import os

import numpy as np
import pytest
import torch

from birefnet_tpu_torch import params as pparams
from birefnet_tpu_torch.models import swin
from birefnet_tpu_torch.ops import window as W
from birefnet_tpu_torch.ops.kernels import (bf16_gemm, deform_im2col,
                                            f32_gemm, flash_window_attn,
                                            fused_block_attn, fused_mlp,
                                            int8_gemm, row_ln, tap_conv, tf32)

pytestmark = pytest.mark.cuda
# The int8 kernels are also held to mean|kernel - plain| / mean|plain|: at
# these shapes the H100's readings sit well below this bound, and copies of
# the kernels that skipped K1-int8's bf16 rounding of the normed rows or
# dequantized every 64th channel with its neighbour's scale broke it.
MEAN_BOUND_I8 = 1e-4
# K3 whole on f32 activations: an LN2 code flipped by the sums' order
# moves its whole output row, unrounded, so at a tail of few rows one flip
# shows in the mean (the H100 read 1.016e-4 at T = 48, C = 1536); the
# bound is the one chip_smoke.py holds K1-int8 to. The cluster kernel's
# arithmetic is held bitwise from given codes below.
MEAN_BOUND_I8_F32 = 1e-3
# K1-int8 at a model's int8 width (C >= 768: swin_b's C = 1024, 32 heads):
# the H100 read 1.1e-4 to 2.2e-4 at C = 1024 in bf16 and f32 (chip_smoke.py
# read up to 2.0e-4 at Swin-L's stage-3 shapes), so the bound is about 2.3x
# the largest reading. That the LN1 codes flip no more often at this width
# is held by test_ln_code_flips_are_rare_and_one_step at C = 1024.
MEAN_BOUND_K1_I8_WIDE = 5e-4
# The bf16 GEMM and row pass round at their plain versions' points and sum
# in f32 in another order, so they differ only where a sum lands on a bf16
# rounding boundary: mean|kernel - plain| / mean|plain| <= MEAN_BOUND_BF16.
MEAN_BOUND_BF16 = 1e-4


@pytest.fixture(scope="module")
def dev():
    if (os.environ.get("BIREFNET_TEST_CUDA", "0") != "1"
            or not torch.cuda.is_available()):
        pytest.skip("needs BIREFNET_TEST_CUDA=1 and a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dev, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _assert_close(got, want, mean_bound=None):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    bound = 2e-2 * want.abs().max().item()
    assert err <= bound, f"max|kernel - plain| {err} > {bound}"
    if mean_bound is not None:
        rel = ((got - want).abs().mean() / want.abs().mean()).item()
        assert rel <= mean_bound, f"mean|kernel - plain| / mean|plain| {rel}"


# Every Swin-L and swin_t width (96 ... 3072), row counts that are no
# multiple of the rows per block (bf16: 64 rows a block at C = 96 down to 2
# at 3072; f32 half as many), and two widths off the 96 * 2^k ladder that
# leave lanes of the last register slot idle (640 bf16, 200 f32 and bf16).
@pytest.mark.parametrize("shape", [(1000, 192), (37, 3072), (2, 7, 9, 768),
                                   (1000, 96), (50, 384), (1001, 1536),
                                   (101, 640), (99, 200),
                                   # swin_b's rows, 128 2^k (the 4-slot path)
                                   (1000, 128), (500, 256), (301, 512),
                                   (200, 1024), (101, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_ln_kernel_matches_plain(dev, shape, dtype):
    gen = torch.Generator(dev).manual_seed(0)
    c = shape[-1]
    x = _randn(gen, shape, dev, 3.0, dtype)
    p = {"scale": _randn(gen, (c,), dev), "bias": _randn(gen, (c,), dev)}
    n0 = row_ln.layer_norm_rows.launches
    got = row_ln.layer_norm_rows(p, x)
    assert row_ln.layer_norm_rows.launches == n0 + 1
    _assert_close(got, row_ln.layer_norm_rows_plain(p, x))


# (M, N, K, epilogue): K1-int8's qkv ("bf16"; "f32" on f32 activations) and
# proj ("residual" with a bf16 res; "residual f32" with an f32 one) at
# every Swin-L int8 site of a batch-2 1024^2 forward (full and half pass,
# stages 2 and 3), then each epilogue at an M tail of 100 rows, once at K =
# 64 and N = 192 (tiles and a k step that TMA fills past the matrix) and
# once at K1-int8's qkv width. (K3 runs its own cluster kernel.)
INT8_GEMM_SHAPES = (
    [(m, 3 * c, c, e) for m, c in ((10368, 768), (2592, 1536),
                                    (2592, 768), (1152, 1536))
     for e in ("bf16", "f32")]
    + [(m, c, c, e) for m, c in ((10368, 768), (2592, 1536),
                                  (2592, 768), (1152, 1536))
       for e in ("residual", "residual f32")]
    + [(100, n, k, e) for e in ("bf16", "residual", "f32", "residual f32")
       for n, k in ((192, 64), (2304, 768))])


def _int8_gemm_case(seed, m, n, k, dev):
    """Codes, row scales and a quantized linear at which y is O(1)."""
    gen = torch.Generator(dev).manual_seed(seed)
    q = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    sx = (0.5 + torch.rand((m, 1), generator=gen, device=dev)) / 127
    sw = (0.5 + torch.rand((n,), generator=gen, device=dev)) / (127 * k ** 0.5)
    lin = {"weight_q8": w, "scale_q8": sw, "bias": _randn(gen, (n,), dev, 0.5)}
    return q, sx, lin


@pytest.mark.parametrize("m,n,k,epilogue", INT8_GEMM_SHAPES)
def test_int8_gemm_matches_int8_linear_bitwise(dev, m, n, k, epilogue):
    """The wgmma GEMM equals ops/quant.int8_linear cast as its epilogue
    casts, bit for bit: the s32 sum is exact and the dequant rounds at the
    plain version's points."""
    q, sx, lin = _int8_gemm_case(m + n + k, m, n, k, dev)
    res = None
    if epilogue.startswith("residual"):
        res = _randn(torch.Generator(dev).manual_seed(k), (m, n), dev, 1.0,
                     torch.float32 if epilogue.endswith("f32")
                     else torch.bfloat16)
        epilogue = "residual"
    n0 = int8_gemm.int8_gemm.launches
    got = int8_gemm.int8_gemm(q, sx, lin, epilogue, res)
    assert int8_gemm.int8_gemm.launches == n0 + 1
    want = int8_gemm.int8_gemm_plain(q, sx, lin, epilogue, res)
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert torch.equal(got, want), (f"{int(diff.ne(0).sum())} of "
                                    f"{diff.numel()} differ, max "
                                    f"{float(diff.max())}")


# (M, N, K, epilogue): K1's qkv ("store") and proj ("residual") on the
# window canvas and K2's fc1 ("gelu") and fc2 ("residual") on the tokens, at
# every stage of the full pass of a batch-2 1024^2 forward of Swin-L (C =
# 192 ... 1536, canvases 264^2 ... 36^2) and of swin_t's K2 (C = 96 ...
# 768); then every epilogue at an M tail of 100 rows, at N = K = 96 (a tile
# and a k step that TMA fills past the matrix) and at K1's stage-0 qkv.
BF16_GEMM_SHAPES = (
    [(2 * hp * hp, n, c, e) for hp, c in ((264, 192), (132, 384), (72, 768),
                                          (36, 1536))
     for n, e in ((3 * c, "store"), (c, "residual"))]
    + [(2 * h * h, n, k, e) for h, c in ((256, 192), (128, 384), (64, 768),
                                         (32, 1536), (256, 96), (128, 192),
                                         (64, 384), (32, 768))
       for n, k, e in ((4 * c, c, "gelu"), (c, 4 * c, "residual"))]
    + [(100, n, k, e) for e in ("store", "residual", "gelu")
       for n, k in ((96, 96), (576, 192))])


@pytest.mark.parametrize("m,n,k,epilogue", BF16_GEMM_SHAPES)
def test_bf16_gemm_matches_plain(dev, m, n, k, epilogue):
    """The wgmma bf16 GEMM against F.linear in f32 of the same bf16
    operands plus the epilogue."""
    gen = torch.Generator(dev).manual_seed(m + n + k)
    a = _randn(gen, (m, k), dev, 1.0, torch.bfloat16)
    lin = {"weight": _randn(gen, (n, k), dev, k ** -0.5, torch.bfloat16),
           "bias": _randn(gen, (n,), dev, 0.5)}
    res = (_randn(gen, (m, n), dev, 1.0, torch.bfloat16)
           if epilogue == "residual" else None)
    n0 = bf16_gemm.bf16_gemm.launches
    got = bf16_gemm.bf16_gemm(a, lin, epilogue, res)
    assert bf16_gemm.bf16_gemm.launches == n0 + 1
    assert got.dtype == torch.bfloat16
    _assert_close(got, bf16_gemm.bf16_gemm_plain(a, lin, epilogue, res),
                  MEAN_BOUND_BF16)


# (rows, C, canvas (Hp, Wp, shift, origin, h_real, w_real)): K1's LN1 rows
# on the Swin-L canvases (rolled, offset, unshifted), K2's LN2 rows, and
# widths off the 96 * 2^k ladder.
LN_ROW_CASES = [
    (2 * 264 * 264, 192, (264, 264, 6, 0, 256, 256)),
    (2 * 72 * 72, 768, (72, 72, 0, 6, 64, 64)),
    (2 * 36 * 36, 1536, (36, 36, 0, 0, 32, 32)),
    (2 * 24 * 24, 64, (24, 24, 6, 0, 20, 17)),
    (131072, 96, None), (8192, 384, None), (512, 1536, None), (101, 640, None),
]


@pytest.mark.parametrize("t,c,canvas", LN_ROW_CASES)
def test_ln_rows_matches_plain(dev, t, c, canvas):
    gen = torch.Generator(dev).manual_seed(t + c)
    x = _randn(gen, (t, c), dev, 3.0, torch.bfloat16)
    ln = {"scale": 1 + 0.1 * _randn(gen, (c,), dev),
          "bias": 0.1 * _randn(gen, (c,), dev)}
    n0 = bf16_gemm.ln_rows.launches
    got = bf16_gemm.ln_rows(x, ln, canvas)
    assert bf16_gemm.ln_rows.launches == n0 + 1
    want = bf16_gemm.ln_rows_plain(x, ln, canvas)
    if canvas is not None:
        pads = ~fused_block_attn.pad_token_rows(canvas, t, dev)
        assert pads.any() == (canvas[4] < canvas[0] or canvas[5] < canvas[1])
        assert not got[pads].any()
    _assert_close(got, want, MEAN_BOUND_BF16)


def _exact_ln_rows(gen, t, k, dev):
    """bf16 rows whose f32 sums are exact in any order: each row is a
    multiple of 1/4 in [-4, 4] plus k/2 values of 1/4 steps in [-8, 8] and
    their negatives, shuffled; so mean and variance, and every value
    after them, are the same however the sums run."""
    half = torch.randint(-32, 33, (t, k // 2), generator=gen, device=dev)
    d = torch.cat([half, -half], 1).float() / 4
    d = d.gather(1, torch.rand((t, k), generator=gen, device=dev).argsort(1))
    m = torch.randint(-16, 17, (t, 1), generator=gen, device=dev).float() / 4
    return (m + d).to(torch.bfloat16)


# (rows, K, dtype, LayerNorm, canvas (Hp, Wp, shift, origin, h_real,
# w_real)): K1-int8's attention rows (no LN) and LN1 on the Swin-L int8
# canvases (rolled, offset, unshifted), K3's LN2 (LN, no rounding), and
# small rows off the ladder, in bf16 and, for the f32 branches, in f32 (no
# rounding on the canvas). (K3's f32 hidden rows are quantized inside its
# cluster kernel.)
QUANT_ROW_CASES = [
    (2592, 768, "bf16", False, None), (1152, 1536, "bf16", False, None),
    (100, 64, "bf16", False, None),
    (2 * 36 * 36, 768, "bf16", True, (36, 36, 6, 0, 32, 32)),
    (2 * 36 * 36, 768, "bf16", True, (36, 36, 0, 6, 32, 32)),
    (2 * 24 * 24, 1536, "bf16", True, (24, 24, 0, 0, 16, 16)),
    (2 * 72 * 72, 768, "bf16", True, (72, 72, 6, 0, 64, 64)),
    (2048, 768, "bf16", True, None), (512, 1536, "bf16", True, None),
    (2592, 768, "f32", False, None), (1152, 1536, "f32", False, None),
    (100, 64, "f32", False, None),
    (2 * 36 * 36, 768, "f32", True, (36, 36, 6, 0, 32, 32)),
    (2 * 24 * 24, 1536, "f32", True, (24, 24, 0, 0, 16, 16)),
    (2 * 72 * 72, 768, "f32", True, (72, 72, 0, 4, 64, 64)),
    (8192, 768, "f32", True, None), (512, 1536, "f32", True, None),
]


@pytest.mark.parametrize("t,k,dtype,ln,canvas", QUANT_ROW_CASES)
def test_quantize_rows_matches_plain_bitwise(dev, t, k, dtype, ln, canvas):
    """The row pass's codes and scales equal ops/quant.quantize_rows after
    the same LayerNorm, pad zeroing and bf16 rounding, bit for bit. The
    LayerNorm cases take rows whose sums are exact in any order, so the
    statistics cannot differ by summation order."""
    gen = torch.Generator(dev).manual_seed(t + k)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    if ln:
        x = _exact_ln_rows(gen, t, k, dev).to(dt)
        lnp = {"scale": 1 + 0.1 * _randn(gen, (k,), dev),
               "bias": 0.1 * _randn(gen, (k,), dev)}
    else:
        x = _randn(gen, (t, k), dev, 2.0, dt)
        lnp = None
    n0 = int8_gemm.quantize_rows.launches
    codes, scales = int8_gemm.quantize_rows(x, lnp, canvas)
    assert int8_gemm.quantize_rows.launches == n0 + 1
    want_codes, want_scales = int8_gemm.quantize_rows_plain(x, lnp, canvas)
    assert torch.equal(scales, want_scales)
    assert torch.equal(codes, want_codes), (
        f"{int(codes.ne(want_codes).sum())} of {codes.numel()} codes differ")


def _mlp_params(gen, c, dev):
    bf = torch.bfloat16
    return ({"scale": 1 + 0.1 * _randn(gen, (c,), dev),
             "bias": 0.1 * _randn(gen, (c,), dev)},
            {"fc1": {"weight": _randn(gen, (4 * c, c), dev, 0.05, bf),
                     "bias": _randn(gen, (4 * c,), dev, 0.1)},
             "fc2": {"weight": _randn(gen, (c, 4 * c), dev, 0.05, bf),
                     "bias": _randn(gen, (c,), dev, 0.1)}})


@pytest.mark.parametrize("t,c", [(100, 64), (512, 192), (48, 1536), (100, 96),
                                 (4096, 96)])
def test_fused_mlp_kernel_matches_plain(dev, t, c):
    gen = torch.Generator(dev).manual_seed(1)
    x = _randn(gen, (t, c), dev, 1.0, torch.bfloat16)
    n2, mlp = _mlp_params(gen, c, dev)
    n0 = fused_mlp.fused_mlp_residual.launches
    got = fused_mlp.fused_mlp_residual(x, n2, mlp)
    assert fused_mlp.fused_mlp_residual.launches == n0 + 1
    _assert_close(got, fused_mlp.fused_mlp_residual_plain(x, n2, mlp))


def _block_params(gen, c, heads, dev):
    bf = torch.bfloat16
    return ({"scale": 1 + 0.1 * _randn(gen, (c,), dev),
             "bias": 0.1 * _randn(gen, (c,), dev)},
            {"qkv": {"weight": _randn(gen, (3 * c, c), dev, 0.05, bf),
                     "bias": _randn(gen, (3 * c,), dev)},
             "proj": {"weight": _randn(gen, (c, c), dev, 0.05, bf),
                      "bias": _randn(gen, (c,), dev)},
             "cached_bias": _randn(gen, (heads, 144, 144), dev)})


@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("hw", [(24, 24), (20, 17), (16, 16)])
# Swin-L's head width and swin_b's stages 0-2 (4, 8 and 16 heads of 32).
@pytest.mark.parametrize("heads,c", [(2, 64), (6, 192), (4, 128), (8, 256),
                                     (16, 512)])
def test_fused_block_attn_kernel_matches_plain(dev, shift, hw, heads, c):
    gen = torch.Generator(dev).manual_seed(2)
    h, w = hw
    x = _randn(gen, (2, h, w, c), dev, 1.0, torch.bfloat16)
    norm1, attn = _block_params(gen, c, heads, dev)
    hp, wp = -(-h // 12) * 12, -(-w // 12) * 12
    mask = W.sw_msa_mask(hp, wp, 12, 6, dev)
    canvas, k_shift, k_mask, origin = swin.fused_block_canvas(x, 12, shift,
                                                              mask)
    args = (canvas, norm1, attn, 12, k_shift, heads, k_mask, h, w, origin)
    n0 = fused_block_attn.fused_window_block_attention.launches
    got = fused_block_attn.fused_window_block_attention(*args)
    assert fused_block_attn.fused_window_block_attention.launches == n0 + 1
    want = fused_block_attn.fused_window_block_attention_plain(*args)
    # Only the real tokens are defined; the caller crops the pad region.
    crop = (slice(None), slice(origin, origin + h), slice(origin, origin + w))
    if k_shift:
        got = W.roll_2d(got, k_shift, k_shift)
        want = W.roll_2d(want, k_shift, k_shift)
    _assert_close(got[crop], want[crop])


def _quantized(tree, key, dtype=torch.bfloat16):
    """The tree's `key` linears quantized from f32, then cast to `dtype`."""
    fn = (pparams.quantize_mlp_int8 if key == "mlp"
          else pparams.quantize_attn_int8)
    return pparams.cast_matmul_weights(fn({key: tree}, 0)[key], dtype)


# (T, C) of K3's cluster kernel: every Swin-L site (stage 2: C = 768, 18
# blocks; stage 3: 1536, 2 blocks; full and half pass; swin_t's stage 3 is
# (2048, 768) and (512, 768)), swin_b's stage 3 (C = 1024: 11 CTAs a
# cluster, slices padded past 4C), and tails: M tails of 100 and 48 rows,
# C = 64 (one CTA, 256 of its 384 hidden units real) and 192.
K3_SHAPES = [(8192, 768), (2048, 768), (2048, 1536), (512, 1536),
             (2048, 1024), (512, 1024), (100, 64), (512, 192), (512, 768),
             (48, 1536)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,c", K3_SHAPES)
def test_fused_mlp_int8_kernel_matches_plain(dev, t, c, dtype):
    gen = torch.Generator(dev).manual_seed(6)
    x = _randn(gen, (t, c), dev, 1.0, dtype)
    n2, mlp = _mlp_params(gen, c, dev)
    mlp = _quantized(pparams.tree_map(lambda _, v: v.float(), mlp), "mlp",
                     dtype)
    n0, n16 = (fused_mlp.fused_mlp_residual_int8.launches,
               fused_mlp.fused_mlp_residual.launches)
    got = fused_mlp.fused_mlp_residual(x, n2, mlp)
    assert fused_mlp.fused_mlp_residual_int8.launches == n0 + 1
    assert fused_mlp.fused_mlp_residual.launches == n16
    _assert_close(got, fused_mlp.fused_mlp_residual_int8_plain(x, n2, mlp),
                  MEAN_BOUND_I8 if dtype == torch.bfloat16
                  else MEAN_BOUND_I8_F32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,c", K3_SHAPES)
def test_fused_mlp_int8_codes_matches_plain_chain_bitwise(dev, t, c, dtype):
    """K3's cluster kernel from given LN2 codes and scales (the row pass's)
    equals int8_linear -> gelu_erf3 -> quantize_rows -> int8_linear -> + x
    on the card, bit for bit, on bf16 and on f32 activations: its integer
    sums are exact in any split and every f32 step rounds where the plain
    chain does."""
    gen = torch.Generator(dev).manual_seed(7)
    x = _randn(gen, (t, c), dev, 1.0, dtype)
    n2, mlp = _mlp_params(gen, c, dev)
    mlp = _quantized(pparams.tree_map(lambda _, v: v.float(), mlp), "mlp",
                     dtype)
    codes, scales = int8_gemm.quantize_rows(x, n2)
    n0 = fused_mlp.fused_mlp_residual_int8_codes.launches
    got = fused_mlp.fused_mlp_residual_int8_codes(x, codes, scales, mlp)
    assert fused_mlp.fused_mlp_residual_int8_codes.launches == n0 + 1
    want = fused_mlp.fused_mlp_residual_int8_codes_plain(x, codes, scales, mlp)
    diff = (got.float() - want.float()).abs()
    assert torch.equal(got, want), (f"{int(diff.ne(0).sum())} of "
                                    f"{diff.numel()} differ, max "
                                    f"{float(diff.max())}")


def test_int8_entries_refuse_what_k3_runs_inside(dev):
    """The int8 GEMM has no GELU kernel on the card: K3's cluster kernel
    runs it (and quantizes its f32 hidden rows) in shared memory. The row
    pass takes bf16 and f32 rows (K1-int8's attention rows in either
    dtype) and refuses others."""
    gen = torch.Generator(dev).manual_seed(10)
    q, sx, lin = _int8_gemm_case(10, 64, 64, 64, dev)
    with pytest.raises(ValueError, match="epilogue"):
        int8_gemm.int8_gemm(q, sx, lin, "gelu")
    with pytest.raises(ValueError, match="bf16 or f32"):
        int8_gemm.quantize_rows(_randn(gen, (64, 256), dev, 1.0,
                                       torch.float16))


def test_int8_weights_quantized_on_the_card_equal_the_cpu(dev):
    """make_infer_fn quantizes the Swin-L tree on the card: K1-int8's and
    K3's int8 codes and scales equal the CPU quantizer's, bit for bit."""
    from birefnet_tpu_torch.configs import BiRefNetConfig

    cfg = BiRefNetConfig.swin_l()
    tree = pparams.build_param_tree(pparams.random_checkpoint(cfg, 0), cfg)
    bb = {k: v for k, v in tree.items() if k == "bb"}
    cpu = pparams.quantize_attn_int8(pparams.quantize_mlp_int8(bb))
    card = pparams.quantize_attn_int8(pparams.quantize_mlp_int8(
        pparams.to_device(bb, dev)))
    want = {k: v for k, v in _flat(cpu) if k.endswith(("_q8"))}
    got = {k: v for k, v in _flat(card) if k.endswith(("_q8"))}
    assert len(want) == 4 * 20 * 2 and got.keys() == want.keys()
    bad = {k: int(got[k].cpu().ne(v).sum()) for k, v in want.items()
           if not torch.equal(got[k].cpu(), v)}
    assert not bad, f"entries that differ on the card: {bad}"


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# (rows, C, canvas) of the LN row pass: K1-int8's LN1 on the Swin-L int8
# canvases (stage 2 full and half pass, rolled and offset; stage 3) and K3's
# LN2 on the real tokens (stages 2 and 3, full and half pass); then swin_b's
# stage 3 (C = 1024): K1-int8's canvases, plain and shifted, and K3's rows.
LN_FLIP_CASES = [
    (2 * 72 * 72, 768, (72, 72, 6, 0, 64, 64)),
    (2 * 72 * 72, 768, (72, 72, 0, 4, 64, 64)),
    (2 * 36 * 36, 768, (36, 36, 6, 0, 32, 32)),
    (2 * 36 * 36, 1536, (36, 36, 0, 0, 32, 32)),
    (2 * 24 * 24, 1536, (24, 24, 6, 0, 16, 16)),
    (8192, 768, None), (2048, 768, None), (2048, 1536, None),
    (512, 1536, None),
    (2 * 36 * 36, 1024, (36, 36, 0, 0, 32, 32)),
    (2 * 36 * 36, 1024, (36, 36, 6, 0, 32, 32)),
    (2048, 1024, None), (512, 1024, None),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,c,canvas", LN_FLIP_CASES)
def test_ln_code_flips_are_rare_and_one_step(dev, t, c, canvas, dtype):
    """The row pass's LN codes against the plain model's (F.layer_norm, pad
    zeroing and the rounding to x's dtype, quantize_rows): statistics
    summed in other orders may flip a code on a rounding boundary, by one
    step, rarely. For f32 canvases a plain model that rounds the rows to
    bf16 (what the kernel must not do) flips far more."""
    gen = torch.Generator(dev).manual_seed(t + c)
    x = _randn(gen, (t, c), dev, 1.0, dtype)
    ln = {"scale": 1 + 0.1 * _randn(gen, (c,), dev),
          "bias": 0.1 * _randn(gen, (c,), dev)}
    flips, worst, n = int8_gemm.ln_code_flips(x, ln, canvas)
    assert worst <= 1, f"{flips} of {n} codes differ, by up to {worst}"
    assert flips <= 1e-3 * n, f"{flips} of {n} codes differ"
    if dtype == torch.float32 and canvas is not None:
        control, _, _ = int8_gemm.ln_code_flips(x, ln, canvas, torch.bfloat16)
        assert control > 1e-3 * n, f"bf16-rounded control: {control} of {n}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("hw", [(24, 24), (20, 17), (16, 16)])
# and swin_b's stage 3 (32 heads at C = 1024)
@pytest.mark.parametrize("heads,c", [(2, 64), (6, 192), (32, 1024)])
def test_fused_block_attn_int8_kernel_matches_plain(dev, shift, hw, heads, c,
                                                    dtype):
    gen = torch.Generator(dev).manual_seed(7)
    h, w = hw
    x = _randn(gen, (2, h, w, c), dev, 1.0, dtype)
    norm1, attn = _block_params(gen, c, heads, dev)
    attn = _quantized(pparams.tree_map(lambda _, v: v.float(), attn), "attn",
                      dtype)
    hp, wp = -(-h // 12) * 12, -(-w // 12) * 12
    canvas, k_shift, k_mask, origin = swin.fused_block_canvas(
        x, 12, shift, W.sw_msa_mask(hp, wp, 12, 6, dev))
    args = (canvas, norm1, attn, 12, k_shift, heads, k_mask, h, w, origin)
    n0 = fused_block_attn.fused_window_block_attention_int8.launches
    got = fused_block_attn.fused_window_block_attention(*args)
    assert fused_block_attn.fused_window_block_attention_int8.launches == n0 + 1
    want = fused_block_attn.fused_window_block_attention_int8_plain(*args)
    crop = (slice(None), slice(origin, origin + h), slice(origin, origin + w))
    if k_shift:
        got = W.roll_2d(got, k_shift, k_shift)
        want = W.roll_2d(want, k_shift, k_shift)
    _assert_close(got[crop], want[crop],
                  MEAN_BOUND_K1_I8_WIDE if c >= 768 else MEAN_BOUND_I8)


def test_int8_kernels_refuse_f32(dev):
    """No longer refused: the W8A8 wrappers take f32 activations on the
    card, launch their f32 kernels and return their plain versions'
    results (K3 within the int8 bounds, K1-int8 too); other dtypes are
    refused."""
    gen = torch.Generator(dev).manual_seed(8)
    n2, mlp = _mlp_params(gen, 64, dev)
    mlp = _quantized(pparams.tree_map(lambda _, v: v.float(), mlp), "mlp",
                     torch.float32)
    x = _randn(gen, (16, 64), dev)
    n0 = fused_mlp.fused_mlp_residual_int8.launches
    got = fused_mlp.fused_mlp_residual(x, n2, mlp)
    assert fused_mlp.fused_mlp_residual_int8.launches == n0 + 1
    assert got.dtype == torch.float32
    _assert_close(got, fused_mlp.fused_mlp_residual_int8_plain(x, n2, mlp),
                  MEAN_BOUND_I8)
    with pytest.raises(TypeError):
        fused_mlp.fused_mlp_residual(x.half(), n2, mlp)
    norm1, attn = _block_params(gen, 64, 2, dev)
    attn = _quantized(_f32(attn), "attn", torch.float32)
    xa = _randn(gen, (2, 24, 24, 64), dev)
    args = (xa, norm1, attn, 12, 0, 2, None, 24, 24)
    n0 = fused_block_attn.fused_window_block_attention_int8.launches
    got = fused_block_attn.fused_window_block_attention(*args)
    assert fused_block_attn.fused_window_block_attention_int8.launches == n0 + 1
    assert got.dtype == torch.float32
    _assert_close(got, fused_block_attn.fused_window_block_attention_int8_plain(
        *args), MEAN_BOUND_I8)


# K5's shapes: W % 8 == 0 takes the 16-byte staging, other W the scalar
# staging; H and W off the 32 x 128 tile, B = 3, and the main path's shape.
TAP_CONV_SHAPES = [(2, 32, 40, 3), (1, 70, 130, 3), (3, 50, 136, 3),
                   (2, 45, 77, 3), (1, 97, 264, 3), (2, 1024, 1024, 3)]


@pytest.fixture(scope="module")
def tap_conv_first(dev):
    """K5's first body (tools/tap_conv_first.cu), built with nvcc beside the
    library, as a function (x, k [5, 5, 3] f32, bias [1] f32) -> out. The
    redesigned kernel applies the taps in its order (channel, row, column
    offset, one fmaf each from the bias), so their outputs are bitwise
    equal."""
    import ctypes

    from birefnet_tpu_torch.ops.kernels import build

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "tap_conv_first.cu")
    lib = build.build_extra(src)
    fn = ctypes.CDLL(lib).tap_conv5_first
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, k, b):
        out = torch.empty(x.shape[:3], dtype=x.dtype, device=x.device)
        kf = k.reshape(5, 5, 3).float().contiguous()
        assert fn(x.data_ptr(), kf.data_ptr(), b.data_ptr(), out.data_ptr(),
                  *x.shape[:3], build.stream(x.device)) == 0
        return out
    return run


@pytest.mark.parametrize("shape", TAP_CONV_SHAPES)
def test_tap_conv_kernel_matches_plain(dev, shape):
    gen = torch.Generator(dev).manual_seed(3)
    x = _randn(gen, shape, dev, 1.0, torch.bfloat16)
    k = _randn(gen, (5, 5, 3, 1), dev)
    b = _randn(gen, (1,), dev)
    n0 = tap_conv.tap_conv_same.launches
    got = tap_conv.tap_conv_same(x, k, b)
    assert tap_conv.tap_conv_same.launches == n0 + 1
    _assert_close(got, tap_conv.tap_conv_same_plain(x, k, b))


@pytest.mark.parametrize("shape", TAP_CONV_SHAPES)
def test_tap_conv_kernel_equals_its_first_body(dev, tap_conv_first, shape):
    """Bitwise equal to K5's first body, with a bias and without one (the
    redesigned entry takes a null bias for 0)."""
    gen = torch.Generator(dev).manual_seed(4)
    x = _randn(gen, shape, dev, 1.0, torch.bfloat16)
    k = _randn(gen, (5, 5, 3, 1), dev, 0.2)
    b = _randn(gen, (1,), dev)
    assert torch.equal(tap_conv.tap_conv_same(x, k, b),
                       tap_conv_first(x, k, b))
    assert torch.equal(tap_conv.tap_conv_same(x, k[..., 0]),
                       tap_conv_first(x, k, torch.zeros(1, device=dev)))


def test_kernels_refuse_f32(dev):
    """tap_conv runs bf16 only (the JAX decoder calls its kernel for bf16
    only); the other kernels take f32 (the f32 tier below)."""
    with pytest.raises(TypeError):
        tap_conv.tap_conv_same(torch.zeros((1, 8, 8, 3), device=dev),
                               torch.zeros((5, 5, 3), device=dev))


def test_swin_kernel_tier_matches_f32_plain(dev):
    """A narrow ws=12 Swin on the kernel tier in bf16 against the plain f32
    forward on the card; every kernel of the backbone launches."""
    from birefnet_tpu_torch.configs import ComputeConfig, SwinConfig
    from birefnet_tpu_torch.params import (_Source, _swin, _swin_entries,
                                           cast_matmul_weights, tree_map)

    cfg = SwinConfig(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))
    rng = np.random.default_rng(5)
    flat = {k: rng.normal(0, 0.05, s).astype(np.float32)
            for k, s in _swin_entries("bb", cfg)}
    params = tree_map(lambda _, v: v.to(dev), _swin(_Source(flat), "bb", cfg))
    x = torch.from_numpy(rng.normal(size=(2, 96, 96, 3)).astype(np.float32))
    x = x.to(dev)
    ref = swin.swin_forward(params, cfg, x, ComputeConfig())
    counters = (fused_block_attn.fused_window_block_attention,
                fused_mlp.fused_mlp_residual, row_ln.layer_norm_rows)
    before = [f.launches for f in counters]
    got = swin.swin_forward(cast_matmul_weights(params, torch.bfloat16), cfg,
                            x.to(torch.bfloat16),
                            ComputeConfig(dtype=torch.bfloat16,
                                          use_flash_attention=True))
    assert [f.launches - b for f, b in zip(counters, before)] == [8, 8, 8]
    for g, r in zip(got, ref):
        err = (g.float() - r).abs().mean().item()
        assert err < 5e-2, f"mean |bf16 kernels - f32 plain| = {err}"


def test_swin_int8_kernel_tier_matches_f32_plain(dev):
    """The narrow Swin with its stages 2 and 3 (C >= 256) quantized: those
    blocks launch the int8 kernels, the others the bf16 ones."""
    from birefnet_tpu_torch.configs import ComputeConfig, SwinConfig
    from birefnet_tpu_torch.params import (_Source, _swin, _swin_entries,
                                           cast_matmul_weights, tree_map)

    cfg = SwinConfig(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))
    rng = np.random.default_rng(9)
    flat = {k: rng.normal(0, 0.05, s).astype(np.float32)
            for k, s in _swin_entries("bb", cfg)}
    params = tree_map(lambda _, v: v.to(dev), _swin(_Source(flat), "bb", cfg))
    x = torch.from_numpy(rng.normal(size=(2, 128, 128, 3)).astype(np.float32))
    x = x.to(dev)
    ref = swin.swin_forward(params, cfg, x, ComputeConfig())
    q = pparams.quantize_attn_int8(pparams.quantize_mlp_int8(params, 256), 256)
    counters = (fused_block_attn.fused_window_block_attention,
                fused_block_attn.fused_window_block_attention_int8,
                fused_mlp.fused_mlp_residual, fused_mlp.fused_mlp_residual_int8,
                row_ln.layer_norm_rows)
    before = [f.launches for f in counters]
    got = swin.swin_forward(cast_matmul_weights(q, torch.bfloat16), cfg,
                            x.to(torch.bfloat16),
                            ComputeConfig(dtype=torch.bfloat16,
                                          use_flash_attention=True,
                                          int8_mlp=True, int8_attn=True))
    assert [f.launches - b for f, b in zip(counters, before)] == [4, 4, 4, 4, 8]
    for g, r in zip(got, ref):
        err = (g.float() - r).abs().mean().item()
        assert err < 5e-2, f"mean |int8 kernels - f32 plain| = {err}"


# Mean bound of the window-attention kernel against its plain version: both
# round at the same points, so only sums in another order differ (the H100
# read at most 3.6e-7 at the swin_t shapes in chip_smoke.py).
MEAN_BOUND_FWA = 1e-5


@pytest.mark.parametrize("masked", [False, True])
# swin_t stage 0 at 35^2 (25 windows per image) and stage 3 at 21^2, and a
# ws=12 geometry; B_ is two images' windows.
@pytest.mark.parametrize("b_,ws,heads,hp", [(50, 7, 3, 35), (18, 7, 24, 21),
                                            (8, 12, 2, 24)])
def test_flash_qkv_kernel_matches_plain(dev, b_, ws, heads, hp, masked):
    gen = torch.Generator(dev).manual_seed(10)
    n, c = ws * ws, heads * 32
    qkv = _randn(gen, (b_, n, 3 * c), dev, 1.0, torch.bfloat16)
    bias = _randn(gen, (heads, n, n), dev, 3.0)
    mask = W.sw_msa_mask(hp, hp, ws, ws // 2, dev) if masked else None
    n0 = flash_window_attn.flash_window_attention_qkv.launches
    got = flash_window_attn.flash_window_attention_qkv(qkv, bias, mask, heads)
    assert flash_window_attn.flash_window_attention_qkv.launches == n0 + 1
    _assert_close(got, flash_window_attn.flash_window_attention_qkv_plain(
        qkv, bias, mask, heads), MEAN_BOUND_FWA)


# The JAX package's test shapes: (B_, heads, N, d, nW or None).
@pytest.mark.parametrize("b_,heads,n,d,nw", [
    (4, 2, 16, 8, None), (36, 4, 144, 32, 9), (8, 2, 16, 8, 4),
    (6, 2, 256, 64, 3), (5, 3, 49, 24, None),
    # head dims 8, 16, 40 and 64 of the core, N padded and not
    (10, 3, 49, 8, 5), (6, 4, 49, 16, None), (4, 2, 144, 40, 2),
    (6, 2, 100, 64, 3), (3, 6, 64, 64, None)])
def test_flash_window_attention_kernel_matches_plain(dev, b_, heads, n, d, nw):
    gen = torch.Generator(dev).manual_seed(11)
    q, k, v = (_randn(gen, (b_, heads, n, d), dev, 1.0, torch.bfloat16)
               for _ in range(3))
    bias = _randn(gen, (heads, n, n), dev)
    mask = None
    if nw is not None:
        mask = torch.where(torch.rand((nw, n, n), generator=gen, device=dev)
                           < 0.3, -100.0, 0.0)
    n0 = flash_window_attn.flash_window_attention.launches
    got = flash_window_attn.flash_window_attention(q, k, v, bias, mask)
    assert flash_window_attn.flash_window_attention.launches == n0 + 1
    _assert_close(got, flash_window_attn.flash_window_attention_plain(
        q, k, v, bias, mask), MEAN_BOUND_FWA)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(4, 2, 16, 8), (3, 2, 100, 24)])
def test_flash_attention_kernel_matches_plain(dev, causal, shape):
    gen = torch.Generator(dev).manual_seed(12)
    q, k, v = (_randn(gen, shape, dev, 1.0, torch.bfloat16)
               for _ in range(3))
    n0 = flash_window_attn.flash_attention.launches
    got = flash_window_attn.flash_attention(q, k, v, causal)
    assert flash_window_attn.flash_attention.launches == n0 + 1
    _assert_close(got, flash_window_attn.flash_attention_plain(q, k, v, causal),
                  MEAN_BOUND_FWA)


# The core with the SW-MSA mask as region ids (the kernel tier's form) and
# as the dense f32 mask: the Swin-L offset mask at N = 144, the underfilled
# grids (Swin-L's half-pass stage 3, 8 windows x 48 heads; swin_t's,
# 18 x 24 at N = 49), and a mask period nW smaller than B_. Held to the
# plain version on the dense f32 tensors, and bitwise to the kernel on the
# dense form of the same mask.
@pytest.mark.parametrize("b_,heads,ws,hp,offset,form", [
    (8, 48, 12, 24, True, "ids"), (8, 48, 12, 24, True, "dense"),
    (18, 24, 7, 21, False, "ids"), (50, 3, 7, 35, False, "ids"),
    (72, 6, 12, 36, True, "ids"), (32, 4, 12, 48, False, "ids")])
def test_window_core_region_ids_match_plain(dev, b_, heads, ws, hp, offset,
                                            form):
    gen = torch.Generator(dev).manual_seed(15)
    n, bf = ws * ws, torch.bfloat16
    qkv = _randn(gen, (b_, n, 3 * heads * 32), dev, 1.0, bf)
    q, k, v = qkv.view(b_, n, 3, heads, 32).permute(2, 0, 3, 1, 4)
    bias = _randn(gen, (heads, n, n), dev, 3.0)
    ids = W.sw_msa_region_ids(hp, hp, ws, ws // 2, dev, offset=offset)
    dense = (W.sw_msa_mask_offset if offset else W.sw_msa_mask)(
        hp, hp, ws, ws // 2, dev)
    assert b_ % ids.shape[0] == 0
    mask = dense if form == "dense" else ids
    n0 = flash_window_attn.flash_window_attention.launches
    got = flash_window_attn.flash_window_attention(q, k, v, bias, mask)
    assert flash_window_attn.flash_window_attention.launches == n0 + 1
    _assert_close(got, flash_window_attn.flash_window_attention_plain(
        q, k, v, bias, dense), MEAN_BOUND_FWA)
    assert torch.equal(got, flash_window_attn.flash_window_attention(
        q, k, v, bias, dense))


@pytest.mark.parametrize("hw", [(20, 17), (16, 16)])
def test_fused_block_attn_takes_region_ids(dev, hw):
    """K1 and K1-int8 on the region-id form of the cyclic and offset masks
    (what models/swin.py passes) give bitwise their dense-mask outputs."""
    gen = torch.Generator(dev).manual_seed(16)
    h, w = hw
    heads, c = 2, 64
    x = _randn(gen, (2, h, w, c), dev, 1.0, torch.bfloat16)
    norm1, attn = _block_params(gen, c, heads, dev)
    attn_q = _quantized(pparams.tree_map(lambda _, v: v.float(), attn), "attn")
    hp, wp = -(-h // 12) * 12, -(-w // 12) * 12
    for tree in (attn, attn_q):
        outs = []
        for mask in (W.sw_msa_mask(hp, wp, 12, 6, dev),
                     W.sw_msa_region_ids(hp, wp, 12, 6, dev)):
            canvas, k_shift, k_mask, origin = swin.fused_block_canvas(
                x, 12, 6, mask)
            outs.append(fused_block_attn.fused_window_block_attention(
                canvas, norm1, tree, 12, k_shift, heads, k_mask, h, w,
                origin))
        assert torch.equal(outs[0], outs[1])


def test_flash_window_attn_refuses_f32_and_wide_heads(dev):
    """q, k, v of mixed dtypes are refused; wide heads (d = 72, which the
    key-tiled core takes) run in either dtype, f32 included, and match the
    plain version. The name is kept from when f32 and d > 64 were
    refused."""
    q = torch.zeros((2, 1, 16, 8), device=dev)
    with pytest.raises(TypeError):
        flash_window_attn.flash_attention(q, q.bfloat16(), q)
    gen = torch.Generator(dev).manual_seed(18)
    for dtype in (torch.bfloat16, torch.float32):
        wide = _randn(gen, (2, 1, 16, 72), dev, 1.0, dtype)
        got = flash_window_attn.flash_attention(wide, wide, wide)
        want = flash_window_attn.flash_attention_plain(wide, wide, wide)
        if dtype == torch.float32:
            _assert_close_f32(got, want)
        else:
            _assert_close(got, want, MEAN_BOUND_FWA)


@pytest.mark.parametrize("kernel", ["fused_block_attn", "flash_window_attn"])
def test_window_core_refuses_a_bf16_bias(dev, kernel):
    """The core reads the rel-pos bias as the f32 tensor it is given; a
    bf16 one is refused, not converted per call."""
    gen = torch.Generator(dev).manual_seed(17)
    bias = _randn(gen, (2, 144, 144), dev, 1.0, torch.bfloat16)
    with pytest.raises(ValueError, match="bias"):
        if kernel == "fused_block_attn":
            norm1, attn = _block_params(gen, 64, 2, dev)
            x = _randn(gen, (2, 24, 24, 64), dev, 1.0, torch.bfloat16)
            fused_block_attn.fused_window_block_attention(
                x, norm1, dict(attn, cached_bias=bias), 12, 0, 2, None, 24, 24)
        else:
            q = _randn(gen, (2, 2, 144, 32), dev, 1.0, torch.bfloat16)
            flash_window_attn.flash_window_attention(q, q, q, bias)


@pytest.mark.parametrize("kernel", ["fused_block_attn", "fused_block_attn_int8",
                                    "flash_window_attn_qkv"])
def test_kernels_round_the_bias_to_bf16(dev, kernel):
    """The K1, K1-int8 and K6 kernels take the rel-pos bias rounded to bf16:
    a bias B and bf16(B) give bitwise the same output."""
    gen = torch.Generator(dev).manual_seed(13)
    heads, c = 2, 64
    ws = 7 if kernel == "flash_window_attn_qkv" else 12
    bias = _randn(gen, (heads, ws * ws, ws * ws), dev, 3.0)
    rounded = bias.bfloat16().float()
    assert not torch.equal(bias, rounded)
    if kernel == "flash_window_attn_qkv":
        qkv = _randn(gen, (8, 49, 3 * c), dev, 1.0, torch.bfloat16)

        def run(b):
            return flash_window_attn.flash_window_attention_qkv(qkv, b, None,
                                                                heads)
    else:
        norm1, attn = _block_params(gen, c, heads, dev)
        if kernel == "fused_block_attn_int8":
            attn = _quantized(pparams.tree_map(lambda _, v: v.float(), attn),
                              "attn")
        x = _randn(gen, (2, 24, 24, c), dev, 1.0, torch.bfloat16)

        def run(b):
            return fused_block_attn.fused_window_block_attention(
                x, norm1, dict(attn, cached_bias=b), 12, 0, heads, None, 24, 24)
    assert torch.equal(run(bias), run(rounded))


def test_swin_middle_tier_matches_f32_plain(dev):
    """A narrow ws=7 Swin on the kernel tier in bf16 against the plain f32
    forward on the card: K6, K2 and row_ln launch."""
    from birefnet_tpu_torch.configs import ComputeConfig, SwinConfig
    from birefnet_tpu_torch.params import (_Source, _swin, _swin_entries,
                                           cast_matmul_weights, tree_map)

    cfg = SwinConfig(embed_dim=96, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                     window_size=7)
    rng = np.random.default_rng(14)
    flat = {k: rng.normal(0, 0.05, s).astype(np.float32)
            for k, s in _swin_entries("bb", cfg)}
    params = tree_map(lambda _, v: v.to(dev), _swin(_Source(flat), "bb", cfg))
    x = torch.from_numpy(rng.normal(size=(2, 128, 128, 3)).astype(np.float32))
    x = x.to(dev)
    ref = swin.swin_forward(params, cfg, x, ComputeConfig())
    counters = (flash_window_attn.flash_window_attention_qkv,
                fused_mlp.fused_mlp_residual, row_ln.layer_norm_rows,
                fused_block_attn.fused_window_block_attention)
    before = [f.launches for f in counters]
    got = swin.swin_forward(cast_matmul_weights(params, torch.bfloat16), cfg,
                            x.to(torch.bfloat16),
                            ComputeConfig(dtype=torch.bfloat16,
                                          use_flash_attention=True))
    assert [f.launches - b for f, b in zip(counters, before)] == [8, 8, 8, 0]
    for g, r in zip(got, ref):
        err = (g.float() - r).abs().mean().item()
        assert err < 5e-2, f"mean |bf16 kernels - f32 plain| = {err}"


# The f32 tier: full f32 products summed in f32 on both sides, in other
# orders, so the kernels and their plain versions (TF32 off, as the dev
# fixture sets) differ by f32 rounding only.
MEAN_BOUND_F32 = 1e-5


def _f32_error(got, want):
    """(max|got - want| / max|want|, mean|got - want| / mean|want|)."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    d = (got - want).abs()
    return ((d.max() / want.abs().max()).item(),
            (d.mean() / want.abs().mean()).item())


def _assert_close_f32(got, want):
    top, mean = _f32_error(got, want)
    assert top <= 1e-4, f"max|kernel - plain| / max|plain| = {top}"
    assert mean <= MEAN_BOUND_F32, f"mean|kernel - plain| / mean|plain| = {mean}"


@pytest.fixture
def tf32_on():
    """PyTorch's TF32 flags on for the test, then off again as the dev
    fixture leaves them."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# (M, N, K, epilogue): K1's qkv and proj at Swin-L's stage-2 canvas, K2's
# fc1 and fc2 at Swin-L's stage 2 and swin_t's stage 0 (C = 96), and every
# epilogue at M and N tails (N = 192: one and a half tiles) and at a tiny
# shape.
F32_GEMM_SHAPES = (
    [(10368, 2304, 768, "store"), (10368, 768, 768, "residual"),
     (8192, 3072, 768, "gelu"), (8192, 768, 3072, "residual"),
     (131072, 384, 96, "gelu"), (131072, 96, 384, "residual")]
    + [(100, n, k, e) for e in ("store", "residual", "gelu")
       for n, k in ((96, 96), (192, 64))]
    + [(3, 4, 8, "residual")])


def _forward_gemm_shapes():
    """Every f32 GEMM shape of a 1024^2 batch-2 forward (both backbone
    passes), as chip_smoke.py phase 3 runs them: K1's qkv ("store") and
    proj ("residual") on Swin-L's padded canvases, K2's fc1 ("gelu") and
    fc2 ("residual") on Swin-L's and swin_t's tokens."""
    shapes = set()
    for model, ws, c0 in (("swin_l", 12, 192), ("swin_t", 7, 96)):
        for side in (256, 128):
            for i in range(4):
                h, c = side >> i, c0 << i
                t, hp = 2 * h * h, -(-h // ws) * ws
                if model == "swin_l":
                    shapes |= {(2 * hp * hp, 3 * c, c, "store"),
                               (2 * hp * hp, c, c, "residual")}
                shapes |= {(t, 4 * c, c, "gelu"), (t, c, 4 * c, "residual")}
    return sorted(shapes)


F32_GEMM_SHAPES += [s for s in _forward_gemm_shapes()
                    if s not in F32_GEMM_SHAPES]


def _f32_gemm_case(m, n, k, epilogue, dev):
    gen = torch.Generator(dev).manual_seed(m + n + k)
    a = _randn(gen, (m, k), dev)
    lin = {"weight": _randn(gen, (n, k), dev, k ** -0.5),
           "bias": _randn(gen, (n,), dev, 0.5)}
    res = _randn(gen, (m, n), dev) if epilogue == "residual" else None
    return a, lin, res


@pytest.mark.parametrize("m,n,k,epilogue", F32_GEMM_SHAPES)
def test_f32_gemm_matches_plain(dev, m, n, k, epilogue):
    a, lin, res = _f32_gemm_case(m, n, k, epilogue, dev)
    n0 = f32_gemm.f32_gemm.launches
    got = f32_gemm.f32_gemm(a, lin, epilogue, res)
    assert f32_gemm.f32_gemm.launches == n0 + 1
    _assert_close_f32(got, f32_gemm.f32_gemm_plain(a, lin, epilogue, res))


@pytest.mark.parametrize("m,n,k,epilogue", [(10368, 768, 768, "residual"),
                                            (8192, 3072, 768, "gelu"),
                                            (100, 96, 96, "store")])
def test_tf32_plain_breaks_the_f32_bound(dev, m, n, k, epilogue, tf32_on):
    """Control: the plain version with TF32 on is no f32 product; the mean
    bound must tell it from the kernel."""
    a, lin, res = _f32_gemm_case(m, n, k, epilogue, dev)
    got = f32_gemm.f32_gemm(a, lin, epilogue, res)
    _, mean = _f32_error(got, f32_gemm.f32_gemm_plain(a, lin, epilogue, res))
    assert mean > MEAN_BOUND_F32, mean


@pytest.mark.parametrize("t,c,canvas", LN_ROW_CASES)
def test_ln_rows_f32_matches_plain(dev, t, c, canvas):
    gen = torch.Generator(dev).manual_seed(t + c)
    x = _randn(gen, (t, c), dev, 3.0)
    ln = {"scale": 1 + 0.1 * _randn(gen, (c,), dev),
          "bias": 0.1 * _randn(gen, (c,), dev)}
    n0 = f32_gemm.ln_rows_f32.launches
    got = f32_gemm.ln_rows_f32(x, ln, canvas)
    assert f32_gemm.ln_rows_f32.launches == n0 + 1
    if canvas is not None:
        assert not got[~fused_block_attn.pad_token_rows(canvas, t, dev)].any()
    _assert_close_f32(got, f32_gemm.ln_rows_f32_plain(x, ln, canvas))


def _f32_mask(kind, b_, n, ws, dev, gen):
    """None, the region ids or the dense mask of a shifted window grid
    whose B_ windows are two images' (ws only), or a random dense mask of
    0 / -100 over B_ / 2 windows."""
    if kind is None:
        return None
    if kind == "random":
        return torch.where(torch.rand((b_ // 2, n, n), generator=gen,
                                      device=dev) < 0.3, -100.0, 0.0)
    hp = int((b_ // 2) ** 0.5) * ws
    if kind == "ids":
        return W.sw_msa_region_ids(hp, hp, ws, ws // 2, dev)
    return W.sw_msa_mask(hp, hp, ws, ws // 2, dev)


# (B_, heads, N, d, mask): the Swin-L core (N = 144) and swin_t's (N = 49)
# with each mask form, and K7/K8's API shapes: N = 16 at d = 8, N = 100
# and 256 at d = 64.
F32_CORE_CASES = [(8, 2, 144, 32, None), (8, 2, 144, 32, "ids"),
                  (18, 3, 144, 32, "dense"), (50, 3, 49, 32, "ids"),
                  (50, 3, 49, 32, "dense"), (4, 2, 16, 8, None),
                  (4, 2, 16, 8, "random"), (4, 2, 100, 64, "random"),
                  (4, 2, 256, 64, "random"), (2, 3, 256, 64, None)]


@pytest.mark.parametrize("b_,heads,n,d,kind", F32_CORE_CASES)
def test_window_core_f32_matches_plain(dev, b_, heads, n, d, kind):
    gen = torch.Generator(dev).manual_seed(b_ + n + d)
    q, k, v = (_randn(gen, (b_, heads, n, d), dev) for _ in range(3))
    bias = _randn(gen, (heads, n, n), dev, 3.0)
    mask = _f32_mask(kind, b_, n, int(n ** 0.5), dev, gen)
    n0 = flash_window_attn.flash_window_attention.launches
    got = flash_window_attn.flash_window_attention(q, k, v, bias, mask)
    assert flash_window_attn.flash_window_attention.launches == n0 + 1
    want = flash_window_attn.flash_window_attention_plain(q, k, v, bias, mask)
    _assert_close_f32(got, want)


@pytest.mark.parametrize("form", ["none", "ids", "dense", "causal"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [49, 144, 256])
def test_window_core_f32_forms_match_plain(dev, n, d, form):
    """The strided layout at swin_t's, Swin-L's and the API's widest N,
    d 32 and 64, with every addend form: a bias alone, region ids and the
    dense mask of a shifted grid of (sqrt N)^2 windows, and the causal flag
    (flash_attention, no bias). K1's canvas layout is held by the f32
    fused_block_attn tests."""
    gen = torch.Generator(dev).manual_seed(n + d)
    q, k, v = (_randn(gen, (8, 3, n, d), dev) for _ in range(3))
    if form == "causal":
        got = flash_window_attn.flash_attention(q, k, v, True)
        _assert_close_f32(got, flash_window_attn.flash_attention_plain(
            q, k, v, True))
        return
    bias = _randn(gen, (3, n, n), dev, 3.0)
    mask = _f32_mask(None if form == "none" else form, 8, n, int(n ** 0.5),
                     dev, gen)
    got = flash_window_attn.flash_window_attention(q, k, v, bias, mask)
    _assert_close_f32(got, flash_window_attn.flash_window_attention_plain(
        q, k, v, bias, mask))


def test_window_core_tf32_plain_breaks_the_f32_bound(dev, tf32_on):
    gen = torch.Generator(dev).manual_seed(3)
    q, k, v = (_randn(gen, (8, 2, 144, 32), dev) for _ in range(3))
    bias = _randn(gen, (2, 144, 144), dev, 3.0)
    got = flash_window_attn.flash_window_attention(q, k, v, bias)
    _, mean = _f32_error(
        got, flash_window_attn.flash_window_attention_plain(q, k, v, bias))
    assert mean > MEAN_BOUND_F32, mean


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(4, 2, 16, 8), (2, 2, 256, 64)])
def test_flash_attention_f32_matches_plain(dev, causal, shape):
    """flash_attention in f32: the causal addend is -1e9 unrounded."""
    gen = torch.Generator(dev).manual_seed(11)
    q, k, v = (_randn(gen, shape, dev) for _ in range(3))
    n0 = flash_window_attn.flash_attention.launches
    got = flash_window_attn.flash_attention(q, k, v, causal)
    assert flash_window_attn.flash_attention.launches == n0 + 1
    _assert_close_f32(got, flash_window_attn.flash_attention_plain(q, k, v,
                                                                   causal))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b_,heads,hp", [(50, 3, 35), (18, 24, 21)])
def test_flash_qkv_f32_matches_plain(dev, b_, heads, hp, masked):
    gen = torch.Generator(dev).manual_seed(12)
    c = heads * 32
    qkv = _randn(gen, (b_, 49, 3 * c), dev)
    bias = _randn(gen, (heads, 49, 49), dev, 3.0)
    mask = W.sw_msa_region_ids(hp, hp, 7, 3, dev) if masked else None
    n0 = flash_window_attn.flash_window_attention_qkv.launches
    got = flash_window_attn.flash_window_attention_qkv(qkv, bias, mask, heads)
    assert flash_window_attn.flash_window_attention_qkv.launches == n0 + 1
    _assert_close_f32(got, flash_window_attn.flash_window_attention_qkv_plain(
        qkv, bias, mask, heads))


def _f32(tree):
    return pparams.tree_map(lambda _, v: v.float(), tree)


@pytest.mark.parametrize("t,c", [(100, 64), (512, 192), (48, 1536), (100, 96),
                                 (4096, 96)])
def test_fused_mlp_f32_matches_plain(dev, t, c):
    gen = torch.Generator(dev).manual_seed(1)
    x = _randn(gen, (t, c), dev)
    n2, mlp = _mlp_params(gen, c, dev)
    mlp = _f32(mlp)
    n0 = fused_mlp.fused_mlp_residual.launches
    got = fused_mlp.fused_mlp_residual(x, n2, mlp)
    assert fused_mlp.fused_mlp_residual.launches == n0 + 1
    _assert_close_f32(got, fused_mlp.fused_mlp_residual_plain(x, n2, mlp))


@pytest.mark.parametrize("mask_form", ["dense", "ids"])
@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("hw", [(24, 24), (20, 17), (16, 16)])
@pytest.mark.parametrize("heads,c", [(2, 64), (6, 192), (4, 128), (16, 512)])
def test_fused_block_attn_f32_matches_plain(dev, shift, hw, heads, c,
                                            mask_form):
    gen = torch.Generator(dev).manual_seed(2)
    h, w = hw
    x = _randn(gen, (2, h, w, c), dev)
    norm1, attn = _block_params(gen, c, heads, dev)
    attn = _f32(attn)
    hp, wp = -(-h // 12) * 12, -(-w // 12) * 12
    mask = (W.sw_msa_mask(hp, wp, 12, 6, dev) if mask_form == "dense"
            else W.sw_msa_region_ids(hp, wp, 12, 6, dev))
    canvas, k_shift, k_mask, origin = swin.fused_block_canvas(x, 12, shift,
                                                              mask)
    args = (canvas, norm1, attn, 12, k_shift, heads, k_mask, h, w, origin)
    n0 = fused_block_attn.fused_window_block_attention.launches
    got = fused_block_attn.fused_window_block_attention(*args)
    assert fused_block_attn.fused_window_block_attention.launches == n0 + 1
    want = fused_block_attn.fused_window_block_attention_plain(*args)
    crop = (slice(None), slice(origin, origin + h), slice(origin, origin + w))
    if k_shift:
        got = W.roll_2d(got, k_shift, k_shift)
        want = W.roll_2d(want, k_shift, k_shift)
    _assert_close_f32(got[crop].contiguous(), want[crop].contiguous())


def test_int8_path_refuses_f32_on_the_card(dev):
    """No longer refused: make_infer_fn runs the int8 flags on the f32
    kernel tier, Swin-L's stages 2 and 3 through the f32 K1-int8 and K3
    kernels (one launch of each per block in the captured call; the first
    call runs the body twice, to warm it up and to capture it), and its
    masks stay within the int8 path's mask gate (MAE < 1e-3) of the f32
    plain pipeline's."""
    from birefnet_tpu_torch import pipeline
    from birefnet_tpu_torch.configs import BiRefNetConfig, ComputeConfig
    from birefnet_tpu_torch.params import build_param_tree, random_checkpoint

    cfg = BiRefNetConfig(size=(128, 128))
    params = build_param_tree(random_checkpoint(cfg, 7), cfg)
    frames = np.random.default_rng(4).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    want = pipeline.make_infer_fn(params, cfg,
                                  ComputeConfig(deform_mode="regular"), dev,
                                  as_uint8=False)(frames)
    counters = (fused_block_attn.fused_window_block_attention_int8,
                fused_mlp.fused_mlp_residual_int8)
    before = [f.launches for f in counters]
    infer = pipeline.make_infer_fn(params, cfg, ComputeConfig(
        use_flash_attention=True, int8_mlp=True, int8_attn=True,
        deform_mode="regular"), dev, as_uint8=False)
    got = infer(frames)
    assert [f.launches - b for f, b in zip(counters, before)] == [80, 80]
    (captured,) = infer.launches.values()
    assert [captured["fused_block_attn.fused_window_block_attention_int8"],
            captured["fused_mlp.fused_mlp_residual_int8"]] == [40, 40]
    assert got.shape == want.shape and torch.isfinite(got).all()
    mae = (got - want).abs().mean().item()
    assert mae < 1e-3, f"mask MAE {mae}"


def _narrow_swin(cfg, seed, hw, dev):
    from birefnet_tpu_torch.params import _Source, _swin, _swin_entries

    rng = np.random.default_rng(seed)
    flat = {k: rng.normal(0, 0.05, s).astype(np.float32)
            for k, s in _swin_entries("bb", cfg)}
    params = pparams.tree_map(lambda _, v: v.to(dev),
                              _swin(_Source(flat), "bb", cfg))
    x = rng.normal(size=(2, hw, hw, 3)).astype(np.float32)
    return params, torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("ws", [12, 7])
def test_swin_f32_kernel_tier_matches_f32_plain(dev, ws):
    """A narrow Swin on the f32 kernel tier against the plain f32 forward:
    ws = 12 launches K1, K2 and row_ln, ws = 7 K6, K2 and row_ln; every
    stage's features within the f32 bounds."""
    from birefnet_tpu_torch.configs import ComputeConfig, SwinConfig

    cfg = (SwinConfig(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))
           if ws == 12 else
           SwinConfig(embed_dim=96, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                      window_size=7))
    params, x = _narrow_swin(cfg, 15, 128, dev)
    ref = swin.swin_forward(params, cfg, x, ComputeConfig())
    counters = (fused_block_attn.fused_window_block_attention,
                flash_window_attn.flash_window_attention_qkv,
                fused_mlp.fused_mlp_residual, row_ln.layer_norm_rows)
    before = [f.launches for f in counters]
    got = swin.swin_forward(params, cfg, x,
                            ComputeConfig(use_flash_attention=True))
    want = [8, 0, 8, 8] if ws == 12 else [0, 8, 8, 8]
    assert [f.launches - b for f, b in zip(counters, before)] == want
    for g, r in zip(got, ref):
        _assert_close_f32(g, r)


def test_make_infer_fn_f32_ignores_tf32_flags(dev, monkeypatch):
    """With PyTorch's default flags (cuDNN TF32 on) the f32 pipeline gives
    the masks and logits of a call made with both flags off, bit for bit:
    make_infer_fn turns TF32 off for an f32 forward. The graphed call with
    the flags off against the eager body with them on: a replay would not
    run the body again."""
    from birefnet_tpu_torch import pipeline
    from birefnet_tpu_torch.configs import BiRefNetConfig, ComputeConfig
    from birefnet_tpu_torch.models import birefnet
    from birefnet_tpu_torch.params import build_param_tree, random_checkpoint

    cfg = BiRefNetConfig(size=(128, 128))
    params = build_param_tree(random_checkpoint(cfg, 7), cfg)
    logits = []
    forward = birefnet.forward_logits

    def caught(*args, **kw):
        logits.append(forward(*args, **kw))
        return logits[-1]

    monkeypatch.setattr(birefnet, "forward_logits", caught)
    infer = pipeline.make_infer_fn(params, cfg,
                                   ComputeConfig(deform_mode="regular"), dev,
                                   as_uint8=False)
    frames = np.random.default_rng(3).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    off = infer(frames)
    try:
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
        on = infer.eager(frames)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert torch.equal(logits[0], logits[-1])
    assert torch.equal(off, on)


# make_infer_fn on the card replays one CUDA graph per input shape
# (pipeline.GraphedInfer); its `eager` runs the same body uncaptured.
GRAPH_TIERS = {
    "bf16 kernel tier": dict(dtype=torch.bfloat16, use_flash_attention=True,
                             deform_mode="regular"),
    "int8 path": dict(dtype=torch.bfloat16, use_flash_attention=True,
                      int8_mlp=True, int8_attn=True, deform_mode="regular"),
    "plain bf16": dict(dtype=torch.bfloat16, deform_mode="regular"),
    "f32 tier": dict(use_flash_attention=True, deform_mode="regular"),
    "f32 int8 path": dict(use_flash_attention=True, int8_mlp=True,
                          int8_attn=True, deform_mode="regular"),
    "plain f32": dict(deform_mode="regular"),
}


def _graph_model(backbone, size):
    import dataclasses

    from birefnet_tpu_torch.configs import BiRefNetConfig
    from birefnet_tpu_torch.params import build_param_tree, random_checkpoint

    cfg = dataclasses.replace(BiRefNetConfig.for_backbone(backbone),
                              size=(size, size))
    return cfg, build_param_tree(random_checkpoint(cfg, 0), cfg)


@pytest.fixture(scope="module")
def swin_t_128(dev):
    return _graph_model("swin_v1_t", 128)


@pytest.fixture(scope="module")
def swin_l_128(dev):
    return _graph_model("swin_v1_l", 128)


def _frames(seed, b=2, hw=128):
    return np.random.default_rng(seed).integers(0, 256, (b, hw, hw, 3),
                                                dtype=np.uint8)


def _launch_counts():
    from birefnet_tpu_torch import pipeline
    return {n: f.launches for n, f in pipeline.kernel_counters().items()}


def _moved(before):
    return {n: c - before[n] for n, c in _launch_counts().items()
            if c != before[n]}


def _graphed_equals_eager(cfg, params, tier, dev):
    """Graphed masks bitwise equal to the eager body's for two frame
    batches; the capture's launch counts equal an eager call's; a replay
    runs no wrapper; the returned masks are fresh tensors."""
    from birefnet_tpu_torch import pipeline
    from birefnet_tpu_torch.configs import ComputeConfig

    tiers = {**GRAPH_TIERS, **DEFORM_GRAPH_TIERS}
    infer = pipeline.make_infer_fn(params, cfg, ComputeConfig(**tiers[tier]),
                                   dev)
    assert isinstance(infer, pipeline.GraphedInfer)
    f1, f2 = _frames(1), _frames(2)
    before = _launch_counts()
    got1 = infer(f1)  # warm-up, capture, replay
    first = _moved(before)
    (key, captured), = infer.launches.items()
    assert key == ((2, 128, 128, 3), torch.uint8)
    assert first == {n: 2 * c for n, c in captured.items()}
    before = _launch_counts()
    want1 = infer.eager(f1)
    assert _moved(before) == captured
    assert torch.equal(got1, want1)
    before = _launch_counts()
    got2 = infer(f2)
    assert _moved(before) == {}  # a replay runs no Python wrapper
    assert torch.equal(got2, infer.eager(f2))
    assert torch.equal(got1, want1)  # not overwritten by the second replay
    static_out = infer._graphs[key][2]
    assert got2.data_ptr() != static_out.data_ptr()
    return captured


@pytest.mark.parametrize("tier", list(GRAPH_TIERS))
def test_graphed_infer_equals_eager_swin_t(dev, swin_t_128, tier):
    captured = _graphed_equals_eager(*swin_t_128, tier, dev)
    if "plain" not in tier:
        assert captured["row_ln.layer_norm_rows"] == 16
        assert captured["flash_window_attn.flash_window_attention_qkv"] == 24


@pytest.mark.parametrize("tier", ["int8 path", "f32 int8 path"])
def test_graphed_infer_equals_eager_swin_l(dev, swin_l_128, tier):
    captured = _graphed_equals_eager(*swin_l_128, tier, dev)
    assert "deform_im2col.deform_im2col" not in captured  # regular mode
    assert captured["fused_block_attn.fused_window_block_attention_int8"] == 40
    assert captured["fused_mlp.fused_mlp_residual_int8"] == 40


def test_graphed_infer_keeps_one_graph_per_batch(dev, swin_t_128):
    from birefnet_tpu_torch import pipeline
    from birefnet_tpu_torch.configs import ComputeConfig

    cfg, params = swin_t_128
    infer = pipeline.make_infer_fn(
        params, cfg, ComputeConfig(**GRAPH_TIERS["bf16 kernel tier"]), dev)
    frames = _frames(3)
    for b in (1, 2, 1):
        assert torch.equal(infer(frames[:b]), infer.eager(frames[:b]))
    assert sorted(k[0][0] for k in infer._graphs) == [1, 2]
    assert set(infer.pool_bytes) == set(infer._graphs)


def test_graphed_infer_owns_what_its_graph_reads(dev, swin_t_128):
    """A replay after every device cache is cleared and the freed memory
    is handed out again stays bitwise: the function holds its own
    references to the cached tensors its graph reads."""
    import gc

    from birefnet_tpu_torch import pipeline
    from birefnet_tpu_torch.configs import ComputeConfig
    from birefnet_tpu_torch.ops import resize

    cfg, params = swin_t_128
    infer = pipeline.make_infer_fn(
        params, cfg, ComputeConfig(**GRAPH_TIERS["int8 path"]), dev)
    frames = _frames(4)
    want = infer(frames)
    for module in (resize, W, pipeline):
        for fn in vars(module).values():
            if callable(getattr(fn, "cache_clear", None)):
                fn.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    junk = torch.full((64 << 20,), float("nan"), device=dev)  # 256 MB
    assert torch.equal(infer(frames), want)
    del junk


def test_two_graphed_functions_replay_at_once_on_one_card(dev, swin_t_128):
    """Two data groups on one card (parallel/sharding.ShardedInfer over
    [cuda:0, cuda:0]) replay their graphs at once through submit: each
    GraphedInfer captures on a stream of its own, so their graphs share no
    cuBLAS workspace; the masks are bitwise the sequential calls'."""
    from birefnet_tpu_torch.configs import ComputeConfig
    from birefnet_tpu_torch.parallel import mesh, sharding

    cfg, params = swin_t_128
    card = torch.device("cuda", torch.cuda.current_device())
    infer = sharding.make_sharded_infer_fn(
        mesh.make_mesh(devices=[card, card]), params, cfg,
        ComputeConfig(**GRAPH_TIERS["bf16 kernel tier"]))
    frames = np.concatenate([_frames(20), _frames(21)])
    want = infer(frames).cpu()
    out = torch.empty(tuple(want.shape), dtype=torch.uint8, pin_memory=True)
    for _ in range(4):
        out.zero_()
        infer.submit(torch.from_numpy(frames).pin_memory(), out).synchronize()
        assert torch.equal(out, want)


def test_graphed_infer_is_safe_across_threads(dev, swin_t_128):
    """Threads sharing one graphed function, each on a stream of its own,
    get the masks of their own frames: copy -> replay -> clone never
    interleaves on the graph's static buffers (one lock, one stream)."""
    import sys
    import threading

    from birefnet_tpu_torch import pipeline
    from birefnet_tpu_torch.configs import ComputeConfig

    cfg, params = swin_t_128
    infer = pipeline.make_infer_fn(
        params, cfg, ComputeConfig(**GRAPH_TIERS["bf16 kernel tier"]), dev)
    frames = [_frames(10 + i) for i in range(4)]
    want = [infer.eager(f) for f in frames]
    infer(frames[0])  # the capture
    torch.cuda.synchronize()
    bad = []

    def worker(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                for rep in range(4):
                    j = (i + rep) % len(frames)
                    got = infer(frames[j])
                    if not torch.equal(got, want[j]):
                        bad.append((i, rep))
        except Exception as e:  # reported below, with the thread's index
            bad.append((i, repr(e)))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def test_graphed_infer_submit_reads_back_bitwise(dev, swin_t_128):
    """serve.main's batches in flight: GraphedInfer.submit copies pinned
    frames in and the masks out into a pinned slot behind an event;
    three batches in flight (serve.DEPTH = 2: three slots) and two more after
    give bitwise __call__'s masks; a fourth batch in flight is refused, as
    is an `out` of the wrong shape."""
    from birefnet_tpu_torch import pipeline, serve
    from birefnet_tpu_torch.configs import ComputeConfig

    cfg, params = swin_t_128
    infer = pipeline.make_infer_fn(
        params, cfg, ComputeConfig(**GRAPH_TIERS["bf16 kernel tier"]), dev,
        out_size=(128, 128))
    frames = [_frames(20 + i) for i in range(5)]
    want = [infer(f).cpu().numpy() for f in frames]
    flight = serve.InFlight(infer, 2, 128)
    handles = [flight.submit(f) for f in frames[:3]]
    with pytest.raises(RuntimeError, match="in flight"):
        flight.submit(frames[3])
    got = [flight.wait(h) for h in handles]
    handles = [flight.submit(f) for f in frames[3:]]
    got += [flight.wait(h) for h in handles]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(infer.launches) == 1
    out = torch.empty((2, 64, 64), dtype=torch.uint8, pin_memory=True)
    with pytest.raises(ValueError, match="out is"):
        infer.submit(torch.from_numpy(frames[0]), out)


# D1 (csrc/deform_im2col.cu) at the decoder's 12 ASPP site shapes of a
# 1024^2 batch-2 forward: C = 64 at 32^2 (the squeeze block and
# decoder_block4), 64^2, 128^2 and 256^2, each with k = 1, 3 and 7; the
# offsets a few pixels, the masks across (0, 2). The kernel computes the
# plain version's f32 operations in the same order without FMA
# contraction: its columns are bitwise the plain version's.
DEFORM_SITES = [(side, k) for side in (32, 64, 128, 256) for k in (1, 3, 7)]


def _deform_case(side, k, dtype, dev, c=64, b=2):
    gen = torch.Generator(dev).manual_seed(1000 * side + k)
    x = torch.randn((b, side, side, c), generator=gen, device=dev).to(dtype)
    offset = torch.randn((b, side, side, 2 * k * k), generator=gen,
                         device=dev) * 3
    mask = (2 * torch.rand((b, side, side, k * k), generator=gen,
                           device=dev)).to(dtype)
    return x, offset, mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("side,k", DEFORM_SITES)
def test_deform_im2col_kernel_matches_plain_bitwise(dev, side, k, dtype):
    x, offset, mask = _deform_case(side, k, dtype, dev)
    before = deform_im2col.deform_im2col.launches
    got = deform_im2col.deform_im2col(x, offset, mask, k, k, 1, k // 2)
    assert deform_im2col.deform_im2col.launches == before + 1
    want = deform_im2col.deform_im2col_plain(x, offset, mask, k, k, 1, k // 2)
    assert got.shape == (2 * side * side, k * k * 64) and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,stride", [(64, 2), (6, 1), (5, 2)])
def test_deform_im2col_kernel_takes_views_strides_and_odd_widths(dev, c,
                                                                 stride,
                                                                 dtype):
    """A permuted (non-contiguous) input, stride 2, and widths that take
    the scalar path (C not a multiple of the 16-byte vector): still
    bitwise the plain version."""
    k, pad = 3, 1
    x, _, _ = _deform_case(19, k, dtype, dev, c=c)
    x = x.permute(0, 2, 1, 3)  # a view with other strides
    oh = (19 + 2 * pad - k) // stride + 1
    gen = torch.Generator(dev).manual_seed(c)
    offset = torch.randn((2, oh, oh, 2 * k * k), generator=gen,
                         device=dev) * 3
    mask = (2 * torch.rand((2, oh, oh, k * k), generator=gen,
                           device=dev)).to(dtype)
    got = deform_im2col.deform_im2col(x, offset, mask, k, k, stride, pad)
    want = deform_im2col.deform_im2col_plain(x, offset, mask, k, k, stride,
                                             pad)
    assert torch.equal(got, want)


def test_deform_im2col_refuses_other_dtypes(dev):
    x, offset, mask = _deform_case(32, 3, torch.float16, dev)
    with pytest.raises(TypeError, match="bf16 or f32"):
        deform_im2col.deform_im2col(x, offset, mask, 3, 3, 1, 1)
    x, offset, mask = _deform_case(32, 3, torch.bfloat16, dev)
    with pytest.raises(TypeError, match="mask in x's dtype"):
        deform_im2col.deform_im2col(x, offset, mask.float(), 3, 3, 1, 1)


DEFORM_GRAPH_TIERS = {
    "int8 path deformable": dict(dtype=torch.bfloat16,
                                 use_flash_attention=True, int8_mlp=True,
                                 int8_attn=True, deform_mode="deformable"),
    "bf16 kernel tier deformable": dict(dtype=torch.bfloat16,
                                        use_flash_attention=True,
                                        deform_mode="deformable"),
    "f32 tier deformable": dict(use_flash_attention=True,
                                deform_mode="deformable"),
}


@pytest.mark.parametrize("tier", list(DEFORM_GRAPH_TIERS))
def test_graphed_deformable_infer_equals_eager(dev, swin_l_128, tier):
    """The deformable paths of Swin-L: graphed masks bitwise the eager
    body's, D1 launched once per ASPP site (20) in the capture."""
    captured = _graphed_equals_eager(*swin_l_128, tier, dev)
    assert captured["deform_im2col.deform_im2col"] == 20


# D1b (csrc/deform_col2im.cu), the backward of D1, at the same 12 site
# shapes in f32 (training runs f32), against autograd through D1's plain
# version: the three gradients within D1B_BOUND x max|plain| and the mean
# ratio within D1B_MEAN (the f32 tier's mean bound). grad_x is summed by
# atomic adds and the channel sums of grad_offset and grad_mask run in
# another order, so the kernel is not bitwise; offsets and masks read in
# (dy, dx) order, swapped, must break the bound.
D1B_BOUND = 1e-5
D1B_MEAN = 1e-5


def _col2im_case(side, k, dev, c=64, stride=1):
    x, offset, mask = _deform_case(side, k, torch.float32, dev, c=c)
    oh = (side + 2 * (k // 2) - k) // stride + 1
    offset, mask = offset[:, :oh, :oh].contiguous(), mask[:, :oh, :oh].contiguous()
    gen = torch.Generator(dev).manual_seed(7 * side + k)
    grad_cols = torch.randn((2 * oh * oh, k * k * c), generator=gen,
                            device=dev)
    return grad_cols, x, offset, mask


def _assert_grads_close(got, want, bound=D1B_BOUND, mean=D1B_MEAN):
    for name, g, w in zip(("grad_x", "grad_offset", "grad_mask"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        err = (g - w).abs().max().item()
        assert err <= bound * w.abs().max().item(), (name, err)
        rel = ((g - w).abs().mean() / w.abs().mean()).item()
        assert rel <= mean, (name, rel)


@pytest.mark.parametrize("side,k", DEFORM_SITES)
def test_deform_col2im_kernel_matches_plain(dev, side, k):
    args = _col2im_case(side, k, dev)
    before = deform_im2col.deform_col2im.launches
    got = deform_im2col.deform_col2im(*args, k, k, 1, k // 2)
    assert deform_im2col.deform_col2im.launches == before + 1
    want = deform_im2col.deform_col2im_plain(*args, k, k, 1, k // 2)
    _assert_grads_close(got, want)


def test_deform_col2im_swapped_offsets_break_the_bound(dev):
    g, x, offset, mask = _col2im_case(64, 3, dev)
    swapped = offset.reshape(2, 64, 64, 9, 2).flip(-1).reshape(offset.shape)
    got = deform_im2col.deform_col2im(g, x, swapped.contiguous(), mask, 3, 3,
                                      1, 1)
    want = deform_im2col.deform_col2im_plain(g, x, offset, mask, 3, 3, 1, 1)
    with pytest.raises(AssertionError):
        _assert_grads_close(got, want)


@pytest.mark.parametrize("c,stride", [(64, 2), (6, 1), (5, 2), (96, 1)])
def test_deform_col2im_takes_strides_and_odd_widths(dev, c, stride):
    """Stride 2, widths that take the scalar path (C % 4 != 0) and one
    whose group spans 32 lanes with a second pass (C = 96)."""
    args = _col2im_case(19, 3, dev, c=c, stride=stride)
    got = deform_im2col.deform_col2im(*args, 3, 3, stride, 1)
    want = deform_im2col.deform_col2im_plain(*args, 3, 3, stride, 1)
    _assert_grads_close(got, want)


def test_deform_col2im_refuses_bf16(dev):
    g, x, offset, mask = _col2im_case(32, 3, dev)
    with pytest.raises(TypeError, match="f32 only"):
        deform_im2col.deform_col2im(g, x.bfloat16(), offset, mask.bfloat16(),
                                    3, 3, 1, 1)


def test_deform_conv2d_differentiates_through_d1_and_d1b(dev):
    """ops/deform_conv.py on CUDA tensors that require grad: one D1 and one
    D1b launch, and the gradients of x, offset, mask and the weight those
    of the plain route (im2col replaced by the plain version)."""
    from birefnet_tpu_torch.ops import deform_conv

    _, x, offset, mask = _col2im_case(32, 3, dev)
    weight = torch.randn((16, 64, 3, 3), device=dev) * 0.05
    leaves = [t.clone().requires_grad_(True) for t in (x, offset, mask,
                                                       weight)]

    def grads():
        out = deform_conv.deform_conv2d(*leaves, padding=1)
        return torch.autograd.grad((out * out).sum(), leaves)

    d1_before = deform_im2col.deform_im2col.launches
    d1b_before = deform_im2col.deform_col2im.launches
    got = grads()
    assert deform_im2col.deform_im2col.launches == d1_before + 1
    assert deform_im2col.deform_col2im.launches == d1b_before + 1
    kernel_route = deform_conv.im2col
    deform_conv.im2col = deform_im2col.deform_im2col_plain
    try:
        want = grads()
    finally:
        deform_conv.im2col = kernel_route
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= D1B_BOUND * w.abs().max().item()


def _refusing_calls(dev):
    """(name, call) of every forward-only wrapper, called on tensors that
    require grad; the refusal comes before any check of their shapes."""
    t = torch.zeros(4, device=dev, requires_grad=True)
    p = {"weight": t, "bias": t}
    attn = {"qkv": p, "proj": p, "cached_bias": t}
    attn8 = {"qkv": dict(p, weight_q8=t), "proj": p, "cached_bias": t}
    mlp, mlp8 = {"fc1": p, "fc2": p}, {"fc1": dict(p, weight_q8=t), "fc2": p}
    ln = {"scale": t, "bias": t}
    return [
        ("K1", lambda: fused_block_attn.fused_window_block_attention(
            t, ln, attn, 12, 0, 1, None, 1, 1)),
        ("K1-int8", lambda: fused_block_attn.fused_window_block_attention(
            t, ln, attn8, 12, 0, 1, None, 1, 1)),
        ("K2", lambda: fused_mlp.fused_mlp_residual(t, ln, mlp)),
        ("K3", lambda: fused_mlp.fused_mlp_residual(t, ln, mlp8)),
        ("K3 codes", lambda: fused_mlp.fused_mlp_residual_int8_codes(
            t, t, t, mlp8)),
        ("K4", lambda: row_ln.layer_norm_rows(ln, t)),
        ("K5", lambda: tap_conv.tap_conv_same(t, t, t)),
        ("K6", lambda: flash_window_attn.flash_window_attention_qkv(t, t)),
        ("K7", lambda: flash_window_attn.flash_window_attention(t, t, t, t)),
        ("K8", lambda: flash_window_attn.flash_attention(t, t, t)),
        ("D1", lambda: deform_im2col.deform_im2col(t, t, t, 1, 1)),
        ("bf16 GEMM", lambda: bf16_gemm.bf16_gemm(t, p, "store")),
        ("f32 GEMM", lambda: f32_gemm.f32_gemm(t, p, "store")),
        ("int8 GEMM", lambda: int8_gemm.int8_gemm(t, t, dict(p, scale_q8=t),
                                                  "bf16")),
    ]


@pytest.mark.parametrize("index", range(14))
def test_forward_only_wrappers_refuse_gradients(dev, index):
    name, call = _refusing_calls(dev)[index]
    with pytest.raises(RuntimeError, match="computes no gradient"):
        call()


def test_train_step_on_the_card_runs_d1_and_d1b_only(dev):
    """One train step of swin_t at 64^2, batch 2, deformable: 20 D1 and 20
    D1b launches, no launch of any forward-only kernel; a finite loss."""
    import dataclasses

    from birefnet_tpu_torch import pipeline, train
    from birefnet_tpu_torch.configs import BiRefNetConfig, ComputeConfig

    cfg = dataclasses.replace(BiRefNetConfig.for_backbone("swin_v1_t"),
                              size=(64, 64))
    params = pparams.init_params(cfg, 0, device=dev)
    state = train.init_train_state(params, train.TrainConfig())
    step = train.make_train_step(cfg, ComputeConfig(), train.TrainConfig())
    counters = pipeline.kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((2, 64, 64, 3), generator=gen, device=dev)
    y = (torch.rand((2, 64, 64), generator=gen, device=dev) > 0.5).float()
    state, m = step(state, x, y)
    counts = {n: fn.launches for n, fn in counters.items() if fn.launches}
    assert counts == {"deform_im2col.deform_im2col": 20,
                      "deform_im2col.deform_col2im": 20}
    assert np.isfinite(float(m["loss"]))


# The key-tiled core (csrc/window_core.cuh core_tiled, window_core_f32.cuh
# core_f32_tiled): the shapes the first core does not take, in bf16 and
# f32. (kind, B_, heads, N, d): K7 with a dense mask over 24^2 windows
# (N = 576, rows that TMA takes) and with region ids over 17^2 windows; K8
# with a bias at N = 257, a padded head dim (d = 20, 3), d = 96 and d = 160
# (two output slices, q's columns streamed per stage); flash_attention
# causal at N = 1024 (d = 128) and 4096 (d = 64); K6 on a packed projection
# of head dim 20 (padded) and at N = 289. Then the edges of the wgmma
# design: causal N = 1000 (no multiple of the row block or a key tile), the
# narrowest column blocks (d = 8 and 24 at N = 300), and a dense mask over
# nW = 3 windows at B_ = 9 and N = 257 (the mask's period, its rows copied
# by the producer's lanes: 1,028 bytes, no TMA row).
TILED_CASES = [("dense", 8, 4, 576, 32), ("ids", 8, 2, 289, 32),
               ("bias", 8, 4, 257, 64), ("bias", 8, 4, 144, 20),
               ("bias", 6, 2, 100, 3), ("bias", 8, 4, 144, 96),
               ("bias", 4, 2, 144, 160), ("causal", 2, 8, 1024, 128),
               ("causal", 1, 8, 4096, 64), ("qkv", 8, 3, 49, 20),
               ("qkv", 8, 3, 289, 32), ("causal", 1, 2, 1000, 64),
               ("bias", 2, 2, 300, 8), ("bias", 2, 2, 300, 24),
               ("dense3", 9, 2, 257, 32)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,b_,heads,n,d", TILED_CASES)
def test_window_core_tiled_matches_plain(dev, kind, b_, heads, n, d, dtype):
    gen = torch.Generator(dev).manual_seed(n + d)
    fwa = flash_window_attn
    bias = _randn(gen, (heads, n, n), dev, 3.0)
    if kind == "qkv":
        wrapper = fwa.flash_window_attention_qkv
        qkv = _randn(gen, (b_, n, 3 * heads * d), dev, 1.0, dtype)
        args = (qkv, bias, None, heads)
        plain = fwa.flash_window_attention_qkv_plain
    else:
        q, k, v = (_randn(gen, (b_, heads, n, d), dev, 1.0, dtype)
                   for _ in range(3))
        if kind == "causal":
            wrapper, plain, args = (fwa.flash_attention,
                                    fwa.flash_attention_plain,
                                    (q, k, v, True))
        else:
            wrapper, plain = (fwa.flash_window_attention,
                              fwa.flash_window_attention_plain)
            mask = None
            if kind in ("dense", "dense3"):
                nw = 3 if kind == "dense3" else 2
                mask = torch.where(torch.rand((nw, n, n), generator=gen,
                                              device=dev) < 0.3, -100.0, 0.0)
            elif kind == "ids":
                mask = W.sw_msa_region_ids(34, 34, 17, 8, dev)
            args = (q, k, v, bias, mask)
    n0 = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == n0 + 1
    want = plain(*args)
    if dtype == torch.float32:
        _assert_close_f32(got, want)
        # Control: the plain version on TF32-rounded operands with the TF32
        # flags on must break the mean bound.
        ops = 1 if kind == "qkv" else 3  # qkv, or q, k and v
        rounded = [tf32.tf32_round(a) for a in args[:ops]] + list(args[ops:])
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = plain(*rounded)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        assert _f32_error(got, control)[1] > MEAN_BOUND_F32
    else:
        _assert_close(got, want, MEAN_BOUND_FWA)
