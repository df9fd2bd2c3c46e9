"""The swin_b backbone's widths on the CPU: the port's plain versions of
the kernels at swin_b's shapes (C = 128 * 2^k, 4-32 heads of 32, ws = 12)
against the JAX package's Pallas kernels in interpret mode, and one whole
swin_b model against the JAX package on the same random checkpoint. (swin_s
runs swin_t's widths, which the other test files hold.)

Inputs come from numpy seeds. The wrappers take the plain version for a
CPU tensor, so each test also checks that a CPU call launches nothing.

Tolerances, and why:
- f32 (K1, K2, K4): atol 2e-5 / rtol 1e-4, sums in other orders.
- K1 in bf16: the TPU kernel packs head groups and rounds exp(s - m) to
  bf16 before P v, the port's plain version rounds its qkv and proj
  products to bf16 before their biases: max |diff| within two bf16 ulps of
  the largest output (2^-6 max|y|), mean |diff| / mean |y| <= 3e-3 (the
  bounds of tests/test_torch_bf16_gemm.py).
- K2 in bf16: one bf16 ulp of the largest output, at most 1% of the outputs
  differing, with the interpret-mode reciprocal of the JAX kernel's 3-term
  erf reproduced (`interpret_reciprocal`).
- K1-int8 and K3 (f32 activations): a LayerNorm sum in another order can
  flip one int8 code by a step: max |diff| <= 2e-2, mean <= 1e-4 (the
  bounds of tests/test_torch_int8.py); K3 in bf16 adds one bf16 ulp of
  the output to the max and takes a mean of 1e-3.
- The whole model, f32, 64^2, batch 1, the default deformable mode: the
  logits within 5e-5 of the JAX package's, the bound that holds Swin-L's
  deformable logits to the JAX golden; the port's kernel tier (its plain
  versions on the CPU) against the same JAX logits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import birefnet_tpu as bt
from birefnet_tpu import params as jparams
from birefnet_tpu.ops.pallas.fused_block_attn import (
    fused_window_block_attention as jax_fused_block)
from birefnet_tpu.ops.pallas.fused_mlp import fused_mlp_residual as jax_mlp
from birefnet_tpu.ops.pallas.row_ln import layer_norm_rows as jax_row_ln
import birefnet_tpu_torch as pt
from birefnet_tpu_torch.models import birefnet as pbirefnet
from birefnet_tpu_torch.models import swin as pswin
from birefnet_tpu_torch.ops import quant
from birefnet_tpu_torch.ops import window as W
from birefnet_tpu_torch.ops.kernels import fused_block_attn, fused_mlp, row_ln
from birefnet_tpu_torch.params import cast_matmul_weights, from_jax_params

TOL = dict(atol=2e-5, rtol=1e-4)
ULP = 2.0 ** -7  # one bf16 ulp is at most this fraction of the value
MAX_STEPS, MEAN_STEPS = 2e-2, 1e-4
LOGITS_BOUND = 5e-5
WS, SHIFT = 12, 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch CPU work, restored
    after it: the suite runs in several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret_reciprocal(monkeypatch):
    """The port's 3-term erf with the reciprocal the JAX kernel gets in
    interpret mode on the CPU: f32 1/x of x rounded to bf16."""

    def erf3(z):
        a = z.abs()
        t = 1.0 / (1.0 + 0.47047 * a).bfloat16().float()
        poly = t * (0.3480242 + t * (-0.0958798 + t * 0.7478556))
        e = 1.0 - poly * torch.exp(-a * a)
        return torch.where(z < 0, -e, e)

    monkeypatch.setattr(quant, "erf3", erf3)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _ln(rng, c):
    return {"scale": 1 + 0.1 * _rand(rng, (c,)), "bias": 0.1 * _rand(rng, (c,))}


def _lin(rng, i, o):
    return {"kernel": _rand(rng, (i, o), 0.05), "bias": _rand(rng, (o,))}


def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _canvas(rng, c, dtype):
    """One shifted 24 x 24 canvas of a 24 x 24 image (batch 1, rolled)."""
    x = torch.from_numpy(_rand(rng, (1, 24, 24, c))).to(dtype)
    canvas, k_shift, mask, origin = pswin.fused_block_canvas(
        x, WS, SHIFT, W.sw_msa_mask(24, 24, WS, SHIFT))
    assert k_shift == SHIFT and origin == 0
    return canvas, mask


def _unroll(y):
    return np.roll(np.asarray(y, np.float32), (SHIFT, SHIFT), axis=(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,c", [(4, 128), (16, 512)])
def test_fused_block_attn_plain_matches_pallas(heads, c, dtype):
    """K1 at swin_b's stage 0 (4 heads, C = 128) and stage 2 (16 heads,
    C = 512)."""
    rng = np.random.default_rng(heads + c)
    p = {"norm1": _ln(rng, c),
         "attn": {"qkv": _lin(rng, c, 3 * c), "proj": _lin(rng, c, c),
                  "cached_bias": _rand(rng, (heads, 144, 144))}}
    canvas, mask = _canvas(rng, c, dtype)
    jattn = _jnp(p["attn"])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for name in ("qkv", "proj"):
        jattn[name]["kernel"] = jattn[name]["kernel"].astype(jdt)
    want = _unroll(jax_fused_block(
        jnp.asarray(canvas.float().numpy(), jdt), _jnp(p["norm1"]), jattn,
        WS, SHIFT, heads, jnp.asarray(mask.numpy()), 24, 24, residual=True,
        interpret=True).astype(jnp.float32))
    tp = from_jax_params(p)
    n0 = fused_block_attn.fused_window_block_attention.launches
    got = fused_block_attn.fused_window_block_attention(
        canvas, tp["norm1"], cast_matmul_weights(tp["attn"], dtype), WS,
        SHIFT, heads, mask, 24, 24)
    assert fused_block_attn.fused_window_block_attention.launches == n0
    assert got.dtype == dtype
    got = W.roll_2d(got, SHIFT, SHIFT).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        d = np.abs(got - want)
        assert d.max() <= 2 * ULP * np.abs(want).max(), d.max()
        assert d.mean() / np.abs(want).mean() <= 3e-3, d.mean()


def test_fused_block_attn_int8_plain_matches_pallas():
    """K1-int8 at swin_b's stage 3: 32 heads, C = 1024, W8A8 qkv and
    proj (f32 activations)."""
    rng = np.random.default_rng(1024)
    heads, c = 32, 1024
    norm1 = _ln(rng, c)
    attn = jparams.quantize_attn_int8(
        {"b": {"attn": _jnp({"qkv": _lin(rng, c, 3 * c),
                             "proj": _lin(rng, c, c),
                             "cached_bias": _rand(rng, (heads, 144, 144))})}},
        c)["b"]["attn"]
    canvas, mask = _canvas(rng, c, torch.float32)
    want = _unroll(jax_fused_block(
        jnp.asarray(canvas.numpy()), _jnp(norm1), attn, WS, SHIFT, heads,
        jnp.asarray(mask.numpy()), 24, 24, residual=True, interpret=True))
    tp = pt.from_jax_params({"norm1": norm1, "attn": attn})
    counts = (fused_block_attn.fused_window_block_attention_int8.launches,
              fused_block_attn.fused_window_block_attention.launches)
    got = fused_block_attn.fused_window_block_attention(
        canvas, tp["norm1"], tp["attn"], WS, SHIFT, heads, mask, 24, 24)
    assert counts == (fused_block_attn.fused_window_block_attention_int8.launches,
                      fused_block_attn.fused_window_block_attention.launches)
    d = np.abs(W.roll_2d(got, SHIFT, SHIFT).numpy() - want)
    assert d.max() <= MAX_STEPS and d.mean() <= MEAN_STEPS, (d.max(), d.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_int8_plain_matches_pallas(dtype, interpret_reciprocal):
    """K3 at swin_b's stage 3 (C = 1024) on 128 tokens."""
    c = 1024
    rng = np.random.default_rng(c + 1)
    x = _rand(rng, (2, 8, 8, c))
    norm2 = _ln(rng, c)
    mlp = jparams.quantize_mlp_int8(
        {"b": {"mlp": _jnp({"fc1": _lin(rng, c, 4 * c),
                            "fc2": _lin(rng, 4 * c, c)})}}, c)["b"]["mlp"]
    want = np.asarray(jax_mlp(jnp.asarray(x).astype(dtype), _jnp(norm2), mlp,
                              interpret=True).astype(jnp.float32))
    t = pt.from_jax_params({"norm2": norm2, "mlp": mlp})
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    n0 = fused_mlp.fused_mlp_residual_int8.launches
    got = fused_mlp.fused_mlp_residual(tx, t["norm2"], t["mlp"])
    assert fused_mlp.fused_mlp_residual_int8.launches == n0
    assert got.dtype == tx.dtype
    d = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert d.max() <= MAX_STEPS and d.mean() <= MEAN_STEPS
    else:  # plus one bf16 ulp of the output (values below 8)
        assert d.max() <= MAX_STEPS + 2 ** -5 and d.mean() <= 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_plain_matches_pallas(dtype, interpret_reciprocal):
    """K2 at swin_b's stage 0 (C = 128)."""
    c = 128
    rng = np.random.default_rng(c)
    x = _rand(rng, (2, 8, 8, c))
    norm2, mlp = _ln(rng, c), {"fc1": _lin(rng, c, 4 * c),
                               "fc2": _lin(rng, 4 * c, c)}
    jdt = jnp.dtype(dtype)
    jmlp = _jnp(mlp)
    for name in ("fc1", "fc2"):
        jmlp[name]["kernel"] = jmlp[name]["kernel"].astype(jdt)
    want = np.asarray(jax_mlp(jnp.asarray(x, jdt), _jnp(norm2), jmlp,
                              interpret=True).astype(jnp.float32))
    t = from_jax_params({"norm2": norm2, "mlp": mlp})
    tdt = getattr(torch, dtype)
    n0 = fused_mlp.fused_mlp_residual.launches
    got = fused_mlp.fused_mlp_residual(torch.from_numpy(x).to(tdt),
                                       t["norm2"],
                                       cast_matmul_weights(t["mlp"], tdt))
    assert fused_mlp.fused_mlp_residual.launches == n0
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        d = np.abs(got.float().numpy() - want)
        assert d.max() <= ULP * np.abs(want).max(), d.max()
        assert (d > 0).mean() <= 1e-2, (d > 0).mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", [(392, 128), (24, 2048)])
def test_row_ln_plain_matches_pallas(n, c, dtype):
    """K4 at swin_b's narrowest and widest rows: the patch-embed and stage
    0 norms (128) and the last patch merge (2048)."""
    rng = np.random.default_rng(n + c)
    x = _rand(rng, (n, c), 3.0)
    jx = jnp.asarray(x).astype(dtype)
    p = {"scale": _rand(rng, (c,)), "bias": _rand(rng, (c,))}
    want = np.asarray(jax_row_ln(_jnp(p), jx, interpret=True).astype(
        jnp.float32))
    n0 = row_ln.layer_norm_rows.launches
    got = row_ln.layer_norm_rows(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
            getattr(torch, dtype)))
    assert row_ln.layer_norm_rows.launches == n0
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:  # a LayerNorm sum in another order flips a rare bf16 rounding
        d = np.abs(got.float().numpy() - want)
        assert (d <= ULP * np.abs(want)).all(), d.max()
        assert (d > 0).mean() <= 1e-3, (d > 0).mean()


@pytest.fixture(scope="module")
def swin_b_64():
    """swin_b at 64^2 from one flat random checkpoint: the input, the JAX
    package's f32 logits (default compute: deformable, the deep stage's
    lax.scan), and the port's tree and config."""
    jcfg = dataclasses.replace(bt.BiRefNetConfig.for_backbone("swin_v1_b"),
                               size=(64, 64))
    pcfg = dataclasses.replace(pt.BiRefNetConfig.for_backbone("swin_v1_b"),
                               size=(64, 64))
    flat = bt.random_checkpoint(jcfg, 3)
    x = (np.random.default_rng(0).normal(size=(1, 64, 64, 3)) * 0.5).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: bt.birefnet.forward_logits(
        p, jcfg, x, bt.ComputeConfig()))(bt.build_param_tree(flat, jcfg),
                                         jnp.asarray(x)))
    return x, want, pt.build_param_tree(flat, pcfg), pcfg


@pytest.mark.parametrize("kernel_tier", [False, True])
def test_swin_b_model_matches_jax(swin_b_64, kernel_tier):
    """The whole swin_b BiRefNet (2, 2, 18, 2 blocks, both backbone
    passes, the deformable decoder) at 64^2, batch 1, f32."""
    x, want, tree, cfg = swin_b_64
    assert cfg.swin_config().embed_dim == 128 and cfg.x4_channels() == 3840
    with torch.inference_mode():
        got = pbirefnet.forward_logits(
            tree, cfg, torch.from_numpy(x),
            pt.ComputeConfig(use_flash_attention=kernel_tier))
    assert got.shape == want.shape == (1, 64, 64, 1)
    d = np.abs(got.numpy() - want).max()
    assert d <= LOGITS_BOUND, d
