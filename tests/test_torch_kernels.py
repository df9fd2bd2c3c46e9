"""birefnet_tpu_torch kernel modules on the CPU: each kernel's plain
PyTorch version against the JAX package's Pallas kernel in interpret mode,
on the same f32 inputs made by numpy from a seed.

The wrappers take the plain version for a CPU tensor, so these tests also
check that a CPU call launches nothing. The CUDA kernels themselves are
checked against the same plain versions on the card (test_torch_cuda.py).
Tolerance: atol 2e-5, rtol 1e-4 (f32, sums in other orders). One test
runs bf16: the kernel tier takes the rel-pos bias rounded to bf16, as the
JAX kernels do, so a bias and its bf16 rounding give bitwise the same
output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from birefnet_tpu.ops import window as jwindow
from birefnet_tpu.ops.pallas.fused_block_attn import (
    fused_window_block_attention as jax_fused_block)
from birefnet_tpu.ops.pallas.fused_mlp import fused_mlp_residual as jax_mlp
from birefnet_tpu.ops.pallas.row_ln import layer_norm_rows as jax_row_ln
from birefnet_tpu.ops.pallas.tap_conv import tap_conv_same as jax_tap_conv
from birefnet_tpu_torch.models import swin
from birefnet_tpu_torch.ops import window as W
from birefnet_tpu_torch.ops.kernels import (flash_window_attn, fused_block_attn,
                                            fused_mlp, row_ln, tap_conv)
from birefnet_tpu_torch.params import (cast_matmul_weights, from_jax_params,
                                       quantize_attn_int8)

TOL = dict(atol=2e-5, rtol=1e-4)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _ln(rng, c):
    return {"scale": 1 + 0.1 * _rand(rng, (c,)), "bias": 0.1 * _rand(rng, (c,))}


def _lin(rng, i, o):
    return {"kernel": _rand(rng, (i, o), 0.05), "bias": _rand(rng, (o,))}


def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("shift", [0, 6])
# exact grid, padded with the cyclic roll, padded with the offset partition
@pytest.mark.parametrize("hw", [(24, 24), (20, 17), (16, 16)])
@pytest.mark.parametrize("heads,c", [(2, 64), (6, 192)])
def test_fused_block_attn_plain_matches_pallas(shift, hw, heads, c):
    rng = np.random.default_rng(10 + shift + hw[1] + c)
    h, w = hw
    ws = 12
    p = {"norm1": _ln(rng, c),
         "attn": {"qkv": _lin(rng, c, 3 * c), "proj": _lin(rng, c, c),
                  "cached_bias": _rand(rng, (heads, 144, 144))}}
    x = _rand(rng, (2, h, w, c))
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    cyclic = W.sw_msa_mask(hp, wp, ws, ws // 2)
    canvas, k_shift, mask, origin = swin.fused_block_canvas(
        torch.from_numpy(x), ws, shift, cyclic)
    want = np.asarray(jax_fused_block(
        jnp.asarray(canvas.numpy()), _jnp(p["norm1"]), _jnp(p["attn"]), ws,
        k_shift, heads, None if mask is None else jnp.asarray(mask.numpy()),
        h, w, residual=True, interpret=True, origin=origin))
    tp = from_jax_params(p)
    n0 = fused_block_attn.fused_window_block_attention.launches
    got = fused_block_attn.fused_window_block_attention(
        canvas, tp["norm1"], tp["attn"], ws, k_shift, heads, mask, h, w,
        origin=origin)
    assert fused_block_attn.fused_window_block_attention.launches == n0
    real = (slice(None), slice(origin, origin + h), slice(origin, origin + w))
    if k_shift:
        got = W.roll_2d(got, k_shift, k_shift)
        want = np.roll(want, (k_shift, k_shift), axis=(1, 2))
    np.testing.assert_allclose(got.numpy()[real], want[real], **TOL)


@pytest.mark.parametrize("c", [64, 96, 192])
def test_fused_mlp_plain_matches_pallas(c):
    rng = np.random.default_rng(c)
    x = _rand(rng, (2, 8, 8, c))
    norm2, mlp = _ln(rng, c), {"fc1": _lin(rng, c, 4 * c),
                               "fc2": _lin(rng, 4 * c, c)}
    want = np.asarray(jax_mlp(jnp.asarray(x), _jnp(norm2), _jnp(mlp),
                              interpret=True))
    t = from_jax_params({"norm2": norm2, "mlp": mlp})
    n0 = fused_mlp.fused_mlp_residual.launches
    got = fused_mlp.fused_mlp_residual(torch.from_numpy(x), t["norm2"],
                                       t["mlp"])
    assert fused_mlp.fused_mlp_residual.launches == n0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n,c", [(200, 192), (24, 3072), (1000, 768),
                                 (392, 96)])
def test_row_ln_plain_matches_pallas(n, c):
    rng = np.random.default_rng(n + c)
    x = _rand(rng, (n, c), 3.0)
    p = {"scale": _rand(rng, (c,)), "bias": _rand(rng, (c,))}
    want = np.asarray(jax_row_ln(_jnp(p), jnp.asarray(x), interpret=True))
    n0 = row_ln.layer_norm_rows.launches
    got = row_ln.layer_norm_rows({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x))
    assert row_ln.layer_norm_rows.launches == n0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tap_conv_plain_matches_pallas():
    rng = np.random.default_rng(3)
    x = _rand(rng, (2, 32, 40, 3))
    k = _rand(rng, (5, 5, 3, 1))
    b = _rand(rng, (1,))
    want = np.asarray(jax_tap_conv(jnp.asarray(x), jnp.asarray(k),
                                   jnp.asarray(b), interpret=True))
    n0 = tap_conv.tap_conv_same.launches
    got = tap_conv.tap_conv_same(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(b))
    assert tap_conv.tap_conv_same.launches == n0
    assert got.shape == (2, 32, 40)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("ws,hp,wp", [
    (12, 24, 24), (12, 36, 24), (12, 264, 264),
    (7, 35, 35), (7, 21, 28), (7, 259, 259)])
def test_sw_msa_masks_match_jax(ws, hp, wp):
    s = ws // 2
    np.testing.assert_array_equal(W.sw_msa_mask(hp, wp, ws, s).numpy(),
                                  jwindow.sw_msa_mask(hp, wp, ws, s))
    np.testing.assert_array_equal(W.sw_msa_mask_offset(hp, wp, ws, s).numpy(),
                                  jwindow.sw_msa_mask_offset(hp, wp, ws, s))
    np.testing.assert_array_equal(W.relative_position_index(ws),
                                  jwindow.relative_position_index(ws))


@pytest.mark.parametrize("kernel", ["fused_block_attn",
                                    "fused_block_attn_int8",
                                    "flash_window_attn_qkv"])
def test_kernel_tier_rounds_the_bias_to_bf16(kernel):
    """With bf16 activations the plain versions of K1, K1-int8 and K6 take
    the rel-pos bias rounded to bf16, as the JAX kernels do: a bias B and
    bf16(B) give bitwise the same output."""
    rng = np.random.default_rng(30)
    c, heads, ws = 64, 2, 12
    n = ws * ws
    bias = torch.from_numpy(_rand(rng, (heads, n, n), 3.0))
    rounded = bias.bfloat16().float()
    assert not torch.equal(bias, rounded)
    if kernel == "flash_window_attn_qkv":
        qkv = torch.from_numpy(_rand(rng, (4, n, 3 * c))).bfloat16()
        mask = W.sw_msa_mask(2 * ws, ws, ws, ws // 2)

        def run(b):
            return flash_window_attn.flash_window_attention_qkv(qkv, b, mask,
                                                                heads)
    else:
        attn = {"qkv": _lin(rng, c, 3 * c), "proj": _lin(rng, c, c)}
        attn = from_jax_params(attn)
        if kernel == "fused_block_attn_int8":
            attn = quantize_attn_int8({"attn": attn}, 0)["attn"]
        attn = cast_matmul_weights(attn, torch.bfloat16)
        norm1 = from_jax_params(_ln(rng, c))
        x = torch.from_numpy(_rand(rng, (2, 24, 24, c))).bfloat16()
        plain = getattr(fused_block_attn,
                        f"fused_window_block_attention"
                        f"{'_int8' if 'int8' in kernel else ''}_plain")

        def run(b):
            return plain(x, norm1, dict(attn, cached_bias=b), ws, 0, heads,
                         None, 24, 24)
    got, want = run(bias), run(rounded)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_wrappers_refuse_other_devices():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        row_ln.layer_norm_rows({"scale": x[0], "bias": x[0]}, x)
