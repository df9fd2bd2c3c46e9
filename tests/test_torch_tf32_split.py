"""The three-product TF32 split that the f32 GEMM and the f32 window core
run on the card (birefnet_tpu_torch/ops/kernels/tf32.py), on the CPU.

- `tf32_split` bit for bit against a numpy reference of cvt.rna.tf32.f32:
  hi + lo == x, hi's 13 low bits zero, ties rounded away from zero.
- The kernels' arithmetic, emulated in PyTorch (three TF32 products per
  f32 product, the small ones first), against the JAX package's f32
  kernels in interpret mode, every dot at precision=HIGHEST: K2
  (`fused_mlp.py:166 _fused`) at a swin_t width and K7
  (`flash_window_attn.py:91 _flash_masked`), held to the f32 bar of the
  card's checks, max|emul - jax| <= 1e-4 max|jax| and mean|emul - jax| /
  mean|jax| <= 1e-5. One TF32 product (passes=1) must break the mean bar,
  or the bar could not tell the split from plain TF32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from birefnet_tpu.ops.pallas import flash_window_attn as jfwa
from birefnet_tpu.ops.pallas.fused_mlp import fused_mlp_residual as jax_mlp
from birefnet_tpu_torch import params as P
from birefnet_tpu_torch.ops.kernels import tf32

MAX_BAR, MEAN_BAR = 1e-4, 1e-5


def _rna_numpy(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on uint32 bits: the magnitude rounded to 10
    significand bits, ties away from zero (finite x)."""
    u = x.astype(np.float32).view(np.uint32)
    mag = u & np.uint32(0x7FFFFFFF)
    mag = (mag + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return (mag | (u & np.uint32(0x80000000))).view(np.float32)


def _values(rng) -> np.ndarray:
    normal = rng.normal(size=4096) * 10.0 ** rng.integers(-20, 20, 4096)
    # Ties: a significand whose 13 dropped bits are exactly 0x1000.
    ties = ((rng.integers(0x00800000, 0x7F000000, 512) & ~0x1FFF) | 0x1000)
    ties = np.concatenate([ties, ties | 0x80000000]).astype(np.uint32)
    subnormal = rng.integers(1, 0x007FFFFF, 512).astype(np.uint32)
    subnormal = np.concatenate([subnormal, subnormal | np.uint32(0x80000000)])
    large = rng.uniform(1e30, 3.3e38, 256) * rng.choice([-1, 1], 256)
    return np.concatenate([normal.astype(np.float32), ties.view(np.float32),
                           subnormal.view(np.float32), large.astype(np.float32),
                           np.array([0.0, -0.0, 1.0, -2.5], np.float32)])


def test_tf32_split_matches_numpy_bits():
    x = _values(np.random.default_rng(0))
    hi, lo = tf32.tf32_split(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    np.testing.assert_array_equal(hi.view(np.uint32), _rna_numpy(x).view(np.uint32))
    assert np.array_equal(hi + lo, x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    ties = (x.view(np.uint32) & np.uint32(0x1FFF)) == 0x1000
    assert ties.sum() >= 1024
    assert (np.abs(hi[ties]) > np.abs(x[ties])).all()
    assert np.array_equal(np.sign(hi[ties]), np.sign(x[ties]))
    assert np.isinf(tf32.tf32_round(torch.tensor([3.4028235e38])).item())


def test_split_weights_for_the_f32_gemm():
    """split_weight is [hi, w - hi]; split_tf32_weights adds it to the
    Swin blocks' f32 GEMM linears only (not to W8A8 ones)."""
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(12, 8))
                         .astype(np.float32))
    s = tf32.split_weight(w)
    hi, lo = tf32.tf32_split(w)
    assert s.shape == (2, 12, 8) and s.is_contiguous()
    assert torch.equal(s[0], hi) and torch.equal(s[1], lo)
    lin = {"weight": w, "bias": torch.zeros(12)}
    tree = {"blocks": [None], "stage": {
        "attn": {"qkv": dict(lin), "proj": dict(lin), "cached_bias": w},
        "mlp": {"fc1": dict(lin, weight_q8=w.to(torch.int8)),
                "fc2": dict(lin)},
        "head": {"weight": w}}}
    out = P.split_tf32_weights(tree)["stage"]
    assert torch.equal(out["attn"]["qkv"]["weight_tf32"], s)
    assert torch.equal(out["attn"]["proj"]["weight_tf32"], s)
    assert "weight_tf32" not in out["mlp"]["fc1"]
    assert torch.equal(out["mlp"]["fc2"]["weight_tf32"], s)
    assert "weight_tf32" not in out["head"]
    assert tf32.weight_split_of(out["attn"]["qkv"]) is out["attn"]["qkv"][
        "weight_tf32"]
    assert torch.equal(tf32.weight_split_of(lin), s)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _bar(got: torch.Tensor, want) -> tuple:
    want = np.asarray(want, np.float32)
    d = np.abs(got.numpy() - want)
    return (d.max() / np.abs(want).max(), d.mean() / np.abs(want).mean())


def _held(top, mean, passes):
    if passes == 3:
        assert top <= MAX_BAR and mean <= MEAN_BAR, (top, mean)
    else:
        assert mean > MEAN_BAR, mean


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "tf32_control"])
def test_mlp_split_against_pallas_f32(passes):
    """K2's two products (fc1, fc2 at C = 96, swin_t's stage 0) from TF32
    pieces against the JAX kernel's f32 branch."""
    rng = np.random.default_rng(96)
    c = 96
    x = _rand(rng, (2, 8, 8, c))
    norm2 = {"scale": 1 + 0.1 * _rand(rng, (c,)), "bias": 0.1 * _rand(rng, (c,))}
    mlp = {name: {"kernel": _rand(rng, (i, o), i ** -0.5), "bias": _rand(rng, (o,))}
           for name, i, o in (("fc1", c, 4 * c), ("fc2", 4 * c, c))}
    want = jax_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in norm2.items()},
                   {n: {k: jnp.asarray(v) for k, v in p.items()}
                    for n, p in mlp.items()}, interpret=True)
    tp = P.from_jax_params({"norm2": norm2, "mlp": mlp})
    got = tf32.mlp_residual_split(torch.from_numpy(x), tp["norm2"], tp["mlp"],
                                  passes)
    _held(*_bar(got, want), passes)


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "tf32_control"])
def test_window_core_split_against_pallas_f32(passes):
    """The f32 core's q s k^T and P v from TF32 pieces against K7 in f32:
    N = 49 (swin_t's windows), d = 32, a rel-pos bias and a 0 / -100
    mask over four windows."""
    rng = np.random.default_rng(49)
    b_, heads, n, d, nw = 8, 2, 49, 32, 4
    q, k, v = (_rand(rng, (b_, heads, n, d)) for _ in range(3))
    bias = _rand(rng, (heads, n, n), 3.0)
    mask = np.where(rng.uniform(size=(nw, n, n)) < 0.3, -100.0, 0.0).astype(
        np.float32)
    want = jfwa.flash_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias, mask)), interpret=True)
    addend = (torch.from_numpy(bias)[None]
              + torch.from_numpy(mask).repeat(b_ // nw, 1, 1)[:, None])
    got = tf32.window_attention_split(
        *(torch.from_numpy(a) for a in (q, k, v)), addend, passes)
    _held(*_bar(got, want), passes)
