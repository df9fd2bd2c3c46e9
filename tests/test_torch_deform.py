"""Faithful deformable sampling in the port against the JAX package (CPU).

The port's deform_conv2d (ops/deform_conv.py: the columns from
ops/kernels/deform_im2col.py's plain version, one matmul), the deformable
ASPP, the decoder block around it and the standalone DeformableConv2d
layer get the same numpy inputs, made from a seed, as their JAX
counterparts (birefnet_tpu/ops/deform_conv.py, models/aspp.py,
models/decoder.py; XLA, no Pallas kernel).

Tolerances:
- deform_conv2d in f32: max|port - jax| <= 1e-5 * max|jax|, for the
  columns and the output;
- in bf16: every column within one bf16 ulp of JAX's (the four corner
  products may be summed in another order), the output within one bf16
  ulp of max|jax|;
- the ASPP, the decoder block and the standalone layer in f32, offset
  convs scaled by OFFSET_SCALE so that offsets reach several pixels:
  max|port - jax| <= MODULE_BOUND * max|jax|. Offsets of several pixels
  carry the offset convs' f32 rounding (sums in another order than XLA's)
  into the samples: the ASPP read 6.0e-6, the block 5.7e-8.
Regular mode and a (dy, dx) swap must miss these bounds tenfold, so they
see the sampling (the ASPP in regular mode read 0.35, the block 8.7e-4).
JAX's columns come from its deform_conv2d with an identity weight beside
the real one: cols @ [I | W] computes the columns exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import birefnet_tpu as bt
from birefnet_tpu import params as jparams
from birefnet_tpu.models import aspp as jaspp
from birefnet_tpu.models import decoder as jdec
from birefnet_tpu.ops import deform_conv as jdeform
import birefnet_tpu_torch as pt
from birefnet_tpu_torch import params as pparams
from birefnet_tpu_torch.models import aspp as paspp
from birefnet_tpu_torch.models import decoder as pdec
from birefnet_tpu_torch.ops import deform_conv as pdeform
from birefnet_tpu_torch.ops import layers as L
from birefnet_tpu_torch.ops.kernels import deform_im2col as d1

F32_BOUND = 1e-5
MODULE_BOUND = 5e-5
# random weights at std 0.05 give offsets of a tenth of a pixel here;
# scaled, they reach several pixels (regular mode then misses by O(1)).
OFFSET_SCALE = 20.0
# The shapes of tests/test_ops.py::test_deform_conv_matches_torch.
SHAPES = [(1, 0, 1), (3, 1, 1), (7, 3, 1), (3, 1, 2)]
_jax_deform = jax.jit(jdeform.deform_conv2d,
                      static_argnames=("stride", "padding"))


def _case(k, pad, stride, seed=0):
    rng = np.random.default_rng(seed)
    b, h, w, cin, cout = 2, 9, 11, 6, 5
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    return dict(
        x=rng.normal(size=(b, h, w, cin)).astype(np.float32),
        offset=(rng.normal(size=(b, oh, ow, 2 * k * k)) * 2).astype(np.float32),
        mask=rng.uniform(0, 2, size=(b, oh, ow, k * k)).astype(np.float32),
        weight=rng.normal(size=(k, k, cin, cout)).astype(np.float32),
        bias=rng.normal(size=(cout,)).astype(np.float32))


def _jax_cols_and_out(c, k, pad, stride, dtype):
    """JAX's columns [B*P, K*C] and output [B, OH, OW, O] from one call:
    the weight [I | W] (the identity's f32 accumulation of one term is
    exact) and the bias [0 | bias]."""
    kc = k * k * c["x"].shape[-1]
    eye = np.eye(kc, dtype=np.float32).reshape(k, k, -1, kc)
    wcat = np.concatenate([eye, c["weight"]], axis=-1)
    bcat = np.concatenate([np.zeros(kc, np.float32), c["bias"]])
    y = np.asarray(_jax_deform(
        jnp.asarray(c["x"], dtype), jnp.asarray(c["offset"]),
        jnp.asarray(c["mask"], dtype), jnp.asarray(wcat, dtype),
        jnp.asarray(bcat), stride=stride, padding=pad).astype(jnp.float32))
    return y[..., :kc].reshape(-1, kc), y[..., kc:]


def _port(c, k, pad, stride, dtype, offset=None):
    x = torch.from_numpy(c["x"]).to(dtype)
    off = torch.from_numpy(c["offset"] if offset is None else offset)
    mask = torch.from_numpy(c["mask"]).to(dtype)
    weight = torch.from_numpy(c["weight"]).permute(3, 2, 0, 1).to(dtype)
    cols = d1.deform_im2col(x, off, mask, k, k, stride, pad)
    out = pdeform.deform_conv2d(x, off, mask, weight,
                                torch.from_numpy(c["bias"]), stride=stride,
                                padding=pad)
    return cols.float().numpy(), out.float().numpy()


def _bf16_ulp(a):
    """One bf16 ulp at each |a| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,pad,stride", SHAPES)
def test_deform_conv2d_matches_jax(k, pad, stride, dtype):
    c = _case(k, pad, stride)
    jcols, jout = _jax_cols_and_out(c, k, pad, stride, getattr(jnp, dtype))
    before = d1.deform_im2col.launches
    cols, out = _port(c, k, pad, stride, getattr(torch, dtype))
    assert d1.deform_im2col.launches == before  # CPU: the plain version
    assert cols.shape == jcols.shape and out.shape == jout.shape
    if dtype == "float32":
        assert np.abs(cols - jcols).max() <= F32_BOUND * np.abs(jcols).max()
        assert np.abs(out - jout).max() <= F32_BOUND * np.abs(jout).max()
    else:
        assert (np.abs(cols - jcols) <= _bf16_ulp(jcols)).all()
        assert np.abs(out - jout).max() <= _bf16_ulp(np.abs(jout).max())


@pytest.mark.parametrize("k,pad", [(1, 0), (3, 1), (7, 3)])
def test_zero_offsets_and_unit_mask_give_the_regular_conv(k, pad):
    c = _case(k, pad, 1)
    x = torch.from_numpy(c["x"])
    conv = {"weight": torch.from_numpy(c["weight"]).permute(3, 2, 0, 1),
            "bias": torch.from_numpy(c["bias"])}
    want = L.conv2d(conv, x, padding=pad)
    b, oh, ow, kk = c["mask"].shape
    got = pdeform.deform_conv2d(x, torch.zeros(b, oh, ow, 2 * kk),
                                torch.ones(b, oh, ow, kk), conv["weight"],
                                conv["bias"], padding=pad)
    assert float((got - want).abs().max()) <= F32_BOUND * float(
        want.abs().max())


def test_swapped_offset_channels_break_the_bound():
    """Control: (dx, dy) in place of (dy, dx) misses JAX's output."""
    k, pad, stride = 3, 1, 1
    c = _case(k, pad, stride)
    _, jout = _jax_cols_and_out(c, k, pad, stride, jnp.float32)
    off = c["offset"]
    swapped = off.reshape(*off.shape[:-1], -1, 2)[..., ::-1].reshape(off.shape)
    _, out = _port(c, k, pad, stride, torch.float32,
                   np.ascontiguousarray(swapped))
    assert np.abs(out - jout).max() > 10 * F32_BOUND * np.abs(jout).max()


def test_dispatcher_takes_the_plain_version_on_the_cpu_only():
    c = _case(3, 1, 1)
    args = (torch.from_numpy(c["x"]), torch.from_numpy(c["offset"]),
            torch.from_numpy(c["mask"]), 3, 3, 1, 1)
    assert torch.equal(d1.deform_im2col(*args), d1.deform_im2col_plain(*args))
    with pytest.raises(ValueError, match="cpu or cuda"):
        d1.deform_im2col(*(a.to("meta") if torch.is_tensor(a) else a
                           for a in args))


# ---- the decoder block and its deformable ASPP, offset convs scaled ----

def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def dec_block():
    """decoder_block1's schema at a narrow input (32 -> 32 channels; the
    ASPP runs at the fixed inter width 64), weights at std 0.05 from seed
    12, offset convs scaled by OFFSET_SCALE. Returns the flat dict, the
    JAX tree and the port tree."""
    name = "decoder.decoder_block1"
    rng = np.random.default_rng(12)
    flat = {k: rng.normal(0.0, 0.05, s).astype(np.float32)
            for k, s in jparams._basic_dec_blk_entries(name, 32, 32)}
    for k in flat:
        if k.endswith("running_var"):
            flat[k] = np.abs(flat[k]) + 0.5
        if ".offset_conv." in k:
            flat[k] = flat[k] * OFFSET_SCALE
    return (flat, _jnp(jparams._basic_dec_blk(jparams._Source(flat), name)),
            pparams._basic_dec_blk(pparams._Source(flat), name))


def _aspp_input(seed=1):
    return np.maximum(np.random.default_rng(seed).normal(
        size=(2, 12, 12, 64)), 0).astype(np.float32)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_deformable_aspp_matches_jax(dec_block):
    _, jp, tp = dec_block
    x = _aspp_input()
    want = np.asarray(jax.jit(lambda p, x: jaspp.aspp_deformable_forward(
        p, x, bt.ComputeConfig(deform_mode="deformable")))(
            jp["dec_att"], jnp.asarray(x)))
    with torch.inference_mode():
        got = paspp.aspp_deformable_forward(tp["dec_att"], torch.from_numpy(x),
                                            pt.ComputeConfig()).numpy()
        regular = paspp.aspp_deformable_forward(
            tp["dec_att"], torch.from_numpy(x),
            pt.ComputeConfig(deform_mode="regular")).numpy()
    assert _max_rel(got, want) <= MODULE_BOUND
    assert _max_rel(regular, want) > 10 * MODULE_BOUND


def test_basic_dec_blk_deformable_matches_jax(dec_block):
    _, jp, tp = dec_block
    x = (np.random.default_rng(2).normal(size=(1, 16, 16, 32)) * 0.5).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: jdec.basic_dec_blk_forward(
        p, x, bt.ComputeConfig(deform_mode="deformable")))(jp, jnp.asarray(x)))
    with torch.inference_mode():
        got = pdec.basic_dec_blk_forward(tp, torch.from_numpy(x),
                                         pt.ComputeConfig()).numpy()
        regular = pdec.basic_dec_blk_forward(
            tp, torch.from_numpy(x), pt.ComputeConfig(deform_mode="regular"))
    assert got.shape == (1, 16, 16, 32)
    assert _max_rel(got, want) <= MODULE_BOUND
    assert _max_rel(regular.numpy(), want) > 10 * MODULE_BOUND


def test_from_jax_params_carries_the_offset_and_modulator_convs(dec_block):
    """The JAX tree converted by from_jax_params runs the port's deformable
    ASPP to the outputs of the tree built from the flat checkpoint."""
    _, jp, tp = dec_block
    carried = pt.from_jax_params(jax.tree_util.tree_map(np.array, jp))
    for key in ("offset_conv", "modulator_conv", "regular_conv"):
        a = carried["dec_att"]["aspp_deforms_2"]["atrous_conv"][key]
        b = tp["dec_att"]["aspp_deforms_2"]["atrous_conv"][key]
        assert torch.equal(a["weight"], b["weight"])
        assert ("bias" in a) == ("bias" in b) == (key != "regular_conv")
    x = torch.from_numpy(_aspp_input(3))
    with torch.inference_mode():
        got = paspp.aspp_deformable_forward(carried["dec_att"], x,
                                            pt.ComputeConfig())
        want = paspp.aspp_deformable_forward(tp["dec_att"], x,
                                             pt.ComputeConfig())
    assert _max_rel(got.numpy(), want.numpy()) <= F32_BOUND


def test_deformable_conv2d_forward_with_stride_matches_jax(dec_block):
    """The standalone layer: stride 2, a k=3 regular conv with a bias."""
    _, jp, tp = dec_block
    rng = np.random.default_rng(5)
    jlayer = dict(jp["dec_att"]["aspp_deforms_1"]["atrous_conv"])
    bias = rng.normal(size=(256,)).astype(np.float32)
    jlayer["regular_conv"] = {"kernel": jlayer["regular_conv"]["kernel"],
                              "bias": jnp.asarray(bias)}
    player = pt.from_jax_params(jax.tree_util.tree_map(np.array, jlayer))
    x = _aspp_input(4)
    want = np.asarray(jax.jit(lambda p, x: jaspp.deformable_conv2d_forward(
        p, x, 3, stride=2, padding=1,
        compute=bt.ComputeConfig(deform_mode="deformable")))(
            jlayer, jnp.asarray(x)))
    with torch.inference_mode():
        got = paspp.deformable_conv2d_forward(player, torch.from_numpy(x), 3,
                                              stride=2, padding=1).numpy()
    assert got.shape == want.shape == (2, 6, 6, 256)
    assert _max_rel(got, want) <= MODULE_BOUND
