"""birefnet_tpu_torch modules against the JAX package on the CPU (f32).

Same weights (one flat torch-schema dict loaded by both packages) and the
same numpy inputs go through each JAX function and its port. Tolerances:
atol 2e-5 / rtol 1e-4 for the backbone (the port's convolutions and
matmuls sum in other orders than XLA's); atol 1e-4 / rtol 1e-3 where a
5760-channel convolution accumulates (the bound tests/test_model_parity.py
uses against the torch oracle).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import birefnet_tpu as bt
from birefnet_tpu import params as jparams
from birefnet_tpu import pipeline as jpipeline
from birefnet_tpu.models import aspp as jaspp
from birefnet_tpu.models import decoder as jdec
from birefnet_tpu.models import swin as jswin
import birefnet_tpu_torch as pt
from birefnet_tpu_torch import params as pparams
from birefnet_tpu_torch import pipeline as ppipeline
from birefnet_tpu_torch.models import aspp as paspp
from birefnet_tpu_torch.models import decoder as pdec
from birefnet_tpu_torch.models import swin as pswin
from birefnet_tpu_torch.ops import resize as presize

NARROW = dict(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))


def _flat(entries, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0.0, 0.05, s).astype(np.float32) for k, s in entries}


def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def narrow_swin():
    jcfg, pcfg = bt.SwinConfig(**NARROW), pt.SwinConfig(**NARROW)
    flat = _flat(jparams._swin_entries("bb", jcfg), 11)
    return (jcfg, _jnp(jparams._swin(jparams._Source(flat), "bb", jcfg)),
            pcfg, pparams._swin(pparams._Source(flat), "bb", pcfg))


@pytest.fixture(scope="module")
def swin_input_and_jax_features(narrow_swin):
    jcfg, jp, _, _ = narrow_swin
    x = (np.random.default_rng(0).normal(size=(2, 96, 96, 3)) * 0.5).astype(
        np.float32)
    fwd = jax.jit(lambda p, x: jswin.swin_forward(
        p, jcfg, x, bt.ComputeConfig(use_flash_attention=False)))
    return x, [np.asarray(f) for f in fwd(jp, jnp.asarray(x))]


@pytest.mark.parametrize("kernel_tier", [False, True])
def test_swin_forward_matches_jax(narrow_swin, swin_input_and_jax_features,
                                  kernel_tier):
    _, _, pcfg, tp = narrow_swin
    x, want = swin_input_and_jax_features
    got = pswin.swin_forward(tp, pcfg, torch.from_numpy(x),
                             pt.ComputeConfig(use_flash_attention=kernel_tier))
    assert [tuple(g.shape) for g in got] == [(2, 24, 24, 64), (2, 12, 12, 128),
                                             (2, 6, 6, 256), (2, 3, 3, 512)]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5,
                                   rtol=1e-4, err_msg=f"stage {i}")


@pytest.fixture(scope="module")
def narrow_ws7():
    """The narrow Swin with window 7 (the middle tier's geometry) at 128^2,
    batch 2, and the JAX middle tier's features."""
    jcfg = bt.SwinConfig(window_size=7, **NARROW)
    pcfg = pt.SwinConfig(window_size=7, **NARROW)
    flat = _flat(jparams._swin_entries("bb", jcfg), 13)
    jp = _jnp(jparams._swin(jparams._Source(flat), "bb", jcfg))
    x = (np.random.default_rng(6).normal(size=(2, 128, 128, 3)) * 0.5).astype(
        np.float32)
    want = jax.jit(lambda p, x: jswin.swin_forward(
        p, jcfg, x, bt.ComputeConfig(use_flash_attention=True)))(
            jp, jnp.asarray(x))
    return pcfg, pparams._swin(pparams._Source(flat), "bb", pcfg), x, [
        np.asarray(f) for f in want]


@pytest.mark.parametrize("int8_attn", [False, True])
def test_swin_middle_tier_matches_jax(narrow_ws7, monkeypatch, int8_attn):
    """ws=7 on the kernel tier: the port's middle tier (K6 and K2 through
    their plain versions) against the JAX middle tier (its Pallas kernels
    in interpret mode), f32. With the attention weights quantized and
    int8_attn on, nothing changes: the middle tier's qkv and proj products
    read the `weight` leaves, as JAX's L.linear reads `kernel`."""
    from birefnet_tpu_torch.ops.kernels import flash_window_attn, fused_mlp

    pcfg, tp, x, want = narrow_ws7
    calls = {"k6": 0, "k2": 0}

    def counted(key, fn):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(flash_window_attn, "flash_window_attention_qkv_plain",
                        counted("k6", flash_window_attn
                                .flash_window_attention_qkv_plain))
    monkeypatch.setattr(fused_mlp, "fused_mlp_residual_plain", counted(
        "k2", fused_mlp.fused_mlp_residual_plain))
    compute = pt.ComputeConfig(use_flash_attention=True, int8_attn=int8_attn)
    tree = pparams.quantize_attn_int8(tp, 64) if int8_attn else tp
    with torch.inference_mode():
        got = pswin.swin_forward(tree, pcfg, torch.from_numpy(x), compute)
    assert calls == {"k6": 8, "k2": 8}
    assert [tuple(g.shape) for g in got] == [(2, 32, 32, 64), (2, 16, 16, 128),
                                             (2, 8, 8, 256), (2, 4, 4, 512)]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=1e-4,
                                   err_msg=f"stage {i}")
    if int8_attn:
        with torch.inference_mode():
            ref = pswin.swin_forward(tp, pcfg, torch.from_numpy(x), compute)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.fixture(scope="module")
def squeeze_block():
    cfg = bt.BiRefNetConfig.swin_l()
    name = "squeeze_module.0"
    flat = _flat(jparams._basic_dec_blk_entries(
        name, cfg.x4_channels(), cfg.lateral_channels()[3]), 12)
    for k in flat:
        if k.endswith("running_var"):
            flat[k] = np.abs(flat[k]) + 0.5
    return (_jnp(jparams._basic_dec_blk(jparams._Source(flat), name)),
            pparams._basic_dec_blk(pparams._Source(flat), name))


def test_aspp_regular_matches_jax(squeeze_block):
    jp, tp = squeeze_block
    x = np.random.default_rng(1).normal(size=(1, 8, 8, 64)).astype(np.float32)
    want = jaspp.aspp_deformable_forward(
        jp["dec_att"], jnp.asarray(x), bt.ComputeConfig(deform_mode="regular"))
    got = paspp.aspp_deformable_forward(tp["dec_att"], torch.from_numpy(x),
                                        pt.ComputeConfig(deform_mode="regular"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)


def test_basic_dec_blk_matches_jax(squeeze_block):
    jp, tp = squeeze_block
    x = (np.random.default_rng(2).normal(size=(1, 4, 4, 5760)) * 0.1).astype(
        np.float32)
    want = jdec.basic_dec_blk_forward(jp, jnp.asarray(x),
                                      bt.ComputeConfig(deform_mode="regular"))
    got = pdec.basic_dec_blk_forward(tp, torch.from_numpy(x),
                                     pt.ComputeConfig(deform_mode="regular"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)


def test_image2patches_matches_jax():
    x = np.random.default_rng(3).normal(size=(1, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        pdec.image2patches(torch.from_numpy(x), 8, 8).numpy(),
        np.asarray(jdec.image2patches(jnp.asarray(x), 8, 8)))


def test_preprocess_matches_jax():
    frames = np.random.default_rng(4).integers(0, 256, (2, 50, 70, 3),
                                               dtype=np.uint8)
    want = jpipeline.preprocess(jnp.asarray(frames), (64, 64))
    got = ppipeline.preprocess(torch.from_numpy(frames), (64, 64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_postprocess_matches_jax():
    mask = np.random.default_rng(5).uniform(size=(2, 64, 64, 1)).astype(
        np.float32)
    for as_uint8 in (False, True):
        want = np.asarray(jpipeline.postprocess(jnp.asarray(mask), 50, 70,
                                                as_uint8=as_uint8))
        got = ppipeline.postprocess(torch.from_numpy(mask), 50, 70,
                                    as_uint8=as_uint8).numpy()
        assert got.shape == want.shape == (2, 50, 70)
        assert got.dtype == want.dtype
        # uint8: a value on a .5 rounding boundary may land one step apart.
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32),
                                   atol=1.0 if as_uint8 else 1e-5)


@pytest.mark.parametrize("src,dst", [(64, 32), (32, 64), (17, 5)])
def test_resize_matrices_match_jax(src, dst):
    from birefnet_tpu.ops import resize as jresize
    np.testing.assert_array_equal(presize._align_corners_matrix(src, dst),
                                  jresize._align_corners_matrix(src, dst))
    np.testing.assert_array_equal(presize._lanczos3_matrix(src, dst),
                                  jresize._lanczos3_matrix(src, dst))
