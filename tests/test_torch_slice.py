"""The port's Swin-L slice as a whole on the CPU against the JAX goldens.

tests/goldens/*_jax.npy hold the JAX package's per-stage features and
logits for random_checkpoint(swin_l, seed 7) on a 64x64 input made from
seed 0 (tests/test_goldens.py), the logits in the JAX package's default
deform mode, deformable. The port runs the same checkpoint and input in
f32 with the kernel tier on, so every kernel wrapper's dispatch runs and
takes its plain version (CPU tensors), and with it off; the logits in
deformable mode too. Tolerances: stages atol 1e-4 / rtol 1e-3; logits
atol 5e-5 / rtol 1e-4, the JAX package's own golden bound (the port read
max|diff| 7.5e-8 in deformable mode; regular mode reads 3.8e-6, within
it too: the random offset convs give sub-pixel offsets at 64^2), and mask
MAE < 1e-5 (the f32 parity bar of PARITY.md).
"""

import os

import numpy as np
import pytest
import torch

import birefnet_tpu_torch as pt
from birefnet_tpu_torch import pipeline
from birefnet_tpu_torch.models import birefnet as bmodel
from birefnet_tpu_torch.models import swin
from birefnet_tpu_torch.ops.kernels import (fused_block_attn, fused_mlp,
                                            row_ln, tap_conv)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CFG = pt.BiRefNetConfig.swin_l()
WRAPPERS = (fused_block_attn.fused_window_block_attention,
            fused_mlp.fused_mlp_residual, row_ln.layer_norm_rows,
            tap_conv.tap_conv_same)


@pytest.fixture(scope="module")
def params():
    return pt.build_param_tree(pt.random_checkpoint(CFG, seed=7), CFG)


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(0)
    return torch.from_numpy((rng.normal(size=(1, 64, 64, 3)) * 0.5).astype(
        np.float32))


@pytest.mark.parametrize("kernel_tier", [True, False])
def test_stage_features_match_goldens(params, x, kernel_tier):
    with torch.inference_mode():
        feats = swin.swin_forward(
            params["bb"], CFG.swin_config(), x,
            pt.ComputeConfig(use_flash_attention=kernel_tier))
    for i, f in enumerate(feats):
        want = np.load(os.path.join(GOLDEN_DIR, f"stage{i + 1}_jax.npy"))
        np.testing.assert_allclose(f.numpy(), want, atol=1e-4, rtol=1e-3,
                                   err_msg=f"stage {i + 1}")


@pytest.mark.parametrize("kernel_tier", [True, False])
def test_logits_and_mask_match_golden(params, x, kernel_tier):
    before = [f.launches for f in WRAPPERS]
    with torch.inference_mode():
        logits = bmodel.forward_logits(
            params, CFG, x,
            pt.ComputeConfig(use_flash_attention=kernel_tier,
                             deform_mode="deformable")).numpy()
    assert [f.launches for f in WRAPPERS] == before  # CPU: plain versions
    want = np.load(os.path.join(GOLDEN_DIR, "logits_jax.npy"))
    assert logits.shape == want.shape == (1, 64, 64, 1)
    np.testing.assert_allclose(logits, want, atol=5e-5, rtol=1e-4)
    mae = np.abs(1 / (1 + np.exp(-logits)) - 1 / (1 + np.exp(-want))).mean()
    assert mae < 1e-5


def test_infer_fn_uint8_to_mask(params):
    """make_infer_fn: uint8 frames in, masks at the frame size out, equal to
    the model's sigmoid at the model size resized back."""
    cfg = pt.BiRefNetConfig(size=(64, 64))
    frames = np.random.default_rng(1).integers(0, 256, (2, 96, 80, 3),
                                               dtype=np.uint8)
    compute = pt.ComputeConfig(use_flash_attention=True, deform_mode="regular")
    infer = pipeline.make_infer_fn(params, cfg, compute, "cpu",
                                   as_uint8=False)
    got = infer(frames)
    assert got.shape == (2, 96, 80) and got.dtype == torch.float32
    with torch.inference_mode():
        x = pipeline.preprocess(torch.from_numpy(frames), cfg.size)
        logits = bmodel.forward_logits(params, cfg, x, compute)
        want = pipeline.postprocess(torch.sigmoid(logits), 96, 80,
                                    as_uint8=False)
    torch.testing.assert_close(got, want)
    masks = pipeline.make_infer_fn(params, cfg, compute, "cpu")(frames)
    assert masks.dtype == torch.uint8 and masks.shape == (2, 96, 80)


def test_input_size_must_divide_by_32(params):
    with pytest.raises(ValueError, match="divisible by 32"):
        bmodel.forward_logits(params, CFG, torch.zeros(1, 48, 40, 3))
