"""make_infer_fn's body is safe to capture in a CUDA graph.

On the card `pipeline.make_infer_fn` captures its body once per input
shape and replays it (pipeline.GraphedInfer). A capture refuses what the
host does inside the body at each call: a tensor built from host values on
the device (a pageable host-to-device copy), a numpy array turned into a
tensor, or a device value read back (`.item()`, `.tolist()`). Here, on
the CPU, a second call of the body runs under patches that raise on each of
those; its mask must equal the unpatched call's bitwise. The device caches
(ops/device_cache.py) that let a graph own what it reads are checked too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from birefnet_tpu_torch import pipeline
from birefnet_tpu_torch.configs import BiRefNetConfig, ComputeConfig
from birefnet_tpu_torch.ops import device_cache, resize
from birefnet_tpu_torch.ops import window as W
from birefnet_tpu_torch.params import build_param_tree, random_checkpoint

TIERS = {
    "plain bf16": ComputeConfig(dtype=torch.bfloat16, deform_mode="regular"),
    "kernel tier int8": ComputeConfig(dtype=torch.bfloat16,
                                      use_flash_attention=True,
                                      int8_mlp=True, int8_attn=True,
                                      deform_mode="regular"),
    "f32 tier": ComputeConfig(use_flash_attention=True, deform_mode="regular"),
    "kernel tier int8 deformable": ComputeConfig(
        dtype=torch.bfloat16, use_flash_attention=True, int8_mlp=True,
        int8_attn=True, deform_mode="deformable"),
}


@pytest.fixture(scope="module")
def swin_t():
    cfg = dataclasses.replace(BiRefNetConfig.for_backbone("swin_v1_t"),
                              size=(64, 64))
    return cfg, build_param_tree(random_checkpoint(cfg, 0), cfg)


def _refuse(name):
    def raise_(*args, **kw):
        raise AssertionError(f"{name} called inside the body")
    return raise_


def _no_device(fn, name):
    def checked(*args, **kw):
        if kw.get("device") is not None:
            raise AssertionError(f"{name}(..., device=) called inside the body")
        return fn(*args, **kw)
    return checked


@pytest.mark.parametrize("tier", list(TIERS))
def test_body_makes_no_host_transfer(swin_t, tier, monkeypatch):
    cfg, params = swin_t
    infer = pipeline.make_infer_fn(params, cfg, TIERS[tier], "cpu")
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    want = infer(frames)  # warm: fills the caches, as a graph's warm-up does
    with monkeypatch.context() as m:
        m.setattr(torch, "tensor", _no_device(torch.tensor, "torch.tensor"))
        m.setattr(torch, "as_tensor", _no_device(torch.as_tensor,
                                                 "torch.as_tensor"))
        m.setattr(torch, "from_numpy", _refuse("torch.from_numpy"))
        m.setattr(torch.Tensor, "item", _refuse("Tensor.item"))
        m.setattr(torch.Tensor, "tolist", _refuse("Tensor.tolist"))
        got = infer(frames)
    assert torch.equal(got, want)


def test_preprocess_and_region_mask_keep_their_values():
    """The capture-safe forms give the numbers of the per-call tensors they
    replace, bit for bit."""
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 40, 56, 3), dtype=np.uint8))
    x = resize.resize_bilinear_half_pixel(frames.float() / 255.0, 32, 32)
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float32)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float32)
    assert torch.equal(pipeline.preprocess(frames, (32, 32)), (x - mean) / std)
    ids = W.sw_msa_region_ids(14, 21, 7, 3, torch.device("cpu"))
    diff = ids[:, None, :] - ids[:, :, None]
    want = torch.where(diff != 0, torch.tensor(-100.0), torch.tensor(0.0))
    got = W.region_mask(ids)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_device_cache_hands_hits_and_misses_to_retained():
    calls = []

    @device_cache.device_cache(maxsize=2)
    def build(n):
        calls.append(n)
        return torch.full((n,), float(n))

    build.cache_clear()
    outside = build(1)
    with device_cache.retained() as held:
        assert build(1) is outside  # a hit
        fresh = build(2)  # a miss
    build(3)  # outside: not held
    assert calls == [1, 2, 3] and [t for t in held] == [outside, fresh]
    build.cache_clear()
    assert build.cache_info().currsize == 0
    assert torch.equal(held[1], torch.full((2,), 2.0))
