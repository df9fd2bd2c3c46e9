"""birefnet_tpu_torch configs and params against the JAX package (CPU).

The port builds its parameter tree from the same flat torch-schema
checkpoint as birefnet_tpu; both trees must hold identical values, and the
synthetic checkpoint must be bit-identical for a seed. The swin_v1_t preset
runs every code path of the schema and loader at a fifth of Swin-L's
memory; test_torch_slice.py loads the Swin-L tree itself.
"""

import numpy as np
import pytest
import torch

import birefnet_tpu as bt
import birefnet_tpu_torch as pt
from birefnet_tpu_torch import params as pparams

CFG = bt.BiRefNetConfig.for_backbone("swin_v1_t")
PCFG = pt.BiRefNetConfig.for_backbone("swin_v1_t")


@pytest.fixture(scope="module")
def flat():
    return bt.random_checkpoint(CFG, seed=7)


def test_random_checkpoint_bit_identical(flat):
    ours = pt.random_checkpoint(PCFG, seed=7)
    assert list(ours) == list(flat)
    for k, v in flat.items():
        assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k


@pytest.mark.parametrize("preset", ["swin_v1_t", "swin_v1_s", "swin_v1_b",
                                    "swin_v1_l"])
def test_checkpoint_spec_and_channel_plan_match(preset):
    jc = bt.BiRefNetConfig.for_backbone(preset)
    pc = pt.BiRefNetConfig.for_backbone(preset)
    assert pt.checkpoint_spec(pc) == bt.checkpoint_spec(jc)
    for fn in ("lateral_channels", "x4_channels", "dec_in_channels",
               "dec_out_channels", "final_channels"):
        assert getattr(pc, fn)() == getattr(jc, fn)()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_build_param_tree_equals_from_jax_params(flat):
    ours = dict(_leaves(pt.build_param_tree(flat, PCFG)))
    theirs = dict(_leaves(pt.from_jax_params(bt.build_param_tree(flat, CFG))))
    assert ours.keys() == theirs.keys()
    for k, v in ours.items():
        assert v.dtype == torch.float32 and torch.equal(v, theirs[k]), k


def test_layouts_are_torch_native(flat):
    tree = pt.build_param_tree(flat, PCFG)
    blk = tree["bb"]["layers_0"]["blocks_0"]
    assert tuple(blk["attn"]["qkv"]["weight"].shape) == (288, 96)
    assert tuple(blk["attn"]["cached_bias"].shape) == (3, 49, 49)
    conv = tree["decoder"]["ipt_blk1"]["conv1"]["weight"]
    assert tuple(conv.shape) == (64, 3, 3, 3)
    cast = pparams.cast_matmul_weights(tree, torch.bfloat16)
    assert cast["bb"]["layers_0"]["blocks_0"]["mlp"]["fc1"]["weight"].dtype \
        == torch.bfloat16
    assert cast["bb"]["layers_0"]["blocks_0"]["mlp"]["fc1"]["bias"].dtype \
        == torch.float32
    assert cast["bb"]["norm_0"]["scale"].dtype == torch.float32


def test_strict_loader_reports_schema_errors(flat):
    extra = dict(flat, **{"bogus.weight": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        pt.build_param_tree(extra, PCFG)
    missing = {k: v for k, v in flat.items() if k != "bb.norm0.bias"}
    with pytest.raises(KeyError, match="bb.norm0.bias"):
        pt.build_param_tree(missing, PCFG)


# deformable-local (the TPU's offset-clamped sampler) stays refused on
# every tier and dtype, int8 or not, with its reason.
@pytest.mark.parametrize("kw", [
    {"deform_mode": "deformable-local", "dtype": torch.bfloat16,
     "use_flash_attention": True},
    {"deform_mode": "deformable-local", "int8_mlp": True, "int8_attn": True}])
def test_unported_compute_options_raise(kw):
    with pytest.raises(NotImplementedError, match="gather floor.*ROADMAP"):
        pt.ComputeConfig(**kw)


# deformable is accepted on every tier and dtype and is the default, as in
# the JAX package; regular stays.
@pytest.mark.parametrize("kw", [
    {"deform_mode": "deformable", "dtype": torch.bfloat16,
     "use_flash_attention": True},
    {"deform_mode": "deformable"}, {"deform_mode": "regular"}])
def test_deform_modes_construct(kw):
    assert pt.ComputeConfig(**kw).deform_mode == kw["deform_mode"]


def test_default_deform_mode_matches_jax():
    import birefnet_tpu as bt
    assert pt.ComputeConfig().deform_mode == bt.ComputeConfig().deform_mode \
        == "deformable"


@pytest.mark.parametrize("kw", [{"int8_mlp": True}, {"int8_attn": True},
                                {"int8_mlp": True, "int8_attn": True,
                                 "dtype": torch.bfloat16,
                                 "use_flash_attention": True}])
def test_int8_compute_options_construct(kw):
    compute = pt.ComputeConfig(**kw)
    for k, v in kw.items():
        assert getattr(compute, k) == v


def test_int8_threshold_matches_jax():
    from birefnet_tpu import params as jparams
    assert pparams.INT8_MLP_MIN_CHANNELS == jparams.INT8_MLP_MIN_CHANNELS
