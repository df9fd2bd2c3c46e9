"""The port's checkpoint export (params.export_checkpoint, save_checkpoint,
init_params) against the JAX package's, bit for bit.

- export_checkpoint(from_jax_params(tree)) equals
  birefnet_tpu.params.export_checkpoint(tree): same names, shapes and bits;
- build_param_tree(export_checkpoint(tree)) == tree, and load -> export ->
  load is bitwise;
- the file save_checkpoint writes loads through both packages to the same
  tree;
- a tree carrying derived inference leaves (int8 codes, TF32 splits) is
  refused.
swin_v1_t keeps the trees small; the ws=12 bias-table scatter is checked
on one Swin-L block.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import birefnet_tpu as bt
from birefnet_tpu import params as jparams
import birefnet_tpu_torch as pt
from birefnet_tpu_torch import params as pparams
from birefnet_tpu_torch import train

CFG_J = bt.BiRefNetConfig.for_backbone("swin_v1_t")
CFG_P = pt.BiRefNetConfig.for_backbone("swin_v1_t")


@pytest.fixture(scope="module")
def flat():
    return bt.random_checkpoint(CFG_J, 3)


def _assert_trees_equal(a, b):
    fa, fb = dict(train.flatten(a)), dict(train.flatten(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_export_equals_the_jax_export(flat):
    jtree = jparams.build_param_tree(flat, CFG_J)
    want = jparams.export_checkpoint(jtree, CFG_J)
    got = pt.export_checkpoint(pt.from_jax_params(jtree), CFG_P)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        assert np.array_equal(got[k], np.asarray(v)), k
        assert got[k].flags["C_CONTIGUOUS"]


def test_load_export_load_is_bitwise(flat):
    tree = pt.build_param_tree(flat, CFG_P)
    exported = pt.export_checkpoint(tree, CFG_P)
    again = pt.build_param_tree(exported, CFG_P)
    _assert_trees_equal(tree, again)
    second = pt.export_checkpoint(again, CFG_P)
    assert all(np.array_equal(exported[k], second[k]) for k in exported)
    # Every tensor but the BatchNorm statistics keeps the file's bits.
    for k, v in flat.items():
        if not k.endswith(("running_mean", "running_var")) and not any(
                k.startswith(p) and k.endswith((".weight", ".bias"))
                for p in _bn_prefixes()):
            assert np.array_equal(exported[k], v), k


def _bn_prefixes():
    return {name.rsplit(".", 1)[0] + "." for name, _ in
            pparams.checkpoint_spec(CFG_P) if name.endswith("running_var")}


def test_saved_file_loads_through_both_packages(flat, tmp_path):
    path = str(tmp_path / "exported.safetensors")
    tree = pt.build_param_tree(flat, CFG_P)
    pt.save_checkpoint(path, tree, CFG_P)
    _assert_trees_equal(pt.load_checkpoint(path, CFG_P), tree)
    jtree = bt.load_checkpoint(path, CFG_J)
    _assert_trees_equal(pt.from_jax_params(jtree), tree)
    os.remove(path)  # 172 MB; a parallel run of the suite keeps tmp_path


def test_init_params_equals_the_jax_init(flat):
    cfg_j = dataclasses.replace(CFG_J, size=(64, 64))
    cfg_p = dataclasses.replace(CFG_P, size=(64, 64))
    want = pt.from_jax_params(bt.params.init_params(cfg_j, seed=3))
    _assert_trees_equal(pt.init_params(cfg_p, seed=3), want)
    _assert_trees_equal(pt.init_params(cfg_p, 3, device="cpu"), want)


def test_bias_table_scatter_at_window_12():
    """One Swin-L block's [(2w-1)^2, heads] table survives expand -> export."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(23 * 23, 6)).astype(np.float32)
    attn = {"qkv": {"weight": torch.zeros(3, 1), "bias": torch.zeros(3)},
            "proj": {"weight": torch.zeros(1, 1), "bias": torch.zeros(1)},
            "cached_bias": torch.from_numpy(pparams.cached_bias(table, 12, 6))}
    out = {}
    pparams._inv_attn(attn, "b", 12, 6, out)
    assert np.array_equal(out["b.relative_position_bias_table"], table)


@pytest.mark.parametrize("derive", ["quantize_mlp_int8", "split_tf32_weights"])
def test_export_refuses_derived_inference_leaves(flat, derive):
    tree = getattr(pparams, derive)(pt.build_param_tree(flat, CFG_P),
                                    **({"min_channels": 96}
                                       if derive.startswith("quantize") else {}))
    with pytest.raises(ValueError, match="derived inference leaves"):
        pt.export_checkpoint(tree, CFG_P)
