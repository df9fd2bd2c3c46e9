"""Checkpoint schema, loader and parameter trees for the PyTorch port.

Counterpart of birefnet_tpu/params.py. `checkpoint_spec` and
`random_checkpoint` are copied from the JAX package, so the same seed gives
a bit-identical flat checkpoint in both packages. The parameter tree has the
JAX package's nesting and key names, with two differences:

- matmul and conv weights keep their torch layouts under the key "weight"
  (conv OIHW, linear [out, in]) where the JAX tree holds "kernel" in HWIO
  and [in, out];
- leaves are torch tensors.

BatchNorm folds to {"scale", "shift"} and the window-attention bias table
expands to the [heads, N, N] "cached_bias" exactly as in the JAX loader.
`from_jax_params` converts the JAX package's tree (as numpy) to this one.
`export_checkpoint` is the exact inverse of `build_param_tree`, rule for
rule the JAX package's (birefnet_tpu/params.py:543-690), so a trained tree
(train.py trains the inference tree: folded BN and "cached_bias" are its
leaves) goes back to the torch schema.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from .configs import BiRefNetConfig, SwinConfig
from .ops.kernels.tf32 import split_weight
from .ops.window import relative_position_index

BN_EPS = 1e-5

# Keys present in real checkpoints that carry no inference information.
IGNORABLE_PATTERNS = (
    re.compile(r".*num_batches_tracked$"),
    re.compile(r".*relative_position_index$"),
    re.compile(r".*attn_mask$"),
)


# ---------------------------------------------------------------------------
# Schema (copied from birefnet_tpu/params.py)
# ---------------------------------------------------------------------------

def _conv_entries(name: str, cin: int, cout: int, k: int, bias: bool = True):
    out = [(f"{name}.weight", (cout, cin, k, k))]
    if bias:
        out.append((f"{name}.bias", (cout,)))
    return out


def _linear_entries(name: str, cin: int, cout: int, bias: bool = True):
    out = [(f"{name}.weight", (cout, cin))]
    if bias:
        out.append((f"{name}.bias", (cout,)))
    return out


def _ln_entries(name: str, c: int):
    return [(f"{name}.weight", (c,)), (f"{name}.bias", (c,))]


def _bn_entries(name: str, c: int):
    return [(f"{name}.weight", (c,)), (f"{name}.bias", (c,)),
            (f"{name}.running_mean", (c,)), (f"{name}.running_var", (c,))]


def _deform_conv_entries(name: str, cin: int, cout: int, k: int):
    kk = k * k
    return (_conv_entries(f"{name}.offset_conv", cin, 2 * kk, k)
            + _conv_entries(f"{name}.modulator_conv", cin, kk, k)
            + _conv_entries(f"{name}.regular_conv", cin, cout, k, bias=False))


def _aspp_deformable_entries(name: str, cin: int, cout: int):
    inter = 256
    out = []
    out += _deform_conv_entries(f"{name}.aspp1.atrous_conv", cin, inter, 1)
    out += _bn_entries(f"{name}.aspp1.bn", inter)
    for i, k in enumerate((1, 3, 7)):
        out += _deform_conv_entries(f"{name}.aspp_deforms.{i}.atrous_conv",
                                    cin, inter, k)
        out += _bn_entries(f"{name}.aspp_deforms.{i}.bn", inter)
    out += _conv_entries(f"{name}.global_avg_pool.1", cin, inter, 1, bias=False)
    out += _bn_entries(f"{name}.global_avg_pool.2", inter)
    out += _conv_entries(f"{name}.conv1", inter * 5, cout, 1, bias=False)
    out += _bn_entries(f"{name}.bn1", cout)
    return out


def _basic_dec_blk_entries(name: str, cin: int, cout: int, inter: int = 64):
    out = []
    out += _conv_entries(f"{name}.conv_in", cin, inter, 3)
    out += _bn_entries(f"{name}.bn_in", inter)
    out += _aspp_deformable_entries(f"{name}.dec_att", inter, inter)
    out += _conv_entries(f"{name}.conv_out", inter, cout, 3)
    out += _bn_entries(f"{name}.bn_out", cout)
    return out


def _simple_convs_entries(name: str, cin: int, cout: int, inter: int = 64):
    return (_conv_entries(f"{name}.conv1", cin, inter, 3)
            + _conv_entries(f"{name}.conv_out", inter, cout, 3))


def _swin_entries(prefix: str, cfg: SwinConfig):
    out = []
    ed = cfg.embed_dim
    out += _conv_entries(f"{prefix}.patch_embed.proj", cfg.in_channels, ed,
                         cfg.patch_size)
    out += _ln_entries(f"{prefix}.patch_embed.norm", ed)
    ws = cfg.window_size
    table_rows = (2 * ws - 1) * (2 * ws - 1)
    for i, depth in enumerate(cfg.depths):
        dim = ed * (1 << i)
        heads = cfg.num_heads[i]
        for j in range(depth):
            b = f"{prefix}.layers.{i}.blocks.{j}"
            out += _ln_entries(f"{b}.norm1", dim)
            out.append((f"{b}.attn.relative_position_bias_table",
                        (table_rows, heads)))
            out += _linear_entries(f"{b}.attn.qkv", dim, dim * 3)
            out += _linear_entries(f"{b}.attn.proj", dim, dim)
            out += _ln_entries(f"{b}.norm2", dim)
            hidden = int(dim * cfg.mlp_ratio)
            out += _linear_entries(f"{b}.mlp.fc1", dim, hidden)
            out += _linear_entries(f"{b}.mlp.fc2", hidden, dim)
        if i < len(cfg.depths) - 1:
            out += _ln_entries(f"{prefix}.layers.{i}.downsample.norm", 4 * dim)
            out += _linear_entries(f"{prefix}.layers.{i}.downsample.reduction",
                                   4 * dim, 2 * dim, bias=False)
        out += _ln_entries(f"{prefix}.norm{i}", dim)
    return out


def checkpoint_spec(cfg: BiRefNetConfig) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every tensor (name, shape) of the ZhengPeng7/BiRefNet checkpoint
    (torch layouts: conv OIHW, linear [out, in])."""
    out = []
    out += _swin_entries("bb", cfg.swin_config())
    out += _basic_dec_blk_entries(
        "squeeze_module.0", cfg.x4_channels(), cfg.lateral_channels()[3])
    d = "decoder"
    ipt_in = cfg.ipt_in_channels()
    ipt_out = cfg.ipt_out_channels()
    for idx in range(5):
        out += _simple_convs_entries(f"{d}.ipt_blk{idx + 1}", ipt_in[idx],
                                     ipt_out[idx])
    dec_in = cfg.dec_in_channels()
    dec_out = cfg.dec_out_channels()
    for pos, stage in enumerate((4, 3, 2, 1)):
        out += _basic_dec_blk_entries(f"{d}.decoder_block{stage}",
                                      dec_in[pos], dec_out[pos])
    lat = cfg.lateral_channels()
    for stage, ch in ((4, lat[2]), (3, lat[1]), (2, lat[0])):
        out += _conv_entries(f"{d}.lateral_block{stage}.conv", ch, ch, 1)
    for pos, stage in enumerate((4, 3, 2)):
        ch = dec_out[pos]
        out += _conv_entries(f"{d}.gdt_convs_{stage}.0", ch, 16, 3)
        out += _bn_entries(f"{d}.gdt_convs_{stage}.1", 16)
        out += _conv_entries(f"{d}.gdt_convs_attn_{stage}.0", 16, 1, 1)
        # Loaded for weight compatibility, never called.
        out += _conv_entries(f"{d}.gdt_convs_pred_{stage}.0", 16, 1, 1)
        out += _conv_entries(f"{d}.conv_ms_spvn_{stage}", ch, 1, 1)
    out += _conv_entries(f"{d}.conv_out1.0", cfg.final_channels(), 1, 1)
    return out


def random_checkpoint(cfg: BiRefNetConfig, seed: int = 0,
                      scale: float = 0.05) -> Dict[str, np.ndarray]:
    """Random flat checkpoint with exactly the schema the loader expects
    (bit-identical to birefnet_tpu.params.random_checkpoint)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, shape in checkpoint_spec(cfg):
        if name.endswith("running_var"):
            arr = rng.uniform(0.5, 1.5, size=shape)
        else:
            arr = rng.normal(0.0, scale, size=shape)
        out[name] = arr.astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# Loading: flat torch-schema dict -> nested tree of tensors
# ---------------------------------------------------------------------------

class _Source:
    """Wraps the flat checkpoint dict; tracks key usage for coverage checks."""

    def __init__(self, tensors: Mapping[str, np.ndarray]):
        self._t = tensors
        self.used: set = set()

    def take(self, name: str) -> np.ndarray:
        if name not in self._t:
            raise KeyError(f"checkpoint missing tensor: {name}")
        self.used.add(name)
        return np.asarray(self._t[name], dtype=np.float32)

    def unused(self) -> List[str]:
        return [k for k in self._t if k not in self.used
                and not any(p.match(k) for p in IGNORABLE_PATTERNS)]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _conv(src: _Source, name: str, bias: bool = True):
    p = {"weight": _t(src.take(f"{name}.weight"))}
    if bias:
        p["bias"] = _t(src.take(f"{name}.bias"))
    return p


_linear = _conv  # [out, in] stays as is, like OIHW


def _ln(src: _Source, name: str):
    return {"scale": _t(src.take(f"{name}.weight")),
            "bias": _t(src.take(f"{name}.bias"))}


def fold_bn(gamma, beta, mean, var):
    """Eval-mode BatchNorm -> (scale, shift), in f32 numpy as the JAX
    loader computes it."""
    scale = gamma / np.sqrt(var + BN_EPS)
    return scale, beta - mean * scale


def _bn(src: _Source, name: str):
    scale, shift = fold_bn(src.take(f"{name}.weight"), src.take(f"{name}.bias"),
                           src.take(f"{name}.running_mean"),
                           src.take(f"{name}.running_var"))
    return {"scale": _t(scale), "shift": _t(shift)}


def cached_bias(table: np.ndarray, window_size: int,
                num_heads: int) -> np.ndarray:
    """[(2w-1)^2, heads] bias table -> [heads, N, N] per-window bias."""
    idx = relative_position_index(window_size)
    n = window_size * window_size
    cached = table[idx.reshape(-1)].reshape(n, n, num_heads)
    return np.ascontiguousarray(cached.transpose(2, 0, 1))


def _attn(src: _Source, name: str, window_size: int, num_heads: int):
    table = src.take(f"{name}.relative_position_bias_table")
    return {"qkv": _linear(src, f"{name}.qkv"),
            "proj": _linear(src, f"{name}.proj"),
            "cached_bias": _t(cached_bias(table, window_size, num_heads))}


def _deform_conv(src: _Source, name: str):
    return {"offset_conv": _conv(src, f"{name}.offset_conv"),
            "modulator_conv": _conv(src, f"{name}.modulator_conv"),
            "regular_conv": _conv(src, f"{name}.regular_conv", bias=False)}


def _aspp_deformable(src: _Source, name: str):
    p = {
        "aspp1": {"atrous_conv": _deform_conv(src, f"{name}.aspp1.atrous_conv"),
                  "bn": _bn(src, f"{name}.aspp1.bn")},
        "global_avg_pool_conv": _conv(src, f"{name}.global_avg_pool.1",
                                      bias=False),
        "global_avg_pool_bn": _bn(src, f"{name}.global_avg_pool.2"),
        "conv1": _conv(src, f"{name}.conv1", bias=False),
        "bn1": _bn(src, f"{name}.bn1"),
    }
    for i in range(3):
        p[f"aspp_deforms_{i}"] = {
            "atrous_conv": _deform_conv(
                src, f"{name}.aspp_deforms.{i}.atrous_conv"),
            "bn": _bn(src, f"{name}.aspp_deforms.{i}.bn"),
        }
    return p


def _basic_dec_blk(src: _Source, name: str):
    return {"conv_in": _conv(src, f"{name}.conv_in"),
            "bn_in": _bn(src, f"{name}.bn_in"),
            "dec_att": _aspp_deformable(src, f"{name}.dec_att"),
            "conv_out": _conv(src, f"{name}.conv_out"),
            "bn_out": _bn(src, f"{name}.bn_out")}


def _simple_convs(src: _Source, name: str):
    return {"conv1": _conv(src, f"{name}.conv1"),
            "conv_out": _conv(src, f"{name}.conv_out")}


def _swin(src: _Source, prefix: str, cfg: SwinConfig):
    p: Dict = {"patch_embed": {
        "proj": _conv(src, f"{prefix}.patch_embed.proj"),
        "norm": _ln(src, f"{prefix}.patch_embed.norm")}}
    for i, depth in enumerate(cfg.depths):
        layer: Dict = {}
        for j in range(depth):
            b = f"{prefix}.layers.{i}.blocks.{j}"
            layer[f"blocks_{j}"] = {
                "norm1": _ln(src, f"{b}.norm1"),
                "attn": _attn(src, f"{b}.attn", cfg.window_size,
                              cfg.num_heads[i]),
                "norm2": _ln(src, f"{b}.norm2"),
                "mlp": {"fc1": _linear(src, f"{b}.mlp.fc1"),
                        "fc2": _linear(src, f"{b}.mlp.fc2")},
            }
        if i < len(cfg.depths) - 1:
            layer["downsample"] = {
                "norm": _ln(src, f"{prefix}.layers.{i}.downsample.norm"),
                "reduction": _linear(
                    src, f"{prefix}.layers.{i}.downsample.reduction",
                    bias=False),
            }
        p[f"layers_{i}"] = layer
        p[f"norm_{i}"] = _ln(src, f"{prefix}.norm{i}")
    return p


def build_param_tree(tensors: Mapping[str, np.ndarray], cfg: BiRefNetConfig,
                     strict: bool = True) -> Dict:
    """Flat torch-schema checkpoint dict -> nested tree of f32 CPU tensors."""
    src = _Source(tensors)
    params: Dict = {"bb": _swin(src, "bb", cfg.swin_config())}
    params["squeeze_module"] = {
        "blocks_0": _basic_dec_blk(src, "squeeze_module.0")}
    d = "decoder"
    dec: Dict = {}
    for idx in range(5):
        dec[f"ipt_blk{idx + 1}"] = _simple_convs(src, f"{d}.ipt_blk{idx + 1}")
    for stage in (4, 3, 2, 1):
        dec[f"decoder_block{stage}"] = _basic_dec_blk(
            src, f"{d}.decoder_block{stage}")
    for stage in (4, 3, 2):
        dec[f"lateral_block{stage}"] = {
            "conv": _conv(src, f"{d}.lateral_block{stage}.conv")}
        dec[f"gdt_convs_{stage}"] = {
            "conv": _conv(src, f"{d}.gdt_convs_{stage}.0"),
            "bn": _bn(src, f"{d}.gdt_convs_{stage}.1")}
        dec[f"gdt_convs_attn_{stage}"] = _conv(
            src, f"{d}.gdt_convs_attn_{stage}.0")
        dec[f"gdt_convs_pred_{stage}"] = _conv(
            src, f"{d}.gdt_convs_pred_{stage}.0")
        dec[f"conv_ms_spvn_{stage}"] = _conv(src, f"{d}.conv_ms_spvn_{stage}")
    dec["conv_out1"] = _conv(src, f"{d}.conv_out1.0")
    params["decoder"] = dec
    if strict:
        extra = src.unused()
        if extra:
            raise ValueError(f"checkpoint has {len(extra)} unexpected "
                             f"tensors, e.g. {extra[:10]}")
    return params


def from_jax_params(tree) -> Dict:
    """The JAX package's parameter tree (numpy or jax arrays: HWIO conv and
    [in, out] linear "kernel" leaves, folded BN) -> this package's tree.
    A tree quantized by the JAX package's `quantize_*_int8` carries int8
    `kernel_q8` [in, out] leaves; they become int8 `weight_q8` [out, in]."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = from_jax_params(v)
        elif k == "kernel":
            a = np.asarray(v, dtype=np.float32)
            out["weight"] = _t(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
        elif k == "kernel_q8":
            out["weight_q8"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(v, dtype=np.int8).T))
        else:
            out[k] = _t(np.asarray(v, dtype=np.float32))
    return out


# Input width from which the Swin blocks' MLP and attention projections are
# quantized (the JAX package's threshold: Swin-L stages 2 and 3, C = 768
# and 1536, where its TPU measurements found the W8A8 kernels faster).
INT8_MLP_MIN_CHANNELS = 768


def _quantize_out_channels(w: torch.Tensor):
    """Symmetric per-output-channel int8 of a [out, in] weight from its f32
    values: scale = max(amax, 1e-30) / 127, q = clip(round(w / scale)),
    rounding half to even, divisions as the JAX package computes them.
    Returns (int8 [out, in], f32 [out]). The 127 is a tensor on w's device:
    PyTorch on CUDA divides by a Python number as a multiply by its rounded
    reciprocal, which gives other scales than the CPU's division."""
    w = w.float()
    amax = torch.clamp_min(w.abs().amax(dim=1), 1e-30)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(w / scale[:, None]), -127.0, 127.0)
    return q.to(torch.int8).contiguous(), scale


def _quantize_blocks(tree, key: str, layers: Tuple[str, str],
                     min_channels: int):
    """Add `weight_q8`/`scale_q8` beside `weight` to the two linears of
    every `key` sub-tree (a Swin block's "mlp" or "attn") whose input width
    is at least min_channels."""
    if not isinstance(tree, Mapping):
        return tree
    out = {}
    for k, v in tree.items():
        if (k == key and isinstance(v, Mapping)
                and all(name in v for name in layers)
                and v[layers[0]]["weight"].shape[1] >= min_channels):
            new = dict(v)
            for name in layers:
                q, s = _quantize_out_channels(v[name]["weight"])
                new[name] = dict(v[name], weight_q8=q, scale_q8=s)
            out[k] = new
        else:
            out[k] = _quantize_blocks(v, key, layers, min_channels)
    return out


def quantize_mlp_int8(params, min_channels: int = INT8_MLP_MIN_CHANNELS):
    """W8A8 weights for the wide Swin MLPs (ComputeConfig.int8_mlp).

    Counterpart of birefnet_tpu.params.quantize_mlp_int8: for every block
    whose mlp input width C >= min_channels, fc1 and fc2 gain `weight_q8`
    (int8 [out, in]) and `scale_q8` (f32 [out]; weight = q * scale),
    computed once from the f32 weights. The `weight` leaves stay for the
    unfused path; ops/kernels/fused_mlp.py dispatches on `weight_q8`."""
    return _quantize_blocks(params, "mlp", ("fc1", "fc2"), min_channels)


def quantize_attn_int8(params, min_channels: int = INT8_MLP_MIN_CHANNELS):
    """W8A8 weights for the wide Swin attention qkv/proj projections
    (ComputeConfig.int8_attn), the same scheme and selectivity as
    quantize_mlp_int8; ops/kernels/fused_block_attn.py dispatches on
    `weight_q8`. The attention core itself stays in the activation dtype."""
    return _quantize_blocks(params, "attn", ("qkv", "proj"), min_channels)


_SPLIT_LINEARS = {"attn": ("qkv", "proj"), "mlp": ("fc1", "fc2")}


def split_tf32_weights(params) -> Dict:
    """The f32 kernel tier's weights: every Swin block's attention qkv and
    proj and MLP fc1 and fc2 that the f32 GEMM runs (no `weight_q8`) gain
    `weight_tf32`, the f32 weight split once into its TF32 hi and lo parts
    ([2, out, in], ops/kernels/tf32.py::split_weight), which the GEMM reads
    beside the activations it splits itself. The `weight` leaves stay for
    the plain versions."""
    if not isinstance(params, Mapping):
        return params
    out = {}
    for k, v in params.items():
        if (k in ("attn", "mlp") and isinstance(v, Mapping)
                and all(name in v for name in _SPLIT_LINEARS[k])):
            new = dict(v)
            for name in _SPLIT_LINEARS[k]:
                lin = v[name]
                if "weight_q8" not in lin and lin["weight"].dtype == torch.float32:
                    new[name] = dict(lin, weight_tf32=split_weight(lin["weight"]))
            out[k] = new
        else:
            out[k] = split_tf32_weights(v)
    return out


def tree_map(fn: Callable[[str, torch.Tensor], torch.Tensor], tree) -> Dict:
    """Apply fn(key, leaf) to every tensor leaf of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, Mapping) else fn(k, v)
            for k, v in tree.items()}


def to_device(params, device) -> Dict:
    return tree_map(lambda _, v: v.to(device), params)


def cast_matmul_weights(params, dtype: torch.dtype) -> Dict:
    """Cast every matmul/conv "weight" leaf to the compute dtype once;
    biases, norm and BN parameters and the attention bias stay f32."""
    if dtype == torch.float32:
        return params
    return tree_map(lambda k, v: v.to(dtype) if k == "weight" else v, params)


def init_params(cfg: BiRefNetConfig, seed: int = 0, device=None) -> Dict:
    """A random tree of the checkpoint's schema (for tests, benchmarks and
    training from scratch): build_param_tree(random_checkpoint(cfg, seed)),
    as birefnet_tpu.params.init_params, on `device` (the CPU by default)."""
    tree = build_param_tree(random_checkpoint(cfg, seed), cfg)
    return tree if device is None else to_device(tree, device)


def load_checkpoint(path: str, cfg: BiRefNetConfig | None = None,
                    strict: bool = True, device=None) -> Dict:
    """Load a safetensors checkpoint into a tree of tensors on `device`."""
    from safetensors.numpy import load_file

    tree = build_param_tree(load_file(path), cfg or BiRefNetConfig.swin_l(),
                            strict=strict)
    return tree if device is None else to_device(tree, device)


# ---------------------------------------------------------------------------
# Export: nested tree -> flat torch-schema checkpoint (inverse of the loader)
# ---------------------------------------------------------------------------
# Every load-time transform is inverted bit-exactly, as in the JAX package:
#   conv / linear weights: already in the torch layouts here;
#   BN fold: written as weight = scale, bias = shift, running_mean = 0,
#            running_var = 1 - BN_EPS, for which the loader's
#            weight / sqrt(var + eps) is exactly 1.0 in f32, so the fold
#            round-trips to the bit; a torch eval-mode BN with these
#            statistics computes the same affine;
#   cached_bias: scattered back into the (2w-1)^2-row bias table (the
#            relative-position index covers every row).

# Leaves that only a prepared inference tree carries (int8 codes and
# scales, TF32 splits): derived from "weight", never exported.
_DERIVED_LEAVES = ("weight_q8", "scale_q8", "weight_tf32")


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def _inv_conv(tree, name: str, out: Dict[str, np.ndarray], bias: bool = True):
    out[f"{name}.weight"] = _f32(tree["weight"])
    if bias:
        out[f"{name}.bias"] = _f32(tree["bias"])


_inv_linear = _inv_conv  # [out, in] as loaded


def _inv_ln(tree, name: str, out):
    out[f"{name}.weight"] = _f32(tree["scale"])
    out[f"{name}.bias"] = _f32(tree["bias"])


def _inv_bn(tree, name: str, out):
    scale, shift = _f32(tree["scale"]), _f32(tree["shift"])
    var = np.full_like(scale, np.float32(1.0) - np.float32(BN_EPS))
    assert float(np.sqrt(var.flat[0] + np.float32(BN_EPS))) == 1.0
    out[f"{name}.weight"] = scale
    out[f"{name}.bias"] = shift
    out[f"{name}.running_mean"] = np.zeros_like(scale)
    out[f"{name}.running_var"] = var


def _inv_attn(tree, name: str, window_size: int, num_heads: int, out):
    _inv_linear(tree["qkv"], f"{name}.qkv", out)
    _inv_linear(tree["proj"], f"{name}.proj", out)
    cached = _f32(tree["cached_bias"])  # [heads, N, N]
    n = window_size * window_size
    idx = np.asarray(relative_position_index(window_size)).reshape(-1)
    table = np.zeros(((2 * window_size - 1) ** 2, num_heads), np.float32)
    # Every (i, j) pair of one relative displacement carries the same value
    # in a loaded tree; the scatter keeps the last.
    table[idx] = cached.transpose(1, 2, 0).reshape(n * n, num_heads)
    assert len(np.unique(idx)) == table.shape[0], "bias table not covered"
    out[f"{name}.relative_position_bias_table"] = table


def _inv_deform_conv(tree, name: str, out):
    _inv_conv(tree["offset_conv"], f"{name}.offset_conv", out)
    _inv_conv(tree["modulator_conv"], f"{name}.modulator_conv", out)
    _inv_conv(tree["regular_conv"], f"{name}.regular_conv", out, bias=False)


def _inv_aspp_deformable(tree, name: str, out):
    _inv_deform_conv(tree["aspp1"]["atrous_conv"], f"{name}.aspp1.atrous_conv",
                     out)
    _inv_bn(tree["aspp1"]["bn"], f"{name}.aspp1.bn", out)
    for i in range(3):
        sub = tree[f"aspp_deforms_{i}"]
        _inv_deform_conv(sub["atrous_conv"],
                         f"{name}.aspp_deforms.{i}.atrous_conv", out)
        _inv_bn(sub["bn"], f"{name}.aspp_deforms.{i}.bn", out)
    _inv_conv(tree["global_avg_pool_conv"], f"{name}.global_avg_pool.1",
              out, bias=False)
    _inv_bn(tree["global_avg_pool_bn"], f"{name}.global_avg_pool.2", out)
    _inv_conv(tree["conv1"], f"{name}.conv1", out, bias=False)
    _inv_bn(tree["bn1"], f"{name}.bn1", out)


def _inv_basic_dec_blk(tree, name: str, out):
    _inv_conv(tree["conv_in"], f"{name}.conv_in", out)
    _inv_bn(tree["bn_in"], f"{name}.bn_in", out)
    _inv_aspp_deformable(tree["dec_att"], f"{name}.dec_att", out)
    _inv_conv(tree["conv_out"], f"{name}.conv_out", out)
    _inv_bn(tree["bn_out"], f"{name}.bn_out", out)


def _inv_simple_convs(tree, name: str, out):
    _inv_conv(tree["conv1"], f"{name}.conv1", out)
    _inv_conv(tree["conv_out"], f"{name}.conv_out", out)


def _inv_swin(tree, prefix: str, cfg: SwinConfig, out):
    _inv_conv(tree["patch_embed"]["proj"], f"{prefix}.patch_embed.proj", out)
    _inv_ln(tree["patch_embed"]["norm"], f"{prefix}.patch_embed.norm", out)
    for i, depth in enumerate(cfg.depths):
        layer = tree[f"layers_{i}"]
        for j in range(depth):
            blk = layer[f"blocks_{j}"]
            b = f"{prefix}.layers.{i}.blocks.{j}"
            _inv_ln(blk["norm1"], f"{b}.norm1", out)
            _inv_attn(blk["attn"], f"{b}.attn", cfg.window_size,
                      cfg.num_heads[i], out)
            _inv_ln(blk["norm2"], f"{b}.norm2", out)
            _inv_linear(blk["mlp"]["fc1"], f"{b}.mlp.fc1", out)
            _inv_linear(blk["mlp"]["fc2"], f"{b}.mlp.fc2", out)
        if i < len(cfg.depths) - 1:
            _inv_ln(layer["downsample"]["norm"],
                    f"{prefix}.layers.{i}.downsample.norm", out)
            _inv_linear(layer["downsample"]["reduction"],
                        f"{prefix}.layers.{i}.downsample.reduction",
                        out, bias=False)
        _inv_ln(tree[f"norm_{i}"], f"{prefix}.norm{i}", out)


def _derived_leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _derived_leaves(v, f"{path}{k}.")
        elif k in _DERIVED_LEAVES:
            yield f"{path}{k}"


def export_checkpoint(params, cfg: BiRefNetConfig) -> Dict[str, np.ndarray]:
    """Nested tree -> flat torch-schema tensors (f32 numpy), the exact
    inverse of build_param_tree: checkpoint_spec(cfg) name for name and
    shape for shape (checked here), and
    build_param_tree(export_checkpoint(p)) == p bit for bit. A tree that
    carries int8 or TF32-split leaves (quantize_*_int8,
    split_tf32_weights: a prepared inference tree) is refused; export the
    tree they were derived from."""
    derived = list(_derived_leaves(params))
    if derived:
        raise ValueError(
            f"export_checkpoint takes the f32 parameter tree; this one "
            f"carries {len(derived)} derived inference leaves (e.g. "
            f"{derived[:3]}) from quantize_*_int8 or split_tf32_weights")
    out: Dict[str, np.ndarray] = {}
    _inv_swin(params["bb"], "bb", cfg.swin_config(), out)
    _inv_basic_dec_blk(params["squeeze_module"]["blocks_0"],
                       "squeeze_module.0", out)
    d, dec = "decoder", params["decoder"]
    for idx in range(5):
        _inv_simple_convs(dec[f"ipt_blk{idx + 1}"], f"{d}.ipt_blk{idx + 1}",
                          out)
    for stage in (4, 3, 2, 1):
        _inv_basic_dec_blk(dec[f"decoder_block{stage}"],
                           f"{d}.decoder_block{stage}", out)
    for stage in (4, 3, 2):
        _inv_conv(dec[f"lateral_block{stage}"]["conv"],
                  f"{d}.lateral_block{stage}.conv", out)
        _inv_conv(dec[f"gdt_convs_{stage}"]["conv"],
                  f"{d}.gdt_convs_{stage}.0", out)
        _inv_bn(dec[f"gdt_convs_{stage}"]["bn"], f"{d}.gdt_convs_{stage}.1",
                out)
        _inv_conv(dec[f"gdt_convs_attn_{stage}"],
                  f"{d}.gdt_convs_attn_{stage}.0", out)
        _inv_conv(dec[f"gdt_convs_pred_{stage}"],
                  f"{d}.gdt_convs_pred_{stage}.0", out)
        _inv_conv(dec[f"conv_ms_spvn_{stage}"], f"{d}.conv_ms_spvn_{stage}",
                  out)
    _inv_conv(dec["conv_out1"], f"{d}.conv_out1.0", out)

    spec = dict(checkpoint_spec(cfg))
    missing = sorted(set(spec) - set(out))
    extra = sorted(set(out) - set(spec))
    if missing or extra:
        raise ValueError(
            f"export schema mismatch: missing {missing[:5]} extra {extra[:5]}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(spec[k]):
            raise ValueError(f"{k}: exported {v.shape} != spec {spec[k]}")
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def save_checkpoint(path: str, params, cfg: BiRefNetConfig | None = None) -> None:
    """Write params as a ZhengPeng7-schema safetensors file, loadable by
    load_checkpoint here, by the JAX package's and by the upstream torch
    BiRefNet in eval mode."""
    from safetensors.numpy import save_file

    cfg = cfg or BiRefNetConfig.swin_l()
    save_file(export_checkpoint(params, cfg), path)
