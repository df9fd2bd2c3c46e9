"""The port's W8A8 int8 path on the CPU against the JAX package.

Weights come from numpy seeds and go through both packages' quantizers;
the JAX side runs its Pallas kernels in interpret mode (`_fused_i8` and
the int8 branch of the fused block-attention kernel), the port its plain
versions (a CPU tensor never launches a kernel).

Tolerances, and why:
- Weight quantization: int8 codes bit-equal, scales within 1 ulp (both
  divide the same f32 amax by 127).
- Activations are quantized per token after a LayerNorm whose sums run in
  another order than XLA's, so a last-bit difference can flip one int8
  code by one step. A kernel's output is held to a few quantization steps
  at most (max |diff| <= 2e-2 at these weight scales, where one step of an
  output is about 5e-3) and to a tiny mean (<= 1e-4: nearly every value
  agrees to f32 rounding), not to bf16 noise. Across a backbone a flipped
  token carries its step into every later block, and the stage-output
  LayerNorm scales the residual stream up (by ~6 in the narrow Swin), so
  stage features are held to max 2e-2 and mean 1e-3, and the masks of the
  whole pipeline to mean 1e-4.
- The JAX fused MLP drops to its unfused, non-int8 path where T has no
  tile that is a multiple of 8 (`_pick_tile`, a TPU tiling rule the port
  does not copy), so the slice tests use inputs at which every int8 site
  of the JAX package tiles: 128^2 at batch 2.
- The JAX MLP's 3-term erf takes `pl.reciprocal(approx=True)`, which
  interpret mode on the CPU evaluates as the f32 reciprocal of the
  bf16-rounded operand; the port takes the exact reciprocal. The
  comparisons of the whole computation reproduce that reciprocal on the
  port's side (`interpret_reciprocal`); one test compares the port's own
  erf, with the tolerance that rounding of the denominator to bf16
  (2^-9 relative) explains: max |diff| <= 1e-2 * max|y|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import birefnet_tpu as bt
from birefnet_tpu import params as jparams
from birefnet_tpu.models import swin as jswin
from birefnet_tpu.ops.pallas.fused_block_attn import (
    fused_window_block_attention as jax_fused_block)
from birefnet_tpu.ops.pallas.fused_mlp import fused_mlp_residual as jax_mlp
import birefnet_tpu_torch as pt
from birefnet_tpu_torch import params as pparams
from birefnet_tpu_torch.models import swin as pswin
from birefnet_tpu_torch.ops import quant
from birefnet_tpu_torch.ops import window as W
from birefnet_tpu_torch.ops.kernels import fused_block_attn, fused_mlp

NARROW = dict(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))
MAX_ERR, MEAN_ERR = 2e-2, 1e-4


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _ln(rng, c):
    return {"scale": 1 + 0.1 * _rand(rng, (c,)), "bias": 0.1 * _rand(rng, (c,))}


def _lin(rng, i, o):
    return {"kernel": _rand(rng, (i, o), 0.05), "bias": _rand(rng, (o,))}


def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_few_steps(got, want, max_err=MAX_ERR, mean_err=MEAN_ERR):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert d.max() <= max_err, f"max |diff| {d.max()}"
    assert d.mean() <= mean_err, f"mean |diff| {d.mean()}"


def _jax_infer_with_features(monkeypatch, jtree, jcfg, jcompute, frames):
    """The JAX package's make_infer_fn masks for uint8 frames and the
    full-scale backbone features of the same call, from one compiled
    program: birefnet.forward's swin_forward is wrapped while the
    pipeline's body is traced, and its first pass's stage outputs are
    returned beside the mask."""
    from birefnet_tpu import pipeline as jpipeline
    from birefnet_tpu.models import birefnet as jbirefnet

    passes, swin_forward = [], jbirefnet.swin_forward

    def captured(*args, **kw):
        out = swin_forward(*args, **kw)
        passes.append(out)
        return out

    monkeypatch.setattr(jbirefnet, "swin_forward", captured)
    body = jpipeline.make_infer_fn(jtree, jcfg, jcompute,
                                   as_uint8=False).__wrapped__
    mask, feats = jax.jit(lambda f: (body(f), passes[0]))(jnp.asarray(frames))
    monkeypatch.setattr(jbirefnet, "swin_forward", swin_forward)
    assert len(passes) == 2  # the full- and half-scale backbone passes
    return np.asarray(mask), [np.asarray(f) for f in feats]


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


@pytest.fixture(scope="module")
def narrow_trees():
    """A narrow Swin backbone (stage widths 64/128/256/512) from one flat
    checkpoint, as the JAX tree and the port's tree."""
    jcfg, pcfg = bt.SwinConfig(**NARROW), pt.SwinConfig(**NARROW)
    rng = np.random.default_rng(21)
    flat = {k: rng.normal(0.0, 0.05, s).astype(np.float32)
            for k, s in jparams._swin_entries("bb", jcfg)}
    return (jcfg, _jnp(jparams._swin(jparams._Source(flat), "bb", jcfg)),
            pcfg, pparams._swin(pparams._Source(flat), "bb", pcfg))


@pytest.mark.parametrize("min_channels", [128, 256])
@pytest.mark.parametrize("kind", ["mlp", "attn"])
def test_quantize_matches_jax(narrow_trees, kind, min_channels):
    _, jtree, _, ptree = narrow_trees
    jq = getattr(jparams, f"quantize_{kind}_int8")(jtree, min_channels)
    pq = getattr(pparams, f"quantize_{kind}_int8")(ptree, min_channels)
    layers = ("fc1", "fc2") if kind == "mlp" else ("qkv", "proj")
    quantized = 0
    for i, c in enumerate((64, 128, 256, 512)):
        for j in range(2):
            jb = jq[f"layers_{i}"][f"blocks_{j}"][kind]
            pb = pq[f"layers_{i}"][f"blocks_{j}"][kind]
            for name in layers:
                assert ("kernel_q8" in jb[name]) == (c >= min_channels)
                assert ("weight_q8" in pb[name]) == (c >= min_channels)
                if c < min_channels:
                    continue
                quantized += 1
                codes = pb[name]["weight_q8"]
                assert codes.dtype == torch.int8 and codes.is_contiguous()
                # torch layout [out, in] against the JAX [in, out]
                np.testing.assert_array_equal(codes.numpy(),
                                              np.asarray(jb[name]["kernel_q8"]).T)
                np.testing.assert_array_max_ulp(pb[name]["scale_q8"].numpy(),
                                                np.asarray(jb[name]["scale_q8"]),
                                                maxulp=1)
                assert torch.equal(pb[name]["weight"], ptree[f"layers_{i}"][
                    f"blocks_{j}"][kind][name]["weight"])
    assert quantized == 2 * len(layers) * (2 if min_channels == 256 else 3)


def test_from_jax_params_carries_a_quantized_tree(narrow_trees):
    _, jtree, _, ptree = narrow_trees
    jq = jparams.quantize_attn_int8(jparams.quantize_mlp_int8(jtree, 256), 256)
    pq = pparams.quantize_attn_int8(pparams.quantize_mlp_int8(ptree, 256), 256)
    ours, theirs = dict(_leaves(pq)), dict(_leaves(pt.from_jax_params(jq)))
    assert ours.keys() == theirs.keys()
    assert sum(k.endswith("weight_q8") for k in ours) == 16
    for k, v in ours.items():
        assert v.dtype == theirs[k].dtype and v.shape == theirs[k].shape, k
        if k.endswith("scale_q8"):
            np.testing.assert_array_max_ulp(v.numpy(), theirs[k].numpy(), 1)
        else:
            assert torch.equal(v, theirs[k]), k


def test_cast_keeps_int8_leaves(narrow_trees):
    _, _, _, ptree = narrow_trees
    cast = pparams.cast_matmul_weights(pparams.quantize_mlp_int8(ptree, 256),
                                       torch.bfloat16)
    fc1 = cast["layers_2"]["blocks_0"]["mlp"]["fc1"]
    assert fc1["weight"].dtype == torch.bfloat16
    assert fc1["weight_q8"].dtype == torch.int8
    assert fc1["scale_q8"].dtype == torch.float32


def _mlp_case(c, dtype):
    rng = np.random.default_rng(c)
    x = _rand(rng, (2, 8, 8, c))
    norm2 = _ln(rng, c)
    mlp = jparams.quantize_mlp_int8(
        {"b": {"mlp": _jnp({"fc1": _lin(rng, c, 4 * c),
                            "fc2": _lin(rng, 4 * c, c)})}}, c)["b"]["mlp"]
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_mlp(jx, _jnp(norm2), mlp, interpret=True).astype(
        jnp.float32))
    t = pt.from_jax_params({"norm2": norm2, "mlp": mlp})
    tx = torch.from_numpy(x).to(getattr(torch, jnp.dtype(dtype).name))
    return tx, t, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 192])
def test_fused_mlp_int8_plain_matches_pallas(c, dtype, interpret_reciprocal):
    x, t, want = _mlp_case(c, dtype)
    n8, n16 = (fused_mlp.fused_mlp_residual_int8.launches,
               fused_mlp.fused_mlp_residual.launches)
    got = fused_mlp.fused_mlp_residual(x, t["norm2"], t["mlp"])
    assert got.dtype == x.dtype
    assert (fused_mlp.fused_mlp_residual_int8.launches,
            fused_mlp.fused_mlp_residual.launches) == (n8, n16)
    if dtype == "float32":
        _assert_few_steps(got, want)
    else:  # plus one bf16 ulp of the output (values below 8)
        _assert_few_steps(got.float(), want, MAX_ERR + 2 ** -5, 1e-3)


@pytest.mark.parametrize("c", [64, 192])
def test_fused_mlp_int8_exact_reciprocal_near_pallas(c):
    x, t, want = _mlp_case(c, "float32")
    got = fused_mlp.fused_mlp_residual_int8_plain(x, t["norm2"], t["mlp"])
    y = np.abs(want - x.numpy()).max()
    d = np.abs(got.numpy() - want)
    assert d.max() <= 1e-2 * y and d.mean() <= 2e-3 * y


@pytest.mark.parametrize("shift", [0, 6])
# exact grid, padded with the cyclic roll, padded with the offset partition
@pytest.mark.parametrize("hw", [(24, 24), (20, 17), (16, 16)])
@pytest.mark.parametrize("heads,c", [(2, 64), (6, 192)])
def test_fused_block_attn_int8_plain_matches_pallas(shift, hw, heads, c):
    rng = np.random.default_rng(10 + shift + hw[1] + c)
    h, w = hw
    ws = 12
    norm1 = _ln(rng, c)
    attn = jparams.quantize_attn_int8(
        {"b": {"attn": _jnp({"qkv": _lin(rng, c, 3 * c),
                             "proj": _lin(rng, c, c),
                             "cached_bias": _rand(rng, (heads, 144, 144))})}},
        c)["b"]["attn"]
    x = _rand(rng, (2, h, w, c))
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    canvas, k_shift, mask, origin = pswin.fused_block_canvas(
        torch.from_numpy(x), ws, shift, W.sw_msa_mask(hp, wp, ws, ws // 2))
    want = np.asarray(jax_fused_block(
        jnp.asarray(canvas.numpy()), _jnp(norm1), attn, ws, k_shift, heads,
        None if mask is None else jnp.asarray(mask.numpy()), h, w,
        residual=True, interpret=True, origin=origin))
    tp = pt.from_jax_params({"norm1": norm1, "attn": attn})
    counts = (fused_block_attn.fused_window_block_attention_int8.launches,
              fused_block_attn.fused_window_block_attention.launches)
    got = fused_block_attn.fused_window_block_attention(
        canvas, tp["norm1"], tp["attn"], ws, k_shift, heads, mask, h, w,
        origin=origin)
    assert counts == (fused_block_attn.fused_window_block_attention_int8.launches,
                      fused_block_attn.fused_window_block_attention.launches)
    real = (slice(None), slice(origin, origin + h), slice(origin, origin + w))
    if k_shift:
        got = W.roll_2d(got, k_shift, k_shift)
        want = np.roll(want, (k_shift, k_shift), axis=(1, 2))
    _assert_few_steps(got.numpy()[real], want[real])


def test_quantize_rows_formula():
    """Half-to-even rounding, the 127 clip, the 1e-30 floor of a zero row."""
    h = torch.tensor([[127.0, 0.5, 1.5, -2.5, -127.0], [0.0] * 5])
    q, s = quant.quantize_rows(h)
    assert q.dtype == torch.int8
    assert q.tolist() == [[127, 0, 2, -2, -127], [0] * 5]
    assert s[:, 0].tolist() == [1.0, np.float32(1e-30) * np.float32(1 / 127)]


def test_swin_forward_int8_matches_jax(narrow_trees, interpret_reciprocal):
    """The slice's backbone: the narrow Swin on the kernel tier with both
    quantizers at its stage-2 width (stages 2 and 3 run int8), port plain
    versions against the JAX package's interpret-mode kernels."""
    jcfg, jtree, pcfg, ptree = narrow_trees
    jq = jparams.quantize_attn_int8(jparams.quantize_mlp_int8(jtree, 256), 256)
    pq = pparams.quantize_attn_int8(pparams.quantize_mlp_int8(ptree, 256), 256)
    x = (np.random.default_rng(0).normal(size=(2, 128, 128, 3)) * 0.5).astype(
        np.float32)
    fwd = jax.jit(lambda p, x: jswin.swin_forward(
        p, jcfg, x, bt.ComputeConfig(use_flash_attention=True, int8_mlp=True,
                                     int8_attn=True)))
    want = [np.asarray(f) for f in fwd(jq, jnp.asarray(x))]
    counts = (fused_mlp.fused_mlp_residual_int8.launches,
              fused_block_attn.fused_window_block_attention_int8.launches)
    with torch.inference_mode():
        got = pswin.swin_forward(
            pq, pcfg, torch.from_numpy(x),
            pt.ComputeConfig(use_flash_attention=True, int8_mlp=True,
                             int8_attn=True))
        plain = pswin.swin_forward(pq, pcfg, torch.from_numpy(x),
                                   pt.ComputeConfig())
    assert counts == (fused_mlp.fused_mlp_residual_int8.launches,
                      fused_block_attn.fused_window_block_attention_int8.launches)
    for g, w_ in zip(got, want):
        _assert_few_steps(g.numpy(), w_, MAX_ERR, 1e-3)
    # Off the kernel tier the quantized leaves are ignored: f32 everywhere.
    ref = pswin.swin_forward(ptree, pcfg, torch.from_numpy(x),
                             pt.ComputeConfig())
    for p, r in zip(plain, ref):
        assert torch.equal(p, r)
    assert max(float((g - p).abs().max()) for g, p in zip(got[2:], plain[2:])) > 1e-3


def test_make_infer_fn_int8_matches_jax(interpret_reciprocal, monkeypatch):
    """The slice as a whole: Swin-L at 128^2, batch 2, through
    make_infer_fn with both int8 flags on the kernel tier (f32
    activations, default min_channels), port on the CPU against the JAX
    package's pipeline. Stages 2 and 3 of both backbone passes run W8A8:
    40 MLP and 40 block-attention sites. The random checkpoint's masks sit
    near 0.5 and barely move with int8, so the masks check the pipeline
    around the int8 blocks (mean 1e-6), the sites are counted, and the
    full-scale backbone features of the make_infer_fn call are held to the
    JAX package's int8 backbone in its own make_infer_fn call."""
    from birefnet_tpu_torch import pipeline as ppipeline
    from birefnet_tpu_torch.models import birefnet as pbirefnet

    jcfg = bt.BiRefNetConfig(size=(128, 128))
    pcfg = pt.BiRefNetConfig(size=(128, 128))
    flat = bt.random_checkpoint(jcfg, 7)
    frames = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    jcompute = bt.ComputeConfig(use_flash_attention=True, int8_mlp=True,
                                int8_attn=True, deform_mode="regular")
    want, want_feats = _jax_infer_with_features(
        monkeypatch, bt.build_param_tree(flat, jcfg), jcfg, jcompute, frames)
    feats = []

    def captured(*args, **kw):
        out = pswin.swin_forward(*args, **kw)
        feats.append(out)
        return out

    monkeypatch.setattr(pbirefnet, "swin_forward", captured)
    calls = {"mlp": 0, "attn": 0}

    def counted(key, fn):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(fused_mlp, "fused_mlp_residual_int8_plain", counted(
        "mlp", fused_mlp.fused_mlp_residual_int8_plain))
    monkeypatch.setattr(
        fused_block_attn, "fused_window_block_attention_int8_plain", counted(
            "attn", fused_block_attn.fused_window_block_attention_int8_plain))
    ptree = pt.build_param_tree(flat, pcfg)
    got = ppipeline.make_infer_fn(
        ptree, pcfg, pt.ComputeConfig(use_flash_attention=True, int8_mlp=True,
                                      int8_attn=True, deform_mode="regular"),
        "cpu",
        as_uint8=False)(frames)
    assert calls == {"mlp": 40, "attn": 40}
    assert got.shape == want.shape == (2, 128, 128)
    assert np.abs(got.numpy() - want).mean() < 1e-6
    # Stage features (mean |f| about 0.05): the int8 flips of 18 blocks
    # read max 9.8e-3 and mean 6.5e-4 here; the f32 backbone reads about
    # the same, so this holds the int8 path to the JAX one within its own
    # rounding noise. Scales dequantizing the wrong channels read 10x that.
    assert len(feats) == 2  # the full- and half-scale backbone passes
    for g, w_ in zip(feats[0], want_feats):
        _assert_few_steps(g.numpy(), w_, MAX_ERR, 1e-3)
    rolled = pparams.tree_map(
        lambda k, v: torch.roll(v, 1) if k == "scale_q8" else v,
        pparams.quantize_attn_int8(pparams.quantize_mlp_int8(ptree["bb"])))
    with torch.inference_mode():
        bad = pswin.swin_forward(
            rolled, pcfg.swin_config(),
            ppipeline.preprocess(torch.from_numpy(frames), pcfg.size),
            pt.ComputeConfig(use_flash_attention=True))
    assert all(np.abs(g.numpy() - w_).mean() > 4e-3
               for g, w_ in zip(bad[2:], want_feats[2:]))


def test_make_infer_fn_swin_t_matches_jax(interpret_reciprocal, monkeypatch):
    """The ws=7 slice as a whole: swin_t at 128^2, batch 2, through
    make_infer_fn with both int8 flags on the kernel tier (f32
    activations), port on the CPU against the JAX package's pipeline. Each
    backbone pass runs 12 middle-tier blocks: 12 K6 sites, and 10 K2 and 2
    K3 sites (int8_mlp quantizes stage 3, C = 768; int8_attn quantizes the
    stage-3 qkv and proj, which the middle tier does not read). The masks
    are held to mean 1e-6, the sites are counted, and the full-scale
    backbone features of the make_infer_fn call to those of the JAX
    middle tier's make_infer_fn call."""
    import dataclasses

    from birefnet_tpu_torch import pipeline as ppipeline
    from birefnet_tpu_torch.models import birefnet as pbirefnet
    from birefnet_tpu_torch.ops.kernels import flash_window_attn

    jcfg = dataclasses.replace(bt.BiRefNetConfig.for_backbone("swin_v1_t"),
                               size=(128, 128))
    pcfg = dataclasses.replace(pt.BiRefNetConfig.for_backbone("swin_v1_t"),
                               size=(128, 128))
    flat = bt.random_checkpoint(jcfg, 8)
    frames = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    jcompute = bt.ComputeConfig(use_flash_attention=True, int8_mlp=True,
                                int8_attn=True, deform_mode="regular")
    want, want_feats = _jax_infer_with_features(
        monkeypatch, bt.build_param_tree(flat, jcfg), jcfg, jcompute, frames)
    feats = []

    def captured(*args, **kw):
        out = pswin.swin_forward(*args, **kw)
        feats.append(out)
        return out

    monkeypatch.setattr(pbirefnet, "swin_forward", captured)
    calls = {"k6": 0, "k2": 0, "k3": 0}

    def counted(key, fn):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(
        flash_window_attn, "flash_window_attention_qkv_plain", counted(
            "k6", flash_window_attn.flash_window_attention_qkv_plain))
    monkeypatch.setattr(fused_mlp, "fused_mlp_residual_plain", counted(
        "k2", fused_mlp.fused_mlp_residual_plain))
    monkeypatch.setattr(fused_mlp, "fused_mlp_residual_int8_plain", counted(
        "k3", fused_mlp.fused_mlp_residual_int8_plain))
    ptree = pt.build_param_tree(flat, pcfg)
    got = ppipeline.make_infer_fn(
        ptree, pcfg, pt.ComputeConfig(use_flash_attention=True, int8_mlp=True,
                                      int8_attn=True, deform_mode="regular"),
        "cpu",
        as_uint8=False)(frames)
    assert calls == {"k6": 24, "k2": 20, "k3": 4}
    assert got.shape == want.shape == (2, 128, 128)
    assert np.abs(got.numpy() - want).mean() < 1e-6
    assert len(feats) == 2  # the full- and half-scale backbone passes
    assert [g.shape[-1] for g in feats[0]] == [96, 192, 384, 768]
    for g, w_ in zip(feats[0], want_feats):
        _assert_few_steps(g.numpy(), w_, MAX_ERR, 1e-3)
