"""The f32 kernel tier on the CPU: the plain f32 chains that the card's f32
kernels (the FFMA GEMM, the f32 row pass and the f32 window-attention core,
composed as K1, K2 and K6-K8) are held to, against the JAX package's f32
kernels, and the pipeline's and serve's f32 policy.

On the CPU every wrapper takes its plain version, so these tests also check
that a CPU call launches nothing. The JAX side runs the f32 branches of its
Pallas kernels in interpret mode, every dot at precision=HIGHEST: `_fused`
of birefnet_tpu/ops/pallas/fused_block_attn.py (K1) and of fused_mlp.py
(K2, with the 5-coefficient `_erf(fast=False)`), the flash_window_attn.py
kernels (K6-K8) and `layer_norm_rows` of row_ln.py; the GEMM against
`jnp.dot(..., precision=HIGHEST)` plus its epilogue.

Tolerance: the f32 bar of ROADMAP.md (PARITY.md:170), 1e-5, as a max and a
mean ratio, max|port - jax| <= 1e-5 * max|jax| and mean|port - jax| /
mean|jax| <= 1e-5, tighter than the 2e-5 / 1e-4 of the other port tests'
f32 cases. Both sides are f32 sums of f32 products in other orders, and
the GELUs differ by at most 1.5e-7 (JAX's 7.1.26 erf against F.gelu).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birefnet_tpu.ops.pallas import flash_window_attn as jfwa
from birefnet_tpu.ops.pallas.fused_block_attn import (
    fused_window_block_attention as jax_fused_block)
from birefnet_tpu.ops.pallas.fused_mlp import _erf as jax_erf
from birefnet_tpu.ops.pallas.fused_mlp import fused_mlp_residual as jax_mlp
from birefnet_tpu.ops.pallas.row_ln import layer_norm_rows as jax_row_ln
from birefnet_tpu_torch import pipeline, serve
from birefnet_tpu_torch.configs import BiRefNetConfig, ComputeConfig
from birefnet_tpu_torch.models import birefnet, swin
from birefnet_tpu_torch.ops import window as W
from birefnet_tpu_torch.ops.kernels import (f32_gemm, flash_window_attn,
                                            fused_block_attn, fused_mlp)
from birefnet_tpu_torch.params import (build_param_tree, from_jax_params,
                                       random_checkpoint)

BAR = 1e-5
WRAPPERS = (f32_gemm.f32_gemm, f32_gemm.ln_rows_f32,
            fused_mlp.fused_mlp_residual,
            fused_block_attn.fused_window_block_attention,
            flash_window_attn.flash_window_attention_qkv,
            flash_window_attn.flash_window_attention,
            flash_window_attn.flash_attention)
HIGHEST = jax.lax.Precision.HIGHEST


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _ln(rng, c):
    return {"scale": 1 + 0.1 * _rand(rng, (c,)), "bias": 0.1 * _rand(rng, (c,))}


def _lin(rng, i, o):
    return {"kernel": _rand(rng, (i, o), i ** -0.5), "bias": _rand(rng, (o,))}


def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _assert_bar(got: torch.Tensor, want):
    """max and mean |got - want| within BAR of max and mean |want|."""
    assert got.dtype == torch.float32
    got, want = got.numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= BAR * np.abs(want).max(), d.max() / np.abs(want).max()
    assert d.mean() <= BAR * np.abs(want).mean(), d.mean() / np.abs(want).mean()


@pytest.fixture
def no_launch():
    """Every f32-tier wrapper's launch count is unchanged by the test."""
    before = [f.launches for f in WRAPPERS]
    yield
    assert [f.launches for f in WRAPPERS] == before


@pytest.mark.parametrize("epilogue", ["store", "residual", "gelu"])
@pytest.mark.parametrize("m,n,k", [(50, 192, 64), (7, 96, 384)])
def test_f32_gemm_plain_matches_jax_highest(m, n, k, epilogue, no_launch):
    rng = np.random.default_rng(m + n + k)
    lin = _lin(rng, k, n)
    a, res = _rand(rng, (m, k)), _rand(rng, (m, n))
    y = jnp.dot(jnp.asarray(a), jnp.asarray(lin["kernel"]),
                precision=HIGHEST) + jnp.asarray(lin["bias"])
    if epilogue == "residual":
        y = jnp.asarray(res) + y
    elif epilogue == "gelu":
        y = y * 0.5 * (1.0 + jax_erf(y * (2.0 ** -0.5), fast=False))
    got = f32_gemm.f32_gemm(torch.from_numpy(a), from_jax_params(lin),
                            epilogue, torch.from_numpy(res))
    _assert_bar(got, y)


@pytest.mark.parametrize("canvas", [None, (24, 24, 6, 0, 20, 17),
                                    (24, 24, 0, 6, 16, 16)],
                         ids=["rows", "rolled", "offset"])
def test_ln_rows_f32_plain_matches_pallas(canvas, no_launch):
    rng = np.random.default_rng(3)
    c = 96
    t = 2 * canvas[0] * canvas[1] if canvas else 200
    x, p = _rand(rng, (t, c), 3.0), _ln(rng, c)
    want = np.asarray(jax_row_ln(_jnp(p), jnp.asarray(x), interpret=True))
    got = f32_gemm.ln_rows_f32(torch.from_numpy(x),
                               {k: torch.from_numpy(v) for k, v in p.items()},
                               canvas)
    if canvas is not None:
        valid = fused_block_attn.pad_token_rows(canvas, t, "cpu").numpy()
        assert not got.numpy()[~valid].any() and (~valid).any()
        want = np.where(valid[:, None], want, 0.0)
    _assert_bar(got, want)


def _k2_chain(x, norm2, mlp):
    """The f32 K2's three launches, by their plain versions."""
    t = x.reshape(-1, x.shape[-1])
    h = f32_gemm.ln_rows_f32(t, norm2)
    h = f32_gemm.f32_gemm(h, mlp["fc1"], "gelu")
    return f32_gemm.f32_gemm(h, mlp["fc2"], "residual", t).reshape(x.shape)


@pytest.mark.parametrize("c", [64, 96, 192])
def test_fused_mlp_f32_chain_matches_pallas(c, no_launch):
    rng = np.random.default_rng(c)
    x = _rand(rng, (2, 8, 8, c))
    norm2, mlp = _ln(rng, c), {"fc1": _lin(rng, c, 4 * c),
                               "fc2": _lin(rng, 4 * c, c)}
    want = np.asarray(jax_mlp(jnp.asarray(x), _jnp(norm2), _jnp(mlp),
                              interpret=True))
    t = from_jax_params({"norm2": norm2, "mlp": mlp})
    tx = torch.from_numpy(x)
    _assert_bar(_k2_chain(tx, t["norm2"], t["mlp"]), want)
    _assert_bar(fused_mlp.fused_mlp_residual(tx, t["norm2"], t["mlp"]), want)


def _k1_chain(canvas, norm1, attn, ws, k_shift, heads, mask, h, w, origin):
    """The f32 K1's four launches, by their plain versions: LN1 rows with
    the pads zeroed, the qkv GEMM, the core on the canvas's windows, the
    proj GEMM with the residual."""
    b, hp, wp, c = canvas.shape
    x = canvas.reshape(-1, c)
    rows = f32_gemm.ln_rows_f32(x, norm1, (hp, wp, k_shift, origin, h, w))
    qkv = f32_gemm.f32_gemm(rows, attn["qkv"], "store")
    o = flash_window_attn.flash_window_attention_qkv(
        W.window_partition(qkv.reshape(b, hp, wp, 3 * c), ws),
        attn["cached_bias"], mask, heads)
    o = W.window_reverse(o, ws, hp, wp).reshape(-1, c)
    return f32_gemm.f32_gemm(o, attn["proj"], "residual", x).reshape(
        canvas.shape)


@pytest.mark.parametrize("shift,hw", [(0, (20, 17)), (6, (20, 17)),
                                      (6, (16, 16))],
                         ids=["unshifted", "rolled", "offset"])
def test_fused_block_attn_f32_chain_matches_pallas(shift, hw, no_launch):
    rng = np.random.default_rng(41 + shift + hw[0])
    heads, c, ws = 2, 64, 12
    h, w = hw
    p = {"norm1": _ln(rng, c),
         "attn": {"qkv": _lin(rng, c, 3 * c), "proj": _lin(rng, c, c),
                  "cached_bias": _rand(rng, (heads, 144, 144))}}
    x = torch.from_numpy(_rand(rng, (2, h, w, c)))
    canvas, k_shift, ids, origin = swin.fused_block_canvas(
        x, ws, shift, W.sw_msa_region_ids(24, 24, ws, ws // 2))
    assert bool(k_shift) == (shift and hw != (16, 16))
    assert bool(origin) == (hw == (16, 16))
    mask = W.dense_mask(ids)
    want = np.asarray(jax_fused_block(
        jnp.asarray(canvas.numpy()), _jnp(p["norm1"]), _jnp(p["attn"]), ws,
        k_shift, heads, None if mask is None else jnp.asarray(mask.numpy()),
        h, w, residual=True, interpret=True, origin=origin))
    tp = from_jax_params(p)
    args = (canvas, tp["norm1"], tp["attn"], ws, k_shift, heads, ids, h, w,
            origin)

    def crop(y):
        y = np.roll(np.asarray(y), (k_shift, k_shift), axis=(1, 2))
        return y[:, origin:origin + h, origin:origin + w]

    for got in (_k1_chain(*args),
                fused_block_attn.fused_window_block_attention(*args)):
        _assert_bar(torch.from_numpy(crop(got)), crop(want))


@pytest.mark.parametrize("masked", [False, True])
def test_flash_qkv_f32_matches_pallas(masked, no_launch):
    """K6 in f32 at swin_t's N = 49: two images of 2x2 windows, 3 heads."""
    rng = np.random.default_rng(7 + masked)
    heads, c = 3, 96
    qkv = _rand(rng, (8, 49, 3 * c))
    bias = _rand(rng, (heads, 49, 49), 3.0)
    ids = W.sw_msa_region_ids(14, 14, 7, 3) if masked else None
    mask = W.dense_mask(ids)
    want = jfwa.flash_window_attention_qkv(
        jnp.asarray(qkv), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask.numpy()), heads,
        interpret=True)
    got = flash_window_attn.flash_window_attention_qkv(
        torch.from_numpy(qkv), torch.from_numpy(bias), ids, heads)
    _assert_bar(got, want)


@pytest.mark.parametrize("b_,heads,n,d,nw", [(36, 4, 144, 32, 9),
                                             (4, 2, 16, 8, None)],
                         ids=["K7", "K8"])
def test_flash_window_attention_f32_matches_pallas(b_, heads, n, d, nw,
                                                   no_launch):
    rng = np.random.default_rng(b_ + n)
    q, k, v = (_rand(rng, (b_, heads, n, d)) for _ in range(3))
    bias = _rand(rng, (heads, n, n))
    mask = None if nw is None else np.where(
        rng.uniform(size=(nw, n, n)) < 0.3, -100.0, 0.0).astype(np.float32)
    want = jfwa.flash_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), interpret=True)
    got = flash_window_attn.flash_window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask))
    _assert_bar(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_f32_matches_pallas(causal, no_launch):
    """K8 through flash_attention: in f32 the causal addend is -1e9
    unrounded, as JAX casts the bias to q.dtype (the bf16 kernel's
    CAUSAL_NEG is -1e9 rounded to bf16)."""
    rng = np.random.default_rng(5 + causal)
    q, k, v = (_rand(rng, (4, 2, 16, 8)) for _ in range(3))
    want = jfwa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_window_attn.flash_attention(tq, tk, tv, causal=causal)
    _assert_bar(got, want)
    bias = flash_window_attn.causal_bias(tq, causal)
    assert bias.dtype == torch.float32
    assert float(bias.min()) == (-1e9 if causal else 0.0)
    assert flash_window_attn.CAUSAL_NEG != -1e9


@pytest.fixture
def tiny_t():
    cfg = dataclasses.replace(BiRefNetConfig.for_backbone("swin_v1_t"),
                              size=(64, 64))
    return cfg, build_param_tree(random_checkpoint(cfg, 7), cfg)


@pytest.fixture
def tf32_flags():
    """Set both TF32 flags on (as a caller might) and restore PyTorch's
    values after the test."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = True
    yield
    for f, v in zip(flags, saved):
        f.allow_tf32 = v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_infer_turns_tf32_off_for_f32_only(tiny_t, tf32_flags, monkeypatch,
                                           dtype):
    """An f32 forward runs with both TF32 flags off and gives the caller's
    values back; a bf16 forward leaves them alone."""
    cfg, params = tiny_t
    seen = []
    forward = birefnet.forward_logits

    def recording(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return forward(*args, **kw)

    monkeypatch.setattr(birefnet, "forward_logits", recording)
    infer = pipeline.make_infer_fn(
        params, cfg, ComputeConfig(dtype=dtype, deform_mode="regular"), "cpu")
    masks = infer(np.zeros((1, 64, 64, 3), np.uint8))
    assert masks.shape == (1, 64, 64)
    assert seen == [(False, False) if dtype == torch.float32 else (True, True)]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def test_serve_compute_config_runs_the_tier_for_either_dtype(monkeypatch):
    """The JAX serve's rule: the kernel tier on the card for either --dtype
    unless DISABLE_FLASH_ATTN is set; never on the CPU."""
    monkeypatch.delenv("DISABLE_FLASH_ATTN", raising=False)
    for dtype, want in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        on_card = serve.compute_config(dtype, cuda=True)
        assert on_card.dtype == want and on_card.use_flash_attention
        assert not serve.compute_config(dtype, cuda=False).use_flash_attention
    monkeypatch.setenv("DISABLE_FLASH_ATTN", "1")
    assert not serve.compute_config("float32", cuda=True).use_flash_attention


def test_int8_flags_on_the_f32_card_tier_are_refused(tmp_path, monkeypatch):
    """No longer refused (the W8A8 kernels take f32 activations): on the
    card make_infer_fn builds an f32 kernel-tier function with either int8
    flag, and serve.main runs --dtype float32 --int8-mlp --int8-attn
    through make_infer_fn with that policy and writes the masks. The
    refusal's helpers are gone."""
    from PIL import Image

    from birefnet_tpu_torch import params as P

    assert not hasattr(pipeline, "unsupported")
    assert not hasattr(fused_mlp, "INT8_F32_MISSING")
    monkeypatch.delenv("DISABLE_FLASH_ATTN", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for flags in ({"int8_mlp": True}, {"int8_attn": True},
                  {"int8_mlp": True, "int8_attn": True}):
        compute = serve.compute_config("float32", True, **flags)
        assert compute.dtype == torch.float32 and compute.use_flash_attention
        assert callable(pipeline.make_infer_fn({}, BiRefNetConfig(
            size=(64, 64)), compute))
    seen = []

    def fake_make_infer_fn(params, cfg, compute, device, out_size):
        seen.append((compute, torch.device(device).type, out_size))
        return lambda frames: torch.full(tuple(frames.shape[:3]), 7,
                                         dtype=torch.uint8)

    monkeypatch.setattr(pipeline, "make_infer_fn", fake_make_infer_fn)
    monkeypatch.setattr(P, "load_checkpoint", lambda path, cfg: {})
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    Image.fromarray(np.zeros((64, 64, 3), np.uint8), "RGB").save(
        img_dir / "a.png")
    rc = serve.main([str(img_dir), "--out", str(tmp_path / "m"),
                     "--checkpoint", "unused", "--size", "64", "--dtype",
                     "float32", "--int8-mlp", "--int8-attn"])
    assert rc == 0
    (compute, device, out_size), = seen
    assert (compute.dtype, compute.use_flash_attention, compute.int8_mlp,
            compute.int8_attn) == (torch.float32, True, True, True)
    assert (device, out_size) == ("cuda", (64, 64))
    m = np.asarray(Image.open(tmp_path / "m" / "a_mask.png"))
    assert m.shape == (64, 64) and int(m.max()) == 7
