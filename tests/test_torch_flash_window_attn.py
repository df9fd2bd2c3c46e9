"""The window-attention kernel module (K6, K7, K8) on the CPU: the port's
plain versions against the JAX package's Pallas kernels in interpret mode,
on the same inputs made by numpy from a seed.

The wrappers take the plain version for a CPU tensor, so these tests also
check that a CPU call launches nothing. The CUDA kernel is checked against
the same plain versions on the card (test_torch_cuda.py).

Tolerances: f32 atol 2e-5 / rtol 1e-4 (sums in other orders). bf16: every
element within one bf16 ulp of the JAX value; both sides round at the same
points (q * bf16 scale, the bias and mask addends, the probabilities, the
output), so only an f32 sum in another order can move a value across a
rounding boundary.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from birefnet_tpu.ops import window as jwindow
from birefnet_tpu.ops.pallas import flash_window_attn as jfwa
from birefnet_tpu_torch.models import swin
from birefnet_tpu_torch.ops import window as W
from birefnet_tpu_torch.ops.attention import (qkv_window_attention,
                                              round_addends, window_attention)
from birefnet_tpu_torch.ops.kernels import flash_window_attn as fwa
from birefnet_tpu_torch.ops.kernels import fused_block_attn
from birefnet_tpu_torch.params import cast_matmul_weights, from_jax_params

TOL = dict(atol=2e-5, rtol=1e-4)
WRAPPERS = (fwa.flash_window_attention_qkv, fwa.flash_window_attention,
            fwa.flash_attention)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _assert_within_one_bf16_ulp(got: torch.Tensor, want: np.ndarray):
    got = got.float().numpy()
    mag = np.maximum(np.abs(want), np.float32(2.0 ** -126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    over = np.abs(got - want) > ulp
    assert not over.any(), (f"{over.sum()} of {over.size} elements off by "
                            f"more than one bf16 ulp, max |diff| "
                            f"{np.abs(got - want).max()}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ws", [7, 12])
def test_flash_qkv_plain_matches_pallas(ws, masked, dtype):
    """K6 on the packed [B_, N, 3C] projection at N = 49 and 144: two
    images of 2x2 windows, 2 heads of 32."""
    rng = np.random.default_rng(ws + masked)
    n, heads, c = ws * ws, 2, 64
    qkv = _rand(rng, (8, n, 3 * c))
    bias = _rand(rng, (heads, n, n), 3.0)
    mask = W.sw_msa_mask(2 * ws, 2 * ws, ws, ws // 2).numpy() if masked else None
    jdt = jnp.dtype(dtype)
    want = np.asarray(jfwa.flash_window_attention_qkv(
        jnp.asarray(qkv, jdt), jnp.asarray(bias, jdt),
        None if mask is None else jnp.asarray(mask, jdt), heads,
        interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    before = [f.launches for f in WRAPPERS]
    got = fwa.flash_window_attention_qkv(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), heads)
    assert [f.launches for f in WRAPPERS] == before
    assert got.shape == (8, n, c) and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        _assert_within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("b_,heads,n,d,nw", [
    (4, 2, 16, 8, None),     # test_simple_bias
    (36, 4, 144, 32, 9),     # test_swin_l_stage0_shape / shifted mask
    (8, 2, 16, 8, 4),        # test_mask_period_batching
])
def test_flash_window_attention_plain_matches_pallas(b_, heads, n, d, nw):
    """K7 (masked) and K8 (unmasked) at the JAX package's test shapes."""
    rng = np.random.default_rng(b_ + n)
    q, k, v = (_rand(rng, (b_, heads, n, d)) for _ in range(3))
    bias = _rand(rng, (heads, n, n))
    mask = None
    if nw is not None:
        mask = np.where(rng.uniform(size=(nw, n, n)) < 0.3, -100.0,
                        0.0).astype(np.float32)
    want = np.asarray(jfwa.flash_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), interpret=True))
    before = [f.launches for f in WRAPPERS]
    got = fwa.flash_window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask))
    assert [f.launches for f in WRAPPERS] == before
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_plain_matches_pallas(causal):
    """K8 through the bias-free entry point, (4, 2, 16, 8)."""
    rng = np.random.default_rng(5 + causal)
    q, k, v = (_rand(rng, (4, 2, 16, 8)) for _ in range(3))
    want = np.asarray(jfwa.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, interpret=True))
    before = [f.launches for f in WRAPPERS]
    got = fwa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    assert [f.launches for f in WRAPPERS] == before
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_wrappers_refuse_other_devices():
    x = torch.zeros((2, 49, 96), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fwa.flash_window_attention_qkv(x, x[0, :1], None, 1)
    q = torch.zeros((2, 1, 16, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fwa.flash_attention(q, q, q)


# The kernel tier's form of the SW-MSA mask, built once: [nW, N] int32
# region ids (cached per geometry). Fed to the plain versions they must
# give bitwise the outputs of the dense f32 mask rounded by round_addends,
# and the JAX interpret-mode kernel's within one bf16 ulp.
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("ws", [7, 12])
def test_region_ids_give_the_rounded_mask(ws, offset):
    hp, shift, heads, c = 2 * ws, ws // 2, 2, 64
    n = ws * ws
    ids = W.sw_msa_region_ids(hp, hp, ws, shift, offset=offset)
    assert ids is W.sw_msa_region_ids(hp, hp, ws, shift, offset=offset)
    assert ids.dtype == torch.int32 and ids.shape == (4, n)
    jmask = (jwindow.sw_msa_mask_offset if offset else jwindow.sw_msa_mask)(
        hp, hp, ws, shift)
    dense = (W.sw_msa_mask_offset if offset else W.sw_msa_mask)(hp, hp, ws,
                                                                shift)
    np.testing.assert_array_equal(W.region_mask(ids).numpy(), jmask)
    assert torch.equal(W.dense_mask(ids), dense)

    rng = np.random.default_rng(20 + ws + offset)
    qkv = _rand(rng, (8, n, 3 * c))
    bias = _rand(rng, (heads, n, n), 3.0)
    qkv_t = torch.from_numpy(qkv).bfloat16()
    bias_t = torch.from_numpy(bias)
    want = qkv_window_attention(qkv_t, *round_addends(torch.bfloat16, bias_t,
                                                      dense), heads)
    got = fwa.flash_window_attention_qkv(qkv_t, bias_t, ids, heads)
    assert torch.equal(got, want)
    q, k, v = qkv_t.view(8, n, 3, heads, 32).permute(2, 0, 3, 1, 4)
    assert torch.equal(
        fwa.flash_window_attention(q, k, v, bias_t, ids),
        window_attention(q, k, v, *round_addends(torch.bfloat16, bias_t,
                                                 dense)))
    if ws == 7:
        ref = np.asarray(jfwa.flash_window_attention_qkv(
            jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16),
            jnp.asarray(jmask, jnp.bfloat16), heads,
            interpret=True).astype(jnp.float32))
        _assert_within_one_bf16_ulp(got, ref)


@pytest.mark.parametrize("hw", [(20, 17), (16, 16)])
def test_block_canvas_keeps_the_mask_form(hw):
    """fused_block_canvas gives the offset mask in the form it was given
    (region ids or dense), and K1's plain version gives bitwise the same
    block output from either (the roll and the offset partition)."""
    rng = np.random.default_rng(30 + hw[1])
    h, w = hw
    ws, heads, c = 12, 2, 64
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    p = from_jax_params({
        "norm1": {"scale": 1 + 0.1 * _rand(rng, (c,)),
                  "bias": 0.1 * _rand(rng, (c,))},
        "attn": {"qkv": {"kernel": _rand(rng, (c, 3 * c), 0.05),
                         "bias": _rand(rng, (3 * c,))},
                 "proj": {"kernel": _rand(rng, (c, c), 0.05),
                          "bias": _rand(rng, (c,))},
                 "cached_bias": _rand(rng, (heads, 144, 144))}})
    attn = cast_matmul_weights(p["attn"], torch.bfloat16)
    x = torch.from_numpy(_rand(rng, (2, h, w, c))).bfloat16()
    outs = []
    for mask in (W.sw_msa_mask(hp, wp, ws, 6),
                 W.sw_msa_region_ids(hp, wp, ws, 6)):
        canvas, k_shift, k_mask, origin = swin.fused_block_canvas(x, ws, 6,
                                                                  mask)
        assert W.is_region_ids(k_mask) == W.is_region_ids(mask)
        outs.append(fused_block_attn.fused_window_block_attention(
            canvas, p["norm1"], attn, ws, k_shift, heads, k_mask, h, w,
            origin=origin))
    assert origin == (6 if hw == (16, 16) else 0)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("causal", [False, True])
def test_causal_flag_matches_causal_bias(causal):
    """The kernel's causal flag adds CAUSAL_NEG where a key lies after its
    query: the same addend as causal_bias, so the plain version fed that
    addend as a mask gives bitwise flash_attention's plain output, which
    matches the JAX interpret-mode kernel."""
    rng = np.random.default_rng(40 + causal)
    n, heads = 16, 2
    q, k, v = (_rand(rng, (4, heads, n, 8)) for _ in range(3))
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    i = torch.arange(n)
    flag = torch.where((i[None, :] > i[:, None]) & causal, fwa.CAUSAL_NEG, 0.0)
    assert torch.equal(flag.bfloat16().expand(heads, n, n),
                       fwa.causal_bias(qt, causal))
    got = window_attention(qt, kt, vt, torch.zeros((heads, n, n)), flag[None])
    assert torch.equal(got, fwa.flash_attention(qt, kt, vt, causal))
    want = np.asarray(jfwa.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        interpret=True).astype(jnp.float32))
    _assert_within_one_bf16_ulp(got, want)


# Shapes past the kernel's first core (N > 256, head dims above 64 or not a
# multiple of 8): the key-tiled core takes them on the card with the same
# plain versions, which must still match the JAX entry points. (kind, B_,
# heads, N, d, nW): K7 masked at N = 300, d = 40; K8 with a bias at
# N = 576, d = 72; flash_attention causal at N = 1024, d = 16.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,b_,heads,n,d,nw", [
    ("masked", 2, 2, 300, 40, 2), ("bias", 1, 2, 576, 72, None),
    ("causal", 1, 2, 1024, 16, None)])
def test_plain_matches_pallas_past_the_first_core(kind, b_, heads, n, d, nw,
                                                  dtype):
    rng = np.random.default_rng(n + d)
    q, k, v = (_rand(rng, (b_, heads, n, d)) for _ in range(3))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    before = [f.launches for f in WRAPPERS]
    if kind == "causal":
        want = jfwa.flash_attention(jq, jk, jv, causal=True, interpret=True)
        got = fwa.flash_attention(tq, tk, tv, causal=True)
    else:
        bias = _rand(rng, (heads, n, n))
        mask = None if nw is None else np.where(
            rng.uniform(size=(nw, n, n)) < 0.3, -100.0, 0.0).astype(np.float32)
        want = jfwa.flash_window_attention(
            jq, jk, jv, jnp.asarray(bias, jdt),
            None if mask is None else jnp.asarray(mask, jdt), interpret=True)
        got = fwa.flash_window_attention(
            tq, tk, tv, torch.from_numpy(bias),
            None if mask is None else torch.from_numpy(mask))
    assert [f.launches for f in WRAPPERS] == before
    assert got.shape == (b_, heads, n, d) and got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        # One bf16 ulp of each value, or of max|want| / 4 where P v's f32
        # sum over hundreds of keys cancels to near zero (a sum in another
        # order moves such a value by more than its own ulp).
        diff = np.abs(got.float().numpy() - want)
        floor = 2.0 ** -9 * np.abs(want).max()
        mag = np.maximum(np.abs(want), np.float32(2.0 ** -126))
        over = diff > np.maximum(np.exp2(np.floor(np.log2(mag)) - 7), floor)
        assert not over.any(), (f"{over.sum()} of {over.size} elements off, "
                                f"max |diff| {diff.max()}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [20, 36, 3])
def test_head_dim_padding_is_exact(d, dtype):
    """A head dim the kernel pads to a multiple of 8: pad_head_dim gives
    contiguous copies whose extra columns are zero, so q k^T is unchanged
    (bitwise, on integer-valued inputs whose sums are exact in any order),
    and head_dim_scale(d) is the true d's d^-0.5 as the plain version
    multiplies q by it, not the padded width's. The padded kernel is held
    against the unpadded plain version on the card."""
    rng = np.random.default_rng(50 + d)
    b_, heads, n = 4, 2, 49
    q, k, v = (torch.from_numpy(rng.integers(-4, 5, (b_, heads, n, d))
                                .astype(np.float32)).to(dtype)
               for _ in range(3))
    padded = [fwa.pad_head_dim(t) for t in (q, k, v)]
    dp = fwa.padded_head_dim(d)
    assert dp % 8 == 0 and d <= dp < d + 8
    assert all(p.shape == (b_, heads, n, dp) and p.is_contiguous()
               and not p[..., d:].any() and torch.equal(p[..., :d], t)
               for p, t in zip(padded, (q, k, v)))
    assert torch.equal(padded[0].float() @ padded[1].float().mT,
                       q.float() @ k.float().mT)
    assert fwa.head_dim_scale(d, dtype) == float(
        torch.tensor(d ** -0.5, dtype=dtype))
    assert fwa.head_dim_scale(d, dtype) != fwa.head_dim_scale(dp, dtype)


@pytest.mark.parametrize("d", [8, 72, 128, 160, 256, 264, 1000])
def test_column_slices_cover_the_head_dim(d):
    """One launch per slice of at most 128 output columns: the slices are
    contiguous, start at 0, end at d and overlap nowhere."""
    slices = fwa.column_slices(d)
    assert slices[0][0] == 0 and slices[-1][1] == d
    assert all(0 < c1 - c0 <= fwa.SLICE for c0, c1 in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert len(slices) == -(-d // fwa.SLICE)
