"""The int8 row pass and int8 GEMM entries (ops/kernels/int8_gemm.py) on
the CPU against the JAX package's W8A8 arithmetic.

On the CPU both entries take their plain versions. The JAX side is the
int8 kernels' own code: `_quantize_rows` of birefnet_tpu/ops/pallas/
fused_mlp.py after the LayerNorm that `_kernel_i8` computes (and, for the
block-attention canvas, the pad zeroing and the rounding to the tokens'
dtype of its int8 branch: bf16 for bf16 tokens, none for f32 ones), and
the i32 `dot_general` with the dequant of `_kernel_i8`, cast to bf16 or
left in f32.

Tolerances, and why: the LayerNorm rows are made so that every f32 sum is
exact in any order (multiples of 1/4 whose deviations cancel), and the
codes are compared exactly. The scales are held to one f32 ulp where the
rows are rounded to bf16 before the amax (or never normed), and to 8 ulp
for the unrounded f32 LayerNorm rows of K3's LN2 and of an f32 canvas
(K1-int8's LN1 at f32): XLA's rsqrt on the CPU and
PyTorch's differ by a few ulp, which moves amax(h) by as many (4 read
here) and flips no code at these rows. The GEMM's integer sum
is exact on both sides and its dequant rounds at the same points, so
its bf16 and f32 outputs are compared exactly. The f32 canvas's codes
are compared exactly too, and a control that rounds its rows to bf16
must change some of them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birefnet_tpu.ops.pallas.fused_mlp import _quantize_rows as jax_quantize_rows
from birefnet_tpu_torch.ops.kernels import int8_gemm


def _exact_rows(rng, t, k):
    """f32 rows, bf16-exact, whose sums are exact in any order."""
    half = rng.integers(-32, 33, (t, k // 2))
    d = np.concatenate([half, -half], 1) / 4
    d = np.take_along_axis(d, rng.random((t, k)).argsort(1), 1)
    m = rng.integers(-16, 17, (t, 1)) / 4
    return (m + d).astype(np.float32)


def _jax_ln(x, g, b):
    """The LayerNorm of `_kernel_i8` in f32."""
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + 1e-5) * g + b


def _valid(hp, wp, shift, origin, h_real, w_real):
    """Real tokens of the padded (rolled or offset) canvas, from first
    principles: canvas (r, c) holds the image's (r + shift, c + shift)."""
    r = (np.arange(hp) + shift) % hp
    c = (np.arange(wp) + shift) % wp
    vr = (r >= origin) & (r < origin + h_real)
    vc = (c >= origin) & (c < origin + w_real)
    return (vr[:, None] & vc[None, :]).reshape(-1)


@pytest.mark.parametrize("form", ["rows bf16", "rows f32", "ln", "ln canvas",
                                  "ln offset canvas", "ln canvas f32"])
def test_quantize_rows_matches_jax(form):
    rng = np.random.default_rng(len(form))
    k = 96
    canvas = {"ln canvas": (12, 12, 6, 0, 10, 10),
              "ln offset canvas": (12, 12, 0, 6, 5, 5),
              "ln canvas f32": (12, 12, 6, 0, 10, 10)}.get(form)
    f32 = form in ("rows f32", "ln canvas f32")
    t = 2 * 144 if canvas else 50
    if form.startswith("ln"):
        x = _exact_rows(rng, t, k)
        g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
        b = (0.1 * rng.standard_normal(k)).astype(np.float32)
        h = _jax_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
        ln = {"scale": torch.from_numpy(g), "bias": torch.from_numpy(b)}
    else:
        x = (2 * rng.standard_normal((t, k))).astype(np.float32)
        if form == "rows bf16":
            x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(
                jnp.float32))
        h, ln = jnp.asarray(x), None
    if canvas:
        valid = np.tile(_valid(*canvas), t // 144)
        h = jnp.where(jnp.asarray(valid)[:, None], h, 0.0)
        # The int8 branch's h.astype(tokens.dtype): a no-op for f32 tokens.
        h = h.astype(jnp.float32 if f32 else jnp.bfloat16).astype(jnp.float32)
    want_q, want_s = jax_quantize_rows(h)
    if f32 and canvas:
        # Control: the f32 rows rounded to bf16 give other codes.
        ctl_q, _ = jax_quantize_rows(h.astype(jnp.bfloat16).astype(jnp.float32))
        assert (np.asarray(ctl_q) != np.asarray(want_q)).any()
    tx = torch.from_numpy(x)
    if not f32:
        tx = tx.to(torch.bfloat16)
    n0 = int8_gemm.quantize_rows.launches
    q, s = int8_gemm.quantize_rows(tx, ln, canvas)
    # The CPU takes the plain version: no launch.
    assert int8_gemm.quantize_rows.launches == n0
    assert q.dtype == torch.int8 and tuple(s.shape) == (t, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(want_s),
                                    maxulp=8 if form in ("ln", "ln canvas f32")
                                    else 1)


@pytest.mark.parametrize("epilogue", ["bf16", "residual", "f32",
                                      "residual f32"])
@pytest.mark.parametrize("m,n,k", [(50, 64, 96), (7, 24, 384)])
def test_int8_gemm_matches_jax(epilogue, m, n, k):
    """The bf16 epilogues (qkv, proj + x of bf16 tokens) and the f32 ones
    (the same at f32 tokens: nothing rounded)."""
    rng = np.random.default_rng(m + n + k)
    q = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w = rng.integers(-127, 128, (n, k), dtype=np.int8)
    sx = ((0.5 + rng.random((m, 1))) / 127).astype(np.float32)
    sw = ((0.5 + rng.random(n)) / (127 * k ** 0.5)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(n)).astype(np.float32)
    res = (rng.standard_normal((m, n))).astype(np.float32)
    acc = jax.lax.dot_general(jnp.asarray(q), jnp.asarray(w.T),
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    f32 = epilogue.endswith("f32")
    jdt, tdt = ((jnp.float32, torch.float32) if f32
                else (jnp.bfloat16, torch.bfloat16))
    y = acc.astype(jnp.float32) * (jnp.asarray(sx) * jnp.asarray(sw))
    y = (y + jnp.asarray(bias)).astype(jdt)
    jres = jnp.asarray(res).astype(jdt)
    residual = epilogue.startswith("residual")
    want = np.asarray((jres + y if residual else y).astype(jnp.float32))
    lin = {"weight_q8": torch.from_numpy(w), "scale_q8": torch.from_numpy(sw),
           "bias": torch.from_numpy(bias)}
    tres = torch.from_numpy(res).to(tdt)
    got = int8_gemm.int8_gemm(torch.from_numpy(q), torch.from_numpy(sx), lin,
                              "residual" if residual else epilogue,
                              tres if residual else None)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_int8_gemm_gelu_epilogue_is_the_erf3_gelu():
    """The "gelu" epilogue is the 3-term erf GELU of the f32 dequant, f32
    out; an unknown epilogue is refused."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-127, 128, (9, 64), dtype=np.int8))
    lin = {"weight_q8": torch.from_numpy(rng.integers(-127, 128, (16, 64),
                                                      dtype=np.int8)),
           "scale_q8": torch.full((16,), 1e-3), "bias": torch.zeros(16)}
    sx = torch.full((9, 1), 1e-2)
    y = int8_gemm.int8_gemm(q, sx, lin, "gelu")
    assert y.dtype == torch.float32
    want = int8_gemm.quant.gelu_erf3(int8_gemm.quant.int8_linear(q, sx, lin))
    assert torch.equal(y, want)
    with pytest.raises(ValueError, match="epilogue"):
        int8_gemm.int8_gemm(q, sx, lin, "relu")
