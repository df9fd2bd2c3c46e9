"""The bf16 pieces of K1 and K2 (ops/kernels/bf16_gemm.py, the plain
versions of ops/kernels/fused_mlp.py and fused_block_attn.py) on the CPU
against the JAX package's bf16 kernels.

On the CPU every wrapper takes its plain version, so these tests also check
that a CPU call launches nothing. The JAX side runs its Pallas kernels in
interpret mode: `_fused` of birefnet_tpu/ops/pallas/fused_mlp.py (K2) and
of fused_block_attn.py (K1), and `layer_norm_rows` of row_ln.py.

Tolerances, and why:
- K2 in bf16: the JAX kernel's 3-term erf takes `pl.reciprocal(approx=True)`,
  which interpret mode on the CPU evaluates as the f32 reciprocal of the
  bf16-rounded operand; the comparison reproduces it on the port's side
  (`interpret_reciprocal`). Both round at the same points and sum in f32 in
  other orders, so they differ only where a sum lands on a bf16 rounding
  boundary: at most one bf16 ulp of the largest output (2^-7 max|y|) and
  at most 1% of the outputs (0.12% read here). The exact-erf GELU
  (`F.gelu`) in its place moved 13-17% of the outputs by an ulp here, and
  must break this bound.
- The bf16 row pass: LayerNorm sums in another order flip a rare bf16
  rounding: each value within one ulp of its own magnitude (2^-7 |y|), at
  most 0.1% of them differ (0.003% read here), pad tokens exactly zero.
- K1 in bf16: the TPU kernel packs head groups and rounds exp(s - m) to
  bf16 before P v; the port keeps the softmax in f32 per head and its plain
  version rounds the qkv and proj products to bf16 before their biases
  (ops/layers.py::linear). That moves a quarter of the outputs, most by
  one ulp: max |diff| within two ulps of the largest output (2^-6 max|y|;
  up to 1.6 ulps, 8.3e-3 max|y|, read over six seeds here) and mean
  |diff| / mean |y| <= 3e-3 (at most 1.2e-3 read).
- The GEMM's plain version against JAX's f32 dot of the same bf16 operands:
  sums in another order, bf16 outputs within one ulp (2^-7 |y|), at most
  1% differing.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from birefnet_tpu.ops.pallas.fused_block_attn import (
    fused_window_block_attention as jax_fused_block)
from birefnet_tpu.ops.pallas.fused_mlp import fused_mlp_residual as jax_mlp
from birefnet_tpu.ops.pallas.row_ln import layer_norm_rows as jax_row_ln
from birefnet_tpu_torch.models import swin
from birefnet_tpu_torch.ops import quant
from birefnet_tpu_torch.ops import window as W
from birefnet_tpu_torch.ops.kernels import bf16_gemm, fused_block_attn, fused_mlp
from birefnet_tpu_torch.params import cast_matmul_weights, from_jax_params

ULP = 2.0 ** -7  # one bf16 ulp is at most this fraction of the value


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _ln(rng, c):
    return {"scale": 1 + 0.1 * _rand(rng, (c,)), "bias": 0.1 * _rand(rng, (c,))}


def _lin(rng, i, o):
    return {"kernel": _rand(rng, (i, o), 0.05), "bias": _rand(rng, (o,))}


def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _bf16(a):
    """f32 numpy of the bf16 rounding of a."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _assert_ulps(got, want, max_share):
    """Each value within one bf16 ulp of its magnitude; at most max_share
    of them differ."""
    got = np.asarray(got, np.float32)
    d = np.abs(got - want)
    assert (d <= ULP * np.abs(want)).all(), f"max |diff| {d.max()}"
    assert (d > 0).mean() <= max_share, f"{(d > 0).mean()} of values differ"


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


def _k2_error(got, want):
    """(max |diff| / max|want|, share of outputs that differ)."""
    d = np.abs(got.float().numpy() - want)
    return d.max() / np.abs(want).max(), (d > 0).mean()


@pytest.mark.parametrize("c", [96, 192])
def test_fused_mlp_bf16_plain_matches_pallas(c, interpret_reciprocal,
                                             monkeypatch):
    rng = np.random.default_rng(c)
    x = _rand(rng, (2, 8, 8, c))
    norm2, mlp = _ln(rng, c), {"fc1": _lin(rng, c, 4 * c),
                               "fc2": _lin(rng, 4 * c, c)}
    want = np.asarray(jax_mlp(jnp.asarray(x, jnp.bfloat16), _jnp(norm2),
                              _jnp(mlp), interpret=True).astype(jnp.float32))
    t = from_jax_params({"norm2": norm2, "mlp": mlp})
    tx = torch.from_numpy(x).bfloat16()
    n0 = fused_mlp.fused_mlp_residual.launches
    got = fused_mlp.fused_mlp_residual(tx, t["norm2"], t["mlp"])
    assert fused_mlp.fused_mlp_residual.launches == n0
    assert got.dtype == torch.bfloat16
    rel, share = _k2_error(got, want)
    assert rel <= ULP and share <= 1e-2, (rel, share)
    # Control: the exact-erf GELU in place of the JAX kernel's 3-term erf.
    monkeypatch.setattr(quant, "gelu_erf3", F.gelu)
    _, share = _k2_error(fused_mlp.fused_mlp_residual(tx, t["norm2"], t["mlp"]),
                         want)
    assert share > 1e-2, share


@pytest.mark.parametrize("n,c", [(200, 192), (392, 96), (50, 768)])
def test_ln_rows_plain_matches_pallas(n, c):
    rng = np.random.default_rng(n + c)
    x = _bf16(_rand(rng, (n, c), 3.0))
    p = {"scale": _rand(rng, (c,)), "bias": _rand(rng, (c,))}
    want = np.asarray(jax_row_ln(_jnp(p), jnp.asarray(x, jnp.bfloat16),
                                 interpret=True).astype(jnp.float32))
    n0 = bf16_gemm.ln_rows.launches
    got = bf16_gemm.ln_rows(torch.from_numpy(x).bfloat16(),
                            {k: torch.from_numpy(v) for k, v in p.items()})
    assert bf16_gemm.ln_rows.launches == n0
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, c)
    _assert_ulps(got.float().numpy(), want, 1e-3)


def _valid(hp, wp, shift, origin, h_real, w_real):
    """Real tokens of the padded (rolled or offset) canvas, from first
    principles: canvas (r, c) holds the image's (r + shift, c + shift)."""
    r = (np.arange(hp) + shift) % hp
    c = (np.arange(wp) + shift) % wp
    vr = (r >= origin) & (r < origin + h_real)
    vc = (c >= origin) & (c < origin + w_real)
    return (vr[:, None] & vc[None, :]).reshape(-1)


@pytest.mark.parametrize("canvas", [(24, 24, 6, 0, 20, 17),
                                    (24, 24, 0, 6, 16, 16)],
                         ids=["rolled", "offset"])
def test_ln_rows_plain_zeroes_pads(canvas):
    rng = np.random.default_rng(sum(canvas))
    c, t = 64, 2 * canvas[0] * canvas[1]
    x = _bf16(_rand(rng, (t, c), 3.0))
    p = {"scale": _rand(rng, (c,)), "bias": _rand(rng, (c,))}
    valid = np.tile(_valid(*canvas), 2)
    assert valid.sum() == 2 * canvas[4] * canvas[5]
    ln = np.asarray(jax_row_ln(_jnp(p), jnp.asarray(x, jnp.bfloat16),
                               interpret=True).astype(jnp.float32))
    want = np.where(valid[:, None], ln, 0.0)
    n0 = bf16_gemm.ln_rows.launches
    got = bf16_gemm.ln_rows(torch.from_numpy(x).bfloat16(),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            canvas).float().numpy()
    assert bf16_gemm.ln_rows.launches == n0
    assert not got[~valid].any()
    _assert_ulps(got, want, 1e-3)


def test_fused_block_attn_bf16_plain_matches_pallas():
    """K1 in bf16 at a shifted, rolled canvas (20 x 17 padded to 24 x 24)."""
    rng = np.random.default_rng(41)
    heads, c, h, w, ws = 6, 192, 20, 17, 12
    p = {"norm1": _ln(rng, c),
         "attn": {"qkv": _lin(rng, c, 3 * c), "proj": _lin(rng, c, c),
                  "cached_bias": _rand(rng, (heads, 144, 144))}}
    x = torch.from_numpy(_rand(rng, (2, h, w, c))).bfloat16()
    canvas, k_shift, mask, origin = swin.fused_block_canvas(
        x, ws, ws // 2, W.sw_msa_mask(24, 24, ws, ws // 2))
    assert k_shift and not origin
    jattn = _jnp(p["attn"])
    for name in ("qkv", "proj"):
        jattn[name]["kernel"] = jattn[name]["kernel"].astype(jnp.bfloat16)
    want = np.asarray(jax_fused_block(
        jnp.asarray(canvas.float().numpy(), jnp.bfloat16), _jnp(p["norm1"]),
        jattn, ws, k_shift, heads, jnp.asarray(mask.numpy()), h, w,
        residual=True, interpret=True, origin=origin).astype(jnp.float32))
    tp = from_jax_params(p)
    n0 = fused_block_attn.fused_window_block_attention.launches
    got = fused_block_attn.fused_window_block_attention(
        canvas, tp["norm1"], cast_matmul_weights(tp["attn"], torch.bfloat16),
        ws, k_shift, heads, mask, h, w, origin=origin)
    assert fused_block_attn.fused_window_block_attention.launches == n0
    assert got.dtype == torch.bfloat16
    got = W.roll_2d(got, k_shift, k_shift)[:, :h, :w].float().numpy()
    want = np.roll(want, (k_shift, k_shift), axis=(1, 2))[:, :h, :w]
    d = np.abs(got - want)
    assert d.max() <= 2 * ULP * np.abs(want).max(), d.max()
    assert d.mean() / np.abs(want).mean() <= 3e-3, d.mean()


def _gemm_case(rng, m, n, k):
    a = _bf16(_rand(rng, (m, k)))
    w = _bf16(_rand(rng, (n, k), k ** -0.5))
    bias = _rand(rng, (n,), 0.5)
    res = _bf16(_rand(rng, (m, n)))
    lin = {"weight": torch.from_numpy(w).bfloat16(),
           "bias": torch.from_numpy(bias)}
    return a, w, bias, res, lin


@pytest.mark.parametrize("epilogue", ["store", "residual"])
@pytest.mark.parametrize("m,n,k", [(50, 64, 96), (7, 24, 384)])
def test_bf16_gemm_plain_matches_jax(epilogue, m, n, k):
    rng = np.random.default_rng(m + n + k)
    a, w, bias, res, lin = _gemm_case(rng, m, n, k)
    y = jax.lax.dot_general(jnp.asarray(a, jnp.bfloat16),
                            jnp.asarray(w.T, jnp.bfloat16),
                            (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    y = (y + jnp.asarray(bias)).astype(jnp.bfloat16)
    if epilogue == "residual":
        y = jnp.asarray(res, jnp.bfloat16) + y
    want = np.asarray(y.astype(jnp.float32))
    n0 = bf16_gemm.bf16_gemm.launches
    got = bf16_gemm.bf16_gemm(torch.from_numpy(a).bfloat16(), lin, epilogue,
                              torch.from_numpy(res).bfloat16()
                              if epilogue == "residual" else None)
    assert bf16_gemm.bf16_gemm.launches == n0
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    _assert_ulps(got.float().numpy(), want, 1e-2)


def test_bf16_gemm_gelu_epilogue_is_the_erf3_gelu():
    """The "gelu" epilogue is bf16 of the 3-term erf GELU of the f32 sum plus
    bias; an unknown epilogue is refused."""
    rng = np.random.default_rng(5)
    a, w, bias, _, lin = _gemm_case(rng, 9, 16, 64)
    ta = torch.from_numpy(a).bfloat16()
    n0 = bf16_gemm.bf16_gemm.launches
    got = bf16_gemm.bf16_gemm(ta, lin, "gelu")
    assert bf16_gemm.bf16_gemm.launches == n0
    y = F.linear(torch.from_numpy(a), torch.from_numpy(w)) + torch.from_numpy(bias)
    assert torch.equal(got, quant.gelu_erf3(y).bfloat16())
    with pytest.raises(ValueError, match="epilogue"):
        bf16_gemm.bf16_gemm(ta, lin, "relu")
