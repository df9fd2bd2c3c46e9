"""K3's cluster split (csrc/fused_mlp_i8.cu) on the CPU: a plain PyTorch
emulation of how the kernel divides the W8A8 MLP among the CTAs of a
thread-block cluster, against the port's plain version and the JAX
package's `_fused_i8` in interpret mode.

The kernel gives CTA r of S the hidden units [W r, W r + W) (W = 384 on
the card, zero past 4C) and the output columns [O r, O r + O) (O = 96).
Each CTA runs fc1 and the GELU on its slice and takes its rows' max |h|;
the row amax is the max of the S slice maxima; each CTA quantizes its
slice with that row scale; fc2's output columns of a CTA are the sum over
the S slices of partial integer products, its two warpgroups taking
alternate pairs of 128-k steps, CTA r starting at its own slice (the k
order rotated by r). The emulation does the same in float64 (exact for
these integer sums) on weights from numpy seeds, for bf16 and f32
activations (the kernel's two instantiations: at f32 the last step adds
y + x unrounded, as the JAX kernel's f32 branch does).

Tolerances, and why: max and integer sums are exact in any order, so the
emulation equals `fused_mlp_residual_int8_plain` bit for bit. Against the
JAX kernel the bound is that of tests/test_torch_int8.py's
`test_fused_mlp_int8_plain_matches_pallas` (max |diff| <= 2e-2 plus one
bf16 ulp of the output, mean <= 1e-3), with the interpret-mode reciprocal
of the 3-term erf reproduced, for the LayerNorm sums of XLA and PyTorch
run in other orders and can flip an int8 code.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from birefnet_tpu import params as jparams
from birefnet_tpu.ops.pallas.fused_mlp import fused_mlp_residual as jax_mlp
import birefnet_tpu_torch as pt
from birefnet_tpu_torch.ops import layers as L
from birefnet_tpu_torch.ops import quant
from birefnet_tpu_torch.ops.kernels import fused_mlp

T = 96  # token rows: a tile of the JAX kernel, one and a half of the card's


def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


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


def _case(c, dtype="bf16"):
    """x [T, C] of `dtype`, the LN2 params and a W8A8 MLP quantized by the
    JAX package, as (torch x, torch tree, JAX x, JAX tree)."""
    rng = np.random.default_rng(c + 7)
    x = rng.normal(size=(T, c)).astype(np.float32)
    norm2 = {"scale": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
             "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}
    lin = {n: {"kernel": (0.05 * rng.normal(size=(i, o))).astype(np.float32),
               "bias": rng.normal(size=o).astype(np.float32)}
           for n, i, o in (("fc1", c, 4 * c), ("fc2", 4 * c, c))}
    jtree = {"norm2": _jnp(norm2), "mlp": jparams.quantize_mlp_int8(
        {"b": {"mlp": _jnp(lin)}}, c)["b"]["mlp"]}
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    return (torch.from_numpy(x).to(tdt), pt.from_jax_params(jtree),
            jnp.asarray(x).astype(jdt), jtree)


def split_mlp(x, norm2, mlp, clusters, width, out_width, k_step=128):
    """The W8A8 MLP as a cluster of `clusters` CTAs computes it: hidden
    slices of `width` units (zero past 4C), output groups of `out_width`
    columns, fc2's k steps of `k_step` units dealt to two warpgroups in
    pairs (stages of four steps, an even count of stages, steps past 4C
    zero), CTA r's order rotated by its slice's steps times r. Every
    hidden unit and output column is covered exactly once."""
    t, c = x.shape
    hidden = 4 * c
    assert clusters * width >= hidden and clusters * out_width >= c
    fc1, fc2 = mlp["fc1"], mlp["fc2"]
    q, sx = quant.quantize_rows(L.layer_norm(norm2, x.float()))
    slices, maxima = [], []
    for r in range(clusters):
        lo, hi = min(r * width, hidden), min((r + 1) * width, hidden)
        part = {k: fc1[k][lo:hi] for k in ("weight_q8", "scale_q8", "bias")}
        h = quant.gelu_erf3(quant.int8_linear(q, sx, part))
        h = torch.cat([h, torch.zeros((t, width - (hi - lo)))], 1)
        slices.append(h)
        maxima.append(h.abs().amax(-1, keepdim=True))
    scale = torch.clamp_min(torch.stack(maxima).amax(0), 1e-30) * (1.0 / 127.0)
    codes = torch.cat([torch.clamp(torch.round(h * (1.0 / scale)), -127.0, 127.0)
                       for h in slices], 1).double()
    w2 = torch.zeros((clusters * out_width, clusters * width),
                     dtype=torch.float64)
    w2[:c, :hidden] = fc2["weight_q8"].double()
    acc = torch.zeros((t, clusters * out_width), dtype=torch.float64)
    steps = -(-hidden // (8 * k_step)) * 8  # stages of four, an even count
    for r in range(clusters):
        cols = slice(r * out_width, (r + 1) * out_width)
        covered = torch.zeros(steps * k_step, dtype=torch.int64)
        for warpgroup in range(2):
            # Logical step s of stage s // 4 goes to warpgroup s % 4 // 2
            # and is k step (s + width / k_step * r) mod steps.
            for s in range(steps):
                if s % 4 // 2 != warpgroup:
                    continue
                p = (s + width // k_step * r) % steps
                ks = slice(p * k_step, (p + 1) * k_step)
                covered[ks] += 1
                if p * k_step < hidden:
                    acc[:, cols] += codes[:, ks] @ w2[cols, ks].t()
        assert bool((covered == 1).all())
    y = acc[:, :c].float() * (scale * fc2["scale_q8"]) + fc2["bias"]
    return x + y.to(x.dtype)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("clusters", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [64, 128])
def test_cluster_split_equals_plain_bitwise(c, clusters, dtype):
    x, tree, _, _ = _case(c, dtype)
    got = split_mlp(x, tree["norm2"], tree["mlp"], clusters, 4 * c // clusters,
                    c // clusters)
    want = fused_mlp.fused_mlp_residual_int8_plain(x, tree["norm2"],
                                                   tree["mlp"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("c", [64, 128])
def test_kernel_split_near_pallas(c, dtype, interpret_reciprocal):
    """The card's own split (cluster_size(C) CTAs of 384 hidden units and
    96 output columns, padded past 4C and C) against JAX `_fused_i8`, on
    bf16 and on f32 activations."""
    x, tree, jx, jtree = _case(c, dtype)
    got = split_mlp(x, tree["norm2"], tree["mlp"], fused_mlp.cluster_size(c),
                    fused_mlp.CLUSTER_SLICE, fused_mlp.CLUSTER_OUT)
    assert torch.equal(got, fused_mlp.fused_mlp_residual_int8_plain(
        x, tree["norm2"], tree["mlp"]))
    want = np.asarray(jax_mlp(jx, jtree["norm2"], jtree["mlp"],
                              interpret=True).astype(jnp.float32))
    d = np.abs(got.float().numpy() - want)
    assert d.max() <= 2e-2 + 2 ** -5, f"max |diff| {d.max()}"
    assert d.mean() <= 1e-3, f"mean |diff| {d.mean()}"


@pytest.mark.parametrize("c", range(64, 1537, 64))
def test_kernel_split_covers_every_width(c):
    """At every C the wrapper takes, the cluster fits the card's limit and
    its slices cover the hidden units and output columns, the last CTA's
    share nonempty; the fc2 stages of four 128-k steps split evenly into
    the two warpgroups' turns."""
    s = fused_mlp.cluster_size(c)
    assert 1 <= s <= fused_mlp.CLUSTER_MAX
    assert s * fused_mlp.CLUSTER_SLICE >= 4 * c > (s - 1) * fused_mlp.CLUSTER_SLICE
    assert s * fused_mlp.CLUSTER_OUT >= c > (s - 1) * fused_mlp.CLUSTER_OUT
    steps = 4 * c // 128
    assert steps * 128 == 4 * c
    turns = [[4 * g + 2 * w + u for g in range(-(-steps // 4)) for u in (0, 1)
              if 4 * g + 2 * w + u < steps] for w in (0, 1)]
    assert sorted(turns[0] + turns[1]) == list(range(steps))


def test_codes_entry_is_the_plain_chain():
    """fused_mlp_residual_int8_codes from the plain LN2 codes is
    fused_mlp_residual_int8_plain; the CPU launches nothing."""
    x, tree, _, _ = _case(64)
    codes, scales = quant.quantize_rows(L.layer_norm(tree["norm2"], x.float()))
    n0, n1 = (fused_mlp.fused_mlp_residual_int8_codes.launches,
              fused_mlp.fused_mlp_residual_int8.launches)
    got = fused_mlp.fused_mlp_residual_int8_codes(x, codes, scales, tree["mlp"])
    assert torch.equal(got, fused_mlp.fused_mlp_residual_int8_plain(
        x, tree["norm2"], tree["mlp"]))
    assert (fused_mlp.fused_mlp_residual_int8_codes.launches,
            fused_mlp.fused_mlp_residual_int8.launches) == (n0, n1)
