#!/usr/bin/env python3
"""Where the device time goes in one pipeline call of the PyTorch port.

    python3 tools/gpu_profile.py [--backbone swin_v1_l] [--tiers int8,bf16,plain]
                                 [--deform-mode regular] [--top 20]

For each tier, builds pipeline.make_infer_fn for the backbone (Swin-L by
default; swin_v1_t runs the ws=7 middle tier) at 1024^2, batch 2,
in --deform-mode (regular by default, the main path's mode; deformable
runs D1 at the decoder's 20 ASPP sites), random_checkpoint(cfg, 0) (the
chip_smoke.py paths:
"int8" = bf16 kernel tier with int8_mlp and int8_attn, "bf16" = bf16
kernel tier, "plain" = bf16 without kernels, "f32" = the f32 kernel tier,
"f32_int8" = the f32 kernel tier with both int8 flags, "plain_f32" = f32
without kernels), warms it up with two calls, then
records one call under torch.profiler (CPU and CUDA activities): first a
replay of the function's CUDA graph (make_infer_fn on the card captures
its body once per input shape), then one call of its eager body
(`.eager`). Prints, per tier and kind: the call's wall time (host clock
around the call and a synchronize), the summed device kernel time, the
device idle share (1 - kernel time / wall time; one stream, so kernels do
not overlap), the kernel time and launches grouped by what it belongs to,
and the top kernels. Then K5 (csrc/tap_conv.cu) alone at the main path's
[2, 1024, 1024, 3] bf16: event and device time per call beside F.conv2d's
(5x5, bf16 NCHW view) and its bounds. Then, for the backbone's 16
row-LayerNorm calls (K4, csrc/row_ln.cu) at
their bf16 shapes, the time per call by CUDA events (mean over 20
back-to-back calls, what a caller waits for) next to the profiler's device
time per call (the kernel alone), the same two for F.layer_norm on the
same input, and the call's byte bound: where event time is well above
device time, the host launch path, not the device, sets the call's time.
Then the int8 GEMM of K1-int8 (csrc/int8_gemm.cu) alone at the int8
path's 8 shapes, with the same two times and TOP/s, beside torch._int_mm's
(the s32 product only, without the dequant epilogue). Then K3
(csrc/fused_mlp_i8.cu) at its int8-path shapes: the call's event time and
device time (the LN2 row pass and the cluster kernel), the cluster kernel's
device time and TOP/s, beside torch._int_mm's two products.
Last, the bf16 GEMM of K1 and K2 (csrc/bf16_gemm.cu) alone at the bf16
tier's shapes (32 for Swin-L, 16 for swin_t), with the same two times and
TFLOP/s, beside F.linear's on the same bf16 operands.
With --deform-mode deformable, last, the deformable sites alone: per site
shape of the forward (C = 64 at 32^2 to 256^2, k = 1, 3, 7) in bf16, the
device time per call of the offset conv, the modulator conv and its
2*sigmoid, D1 (csrc/deform_im2col.cu), the contraction of the columns
(one torch.matmul), and the regular conv that regular mode runs instead,
with their sums per forward (20 sites).
Needs one CUDA device; exits 1 without one.
"""

import argparse
import os
import subprocess
import sys
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from birefnet_tpu_torch.utils.profiling import (  # noqa: E402
    device_ms_per_call, kernel_events, profiled)

# (group, substrings of the kernel name), first match wins. The shared
# window-attention core (csrc/window_core.cuh) runs as two template
# instantiations, named by their row layout: CanvasRows for K1 and K1-int8,
# StridedRows for K6 (and K7/K8). The wgmma GEMM of csrc/wgmma_ring.cuh is
# gemm_kernel<input type, epilogue, output type> (0 store, 1 residual, 2
# GELU): signed char for the int8 GEMM, __nv_bfloat16 for the bf16 one;
# float output for K1-int8 on f32 activations. K3 is the int8 row pass
# quant_rows_kernel<row type, LN, PAD> with LN and no PAD (K1-int8's rows
# are the other two forms), then fused_mlp_i8_kernel<activation type>, its
# cluster kernel. The row kernel of csrc/row_ln.cu is row_ln_kernel<type,
# caller>: 0 K4, 1 K2's LN2 rows, 2 K1's LN1 rows with the pads zeroed.
# The f32 tier runs f32_gemm_kernel<epilogue> (csrc/f32_gemm.cu), the f32
# core window_core_f32_kernel<F32CanvasRows | F32StridedRows, ...>
# (csrc/window_core_f32.cuh) and row_ln_kernel<float, caller>.
GROUPS = [
    ("D1 deform_im2col", ("deform_im2col_kernel",)),
    ("D1b deform_col2im", ("deform_col2im_kernel",)),
    ("K1 f32 attention core", ("F32CanvasRows",)),
    ("K6 f32 window attention", ("F32StridedRows",)),
    ("K1 f32 GEMM (qkv)", ("f32_gemm_kernel<0>",)),
    ("K1/K2 f32 GEMM + residual (proj, fc2)", ("f32_gemm_kernel<1>",)),
    ("K2 f32 GEMM + GELU (fc1)", ("f32_gemm_kernel<2>",)),
    ("K1 f32 LN1 rows (pads zeroed)", ("row_ln_kernel<float, 2>",)),
    ("K2 f32 LN2 rows", ("row_ln_kernel<float, 1>",)),
    ("K1 attention core (bf16 and int8 routes)", ("CanvasRows",)),
    ("K6 window attention (middle tier)", ("StridedRows",)),
    ("K1-int8 int8 GEMM, bf16 out (qkv)",
     ("gemm_kernel<signed char, 0, __nv_bfloat16>",)),
    ("K1-int8 int8 GEMM + residual (proj)",
     ("gemm_kernel<signed char, 1, __nv_bfloat16>",)),
    ("K1-int8 f32 int8 GEMM, f32 out (qkv)",
     ("gemm_kernel<signed char, 0, float>",)),
    ("K1-int8 f32 int8 GEMM + f32 residual (proj)",
     ("gemm_kernel<signed char, 1, float>",)),
    ("K3 f32 cluster kernel", ("fused_mlp_i8_kernel<float>",)),
    ("K3 cluster kernel (fc1, GELU, int8 hidden, fc2)",
     ("fused_mlp_i8_kernel",)),
    ("K3 LN2 row quantization",
     ("quant_rows_kernel<__nv_bfloat16, true, false>",
      "quant_rows_kernel<float, true, false>")),
    ("K1-int8 row quantization", ("quant_rows_kernel",)),
    ("K1 bf16 GEMM (qkv)", ("gemm_kernel<__nv_bfloat16, 0,",)),
    ("K1/K2 bf16 GEMM + residual (proj, fc2)",
     ("gemm_kernel<__nv_bfloat16, 1,",)),
    ("K2 bf16 GEMM + GELU (fc1)", ("gemm_kernel<__nv_bfloat16, 2,",)),
    ("K1 bf16 LN1 rows (pads zeroed)", ("row_ln_kernel<__nv_bfloat16, 2>",)),
    ("K2 bf16 LN2 rows", ("row_ln_kernel<__nv_bfloat16, 1>",)),
    ("K4 row_ln", ("row_ln_kernel",)),
    ("K5 tap_conv", ("tap_conv5_kernel",)),
    ("cuDNN convolutions", ("conv", "cudnn", "xmma_fprop", "dgrad", "wgrad")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "xmma", "gemv", "nvjet")),
    ("elementwise, copies, reductions", ("elementwise", "copy", "Memcpy",
                                         "Memset", "reduce", "cat", "roll",
                                         "index", "fill", "softmax", "norm")),
]


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def row_ln_sites(cfg):
    """The 16 row-LN calls of a 1024^2 batch-2 forward, ((site, [n, C])):
    per backbone pass (stage-0 side 256, then 128), the patch-embed norm,
    the four stage-output norms and the three patch-merge norms."""
    sites = []
    for pass_name, side in (("full", 256), ("half", 128)):
        ch = cfg.backbone_channels
        sites.append((f"{pass_name} patch-embed", (2 * side * side, ch[0])))
        for i, c in enumerate(ch):
            h = side >> i
            sites.append((f"{pass_name} st{i} norm", (2 * h * h, c)))
            if i < 3:
                sites.append((f"{pass_name} st{i} merge",
                              (2 * h * h // 4, 4 * c)))
    return sites


def event_ms_per_call(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def row_ln_table(torch, cfg, smi, reps=20):
    """K4 per call: CUDA-event and device time against F.layer_norm's."""
    import torch.nn.functional as F

    from birefnet_tpu_torch.ops.kernels import row_ln

    gen = torch.Generator("cuda").manual_seed(0)
    total = {"k_ev": 0.0, "k_dev": 0.0, "l_ev": 0.0, "l_dev": 0.0, "bound": 0.0}
    print(f"[profile] K4 row_ln per call, bf16, ms: kernel event / device, "
          f"F.layer_norm event / device, byte bound ({smi})", flush=True)
    for site, (n, c) in row_ln_sites(cfg):
        x = (torch.randn((n, c), generator=gen, device="cuda") * 3).to(
            torch.bfloat16)
        p = {"scale": torch.ones(c, device="cuda"),
             "bias": torch.zeros(c, device="cuda")}
        try:  # the f32 affine beside bf16 input where PyTorch takes it
            F.layer_norm(x, (c,), p["scale"], p["bias"], 1e-5)
            affine = p
        except RuntimeError:
            affine = {k: v.to(torch.bfloat16) for k, v in p.items()}
        kern = partial(row_ln.layer_norm_rows, p, x)
        lib = partial(F.layer_norm, x, (c,), affine["scale"], affine["bias"],
                      1e-5)
        row = {"k_ev": event_ms_per_call(torch, kern, reps),
               "k_dev": device_ms_per_call(kern, reps,
                                           lambda k: "row_ln_kernel" in k),
               "l_ev": event_ms_per_call(torch, lib, reps),
               "l_dev": device_ms_per_call(lib, reps,
                                           lambda k: "norm" in k.lower()),
               "bound": (2 * n * c * 2 + 8 * c) / 3.35e12 * 1e3}
        for key, v in row.items():
            total[key] += v
        print(f"[profile] K4 {site:<17} [{n},{c}]: {row['k_ev']:.4f} / "
              f"{row['k_dev']:.4f}   F.layer_norm {row['l_ev']:.4f} / "
              f"{row['l_dev']:.4f} ({affine['scale'].dtype} affine)   bound "
              f"{row['bound']:.4f}", flush=True)
    print(f"[profile] K4 per forward (16 calls): kernel {total['k_ev']:.4f} / "
          f"{total['k_dev']:.4f}, F.layer_norm {total['l_ev']:.4f} / "
          f"{total['l_dev']:.4f}, bound {total['bound']:.4f} ms ({smi})",
          flush=True)


def gemm_shapes(cfg, kind):
    """(label, M, N, K, epilogue) of the int8 or bf16 GEMMs of a 1024^2
    batch-2 forward: for a window-12 backbone K1-int8's or K1's qkv and
    proj on the window canvas, and K2's fc1 and fc2 on the real tokens
    (bf16 only: K3 runs its cluster kernel); each runs once per block. The
    int8 ones run at the stages with C >= 768 on the int8 path; the bf16
    ones at every stage on the bf16 tier (the int8 path keeps those of C <
    768)."""
    from birefnet_tpu_torch.params import INT8_MLP_MIN_CHANNELS

    ws = cfg.swin_config().window_size
    store = "bf16" if kind == "int8" else "store"
    shapes = []
    for pass_name, side in (("full", 256), ("half", 128)):
        for i, c in enumerate(cfg.backbone_channels):
            if kind == "int8" and c < INT8_MLP_MIN_CHANNELS:
                continue
            h = side >> i
            hp = -(-h // ws) * ws
            t, tc = 2 * h * h, 2 * hp * hp
            if ws == 12:
                shapes += [(f"{pass_name} st{i} qkv", tc, 3 * c, c, store),
                           (f"{pass_name} st{i} proj", tc, c, c, "residual")]
            if kind == "bf16":
                shapes += [(f"{pass_name} st{i} fc1", t, 4 * c, c, "gelu"),
                           (f"{pass_name} st{i} fc2", t, c, 4 * c,
                            "residual")]
    return shapes


def k3_table(torch, cfg, smi, reps=20):
    """K3 per call at the int8 path's shapes: the call's CUDA-event and
    device time (LN2 row pass and cluster kernel), the cluster kernel's
    device time and its rate, and torch._int_mm's event and device time
    for the two products (s32 only, no LayerNorm, GELU or quantization)."""

    from birefnet_tpu_torch import params as P
    from birefnet_tpu_torch.ops.kernels import fused_mlp

    gen = torch.Generator("cuda").manual_seed(0)
    print(f"[profile] K3 per call, us: call event / device, cluster kernel "
          f"device (TOP/s), _int_mm x2 event / device ({smi})", flush=True)
    total = [0.0] * 5
    for pass_name, side in (("full", 256), ("half", 128)):
        for i, c in enumerate(cfg.backbone_channels):
            if c < P.INT8_MLP_MIN_CHANNELS:
                continue
            h = side >> i
            t, depth = 2 * h * h, cfg.swin_config().depths[i]
            x = torch.randn((t, c), generator=gen, device="cuda").to(
                torch.bfloat16)
            mlp32 = {n: {"weight": torch.randn((o, k), generator=gen,
                                               device="cuda") * 0.05,
                         "bias": torch.zeros(o, device="cuda")}
                     for n, k, o in (("fc1", c, 4 * c), ("fc2", 4 * c, c))}
            mlp = P.quantize_mlp_int8({"mlp": mlp32}, 0)["mlp"]
            ln = {"scale": torch.ones(c, device="cuda"),
                  "bias": torch.zeros(c, device="cuda")}
            kern = partial(fused_mlp.fused_mlp_residual_int8, x, ln, mlp)
            q1 = torch.randint(-127, 128, (t, c), generator=gen, device="cuda",
                               dtype=torch.int8)
            q2 = torch.randint(-127, 128, (t, 4 * c), generator=gen,
                               device="cuda", dtype=torch.int8)
            w1, w2 = mlp["fc1"]["weight_q8"], mlp["fc2"]["weight_q8"]

            def lib(q1=q1, q2=q2, w1=w1, w2=w2):
                torch._int_mm(q1, w1.t())
                torch._int_mm(q2, w2.t())

            row = [event_ms_per_call(torch, kern, reps) * 1e3,
                   device_ms_per_call(kern, reps,
                                      lambda s: True) * 1e3,
                   device_ms_per_call(kern, reps,
                                      lambda s: "fused_mlp_i8_kernel" in s)
                   * 1e3,
                   event_ms_per_call(torch, lib, reps) * 1e3,
                   device_ms_per_call(lib, reps,
                                      lambda s: True) * 1e3]
            total = [a + depth * b / 1e3 for a, b in zip(total, row)]
            ops = 16 * c * c * t
            print(f"[profile] K3 {pass_name} st{i} [{t},{c}] x{depth}: "
                  f"{row[0]:.1f} / {row[1]:.1f}   cluster {row[2]:.1f} "
                  f"({ops / row[2] / 1e6:.0f})   _int_mm x2 {row[3]:.1f} / "
                  f"{row[4]:.1f}", flush=True)
    print(f"[profile] K3 per forward, ms: call {total[0]:.4f} / {total[1]:.4f}, "
          f"cluster kernel {total[2]:.4f}, _int_mm x2 {total[3]:.4f} / "
          f"{total[4]:.4f} ({smi})", flush=True)


def gemm_table(torch, cfg, smi, kind, reps=20):
    """The int8 or bf16 GEMM alone per shape: CUDA-event and device time,
    the rate on the device time, and the library call's two times on the
    same operands: torch._int_mm (the s32 product only, no dequant
    epilogue) or F.linear (the bf16 product and bias, no GELU or
    residual)."""
    import torch.nn.functional as F

    from birefnet_tpu_torch.ops.kernels import bf16_gemm, int8_gemm

    gen = torch.Generator("cuda").manual_seed(0)
    bf = torch.bfloat16
    unit, lib_name = ("TOP/s", "_int_mm") if kind == "int8" else ("TFLOP/s",
                                                                  "F.linear")
    print(f"[profile] {kind} GEMM per call, us: kernel event / device "
          f"({unit}), {lib_name} event / device ({unit}) ({smi})", flush=True)
    for label, m, n, k, epilogue in gemm_shapes(cfg, kind):
        res = (torch.zeros((m, n), device="cuda", dtype=bf)
               if epilogue == "residual" else None)
        if kind == "int8":
            q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                              dtype=torch.int8)
            w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                              dtype=torch.int8)
            lin = {"weight_q8": w,
                   "scale_q8": torch.full((n,), 1e-4, device="cuda"),
                   "bias": torch.zeros(n, device="cuda")}
            sx = torch.full((m, 1), 1e-2, device="cuda")
            kern = partial(int8_gemm.int8_gemm, q, sx, lin, epilogue, res)
            lib = partial(torch._int_mm, q, w.t())
        else:
            a = torch.randn((m, k), generator=gen, device="cuda").to(bf)
            lin = {"weight": (torch.randn((n, k), generator=gen, device="cuda")
                              * k ** -0.5).to(bf),
                   "bias": torch.zeros(n, device="cuda")}
            kern = partial(bf16_gemm.bf16_gemm, a, lin, epilogue, res)
            lib = partial(F.linear, a, lin["weight"], lin["bias"].to(bf))
        k_ev = event_ms_per_call(torch, kern, reps) * 1e3
        k_dev = device_ms_per_call(kern, reps,
                                   lambda s: "gemm_kernel" in s) * 1e3
        l_ev = event_ms_per_call(torch, lib, reps) * 1e3
        l_dev = device_ms_per_call(lib, reps,
                                   lambda s: True) * 1e3
        ops = 2 * m * n * k
        print(f"[profile] {kind} GEMM {label:<14} {epilogue:<8} "
              f"[{m},{k}]x[{n},{k}]: {k_ev:.1f} / {k_dev:.1f} "
              f"({ops / k_dev / 1e6:.0f})   {lib_name} {l_ev:.1f} / "
              f"{l_dev:.1f} ({ops / l_dev / 1e6:.0f})", flush=True)


def profile_call(torch, fn, frames, label, smi, top=20):
    """One call of fn(frames) under torch.profiler after two warm calls;
    prints wall time, device kernel time, idle share, the groups and the
    top kernels. Returns {"wall_ms", "device_ms", "idle", "groups":
    {group: [ms, launches]}}."""

    for _ in range(2):
        fn(frames)
    torch.cuda.synchronize()
    prof, wall_ms = profiled(partial(fn, frames))
    kernels = [(a.self_device_time_total / 1e3, a.count, a.key)
               for a in kernel_events(prof) if a.self_device_time_total > 0]
    total = sum(ms for ms, _, _ in kernels)
    idle = max(0.0, 1 - total / wall_ms)
    print(f"[profile] {label}: wall {wall_ms:.2f} ms per batch of "
          f"{frames.shape[0]}, device kernels {total:.2f} ms, idle share "
          f"{idle:.3f} ({smi})", flush=True)
    groups = {}
    for ms, n, name in kernels:
        g = groups.setdefault(group_of(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {label}:   {ms:9.3f} ms  {n:5d} launches  {g}")
    for ms, n, name in sorted(kernels, reverse=True)[:top]:
        print(f"[profile] {label}:   top {ms:9.3f} ms  x{n:<4d} {name[:110]}")
    return {"wall_ms": wall_ms, "device_ms": total, "idle": idle,
            "groups": groups}


def tap_conv_table(torch, smi, reps=20):
    """K5 at the main path's shape: CUDA-event and device time per call,
    F.conv2d's two times on the same bf16 operands, and the bounds.
    Returns the kernel's (event ms, device ms)."""
    import torch.nn.functional as F

    from birefnet_tpu_torch.ops.kernels import tap_conv

    gen = torch.Generator("cuda").manual_seed(0)
    b, h, w = 2, 1024, 1024
    x = torch.randn((b, h, w, 3), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((5, 5, 3, 1), generator=gen, device="cuda") * 0.2
    bias = torch.randn((1,), generator=gen, device="cuda")
    kern = partial(tap_conv.tap_conv_same, x, k, bias)
    wc = k[..., 0].permute(2, 0, 1)[None].to(torch.bfloat16)
    lib = partial(F.conv2d, x.permute(0, 3, 1, 2), wc,
                  bias.to(torch.bfloat16), padding=2)
    k_ev = event_ms_per_call(torch, kern, reps)
    k_dev = device_ms_per_call(kern, reps,
                               lambda s: "tap_conv5_kernel" in s)
    l_ev = event_ms_per_call(torch, lib, reps)
    l_dev = device_ms_per_call(lib, reps,
                               lambda s: True)
    byte_ms = (b * h * w * 3 * 2 + b * h * w * 2 + 76 * 4) / 3.35e12 * 1e3
    op_ms = 2 * 75 * b * h * w / 67e12 * 1e3
    print(f"[profile] K5 tap_conv [{b},{h},{w},3] bf16 per call, ms: kernel "
          f"event {k_ev:.4f} / device {k_dev:.4f}, F.conv2d event "
          f"{l_ev:.4f} / device {l_dev:.4f}, bound {max(byte_ms, op_ms):.5f} "
          f"(bytes {byte_ms:.5f}, f32 FMAs {op_ms:.5f}) ({smi})", flush=True)
    return k_ev, k_dev


def deform_table(torch, smi, reps=20):
    """The deformable sites alone in bf16: per (side, k) of a 1024^2
    batch-2 forward, the device time per call of each piece a deformable
    site runs (offset conv; modulator conv and 2*sigmoid; D1; the
    contraction) and of the regular conv, and their sums per forward."""
    import torch.nn.functional as F

    from birefnet_tpu_torch.ops import layers as L
    from birefnet_tpu_torch.ops.kernels import deform_im2col

    gen = torch.Generator("cuda").manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    names = ("offset conv", "modulator conv + 2 sigmoid", "D1 deform_im2col",
             "contraction (torch.matmul)", "regular conv")
    total = dict.fromkeys(names, 0.0)
    print(f"[profile] deformable sites, bf16, device ms per call: "
          f"{', '.join(names)} ({smi})", flush=True)
    for side in (32, 64, 128, 256):
        for k in (1, 3, 7):
            calls = (2 if k == 1 else 1) * (2 if side == 32 else 1)
            kk, pad = k * k, k // 2
            x = randn(2, side, side, 64).to(bf)
            off_p = {"weight": randn(2 * kk, 64, k, k, scale=0.05).to(bf),
                     "bias": randn(2 * kk)}
            mod_p = {"weight": randn(kk, 64, k, k, scale=0.05).to(bf),
                     "bias": randn(kk)}
            reg = {"weight": randn(256, 64, k, k, scale=0.05).to(bf)}
            offset = randn(2, side, side, 2 * kk, scale=3.0)
            mask = (2 * torch.rand((2, side, side, kk), generator=gen,
                                   device="cuda")).to(bf)
            cols = deform_im2col.deform_im2col(x, offset, mask, k, k, 1, pad)
            w_kc = reg["weight"].permute(2, 3, 1, 0).reshape(kk * 64, 256)
            fns = {
                "offset conv": lambda: L.conv2d(off_p, x, padding=pad).float(),
                "modulator conv + 2 sigmoid": lambda: (2.0 * torch.sigmoid(
                    L.conv2d(mod_p, x, padding=pad).float())).to(bf),
                "D1 deform_im2col": lambda: deform_im2col.deform_im2col(
                    x, offset, mask, k, k, 1, pad),
                "contraction (torch.matmul)": lambda: torch.matmul(cols, w_kc),
                "regular conv": lambda: L.conv2d(reg, x, padding=pad),
            }
            row = {n: device_ms_per_call(fns[n], reps,
                                         lambda name: True) for n in names}
            for n in names:
                total[n] += calls * row[n]
            print(f"[profile] deform [2,{side},{side},64] k={k} x{calls}: "
                  + "  ".join(f"{row[n]:.4f}" for n in names), flush=True)
    print(f"[profile] deformable sites per forward (20), ms: "
          + ", ".join(f"{n} {total[n]:.4f}" for n in names)
          + f"; a deformable site minus a regular one: "
          f"{sum(total[n] for n in names[:4]) - total['regular conv']:.4f} "
          f"({smi})", flush=True)
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--backbone", default="swin_v1_l",
                        choices=("swin_v1_t", "swin_v1_s", "swin_v1_b",
                                 "swin_v1_l"))
    parser.add_argument("--tiers", default="int8,bf16")
    parser.add_argument("--deform-mode", default="regular",
                        choices=("regular", "deformable"))
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from birefnet_tpu_torch import pipeline
    from birefnet_tpu_torch.configs import BiRefNetConfig, ComputeConfig
    from birefnet_tpu_torch.ops.kernels import build
    from birefnet_tpu_torch.params import build_param_tree, random_checkpoint

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[profile] {args.backbone}; {smi}; torch {torch.__version__}",
          flush=True)
    build.build()
    dev = torch.device("cuda")
    cfg = BiRefNetConfig.for_backbone(args.backbone)
    params = build_param_tree(random_checkpoint(cfg, 0), cfg)
    frames = torch.from_numpy(np.random.default_rng(42).integers(
        0, 256, size=(2, 1024, 1024, 3), dtype=np.uint8)).to(dev)
    kernel_tier = ComputeConfig(dtype=torch.bfloat16, use_flash_attention=True)
    tiers = {"int8": kernel_tier.with_overrides(int8_mlp=True, int8_attn=True),
             "bf16": kernel_tier,
             "plain": ComputeConfig(dtype=torch.bfloat16),
             "f32": ComputeConfig(use_flash_attention=True),
             "f32_int8": ComputeConfig(use_flash_attention=True,
                                       int8_mlp=True, int8_attn=True),
             "plain_f32": ComputeConfig()}
    tiers = {name: c.with_overrides(deform_mode=args.deform_mode)
             for name, c in tiers.items()}
    print(f"[profile] deform mode {args.deform_mode}", flush=True)
    for tier in args.tiers.split(","):
        infer = pipeline.make_infer_fn(params, cfg, tiers[tier], dev)
        profile_call(torch, infer, frames, f"{tier} graphed", smi, args.top)
        profile_call(torch, infer.eager, frames, f"{tier} eager", smi,
                     args.top)
        del infer
    tap_conv_table(torch, smi)
    row_ln_table(torch, cfg, smi)
    if cfg.swin_config().window_size == 12:
        gemm_table(torch, cfg, smi, "int8")
    k3_table(torch, cfg, smi)
    gemm_table(torch, cfg, smi, "bf16")
    if args.deform_mode == "deformable":
        deform_table(torch, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
