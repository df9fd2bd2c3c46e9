#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (birefnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
2. build the CUDA kernels from birefnet_tpu_torch/csrc with nvcc (one nvcc
   process per source, all in parallel);
3. check each hand-written kernel against its plain PyTorch version on the
   same inputs at every shape the Swin-L 1024^2 batch-2 forward gives it
   (bound max|kernel - plain| <= 2e-2 * max|plain|), bf16 kernels on bf16
   weights and the W8A8 kernels (K1-int8, K3) on weights quantized from
   f32 by params.quantize_*_int8, those two also to a bound on
   mean|kernel - plain| / mean|plain|; time each kernel, its plain version
   and, where one PyTorch call computes the same function, that call;
   compute each call's bound (the larger of its bytes over 3.35 TB/s and
   the operations its real tokens need over the H100's published peak for
   their type);
4. drive both paths of pipeline.make_infer_fn (Swin-L, 1024^2, batch 2,
   bf16, kernel tier, regular deform mode, random_checkpoint(cfg, 0)) on
   uint8 frames, each with every launch count set to 0 just before it:
   the bf16 tier (48 / 0 / 48 / 0 / 16 / 1 launches of K1, K1-int8, K2,
   K3, row_ln, tap_conv) and the int8 main path, int8_mlp and int8_attn on
   (8 / 40 / 8 / 40 / 16 / 1); check each mask against the f32 plain
   pipeline on the card (mask MAE < 1e-3, TF32 off) and each call's
   backbone features against the f32 pipeline's (the int8 path's error at
   most FEATURE_RATIO times the bf16 tier's, and int8 scales rolled by one
   channel must break that bound: the masks of a random checkpoint barely
   see the backbone), print the int8 mask's difference from the bf16
   tier's, and check the f32 plain forward at 64^2 against the JAX
   package's committed golden logits;
5. serve 4 in-memory requests of different sizes through serve.segment on
   the bf16 tier and on the int8 path;
6. time the pipeline's images/s with CUDA events (median of 5 calls after
   warm-up) on the int8 path, the bf16 kernel tier and the plain bf16
   tier, in turns.

The line before the last is the nvidia-smi name/power line, the one
before it the JSON kernel report (`launches` from the int8 main path,
`launches_by_path` from both), the last line `{"ok": true, "device":
{...}}`. Without a CUDA device, or without the package beside this file,
it exits 1 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, SIZE, WS = 2, 1024, 12
# Swin-L stage geometry per backbone pass: (H of the stage, C, heads, depth).
STAGES = {"full": [(256, 192, 6, 2), (128, 384, 12, 2), (64, 768, 24, 18),
                   (32, 1536, 48, 2)],
          "half": [(128, 192, 6, 2), (64, 384, 12, 2), (32, 768, 24, 18),
                   (16, 1536, 48, 2)]}
BOUND = 2e-2
# The int8 kernels also hold mean|kernel - plain| / mean|plain| to a bound.
# Both sides sum exactly in integers, so they differ only where a LayerNorm
# or softmax sum in another order flips an int8 code: on the H100 at most
# 3.2e-4 for K1-int8 (its bf16 attention core feeds the proj quantization)
# and 1.0e-5 for K3. A copy of K1-int8 that skipped the bf16 rounding of
# the normed rows broke its bound at every shape, and copies of both that
# dequantized every 64th channel with its neighbour's scale broke theirs.
MEAN_BOUND_K1_I8, MEAN_BOUND_K3 = 1e-3, 1e-4
# Backbone features against the f32 plain pipeline's, mean|f - f32| /
# mean|f32| per stage tensor: the int8 path's worst at most FEATURE_RATIO
# times the bf16 kernel tier's in the same run (the H100 read 2.4x), and a
# tree whose int8 scales are rolled by one channel must break that bound.
FEATURE_RATIO = 4.0
# Published H100 SXM peaks (dense): memory bytes/s and operations/s by type.
MEM_RATE = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms over `reps` calls after one warm-up."""
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class KernelReport:
    """Per-kernel max error, and per forward (sum over shapes of the calls
    per forward times the per-call value): kernel, plain and library time,
    and the bound."""

    def __init__(self, name, route, source, replaces, wrapper, mean_bound=None):
        self.wrapper = wrapper
        self.mean_bound = mean_bound
        self.entry = {"name": name, "route": route, "source": source,
                      "replaces": replaces, "launches": None,
                      "launches_by_path": {}, "max_abs_err": 0.0,
                      "mean_rel_err": 0.0, "ms": 0.0,
                      "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None,
                      "library_ms": None}
        self.bytes_ms = self.ops_ms = 0.0

    def check(self, torch, label, calls, kernel_fn, plain_fn, work,
              crop=None, library_fn=None):
        """work = (bytes moved, {type: operations}) of one call."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if crop is not None:
            got, want = crop(got), crop(want)
        got, want = got.float(), want.float()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{self.entry['name']} {label}: shape {tuple(got.shape)} vs "
                 f"{tuple(want.shape)} or non-finite output")
        err = float((got - want).abs().max())
        bound = BOUND * float(want.abs().max())
        mean_rel = float((got - want).abs().mean() / want.abs().mean())
        ms, plain_ms = cuda_ms(torch, kernel_fn), cuda_ms(torch, plain_fn)
        byte_ms = work[0] / MEM_RATE * 1e3
        op_ms = sum(n / PEAK[kind] for kind, n in work[1].items()) * 1e3
        lib = ""
        if library_fn is not None:
            lib_ms = cuda_ms(torch, library_fn)
            lib = f"  library {lib_ms:.4f} ms"
            self.entry["library_ms"] = (self.entry["library_ms"] or 0.0) + \
                calls * lib_ms
        log(f"{self.entry['name']:<17} {label:<34} max|k-p| {err:.3e} "
            f"(bound {bound:.3e})  mean|k-p|/mean|p| {mean_rel:.3e}  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms{lib}  least "
            f"{max(byte_ms, op_ms):.4f} ms  x{calls}/forward")
        if not err <= bound:
            fail(f"{self.entry['name']} {label}: max|k-p| {err} > {bound}")
        if self.mean_bound is not None and not mean_rel <= self.mean_bound:
            fail(f"{self.entry['name']} {label}: mean|k-p|/mean|p| {mean_rel} "
                 f"> {self.mean_bound}")
        e = self.entry
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["mean_rel_err"] = max(e["mean_rel_err"], mean_rel)
        e["ms"] += calls * ms
        e["plain_ms"] += calls * plain_ms
        e["bound_ms"] += calls * max(byte_ms, op_ms)
        self.bytes_ms += calls * byte_ms
        self.ops_ms += calls * op_ms
        e["bound_by"] = "bytes" if self.bytes_ms >= self.ops_ms else "operations"


def check_kernels(torch, dev):
    import torch.nn.functional as F

    from birefnet_tpu_torch import params as P
    from birefnet_tpu_torch.models import swin
    from birefnet_tpu_torch.ops import window as W
    from birefnet_tpu_torch.ops.kernels import (fused_block_attn, fused_mlp,
                                                row_ln, tap_conv)

    gen = torch.Generator(dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def ln_params(c):
        return {"scale": 1 + 0.1 * randn((c,)), "bias": 0.1 * randn((c,))}

    def lin(i, o):
        return {"weight": randn((o, i), 0.05), "bias": 0.1 * randn((o,))}

    reports = {
        "fused_block_attn": KernelReport(
            "fused_block_attn", "cuda", "birefnet_tpu_torch/csrc/fused_block_attn.cu",
            "birefnet_tpu/ops/pallas/fused_block_attn.py:250",
            fused_block_attn.fused_window_block_attention),
        "fused_block_attn_int8": KernelReport(
            "fused_block_attn_int8", "cuda",
            "birefnet_tpu_torch/csrc/fused_block_attn.cu",
            "birefnet_tpu/ops/pallas/fused_block_attn.py:100",
            fused_block_attn.fused_window_block_attention_int8,
            MEAN_BOUND_K1_I8),
        "fused_mlp": KernelReport(
            "fused_mlp", "cuda", "birefnet_tpu_torch/csrc/fused_mlp.cu",
            "birefnet_tpu/ops/pallas/fused_mlp.py:166", fused_mlp.fused_mlp_residual),
        "fused_mlp_int8": KernelReport(
            "fused_mlp_int8", "cuda", "birefnet_tpu_torch/csrc/fused_mlp_i8.cu",
            "birefnet_tpu/ops/pallas/fused_mlp.py:186",
            fused_mlp.fused_mlp_residual_int8, MEAN_BOUND_K3),
        "row_ln": KernelReport(
            "row_ln", "triton", "birefnet_tpu_torch/ops/kernels/row_ln_triton.py",
            "birefnet_tpu/ops/pallas/row_ln.py:43", row_ln.layer_norm_rows),
        "tap_conv": KernelReport(
            "tap_conv", "cuda", "birefnet_tpu_torch/csrc/tap_conv.cu",
            "birefnet_tpu/ops/pallas/tap_conv.py:55", tap_conv.tap_conv_same),
    }
    k1, k1q = reports["fused_block_attn"], reports["fused_block_attn_int8"]
    k2, k3 = reports["fused_mlp"], reports["fused_mlp_int8"]
    k4, k5 = reports["row_ln"], reports["tap_conv"]

    for pass_name, stages in STAGES.items():
        for i, (h, c, heads, depth) in enumerate(stages):
            x = randn((BATCH, h, h, c), 1.0, bf)
            norm1 = ln_params(c)
            attn32 = {"qkv": lin(c, 3 * c), "proj": lin(c, c),
                      "cached_bias": randn((heads, WS * WS, WS * WS))}
            attn = P.cast_matmul_weights(attn32, bf)
            attn_q = P.cast_matmul_weights(
                P.quantize_attn_int8({"attn": attn32}, 0)["attn"], bf)
            hp = -(-h // WS) * WS
            cyclic_mask = W.sw_msa_mask(hp, hp, WS, WS // 2, dev)
            for shift in (0, WS // 2):
                canvas, k_shift, mask, origin = swin.fused_block_canvas(
                    x, WS, shift, cyclic_mask)
                route = ("offset" if origin else "roll") if shift else "unshifted"
                # Operations the function needs: qkv and proj (8 C^2) and
                # q k^T and P v over the window's WS^2 keys (4 WS^2 C) for
                # each real token. A pad token's normed row is zero, so its
                # k and v are the qkv bias and need no product, and its
                # output is cropped. Bytes stay those of the whole canvas.
                t = BATCH * h * h
                core = 4 * WS * WS * c * t
                side = nbytes(canvas, norm1["scale"], norm1["bias"],
                              attn["cached_bias"], mask) + canvas.numel() * 2

                def crop(y, k_shift=k_shift, origin=origin):
                    if k_shift:
                        y = W.roll_2d(y, k_shift, k_shift)
                    return y[:, origin:origin + h, origin:origin + h]

                for rep, p, kernel, plain, weights, ops in (
                        (k1, attn, fused_block_attn.fused_window_block_attention,
                         fused_block_attn.fused_window_block_attention_plain,
                         (attn["qkv"]["weight"], attn["qkv"]["bias"],
                          attn["proj"]["weight"], attn["proj"]["bias"]),
                         {"bf16": 8 * c * c * t + core}),
                        (k1q, attn_q,
                         fused_block_attn.fused_window_block_attention_int8,
                         fused_block_attn.fused_window_block_attention_int8_plain,
                         tuple(attn_q[n][k] for n in ("qkv", "proj")
                               for k in ("weight_q8", "scale_q8", "bias")),
                         {"int8": 8 * c * c * t, "bf16": core})):
                    if rep is k1q and c < P.INT8_MLP_MIN_CHANNELS:
                        continue
                    args = (canvas, norm1, p, WS, k_shift, heads, mask, h, h,
                            origin)
                    rep.check(torch, f"{pass_name} st{i} Hp={hp} C={c} {route}",
                              depth // 2,
                              lambda kernel=kernel, args=args: kernel(*args),
                              lambda plain=plain, args=args: plain(*args),
                              (side + nbytes(*weights), ops), crop)
            x2 = randn((BATCH * h * h, c), 1.0, bf)
            norm2 = ln_params(c)
            mlp32 = {"fc1": lin(c, 4 * c), "fc2": lin(4 * c, c)}
            mlp = P.cast_matmul_weights(mlp32, bf)
            mlp_q = P.cast_matmul_weights(
                P.quantize_mlp_int8({"mlp": mlp32}, 0)["mlp"], bf)
            t = x2.shape[0]
            side = 2 * nbytes(x2) + nbytes(norm2["scale"], norm2["bias"])
            k2.check(torch, f"{pass_name} st{i} T={t} C={c}", depth,
                     lambda: fused_mlp.fused_mlp_residual(x2, norm2, mlp),
                     lambda: fused_mlp.fused_mlp_residual_plain(x2, norm2, mlp),
                     (side + nbytes(*(mlp[n][k] for n in ("fc1", "fc2")
                                      for k in ("weight", "bias"))),
                      {"bf16": 16 * c * c * t}))
            if c >= P.INT8_MLP_MIN_CHANNELS:
                k3.check(torch, f"{pass_name} st{i} T={t} C={c}", depth,
                         lambda: fused_mlp.fused_mlp_residual_int8(x2, norm2, mlp_q),
                         lambda: fused_mlp.fused_mlp_residual_int8_plain(
                             x2, norm2, mlp_q),
                         (side + nbytes(*(mlp_q[n][k] for n in ("fc1", "fc2")
                                          for k in ("weight_q8", "scale_q8",
                                                    "bias"))),
                          {"int8": 16 * c * c * t}))
            # Row-LN sites: the stage-output norm, plus the patch-embed norm
            # before stage 0 and the patch-merge norm after stages 0-2.
            sites = [("stage norm", BATCH * h * h, c)]
            if i == 0:
                sites.append(("patch-embed norm", BATCH * h * h, c))
            if i < 3:
                sites.append(("patch-merge norm", BATCH * h * h // 4, 4 * c))
            for site, n, cc in sites:
                xr = randn((n, cc), 3.0, bf)
                p = ln_params(cc)
                pb = {k: v.to(bf) for k, v in p.items()}
                k4.check(torch, f"{pass_name} {site} [{n},{cc}]", 1,
                         lambda: row_ln.layer_norm_rows(p, xr),
                         lambda: row_ln.layer_norm_rows_plain(p, xr),
                         (2 * nbytes(xr) + nbytes(p["scale"], p["bias"]),
                          {"f32": 8 * n * cc}),
                         library_fn=lambda: F.layer_norm(
                             xr, (cc,), pb["scale"], pb["bias"], 1e-5))

    xi = randn((BATCH, SIZE, SIZE, 3), 1.0, bf)
    kk, kb = randn((5, 5, 3, 1), 0.2), randn((1,))
    xc = xi.permute(0, 3, 1, 2)  # channels-last NCHW view
    wc, bc = kk[..., 0].permute(2, 0, 1)[None].to(bf), kb.to(bf)
    k5.check(torch, f"[{BATCH},{SIZE},{SIZE},3]", 1,
             lambda: tap_conv.tap_conv_same(xi, kk, kb),
             lambda: tap_conv.tap_conv_same_plain(xi, kk, kb),
             (nbytes(xi, kk, kb) + BATCH * SIZE * SIZE * 2,
              {"f32": 2 * 75 * BATCH * SIZE * SIZE}),
             library_fn=lambda: F.conv2d(xc, wc, bc, padding=2))
    return reports


def with_features(bmodel, infer, frames):
    """infer(frames), and the backbone stage features its call computed
    (both passes), caught where models/birefnet.py calls swin_forward."""
    feats, swin_forward = [], bmodel.swin_forward

    def caught(*args, **kw):
        out = swin_forward(*args, **kw)
        feats.extend(out)
        return out

    bmodel.swin_forward = caught
    try:
        return infer(frames), feats
    finally:
        bmodel.swin_forward = swin_forward


def feature_error(path, feats, ref_feats) -> float:
    """Logs mean|f - ref| / mean|ref| per stage tensor; returns the largest."""
    if len(feats) != len(ref_feats):
        fail(f"{path}: {len(feats)} backbone features, want {len(ref_feats)}")
    rel = [float((f.float() - r).abs().mean() / r.abs().mean())
           for f, r in zip(feats, ref_feats)]
    log(f"phase 4: {path}: backbone features vs f32 plain pipeline, "
        f"mean|f - f32| / mean|f32| per stage (full pass, half pass): "
        + " ".join(f"{e:.3e}" for e in rel))
    return max(rel)


def drive(torch, bmodel, reports, infer, frames, want, path):
    """One make_infer_fn call with every count set to 0 just before it;
    checks the counts read just after against `want`. Returns the mask and
    the backbone features."""
    for r in reports.values():
        r.wrapper.launches = 0
    mask, feats = with_features(bmodel, infer, frames)
    torch.cuda.synchronize()
    counts = {name: r.wrapper.launches for name, r in reports.items()}
    log(f"phase 4: {path}: launches in one make_infer_fn call: {counts}")
    if counts != want:
        fail(f"{path} launch counts {counts} != {want}")
    for name, r in reports.items():
        r.entry["launches_by_path"][path] = counts[name]
    if tuple(mask.shape) != (BATCH, SIZE, SIZE) or not bool(
            torch.isfinite(mask).all()) or float(mask.min()) < 0 or float(
            mask.max()) > 1:
        fail(f"{path}: bad mask: shape {tuple(mask.shape)}, range "
             f"[{float(mask.min())}, {float(mask.max())}]")
    return mask, feats


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "birefnet_tpu_torch")):
        fail(f"birefnet_tpu_torch/ not found beside {__file__}")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.modules["jax"] = None  # the port must not reach for JAX
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"phase 1: {kind}, {torch.cuda.device_count()} device(s); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    from birefnet_tpu_torch import pipeline, serve
    from birefnet_tpu_torch.configs import BiRefNetConfig, ComputeConfig
    from birefnet_tpu_torch.models import birefnet as bmodel
    from birefnet_tpu_torch.ops.kernels import build
    from birefnet_tpu_torch.params import (build_param_tree, quantize_attn_int8,
                                           quantize_mlp_int8, random_checkpoint,
                                           to_device, tree_map)

    t0 = time.perf_counter()
    build.build(verbose=True)
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        reports = check_kernels(torch, dev)
    log("phase 3: every kernel within its bound at every slice shape")

    cfg = BiRefNetConfig.swin_l()
    params = build_param_tree(random_checkpoint(cfg, 0), cfg)
    frames = np.random.default_rng(42).integers(
        0, 256, size=(BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    frames_dev = torch.from_numpy(frames).to(dev)
    bf16 = ComputeConfig(dtype=torch.bfloat16, use_flash_attention=True)
    int8 = bf16.with_overrides(int8_mlp=True, int8_attn=True)
    names = list(reports)
    tiers = {"bf16": (bf16, dict(zip(names, (48, 0, 48, 0, 16, 1)))),
             "int8": (int8, dict(zip(names, (8, 40, 8, 40, 16, 1))))}
    ref, ref_feats = with_features(bmodel, pipeline.make_infer_fn(
        params, cfg, ComputeConfig(), dev, as_uint8=False), frames_dev)
    masks, feature_err = {}, {}
    for path, (compute, want) in tiers.items():
        infer = pipeline.make_infer_fn(params, cfg, compute, dev,
                                       as_uint8=False)
        masks[path], feats = drive(torch, bmodel, reports, infer, frames_dev,
                                   want, path)
        del infer
        mae = float((masks[path] - ref).abs().mean())
        log(f"phase 4: {path}: mask MAE vs f32 plain pipeline = {mae:.3e} "
            f"(gate < 1e-3)")
        if not mae < 1e-3:
            fail(f"{path} mask MAE {mae} >= 1e-3")
        feature_err[path] = feature_error(path, feats, ref_feats)
        del feats
    limit = FEATURE_RATIO * feature_err["bf16"]
    log(f"phase 4: int8 features' largest relative error {feature_err['int8']:.3e} "
        f"(gate <= {FEATURE_RATIO} x the bf16 tier's {feature_err['bf16']:.3e} "
        f"= {limit:.3e})")
    if not feature_err["int8"] <= limit:
        fail(f"int8 backbone features off by {feature_err['int8']} > {limit}")
    # Negative control: int8 scales rolled by one channel (every channel
    # dequantized with its neighbour's scale) must break the feature gate.
    rolled = tree_map(lambda k, v: torch.roll(v, 1) if k == "scale_q8" else v,
                      quantize_attn_int8(quantize_mlp_int8(params)))
    _, feats = with_features(bmodel, pipeline.make_infer_fn(
        rolled, cfg, bf16, dev, as_uint8=False), frames_dev)
    if not feature_error("rolled int8 scales", feats, ref_feats) > limit:
        fail("the feature gate does not see int8 scales rolled by one channel")
    del rolled, feats
    d = (masks["int8"] - masks["bf16"]).abs()
    log(f"phase 4: int8 vs bf16 kernel-tier masks: mean |diff| "
        f"{float(d.mean()):.3e}, max {float(d.max()):.3e} (not gated)")
    for r in reports.values():
        r.entry["launches"] = r.entry["launches_by_path"]["int8"]
    del ref, ref_feats, masks, d

    golden = os.path.join(ROOT, "tests", "goldens", "logits_jax.npy")
    golden_cfg = BiRefNetConfig.swin_l()
    params_golden = to_device(build_param_tree(random_checkpoint(golden_cfg, 7),
                                               golden_cfg), dev)
    xg = (np.random.default_rng(0).normal(size=(1, 64, 64, 3)) * 0.5).astype(
        np.float32)
    with torch.inference_mode():
        logits = bmodel.forward_logits(params_golden, golden_cfg,
                                       torch.from_numpy(xg).to(dev))
    diff = np.abs(logits.cpu().numpy() - np.load(golden))
    log(f"phase 4: f32 plain 64^2 logits vs JAX golden: max|diff| "
        f"{diff.max():.3e} (bound 5e-4)")
    if not diff.max() < 5e-4:
        fail(f"golden logits differ by {diff.max()}")
    del params_golden

    rng = np.random.default_rng(7)
    sizes = [(720, 1280), (1024, 1024), (480, 640), (1500, 900)]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    for path, (compute, _) in tiers.items():
        serve_infer = pipeline.make_infer_fn(params, cfg, compute, dev,
                                             out_size=(SIZE, SIZE))
        served = serve.segment(serve_infer, images, SIZE, BATCH)
        got = [m.shape for m in served]
        log(f"phase 5: {path}: served {len(served)} requests, mask shapes {got}")
        if got != sizes or any(m.dtype != np.uint8 for m in served):
            fail(f"{path}: served mask shapes {got} != {sizes}")
        del serve_infer

    fns = {"int8 path": pipeline.make_infer_fn(params, cfg, int8, dev),
           "bf16 kernel tier": pipeline.make_infer_fn(params, cfg, bf16, dev),
           "plain bf16": pipeline.make_infer_fn(
               params, cfg, ComputeConfig(dtype=torch.bfloat16), dev)}
    order = list(fns) + list(fns)[::-1]
    for name in order:
        fn = fns[name]
        ms = []
        fn(frames_dev)
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(frames_dev)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        med = sorted(ms)[len(ms) // 2]
        log(f"phase 6: {name}: median {med:.2f} ms per batch of {BATCH} -> "
            f"{BATCH / (med / 1e3):.2f} img/s ({smi})")

    print(json.dumps({"kernels": [r.entry for r in reports.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
