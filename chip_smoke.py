#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (birefnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
2. build the CUDA kernels from birefnet_tpu_torch/csrc with nvcc;
3. check each hand-written kernel against its plain PyTorch version on the
   same bf16 inputs at every shape the Swin-L 1024^2 batch-2 forward gives
   it (bound max|kernel - plain| <= 2e-2 * max|plain|) and time both;
4. drive the main path, pipeline.make_infer_fn (Swin-L, 1024^2, batch 2,
   bf16, kernel tier, regular deform mode, random_checkpoint(cfg, 0)), on
   uint8 frames: count each kernel's launches in that one call (48 / 48 /
   16 / 1), check the masks against the f32 plain pipeline on the card
   (mask MAE < 1e-3, TF32 off), and check the f32 plain forward at 64^2
   against the JAX package's committed golden logits;
5. serve 4 in-memory requests of different sizes through serve.segment;
6. time the pipeline's images/s with CUDA events (median of 5 calls after
   warm-up) on the kernel tier and on the plain bf16 tier.

The line before the last is the JSON kernel report, the last line
`{"ok": true, "device": {...}}`. Without a CUDA device, or without the
package beside this file, it exits 1 and prints no result.
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


class KernelReport:
    """Per-kernel max error and time per forward (sum over shapes of the
    per-call time times the calls per forward at that shape)."""

    def __init__(self, name, route, source, replaces):
        self.entry = {"name": name, "route": route, "source": source,
                      "replaces": replaces, "launches": None,
                      "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}

    def check(self, torch, label, calls, kernel_fn, plain_fn, crop=None):
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
        ms, plain_ms = cuda_ms(torch, kernel_fn), cuda_ms(torch, plain_fn)
        log(f"{self.entry['name']:<17} {label:<34} max|k-p| {err:.3e} "
            f"(bound {bound:.3e})  kernel {ms:.4f} ms  plain {plain_ms:.4f} "
            f"ms  x{calls}/forward")
        if not err <= bound:
            fail(f"{self.entry['name']} {label}: max|k-p| {err} > {bound}")
        e = self.entry
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["ms"] += calls * ms
        e["plain_ms"] += calls * plain_ms


def check_kernels(torch, dev):
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

    k1 = KernelReport("fused_block_attn", "cuda",
                      "birefnet_tpu_torch/csrc/fused_block_attn.cu",
                      "birefnet_tpu/ops/pallas/fused_block_attn.py:250")
    k2 = KernelReport("fused_mlp", "cuda", "birefnet_tpu_torch/csrc/fused_mlp.cu",
                      "birefnet_tpu/ops/pallas/fused_mlp.py:166")
    k4 = KernelReport("row_ln", "triton",
                      "birefnet_tpu_torch/ops/kernels/row_ln_triton.py",
                      "birefnet_tpu/ops/pallas/row_ln.py:43")
    k5 = KernelReport("tap_conv", "cuda", "birefnet_tpu_torch/csrc/tap_conv.cu",
                      "birefnet_tpu/ops/pallas/tap_conv.py:55")

    for pass_name, stages in STAGES.items():
        for i, (h, c, heads, depth) in enumerate(stages):
            x = randn((BATCH, h, h, c), 1.0, bf)
            norm1 = ln_params(c)
            attn = {"qkv": {"weight": randn((3 * c, c), 0.05, bf),
                            "bias": 0.1 * randn((3 * c,))},
                    "proj": {"weight": randn((c, c), 0.05, bf),
                             "bias": 0.1 * randn((c,))},
                    "cached_bias": randn((heads, WS * WS, WS * WS))}
            hp = -(-h // WS) * WS
            cyclic_mask = W.sw_msa_mask(hp, hp, WS, WS // 2, dev)
            for shift in (0, WS // 2):
                canvas, k_shift, mask, origin = swin.fused_block_canvas(
                    x, WS, shift, cyclic_mask)
                args = (canvas, norm1, attn, WS, k_shift, heads, mask, h, h,
                        origin)
                route = ("offset" if origin else "roll") if shift else "unshifted"

                def crop(t, k_shift=k_shift, origin=origin):
                    if k_shift:
                        t = W.roll_2d(t, k_shift, k_shift)
                    return t[:, origin:origin + h, origin:origin + h]

                k1.check(torch, f"{pass_name} st{i} Hp={hp} C={c} {route}",
                         depth // 2,
                         lambda: fused_block_attn.fused_window_block_attention(*args),
                         lambda: fused_block_attn.fused_window_block_attention_plain(*args),
                         crop)
            x2 = randn((BATCH * h * h, c), 1.0, bf)
            norm2 = ln_params(c)
            mlp = {"fc1": {"weight": randn((4 * c, c), 0.05, bf),
                           "bias": 0.1 * randn((4 * c,))},
                   "fc2": {"weight": randn((c, 4 * c), 0.05, bf),
                           "bias": 0.1 * randn((c,))}}
            k2.check(torch, f"{pass_name} st{i} T={x2.shape[0]} C={c}", depth,
                     lambda: fused_mlp.fused_mlp_residual(x2, norm2, mlp),
                     lambda: fused_mlp.fused_mlp_residual_plain(x2, norm2, mlp))
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
                k4.check(torch, f"{pass_name} {site} [{n},{cc}]", 1,
                         lambda: row_ln.layer_norm_rows(p, xr),
                         lambda: row_ln.layer_norm_rows_plain(p, xr))

    xi = randn((BATCH, SIZE, SIZE, 3), 1.0, bf)
    kk, kb = randn((5, 5, 3, 1), 0.2), randn((1,))
    k5.check(torch, f"[{BATCH},{SIZE},{SIZE},3]", 1,
             lambda: tap_conv.tap_conv_same(xi, kk, kb),
             lambda: tap_conv.tap_conv_same_plain(xi, kk, kb))
    return {"fused_block_attn": (k1, fused_block_attn.fused_window_block_attention),
            "fused_mlp": (k2, fused_mlp.fused_mlp_residual),
            "row_ln": (k4, row_ln.layer_norm_rows),
            "tap_conv": (k5, tap_conv.tap_conv_same)}


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
    from birefnet_tpu_torch.params import (build_param_tree, random_checkpoint,
                                           to_device)

    t0 = time.perf_counter()
    build.build(verbose=True)
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        kernels = check_kernels(torch, dev)
    log("phase 3: every kernel within its bound at every slice shape")

    cfg = BiRefNetConfig.swin_l()
    params = build_param_tree(random_checkpoint(cfg, 0), cfg)
    frames = np.random.default_rng(42).integers(
        0, 256, size=(BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    frames_dev = torch.from_numpy(frames).to(dev)
    bf16 = ComputeConfig(dtype=torch.bfloat16, use_flash_attention=True)
    infer = pipeline.make_infer_fn(params, cfg, bf16, dev, as_uint8=False)
    for _, fn in kernels.values():
        fn.launches = 0
    mask = infer(frames_dev)
    torch.cuda.synchronize()
    want = {"fused_block_attn": 48, "fused_mlp": 48, "row_ln": 16, "tap_conv": 1}
    counts = {name: fn.launches for name, (_, fn) in kernels.items()}
    log(f"phase 4: launches in one make_infer_fn call: {counts}")
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    for name, (report, _) in kernels.items():
        report.entry["launches"] = counts[name]
    if tuple(mask.shape) != (BATCH, SIZE, SIZE) or not bool(
            torch.isfinite(mask).all()) or float(mask.min()) < 0 or float(
            mask.max()) > 1:
        fail(f"bad mask: shape {tuple(mask.shape)}, range "
             f"[{float(mask.min())}, {float(mask.max())}]")
    ref_infer = pipeline.make_infer_fn(params, cfg, ComputeConfig(), dev,
                                       as_uint8=False)
    ref = ref_infer(frames_dev)
    mae = float((mask - ref).abs().mean())
    log(f"phase 4: bf16 kernel-tier mask MAE vs f32 plain pipeline = {mae:.3e} "
        f"(gate < 1e-3)")
    if not mae < 1e-3:
        fail(f"mask MAE {mae} >= 1e-3")
    del ref_infer, ref

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

    serve_infer = pipeline.make_infer_fn(params, cfg, bf16, dev,
                                         out_size=(SIZE, SIZE))
    rng = np.random.default_rng(7)
    sizes = [(720, 1280), (1024, 1024), (480, 640), (1500, 900)]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    masks = serve.segment(serve_infer, images, SIZE, BATCH)
    got = [m.shape for m in masks]
    log(f"phase 5: served {len(masks)} requests, mask shapes {got}")
    if got != sizes or any(m.dtype != np.uint8 for m in masks):
        fail(f"served mask shapes {got} != {sizes}")

    plain = pipeline.make_infer_fn(params, cfg,
                                   ComputeConfig(dtype=torch.bfloat16), dev)
    fast = pipeline.make_infer_fn(params, cfg, bf16, dev)
    for name, fn in (("kernel tier", fast), ("plain bf16", plain),
                     ("kernel tier", fast)):
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

    print(json.dumps({"kernels": [r.entry for r, _ in kernels.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
