#!/usr/bin/env python3
"""Where the device time goes in one pipeline call of the PyTorch port.

    python3 tools/gpu_profile.py [--backbone swin_v1_l] [--tiers int8,bf16,plain]
                                 [--top 20]

For each tier, builds pipeline.make_infer_fn for the backbone (Swin-L by
default; swin_v1_t runs the ws=7 middle tier) at 1024^2, batch 2, bf16,
regular deform mode, random_checkpoint(cfg, 0) (the chip_smoke.py paths:
"int8" = kernel tier with int8_mlp and int8_attn, "bf16" = kernel tier,
"plain" = no kernels), warms it up with two calls, then
records one call under torch.profiler (CPU and CUDA activities). Prints,
per tier: the call's wall time (host clock around the call and a
synchronize), the summed device kernel time, the device idle share
(1 - kernel time / wall time; one stream, so kernels do not overlap),
the kernel time grouped by what it belongs to, and the top kernels.
Needs one CUDA device; exits 1 without one.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (group, substrings of the kernel name), first match wins. The shared
# window-attention core (csrc/window_core.cuh) runs as two template
# instantiations, named by their row layout: CanvasRows for K1 and K1-int8,
# StridedRows for K6 (and K7/K8).
GROUPS = [
    ("K1 attention core (bf16 and int8 routes)", ("CanvasRows",)),
    ("K6 window attention (middle tier)", ("StridedRows",)),
    ("K1-int8/K3 int8 GEMM, bf16 out (qkv)", ("i8::gemm_kernel<0>",)),
    ("K1-int8/K3 int8 GEMM + residual (proj, fc2)", ("i8::gemm_kernel<1>",)),
    ("K3 int8 GEMM + GELU (fc1)", ("i8::gemm_kernel<2>",)),
    ("K1-int8/K3 row quantization", ("quant_rows_kernel",)),
    ("K1 bf16 LN+qkv GEMM", ("gemm_kernel<true, false>",)),
    ("K1 bf16 proj GEMM", ("gemm_kernel<false, true>",)),
    ("K2 fused_mlp", ("fused_mlp_kernel", "mlp_split_epilogue")),
    ("K4 row_ln (Triton)", ("row_ln_kernel",)),
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--backbone", default="swin_v1_l",
                        choices=("swin_v1_t", "swin_v1_s", "swin_v1_b",
                                 "swin_v1_l"))
    parser.add_argument("--tiers", default="int8,bf16")
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
             "plain": ComputeConfig(dtype=torch.bfloat16)}
    for tier in args.tiers.split(","):
        infer = pipeline.make_infer_fn(params, cfg, tiers[tier], dev)
        for _ in range(2):
            infer(frames)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            infer(frames)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side events only: a CPU op's entry repeats the device time
        # of the kernels it launched.
        kernels = [(a.self_device_time_total / 1e3, a.count, a.key)
                   for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA
                   and a.self_device_time_total > 0]
        total = sum(ms for ms, _, _ in kernels)
        print(f"[profile] {tier}: wall {wall_ms:.2f} ms per batch of 2, device "
              f"kernels {total:.2f} ms, idle share "
              f"{max(0.0, 1 - total / wall_ms):.3f} ({smi})", flush=True)
        groups = {}
        for ms, n, name in kernels:
            g = groups.setdefault(group_of(name), [0.0, 0])
            g[0] += ms
            g[1] += n
        for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"[profile] {tier}:   {ms:9.3f} ms  {n:5d} launches  {g}")
        for ms, n, name in sorted(kernels, reverse=True)[:args.top]:
            print(f"[profile] {tier}:   top {ms:9.3f} ms  x{n:<4d} {name[:110]}")
        del infer
    return 0


if __name__ == "__main__":
    sys.exit(main())
