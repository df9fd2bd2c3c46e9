#!/usr/bin/env python3
"""Time the f32 window-attention core (csrc/window_core_f32.cuh) alone,
or with --bf16 the bf16 core (csrc/window_core.cuh).

    python3 tools/core_time.py [ROOT] [--bf16]

ROOT is a checkout of this repository (default: the one holding this
file); its package is imported and its kernels built into its own
build/kernels/. Times the core per 1024^2 batch-2 forward by CUDA events
(mean of 10 calls per shape after one warm-up, times the calls per
forward): through flash_window_attention at Swin-L's 16 core shapes (both
passes, N = 144, unmasked and with the offset mask's region ids: the
calls K1 makes), and through flash_window_attention_qkv at swin_t's 16 K6
shapes (N = 49), in f32 or bf16; then the same calls of one forward
captured in a CUDA graph and replayed (mean of 20 replays: the device
time of a forward's calls, without the host's launch path, which the
event sums of calls under 0.1 ms follow); checks every output against
the plain version (TF32 off) and prints the largest difference. To
compare variants of the core, run it on copies of the tree that differ
in the header, one process each, in turns (A, B, B, A). Needs one CUDA
device.
"""

import os
import sys
from functools import partial

ARGS = [a for a in sys.argv[1:] if a != "--bf16"]
BF16 = "--bf16" in sys.argv[1:]
ROOT = ARGS[0] if ARGS else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(torch, fn, reps=10):
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from birefnet_tpu_torch.ops import window as W
    from birefnet_tpu_torch.ops.kernels import build
    from birefnet_tpu_torch.ops.kernels import flash_window_attn as fwa

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    dtype = torch.bfloat16 if BF16 else torch.float32
    worst = 0.0
    totals, calls = {}, {}
    # (ws, (Hp, C, heads, depth) per stage of both passes) of each model.
    for model, ws, stages in (
            ("swin_l", 12, ((264, 192, 6, 2), (132, 384, 12, 2),
                            (72, 768, 24, 18), (36, 1536, 48, 2),
                            (132, 192, 6, 2), (72, 384, 12, 2),
                            (36, 768, 24, 18), (24, 1536, 48, 2))),
            ("swin_t", 7, ((259, 96, 3, 2), (133, 192, 6, 2),
                           (70, 384, 12, 6), (35, 768, 24, 2),
                           (133, 96, 3, 2), (70, 192, 6, 2),
                           (35, 384, 12, 6), (21, 768, 24, 2)))):
        n = ws * ws
        for hp, c, heads, depth in stages:
            b_ = 2 * (hp // ws) ** 2
            qkv = torch.randn((b_, n, 3 * c), generator=gen,
                              device=dev).to(dtype)
            bias = torch.randn((heads, n, n), generator=gen, device=dev)
            masks = (None, W.sw_msa_region_ids(hp, hp, ws, ws // 2, dev,
                                               offset=ws == 12))
            for mask in masks:
                if ws == 12:
                    q, k, v = qkv.view(b_, n, 3, heads, 32).permute(
                        2, 0, 3, 1, 4)
                    args = (q, k, v, bias, mask)
                    kernel, plain = (fwa.flash_window_attention,
                                     fwa.flash_window_attention_plain)
                else:
                    args = (qkv, bias, mask, heads)
                    kernel, plain = (fwa.flash_window_attention_qkv,
                                     fwa.flash_window_attention_qkv_plain)
                worst = max(worst, float(
                    (kernel(*args).float() - plain(*args).float()).abs().max()))
                totals[model] = totals.get(model, 0.0) + depth // 2 * cuda_ms(
                    torch, lambda: kernel(*args))
                calls.setdefault(model, []).append(
                    (partial(kernel, *args), depth // 2))
    graphed = {}
    for model, fns in calls.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up outside the capture
            for fn, _ in fns:
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for fn, reps in fns:
                for _ in range(reps):
                    fn()
        graphed[model] = cuda_ms(torch, graph.replay, 20)
    tag = "core_bf16" if BF16 else "core_f32"
    print(f"[{tag}] {ROOT}: Swin-L core per forward "
          f"{totals['swin_l']:.4f} ms (graphed {graphed['swin_l']:.4f}), "
          f"swin_t K6 {totals['swin_t']:.4f} ms (graphed "
          f"{graphed['swin_t']:.4f}), max|kernel - plain| {worst:.3e} "
          f"({torch.cuda.get_device_name(0)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
