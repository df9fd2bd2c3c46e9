#!/usr/bin/env python3
"""Time the f32 window-attention core (csrc/window_core_f32.cuh) alone,
or with --bf16 the bf16 core (csrc/window_core.cuh); with --tiled the
key-tiled cores (core_tiled, core_f32_tiled) in both dtypes.

    python3 tools/core_time.py [ROOT] [--bf16]
    python3 tools/core_time.py [ROOT] --tiled

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

--tiled takes the nine shapes of chip_smoke.py phase 3 that run the
key-tiled cores (K7 with a dense mask at N = 576, K8 at N = 257, d = 20,
96 and 160, flash_attention causal at N = 1024 and 4096, K6 at a padded
head dim and at N = 289), in bf16 and in f32 (TF32 off). Each shape's
calls are captured in a CUDA graph and replayed (the device time of a
call without the host's launch path), beside one SDPA call on the same
q, k, v with the addend prebuilt (graphed the same way) and the bound
(the larger of the bytes the call must move over 3.35 TB/s and its
operations over the bf16 or TF32 peak, the causal half not counted, one
q k^T); then all nine calls of a dtype as one graph, whose replay is
the sum a parent/change A/B compares.
"""

import os
import sys
from functools import partial

ARGS = [a for a in sys.argv[1:] if a not in ("--bf16", "--tiled")]
BF16 = "--bf16" in sys.argv[1:]
TILED = "--tiled" in sys.argv[1:]
# flash_window_attention (K7 with nW, else K8) or flash_attention causal
# (B_, heads, N, d, nW or "causal" or None), then K6 (B_, heads, N, C).
TILED_SHAPES = [("k7 dense mask", 8, 4, 576, 32, 2),
                ("k8 bias N=257", 8, 4, 257, 64, None),
                ("k8 padded d=20", 8, 4, 144, 20, None),
                ("k8 d=96", 8, 4, 144, 96, None),
                ("k8 causal N=1024", 2, 8, 1024, 128, "causal"),
                ("k8 causal N=4096", 1, 8, 4096, 64, "causal"),
                ("k8 two slices d=160", 4, 2, 144, 160, None)]
TILED_K6 = [("k6 padded d=20", 8, 3, 49, 60), ("k6 N=289", 8, 3, 289, 96)]
MEM_RATE, PEAK_BF16, PEAK_TF32 = 3.35e12, 989e12, 494.7e12
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


def graphed_ms(torch, fns, reps=20):
    """Device time of one pass over the calls `fns`, captured once in a
    CUDA graph (after a warm-up outside it) and replayed `reps` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    return cuda_ms(torch, graph.replay, reps)


def tiled_main(torch) -> int:
    """--tiled: the key-tiled cores at phase 3's nine shapes."""
    import torch.nn.functional as F
    from birefnet_tpu_torch.ops.kernels import build
    from birefnet_tpu_torch.ops.kernels import flash_window_attn as fwa

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(dev).manual_seed(0)
        esize = 2 if dtype == torch.bfloat16 else 4
        calls, worst = [], 0.0
        for label, b_, heads, n, d, mask in TILED_SHAPES + [
                (lbl, b_, h, n, c // h, "k6") for lbl, b_, h, n, c in TILED_K6]:
            q, k, v = (torch.randn((b_, heads, n, d), generator=gen,
                                   device=dev).to(dtype) for _ in range(3))
            bias = torch.randn((heads, n, n), generator=gen, device=dev)
            dense = None
            if mask == "causal":
                args, kernel = (q, k, v, True), fwa.flash_attention
                plain = fwa.flash_attention_plain
                addend = fwa.causal_bias(q, True).float()[None]
            elif mask == "k6":
                qkv = torch.stack((q, k, v), 2).transpose(1, 3).reshape(
                    b_, n, 3 * heads * d).contiguous()
                q, k, v = qkv.view(b_, n, 3, heads, d).permute(
                    2, 0, 3, 1, 4).contiguous()
                args = (qkv, bias, None, heads)
                kernel = fwa.flash_window_attention_qkv
                plain = fwa.flash_window_attention_qkv_plain
                addend = (bias.to(dtype) if dtype == torch.bfloat16
                          else bias).float()[None]
            else:
                if mask is not None:
                    dense = torch.where(torch.rand(
                        (mask, n, n), generator=gen, device=dev) < 0.3,
                        -100.0, 0.0)
                args = (q, k, v, bias, dense)
                kernel = fwa.flash_window_attention
                plain = fwa.flash_window_attention_plain
                addend = (bias.to(dtype) if dtype == torch.bfloat16
                          else bias).float()[None]
                if dense is not None:
                    addend = addend + dense.repeat(b_ // mask, 1, 1)[:, None]
            want = plain(*args).float()
            err = float((kernel(*args).float() - want).abs().max()
                        / want.abs().max())
            worst = max(worst, err)
            attn = addend.expand(b_, heads, n, n).to(dtype).contiguous()
            fn = partial(kernel, *args)
            lib = partial(F.scaled_dot_product_attention, q, k, v,
                          attn_mask=attn)
            nbytes = 4 * b_ * heads * n * d * esize + (
                0 if mask == "causal" else heads * n * n * 4) + (
                0 if dense is None else dense.numel() * 4)
            ops = (4 * d * n * (n + 1) // 2 if mask == "causal"
                   else 4 * n * n * d) * b_ * heads
            bound = max(nbytes / MEM_RATE, ops / PEAK_BF16 if esize == 2
                        else 3 * ops / PEAK_TF32) * 1e3
            ms = graphed_ms(torch, [fn] * 10) / 10
            lib_ms = graphed_ms(torch, [lib] * 10) / 10
            print(f"[tiled {'bf16' if esize == 2 else 'f32'}] {label:<22} "
                  f"({b_},{heads},{n},{d}) kernel {ms:.4f} ms  SDPA "
                  f"{lib_ms:.4f} ms  bound {bound:.4f} ms  "
                  f"max|k-p|/max|p| {err:.2e}", flush=True)
            calls.append(fn)
        total = graphed_ms(torch, calls)
        print(f"[tiled {'bf16' if esize == 2 else 'f32'}] {ROOT}: nine shapes "
              f"graphed {total:.4f} ms, worst max|k-p|/max|p| {worst:.2e} "
              f"({torch.cuda.get_device_name(0)})", flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if TILED:
        return tiled_main(torch)
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
