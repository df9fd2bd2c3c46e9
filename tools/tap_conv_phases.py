#!/usr/bin/env python3
"""Where K5's time goes (csrc/tap_conv.cu, the decoder's 5x5 head conv).

    python3 tools/tap_conv_phases.py [--reps 50]

At the main path's [2, 1024, 1024, 3] bf16, times per call (the
profiler's device time and CUDA events, mean over --reps back-to-back
calls, after a busy warm-up so that the card runs at its full clock):

- the kernel as built;
- a copy with the staging switched off (no cp.async, no spread into the
  planar tile; the compute reads whatever the shared memory holds): the
  compute and the stores alone;
- a copy with the compute switched off (the accumulators stay at the
  bias): the staging and the stores alone;
- K5's first body (tools/tap_conv_first.cu), checked bitwise against the
  kernel.

The copies are built by build.build_extra into build/kernels/extra/. Prints
the bound (the larger of the bytes over 3.35 TB/s and the f32 FMAs over
67 TFLOP/s) beside them, with the card's name and power limit. Needs one
CUDA device and nvcc; exits 1 without them.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "birefnet_tpu_torch", "csrc", "tap_conv.cu")


def variant(switch: str) -> str:
    """csrc/tap_conv.cu with the staging or the compute switched off."""
    src = open(CSRC).read()
    edits = {
        "staging": [
            ("  if (kVec && t < tiles) stage_raw(",
             "  if (false && t < tiles) stage_raw("),
            ("      spread_raw(raw, plane);\n", ""),
            ("      if (t + gridDim.x < tiles) stage_raw(",
             "      if (false) stage_raw(")],
        "compute": [
            ("    for (int ch = 0; ch < kCin; ++ch) {\n      float tap",
             "    for (int ch = 0; ch < 0; ++ch) {\n      float tap")],
    }[switch]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"tap_conv_phases: anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def entry(lib: str, name: str):
    fn = getattr(ctypes.CDLL(lib), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch.profiler import ProfilerActivity, profile

    import gpu_profile
    from birefnet_tpu_torch.ops.kernels import build, tap_conv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    build.build()
    fns = {"as built": build.function("bt_tap_conv5_bf16", 4, 3)}
    for switch in ("staging", "compute"):
        lib = build.build_extra(os.path.join(os.path.dirname(CSRC),
                                             f"tap_conv_no_{switch}.cu"),
                                variant(switch))
        fns[f"{switch} off"] = entry(lib, "bt_tap_conv5_bf16")
    fns["first body"] = entry(build.build_extra(
        os.path.join(ROOT, "tools", "tap_conv_first.cu")), "tap_conv5_first")

    b, h, w = 2, 1024, 1024
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((b, h, w, 3), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((5, 5, 3), generator=gen, device="cuda") * 0.2
    bias = torch.randn((1,), generator=gen, device="cuda")
    stream = build.stream(x.device)
    hot = torch.randn((4096, 4096), device="cuda")

    def call(fn):
        out = torch.empty((b, h, w), dtype=torch.bfloat16, device="cuda")
        code = fn(x.data_ptr(), k.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  b, h, w, stream)
        if code != 0:
            raise RuntimeError(f"launch failed: cudaError {code}")
        return out

    want = tap_conv.tap_conv_same(x, k, bias)
    if not torch.equal(call(fns["first body"]), want):
        print("error: the kernel differs from its first body", file=sys.stderr)
        return 1
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    byte_ms = (b * h * w * 3 * 2 + b * h * w * 2 + 76 * 4) / 3.35e12 * 1e3
    op_ms = 2 * 75 * b * h * w / 67e12 * 1e3
    print(f"[tap_conv] [{b},{h},{w},3] bf16 per call; bound "
          f"{max(byte_ms, op_ms) * 1e3:.2f} us (bytes {byte_ms * 1e3:.2f}, "
          f"f32 FMAs {op_ms * 1e3:.2f}) ({smi})", flush=True)
    for rnd in range(2):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.3:  # busy: the full clock
                for _ in range(5):
                    hot @ hot
                torch.cuda.synchronize()
            run = partial(call, fn)
            dev = gpu_profile.device_ms_per_call(
                torch, profile, acts, run, args.reps,
                lambda s: "tap_conv5_kernel" in s)
            ev = gpu_profile.event_ms_per_call(torch, run, args.reps)
            print(f"[tap_conv] round {rnd} {name:<12} device {dev * 1e3:.2f} us, "
                  f"events {ev * 1e3:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
