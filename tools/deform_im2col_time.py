#!/usr/bin/env python3
"""D1 (csrc/deform_im2col.cu) against its first body, per Swin-L forward.

    python3 tools/deform_im2col_time.py [--reps 20]

At the 12 ASPP site shapes of a 1024^2 batch-2 forward (C = 64 at 32^2,
64^2, 128^2 and 256^2, each with k = 1, 3 and 7; k = 1 twice per ASPP and
32^2 twice, 20 calls in all), in bf16 and f32, with offsets of a few
pixels and masks across (0, 2): the kernel as built and its first body
(tools/deform_im2col_first.cu, built by build.build_extra into
build/kernels/extra/) are each checked bitwise against the plain version,
then timed in turns (first, kernel, kernel, first) by CUDA events (mean
over --reps back-to-back calls) and by the profiler's device time. Prints
each shape and the sums per forward beside the byte bound (the columns
written, x, the offsets and the mask read, over 3.35 TB/s), with the
card's name and power limit. Needs one CUDA device and nvcc; exits 1
without them.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST = os.path.join(ROOT, "tools", "deform_im2col_first.cu")
SITES = [(side, k, (2 if k == 1 else 1) * (2 if side == 32 else 1))
         for side in (32, 64, 128, 256) for k in (1, 3, 7)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch.profiler import ProfilerActivity, profile

    import gpu_profile
    from birefnet_tpu_torch.ops.kernels import build, deform_im2col

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    first = getattr(ctypes.CDLL(build.build_extra(FIRST)), "bt_deform_im2col")
    first.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                      + [ctypes.c_void_p])
    first.restype = ctypes.c_int
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(dev).manual_seed(0)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print(f"[d1] D1 per call, ms: first body event / device, kernel event / "
          f"device, byte bound ({smi})", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        total = [0.0] * 5
        for side, k, calls in SITES:
            x = torch.randn((2, side, side, 64), generator=gen,
                            device=dev).to(dtype)
            offset = torch.randn((2, side, side, 2 * k * k), generator=gen,
                                 device=dev) * 3
            mask = (2 * torch.rand((2, side, side, k * k), generator=gen,
                                   device=dev)).to(dtype)
            site = (x, offset, mask, k, k, 1, k // 2)
            cols = torch.empty((2 * side * side, k * k * 64), dtype=dtype,
                               device=dev)
            f32 = int(dtype == torch.float32)

            def run_first():
                code = first(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                             cols.data_ptr(), 2, side, side, 64, side, side, k,
                             k, 1, k // 2, 1, f32, f32, build.stream(dev))
                build.check(code, "deform_im2col first body")
                return cols

            def run_kernel():
                return deform_im2col.deform_im2col(*site)

            want = deform_im2col.deform_im2col_plain(*site)
            for name, fn in (("first body", run_first), ("kernel", run_kernel)):
                if not torch.equal(fn(), want):
                    print(f"error: {name} differs from the plain version at "
                          f"{side}^2 k={k} {dtype}", file=sys.stderr)
                    return 1
            # [first event, first device, kernel event, kernel device],
            # each the mean of two turns: first, kernel, kernel, first.
            row = [0.0] * 4
            for j, fn in ((0, run_first), (2, run_kernel), (2, run_kernel),
                          (0, run_first)):
                row[j] += gpu_profile.event_ms_per_call(torch, fn,
                                                        args.reps) / 2
                row[j + 1] += gpu_profile.device_ms_per_call(
                    torch, profile, acts, fn, args.reps,
                    lambda s: "deform_im2col_kernel" in s) / 2
            nbytes = sum(t.numel() * t.element_size()
                         for t in (x, offset, mask, want))
            bound = nbytes / 3.35e12 * 1e3
            total = [a + calls * b for a, b in zip(total, row + [bound])]
            print(f"[d1] {str(dtype)[6:]} [2,{side},{side},64] k={k} x{calls}: "
                  f"{row[0]:.4f} / {row[1]:.4f}   {row[2]:.4f} / "
                  f"{row[3]:.4f}   {bound:.4f}", flush=True)
        print(f"[d1] {str(dtype)[6:]} per forward (20 calls), ms: first body "
              f"{total[0]:.4f} / {total[1]:.4f}, kernel {total[2]:.4f} / "
              f"{total[3]:.4f}, bound {total[4]:.4f} ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
