#!/usr/bin/env python3
"""D1b (csrc/deform_col2im.cu) with vector atomics against scalar ones.

    python3 tools/deform_col2im_time.py [--reps 20]

At the 12 ASPP site shapes of a 1024^2 batch-2 training step (C = 64 at
32^2, 64^2, 128^2 and 256^2, each with k = 1, 3 and 7; k = 1 twice per
ASPP and 32^2 twice, 20 calls in all), f32, with offsets of a few pixels,
masks across (0, 2) and a seeded column gradient: the kernel as built
(one 16-byte vector atomicAdd per corner and channel vector) and the same
source built with BT_COL2IM_SCALAR_ATOMICS (four scalar atomicAdds, its
first body; build.build_extra into build/kernels/extra/) are each checked
against the plain version (max |kernel - plain| <= 1e-5 x max |plain| for
each of the three gradients), then timed in turns (scalar, vector,
vector, scalar) by CUDA events (mean over --reps back-to-back calls) and
by the profiler's device time (the kernel and its memset of grad_x).
Prints each shape and the sums per step beside the byte bound (G, x, the
offsets and the mask read, the three gradients written, over 3.35 TB/s),
with the card's name and power limit. Needs one CUDA device and nvcc;
exits 1 without them.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "birefnet_tpu_torch", "csrc", "deform_col2im.cu")
SITES = [(side, k, (2 if k == 1 else 1) * (2 if side == 32 else 1))
         for side in (32, 64, 128, 256) for k in (1, 3, 7)]
BOUND = 1e-5
MEM_RATE = 3.35e12


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

    import gpu_profile
    from birefnet_tpu_torch.ops.kernels import build, deform_im2col

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    with open(SOURCE) as f:
        text = "#define BT_COL2IM_SCALAR_ATOMICS\n" + f.read()
    scalar = getattr(ctypes.CDLL(build.build_extra(SOURCE, text)),
                     "bt_deform_col2im")
    scalar.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    scalar.restype = ctypes.c_int
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(dev).manual_seed(0)
    print(f"[d1b] D1b per call, ms: scalar atomics event / device, vector "
          f"atomics event / device, byte bound ({smi})", flush=True)
    total = [0.0] * 5
    for side, k, calls in SITES:
        x = torch.randn((2, side, side, 64), generator=gen, device=dev)
        offset = torch.randn((2, side, side, 2 * k * k), generator=gen,
                             device=dev) * 3
        mask = 2 * torch.rand((2, side, side, k * k), generator=gen,
                              device=dev)
        g = torch.randn((2 * side * side, k * k * 64), generator=gen,
                        device=dev)
        site = (g, x, offset, mask, k, k, 1, k // 2)
        outs = [torch.empty_like(t) for t in (x, offset, mask)]

        def run_scalar():
            code = scalar(g.data_ptr(), x.data_ptr(), offset.data_ptr(),
                          mask.data_ptr(), *[t.data_ptr() for t in outs], 2,
                          side, side, 64, side, side, k, k, 1, k // 2, 1,
                          build.stream(dev))
            build.check(code, "deform_col2im scalar atomics")
            return outs

        def run_vector():
            return deform_im2col.deform_col2im(*site)

        want = deform_im2col.deform_col2im_plain(*site)
        for name, fn in (("scalar", run_scalar), ("vector", run_vector)):
            for got, ref in zip(fn(), want):
                err = float((got - ref).abs().max())
                if not err <= BOUND * float(ref.abs().max()):
                    print(f"error: {name} atomics at [2,{side},{side},64] "
                          f"k={k}: max |kernel - plain| {err}",
                          file=sys.stderr)
                    return 1
        times = {"scalar": [], "vector": []}
        for name, fn in (("scalar", run_scalar), ("vector", run_vector),
                         ("vector", run_vector), ("scalar", run_scalar)):
            times[name].append((
                gpu_profile.event_ms_per_call(torch, fn, args.reps),
                gpu_profile.device_ms_per_call(fn, args.reps,
                                               lambda n: True)))
        row = [sum(t[i] for t in times[n]) / 2 for n in ("scalar", "vector")
               for i in (0, 1)]
        nbytes = sum(t.numel() * 4 for t in (g, x, offset, mask, x, offset,
                                             mask))
        row.append(nbytes / MEM_RATE * 1e3)
        for i, v in enumerate(row):
            total[i] += calls * v
        print(f"[d1b] f32 [2,{side},{side},64] k={k} x{calls}: "
              f"{row[0]:.4f} / {row[1]:.4f}   {row[2]:.4f} / {row[3]:.4f}   "
              f"{row[4]:.4f}", flush=True)
    print(f"[d1b] f32 per step (20 calls), ms: scalar atomics {total[0]:.4f} "
          f"/ {total[1]:.4f}, vector atomics {total[2]:.4f} / {total[3]:.4f},"
          f" bound {total[4]:.4f} ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
