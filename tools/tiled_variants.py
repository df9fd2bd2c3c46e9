#!/usr/bin/env python3
"""What each piece of the key-tiled cores' work costs on the card: builds
diagnostic copies of csrc/flash_window_attn.cu under build/tiled_variants/,
each with one piece of window_core.cuh (the bf16 core_tiled and the code
core_f32_tiled shares with it) taken out or changed, and times phase 3's
seven K7/K8 tiled shapes through each, graphed, in bf16 and f32, in turns.
The copies compute wrong outputs on purpose (a piece is missing); they
are never the port's library.

    python3 tools/tiled_variants.py [ROOT]

Variants:
- base:    the sources as they are;
- noadd:   no bias, mask, id or causal addend work in the score epilogue
           (both cores: the epilogue is shared);
- noexp:   the bf16 core's exponentials replaced by their arguments;
- ring:    the bf16 core's consumer waits for each stage and releases it
           at once: the producer, its copies and the barriers alone;
- nosplit: never two consumer warpgroups a block (both cores).
Needs one CUDA device and nvcc.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import time
from functools import partial

ROOT = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))

WAIT = ("        ring::mbar_wait(full, cur.parity);\n        __syncwarp();\n"
        "        const int kb = min(2,")
VARIANTS = {
    "base": [],
    "noadd": [("  if (add) {\n#pragma unroll", "  if (false) {\n#pragma unroll")],
    "noexp": [
        ("return ex2(fmaf(x, kLog2e, -c)) * inv;", "return fmaf(x, kLog2e, -c) * inv;"),
        ("s0 += ex2(fmaf(S[4 * j], kLog2e, -c0)) + ex2(fmaf(S[4 * j + 1], kLog2e, -c0));",
         "s0 += fmaf(S[4 * j], kLog2e, -c0) + fmaf(S[4 * j + 1], kLog2e, -c0);"),
        ("s1 += ex2(fmaf(S[4 * j + 2], kLog2e, -c1)) + ex2(fmaf(S[4 * j + 3], kLog2e, -c1));",
         "s1 += fmaf(S[4 * j + 2], kLog2e, -c1) + fmaf(S[4 * j + 3], kLog2e, -c1);")],
    "ring": [(WAIT, WAIT.replace(
        "        const int kb = min(2,",
        "        if (p.n > 0) {\n          if (lane == 0) ring::mbar_arrive(empty);\n"
        "          continue;\n        }\n        const int kb = min(2,"))],
    "nosplit": [("p.cwg = split && waves % 2 == 1 ? 2 : 1;", "p.cwg = 1;")],
}


def build_variant(name, subs, csrc, nvcc, flags):
    """Copy csrc into build/tiled_variants/<name>/ with `subs` applied to
    window_core.cuh and start nvcc on its flash_window_attn.cu."""
    out = os.path.join(ROOT, "build", "tiled_variants", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = os.path.join(out, "window_core.cuh")
    with open(path) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {name}: pattern not found: {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(out, "lib.so")
    cmd = [nvcc, *flags, "-shared", "-o", lib, os.path.join(out, "flash_window_attn.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import core_time as ct
    from birefnet_tpu_torch.ops.kernels import build
    from birefnet_tpu_torch.ops.kernels import flash_window_attn as fwa

    t0 = time.perf_counter()
    csrc = os.path.join(ROOT, "birefnet_tpu_torch", "csrc")
    procs = {name: build_variant(name, subs, csrc, build._nvcc(), build.NVCC_FLAGS)
             for name, subs in VARIANTS.items()}
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"error: variant {name} did not build:\n{err}", file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(lib)
    print(f"[variants] built {len(libs)} in {time.perf_counter() - t0:.0f} s", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    calls = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, b_, heads, n, d, mask in ct.TILED_SHAPES:
            q, k, v = (torch.randn((b_, heads, n, d), generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            if mask == "causal":
                fn = partial(fwa.flash_attention, q, k, v, True)
            else:
                bias = torch.randn((heads, n, n), generator=gen, device=dev)
                dense = None if mask is None else torch.where(
                    torch.rand((mask, n, n), generator=gen, device=dev) < 0.3, -100.0, 0.0)
                fn = partial(fwa.flash_window_attention, q, k, v, bias, dense)
            calls.append((f"{label} {'bf16' if dtype == torch.bfloat16 else 'f32'}", fn))
    times = {}
    for _ in range(2):  # two rounds of every variant, in turns
        for name, lib in libs.items():
            build.library = lambda lib=lib: lib
            build.function.cache_clear()
            for label, fn in calls:
                ms = ct.graphed_ms(torch, [fn] * 10) / 10
                times.setdefault((name, label), []).append(ms)
    for label, _ in calls:
        row = "  ".join(f"{name} {min(times[(name, label)]):.4f}" for name in libs)
        print(f"[variants] {label:<26} {row}  (ms, graphed, best of 2; "
              f"{torch.cuda.get_device_name(0)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
