#!/usr/bin/env python3
"""Where serve.main's time goes on the card, host included.

    python3 tools/serve_stages.py [--runs 3]

Builds Swin-L's pipeline.make_infer_fn on random_checkpoint(cfg, 0) for
serve.main's default flags (bf16, deformable) and for the main path's
(--int8-mlp --int8-attn --deform-mode regular), at 1024^2, batch 2, and
times one call of each by CUDA events (mean of 10 after the capture: the
copy in, the replay, the clone). Then, on chip_smoke.py phase 9's 16
seeded images (write_entry_inputs), it runs serve.write_masks (the loop of
serve.main: the BatchLoader, two batches in flight, the write pool) `runs`
times and the sequential loop (chip_smoke.serve_sequential: decode,
serve.segment, write, in series) once, on the same function, and prints
img/s including IO, the wall time, the seconds that every thread spent in
each host stage (decode, triangle resize, Lanczos3 resize, the whole mask
write, the main thread's submit and wait), and the device's busy share
estimated as batches x the call's event time / wall. Needs one CUDA
device; exits 1 without one.
"""

import argparse
import collections
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed_stages(loader, native, serve):
    """Wrap each host stage to add its seconds (summed over threads) to the
    returned dict."""
    stages = collections.defaultdict(float)
    lock = threading.Lock()

    def wrap(owner, name, key):
        fn = getattr(owner, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                with lock:
                    stages[key] += time.perf_counter() - t0
        setattr(owner, name, timed)

    wrap(loader, "_decode", "decode")
    wrap(native, "resize_triangle_u8", "triangle resize")
    wrap(native, "resize_lanczos3_u8", "Lanczos3 resize")
    wrap(serve, "_write_mask", "mask write (Lanczos3 + PNG)")
    wrap(serve.InFlight, "submit", "main thread: submit")
    wrap(serve.InFlight, "wait", "main thread: wait")
    return stages


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from birefnet_tpu_torch import loader, pipeline, serve
    from birefnet_tpu_torch.configs import BiRefNetConfig
    from birefnet_tpu_torch.params import build_param_tree, random_checkpoint
    from birefnet_tpu_torch.utils import native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[serve] {smi}; {os.cpu_count()} host cores; host-image library "
          f"{native.require()}", flush=True)
    stages = timed_stages(loader, native, serve)
    cfg = BiRefNetConfig.swin_l()
    params = build_param_tree(random_checkpoint(cfg, 0), cfg)
    batch, size = chip_smoke.BATCH, chip_smoke.SIZE
    flag_sets = {"default (bf16, deformable)": serve.compute_config(
                     "bfloat16", True),
                 "main path (int8, regular)": serve.compute_config(
                     "bfloat16", True, True, True, "regular")}
    with tempfile.TemporaryDirectory() as tmp:
        paths, _ = chip_smoke.write_entry_inputs(tmp)
        batches = -(-len(paths) // batch)
        for label, compute in flag_sets.items():
            infer = pipeline.make_infer_fn(params, cfg, compute,
                                           torch.device("cuda"),
                                           out_size=(size, size))
            frames = np.random.default_rng(0).integers(
                0, 256, (batch, size, size, 3), dtype=np.uint8)
            infer(frames)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                infer(frames)
            end.record()
            torch.cuda.synchronize()
            call_ms = start.elapsed_time(end) / 10
            print(f"[serve] {label}: one call {call_ms:.2f} ms by events "
                  f"(device-only {batch / call_ms * 1e3:.2f} img/s) ({smi})",
                  flush=True)
            for run in range(args.runs + 1):
                stages.clear()
                out = os.path.join(tmp, f"{label[:4]}{run}")
                t0 = time.perf_counter()
                if run < args.runs:
                    os.makedirs(out)
                    n = serve.write_masks(infer, loader.BatchLoader(
                        paths, batch_size=batch, size=size), out)
                    kind = f"overlapped run {run}"
                else:
                    n = len(paths)
                    chip_smoke.serve_sequential(serve, infer, paths, size,
                                                batch, out)
                    kind = "sequential"
                wall = time.perf_counter() - t0
                print(f"[serve] {label}: {kind}: {n} images in {wall:.3f} s, "
                      f"{n / wall:.2f} img/s incl. IO; device busy share "
                      f"~{batches * call_ms / 1e3 / wall:.3f}; thread "
                      f"seconds by stage " + ", ".join(
                          f"{k} {v:.3f}" for k, v in stages.items())
                      + f" ({smi})", flush=True)
            del infer
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
