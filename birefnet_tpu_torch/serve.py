"""Batch serving: segment a list of images on one device or a mesh of them.

Counterpart of birefnet_tpu/serve.py. The serving core, `segment`, works
on in-memory uint8 images of any sizes: each is resized on the host to the
model size (native triangle filter), batches run through the device
pipeline, and each mask is resized back on the host to its image's own
size (native Lanczos3). `main` is the file server: a `BatchLoader`
decodes and resizes the next batches on its threads, up to two device
batches stay in flight (`write_masks`: on the card each batch's frames go
in and its masks come back through pinned host buffers behind a CUDA
event, `pipeline.GraphedInfer.submit`), and a thread pool resizes the
masks back and writes `<name>_mask.png` files behind the read-back.

Usage:
  python -m birefnet_tpu_torch.serve imgs/*.jpg --out masks/ \
      [--checkpoint model.safetensors] --batch 2 --dtype bfloat16 \
      --int8-mlp --int8-attn

Without --checkpoint it serves the HF-cache copy of the published
checkpoint (cli.default_checkpoint_path), as the JAX serve does. It runs
on the CUDA device, on the kernel tier for either --dtype (as the JAX
serve does on its TPU) unless DISABLE_FLASH_ATTN is set, the int8 flags
with either, and on the CPU only under --cpu. On the card it builds the
native host-resize library first and stops with the compiler's output if
that fails. --deform-mode is deformable (faithful sampling, the default,
as in the JAX serve) or regular. --dp N serves on a mesh of N data
groups (parallel/sharding.make_sharded_infer_fn): cuda:0..N-1, or N CPU
groups under --cpu; each batch is split into N equal groups, one captured
graph per card, and two batches stay in flight across all of them.
--spatial > 1 is refused (parallel/mesh.SPATIAL_CUT: 2048^2 fits one
card), as are --aot-dir executables and the deformable-local and auto
deform modes (an offset-clamped sampler for the TPU's gather floor, and
its calibration).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .utils import native


def segment(infer: Callable, images: Sequence[np.ndarray], size: int,
            batch: int) -> List[np.ndarray]:
    """[H, W, 3] uint8 images -> [H, W] uint8 masks, one per image.

    `infer` maps [B, size, size, 3] uint8 frames to [B, size, size] uint8
    masks (pipeline.make_infer_fn with out_size=(size, size))."""
    masks: List[np.ndarray] = []
    for start in range(0, len(images), batch):
        chunk = images[start:start + batch]
        frames = np.stack([
            img if img.shape[:2] == (size, size)
            else native.resize_triangle_u8(img, size, size) for img in chunk])
        out = infer(frames).cpu().numpy()
        for img, m in zip(chunk, out):
            oh, ow = img.shape[:2]
            masks.append(native.resize_lanczos3_u8(m[..., None], oh, ow)[..., 0])
    return masks


def compute_config(dtype: str, cuda: bool, int8_mlp: bool = False,
                   int8_attn: bool = False, deform_mode: str = "deformable"):
    """serve's compute policy, as the JAX serve sets it
    (birefnet_tpu/serve.py:109-116): the kernel tier on the card for either
    --dtype unless DISABLE_FLASH_ATTN is set, the plain versions on the
    CPU."""
    from .configs import ComputeConfig

    return ComputeConfig(
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
        use_flash_attention=cuda and "DISABLE_FLASH_ATTN" not in os.environ,
        deform_mode=deform_mode, int8_mlp=int8_mlp, int8_attn=int8_attn)


def _paths(inputs: Sequence[str]) -> List[str]:
    paths = []
    for inp in inputs:
        if os.path.isdir(inp):
            for ext in ("*.png", "*.jpg", "*.jpeg", "*.webp", "*.bmp"):
                paths.extend(sorted(glob.glob(os.path.join(inp, ext))))
        else:
            paths.extend(sorted(glob.glob(inp)) or [inp])
    return paths


# Device batches serve.main keeps in flight, as the JAX serve does.
DEPTH = 2


class InFlight:
    """Batches in flight on `infer` (make_infer_fn's function with
    out_size=(size, size)). On the card (`infer` has `submit`) it keeps
    DEPTH + 1 slots of pinned host memory, frames in and masks out: a
    batch is copied into the next slot, submitted, and its masks are read
    back into the slot behind a CUDA event; `wait` waits on that event
    alone and hands the slot back. A slot is reused only after its batch
    was waited on. On the CPU the batch runs at `submit`."""

    def __init__(self, infer: Callable, batch: int, size: int):
        self._infer = infer
        self._slots = None
        if hasattr(infer, "submit"):
            self._slots = deque(
                (torch.empty((batch, size, size, 3), dtype=torch.uint8,
                             pin_memory=True),
                 torch.empty((batch, size, size), dtype=torch.uint8,
                             pin_memory=True))
                for _ in range(DEPTH + 1))

    def submit(self, frames: np.ndarray):
        """Start a batch; returns the handle `wait` takes."""
        if self._slots is None:
            return self._infer(frames).cpu().numpy()
        if not self._slots:
            raise RuntimeError("every pinned slot is in flight: wait for a "
                               "batch before submitting another")
        slot = self._slots.popleft()
        slot[0].numpy()[...] = frames
        return slot, self._infer.submit(slot[0], slot[1])

    def wait(self, handle) -> np.ndarray:
        """The batch's [B, size, size] uint8 masks, in an array of its own."""
        if self._slots is None:
            return handle
        slot, done = handle
        done.synchronize()
        masks = slot[1].numpy().copy()
        self._slots.append(slot)
        return masks


def _write_mask(mask: np.ndarray, orig: Tuple[int, int], src: str,
                out_dir: str) -> None:
    """Lanczos3-resize one model-size mask to its image's size and write
    it as <out_dir>/<stem>_mask.png."""
    from PIL import Image

    oh, ow = orig
    out = native.resize_lanczos3_u8(mask[..., None], oh, ow)[..., 0]
    dst = os.path.join(
        out_dir, os.path.splitext(os.path.basename(src))[0] + "_mask.png")
    Image.fromarray(out).save(dst)


def write_masks(infer: Callable, loader, out_dir: str) -> int:
    """Segment every image of `loader` (a loader.BatchLoader over file
    paths) and write its mask into `out_dir`; returns the count.

    Three-way overlap, as in birefnet_tpu/serve.py:182-236: the loader
    prepares the next batches on its threads, up to DEPTH device batches
    stay in flight (InFlight), and the masks' resize and PNG writes run on
    a thread pool behind the read-back. A failed write raises as soon as
    its batch's writes have settled, not after the whole run."""
    flight = InFlight(infer, loader.batch_size, loader.size)
    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 4))
    futures: deque = deque()
    inflight: deque = deque()
    paths = iter(loader.sources)

    def drain_one():
        handle, sizes, srcs = inflight.popleft()
        masks = flight.wait(handle)
        for mask, orig, src in zip(masks, sizes, srcs):
            futures.append(pool.submit(_write_mask, mask, orig, src, out_dir))
        while futures and futures[0].done():
            futures.popleft().result()

    done = 0
    try:
        for frames, sizes in loader:
            inflight.append((flight.submit(frames), sizes,
                             [next(paths) for _ in sizes]))
            done += len(sizes)
            if len(inflight) > DEPTH:
                drain_one()
        while inflight:
            drain_one()
        for f in futures:
            f.result()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    return done


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="BiRefNet batch segmentation (PyTorch)")
    parser.add_argument("inputs", nargs="+",
                        help="image files, globs, or directories")
    parser.add_argument("--out", default="masks",
                        help="output directory (default: masks/)")
    parser.add_argument("--checkpoint", default=None,
                        help="path to model.safetensors (default: the HF "
                        "cache's ZhengPeng7/BiRefNet snapshot)")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--backbone", default="swin_v1_l",
                        choices=("swin_v1_t", "swin_v1_s", "swin_v1_b",
                                 "swin_v1_l"))
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="bfloat16")
    parser.add_argument("--deform-mode", default="deformable",
                        choices=("deformable", "deformable-local", "regular",
                                 "auto"))
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (plain PyTorch, no kernels)")
    parser.add_argument("--int8-mlp", action="store_true",
                        help="W8A8 int8 MLP kernels at the wide Swin stages "
                        "(C >= 768; CUDA kernel tier only)")
    parser.add_argument("--int8-attn", action="store_true",
                        help="W8A8 int8 attention qkv/proj at the same "
                        "stages (CUDA kernel tier only)")
    parser.add_argument("--dp", type=int, default=0,
                        help="data-parallel groups: the batch split over "
                        "cuda:0..N-1 (N CPU groups under --cpu)")
    parser.add_argument("--spatial", type=int, default=1,
                        help="spatial shards per group: only 1 (refused "
                        "above, parallel/mesh.py says why)")
    # Accepted for command-line parity with birefnet_tpu.serve, refused below.
    parser.add_argument("--aot-dir", default=None)
    args = parser.parse_args(argv)

    unported = {"--aot-dir": args.aot_dir,
                "--deform-mode": args.deform_mode not in ("deformable",
                                                          "regular")}
    refused = [flag for flag, on in unported.items() if on]
    if refused:
        parser.error(f"{', '.join(refused)} not ported to birefnet_tpu_torch "
                     "(bf16/f32, deform-mode deformable or regular: "
                     "deformable-local's clamped sampler exists for the TPU's "
                     "gather floor and auto needs its calibration; see "
                     "ROADMAP.md)")
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass --cpu to run on "
                     "the CPU")
    # The JAX serve's mesh checks, in its order (birefnet_tpu/serve.py).
    if args.spatial > 1 and not args.dp:
        parser.error("--spatial requires --dp (use --dp 1 for a "
                     "spatial-only mesh)")
    if args.dp:
        if args.batch % args.dp != 0:
            parser.error(f"--batch {args.batch} not divisible by --dp "
                         f"{args.dp}")
        cards = torch.cuda.device_count() if not args.cpu else None
        if cards is not None and args.dp * args.spatial > cards:
            parser.error(f"--dp {args.dp} x --spatial {args.spatial} > "
                         f"{cards} devices")
    if args.spatial != 1:
        from .parallel.mesh import SPATIAL_CUT
        parser.error(f"--spatial {args.spatial}: {SPATIAL_CUT}")

    paths = _paths(args.inputs)
    if not paths:
        print("error: no input images found", file=sys.stderr)
        return 1
    from .cli import default_checkpoint_path

    ckpt = args.checkpoint or default_checkpoint_path()
    if ckpt is None:
        print("error: no checkpoint found; pass --checkpoint",
              file=sys.stderr)
        return 1

    import dataclasses

    from . import pipeline
    from .configs import BiRefNetConfig
    from .loader import BatchLoader
    from .params import load_checkpoint

    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        try:
            print(f"Host resizes: {native.require()}")
        except native.NativeLibraryError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    compute = compute_config(args.dtype, device.type == "cuda",
                             args.int8_mlp, args.int8_attn, args.deform_mode)
    cfg = dataclasses.replace(BiRefNetConfig.for_backbone(args.backbone),
                              size=(args.size, args.size))
    print(f"Loading {ckpt} ...")
    params = load_checkpoint(ckpt, cfg)
    if args.dp:
        from .parallel import mesh, sharding

        grid = mesh.make_mesh(devices=[
            "cpu" if args.cpu else f"cuda:{i}" for i in range(args.dp)])
        print(f"Sharded over {args.dp} devices (data {args.dp} x spatial 1; "
              f"{args.batch // args.dp} images/group/step)")
        infer = sharding.make_sharded_infer_fn(
            grid, params, cfg, compute, out_size=(args.size, args.size))
    else:
        infer = pipeline.make_infer_fn(params, cfg, compute, device,
                                       out_size=(args.size, args.size))
    if device.type == "cuda":
        # Capture the batch shape's graph (on every card) before the clock
        # starts, as the JAX serve compiles its units before the first batch.
        infer(np.zeros((args.batch, args.size, args.size, 3), np.uint8))

    try:
        os.makedirs(args.out, exist_ok=True)
        t0 = time.perf_counter()
        done = write_masks(infer, BatchLoader(paths, batch_size=args.batch,
                                              size=args.size), args.out)
    except OSError as e:  # an unreadable image, an unwritable --out
        print(f"error: {e}", file=sys.stderr)
        return 1
    dt = time.perf_counter() - t0
    where = f"{args.dp} x {device}" if args.dp else device
    print(f"Segmented {done} images in {dt:.3f}s on {where} "
          f"({done / dt:.2f} img/s incl. IO)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
