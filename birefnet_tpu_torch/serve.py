"""Batch serving: segment a list of images on one device.

Counterpart of birefnet_tpu/serve.py. The serving core, `segment`, works
on in-memory uint8 images of any sizes: each is resized on the host to the
model size (native triangle filter), batches run through the device
pipeline, and each mask is resized back on the host to its image's own
size (native Lanczos3). `main` is the file wrapper: it decodes images with
PIL and writes `<name>_mask.png` files.

Usage:
  python -m birefnet_tpu_torch.serve imgs/*.jpg --out masks/ \
      --checkpoint model.safetensors --batch 2 --dtype bfloat16 \
      --int8-mlp --int8-attn

It runs on the CUDA device, on the kernel tier for either --dtype (as the
JAX serve does on its TPU), the int8 flags with either, and on the CPU
only under --cpu. --deform-mode is deformable (faithful sampling, the
default, as in the JAX serve) or regular. Single device only: the JAX
package's --dp/--spatial meshes, --aot-dir executables, and the
deformable-local and auto deform modes (an offset-clamped sampler for the
TPU's gather floor, and its calibration) are not ported and are refused.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import Callable, List, Sequence

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="BiRefNet batch segmentation (PyTorch, one device)")
    parser.add_argument("inputs", nargs="+",
                        help="image files, globs, or directories")
    parser.add_argument("--out", default="masks")
    parser.add_argument("--checkpoint", required=True)
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
    # Accepted for command-line parity with birefnet_tpu.serve, refused below.
    parser.add_argument("--aot-dir", default=None)
    parser.add_argument("--dp", type=int, default=0)
    parser.add_argument("--spatial", type=int, default=1)
    args = parser.parse_args(argv)

    unported = {"--dp": args.dp, "--spatial": args.spatial != 1,
                "--aot-dir": args.aot_dir,
                "--deform-mode": args.deform_mode not in ("deformable",
                                                          "regular")}
    refused = [flag for flag, on in unported.items() if on]
    if refused:
        parser.error(f"{', '.join(refused)} not ported to birefnet_tpu_torch "
                     "(single device, bf16/f32, deform-mode deformable or "
                     "regular: deformable-local's clamped sampler exists for "
                     "the TPU's gather floor and auto needs its calibration; "
                     "see ROADMAP.md)")
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass --cpu to run on "
                     "the CPU")
    from .pipeline import make_infer_fn

    device = torch.device("cpu" if args.cpu else "cuda")
    compute = compute_config(args.dtype, device.type == "cuda",
                             args.int8_mlp, args.int8_attn, args.deform_mode)

    paths = _paths(args.inputs)
    if not paths:
        print("error: no input images found", file=sys.stderr)
        return 1

    import dataclasses
    from PIL import Image

    from .configs import BiRefNetConfig
    from .params import load_checkpoint

    cfg = dataclasses.replace(BiRefNetConfig.for_backbone(args.backbone),
                              size=(args.size, args.size))
    print(f"Loading {args.checkpoint} ...")
    params = load_checkpoint(args.checkpoint, cfg)
    infer = make_infer_fn(params, cfg, compute, device,
                          out_size=(args.size, args.size))

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    done = 0
    for start in range(0, len(paths), args.batch):
        chunk = paths[start:start + args.batch]
        images = []
        for p in chunk:
            with Image.open(p) as im:
                images.append(np.asarray(im.convert("RGB"), np.uint8))
        for p, m in zip(chunk, segment(infer, images, args.size, args.batch)):
            name = os.path.splitext(os.path.basename(p))[0] + "_mask.png"
            Image.fromarray(m).save(os.path.join(args.out, name))
        done += len(chunk)
    dt = time.time() - t0
    print(f"Segmented {done} images in {dt:.1f}s on {device} "
          f"({done / dt:.2f} img/s incl. IO)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
