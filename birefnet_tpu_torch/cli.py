"""CLI entry point: BiRefNet inference on one image.

Counterpart of birefnet_tpu/cli.py (the reference's `infer_image` example,
reference: examples/infer_image.rs): load the weights, run the frame at
its own size through `pipeline.make_infer_fn` (resize, normalize, the
model, sigmoid and the mask's resize back, all on the device; on the card
one CUDA graph per input shape), print the first call's time (with the
capture) and the steady-state time, the mask's stats, and save the mask.

Usage:
  python -m birefnet_tpu_torch.cli photo.jpg mask.png \
      [--checkpoint model.safetensors]

Without --checkpoint it uses the HF-cache copy of ZhengPeng7/BiRefNet and
downloads it there if it is missing (hub.py); offline, it exits 1 with
what to do. It runs on the CUDA device, on the kernel tier at either
--dtype (float32 by default, as in the JAX cli), and on the CPU only under
--cpu; on the card it first checks that the native host-image library
builds (utils/native.require), as serve.main does. Flags:
  --no-flash          the plain PyTorch versions instead of the kernel
                      tier (so does the DISABLE_FLASH_ATTN environment
                      variable, the reference's kill-switch)
  --no-pallas-deform  accepted and ignored, as in the JAX package
  --deform-mode       deformable (default) or regular; deformable-local
                      is refused, as in serve.py
The JAX cli runs its staged executables on the TPU (a compile-size
workaround that is not ported); this one runs make_infer_fn's graph.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import hub
from .utils import native


def default_checkpoint_path() -> Optional[str]:
    """The HF-hub cached ZhengPeng7/BiRefNet snapshot's model.safetensors
    under ~/.cache/huggingface/hub, or None (the same lookup as
    birefnet_tpu.cli.default_checkpoint_path)."""
    return hub.cached_file()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="BiRefNet dichotomous image segmentation (PyTorch)")
    parser.add_argument("image", help="input image path")
    parser.add_argument("output", nargs="?", default="output_mask.png",
                        help="output mask path (default: output_mask.png)")
    parser.add_argument("--checkpoint", default=None,
                        help="path to model.safetensors "
                             "(default: HF cache, downloaded if missing)")
    parser.add_argument("--size", type=int, default=1024,
                        help="inference resolution (default 1024)")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32")
    parser.add_argument("--no-flash", action="store_true",
                        help="run the plain PyTorch versions instead of the "
                             "CUDA kernel tier")
    parser.add_argument("--no-pallas-deform", action="store_true",
                        help="accepted for parity with birefnet_tpu.cli and "
                             "ignored, as the JAX package ignores it")
    parser.add_argument("--deform-mode",
                        choices=("deformable", "deformable-local", "regular"),
                        default="deformable",
                        help="deformable = true sampling (the reference's "
                             "Metal path); regular = plain conv (the "
                             "reference's CPU path); deformable-local is "
                             "not ported")
    parser.add_argument("--backbone",
                        choices=("swin_v1_t", "swin_v1_s", "swin_v1_b",
                                 "swin_v1_l"),
                        default="swin_v1_l",
                        help="Swin backbone preset (default: swin_v1_l, the "
                             "published checkpoint's); the others need a "
                             "matching checkpoint")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (plain PyTorch, no kernels)")
    args = parser.parse_args(argv)

    if args.deform_mode == "deformable-local":
        parser.error("--deform-mode deformable-local is not ported to "
                     "birefnet_tpu_torch: its clamped sampler exists for the "
                     "TPU's gather floor (see ROADMAP.md); use deformable")
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass --cpu to run on "
                     "the CPU")

    ckpt = args.checkpoint or default_checkpoint_path()
    if ckpt is None:
        try:
            print(f"Downloading {hub.DEFAULT_REPO}/{hub.DEFAULT_FILE} ...")
            ckpt = hub.download()
        except hub.HubUnavailableError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    import dataclasses

    from PIL import Image

    from . import pipeline
    from .configs import BiRefNetConfig, ComputeConfig
    from .params import load_checkpoint
    from .utils.profiling import tensor_stats

    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        # The entry points on the card stop on a host-image library that
        # does not build, with the compiler's output, as serve.main does
        # (this one resizes on the device and needs it for nothing else).
        try:
            native.require()
        except native.NativeLibraryError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    compute = ComputeConfig(
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        use_flash_attention=(device.type == "cuda" and not args.no_flash
                             and "DISABLE_FLASH_ATTN" not in os.environ),
        deform_mode=args.deform_mode)
    cfg = dataclasses.replace(BiRefNetConfig.for_backbone(args.backbone),
                              size=(args.size, args.size))

    print(f"Loading model from {ckpt} ...")
    params = load_checkpoint(ckpt, cfg)

    with Image.open(args.image) as im:
        frame = np.array(im.convert("RGB"), dtype=np.uint8)
    orig_h, orig_w = frame.shape[:2]
    print(f"Input: {args.image} ({orig_w}x{orig_h})")

    infer = pipeline.make_infer_fn(params, cfg, compute, device)
    print(f"Running inference on {device} ...")
    t0 = time.perf_counter()
    mask = infer(frame[None]).cpu().numpy()  # the read-back fences
    print(f"Inference time (incl. graph capture): "
          f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    mask = infer(frame[None]).cpu().numpy()
    print(f"Inference time (steady state): {time.perf_counter() - t0:.3f}s")

    # Health-check stats like the reference (examples/infer_image.rs:79-90).
    stats = tensor_stats(mask[0].astype(np.float32) / 255.0, "mask")
    print(f"Mask stats - min: {stats['min']:.4f}, max: {stats['max']:.4f}, "
          f"mean: {stats['mean']:.4f}")

    Image.fromarray(mask[0]).save(args.output)
    print(f"Saved mask to: {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
