"""Finetuning CLI: a directory of (image, mask) pairs -> a trained checkpoint.

Counterpart of birefnet_tpu/finetune.py: it pairs images with same-stem
masks, runs the structure-loss AdamW train step (train.py) on the CUDA
device, and exports the result to the ZhengPeng7 torch schema
(params.save_checkpoint), a checkpoint that both packages, the upstream
torch model and the reference implementation load.

Usage:
  python -m birefnet_tpu_torch.finetune imgs/ masks/ --out trained.safetensors \
      --checkpoint model.safetensors --size 1024 --batch 2 --steps 100 \
      --save-state run_state.safetensors [--resume run_state.safetensors]

Masks are grayscale images; any stem match counts (img0.jpg <-> img0.png).
It runs on the CUDA device, and on the CPU only under --device cpu; without
a CUDA device it raises rather than fall back. --dp N trains on N ranks,
one process each (parallel/ranks.py): cuda:0..N-1 over NCCL, or N gloo
processes on the CPU under --device cpu. Each rank decodes its rows of
every batch, the gradients are all-reduced once a step, and every rank
applies the same update to its replicated state (the JAX package's --dp
shards the state FSDP-style over its TPU mesh; train.make_train_step says
why the port does not). Rank 0 prints and writes the outputs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np


def find_pairs(images_dir: str, masks_dir: str):
    """Pair image files with same-stem mask files (sorted, strict)."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
    masks = {}
    for f in os.listdir(masks_dir):
        stem, ext = os.path.splitext(f)
        if ext.lower() in exts:
            masks[stem] = os.path.join(masks_dir, f)
    pairs = []
    for f in sorted(os.listdir(images_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() not in exts:
            continue
        if stem not in masks:
            raise FileNotFoundError(
                f"no mask with stem {stem!r} in {masks_dir} for image {f}")
        pairs.append((os.path.join(images_dir, f), masks[stem]))
    if not pairs:
        raise FileNotFoundError(f"no images found in {images_dir}")
    return pairs


def load_mask(path: str, size: int) -> np.ndarray:
    """Grayscale mask -> [size, size] float32 in [0, 1] (the triangle
    resize of the image side)."""
    from PIL import Image

    from .utils import native

    m = np.asarray(Image.open(path).convert("L"))
    if m.shape != (size, size):
        m = native.resize_triangle_u8(
            np.repeat(m[..., None], 3, axis=-1), size, size)[..., 0]
    return m.astype(np.float32) / 255.0


def _batches(pairs, batch: int, size: int, steps: int, seed: int = 0,
             flip: bool = False, rows=None):
    """`steps` batches (frames_u8 [B, s, s, 3], masks [B, s, s]) of shuffled
    epochs, as the JAX package draws them: the same seeded order, and with
    flip=True a per-sample horizontal flip of image and mask from a stream
    of its own, so the selection is the same with and without it. `rows`
    (indices into the batch) decodes only those rows of each batch, a
    data-parallel rank's: the draws, flips included, stay the global
    batch's."""
    from .loader import load_frame

    rng = np.random.default_rng(seed)
    frng = np.random.default_rng(seed + 0x5F11)
    idx, pos = rng.permutation(len(pairs)), 0
    rows = np.arange(batch) if rows is None else np.asarray(rows)
    for _ in range(steps):
        take = []
        while len(take) < batch:
            if pos == len(idx):
                idx, pos = rng.permutation(len(pairs)), 0
            take.append(pairs[int(idx[pos])])
            pos += 1
        frames = np.stack([load_frame(take[r][0], size)[0] for r in rows])
        masks = np.stack([load_mask(take[r][1], size) for r in rows])
        if flip:
            sel = (frng.random(batch) < 0.5)[rows]
            frames[sel] = frames[sel, :, ::-1]
            masks[sel] = masks[sel, :, ::-1]
        yield frames, masks


def main(argv=None, history: Optional[List[dict]] = None) -> int:
    """The CLI. `history`, if given, receives one dict per step: "step",
    "loss", "grad_norm", "ms" (the step's wall time, from the batch on the
    device to its loss read back) and "load_ms" (reading and preparing the
    batch); with --dp > 1, rank 0's (the loss and norm are the global
    ones)."""
    parser = argparse.ArgumentParser(
        description="Finetune BiRefNet on (image, mask) pairs (PyTorch/CUDA)")
    parser.add_argument("images_dir")
    parser.add_argument("masks_dir")
    parser.add_argument("--out", required=True,
                        help="output checkpoint (torch schema safetensors)")
    parser.add_argument("--checkpoint", default=None,
                        help="initial weights (default: random init)")
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--backbone",
                        choices=("swin_v1_t", "swin_v1_s", "swin_v1_b",
                                 "swin_v1_l"),
                        default="swin_v1_l")
    parser.add_argument("--batch", type=int, default=1,
                        help="frames per optimizer step (with --accum-steps "
                             "k the effective batch: k microbatches of "
                             "batch/k run in turn)")
    parser.add_argument("--accum-steps", type=int, default=1)
    parser.add_argument("--augment-flip", action="store_true",
                        help="random horizontal flip of image and mask")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each Swin block in the backward "
                             "instead of saving its activations")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--backbone-lr-scale", type=float, default=1.0,
                        help="LR multiplier for the Swin backbone (0 "
                             "freezes it)")
    parser.add_argument("--weight-decay", type=float, default=1e-2)
    parser.add_argument("--schedule", choices=("constant", "cosine"),
                        default="constant")
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32",
                        help="activation dtype request; training always runs "
                             "float32 (train.validate_train_compute)")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel ranks: one process per CUDA "
                             "device (NCCL), or N gloo processes on the CPU "
                             "under --device cpu")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "given)")
    parser.add_argument("--save-state", default=None,
                        help="also save resumable train state here")
    parser.add_argument("--resume", default=None,
                        help="resume from a --save-state file")
    parser.add_argument("--log-every", type=int, default=1)
    args = parser.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("finetune runs on the CUDA device unless --device "
                           "cpu is given, and no CUDA device is available")
    if args.batch % args.accum_steps:
        raise ValueError(f"--batch {args.batch} not divisible by "
                         f"--accum-steps {args.accum_steps}")
    if args.dp < 1 or (args.batch // args.accum_steps) % args.dp:
        raise ValueError(f"microbatch {args.batch // args.accum_steps} "
                         f"(--batch/--accum-steps) not divisible by --dp "
                         f"{args.dp}")
    if args.dp == 1:
        _train(0, 1, device, args, history)
        return 0
    if device.type == "cuda":
        if args.dp > torch.cuda.device_count():
            raise ValueError(f"--dp {args.dp} > {torch.cuda.device_count()} "
                             f"CUDA devices")
        # One nvcc build here, not one per rank.
        from .ops.kernels import build
        build.build()
    devices = ([f"cuda:{r}" for r in range(args.dp)] if device.type == "cuda"
               else ["cpu"] * args.dp)
    import json
    import tempfile

    from .parallel import ranks

    with tempfile.TemporaryDirectory(prefix="birefnet_finetune_") as tmp:
        steps = os.path.join(tmp, "history.json")
        try:
            ranks.spawn(rank_main, devices, (args, steps))
        except Exception as e:  # a rank failed
            print(f"error: {args.dp} ranks: {e}", file=sys.stderr)
            return 1
        if history is not None:
            with open(steps) as f:
                history.extend(json.load(f))
    return 0


def rank_main(rank: int, world: int, device, args, history_path: str) -> None:
    """One rank of `finetune.main --dp N` (a parallel.ranks.spawn rank
    function); rank 0 writes its step history to `history_path`."""
    import json

    history: List[dict] = []
    _train(rank, world, device, args, history)
    if rank == 0:
        with open(history_path, "w") as f:
            json.dump(history, f)


def _train(rank: int, world: int, device, args,
           history: Optional[List[dict]]) -> None:
    """The training loop as rank `rank` of `world` (world 1: no group).
    Every rank walks the same batches and decodes its rows; rank 0 prints,
    fills `history` and writes --out and --save-state."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from . import params as P
    from . import pipeline, train
    from .configs import BiRefNetConfig, ComputeConfig
    from .parallel.sharding import rank_rows

    lead = rank == 0
    cfg = BiRefNetConfig.for_backbone(args.backbone)
    if cfg.size != (args.size, args.size):
        cfg = dataclasses.replace(cfg, size=(args.size, args.size))
    compute = train.validate_train_compute(
        ComputeConfig(dtype=getattr(torch, args.dtype),
                      remat_blocks=args.remat))
    tcfg = train.TrainConfig(learning_rate=args.lr,
                             weight_decay=args.weight_decay,
                             schedule=args.schedule,
                             warmup_steps=args.warmup_steps,
                             total_steps=args.steps,
                             accum_steps=args.accum_steps,
                             backbone_lr_scale=args.backbone_lr_scale)

    pairs = find_pairs(args.images_dir, args.masks_dir)
    if lead:
        print(f"{len(pairs)} image/mask pairs; batch {args.batch}, "
              f"{args.steps} steps @ {args.size}^2 float32 on {device}"
              + (f" and {world - 1} more ranks" if world > 1 else ""),
              flush=True)

    params = (P.load_checkpoint(args.checkpoint, cfg, device=device)
              if args.checkpoint else
              P.init_params(cfg, seed=0, device=device))
    state = train.init_train_state(params, tcfg)
    if args.resume:
        state = train.load_train_state(args.resume, state)
        if lead:
            print(f"resumed at step {int(state.step)}", flush=True)
    step_fn = train.make_train_step(
        cfg, compute, tcfg,
        process_group=dist.group.WORLD if world > 1 else None)

    t0 = time.perf_counter()
    batches = _batches(pairs, args.batch, args.size, args.steps,
                       flip=args.augment_flip,
                       rows=rank_rows(args.batch, args.accum_steps, rank,
                                      world))
    for i in range(args.steps):
        t_load = time.perf_counter()
        frames, masks = next(batches)
        with torch.no_grad():
            x = pipeline.preprocess(torch.from_numpy(frames).to(device),
                                    cfg.size, dtype=compute.dtype)
        y = torch.from_numpy(masks).to(device)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, x, y)
        loss = float(metrics["loss"])
        t_end = time.perf_counter()
        grad_norm = float(metrics["grad_norm"])
        if history is not None:
            history.append({"step": int(state.step), "loss": loss,
                            "grad_norm": grad_norm,
                            "ms": (t_end - t_step) * 1e3,
                            "load_ms": (t_step - t_load) * 1e3})
        if lead and (i % args.log_every == 0 or i == args.steps - 1):
            print(f"step {int(state.step):5d}  loss {loss:.4f}  grad_norm "
                  f"{grad_norm:.3e}  {time.perf_counter() - t0:.1f}s",
                  flush=True)

    if lead:
        if args.save_state:
            train.save_train_state(args.save_state, state)
            print(f"train state -> {args.save_state}", flush=True)
        P.save_checkpoint(args.out, state.params, cfg)
        print(f"checkpoint (torch schema) -> {args.out}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
