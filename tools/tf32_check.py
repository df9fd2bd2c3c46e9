#!/usr/bin/env python3
"""Does an f32 make_infer_fn give the same result whatever TF32 flags its
caller has set?

    python3 tools/tf32_check.py [ROOT]

ROOT is a checkout of this repository (default: the one holding this file),
whose package is imported. Builds the f32 plain pipeline
(`ComputeConfig(deform_mode="regular")`) of Swin-L at 128^2 from random_checkpoint(cfg, 7), runs
one batch of 2 random uint8 frames with both of PyTorch's TF32 flags off,
then with PyTorch's defaults (cuDNN's flag on, the matmul flag off), and
prints whether the masks and the logits are bitwise equal and the largest
logit difference. The JAX package's f32 contract is precision=HIGHEST at
every conv and dot, so they should be equal. Needs one CUDA device.
"""

import os
import sys

ROOT = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from birefnet_tpu_torch import pipeline
    from birefnet_tpu_torch.configs import BiRefNetConfig, ComputeConfig
    from birefnet_tpu_torch.models import birefnet
    from birefnet_tpu_torch.params import build_param_tree, random_checkpoint

    cfg = BiRefNetConfig(size=(128, 128))
    params = build_param_tree(random_checkpoint(cfg, 7), cfg)
    logits = []
    forward = birefnet.forward_logits

    def caught(*args, **kw):
        logits.append(forward(*args, **kw))
        return logits[-1]

    birefnet.forward_logits = caught
    infer = pipeline.make_infer_fn(params, cfg,
                                   ComputeConfig(deform_mode="regular"),
                                   "cuda", as_uint8=False)
    frames = np.random.default_rng(3).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    off = infer(frames)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    on = infer(frames)
    d = float((logits[0] - logits[1]).abs().max())
    print(f"[tf32_check] {ROOT}: masks equal {torch.equal(off, on)}, logits "
          f"equal {torch.equal(logits[0], logits[1])}, max|logit diff| "
          f"{d:.3e} ({torch.cuda.get_device_name(0)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
