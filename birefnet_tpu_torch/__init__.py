"""birefnet_tpu_torch: the PyTorch/CUDA port of the BiRefNet inference
framework, for one NVIDIA H100.

The package mirrors birefnet_tpu's module names (configs, params, ops,
models, pipeline, serve, utils) and keeps its layouts at the public
functions (NHWC activations). It imports torch and never jax; the JAX
package stays the reference it is tested against. The TPU kernels of the
Swin-L inference path (bf16, and W8A8 int8 at the wide stages) are
hand-written Hopper kernels under ops/kernels/ (sources in csrc/), built
with nvcc at first use. train.py and finetune.py train the model with the
upstream structure loss, f32, through the plain versions and the
deformable sampling's own backward kernel.
"""

from .configs import (IMAGENET_MEAN, IMAGENET_STD, BiRefNetConfig,
                      ComputeConfig, DecoderConfig, SwinConfig)
from .params import (build_param_tree, checkpoint_spec, export_checkpoint,
                     from_jax_params, init_params, load_checkpoint,
                     quantize_attn_int8, quantize_mlp_int8, random_checkpoint,
                     save_checkpoint)

__all__ = [
    "BiRefNetConfig", "ComputeConfig", "DecoderConfig", "SwinConfig",
    "IMAGENET_MEAN", "IMAGENET_STD", "build_param_tree", "checkpoint_spec",
    "export_checkpoint", "from_jax_params", "init_params", "load_checkpoint",
    "quantize_attn_int8", "quantize_mlp_int8", "random_checkpoint",
    "save_checkpoint",
]
