"""birefnet_tpu_torch: the PyTorch/CUDA port of the BiRefNet inference
framework, for one NVIDIA H100.

The package mirrors birefnet_tpu's module names (configs, params, ops,
models, pipeline, serve, utils) and keeps its layouts at the public
functions (NHWC activations). It imports torch and never jax; the JAX
package stays the reference it is tested against. The TPU kernels of the
Swin-L inference path (bf16, and W8A8 int8 at the wide stages) are
hand-written Hopper kernels under ops/kernels/ (sources in csrc/), built
with nvcc at first use.
"""

from .configs import (IMAGENET_MEAN, IMAGENET_STD, BiRefNetConfig,
                      ComputeConfig, SwinConfig)
from .params import (build_param_tree, checkpoint_spec, from_jax_params,
                     load_checkpoint, quantize_attn_int8, quantize_mlp_int8,
                     random_checkpoint)

__all__ = [
    "BiRefNetConfig", "ComputeConfig", "SwinConfig",
    "IMAGENET_MEAN", "IMAGENET_STD", "build_param_tree", "checkpoint_spec",
    "from_jax_params", "load_checkpoint", "quantize_attn_int8",
    "quantize_mlp_int8", "random_checkpoint",
]
