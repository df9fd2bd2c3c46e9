"""Model configurations for the PyTorch/CUDA port of BiRefNet.

Counterpart of birefnet_tpu/configs.py: the same frozen dataclasses, presets
and derived channel math, so a config built here describes exactly the
checkpoint schema and graph the JAX package builds. Only the compute policy
differs: `ComputeConfig.dtype` is a torch dtype, and the options whose code
is not ported raise `NotImplementedError` naming ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Swin Transformer backbone hyperparameters (reference: src/swin.rs:14-88)."""

    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 4
    in_channels: int = 3
    # Present in the reference config but unused at inference.
    drop_path_rate: float = 0.2

    @staticmethod
    def swin_t() -> "SwinConfig":
        return SwinConfig(embed_dim=96, depths=(2, 2, 6, 2),
                          num_heads=(3, 6, 12, 24), window_size=7)

    @staticmethod
    def swin_s() -> "SwinConfig":
        return SwinConfig(embed_dim=96, depths=(2, 2, 18, 2),
                          num_heads=(3, 6, 12, 24), window_size=7)

    @staticmethod
    def swin_b() -> "SwinConfig":
        return SwinConfig(embed_dim=128, depths=(2, 2, 18, 2),
                          num_heads=(4, 8, 16, 32), window_size=12)

    @staticmethod
    def swin_l() -> "SwinConfig":
        """Swin-L preset, used by BiRefNet (reference: src/swin.rs:69-80)."""
        return SwinConfig()

    def stage_channels(self) -> Tuple[int, ...]:
        """Per-stage output channels: embed_dim * 2^i."""
        return tuple(self.embed_dim * (1 << i) for i in range(len(self.depths)))


_SWIN_BACKBONES = {
    "swin_v1_t": SwinConfig.swin_t,
    "swin_v1_s": SwinConfig.swin_s,
    "swin_v1_b": SwinConfig.swin_b,
    "swin_v1_l": SwinConfig.swin_l,
}


@dataclasses.dataclass(frozen=True)
class BiRefNetConfig:
    """Top-level BiRefNet configuration (reference: src/birefnet.rs:13-67)."""

    size: Tuple[int, int] = (1024, 1024)
    backbone: str = "swin_v1_l"
    backbone_channels: Tuple[int, ...] = (192, 384, 768, 1536)
    mul_scl_ipt: bool = True
    ms_supervision: bool = True
    dec_ipt: bool = True
    use_aspp_deformable: bool = True
    cxt: Tuple[int, ...] = (192, 384, 768)

    @staticmethod
    def swin_l() -> "BiRefNetConfig":
        return BiRefNetConfig()

    @staticmethod
    def for_backbone(backbone: str) -> "BiRefNetConfig":
        """Full-model config for any Swin preset backbone (same derivation
        as birefnet_tpu.configs.BiRefNetConfig.for_backbone)."""
        swin = _SWIN_BACKBONES[backbone]()
        ch = swin.stage_channels()
        return BiRefNetConfig(backbone=backbone, backbone_channels=ch,
                              cxt=ch[:3])

    def swin_config(self) -> SwinConfig:
        if self.backbone not in _SWIN_BACKBONES:
            raise ValueError(
                f"unknown backbone {self.backbone!r}; "
                f"known: {sorted(_SWIN_BACKBONES)}")
        swin = _SWIN_BACKBONES[self.backbone]()
        if tuple(self.backbone_channels) != swin.stage_channels():
            raise ValueError(
                f"backbone_channels {self.backbone_channels} do not match "
                f"{self.backbone}'s stage channels {swin.stage_channels()}; "
                f"use BiRefNetConfig.for_backbone({self.backbone!r})")
        return swin

    def lateral_channels(self) -> Tuple[int, ...]:
        mult = 2 if self.mul_scl_ipt else 1
        return tuple(c * mult for c in self.backbone_channels)

    def x4_channels(self) -> int:
        """Squeeze input channels including the cxt concat
        (Swin-L: 3072 + 2*(192+384+768) = 5760)."""
        mult = 2 if self.mul_scl_ipt else 1
        return self.backbone_channels[3] * mult + sum(c * mult for c in self.cxt)

    def ipt_out_channels(self) -> Tuple[int, ...]:
        return (48, 96, 192, 384, 384)

    def ipt_in_channels(self) -> Tuple[int, ...]:
        """image2patches channel counts 3*grid^2 (see the JAX docstring)."""
        return (3, 48, 192, 768, 3072)

    def dec_out_channels(self) -> Tuple[int, ...]:
        lat = self.lateral_channels()
        return (lat[2], lat[1], lat[0], lat[0] // 2)

    def dec_in_channels(self) -> Tuple[int, ...]:
        lat = self.lateral_channels()
        ipt_out = self.ipt_out_channels()
        dec_out = self.dec_out_channels()
        return (
            lat[3] + ipt_out[4],
            dec_out[0] + ipt_out[3],
            dec_out[1] + ipt_out[2],
            dec_out[2] + ipt_out[1],
        )

    def final_channels(self) -> int:
        return self.dec_out_channels()[3] + self.ipt_out_channels()[0]


@dataclasses.dataclass(frozen=True)
class ComputeConfig:
    """Runtime compute policy (counterpart of birefnet_tpu ComputeConfig).

    `use_flash_attention` turns on the kernel tier: the ws=12 Swin blocks
    run the fused block-attention and fused-MLP kernels, the ws=7 blocks
    (swin_t, swin_s) the middle tier (the packed-qkv window-attention
    kernel between plain qkv and proj products, then the fused-MLP
    kernel), the standalone LayerNorms run the row-LN kernel, and the bf16
    decoder head runs the tap-conv kernel (ops/kernels/). The tier follows
    from the window size, as in the JAX package, whose `use_fused_block`
    knob the port does not copy. The tier runs in either `dtype`, as the
    JAX kernels do: bf16 on the bf16 kernels, f32 on their f32 branches
    (GEMMs and window-attention core as three TF32 products each, within
    about 1e-6 of f32 products and summed in f32; f32 row passes), except
    the tap-conv head, which the JAX decoder runs for bf16 only. On a CPU
    tensor every kernel wrapper takes its plain PyTorch version; on a CUDA
    tensor it launches the kernel or raises.

    `int8_mlp` / `int8_attn` select the W8A8 path, as in the JAX package
    (birefnet_tpu/configs.py:277-293): `pipeline.make_infer_fn` quantizes
    the wide Swin blocks' MLP and attention qkv/proj weights once
    (`params.quantize_mlp_int8` / `quantize_attn_int8`, C >= 768: Swin-L
    stages 2 and 3, swin_t stage 3), and the fused MLP and block-attention
    wrappers run their int8 kernels for every block that carries the
    quantized leaves. So int8 engages only on the kernel tier, at C >= 768;
    the unfused path and the ws=7 middle tier's qkv and proj products read
    the `weight` leaves and ignore the quantized ones (int8_attn changes
    nothing at ws=7, as in the JAX package). The int8 kernels take either
    dtype, as the JAX `_kernel_i8` bodies do: f32 activations stay
    unrounded around the int8 products.

    `deform_mode` is "deformable" by default, as in the JAX package:
    faithful modulated deformable sampling at the decoder's 20 ASPP sites
    (ops/deform_conv.py; kernel D1 on the card, on every tier and dtype).
    "regular" ignores the offsets and the modulator and runs the regular
    conv (the reference's CPU semantics, which the mask-MAE gate compares
    against). "deformable-local", the JAX package's offset-clamped sampler
    that exists for the TPU's gather floor, is not ported.
    """

    dtype: torch.dtype = torch.float32
    use_flash_attention: bool = False
    deform_mode: str = "deformable"
    int8_mlp: bool = False
    int8_attn: bool = False

    def __post_init__(self):
        if self.deform_mode not in ("deformable", "regular",
                                    "deformable-local"):
            raise ValueError(f"unknown deform_mode: {self.deform_mode!r}")
        if self.deform_mode == "deformable-local":
            raise NotImplementedError(
                "deform_mode='deformable-local' is not ported: its "
                "offset-clamped sampler exists for the TPU's gather floor "
                "(ROADMAP.md, Standing notes); use 'deformable' (exact) or "
                "'regular'")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, "
                             f"got {self.dtype}")

    def with_overrides(self, **kw) -> "ComputeConfig":
        return dataclasses.replace(self, **kw)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
