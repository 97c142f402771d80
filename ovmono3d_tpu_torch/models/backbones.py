"""Backbone factory (counterpart of ovmono3d_tpu/models/backbones.py).

Only the DINOv2 ViT + Simple Feature Pyramid family is ported as a detector
backbone; the other families raise NotImplementedError naming their ROADMAP
items. `VIT_PRESETS["sam"]` and `SAM_ARCHS` describe SAM's image encoder,
which the GEO pipeline builds on its own (geo/cli.py).
"""
from __future__ import annotations

import logging
from typing import Any

import torch
from torch import nn

from ovmono3d_tpu_torch.config import BackboneConfig
from ovmono3d_tpu_torch.models.sfp import SimpleFeaturePyramid
from ovmono3d_tpu_torch.models.vit import VisionTransformer

# The JAX package's preset for segment_anything's image encoder, vit_b at
# 1024^2: windowed, no cls token, global attention every third block, rel-pos
# attention and the 256-channel neck.
VIT_PRESETS: dict[str, dict[str, Any]] = {
    "sam": dict(patch_size=16, pretrain_grid=64, layerscale=False,
                use_cls_token=False, window_size=14,
                global_blocks=(2, 5, 8, 11), neck_channels=256,
                use_rel_pos=True),
}

# Per-arch widths and global-attention blocks of the SAM encoders
# (segment_anything build_sam.py encoder_global_attn_indexes), as the JAX
# package's GEO tool lays them over the preset.
SAM_ARCHS: dict[str, dict[str, Any]] = {
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12,
                  global_blocks=(2, 5, 8, 11)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16,
                  global_blocks=(5, 11, 17, 23)),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16,
                  global_blocks=(7, 15, 23, 31)),
}


class ViTSFPBackbone(nn.Module):
    """ViT trunk + Simple Feature Pyramid (reference dino.py:141-224)."""

    def __init__(self, cfg: BackboneConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        if cfg.name != "dinov2":
            raise NotImplementedError(
                f"backbone {cfg.name!r}: ROADMAP queue 1 items 8 and 9 (only "
                "dinov2 is ported)")
        self.vit = VisionTransformer(
            patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
            depth=cfg.depth, num_heads=cfg.num_heads,
            pretrain_grid=cfg.pretrain_grid, layerscale=cfg.layerscale,
            use_depth_fusion=cfg.use_depth_fusion,
            dtype=dtype, device=device, remat=cfg.remat,
            remat_policy=cfg.remat_policy, quant=cfg.quant, gelu=cfg.gelu)
        self.sfp = SimpleFeaturePyramid(
            cfg.embed_dim, cfg.out_channels, cfg.scale_factors,
            trunk_stride=cfg.patch_size, dtype=dtype, device=device)

    @property
    def strides(self) -> list[int]:
        return self.sfp.strides

    @property
    def feature_names(self) -> list[str]:
        return self.sfp.feature_names

    def forward(self, images: torch.Tensor,
                depth: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        return self.sfp(self.vit(images, depth)["last_feat"])

    def init_weights(self, generator: torch.Generator) -> None:
        self.vit.init_weights(generator)
        self.sfp.init_weights(generator)


def build_backbone(cfg: BackboneConfig, device=None) -> ViTSFPBackbone:
    preset = VIT_PRESETS.get(cfg.name, {})
    if cfg.remat and (preset.get("window_size") or preset.get("use_rel_pos")):
        logging.getLogger("ovmono3d").warning(
            "backbone.remat only wraps plain (non-windowed, non-rel-pos)"
            " ViT blocks; '%s' keeps its windowed/rel-pos blocks "
            "un-rematerialized", cfg.name)
    return ViTSFPBackbone(cfg, device=device)
