"""Backbone factory (counterpart of ovmono3d_tpu/models/backbones.py).

Only the DINOv2 ViT + Simple Feature Pyramid family is ported; the other
families raise NotImplementedError naming their ROADMAP slice.
"""
from __future__ import annotations

import torch
from torch import nn

from ovmono3d_tpu_torch.config import BackboneConfig
from ovmono3d_tpu_torch.models.sfp import SimpleFeaturePyramid
from ovmono3d_tpu_torch.models.vit import VisionTransformer


class ViTSFPBackbone(nn.Module):
    """ViT trunk + Simple Feature Pyramid (reference dino.py:141-224)."""

    def __init__(self, cfg: BackboneConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        if cfg.name != "dinov2":
            raise NotImplementedError(
                f"backbone {cfg.name!r}: ROADMAP slices 6-7 (only dinov2 is "
                "ported)")
        self.vit = VisionTransformer(
            patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
            depth=cfg.depth, num_heads=cfg.num_heads,
            pretrain_grid=cfg.pretrain_grid, layerscale=cfg.layerscale,
            use_depth_fusion=cfg.use_depth_fusion,
            dtype=dtype, device=device, remat=cfg.remat, quant=cfg.quant)
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
    return ViTSFPBackbone(cfg, device=device)
