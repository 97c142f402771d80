"""Backbone factory (counterpart of ovmono3d_tpu/models/backbones.py): every
trunk family behind one (images, depth) -> {name: [B, H, W, C]} interface
with static strides, selected by cfg.backbone.name.

Each splits into `trunk_features` and `pyramid` (RCNN3D opens its
model.trunk and model.pyramid spans around them); `forward` is the two.

- `ViTSFPBackbone`: a ViT trunk and the Simple Feature Pyramid, for the
  dinov2, clip, mae, sam and midas presets (the reference's
  build_dino/clip/mae/sam/midas_backbone);
- `CNNFPNBackbone`: a CNN trunk (DLA, ResNet, DenseNet, MNASNet,
  ShuffleNetV2) and the FPN over p2-p6 (build_dla_from_vision_fpn_backbone
  and the torchvision wrappers). The CNNs and the FPN run in f32 over NCHW
  maps with frozen BatchNorms; the pyramid comes out channels-last like the
  SFP's.

`SAM_ARCHS` gives SAM's encoder widths, which the GEO pipeline lays over the
sam preset (geo/cli.py).
"""
from __future__ import annotations

import logging
from typing import Any

import torch
from torch import nn

from ovmono3d_tpu_torch.config import BackboneConfig
from ovmono3d_tpu_torch.models.cnns import DenseNet, MNASNet, ShuffleNetV2
from ovmono3d_tpu_torch.models.dla import DLA, DLA_PRESETS, FPN
from ovmono3d_tpu_torch.models.layers import init_flax_defaults
from ovmono3d_tpu_torch.models.resnet import ResNet
from ovmono3d_tpu_torch.models.sfp import SimpleFeaturePyramid
from ovmono3d_tpu_torch.models.vit import VisionTransformer

logger = logging.getLogger("ovmono3d")

# Architecture presets per family (the JAX package's, from the reference's
# backbone files and configs).
VIT_PRESETS: dict[str, dict[str, Any]] = {
    # dinov2 vitb14 @ 518 pretrain (dino.py).
    "dinov2": dict(patch_size=14, pretrain_grid=37, layerscale=True,
                   pos_interp_offset=0.1),
    # open_clip ViT-B/16 'openai' @ 224 (clip.py): pre-LN tower, QuickGELU
    # MLPs, torch-default LayerNorm eps.
    "clip": dict(patch_size=16, pretrain_grid=14, layerscale=False,
                 pre_ln=True, quick_gelu=True, norm_eps=1e-5),
    # HF ViTMAE base @ 224 (mae.py): fixed 2D sin-cos table rebuilt at the
    # runtime grid, BERT-style LN eps. `tap_offset` -2: the reference reads
    # HF `hidden_states[n_layers - 1]`, which (index 0 being the embeddings)
    # is block n-2's output, an off-by-one kept for checkpoint parity
    # (mae.py:111-113).
    "mae": dict(patch_size=16, pretrain_grid=14, layerscale=False,
                pos_sincos=True, norm_eps=1e-12, tap_offset=-2),
    # segment_anything vit_b @ 1024 (sam.py): windowed, no cls token,
    # global attention every 3rd block, 256-channel neck.
    "sam": dict(patch_size=16, pretrain_grid=64, layerscale=False,
                use_cls_token=False, window_size=14,
                global_blocks=(2, 5, 8, 11), neck_channels=256,
                use_rel_pos=True),
    # MiDaS DPT_Large ViT-L/16 @ 384 (midas_final.py).
    "midas": dict(patch_size=16, pretrain_grid=24, layerscale=False,
                  embed_dim=1024, depth=24, num_heads=16),
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


def vit_trunk_kwargs(cfg: BackboneConfig) -> dict[str, Any]:
    """The trunk's structural fields: the config's for dinov2 (tests and
    benchmarks shrink it); for the fixed foundation trunks the preset wins
    and the config fills only what it leaves. The size-based position resize
    (offset 0) unless the preset says otherwise, as in the JAX module."""
    preset = dict(VIT_PRESETS[cfg.name])
    fields = dict(patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
                  depth=cfg.depth, num_heads=cfg.num_heads,
                  pretrain_grid=cfg.pretrain_grid, layerscale=cfg.layerscale)
    if cfg.name == "dinov2":
        preset.update(fields)
    else:
        for k, v in fields.items():
            preset.setdefault(k, v)
    preset.setdefault("pos_interp_offset", 0.0)
    return preset


class ViTSFPBackbone(nn.Module):
    """ViT trunk + Simple Feature Pyramid (reference dino.py:141-224). The
    pyramid reads the trunk's last features (through SAM's neck, which is
    the pyramid's first part: 256 channels), or block depth-2's for MAE's
    tap."""

    def __init__(self, cfg: BackboneConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = vit_trunk_kwargs(cfg)
        tap = kw.pop("tap_offset", -1)
        self.tap_layer = kw["depth"] + tap if tap != -1 else None
        if self.tap_layer is not None:
            kw["out_layers"] = (*kw.get("out_layers", ()), self.tap_layer)
        # Depth-prompt fusion is a DINO-backbone feature
        # (MODEL.DINO.USE_DEPTH_FUSION, dino.py:83-105).
        fuse = cfg.use_depth_fusion and cfg.name == "dinov2"
        if cfg.use_depth_fusion and not fuse:
            logger.warning(
                "use_depth_fusion is only supported by the dinov2 backbone "
                "(reference MODEL.DINO.USE_DEPTH_FUSION); '%s' runs "
                "without depth fusion", cfg.name)
        self.vit = VisionTransformer(
            use_depth_fusion=fuse, dtype=dtype, device=device,
            remat=cfg.remat, remat_policy=cfg.remat_policy, quant=cfg.quant,
            gelu=cfg.gelu, **kw)
        self.sfp = SimpleFeaturePyramid(
            kw.get("neck_channels") or kw["embed_dim"], cfg.out_channels,
            cfg.scale_factors, trunk_stride=kw["patch_size"], dtype=dtype,
            device=device)

    @property
    def trunk(self) -> nn.Module:
        return self.vit

    @property
    def strides(self) -> list[int]:
        return self.sfp.strides

    @property
    def feature_names(self) -> list[str]:
        return self.sfp.feature_names

    def forward(self, images: torch.Tensor,
                depth: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        return self.pyramid(self.trunk_features(images, depth))

    def trunk_features(self, images: torch.Tensor,
                       depth: torch.Tensor | None = None) -> torch.Tensor:
        """The map the pyramid reads: the ViT's last features (before
        SAM's neck, which the pyramid applies) or its tap."""
        if self.tap_layer is not None:
            return self.vit(images, depth)[f"feat{self.tap_layer}"]
        return self.vit(images, depth, neck=False)["last_feat"]

    def pyramid(self, feat: torch.Tensor) -> dict[str, torch.Tensor]:
        if self.tap_layer is None and self.vit.neck_channels > 0:
            feat = self.vit.neck(feat)
        return self.sfp(feat)

    def init_weights(self, generator: torch.Generator) -> None:
        self.vit.init_weights(generator)
        self.sfp.init_weights(generator)


def _cnn_trunk(name: str, device) -> tuple[str, nn.Module]:
    """(the flax module name, the trunk) of a CNN backbone name."""
    name = "dla34" if name == "dla" else name
    if name in DLA_PRESETS:
        return "dla", DLA(**DLA_PRESETS[name], device=device)
    if name in ("resnet18", "resnet34"):
        depths = (2, 2, 2, 2) if name == "resnet18" else (3, 4, 6, 3)
        return "resnet", ResNet(depths, bottleneck=False, device=device)
    if name in ("resnet", "resnet50", "resnet101"):
        depths = (3, 4, 23, 3) if name == "resnet101" else (3, 4, 6, 3)
        return "resnet", ResNet(depths, device=device)
    if name in ("densenet", "densenet121"):
        return "densenet", DenseNet(device=device)
    if name in ("mnasnet", "mnasnet1_0"):
        return "mnasnet", MNASNet(device=device)
    if name in ("shufflenet", "shufflenet_v2"):
        return "shufflenet", ShuffleNetV2(device=device)
    raise ValueError(f"unknown CNN backbone '{name}'")


class CNNFPNBackbone(nn.Module):
    """CNN trunk + FPN: DLA-34 (the original Cube R-CNN backbone,
    dla.py:417-506) or the torchvision-style trunks (resnet.py:12-96 and the
    others). NHWC images in, NHWC p2-p6 maps out, f32 throughout. The trunk
    sits under its flax name (`dla`, `resnet`, `densenet`, `mnasnet`,
    `shufflenet`)."""

    def __init__(self, cfg: BackboneConfig, device=None):
        super().__init__()
        self.trunk_name, trunk = _cnn_trunk(cfg.name, device)
        self.add_module(self.trunk_name, trunk)
        self.fpn = FPN(trunk.out_channels, cfg.out_channels, device=device)

    @property
    def trunk(self) -> nn.Module:
        return getattr(self, self.trunk_name)

    @property
    def strides(self) -> list[int]:
        return [4, 8, 16, 32, 64]

    @property
    def feature_names(self) -> list[str]:
        return ["p2", "p3", "p4", "p5", "p6"]

    def forward(self, images: torch.Tensor,
                depth: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        return self.pyramid(self.trunk_features(images, depth))

    def trunk_features(self, images: torch.Tensor,
                       depth: torch.Tensor | None = None):
        """The trunk's NCHW levels, which the FPN reads."""
        # NCHW views of the NHWC batch (channels_last strides): no copy.
        return self.trunk(images.permute(0, 3, 1, 2))

    def pyramid(self, feats) -> dict[str, torch.Tensor]:
        return {n: f.permute(0, 2, 3, 1) for n, f in self.fpn(feats).items()}

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun-normal kernels, zero biases, BatchNorm
        scale 1, bias 0, mean 0, var 1."""
        init_flax_defaults(self, generator)


# Every CNN name build_backbone takes, aliases included.
CNN_NAMES = ("dla", *DLA_PRESETS, "resnet", "resnet18", "resnet34",
             "resnet50", "resnet101", "densenet", "densenet121", "mnasnet",
             "mnasnet1_0", "shufflenet", "shufflenet_v2")


def build_backbone(cfg: BackboneConfig, device=None) -> nn.Module:
    if cfg.name in VIT_PRESETS:
        preset = VIT_PRESETS[cfg.name]
        if cfg.remat and (preset.get("window_size")
                          or preset.get("use_rel_pos")):
            logger.warning(
                "backbone.remat only wraps plain (non-windowed, non-rel-pos)"
                " ViT blocks; '%s' keeps its windowed/rel-pos blocks "
                "un-rematerialized", cfg.name)
        return ViTSFPBackbone(cfg, device=device)
    if cfg.name in CNN_NAMES:
        if cfg.remat:
            logger.warning(
                "backbone.remat is not implemented for CNN trunks; '%s' "
                "runs without rematerialization", cfg.name)
        return CNNFPNBackbone(cfg, device=device)
    raise ValueError(f"unknown backbone '{cfg.name}'")
