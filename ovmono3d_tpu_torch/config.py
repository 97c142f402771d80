"""Model configuration for the port: the fields the oracle-2D LIFT path reads.

Same names and defaults as ovmono3d_tpu/config.py (a test holds them field
by field against the JAX dataclasses). YAML loading and the solver, input,
dataset and test sections arrive with the slices that read them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class BackboneConfig:
    name: str = "dinov2"            # only dinov2 is ported
    patch_size: int = 14
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    pretrain_grid: int = 37
    use_depth_fusion: bool = True
    layerscale: bool = True
    remat: bool = False             # training: ROADMAP slice 3
    out_channels: int = 256         # SFP channels
    scale_factors: tuple[float, ...] = (2.0, 1.0, 0.5)
    square_pad: int = 896           # fixed input side
    quant: str = "none"             # int8 serving: ROADMAP slice 7


@dataclass(frozen=True)
class RPNConfig:
    # The pooled levels; the rest of the RPN is ROADMAP slice 2.
    in_features: tuple[str, ...] = ("p2", "p3", "p4")


@dataclass(frozen=True)
class CubeHeadConfig:
    num_conv: int = 0
    conv_dim: int = 256
    num_fc: int = 2
    fc_dim: int = 1024
    shared_fc: bool = True
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 2
    z_type: str = "direct"          # direct | sigmoid | log | clusters
    pose_type: str = "6d"           # 6d | quaternion | euler
    cluster_bins: int = 1
    virtual_depth: bool = True
    virtual_focal: float = 512.0
    allocentric_pose: bool = True
    dims_priors_enabled: bool = False
    dims_priors_func: str = "exp"   # exp | sigmoid
    use_confidence: float = 1.0
    scale_roi_boxes: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    num_classes: int = 50
    pixel_mean: tuple[float, float, float] = (123.675, 116.280, 103.530)
    pixel_std: tuple[float, float, float] = (58.395, 57.120, 57.375)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    cube: CubeHeadConfig = field(default_factory=CubeHeadConfig)
    # False: pool in bf16 (the heads read bf16 features); True: f32 pooling.
    exact_roi_pool: bool = False


def flagship_config(square_pad: int = 896) -> ModelConfig:
    """The flagship OVMono3D-LIFT model: DINOv2 ViT-B/14 + SFP (2, 1, 0.5) +
    cube head, 50 classes, at `square_pad`^2 input."""
    bb = dataclasses.replace(BackboneConfig(), square_pad=square_pad)
    return ModelConfig(num_classes=50, backbone=bb)
