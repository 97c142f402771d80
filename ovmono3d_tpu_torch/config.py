"""Configuration for the port: the fields the oracle-2D LIFT path, the
training step and open-vocabulary serving read.

Same names and defaults as ovmono3d_tpu/config.py (a test holds them field
by field against the JAX dataclasses). YAML loading and the dataset and
evaluation sections arrive with the slices that read them.
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
    freeze: bool = True             # requires_grad=False on the ViT trunk
    remat: bool = False             # activation checkpointing: queued
    out_channels: int = 256         # SFP channels
    scale_factors: tuple[float, ...] = (2.0, 1.0, 0.5)
    square_pad: int = 896           # fixed input side
    quant: str = "none"             # "int8": W8A8 serving of the trunk's
                                    # qkv/proj/fc1/fc2 (ops/quant.py;
                                    # SERVING-only)
    gelu: str = "erf"               # "tanh": approximate-GELU serving
                                    # epilogue of the trunk MLPs


@dataclass(frozen=True)
class AnchorConfig:
    sizes: tuple[tuple[float, ...], ...] = ((64.0,), (256.0,), (512.0,))
    aspect_ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    offset: float = 0.0


@dataclass(frozen=True)
class RPNConfig:
    in_features: tuple[str, ...] = ("p2", "p3", "p4")
    pre_nms_topk_train: int = 2000  # per level
    pre_nms_topk_test: int = 1000
    post_nms_topk_train: int = 1000
    post_nms_topk_test: int = 1000
    nms_thresh: float = 0.7
    iou_thresholds: tuple[float, float] = (0.05, 0.05)
    positive_fraction: float = 1.0
    batch_size_per_image: int = 256
    ignore_threshold: float = 0.5
    objectness: str = "IoUness"
    boundary_thresh: float = -1.0
    loss_weight: float = 1.0
    min_box_size: float = 0.0


@dataclass(frozen=True)
class ROIBoxConfig:
    in_features: tuple[str, ...] = ("p2", "p3", "p4")
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 2
    num_fc: int = 2
    fc_dim: int = 1024
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    iou_thresholds: tuple[float, ...] = (0.5,)
    score_thresh_test: float = 0.01
    nms_thresh_test: float = 0.5
    detections_per_image: int = 100
    smooth_l1_beta: float = 0.0
    cls_agnostic_bbox_reg: bool = False
    bbox_reg_weights: tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)


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
    disentangled_loss: bool = True
    chamfer_pose: bool = True
    dims_priors_enabled: bool = False
    dims_priors_func: str = "exp"   # exp | sigmoid
    use_confidence: float = 1.0
    inverse_z_weight: bool = False
    scale_roi_boxes: float = 0.0
    loss_w_3d: float = 1.0
    loss_w_xy: float = 1.0
    loss_w_z: float = 1.0
    loss_w_dims: float = 1.0
    loss_w_pose: float = 1.0
    loss_w_joint: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    num_classes: int = 50
    pixel_mean: tuple[float, float, float] = (123.675, 116.280, 103.530)
    pixel_std: tuple[float, float, float] = (58.395, 57.120, 57.375)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    anchors: AnchorConfig = field(default_factory=AnchorConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    roi_box: ROIBoxConfig = field(default_factory=ROIBoxConfig)
    cube: CubeHeadConfig = field(default_factory=CubeHeadConfig)
    # False: pool in bf16 (the heads read bf16 features); True: f32 pooling.
    exact_roi_pool: bool = False
    stabilize: float = 0.01         # skip fraction that triggers a restart
    max_proposals: int = 512        # padded proposals per image (train)


@dataclass(frozen=True)
class SolverConfig:
    type: str = "sgd"               # sgd | adam | adamw (+amsgrad variants)
    ims_per_batch: int = 32
    base_lr: float = 0.12
    momentum: float = 0.9
    weight_decay: float = 0.0001
    weight_decay_norm: float = 0.0
    # None = biases follow weight_decay (detectron2 WEIGHT_DECAY_BIAS).
    weight_decay_bias: float | None = None
    adam_eps: float = 1e-2          # all reference adam variants
    bias_lr_factor: float = 1.0
    steps: tuple[int, ...] = (69600, 92800)
    gamma: float = 0.1
    max_iter: int = 41000
    warmup_iters: int = 3625
    warmup_factor: float = 1.0 / 1000
    clip_gradients: float = 0.0
    checkpoint_period: int = 9999
    max_training_attempts: int = 10


@dataclass(frozen=True)
class TestConfig:
    eval_period: int = 29000        # in-train evaluation period (0 = off)


@dataclass(frozen=True)
class InputConfig:
    min_size_train: tuple[int, ...] = (532,)
    min_size_test: int = 532        # ResizeShortestEdge at serving time
    max_size_train: int = 896
    max_size_test: int = 896
    random_flip: bool = True
    train_set_percentage: float = 1.0
    depth_size: tuple[int, int] = (800, 600)
    format: str = "RGB"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    test: TestConfig = field(default_factory=TestConfig)
    input: InputConfig = field(default_factory=InputConfig)


def flagship_config(square_pad: int = 896) -> ModelConfig:
    """The flagship OVMono3D-LIFT model: DINOv2 ViT-B/14 + SFP (2, 1, 0.5) +
    RPN + box head + cube head, 50 classes, at `square_pad`^2 input."""
    bb = dataclasses.replace(BackboneConfig(), square_pad=square_pad)
    return ModelConfig(num_classes=50, backbone=bb)
