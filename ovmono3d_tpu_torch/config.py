"""Configuration for the port: typed frozen dataclasses, YAML files with
`_BASE_` inheritance, and `dotted.path=value` overrides.

Same names and defaults as ovmono3d_tpu/config.py (a test holds them field
by field against the JAX dataclasses), and `load_config` / `oracle2d_file`
are copies of its functions: every file under configs/ loads to the same
values in both packages. The port carries the fields its paths read and the
ones the shipped YAML files set, the remat policy and gradient accumulation
among them; the JAX package's attention-backend switch has no field here,
and a YAML file that sets it is refused as an unknown key.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass(frozen=True)
class BackboneConfig:
    name: str = "dinov2"            # models/backbones.py build_backbone
    model_name: str = "vitb14"
    patch_size: int = 14
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    pretrain_grid: int = 37
    use_depth_fusion: bool = True
    layerscale: bool = True
    freeze: bool = True             # requires_grad=False on the trunk
    remat: bool = False             # checkpoint the trunk's plain blocks
    remat_policy: str = "dots_attn"  # full | dots | dots_attn: what a
                                    # rematerialized block keeps for its
                                    # backward (models/vit.py)
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
    max_detections: int = 100       # padded detections per image (test)


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
    # k micro-steps an optimizer update, the mean of their gradients
    # (train/optim.py with_grad_accum); the LR schedule counts updates,
    # max_iter counts micro-steps.
    grad_accum_steps: int = 1


@dataclass(frozen=True)
class DatasetConfig:
    train: tuple[str, ...] = ("Objectron_train", "Objectron_val")
    test: tuple[str, ...] = ("Objectron_test",)
    test_base: tuple[str, ...] = ("Objectron_test",)
    test_novel: tuple[str, ...] = ()
    category_names: tuple[str, ...] = ()
    category_names_base: tuple[str, ...] = (
        "bicycle", "books", "bottle", "camera", "cereal box", "chair",
        "cup", "laptop", "shoes",
    )
    category_names_novel: tuple[str, ...] = ()
    ignore_names: tuple[str, ...] = ()
    truncation_thres: float = 0.99
    visibility_thres: float = 0.01
    min_height_thres: float = 0.0
    max_depth: float = 1e8
    modal_2d_boxes: bool = False
    trunc_2d_boxes: bool = True
    data_root: str = "datasets"     # base dir for Omni3D jsons/images
    # Directory of per-image prompt-depth .npz files (key 'depth', named
    # <image stem>.npz); empty = no prompt depth.
    depth_dir: str = ""
    oracle2d_eval_mode: str = "target_aware"  # target_aware | previous_metric
    # {eval_mode: {base|novel: {dataset: path}}}, or a flat {dataset: path}.
    oracle2d_files: dict[str, Any] = field(default_factory=dict)
    balance_datasets: bool = False
    repeat_threshold: float = 0.0
    filter_empty_annotations: bool = True


@dataclass(frozen=True)
class TestConfig:
    oracle2d: bool = True
    cat_mode: str = "base"          # base | novel | all
    eval_period: int = 29000        # in-train evaluation period (0 = off)
    visibility_thres: float = 0.5   # the GT ignore decision at evaluation
    truncation_thres: float = 0.5
    detections_per_image: int = 100


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
    input: InputConfig = field(default_factory=InputConfig)
    datasets: DatasetConfig = field(default_factory=DatasetConfig)
    test: TestConfig = field(default_factory=TestConfig)
    output_dir: str = "output"
    seed: int = 5
    vis_period: int = 2320


def flagship_config(square_pad: int = 896) -> ModelConfig:
    """The flagship OVMono3D-LIFT model: DINOv2 ViT-B/14 + SFP (2, 1, 0.5) +
    RPN + box head + cube head, 50 classes, at `square_pad`^2 input."""
    bb = dataclasses.replace(BackboneConfig(), square_pad=square_pad)
    return ModelConfig(num_classes=50, backbone=bb)


# ---------------------------------------------------------------------------
# Loading / overriding (copies of the JAX package's functions)
# ---------------------------------------------------------------------------

def _set_in_dict(d: dict, path: str, value: Any) -> dict:
    """Functionally set a dotted path inside a plain-dict config field."""
    head, _, rest = path.partition(".")
    d = dict(d)
    if rest:
        child = d.get(head)
        d[head] = _set_in_dict(child if isinstance(child, dict) else {},
                               rest, value)
    else:
        d[head] = value
    return d


def _set_by_path(obj: Any, path: str, value: Any) -> Any:
    """Functionally set a dotted path on a (frozen) dataclass tree."""
    head, _, rest = path.partition(".")
    if not dataclasses.is_dataclass(obj):
        raise KeyError(f"cannot descend into non-dataclass at '{head}'")
    names = {f.name: f for f in dataclasses.fields(obj)}
    if head not in names:
        raise KeyError(
            f"unknown config key '{head}' on {type(obj).__name__}; "
            f"valid: {sorted(names)}"
        )
    if rest:
        child = getattr(obj, head)
        if isinstance(child, dict):
            # dict-valued fields (oracle2d_files) take any nested keys.
            return dataclasses.replace(
                obj, **{head: _set_in_dict(child, rest, value)})
        return dataclasses.replace(
            obj, **{head: _set_by_path(child, rest, value)})
    current = getattr(obj, head)
    return dataclasses.replace(obj, **{head: _coerce(value, current)})


def _coerce(value: Any, like: Any) -> Any:
    """Coerce a YAML/CLI value to the type of the existing field value."""
    if isinstance(like, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(like, int) and not isinstance(like, bool):
        return int(value)
    if isinstance(like, float):
        return float(value)
    if isinstance(like, tuple):
        if isinstance(value, str):
            value = [v for v in value.strip("()[]").split(",") if v.strip()]
        elif not isinstance(value, (list, tuple)):
            # A scalar override of a tuple field -> a 1-tuple, like yacs.
            value = [value]
        elem = like[0] if like else value[0] if value else None
        if elem is not None and not isinstance(elem, (tuple, list)):
            return tuple(type(elem)(v) for v in value)
        return tuple(tuple(x) if isinstance(x, list) else x for x in value)
    return value


def _flatten(d: dict, prefix: str = "") -> list[tuple[str, Any]]:
    out = []
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(_flatten(v, key + "."))
        else:
            out.append((key, v))
    return out


def load_config(yaml_path: str | Path | None = None,
                overrides: list[str] | None = None,
                base: Config | None = None) -> Config:
    """Build a Config: defaults -> YAML (with its _BASE_ chain) -> overrides
    (`dotted.path=value` strings, each value parsed as YAML). PyYAML is
    imported here, only when a file or an override needs it."""
    cfg = base or Config()
    if yaml_path is not None:
        import yaml

        yaml_path = Path(yaml_path)
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        if "_BASE_" in data:
            base_rel = data.pop("_BASE_")
            cfg = load_config(yaml_path.parent / base_rel, base=cfg)
        for key, value in _flatten(data):
            cfg = _set_by_path(cfg, key, value)
    for item in overrides or []:
        import yaml

        key, _, value = item.partition("=")
        cfg = _set_by_path(cfg, key.strip(), yaml.safe_load(value.strip()))
    return cfg


def oracle2d_file(ds_cfg: DatasetConfig, dataset: str,
                  cat_mode: str) -> str | None:
    """The oracle-2D detection JSON of a test dataset:
    `oracle2d_files[eval_mode][cat_mode][dataset]` (cat_mode "all" reads
    "base"), or a flat `{dataset: path}`; None when none is configured."""
    files = ds_cfg.oracle2d_files or {}
    sub = files.get(ds_cfg.oracle2d_eval_mode)
    if isinstance(sub, dict):
        mode = cat_mode if cat_mode in ("base", "novel") else "base"
        per_mode = sub.get(mode)
        if isinstance(per_mode, dict):
            path = per_mode.get(dataset)
            return path if isinstance(path, str) else None
        return None
    path = files.get(dataset)
    return path if isinstance(path, str) else None
