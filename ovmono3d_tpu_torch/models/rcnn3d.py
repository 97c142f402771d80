"""RCNN3D, oracle-2D path, in PyTorch (counterpart of
ovmono3d_tpu/models/rcnn3d.py).

OVMono3D-LIFT inference on given 2D boxes, the reference's evaluation
protocol (reference rcnn3d.py:100-102, roi_heads.py:232-243):

  pixel normalization -> DINOv2 trunk + SFP -> multilevel ROIAlignV2 ->
  cube head -> decode_cube (virtual depth, allocentric pose, 3D lift) ->
  Detections scored sqrt(score * conf).

Batch contract, as in the JAX package (static shapes):
  image           [B, S, S, 3] f32 RGB 0..255 (padded square)
  K               [B, 3, 3]   original-image intrinsics
  im_hw           [B, 2]      valid network-input height/width
  im_scale_ratio  [B]         original / network-input scale
  oracle_boxes/classes/scores/valid: [B, N, ...] given 2D boxes

Learned 2D detection (RPN + box head) is ROADMAP slice 2.
"""
from __future__ import annotations

import torch
from torch import nn

from ovmono3d_tpu_torch.config import ModelConfig
from ovmono3d_tpu_torch.models.backbones import build_backbone
from ovmono3d_tpu_torch.models.heads import CubeHead
from ovmono3d_tpu_torch.ops.roi_align import multilevel_roi_align
from ovmono3d_tpu_torch.structures import Detections
from ovmono3d_tpu_torch.utils import geometry as geom


def decode_cube(cfg, outputs: dict, src_boxes: torch.Tensor,
                classes: torch.Tensor, K_scaled: torch.Tensor,
                focal: torch.Tensor, im_h: torch.Tensor,
                im_ratio: torch.Tensor, priors_dims=None, priors_z_scales=None,
                priors_z_stats=None) -> dict:
    """Cube head outputs -> camera-space cuboids (roi_heads.py:329-848).

    src_boxes [N, 4] input-resolution boxes, classes [N], K_scaled [N, 3, 3]
    network-resolution intrinsics, focal [N] original fy, im_h [N]
    network-input height, im_ratio [N]. Priors: dims [C, 2, 3], z_scales
    [C, bins], z_stats [C, bins, 2].
    """
    n = src_boxes.shape[0]
    idx = torch.arange(n, device=src_boxes.device)

    def percls(x):
        return x[idx, classes] if cfg.dims_priors_enabled else x

    deltas_2d = percls(outputs["deltas_2d"])
    dims_norm = percls(outputs["dims"])
    pose_allo = percls(outputs["pose"])
    uncert = outputs["uncert"]
    if uncert is not None:
        uncert = percls(uncert).reshape(n)

    src_w = src_boxes[:, 2] - src_boxes[:, 0]
    src_h = src_boxes[:, 3] - src_boxes[:, 1]

    z_assign = None
    if cfg.cluster_bins > 1:
        if priors_z_scales is None:
            raise ValueError("cluster_bins > 1 needs priors")
        src_scale = torch.sqrt(src_w**2 + src_h**2)
        if cfg.dims_priors_enabled:
            scales = priors_z_scales[classes]                   # [N, B]
            z_all = outputs["z"][idx, :, classes]               # [N, B]
        else:
            scales = priors_z_scales[0][None].expand(n, cfg.cluster_bins)
            z_all = outputs["z"]
        z_assign = torch.argmin((scales - src_scale[:, None]).abs(), dim=1)
        z_raw = torch.gather(z_all, 1, z_assign[:, None])[:, 0]
    else:
        z_raw = percls(outputs["z"]).reshape(n)

    x = src_boxes[:, 0] + 0.5 * src_w + src_w * deltas_2d[:, 0]
    y = src_boxes[:, 1] + 0.5 * src_h + src_h * deltas_2d[:, 1]

    dims_prior_mean = None
    if cfg.dims_priors_enabled:
        if priors_dims is None:
            raise ValueError("dims_priors_enabled needs priors")
        pd = priors_dims[classes]
        mean, std = pd[:, 0], pd[:, 1]
        dims_prior_mean = mean
        if cfg.dims_priors_func == "sigmoid":
            dims = geom.scaled_sigmoid(dims_norm, (mean - 3 * std).clamp(min=0.0),
                                       mean + 3 * std)
        else:
            dims = torch.exp(dims_norm.clamp(max=5)) * mean
    else:
        dims = torch.exp(dims_norm.clamp(max=5))

    if cfg.allocentric_pose:
        pose = geom.R_from_allocentric(K_scaled, pose_allo, x.detach(),
                                       y.detach())
    else:
        pose = pose_allo

    if cfg.z_type == "sigmoid":
        z_norm = torch.sigmoid(z_raw)
        z = z_norm * 100.0
    elif cfg.z_type == "log":
        z_norm = z_raw
        z = torch.exp(z_raw)
    elif cfg.z_type == "clusters":
        if priors_z_stats is None or z_assign is None:
            raise ValueError("z_type=clusters needs cluster_bins > 1 and priors")
        if cfg.dims_priors_enabled:
            stats = priors_z_stats[classes]                     # [N, B, 2]
        else:
            stats = priors_z_stats[0][None].expand(n, *priors_z_stats[0].shape)
        stats = torch.gather(
            stats, 1, z_assign[:, None, None].expand(n, 1, 2))[:, 0]
        z_mean, z_std = stats[:, 0], stats[:, 1]
        z_norm = z_raw
        z = geom.scaled_sigmoid(z_raw, (z_mean - 3 * z_std).clamp(min=0.0),
                                z_mean + 3 * z_std)
    else:  # direct
        z_norm = z_raw
        z = z_raw
    if cfg.z_type != "clusters":
        z_mean = torch.zeros_like(z)
        z_std = torch.ones_like(z)

    if cfg.virtual_depth:
        v2r = geom.virtual_to_real_scale(focal, im_h * im_ratio,
                                         cfg.virtual_focal, im_h)
        z = z * v2r
    else:
        v2r = torch.ones_like(z)

    center_cam = geom.backproject(K_scaled, torch.stack([x, y], -1), z)
    conf = torch.exp(-uncert) if uncert is not None else torch.ones_like(z)
    corners = geom.cuboid_corners(torch.cat([center_cam, dims], dim=-1), pose)
    return {
        "x": x, "y": y, "z": z, "z_norm": z_norm, "dims": dims,
        "dims_norm": dims_norm, "pose": pose, "pose_allocentric": pose_allo,
        "uncert": uncert, "conf": conf, "center_cam": center_cam,
        "corners": corners, "virtual_to_real": v2r, "deltas_2d": deltas_2d,
        "z_mean": z_mean, "z_std": z_std, "dims_prior_mean": dims_prior_mean,
    }


class RCNN3D(nn.Module):
    """Oracle-2D OVMono3D-LIFT model. `priors` (optional) holds tensors dims
    [C, 2, 3], z_scales [C, B], z_stats [C, B, 2] for the prior decodes."""

    def __init__(self, cfg: ModelConfig, priors: dict | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.priors = priors or {}
        self.backbone = build_backbone(cfg.backbone, device=device)
        cube = cfg.cube
        self.cube_head = CubeHead(
            in_channels=cfg.backbone.out_channels,
            resolution=cube.pooler_resolution,
            num_classes=cfg.num_classes, num_conv=cube.num_conv,
            conv_dim=cube.conv_dim, num_fc=cube.num_fc, fc_dim=cube.fc_dim,
            shared_fc=cube.shared_fc, z_type=cube.z_type,
            pose_type=cube.pose_type, cluster_bins=cube.cluster_bins,
            dims_priors_enabled=cube.dims_priors_enabled,
            use_confidence=cube.use_confidence, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.backbone.init_weights(generator)
        self.cube_head.init_weights(generator)

    def preprocess(self, image: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(self.cfg.pixel_mean, device=image.device)
        std = torch.tensor(self.cfg.pixel_std, device=image.device)
        return (image - mean) / std

    def features(self, image: torch.Tensor,
                 depth: torch.Tensor | None = None) -> dict:
        return self.backbone(self.preprocess(image), depth)

    @property
    def feature_strides(self) -> list[int]:
        names = self.backbone.feature_names
        strides = self.backbone.strides
        return [strides[names.index(n)] for n in self.cfg.rpn.in_features]

    def _pool_flat(self, feats: dict, boxes: torch.Tensor, resolution: int,
                   sampling_ratio: int) -> torch.Tensor:
        """ROIAlign [B, N, 4] boxes over the batched maps -> [B*N, R, R, C].
        Pools in bf16 (the head reads bf16 features) unless exact_roi_pool."""
        maps = [feats[n] for n in self.cfg.rpn.in_features]
        if not self.cfg.exact_roi_pool:
            maps = [m.to(torch.bfloat16) for m in maps]
        pooled = multilevel_roi_align(maps, self.feature_strides, boxes,
                                      resolution, sampling_ratio)
        b, n = pooled.shape[:2]
        return pooled.reshape(b * n, *pooled.shape[2:])

    @staticmethod
    def _camera_per_box(K, im_hw, im_ratio, n: int):
        """Per-box camera tensors, flattened [B*n, ...]."""
        K_scaled = K / im_ratio[:, None, None]
        K_scaled[:, 2, 2] = 1.0
        Kb = K_scaled.repeat_interleave(n, dim=0)
        focal = K[:, 1, 1].repeat_interleave(n, dim=0)
        im_h = im_hw[:, 0].float().repeat_interleave(n, dim=0)
        ratio = im_ratio.repeat_interleave(n, dim=0)
        return Kb, focal, im_h, ratio

    def _run_cube(self, feats, boxes, classes, K, im_hw, im_ratio):
        """Pool + cube head + decode on [B, N] boxes -> decode dict with
        [B, N, ...] leaves, and the per-box intrinsics."""
        b, n = boxes.shape[:2]
        cube = self.cfg.cube
        boxes_pool = boxes
        if cube.scale_roi_boxes > 0:
            ctr = 0.5 * (boxes[..., :2] + boxes[..., 2:])
            half = 0.5 * (boxes[..., 2:] - boxes[..., :2]) * cube.scale_roi_boxes
            boxes_pool = torch.cat([ctr - half, ctr + half], dim=-1)
        pooled = self._pool_flat(feats, boxes_pool, cube.pooler_resolution,
                                 cube.pooler_sampling_ratio)
        outputs = self.cube_head(pooled)
        Kb, focal, im_h, ratio = self._camera_per_box(K, im_hw, im_ratio, n)
        pr = self.priors
        dec = decode_cube(cube, outputs, boxes.reshape(b * n, 4),
                          classes.reshape(b * n), Kb, focal, im_h, ratio,
                          pr.get("dims"), pr.get("z_scales"), pr.get("z_stats"))
        dec = {k: (v.reshape(b, n, *v.shape[1:]) if v is not None else None)
               for k, v in dec.items()}
        return dec, Kb

    def forward(self, image, K, im_hw, im_scale_ratio, depth=None,
                oracle_boxes=None, oracle_classes=None, oracle_scores=None,
                oracle_valid=None) -> Detections:
        """Batched inference on oracle 2D boxes."""
        if oracle_boxes is None:
            raise NotImplementedError("2D detection: ROADMAP slice 2")
        feats = self.features(image, depth)
        classes = oracle_classes.to(torch.int32)
        dec, _ = self._run_cube(feats, oracle_boxes, classes, K, im_hw,
                                im_scale_ratio)
        fused = torch.sqrt((oracle_scores * dec["conf"]).clamp(min=0.0))
        ratio = im_scale_ratio[:, None, None]
        return Detections(
            boxes=oracle_boxes * ratio,
            scores=torch.where(oracle_valid, fused, torch.zeros_like(fused)),
            classes=classes,
            valid=oracle_valid,
            center_cam=dec["center_cam"],
            center_2d=torch.stack([dec["x"], dec["y"]], -1) * ratio,
            dimensions=dec["dims"],
            pose=dec["pose"],
            corners3d=dec["corners"],
        )


def build_model(cfg: ModelConfig, priors: dict | None = None, device=None,
                seed: int = 0) -> RCNN3D:
    """Build the model with weights drawn from torch.Generator(seed), on
    `device`. On "meta" the model has shapes only (no weights).

    Parameters are made on the CPU, filled by the flax-style initializers
    from one generator (so a seed gives the same weights on every device),
    then moved. On CUDA, set torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 to False first: the f32 head and decode
    stand in for the JAX package's Precision.HIGHEST.
    """
    device = torch.device(device or "cpu")
    if device.type == "meta":
        return RCNN3D(cfg, priors, device=device)
    model = RCNN3D(cfg, priors, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
        model.init_weights(torch.Generator().manual_seed(seed))
        unset = [name for name, p in model.named_parameters()
                 if torch.isnan(p).any()]
    if unset:
        raise RuntimeError(f"parameters left uninitialized: {unset}")
    return model.to(device)
