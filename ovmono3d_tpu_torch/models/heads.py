"""Detection heads in PyTorch (counterpart of ovmono3d_tpu/models/heads.py):

- RPNHead: detectron2 StandardRPNHead, a shared 3x3 conv and 1x1
  objectness / delta predictors applied to every pyramid level;
- FastRCNNHead: the box head, an FC stack and linear class / box-delta
  predictors (reference fast_rcnn.py);
- CubeHead: the 3D attribute regressor (reference
  cubercnn/modeling/roi_heads/cube_head.py:20-204), an optional 3x3 conv
  stack, shared (or per-output) FC stacks, and linear outputs for the 2D
  center deltas, log dims, pose (6d / quaternion / euler), depth and
  uncertainty.

All run in f32 over NHWC maps or pooled [N, R, R, C] features, with the
flax submodule names so utils/flax_bridge.py maps the parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.layers import lecun_normal_
from ovmono3d_tpu_torch.ops.rotation import (
    copysign,
    euler_angles_to_matrix,
    quaternion_to_matrix,
    rotation_6d_to_matrix,
)

_POSE_DIMS = {"6d": 6, "quaternion": 4, "euler": 3}


def _c2_xavier_(linear: nn.Linear, generator: torch.Generator) -> None:
    """fvcore c2_xavier_fill: uniform(+-sqrt(3 / fan_in)), zero bias."""
    bound = math.sqrt(3.0 / linear.in_features)
    nn.init.uniform_(linear.weight, -bound, bound, generator=generator)
    nn.init.zeros_(linear.bias)


class RPNHead(nn.Module):
    """Shared conv + objectness / delta predictors, applied per level.
    Returns, per level, logits [B, H*W*A] and deltas [B, H*W*A, 4] in
    (h, w, anchor) order."""

    def __init__(self, num_anchors: int, conv_dim: int = 256, device=None):
        super().__init__()
        self.conv = nn.Conv2d(conv_dim, conv_dim, 3, padding=1, device=device)
        self.objectness = nn.Conv2d(conv_dim, num_anchors, 1, device=device)
        self.deltas = nn.Conv2d(conv_dim, num_anchors * 4, 1, device=device)

    def forward(self, feats: list[torch.Tensor]):
        logits, regs = [], []
        for f in feats:                       # [B, H, W, C] f32
            t = F.relu(self.conv(f.permute(0, 3, 1, 2)))
            b = f.shape[0]
            logits.append(self.objectness(t).permute(0, 2, 3, 1).reshape(b, -1))
            regs.append(self.deltas(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return logits, regs

    def init_weights(self, generator: torch.Generator) -> None:
        """detectron2 StandardRPNHead: normal(0.01) weights, zero biases."""
        for conv in (self.conv, self.objectness, self.deltas):
            nn.init.normal_(conv.weight, 0.0, 0.01, generator=generator)
            nn.init.zeros_(conv.bias)


class FastRCNNHead(nn.Module):
    """Box feature MLP + classification / regression predictors over pooled
    [N, R, R, C] features. Returns (scores [N, C+1] logits, deltas
    [N, Creg*4])."""

    def __init__(self, in_dim: int, num_classes: int, num_fc: int = 2,
                 fc_dim: int = 1024, cls_agnostic_bbox_reg: bool = False,
                 device=None):
        super().__init__()
        self.num_fc = num_fc
        d = in_dim
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(d, fc_dim, device=device))
            d = fc_dim
        self.cls_score = nn.Linear(d, num_classes + 1, device=device)
        num_reg = 1 if cls_agnostic_bbox_reg else num_classes
        self.bbox_pred = nn.Linear(d, num_reg * 4, device=device)

    def forward(self, pooled: torch.Tensor):
        x = pooled.float().reshape(pooled.shape[0], -1)     # (i, j, c) order
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return self.cls_score(x), self.bbox_pred(x)

    def init_weights(self, generator: torch.Generator) -> None:
        """c2-xavier FC stack, normal(0.01) / normal(0.001) predictors, zero
        biases."""
        for i in range(self.num_fc):
            _c2_xavier_(getattr(self, f"fc{i + 1}"), generator)
        for lin, std in ((self.cls_score, 0.01), (self.bbox_pred, 0.001)):
            nn.init.normal_(lin.weight, 0.0, std, generator=generator)
            nn.init.zeros_(lin.bias)
_OUTPUTS = ("xy", "dims", "pose", "z", "conf")


class CubeHead(nn.Module):
    """3D attribute regressor. Outputs, with class axes only when
    `dims_priors_enabled`:

      deltas_2d [N, (C,) 2], z [N, (bins,) (C,)], dims [N, (C,) 3],
      pose [N, (C,) 3, 3], uncert [N, (C,)] (>= 0.01) or None.
    """

    def __init__(self, in_channels: int, resolution: int, num_classes: int,
                 num_conv: int = 0, conv_dim: int = 256, num_fc: int = 2,
                 fc_dim: int = 1024, shared_fc: bool = True,
                 z_type: str = "direct", pose_type: str = "6d",
                 cluster_bins: int = 1, dims_priors_enabled: bool = False,
                 use_confidence: float = 1.0, device=None):
        super().__init__()
        if pose_type not in _POSE_DIMS:
            raise ValueError(f"pose_type {pose_type!r}")
        self.num_classes = num_classes
        self.num_conv = num_conv
        self.num_fc = num_fc
        self.shared_fc = shared_fc
        self.pose_type = pose_type
        self.cluster_bins = cluster_bins
        self.dims_priors_enabled = dims_priors_enabled
        self.use_confidence = use_confidence
        ch = in_channels
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", nn.Conv2d(
                ch, conv_dim, 3, padding=1, device=device))
            ch = conv_dim
        in_dim = ch * resolution * resolution
        for name in (("shared",) if shared_fc else _OUTPUTS):
            d = in_dim
            for i in range(num_fc):
                self.add_module(f"{name}_fc{i + 1}",
                                nn.Linear(d, fc_dim, device=device))
                d = fc_dim
        feat_dim = fc_dim if num_fc else in_dim
        mult = num_classes if dims_priors_enabled else 1
        bins = max(cluster_bins, 1)
        self.center_deltas = nn.Linear(feat_dim, mult * 2, device=device)
        self.dims = nn.Linear(feat_dim, mult * 3, device=device)
        self.pose = nn.Linear(feat_dim, mult * _POSE_DIMS[pose_type],
                              device=device)
        self.depth = nn.Linear(feat_dim, mult * bins, device=device)
        self.uncertainty = (nn.Linear(feat_dim, mult, device=device)
                            if use_confidence > 0 else None)

    def _mlp(self, x: torch.Tensor, name: str) -> torch.Tensor:
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"{name}_fc{i + 1}")(x))
        return x

    def forward(self, pooled: torch.Tensor) -> dict:
        x = pooled.float()                                   # [N, R, R, C]
        for i in range(self.num_conv):
            conv = getattr(self, f"conv{i + 1}")
            x = F.relu(conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        n = x.shape[0]
        x = x.reshape(n, -1)                                 # (i, j, c) order
        if self.shared_fc:
            feat = self._mlp(x, "shared")
            feats = {k: feat for k in _OUTPUTS}
        else:
            feats = {k: self._mlp(x, k) for k in _OUTPUTS}

        C = self.num_classes
        deltas_2d = self.center_deltas(feats["xy"])
        dims = self.dims(feats["dims"])
        pose_dims = _POSE_DIMS[self.pose_type]
        pose_flat = self.pose(feats["pose"]).reshape(-1, pose_dims)
        z = self.depth(feats["z"])
        uncert = None
        if self.uncertainty is not None:
            uncert = self.uncertainty(feats["conf"]).clamp(min=0.01)

        if self.pose_type == "6d":
            pose = rotation_6d_to_matrix(pose_flat)
        elif self.pose_type == "quaternion":
            q = pose_flat
            norm = torch.sqrt((q * q).sum(dim=1).clamp(min=1e-12))
            pose = quaternion_to_matrix(q / copysign(norm, q[:, 0])[:, None])
        else:
            pose = euler_angles_to_matrix(pose_flat, "XYZ")

        if self.dims_priors_enabled:
            deltas_2d = deltas_2d.reshape(n, C, 2)
            dims = dims.reshape(n, C, 3)
            pose = pose.reshape(n, C, 3, 3)
            z = (z.reshape(n, self.cluster_bins, C) if self.cluster_bins > 1
                 else z.reshape(n, C))
            if uncert is not None:
                uncert = uncert.reshape(n, C)
        else:
            deltas_2d = deltas_2d.reshape(n, 2)
            dims = dims.reshape(n, 3)
            pose = pose.reshape(n, 3, 3)
            z = (z.reshape(n, self.cluster_bins) if self.cluster_bins > 1
                 else z.reshape(n))
            if uncert is not None:
                uncert = uncert.reshape(n)
        return {"deltas_2d": deltas_2d, "z": z, "dims": dims, "pose": pose,
                "uncert": uncert}

    def init_weights(self, generator: torch.Generator) -> None:
        """Reference init: c2-xavier FC stacks (uniform +-sqrt(3 / fan_in)),
        normal(0.001) outputs, zero biases, uncertainty bias 5.0; flax's
        lecun-normal conv stack."""
        for name, mod in self.named_children():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            elif "_fc" in name:
                bound = math.sqrt(3.0 / mod.in_features)
                nn.init.uniform_(mod.weight, -bound, bound, generator=generator)
            else:
                nn.init.normal_(mod.weight, 0.0, 0.001, generator=generator)
            nn.init.zeros_(mod.bias)
        if self.uncertainty is not None:
            nn.init.constant_(self.uncertainty.bias, 5.0)
