"""Fixed-shape detection outputs and training targets (counterpart of
ovmono3d_tpu/structures.py).

Every field shares the leading dims [B, N] (or [B, M]); invalid slots are
masked by `valid`. Detections mirror the reference's final Instances fields
(roi_heads.py:820-843).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch


@dataclass
class Detections:
    boxes: torch.Tensor                         # [B, N, 4] xyxy, original image
    scores: torch.Tensor                        # [B, N]
    classes: torch.Tensor                       # [B, N] int32
    valid: torch.Tensor                         # [B, N] bool
    scores_full: torch.Tensor | None = None     # [B, N, C] (2D detector)
    center_cam: torch.Tensor | None = None      # [B, N, 3]
    center_2d: torch.Tensor | None = None       # [B, N, 2]
    dimensions: torch.Tensor | None = None      # [B, N, 3] (w, h, l)
    pose: torch.Tensor | None = None            # [B, N, 3, 3]
    corners3d: torch.Tensor | None = None       # [B, N, 8, 3]

    def items(self) -> list[tuple[str, torch.Tensor]]:
        """(name, tensor) for every field that is set."""
        return [(f.name, getattr(self, f.name)) for f in fields(self)
                if getattr(self, f.name) is not None]


@dataclass
class GroundTruth:
    """Padded per-image ground truth for training. boxes3d is
    [u, v, z, w, h, l, X, Y, Z]: (u, v) the projected 3D center in
    network-input pixels, z the metric depth, (w, h, l) the dimensions and
    (X, Y, Z) the camera-space center."""

    boxes: torch.Tensor                         # [B, M, 4] xyxy, input coords
    classes: torch.Tensor                       # [B, M] int (-1 = ignore)
    boxes3d: torch.Tensor                       # [B, M, 9]
    poses: torch.Tensor                         # [B, M, 3, 3]
    valid: torch.Tensor                         # [B, M] bool
