"""Fixed-shape detection outputs and training targets (counterpart of
ovmono3d_tpu/structures.py).

Every field shares the leading dims [B, N] (or [B, M]); invalid slots are
masked by `valid`. Detections mirror the reference's final Instances fields
(roi_heads.py:820-843).
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch


@dataclass
class Boxes2D:
    """Padded 2D boxes. xyxy: [..., N, 4]; valid: [..., N] bool."""

    xyxy: torch.Tensor
    valid: torch.Tensor

    @property
    def centers(self) -> torch.Tensor:
        return 0.5 * (self.xyxy[..., :2] + self.xyxy[..., 2:])

    @property
    def widths(self) -> torch.Tensor:
        return self.xyxy[..., 2] - self.xyxy[..., 0]

    @property
    def heights(self) -> torch.Tensor:
        return self.xyxy[..., 3] - self.xyxy[..., 1]

    def clip(self, h, w) -> "Boxes2D":
        """Boxes clipped to [0, w] x [0, h] (numbers or tensors)."""
        x1, y1, x2, y2 = self.xyxy.unbind(-1)
        zero = torch.zeros_like(x1)
        w = torch.as_tensor(w, dtype=x1.dtype, device=x1.device)
        h = torch.as_tensor(h, dtype=x1.dtype, device=x1.device)
        xyxy = torch.stack([torch.minimum(torch.maximum(x1, zero), w),
                            torch.minimum(torch.maximum(y1, zero), h),
                            torch.minimum(torch.maximum(x2, zero), w),
                            torch.minimum(torch.maximum(y2, zero), h)], -1)
        return Boxes2D(xyxy, self.valid)

    def nonempty(self, threshold: float = 0.0) -> torch.Tensor:
        return (self.widths > threshold) & (self.heights > threshold)


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


def concatenate(dets: list[Detections], axis: int = -2) -> Detections:
    """Every field of `dets` concatenated along `axis`, as the JAX
    package's does (one axis for all fields: -2 is the slot axis of boxes
    [..., N, 4]). A field missing from any of them is None."""
    out = {}
    for f in fields(Detections):
        xs = [getattr(d, f.name) for d in dets]
        out[f.name] = (None if any(x is None for x in xs)
                       else torch.cat(xs, dim=axis))
    return Detections(**out)


def take(det: Detections, idx: torch.Tensor,
         valid: torch.Tensor) -> Detections:
    """Slots gathered by index along the first axis (a post-NMS top-k, for
    instance), `valid` and-ed into the mask."""
    taken = {name: x[idx] for name, x in det.items()}
    out = replace(det, **taken)
    out.valid = out.valid & valid
    return out
