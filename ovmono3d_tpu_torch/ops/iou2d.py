"""Pairwise 2D box overlaps in PyTorch (counterpart of
ovmono3d_tpu/ops/iou2d.py; detectron2's pairwise_iou / pairwise_ioa).

Boxes are XYXY, [..., N, 4]. Every op is dense O(N*M) and keeps the JAX
package's order of f32 operations, so results agree bit for bit.
"""
from __future__ import annotations

import torch

_EPS = 1e-7


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] -> [..., N]. Degenerate boxes get area 0."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def pairwise_intersection(boxes1: torch.Tensor,
                          boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection areas; [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection-over-union [..., N, M]."""
    inter = pairwise_intersection(boxes1, boxes2)
    a1 = box_area(boxes1)[..., :, None]
    a2 = box_area(boxes2)[..., None, :]
    union = a1 + a2 - inter
    return torch.where(union > 0, inter / union.clamp(min=_EPS),
                       torch.zeros_like(inter))


def pairwise_ioa(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection over the area of boxes2: [..., N, M]
    (result[n, m] = inter(b1[n], b2[m]) / area(b2[m]))."""
    inter = pairwise_intersection(boxes1, boxes2)
    a2 = box_area(boxes2)[..., None, :]
    return torch.where(a2 > 0, inter / a2.clamp(min=_EPS),
                       torch.zeros_like(inter))


def matched_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of aligned pairs: [..., N, 4] x [..., N, 4] -> [..., N]."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return torch.where(union > 0, inter / union.clamp(min=_EPS),
                       torch.zeros_like(inter))
