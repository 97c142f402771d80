"""ROIAlignV2 (`aligned=True`) as two dense contractions, in PyTorch.

Counterpart of ovmono3d_tpu/ops/roi_align.py, with the same separable
formulation: bilinear sampling on a regular per-box lattice factorizes, so

    pooled[n, i, j, c] = Ry[n, i, :] @ feat[:, :, c] @ Rx[n, j, :]^T

with Ry/Rx the per-box, bin-averaged interpolation matrices. Fixed S x S
sampling (S = 2) instead of the reference's adaptive count, and dense level
selection over all pyramid levels, exactly as the JAX package does.

Layouts follow the JAX package: feature maps [..., H, W, C] (channels
last), boxes [..., N, 4] XYXY in image coordinates; any leading dims batch.
"""
from __future__ import annotations

import math

import torch


def _interp_matrix(coords: torch.Tensor, size: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """[..., R, S] sample positions along one axis -> [..., R, size] weights:
    the mean over the S samples of the bilinear hat weights, with
    torchvision's borders (positions in (-1, size) clamp into the map,
    positions further out weigh nothing)."""
    oob = (coords < -1.0) | (coords > size)
    c = coords.clamp(0.0, size - 1.0)
    lattice = torch.arange(size, dtype=c.dtype, device=c.device)
    w = (1.0 - (c[..., None] - lattice).abs()).clamp(min=0.0)
    w = w.masked_fill(oob[..., None], 0.0)
    return w.mean(dim=-2).to(dtype)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, stride: int,
              resolution: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlignV2 on one pyramid level.

    feat: [..., H, W, C]; boxes: [..., N, 4] (f32). Returns
    [..., N, R, R, C] in feat's dtype; the contractions accumulate in f32.
    """
    H, W, _ = feat.shape[-3:]
    R, S = resolution, sampling_ratio
    scale = 1.0 / stride
    boxes = boxes.float()
    x1 = boxes[..., 0] * scale - 0.5
    y1 = boxes[..., 1] * scale - 0.5
    x2 = boxes[..., 2] * scale - 0.5
    y2 = boxes[..., 3] * scale - 0.5
    bin_w = (x2 - x1) / R
    bin_h = (y2 - y1) / R
    dev = feat.device
    axis_pos = (torch.arange(R, dtype=torch.float32, device=dev)[:, None]
                + (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S)
    ys = y1[..., None, None] + axis_pos * bin_h[..., None, None]  # [..., N, R, S]
    xs = x1[..., None, None] + axis_pos * bin_w[..., None, None]
    Ry = _interp_matrix(ys, H, feat.dtype)                          # [..., N, R, H]
    Rx = _interp_matrix(xs, W, feat.dtype)                          # [..., N, R, W]
    t = torch.einsum("...nih,...hwc->...niwc", Ry, feat)
    return torch.einsum("...njw,...niwc->...nijc", Rx, t)


def assign_fpn_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                      canonical_size: float = 224.0,
                      canonical_level: int = 4) -> torch.Tensor:
    """detectron2 ROIPooler levels floor(l0 + log2(sqrt(area) / s0)),
    clamped to [min_level, max_level]; int32 [..., N]."""
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0))
    lvl = torch.floor(canonical_level
                      + torch.log2(torch.sqrt(area) / canonical_size + 1e-8))
    return lvl.to(torch.int32).clamp(min_level, max_level)


def multilevel_roi_align(feats: list[torch.Tensor], strides: list[int],
                         boxes: torch.Tensor, resolution: int = 7,
                         sampling_ratio: int = 2,
                         canonical_size: float = 224.0,
                         canonical_level: int = 4) -> torch.Tensor:
    """Pool every box at every level and keep its assigned level's result.

    feats: [..., H_l, W_l, C] maps, fine to coarse, with `strides`. Returns
    [..., N, R, R, C].
    """
    min_level = int(math.log2(strides[0]))
    max_level = int(math.log2(strides[-1]))
    levels = assign_fpn_levels(boxes, min_level, max_level, canonical_size,
                               canonical_level)
    out = None
    for li, (feat, stride) in enumerate(zip(feats, strides)):
        pooled = roi_align(feat, boxes, stride, resolution, sampling_ratio)
        sel = (levels == min_level + li)[..., None, None, None]
        out = (pooled * sel if out is None
               else torch.where(sel, pooled, out))
    return out
