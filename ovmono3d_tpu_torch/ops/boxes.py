"""Anchors, box delta transforms, IoU matching and label subsampling in
PyTorch (counterpart of ovmono3d_tpu/ops/boxes.py: detectron2's
DefaultAnchorGenerator, Box2BoxTransform, Matcher and the reference
RPNWithIgnore's IoU-weighted subsample_labels).

Everything is fixed-shape and takes leading batch dimensions, so a batch of
images runs as one set of tensor ops with no host synchronisation. The JAX
package's order of f32 operations is kept, so integer and mask outputs agree
bit for bit when both sides see the same inputs (and the same uniform draws).
"""
from __future__ import annotations

import math

import torch

from ovmono3d_tpu_torch.ops.iou2d import pairwise_iou


def generate_anchors(feat_hw: tuple[int, int], stride: int,
                     sizes: tuple[float, ...], aspect_ratios: tuple[float, ...],
                     offset: float = 0.0, device=None) -> torch.Tensor:
    """Dense anchors for one feature level: [H*W*A, 4] xyxy image coords,
    (h, w, a) order; cell anchors of area size^2 and w/h ratio r centred on
    (x + offset) * stride."""
    cell = []
    for size in sizes:
        area = size * size
        for r in aspect_ratios:
            w = math.sqrt(area / r)
            h = w * r
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    cell = torch.tensor(cell, dtype=torch.float32, device=device)   # [A, 4]
    h, w = feat_hw
    shift_x = (torch.arange(w, dtype=torch.float32, device=device)
               + offset) * stride
    shift_y = (torch.arange(h, dtype=torch.float32, device=device)
               + offset) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")       # [H, W]
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    return (shifts + cell[None]).reshape(-1, 4)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0,
                                                               1.0),
                 scale_clamp: float = math.log(1000.0 / 16)) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas: (dx, dy, dw, dh) -> xyxy."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=scale_clamp)
    dh = (deltas[..., 3] / wh).clamp(max=scale_clamp)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h],
                       dim=-1)


def get_deltas(src_boxes: torch.Tensor, target_boxes: torch.Tensor,
               weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0,
                                                             1.0)
               ) -> torch.Tensor:
    """Box2BoxTransform.get_deltas: regression targets src -> target."""
    src_w = src_boxes[..., 2] - src_boxes[..., 0]
    src_h = src_boxes[..., 3] - src_boxes[..., 1]
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h
    tgt_w = (target_boxes[..., 2] - target_boxes[..., 0]).clamp(min=1e-4)
    tgt_h = (target_boxes[..., 3] - target_boxes[..., 1]).clamp(min=1e-4)
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h
    wx, wy, ww, wh = weights
    src_w = src_w.clamp(min=1e-4)
    src_h = src_h.clamp(min=1e-4)
    return torch.stack([wx * (tgt_cx - src_cx) / src_w,
                        wy * (tgt_cy - src_cy) / src_h,
                        ww * torch.log(tgt_w / src_w),
                        wh * torch.log(tgt_h / src_h)], dim=-1)


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, thresholds: tuple[float, float],
                  allow_low_quality: bool = True):
    """detectron2 Matcher with (lo, hi) thresholds and labels (0, -1, 1);
    invalid GT rows are excluded. anchors [..., R, 4] (or [R, 4]), gt_boxes
    [..., M, 4], gt_valid [..., M].

    Returns (matched_idx [..., R], labels [..., R] in {-1, 0, 1},
    matched_iou [..., R], iou [..., M, R] -- the masked quality matrix).
    `allow_low_quality`: the best anchors of each GT become positive.
    """
    iou = pairwise_iou(gt_boxes, anchors)                     # [..., M, R]
    iou = torch.where(gt_valid[..., :, None], iou, torch.full_like(iou, -1.0))
    matched_iou = iou.amax(dim=-2)
    matched_idx = iou.argmax(dim=-2)

    lo, hi = thresholds
    one = torch.ones_like(matched_idx)
    labels = torch.where(matched_iou >= hi, one, -one)
    labels = torch.where(matched_iou < lo, torch.zeros_like(labels), labels)

    if allow_low_quality:
        best_per_gt = iou.amax(dim=-1, keepdim=True)          # [..., M, 1]
        is_best = ((iou >= best_per_gt - 1e-7) & (best_per_gt > 0)
                   & gt_valid[..., :, None])
        labels = torch.where(is_best.any(dim=-2), one, labels)

    return matched_idx, labels, matched_iou.clamp(min=0.0), iou


def uniform_draws(shape, generator: torch.Generator | None = None,
                  device=None) -> torch.Tensor:
    """Uniforms in [1e-10, 1), as jax.random.uniform(minval=1e-10) draws
    them (not the same numbers: tests feed both sides one set)."""
    return torch.rand(shape, generator=generator, device=device).clamp_(
        min=1e-10)


def subsample_labels(labels: torch.Tensor, num_samples: int,
                     positive_fraction: float,
                     matched_ious: torch.Tensor | None = None, *,
                     generator: torch.Generator | None = None,
                     draws: torch.Tensor | None = None):
    """Random (IoU-weighted when `matched_ious` is given) subsampling of the
    positive (label 1) and negative (label 0) entries of labels [..., N].

    Up to num_samples * positive_fraction positives, the rest negatives,
    each drawn without replacement by the Gumbel-top-k trick from weights
    matched_iou + 1e-4 (the reference's multinomial, rpn.py:315-325).
    `draws` [..., 2, N] holds the uniforms for the positive and the negative
    draw (what jax.random.uniform gives from the two halves of the JAX
    key); without it they come from `generator`. Returns (pos_sampled,
    neg_sampled) bool masks [..., N].
    """
    if draws is None:
        draws = uniform_draws((*labels.shape[:-1], 2, labels.shape[-1]),
                              generator, labels.device)
    positive = labels == 1
    negative = labels == 0
    num_pos_target = int(num_samples * positive_fraction)
    if matched_ious is not None:
        w = matched_ious + 1e-4
    else:
        w = torch.ones(labels.shape, dtype=torch.float32,
                       device=labels.device)
    logw = torch.log(w.clamp(min=1e-9))
    n = labels.shape[-1]
    arange = torch.arange(n, device=labels.device).expand(labels.shape)

    def sample(u, mask, count):
        gumbel = -torch.log(-torch.log(u))
        score = torch.where(mask, logw, torch.full_like(logw, -math.inf))
        score = score + gumbel
        order = torch.argsort(-score, dim=-1, stable=True)
        ranks = torch.empty_like(order).scatter_(-1, order, arange)
        avail = mask.sum(dim=-1, keepdim=True)
        return (ranks < torch.minimum(count, avail)) & mask

    pos_sampled = sample(draws[..., 0, :], positive,
                         torch.full_like(positive[..., :1], num_pos_target,
                                         dtype=torch.long))
    num_neg_target = num_samples - pos_sampled.sum(dim=-1, keepdim=True)
    neg_sampled = sample(draws[..., 1, :], negative, num_neg_target)
    return pos_sampled, neg_sampled
