"""Fixed-shape non-maximum suppression in PyTorch (counterpart of
ovmono3d_tpu/ops/nms.py).

Every function returns a fixed-size keep *mask* rather than a list of kept
indices, so nothing waits on the host. Suppression is torchvision's: a box
goes when its IoU with a kept, higher-scoring box is strictly above the
threshold. Score order is a stable descending sort, so ties keep index
order as in the JAX package, and the keep masks agree with it bit for bit.
"""
from __future__ import annotations

import torch

from ovmono3d_tpu_torch.ops.iou2d import pairwise_iou


def _sorted(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """Score order (stable, high to low, invalid last) and the boxes and
    valid flags in that order, over the last axis."""
    neg_inf = torch.finfo(scores.dtype).min
    masked = torch.where(valid, scores, torch.full_like(scores, neg_inf))
    order = torch.argsort(-masked, dim=-1, stable=True)
    boxes_sorted = torch.gather(boxes, -2, order[..., None].expand_as(boxes))
    return order, boxes_sorted, torch.gather(valid, -1, order)


def _unsort(keep_sorted: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Serial greedy NMS over one set of boxes [N, 4] with scores [N]:
    the reference algorithm, one step per box. Returns keep [N] bool."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    order, boxes_sorted, valid_sorted = _sorted(boxes, scores, valid)
    suppress_edge = pairwise_iou(boxes_sorted, boxes_sorted) > iou_threshold
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    alive = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        is_kept = alive[i] & valid_sorted[i]
        keep[i] = is_kept
        alive = alive & ~(is_kept & suppress_edge[i])
    return _unsort(keep, order)


def nms_mask_parallel(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_threshold: float, valid: torch.Tensor | None = None,
                      iters: int = 32) -> torch.Tensor:
    """Greedy NMS as a parallel fixpoint iteration, over any leading batch
    dims: boxes [..., N, 4], scores / valid [..., N] -> keep [..., N].

    Greedy NMS is the fixpoint of keep[i] = valid[i] and no kept j before i
    (in score order) has iou(j, i) > t. Starting from keep = valid, each
    round is one dense masked reduction; the fixpoint is reached within the
    suppression-chain depth. Exactly `iters` rounds run, with no host sync:
    once the mask has converged further rounds leave it as it is, so this
    equals the JAX package's early-exiting loop, which also stops after
    `iters` rounds when the chain is deeper.
    """
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
    order, boxes_sorted, valid_sorted = _sorted(boxes, scores, valid)
    n = scores.shape[-1]
    tri = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    # suppress[..., j, i]: earlier j can suppress later i.
    suppress = (pairwise_iou(boxes_sorted, boxes_sorted) > iou_threshold) & tri
    keep = valid_sorted
    for _ in range(iters):
        killed = (suppress & keep[..., :, None]).any(dim=-2)
        keep = valid_sorted & ~killed
    return _unsort(keep, order)


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     classes: torch.Tensor, iou_threshold: float,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """Class-aware NMS by the coordinate-offset trick (detectron2
    batched_nms): boxes [..., N, 4] of different classes [..., N] never
    suppress each other; leading dims are independent sets (images). The
    offset span is taken over each set's finite, valid boxes only, so one
    non-finite slot cannot poison every shifted box."""
    ok = torch.isfinite(boxes).all(dim=-1)
    if valid is not None:
        ok = ok & valid
    safe = torch.where(ok[..., None], boxes, torch.zeros_like(boxes))
    span = safe.amax((-2, -1)) - safe.amin((-2, -1)) + 1.0
    shifted = safe + (classes.to(boxes.dtype) * span[..., None])[..., None]
    return nms_mask_parallel(shifted, scores, iou_threshold, ok)


def topk_after_nms(scores: torch.Tensor, keep: torch.Tensor, k: int):
    """The k highest-scoring kept boxes: (indices [k] into the inputs, valid
    [k] marking slots actually filled). Ties keep index order."""
    neg_inf = torch.finfo(scores.dtype).min
    masked = torch.where(keep, scores, torch.full_like(scores, neg_inf))
    top, idx = stable_topk(masked, k)
    return idx, top > neg_inf


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k over the last axis: the k largest values and their
    indices, equal values in index order."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]
