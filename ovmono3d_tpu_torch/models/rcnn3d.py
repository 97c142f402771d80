"""RCNN3D in PyTorch (counterpart of ovmono3d_tpu/models/rcnn3d.py).

Inference (`RCNN3D.forward`): OVMono3D-LIFT on given 2D boxes, the
reference's evaluation protocol (reference rcnn3d.py:100-102,
roi_heads.py:232-243), or on the model's own 2D detections when no oracle
boxes are given (`_detect_2d`: RPN proposals -> box head -> per-class boxes
-> `fast_rcnn_inference`):

  pixel normalization -> DINOv2 trunk + SFP -> [RPN + box head] ->
  multilevel ROIAlignV2 -> cube head -> decode_cube (virtual depth,
  allocentric pose, 3D lift) -> Detections scored sqrt(score * conf).

Training (`RCNN3D.compute_losses`): trunk + SFP -> RPN head -> anchor
labeling with IoU-weighted sampling -> IoUness RPN losses; proposals (per
level top-k, decode, clip, per-level NMS, global top-k) + GT boxes ->
proposal sampling -> box head losses; cube head on the sampled boxes ->
disentangled corner / chamfer cube losses. Where the JAX package vmaps a
per-image function, the port writes the batched form: one set of tensor ops
over [B, ...] with no host synchronisation.

Both open spans (utils/trace.py) at their layers: model.trunk (the pixel
normalization and the trunk), model.pyramid (SFP, SAM's neck, FPN),
model.rpn (head, anchors, labels, RPN losses), model.proposals (proposals
and their sampling), model.box_head and model.cube_head (ROIAlign, the
head, its decode and losses).

Batch contract, as in the JAX package (static shapes):
  image           [B, S, S, 3] f32 RGB 0..255 (padded square)
  K               [B, 3, 3]   original-image intrinsics
  im_hw           [B, 2]      valid network-input height/width
  im_scale_ratio  [B]         original / network-input scale
  oracle_boxes/classes/scores/valid: [B, N, ...] given 2D boxes (inference)
  gt              GroundTruth padded to M slots per image (training)
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.config import ModelConfig
from ovmono3d_tpu_torch.models.backbones import build_backbone
from ovmono3d_tpu_torch.models.heads import CubeHead, FastRCNNHead, RPNHead
from ovmono3d_tpu_torch.models.layers import init_seeded
from ovmono3d_tpu_torch.ops import boxes as box_ops
from ovmono3d_tpu_torch.ops.iou2d import pairwise_ioa, pairwise_iou
from ovmono3d_tpu_torch.ops.nms import (batched_nms_mask, nms_mask_parallel,
                                       stable_topk)
from ovmono3d_tpu_torch.ops.roi_align import multilevel_roi_align
from ovmono3d_tpu_torch.ops.rotation import so3_relative_angle
from ovmono3d_tpu_torch.structures import Detections, GroundTruth
from ovmono3d_tpu_torch.utils import geometry as geom
from ovmono3d_tpu_torch.utils.device import (device_constant, disable_tf32,
                                             resolve_device)
from ovmono3d_tpu_torch.utils.trace import span

SQRT_2 = 1.4142135623730951


def smooth_l1(pred, target, beta: float = 0.0):
    diff = (pred - target).abs()
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)


def rpn_proposals(logits: torch.Tensor, deltas: torch.Tensor,
                  anchors: torch.Tensor, level_sizes: tuple[int, ...],
                  im_hw: torch.Tensor, pre_nms_topk: int, post_nms_topk: int,
                  nms_thresh: float, min_box_size: float):
    """detectron2 find_top_rpn_proposals, fixed-shape and batched (the JAX
    package's rpn_proposals_single over images): per-level top-k -> decode
    -> clip -> per-level NMS -> global top-k by score.

    logits [B, R] and deltas [B, R, 4] concatenated over levels, anchors
    [R, 4], im_hw [B, 2] float. NMS runs independently per level (boxes of
    different levels never suppress each other, as in the reference's
    level-offset batched_nms); the levels run as one batched fixpoint, each
    padded to the largest k with invalid slots, which are never kept and
    suppress nothing. Returns boxes [B, P, 4], scores [B, P], valid [B, P].
    """
    b = logits.shape[0]
    h, w = im_hw[:, 0:1], im_hw[:, 1:2]
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    ks = [min(pre_nms_topk, size) for size in level_sizes]
    k_max = max(ks)
    sel_boxes, sel_scores, sel_valid = [], [], []
    start = 0
    for size, k in zip(level_sizes, ks):
        s, idx = stable_topk(logits[:, start:start + size], k)       # [B, k]
        ld = torch.gather(deltas[:, start:start + size], 1,
                          idx[..., None].expand(b, k, 4))
        bx = box_ops.apply_deltas(ld, anchors[start:start + size][idx])
        bx = torch.stack([
            torch.minimum(torch.maximum(bx[..., 0], zero), w),
            torch.minimum(torch.maximum(bx[..., 1], zero), h),
            torch.minimum(torch.maximum(bx[..., 2], zero), w),
            torch.minimum(torch.maximum(bx[..., 3], zero), h),
        ], dim=-1)
        v = ((bx[..., 2] - bx[..., 0] > min_box_size)
             & (bx[..., 3] - bx[..., 1] > min_box_size)
             & torch.isfinite(bx).all(dim=-1) & torch.isfinite(s))
        pad = k_max - k
        sel_boxes.append(F.pad(bx, (0, 0, 0, pad)))
        sel_scores.append(F.pad(s, (0, pad)))
        sel_valid.append(F.pad(v, (0, pad)))
        start += size
    boxes = torch.stack(sel_boxes, 1)                          # [B, L, k, 4]
    scores = torch.stack(sel_scores, 1)
    keep = nms_mask_parallel(boxes, scores, nms_thresh,
                             torch.stack(sel_valid, 1))
    boxes = torch.cat([boxes[:, i, :k] for i, k in enumerate(ks)], 1)
    scores = torch.cat([scores[:, i, :k] for i, k in enumerate(ks)], 1)
    keep = torch.cat([keep[:, i, :k] for i, k in enumerate(ks)], 1)

    neg_inf = torch.finfo(scores.dtype).min
    masked = torch.where(keep, scores, torch.full_like(scores, neg_inf))
    top_scores, idx = stable_topk(masked, post_nms_topk)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(b, -1, 4))
    return top_boxes, top_scores, top_scores > neg_inf


def fast_rcnn_inference(boxes_per_class: torch.Tensor, scores: torch.Tensor,
                        prop_valid: torch.Tensor, im_hw: torch.Tensor,
                        score_thresh: float, nms_thresh: float, topk: int):
    """detectron2 fast_rcnn_inference_single_image, fixed-shape and batched
    (the JAX package's `fast_rcnn_inference_single` over images).

    boxes_per_class [B, N, C, 4], scores [B, N, C] (softmax without the
    background column), prop_valid [B, N], im_hw [B, 2] float. Boxes are
    clipped to the image; candidates above `score_thresh` from valid
    proposals with finite boxes are cut to the best n_cand = min(max(4 topk,
    256), N C) before the class-aware NMS (a candidate outside them enters
    the top `topk` only if NMS kills nearly all better ones), then the
    `topk` best kept ones are taken. Every top-k is `stable_topk`: under
    seeded weights the class scores nearly tie, and equal scores keep index
    order as in the JAX package. Returns boxes [B, K, 4], scores [B, K] (0
    where invalid), classes [B, K], valid [B, K], proposal index [B, K].
    """
    b, n, c = scores.shape
    h, w = im_hw[:, 0, None], im_hw[:, 1, None]
    boxes = boxes_per_class.reshape(b, n * c, 4)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    boxes = torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), w),
        torch.minimum(torch.maximum(boxes[..., 1], zero), h),
        torch.minimum(torch.maximum(boxes[..., 2], zero), w),
        torch.minimum(torch.maximum(boxes[..., 3], zero), h),
    ], dim=-1)
    flat_scores = scores.reshape(b, n * c)
    classes = torch.arange(c, dtype=torch.int32,
                           device=scores.device).repeat(n).expand(b, -1)
    prop_idx = torch.arange(n, dtype=torch.int32, device=scores.device) \
        .repeat_interleave(c).expand(b, -1)
    valid = ((flat_scores > score_thresh)
             & prop_valid.repeat_interleave(c, dim=1)
             & torch.isfinite(boxes).all(-1))
    n_cand = min(max(4 * topk, 256), n * c)
    neg = torch.finfo(flat_scores.dtype).min
    _, cand = stable_topk(torch.where(valid, flat_scores,
                                      torch.full_like(flat_scores, neg)),
                          n_cand)
    boxes = torch.gather(boxes, 1, cand[..., None].expand(b, n_cand, 4))
    flat_scores = torch.gather(flat_scores, 1, cand)
    classes = torch.gather(classes, 1, cand)
    prop_idx = torch.gather(prop_idx, 1, cand)
    valid = torch.gather(valid, 1, cand)
    keep = batched_nms_mask(boxes, flat_scores, classes, nms_thresh, valid)
    top, idx = stable_topk(torch.where(keep, flat_scores,
                                       torch.full_like(flat_scores, neg)),
                           topk)
    det_valid = top > score_thresh
    return (torch.gather(boxes, 1, idx[..., None].expand(b, topk, 4)),
            torch.where(det_valid, top, torch.zeros_like(top)),
            torch.gather(classes, 1, idx), det_valid,
            torch.gather(prop_idx, 1, idx))


def label_anchors(anchors: torch.Tensor, gt: GroundTruth,
                  iou_thresholds: tuple[float, float], batch_size: int,
                  positive_fraction: float, ignore_threshold: float,
                  draws: torch.Tensor):
    """RPNWithIgnore.label_and_sample_anchors (rpn.py:40-110), batched (the
    JAX package's label_anchors_single over images). anchors [R, 4], gt
    [B, M]; `draws` [B, 2, R] are the sampling uniforms.

    Returns (fg_mask [B, R] sampled positives, matched_gt_boxes [B, R, 4],
    iou_targets [B, R]). The negative sample is not computed: the IoUness
    losses are foreground-only (rpn.py:206-273), and ignore regions only
    affect negatives, so `ignore_threshold` is unused as in the JAX package.
    """
    del ignore_threshold
    fg_gt = gt.valid & (gt.classes >= 0)
    matched_idx, labels, matched_iou, iou_full = box_ops.match_anchors(
        anchors, gt.boxes, fg_gt, iou_thresholds, allow_low_quality=True)
    pos_sampled, _ = box_ops.subsample_labels(
        labels, batch_size, positive_fraction, matched_iou, draws=draws)
    # The single best anchor per GT survives sampling (rpn.py:71-84: the
    # first index on exact ties), if the matcher labeled it positive.
    best_idx = iou_full.argmax(dim=-1)                          # [B, M]
    gt_has_best = fg_gt & (iou_full.amax(dim=-1) > 0)
    force_anchor = torch.zeros_like(labels).scatter_reduce_(
        -1, best_idx, gt_has_best.to(labels.dtype), reduce="amax")
    fg_mask = pos_sampled | ((force_anchor > 0) & (labels == 1))
    matched_boxes = torch.gather(
        gt.boxes, 1, matched_idx[..., None].expand(*matched_idx.shape, 4))
    return fg_mask, matched_boxes, matched_iou


def sample_proposals(prop_boxes: torch.Tensor, prop_valid: torch.Tensor,
                     gt: GroundTruth, num_samples: int,
                     positive_fraction: float, iou_threshold: float,
                     ignore_threshold: float, num_classes: int,
                     draws: torch.Tensor) -> dict:
    """ROIHeads3D.label_and_sample_proposals (roi_heads.py:850-953),
    fixed-shape and batched (the JAX package's sample_proposals_single over
    images). prop_boxes [B, P, 4] (GT boxes already appended), prop_valid
    [B, P]; `draws` [B, 2, P] are the sampling uniforms.

    Returns a dict of sampled slots [B, S]: boxes, classes (background =
    num_classes), fg, valid and gt_idx (the matched GT slot). Sampled slots
    come first, positives before negatives, each in proposal order.
    """
    fg_gt = gt.valid & (gt.classes >= 0)
    ign_gt = gt.valid & (gt.classes < 0)
    iou = pairwise_iou(gt.boxes, prop_boxes)                    # [B, M, P]
    iou = torch.where(fg_gt[..., None], iou, torch.full_like(iou, -1.0))
    matched_iou = iou.amax(dim=-2).clamp(min=0.0)
    matched_idx = iou.argmax(dim=-2)

    one = torch.ones_like(matched_idx)
    labels = torch.where(matched_iou >= iou_threshold, one, 0 * one)
    # Only background proposals inside ignore regions are excluded
    # (roi_heads.py:909-917).
    ioa = pairwise_ioa(gt.boxes, prop_boxes)
    ioa = torch.where(ign_gt[..., None], ioa, torch.zeros_like(ioa))
    in_ignore = ioa.amax(dim=-2) >= ignore_threshold
    labels = torch.where((in_ignore & (labels == 0)) | ~prop_valid, -one,
                         labels)

    pos_sampled, neg_sampled = box_ops.subsample_labels(
        labels, num_samples, positive_fraction, matched_iou, draws=draws)
    rank = pos_sampled.long() * 2 + neg_sampled.long()
    p = prop_boxes.shape[1]
    order_score = rank * (p + 1) - torch.arange(p, device=rank.device)
    _, sel = stable_topk(order_score, num_samples)
    sel_rank = torch.gather(rank, 1, sel)
    valid = sel_rank > 0
    fg = sel_rank == 2
    gt_idx = torch.gather(matched_idx, 1, sel)
    bg = torch.full_like(gt_idx, num_classes)
    classes = torch.where(fg, torch.gather(gt.classes.long(), 1, gt_idx), bg)
    return {
        "boxes": torch.gather(prop_boxes, 1,
                              sel[..., None].expand(*sel.shape, 4)),
        "classes": torch.where(valid, classes, bg),
        "fg": fg,
        "valid": valid,
        "gt_idx": gt_idx,
    }


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


def _count(n: torch.Tensor, count_reduce=None) -> torch.Tensor:
    """A loss normalizer: this process's count, or the whole batch's
    through `count_reduce` (compute_losses)."""
    return n if count_reduce is None else count_reduce(n)


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                count_reduce=None) -> torch.Tensor:
    """Mean over slots where mask > 0 and the value is finite
    (safely_reduce_losses, roi_heads.py:956-964); the count over the whole
    batch with `count_reduce`."""
    finite = torch.isfinite(x)
    w = mask.to(x.dtype) * finite.to(x.dtype)
    x = torch.where(finite, x, torch.zeros_like(x))
    return (x * w).sum() / _count(w.sum(), count_reduce).clamp(min=1.0)


def box_head_losses(box_cfg, num_classes: int, scores_logits: torch.Tensor,
                    box_deltas: torch.Tensor, flat_classes: torch.Tensor,
                    flat_valid: torch.Tensor, flat_fg: torch.Tensor,
                    flat_boxes: torch.Tensor,
                    matched_gt_boxes: torch.Tensor, count_reduce=None):
    """Fast R-CNN box-head losses (reference fast_rcnn.py:145-260).

    loss_cls: softmax cross-entropy over the valid sampled proposals, mean.
    loss_reg: smooth-L1 of the (per-class or agnostic) deltas of foreground
    proposals against the encoded GT deltas, summed and divided by the number
    of valid proposals, not the foreground count (fast_rcnn.py:179-243).
    """
    log_probs = F.log_softmax(scores_logits, dim=-1)
    ce = -log_probs.gather(-1, flat_classes[:, None].long())[:, 0]
    loss_cls = masked_mean(ce, flat_valid, count_reduce)
    reg_targets = box_ops.get_deltas(flat_boxes, matched_gt_boxes,
                                     box_cfg.bbox_reg_weights)
    n = flat_classes.shape[0]
    if box_cfg.cls_agnostic_bbox_reg:
        pred_reg = box_deltas
    else:
        cls_for_reg = flat_classes.long().clamp(max=num_classes - 1)
        pred_reg = box_deltas.reshape(n, num_classes, 4).gather(
            1, cls_for_reg[:, None, None].expand(n, 1, 4))[:, 0]
    reg_loss = smooth_l1(pred_reg, reg_targets, box_cfg.smooth_l1_beta).sum(-1)
    n_valid = _count(flat_valid.sum().float(), count_reduce)
    loss_reg = (reg_loss * flat_fg.float()).sum() / n_valid.clamp(min=1.0)
    return loss_cls, loss_reg


def cube_losses(cfg, dec: dict, gt_boxes3d: torch.Tensor,
                gt_poses: torch.Tensor, K_scaled: torch.Tensor,
                fg_mask: torch.Tensor,
                src_boxes: torch.Tensor | None = None,
                count_reduce=None) -> dict:
    """Cube losses, fixed-shape, masked-mean reduced over foreground slots.

    Disentangled corner losses (roi_heads.py:551-627) by default, with the
    chamfer pose loss when cfg.chamfer_pose; with cfg.disentangled_loss
    False the delta / log-space l1 losses and the `1 - cos` pose loss
    (roi_heads.py:630-673). gt_boxes3d [N, 9] (u, v, z, w, h, l, X, Y, Z),
    gt_poses / K_scaled [N, 3, 3], fg_mask [N] 1.0 = supervised slot.
    """
    gt_2d = gt_boxes3d[:, :2]
    gt_z = gt_boxes3d[:, 2]
    gt_dims = gt_boxes3d[:, 3:6]
    gt_center = geom.backproject(K_scaled, gt_2d, gt_z)
    gt_box3d = torch.cat([gt_center, gt_dims], dim=-1)
    gt_corners = geom.cuboid_corners(gt_box3d, gt_poses)

    def corner_l1(pred_corners):
        d = (pred_corners - gt_corners).abs()
        return d.reshape(d.shape[0], -1).mean(dim=1)

    def corners(center, dims, pose):
        return geom.cuboid_corners(torch.cat([center, dims], -1), pose)

    xy = torch.stack([dec["x"], dec["y"]], -1)
    if cfg.disentangled_loss:
        loss_z = corner_l1(corners(geom.backproject(K_scaled, gt_2d, dec["z"]),
                                   gt_dims, gt_poses))
        loss_xy = corner_l1(corners(geom.backproject(K_scaled, xy, gt_z),
                                    gt_dims, gt_poses))
        loss_dims = corner_l1(corners(gt_center, dec["dims"], gt_poses))
        pose_corners = geom.cuboid_corners(gt_box3d, dec["pose"])
        if cfg.chamfer_pose:
            loss_pose = geom.chamfer_corner_distance(pose_corners, gt_corners)
        else:
            loss_pose = corner_l1(pose_corners)
    else:
        if src_boxes is None:
            raise ValueError("the non-disentangled xy loss needs src_boxes")
        src_w = (src_boxes[:, 2] - src_boxes[:, 0]).clamp(min=1e-4)
        src_h = (src_boxes[:, 3] - src_boxes[:, 1]).clamp(min=1e-4)
        src_cx = src_boxes[:, 0] + 0.5 * src_w
        src_cy = src_boxes[:, 1] + 0.5 * src_h
        gt_deltas = torch.stack([(gt_2d[:, 0] - src_cx) / src_w,
                                 (gt_2d[:, 1] - src_cy) / src_h], dim=-1)
        loss_xy = (dec["deltas_2d"] - gt_deltas).abs().mean(-1)
        # Dims: log-space l1; with priors the target is prior-normalised,
        # log(gt / prior) (roi_heads.py:644-649).
        gt_dims_safe = gt_dims.clamp(min=1e-4)
        if cfg.dims_priors_enabled and dec.get("dims_prior_mean") is not None:
            dims_target = torch.log(
                gt_dims_safe / dec["dims_prior_mean"].clamp(min=1e-4))
        else:
            dims_target = torch.log(gt_dims_safe)
        loss_dims = (dec["dims_norm"] - dims_target).abs().mean(-1)
        # Pose: 1 - cos(relative angle), allocentric (roi_heads.py:652-657).
        if cfg.allocentric_pose:
            gt_allo = geom.R_to_allocentric(K_scaled, gt_poses,
                                            dec["x"].detach(),
                                            dec["y"].detach())
            loss_pose = 1.0 - so3_relative_angle(
                dec["pose_allocentric"], gt_allo, eps=0.1, cos_angle=True)
        else:
            loss_pose = 1.0 - so3_relative_angle(dec["pose"], gt_poses,
                                                 eps=0.1, cos_angle=True)
        # Z per z_type (roi_heads.py:663-673).
        r2v = 1.0 / dec["virtual_to_real"].clamp(min=1e-8)
        if cfg.z_type == "sigmoid":
            loss_z = (dec["z_norm"] - (gt_z * r2v / 100.0).clamp(0, 1)).abs()
        elif cfg.z_type == "log":
            loss_z = (dec["z_norm"]
                      - torch.log((gt_z * r2v).clamp(min=0.01))).abs()
        elif cfg.z_type == "clusters":
            loss_z = (dec["z_norm"] - (gt_z * r2v - dec["z_mean"])
                      / dec["z_std"].clamp(min=1e-8)).abs()
        else:  # direct
            loss_z = (dec["z"] - gt_z).abs()

    losses = {"loss_xy": loss_xy, "loss_z": loss_z, "loss_dims": loss_dims,
              "loss_pose": loss_pose}
    if cfg.loss_w_joint > 0:
        joint = corners(geom.backproject(K_scaled, xy, dec["z"]), dec["dims"],
                        dec["pose"])
        if cfg.chamfer_pose and cfg.disentangled_loss:
            losses["loss_joint"] = geom.chamfer_corner_distance(joint,
                                                                gt_corners)
        else:
            losses["loss_joint"] = corner_l1(joint)

    if cfg.inverse_z_weight:
        inv_w = 1.0 / torch.log(gt_z.clamp(min=math.e))
        losses = {k: v * inv_w for k, v in losses.items()}

    weights = {"loss_xy": cfg.loss_w_xy, "loss_z": cfg.loss_w_z,
               "loss_dims": cfg.loss_w_dims, "loss_pose": cfg.loss_w_pose,
               "loss_joint": cfg.loss_w_joint}
    out = {}
    uncert_sf = 1.0
    if cfg.use_confidence > 0 and dec["uncert"] is not None:
        uncert_sf = SQRT_2 * torch.exp(-dec["uncert"])
        out["loss_uncert"] = cfg.use_confidence * masked_mean(
            dec["uncert"], fg_mask, count_reduce)
    for k, v in losses.items():
        out[k] = (masked_mean(v * uncert_sf, fg_mask, count_reduce)
                  * weights[k] * cfg.loss_w_3d)
    return out


class RCNN3D(nn.Module):
    """OVMono3D-LIFT model: oracle- and learned-2D inference and the
    training losses. `priors` (optional) holds tensors dims [C, 2, 3],
    z_scales [C, B], z_stats [C, B, 2] for the prior decodes."""

    def __init__(self, cfg: ModelConfig, priors: dict | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.priors = priors or {}
        self.backbone = build_backbone(cfg.backbone, device=device)
        self.rpn_head = RPNHead(
            num_anchors=len(cfg.anchors.aspect_ratios) * len(cfg.anchors.sizes[0]),
            conv_dim=cfg.backbone.out_channels, device=device)
        box = cfg.roi_box
        self.box_head = FastRCNNHead(
            in_dim=cfg.backbone.out_channels * box.pooler_resolution**2,
            num_classes=cfg.num_classes, num_fc=box.num_fc, fc_dim=box.fc_dim,
            cls_agnostic_bbox_reg=box.cls_agnostic_bbox_reg, device=device)
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
        self.rpn_head.init_weights(generator)
        self.box_head.init_weights(generator)
        self.cube_head.init_weights(generator)

    def preprocess(self, image: torch.Tensor) -> torch.Tensor:
        mean = device_constant(self.cfg.pixel_mean, image.device)
        std = device_constant(self.cfg.pixel_std, image.device)
        return (image - mean) / std

    def features(self, image: torch.Tensor,
                 depth: torch.Tensor | None = None) -> dict:
        with span("model.trunk"):
            feat = self.backbone.trunk_features(self.preprocess(image), depth)
        with span("model.pyramid"):
            return self.backbone.pyramid(feat)

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
        """Batched inference: on the oracle 2D boxes when they are given
        (the RPN and the box head are skipped), else on the model's own 2D
        detections (`_detect_2d`, max_detections slots an image)."""
        oracle = (oracle_boxes, oracle_classes, oracle_scores, oracle_valid)
        if any(x is None for x in oracle) and any(x is not None
                                                  for x in oracle):
            raise ValueError(
                "oracle_boxes, oracle_classes, oracle_scores and oracle_valid "
                "go together: all four (oracle 2D boxes) or none (the "
                "model's own 2D detections)")
        feats = self.features(image, depth)
        if oracle_boxes is not None:
            det_boxes, det_classes = oracle_boxes, oracle_classes.to(
                torch.int32)
            det_scores, det_valid = oracle_scores, oracle_valid
        else:
            det_boxes, det_scores, det_classes, det_valid = self._detect_2d(
                feats, im_hw)
        with span("model.cube_head"):
            dec, _ = self._run_cube(feats, det_boxes, det_classes, K, im_hw,
                                    im_scale_ratio)
            fused = torch.sqrt((det_scores * dec["conf"]).clamp(min=0.0))
            ratio = im_scale_ratio[:, None, None]
            return Detections(
                boxes=det_boxes * ratio,
                scores=torch.where(det_valid, fused, torch.zeros_like(fused)),
                classes=det_classes,
                valid=det_valid,
                center_cam=dec["center_cam"],
                center_2d=torch.stack([dec["x"], dec["y"]], -1) * ratio,
                dimensions=dec["dims"],
                pose=dec["pose"],
                corners3d=dec["corners"],
            )

    def _detect_2d(self, feats: dict, im_hw: torch.Tensor):
        """Learned 2D detection (the JAX package's `_detect_2d`): test-time
        RPN proposals, the box head on them, per-class boxes, then
        `fast_rcnn_inference`. Returns boxes [B, K, 4], scores, classes and
        valid [B, K], K = max_detections."""
        rpn_cfg, box_cfg = self.cfg.rpn, self.cfg.roi_box
        with span("model.rpn"):
            logits, deltas, anchors, level_sizes = self._rpn_forward(feats)
        hw = im_hw.float()
        with span("model.proposals"):
            prop_boxes, _, prop_valid = rpn_proposals(
                logits, deltas, anchors, level_sizes, hw,
                rpn_cfg.pre_nms_topk_test, rpn_cfg.post_nms_topk_test,
                rpn_cfg.nms_thresh, rpn_cfg.min_box_size)
        with span("model.box_head"):
            b, p = prop_boxes.shape[:2]
            pooled = self._pool_flat(feats, prop_boxes,
                                     box_cfg.pooler_resolution,
                                     box_cfg.pooler_sampling_ratio)
            scores_logits, box_deltas = self.box_head(pooled)
            c = self.cfg.num_classes
            probs = torch.softmax(scores_logits, dim=-1)[:, :-1]
            flat_boxes = prop_boxes.reshape(b * p, 4)
            if box_cfg.cls_agnostic_bbox_reg:
                per_class = box_ops.apply_deltas(
                    box_deltas, flat_boxes, box_cfg.bbox_reg_weights
                )[:, None, :].expand(b * p, c, 4)
            else:
                per_class = box_ops.apply_deltas(
                    box_deltas.reshape(b * p, c, 4),
                    flat_boxes[:, None, :].expand(b * p, c, 4),
                    box_cfg.bbox_reg_weights)
            det = fast_rcnn_inference(
                per_class.reshape(b, p, c, 4), probs.reshape(b, p, c),
                prop_valid, hw, box_cfg.score_thresh_test,
                box_cfg.nms_thresh_test, self.cfg.max_detections)
            return det[:4]

    # -- training -----------------------------------------------------------

    def _anchors(self, feats: dict) -> list[torch.Tensor]:
        anchors = []
        for i, (name, stride) in enumerate(zip(self.cfg.rpn.in_features,
                                               self.feature_strides)):
            h, w = feats[name].shape[1:3]
            anchors.append(box_ops.generate_anchors(
                (h, w), stride, self.cfg.anchors.sizes[i],
                self.cfg.anchors.aspect_ratios, self.cfg.anchors.offset,
                device=feats[name].device))
        return anchors

    def _rpn_forward(self, feats: dict):
        logits, deltas = self.rpn_head(
            [feats[n] for n in self.cfg.rpn.in_features])
        anchors = self._anchors(feats)
        level_sizes = tuple(a.shape[0] for a in anchors)
        return (torch.cat(logits, 1), torch.cat(deltas, 1),
                torch.cat(anchors), level_sizes)

    def compute_losses(self, image, K, im_hw, im_scale_ratio,
                       gt: GroundTruth, generator: torch.Generator | None = None,
                       draws: dict | None = None, depth=None,
                       count_reduce=None) -> dict:
        """Full training forward -> loss dict (the JAX package's
        RCNN3D.compute_losses). The sampling uniforms are `draws`
        ({"anchor": [B, 2, R], "proposal": [B, 2, P]}: R anchors over all
        levels, P = post_nms_topk_train + M proposals), or are drawn from
        `generator` on the image's device.

        `count_reduce` (a no-grad sum of a count tensor over a process
        group) makes every loss normalizer a count over the whole batch
        that the group shares: the masked means' slot counts, the box
        regression's valid proposals and the RPN's sample count. Each
        process's losses are then its share of the global batch's, as in
        the JAX package's one program over a sharded batch."""
        rpn_cfg = self.cfg.rpn
        box_cfg = self.cfg.roi_box
        b = image.shape[0]
        feats = self.features(image, depth)

        # RPN labeling + IoUness losses (rpn.py:129-273).
        with span("model.rpn"):
            logits, deltas, anchors, level_sizes = self._rpn_forward(feats)
            if draws is None:
                p = rpn_cfg.post_nms_topk_train + gt.boxes.shape[1]
                draws = {"anchor": (b, 2, anchors.shape[0]),
                         "proposal": (b, 2, p)}
                draws = {k: box_ops.uniform_draws(v, generator, image.device)
                         for k, v in draws.items()}
            fg_mask, matched_boxes, iou_targets = label_anchors(
                anchors, gt, rpn_cfg.iou_thresholds,
                rpn_cfg.batch_size_per_image, rpn_cfg.positive_fraction,
                rpn_cfg.ignore_threshold, draws=draws["anchor"])
            fg_f = fg_mask.float()
            normalizer = rpn_cfg.batch_size_per_image * b
            if count_reduce is not None:
                normalizer = count_reduce(torch.full(
                    (), float(normalizer), device=image.device))
            bce = F.binary_cross_entropy_with_logits(logits, iou_targets,
                                                     reduction="none")
            loss_rpn_cls = (bce * iou_targets * fg_f).sum() / normalizer
            gt_deltas = box_ops.get_deltas(anchors.expand_as(matched_boxes),
                                           matched_boxes)
            reg = smooth_l1(deltas, gt_deltas).sum(-1)
            loss_rpn_loc = (reg * iou_targets * fg_f).sum() / normalizer
            losses = {"rpn/cls": loss_rpn_cls * rpn_cfg.loss_weight,
                      "rpn/loc": loss_rpn_loc * rpn_cfg.loss_weight}

        # Proposals (train top-k) + GT boxes.
        with span("model.proposals"):
            prop_boxes, _, prop_valid = rpn_proposals(
                logits.detach(), deltas.detach(), anchors, level_sizes,
                im_hw.float(), rpn_cfg.pre_nms_topk_train,
                rpn_cfg.post_nms_topk_train, rpn_cfg.nms_thresh,
                rpn_cfg.min_box_size)
            gt_is_fg = gt.valid & (gt.classes >= 0)
            prop_boxes = torch.cat([prop_boxes, gt.boxes], 1)
            prop_valid = torch.cat([prop_valid, gt_is_fg], 1)
            sampled = sample_proposals(
                prop_boxes, prop_valid, gt, box_cfg.batch_size_per_image,
                box_cfg.positive_fraction, box_cfg.iou_thresholds[0],
                rpn_cfg.ignore_threshold, self.cfg.num_classes,
                draws=draws["proposal"])

        # Box head losses (fast_rcnn.py:145-260).
        s = box_cfg.batch_size_per_image
        with span("model.box_head"):
            pooled = self._pool_flat(feats, sampled["boxes"],
                                     box_cfg.pooler_resolution,
                                     box_cfg.pooler_sampling_ratio)
            scores_logits, box_deltas = self.box_head(pooled)
            flat_fg = sampled["fg"].reshape(b * s)
            gt_idx = sampled["gt_idx"]
            matched_gt_boxes = torch.gather(
                gt.boxes, 1, gt_idx[..., None].expand(b, s, 4)
            ).reshape(b * s, 4)
            flat_boxes = sampled["boxes"].reshape(b * s, 4)
            losses["box/cls"], losses["box/reg"] = box_head_losses(
                box_cfg, self.cfg.num_classes, scores_logits, box_deltas,
                sampled["classes"].reshape(b * s),
                sampled["valid"].reshape(b * s), flat_fg, flat_boxes,
                matched_gt_boxes, count_reduce)

        # Cube head on the sampled foreground (roi_heads.py:329-793).
        with span("model.cube_head"):
            dec, Kb = self._run_cube(feats, sampled["boxes"],
                                     sampled["classes"] * sampled["fg"].long(),
                                     K, im_hw, im_scale_ratio)
            dec_flat = {k: (v.reshape(b * s, *v.shape[2:]) if v is not None
                            else None) for k, v in dec.items()}
            gt_boxes3d = torch.gather(
                gt.boxes3d, 1, gt_idx[..., None].expand(b, s, 9)
            ).reshape(b * s, 9)
            gt_poses = torch.gather(
                gt.poses, 1, gt_idx[..., None, None].expand(b, s, 3, 3)
            ).reshape(b * s, 3, 3)
            cube = cube_losses(self.cfg.cube, dec_flat, gt_boxes3d, gt_poses,
                               Kb, flat_fg.float(), src_boxes=flat_boxes,
                               count_reduce=count_reduce)
        losses.update({f"cube/{k}": v for k, v in cube.items()})
        return losses


def freeze_trunk(model: RCNN3D, freeze: bool) -> None:
    """The backbone's trunk (every backbone child but the sfp / fpn
    pyramid; the JAX package's freeze mask over `backbone/*`) gets
    requires_grad=not freeze; the pyramid and the heads stay trainable.
    Unfrozen, the trunk's BatchNorm statistics (buffers) require grad too,
    so the optimizer updates them with their gradients: the JAX train step
    differentiates its whole variables tree, batch_stats included (ROADMAP
    queue 3). Frozen, they are plain buffers no step changes."""
    for name, child in model.backbone.named_children():
        if name in ("sfp", "fpn"):
            continue
        child.requires_grad_(not freeze)
        for buf in child.buffers():
            buf.requires_grad_(not freeze)


def build_model(cfg: ModelConfig, priors: dict | None = None, device=None,
                seed: int = 0) -> RCNN3D:
    """Build the model with weights drawn from torch.Generator(seed), on
    `device`: CUDA unless the caller asks for another device ("cpu"), and
    an error when there is no card. On "meta" the model has shapes only (no
    weights). With cfg.backbone.freeze the trunk's parameters get
    requires_grad=False (`freeze_trunk`: the SFP / FPN and the heads stay
    trainable, as the reference freezes backbone.net).

    Parameters are made on the CPU, filled by the flax-style initializers
    from one generator (so a seed gives the same weights on every device),
    then moved. On CUDA it turns TF32 off for matmuls and cuDNN
    (`utils.device.disable_tf32`): the f32 heads, losses and decode stand in
    for the JAX package's Precision.HIGHEST.
    """
    device = resolve_device(device)
    disable_tf32(device)
    if device.type == "meta":
        model = RCNN3D(cfg, priors, device=device)
    else:
        model = init_seeded(RCNN3D(cfg, priors, device="meta"),
                            seed).to(device)
    freeze_trunk(model, cfg.backbone.freeze)
    return model
