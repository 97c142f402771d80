"""Cube R-CNN / OVMono3D training step in plain float32 PyTorch.

RPNWithIgnore's IoUness losses over anchors labeled by detectron2's
Matcher (low-quality matches allowed) and sampled IoU-weighted; proposals
by per-level top-k, decode, clip, per-level greedy NMS and a global top-k;
ROIHeads3D's proposal sampling with the GT boxes appended; Fast R-CNN box
losses; the cube head's disentangled corner, chamfer pose, joint and
uncertainty losses; then detectron2's SGD with momentum, weight decay
groups and the warmup schedule, and the reference trainer's skip of a
non-finite or spiking step.

Sampling is without replacement in proportion to weight by the Gumbel
top-k rule over the batch's `draws` uniforms, so the program and this
reference sample alike from one set of draws.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import geometry as geo
from . import model as M
from .numerics import Ops

NORM_KEYS = ("norm", "layernorm", "ln", "bn")
SKIP_TOLERANCE = 4.0
EMA_GAIN = 0.02


def anchors(cfg: dict, maps: list) -> torch.Tensor:
    """detectron2 DefaultAnchorGenerator over every level, (h, w, a) order."""
    a = cfg["model"]["anchors"]
    out = []
    for fm, st, sizes in zip(maps, M.strides(cfg), a["sizes"]):
        cell = []
        for s in sizes:
            for r in a["aspect_ratios"]:
                w = math.sqrt(s * s / r)
                cell.append([-w / 2, -w * r / 2, w / 2, w * r / 2])
        cell = torch.tensor(cell, device=fm.device)
        H, W = fm.shape[-2:]
        ys = (torch.arange(H, device=fm.device) + a["offset"]) * st
        xs = (torch.arange(W, device=fm.device) + a["offset"]) * st
        yy, xx = torch.meshgrid(ys.float(), xs.float(), indexing="ij")
        shift = torch.stack([xx, yy, xx, yy], -1).reshape(-1, 1, 4)
        out.append((shift + cell).reshape(-1, 4))
    return out


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M]."""
    area = lambda x: ((x[..., 2] - x[..., 0]).clamp(min=0)        # noqa: E731
                      * (x[..., 3] - x[..., 1]).clamp(min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-7),
                       torch.zeros_like(inter))


def ioa(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection over the area of b."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    ab = ((b[..., 2] - b[..., 0]).clamp(min=0)
          * (b[..., 3] - b[..., 1]).clamp(min=0))[..., None, :]
    return torch.where(ab > 0, inter / ab.clamp(min=1e-7),
                       torch.zeros_like(inter))


def encode(src, tgt, wts=(1.0, 1.0, 1.0, 1.0)):
    """Box2BoxTransform.get_deltas."""
    sw = (src[..., 2] - src[..., 0]).clamp(min=1e-4)
    sh = (src[..., 3] - src[..., 1]).clamp(min=1e-4)
    tw = (tgt[..., 2] - tgt[..., 0]).clamp(min=1e-4)
    th = (tgt[..., 3] - tgt[..., 1]).clamp(min=1e-4)
    sx = src[..., 0] + 0.5 * (src[..., 2] - src[..., 0])
    sy = src[..., 1] + 0.5 * (src[..., 3] - src[..., 1])
    tx, ty = tgt[..., 0] + 0.5 * tw, tgt[..., 1] + 0.5 * th
    return torch.stack([wts[0] * (tx - sx) / sw, wts[1] * (ty - sy) / sh,
                        wts[2] * torch.log(tw / sw),
                        wts[3] * torch.log(th / sh)], -1)


def decode_boxes(d, boxes, wts=(1.0, 1.0, 1.0, 1.0)):
    """Box2BoxTransform.apply_deltas (scale clamp log(1000 / 16))."""
    clamp = math.log(1000.0 / 16)
    w, h = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    cx, cy = boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h
    px = d[..., 0] / wts[0] * w + cx
    py = d[..., 1] / wts[1] * h + cy
    pw = torch.exp((d[..., 2] / wts[2]).clamp(max=clamp)) * w
    ph = torch.exp((d[..., 3] / wts[3]).clamp(max=clamp)) * h
    return torch.stack([px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2],
                       -1)


def gumbel_sample(mask, weight, u, count):
    """`count` [..., 1] entries of `mask`, without replacement, in
    proportion to `weight`: the largest log(weight) - log(-log(u))."""
    score = torch.where(mask, torch.log(weight.clamp(min=1e-9))
                        - torch.log(-torch.log(u)),
                        torch.full_like(weight, -math.inf))
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device)
        .expand_as(order))
    return (rank < torch.minimum(count, mask.sum(-1, keepdim=True))) & mask


def subsample(labels, num, frac, matched_iou, draws):
    w = matched_iou + 1e-4
    pos = gumbel_sample(labels == 1, w, draws[:, 0],
                        torch.full_like(labels[:, :1], int(num * frac)))
    neg = gumbel_sample(labels == 0, w, draws[:, 1],
                        num - pos.sum(-1, keepdim=True))
    return pos, neg


def greedy_nms(boxes, scores, valid, thresh):
    """Greedy NMS over the last set axis (a box goes when its IoU with a
    kept, higher-scoring box exceeds `thresh`), any leading dims; ties in
    score keep index order."""
    masked = torch.where(valid, scores, torch.full_like(scores, -math.inf))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    sb = torch.gather(boxes, -2, order[..., None].expand_as(boxes))
    sv = torch.gather(valid, -1, order)
    n = scores.shape[-1]
    earlier = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (iou(sb, sb) > thresh) & earlier
    keep = sv
    while True:
        new = sv & ~(sup & keep[..., :, None]).any(-2)
        if torch.equal(new, keep):
            break
        keep = new
    return torch.zeros_like(keep).scatter_(-1, order, keep)


def topk_stable(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def proposals(cfg, logits, deltas, level_anchors, im_hw):
    """find_top_rpn_proposals at the training sizes -> boxes, valid."""
    rpn = cfg["model"]["rpn"]
    B = logits.shape[0]
    lo = torch.finfo(torch.float32).min
    bxs, scs, start = [], [], 0
    for anc in level_anchors:
        n = anc.shape[0]
        k = min(rpn["pre_nms_topk_train"], n)
        s, idx = topk_stable(logits[:, start:start + n], k)
        d = torch.gather(deltas[:, start:start + n], 1,
                         idx[..., None].expand(B, k, 4))
        bx = decode_boxes(d, anc[idx])
        h = im_hw[:, 0, None].float()
        w = im_hw[:, 1, None].float()
        bx = torch.stack([bx[..., 0].clamp(min=0).minimum(w),
                          bx[..., 1].clamp(min=0).minimum(h),
                          bx[..., 2].clamp(min=0).minimum(w),
                          bx[..., 3].clamp(min=0).minimum(h)], -1)
        v = ((bx[..., 2] - bx[..., 0] > rpn["min_box_size"])
             & (bx[..., 3] - bx[..., 1] > rpn["min_box_size"])
             & torch.isfinite(bx).all(-1) & torch.isfinite(s))
        keep = greedy_nms(bx, s, v, rpn["nms_thresh"])
        bxs.append(bx)
        scs.append(torch.where(keep, s, torch.full_like(s, lo)))
        start += n
    boxes, scores = torch.cat(bxs, 1), torch.cat(scs, 1)
    top, idx = topk_stable(scores, rpn["post_nms_topk_train"])
    return (torch.gather(boxes, 1, idx[..., None].expand(B, idx.shape[1], 4)),
            top > lo)


def masked_mean(x, mask):
    fin = torch.isfinite(x)
    w = mask.float() * fin.float()
    return (torch.where(fin, x, torch.zeros_like(x)) * w).sum() / \
        w.sum().clamp(min=1.0)


def losses(ops: Ops, p: dict, cfg: dict, batch: dict,
           remat: bool = False) -> dict:
    """The training losses of one batch (RCNN3D's loss dict)."""
    m = cfg["model"]
    rpn, box, cube = m["rpn"], m["roi_box"], m["cube"]
    maps = M.features(ops, p, cfg, batch["image"], remat)
    B = maps[0].shape[0]
    gt_boxes, gt_cls = batch["gt_boxes"].float(), batch["gt_classes"]
    gt_valid = batch["gt_valid"]
    fg_gt = gt_valid & (gt_cls >= 0)

    # RPN head over every level, (h, w, a) order.
    logits, deltas = [], []
    for fm in maps:
        t = F.relu(F.conv2d(fm, p["rpn_head.conv.weight"],
                            p["rpn_head.conv.bias"], padding=1))
        lg = F.conv2d(t, p["rpn_head.objectness.weight"],
                      p["rpn_head.objectness.bias"])
        dl = F.conv2d(t, p["rpn_head.deltas.weight"],
                      p["rpn_head.deltas.bias"])
        logits.append(lg.permute(0, 2, 3, 1).reshape(B, -1))
        deltas.append(dl.permute(0, 2, 3, 1).reshape(B, -1, 4))
    logits, deltas = torch.cat(logits, 1), torch.cat(deltas, 1)
    level_anchors = anchors(cfg, maps)
    anc = torch.cat(level_anchors)

    # Anchor labels: Matcher(lo = hi) with low-quality matches, IoU-weighted
    # positives, and each GT's best anchor kept.
    q = iou(gt_boxes, anc[None].expand(B, -1, 4))
    q = torch.where(fg_gt[..., None], q, torch.full_like(q, -1.0))
    m_iou, m_idx = q.max(1)
    lo_t, hi_t = rpn["iou_thresholds"]
    labels = torch.where(m_iou >= hi_t, 1, -1)
    labels = torch.where(m_iou < lo_t, 0, labels)
    best = q.max(-1, keepdim=True).values
    low_q = ((q >= best - 1e-7) & (best > 0) & fg_gt[..., None]).any(1)
    labels = torch.where(low_q, 1, labels)
    m_iou = m_iou.clamp(min=0)
    pos, _ = subsample(labels, rpn["batch_size_per_image"],
                       rpn["positive_fraction"], m_iou, batch["draws_anchor"])
    forced = torch.zeros_like(labels).scatter_reduce(
        -1, q.argmax(-1), (fg_gt & (best[..., 0] > 0)).long(), "amax")
    fg = (pos | ((forced > 0) & (labels == 1))).float()
    matched = torch.gather(gt_boxes, 1, m_idx[..., None].expand(B, -1, 4))
    norm = rpn["batch_size_per_image"] * B
    bce = F.binary_cross_entropy_with_logits(logits, m_iou, reduction="none")
    out = {"rpn/cls": (bce * m_iou * fg).sum() / norm * rpn["loss_weight"]}
    reg = (deltas - encode(anc.expand_as(matched), matched)).abs().sum(-1)
    out["rpn/loc"] = (reg * m_iou * fg).sum() / norm * rpn["loss_weight"]

    # Proposals (no gradient) with the GT boxes appended, then sampling.
    with torch.no_grad():
        pb, pv = proposals(cfg, logits.detach(), deltas.detach(),
                           level_anchors, batch["im_hw"])
    pb = torch.cat([pb, gt_boxes], 1)
    pv = torch.cat([pv, fg_gt], 1)
    P = pb.shape[1]
    q = iou(gt_boxes, pb)
    q = torch.where(fg_gt[..., None], q, torch.full_like(q, -1.0))
    p_iou, p_idx = q.max(1)
    p_iou = p_iou.clamp(min=0)
    lab = (p_iou >= box["iou_thresholds"][0]).long()
    ign = gt_valid & (gt_cls < 0)
    cover = torch.where(ign[..., None], ioa(gt_boxes, pb),
                        torch.zeros_like(q)).max(1).values
    lab = torch.where(((cover >= rpn["ignore_threshold"]) & (lab == 0))
                      | ~pv, -1, lab)
    S = box["batch_size_per_image"]
    ppos, pneg = subsample(lab, S, box["positive_fraction"], p_iou,
                           batch["draws_proposal"])
    rank = ppos.long() * 2 + pneg.long()
    _, sel = topk_stable(rank * (P + 1) - torch.arange(P, device=rank.device),
                         S)
    srank = torch.gather(rank, 1, sel)
    s_valid, s_fg = srank > 0, srank == 2
    s_gt = torch.gather(p_idx, 1, sel)
    C = m["num_classes"]
    s_cls = torch.where(s_fg, torch.gather(gt_cls.long(), 1, s_gt), C)
    s_boxes = torch.gather(pb, 1, sel[..., None].expand(B, S, 4))

    # Box head.
    rmaps = M.roi_maps(ops, cfg, maps)
    pooled = M.roi_align(rmaps, M.strides(cfg), s_boxes,
                         box["pooler_resolution"],
                         box["pooler_sampling_ratio"]).reshape(B * S, -1)
    scores, bdeltas = M.box_head(p, pooled, box["num_fc"])
    fcls, fvalid, ffg = s_cls.reshape(-1), s_valid.reshape(-1), \
        s_fg.reshape(-1)
    ce = -F.log_softmax(scores, -1).gather(1, fcls[:, None])[:, 0]
    out["box/cls"] = masked_mean(ce, fvalid)
    mgt = torch.gather(gt_boxes, 1, s_gt[..., None].expand(B, S, 4))
    tgt = encode(s_boxes.reshape(-1, 4), mgt.reshape(-1, 4),
                 box["bbox_reg_weights"])
    pred = bdeltas.view(B * S, C, 4).gather(
        1, fcls.clamp(max=C - 1)[:, None, None].expand(-1, 1, 4))[:, 0]
    out["box/reg"] = (((pred - tgt).abs().sum(-1) * ffg).sum()
                      / fvalid.sum().float().clamp(min=1.0))

    # Cube head (class-agnostic: no priors) on every sampled slot,
    # supervised on the foreground.
    pooled = M.roi_align(rmaps, M.strides(cfg), s_boxes,
                         cube["pooler_resolution"],
                         cube["pooler_sampling_ratio"])
    co = M.cube_head(p, pooled.reshape(B * S, *pooled.shape[2:]),
                     cube["num_fc"])
    Ks, focal, im_h, ratio = M.camera(batch["K"].float(), batch["im_hw"],
                                      batch["im_scale_ratio"].float(), S)
    dec = M.decode(cfg, co, s_boxes.reshape(-1, 4), Ks, focal, im_h, ratio)
    g3 = torch.gather(batch["gt_boxes3d"].float(), 1,
                      s_gt[..., None].expand(B, S, 9)).reshape(-1, 9)
    gR = torch.gather(batch["gt_poses"].float(), 1,
                      s_gt[..., None, None].expand(B, S, 3, 3)).reshape(
        -1, 3, 3)
    g_center = geo.backproject(Ks, g3[:, :2], g3[:, 2])
    g_dims = g3[:, 3:6]
    g_corners = geo.corners(g_center, g_dims, gR)
    xy = torch.stack([dec["x"], dec["y"]], -1)

    def l1(c):
        return (c - g_corners).abs().reshape(c.shape[0], -1).mean(1)
    parts = {
        "loss_xy": l1(geo.corners(geo.backproject(Ks, xy, g3[:, 2]),
                                  g_dims, gR)),
        "loss_z": l1(geo.corners(geo.backproject(Ks, g3[:, :2], dec["z"]),
                                 g_dims, gR)),
        "loss_dims": l1(geo.corners(g_center, dec["dims"], gR)),
        "loss_pose": geo.chamfer(geo.corners(g_center, g_dims, dec["pose"]),
                                 g_corners),
        "loss_joint": geo.chamfer(geo.corners(
            geo.backproject(Ks, xy, dec["z"]), dec["dims"], dec["pose"]),
            g_corners),
    }
    weights = {"loss_xy": cube["loss_w_xy"], "loss_z": cube["loss_w_z"],
               "loss_dims": cube["loss_w_dims"],
               "loss_pose": cube["loss_w_pose"],
               "loss_joint": cube["loss_w_joint"]}
    sf = geo.SQRT2 * torch.exp(-dec["uncert"])
    out["cube/loss_uncert"] = cube["use_confidence"] * masked_mean(
        dec["uncert"], ffg)
    for k, v in parts.items():
        out[f"cube/{k}"] = (masked_mean(v * sf, ffg) * weights[k]
                            * cube["loss_w_3d"])
    return out


def trainable_names(cfg: dict, names) -> list[str]:
    """The frozen trunk is backbone.vit (the pyramid and heads train)."""
    frozen = cfg["model"]["backbone"]["freeze"]
    return [n for n in names if not (frozen and n.startswith("backbone.vit."))]


def weight_decay(cfg: dict, name: str) -> float:
    """detectron2's groups: norm layers take weight_decay_norm, the rest
    (biases included, weight_decay_bias unset) weight_decay."""
    keys = name.lower().split(".")
    is_norm = any(k in part for part in keys[:-1] for k in NORM_KEYS)
    s = cfg["solver"]
    if is_norm:
        return s["weight_decay_norm"]
    if keys[-1] == "bias" and s["weight_decay_bias"] is not None:
        return s["weight_decay_bias"]
    return s["weight_decay"]


def learning_rate(cfg: dict, count: int) -> float:
    """WarmupMultiStepLR at update `count`."""
    s = cfg["solver"]
    wf = s["warmup_factor"]
    warm = (wf + (1 - wf) * count / max(s["warmup_iters"], 1)
            if count < s["warmup_iters"] else 1.0)
    return s["base_lr"] * warm * s["gamma"] ** sum(count >= t
                                                   for t in s["steps"])


def run_steps(ops: Ops, weights: dict, cfg: dict, batches: list,
              remat: bool = False) -> dict:
    """Train from `weights` over `batches`, one step each. Returns each
    step's total loss, the first step's gradient by leaf and each
    trainable leaf's change after the last step."""
    p = {k: v.detach().float().clone() for k, v in weights.items()}
    names = trainable_names(cfg, list(p))
    for n in names:
        p[n].requires_grad_(True)
    trace = {n: torch.zeros_like(p[n]) for n in names}
    ema, count = -1.0, 0
    stab = cfg["model"]["stabilize"]
    out = {"loss": [], "losses": [], "skipped": []}
    for i, batch in enumerate(batches):
        parts = losses(ops, p, cfg, batch, remat)
        out["losses"].append({k: float(v.detach()) for k, v in parts.items()})
        total = sum(parts.values())
        grads = torch.autograd.grad(total, [p[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(p[n]) if g is None else g
                 for n, g in zip(names, grads)]
        total = float(total.detach())
        finite = math.isfinite(total) and all(bool(torch.isfinite(g).all())
                                             for g in grads)
        if ema < 0 and math.isfinite(total):
            ema = 2 * total
        skip = (not finite) or (stab > 0 and ema > 0
                                and total > SKIP_TOLERANCE * ema)
        out["loss"].append(total)
        out["skipped"].append(skip)
        if i == 0:
            out["grad"] = {n: g.detach().clone() for n, g in zip(names, grads)}
        if not skip:
            lr = learning_rate(cfg, count)
            with torch.no_grad():
                for n, g in zip(names, grads):
                    u = g + weight_decay(cfg, n) * p[n]
                    trace[n] = u + cfg["solver"]["momentum"] * trace[n]
                    p[n] -= lr * trace[n]
            count += 1
            ema = ema * (1 - EMA_GAIN) + total * EMA_GAIN
        del grads
    out["delta"] = {n: (p[n].detach() - weights[n].float()) for n in names}
    return out
