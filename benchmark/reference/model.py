"""OVMono3D-LIFT's forward in plain float32 PyTorch, from a flat weight dict.

Trunks (NCHW images in, [B, C, h, w] features out):
- DINOv2 ViT-B/14 (facebookresearch/dinov2): cls token, the learned
  position table bicubically resized with DINOv2's +0.1 offset, pre-norm
  blocks with LayerScale, then the depth-prompt 1x1 conv over the patch
  tokens (OVMono3D's dino.py; with no depth prompt its depth channel is 0);
- SAM ViT-B/16 (segment_anything image_encoder.py): no cls token, 14 x 14
  windowed blocks (the grid zero-padded after norm1) and global blocks,
  decomposed relative-position bias from the unscaled q, the conv neck.
Then detectron2's SimpleFeaturePyramid, the RPN head, ROIAlignV2 and the
box and cube heads (Cube R-CNN roi_heads.py / cube_head.py), and the cube
decode with virtual depth and allocentric pose.

Weight names are the port's parameter names, the layout the benchmark
draws its weights in.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import geometry as geo
from .numerics import Ops


def layer_norm(x, w, b, eps=1e-6):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def layer_norm_nchw(x, w, b, eps=1e-6):
    return layer_norm(x.permute(0, 2, 3, 1), w, b, eps).permute(0, 3, 1, 2)


LOGITS_PER_CHUNK = 2 ** 28       # f32 logits a chunk of the batch: 1 GiB


def attention(ops: Ops, q, k, v, bias_fn=None):
    """softmax(q k^T / sqrt(D) + bias) v over [B, H, N, D], in chunks of
    the batch that bound the logits' memory."""
    B, H, N, _ = q.shape
    scale = 1.0 / math.sqrt(q.shape[-1])
    step = max(1, LOGITS_PER_CHUNK // (H * N * N))
    outs = []
    for i in range(0, B, step):
        j = min(B, i + step)
        logits = ops.einsum("bhnd,bhmd->bhnm", q[i:j], k[i:j],
                            low=True) * scale
        if bias_fn is not None:
            logits = logits + bias_fn(i, j)
        probs = torch.softmax(logits, dim=-1)
        outs.append(ops.store(ops.einsum("bhnm,bhmd->bhnd", probs, v[i:j],
                                         low=True)))
    return torch.cat(outs)


def rel_pos_table(table: torch.Tensor, size: int) -> torch.Tensor:
    """segment_anything get_rel_pos: [size, size, D] of table[i - j + size - 1]
    (the table resized linearly when its length differs)."""
    if table.shape[0] != 2 * size - 1:
        table = F.interpolate(table.float().T[None], size=2 * size - 1,
                              mode="linear")[0].T
    idx = (torch.arange(size, device=table.device)[:, None]
           - torch.arange(size, device=table.device)[None, :] + size - 1)
    return table.float()[idx]


def vit_block(ops: Ops, p: dict, pre: str, x: torch.Tensor, grid, heads: int,
              layerscale: bool, window: int, rel_pos: bool, prefix: int):
    """One pre-norm block over [B, prefix + h*w, C] tokens."""
    B, N, C = x.shape
    h, w = grid
    D = C // heads

    def attend(t, thw):
        b, n, _ = t.shape
        qkv = ops.linear(t, p[pre + "attn.qkv.weight"],
                         p[pre + "attn.qkv.bias"], low=True)
        q, k, v = qkv.view(b, n, 3, heads, D).permute(2, 0, 3, 1, 4)
        bias_fn = None
        if rel_pos:
            th, tw = thw
            Rh = rel_pos_table(p[pre + "attn.rel_pos_h"], th)
            Rw = rel_pos_table(p[pre + "attn.rel_pos_w"], tw)

            def bias_fn(i, j):
                qi = q[i:j].reshape(j - i, heads, th, tw, D)
                bh = ops.einsum("bhrcd,rkd->bhrck", qi, Rh, low=True)
                bw = ops.einsum("bhrcd,ckd->bhrck", qi, Rw, low=True)
                return (bh[..., :, None] + bw[..., None, :]).reshape(
                    j - i, heads, th * tw, th * tw)
        o = attention(ops, q, k, v, bias_fn)
        o = o.permute(0, 2, 1, 3).reshape(b, n, C)
        return ops.linear(o, p[pre + "attn.proj.weight"],
                          p[pre + "attn.proj.bias"], low=True)

    y = layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"])
    if window:
        hp, wp = -(-h // window) * window, -(-w // window) * window
        g = F.pad(y.view(B, h, w, C), (0, 0, 0, wp - w, 0, hp - h))
        g = g.view(B, hp // window, window, wp // window, window, C)
        g = g.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)
        g = attend(g, (window, window))
        g = g.view(B, hp // window, wp // window, window, window, C)
        y = g.permute(0, 1, 3, 2, 4, 5).reshape(B, hp, wp, C)[:, :h, :w]
        y = y.reshape(B, N, C)
    else:
        y = attend(y, grid)
    if layerscale:
        y = y * p[pre + "ls1.gamma"]
    x = ops.store(x + y)
    y = layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"])
    y = ops.linear(y, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"],
                   low=True)
    y = ops.linear(F.gelu(y), p[pre + "mlp.fc2.weight"],
                   p[pre + "mlp.fc2.bias"], low=True)
    if layerscale:
        y = y * p[pre + "ls2.gamma"]
    return ops.store(x + y)


def trunk(ops: Ops, p: dict, cfg: dict, images: torch.Tensor,
          remat: bool = False) -> torch.Tensor:
    """Normalized NCHW images -> the trunk's (or its neck's) [B, C, h, w]."""
    t = cfg["trunk"]
    pre = "backbone.vit."
    ps = t["patch_size"]
    x = ops.conv(images, p[pre + "patch_embed.weight"],
                 p[pre + "patch_embed.bias"], stride=ps, low=True)
    B, C, h, w = x.shape
    x = x.flatten(2).transpose(1, 2)
    pos = p[pre + "pos_embed"].float()
    prefix = 1 if t["cls_token"] else 0
    g = t["pretrain_grid"]
    patch_pos = pos[:, prefix:].reshape(1, g, g, C).permute(0, 3, 1, 2)
    if (g, g) != (h, w):
        if t["pos_interp_offset"]:
            off = t["pos_interp_offset"]
            patch_pos = F.interpolate(
                patch_pos, scale_factor=((h + off) / g, (w + off) / g),
                mode="bicubic", align_corners=False)
        else:
            patch_pos = F.interpolate(patch_pos, size=(h, w), mode="bicubic",
                                      align_corners=False)
    x = x + patch_pos.flatten(2).transpose(1, 2)
    if prefix:
        cls = p[pre + "cls_token"].float() + pos[:, :1]
        x = torch.cat([cls.expand(B, 1, C), x], 1)
    x = ops.store(x)
    for i in range(t["depth"]):
        window = 0 if (not t["window"] or i in t["global_blocks"]) \
            else t["window"]

        def blk(xx, i=i, window=window):
            if window and prefix:
                return torch.cat([xx[:, :prefix], vit_block(
                    ops, p, f"{pre}block{i}.", xx[:, prefix:], (h, w),
                    t["heads"], t["layerscale"], window, t["rel_pos"], 0)], 1)
            return vit_block(ops, p, f"{pre}block{i}.", xx, (h, w),
                             t["heads"], t["layerscale"], window,
                             t["rel_pos"], prefix)
        x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
    tokens = x[:, prefix:]
    if t["depth_fusion"]:
        wt = p[pre + "depth_fusion.weight"][:, :C, 0, 0]
        tokens = ops.linear(tokens, wt, p[pre + "depth_fusion.bias"],
                            low=True)
    feat = tokens.transpose(1, 2).reshape(B, C, h, w)
    if t["neck"]:
        feat = ops.conv(feat, p[pre + "neck_conv1.weight"], low=True)
        feat = layer_norm_nchw(feat, p[pre + "neck_norm1.weight"],
                               p[pre + "neck_norm1.bias"])
        feat = ops.conv(feat, p[pre + "neck_conv2.weight"], padding=1,
                        low=True)
        feat = layer_norm_nchw(feat, p[pre + "neck_norm2.weight"],
                               p[pre + "neck_norm2.bias"])
    return feat


def pyramid(ops: Ops, p: dict, cfg: dict, feat: torch.Tensor) -> list:
    """detectron2 SimpleFeaturePyramid -> maps fine to coarse (NCHW)."""
    pre = "backbone.sfp."
    out = []
    for i, s in enumerate(cfg["model"]["backbone"]["scale_factors"]):
        x = feat
        if s == 4.0:
            x = ops.conv_t(x, p[f"{pre}up4a_{i}.weight"],
                           p[f"{pre}up4a_{i}.bias"], low=True)
            x = F.gelu(layer_norm_nchw(x, p[f"{pre}up4_norm_{i}.weight"],
                                       p[f"{pre}up4_norm_{i}.bias"]))
            x = ops.conv_t(x, p[f"{pre}up4b_{i}.weight"],
                           p[f"{pre}up4b_{i}.bias"], low=True)
        elif s == 2.0:
            x = ops.conv_t(x, p[f"{pre}up2_{i}.weight"],
                           p[f"{pre}up2_{i}.bias"], low=True)
        elif s == 0.5:
            x = F.max_pool2d(x, 2, 2)
        st = f"{pre}stage_{i}."
        x = ops.conv(x, p[st + "lateral.weight"], low=True)
        x = layer_norm_nchw(x, p[st + "lateral_norm.weight"],
                            p[st + "lateral_norm.bias"])
        x = ops.conv(x, p[st + "output.weight"], padding=1, low=True)
        out.append(layer_norm_nchw(x, p[st + "output_norm.weight"],
                                   p[st + "output_norm.bias"]))
    return out


def strides(cfg: dict) -> list[int]:
    ps = cfg["trunk"]["patch_size"]
    return [round(ps / s) for s in cfg["model"]["backbone"]["scale_factors"]]


def features(ops: Ops, p: dict, cfg: dict, image: torch.Tensor,
             remat: bool = False) -> list:
    """[B, S, S, 3] RGB 0..255 -> the pyramid's maps."""
    m = cfg["model"]
    mean = torch.tensor(m["pixel_mean"], device=image.device)
    std = torch.tensor(m["pixel_std"], device=image.device)
    x = ((image.float() - mean) / std).permute(0, 3, 1, 2)
    return pyramid(ops, p, cfg, trunk(ops, p, cfg, x, remat))


def roi_maps(ops: Ops, cfg: dict, maps: list) -> list:
    """The maps ROIAlign reads: kept in bfloat16 where the configuration
    pools inexactly (`exact_roi_pool` false), so the control's fp8."""
    if cfg["model"]["exact_roi_pool"]:
        return maps
    return [ops.store(m) for m in maps]


def roi_align(maps: list, map_strides: list, boxes: torch.Tensor,
              res: int, ratio: int) -> torch.Tensor:
    """ROIAlignV2 (aligned, sampling_ratio fixed) with detectron2's level
    assignment: boxes [B, N, 4] -> [B, N, res, res, C]. Bilinear samples
    follow torchvision: a sample beyond one pixel outside the map counts 0,
    one within it reads the border."""
    B, N, _ = boxes.shape
    lo, hi = int(math.log2(map_strides[0])), int(math.log2(map_strides[-1]))
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))
    level = torch.floor(4 + torch.log2(area.sqrt() / 224 + 1e-8)).clamp(lo, hi)
    frac = (torch.arange(res * ratio, device=boxes.device) // ratio
            + (torch.arange(res * ratio, device=boxes.device) % ratio + 0.5)
            / ratio)
    out = None
    for li, (fm, st) in enumerate(zip(maps, map_strides)):
        H, W = fm.shape[-2:]
        b = boxes.float() / st - 0.5
        ys = b[..., 1, None] + frac * (b[..., 3, None] - b[..., 1, None]) / res
        xs = b[..., 0, None] + frac * (b[..., 2, None] - b[..., 0, None]) / res
        gy = (2 * ys + 1) / H - 1                       # [B, N, RS]
        gx = (2 * xs + 1) / W - 1
        grid = torch.stack([gx[:, :, None, :].expand(-1, -1, res * ratio, -1),
                            gy[:, :, :, None].expand(-1, -1, -1, res * ratio)],
                           -1).reshape(B, N * res * ratio, res * ratio, 2)
        s = F.grid_sample(fm.float(), grid, mode="bilinear",
                          padding_mode="border", align_corners=False)
        inside = (((ys >= -1) & (ys <= H))[:, :, :, None]
                  & ((xs >= -1) & (xs <= W))[:, :, None, :])
        C = fm.shape[1]
        s = s.view(B, C, N, res * ratio, res * ratio) * inside[:, None]
        s = s.view(B, C, N, res, ratio, res, ratio).mean((4, 6))
        pooled = s.permute(0, 2, 3, 4, 1)                # [B, N, R, R, C]
        sel = (level == lo + li)[..., None, None, None]
        out = pooled * sel if out is None else torch.where(sel, pooled, out)
    return out


def box_head(p: dict, pooled: torch.Tensor, num_fc: int):
    x = pooled.reshape(pooled.shape[0], -1)
    for i in range(num_fc):
        x = F.relu(F.linear(x, p[f"box_head.fc{i + 1}.weight"],
                            p[f"box_head.fc{i + 1}.bias"]))
    return (F.linear(x, p["box_head.cls_score.weight"],
                     p["box_head.cls_score.bias"]),
            F.linear(x, p["box_head.bbox_pred.weight"],
                     p["box_head.bbox_pred.bias"]))


def cube_head(p: dict, pooled: torch.Tensor, num_fc: int) -> dict:
    """Shared FC stack -> 2D center deltas, log dims, 6D pose, depth and
    uncertainty (clamped at 0.01), class-agnostic."""
    x = pooled.reshape(pooled.shape[0], -1)
    for i in range(num_fc):
        x = F.relu(F.linear(x, p[f"cube_head.shared_fc{i + 1}.weight"],
                            p[f"cube_head.shared_fc{i + 1}.bias"]))

    def out(name):
        return F.linear(x, p[f"cube_head.{name}.weight"],
                        p[f"cube_head.{name}.bias"])
    return {"deltas_2d": out("center_deltas"), "dims": out("dims"),
            "pose": geo.rotation_6d(out("pose")), "z": out("depth")[:, 0],
            "uncert": out("uncertainty")[:, 0].clamp(min=0.01)}


def camera(K, im_hw, ratio, n):
    """Per-box network-resolution intrinsics, original focal, height, ratio."""
    Ks = K / ratio[:, None, None]
    Ks = torch.cat([Ks[:, :2], torch.tensor([0.0, 0.0, 1.0],
                                            device=K.device).expand(
        K.shape[0], 1, 3)], 1)
    rep = lambda t: t.repeat_interleave(n, 0)                   # noqa: E731
    return rep(Ks), rep(K[:, 1, 1]), rep(im_hw[:, 0].float()), rep(ratio)


def decode(cfg: dict, out: dict, boxes: torch.Tensor, Ks, focal, im_h,
           ratio) -> dict:
    """Cube head outputs on [N] input-resolution boxes -> camera-space
    cuboids (direct depth scaled from the virtual focal, allocentric
    pose)."""
    cube = cfg["model"]["cube"]
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    x = boxes[:, 0] + 0.5 * w + w * out["deltas_2d"][:, 0]
    y = boxes[:, 1] + 0.5 * h + h * out["deltas_2d"][:, 1]
    dims = torch.exp(out["dims"].clamp(max=5))
    pose = geo.ray_rotation(Ks, x.detach(), y.detach()) @ out["pose"]
    z = out["z"] * (im_h * focal) / (cube["virtual_focal"] * im_h * ratio)
    center = geo.backproject(Ks, torch.stack([x, y], -1), z)
    return {"x": x, "y": y, "z": z, "dims": dims, "pose": pose,
            "uncert": out["uncert"], "conf": torch.exp(-out["uncert"]),
            "center": center, "corners": geo.corners(center, dims, pose)}


def oracle_forward(ops: Ops, p: dict, cfg: dict, batch: dict) -> dict:
    """The evaluation protocol's forward on given 2D boxes: corners3d and
    scores in the original image's frame, [B, N, ...]."""
    m = cfg["model"]
    maps = features(ops, p, cfg, batch["image"])
    boxes = batch["oracle_boxes"].float()
    B, N, _ = boxes.shape
    cube = m["cube"]
    pooled = roi_align(roi_maps(ops, cfg, maps), strides(cfg), boxes,
                       cube["pooler_resolution"], cube["pooler_sampling_ratio"])
    out = cube_head(p, pooled.reshape(B * N, *pooled.shape[2:]),
                    cube["num_fc"])
    Ks, focal, im_h, ratio = camera(batch["K"].float(), batch["im_hw"],
                                    batch["im_scale_ratio"].float(), N)
    dec = decode(cfg, out, boxes.reshape(B * N, 4), Ks, focal, im_h, ratio)
    score = torch.sqrt((batch["oracle_scores"].reshape(-1) * dec["conf"])
                       .clamp(min=0))
    valid = batch["oracle_valid"].reshape(-1)
    return {"corners3d": dec["corners"].view(B, N, 8, 3),
            "dimensions": dec["dims"].view(B, N, 3),
            "scores": torch.where(valid, score, torch.zeros_like(score))
            .view(B, N)}
