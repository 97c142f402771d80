"""The traffic generator: batches of mapped images with 3D ground truth or
oracle 2D boxes, drawn from a seed on the device, shaped by a traffic
file's parameters.

Each image takes a camera size from `camera_sizes` (original width and
height), is resized as detectron2's ResizeShortestEdge does (the short side
to a size drawn from `short_sides`, the long side capped at `max_long`) and
padded to the configuration's square canvas with zeros. Its pixels are
uniform in 0..255. Objects are cuboids in front of the camera (a copy of
the port's chip_smoke `synthetic_batch` idea): projected center inside the
image, depth 2..20 m, sides 0.3..2.5 m, random yaw; their 2D boxes are the
projected cuboids clipped to the image. GT slots hold `gt_slots` objects
of which `gt_valid` [lo, hi] are valid; oracle slots `oracle_slots` boxes
of which `oracle_valid` [lo, hi] are valid (the rest zero, as the test
mapper pads them).
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import geometry as geo


def _choice(g, options, n, device):
    idx = torch.randint(0, len(options), (n,), generator=g, device=device)
    return torch.tensor(options, dtype=torch.float32, device=device)[idx]


def cameras(g, traffic: dict, n: int, side: int, device):
    """Per image: im_hw [n, 2] int32, ratio [n] (original / input), the
    original intrinsics K [n, 3, 3] and the input-resolution ones."""
    sizes = _choice(g, traffic["camera_sizes"], n, device)       # [n, 2]
    w0, h0 = sizes[:, 0], sizes[:, 1]
    short = _choice(g, traffic["short_sides"], n, device)
    scale = short / torch.minimum(w0, h0)
    scale = torch.minimum(scale, traffic["max_long"] / torch.maximum(w0, h0))
    nh = torch.floor(h0 * scale + 0.5).clamp(max=side)
    nw = torch.floor(w0 * scale + 0.5).clamp(max=side)
    ratio = h0 / nh
    f0 = (0.9 + 0.4 * torch.rand(n, generator=g, device=device)) * \
        torch.maximum(w0, h0)
    K = torch.zeros(n, 3, 3, device=device)
    K[:, 0, 0], K[:, 1, 1] = f0, f0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w0 / 2, h0 / 2, 1.0
    Kn = K / ratio[:, None, None]
    Kn[:, 2, 2] = 1.0
    return torch.stack([nh, nw], -1).int(), ratio, K, Kn


def objects(g, Kn, im_hw, m: int, device):
    """m cuboids an image: boxes [n, m, 4], boxes3d [n, m, 9], poses."""
    n = Kn.shape[0]

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=device)
    h = im_hw[:, 0, None].float()
    w = im_hw[:, 1, None].float()
    uv = torch.stack([w * uni(0.1, 0.9, n, m), h * uni(0.1, 0.9, n, m)], -1)
    z = uni(2.0, 20.0, n, m)
    center = geo.backproject(Kn[:, None], uv, z)
    dims = uni(0.3, 2.5, n, m, 3)
    poses = geo.yaw_rotation(uni(-math.pi, math.pi, n, m))
    c2d = geo.project(Kn, geo.corners(center, dims, poses)
                      .reshape(n, m * 8, 3)).reshape(n, m, 8, 2)
    hi = torch.stack([w[:, 0] - 1, h[:, 0] - 1], -1)[:, None]
    lo_xy = torch.maximum(c2d.amin(2), torch.zeros_like(hi))
    hi_xy = torch.minimum(c2d.amax(2), hi)
    boxes = torch.cat([lo_xy, hi_xy], -1)
    boxes3d = torch.cat([uv, z[..., None], dims, center], -1)
    return boxes, boxes3d, poses


def images(g, im_hw, side: int, device):
    n = im_hw.shape[0]
    img = 255.0 * torch.rand(n, side, side, 3, generator=g, device=device)
    ys = torch.arange(side, device=device)
    inside = ((ys[None, :, None] < im_hw[:, 0, None, None])
              & (ys[None, None, :] < im_hw[:, 1, None, None]))
    return img * inside[..., None]


def valid_slots(g, m: int, lo_hi, n: int, device):
    count = torch.randint(lo_hi[0], lo_hi[1] + 1, (n, 1), generator=g,
                          device=device)
    return torch.arange(m, device=device)[None] < count


def anchor_count(cfg: dict) -> int:
    side = cfg["model"]["backbone"]["square_pad"]
    ps = cfg["trunk"]["patch_size"]
    a = cfg["model"]["anchors"]
    total = 0
    for s, sizes in zip(cfg["model"]["backbone"]["scale_factors"], a["sizes"]):
        grid = round(side / ps * s)
        total += grid * grid * len(sizes) * len(a["aspect_ratios"])
    return total


def train_batch(g, cfg: dict, traffic: dict, device) -> dict:
    """One training batch of the port's batch contract, with `draws`."""
    b, m = traffic["batch"], traffic["gt_slots"]
    side = cfg["model"]["backbone"]["square_pad"]
    im_hw, ratio, K, Kn = cameras(g, traffic, b, side, device)
    boxes, boxes3d, poses = objects(g, Kn, im_hw, m, device)
    n_prop = cfg["model"]["rpn"]["post_nms_topk_train"] + m

    def draws(n):
        return torch.rand(b, 2, n, generator=g, device=device).clamp_(
            min=1e-10)
    return {
        "image": images(g, im_hw, side, device), "K": K, "im_hw": im_hw,
        "im_scale_ratio": ratio, "gt_boxes": boxes,
        "gt_classes": torch.randint(0, cfg["model"]["num_classes"], (b, m),
                                    generator=g, device=device),
        "gt_boxes3d": boxes3d, "gt_poses": poses,
        "gt_valid": valid_slots(g, m, traffic["gt_valid"], b, device),
        "draws": {"anchor": draws(anchor_count(cfg)),
                  "proposal": draws(n_prop)},
    }


def oracle_batch(g, cfg: dict, traffic: dict, device) -> dict:
    """One evaluation batch as the test iterator maps it, with oracle
    slots."""
    b, m = traffic["batch"], traffic["oracle_slots"]
    side = cfg["model"]["backbone"]["square_pad"]
    im_hw, ratio, K, Kn = cameras(g, traffic, b, side, device)
    boxes, _, _ = objects(g, Kn, im_hw, m, device)
    valid = valid_slots(g, m, traffic["oracle_valid"], b, device)
    scores = 0.05 + 0.95 * torch.rand(b, m, generator=g, device=device)
    zero = torch.zeros((), device=device)
    return {
        "image": images(g, im_hw, side, device), "K": K, "im_hw": im_hw,
        "im_scale_ratio": ratio,
        "oracle_boxes": torch.where(valid[..., None], boxes, zero),
        "oracle_classes": torch.randint(0, cfg["model"]["num_classes"],
                                        (b, m), generator=g, device=device
                                        ).int(),
        "oracle_scores": torch.where(valid, scores, zero),
        "oracle_valid": valid,
    }
