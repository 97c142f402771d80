"""Analytic operation and byte counts of the open-vocabulary path: the
GroundingDINO Swin-B detector and kernel 8 (Swin window attention), for the
stream cell's MFU and roofline metrics. flops.py's peaks and counting
rules hold (a multiply-add is 2 FLOPs; norms, activations, softmax and
element-wise work count 0; attention over [B, H, N, D] is 4 B H N^2 D),
with these for the detector:

- Swin's qkv and output projections and its attention count the windows'
  padded tokens, as attended; its MLPs and merges the map's tokens;
- BERT, the text layers and the logits count the prompt's T tokens as run
  (the port cuts the prompt to T), padding included;
- deformable sampling counts 10 FLOPs a channel for each query, head,
  level and point: its four bilinear taps' multiply-adds (8, as flops.py
  counts ROIAlign's) and the attention weight's (2);
- the postprocess's phrase sums are left out (under 0.01% of the image).

Kernel 8's bound at a launch over a batch of images (the stream runs a
chunk as one batch, one launch a block): bf16 q, k, v and o of every
image, and the f32 [H, N, N] bias and the int32 region ids [nw, N] of a
shifted block, which the batch shares, each counted once (one image, stage
0: 53.8 MB, 0.0161 ms at 3.35 TB/s).
"""
from __future__ import annotations

from benchmark import flops

BF16, F32, I32 = 2, 4, 4


def swin_blocks(g: dict, side: int) -> list[dict]:
    """Every Swin block at a side x side image: stage, map (h, w), window,
    shift, windows, heads, width."""
    s = g["swin"]
    h = w = side // s["patch_size"]
    c = s["embed_dim"]
    out = []
    for si, depth in enumerate(s["depths"]):
        for bi in range(depth):
            win, shift = s["window"], 0 if bi % 2 == 0 else s["window"] // 2
            if min(h, w) <= win:
                win, shift = min(h, w), 0
            nw = (-(-h // win)) * (-(-w // win))
            out.append({"stage": si, "hw": (h, w), "window": win,
                        "shift": shift, "windows": nw,
                        "heads": s["heads"][si], "dim": c})
        if si < len(s["depths"]) - 1:
            h, w, c = -(-h // 2), -(-w // 2), 2 * c
    return out


def level_shapes(g: dict, side: int) -> list[tuple[int, int]]:
    """The transformer's levels: Swin stages 1-3 and the stride-2 extra
    level."""
    hw = side // g["swin"]["patch_size"]
    shapes = []
    for _ in range(3):
        hw = -(-hw // 2)
        shapes.append((hw, hw))
    shapes.append(((hw + 1) // 2, (hw + 1) // 2))
    return shapes


def swin_flops(g: dict, side: int) -> float:
    s = g["swin"]
    blocks = swin_blocks(g, side)
    n0 = (side // s["patch_size"]) ** 2
    total = 2.0 * n0 * 3 * s["patch_size"] ** 2 * s["embed_dim"]
    for b in blocks:
        c, n = b["dim"], b["window"] ** 2
        tokens = b["hw"][0] * b["hw"][1]
        padded = b["windows"] * n
        total += 2.0 * padded * c * 4 * c                   # qkv, proj
        total += 4.0 * b["windows"] * n * n * c             # attention
        total += 16.0 * tokens * c * c                      # MLP (4x)
    for si in range(len(s["depths"]) - 1):
        last = [b for b in blocks if b["stage"] == si][-1]
        h, w = last["hw"]
        c = last["dim"]
        total += 2.0 * (-(-h // 2)) * (-(-w // 2)) * 4 * c * 2 * c
    return total


def bert_flops(g: dict, T: int) -> float:
    b, c = g["bert"], g["transformer"]["hidden"]
    H, I = b["hidden"], b["intermediate"]
    layer = 8.0 * T * H * H + 4.0 * T * T * H + 4.0 * T * H * I
    return b["layers"] * layer + 2.0 * T * H * c


def sampling_flops(g: dict, queries: int, points: int) -> float:
    """One deformable sampling call over `queries` queries, `points`
    points a head and level (heads x head dim = the width)."""
    t = g["transformer"]
    return 10.0 * queries * t["levels"] * points * t["hidden"]


def encoder_flops(g: dict, side: int, T: int) -> float:
    """Input projections, six enhancer layers, without sampling."""
    t = g["transformer"]
    c, F, Ff, Ft = t["hidden"], t["fusion_dim"], t["ffn"], t["text_ffn"]
    shapes = level_shapes(g, side)
    S = sum(h * w for h, w in shapes)
    cin = [g["swin"]["embed_dim"] * 2 ** (i + 1) for i in range(3)]
    total = sum(2.0 * h * w * ci * c for (h, w), ci in zip(shapes, cin))
    h4, w4 = shapes[3]
    total += 2.0 * h4 * w4 * cin[2] * c * 9
    hlp = t["heads"] * t["levels"] * t["enc_points"]
    fusion = (4.0 * S * c * F + 4.0 * T * c * F + 6.0 * S * T * F
              + 2.0 * S * F * c + 2.0 * T * F * c)
    text = 8.0 * T * c * c + 4.0 * T * T * c + 4.0 * T * c * Ft
    image = (4.0 * S * c * c + 2.0 * S * c * hlp * 3
             + 4.0 * S * c * Ff)
    return total + t["enc_layers"] * (fusion + text + image)


def decoder_flops(g: dict, side: int, T: int) -> float:
    """The selection, six decoder layers and the heads, without
    sampling."""
    t = g["transformer"]
    c, Q, Ff = t["hidden"], t["queries"], t["ffn"]
    S = sum(h * w for h, w in level_shapes(g, side))
    hlp = t["heads"] * t["levels"] * t["dec_points"]
    box = 2.0 * (2 * c * c + 4 * c)
    total = 2.0 * S * c * c + 2.0 * S * T * c + S * box
    layer = (2.0 * Q * 3 * c * c                        # ref_point_head
             + 8.0 * Q * c * c + 4.0 * Q * Q * c       # self-attention
             + 4.0 * Q * c * c + 4.0 * T * c * c + 4.0 * Q * T * c
             + 2.0 * S * c * c + 2.0 * Q * c * hlp * 3 + 2.0 * Q * c * c
             + 4.0 * Q * c * Ff + Q * box)
    return total + t["dec_layers"] * layer + Q * box + 2.0 * Q * T * c


def detector_flops(g: dict, side: int, T: int) -> float:
    """One image through the detector."""
    t = g["transformer"]
    S = sum(h * w for h, w in level_shapes(g, side))
    sampling = (t["enc_layers"] * sampling_flops(g, S, t["enc_points"])
                + t["dec_layers"] * sampling_flops(g, t["queries"],
                                                   t["dec_points"]))
    return (swin_flops(g, side) + bert_flops(g, T)
            + encoder_flops(g, side, T) + decoder_flops(g, side, T)
            + sampling)


def image_flops(cfg: dict, T: int) -> float:
    """One image of the stream: the detector and the lift on its slots."""
    g = cfg["gdino"]
    side = cfg["model"]["backbone"]["square_pad"]
    return detector_flops(g, side, T) + flops.infer_batch_flops(
        cfg, 1, g["detect_topk"])


def window_launch_bound_s(block: dict, batch: int = 1) -> float:
    n, h = block["window"] ** 2, block["heads"]
    d = block["dim"] // h
    bw = batch * block["windows"]
    io = 4 * bw * n * h * d * BF16 + h * n * n * F32
    if block["shift"]:
        io += block["windows"] * n * I32
    return max(4.0 * bw * h * n * n * d / flops.BF16_PEAK,
               io / flops.HBM_BYTES_PER_S)


def window_bound_s(cfg: dict, batch: int = 1) -> float:
    """Kernel 8's least time over the Swin blocks of one batch of `batch`
    images."""
    side = cfg["model"]["backbone"]["square_pad"]
    return sum(window_launch_bound_s(b, batch)
               for b in swin_blocks(cfg["gdino"], side))
