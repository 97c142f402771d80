"""Analytic operation and byte counts of the model, for the MFU and roofline
metrics.

Peaks: one NVIDIA H100 SXM (H100 80GB HBM3), NVIDIA's data sheet, dense
rates at the card's 700 W power limit: 989 TFLOP/s bf16, 3.35 TB/s HBM3.
A card set below 700 W (`nvidia-smi --query-gpu=power.limit`) runs under
these peaks; PERF.md writes the limit beside every share.

Counting rules (what the model needs, whatever implements it, so a later
kernel that recomputes or fuses work leaves the counts as they are):
- a product, a convolution or an attention contraction counts 2 FLOPs a
  multiply-add; norms, activations, softmax and element-wise work count 0;
- attention over [B, H, N, D] is 4 B H N^2 D forward (QK^T and PV) and
  8 B H N^2 D backward, twice the forward (dQ, dK, dV and dP); the flash
  kernels' recompute of the forward in the backward is not counted (the
  port's chip_smoke counts it: 10 B H N^2 D);
- the rel-pos bias adds 2 B H N^2 forward (its two terms per logit) and as
  much backward (the two tables' row sums of dS); its factor einsums are
  products, 2 N H (h + w) D a batch element each way;
- ROIAlign counts its bilinear taps: 4 taps x S^2 samples x R^2 bins x C
  channels a box, one pyramid level a box;
- the backward counts 2x the forward of the parts that receive gradients
  (a frozen trunk gets none);
- bytes of a kernel: each input read once and each output written once.
"""
from __future__ import annotations

BF16_PEAK = 989e12
HBM_BYTES_PER_S = 3.35e12


def trunk_geometry(cfg: dict) -> dict:
    t = cfg["trunk"]
    side = cfg["model"]["backbone"]["square_pad"]
    g = side // t["patch_size"]
    w = t["window"]
    windows = (-(-g // w)) ** 2 if w else 0
    return {"grid": g, "tokens": g * g + (1 if t["cls_token"] else 0),
            "windows": windows, "dim": t["embed_dim"], "heads": t["heads"],
            "head_dim": t["embed_dim"] // t["heads"]}


def attention_flops(b, h, n, d) -> float:
    return 4.0 * b * h * n * n * d


def attention_calls(cfg: dict, batch: int) -> list[dict]:
    """Every attention call of one trunk forward: batch, heads, tokens,
    head dim, rel-pos grid (or None)."""
    t, geo = cfg["trunk"], trunk_geometry(cfg)
    calls = []
    for i in range(t["depth"]):
        windowed = t["window"] and i not in t["global_blocks"]
        if windowed:
            n, bb, grid = t["window"] ** 2, batch * geo["windows"], (
                t["window"], t["window"])
        else:
            n, bb, grid = geo["tokens"], batch, (geo["grid"], geo["grid"])
        calls.append({"b": bb, "h": geo["heads"], "n": n,
                      "d": geo["head_dim"],
                      "grid": grid if t["rel_pos"] else None})
    return calls


def trunk_flops(cfg: dict, batch: int) -> float:
    """One trunk forward (patch embed, blocks, depth fusion, neck)."""
    t, geo = cfg["trunk"], trunk_geometry(cfg)
    c, g = geo["dim"], geo["grid"]
    patches = g * g
    total = 2.0 * patches * 3 * t["patch_size"] ** 2 * c
    for call in attention_calls(cfg, 1):
        tokens = call["b"] * call["n"]          # windows padded, as attended
        total += 2.0 * tokens * c * 4 * c                     # qkv, proj
        total += 2.0 * geo["tokens"] * c * 8 * c              # mlp
        total += attention_flops(call["b"], call["h"], call["n"], call["d"])
        if call["grid"]:
            gh, gw = call["grid"]
            total += 2.0 * tokens * c * (gh + gw)             # bias factors
            total += 2.0 * call["b"] * call["h"] * call["n"] ** 2
    if t["depth_fusion"]:
        total += 2.0 * patches * c * c
    if t["neck"]:
        total += 2.0 * patches * (c * t["neck"] + t["neck"] ** 2 * 9)
    return batch * total


def pyramid_maps(cfg: dict) -> list[tuple[int, int]]:
    """(side, stride) of each pyramid level."""
    g = trunk_geometry(cfg)["grid"]
    ps = cfg["trunk"]["patch_size"]
    return [(round(g * s), round(ps / s))
            for s in cfg["model"]["backbone"]["scale_factors"]]


def pyramid_flops(cfg: dict, batch: int) -> float:
    t = cfg["trunk"]
    cin = t["neck"] or t["embed_dim"]
    out = cfg["model"]["backbone"]["out_channels"]
    g = trunk_geometry(cfg)["grid"]
    total = 0.0
    for s in cfg["model"]["backbone"]["scale_factors"]:
        side = round(g * s)
        c = cin
        if s == 4.0:
            total += 2.0 * (2 * g) ** 2 * cin * (cin // 2)
            total += 2.0 * (4 * g) ** 2 * (cin // 2) * (cin // 4)
            c = cin // 4
        elif s == 2.0:
            total += 2.0 * (2 * g) ** 2 * cin * (cin // 2)
            c = cin // 2
        total += 2.0 * side * side * (c * out + out * out * 9)
    return batch * total


def rpn_flops(cfg: dict, batch: int) -> float:
    m = cfg["model"]
    a = len(m["anchors"]["aspect_ratios"]) * len(m["anchors"]["sizes"][0])
    c = m["backbone"]["out_channels"]
    return batch * sum(2.0 * side * side * (c * c * 9 + c * 5 * a)
                       for side, _ in pyramid_maps(cfg))


def roi_flops(cfg: dict, boxes: int, head: str) -> float:
    """ROIAlign and one head (`box` or `cube`) over `boxes` boxes."""
    m = cfg["model"]
    h = m["roi_box"] if head == "box" else m["cube"]
    c = m["backbone"]["out_channels"]
    r, s = h["pooler_resolution"], h["pooler_sampling_ratio"]
    total = 8.0 * s * s * r * r * c
    d = c * r * r
    for _ in range(h["num_fc"]):
        total += 2.0 * d * h["fc_dim"]
        d = h["fc_dim"]
    nc = m["num_classes"]
    total += 2.0 * d * ((nc + 1) + 4 * nc if head == "box"
                        else 2 + 3 + 6 + 1 + 1)
    return boxes * total


def train_step_flops(cfg: dict, batch: int) -> float:
    """One training step: every forward once, and 2x the forward again for
    the parts that receive gradients."""
    sampled = batch * cfg["model"]["roi_box"]["batch_size_per_image"]
    heads = (pyramid_flops(cfg, batch) + rpn_flops(cfg, batch)
             + roi_flops(cfg, sampled, "box")
             + roi_flops(cfg, sampled, "cube"))
    trunk = trunk_flops(cfg, batch)
    frozen = cfg["model"]["backbone"]["freeze"]
    return 3.0 * heads + (1.0 if frozen else 3.0) * trunk


def infer_batch_flops(cfg: dict, batch: int, boxes: int) -> float:
    """One oracle-2D batch: trunk, pyramid, ROIAlign and the cube head."""
    return (trunk_flops(cfg, batch) + pyramid_flops(cfg, batch)
            + roi_flops(cfg, batch * boxes, "cube"))


def flash_bound_s(cfg: dict, batch: int) -> float:
    """The least time of one trunk forward's attention (bf16 q, k, v in,
    o out)."""
    total = 0.0
    for c in attention_calls(cfg, batch):
        io = 4.0 * c["b"] * c["n"] * c["h"] * c["d"] * 2
        total += max(attention_flops(c["b"], c["h"], c["n"], c["d"])
                     / BF16_PEAK, io / HBM_BYTES_PER_S)
    return total


def relpos_train_bound_s(cfg: dict, batch: int) -> float:
    """The least time of one training step's rel-pos attention: the
    forward with its log-sum-exp, and the backward."""
    total = 0.0
    for c in attention_calls(cfg, batch):
        b, h, n, d = c["b"], c["h"], c["n"], c["d"]
        gh, gw = c["grid"]
        qkvo = b * n * h * d * 2                    # one bf16 [B, N, H, D]
        tables = b * n * h * (gh + gw) * 4          # qrh and qrw, f32
        lse = b * h * n * 4
        fwd_flops = attention_flops(b, h, n, d) + 2.0 * b * h * n * n
        fwd_bytes = 3 * qkvo + tables + qkvo + lse
        bwd_flops = 2 * attention_flops(b, h, n, d) + 2.0 * b * h * n * n
        bwd_bytes = (5 * qkvo + tables + lse) + (3 * qkvo + tables)
        total += max(fwd_flops / BF16_PEAK, fwd_bytes / HBM_BYTES_PER_S)
        total += max(bwd_flops / BF16_PEAK, bwd_bytes / HBM_BYTES_PER_S)
    return total
