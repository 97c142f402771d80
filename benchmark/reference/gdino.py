"""GroundingDINO (Swin-B + BERT-base) in plain float32 PyTorch, from a flat
weight dict in the port's parameter layout.

It follows IDEA-Research's GroundingDINO (groundingdino/models/
GroundingDINO: swin_transformer.py, bertwarper.py, fuse_modules.py,
transformer.py, ms_deform_attn.py, utils.py) in its SwinB configuration
(GroundingDINO_SwinB_cfg.py), as OVMono3D serves it (roi_heads_gdino.py):

- Swin-B: 4x4 patches, LayerNorm, windows of 12 with the table of relative
  position biases, the map padded to whole windows, every second block
  shifted by half a window (torch.roll) with Swin's region mask, patch
  merging; stages 1-3 normed out at strides 8, 16, 32;
- BERT-base with the sub-sentence mask (each phrase between special tokens
  attends to itself) and position ids restarting at every phrase, then the
  linear map to the transformer's width;
- four levels (1x1 projections and GroupNorm, one stride-2 3x3 extra level)
  with sine position embeddings plus level embeddings;
- six enhancer layers: bi-directional image <-> text fusion with layer
  scales, the text self-attention layer, the deformable image layer;
- the two-stage selection: proposals at every token, memory and proposals
  masked outside (0.01, 0.99), the encoder output scored against the text,
  the top 900 by their best token;
- six decoder layers (self-attention, text cross-attention, deformable
  cross-attention, FFN) with iterative box refinement, the contrastive
  logits against the text, and OVMono3D's postprocess (phrase scores, box
  threshold, class-agnostic NMS, the top slots).

Deformable sampling is plain bilinear sampling (F.grid_sample, zeros
outside, align_corners False), MultiScaleDeformableAttention's pure-PyTorch
form.

Departures from the published description, each without effect on what is
compared: the shifted-window mask and the logits of text padding are -1e9
or -100 where the published code writes -100 or -inf (masked entries weigh
exp(-100) or nothing either way; padded tokens are not compared); a map no
larger than a window is one window with no shift (Swin's classification
rule, which the JAX package and the port keep; no Swin-B map at 896^2 is
that small); BiMultiHeadAttention's clamps at +-50000 are left out (they
bind at no logit of these inputs); `encode` may be given the selection's
indices (`index`), replacing its own top 900, so that a check can follow
the program's discrete choice past the selection.

`Precision` gives every product its precision: float32 (TF32 off), the
configuration's bfloat16 (what the port computes in its compute dtype) in
float8 e4m3 (the control below bfloat16), or the configuration's float32
islands (BERT, the input projections, the encoder output's scoring and the
two logit products) in bfloat16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .numerics import round_fp8

NEG = -1e9


def _round(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f32":
        return x
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    if mode == "fp8":
        return round_fp8(x)
    raise ValueError(f"precision mode {mode!r}")


class Precision:
    """`low`: how the values that the configuration keeps in bfloat16 are
    computed ("f32", "bf16" as the port, "fp8" the control); `island`: how
    the configuration's float32 islands are ("f32", or "bf16" the control).
    A product of a kind rounds its inputs and output; an einsum its
    inputs."""

    def __init__(self, low: str = "f32", island: str = "f32"):
        for m in (low, island):
            _round(torch.zeros(1), m)
        self.modes = {"low": low, "island": island, None: "f32"}

    def r(self, x, kind):
        return _round(x.float(), self.modes[kind])

    def linear(self, x, w, b=None, kind=None):
        return self.r(F.linear(self.r(x, kind), self.r(w, kind),
                               None if b is None else b.float()), kind)

    def conv(self, x, w, b=None, stride=1, padding=0, kind=None):
        return self.r(F.conv2d(self.r(x, kind), self.r(w, kind),
                               None if b is None else b.float(), stride,
                               padding), kind)

    def einsum(self, eq, a, b, kind=None):
        return torch.einsum(eq, self.r(a, kind), self.r(b, kind))


def ln(x, p, name, eps=1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), p[name + ".weight"],
                        p[name + ".bias"], eps)


def dense(pr: Precision, p, name, x, kind="low"):
    return pr.linear(x, p[name + ".weight"], p.get(name + ".bias"), kind)


def group_norm(x, p, name, groups=32, eps=1e-5):
    """GroupNorm over [B, H, W, C] (a group of one value normalizes to the
    bias)."""
    b, c = x.shape[0], x.shape[-1]
    g = x.float().reshape(b, -1, groups, c // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * p[name + ".weight"] + p[name + ".bias"]


def attend(pr: Precision, q, k, v, bias=None, kind="low"):
    """softmax(q k^T / sqrt(D) + bias) v over [B, N, H, D]: f32 logits, the
    probabilities stored as the configuration stores them."""
    d = q.shape[-1]
    logits = pr.einsum("bnhd,bmhd->bhnm", q, k, kind) / math.sqrt(d)
    if bias is not None:
        logits = logits + bias
    probs = pr.r(torch.softmax(logits, dim=-1), kind)
    return pr.einsum("bhnm,bmhd->bnhd", probs, v, kind)


# -- Swin-B ------------------------------------------------------------------

def rel_pos_index(table_window: int, window: int, device) -> torch.Tensor:
    r = torch.arange(window, device=device)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return ((rel[0] + table_window - 1) * (2 * table_window - 1)
            + rel[1] + table_window - 1)


def shift_mask(hp: int, wp: int, window: int, shift: int, device):
    """Swin's region mask [num_windows, w^2, w^2]: 0 within a region, -100
    across."""
    img = torch.zeros(hp, wp, device=device)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    ids = img.view(hp // window, window, wp // window, window).permute(
        0, 2, 1, 3).reshape(-1, window * window)
    return torch.where(ids[:, :, None] == ids[:, None, :], 0.0, -100.0)


def swin_block(pr: Precision, p, pre: str, x, hw, heads: int, window: int,
               shift: int, keep: str):
    """One block over [B, H*W, C]; `keep` is the residual stream's kind
    (stage 0's is float32)."""
    H, W = hw
    B, _, C = x.shape
    if min(H, W) <= window:
        table_window, window, shift = window, min(H, W), 0
    else:
        table_window = window
    n = window * window
    idx = rel_pos_index(table_window, window, x.device)
    bias = p[pre + "attn.rel_pos_bias"].float()[idx.reshape(-1)].reshape(
        n, n, heads).permute(2, 0, 1)
    h = pr.r(ln(x, p, pre + "norm1"), "low").view(B, H, W, C)
    hp, wp = -(-H // window) * window, -(-W // window) * window
    h = F.pad(h, (0, 0, 0, wp - W, 0, hp - H))
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    nw = (hp // window) * (wp // window)
    h = h.view(B, hp // window, window, wp // window, window, C)
    h = h.permute(0, 1, 3, 2, 4, 5).reshape(B * nw, n, C)
    qkv = dense(pr, p, pre + "attn.qkv", h).view(B * nw, n, 3, heads,
                                                  C // heads)
    full = bias[None]
    if shift:
        full = (full.view(1, 1, heads, n, n)
                + shift_mask(hp, wp, window, shift, x.device)[None, :, None]
                ).view(1, nw, heads, n, n).expand(B, -1, -1, -1, -1).reshape(
                    B * nw, heads, n, n)
    o = pr.r(attend(pr, qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], full),
             "low")
    h = dense(pr, p, pre + "attn.proj", o.reshape(B * nw, n, C))
    h = h.view(B, hp // window, wp // window, window, window, C)
    h = h.permute(0, 1, 3, 2, 4, 5).reshape(B, hp, wp, C)
    if shift:
        h = torch.roll(h, (shift, shift), dims=(1, 2))
    x = pr.r(x + h[:, :H, :W].reshape(B, H * W, C), keep)
    y = dense(pr, p, pre + "fc1", ln(x, p, pre + "norm2"))
    y = dense(pr, p, pre + "fc2", pr.r(F.gelu(y), "low"))
    return pr.r(x + y, keep)


def swin(pr: Precision, p, g: dict, image):
    """Normalized [B, S, S, 3] -> {level: [B, h, w, C]} at strides 8, 16,
    32."""
    s = g["swin"]
    x = pr.conv(image.permute(0, 3, 1, 2), p["backbone.patch_embed.weight"],
                p["backbone.patch_embed.bias"], stride=4, kind="low")
    B, C, H, W = x.shape
    x = ln(x.flatten(2).transpose(1, 2), p, "backbone.patch_norm")
    hw, keep, outs = (H, W), None, []
    for si, depth in enumerate(s["depths"]):
        for bi in range(depth):
            x = swin_block(pr, p, f"backbone.stage{si}_block{bi}.", x, hw,
                           s["heads"][si], s["window"],
                           0 if bi % 2 == 0 else s["window"] // 2, keep)
        if si >= 1:
            outs.append(ln(x, p, f"backbone.out_norm{si}").view(
                B, hw[0], hw[1], -1))
        if si < len(s["depths"]) - 1:
            c = x.shape[-1]
            m = F.pad(x.view(B, hw[0], hw[1], c),
                      (0, 0, 0, hw[1] % 2, 0, hw[0] % 2))
            m = torch.cat([m[:, 0::2, 0::2], m[:, 1::2, 0::2],
                           m[:, 0::2, 1::2], m[:, 1::2, 1::2]], -1)
            hw = (m.shape[1], m.shape[2])
            x = dense(pr, p, f"backbone.merge{si}.reduction",
                      ln(m.reshape(B, -1, 4 * c), p,
                         f"backbone.merge{si}.norm"))
            keep = "low"
    return outs


# -- BERT --------------------------------------------------------------------

def subsentence_masks(input_ids, special_ids):
    """GroundingDINO's generate_masks_with_special_tokens_and_transfer_map:
    each run of tokens closed by a special token ([CLS], [SEP], '.', '?')
    attends within itself, with position ids from 0; a special token at the
    first or last column attends to itself alone; every token attends to
    itself. Returns ([B, T, T] bool, [B, T] int64)."""
    B, T = input_ids.shape
    special = torch.isin(input_ids, torch.tensor(special_ids,
                                                 device=input_ids.device))
    eye = torch.eye(T, dtype=torch.bool, device=input_ids.device)
    mask = eye[None].repeat(B, 1, 1)
    pos = torch.zeros(B, T, dtype=torch.long, device=input_ids.device)
    for b in range(B):
        prev = 0
        for col in torch.nonzero(special[b]).flatten().tolist():
            if col in (0, T - 1):
                pos[b, col] = 0
            else:
                mask[b, prev + 1:col + 1, prev + 1:col + 1] = True
                pos[b, prev + 1:col + 1] = torch.arange(col - prev)
            prev = col
    return mask, pos


def bert(pr: Precision, p, g: dict, ids, pair_mask, pos_ids):
    """[B, T] ids -> [B, T, 768], every product a float32 island."""
    b = g["bert"]
    x = (p["bert.word_embeddings.weight"][ids]
         + p["bert.position_embeddings.weight"][pos_ids]
         + p["bert.token_type_embeddings.weight"][torch.zeros_like(ids)])
    x = ln(x, p, "bert.embed_norm", 1e-12)
    bias = torch.where(pair_mask, 0.0, NEG)[:, None]
    B, T, C = x.shape
    heads = b["heads"]
    for i in range(b["layers"]):
        pre = f"bert.layer{i}."
        q, k, v = (dense(pr, p, pre + n, x, "island").view(B, T, heads, -1)
                   for n in ("q", "k", "v"))
        o = attend(pr, q, k, v, bias, "island").reshape(B, T, C)
        x = ln(x + dense(pr, p, pre + "attn_out", o, "island"), p,
               pre + "attn_norm", 1e-12)
        h = dense(pr, p, pre + "out",
                  F.gelu(dense(pr, p, pre + "inter", x, "island")), "island")
        x = ln(x + h, p, pre + "out_norm", 1e-12)
    return x


# -- the cross-modality transformer ------------------------------------------

def _dim_t(half: int, temperature: float, device):
    i = torch.arange(half, dtype=torch.float32, device=device)
    return temperature ** (2 * (i // 2) / half)


def _interleave(x):
    return torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()],
                       -1).flatten(-2)


def image_pos(shapes, dim: int, device):
    """PositionEmbeddingSineHW (temperature 20, normalized by 2 pi) of each
    level, concatenated: [S, dim] as (pos_y, pos_x)."""
    half = dim // 2
    dim_t = _dim_t(half, 20.0, device)
    outs = []
    for h, w in shapes:
        y = (torch.arange(h, device=device) + 1.0) / (h + 1e-6) * 2 * math.pi
        x = (torch.arange(w, device=device) + 1.0) / (w + 1e-6) * 2 * math.pi
        py = _interleave(y[:, None] / dim_t)
        px = _interleave(x[:, None] / dim_t)
        outs.append(torch.cat([py[:, None].expand(h, w, half),
                               px[None].expand(h, w, half)], -1)
                    .reshape(h * w, dim))
    return torch.cat(outs)


def coord_pos(coords, dim: int, exchange_xy: bool = False):
    """gen_sineembed_for_position / get_sine_pos_embed (temperature 10000)
    of [..., n] coordinates -> [..., n * dim / 2]."""
    half = dim // 2
    emb = _interleave(coords[..., None] * 2 * math.pi
                      / _dim_t(half, 10000.0, coords.device))
    if exchange_xy and coords.shape[-1] >= 2:
        emb = torch.cat([emb[..., 1:2, :], emb[..., 0:1, :],
                         emb[..., 2:, :]], -2)
    return emb.flatten(-2)


def inverse_sigmoid(x, eps=1e-3):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def token_centres(shapes, device):
    """Each token's normalized centre (x, y): [S, 2]."""
    pts = []
    for h, w in shapes:
        ys = (torch.arange(h, device=device) + 0.5) / h
        xs = (torch.arange(w, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    return torch.cat(pts)


def deformable_sample(pr: Precision, value, shapes, loc, weights):
    """MultiScaleDeformableAttention: value [B, S, H, D], loc [B, Q, H, L,
    P, 2] in [0, 1] of each level, weights [B, Q, H, L, P] -> [B, Q, H*D],
    by bilinear sampling."""
    B, _, heads, d = value.shape
    q, points = loc.shape[1], loc.shape[4]
    out = 0.0
    start = 0
    for li, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].float().permute(0, 2, 3, 1)
        start += h * w
        grid = (2 * loc[:, :, :, li] - 1).transpose(1, 2).reshape(
            B * heads, q, points, 2)
        s = F.grid_sample(v.reshape(B * heads, d, h, w), grid,
                          mode="bilinear", padding_mode="zeros",
                          align_corners=False)                 # [BH, D, Q, P]
        wl = weights[:, :, :, li].transpose(1, 2).reshape(B * heads, 1, q,
                                                          points)
        out = out + (s * wl).sum(-1)
    return pr.r(out.view(B, heads, d, q).permute(0, 3, 1, 2).reshape(
        B, q, heads * d), "low")


def deformable_attention(pr, p, pre, query, value_in, shapes, loc_fn, g):
    t = g["transformer"]
    heads, levels = t["heads"], t["levels"]
    B, nq, C = query.shape
    value = dense(pr, p, pre + "value_proj", value_in).view(B, -1, heads,
                                                            C // heads)
    points = loc_fn.points
    off = dense(pr, p, pre + "sampling_offsets", query).view(
        B, nq, heads, levels, points, 2)
    attw = pr.r(torch.softmax(dense(pr, p, pre + "attention_weights", query)
                              .view(B, nq, heads, levels * points), -1),
                "low").view(B, nq, heads, levels, points)
    sampled = deformable_sample(pr, value, shapes, loc_fn(off), attw)
    return dense(pr, p, pre + "output_proj", sampled)


def mha(pr, p, pre, q, k, v, heads, bias=None):
    B, nq, C = q.shape
    qh = dense(pr, p, pre + "q", q).view(B, nq, heads, -1)
    kh = dense(pr, p, pre + "k", k).view(B, k.shape[1], heads, -1)
    vh = dense(pr, p, pre + "v", v).view(B, v.shape[1], heads, -1)
    return dense(pr, p, pre + "out",
                 attend(pr, qh, kh, vh, bias).reshape(B, nq, C))


def fusion(pr, p, pre, img, txt, text_mask, g):
    """BiAttentionBlock: the residual adds onto the layer-normed streams."""
    f = g["transformer"]
    heads, width = f["fusion_heads"], f["fusion_dim"]
    vi, li = ln(img, p, pre + "ln_v"), ln(txt, p, pre + "ln_l")
    B, S, _ = vi.shape
    T = li.shape[1]
    qv = dense(pr, p, pre + "v_proj", vi).view(B, S, heads, -1)
    ql = dense(pr, p, pre + "l_proj", li).view(B, T, heads, -1)
    vv = dense(pr, p, pre + "values_v", vi).view(B, S, heads, -1)
    vl = dense(pr, p, pre + "values_l", li).view(B, T, heads, -1)
    logits = pr.einsum("bshd,bthd->bhst", qv, ql, "low") / math.sqrt(
        width // heads)
    logits = torch.where(text_mask[:, None, None, :], logits, NEG)
    a_v = pr.r(torch.softmax(logits, -1), "low")
    a_l = pr.r(torch.softmax(logits.transpose(-1, -2), -1), "low")
    dv = pr.einsum("bhst,bthd->bshd", a_v, vl, "low").reshape(B, S, width)
    dl = pr.einsum("bhts,bshd->bthd", a_l, vv, "low").reshape(B, T, width)
    return (vi + dense(pr, p, pre + "out_v", dv) * p[pre + "gamma_v"],
            li + dense(pr, p, pre + "out_l", dl) * p[pre + "gamma_l"])


def ffn(pr, p, pre, x, a, b, norm):
    h = dense(pr, p, pre + b, pr.r(F.relu(dense(pr, p, pre + a, x)), "low"))
    return ln(x + h, p, pre + norm)


def box_mlp(p, pre, x, layers):
    for i in range(layers):
        x = F.linear(x, p[f"{pre}.l{i}.weight"], p[f"{pre}.l{i}.bias"])
        if i < layers - 1:
            x = F.relu(x)
    return x


class _Loc:
    """A deformable layer's sampling locations from its offsets."""

    def __init__(self, fn, points):
        self.fn, self.points = fn, points

    def __call__(self, off):
        return self.fn(off)


def _taps(n_out: int, n_in: int, device):
    """Bilinear taps of a half-pixel-centred resize from n_in to n_out
    samples (cv2.INTER_LINEAR): the two source indices and the second
    one's weight."""
    src = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
           * (n_in / n_out) - 0.5).clamp(min=0.0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    return i0, (i0 + 1).clamp(max=n_in - 1), (src - i0).float()


def stream_canvas(frame, side: int, short: int, max_size: int):
    """OVMono3D's test-time canvas of a uint8 [h, w, 3] frame: scaled so
    the short side is `short` and the long side at most
    min(max_size, side) (detectron2's ResizeShortestEdge, sizes rounded
    half up), resized bilinearly, rounded to whole pixel values and placed
    top-left on a zero [side, side, 3] canvas. Returns (the canvas in
    float32, (nh, nw), the ratio back to the frame, 1 / scale)."""
    h, w = frame.shape[:2]
    cap = min(max_size, side)
    scale = short / min(h, w)
    if max(h, w) * scale > cap:
        scale = cap / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    x = frame.float()
    y0, y1, ly = _taps(nh, h, x.device)
    x0, x1, lx = _taps(nw, w, x.device)
    rows = x[y0] * (1 - ly)[:, None, None] + x[y1] * ly[:, None, None]
    out = rows[:, x0] * (1 - lx)[None, :, None] + rows[:, x1] * lx[None, :,
                                                                   None]
    canvas = torch.zeros(side, side, 3, device=x.device)
    canvas[:nh, :nw] = out.round().clamp(0, 255)
    return canvas, (nh, nw), 1.0 / scale


def normalize_canvas(canvas, hw, mean, std):
    """A [B, S, S, 3] canvas of raw pixels -> (x / 255 - mean) / std on
    the content (hw [B, 2] = (h, w)), 0 in the padding."""
    S = canvas.shape[1]
    ar = torch.arange(S, device=canvas.device)
    content = ((ar[None, :, None] < hw[:, 0, None, None])
               & (ar[None, None, :] < hw[:, 1, None, None]))
    norm = (canvas.float() / 255.0 - torch.tensor(mean, device=canvas.device)
            ) / torch.tensor(std, device=canvas.device)
    return torch.where(content[..., None], norm, 0.0)


def encode(pr: Precision, p, g: dict, image, input_ids, text_mask,
           special_ids, index=None) -> dict:
    """The detector on a normalized [B, S, S, 3] image and the prompt's
    [B, T] ids and mask: {"pred_logits": [B, Q, T] (-1e9 on padding),
    "pred_boxes": [B, Q, 4] (cx, cy, w, h), "query_index": the top-Q
    encoder tokens it chose, "own_index": its own top Q, whether or not
    `index` [B, Q] replaced them, "text_features": [B, T, C] the encoded
    prompt, "memory": [B, S, C] the encoder's output, "hs": [B, Q, C] the
    decoder's normed output}."""
    t = g["transformer"]
    c, heads, levels = t["hidden"], t["heads"], t["levels"]
    dev = image.device
    pair, pos_ids = subsentence_masks(input_ids, special_ids)
    txt = dense(pr, p, "feat_map", bert(pr, p, g, input_ids, pair, pos_ids),
                "island")
    feats = swin(pr, p, g, image)
    srcs = [group_norm(pr.conv(f.permute(0, 3, 1, 2),
                               p[f"input_proj{i}.weight"],
                               p[f"input_proj{i}.bias"], kind="island")
                       .permute(0, 2, 3, 1), p, f"input_proj_norm{i}")
            for i, f in enumerate(feats)]
    srcs.append(group_norm(pr.conv(
        feats[-1].permute(0, 3, 1, 2), p["extra_proj.weight"],
        p["extra_proj.bias"], stride=2, padding=1, kind="island").permute(
            0, 2, 3, 1), p, "extra_norm"))
    shapes = [(s.shape[1], s.shape[2]) for s in srcs]
    B = image.shape[0]
    src = torch.cat([s.reshape(B, -1, c) for s in srcs], 1)
    lvl = torch.cat([p["level_embed"][i].expand(h * w, c)
                     for i, (h, w) in enumerate(shapes)])
    pos = image_pos(shapes, c, dev) + lvl
    centres = token_centres(shapes, dev)
    level_wh = torch.tensor([(w, h) for h, w in shapes], dtype=torch.float32,
                            device=dev)
    text_pos = coord_pos(pos_ids[..., None].float(), 2 * c)
    enh_bias = torch.where(pair, 0.0, NEG)[:, None]

    img, text = src, txt
    enc_points = t["enc_points"]
    for i in range(t["enc_layers"]):
        img, text = fusion(pr, p, f"fusion{i}.", img, text, text_mask, g)
        pre = f"text_enh{i}."
        q = text + text_pos
        text = ln(text + mha(pr, p, pre + "self_attn.", q, q, text,
                             t["text_heads"], enh_bias), p, pre + "norm1")
        text = ffn(pr, p, pre, text, "ffn1", "ffn2", "norm2")
        pre = f"img_enc{i}."
        loc = _Loc(lambda off: (centres[None, :, None, None, None, :]
                                + off / level_wh[None, None, None, :, None]),
                   enc_points)
        h = deformable_attention(pr, p, pre, img + pos[None], img, shapes,
                                 loc, g)
        img = ln(img + h, p, pre + "norm1")
        img = ffn(pr, p, pre, img, "ffn1", "ffn2", "norm2")
    memory = img

    # Two-stage selection.
    wh = torch.cat([torch.full((h * w, 2), 0.05 * 2.0 ** i, device=dev)
                    for i, (h, w) in enumerate(shapes)])
    prop = torch.cat([centres, wh], -1)
    valid = ((prop > 0.01) & (prop < 0.99)).all(-1)
    out_mem = ln(dense(pr, p, "enc_output",
                       torch.where(valid[None, :, None], memory, 0.0),
                       "island"), p, "enc_output_norm")
    txt_masked = torch.where(text_mask[..., None], text, 0.0)
    enc_logits = torch.where(text_mask[:, None, :], pr.einsum(
        "bsc,btc->bst", out_mem, txt_masked, "island"), NEG)
    scores = enc_logits.amax(-1)
    Q = t["queries"]
    own = torch.sort(scores, dim=-1, descending=True,
                     stable=True)[1][:, :Q]
    index = own if index is None else index.to(dev).long()
    prop_logits = torch.where(valid[:, None], torch.log(prop / (1 - prop)),
                              torch.inf)
    boxes_all = torch.sigmoid(prop_logits[None]
                              + box_mlp(p, "enc_bbox_head", out_mem, 3))
    ref = torch.gather(boxes_all, 1, index[..., None].expand(B, Q, 4))
    tgt = p["tgt_embed"][None].expand(B, Q, c).float()

    # Decoder with iterative refinement.
    text_bias = torch.where(text_mask, 0.0, NEG)[:, None, None, :]
    dec_points = t["dec_points"]
    ref_in = ref
    for i in range(t["dec_layers"]):
        pre = f"dec{i}."
        query_pos = box_mlp(p, "ref_point_head",
                            coord_pos(ref, c, exchange_xy=True), 2)
        q = tgt + query_pos
        tgt = ln(tgt + mha(pr, p, pre + "self_attn.", q, q, tgt, heads), p,
                 pre + "norm1")
        tgt = ln(tgt + mha(pr, p, pre + "text_cross.", tgt + query_pos, text,
                           text, heads, text_bias), p, pre + "norm_text")
        r = ref
        loc = _Loc(lambda off, r=r: (r[:, :, None, None, None, :2]
                                     + off / dec_points
                                     * r[:, :, None, None, None, 2:] * 0.5),
                   dec_points)
        h = deformable_attention(pr, p, pre, tgt + query_pos, memory, shapes,
                                 loc, g)
        tgt = ln(tgt + h, p, pre + "norm2")
        tgt = ffn(pr, p, pre, tgt, "ffn1", "ffn2", "norm3")
        ref_in = ref
        ref = torch.sigmoid(inverse_sigmoid(ref)
                            + box_mlp(p, "bbox_head", tgt, 3))
    hs = ln(tgt, p, "decoder_norm")
    boxes = torch.sigmoid(box_mlp(p, "bbox_head", hs, 3)
                          + inverse_sigmoid(ref_in))
    logits = torch.where(text_mask[:, None, :], pr.einsum(
        "bqc,btc->bqt", hs, txt_masked, "island"), NEG)
    return {"pred_logits": logits, "pred_boxes": boxes,
            "query_index": index, "own_index": own, "text_features": txt,
            "memory": memory, "hs": hs}


def greedy_nms(boxes, scores, valid, threshold):
    """Greedy class-agnostic NMS in score order (stable): keep [N]."""
    order = torch.sort(torch.where(valid, scores, -torch.inf), descending=True,
                       stable=True)[1]
    b = boxes[order]
    area = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    lt = torch.maximum(b[:, None, :2], b[None, :, :2])
    rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area[:, None] + area[None] - inter
    iou = torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)
    v = valid[order]
    keep = torch.zeros_like(v)
    for i in range(len(order)):
        if v[i] and not bool((keep[:i] & (iou[:i, i] > threshold)).any()):
            keep[i] = True
    out = torch.zeros_like(keep)
    out[order] = keep
    return out


def postprocess(logits, boxes, span_matrix, span_valid, side: float,
                topk: int, box_threshold: float, nms_threshold: float):
    """One image's token logits [Q, T] and boxes [Q, 4] -> the 2D slots:
    each query's phrase scores (the sum of its tokens' probabilities), the
    best phrase, the box threshold, class-agnostic NMS, the top `topk` by
    score; boxes xyxy in pixels of the side x side canvas."""
    probs = torch.sigmoid(logits)
    phrase = torch.where(span_valid[None], probs @ span_matrix.T, NEG)
    scores, classes = phrase.max(1)
    cx, cy, w, h = (boxes * side).unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    valid = scores > box_threshold
    keep = greedy_nms(xyxy, scores, valid, nms_threshold)
    masked = torch.where(keep, scores, torch.finfo(scores.dtype).min)
    top, idx = torch.sort(masked, descending=True, stable=True)
    top, idx = top[:topk], idx[:topk]
    ok = top > box_threshold
    return {"boxes": xyxy[idx], "scores": torch.where(ok, top, 0.0),
            "classes": classes[idx].int(), "valid": ok}
