"""Seeded state dicts in the released checkpoints' key layouts, at any width.

Test support for the converters and loaders (tests/test_torch_*.py and
chip_smoke.py): no CLI calls it, and nothing here is a released weight. The
released files are not in the repository; these dicts carry their key names
and shapes, filled from a numpy seed:

  lift_state        ovmono3d_lift.pth (detectron2: `backbone.net.vit.*`,
                    `backbone.net.depth_fusion.*`, `backbone.simfp_*`,
                    `proposal_generator.*`, `roi_heads.*` with the priors)
  dinov2_hub_state  a torch.hub DINOv2 trunk (`--trunk-ckpt`)
  gdino_state       the original GroundingDINO (`backbone.0.*` Swin, `bert.*`,
                    `transformer.*`, `input_proj.*`, `feat_map`, `bbox_embed`)
  sam_state         the official segment-anything (`image_encoder.*`,
                    `prompt_encoder.*`, `mask_decoder.*`)
  depth_pro_state   transformers' DepthProForDepthEstimation (`depth_pro.*`,
                    `fusion_stage.*`, `head.*`, `fov_model.*`)
  clip_visual_state open_clip's 'openai' ViT-B/16 tower (`visual.*`)
  mae_state         HF ViTMAE (`vit.embeddings.*`, `vit.encoder.layer.*`)
  midas_state       MiDaS DPT_Large (`pretrained.model.*` timm ViT-L/16 and
                    the DPT `scratch.*` head)
  dla_state         the DLA model zoo (`base_layer.*`, `level0-5.*`, `fc.*`)
  resnet_state      torchvision ResNet (`conv1`, `bn1`, `layer1-4.*`, `fc`)
  densenet_state    torchvision DenseNet (`features.*`, `classifier.*`)
  mnasnet_state     torchvision MNASNet 1.0 (`layers.*`, `classifier.1.*`)
  shufflenet_state  torchvision ShuffleNetV2 x1.0 (`conv1`, `stage2-4`,
                    `conv5`, `fc`)

Each also holds keys the converters do not read, as the released modules
register them: DINOv2's final `norm.*` and `mask_token`, the priors (read by
`lift_convert.extract_priors`), Swin's `relative_position_index`, BERT's
`position_ids` and pooler, the decoder's shared `bbox_embed` copies, SAM's
unused point embeddings and mask downscaling, Depth-Pro's `mask_token`s and
its first fusion layer's unused residual unit, CLIP's `ln_post` and `proj`,
MAE's final `layernorm` and table, MiDaS's final `norm` and DPT head, and
the CNNs' classifiers and `num_batches_tracked`. `IGNORED` names them by
pattern. BatchNorms are drawn with their running statistics: mean ~N(0,
0.02^2), var ~1 + N(0, 0.1^2), as scales are.

Kernels are drawn ~N(0, 1/fan_in), biases ~N(0, 0.02^2), norm scales
~1 + N(0, 0.1^2): activations stay O(1) through any depth. With
`shape_only=True` every array has a zero-byte dtype (`np.dtype([])`): the
keys and shapes of a full-size checkpoint in no memory, for the coverage
tests and the converters' transposes alike.
"""
from __future__ import annotations

import math

import numpy as np

SHAPE_ONLY = np.dtype([])

# Keys (regexes) each converter leaves unread, by the layout above.
IGNORED = {
    "lift": (r"backbone\.net\.vit\.norm\.", r"backbone\.net\.vit\.mask_token",
             r"roi_heads\.priors_"),
    "dinov2": (r"^norm\.", r"^mask_token"),
    "gdino": (r"\.relative_position_index$", r"bert\.embeddings\.position_ids",
              r"bert\.pooler\.", r"^bbox_embed\.[1-9]",
              r"^transformer\.decoder\.bbox_embed\."),
    # (mask_embed / not_a_point_embeddings: hf_shims' names for the same)
    "sam": (r"prompt_encoder\.point_embeddings\.[01]\.",
            r"prompt_encoder\.not_a_point_embed",
            r"prompt_encoder\.mask_downscaling\.",
            r"prompt_encoder\.mask_embed\."),
    "depth_pro": (r"\.embeddings\.mask_token$",
                  r"^fusion_stage\.intermediate\.0\.residual_layer1\."),
    "clip": (r"^visual\.ln_post\.", r"^visual\.proj$"),
    "mae": (r"^vit\.layernorm\.", r"position_embeddings$"),
    "midas": (r"^pretrained\.model\.norm\.", r"^scratch\."),
    "cnn": (r"num_batches_tracked$", r"^fc\.", r"^classifier\.",
            r"^layers\.1[456]\.", r"^conv5\."),
}


class _Draw:
    """Array maker: seeded values, or zero-byte arrays of the same shape."""

    def __init__(self, seed: int, shape_only: bool):
        self.rng = np.random.default_rng(seed)
        self.shape_only = shape_only
        self.state: dict[str, np.ndarray] = {}

    def put(self, key: str, shape, kind: str = "w", fan_in: float = 1
            ) -> None:
        shape = tuple(int(s) for s in shape)
        if self.shape_only:
            self.state[key] = np.empty(shape, SHAPE_ONLY)
            return
        arr = self.rng.standard_normal(shape, dtype=np.float32)
        if kind == "scale":
            arr = 1.0 + 0.1 * arr
        else:
            arr *= np.float32(0.02 if kind == "bias" else fan_in ** -0.5)
        self.state[key] = arr.astype(np.float32, copy=False)

    def linear(self, prefix: str, din: int, dout: int, bias=True) -> None:
        self.put(prefix + ".weight", (dout, din), fan_in=din)
        if bias:
            self.put(prefix + ".bias", (dout,), "bias")

    def conv(self, prefix: str, cin: int, cout: int, k: int,
             bias=True) -> None:
        self.put(prefix + ".weight", (cout, cin, k, k), fan_in=cin * k * k)
        if bias:
            self.put(prefix + ".bias", (cout,), "bias")

    def deconv(self, prefix: str, cin: int, cout: int, k: int = 2,
               bias=True) -> None:
        """torch ConvTranspose2d: weight [in, out, kh, kw]."""
        self.put(prefix + ".weight", (cin, cout, k, k), fan_in=cin)
        if bias:
            self.put(prefix + ".bias", (cout,), "bias")

    def norm(self, prefix: str, d: int) -> None:
        self.put(prefix + ".weight", (d,), "scale")
        self.put(prefix + ".bias", (d,), "bias")

    def bn(self, prefix: str, d: int) -> None:
        """torch BatchNorm2d: affine, running statistics, the step count."""
        self.norm(prefix, d)
        self.put(prefix + ".running_mean", (d,), "bias")
        self.put(prefix + ".running_var", (d,), "scale")
        self.state[prefix + ".num_batches_tracked"] = (
            np.empty((), SHAPE_ONLY) if self.shape_only
            else np.array(0, np.int64))

    def convbn(self, conv: str, bn: str, cin: int, cout: int, k: int,
               groups: int = 1) -> None:
        self.conv(conv, cin // groups, cout, k, bias=False)
        self.bn(bn, cout)

    def table(self, key: str, shape, std: float = 0.02) -> None:
        self.put(key, shape, fan_in=1.0 / std ** 2)


def _dinov2(d: _Draw, p: str, dim: int, depth: int, patch: int, grid: int,
            layerscale: bool = True) -> None:
    """A torch.hub DINOv2 ViT under prefix `p` (fused qkv, `blocks.N.`),
    with its final norm and mask token."""
    d.table(p + "cls_token", (1, 1, dim))
    d.table(p + "pos_embed", (1, grid * grid + 1, dim))
    d.table(p + "mask_token", (1, dim))
    d.conv(p + "patch_embed.proj", 3, dim, patch)
    for i in range(depth):
        b = f"{p}blocks.{i}."
        d.norm(b + "norm1", dim)
        d.linear(b + "attn.qkv", dim, 3 * dim)
        d.linear(b + "attn.proj", dim, dim)
        d.norm(b + "norm2", dim)
        d.linear(b + "mlp.fc1", dim, 4 * dim)
        d.linear(b + "mlp.fc2", 4 * dim, dim)
        if layerscale:
            d.put(b + "ls1.gamma", (dim,), "scale")
            d.put(b + "ls2.gamma", (dim,), "scale")
    d.norm(p + "norm", dim)


def dinov2_hub_state(dim: int = 768, depth: int = 12, patch: int = 14,
                     grid: int = 37, layerscale: bool = True, seed: int = 0,
                     shape_only: bool = False) -> dict:
    """A torch.hub DINOv2 trunk (dinov2_vitb14 at the defaults)."""
    d = _Draw(seed, shape_only)
    _dinov2(d, "", dim, depth, patch, grid, layerscale)
    return d.state


def lift_state(cfg, seed: int = 0, shape_only: bool = False) -> dict:
    """ovmono3d_lift.pth's layout for the port's ModelConfig `cfg` (the
    flagship: `config.flagship_config()`), with the category priors
    roi_heads.priors_dims_per_cat [1, C, 2, 3], priors_z_scales [C, B] and
    priors_z_stats [C, B, 2] (B = max(cube.cluster_bins, 1)). The cube head
    must have no convs (the converter maps fc heads only)."""
    d = _Draw(seed, shape_only)
    bb, cube, box = cfg.backbone, cfg.cube, cfg.roi_box
    C, out = bb.embed_dim, bb.out_channels
    if cube.num_conv:
        raise ValueError("the LIFT converter maps cube heads without convs")
    _dinov2(d, "backbone.net.vit.", C, bb.depth, bb.patch_size,
            bb.pretrain_grid, bb.layerscale)
    if bb.use_depth_fusion:
        d.conv("backbone.net.depth_fusion", C + 1, C, 1)
    for scale in bb.scale_factors:
        stage = int(math.log2(round(bb.patch_size / scale)))
        p = f"backbone.simfp_{stage}."
        cin = C
        if scale == 4.0:
            d.deconv(p + "0", C, C // 2)
            d.norm(p + "1", C // 2)
            d.deconv(p + "3", C // 2, C // 4)
            cin, c1 = C // 4, 4
        elif scale == 2.0:
            d.deconv(p + "0", C, C // 2)
            cin, c1 = C // 2, 1
        elif scale == 1.0:
            c1 = 0
        else:                                   # 0.5: MaxPool first
            c1 = 1
        d.conv(f"{p}{c1}", cin, out, 1, bias=False)
        d.norm(f"{p}{c1}.norm", out)
        d.conv(f"{p}{c1 + 1}", out, out, 3, bias=False)
        d.norm(f"{p}{c1 + 1}.norm", out)
    a = len(cfg.anchors.aspect_ratios) * len(cfg.anchors.sizes[0])
    r = "proposal_generator.rpn_head."
    d.conv(r + "conv", out, out, 3)
    d.conv(r + "objectness_logits", out, a, 1)
    d.conv(r + "anchor_deltas", out, 4 * a, 1)
    n = cfg.num_classes
    din = out * box.pooler_resolution ** 2
    for j in range(box.num_fc):
        d.linear(f"roi_heads.box_head.fc{j + 1}", din, box.fc_dim)
        din = box.fc_dim
    d.linear("roi_heads.box_predictor.cls_score", din, n + 1)
    d.linear("roi_heads.box_predictor.bbox_pred", din,
             4 * (1 if box.cls_agnostic_bbox_reg else n))
    p = "roi_heads.cube_head."
    in_dim = out * cube.pooler_resolution ** 2
    groups = (("feature_generator",) if cube.shared_fc else
              tuple(f"feature_generator_{t}"
                    for t in ("XY", "dims", "pose", "Z", "conf")))
    for g in groups:
        din = in_dim
        for j in range(cube.num_fc):
            d.linear(f"{p}{g}.fc{j + 1}", din, cube.fc_dim)
            din = cube.fc_dim
    feat = cube.fc_dim if cube.num_fc else in_dim
    mult = n if cube.dims_priors_enabled else 1
    bins = max(cube.cluster_bins, 1)
    pose_dims = {"6d": 6, "quaternion": 4, "euler": 3}[cube.pose_type]
    d.linear(p + "bbox_3D_center_deltas", feat, 2 * mult)
    d.linear(p + "bbox_3D_dims", feat, 3 * mult)
    d.linear(p + "bbox_3D_pose", feat, pose_dims * mult)
    d.linear(p + "bbox_3D_center_depth", feat, bins * mult)
    if cube.use_confidence > 0:
        d.linear(p + "bbox_3D_uncertainty", feat, mult)
    if shape_only:
        d.put("roi_heads.priors_dims_per_cat", (1, n, 2, 3))
        d.put("roi_heads.priors_z_scales", (n, bins))
        d.put("roi_heads.priors_z_stats", (n, bins, 2))
    else:
        g = d.rng
        dims = np.stack([g.uniform(0.3, 2.0, (n, 3)),
                         g.uniform(0.05, 0.5, (n, 3))], 1)
        z = np.sort(g.uniform(1.0, 30.0, (n, bins)), 1)
        d.state["roi_heads.priors_dims_per_cat"] = dims[None].astype(
            np.float32)
        d.state["roi_heads.priors_z_scales"] = z.astype(np.float32)
        d.state["roi_heads.priors_z_stats"] = np.stack(
            [z, 0.2 * z], -1).astype(np.float32)
    return d.state


def gdino_state(seed: int = 0, shape_only: bool = False, hidden_dim=256,
                nheads=8, enc_layers=6, dec_layers=6, num_queries=900,
                num_levels=4, enc_points=4, dec_points=4, ffn_dim=2048,
                swin_embed_dim=128, swin_depths=(2, 2, 18, 2),
                swin_heads=(4, 8, 16, 32), swin_window=12, bert_layers=12,
                bert_hidden=768, bert_intermediate=3072, bert_vocab=30522,
                bert_max_position=512, **_unused) -> dict:
    """The original GroundingDINO's layout for the port's GroundingDINO
    keyword arguments (the SwinB release at the defaults;
    `max_text_len`, `bert_heads` and `compute_dtype` set no shape)."""
    d = _Draw(seed, shape_only)
    c, w = hidden_dim, swin_window
    sw = "backbone.0."
    d.conv(sw + "patch_embed.proj", 3, swin_embed_dim, 4)
    d.norm(sw + "patch_embed.norm", swin_embed_dim)
    dim = swin_embed_dim
    for si, depth in enumerate(swin_depths):
        for bi in range(depth):
            p = f"{sw}layers.{si}.blocks.{bi}."
            d.norm(p + "norm1", dim)
            d.linear(p + "attn.qkv", dim, 3 * dim)
            d.linear(p + "attn.proj", dim, dim)
            d.table(p + "attn.relative_position_bias_table",
                    ((2 * w - 1) ** 2, swin_heads[si]))
            if shape_only:
                d.put(p + "attn.relative_position_index", (w * w, w * w))
            else:
                d.state[p + "attn.relative_position_index"] = np.zeros(
                    (w * w, w * w), np.int64)
            d.norm(p + "norm2", dim)
            d.linear(p + "mlp.fc1", dim, 4 * dim)
            d.linear(p + "mlp.fc2", 4 * dim, dim)
        if si < len(swin_depths) - 1:
            p = f"{sw}layers.{si}.downsample."
            d.norm(p + "norm", 4 * dim)
            d.linear(p + "reduction", 4 * dim, 2 * dim, bias=False)
            dim *= 2
    dims = [swin_embed_dim * 2 ** i for i in range(len(swin_depths))]
    for si in (1, 2, 3):
        d.norm(f"{sw}norm{si}", dims[si])

    h = bert_hidden
    d.table("bert.embeddings.word_embeddings.weight", (bert_vocab, h))
    d.table("bert.embeddings.position_embeddings.weight",
            (bert_max_position, h))
    d.table("bert.embeddings.token_type_embeddings.weight", (2, h))
    d.norm("bert.embeddings.LayerNorm", h)
    if shape_only:
        d.put("bert.embeddings.position_ids", (1, bert_max_position))
    else:
        d.state["bert.embeddings.position_ids"] = np.arange(
            bert_max_position, dtype=np.int64)[None]
    for i in range(bert_layers):
        p = f"bert.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            d.linear(p + "attention.self." + name, h, h)
        d.linear(p + "attention.output.dense", h, h)
        d.norm(p + "attention.output.LayerNorm", h)
        d.linear(p + "intermediate.dense", h, bert_intermediate)
        d.linear(p + "output.dense", bert_intermediate, h)
        d.norm(p + "output.LayerNorm", h)
    d.linear("bert.pooler.dense", h, h)

    d.linear("feat_map", h, c)
    for i, din in enumerate(dims[1:]):
        d.conv(f"input_proj.{i}.0", din, c, 1)
        d.norm(f"input_proj.{i}.1", c)
    d.conv("input_proj.3.0", dims[3], c, 3)
    d.norm("input_proj.3.1", c)
    d.table("transformer.level_embed", (num_levels, c), std=1.0)
    d.table("transformer.tgt_embed.weight", (num_queries, c), std=1.0)
    d.linear("transformer.enc_output", c, c)
    d.norm("transformer.enc_output_norm", c)
    d.norm("transformer.decoder.norm", c)

    def deformable(p, points):
        d.linear(p + "sampling_offsets", c, nheads * num_levels * points * 2)
        d.linear(p + "attention_weights", c, nheads * num_levels * points)
        d.linear(p + "value_proj", c, c)
        d.linear(p + "output_proj", c, c)

    def mha(p):
        d.put(p + ".in_proj_weight", (3 * c, c), fan_in=c)
        d.put(p + ".in_proj_bias", (3 * c,), "bias")
        d.linear(p + ".out_proj", c, c)

    for i in range(enc_layers):
        p = f"transformer.encoder.layers.{i}."
        deformable(p + "self_attn.", enc_points)
        d.linear(p + "linear1", c, ffn_dim)
        d.linear(p + "linear2", ffn_dim, c)
        d.norm(p + "norm1", c)
        d.norm(p + "norm2", c)
        p = f"transformer.encoder.text_layers.{i}."
        mha(p + "self_attn")
        d.linear(p + "linear1", c, 1024)
        d.linear(p + "linear2", 1024, c)
        d.norm(p + "norm1", c)
        d.norm(p + "norm2", c)
        p = f"transformer.encoder.fusion_layers.{i}."
        d.norm(p + "layer_norm_v", c)
        d.norm(p + "layer_norm_l", c)
        for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj"):
            d.linear(p + "attn." + name, c, 1024)
        d.linear(p + "attn.out_v_proj", 1024, c)
        d.linear(p + "attn.out_l_proj", 1024, c)
        d.put(p + "gamma_v", (c,), "bias")
        d.put(p + "gamma_l", (c,), "bias")
    for i in range(dec_layers):
        p = f"transformer.decoder.layers.{i}."
        deformable(p + "cross_attn.", dec_points)
        mha(p + "self_attn")
        mha(p + "ca_text")
        d.linear(p + "linear1", c, ffn_dim)
        d.linear(p + "linear2", ffn_dim, c)
        for name in ("norm1", "norm2", "norm3", "catext_norm"):
            d.norm(p + name, c)
    for j in range(3):
        d.linear(f"bbox_embed.0.layers.{j}", c, 4 if j == 2 else c)
        d.linear(f"transformer.enc_out_bbox_embed.layers.{j}", c,
                 4 if j == 2 else c)
    d.linear("transformer.decoder.ref_point_head.layers.0", 2 * c, c)
    d.linear("transformer.decoder.ref_point_head.layers.1", c, c)
    # dec_pred_bbox_embed_share: every decoder layer's box head is
    # bbox_embed.0, registered under each index and again on the decoder.
    shared = {k: v for k, v in d.state.items()
              if k.startswith("bbox_embed.0.")}
    for i in range(dec_layers):
        for k, v in shared.items():
            rest = k[len("bbox_embed.0."):]
            if i:
                d.state[f"bbox_embed.{i}.{rest}"] = v
            d.state[f"transformer.decoder.bbox_embed.{i}.{rest}"] = v
    return d.state


def sam_state(embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
              global_blocks=(7, 15, 23, 31), window_size: int = 14,
              grid: int = 64, patch: int = 16, neck: int = 256,
              decoder_dim: int = 256, decoder_mlp: int = 2048,
              decoder_depth: int = 2, num_masks: int = 3,
              mask_in_chans: int = 16, seed: int = 0,
              shape_only: bool = False) -> dict:
    """The official segment-anything layout (sam_vit_h at the defaults;
    `backbones.SAM_ARCHS` gives vit_b / vit_l's widths)."""
    d = _Draw(seed, shape_only)
    hd = embed_dim // num_heads
    p = "image_encoder."
    d.conv(p + "patch_embed.proj", 3, embed_dim, patch)
    d.table(p + "pos_embed", (1, grid, grid, embed_dim))
    for i in range(depth):
        b = f"{p}blocks.{i}."
        size = grid if i in global_blocks else window_size
        d.norm(b + "norm1", embed_dim)
        d.linear(b + "attn.qkv", embed_dim, 3 * embed_dim)
        d.linear(b + "attn.proj", embed_dim, embed_dim)
        d.table(b + "attn.rel_pos_h", (2 * size - 1, hd), std=0.1)
        d.table(b + "attn.rel_pos_w", (2 * size - 1, hd), std=0.1)
        d.norm(b + "norm2", embed_dim)
        d.linear(b + "mlp.lin1", embed_dim, 4 * embed_dim)
        d.linear(b + "mlp.lin2", 4 * embed_dim, embed_dim)
    d.conv(p + "neck.0", embed_dim, neck, 1, bias=False)
    d.norm(p + "neck.1", neck)
    d.conv(p + "neck.2", neck, neck, 3, bias=False)
    d.norm(p + "neck.3", neck)

    c = decoder_dim
    q = "prompt_encoder."
    d.table(q + "pe_layer.positional_encoding_gaussian_matrix",
            (2, c // 2), std=1.0)
    for i in range(4):
        d.table(f"{q}point_embeddings.{i}.weight", (1, c), std=1.0)
    d.table(q + "not_a_point_embed.weight", (1, c), std=1.0)
    d.table(q + "no_mask_embed.weight", (1, c), std=1.0)
    m = q + "mask_downscaling."
    d.conv(m + "0", 1, mask_in_chans // 4, 2)
    d.norm(m + "1", mask_in_chans // 4)
    d.conv(m + "3", mask_in_chans // 4, mask_in_chans, 2)
    d.norm(m + "4", mask_in_chans)
    d.conv(m + "6", mask_in_chans, c, 1)

    md = "mask_decoder."

    def attn(prefix, inner):
        for name in ("q_proj", "k_proj", "v_proj"):
            d.linear(f"{prefix}.{name}", c, inner)
        d.linear(prefix + ".out_proj", inner, c)

    d.table(md + "iou_token.weight", (1, c), std=1.0)
    d.table(md + "mask_tokens.weight", (num_masks + 1, c), std=1.0)
    for i in range(decoder_depth):
        lp = f"{md}transformer.layers.{i}."
        attn(lp + "self_attn", c)
        d.norm(lp + "norm1", c)
        attn(lp + "cross_attn_token_to_image", c // 2)
        d.norm(lp + "norm2", c)
        d.linear(lp + "mlp.lin1", c, decoder_mlp)
        d.linear(lp + "mlp.lin2", decoder_mlp, c)
        d.norm(lp + "norm3", c)
        attn(lp + "cross_attn_image_to_token", c // 2)
        d.norm(lp + "norm4", c)
    attn(md + "transformer.final_attn_token_to_image", c // 2)
    d.norm(md + "transformer.norm_final_attn", c)
    d.deconv(md + "output_upscaling.0", c, c // 4)
    d.norm(md + "output_upscaling.1", c // 4)
    d.deconv(md + "output_upscaling.3", c // 4, c // 8)
    for i in range(num_masks + 1):
        hp = f"{md}output_hypernetworks_mlps.{i}.layers"
        d.linear(hp + ".0", c, c)
        d.linear(hp + ".1", c, c)
        d.linear(hp + ".2", c, c // 8)
    d.linear(md + "iou_prediction_head.layers.0", c, c)
    d.linear(md + "iou_prediction_head.layers.1", c, c)
    d.linear(md + "iou_prediction_head.layers.2", c, num_masks + 1)
    return d.state


def _hf_dinov2(d: _Draw, p: str, dim: int, depth: int, patch: int,
               grid: int) -> None:
    """A transformers Dinov2Model (separate q/k/v, layer scales, final
    layernorm) under prefix `p`."""
    e = p + "embeddings."
    d.table(e + "cls_token", (1, 1, dim))
    d.table(e + "mask_token", (1, dim))
    d.table(e + "position_embeddings", (1, grid * grid + 1, dim))
    d.conv(e + "patch_embeddings.projection", 3, dim, patch)
    for i in range(depth):
        b = f"{p}encoder.layer.{i}."
        d.norm(b + "norm1", dim)
        for name in ("query", "key", "value"):
            d.linear(b + "attention.attention." + name, dim, dim)
        d.linear(b + "attention.output.dense", dim, dim)
        d.put(b + "layer_scale1.lambda1", (dim,), "scale")
        d.norm(b + "norm2", dim)
        d.linear(b + "mlp.fc1", dim, 4 * dim)
        d.linear(b + "mlp.fc2", 4 * dim, dim)
        d.put(b + "layer_scale2.lambda1", (dim,), "scale")
    d.norm(p + "layernorm", dim)


def depth_pro_state(seed: int = 0, shape_only: bool = False,
                    patch_size: int = 16, encoder_size: int = 384,
                    vit_dim: int = 1024, vit_depth: int = 24,
                    scaled_dims=(1024, 1024, 512), hook_dims=(256, 256),
                    fusion_dim: int = 256, num_fov_layers: int = 2,
                    use_fov: bool = True, **_unused) -> dict:
    """transformers' DepthProForDepthEstimation layout (apple/DepthPro-hf)
    for the port's DepthPro keyword arguments (the release at the
    defaults; `vit_heads`, the ratios, `hook_ids`, `merge_padding`, `quant`,
    `gelu` and `dtype` set no shape)."""
    d = _Draw(seed, shape_only)
    grid = encoder_size // patch_size
    for name in ("patch_encoder", "image_encoder"):
        _hf_dinov2(d, f"depth_pro.encoder.{name}.model.", vit_dim, vit_depth,
                   patch_size, grid)
    up = "depth_pro.neck.feature_upsample."
    d.deconv(up + "image_block.layers.0", vit_dim, scaled_dims[0])
    for i, c in enumerate(scaled_dims):
        d.conv(f"{up}scaled_images.{i}.layers.0", vit_dim, c, 1, bias=False)
        d.deconv(f"{up}scaled_images.{i}.layers.1", c, c, bias=False)
    for i, c in enumerate(hook_dims):
        inter = fusion_dim if i == 0 else c
        d.conv(f"{up}intermediate.{i}.layers.0", vit_dim, inter, 1,
               bias=False)
        for j in range(2 + i):
            d.deconv(f"{up}intermediate.{i}.layers.{j + 1}",
                     inter if j == 0 else c, c, bias=False)
    d.conv("depth_pro.neck.fuse_image_with_low_res", 2 * scaled_dims[0],
           scaled_dims[0], 1)
    dims = tuple(scaled_dims) + tuple(hook_dims)
    n_project = len(dims) - (1 if dims[-1] == fusion_dim else 0)
    for i in range(n_project):
        d.conv(f"depth_pro.neck.feature_projection.projections.{i}",
               dims[i], fusion_dim, 3, bias=False)

    def fusion(p, deconv):
        for r in ("residual_layer1", "residual_layer2"):
            for k in ("convolution1", "convolution2"):
                d.conv(f"{p}.{r}.{k}", fusion_dim, fusion_dim, 3)
        if deconv:
            d.deconv(p + ".deconv", fusion_dim, fusion_dim, bias=False)
        d.conv(p + ".projection", fusion_dim, fusion_dim, 1)

    for i in range(len(dims) - 1):
        fusion(f"fusion_stage.intermediate.{i}", True)
    fusion("fusion_stage.final", False)
    half = fusion_dim // 2
    d.conv("head.layers.0", fusion_dim, half, 3)
    d.deconv("head.layers.1", half, half)
    d.conv("head.layers.2", half, 32, 3)
    d.conv("head.layers.4", 32, 1, 1)
    if use_fov:
        _hf_dinov2(d, "fov_model.fov_encoder.model.", vit_dim, vit_depth,
                   patch_size, grid)
        d.linear("fov_model.fov_encoder.neck", vit_dim, half)
        d.conv("fov_model.conv", fusion_dim, half, 3)
        cin = half
        for i in range(num_fov_layers):
            cout = -(-fusion_dim // 2 ** (i + 2))
            d.conv(f"fov_model.head.layers.{2 * i}", cin, cout, 3)
            cin = cout
        k = int((grid - 1) / 2 ** num_fov_layers + 1)
        d.conv(f"fov_model.head.layers.{2 * num_fov_layers}", cin, 1, k)
    return d.state


def _vit_blocks(d: _Draw, p: str, dim: int, depth: int) -> None:
    """timm / hub ViT blocks (fused qkv, no layer scale) under `p`."""
    for i in range(depth):
        b = f"{p}blocks.{i}."
        d.norm(b + "norm1", dim)
        d.linear(b + "attn.qkv", dim, 3 * dim)
        d.linear(b + "attn.proj", dim, dim)
        d.norm(b + "norm2", dim)
        d.linear(b + "mlp.fc1", dim, 4 * dim)
        d.linear(b + "mlp.fc2", 4 * dim, dim)


def clip_visual_state(dim: int = 768, depth: int = 12, patch: int = 16,
                      grid: int = 14, out_dim: int = 512, seed: int = 0,
                      shape_only: bool = False) -> dict:
    """open_clip's ViT-B-16 'openai' visual tower (the defaults)."""
    d = _Draw(seed, shape_only)
    p = "visual."
    d.table(p + "class_embedding", (dim,))
    d.table(p + "positional_embedding", (grid * grid + 1, dim))
    d.conv(p + "conv1", 3, dim, patch, bias=False)
    d.norm(p + "ln_pre", dim)
    for i in range(depth):
        b = f"{p}transformer.resblocks.{i}."
        d.norm(b + "ln_1", dim)
        d.put(b + "attn.in_proj_weight", (3 * dim, dim), fan_in=dim)
        d.put(b + "attn.in_proj_bias", (3 * dim,), "bias")
        d.linear(b + "attn.out_proj", dim, dim)
        d.norm(b + "ln_2", dim)
        d.linear(b + "mlp.c_fc", dim, 4 * dim)
        d.linear(b + "mlp.c_proj", 4 * dim, dim)
    d.norm(p + "ln_post", dim)
    d.put(p + "proj", (dim, out_dim), fan_in=dim)
    return d.state


def mae_state(dim: int = 768, depth: int = 12, patch: int = 16,
              grid: int = 14, seed: int = 0, shape_only: bool = False
              ) -> dict:
    """HF ViTMAE's encoder under `vit.` (facebook/vit-mae-base at the
    defaults), with its fixed sin-cos table and final layernorm."""
    d = _Draw(seed, shape_only)
    e = "vit.embeddings."
    d.table(e + "cls_token", (1, 1, dim))
    d.table(e + "position_embeddings", (1, grid * grid + 1, dim))
    d.conv(e + "patch_embeddings.projection", 3, dim, patch)
    for i in range(depth):
        b = f"vit.encoder.layer.{i}."
        d.norm(b + "layernorm_before", dim)
        for name in ("query", "key", "value"):
            d.linear(b + "attention.attention." + name, dim, dim)
        d.linear(b + "attention.output.dense", dim, dim)
        d.norm(b + "layernorm_after", dim)
        d.linear(b + "intermediate.dense", dim, 4 * dim)
        d.linear(b + "output.dense", 4 * dim, dim)
    d.norm("vit.layernorm", dim)
    return d.state


def midas_state(dim: int = 1024, depth: int = 24, patch: int = 16,
                grid: int = 24, features: int = 256, seed: int = 0,
                shape_only: bool = False) -> dict:
    """MiDaS DPT_Large (the defaults): the timm ViT-L/16 trunk under
    `pretrained.model.` and a stand-in of the DPT head's `scratch.*`."""
    d = _Draw(seed, shape_only)
    p = "pretrained.model."
    d.table(p + "cls_token", (1, 1, dim))
    d.table(p + "pos_embed", (1, grid * grid + 1, dim))
    d.conv(p + "patch_embed.proj", 3, dim, patch)
    _vit_blocks(d, p, dim, depth)
    d.norm(p + "norm", dim)
    for i in range(4):
        d.conv(f"scratch.layer{i + 1}_rn", dim, features, 3, bias=False)
    return d.state


def _dla_block(d: _Draw, p: str, block: str, cin: int, features: int,
               cardinality: int) -> None:
    if block == "basic":
        d.convbn(p + ".conv1", p + ".bn1", cin, features, 3)
        d.convbn(p + ".conv2", p + ".bn2", features, features, 3)
        return
    bottle = (features * cardinality // 32 if block == "bottleneckx"
              else features // 2)
    d.convbn(p + ".conv1", p + ".bn1", cin, bottle, 1)
    d.convbn(p + ".conv2", p + ".bn2", bottle, bottle, 3,
             groups=cardinality if block == "bottleneckx" else 1)
    d.convbn(p + ".conv3", p + ".bn3", bottle, features, 1)


def _dla_tree(d: _Draw, p: str, levels: int, cin: int, features: int,
              level_root: bool, block: str, cardinality: int,
              children_ch=()) -> None:
    """The reference Tree's keys; the root's width counts the children."""
    ch = list(children_ch) + ([cin] if level_root else [])
    if levels == 1:
        _dla_block(d, p + ".tree1", block, cin, features, cardinality)
        _dla_block(d, p + ".tree2", block, features, features, cardinality)
        d.convbn(p + ".root.conv", p + ".root.bn", 2 * features + sum(ch),
                 features, 1)
    else:
        _dla_tree(d, p + ".tree1", levels - 1, cin, features, False, block,
                  cardinality)
        _dla_tree(d, p + ".tree2", levels - 1, features, features, False,
                  block, cardinality, (*ch, features))
    if cin != features:
        d.convbn(p + ".project.0", p + ".project.1", cin, features, 1)


def dla_state(levels=(1, 1, 1, 2, 2, 1), channels=(16, 32, 64, 128, 256, 512),
              block: str = "basic", cardinality: int = 32,
              num_classes: int = 1000, seed: int = 0,
              shape_only: bool = False, **_unused) -> dict:
    """The DLA model zoo's layout (dla34 at the defaults; a
    `models.dla.DLA_PRESETS` entry gives the others), with its 1x1-conv
    classifier `fc`."""
    d = _Draw(seed, shape_only)
    ch = channels
    d.convbn("base_layer.0", "base_layer.1", 3, ch[0], 7)
    d.convbn("level0.0", "level0.1", ch[0], ch[0], 3)
    d.convbn("level1.0", "level1.1", ch[0], ch[1], 3)
    for i in (2, 3, 4, 5):
        _dla_tree(d, f"level{i}", levels[i], ch[i - 1], ch[i], i > 2, block,
                  cardinality)
    d.conv("fc", ch[5], num_classes, 1)
    return d.state


def resnet_state(depths=(3, 4, 6, 3), bottleneck: bool = True,
                 width: int = 64, num_classes: int = 1000, seed: int = 0,
                 shape_only: bool = False) -> dict:
    """torchvision's ResNet layout (resnet50 at the defaults)."""
    d = _Draw(seed, shape_only)
    d.convbn("conv1", "bn1", 3, width, 7)
    cin, exp = width, 4 if bottleneck else 1
    for si, depth in enumerate(depths):
        f = width * 2 ** si
        for bi in range(depth):
            t = f"layer{si + 1}.{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            if bottleneck:
                d.convbn(t + ".conv1", t + ".bn1", cin, f, 1)
                d.convbn(t + ".conv2", t + ".bn2", f, f, 3)
                d.convbn(t + ".conv3", t + ".bn3", f, 4 * f, 1)
            else:
                d.convbn(t + ".conv1", t + ".bn1", cin, f, 3)
                d.convbn(t + ".conv2", t + ".bn2", f, f, 3)
            if cin != f * exp or stride > 1:
                d.convbn(t + ".downsample.0", t + ".downsample.1", cin,
                         f * exp, 1)
            cin = f * exp
    d.linear("fc", cin, num_classes)
    return d.state


def densenet_state(block_layers=(6, 12, 24, 16), growth: int = 32,
                   init_features: int = 64, num_classes: int = 1000,
                   seed: int = 0, shape_only: bool = False) -> dict:
    """torchvision's DenseNet layout (densenet121 at the defaults)."""
    d = _Draw(seed, shape_only)
    d.conv("features.conv0", 3, init_features, 7, bias=False)
    d.bn("features.norm0", init_features)
    ch = init_features
    for bi, layers in enumerate(block_layers):
        for li in range(layers):
            t = f"features.denseblock{bi + 1}.denselayer{li + 1}"
            d.bn(t + ".norm1", ch + li * growth)
            d.conv(t + ".conv1", ch + li * growth, 4 * growth, 1, bias=False)
            d.bn(t + ".norm2", 4 * growth)
            d.conv(t + ".conv2", 4 * growth, growth, 3, bias=False)
        ch += layers * growth
        if bi < len(block_layers) - 1:
            t = f"features.transition{bi + 1}"
            d.bn(t + ".norm", ch)
            d.conv(t + ".conv", ch, ch // 2, 1, bias=False)
            ch //= 2
    d.bn("features.norm5", ch)
    d.linear("classifier", ch, num_classes)
    return d.state


# torchvision mnasnet1_0's stacks: (out, kernel, expansion, repeats).
MNASNET_STACKS = ((24, 3, 3, 3), (40, 5, 3, 3), (80, 5, 6, 3), (96, 3, 6, 2),
                  (192, 5, 6, 4), (320, 3, 6, 1))


def mnasnet_state(num_classes: int = 1000, seed: int = 0,
                  shape_only: bool = False) -> dict:
    """torchvision's MNASNet 1.0 layout (the flat `layers` Sequential)."""
    d = _Draw(seed, shape_only)
    d.convbn("layers.0", "layers.1", 3, 32, 3)
    d.convbn("layers.3", "layers.4", 32, 32, 3, groups=32)
    d.convbn("layers.6", "layers.7", 32, 16, 1)
    cin = 16
    for si, (out, k, e, reps) in enumerate(MNASNET_STACKS):
        for ri in range(reps):
            t = f"layers.{8 + si}.{ri}.layers"
            mid = cin * e
            d.convbn(t + ".0", t + ".1", cin, mid, 1)
            d.convbn(t + ".3", t + ".4", mid, mid, k, groups=mid)
            d.convbn(t + ".6", t + ".7", mid, out, 1)
            cin = out
    d.convbn("layers.14", "layers.15", cin, 1280, 1)
    d.linear("classifier.1", 1280, num_classes)
    return d.state


def shufflenet_state(num_classes: int = 1000, seed: int = 0,
                     shape_only: bool = False) -> dict:
    """torchvision's ShuffleNetV2 x1.0 layout."""
    d = _Draw(seed, shape_only)
    d.convbn("conv1.0", "conv1.1", 3, 24, 3)
    cin = 24
    for si, (reps, out) in enumerate(zip((4, 8, 4), (116, 232, 464))):
        br = out // 2
        for ri in range(reps):
            t = f"stage{si + 2}.{ri}"
            if ri == 0:
                d.convbn(t + ".branch1.0", t + ".branch1.1", cin, cin, 3,
                         groups=cin)
                d.convbn(t + ".branch1.2", t + ".branch1.3", cin, br, 1)
            d.convbn(t + ".branch2.0", t + ".branch2.1",
                     cin if ri == 0 else br, br, 1)
            d.convbn(t + ".branch2.3", t + ".branch2.4", br, br, 3, groups=br)
            d.convbn(t + ".branch2.5", t + ".branch2.6", br, br, 1)
            cin = out
    d.convbn("conv5.0", "conv5.1", cin, 1024, 1)
    d.linear("fc", 1024, num_classes)
    return d.state
