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

Each also holds keys the converters do not read, as the released modules
register them: DINOv2's final `norm.*` and `mask_token`, the priors (read by
`lift_convert.extract_priors`), Swin's `relative_position_index`, BERT's
`position_ids` and pooler, the decoder's shared `bbox_embed` copies, SAM's
unused point embeddings and mask downscaling, Depth-Pro's `mask_token`s and
its first fusion layer's unused residual unit. `IGNORED` names them by
pattern.

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
