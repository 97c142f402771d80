"""HF-hub -> original-repo checkpoint key shims (counterpart of
ovmono3d_tpu/utils/hf_shims.py; numpy only, no transformers import).

The release converters (utils/gdino_convert.py, utils/sam_convert.py)
consume the ORIGINAL repos' state-dict key formats (the files the
reference's setup.sh downloads: groundingdino_swinb_cogcoor.pth,
sam_vit_h_4b8939.pth). These shims rename HuggingFace-hub state dicts
(GroundingDinoForObjectDetection / SamModel) into that format — the
inverse of HF's own conversion scripts, fusing the split q/k/v linears
back into qkv / in_proj tensors — so users can validate release weights
from either source. Held to HF's forward end to end by
tests/test_torch_hf_crossval.py (full-model parity at matched weights).
"""
from __future__ import annotations

import numpy as np


def hf_gdino_to_original_keys(sd: dict, depths, enc_layers, dec_layers) -> dict:
    """Rename a HF GroundingDinoForObjectDetection state dict to the original
    groundingdino_swinb key format consumed by utils/gdino_convert.py
    (inverse of HF's conversion script: fuses Swin and nn.MultiheadAttention
    q/k/v back into qkv / in_proj tensors)."""
    out = {}

    def fuse(dst, src, w="in_proj_weight", b="in_proj_bias"):
        """HF separate query/key/value linears -> fused qkv/in_proj."""
        out[dst + w] = np.concatenate(
            [sd[src + "query.weight"], sd[src + "key.weight"],
             sd[src + "value.weight"]], 0)
        out[dst + b] = np.concatenate(
            [sd[src + "query.bias"], sd[src + "key.bias"],
             sd[src + "value.bias"]], 0)

    def copy(dst, src, wb=(".weight", ".bias")):
        for s in wb:
            out[dst + s] = sd[src + s]

    # --- Swin trunk ---
    sw_hf = "model.backbone.conv_encoder.model."
    sw = "backbone.0."
    copy(sw + "patch_embed.proj", sw_hf + "embeddings.patch_embeddings.projection")
    copy(sw + "patch_embed.norm", sw_hf + "embeddings.norm")
    for si, depth in enumerate(depths):
        for bi in range(depth):
            hb = f"{sw_hf}encoder.layers.{si}.blocks.{bi}."
            ob = f"{sw}layers.{si}.blocks.{bi}."
            copy(ob + "norm1", hb + "layernorm_before")
            fuse(ob + "attn.qkv.", hb + "attention.self.",
                 w="weight", b="bias")
            out[ob + "attn.relative_position_bias_table"] = sd[
                hb + "attention.self.relative_position_bias_table"]
            copy(ob + "attn.proj", hb + "attention.output.dense")
            copy(ob + "norm2", hb + "layernorm_after")
            copy(ob + "mlp.fc1", hb + "intermediate.dense")
            copy(ob + "mlp.fc2", hb + "output.dense")
        if si < len(depths) - 1:
            hd = f"{sw_hf}encoder.layers.{si}.downsample."
            out[f"{sw}layers.{si}.downsample.reduction.weight"] = sd[
                hd + "reduction.weight"]
            copy(f"{sw}layers.{si}.downsample.norm", hd + "norm")
    for oi, stage in ((1, "stage2"), (2, "stage3"), (3, "stage4")):
        copy(f"{sw}norm{oi}", sw_hf + f"hidden_states_norms.{stage}")

    # --- text trunk + projections ---
    for k in list(sd):
        if k.startswith("model.text_backbone."):
            out["bert." + k[len("model.text_backbone."):]] = sd[k]
    copy("feat_map", "model.text_projection")
    out["transformer.level_embed"] = sd["model.level_embed"]
    out["transformer.tgt_embed.weight"] = sd[
        "model.query_position_embeddings.weight"]
    copy("transformer.enc_output", "model.enc_output")
    copy("transformer.enc_output_norm", "model.enc_output_norm")
    for j in range(3):
        copy(f"transformer.enc_out_bbox_embed.layers.{j}",
             f"model.encoder_output_bbox_embed.layers.{j}")
    for i in range(4):
        copy(f"input_proj.{i}.0", f"model.input_proj_vision.{i}.0")
        copy(f"input_proj.{i}.1", f"model.input_proj_vision.{i}.1")

    # --- encoder layers ---
    for i in range(enc_layers):
        he = f"model.encoder.layers.{i}."
        te = f"transformer.encoder.text_layers.{i}."
        fuse(te + "self_attn.", he + "text_enhancer_layer.self_attn.")
        copy(te + "self_attn.out_proj",
             he + "text_enhancer_layer.self_attn.out_proj")
        copy(te + "linear1", he + "text_enhancer_layer.fc1")
        copy(te + "linear2", he + "text_enhancer_layer.fc2")
        copy(te + "norm1", he + "text_enhancer_layer.layer_norm_before")
        copy(te + "norm2", he + "text_enhancer_layer.layer_norm_after")
        fe = f"transformer.encoder.fusion_layers.{i}."
        copy(fe + "layer_norm_v", he + "fusion_layer.layer_norm_vision")
        copy(fe + "layer_norm_l", he + "fusion_layer.layer_norm_text")
        for o, h in (("v_proj", "vision_proj"), ("l_proj", "text_proj"),
                     ("values_v_proj", "values_vision_proj"),
                     ("values_l_proj", "values_text_proj"),
                     ("out_v_proj", "out_vision_proj"),
                     ("out_l_proj", "out_text_proj")):
            copy(fe + "attn." + o, he + "fusion_layer.attn." + h)
        out[fe + "gamma_v"] = sd[he + "fusion_layer.vision_param"]
        out[fe + "gamma_l"] = sd[he + "fusion_layer.text_param"]
        de = f"transformer.encoder.layers.{i}."
        for o in ("sampling_offsets", "attention_weights", "value_proj",
                  "output_proj"):
            copy(de + "self_attn." + o,
                 he + "deformable_layer.self_attn." + o)
        copy(de + "norm1", he + "deformable_layer.self_attn_layer_norm")
        copy(de + "linear1", he + "deformable_layer.fc1")
        copy(de + "linear2", he + "deformable_layer.fc2")
        copy(de + "norm2", he + "deformable_layer.final_layer_norm")

    # --- decoder layers ---
    copy("transformer.decoder.norm", "model.decoder.layer_norm")
    for j in range(2):
        copy(f"transformer.decoder.ref_point_head.layers.{j}",
             f"model.decoder.reference_points_head.layers.{j}")
    for i in range(dec_layers):
        hd = f"model.decoder.layers.{i}."
        od = f"transformer.decoder.layers.{i}."
        fuse(od + "self_attn.", hd + "self_attn.")
        copy(od + "self_attn.out_proj", hd + "self_attn.out_proj")
        copy(od + "norm2", hd + "self_attn_layer_norm")
        fuse(od + "ca_text.", hd + "encoder_attn_text.")
        copy(od + "ca_text.out_proj", hd + "encoder_attn_text.out_proj")
        copy(od + "catext_norm", hd + "encoder_attn_text_layer_norm")
        for o in ("sampling_offsets", "attention_weights", "value_proj",
                  "output_proj"):
            copy(od + "cross_attn." + o, hd + "encoder_attn." + o)
        copy(od + "norm1", hd + "encoder_attn_layer_norm")
        copy(od + "linear1", hd + "fc1")
        copy(od + "linear2", hd + "fc2")
        copy(od + "norm3", hd + "final_layer_norm")
    for j in range(3):
        copy(f"bbox_embed.0.layers.{j}", f"bbox_embed.0.layers.{j}")
    return out




def hf_sam_to_original_keys(sd: dict) -> dict:
    """Rename a HF SamModel state dict (prompt_encoder + mask_decoder) to the
    original segment-anything key format consumed by utils/sam_convert.py."""
    ren = {
        "prompt_encoder.shared_embedding.positional_embedding":
            "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
        "mask_decoder.upscale_conv1.weight":
            "mask_decoder.output_upscaling.0.weight",
        "mask_decoder.upscale_conv1.bias":
            "mask_decoder.output_upscaling.0.bias",
        "mask_decoder.upscale_layer_norm.weight":
            "mask_decoder.output_upscaling.1.weight",
        "mask_decoder.upscale_layer_norm.bias":
            "mask_decoder.output_upscaling.1.bias",
        "mask_decoder.upscale_conv2.weight":
            "mask_decoder.output_upscaling.3.weight",
        "mask_decoder.upscale_conv2.bias":
            "mask_decoder.output_upscaling.3.bias",
        "mask_decoder.transformer.layer_norm_final_attn.weight":
            "mask_decoder.transformer.norm_final_attn.weight",
        "mask_decoder.transformer.layer_norm_final_attn.bias":
            "mask_decoder.transformer.norm_final_attn.bias",
    }
    out = {}
    for k, v in sd.items():
        if k.startswith("vision_encoder") or k.startswith(
                "shared_image_embedding"):
            continue
        k2 = ren.get(k, k)
        k2 = k2.replace("point_embed.", "point_embeddings.")
        # SamFeedForward proj_in/layers.{i}/proj_out -> layers.{0,1+i,last}
        for head, n in (("output_hypernetworks_mlps.0.", 3),
                        ("output_hypernetworks_mlps.1.", 3),
                        ("output_hypernetworks_mlps.2.", 3),
                        ("output_hypernetworks_mlps.3.", 3),
                        ("iou_prediction_head.", 3)):
            full = "mask_decoder." + head
            if k2.startswith(full):
                rest = k2[len(full):]
                if rest.startswith("proj_in."):
                    k2 = full + "layers.0." + rest[len("proj_in."):]
                elif rest.startswith("proj_out."):
                    k2 = full + f"layers.{n - 1}." + rest[len("proj_out."):]
                elif rest.startswith("layers."):
                    j = int(rest.split(".")[1])
                    k2 = (full + f"layers.{j + 1}." +
                          rest.split(".", 2)[2])
        k2 = k2.replace(".layer_norm", ".norm")
        out[k2] = np.asarray(v)
    return out

