"""segment-anything checkpoint conversion: sam_vit_*.pth -> the flax-layout
tree (counterpart of ovmono3d_tpu/utils/sam_convert.py; utils/flax_bridge.py
loads it into the port's modules).

Maps the official SAM state dict (the model OVMono3D-GEO loads —
reference tools/ovmono3d_geo.py:270-272, SamPredictor over `sam_model_registry
['vit_h']`) onto our modules:

  image_encoder.*   -> models.vit.VisionTransformer (preset "sam":
                       windowed + decomposed rel-pos attention, 256-ch neck)
  prompt_encoder.*  -> models.sam.PromptEncoder (box corners only: official
                       point_embeddings[2]/[3] + no_mask_embed)
  mask_decoder.*    -> models.sam.MaskDecoder (two-way transformer,
                       upscaling, hypernetwork MLPs, IoU head)

Layout rules per checkpoint_convert (_t Linear transpose, _conv OIHW->HWIO,
_deconv IOHW->HWIO).
"""
from __future__ import annotations

import numpy as np

from ovmono3d_tpu_torch.utils.checkpoint_convert import _conv, _deconv, _t


def _linear(state, prefix):
    return {
        "kernel": _t(state[prefix + ".weight"]),
        "bias": np.asarray(state[prefix + ".bias"]),
    }


def _norm(state, prefix):
    return {
        "scale": np.asarray(state[prefix + ".weight"]),
        "bias": np.asarray(state[prefix + ".bias"]),
    }


def _attn(state, prefix):
    """Official {q,k,v,out}_proj -> our _Attention {q,k,v,out}."""
    return {
        "q": _linear(state, prefix + ".q_proj"),
        "k": _linear(state, prefix + ".k_proj"),
        "v": _linear(state, prefix + ".v_proj"),
        "out": _linear(state, prefix + ".out_proj"),
    }


def convert_sam_encoder(state: dict, depth: int = 12,
                        prefix: str = "image_encoder.") -> dict:
    """image_encoder.* -> VisionTransformer params (sam preset)."""
    s = {k[len(prefix):]: v for k, v in state.items()
         if k.startswith(prefix)}
    pos = np.asarray(s["pos_embed"])          # [1, G, G, C]
    out = {
        "patch_embed": {
            "kernel": _conv(s["patch_embed.proj.weight"]),
            "bias": np.asarray(s["patch_embed.proj.bias"]),
        },
        "pos_embed": pos.reshape(1, -1, pos.shape[-1]),
        "neck_conv1": {"kernel": _conv(s["neck.0.weight"])},
        "neck_norm1": _norm(s, "neck.1"),
        "neck_conv2": {"kernel": _conv(s["neck.2.weight"])},
        "neck_norm2": _norm(s, "neck.3"),
    }
    for i in range(depth):
        bp = f"blocks.{i}."
        out[f"block{i}"] = {
            "norm1": _norm(s, bp + "norm1"),
            "attn": {
                "qkv": _linear(s, bp + "attn.qkv"),
                "proj": _linear(s, bp + "attn.proj"),
                "rel_pos_h": np.asarray(s[bp + "attn.rel_pos_h"]),
                "rel_pos_w": np.asarray(s[bp + "attn.rel_pos_w"]),
            },
            "norm2": _norm(s, bp + "norm2"),
            "mlp": {
                "fc1": _linear(s, bp + "mlp.lin1"),
                "fc2": _linear(s, bp + "mlp.lin2"),
            },
        }
    return out


def convert_sam_segmenter(state: dict, num_masks: int = 3,
                          decoder_depth: int = 2) -> dict:
    """prompt_encoder.* + mask_decoder.* -> SamSegmenter params."""
    prompt = {
        "pe": {
            "gaussian_matrix": np.asarray(
                state["prompt_encoder.pe_layer."
                      "positional_encoding_gaussian_matrix"]
            ),
        },
        # Box corners use point-type embeddings 2 (top-left) and 3
        # (bottom-right) (segment_anything PromptEncoder._embed_boxes).
        "point_embeddings": np.concatenate([
            np.asarray(state["prompt_encoder.point_embeddings.2.weight"]),
            np.asarray(state["prompt_encoder.point_embeddings.3.weight"]),
        ], axis=0),
        "no_mask_embed": np.asarray(
            state["prompt_encoder.no_mask_embed.weight"]
        )[0],
    }

    d = "mask_decoder."
    decoder = {
        "iou_token": np.asarray(state[d + "iou_token.weight"]),
        "mask_tokens": np.asarray(state[d + "mask_tokens.weight"]),
        "final_t2i": _attn(state, d + "transformer."
                                      "final_attn_token_to_image"),
        "final_norm": _norm(state, d + "transformer.norm_final_attn"),
        "up1": {
            "kernel": _deconv(state[d + "output_upscaling.0.weight"]),
            "bias": np.asarray(state[d + "output_upscaling.0.bias"]),
        },
        "up_norm": _norm(state, d + "output_upscaling.1"),
        "up2": {
            "kernel": _deconv(state[d + "output_upscaling.3.weight"]),
            "bias": np.asarray(state[d + "output_upscaling.3.bias"]),
        },
        "iou_l0": _linear(state, d + "iou_prediction_head.layers.0"),
        "iou_l1": _linear(state, d + "iou_prediction_head.layers.1"),
        "iou_out": _linear(state, d + "iou_prediction_head.layers.2"),
    }
    for i in range(decoder_depth):
        lp = d + f"transformer.layers.{i}."
        decoder[f"block{i}"] = {
            "self_attn": _attn(state, lp + "self_attn"),
            "norm1": _norm(state, lp + "norm1"),
            "t2i": _attn(state, lp + "cross_attn_token_to_image"),
            "norm2": _norm(state, lp + "norm2"),
            "mlp1": _linear(state, lp + "mlp.lin1"),
            "mlp2": _linear(state, lp + "mlp.lin2"),
            "norm3": _norm(state, lp + "norm3"),
            "i2t": _attn(state, lp + "cross_attn_image_to_token"),
            "norm4": _norm(state, lp + "norm4"),
        }
    for i in range(num_masks + 1):
        hp = d + f"output_hypernetworks_mlps.{i}.layers"
        decoder[f"hyper{i}_l0"] = _linear(state, hp + ".0")
        decoder[f"hyper{i}_l1"] = _linear(state, hp + ".1")
        decoder[f"hyper{i}_out"] = _linear(state, hp + ".2")

    return {"prompt_encoder": prompt, "mask_decoder": decoder}
