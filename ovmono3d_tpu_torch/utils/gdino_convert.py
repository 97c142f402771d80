"""GroundingDINO checkpoint conversion: public torch weights -> the
flax-layout tree (counterpart of ovmono3d_tpu/utils/gdino_convert.py).

Maps the released `groundingdino_swinb_cogcoor.pth` state dict (the
checkpoint the reference loads, roi_heads_gdino.py:87-91) onto the tree of
models.gdino.model.GroundingDINO, which utils/flax_bridge.py loads into the
port's module. Layout rules as in checkpoint_convert (Linear transpose, Conv
OIHW->HWIO); torch nn.MultiheadAttention fused in_proj tensors are split
into separate q/k/v Dense params. Buffers of the file (Swin's
relative_position_index, BERT's position_ids) are not read: the model
rebuilds them.
"""
from __future__ import annotations

import numpy as np

from ovmono3d_tpu_torch.utils.checkpoint_convert import _conv, _t


def _ln(state, prefix):
    return {
        "scale": np.asarray(state[prefix + ".weight"]),
        "bias": np.asarray(state[prefix + ".bias"]),
    }


def _linear(state, prefix):
    return {
        "kernel": _t(state[prefix + ".weight"]),
        "bias": np.asarray(state[prefix + ".bias"]),
    }


def _mha(state, prefix):
    """torch nn.MultiheadAttention -> {q, k, v, out} Dense params."""
    w = np.asarray(state[prefix + ".in_proj_weight"])
    b = np.asarray(state[prefix + ".in_proj_bias"])
    d = w.shape[0] // 3
    return {
        "q": {"kernel": _t(w[:d]), "bias": b[:d]},
        "k": {"kernel": _t(w[d : 2 * d]), "bias": b[d : 2 * d]},
        "v": {"kernel": _t(w[2 * d :]), "bias": b[2 * d :]},
        "out": _linear(state, prefix + ".out_proj"),
    }


def convert_swin(state: dict, depths=(2, 2, 18, 2),
                 out_indices=(1, 2, 3), prefix="backbone.0.") -> dict:
    """Swin-B trunk -> models.gdino.swin.SwinTransformer params."""
    g = lambda k: state[prefix + k]
    out = {
        "patch_embed": {
            "kernel": _conv(g("patch_embed.proj.weight")),
            "bias": np.asarray(g("patch_embed.proj.bias")),
        },
        "patch_norm": _ln(state, prefix + "patch_embed.norm"),
    }
    for si, depth in enumerate(depths):
        for bi in range(depth):
            p = f"{prefix}layers.{si}.blocks.{bi}."
            out[f"stage{si}_block{bi}"] = {
                "norm1": _ln(state, p + "norm1"),
                "attn": {
                    "qkv": _linear(state, p + "attn.qkv"),
                    "proj": _linear(state, p + "attn.proj"),
                    "rel_pos_bias": np.asarray(
                        g(f"layers.{si}.blocks.{bi}."
                          "attn.relative_position_bias_table")
                    ),
                },
                "norm2": _ln(state, p + "norm2"),
                "fc1": _linear(state, p + "mlp.fc1"),
                "fc2": _linear(state, p + "mlp.fc2"),
            }
        if si < len(depths) - 1:
            p = f"{prefix}layers.{si}.downsample."
            out[f"merge{si}"] = {
                "norm": _ln(state, p + "norm"),
                "reduction": {
                    "kernel": _t(g(f"layers.{si}.downsample.reduction.weight"))
                },
            }
    for si in out_indices:
        out[f"out_norm{si}"] = _ln(state, prefix + f"norm{si}")
    return out


def convert_bert(state: dict, layers=12, prefix="bert.") -> dict:
    """HF BERT encoder -> models.gdino.bert.BertEncoder params."""
    g = prefix
    out = {
        "word_embeddings": {
            "embedding": np.asarray(
                state[g + "embeddings.word_embeddings.weight"]
            )
        },
        "position_embeddings": {
            "embedding": np.asarray(
                state[g + "embeddings.position_embeddings.weight"]
            )
        },
        "token_type_embeddings": {
            "embedding": np.asarray(
                state[g + "embeddings.token_type_embeddings.weight"]
            )
        },
        "embed_norm": _ln(state, g + "embeddings.LayerNorm"),
    }
    for i in range(layers):
        p = f"{g}encoder.layer.{i}."
        out[f"layer{i}"] = {
            "q": _linear(state, p + "attention.self.query"),
            "k": _linear(state, p + "attention.self.key"),
            "v": _linear(state, p + "attention.self.value"),
            "attn_out": _linear(state, p + "attention.output.dense"),
            "attn_norm": _ln(state, p + "attention.output.LayerNorm"),
            "inter": _linear(state, p + "intermediate.dense"),
            "out": _linear(state, p + "output.dense"),
            "out_norm": _ln(state, p + "output.LayerNorm"),
        }
    return out


def _deformable(state, prefix):
    return {
        "sampling_offsets": _linear(state, prefix + "sampling_offsets"),
        "attention_weights": _linear(state, prefix + "attention_weights"),
        "value_proj": _linear(state, prefix + "value_proj"),
        "output_proj": _linear(state, prefix + "output_proj"),
    }


def convert_transformer(state: dict, enc_layers=6, dec_layers=6) -> dict:
    """Enhancer + decoder + heads -> top-level GroundingDINO params."""
    out: dict = {
        "feat_map": _linear(state, "feat_map"),
        "level_embed": np.asarray(state["transformer.level_embed"]),
        "tgt_embed": np.asarray(state["transformer.tgt_embed.weight"]),
        "enc_output": _linear(state, "transformer.enc_output"),
        "enc_output_norm": _ln(state, "transformer.enc_output_norm"),
        "decoder_norm": _ln(state, "transformer.decoder.norm"),
    }
    for i in range(3):
        out[f"input_proj{i}"] = {
            "kernel": _conv(state[f"input_proj.{i}.0.weight"]),
            "bias": np.asarray(state[f"input_proj.{i}.0.bias"]),
        }
        out[f"input_proj_norm{i}"] = {
            "scale": np.asarray(state[f"input_proj.{i}.1.weight"]),
            "bias": np.asarray(state[f"input_proj.{i}.1.bias"]),
        }
    out["extra_proj"] = {
        "kernel": _conv(state["input_proj.3.0.weight"]),
        "bias": np.asarray(state["input_proj.3.0.bias"]),
    }
    out["extra_norm"] = {
        "scale": np.asarray(state["input_proj.3.1.weight"]),
        "bias": np.asarray(state["input_proj.3.1.bias"]),
    }

    for i in range(enc_layers):
        p = f"transformer.encoder.layers.{i}."
        out[f"img_enc{i}"] = {
            **_deformable(state, p + "self_attn."),
            "ffn1": _linear(state, p + "linear1"),
            "ffn2": _linear(state, p + "linear2"),
            "norm1": _ln(state, p + "norm1"),
            "norm2": _ln(state, p + "norm2"),
        }
        p = f"transformer.encoder.text_layers.{i}."
        out[f"text_enh{i}"] = {
            "self_attn": _mha(state, p + "self_attn"),
            "ffn1": _linear(state, p + "linear1"),
            "ffn2": _linear(state, p + "linear2"),
            "norm1": _ln(state, p + "norm1"),
            "norm2": _ln(state, p + "norm2"),
        }
        p = f"transformer.encoder.fusion_layers.{i}."
        out[f"fusion{i}"] = {
            "ln_v": _ln(state, p + "layer_norm_v"),
            "ln_l": _ln(state, p + "layer_norm_l"),
            "v_proj": _linear(state, p + "attn.v_proj"),
            "l_proj": _linear(state, p + "attn.l_proj"),
            "values_v": _linear(state, p + "attn.values_v_proj"),
            "values_l": _linear(state, p + "attn.values_l_proj"),
            "out_v": _linear(state, p + "attn.out_v_proj"),
            "out_l": _linear(state, p + "attn.out_l_proj"),
            "gamma_v": np.asarray(state[p + "gamma_v"]),
            "gamma_l": np.asarray(state[p + "gamma_l"]),
        }

    for i in range(dec_layers):
        p = f"transformer.decoder.layers.{i}."
        out[f"dec{i}"] = {
            **_deformable(state, p + "cross_attn."),
            "self_attn": _mha(state, p + "self_attn"),
            "text_cross": _mha(state, p + "ca_text"),
            "ffn1": _linear(state, p + "linear1"),
            "ffn2": _linear(state, p + "linear2"),
            "norm1": _ln(state, p + "norm2"),       # torch: norm2 after self
            "norm_text": _ln(state, p + "catext_norm"),
            "norm2": _ln(state, p + "norm1"),       # torch: norm1 after cross
            "norm3": _ln(state, p + "norm3"),
        }

    # Shared bbox MLP (dec_pred_bbox_embed_share=True -> bbox_embed.0).
    def mlp(prefix, n=3):
        return {
            f"l{j}": _linear(state, f"{prefix}.layers.{j}") for j in range(n)
        }

    out["bbox_head"] = mlp("bbox_embed.0")
    out["enc_bbox_head"] = mlp("transformer.enc_out_bbox_embed")
    out["ref_point_head"] = mlp("transformer.decoder.ref_point_head", 2)
    return out


def _count(state: dict, template: str) -> int:
    i = 0
    while template.format(i) in state:
        i += 1
    return i


def convert_groundingdino(state: dict) -> dict:
    """Full checkpoint -> GroundingDINO param tree (under 'params').

    Layer counts / stage depths are auto-detected from the key structure, so
    the same converter handles the released SwinB model and reduced test
    architectures.
    """
    enc = _count(
        state, "transformer.encoder.layers.{}.self_attn.value_proj.weight"
    )
    dec = _count(
        state, "transformer.decoder.layers.{}.cross_attn.value_proj.weight"
    )
    out = convert_transformer(state, enc_layers=enc, dec_layers=dec)
    depths = tuple(
        _count(state, "backbone.0.layers." + str(si) + ".blocks.{}.norm1.weight")
        for si in range(
            _count(state, "backbone.0.layers.{}.blocks.0.norm1.weight")
        )
    )
    out["backbone"] = convert_swin(state, depths=depths)
    bert_prefix = (
        "bert.bert."
        if "bert.bert.embeddings.word_embeddings.weight" in state
        else "bert."
    )
    bert_layers = _count(
        state, bert_prefix + "encoder.layer.{}.attention.self.query.weight"
    )
    out["bert"] = convert_bert(state, layers=bert_layers, prefix=bert_prefix)
    return out
