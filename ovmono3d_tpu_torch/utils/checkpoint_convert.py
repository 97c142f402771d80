"""Checkpoint conversion: released torch weights -> the flax-layout tree
(counterpart of ovmono3d_tpu/utils/checkpoint_convert.py, numpy only).

The reference loads DINOv2 from torch.hub and OVMono3D-LIFT heads from
`ovmono3d_lift.pth` (setup.sh, demo flow -- SURVEY.md §2.3 "checkpoint
conversion" hard part #4). These converters map those state dicts onto the
JAX package's parameter trees, which the port loads into its modules through
utils/flax_bridge.py (`load_flax_params`, the inverse transposes):

  torch Linear weight [out, in]      -> Dense kernel [in, out]
  torch Conv2d weight [out,in,kh,kw] -> Conv kernel [kh,kw,in,out]
  torch ConvTranspose2d [in,out,kh,kw] -> ConvTranspose [kh,kw,in,out],
                                        spatially flipped

So a converted tree equals the JAX converter's exactly, and the port keeps
one layout rule, the bridge's. The double transpose costs load time only.

DINOv2 specifics: fused qkv stays fused (the trunk's Attention uses one
Dense); the trunk's final `norm.*` is intentionally dropped -- the
reference's backbone consumes block outputs WITHOUT the final LayerNorm
(cubercnn/modeling/backbone/dino.py:89-117 loops blocks manually).
State dicts are plain dicts of numpy arrays (`utils.load.load_torch_state`).
"""
from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def _t(w):  # torch Linear -> Dense
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w):  # torch Conv2d OIHW -> HWIO
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _deconv(w):  # torch ConvTranspose2d IOHW -> HWIO
    # Flax ConvTranspose (lax.conv_transpose, transpose_kernel=False) applies
    # the kernel spatially MIRRORED relative to torch's ConvTranspose2d; the
    # [::-1, ::-1] flip makes the two bit-identical. flax_bridge flips again
    # when it loads the tree into a torch ConvTranspose2d, so the pair gives
    # back the checkpoint's IOHW weight unflipped.
    return np.ascontiguousarray(
        np.transpose(np.asarray(w), (2, 3, 0, 1))[::-1, ::-1]
    )


def convert_dinov2_vit(
    state: dict[str, np.ndarray], depth: int = 12, final_norm: bool = False
) -> dict:
    """torch.hub dinov2 ViT state dict -> VisionTransformer param dict.

    Returns the params subtree for models.vit.VisionTransformer (to be
    placed under params['params']['backbone']).
    """
    get = state.__getitem__
    out: dict = {
        "cls_token": np.asarray(get("cls_token"))[..., :],
        "pos_embed": np.asarray(get("pos_embed")),
        "patch_embed": {
            "kernel": _conv(get("patch_embed.proj.weight")),
            "bias": np.asarray(get("patch_embed.proj.bias")),
        },
    }
    for i in range(depth):
        p = f"blocks.{i}."
        blk = {
            "norm1": {
                "scale": np.asarray(get(p + "norm1.weight")),
                "bias": np.asarray(get(p + "norm1.bias")),
            },
            "attn": {
                "qkv": {
                    "kernel": _t(get(p + "attn.qkv.weight")),
                    "bias": np.asarray(get(p + "attn.qkv.bias")),
                },
                "proj": {
                    "kernel": _t(get(p + "attn.proj.weight")),
                    "bias": np.asarray(get(p + "attn.proj.bias")),
                },
            },
            "norm2": {
                "scale": np.asarray(get(p + "norm2.weight")),
                "bias": np.asarray(get(p + "norm2.bias")),
            },
            "mlp": {
                "fc1": {
                    "kernel": _t(get(p + "mlp.fc1.weight")),
                    "bias": np.asarray(get(p + "mlp.fc1.bias")),
                },
                "fc2": {
                    "kernel": _t(get(p + "mlp.fc2.weight")),
                    "bias": np.asarray(get(p + "mlp.fc2.bias")),
                },
            },
        }
        if p + "ls1.gamma" in state:
            blk["ls1"] = {"gamma": np.asarray(get(p + "ls1.gamma"))}
            blk["ls2"] = {"gamma": np.asarray(get(p + "ls2.gamma"))}
        out[f"block{i}"] = blk
    if final_norm:
        # DINOv2's trailing LayerNorm (VisionTransformer final_norm=True;
        # the detection backbone drops it, Depth-Pro's encoders keep it).
        out["norm"] = {
            "scale": np.asarray(get("norm.weight")),
            "bias": np.asarray(get("norm.bias")),
        }
    unused = [
        k for k in state
        if not k.startswith(("blocks.", "cls_token", "pos_embed",
                             "patch_embed.", "norm.", "mask_token",
                             "register_tokens"))
    ]
    if unused:
        logger.warning("unconverted dinov2 keys: %s", unused)
    return out


def hf_dinov2_to_hub(state: dict, prefix: str = "") -> dict:
    """Rename a transformers Dinov2Model state dict (separate q/k/v, HF key
    names) to the torch.hub dinov2 format `convert_dinov2_vit` consumes
    (fused qkv, `blocks.N.` names). `prefix` strips a leading module path
    (e.g. 'depth_pro.encoder.patch_encoder.model.')."""
    s = {k[len(prefix):]: np.asarray(v) for k, v in state.items()
         if k.startswith(prefix)}
    out = {
        "cls_token": s["embeddings.cls_token"],
        "pos_embed": s["embeddings.position_embeddings"],
        "patch_embed.proj.weight":
            s["embeddings.patch_embeddings.projection.weight"],
        "patch_embed.proj.bias":
            s["embeddings.patch_embeddings.projection.bias"],
    }
    if "layernorm.weight" in s:
        out["norm.weight"] = s["layernorm.weight"]
        out["norm.bias"] = s["layernorm.bias"]
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in s:
        h = f"encoder.layer.{i}."
        o = f"blocks.{i}."
        out[o + "attn.qkv.weight"] = np.concatenate([
            s[h + "attention.attention.query.weight"],
            s[h + "attention.attention.key.weight"],
            s[h + "attention.attention.value.weight"],
        ], 0)
        out[o + "attn.qkv.bias"] = np.concatenate([
            s[h + "attention.attention.query.bias"],
            s[h + "attention.attention.key.bias"],
            s[h + "attention.attention.value.bias"],
        ], 0)
        for src, dst in (
            ("norm1.weight", "norm1.weight"), ("norm1.bias", "norm1.bias"),
            ("attention.output.dense.weight", "attn.proj.weight"),
            ("attention.output.dense.bias", "attn.proj.bias"),
            ("layer_scale1.lambda1", "ls1.gamma"),
            ("layer_scale2.lambda1", "ls2.gamma"),
            ("norm2.weight", "norm2.weight"), ("norm2.bias", "norm2.bias"),
            ("mlp.fc1.weight", "mlp.fc1.weight"),
            ("mlp.fc1.bias", "mlp.fc1.bias"),
            ("mlp.fc2.weight", "mlp.fc2.weight"),
            ("mlp.fc2.bias", "mlp.fc2.bias"),
        ):
            out[o + dst] = s[h + src]
        i += 1
    return out


def convert_clip_vit(state: dict, prefix: str = "visual.") -> dict:
    """open_clip visual tower (the 'openai' ViT checkpoints the reference
    loads, clip.py:23-28) -> VisionTransformer params (preset 'clip').

    conv1 has no bias in CLIP; the PatchEmbed bias is set to zero."""
    s = {k[len(prefix):]: np.asarray(v) for k, v in state.items()
         if k.startswith(prefix)}
    width = s["class_embedding"].shape[-1]
    out: dict = {
        "cls_token": s["class_embedding"].reshape(1, 1, width),
        "pos_embed": s["positional_embedding"].reshape(1, -1, width),
        "patch_embed": {
            "kernel": _conv(s["conv1.weight"]),
            "bias": np.zeros((width,), np.float32),
        },
        "ln_pre": {
            "scale": s["ln_pre.weight"],
            "bias": s["ln_pre.bias"],
        },
    }
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in s:
        p = f"transformer.resblocks.{i}."
        out[f"block{i}"] = {
            "norm1": {"scale": s[p + "ln_1.weight"],
                      "bias": s[p + "ln_1.bias"]},
            "attn": {
                "qkv": {"kernel": _t(s[p + "attn.in_proj_weight"]),
                        "bias": s[p + "attn.in_proj_bias"]},
                "proj": {"kernel": _t(s[p + "attn.out_proj.weight"]),
                         "bias": s[p + "attn.out_proj.bias"]},
            },
            "norm2": {"scale": s[p + "ln_2.weight"],
                      "bias": s[p + "ln_2.bias"]},
            "mlp": {
                "fc1": {"kernel": _t(s[p + "mlp.c_fc.weight"]),
                        "bias": s[p + "mlp.c_fc.bias"]},
                "fc2": {"kernel": _t(s[p + "mlp.c_proj.weight"]),
                        "bias": s[p + "mlp.c_proj.bias"]},
            },
        }
        i += 1
    return out


def convert_mae_vit(state: dict, prefix: str = "vit.") -> dict:
    """HF ViTMAE encoder (facebook/vit-mae-base, the reference's trunk,
    mae.py:21) -> VisionTransformer params (preset 'mae').

    The fixed sin-cos position table is NOT converted — the model rebuilds
    it exactly at the runtime grid (pos_sincos=True, mae.py:61-76)."""
    s = {k[len(prefix):]: np.asarray(v) for k, v in state.items()
         if k.startswith(prefix)}
    out: dict = {
        "cls_token": s["embeddings.cls_token"],
        "patch_embed": {
            "kernel": _conv(
                s["embeddings.patch_embeddings.projection.weight"]
            ),
            "bias": s["embeddings.patch_embeddings.projection.bias"],
        },
    }
    i = 0
    while f"encoder.layer.{i}.layernorm_before.weight" in s:
        p = f"encoder.layer.{i}."
        out[f"block{i}"] = {
            "norm1": {"scale": s[p + "layernorm_before.weight"],
                      "bias": s[p + "layernorm_before.bias"]},
            "attn": {
                "qkv": {
                    "kernel": _t(np.concatenate([
                        s[p + "attention.attention.query.weight"],
                        s[p + "attention.attention.key.weight"],
                        s[p + "attention.attention.value.weight"],
                    ], 0)),
                    "bias": np.concatenate([
                        s[p + "attention.attention.query.bias"],
                        s[p + "attention.attention.key.bias"],
                        s[p + "attention.attention.value.bias"],
                    ], 0),
                },
                "proj": {
                    "kernel": _t(s[p + "attention.output.dense.weight"]),
                    "bias": s[p + "attention.output.dense.bias"],
                },
            },
            "norm2": {"scale": s[p + "layernorm_after.weight"],
                      "bias": s[p + "layernorm_after.bias"]},
            "mlp": {
                "fc1": {"kernel": _t(s[p + "intermediate.dense.weight"]),
                        "bias": s[p + "intermediate.dense.bias"]},
                "fc2": {"kernel": _t(s[p + "output.dense.weight"]),
                        "bias": s[p + "output.dense.bias"]},
            },
        }
        i += 1
    return out


def convert_midas_vit(state: dict, prefix: str = "pretrained.model.") -> dict:
    """MiDaS DPT_Large trunk (timm vit_large_patch16_384 inside the
    torch.hub checkpoint, midas_final.py:23-24) -> VisionTransformer params
    (preset 'midas'). timm uses the same fused-qkv key layout as the hub
    dinov2 checkpoints, minus layerscale."""
    s = {k[len(prefix):]: v for k, v in state.items()
         if k.startswith(prefix)}
    depth = 0
    while f"blocks.{depth}.norm1.weight" in s:
        depth += 1
    return convert_dinov2_vit(s, depth=depth)


def convert_depth_fusion(state: dict[str, np.ndarray], prefix: str) -> dict:
    """The OVMono3D depth-fusion 1x1 conv (dino.py:40-46)."""
    return {
        "kernel": _conv(state[prefix + "weight"]),
        "bias": np.asarray(state[prefix + "bias"]),
    }
