"""Depth-Pro checkpoint conversion: released weights -> the flax-layout tree
(counterpart of ovmono3d_tpu/utils/depth_convert.py; utils/flax_bridge.py
loads it into the port's module).

Consumes the `apple/DepthPro-hf` state-dict format (the transformers
`DepthProForDepthEstimation` port of ml-depth-pro's depth_pro.pt — the
model OVMono3D-GEO loads, reference tools/ovmono3d_geo.py:266-268) and maps
it onto models.depth.DepthPro. Layout rules per checkpoint_convert
(_t Linear transpose, _conv OIHW->HWIO, _deconv IOHW->HWIO + spatial flip).
"""
from __future__ import annotations

import numpy as np

from ovmono3d_tpu_torch.utils.checkpoint_convert import (
    _conv,
    _deconv,
    _t,
    convert_dinov2_vit,
    hf_dinov2_to_hub,
)


def _cv(state, key, bias=True):
    out = {"kernel": _conv(state[key + ".weight"])}
    if bias:
        out["bias"] = np.asarray(state[key + ".bias"])
    return out


def _dcv(state, key, bias=True):
    out = {"kernel": _deconv(state[key + ".weight"])}
    if bias:
        out["bias"] = np.asarray(state[key + ".bias"])
    return out


def _count(state, template):
    i = 0
    while template.format(i) in state:
        i += 1
    return i


def convert_depth_pro(state: dict) -> dict:
    """HF DepthProForDepthEstimation state dict -> DepthPro param tree."""
    s = {k: np.asarray(v) for k, v in state.items()}

    def vit(prefix):
        depth = _count(
            s, prefix + "encoder.layer.{}.norm1.weight"
        )
        return convert_dinov2_vit(hf_dinov2_to_hub(s, prefix), depth=depth,
                                  final_norm=True)

    out: dict = {
        "patch_encoder": vit("depth_pro.encoder.patch_encoder.model."),
        "image_encoder": vit("depth_pro.encoder.image_encoder.model."),
    }

    up = "depth_pro.neck.feature_upsample."
    out["up_image"] = _dcv(s, up + "image_block.layers.0")
    n_scaled = _count(s, up + "scaled_images.{}.layers.0.weight")
    for i in range(n_scaled):
        out[f"up_scaled{i}_proj"] = _cv(
            s, up + f"scaled_images.{i}.layers.0", bias=False
        )
        out[f"up_scaled{i}_deconv"] = _dcv(
            s, up + f"scaled_images.{i}.layers.1", bias=False
        )
    n_hooks = _count(s, up + "intermediate.{}.layers.0.weight")
    for i in range(n_hooks):
        out[f"up_hook{i}_proj"] = _cv(
            s, up + f"intermediate.{i}.layers.0", bias=False
        )
        j = 0
        while up + f"intermediate.{i}.layers.{j + 1}.weight" in s:
            out[f"up_hook{i}_deconv{j}"] = _dcv(
                s, up + f"intermediate.{i}.layers.{j + 1}", bias=False
            )
            j += 1
    out["fuse_lowres"] = _cv(s, "depth_pro.neck.fuse_image_with_low_res")
    n_proj = _count(
        s, "depth_pro.neck.feature_projection.projections.{}.weight"
    )
    for i in range(n_proj):
        out[f"project{i}"] = _cv(
            s, f"depth_pro.neck.feature_projection.projections.{i}",
            bias=False,
        )

    def fusion(prefix, deconv):
        blk = {
            "rcu1": {
                "conv1": _cv(s, prefix + ".residual_layer1.convolution1"),
                "conv2": _cv(s, prefix + ".residual_layer1.convolution2"),
            },
            "rcu2": {
                "conv1": _cv(s, prefix + ".residual_layer2.convolution1"),
                "conv2": _cv(s, prefix + ".residual_layer2.convolution2"),
            },
            "project": _cv(s, prefix + ".projection"),
        }
        if deconv:
            blk["deconv"] = _dcv(s, prefix + ".deconv", bias=False)
        return blk

    n_fusion = _count(
        s, "fusion_stage.intermediate.{}.projection.weight"
    )
    for i in range(n_fusion):
        out[f"fusion{i}"] = fusion(f"fusion_stage.intermediate.{i}", True)
    out[f"fusion{n_fusion}"] = fusion("fusion_stage.final", False)
    # The first fusion layer is called without a residual input; its rcu1
    # parameters exist in the checkpoint but not in our module.
    out["fusion0"].pop("rcu1")

    out["head_conv1"] = _cv(s, "head.layers.0")
    out["head_deconv"] = _dcv(s, "head.layers.1")
    out["head_conv2"] = _cv(s, "head.layers.2")
    out["head_out"] = _cv(s, "head.layers.4")

    if "fov_model.conv.weight" in s:
        out["fov_encoder"] = vit("fov_model.fov_encoder.model.")
        out["fov_neck"] = {
            "kernel": _t(s["fov_model.fov_encoder.neck.weight"]),
            "bias": np.asarray(s["fov_model.fov_encoder.neck.bias"]),
        }
        out["fov_conv"] = _cv(s, "fov_model.conv")
        i = 0
        while f"fov_model.head.layers.{i * 2}.weight" in s:
            key = f"fov_model.head.layers.{i * 2}"
            name = (
                f"fov_head{i}"
                if f"fov_model.head.layers.{(i + 1) * 2}.weight" in s
                else "fov_head_out"
            )
            out[name] = _cv(s, key)
            i += 1
    return out
