"""OVMono3D-LIFT checkpoint conversion: `ovmono3d_lift.pth` -> RCNN3D params
(counterpart of ovmono3d_tpu/utils/lift_convert.py).

Maps the released detectron2-format checkpoint (the model the reference's
demo/eval loads — demo.py:144-150) onto the flax-layout tree of
models.rcnn3d.RCNN3D, which utils/flax_bridge.py loads into the port's
module:

  backbone.net.vit.*            -> backbone/vit (convert_dinov2_vit)
  backbone.net.depth_fusion.*   -> backbone/vit/depth_fusion
  backbone.simfp_{s}.*          -> backbone/sfp/{up2_i, stage_i.*}
  proposal_generator.rpn_head.* -> rpn_head
  roi_heads.box_head/.box_predictor -> box_head
  roi_heads.cube_head.*         -> cube_head

Layout rules per checkpoint_convert (Linear transpose, Conv OIHW->HWIO,
ConvTranspose IOHW->HWIO); detectron2 Conv2d `.norm` submodules are
LayerNorms over channels.

One departure from the JAX converter: the box head's and the cube head's
first fc layer. detectron2 pools [N, C, R, R] and flattens it in (C, H, W)
order, so the released fc1 weight's input columns run in that order; the
heads here flatten the pooled [N, R, R, C] grid in (H, W, C) order. The JAX
converter only transposes fc1, so its heads read a released file's features
in the wrong order; here fc1's input rows are permuted from (C, H, W) to
(H, W, C) (`_fc1`), which makes the heads compute detectron2's function.
"""
from __future__ import annotations

import logging
import math

import numpy as np

from ovmono3d_tpu_torch.utils.checkpoint_convert import (
    _conv,
    _deconv,
    _t,
    convert_dinov2_vit,
)

logger = logging.getLogger(__name__)


def _linear(state, prefix):
    return {
        "kernel": _t(state[prefix + ".weight"]),
        "bias": np.asarray(state[prefix + ".bias"]),
    }


def _fc1(state, prefix, resolution):
    """A head's first fc layer, its input rows permuted from detectron2's
    (C, H, W) flattening to the (H, W, C) order of the pooled NHWC grid."""
    out = _linear(state, prefix)
    k = out["kernel"]
    rr = resolution * resolution
    if k.ndim != 2 or k.shape[0] % rr:
        raise ValueError(f"{prefix}.weight: {k.shape[::-1]} is not "
                         f"[out, C * {resolution} * {resolution}]")
    c = k.shape[0] // rr
    out["kernel"] = np.ascontiguousarray(
        k.reshape(c, resolution, resolution, -1).transpose(1, 2, 0, 3)
        .reshape(k.shape))
    return out


def _conv2d(state, prefix):
    return {
        "kernel": _conv(state[prefix + ".weight"]),
        **(
            {"bias": np.asarray(state[prefix + ".bias"])}
            if prefix + ".bias" in state
            else {}
        ),
    }


def _norm(state, prefix):
    return {
        "scale": np.asarray(state[prefix + ".weight"]),
        "bias": np.asarray(state[prefix + ".bias"]),
    }


def convert_sfp(state, scale_factors=(2.0, 1.0, 0.5), patch_size=14,
                prefix="backbone.") -> dict:
    """detectron2 SimpleFeaturePyramid stages -> models.sfp params.

    detectron2 names each stage `simfp_{log2(stride)}` and packs its layers
    in an nn.Sequential: [ConvTranspose?] [MaxPool?] Conv1x1(+norm)
    Conv3x3(+norm); pooling has no params so the conv indices shift by
    scale.
    """
    out: dict = {}
    for i, scale in enumerate(scale_factors):
        stride = round(patch_size / scale)
        stage = int(math.log2(stride))
        p = f"{prefix}simfp_{stage}."
        if scale == 2.0:
            out[f"up2_{i}"] = {
                "kernel": _deconv(state[p + "0.weight"]),
                "bias": np.asarray(state[p + "0.bias"]),
            }
            c1, c2 = 1, 2
        elif scale == 4.0:
            out[f"up4a_{i}"] = {
                "kernel": _deconv(state[p + "0.weight"]),
                "bias": np.asarray(state[p + "0.bias"]),
            }
            out[f"up4_norm_{i}"] = _norm(state, p + "1")
            out[f"up4b_{i}"] = {
                "kernel": _deconv(state[p + "3.weight"]),
                "bias": np.asarray(state[p + "3.bias"]),
            }
            c1, c2 = 4, 5
        elif scale == 1.0:
            c1, c2 = 0, 1
        else:  # 0.5 -> MaxPool first (no params)
            c1, c2 = 1, 2
        out[f"stage_{i}"] = {
            "lateral": {"kernel": _conv(state[f"{p}{c1}.weight"])},
            "lateral_norm": _norm(state, f"{p}{c1}.norm"),
            "output": {"kernel": _conv(state[f"{p}{c2}.weight"])},
            "output_norm": _norm(state, f"{p}{c2}.norm"),
        }
    return out


def convert_rpn_head(state, prefix="proposal_generator.rpn_head.") -> dict:
    return {
        "conv": _conv2d(state, prefix + "conv"),
        "objectness": _conv2d(state, prefix + "objectness_logits"),
        "deltas": _conv2d(state, prefix + "anchor_deltas"),
    }


def convert_box_head(state, resolution: int = 7) -> dict:
    """detectron2's FastRCNNConvFCHead and predictors -> box_head;
    `resolution` is the pooler's (fc1's input is C * resolution^2)."""
    return {
        "fc1": _fc1(state, "roi_heads.box_head.fc1", resolution),
        "fc2": _linear(state, "roi_heads.box_head.fc2"),
        "cls_score": _linear(state, "roi_heads.box_predictor.cls_score"),
        "bbox_pred": _linear(state, "roi_heads.box_predictor.bbox_pred"),
    }


def convert_cube_head(state, shared_fc=True, num_fc=2,
                      prefix="roi_heads.cube_head.",
                      resolution: int = 7) -> dict:
    """The cube head's fc stacks and outputs -> cube_head; `resolution` is
    its pooler's."""
    def fc(key, j):
        return (_fc1(state, key, resolution) if j == 1
                else _linear(state, key))

    out: dict = {}
    if shared_fc:
        for j in range(1, num_fc + 1):
            out[f"shared_fc{j}"] = fc(f"{prefix}feature_generator.fc{j}", j)
    else:
        names = {
            "xy": "XY", "dims": "dims", "pose": "pose", "z": "Z",
            "conf": "conf",
        }
        for ours, theirs in names.items():
            for j in range(1, num_fc + 1):
                key = f"{prefix}feature_generator_{theirs}.fc{j}"
                if key + ".weight" in state:
                    out[f"{ours}_fc{j}"] = fc(key, j)
    out["center_deltas"] = _linear(state, prefix + "bbox_3D_center_deltas")
    out["dims"] = _linear(state, prefix + "bbox_3D_dims")
    out["pose"] = _linear(state, prefix + "bbox_3D_pose")
    out["depth"] = _linear(state, prefix + "bbox_3D_center_depth")
    if prefix + "bbox_3D_uncertainty.weight" in state:
        out["uncertainty"] = _linear(state, prefix + "bbox_3D_uncertainty")
    return out


def extract_priors(state: dict) -> dict | None:
    """Recover the category priors baked into a released checkpoint as
    parameters (roi_heads.py:117-143: priors_dims_per_cat [1, C, 2, 3],
    priors_z_scales [C, B], priors_z_stats [C, B, 2]) in the dict layout
    utils.priors.compute_priors produces — so dims_priors_enabled /
    cluster_bins decodes work from the checkpoint alone, no priors.npz."""
    import numpy as np

    key = "roi_heads.priors_dims_per_cat"
    if key not in state:
        return None
    priors = {"dims": np.asarray(state[key])[0]}
    if "roi_heads.priors_z_scales" in state:
        priors["z_scales"] = np.asarray(state["roi_heads.priors_z_scales"])
    if "roi_heads.priors_z_stats" in state:
        priors["z_stats"] = np.asarray(state["roi_heads.priors_z_stats"])
    return priors


def convert_ovmono3d_lift(
    state: dict,
    depth: int = 12,
    scale_factors=(2.0, 1.0, 0.5),
    patch_size: int = 14,
    shared_fc: bool = True,
    box_resolution: int = 7,
    cube_resolution: int = 7,
) -> dict:
    """Full ovmono3d_lift.pth state dict -> RCNN3D params['params'] tree
    (the resolutions are the box and cube poolers')."""
    vit = convert_dinov2_vit(
        {
            k[len("backbone.net.vit."):]: v
            for k, v in state.items()
            if k.startswith("backbone.net.vit.")
        },
        depth=depth,
    )
    if "backbone.net.depth_fusion.weight" in state:
        vit["depth_fusion"] = _conv2d(state, "backbone.net.depth_fusion")
    return {
        "backbone": {
            "vit": vit,
            "sfp": convert_sfp(state, scale_factors, patch_size),
        },
        "rpn_head": convert_rpn_head(state),
        "box_head": convert_box_head(state, box_resolution),
        "cube_head": convert_cube_head(state, shared_fc=shared_fc,
                                       resolution=cube_resolution),
    }
